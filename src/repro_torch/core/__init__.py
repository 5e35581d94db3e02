"""GEMM algebra: FIP/FFIP, int8 quantization, the GEMM provider."""
