"""PyTorch/CUDA port of the FIP/FFIP reproduction (``repro``), for NVIDIA
Hopper. Mirrors ``repro``'s module layout; the hand-written kernels live in
``repro_torch.kernels`` (CUDA C++ under ``kernels/csrc``)."""
