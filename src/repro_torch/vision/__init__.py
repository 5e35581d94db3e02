"""CNN models (AlexNet, VGG-16, ResNet-50) whose convs run through the GEMM
provider: the port of ``repro/vision``."""
