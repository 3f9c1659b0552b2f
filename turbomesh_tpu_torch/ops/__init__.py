"""Hand-written device kernels (CUDA C++ sources under ../csrc) and their
plain PyTorch versions."""
