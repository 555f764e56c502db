"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.  Sources live in ``csrc/``; ``build`` compiles them with nvcc at
first use and binds them through ctypes."""
