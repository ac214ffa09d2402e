"""Hand-written CUDA kernels for Hopper (sm_90a), each with its plain
PyTorch version beside it. Sources live in ``csrc/``; ``build.py`` compiles
them with nvcc at first use."""
