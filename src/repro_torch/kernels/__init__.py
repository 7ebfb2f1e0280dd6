"""BAM attention kernels: CUDA C++ sources in ``csrc/``, their
wrappers, plain PyTorch versions and the dense oracle."""
