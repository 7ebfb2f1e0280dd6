"""PyTorch/CUDA port of the Cornstarch reproduction (``repro``).

Modules mirror ``repro``'s names. The port imports torch, numpy and the
standard library only: nothing of JAX and nothing of ``repro``. Its
kernels are CUDA C++ written for Hopper (``kernels/csrc``), built with
``nvcc`` on first use. Entry points run on ``device="cuda"`` unless the
caller asks for the CPU, where every kernel runs its plain PyTorch
version.
"""
