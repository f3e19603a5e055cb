"""Hand-written Hopper kernels (CUDA C++ under ``*/csrc``), one package
per Pallas kernel of ``repro.kernels``, each with its plain PyTorch
version beside it in ``ops.py``."""
