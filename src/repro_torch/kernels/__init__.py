"""Hand-written Hopper kernels (CUDA C++ under ``*/csrc``), one package
per Pallas kernel of ``repro.kernels`` or per XLA program of the
reference that the port writes by hand (the simulator's round loop, the
MoE layer's grouped expert FFN), each with its plain PyTorch version
beside it in ``ops.py``."""
