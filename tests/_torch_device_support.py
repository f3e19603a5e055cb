"""Tensors on a device the port has no kernel for, for the tests that the
kernels' wrappers refuse one: the ``lazy`` device of PyTorch's
TorchScript lazy-tensor backend, which runs on the CPU.  (``meta`` has
the dry-run's branch, so it no longer serves.)"""
import torch

_READY = []


def no_kernel_tensor(shape, dtype=torch.float32) -> torch.Tensor:
    """An empty ``lazy`` tensor; the backend is started once a process."""
    if not _READY:
        import importlib
        ts_backend = importlib.import_module("torch._lazy.ts_backend")
        try:
            ts_backend.init()
        except RuntimeError as e:           # started already
            if "multiple backend fallbacks" not in str(e):
                raise
        _READY.append(True)
    return torch.empty(shape, dtype=dtype, device="lazy")
