"""PyTorch/CUDA port of the ``repro`` router and serving stack.

A second package beside ``repro`` (the JAX/Pallas reference, which it
never imports).  Module paths mirror the reference's, so
``repro_torch.serving.engine`` is the twin of ``repro.serving.engine``.
"""
