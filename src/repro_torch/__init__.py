"""repro_torch — the PyTorch/CUDA port of the OpenCLIPER reproduction.

A second package beside the JAX package ``repro``, mirroring its layout.
It imports ``torch`` and never JAX or ``repro``; its hot-path kernels are
hand-written CUDA for Hopper (``kernels/csrc``), built at first use.
"""
