"""Aggregated kernel wrappers (the framework's "loadKernels" surface).

Importing this module registers every kernel of the port in the global
registry: ``complexElementProd``, ``xImageSum``, ``rss``,
``mriFusedEpilogue``, ``mriFusedRecon``, ``rmsnorm``, ``flash_attention``,
``wkv6`` and ``negate_kernel``.  ``CLapp.loadKernels([...])`` imports the
individual modules on demand instead.
"""
from .coil_combine import rss, ximage_sum
from .complex_elementprod import complex_elementprod
from .flash_attention import flash_attention
from .mri_fused import fused_epilogue, fused_recon
from .negate import negate
from .rmsnorm import rmsnorm
from .wkv6 import wkv6

__all__ = ["complex_elementprod", "flash_attention", "fused_epilogue", "fused_recon",
           "negate", "rmsnorm", "rss", "wkv6", "ximage_sum"]
