"""Aggregated kernel wrappers (the framework's "loadKernels" surface).

Importing this module registers every kernel of the port in the global
registry: ``complexElementProd``, ``xImageSum``, ``rss``,
``mriFusedEpilogue``, ``mriFusedRecon``, ``rmsnorm`` and ``flash_attention``.  ``CLapp.loadKernels([...])``
imports the individual modules on demand instead.
"""
from .coil_combine import rss, ximage_sum
from .complex_elementprod import complex_elementprod
from .flash_attention import flash_attention
from .mri_fused import fused_epilogue, fused_recon
from .rmsnorm import rmsnorm

__all__ = ["complex_elementprod", "flash_attention", "fused_epilogue", "fused_recon",
           "rmsnorm", "rss", "ximage_sum"]
