"""Aggregated kernel wrappers (the framework's "loadKernels" surface).

Importing this module registers every kernel of the port in the global
registry: ``complexElementProd``, ``xImageSum``, ``rss``,
``mriFusedEpilogue`` and ``mriFusedRecon``.  ``CLapp.loadKernels([...])``
imports the individual modules on demand instead.
"""
from .coil_combine import rss, ximage_sum
from .complex_elementprod import complex_elementprod
from .mri_fused import fused_epilogue, fused_recon

__all__ = ["complex_elementprod", "fused_epilogue", "fused_recon", "rss",
           "ximage_sum"]
