"""Built-in Processes of the MRI path (paper §IV)."""
from .coil_combine import CombineParams, RSSCombine, XImageSum
from .complex_elementprod import ComplexElementProd, ComplexElementProdParams
from .fft import FFT, FFTParams
from .simple_mri_recon import FusedMRIRecon, FusedReconParams, SimpleMRIRecon

__all__ = ["CombineParams", "ComplexElementProd", "ComplexElementProdParams",
           "FFT", "FFTParams", "FusedMRIRecon", "FusedReconParams",
           "RSSCombine", "SimpleMRIRecon", "XImageSum"]
