"""Built-in Processes: the MRI path (paper §IV), the listing-1 Negate and
LM decode (:mod:`.lm`)."""
from .coil_combine import CombineParams, RSSCombine, XImageSum
from .complex_elementprod import ComplexElementProd, ComplexElementProdParams
from .fft import FFT, FFTParams
from .lm import (CacheSplice, DecodeSession, DecodeStep, PrefillProcess, SlotRelease,
                 TreeCodec, decode_state_data, weights_data)
from .negate import Negate
from .simple_mri_recon import FusedMRIRecon, FusedReconParams, SimpleMRIRecon

__all__ = ["CacheSplice", "CombineParams", "ComplexElementProd", "ComplexElementProdParams",
           "DecodeSession", "DecodeStep", "FFT", "FFTParams", "FusedMRIRecon",
           "FusedReconParams", "Negate", "PrefillProcess", "RSSCombine",
           "SimpleMRIRecon", "SlotRelease", "TreeCodec", "XImageSum", "decode_state_data",
           "weights_data"]
