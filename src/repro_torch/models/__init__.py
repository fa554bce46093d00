"""Model zoo of the port: the decoder (dense, moe with MLA, vlm), RWKV6
(ssm), Zamba2 (hybrid) and Whisper (encdec) families."""
from .common import ArchConfig
from .rwkv6 import RWKV6Model
from .transformer import DecoderLM
from .whisper import WhisperModel
from .zamba2 import Zamba2Model


def build_model(cfg: ArchConfig):
    """Return the model object for a config's family."""
    if cfg.family in ("dense", "moe", "vlm"):
        return DecoderLM(cfg)
    if cfg.family == "hybrid":
        return Zamba2Model(cfg)
    if cfg.family == "ssm":
        return RWKV6Model(cfg)
    if cfg.family == "encdec":
        return WhisperModel(cfg)
    raise ValueError(f"unknown family {cfg.family!r}")


__all__ = ["ArchConfig", "DecoderLM", "RWKV6Model", "WhisperModel", "Zamba2Model",
           "build_model"]
