"""Model zoo of the port: the decoder (dense and moe, MLA included), RWKV6
(ssm) and Whisper (encdec) families so far."""
from .common import ArchConfig
from .rwkv6 import RWKV6Model
from .transformer import DecoderLM
from .whisper import WhisperModel


def build_model(cfg: ArchConfig):
    """Return the model object for a config's family."""
    if cfg.family in ("dense", "moe"):
        return DecoderLM(cfg)
    if cfg.family == "ssm":
        return RWKV6Model(cfg)
    if cfg.family == "encdec":
        return WhisperModel(cfg)
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (ROADMAP queue 1, rest of the LM stack)")


__all__ = ["ArchConfig", "DecoderLM", "RWKV6Model", "WhisperModel", "build_model"]
