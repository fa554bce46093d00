"""Model zoo of the port: the dense decoder family so far."""
from .common import ArchConfig
from .transformer import DecoderLM


def build_model(cfg: ArchConfig):
    """Return the model object for a config's family."""
    if cfg.family == "dense":
        return DecoderLM(cfg)
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (ROADMAP queue 1: whisper, rwkv6, then "
        "the rest of the LM stack)")


__all__ = ["ArchConfig", "DecoderLM", "build_model"]
