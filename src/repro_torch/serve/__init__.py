"""Serving layer of the port: slot-based continuous batching for LMs."""
from .engine import SamplingConfig
from .pipeline import LMServer, PromptTooLongError

__all__ = ["LMServer", "PromptTooLongError", "SamplingConfig"]
