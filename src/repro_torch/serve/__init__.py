"""Serving layer of the port: request/response serving over Data-set
pipelines (:class:`PipelineServer`) and slot-based continuous batching for
LMs (:class:`LMServer`, and :class:`ServeEngine`, its former API)."""
from .engine import SamplingConfig, ServeEngine, make_decode_fn, make_prefill_fn, sample_tokens
from .pipeline import LMServer, PipelineServer, PromptTooLongError, ServeResponse

__all__ = ["LMServer", "PipelineServer", "PromptTooLongError", "SamplingConfig",
           "ServeEngine", "ServeResponse", "make_decode_fn", "make_prefill_fn",
           "sample_tokens"]
