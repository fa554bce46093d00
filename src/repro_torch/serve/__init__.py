"""Serving layer of the port: request/response serving over Data-set
pipelines (:class:`PipelineServer`), slot-based continuous batching for
LMs (:class:`LMServer`, and :class:`ServeEngine`, its former API), and the
control plane in front of several of them (:class:`FrontDoor`)."""
from .control import (AdmissionRejected, CallableReplica, FrontDoor, Metrics, Outcome,
                      PipelineReplica, PriorityClass, Replica, Router)
from .engine import SamplingConfig, ServeEngine, make_decode_fn, make_prefill_fn, sample_tokens
from .pipeline import LMServer, PipelineServer, PromptTooLongError, ServeResponse

__all__ = ["AdmissionRejected", "CallableReplica", "FrontDoor", "LMServer", "Metrics",
           "Outcome", "PipelineReplica", "PipelineServer", "PriorityClass",
           "PromptTooLongError", "Replica", "Router", "SamplingConfig", "ServeEngine",
           "ServeResponse", "make_decode_fn", "make_prefill_fn", "sample_tokens"]
