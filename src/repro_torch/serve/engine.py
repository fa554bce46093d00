"""The former serving entry point, now a thin shim over :class:`~repro_torch.
serve.pipeline.LMServer` (the counterpart of ``repro/serve/engine.py``).

* :class:`SamplingConfig` -- sampling and stop conditions, shared by both.
* :func:`sample_tokens`, :func:`make_prefill_fn`, :func:`make_decode_fn`
  -- helpers for callers that drive a model's serve contract themselves.
* :class:`ServeEngine` -- the former fixed-width continuous-batching API,
  served by ``LMServer``: greedy decoding only, as ``LMServer`` samples on
  the device.  Encoder-decoder models (Whisper) take ``enc_len`` and
  per-request frames, as ``LMServer`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class SamplingConfig:
    temperature: float = 0.0      # 0 = greedy
    top_k: int = 0                # 0 = no top-k
    max_new_tokens: int = 32
    eos_id: Optional[int] = None


def sample_tokens(logits: torch.Tensor, cfg: SamplingConfig,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits (B, 1, V) f32 -> tokens (B, 1) int32: the argmax when
    ``cfg.temperature`` is 0, else a draw from the softmax of the logits
    over the temperature, restricted to the ``cfg.top_k`` largest when it
    is set (``generator`` seeds it; it gives other numbers than the JAX
    package's ``jax.random`` key)."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits.float() / cfg.temperature
    if cfg.top_k:
        floor = torch.topk(scaled, cfg.top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < floor, torch.full_like(scaled, -1e30), scaled)
    flat = torch.softmax(scaled.reshape(-1, scaled.shape[-1]), dim=-1)
    toks = torch.multinomial(flat, 1, generator=generator)
    return toks.reshape(logits.shape[:-1]).to(torch.int32)


def make_prefill_fn(model) -> Callable:
    def prefill(params, tokens, cache):
        return model.prefill(params, tokens, cache)
    return prefill


def make_decode_fn(model) -> Callable:
    def decode(params, token, pos, cache):
        return model.decode_step(params, token, pos, cache)
    return decode


class ServeEngine:
    """The former continuous-batching API, served by :class:`~repro_torch.
    serve.pipeline.LMServer` (``server``).  ``sampling`` defaults to a
    fresh :class:`SamplingConfig` per engine."""

    def __init__(self, model, params, batch: int, max_len: int,
                 sampling: Optional[SamplingConfig] = None, app=None,
                 enc_len: Optional[int] = None):
        from .pipeline import LMServer  # the server builds on this module

        self.sampling = sampling if sampling is not None else SamplingConfig()
        self.model, self.params = model, params
        self.batch, self.max_len = batch, max_len
        self._server = LMServer(model, params, batch=batch, max_len=max_len,
                                sampling=self.sampling, enc_len=enc_len, app=app)

    # -- request lifecycle (delegated) ----------------------------------------
    def submit(self, prompt: Sequence[int], frames=None) -> int:
        return self._server.submit(prompt, frames)

    def step(self) -> None:
        self._server.step()

    def run(self, max_steps: int = 10_000) -> List[List[int]]:
        return self._server.run(max_steps)

    # -- the former attributes, read through ----------------------------------
    @property
    def results(self) -> List[List[int]]:
        return self._server.results

    @property
    def queue(self) -> List[tuple]:
        return self._server.queue

    @property
    def active(self) -> np.ndarray:
        return self._server.active

    @property
    def positions(self) -> np.ndarray:
        return self._server.positions

    @property
    def req_of_slot(self) -> np.ndarray:
        return self._server.req_of_slot

    @property
    def server(self):
        """The underlying :class:`~repro_torch.serve.pipeline.LMServer`."""
        return self._server
