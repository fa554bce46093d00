"""Slot-based continuous batching for autoregressive decode
(``repro/serve/pipeline.py``'s :class:`LMServer`; ``PipelineServer``, the
request/response loop over Data-set pipelines, is a later slice).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.app import CLapp
from repro_torch.core.data import Data
from repro_torch.core.graph import Pipeline
from repro_torch.core.process import ProfileParameters
from repro_torch.processes import lm as lmp
from .engine import SamplingConfig


class PromptTooLongError(ValueError):
    """A prompt does not fit the server's cache capacity: a prompt of ``T``
    tokens prefills positions ``0..T-1`` and every generated token needs
    one more, so ``1 <= T <= max_len - 1``.  Raised by
    :meth:`LMServer.submit` before the request is queued."""

    def __init__(self, prompt_len: int, max_len: int):
        super().__init__(
            f"prompt of {prompt_len} token(s) does not fit the cache capacity "
            f"max_len={max_len}: need 1 <= len(prompt) <= {max_len - 1} (prefill fills "
            "len(prompt) positions and each generated token needs one more)")
        self.prompt_len = prompt_len
        self.max_len = max_len


class LMServer:
    """Continuous batching over the rows (slots) of one persistent,
    device-resident decode state (:func:`repro_torch.processes.lm.
    decode_state_data`), built from Pipeline processes:

    * **admission**: a queued prompt claims a free slot: a per-prompt-
      length prefill :class:`~repro_torch.core.graph.Pipeline` fills a
      batch-1 row state on the device, and an in-place
      :class:`~repro_torch.processes.lm.CacheSplice` writes it into the
      slot.  Every prefill pipe writes the same row Data (the JAX package
      gives each its own), so the row states take one row's memory.
    * **decode**: one in-place :class:`~repro_torch.processes.lm.DecodeStep`
      launch per token advances every active slot.  On the card the first
      step runs eagerly and every later one replays one CUDA graph of the
      whole step (:meth:`~repro_torch.core.process.Process.launch`; the
      step's ``captures`` and ``replays`` count them).  The only per-step
      host traffic is the (B, 1) token readback, and the state never moves
      host to device (``app.h2d_bytes`` of ``state_h`` stays 0, and
      ``decode_profile`` records no ``"transfer"``).  The prefill, the
      splice and the release are never captured (their classes set
      ``graphed = False``): every prompt's prefill runs eagerly, also at a
      length seen before.
    * **release**: a finished request retires its slot with an in-place
      :class:`~repro_torch.processes.lm.SlotRelease`.

    It serves both ported families unchanged: the dense decoder (its state
    a K/V cache per slot) and RWKV6 (the ssm family: two shift vectors and
    the (H, D, D) WKV state per layer and slot, spliced like the stacked
    K/V leaves on their slot axis 1).

    Decoding is greedy (the argmax runs on the device); stochastic sampling
    is rejected at construction.  ``weights`` is a parameter tree or a
    weights Data (:func:`~repro_torch.processes.lm.weights_data`,
    :func:`repro_torch.interop.params_from_reference`).  Without ``app``
    the server runs on the CUDA card (``CLapp().init()`` never falls back
    to the CPU).  Encoder-decoder models (whisper) are a later slice.
    """

    def __init__(self, model, weights: Any, *, batch: int, max_len: int,
                 sampling: Optional[SamplingConfig] = None, app: Optional[CLapp] = None):
        self.sampling = sampling if sampling is not None else SamplingConfig()
        if self.sampling.temperature > 0 or self.sampling.top_k:
            raise NotImplementedError(
                "LMServer decodes greedily on the device; temperature/top_k sampling is "
                "not wired into the device-resident path")
        self.model = model
        self.batch, self.max_len = batch, max_len
        self.app = app if app is not None else CLapp().init()
        wdata, self._wcodec = lmp.resolve_weights(model, weights)
        self._weights_h = self.app.addData(wdata)
        self.state, self._ccodec = lmp.decode_state_data(model, batch, max_len)
        self.state_h = self.app.addData(self.state, to_device=False)
        self._row, _ = lmp.decode_state_data(model, 1, max_len)
        self._row_h = self.app.addData(self._row, to_device=False)
        self.decode_pipe = Pipeline(self.app) | lmp.DecodeStep(
            self.app, model, self._wcodec, self._ccodec, max_len=max_len).bind(
                infile=self.state_h, outfile=self.state_h, weights=self._weights_h)
        self.decode_pipe.build()
        self._prefill_pipes: Dict[int, Pipeline] = {}     # prompt length -> pipe
        self._splice: Dict[int, lmp.CacheSplice] = {}
        self._release: Dict[int, lmp.SlotRelease] = {}
        # host bookkeeping, as the JAX LMServer keeps it
        self.active = np.zeros(batch, dtype=bool)
        self.positions = np.zeros(batch, dtype=np.int32)
        self.req_of_slot = np.full(batch, -1, dtype=np.int64)
        self.results: List[List[int]] = []
        self.queue: List[tuple] = []
        self.steps = 0
        self.admitted = 0
        #: one sample per prefill launch, prompt uploads under "transfer"
        self.prefill_profile = ProfileParameters(enable=True)
        #: one sample per decode step; its "transfer" phase stays empty
        self.decode_profile = ProfileParameters(enable=True)

    # -- request lifecycle ----------------------------------------------------
    def submit(self, prompt: Sequence[int]) -> int:
        """Queue one request; raises :class:`PromptTooLongError` unless
        ``1 <= len(prompt) <= max_len - 1``."""
        prompt = [int(t) for t in prompt]
        if not 1 <= len(prompt) <= self.max_len - 1:
            raise PromptTooLongError(len(prompt), self.max_len)
        rid = len(self.results)
        self.results.append([])
        self.queue.append((rid, prompt))
        return rid

    def _prefill_pipe(self, length: int) -> Pipeline:
        pipe = self._prefill_pipes.get(length)
        if pipe is None:
            proc = lmp.PrefillProcess(self.app, self.model, self._wcodec, self._ccodec,
                                      max_len=self.max_len)
            pipe = Pipeline(self.app) | proc.bind(infile="tokens", outfile=self._row_h,
                                                  weights=self._weights_h)
            self._prefill_pipes[length] = pipe
        return pipe

    def _admit(self) -> None:
        """Claim free slots for queued prompts: a single-row prefill, then
        an in-place splice into the slot."""
        for slot in np.where(~self.active)[0]:
            if not self.queue:
                break
            slot = int(slot)
            rid, prompt = self.queue.pop(0)
            toks = Data({"tokens": np.asarray(prompt, np.int32)[None, :]})
            row = self._prefill_pipe(len(prompt)).run(toks, sync=False,
                                                      profile=self.prefill_profile)
            tok = int(row.device_view("token")[0, 0])
            sp = self._splice.get(slot)
            if sp is None:
                sp = lmp.CacheSplice(self.app, slot)
                sp.in_handles["in"] = self.state_h
                sp.in_handles["row"] = self._row_h
                sp.out_handle = self.state_h
                self._splice[slot] = sp
            sp.launch()
            self.active[slot] = True
            self.positions[slot] = len(prompt)
            self.req_of_slot[slot] = rid
            self.results[rid] = [tok]
            self.admitted += 1

    def _release_slot(self, slot: int) -> None:
        rl = self._release.get(slot)
        if rl is None:
            rl = lmp.SlotRelease(self.app, slot)
            rl.in_handles["in"] = self.state_h
            rl.out_handle = self.state_h
            self._release[slot] = rl
        rl.launch()

    # -- decode ----------------------------------------------------------------
    def step(self) -> None:
        """Admit whatever fits, then one batched decode step for every
        active slot (a single in-place launch)."""
        self._admit()
        if not self.active.any():
            return
        self.decode_pipe.run(None, sync=False, profile=self.decode_profile)
        self.steps += 1
        new = self.state.device_view("token").cpu().numpy()       # (B, 1) readback
        for slot in np.where(self.active)[0]:
            slot = int(slot)
            t = int(new[slot, 0])
            rid = int(self.req_of_slot[slot])
            self.results[rid].append(t)
            self.positions[slot] += 1
            done = self.sampling.eos_id is not None and t == self.sampling.eos_id
            if done or len(self.results[rid]) >= self.sampling.max_new_tokens:
                self.active[slot] = False
                self._release_slot(slot)

    def run(self, max_steps: int = 10_000) -> List[List[int]]:
        steps = 0
        while (self.queue or self.active.any()) and steps < max_steps:
            self.step()
            steps += 1
        return self.results
