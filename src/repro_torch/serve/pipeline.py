"""Request/response serving over a built operator Pipeline, and
slot-based continuous batching for autoregressive decode (the counterpart
of ``repro/serve/pipeline.py``).

:class:`PipelineServer` serves Data-set workloads (MRI reconstructions,
image operators):

    admission queue  ->  dynamic batcher  ->  batched launches

* **Admission**: ``submit()`` validates the request against the
  pipeline's input edges and takes a host snapshot of it (numpy only: it
  makes no CUDA call, so a submitting thread never disturbs a capture in
  the worker thread below) and queues it.  A fan-in pipeline takes a
  **multi-tensor request**: one Data per input edge, as an ``{edge ->
  Data}`` mapping.
* **Dynamic batching**: ``drain()`` groups what is pending into batches of
  up to ``batch`` rows per input edge, row-aligned across edges; a
  partial batch follows the streaming executor's ragged-tail policy
  (:class:`repro_torch.core.stream._BatchPlan`): padded by repetition when
  the waste is small, else launched by a twin for its row count.
  Requests submitted while a drain runs are taken by the same drain.
* **Transfer/compute overlap**: each batch goes through the streaming
  executor's pinned upload slots (:class:`repro_torch.core.stream.
  StreamQueue`, one per input edge): the next batch uploads while this one
  computes.
* **Flush timeout**: with ``flush_timeout`` (seconds) a background thread
  serves on its own: a full batch launches at once, a partial one once
  its oldest request waited ``flush_timeout``.  Responses are taken with
  :meth:`PipelineServer.collect` (or a final ``drain()``); ``close()``
  flushes what is left and stops the thread.  On the card the worker
  thread launches, so any twin not captured yet is captured there (in
  thread-local capture mode, :func:`repro_torch.core.process.
  capture_graph`, so other threads' CUDA calls carry on meanwhile).
  :meth:`PipelineServer.warmup` captures every twin the server can use
  before the thread starts; after it, the worker captures nothing.  A
  worker's error reaches every later caller.

Each response carries its request id and the wall-clock latency from
``submit()`` to the result on the device being complete.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.app import CLapp
from repro_torch.core.data import Data
from repro_torch.core.graph import Pipeline
from repro_torch.core.process import PortError, ProfileParameters, _Phases, _PhaseView
from repro_torch.core.stream import _BatchPlan, _check_policy, _edge_blobs, _result
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


@dataclasses.dataclass
class ServeResponse:
    """One served result: the output Data plus latency accounting."""

    rid: int
    data: Data
    submitted_s: float          # perf_counter at submit()
    completed_s: float          # perf_counter when the result was complete

    @property
    def latency_s(self) -> float:
        return self.completed_s - self.submitted_s


@dataclasses.dataclass
class _Request:
    rid: int
    blobs: Tuple[Any, ...]      # host snapshots (numpy), one per input edge
    submitted_s: float


class PipelineServer:
    """Serving front end for one :class:`repro_torch.core.graph.Pipeline`.

    Usage::

        server = pipe.serve(batch=8)
        rids = [server.submit(kdata) for kdata in requests]
        responses = server.drain()          # a ServeResponse per request

        # fan-in pipeline: one Data per input edge
        rid = server.submit({"kspace": kd, "smaps": sm})

        # latency-sensitive: a background thread with a partial-batch flush
        server = pipe.serve(batch=8, flush_timeout=0.010)
        server.warmup(example)               # captures before the thread runs
        rids = [server.submit(r) for r in requests]
        responses = server.collect(len(rids), timeout=5.0)
        server.close()

    The pipeline is built from the first request (or the ``warmup``
    example), or reused if already built; every launch goes through the
    executor's twins of :mod:`repro_torch.core.stream`, kept for the
    server's life.  ``sharded``, ``split="proportional"`` and ``lanes``
    carve each batch over the lanes of the app's mesh as a stream does
    (:meth:`repro_torch.core.process.Process.stream`): each lane's share
    through its own twins and upload queue, the split vector shared by
    every input edge.  ``warmup()`` captures every lane's twins of the
    balanced and the current split vector; a proportional vector that
    shifts later may set up (and capture) a new twin in the thread that
    drains."""

    def __init__(self, pipeline, *, batch: int = 8, sharded: bool = False, depth: int = 2,
                 tail_waste_threshold: float = 0.5, split: str = "equal",
                 lanes: bool = False, flush_timeout: Optional[float] = None):
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        if flush_timeout is not None and flush_timeout <= 0:
            raise ValueError(f"flush_timeout must be > 0 seconds, got {flush_timeout}")
        self.pipeline = pipeline
        self.batch = batch
        self.depth = depth
        self.tail_waste_threshold = tail_waste_threshold
        self.flush_timeout = flush_timeout
        _check_policy(sharded, split, lanes)
        self.sharded, self.split, self.lanes = sharded, split, lanes
        self._pending: Deque[_Request] = deque()
        self._next_rid = 0
        self._plan: Optional[_BatchPlan] = None
        self._built = None
        self.served = 0             # completed requests
        self.launches = 0           # batched launches issued
        # background drain state (flush_timeout mode)
        self._cv = threading.Condition()
        self._completed: List[ServeResponse] = []
        self._worker: Optional[threading.Thread] = None
        self._busy = False          # the worker is launching a group
        self._force_flush = False
        self._stop_flag = False
        self._closed = False
        self._worker_error: Optional[BaseException] = None

    # ------------------------------------------------------------ lifecycle
    def _ensure_built(self, request: Any) -> None:
        if self._plan is not None:
            return
        built = self.pipeline.build(request)
        plan = _BatchPlan(built.executor, self.batch, depth=self.depth,
                          tail_waste_threshold=self.tail_waste_threshold,
                          sharded=self.sharded, split=self.split, lanes=self.lanes).init()
        plan.prepare_aux()
        self._built, self._plan = built, plan

    @property
    def pending(self) -> int:
        with self._cv:
            return len(self._pending)

    @property
    def input_edges(self) -> Tuple[str, ...]:
        """The input edges in the order requests are batched in."""
        if self._built is None:
            raise RuntimeError("server not built yet (submit a request)")
        return self._built.input_order

    def warmup(self, example: Any = None) -> None:
        """Set up and launch, on whatever their inputs hold, every twin a
        drain can use (the full batch and each partial-flush row count the
        ragged-tail policy can pick, in every upload slot, on every lane of
        a carved server) until it replays a graph: on the card each is
        captured here, in the calling thread, and never in the background
        thread.  ``example`` (a request) builds
        the pipeline when no request was submitted yet.  Call it before the
        first ``submit()`` of a ``flush_timeout`` server."""
        with self._cv:
            if self._worker is not None:
                raise RuntimeError("warmup() after the background thread started: call it "
                                   "before the first submit()")
        if self._plan is None:
            if example is None:
                raise RuntimeError("server not built yet (submit a request or pass an example)")
            self._ensure_built(example)
        plan = self._plan
        for rows in sorted({plan.launch_rows(r) for r in range(1, self.batch + 1)}):
            for bp in plan.twins_for(rows):
                bp.warmup()
        plan.synchronize()

    # ------------------------------------------------------------ admission
    def _pack_request(self, request: Any) -> Tuple[Any, ...]:
        """Normalise and validate one request into per-edge host snapshots,
        naming graph edges and raising PortError."""
        item = self.pipeline._item_tuple(self._built, request, what="request")
        if isinstance(item, Data):
            item = (item,)
        return _edge_blobs(item, self._plan.launchable, what="request",
                           names=self._built.input_order, err=PortError, pack=True)

    def submit(self, request: Any) -> int:
        """Admit one request: validate, snapshot, queue; returns its id.
        With ``flush_timeout`` this also starts the background thread
        (once) and wakes it."""
        self._ensure_built(request)
        blobs = self._pack_request(request)
        with self._cv:
            self._check_closed()
            self._check_worker_error()
            rid = self._next_rid
            self._next_rid += 1
            self._pending.append(_Request(rid, blobs, time.perf_counter()))
            if self.flush_timeout is not None:
                if self._worker is None:
                    self._worker = threading.Thread(target=self._worker_loop,
                                                    name="pipeline-server-drain", daemon=True)
                    self._worker.start()
                self._cv.notify_all()
        return rid

    def _check_closed(self) -> None:
        """(Caller holds the lock.)  A closed server neither admits nor
        serves."""
        if self._closed:
            raise RuntimeError("server is closed (close() was called); create a new server "
                               "via pipe.serve()")

    def _check_worker_error(self) -> None:
        """(Caller holds the lock.)  A failure in the background thread is
        terminal: every later caller gets it."""
        if self._worker_error is not None:
            raise RuntimeError("the background drain thread died; the server cannot serve any "
                               "more requests (requests of the failing batch were dropped)"
                               ) from self._worker_error

    # ------------------------------------------------------------- serving
    def _responses_for(self, group: Sequence[_Request], out, t_done: float
                       ) -> List[ServeResponse]:
        la = self._plan.launchable
        rows = self._plan.split_output(out)[:len(group)]
        self.launches += 1
        return [ServeResponse(rid=req.rid, data=_result(la.out_layout, blob),
                              submitted_s=req.submitted_s, completed_s=t_done)
                for req, blob in zip(group, rows)]

    def drain(self) -> List[ServeResponse]:
        """Serve every pending request (including ones admitted while the
        drain runs); the responses in launch order.  With the background
        thread running this forces a flush of any partial batch, waits for
        the thread to go idle and returns what it completed and nobody
        collected."""
        with self._cv:
            self._check_closed()
        if self._worker is not None:
            with self._cv:
                self._force_flush = True
                self._cv.notify_all()
                while (self._pending or self._busy) and self._worker_error is None:
                    self._cv.wait()
                self._check_worker_error()
                self._force_flush = False
                out, self._completed = self._completed, []
            return out
        if self._plan is None or not self._pending:
            return []
        plan = self._plan
        tail = len(self._pending) % self.batch
        if tail:
            plan.precompile(tail)       # before the loop: never stalls it
        groups: Deque[List[_Request]] = deque()

        def group_iter():
            while True:
                with self._cv:
                    if not self._pending:
                        return
                    group: List[_Request] = []
                    while self._pending and len(group) < self.batch:
                        group.append(self._pending.popleft())
                groups.append(group)
                yield [r.blobs for r in group]

        responses: List[ServeResponse] = []
        for out, _ in plan.run(group_iter()):  # the next batch uploads while this runs
            plan.synchronize()                 # latency: the result is complete
            responses.extend(self._responses_for(groups.popleft(), out, time.perf_counter()))
        if plan.proportional:
            plan.harvest()                     # the launches ran: their rates
        self.served += len(responses)
        return responses

    # ------------------------------------------- background drain (timeout)
    def _worker_loop(self) -> None:
        plan = self._plan
        while True:
            with self._cv:
                while True:
                    if self._pending:
                        n = len(self._pending)
                        if n >= self.batch or self._force_flush or self._stop_flag:
                            break
                        waited = time.perf_counter() - self._pending[0].submitted_s
                        remaining = self.flush_timeout - waited
                        if remaining <= 0:
                            break           # the oldest request timed out: flush
                        self._cv.wait(timeout=remaining)
                    else:
                        if self._stop_flag:
                            return
                        self._cv.wait()
                k = min(len(self._pending), self.batch)
                group = [self._pending.popleft() for _ in range(k)]
                self._busy = True
            responses: List[ServeResponse] = []
            error: Optional[BaseException] = None
            try:
                for out, _ in plan.run(iter([[r.blobs for r in group]])):
                    plan.synchronize()
                    responses = self._responses_for(group, out, time.perf_counter())
                if plan.proportional:
                    plan.harvest()
            except BaseException as e:    # noqa: BLE001 -- reaches the callers
                error = e
            finally:
                # responses (or the error) land in the same lock transition that
                # clears busy: a drain() cannot see idle-but-empty, nor hang on a
                # dead worker
                with self._cv:
                    self._completed.extend(responses)
                    self.served += len(responses)
                    self._busy = False
                    if error is not None:
                        self._worker_error = error
                    self._cv.notify_all()
            if error is not None:
                return

    def collect(self, n: Optional[int] = None,
                timeout: Optional[float] = None) -> List[ServeResponse]:
        """Take completed responses from the background thread, waiting for
        at least ``n`` (or ``timeout`` seconds); ``n=None`` takes what is
        ready.  Needs ``flush_timeout``: without the thread only ``drain()``
        produces responses."""
        if self.flush_timeout is None:
            raise RuntimeError("collect() needs the background drain thread "
                               "(flush_timeout=...); without it use drain()")
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._cv:
            self._check_closed()
            while n is not None and len(self._completed) < n:
                self._check_worker_error()
                rem = None if deadline is None else deadline - time.perf_counter()
                if rem is not None and rem <= 0:
                    break
                self._cv.wait(timeout=rem)
            out, self._completed = self._completed, []
        return out

    def close(self) -> None:
        """Stop the background thread after it flushed what is pending, and
        mark the server closed (later ``submit``/``drain``/``collect``
        raise).  Idempotent; a server without ``flush_timeout`` has nothing
        to close and stays usable."""
        if self.flush_timeout is None:
            return
        with self._cv:
            self._closed = True
            worker, self._worker = self._worker, None
            if worker is None:
                return
            self._stop_flag = True
            self._cv.notify_all()
        worker.join()

    def __enter__(self) -> "PipelineServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class LMServer:
    """Continuous batching over the rows (slots) of one persistent,
    device-resident decode state (:func:`repro_torch.processes.lm.
    decode_state_data`), built from Pipeline processes:

    * **admission**: a queued prompt claims a free slot: a per-prompt-
      length prefill :class:`~repro_torch.core.graph.Pipeline` fills a
      batch-1 row state on the device, and an in-place
      :class:`~repro_torch.processes.lm.CacheSplice` writes it into the
      slot.  Every prefill pipe writes the same row Data (the JAX package
      gives each its own), and for Whisper reads the same frames Data, so
      the row states take one row's memory and the frames one request's,
      however many prompt lengths the server has seen.
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

    It serves every family unchanged: the decoder (dense, MoE, MLA; the
    VLM text-only, as the JAX ``LMServer`` serves it: a request brings no
    patches), its state a K/V cache per slot; RWKV6 (the ssm family: two
    shift vectors and the (H, D, D) WKV state per layer and slot, spliced
    like the stacked K/V leaves on their slot axis 1); Zamba2 (hybrid: the
    shared block's K/V and each Mamba2 layer's conv window and SSM state,
    (n_super, per_super, B, ...), spliced on slot axis 2); and Whisper (encdec: a request
    brings its audio frames to :meth:`submit`, uploaded with its prompt
    into the server's one frames Data, which every prefill pipe's frames
    port reads; the prefill encodes them and writes
    the cross K/V of ``enc_len`` encoder positions into the row, which the
    splice writes into the slot, so a replayed decode step reads each
    slot's own cross cache).

    Decoding is greedy (the argmax runs on the device); stochastic sampling
    is rejected at construction.  ``weights`` is a parameter tree or a
    weights Data (:func:`~repro_torch.processes.lm.weights_data`,
    :func:`repro_torch.interop.params_from_reference`).  Without ``app``
    the server runs on the CUDA card (``CLapp().init()`` never falls back
    to the CPU).
    """

    def __init__(self, model, weights: Any, *, batch: int, max_len: int,
                 sampling: Optional[SamplingConfig] = None, enc_len: Optional[int] = None,
                 app: Optional[CLapp] = None):
        self.sampling = sampling if sampling is not None else SamplingConfig()
        if self.sampling.temperature > 0 or self.sampling.top_k:
            raise NotImplementedError(
                "LMServer decodes greedily on the device; temperature/top_k sampling is "
                "not wired into the device-resident path")
        self.model = model
        self.batch, self.max_len = batch, max_len
        self.enc_len = enc_len
        self.encdec = model.cfg.family == "encdec"
        if self.encdec and enc_len is None:
            raise ValueError("encoder-decoder models need enc_len")
        self.app = app if app is not None else CLapp().init()
        wdata, self._wcodec = lmp.resolve_weights(model, weights)
        self._weights_h = self.app.addData(wdata)
        self.state, self._ccodec = lmp.decode_state_data(model, batch, max_len, enc_len)
        self.state_h = self.app.addData(self.state, to_device=False)
        #: one sample per prefill launch; "transfer" for the zero decode
        #: state (here, before any launch; the JAX LMServer's first splice
        #: uploads it) and for each prompt (and its frames); "compute" for
        #: each prefill launch and each cache splice (the JAX package's
        #: counts)
        self.prefill_profile = ProfileParameters(enable=True)
        zero = _Phases(self.app.device)
        self.app.host2device(self.state_h, zero)
        zero.end_transfers()
        zero.read(self.prefill_profile)
        self._row, _ = lmp.decode_state_data(model, 1, max_len, enc_len)
        self._row_h = self.app.addData(self._row, to_device=False)
        if self.encdec:
            self._frames = Data({"frames": np.zeros((1, enc_len, model.cfg.d_model),
                                                    np.float32)})
            self._frames_h = self.app.addData(self._frames, to_device=False)
        self.decode_pipe = Pipeline(self.app) | lmp.DecodeStep(
            self.app, model, self._wcodec, self._ccodec, max_len=max_len,
            enc_len=enc_len).bind(
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
        #: one sample per decode step; "compute" for each step and each slot
        #: release; its "transfer" phase stays empty
        self.decode_profile = ProfileParameters(enable=True)

    # -- request lifecycle ----------------------------------------------------
    def submit(self, prompt: Sequence[int], frames: Optional[np.ndarray] = None) -> int:
        """Queue one request.  ``frames`` (T_enc, D) or (1, T_enc, D) is
        required for encoder-decoder models, rejected otherwise.  Raises
        :class:`PromptTooLongError` unless ``1 <= len(prompt) <= max_len -
        1``, and ``ValueError`` for frames that do not cover ``enc_len``
        encoder positions."""
        prompt = [int(t) for t in prompt]
        if not 1 <= len(prompt) <= self.max_len - 1:
            raise PromptTooLongError(len(prompt), self.max_len)
        if self.encdec and frames is None:
            raise ValueError(
                "encoder-decoder models take per-request frames")
        if not self.encdec and frames is not None:
            raise ValueError(f"{self.model.cfg.family!r} models take no "
                             "frames")
        if frames is not None:
            frames = np.asarray(frames, np.float32)
            if frames.ndim == 2:
                frames = frames[None]
            if frames.shape[1] != self.enc_len:
                raise ValueError(
                    f"frames cover {frames.shape[1]} encoder positions "
                    f"but the decode state was compiled for "
                    f"enc_len={self.enc_len}")
        rid = len(self.results)
        self.results.append([])
        self.queue.append((rid, prompt, frames))
        return rid

    def _prefill_pipe(self, length: int) -> Pipeline:
        pipe = self._prefill_pipes.get(length)
        if pipe is None:
            proc = lmp.PrefillProcess(self.app, self.model, self._wcodec, self._ccodec,
                                      max_len=self.max_len)
            ports = {"frames": self._frames_h} if self.encdec else {}
            pipe = Pipeline(self.app) | proc.bind(infile="tokens", outfile=self._row_h,
                                                  weights=self._weights_h, **ports)
            self._prefill_pipes[length] = pipe
        return pipe

    def _admit(self) -> None:
        """Claim free slots for queued prompts: a single-row prefill, then
        an in-place splice into the slot."""
        for slot in np.where(~self.active)[0]:
            if not self.queue:
                break
            slot = int(slot)
            rid, prompt, frames = self.queue.pop(0)
            toks = Data({"tokens": np.asarray(prompt, np.int32)[None, :]})
            pipe = self._prefill_pipe(len(prompt))
            if self.encdec:
                # into the one frames blob: the copy stream waits for the
                # launches queued before, so no earlier prefill reads it late
                t0 = time.perf_counter()
                self._frames.get_ndarray(0).set_host(frames)
                self.app.host2device(self._frames_h)
                self.app.wait_transfers()
                self.prefill_profile.record_phase("transfer", time.perf_counter() - t0)
            row = pipe.run(toks, sync=False, profile=self.prefill_profile)
            tok = int(row.device_view("token")[0, 0])
            sp = self._splice.get(slot)
            if sp is None:
                sp = lmp.CacheSplice(self.app, slot)
                sp.in_handles["in"] = self.state_h
                sp.in_handles["row"] = self._row_h
                sp.out_handle = self.state_h
                self._splice[slot] = sp
            sp.launch(_PhaseView(self.prefill_profile))   # phases only: samples are prefills
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
        rl.launch(_PhaseView(self.decode_profile))      # phases only: samples are steps

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
