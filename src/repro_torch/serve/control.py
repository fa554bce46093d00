"""FrontDoor: the serving control plane in front of N replicas (the
counterpart of ``repro/serve/control.py``: admission, router, replicas,
metrics).

:class:`~repro_torch.serve.pipeline.PipelineServer` (dynamic batching) and
:class:`~repro_torch.serve.pipeline.LMServer` (continuous batching) serve
one instance.  The layer above one instance is housekeeping of the
framework as much as device selection is:

* **Admission**: a bounded priority queue.  Every request carries a
  priority class; when the queue is full the overflow policy decides:
  ``"block"`` (the caller waits up to ``block_timeout_s``, then
  :class:`AdmissionRejected`), ``"reject"`` (an immediate
  :class:`AdmissionRejected`) or ``"shed"`` (the oldest queued request of
  the lowest class at or below the new request's level is evicted with a
  ``"shed"`` outcome; more urgent work is never evicted).  Per-class or
  per-request deadlines complete stale requests as ``"timed_out"``
  *before* they are launched, so a backed-up queue spends no device time
  on answers nobody waits for.
* **Routing**: admitted requests go to N :class:`Replica` backends (each
  its own ``CLapp``, from :meth:`repro_torch.core.app.CLapp.split`) by a
  policy: ``"round-robin"``, ``"least-outstanding"``, or ``"profile"``,
  a smooth weighted round-robin whose weights are each replica's
  **measured items/s** (the :class:`~repro_torch.launch.mesh.
  DeviceProfileRegistry` signal that the proportional split reads),
  refined after every completed batch.
* **Observability**: a :class:`Metrics` registry (counters, gauges and
  histograms with label sets, rendered as Prometheus text by
  :meth:`Metrics.render`) and a :meth:`FrontDoor.health` snapshot.  A
  replica whose ``process`` raises is marked unhealthy, its queued work is
  re-routed (up to ``max_retries``), and it is left out of routing until a
  probe succeeds.  A failing replica is never carried on elsewhere (on the
  CPU, say): its requests end as ``"error"`` once their retries are spent.

Usage::

    servers  = [Pipeline(a) | SimpleMRIRecon(a, mode="fused_kernel") for a in app.split(2)]
    replicas = [PipelineReplica(f"r{i}", p.serve(batch=8)) for i, p in enumerate(servers)]
    fd = FrontDoor(replicas, capacity=64, overflow="shed", policy="profile")
    rids = [fd.submit(req, priority="interactive") for req in requests]
    outcomes = fd.drain()           # one Outcome per admitted request
    print(fd.metrics.render())      # Prometheus exposition text
    fd.close()

A :class:`Replica` needs only ``process(payloads) -> results``, so the
same control plane fronts MRI pipelines, LM decode servers, or plain
functions.  One worker thread a replica calls ``process``: on the card two
replicas of one device launch from two threads, which the compiled launch
allows (:func:`repro_torch.core.process.capture_graph`).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import re
import threading
import time
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import torch

from repro_torch.launch.mesh import DeviceProfile

__all__ = [
    "AdmissionRejected", "CallableReplica", "FrontDoor", "Metrics",
    "Outcome", "PipelineReplica", "PriorityClass", "Replica", "Router",
]


# ---------------------------------------------------------------------------
# Metrics: counters / gauges / histograms + Prometheus exposition
# ---------------------------------------------------------------------------

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _label_key(labels: Mapping[str, str]) -> Tuple[Tuple[str, str], ...]:
    for k in labels:
        if not _LABEL_RE.match(k):
            raise ValueError(f"invalid metric label name {k!r}")
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _fmt_labels(key: Tuple[Tuple[str, str], ...],
                extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    items = key + extra
    if not items:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in items)
    return "{" + body + "}"


class _Metric:
    """Common label-set bookkeeping for one named metric."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: Dict[Tuple[Tuple[str, str], ...], Any] = {}

    def _header(self) -> List[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        return lines


class Counter(_Metric):
    """Monotonically increasing count, optionally per label set."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels: str) -> None:
        if value < 0:
            raise ValueError("counters only go up")
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels: str) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))

    def total(self) -> float:
        """Sum over every label set."""
        with self._lock:
            return float(sum(self._series.values()))

    def render(self) -> List[str]:
        with self._lock:
            series = sorted(self._series.items())
        lines = self._header()
        for key, v in series:
            lines.append(f"{self.name}{_fmt_labels(key)} {_num(v)}")
        return lines


class Gauge(_Metric):
    """A value that goes up and down (queue depth, in-flight, liveness)."""

    kind = "gauge"

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._series[_label_key(labels)] = float(value)

    def value(self, **labels: str) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), float("nan")))

    def render(self) -> List[str]:
        with self._lock:
            series = sorted(self._series.items())
        lines = self._header()
        for key, v in series:
            lines.append(f"{self.name}{_fmt_labels(key)} {_num(v)}")
        return lines


class Histogram(_Metric):
    """Sampled observations (latencies), rendered as a Prometheus summary
    with p50/p99/p999 quantiles from
    :meth:`repro_torch.core.process.ProfileParameters.percentile`
    (``np.percentile``, the statistic the JAX package reports)."""

    kind = "summary"
    quantiles = (50.0, 99.0, 99.9)

    def observe(self, value: float, **labels: str) -> None:
        key = _label_key(labels)
        with self._lock:
            prof = self._series.get(key)
            if prof is None:
                from repro_torch.core.process import ProfileParameters
                prof = ProfileParameters(enable=True)
                self._series[key] = prof
            prof.record(float(value))

    def percentile(self, p: float, **labels: str) -> float:
        """p-th percentile of the observations; nan when empty."""
        with self._lock:
            prof = self._series.get(_label_key(labels))
        if prof is None:
            return float("nan")
        return prof.percentile(p)

    def count(self, **labels: str) -> int:
        with self._lock:
            prof = self._series.get(_label_key(labels))
        return 0 if prof is None else len(prof.samples)

    def render(self) -> List[str]:
        with self._lock:
            series = sorted(self._series.items())
        lines = self._header()
        for key, prof in series:
            for q in self.quantiles:
                ql = (("quantile", f"{q / 100.0:.10g}"),)
                lines.append(
                    f"{self.name}{_fmt_labels(key, ql)} "
                    f"{_num(prof.percentile(q))}")
            lines.append(f"{self.name}_count{_fmt_labels(key)} "
                         f"{len(prof.samples)}")
            lines.append(f"{self.name}_sum{_fmt_labels(key)} "
                         f"{_num(sum(prof.samples))}")
        return lines


def _num(v: float) -> str:
    """Prometheus number formatting: integers without a trailing .0."""
    f = float(v)
    if f != f:
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class Metrics:
    """Registry of named metrics.  ``counter``/``gauge``/``histogram``
    get-or-create (re-registering with a different kind raises), and
    :meth:`render` produces the whole registry in Prometheus text
    exposition format — the ``/metrics`` payload of a deployment."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get(Histogram, name, help)

    def render(self) -> str:
        """The registry as Prometheus text exposition (one block per
        metric, label sets sorted — deterministic for tests)."""
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# Requests, priorities, outcomes
# ---------------------------------------------------------------------------

class AdmissionRejected(RuntimeError):
    """The admission queue refused a request: full under the ``reject``
    policy, full of strictly-higher-priority work under ``shed``, or the
    ``block`` wait exceeded ``block_timeout_s``."""

    def __init__(self, msg: str, *, priority: str, reason: str):
        super().__init__(msg)
        self.priority = priority
        #: "full" | "blocked_timeout" | "higher_priority_only"
        self.reason = reason


@dataclasses.dataclass(frozen=True)
class PriorityClass:
    """One admission class.  Lower ``level`` is MORE urgent (dispatched
    first, shed last).  ``deadline_s`` bounds queue staleness: a request
    not *dispatched* within that many seconds of submission completes as
    ``"timed_out"`` instead of occupying a replica."""

    name: str
    level: int
    deadline_s: Optional[float] = None


DEFAULT_CLASSES = (
    PriorityClass("interactive", 0),
    PriorityClass("normal", 1),
    PriorityClass("batch", 2),
)


@dataclasses.dataclass
class Outcome:
    """Terminal record of one admitted request."""

    rid: int
    status: str                     # "ok" | "shed" | "timed_out" | "error"
    priority: str
    submitted_s: float
    completed_s: float
    result: Any = None              # the replica's result when status=="ok"
    replica: Optional[str] = None   # replica that served (or errored) it
    error: Optional[BaseException] = None

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    @property
    def latency_s(self) -> float:
        return self.completed_s - self.submitted_s


@dataclasses.dataclass
class _Ticket:
    rid: int
    payload: Any
    cls: PriorityClass
    submitted_s: float
    deadline_s: Optional[float]     # absolute perf_counter deadline
    attempts: int = 0
    cancelled: bool = False         # lazily removed from the heap

    @property
    def expired(self) -> bool:
        return (self.deadline_s is not None
                and time.perf_counter() > self.deadline_s)


# ---------------------------------------------------------------------------
# Replicas
# ---------------------------------------------------------------------------

class Replica:
    """One serving backend behind the FrontDoor.

    Subclasses implement :meth:`process` — take a list of request
    payloads, return the list of results in the same order.  The base
    class owns the control-plane bookkeeping: an in-flight counter, a
    health flag, and a measured items/s rate (a
    :class:`~repro_torch.launch.mesh.DeviceProfile` EMA fed by the
    FrontDoor after every completed batch: the signal behind the
    ``"profile"`` routing policy)."""

    def __init__(self, name: str, *, max_batch: int = 8,
                 probe_payload: Any = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.name = name
        self.max_batch = max_batch
        self.probe_payload = probe_payload
        self.healthy = True
        self.in_flight = 0              # dispatched to replica, not completed
        self.served = 0
        self.last_error: Optional[BaseException] = None
        # replica-level throughput EMA; lane=-1 marks "whole replica"
        self.profile = DeviceProfile(lane=-1)

    # -- backend contract ---------------------------------------------------
    def process(self, payloads: Sequence[Any]) -> List[Any]:
        raise NotImplementedError

    def probe(self) -> bool:
        """Liveness check used to re-admit an unhealthy replica: run the
        configured ``probe_payload`` through :meth:`process` (or report
        healthy when no probe payload exists — the next real request is
        then the probe)."""
        if self.probe_payload is None:
            return True
        try:
            self.process([self.probe_payload])
        except Exception:       # noqa: BLE001 — any failure = still down
            return False
        return True

    # -- profile plumbing ---------------------------------------------------
    def record(self, items: int, seconds: float) -> None:
        """Fold one completed batch into the replica's rate EMA."""
        self.profile.record(items, seconds)

    @property
    def rate(self) -> float:
        """Measured items/sec (nan while cold)."""
        return self.profile.rate

    def set_rate(self, rate: float) -> None:
        """Seed the rate directly (benchmarks, emulated pools)."""
        self.profile.set_rate(rate)

    def __repr__(self):
        state = "up" if self.healthy else "DOWN"
        return (f"{type(self).__name__}({self.name!r}, {state}, "
                f"in_flight={self.in_flight}, rate={self.rate:.1f}/s)")


class PipelineReplica(Replica):
    """A :class:`~repro_torch.serve.pipeline.PipelineServer` as a FrontDoor
    backend.  Payloads are pipeline requests (one Data, or an ``{edge:
    Data}`` mapping for fan-in graphs); results are the served output
    Data, in request order.  ``max_batch`` is the server's batch size, so
    one FrontDoor dispatch fills at most one batched launch.

    When the replica app's lanes all have a measured rate
    (``split="proportional"`` streams and serves feed them), :attr:`rate`
    is their sum, the measured capacity of the replica's whole mesh, over
    the FrontDoor-side EMA: the ``"profile"`` routing policy and the
    proportional split then read the same signal.  The registry is keyed
    by lane (a position in the app's mesh), so the lanes asked for are
    those of the app's mesh.

    On the card, call ``server.warmup(example)`` before the FrontDoor
    starts: every twin is then captured in the calling thread, and the
    replica's worker thread only replays."""

    def __init__(self, name: str, server, *, probe_request: Any = None):
        super().__init__(name, max_batch=server.batch,
                         probe_payload=probe_request)
        self.server = server

    def process(self, payloads: Sequence[Any]) -> List[Any]:
        rids = [self.server.submit(p) for p in payloads]
        by_rid = {r.rid: r for r in self.server.drain()}
        missing = [rid for rid in rids if rid not in by_rid]
        if missing:
            raise RuntimeError(
                f"replica {self.name!r} dropped requests {missing}")
        return [by_rid[rid].data for rid in rids]

    @property
    def app(self):
        return self.server.pipeline.app

    @property
    def rate(self) -> float:
        lanes = range(len(self.app.mesh.groups))     # the registry's keys
        total = self.app.device_profiles.total_rate(lanes)
        if total == total:          # registry warm: measured lane capacity
            return total
        return self.profile.rate

    def warm_start(self, directory: str, handle, *,
                   step: Optional[int] = None) -> int:
        """Spin-up restore: fill the Data behind ``handle`` (weights,
        sensitivity maps, any static input) from the newest complete
        checkpoint in ``directory`` and upload it to the replica's device.
        Checkpoint contract: a ``{array name: array}`` tree, as written by
        ``save_checkpoint(dir, step, {a.name: ... for a in data})`` of
        either package, in either format (a ``sharded-v1`` checkpoint of
        another mesh shape is assembled); torn steps are skipped for the
        last complete one.  Returns the restored step.

        ``handle`` is the ``DataHandle`` of a registered Data (a live
        update: the arrays are uploaded at once, into the same device
        blob, so a captured launch reads them at its next replay), or the
        bound :class:`~repro_torch.core.data.Data` itself for a replica
        whose server has not built yet, whose build then uploads the
        restored arrays."""
        from repro_torch.ckpt import latest_step, restore_checkpoint
        from repro_torch.core.arena import torch_dtype
        from repro_torch.core.data import Data

        if step is None:
            step = latest_step(directory)
            if step is None:
                raise FileNotFoundError(
                    f"no complete checkpoints in {directory}")
        if isinstance(handle, Data):
            data, handle = handle, None
        else:
            data = self.app.getData(handle)
        like = {a.name: torch.zeros(a.shape, dtype=torch_dtype(a.dtype))
                for a in data}
        restored = restore_checkpoint(directory, like, step=step)
        for a in data:
            a.set_host(restored[a.name])
        if handle is not None:
            self.app.host2device(handle)
        return step


class CallableReplica(Replica):
    """A plain function as a backend, ``fn(payload) -> result`` a request:
    an :class:`~repro_torch.serve.pipeline.LMServer` that serves a prompt
    (``submit`` then ``run``), a custom backend, or a function with a
    synthetic service time that exercises queueing and routing without a
    device."""

    def __init__(self, name: str, fn: Callable[[Any], Any], *,
                 max_batch: int = 1, probe_payload: Any = None):
        super().__init__(name, max_batch=max_batch,
                         probe_payload=probe_payload)
        self.fn = fn

    def process(self, payloads: Sequence[Any]) -> List[Any]:
        return [self.fn(p) for p in payloads]


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------

class Router:
    """Replica selection policy.

    * ``"round-robin"`` — cycle through the healthy replicas.
    * ``"least-outstanding"`` — the healthy replica with the fewest
      dispatched-but-uncompleted requests (ties: the first by name).
    * ``"profile"`` — smooth weighted round-robin with weights
      proportional to each replica's measured items/sec (:attr:`Replica.
      rate`); a cold replica weighs in at the mean warm rate (or 1.0
      when every replica is cold — degenerating to plain round-robin),
      so routing calibrates itself as the proportional batch split does:
      the first dispatches measure, every later one is carved by what the
      replicas delivered.
    """

    POLICIES = ("round-robin", "least-outstanding", "profile")

    def __init__(self, policy: str = "least-outstanding"):
        if policy not in self.POLICIES:
            raise ValueError(
                f"unknown routing policy {policy!r}: expected one of "
                f"{list(self.POLICIES)}")
        self.policy = policy
        self._rr = 0
        self._wrr: Dict[str, float] = {}    # smooth-WRR current weights

    def pick(self, replicas: Sequence[Replica]) -> Replica:
        """Choose among the given (healthy) replicas."""
        if not replicas:
            raise ValueError("no replicas to route to")
        if len(replicas) == 1:
            return replicas[0]
        if self.policy == "round-robin":
            r = replicas[self._rr % len(replicas)]
            self._rr += 1
            return r
        if self.policy == "least-outstanding":
            return min(replicas, key=lambda r: (r.in_flight, r.name))
        return self._pick_weighted(replicas)

    def weights(self, replicas: Sequence[Replica]) -> List[float]:
        """Effective profile weights: measured rate, cold -> mean warm
        rate (or 1.0 when everything is cold)."""
        rates = [r.rate for r in replicas]
        warm = [x for x in rates if x == x and x > 0]
        fallback = (sum(warm) / len(warm)) if warm else 1.0
        return [x if (x == x and x > 0) else fallback for x in rates]

    def _pick_weighted(self, replicas: Sequence[Replica]) -> Replica:
        # nginx-style smooth weighted round-robin: deterministic, and over
        # any window the pick counts converge to the weight proportions
        weights = self.weights(replicas)
        total = sum(weights)
        best, best_cur = None, float("-inf")
        for r, w in zip(replicas, weights):
            cur = self._wrr.get(r.name, 0.0) + w
            self._wrr[r.name] = cur
            if cur > best_cur:
                best, best_cur = r, cur
        self._wrr[best.name] -= total
        return best


# ---------------------------------------------------------------------------
# FrontDoor
# ---------------------------------------------------------------------------

class FrontDoor:
    """Priority admission + replica routing + metrics, in front of N
    :class:`Replica` backends.  See the module docstring for the model;
    the knobs:

    ``capacity``
        Bound on the number of *queued* (admitted, not yet dispatched)
        requests.  Backpressure begins here.
    ``overflow``
        ``"block"`` | ``"reject"`` | ``"shed"`` — what a full queue does
        to a new ``submit()``.
    ``policy``
        Routing policy name, see :class:`Router`.
    ``classes``
        Iterable of :class:`PriorityClass`; defaults to ``interactive(0)
        / normal(1) / batch(2)`` with no deadlines.
    ``block_timeout_s``
        Longest a ``submit()`` may block under ``overflow="block"``
        before raising :class:`AdmissionRejected`.
    ``probe_interval_s``
        How often an unhealthy replica is probed for recovery.
    ``max_retries``
        How many times a request bounced by a replica failure is
        re-routed before completing as ``"error"``.
    ``auto_start``
        Start the dispatcher/worker threads on the first ``submit()``
        (default).  ``False`` queues submissions until an explicit
        :meth:`start` — lets tests (and pre-warm flows) admit a whole
        priority mix before any dispatch happens.

    ``dispatch_ahead``
        How many requests a replica's private inbox may hold before the
        dispatcher stops handing it more (default: one batch,
        ``max_batch``).  ``None`` dispatches **eagerly** — every queued
        request is routed the moment it is admitted.

    Dispatch is **demand-bounded** by default: a replica is handed at
    most one batch beyond what it is currently processing, so the
    priority queue — not a replica's private backlog — holds the waiting
    work, a late high-priority request overtakes queued lower classes,
    and a busy replica's slowness steers traffic away from it no matter
    the policy (join-shortest-queue behaviour).  Eager dispatch is the
    opposite trade: routing commits immediately (what a front-end before
    *remote* replicas, which cannot see queue depths, has to do), so the
    routing policy alone decides the split: that is where
    ``policy="profile"`` pays on a skewed pool.
    """

    def __init__(self, replicas: Sequence[Replica], *,
                 capacity: int = 64, overflow: str = "block",
                 policy: str = "least-outstanding",
                 classes: Optional[Sequence[PriorityClass]] = None,
                 default_class: Optional[str] = None,
                 block_timeout_s: float = 30.0,
                 probe_interval_s: float = 0.05,
                 max_retries: int = 1,
                 metrics: Optional[Metrics] = None,
                 auto_start: bool = True,
                 dispatch_ahead: Optional[int] = ...):
        if not replicas:
            raise ValueError("FrontDoor needs at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"replica names must be unique, got {names}")
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if overflow not in ("block", "reject", "shed"):
            raise ValueError(
                f"unknown overflow policy {overflow!r}: expected "
                "'block' | 'reject' | 'shed'")
        self.replicas = list(replicas)
        self.capacity = capacity
        self.overflow = overflow
        self.router = Router(policy)
        self.block_timeout_s = block_timeout_s
        self.probe_interval_s = probe_interval_s
        self.max_retries = max_retries
        cls_list = list(classes) if classes is not None \
            else list(DEFAULT_CLASSES)
        self.classes: Dict[str, PriorityClass] = {c.name: c for c in cls_list}
        if len(self.classes) != len(cls_list):
            raise ValueError("priority class names must be unique")
        if default_class is not None:
            self.default_class = default_class
        elif classes is None:
            self.default_class = "normal"
        else:
            # custom class list: default to the median urgency level
            by_level = sorted(cls_list, key=lambda c: c.level)
            self.default_class = by_level[(len(by_level) - 1) // 2].name
        if self.default_class not in self.classes:
            raise ValueError(f"default class {self.default_class!r} not in "
                             f"{sorted(self.classes)}")

        self.metrics = metrics if metrics is not None else Metrics()
        m = self.metrics
        self._m_admitted = m.counter(
            "frontdoor_requests_admitted_total", "requests admitted per class")
        self._m_rejected = m.counter(
            "frontdoor_requests_rejected_total", "admissions refused per class")
        self._m_shed = m.counter(
            "frontdoor_requests_shed_total", "queued requests evicted per class")
        self._m_timed_out = m.counter(
            "frontdoor_requests_timed_out_total",
            "requests dropped past their deadline per class")
        self._m_completed = m.counter(
            "frontdoor_requests_completed_total", "requests served per class")
        self._m_errored = m.counter(
            "frontdoor_requests_errored_total",
            "requests failed after retries per class")
        self._m_requeued = m.counter(
            "frontdoor_requests_requeued_total",
            "requests re-routed off a failing replica")
        self._m_depth = m.gauge(
            "frontdoor_queue_depth", "admitted requests waiting for dispatch")
        self._m_in_flight = m.gauge(
            "frontdoor_replica_in_flight", "dispatched, not yet completed")
        self._m_healthy = m.gauge(
            "frontdoor_replica_healthy", "1 = routing, 0 = excluded")
        self._m_rate = m.gauge(
            "frontdoor_replica_rate_items_per_s", "measured replica items/sec")
        self._m_dispatched = m.counter(
            "frontdoor_replica_dispatched_total", "requests routed per replica")
        self._m_latency = m.histogram(
            "frontdoor_request_latency_seconds",
            "submit-to-complete latency per replica")
        self._m_depth.set(0)
        for r in self.replicas:
            self._m_healthy.set(1.0, replica=r.name)
            self._m_in_flight.set(0, replica=r.name)

        self._cv = threading.Condition()
        self._heap: List[Tuple[int, int, _Ticket]] = []
        self._queued = 0                # live (non-cancelled) heap entries
        self._seq = itertools.count()
        self._next_rid = 0
        self._outstanding = 0           # admitted, no terminal Outcome yet
        self._completed: List[Outcome] = []
        self._inboxes: Dict[str, List[_Ticket]] = {r.name: []
                                                   for r in self.replicas}
        self._probe_due: Dict[str, float] = {}
        if dispatch_ahead is not ... and dispatch_ahead is not None \
                and dispatch_ahead < 1:
            raise ValueError(
                f"dispatch_ahead must be >= 1 (or None for eager "
                f"dispatch), got {dispatch_ahead}")
        self.dispatch_ahead = dispatch_ahead
        self._closed = False        # no more admissions; flush continues
        self._stopping = False      # thread-exit signal, set after flush
        self._threads: List[threading.Thread] = []
        self._started = False
        self.auto_start = auto_start

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "FrontDoor":
        """Start the dispatcher and per-replica worker threads (idempotent;
        ``submit()`` auto-starts)."""
        with self._cv:
            if self._started:
                return self
            self._started = True
            self._threads = [threading.Thread(
                target=self._dispatch_loop, name="frontdoor-dispatch",
                daemon=True)]
            for r in self.replicas:
                self._threads.append(threading.Thread(
                    target=self._replica_loop, args=(r,),
                    name=f"frontdoor-{r.name}", daemon=True))
            for t in self._threads:
                t.start()
        return self

    def close(self, timeout: Optional[float] = None) -> None:
        """Stop admitting, flush outstanding work (up to ``timeout``; an
        all-unhealthy pool stops the wait early instead of hanging),
        complete anything unfinishable as ``"error"``, and join the
        threads.  Idempotent and thread-safe."""
        with self._cv:
            already = self._closed
            self._closed = True
            self._cv.notify_all()
        deadline = None if timeout is None \
            else time.perf_counter() + timeout
        if not already:
            with self._cv:
                while self._outstanding > 0 and self._started:
                    processing = any(
                        r.in_flight > len(self._inboxes[r.name])
                        for r in self.replicas)
                    if not any(r.healthy for r in self.replicas) \
                            and not processing:
                        break       # nothing can make progress any more
                    if not any(t.is_alive() for t in self._threads):
                        break       # workers gone: nobody left to flush
                    rem = None if deadline is None \
                        else deadline - time.perf_counter()
                    if rem is not None and rem <= 0:
                        break
                    self._cv.wait(timeout=0.05 if rem is None
                                  else min(rem, 0.05))
                # abandon whatever could not finish (down pool / timeout)
                leftovers = [t for _, _, t in self._heap if not t.cancelled]
                for box in self._inboxes.values():
                    leftovers.extend(box)
                    box.clear()
                self._heap.clear()
                self._queued = 0
                self._m_depth.set(0)
                for r in self.replicas:
                    r.in_flight = 0
                    self._m_in_flight.set(0, replica=r.name)
                for t in leftovers:
                    self._complete_locked(
                        t, "error",
                        error=RuntimeError(
                            "FrontDoor closed before dispatch"))
                self._stopping = True   # flush done: threads may exit
                self._cv.notify_all()
        threads, self._threads = self._threads, []
        for t in threads:
            t.join(timeout=5.0)

    def __enter__(self) -> "FrontDoor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- admission
    def submit(self, payload: Any, *, priority: Optional[str] = None,
               deadline_s: Optional[float] = None) -> int:
        """Admit one request under the queue's capacity/overflow policy;
        returns its rid.  ``priority`` names a configured class;
        ``deadline_s`` (seconds from now until *dispatch*) overrides the
        class deadline.  Raises :class:`AdmissionRejected` when the
        policy refuses the request."""
        if self.auto_start:
            self.start()
        name = priority if priority is not None else self.default_class
        cls = self.classes.get(name)
        if cls is None:
            raise ValueError(f"unknown priority class {name!r}: expected "
                             f"one of {sorted(self.classes)}")
        now = time.perf_counter()
        dl = deadline_s if deadline_s is not None else cls.deadline_s
        abs_dl = None if dl is None else now + dl
        block_deadline = now + self.block_timeout_s
        with self._cv:
            if self._closed:
                raise RuntimeError(
                    "FrontDoor is closed; no new requests are admitted")
            while self._queued >= self.capacity:
                if self.overflow == "reject":
                    self._m_rejected.inc(**{"class": name})
                    raise AdmissionRejected(
                        f"admission queue full ({self.capacity}); "
                        f"request of class {name!r} rejected",
                        priority=name, reason="full")
                if self.overflow == "shed":
                    victim = self._shed_victim_locked(cls.level)
                    if victim is None:
                        self._m_rejected.inc(**{"class": name})
                        raise AdmissionRejected(
                            f"admission queue full of higher-priority work; "
                            f"request of class {name!r} rejected",
                            priority=name, reason="higher_priority_only")
                    victim.cancelled = True
                    self._queued -= 1
                    self._m_shed.inc(**{"class": victim.cls.name})
                    self._complete_locked(victim, "shed")
                    continue
                # block: wait for the dispatcher to make room
                rem = block_deadline - time.perf_counter()
                if rem <= 0 or not self._cv.wait(timeout=rem):
                    self._m_rejected.inc(**{"class": name})
                    raise AdmissionRejected(
                        f"admission blocked > {self.block_timeout_s:.3f}s "
                        f"(queue full at {self.capacity}); request of class "
                        f"{name!r} rejected", priority=name,
                        reason="blocked_timeout")
                if self._closed:
                    raise RuntimeError(
                        "FrontDoor closed while blocked on admission")
            rid = self._next_rid
            self._next_rid += 1
            ticket = _Ticket(rid, payload, cls, now, abs_dl)
            heapq.heappush(self._heap, (cls.level, next(self._seq), ticket))
            self._queued += 1
            self._outstanding += 1
            self._m_admitted.inc(**{"class": name})
            self._m_depth.set(self._queued)
            self._cv.notify_all()
        return rid

    def _shed_victim_locked(self, new_level: int) -> Optional[_Ticket]:
        """Oldest queued ticket of the lowest-priority class whose level
        is >= the incoming request's (shed never evicts strictly more
        urgent work)."""
        victim = None
        for _, seq, t in self._heap:
            if t.cancelled or t.cls.level < new_level:
                continue
            if victim is None or (t.cls.level, -seq) > \
                    (victim[0].cls.level, -victim[1]):
                victim = (t, seq)
        return None if victim is None else victim[0]

    # ------------------------------------------------------------ completion
    def _complete_locked(self, ticket: _Ticket, status: str, *,
                         result: Any = None, replica: Optional[str] = None,
                         error: Optional[BaseException] = None,
                         completed_s: Optional[float] = None) -> None:
        out = Outcome(
            rid=ticket.rid, status=status, priority=ticket.cls.name,
            submitted_s=ticket.submitted_s,
            completed_s=completed_s if completed_s is not None
            else time.perf_counter(),
            result=result, replica=replica, error=error)
        self._completed.append(out)
        self._outstanding -= 1
        if status == "ok":
            self._m_completed.inc(**{"class": ticket.cls.name})
        elif status == "timed_out":
            self._m_timed_out.inc(**{"class": ticket.cls.name})
        elif status == "error":
            self._m_errored.inc(**{"class": ticket.cls.name})
        # "shed" is counted at the eviction site (it knows the victim class)
        self._cv.notify_all()

    def collect(self, n: Optional[int] = None,
                timeout: Optional[float] = None) -> List[Outcome]:
        """Take terminal outcomes.  Blocks until ``n`` are available (or
        ``timeout`` elapses); ``n=None`` returns whatever is ready now.
        Works after :meth:`close` (leftover outcomes stay retrievable)."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._cv:
            while n is not None and len(self._completed) < n:
                rem = None if deadline is None \
                    else deadline - time.perf_counter()
                if rem is not None and rem <= 0:
                    break
                if self._closed and self._outstanding == 0:
                    break
                self._cv.wait(timeout=rem)
            out, self._completed = self._completed, []
        return out

    def drain(self, timeout: Optional[float] = None) -> List[Outcome]:
        """Block until every admitted request has a terminal outcome (or
        ``timeout`` elapses), then return all uncollected outcomes."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._cv:
            while self._outstanding > 0:
                rem = None if deadline is None \
                    else deadline - time.perf_counter()
                if rem is not None and rem <= 0:
                    break
                self._cv.wait(timeout=rem)
            out, self._completed = self._completed, []
        return out

    @property
    def outstanding(self) -> int:
        with self._cv:
            return self._outstanding

    @property
    def queue_depth(self) -> int:
        with self._cv:
            return self._queued

    # ------------------------------------------------------------ dispatcher
    def _healthy_locked(self) -> List[Replica]:
        return [r for r in self.replicas if r.healthy]

    def _dispatch_loop(self) -> None:
        while True:
            with self._cv:
                # demand-bounded dispatch: wait until work exists AND some
                # healthy replica has room for another batch, so waiting
                # requests stay in the PRIORITY queue instead of piling up
                # behind a routing decision that was made too early
                while True:
                    if self._stopping:
                        return      # close() finished its flush wait
                    ready = [r for r in self._healthy_locked()
                             if self._has_room_locked(r)]
                    if self._queued > 0 and ready:
                        break
                    self._cv.wait(timeout=0.05)
                ticket = self._pop_ticket_locked()
                self._m_depth.set(self._queued)
                if ticket.expired:
                    self._complete_locked(ticket, "timed_out")
                    continue
                replica = self.router.pick(ready)
                self._inboxes[replica.name].append(ticket)
                replica.in_flight += 1
                self._m_in_flight.set(replica.in_flight,
                                      replica=replica.name)
                self._m_dispatched.inc(replica=replica.name)
                self._cv.notify_all()

    def _has_room_locked(self, replica: Replica) -> bool:
        if self.dispatch_ahead is None:
            return True                         # eager: route immediately
        limit = replica.max_batch if self.dispatch_ahead is ... \
            else self.dispatch_ahead
        return len(self._inboxes[replica.name]) < limit

    def _pop_ticket_locked(self) -> Optional[_Ticket]:
        while self._heap:
            _, _, t = heapq.heappop(self._heap)
            if t.cancelled:
                continue
            self._queued -= 1
            return t
        return None

    # -------------------------------------------------------- replica worker
    def _replica_loop(self, replica: Replica) -> None:
        box = self._inboxes[replica.name]
        while True:
            probe_after = None
            with self._cv:
                while True:
                    if not replica.healthy:
                        probe_after = self._probe_due.get(replica.name, 0.0)
                        break
                    if box:
                        break
                    if self._stopping:
                        return      # close() finished its flush wait
                    self._cv.wait(timeout=0.05)
                if not replica.healthy:
                    batch = []
                else:
                    batch = [box.pop(0)
                             for _ in range(min(len(box),
                                                replica.max_batch))]
            if not replica.healthy:
                if self._stopping:
                    return
                wait = probe_after - time.perf_counter()
                if wait > 0:
                    time.sleep(min(wait, 0.05))
                    continue
                if replica.probe():
                    with self._cv:
                        replica.healthy = True
                        replica.last_error = None
                        self._m_healthy.set(1.0, replica=replica.name)
                        self._cv.notify_all()
                else:
                    self._probe_due[replica.name] = \
                        time.perf_counter() + self.probe_interval_s
                continue

            # deadline check at dispatch: stale tickets never hit the device
            live: List[_Ticket] = []
            with self._cv:
                for t in batch:
                    if t.expired:
                        replica.in_flight -= 1
                        self._complete_locked(t, "timed_out")
                    else:
                        live.append(t)
                self._m_in_flight.set(replica.in_flight,
                                      replica=replica.name)
            if not live:
                continue

            t0 = time.perf_counter()
            error: Optional[BaseException] = None
            results: List[Any] = []
            try:
                results = replica.process([t.payload for t in live])
                if len(results) != len(live):
                    raise RuntimeError(
                        f"replica {replica.name!r} returned "
                        f"{len(results)} results for {len(live)} requests")
            except Exception as e:      # noqa: BLE001 — fault isolation
                error = e
            dt = time.perf_counter() - t0

            if error is None:
                replica.record(len(live), dt)
                done = time.perf_counter()
                with self._cv:
                    for t, res in zip(live, results):
                        replica.in_flight -= 1
                        replica.served += 1
                        self._m_latency.observe(done - t.submitted_s,
                                                replica=replica.name)
                        self._complete_locked(t, "ok", result=res,
                                              replica=replica.name,
                                              completed_s=done)
                    self._m_in_flight.set(replica.in_flight,
                                          replica=replica.name)
                    self._m_rate.set(replica.rate, replica=replica.name)
            else:
                # graceful degradation: mark unhealthy, bounce the batch
                # (and everything else queued here) back through admission
                with self._cv:
                    replica.healthy = False
                    replica.last_error = error
                    self._probe_due[replica.name] = \
                        time.perf_counter() + self.probe_interval_s
                    self._m_healthy.set(0.0, replica=replica.name)
                    bounced = live + box
                    box.clear()
                    replica.in_flight -= len(bounced)
                    self._m_in_flight.set(replica.in_flight,
                                          replica=replica.name)
                    for t in bounced:
                        t.attempts += 1
                        if t.attempts > self.max_retries:
                            self._complete_locked(t, "error",
                                                  replica=replica.name,
                                                  error=error)
                        else:
                            self._m_requeued.inc()
                            heapq.heappush(
                                self._heap,
                                (t.cls.level, next(self._seq), t))
                            self._queued += 1
                    self._m_depth.set(self._queued)
                    self._cv.notify_all()

    # ---------------------------------------------------------------- health
    def health(self) -> Dict[str, Any]:
        """Liveness/readiness snapshot: overall ``ok`` (any healthy
        replica), queue depth, and per-replica state incl. measured rate
        and latency percentiles."""
        with self._cv:
            replicas = {}
            for r in self.replicas:
                replicas[r.name] = {
                    "healthy": r.healthy,
                    "in_flight": r.in_flight,
                    "served": r.served,
                    "rate_items_per_s": r.rate,
                    "p50_ms": self._m_latency.percentile(
                        50.0, replica=r.name) * 1e3,
                    "p99_ms": self._m_latency.percentile(
                        99.0, replica=r.name) * 1e3,
                    "last_error": None if r.last_error is None
                    else repr(r.last_error),
                }
            return {
                "ok": any(r.healthy for r in self.replicas),
                "closed": self._closed,
                "queue_depth": self._queued,
                "outstanding": self._outstanding,
                "replicas": replicas,
            }
