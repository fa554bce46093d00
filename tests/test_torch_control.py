"""The port's serving control plane (``repro_torch.serve.control``) against
the JAX package's (``repro.serve.control``) on the CPU.

* ``Metrics.render()`` gives the same text byte for byte for one script of
  ``inc`` / ``set`` / ``observe`` calls (labels, NaN, large and fractional
  values).
* ``Router`` picks the same replica sequence under each policy for seeded
  rates and in-flight counts.
* Every FrontDoor scenario of ``tests/test_control.py`` (overflow policies,
  priority order, deadlines, demand-bounded and eager dispatch, health and
  probe recovery, metrics accounting, validation) runs through both
  packages' ``FrontDoor`` over ``CallableReplica``s: each rid ends with the
  same status, and each scenario's other observations (service order,
  counters, served counts, error messages) are equal.  The scenarios wait
  on events and on conditions polled up to a bound (:func:`_until`), never
  on the length of a sleep.
* ``PipelineReplica``s of a SMOKE ``SimpleMRIRecon`` on ``CLapp.split``
  apps: routed results bit for bit the port's direct server, within rtol
  1e-4 of the JAX package's ``PipelineReplica``s; a fault injected into a
  replica's server is requeued and the replica recovers through its probe;
  ``rate`` reads the lanes of the replica app's mesh.
* ``warm_start`` restores a checkpoint written by either package (legacy
  and ``sharded-v1``) byte for byte, before and after the server built.
* ``repro_torch.launch.serve_lm.serve_front_door`` with the JAX package's
  qwen3-14b SMOKE weights (``interop.params_from_reference``) gives the
  JAX front door's tokens for every rid.
* Two threads launching compiled processes through the capture seam
  (``process.capture_graph``) each see their own compile mesh and their
  own capture tally, and ``capture_graph`` captures in thread-local mode
  with one capture at a time on a device.
"""
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro import ckpt as jckpt
from repro import core as jcore
from repro import processes as jproc
from repro.serve import control as jctl
import repro_torch.core as tcore
from repro_torch import interop
from repro_torch.ckpt import save_checkpoint
from repro_torch.configs import get_smoke
from repro_torch.configs.mri_recon import SMOKE
from repro_torch.core import (CLapp, Data, DeviceTraits, DeviceType, Pipeline, Port, Process,
                              XData, process, registry)
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.kernels import negate as _negate  # noqa: F401  (registers negate_kernel)
from repro_torch.processes import SimpleMRIRecon
from repro_torch.serve import control as tctl

PACKAGES = {"jax": jctl, "port": tctl}
SHAPE = (SMOKE.frames, SMOKE.coils, SMOKE.height, SMOKE.width)
JAX_TOL = dict(rtol=1e-4, atol=1e-4)
WAIT_S = 10.0                   # bound on every wait for an event or condition


def _until(pred, what, timeout=WAIT_S):
    """Poll ``pred`` until it holds; fail naming ``what`` after ``timeout``."""
    deadline = time.perf_counter() + timeout
    while not pred():
        if time.perf_counter() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


def _cpu_app():
    return CLapp().init(device_traits=DeviceTraits(type=DeviceType.CPU))


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _metrics_script(ctl, seed):
    """One seeded script of registry calls; returns ``render()``."""
    rng = np.random.default_rng(seed)
    m = ctl.Metrics()
    c = m.counter("frontdoor_requests_admitted_total", "requests admitted per class")
    g = m.gauge("frontdoor_replica_rate_items_per_s", "measured replica items/sec")
    h = m.histogram("frontdoor_request_latency_seconds", "submit-to-complete latency")
    u = m.counter("zz_untitled_total")
    m.histogram("empty_seconds", "never observed")
    for i in range(40):
        labels = {"class": ["interactive", "normal", "batch"][int(rng.integers(3))]}
        if i % 4 == 0:
            labels["replica"] = f"r{int(rng.integers(3))}"
        c.inc(float(rng.integers(1, 4)) if i % 3 else 0.1 * (i + 1), **labels)
        g.set([float("nan"), 2.0 ** 60, -3.25, 7.0, 1e-7][i % 5],
              replica=f"r{i % 3}")
        h.observe(float(rng.exponential(0.02)), replica=f"r{i % 2}")
        if i % 7 == 0:
            u.inc()
    g.set(float("nan"))
    return m.render()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_render_byte_equal(seed):
    text = _metrics_script(tctl, seed)
    assert text == _metrics_script(jctl, seed)
    assert "NaN" in text and text.endswith("\n")
    assert 'quantile="0.999"' in text


def test_metrics_values_and_errors_match():
    for ctl in PACKAGES.values():
        m = ctl.Metrics()
        h = m.histogram("latency_seconds")
        for v in [0.01, 0.02, 0.03, 0.04]:
            h.observe(v, replica="r0")
        assert h.count(replica="r0") == 4
        assert h.percentile(50.0, replica="r0") == pytest.approx(0.025)
        assert np.isnan(h.percentile(50.0, replica="absent"))
        assert np.isnan(m.gauge("depth").value())
        with pytest.raises(ValueError, match="only go up"):
            m.counter("requests_total").inc(-1)
        with pytest.raises(ValueError, match="already registered"):
            m.gauge("requests_total")
        with pytest.raises(ValueError, match="invalid metric name"):
            m.counter("bad-name")
        with pytest.raises(ValueError, match="invalid metric label name"):
            m.counter("ok_total").inc(**{"bad-label": "x"})
    assert tctl.Metrics().render() == jctl.Metrics().render() == ""


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------

def _router_picks(ctl, policy, seed, n=300):
    rng = np.random.default_rng(seed)
    reps = [ctl.CallableReplica(name, lambda p: p) for name in ("r2", "r0", "r1", "r3")]
    rates = rng.uniform(10.0, 400.0, size=len(reps))
    for r, rate in zip(reps, rates):
        if rate > 60.0:              # the others stay cold: the mean warm rate
            r.set_rate(float(rate))
    router = ctl.Router(policy)
    picks = []
    for i in range(n):
        for r in reps:
            r.in_flight = int(rng.integers(0, 4))
        pool = [r for r in reps if rng.random() > 0.2] or reps[:1]
        picks.append(router.pick(pool).name)
        if i == n // 2:               # rates drift mid-run
            reps[1].set_rate(float(rng.uniform(10.0, 400.0)))
    return picks, router.weights(reps)


@pytest.mark.parametrize("policy", ["round-robin", "least-outstanding", "profile"])
@pytest.mark.parametrize("seed", [0, 1])
def test_router_sequences_equal(policy, seed):
    picks, weights = _router_picks(tctl, policy, seed)
    assert (picks, weights) == _router_picks(jctl, policy, seed)
    assert len(set(picks)) > 1


def test_router_profile_split_and_errors():
    for ctl in PACKAGES.values():
        fast, slow = ctl.CallableReplica("fast", None), ctl.CallableReplica("slow", None)
        fast.set_rate(300.0)
        slow.set_rate(100.0)
        r = ctl.Router("profile")
        picks = [r.pick([fast, slow]).name for _ in range(40)]
        assert picks.count("fast") == 30 and picks.count("slow") == 10
        assert ctl.Router("profile").weights(
            [ctl.CallableReplica("a", None), ctl.CallableReplica("b", None)]) == [1.0, 1.0]
        with pytest.raises(ValueError, match="unknown routing policy"):
            ctl.Router("fastest-first")
        with pytest.raises(ValueError, match="no replicas"):
            ctl.Router().pick([])


# ---------------------------------------------------------------------------
# FrontDoor scenarios, run through both packages
# ---------------------------------------------------------------------------

class Gate:
    """A replica function that blocks until opened; ``entered`` counts the
    calls that reached it."""

    def __init__(self):
        self.open = threading.Event()
        self.entered = 0
        self.served = []
        self._lock = threading.Lock()

    def __call__(self, p):
        with self._lock:
            self.entered += 1
        if not self.open.wait(WAIT_S):
            raise RuntimeError("gate never opened")
        with self._lock:
            self.served.append(p)
        return p


def _gated(ctl, capacity, overflow, **kw):
    """A FrontDoor whose one replica blocks on a gate: two interactive
    plugs fill the service slot and the one-batch-ahead inbox, so every
    later submit waits in the admission queue."""
    gate = Gate()
    fd = ctl.FrontDoor([ctl.CallableReplica("r", gate, max_batch=1)],
                       capacity=capacity, overflow=overflow, **kw)
    plugs = [fd.submit("plug-0", priority="interactive")]
    _until(lambda: gate.entered == 1, "the worker to take plug-0")
    plugs.append(fd.submit("plug-1", priority="interactive"))
    _until(lambda: fd.queue_depth == 0, "the dispatcher to route plug-1")
    return fd, gate, plugs


def _statuses(fd, timeout=WAIT_S):
    outs = fd.drain(timeout=timeout)
    return {o.rid: o.status for o in outs}, outs


def _counter(fd, name, **labels):
    return fd.metrics.counter(name).value(**labels)


def sc_reject_full(ctl):
    fd, gate, plugs = _gated(ctl, 2, "reject")
    try:
        a, b = fd.submit("a"), fd.submit("b")
        with pytest.raises(ctl.AdmissionRejected) as exc:
            fd.submit("c")
        gate.open.set()
        st, _ = _statuses(fd)
        return dict(statuses=st, rids=plugs + [a, b], reason=exc.value.reason,
                    priority=exc.value.priority,
                    rejected=_counter(fd, "frontdoor_requests_rejected_total",
                                      **{"class": "normal"}))
    finally:
        gate.open.set()
        fd.close()


def sc_block_times_out(ctl):
    fd, gate, plugs = _gated(ctl, 1, "block", block_timeout_s=0.15)
    try:
        a = fd.submit("a")
        t0 = time.perf_counter()
        with pytest.raises(ctl.AdmissionRejected) as exc:
            fd.submit("b")
        waited = time.perf_counter() - t0 >= 0.1
        gate.open.set()
        c = fd.submit("c")             # room is made: a blocked submit admits
        st, _ = _statuses(fd)
        return dict(statuses=st, rids=plugs + [a, c], reason=exc.value.reason, waited=waited)
    finally:
        gate.open.set()
        fd.close()


def sc_shed_oldest_lowest(ctl):
    fd, gate, plugs = _gated(ctl, 2, "shed")
    try:
        old = fd.submit("old-batch", priority="batch")
        new = fd.submit("new-batch", priority="batch")
        hi = fd.submit("urgent", priority="interactive")
        gate.open.set()
        st, outs = _statuses(fd)
        shed = [(o.rid, o.priority, o.ok) for o in outs if o.status == "shed"]
        return dict(statuses=st, shed=shed, order=gate.served,
                    shed_total=_counter(fd, "frontdoor_requests_shed_total",
                                        **{"class": "batch"}),
                    rids=[old, new, hi])
    finally:
        gate.open.set()
        fd.close()


def sc_shed_never_evicts_urgent(ctl):
    fd, gate, plugs = _gated(ctl, 2, "shed")
    try:
        fd.submit("hi-1", priority="interactive")
        fd.submit("hi-2", priority="interactive")
        with pytest.raises(ctl.AdmissionRejected) as exc:
            fd.submit("lowly", priority="batch")
        gate.open.set()
        st, _ = _statuses(fd)
        return dict(statuses=st, reason=exc.value.reason)
    finally:
        gate.open.set()
        fd.close()


def sc_closed_rejects(ctl):
    fd = ctl.FrontDoor([ctl.CallableReplica("r", lambda p: p)])
    rid = fd.submit(1)
    st, _ = _statuses(fd)
    fd.close()
    with pytest.raises(RuntimeError, match="closed") as exc:
        fd.submit(2)
    fd.close()                         # idempotent
    return dict(statuses=st, rid=rid, error=str(exc.value))


def sc_priority_order(ctl):
    order = []
    fd = ctl.FrontDoor([ctl.CallableReplica("r", lambda p: order.append(p) or p, max_batch=1)],
                       capacity=16, auto_start=False)
    for p, cls in [("b1", "batch"), ("n1", "normal"), ("i1", "interactive"),
                   ("b2", "batch"), ("i2", "interactive")]:
        fd.submit(p, priority=cls)
    depth = fd.queue_depth
    fd.start()
    st, _ = _statuses(fd)
    fd.close()
    return dict(statuses=st, order=order, depth=depth)


def sc_unknown_priority(ctl):
    fd = ctl.FrontDoor([ctl.CallableReplica("r", lambda p: p)], auto_start=False)
    with pytest.raises(ValueError, match="unknown priority class") as exc:
        fd.submit(1, priority="vip")
    fd.close()
    return dict(error=str(exc.value), outcomes=len(fd.collect()))


def sc_deadline_expiry(ctl):
    gate = Gate()
    fd = ctl.FrontDoor([ctl.CallableReplica("r", gate, max_batch=1)], capacity=16,
                       classes=[ctl.PriorityClass("rt", 0, deadline_s=0.05),
                                ctl.PriorityClass("bg", 1)], default_class="bg")
    try:
        first = fd.submit("first", priority="bg")
        _until(lambda: gate.entered == 1, "the worker to take the first request")
        t0 = time.perf_counter()
        stale = fd.submit("stale", priority="rt")
        _until(lambda: time.perf_counter() > t0 + 0.06, "the rt deadline to pass")
        gate.open.set()
        st, outs = _statuses(fd)
        return dict(statuses=st, rids=[first, stale], served=gate.served,
                    timed_out=_counter(fd, "frontdoor_requests_timed_out_total",
                                       **{"class": "rt"}))
    finally:
        gate.open.set()
        fd.close()


def sc_per_request_deadline(ctl):
    gate = Gate()
    fd = ctl.FrontDoor([ctl.CallableReplica("r", gate, max_batch=1)], capacity=16)
    try:
        first = fd.submit("first")
        _until(lambda: gate.entered == 1, "the worker to take the first request")
        t0 = time.perf_counter()
        stale = fd.submit("stale", deadline_s=0.03)
        fresh = fd.submit("fresh")
        _until(lambda: time.perf_counter() > t0 + 0.04, "the request's deadline to pass")
        gate.open.set()
        st, _ = _statuses(fd)
        return dict(statuses=st, rids=[first, stale, fresh], served=gate.served)
    finally:
        gate.open.set()
        fd.close()


def sc_eager_profile_split(ctl):
    gate = Gate()
    fast, slow = ctl.CallableReplica("fast", gate), ctl.CallableReplica("slow", gate)
    fast.set_rate(300.0)
    slow.set_rate(100.0)
    fd = ctl.FrontDoor([fast, slow], capacity=40, policy="profile", dispatch_ahead=None,
                       auto_start=False)
    for i in range(40):
        fd.submit(i)
    fd.start()
    _until(lambda: fd.queue_depth == 0, "every request to be routed")
    gate.open.set()
    st, _ = _statuses(fd)
    fd.close()
    return dict(statuses=st, served={"fast": fast.served, "slow": slow.served},
                dispatched=[_counter(fd, "frontdoor_replica_dispatched_total", replica=n)
                            for n in ("fast", "slow")])


def sc_demand_bounded(ctl):
    gate = Gate()
    fd = ctl.FrontDoor([ctl.CallableReplica("r", gate, max_batch=2)], capacity=16)
    try:
        rids = [fd.submit(i) for i in range(6)]
        _until(lambda: gate.entered == 1 and len(fd._inboxes["r"]) == 2,
               "one batch in service and one batch dispatched ahead")
        held = fd.queue_depth >= 2    # 6 less a batch in service and one ahead
        gate.open.set()
        st, _ = _statuses(fd)
        return dict(statuses=st, rids=rids, held=held, served=gate.served)
    finally:
        gate.open.set()
        fd.close()


def sc_unhealthy_recovers(ctl):
    broken = threading.Event()
    broken.set()

    def flaky(p):
        if broken.is_set():
            raise RuntimeError("injected replica failure")
        return p + 100

    flk = ctl.CallableReplica("flaky", flaky, probe_payload=0)
    ok = ctl.CallableReplica("ok", lambda p: p + 100)
    fd = ctl.FrontDoor([flk, ok], capacity=16, policy="round-robin",
                       probe_interval_s=0.02, max_retries=3)
    try:
        rids = [fd.submit(i) for i in range(6)]
        st, outs = _statuses(fd)
        results = sorted((o.rid, o.result) for o in outs)
        requeued = _counter(fd, "frontdoor_requests_requeued_total") > 0
        h = fd.health()
        down = (h["ok"], h["replicas"]["flaky"]["healthy"],
                "injected" in h["replicas"]["flaky"]["last_error"],
                fd.metrics.gauge("frontdoor_replica_healthy").value(replica="flaky"))
        broken.clear()
        _until(lambda: flk.healthy, "the probe to readmit the replica")
        again = [fd.submit(50), fd.submit(51)]
        st2, _ = _statuses(fd)
        return dict(statuses=st, rids=rids, results=results, requeued=requeued, down=down,
                    again={r: st2[r] for r in again},
                    healthy_after=fd.health()["replicas"]["flaky"]["healthy"])
    finally:
        fd.close()


def sc_whole_pool_down(ctl):
    def broken(p):
        raise RuntimeError("always down")

    fd = ctl.FrontDoor([ctl.CallableReplica("b", broken)], capacity=4,
                       probe_interval_s=0.01, max_retries=2)
    try:
        rid = fd.submit(1)
        st, outs = _statuses(fd)
        err = [o for o in outs if o.rid == rid][0]
        # no health check here: a replica with no probe payload is readmitted
        # probe_interval_s (10 ms) after its last failure, so "ok" races drain()
        return dict(statuses=st, error="always down" in repr(err.error), replica=err.replica,
                    errored=_counter(fd, "frontdoor_requests_errored_total",
                                     **{"class": "normal"}),
                    requeued=_counter(fd, "frontdoor_requests_requeued_total"))
    finally:
        fd.close()


def sc_close_with_down_pool(ctl):
    def broken(p):
        raise RuntimeError("down")

    fd = ctl.FrontDoor([ctl.CallableReplica("b", broken, probe_payload=1)], capacity=4,
                       probe_interval_s=10.0, max_retries=100)
    rid = fd.submit(1)
    t0 = time.perf_counter()
    fd.close(timeout=5.0)
    quick = time.perf_counter() - t0 < 5.0
    outs = fd.collect()
    return dict(statuses={o.rid: o.status for o in outs}, rid=rid, quick=quick,
                closed=fd.health()["closed"])


def sc_metrics_accounting(ctl):
    fd, gate, plugs = _gated(ctl, 2, "shed")
    try:
        fd.submit(0, priority="batch")
        fd.submit(1, priority="batch")
        fd.submit(2, priority="interactive")
        gate.open.set()
        st, _ = _statuses(fd)
        m = fd.metrics
        health = fd.health()
        return dict(
            statuses=st,
            totals=[m.counter(f"frontdoor_requests_{k}_total").total()
                    for k in ("admitted", "completed", "shed", "timed_out", "errored",
                              "rejected", "requeued")],
            depth=m.gauge("frontdoor_queue_depth").value(),
            latencies=m.histogram("frontdoor_request_latency_seconds").count(replica="r"),
            dispatched=m.counter("frontdoor_replica_dispatched_total").value(replica="r"),
            in_flight=m.gauge("frontdoor_replica_in_flight").value(replica="r"),
            health=(health["queue_depth"], health["outstanding"],
                    health["replicas"]["r"]["served"], health["replicas"]["r"]["p50_ms"] > 0))
    finally:
        gate.open.set()
        fd.close()


def sc_rate_self_calibrates(ctl):
    r = ctl.CallableReplica("r", lambda p: p)
    cold = r.rate != r.rate
    fd = ctl.FrontDoor([r], capacity=8)
    try:
        for i in range(4):
            fd.submit(i)
        st, _ = _statuses(fd)
        return dict(statuses=st, cold=cold, warm=r.rate > 0,
                    gauge=fd.metrics.gauge("frontdoor_replica_rate_items_per_s")
                    .value(replica="r") > 0)
    finally:
        fd.close()


def sc_validation(ctl):
    echo = ctl.CallableReplica
    cases = [((), {}), ((echo("a", None), echo("a", None)), {}),
             ((echo("a", None),), dict(capacity=0)),
             ((echo("a", None),), dict(overflow="drop-newest")),
             ((echo("a", None),), dict(dispatch_ahead=0)),
             ((echo("a", None),), dict(default_class="vip")),
             ((echo("a", None),), dict(classes=[ctl.PriorityClass("x", 0),
                                                ctl.PriorityClass("x", 1)]))]
    errors = []
    for reps, kw in cases:
        with pytest.raises(ValueError) as exc:
            ctl.FrontDoor(list(reps), **kw)
        errors.append(str(exc.value))
    with pytest.raises(ValueError, match="max_batch"):
        echo("a", None, max_batch=0)
    fd = ctl.FrontDoor([echo("a", None)], classes=[ctl.PriorityClass("hi", 0),
                                                   ctl.PriorityClass("mid", 1),
                                                   ctl.PriorityClass("lo", 2)],
                       auto_start=False)
    return dict(errors=errors, default=fd.default_class)


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_reject_full, sc_block_times_out, sc_shed_oldest_lowest, sc_shed_never_evicts_urgent,
    sc_closed_rejects, sc_priority_order, sc_unknown_priority, sc_deadline_expiry,
    sc_per_request_deadline, sc_eager_profile_split, sc_demand_bounded, sc_unhealthy_recovers,
    sc_whole_pool_down, sc_close_with_down_pool, sc_metrics_accounting,
    sc_rate_self_calibrates, sc_validation)}

#: what each scenario must show (the reference test's assertions), beside
#: the two packages agreeing
EXPECT = {
    "reject_full": lambda r: (set(r["statuses"].values()) == {"ok"}
                              and sorted(r["statuses"]) == sorted(r["rids"])
                              and r["reason"] == "full" and r["priority"] == "normal"
                              and r["rejected"] == 1),
    "block_times_out": lambda r: (r["reason"] == "blocked_timeout" and r["waited"]
                                  and set(r["statuses"].values()) == {"ok"}),
    "shed_oldest_lowest": lambda r: ([r["statuses"][x] for x in r["rids"]]
                                     == ["shed", "ok", "ok"]
                                     and r["shed"] == [(r["rids"][0], "batch", False)]
                                     and r["shed_total"] == 1
                                     and r["order"] == ["plug-0", "plug-1", "urgent",
                                                        "new-batch"]),
    "shed_never_evicts_urgent": lambda r: (r["reason"] == "higher_priority_only"
                                           and set(r["statuses"].values()) == {"ok"}),
    "closed_rejects": lambda r: r["statuses"] == {r["rid"]: "ok"} and "closed" in r["error"],
    "priority_order": lambda r: (r["order"] == ["i1", "i2", "n1", "b1", "b2"]
                                 and r["depth"] == 5
                                 and set(r["statuses"].values()) == {"ok"}),
    "unknown_priority": lambda r: r["outcomes"] == 0,
    "deadline_expiry": lambda r: (r["statuses"][r["rids"][1]] == "timed_out"
                                  and r["served"] == ["first"] and r["timed_out"] == 1),
    "per_request_deadline": lambda r: ([r["statuses"][x] for x in r["rids"]]
                                       == ["ok", "timed_out", "ok"]
                                       and "stale" not in r["served"]),
    "eager_profile_split": lambda r: (r["served"] == {"fast": 30, "slow": 10}
                                      and r["dispatched"] == [30, 10]
                                      and set(r["statuses"].values()) == {"ok"}),
    "demand_bounded": lambda r: (r["held"] and set(r["statuses"].values()) == {"ok"}
                                 and r["served"] == list(range(6))),
    "unhealthy_recovers": lambda r: ([r["statuses"][x] for x in r["rids"]] == ["ok"] * 6
                                     and r["results"] == [(i, i + 100) for i in range(6)]
                                     and r["requeued"] and r["down"] == (True, False, True, 0.0)
                                     and set(r["again"].values()) == {"ok"}
                                     and r["healthy_after"]),
    "whole_pool_down": lambda r: (list(r["statuses"].values()) == ["error"] and r["error"]
                                  and r["replica"] == "b"
                                  and r["errored"] == 1 and r["requeued"] == 2),
    "close_with_down_pool": lambda r: (r["statuses"] == {r["rid"]: "error"} and r["quick"]
                                       and r["closed"]),
    "metrics_accounting": lambda r: (r["totals"] == [5, 4, 1, 0, 0, 0, 0] and r["depth"] == 0
                                     and r["latencies"] == 4 and r["dispatched"] == 4
                                     and r["in_flight"] == 0
                                     and r["health"] == (0, 0, 4, True)),
    "rate_self_calibrates": lambda r: r["cold"] and r["warm"] and r["gauge"],
    "validation": lambda r: len(r["errors"]) == 7 and r["default"] == "mid",
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_frontdoor_scenario_matches_reference(name):
    got = SCENARIOS[name](tctl)
    want = SCENARIOS[name](jctl)
    assert got == want
    assert EXPECT[name](got), got


def test_frontdoor_port_exports():
    import repro_torch.serve as tserve
    from repro.serve import __all__ as jall
    names = [n for n in jctl.__all__]
    assert sorted(names) == sorted(tctl.__all__)
    for n in names:
        assert getattr(tserve, n) is getattr(tctl, n)
        assert n in jall and n in tserve.__all__
    assert tctl.DEFAULT_CLASSES == tuple(tctl.PriorityClass(c.name, c.level, c.deadline_s)
                                         for c in jctl.DEFAULT_CLASSES)


# ---------------------------------------------------------------------------
# PipelineReplica over SMOKE SimpleMRIRecon
# ---------------------------------------------------------------------------

def _mri(mod, n, seed=5):
    """``n`` k-space requests (each its own maps) of the SMOKE shape."""
    rng = np.random.default_rng(seed)
    f, c, h, w = SHAPE
    out = []
    for _ in range(n):
        k = (rng.standard_normal(SHAPE) + 1j * rng.standard_normal(SHAPE)).astype(np.complex64)
        s = (rng.standard_normal((c, h, w)) + 1j * rng.standard_normal((c, h, w))
             ).astype(np.complex64)
        out.append(mod.KData({"kdata": k, "sensitivity_maps": s}))
    return out


def _split_apps(n):
    root = _cpu_app()
    root.set_mesh(make_data_mesh([torch.device("cpu")] * n))
    return root.split(n)


def _port_replicas(mode="fused_kernel", n=2, batch=4, probe=None):
    reps = []
    for i, a in enumerate(_split_apps(n)):
        pipe = Pipeline(a) | SimpleMRIRecon(a, mode=mode, in_place=False).bind()
        reps.append(tctl.PipelineReplica(f"r{i}", pipe.serve(batch=batch), probe_request=probe))
    return reps


def _xdata(data):
    return np.asarray(data.device_view("xdata").cpu().numpy() if isinstance(
        data.device_view("xdata"), torch.Tensor) else data.device_view("xdata"))


@pytest.mark.parametrize("policy", ["round-robin", "least-outstanding", "profile"])
def test_pipeline_replicas_bit_for_bit_direct_and_near_jax(policy):
    """12 requests (a third interactive) through two port replicas on
    ``CLapp.split`` apps: each result bit for bit the port's direct
    server's, within 1e-4 of the JAX package's PipelineReplicas under the
    same policy; both replicas serve."""
    n = 12
    app = _cpu_app()
    server = (Pipeline(app) | SimpleMRIRecon(app, mode="fused_kernel", in_place=False).bind()
              ).serve(batch=4)
    rids = [server.submit(d) for d in _mri(tcore, n)]
    direct = {r.rid: _xdata(r.data) for r in server.drain()}

    fd = tctl.FrontDoor(_port_replicas(), capacity=32, policy=policy, auto_start=False)
    japp = jcore.CLapp().init()
    jreps = []
    for i in range(2):
        jpipe = jcore.Pipeline(japp) | jproc.SimpleMRIRecon(japp, mode="fused_pallas",
                                                            in_place=False).bind()
        jreps.append(jctl.PipelineReplica(f"r{i}", jpipe.serve(batch=4)))
    jfd = jctl.FrontDoor(jreps, capacity=32, policy=policy, auto_start=False)
    try:
        classes = ["interactive" if i % 3 == 0 else "batch" for i in range(n)]
        fids = [fd.submit(d, priority=c) for d, c in zip(_mri(tcore, n), classes)]
        jids = [jfd.submit(d, priority=c) for d, c in zip(_mri(jcore, n), classes)]
        assert fids == jids == rids
        fd.start()
        jfd.start()
        outs = {o.rid: o for o in fd.drain(timeout=60.0)}
        jouts = {o.rid: o for o in jfd.drain(timeout=60.0)}
        for fid in fids:
            o, jo = outs[fid], jouts[fid]
            assert o.ok and jo.ok, (o.error, jo.error)
            got = _xdata(o.result)
            np.testing.assert_array_equal(got, direct[fid])
            np.testing.assert_allclose(got, np.asarray(jo.result.device_views()["xdata"]),
                                       **JAX_TOL)
        assert {o.replica for o in outs.values()} == {"r0", "r1"}
    finally:
        fd.close()
        jfd.close()


def test_pipeline_replica_fault_requeued_and_probe_recovers():
    """A launch failure injected into r1's server (its ``stack_group``
    raises): r1 is marked unhealthy, its batch is requeued to r0, r1
    comes back through its probe, every outcome is "ok" and bit for bit
    the direct server's."""
    n = 8
    app = _cpu_app()
    server = (Pipeline(app) | SimpleMRIRecon(app, mode="fused_kernel", in_place=False).bind()
              ).serve(batch=4)
    for d in _mri(tcore, n):
        server.submit(d)
    direct = {r.rid: _xdata(r.data) for r in server.drain()}
    reps = _port_replicas(probe=_mri(tcore, 1, seed=9)[0])
    for r in reps:                          # built before the fault
        r.process(_mri(tcore, 1))
    fd = tctl.FrontDoor(reps, capacity=16, policy="round-robin", probe_interval_s=0.02,
                        max_retries=2, auto_start=False)
    plan = reps[1].server._plan

    def boom(items):
        raise RuntimeError("injected launch failure")
    plan.stack_group = boom
    try:
        fids = [fd.submit(d) for d in _mri(tcore, n)]
        fd.start()
        _until(lambda: not reps[1].healthy or fd.outstanding == 0, "r1 to fail")
        outs = {o.rid: o for o in fd.drain(timeout=60.0)}
        assert [outs[f].status for f in fids] == ["ok"] * n
        assert {outs[f].replica for f in fids} == {"r0"}
        assert fd.metrics.counter("frontdoor_requests_requeued_total").value() >= 1
        assert "injected" in fd.health()["replicas"]["r1"]["last_error"]
        for f in fids:
            np.testing.assert_array_equal(_xdata(outs[f].result), direct[f])
        del plan.stack_group                 # heal it: the probe readmits r1
        _until(lambda: reps[1].healthy, "r1's probe to succeed")
        more = [fd.submit(d) for d in _mri(tcore, 4)]
        outs = {o.rid: o for o in fd.drain(timeout=60.0)}
        assert all(outs[f].ok for f in more)
        assert reps[1].served > 0
    finally:
        fd.close()


def test_pipeline_replica_rate_reads_the_app_mesh_lanes():
    """``rate`` is the sum of the replica app's lane rates once every lane
    of its mesh is warm (the signal the proportional split reads), else
    the FrontDoor-side EMA."""
    rep = _port_replicas(n=2)[0]
    assert rep.rate != rep.rate              # cold everywhere
    rep.record(10, 0.5)
    assert rep.rate == pytest.approx(20.0)   # the EMA
    rep.app.device_profiles.set_rate(0, 250.0)
    assert rep.rate == 250.0                 # the registry, keyed by lane
    root = _cpu_app()
    root.set_mesh(make_data_mesh([torch.device("cpu")] * 4))
    wide = root.split(2)[0]
    pipe = Pipeline(wide) | SimpleMRIRecon(wide, mode="fused_kernel").bind()
    rep2 = tctl.PipelineReplica("w", pipe.serve(batch=4))
    assert len(wide.mesh.groups) == 2
    wide.device_profiles.set_rate(0, 100.0)
    assert rep2.rate != rep2.rate            # lane 1 still cold
    wide.device_profiles.set_rate(1, 50.0)
    assert rep2.rate == 150.0
    assert rep2.max_batch == 4 and rep2.profile.lane == -1


# ---------------------------------------------------------------------------
# warm_start across the packages
# ---------------------------------------------------------------------------

class _Bias(Process):
    batch_axis = True
    ports = {"in": Port(names=("img",)), "out": Port(names=("img",)),
             "bias": Port(names=("img",), optional=True)}

    def apply(self, views, aux, params, out=None):
        return {"img": views["img"] + aux["bias"]["img"]}


class _JBias(jcore.Process):
    ports = {"in": jcore.Port(names=("img",)), "out": jcore.Port(names=("img",)),
             "bias": jcore.Port(names=("img",), optional=True)}

    def apply(self, views, aux, params):
        return {"img": views["img"] + aux["bias"]["img"]}


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("fmt", ["legacy", "sharded-v1"])
def test_warm_start_restores_either_package(tmp_path, writer, fmt):
    """A bias checkpoint (step 7, and a torn step 9) written by one package
    restores through both packages' ``warm_start``, into a registered Data
    (live) and into a bound Data before the first build, byte for byte."""
    rng = np.random.default_rng(11)
    bias = rng.standard_normal((6, 5)).astype(np.float32)
    x = rng.standard_normal((6, 5)).astype(np.float32)
    d = str(tmp_path / "ckpt")
    save = jckpt.save_checkpoint if writer == "jax" else save_checkpoint
    save(d, 7, {"img": bias}, sharded=fmt == "sharded-v1")
    (tmp_path / "ckpt" / "step_0000000009").mkdir()

    # the port: live into the registered Data, then pre-build
    app = _cpu_app()
    node = _Bias(app).bind(bias=Data({"img": np.zeros((6, 5), np.float32)}))
    pipe = Pipeline(app) | node
    server = pipe.serve(batch=2)
    server.submit(Data({"img": x}))
    server.drain()
    rep = tctl.PipelineReplica("r0", server)
    assert rep.warm_start(d, node.process.in_handles["bias"]) == 7
    assert app.getData(node.process.in_handles["bias"]).get_ndarray(0).host.tobytes() == \
        bias.tobytes()
    server.submit(Data({"img": x}))
    (res,) = server.drain()
    got = _img_out(res.data)
    assert got.tobytes() == (x + bias).tobytes()
    fresh = Data({"img": np.zeros((6, 5), np.float32)})
    app2 = _cpu_app()
    server2 = (Pipeline(app2) | _Bias(app2).bind(bias=fresh)).serve(batch=2)
    assert tctl.PipelineReplica("r1", server2).warm_start(d, fresh) == 7
    server2.submit(Data({"img": x}))
    (res2,) = server2.drain()
    assert _img_out(res2.data).tobytes() == got.tobytes()

    # the JAX package's warm_start on the same checkpoint
    japp = jcore.CLapp().init()
    jfresh = jcore.Data({"img": np.zeros((6, 5), np.float32)})
    jserver = (jcore.Pipeline(japp) | _JBias(japp).bind(bias=jfresh)).serve(batch=2)
    assert jctl.PipelineReplica("j", jserver).warm_start(d, jfresh) == 7
    jserver.submit(jcore.Data({"img": x}))
    (jres,) = jserver.drain()
    assert np.asarray(jres.data.device_views()["img"]).tobytes() == got.tobytes()


def _img_out(data):
    v = data.device_view("img")
    return (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)).copy()


def test_warm_start_without_checkpoint_raises(tmp_path):
    app = _cpu_app()
    server = (Pipeline(app) | _Bias(app).bind(bias=Data({"img": np.zeros((2, 2),
                                                                           np.float32)}))
              ).serve(batch=2)
    with pytest.raises(FileNotFoundError, match="no complete checkpoints"):
        tctl.PipelineReplica("r", server).warm_start(str(tmp_path), Data({"img": np.zeros(
            (2, 2), np.float32)}))


# ---------------------------------------------------------------------------
# the serving example's front door against the JAX package's
# ---------------------------------------------------------------------------

def test_serve_front_door_tokens_match_jax():
    """The port's ``serve_front_door`` (two LMServer replicas on split CPU
    apps) with the JAX package's qwen3-14b SMOKE weights: every rid's
    tokens equal those of the JAX example's front door (two JAX
    LMServers behind the JAX FrontDoor, the same prompts and classes)."""
    from repro.configs import get_smoke as j_get_smoke
    from repro.models import build_model as j_build_model
    from repro.serve import LMServer as JLMServer, SamplingConfig as JSampling
    from repro_torch.launch import serve_lm

    cfg = j_get_smoke("qwen3-14b")
    model = j_build_model(cfg)
    params = model.init_params(jax.random.key(0))

    def make_replica(name):
        lm = JLMServer(model, params, batch=2, max_len=32,
                       sampling=JSampling(max_new_tokens=8))

        def decode(prompt):
            rid = lm.submit(list(prompt))
            return lm.run()[rid]
        return jctl.CallableReplica(name, decode, max_batch=2)

    jfd = jctl.FrontDoor([make_replica("lm-0"), make_replica("lm-1")], capacity=16,
                         overflow="shed", policy="least-outstanding")
    try:
        rng = np.random.default_rng(2)
        jrids = [jfd.submit(list(rng.integers(0, cfg.vocab, size=5)),
                            priority="interactive" if i % 3 == 0 else "batch")
                 for i in range(6)]
        jout = {o.rid: [int(t) for t in o.result] for o in jfd.drain(timeout=600.0)}
    finally:
        jfd.close()
    named = {jax.tree_util.keystr(p): np.asarray(v)
             for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    weights = interop.params_from_reference(named, get_smoke("qwen3-14b"), "cpu")
    got = serve_lm.serve_front_door(_cpu_app(), weights)
    assert sorted(got) == jrids
    assert {rid: [int(t) for t in toks] for rid, toks in got.items()} == jout


def test_serve_front_door_replicas_each_own_app(monkeypatch):
    """``serve_front_door`` gives each of its two LMServer replicas an app
    of its own on the caller's device (as the JAX example gives each its
    own default app), and every rid its 8 tokens."""
    from repro_torch.launch import serve_lm

    apps = []

    class Recording:
        def __init__(self, model, weights, *, batch, max_len, sampling, app):
            apps.append(app)
            self.batch, self.new, self.rids = batch, sampling.max_new_tokens, []

        def submit(self, prompt):
            self.rids.append(len(self.rids))
            return self.rids[-1]

        def run(self):
            return {rid: [rid] * self.new for rid in self.rids}

    monkeypatch.setattr(serve_lm, "LMServer", Recording)
    monkeypatch.setattr(serve_lm, "_params", lambda model, app, seed: None)
    app = _cpu_app()
    got = serve_lm.serve_front_door(app)
    assert len(apps) == 2 and apps[0] is not apps[1] and app not in apps
    assert [a.device for a in apps] == [app.device] * 2
    assert len(got) == 6 and all(len(toks) == 8 for toks in got.values())


# ---------------------------------------------------------------------------
# two threads through the compiled launch's seam
# ---------------------------------------------------------------------------

class _MeshProbe(Process):
    """Meets the other thread's launch at a barrier, then records the
    compile mesh its ``apply`` runs under: both threads are inside a launch
    when they read it."""

    def apply(self, views, aux, params, out=None):
        params["barrier"].wait(WAIT_S)
        params["seen"].append(process.current_compile_mesh())
        return {k: v + 1 for k, v in views.items()}


def test_two_threads_see_their_own_compile_mesh(monkeypatch):
    """Two apps with different meshes launch a compiled process each from
    their own thread (eager, captured, replayed: the seam runs the body at
    capture and at each replay); every ``apply`` waits for the other
    thread's at a barrier, so the launches overlap.  Each reads its own
    app's mesh from ``current_compile_mesh()``: the compile mesh is
    thread-local."""
    captures = []

    def capture(body, device):
        captures.append(threading.current_thread().name)
        body()
        return body
    monkeypatch.setattr(process, "capture_graph", capture)
    monkeypatch.setattr(process, "_graphs_on", lambda device: True)
    barrier = threading.Barrier(2)
    meshes = [make_data_mesh([torch.device("cpu")]),
              make_data_mesh([torch.device("cpu")] * 2, model=2)]
    seen, errors, procs = [[], []], [], [None, None]

    def worker(i):
        try:
            app = _cpu_app()
            app.set_mesh(meshes[i])
            p = procs[i] = _MeshProbe(app)
            p.in_handle = app.addData(XData({"img": np.zeros((3, 4), np.float32)}))
            p.out_handle = app.addData(XData({"img": np.zeros((3, 4), np.float32)}))
            p.set_launch_parameters({"barrier": barrier, "seen": seen[i]})
            p.init()
            for _ in range(3):         # eager, captured, replayed
                p.launch()
        except BaseException as e:    # noqa: BLE001 -- reaches the assertion below
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=worker, args=(i,), name=f"t{i}") for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S * 2)
    assert not errors, errors
    assert sorted(captures) == ["t0", "t1"]
    assert [(p.captures, p.replays) for p in procs] == [(1, 2), (1, 2)]
    for i in range(2):
        assert len(seen[i]) == 4 and all(m is meshes[i] for m in seen[i]), (i, seen[i])
    assert process.current_compile_mesh() is None


def test_capture_tally_belongs_to_its_thread():
    """While one thread's capture counts into its tally, a launch counted
    in another thread goes to the launch counts, not into that tally."""
    registry.reset_launch_counts()
    tally, inside, done = {}, threading.Event(), threading.Event()

    def capturing():
        with registry.counting_into(tally):
            registry.count_launch("negate_kernel")
            inside.set()
            done.wait(WAIT_S)

    t = threading.Thread(target=capturing)
    t.start()
    assert inside.wait(WAIT_S)
    registry.count_launch("negate_kernel")
    also = {}
    with registry.also_counting(also):
        registry.count_launch("negate_kernel")
    done.set()
    t.join(WAIT_S)
    assert tally == {"negate_kernel": 1}
    assert registry.launch_counts()["negate_kernel"] == 2
    assert also == {"negate_kernel": 1}
    registry.reset_launch_counts()


def test_launches_on_a_capturing_stream_join_that_capture(monkeypatch):
    """A thread that launches on a capturing stream of the capture's device
    (autograd's device thread running a captured backward) counts into
    that capture's tally; a thread on a stream that is not capturing, or
    on another device, counts into the launch counts.  The CUDA queries
    are stubbed: each thread says whether its stream captures."""
    streams = threading.local()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: getattr(streams, "capturing", False))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: getattr(streams, "device", 0))
    registry.reset_launch_counts()
    tally, opened, done = {}, threading.Event(), threading.Event()

    def capturing():
        with registry.counting_into(tally, torch.device("cuda", 0)):
            registry.count_launch("negate_kernel")
            opened.set()
            done.wait(WAIT_S)

    def launcher(capturing_stream, device):
        streams.capturing, streams.device = capturing_stream, device
        registry.count_launch("negate_kernel")

    t = threading.Thread(target=capturing)
    t.start()
    assert opened.wait(WAIT_S)
    for args in [(True, 0), (False, 0), (True, 1)]:
        w = threading.Thread(target=launcher, args=args)
        w.start()
        w.join(WAIT_S)
    done.set()
    t.join(WAIT_S)
    assert tally == {"negate_kernel": 2}
    assert registry.launch_counts()["negate_kernel"] == 2
    assert registry._CAPTURING == {}
    registry.reset_launch_counts()


def test_launch_counts_lose_no_update_across_threads():
    """16 threads counting 3000 launches each (and 1000 replays of a
    3-launch tally), the interpreter switching threads every microsecond:
    the shared counts add up to every launch."""
    import sys
    registry.reset_launch_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker():
            for _ in range(3000):
                registry.count_launch("negate_kernel")
            for _ in range(1000):
                registry.add_launches({"negate_kernel": 3})
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S * 6)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert registry.launch_counts()["negate_kernel"] == 16 * 6000
    registry.reset_launch_counts()


def test_capture_graph_thread_local_and_one_capture_a_device(monkeypatch):
    """``capture_graph`` with the CUDA calls stubbed: each capture runs in
    ``"thread_local"`` error mode on the device's capture stream, and two
    threads capturing on one device take turns (the second body starts
    after the first capture ended)."""
    log, modes, lock = [], [], threading.Lock()

    class FakeGraph:
        def replay(self):
            pass

    class FakeCapture:
        def __init__(self, graph, stream=None, capture_error_mode="global"):
            modes.append((stream, capture_error_mode))

        def __enter__(self):
            with lock:
                log.append("begin")

        def __exit__(self, *exc):
            with lock:
                log.append("end")

    class FakeDevice:
        def __init__(self, device):
            pass

        def __enter__(self):
            pass

        def __exit__(self, *exc):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", FakeCapture)
    monkeypatch.setattr(torch.cuda, "device", FakeDevice)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: ("stream", str(device)))
    monkeypatch.setattr(process, "_CAPTURE_STREAMS", {})

    class WatchedLock:
        """The device's capture lock, counting the threads that asked."""

        def __init__(self):
            self.lock, self.asked = threading.Lock(), 0

        def __enter__(self):
            with lock:
                self.asked += 1
            self.lock.acquire()

        def __exit__(self, *exc):
            self.lock.release()

    watched = WatchedLock()
    monkeypatch.setattr(process, "_CAPTURE_LOCKS", {torch.device("cuda", 0): watched})
    first_in = threading.Event()
    release = threading.Event()

    def body_a():
        first_in.set()
        release.wait(WAIT_S)

    def body_b():
        with lock:
            log.append("b-body")

    ta = threading.Thread(target=process.capture_graph, args=(body_a, torch.device("cuda", 0)))
    ta.start()
    assert first_in.wait(WAIT_S)
    tb = threading.Thread(target=process.capture_graph, args=(body_b, torch.device("cuda", 0)))
    tb.start()
    _until(lambda: watched.asked == 2, "the second capture to ask for the device's lock")
    assert log == ["begin"]                      # the second waits for the first
    release.set()
    ta.join(WAIT_S)
    tb.join(WAIT_S)
    assert log == ["begin", "end", "begin", "b-body", "end"]
    assert modes == [(("stream", "cuda:0"), "thread_local")] * 2
