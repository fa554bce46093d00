"""The port's optimizer (``repro_torch.optim``) against the JAX package's
(``repro.optim``) on the CPU, on inputs made from a numpy seed: AdamW
(over three steps, f32 and bf16 parameters, with and without the clip),
``global_norm``, the three schedule kinds at every step, the int8
error-feedback compression, and the port of ``tests/test_optim_ckpt.py``'s
optimizer cases.

Tolerances: AdamW, clipping and ``global_norm`` at rtol 1e-5 / atol 1e-6
(``tests/test_optim_ckpt.py``'s; two frameworks' f32 ``pow``, ``sqrt`` and
sums round alike to an ulp or two); the schedules at rtol 1e-6 (one f32
``cos``); the int8 codes and the scale exactly (the same f32 operations,
rounded half to even in both); the error buffer at atol 1e-7.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import (AdamWConfig as JAdamWConfig, Schedule as JSchedule,
                         adamw_init as j_adamw_init, adamw_update as j_adamw_update,
                         ef_int8_compress as j_ef_int8_compress, global_norm as j_global_norm)
from repro_torch.core.arena import tree_flatten
from repro_torch.optim import (AdamWConfig, Schedule, adamw_init, adamw_update,
                               dp_mean_compressed, ef_int8_compress, ef_int8_decompress,
                               global_norm, make_schedule)
from repro_torch.optim import adamw as adamw_mod

TOL = dict(rtol=1e-5, atol=1e-6)


def _tree(rng, dtype=np.float32, scale=1.0):
    return {"a": {"w": (rng.standard_normal((4, 3)) * scale).astype(dtype)},
            "b": (rng.standard_normal((7,)) * scale).astype(dtype),
            "c": (rng.standard_normal((2, 2, 5)) * scale).astype(dtype)}


def _j(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _t(tree, dtype=torch.float32):
    return {k: _t(v, dtype) if isinstance(v, dict) else torch.tensor(v).to(dtype)
            for k, v in tree.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_trees(port, ref, **tol):
    jflat = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(ref)[0]}
    pflat = dict(tree_flatten(port))
    assert set(pflat) == set(jflat)
    for name in pflat:
        np.testing.assert_allclose(_np(pflat[name]), _np(jflat[name]), err_msg=name, **tol)


SCHEDULES = {"constant": dict(kind="constant", base_lr=1e-2, warmup_steps=0),
             "cosine": dict(kind="cosine", base_lr=1e-2, warmup_steps=2, total_steps=5,
                            min_lr=1e-3),
             "linear": dict(kind="linear", base_lr=1e-2, warmup_steps=1, total_steps=4,
                            min_lr=0.0)}


@pytest.mark.parametrize("kind", sorted(SCHEDULES))
@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_three_steps_match_reference(kind, clip, dtype):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=clip)
    jcfg = JAdamWConfig(**kw, schedule=JSchedule(**SCHEDULES[kind]))
    tcfg = AdamWConfig(**kw, schedule=Schedule(**SCHEDULES[kind]))
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                             torch.float32)
    jp, tp = _j(p0, jdt), _t(p0, tdt)
    jst, tst = j_adamw_init(jp), adamw_init(tp)
    for step in range(3):
        g = _tree(rng, scale=3.0)
        jp, jst, jm = j_adamw_update(jp, _j(g, jdt), jst, jcfg)
        tp, tst, tm = adamw_update(tp, _t(g, tdt), tst, tcfg)
        np.testing.assert_allclose(_np(tm["lr"]), _np(jm["lr"]), rtol=1e-6)
        np.testing.assert_allclose(_np(tm["grad_norm"]), _np(jm["grad_norm"]), **TOL)
        for key in ("master", "m", "v"):
            _assert_trees(tst[key], jst[key], **TOL)
        assert int(tst["step"]) == int(jst["step"]) == step + 1
        assert tst["step"].dtype == torch.int32 and tst["step"].shape == ()
        # the parameters are the master rounded to their dtype
        _assert_trees(tp, jp, **(TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-6)))
        for (_, p), (_, m) in zip(tree_flatten(tp), tree_flatten(tst["master"])):
            assert p.dtype == tdt and torch.equal(p, m.to(tdt))


def test_adamw_updates_the_state_in_place_in_chunks(monkeypatch):
    """The update writes the parameters, master, m and v in their own
    tensors; a leaf larger than ``CHUNK`` is updated slice by slice with
    the same result."""
    rng = np.random.default_rng(1)
    p0, g = _tree(rng), _tree(rng, scale=2.0)
    cfg = AdamWConfig(schedule=Schedule(kind="constant", base_lr=1e-2, warmup_steps=0))
    whole_p = _t(p0)
    whole = adamw_init(whole_p)
    adamw_update(whole_p, _t(g), whole, cfg)
    monkeypatch.setattr(adamw_mod, "CHUNK", 5)
    tp = _t(p0)
    st = adamw_init(tp)
    ptrs = [t.data_ptr() for _, t in tree_flatten({"p": tp, "s": st})]
    out_p, out_st, _ = adamw_update(tp, _t(g), st, cfg)
    assert out_p is tp and out_st is st
    assert [t.data_ptr() for _, t in tree_flatten({"p": tp, "s": st})] == ptrs
    for (_, a), (_, b) in zip(tree_flatten({"p": tp, "s": st}),
                              tree_flatten({"p": whole_p, "s": whole})):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_route_runs_the_plain_chunked_path(monkeypatch, dtype):
    """On CPU tensors the update and the clip's norm are the plain
    versions, the update in ``CHUNK`` slices: the kernel library is never
    loaded, no launch is counted, one plain call a leaf, one square root a
    slice (and the norm's), and the state equals the whole-leaf update's."""
    from repro_torch.core.registry import launch_counts
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    rng = np.random.default_rng(3)
    p0, g = _tree(rng), _tree(rng, scale=2.0)
    cfg = AdamWConfig(schedule=Schedule(kind="constant", base_lr=1e-2, warmup_steps=0))
    whole_p = _t(p0, tdt)
    whole = adamw_init(whole_p)
    adamw_update(whole_p, _t(g, tdt), whole, cfg)

    def refused():
        raise AssertionError("the CPU route loaded the kernel library")

    plain_calls, sqrt_calls = [], []
    plain, sqrt = adamw_mod._update_leaf_plain, torch.sqrt
    monkeypatch.setattr(adamw_mod._build, "library", refused)
    monkeypatch.setattr(adamw_mod, "CHUNK", 5)
    monkeypatch.setattr(adamw_mod, "_update_leaf_plain",
                        lambda *a: plain_calls.append(a[1].numel()) or plain(*a))
    monkeypatch.setattr(torch, "sqrt", lambda x: sqrt_calls.append(x.numel()) or sqrt(x))
    before = launch_counts()
    tp = _t(p0, tdt)
    st = adamw_init(tp)
    adamw_update(tp, _t(g, tdt), st, cfg)
    assert launch_counts() == before
    assert sorted(plain_calls) == [7, 12, 20]
    assert len(sqrt_calls) == 1 + sum(-(-n // 5) for n in plain_calls)
    for (_, a), (_, b) in zip(tree_flatten({"p": tp, "s": st}),
                              tree_flatten({"p": whole_p, "s": whole})):
        assert torch.equal(a, b)


@pytest.mark.parametrize("p_dtype,g_dtype,update_bytes,norm_bytes", [
    (torch.bfloat16, torch.bfloat16, 28, 2), (torch.float32, torch.float32, 32, 4),
    (torch.bfloat16, torch.float32, 30, 4)])
def test_optimizer_costs_count_each_stream_once(p_dtype, g_dtype, update_bytes, norm_bytes):
    """The kernels' cost models: the update reads the gradient, master, m
    and v and writes master, m, v and the parameter; the sum of squares
    reads the gradient (bf16 parameters' gradient in f32 after the int8
    compression)."""
    n = 6 * 7

    def meta(dtype):
        return torch.empty(6, 7, dtype=dtype, device="meta")
    cost = adamw_mod.adamw_update_cost(meta(p_dtype), meta(torch.float32), meta(g_dtype),
                                       meta(torch.float32), meta(torch.float32))
    assert (cost.flops, cost.bytes, cost.peak) == (17 * n, update_bytes * n, "fp32")
    cost = adamw_mod.sum_squares_cost([meta(g_dtype), meta(g_dtype)])
    assert (cost.flops, cost.bytes) == (2 * 2 * n, 2 * norm_bytes * n)


def test_adamw_init_master_is_a_distinct_buffer():
    p = {"w": torch.ones(3)}
    st = adamw_init(p)
    assert st["master"]["w"].data_ptr() != p["w"].data_ptr()
    assert st["master"]["w"].dtype == st["m"]["w"].dtype == st["v"]["w"].dtype == torch.float32
    assert int(st["step"]) == 0


def test_adamw_matches_the_closed_form_first_step():
    """``tests/test_optim_ckpt.py``'s closed form: m = (1 - b1) g, v = (1 -
    b2) g², so the first step is lr (g / |g| + wd p)."""
    rng = np.random.default_rng(0)
    p = rng.standard_normal((4, 3)).astype(np.float32)
    g = rng.standard_normal((4, 3)).astype(np.float32)
    cfg = AdamWConfig(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01, clip_norm=None,
                      schedule=Schedule(kind="constant", base_lr=1e-2, warmup_steps=0))
    tp = {"w": torch.tensor(p)}
    new_p, st, _ = adamw_update(tp, {"w": torch.tensor(g)}, adamw_init(tp), cfg)
    expect = p - 1e-2 * (g / (np.abs(g) + 1e-8) + 0.01 * p)
    np.testing.assert_allclose(new_p["w"].numpy(), expect, **TOL)
    assert int(st["step"]) == 1


def test_grad_clipping_matches_reference():
    cfg_kw = dict(clip_norm=1.0, weight_decay=0.0)
    sched = dict(kind="constant", base_lr=1.0, warmup_steps=0)
    jp = {"w": jnp.ones((10,), jnp.float32)}
    jg = {"w": jnp.full((10,), 100.0, jnp.float32)}
    _, jst, jm = j_adamw_update(jp, jg, j_adamw_init(jp),
                                JAdamWConfig(**cfg_kw, schedule=JSchedule(**sched)))
    tp = {"w": torch.ones(10)}
    _, tst, tm = adamw_update(tp, {"w": torch.full((10,), 100.0)}, adamw_init(tp),
                              AdamWConfig(**cfg_kw, schedule=Schedule(**sched)))
    assert float(tm["grad_norm"]) > 100.0          # reported before the clip
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), **TOL)
    for key in ("master", "m", "v"):
        _assert_trees(tst[key], jst[key], **TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_global_norm_matches_reference(seed):
    rng = np.random.default_rng(seed)
    tree = _tree(rng, scale=10.0 ** seed)
    np.testing.assert_allclose(float(global_norm(_t(tree))), float(j_global_norm(_j(tree))),
                               **TOL)


def test_global_norm_of_known_values():
    t = {"a": torch.ones(3), "b": torch.full((4,), 2.0)}
    assert float(global_norm(t)) == pytest.approx(np.sqrt(3 + 16))


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 7), (3, 3)])
def test_schedules_match_reference_at_every_step(kind, warmup, total):
    kw = dict(base_lr=1e-3, warmup_steps=warmup, total_steps=total, min_lr=1e-4)
    js, ts = JSchedule(kind=kind, **kw), make_schedule(kind, **kw)
    steps = np.arange(0, total + 5)
    got = np.array([float(ts(torch.tensor(s, dtype=torch.int32))) for s in steps])
    want = np.array([float(js(jnp.asarray(s, jnp.int32))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_schedule_takes_a_device_step_and_returns_a_tensor():
    s = make_schedule("cosine", base_lr=1e-3, warmup_steps=10, total_steps=100, min_lr=1e-4)
    lr = s(torch.zeros((), dtype=torch.int32))
    assert isinstance(lr, torch.Tensor) and lr.dtype == torch.float32 and lr.shape == ()
    assert float(lr) == 0.0
    assert abs(float(s(torch.tensor(10))) - 1e-3) < 1e-9
    assert float(s(100)) == pytest.approx(1e-4, rel=1e-3)


@pytest.mark.parametrize("shape,seed", [((32,), 0), ((7, 5), 1), ((3, 4, 6), 2)])
def test_ef_int8_compress_matches_reference(shape, seed):
    rng = np.random.default_rng(seed)
    jerr, terr = jnp.zeros(shape, jnp.float32), torch.zeros(shape)
    for _ in range(4):
        g = (rng.standard_normal(shape) * 3).astype(np.float32)
        jq, js, jerr = j_ef_int8_compress(jnp.asarray(g), jerr)
        tq, ts, terr = ef_int8_compress(torch.tensor(g), terr)
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert float(ts) == float(js)
        np.testing.assert_allclose(terr.numpy(), np.asarray(jerr), rtol=0, atol=1e-7)
        np.testing.assert_allclose(ef_int8_decompress(tq, ts).numpy(),
                                   np.asarray(jq, np.float32) * float(js), rtol=0, atol=0)


def test_ef_compress_error_feedback_telescopes():
    """The sum of the dequantized gradients plus the last error is the sum
    of the true gradients."""
    rng = np.random.default_rng(0)
    err = torch.zeros(32)
    total_true, total_deq = np.zeros(32, np.float32), np.zeros(32, np.float32)
    for _ in range(5):
        g = torch.tensor(rng.standard_normal(32).astype(np.float32))
        q, scale, err = ef_int8_compress(g, err)
        total_true += g.numpy()
        total_deq += ef_int8_decompress(q, scale).numpy()
    np.testing.assert_allclose(total_deq + err.numpy(), total_true, rtol=1e-4, atol=1e-4)


def test_dp_mean_compressed_waits_for_the_multi_gpu_slice():
    """The multi-GPU slice came (the name is the refusal's this test
    replaced). Two lanes: the int8 payloads summed in int32, dequantized
    with the mean of the two scales; each lane keeps its own error buffer
    (against the JAX function itself: ``tests/test_torch_train_mesh.py``)."""
    g = [torch.tensor([1.0, -2.0, 0.5]), torch.tensor([4.0, 1.0, -1.0])]
    err = [torch.zeros(3), torch.full((3,), 0.25)]
    mean, new_err = dp_mean_compressed(g, err)
    parts = [ef_int8_compress(a, e) for a, e in zip(g, err)]
    qsum = parts[0][0].to(torch.int32) + parts[1][0].to(torch.int32)
    want = qsum.float() * ((parts[0][1] + parts[1][1]) / 2) / 2
    assert torch.equal(mean, want)
    assert all(torch.equal(n, p[2]) for n, p in zip(new_err, parts))
