"""The port's dry-run tools against the JAX package's.

* The cell grid (``SHAPES``, ``cells``) and ``default_microbatches``
  equal the reference's for all 40 cells; ``fit_pspec`` on the reference's
  five cases and on a ``hypothesis`` sweep (and a seeded one, which runs
  without ``hypothesis`` too).
* ``count_params`` / ``model_flops`` of every full ``CONFIG`` on
  ``TensorSpec`` trees equal the reference's on ``jax.eval_shape``
  parameters (nothing allocated).
* ``build_lowerable``'s argument leaves have the reference's names,
  shapes and dtypes for every runnable cell; the fitted train placements
  equal the reference's on both production meshes, and the cache leaves
  the port places otherwise (its slot strips, not the reference's
  sequence over ``model``) are named here.
* ``CostMode``: a product counts 2 n^3 (the reference's ``cost_dict``
  within 1 %), a loop of ten counts ten (the reference's scan counts one),
  a model's traced cost is linear in its layers (so no reconstruction from
  unrolled variants is needed), a ``meta`` trace equals a real CPU run of
  the same step, and each registered wrapper's ``meta`` outputs are its
  plain version's shapes and dtypes, counted as its registry ``Cost``.
* Collective bytes of a dense SMOKE layer on (1, 2) and (2, 2) meshes
  equal a count written out from the partition rules; ``diagnose``'s
  sources sum to the totals.
* ``argument_size_in_bytes`` of a SMOKE train cell on (4, 4) equals the
  reference's ``memory_analysis()`` on an Auto mesh of 16 host devices (a
  subprocess); the whole ``run_cell`` on the granite SMOKE cut returns the
  reference's record keys; ``--opt opt_*`` is refused, naming the lever.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given
from hypothesis import strategies as st
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import SHAPES as J_SHAPES
from repro.configs import cells as j_cells
from repro.configs import get_config as j_get_config
from repro.launch import roofline as jroof
from repro.launch import specs as jspecs
from repro.models import build_model as j_build_model
from repro.models.common import mesh_axes, resolve_tree
from repro_torch.configs import ARCH_IDS, SHAPES, ShapeSpec, cells, get_config, get_smoke
from repro_torch.core import registry
from repro_torch.core.arena import tree_flatten
from repro_torch.kernels import ref
from repro_torch.launch import dryrun, specs
from repro_torch.launch.diagnose import diagnose, two_layers
from repro_torch.launch.roofline import (CostMode, Roofline, collective_bytes,
                                         collective_sources, cost_dict, count_params,
                                         model_flops)
from repro_torch.models import build_model
from repro_torch.models.common import alloc_tree
from repro_torch.optim import adamw_init
from repro_torch.train.step import TrainConfig, make_train_state, make_train_step

ROOT = Path(__file__).resolve().parents[1]
META = torch.device("meta")
RUNNABLE = [(a, s) for a, s, ok, _ in j_cells(include_skips=True) if ok]
MESHES = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}


def _entry(e):
    """A spec entry as the port writes it: None, a name, or a tuple of two
    or more names."""
    if isinstance(e, (tuple, list)):
        return e[0] if len(e) == 1 else tuple(e)
    return e


def _jt(p):
    """A JAX ``PartitionSpec`` as the port's spec tuple."""
    out = [_entry(e) for e in p]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _j_named(tree):
    """``{keystr path: leaf}`` of a JAX tree (PartitionSpecs as leaves)."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P) or x is None)[0]
    return {jax.tree_util.keystr(p): v for p, v in flat}


def _named(tree):
    return dict(tree_flatten(tree)) if isinstance(tree, dict) else {"": tree}


def _j_fitted(arch, shape, multi_pod):
    shape_, axes = MESHES[multi_pod]
    mesh = AbstractMesh(shape_, axes)
    low = jspecs.build_lowerable(arch, shape)
    with mesh_axes(mesh):
        return low, jspecs.fit_pspecs(resolve_tree(low.in_pspecs), low.specs, mesh)


# ---------------------------------------------------------------------------
# The cell grid, microbatches, spec fitting
# ---------------------------------------------------------------------------

def test_shapes_and_cells_equal_the_reference():
    assert list(SHAPES) == list(J_SHAPES)
    for name, s in SHAPES.items():
        j = J_SHAPES[name]
        assert (s.name, s.kind, s.seq, s.batch) == (j.name, j.kind, j.seq, j.batch)
    got, want = cells(include_skips=True), j_cells(include_skips=True)
    assert got == want
    assert len(got) == 40 and sum(ok for *_, ok, _ in got) == 33
    assert [c[:2] for c in cells()] == [c[:2] for c in j_cells()]
    long = {a for a, s, ok, _ in got if s == "long_500k" and ok}
    assert long == {"h2o-danube-1.8b", "rwkv6-3b", "zamba2-2.7b"}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_default_microbatches_equal_the_reference(arch):
    for name in SHAPES:
        got = specs.default_microbatches(get_config(arch), SHAPES[name])
        assert got == jspecs.default_microbatches(j_get_config(arch), J_SHAPES[name]), name


FIT_MESH = {"data": 16, "model": 16, "pod": 2}
FIT_CASES = [
    (("model", None), (49155, 1024)),
    (("model", None), (151936, 1024)),
    ((("pod", "data"), None), (256, 8)),
    ((("pod", "data"), None), (1, 8)),
    ((("pod", "data"),), (48,)),
]


def _fit_both(spec, shape):
    return (specs.fit_pspec(spec, shape, FIT_MESH),
            _jt(jspecs.fit_pspec(P(*spec), shape, FIT_MESH)))


@pytest.mark.parametrize("spec,shape", FIT_CASES)
def test_fit_pspec_equals_the_reference_on_its_cases(spec, shape):
    got, want = _fit_both(spec, shape)
    assert got == want


_AXES = [None, "data", "model", "pod", ("pod", "data"), ("data", "model"),
         ("pod", "data", "model"), ("model", "data")]
_DIMS = [1, 2, 3, 8, 16, 32, 48, 64, 256, 4096, 49155, 151936]


@given(st.lists(st.tuples(st.sampled_from(_DIMS), st.sampled_from(_AXES)), min_size=1,
                max_size=4))
def test_fit_pspec_equals_the_reference_on_a_sweep(dims):
    shape = tuple(d for d, _ in dims)
    spec = tuple(a for _, a in dims)
    got, want = _fit_both(spec, shape)
    assert got == want


def test_fit_pspec_equals_the_reference_on_a_seeded_sweep():
    rng = np.random.default_rng(0)
    for _ in range(400):
        n = int(rng.integers(1, 5))
        shape = tuple(int(rng.choice(_DIMS)) for _ in range(n))
        spec = tuple(_AXES[int(rng.integers(len(_AXES)))] for _ in range(int(rng.integers(0, n + 1))))
        got, want = _fit_both(spec, shape)
        assert got == want, (spec, shape)


# ---------------------------------------------------------------------------
# Parameter counts and MODEL_FLOPS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_count_params_and_model_flops_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    specs_tree = build_model(cfg).param_specs()
    jparams = jax.eval_shape(j_build_model(jcfg).init_params, jax.random.key(0))
    total, active = count_params(specs_tree, cfg)
    jtotal, jactive = jroof.count_params(jparams, jcfg)
    assert total == pytest.approx(jtotal, rel=1e-12)
    assert active == pytest.approx(jactive, rel=1e-12)
    if cfg.n_experts:
        assert active < total
    for kind, b, s in (("train", 256, 4096), ("prefill", 32, 32768), ("decode", 128, 32768)):
        assert model_flops(cfg, specs_tree, kind, b, s) == pytest.approx(
            jroof.model_flops(jcfg, jparams, kind, b, s), rel=1e-12)
    assert all(isinstance(leaf, tuple) and not isinstance(leaf, torch.Tensor)
               for _, leaf in tree_flatten(specs_tree))      # specs: nothing allocated


# ---------------------------------------------------------------------------
# Argument specs and placements
# ---------------------------------------------------------------------------

def _leaves(tree):
    return {n: (tuple(int(d) for d in s.shape), str(np.dtype(s.dtype)) if s.dtype != "bfloat16"
                else "bfloat16") for n, s in _named(tree).items()}


def _j_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    if not flat or flat[0][0] == ():
        return {"": (tuple(tree.shape), str(tree.dtype))}
    return {jax.tree_util.keystr(p): (tuple(v.shape), str(v.dtype)) for p, v in flat}


@pytest.mark.parametrize("arch,shape", RUNNABLE, ids=[f"{a}-{s}" for a, s in RUNNABLE])
def test_argument_specs_equal_the_reference(arch, shape):
    low = specs.build_lowerable(arch, shape)
    jlow = jspecs.build_lowerable(arch, shape)
    assert (low.kind, len(low.specs), low.donate) == (jlow.kind, len(jlow.specs), jlow.donate)
    for got, want in zip(low.specs, jlow.specs):
        assert _leaves(got) == _j_leaves(want)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_fitted_train_placements_equal_the_reference(arch, multi_pod):
    low = specs.build_lowerable(arch, "train_4k")
    got = dryrun.fit_cell(low, dryrun.meta_production_mesh(multi_pod))
    _, want = _j_fitted(arch, "train_4k", multi_pod)
    for g, w in zip(got, want):
        jw = {n: _jt(s) for n, s in _j_named(w).items()}
        assert _named(g) == jw


#: the cache leaves whose fitted placement differs from the reference's in
#: every prefill and decode cell on both production meshes: the port puts
#: slots in strips over ``model`` (``cache_partition_rules``), the
#: reference the sequence (or heads, or channels); rwkv6's ``wkv`` and
#: whisper's cross K/V place alike, their ``model`` split dropped by both
PLACED_OTHERWISE = {
    "deepseek-v2-lite-16b": ["['layer0']['c_kv']", "['layer0']['k_pe']", "['layer0']['kpos']",
                             "['scan']['c_kv']", "['scan']['k_pe']", "['scan']['kpos']"],
    "zamba2-2.7b": ["['kv']['k']", "['kv']['kpos']", "['kv']['v']", "['ssm']['conv']",
                    "['ssm']['ssm']"],
    "rwkv6-3b": ["['cm_shift']", "['tm_shift']"],
    "whisper-large-v3": ["['self']['k']", "['self']['kpos']", "['self']['v']"],
    **{a: ["['scan']['k']", "['scan']['kpos']", "['scan']['v']"]
       for a in ("granite-moe-1b-a400m", "qwen3-14b", "minitron-8b", "h2o-danube-1.8b",
                 "qwen2-7b", "internvl2-2b")},
}
SERVE = [(a, s) for a, s in RUNNABLE if s != "train_4k"]


@pytest.mark.parametrize("arch,shape", SERVE, ids=[f"{a}-{s}" for a, s in SERVE])
def test_cache_placements_differ_only_where_named(arch, shape):
    for multi_pod in (False, True):
        low = specs.build_lowerable(arch, shape)
        got = dict(tree_flatten(dryrun.fit_cell(low, dryrun.meta_production_mesh(multi_pod))[-1]))
        _, want = _j_fitted(arch, shape, multi_pod)
        want = {n: _jt(s) for n, s in _j_named(want[-1]).items()}
        assert set(got) == set(want)
        assert sorted(n for n in got if got[n] != want[n]) == PLACED_OTHERWISE[arch]


def test_decode_strips_fall_back_to_replication():
    """decode_32k: 8 slots a data lane do not split over 16 model lanes."""
    low = specs.build_lowerable("qwen3-14b", "decode_32k")
    cache = dict(tree_flatten(dryrun.fit_cell(low, dryrun.meta_production_mesh())[-1]))
    assert cache["['scan']['k']"] == (None, "data")
    one = dryrun.meta_mesh((1, 2))
    cache = dict(tree_flatten(dryrun.fit_cell(low, one)[-1]))
    assert cache["['scan']['k']"] == (None, ("data", "model"))


# ---------------------------------------------------------------------------
# The counting mode
# ---------------------------------------------------------------------------

def test_a_product_counts_as_in_the_reference_and_a_loop_every_time():
    a = torch.empty(512, 512, device=META)
    with CostMode() as one:
        a @ a
    jone = jroof.cost_dict(jax.jit(lambda x: x @ x).lower(
        jax.ShapeDtypeStruct((512, 512), jnp.float32)).compile())["flops"]
    assert cost_dict(one)["flops"] == 2 * 512 ** 3
    assert cost_dict(one)["flops"] == pytest.approx(jone, rel=0.01)
    with CostMode() as ten:
        x = a
        for _ in range(10):
            x = x @ a
    assert ten.total()["flops"] == 10 * 2 * 512 ** 3

    def scanned(x):
        y, _ = jax.lax.scan(lambda c, _: (c @ c, ()), x, None, length=10)
        return y

    jscan = jroof.cost_dict(jax.jit(scanned).lower(
        jax.ShapeDtypeStruct((512, 512), jnp.float32)).compile())["flops"]
    assert jscan == pytest.approx(jone, rel=0.05)          # the reference's: once
    w = torch.empty(512, 512, device=META, requires_grad=True)
    with CostMode() as trained:
        x = a.requires_grad_(True)
        for _ in range(10):
            x = x @ w
        x.sum().backward()
    assert trained.total()["flops"] == 30 * 2 * 512 ** 3   # 10 forward, 20 backward


def _with_layers(cfg, n):
    if cfg.family == "hybrid":
        return cfg.scaled(n_layers=n * cfg.attn_every)
    if cfg.family == "encdec":
        return cfg.scaled(enc_layers=n, dec_layers=n, n_layers=2 * n)
    return cfg.scaled(n_layers=n + (1 if cfg.first_dense_ff else 0))


TINY = ShapeSpec("train_tiny", "train", 8, 4)


def _traced(arch, cfg, mesh=(1, 1), **kw):
    rec = dryrun.run_cell(arch, TINY, mesh=dryrun.meta_mesh(mesh), cfg_override=cfg,
                          verbose=False, microbatches=1, **kw)
    return rec["roofline"]["flops_per_chip"], rec["roofline"]["hbm_bytes_per_chip"]


@pytest.mark.parametrize("arch", ["qwen3-14b", "deepseek-v2-lite-16b", "zamba2-2.7b",
                                  "whisper-large-v3"])
def test_traced_costs_are_linear_in_the_layers(arch):
    """c(L) = c1 + (L - 1)(c2 - c1) exactly: the identity the reference's
    reconstruction from unrolled 1- and 2-layer variants relies on, which
    the port's trace (every loop counted) needs no longer."""
    cfg = get_smoke(arch)
    (f1, b1), (f2, b2), (f4, b4) = (_traced(arch, _with_layers(cfg, n)) for n in (1, 2, 4))
    assert f4 == f1 + 3 * (f2 - f1) and f2 > f1
    assert b4 == b1 + 3 * (b2 - b1) and b2 > b1


def _batch(cfg, device, b=4, s=8):
    g = torch.Generator().manual_seed(0)
    if cfg.family == "encdec":
        s //= 2
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=g, dtype=torch.int32),
             "labels": torch.randint(0, cfg.vocab, (b, s), generator=g, dtype=torch.int32)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(b, s, cfg.d_model, generator=g)
    if cfg.family == "vlm":
        batch = {"patch_embeds": torch.randn(b, cfg.n_patches, cfg.d_model, generator=g),
                 "tokens": batch["tokens"][:, : s - cfg.n_patches],
                 "labels": batch["labels"][:, : s - cfg.n_patches]}
    return {k: v.to(device) for k, v in batch.items()}


FAMILIES = ["qwen3-14b", "granite-moe-1b-a400m", "deepseek-v2-lite-16b", "rwkv6-3b",
            "zamba2-2.7b", "whisper-large-v3", "internvl2-2b"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_a_meta_trace_counts_what_a_cpu_run_counts(arch):
    """The dry run on a one-lane mesh against ``CostMode`` around the
    port's own step (``make_train_step``) on CPU tensors."""
    cfg = get_smoke(arch)
    model = build_model(cfg)
    state, batch = make_train_state(model, 0, device="cpu"), _batch(cfg, "cpu")
    with CostMode() as real:
        make_train_step(model, TrainConfig())(state, batch)
    flops, moved = _traced(arch, cfg)
    assert (flops, moved) == (real.total()["flops"], real.total()["bytes accessed"])
    params = alloc_tree(model.param_specs(), META)
    meta_state, meta_batch = {"params": params, "opt": adamw_init(params)}, _batch(cfg, META)
    with CostMode() as meta:      # the step itself on meta tensors too
        make_train_step(model, TrainConfig())(meta_state, meta_batch)
    assert meta.total() == real.total() and meta.kernels == real.kernels


def _inputs():
    """CPU inputs of each registered entry: (wrapper, plain, args, kwargs)."""
    g = torch.Generator().manual_seed(0)
    f32, c64 = torch.float32, torch.complex64

    def r(*shape, dtype=f32):
        return torch.randn(*shape, generator=g, dtype=dtype)

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim import adamw as opt
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd
    from repro_torch.kernels.wkv6 import wkv6_bwd
    q, k, v = r(1, 4, 5, 16), r(1, 2, 5, 16), r(1, 2, 5, 16)
    wk = [r(1, 5, 2, 8) for _ in range(3)] + [r(1, 5, 2, 8) - 1.0, r(2, 8), r(1, 2, 8, 8)]
    return {
        "negate_kernel": (ops.negate, ref.negate, (r(4, 5),), {}),
        "complexElementProd": (ops.complex_elementprod, ref.complex_elementprod,
                               (r(2, 3, 4, 5, dtype=c64), r(3, 4, 5, dtype=c64), True), {}),
        "xImageSum": (ops.ximage_sum, ref.ximage_sum, (r(2, 3, 4, 5, dtype=c64),), {}),
        "rss": (ops.rss, ref.rss, (r(2, 3, 4, 5, dtype=c64),), {}),
        "mriFusedEpilogue": (ops.fused_epilogue, ref.mri_fused_epilogue,
                             (r(2, 3, 4, 5, dtype=c64), r(3, 4, 5, dtype=c64), "rss"), {}),
        "mriFusedRecon": (ops.fused_recon, ref.mri_fused_recon,
                          (r(2, 3, 4, 5, dtype=c64), r(3, 4, 5, dtype=c64), "sum", "ortho"), {}),
        "rmsnorm": (ops.rmsnorm, ref.rmsnorm, (r(2, 3, 8), r(8), 1e-6), {}),
        "rmsnorm_bwd": (rmsnorm_bwd, ref.rmsnorm_bwd, (r(2, 3, 8), r(8), r(2, 3, 8), 1e-6), {}),
        "flash_attention": (ops.flash_attention, ref.attention, (q, k, v), {"causal": True}),
        "flash_attention_bwd": (flash_attention_bwd, ref.attention_bwd,
                                (q, k, v, r(1, 4, 5, 16), r(1, 4, 5, 16), None),
                                {"causal": True}),
        "wkv6": (ops.wkv6, ref.wkv6, tuple(wk), {}),
        "wkv6_bwd": (wkv6_bwd, ref.wkv6_bwd, tuple(wk) + (r(1, 5, 2, 8), r(1, 2, 8, 8)), {}),
        # AdamW's two passes: a bf16 leaf's update (in place, no output) and
        # the sum of squares of a bf16 and an f32 gradient
        "adamw_update": (opt.update_leaf, opt._update_leaf_plain,
                         (r(3, 8, dtype=torch.bfloat16), r(3, 8), r(3, 8, dtype=torch.bfloat16),
                          r(3, 8), r(3, 8).abs(),
                          {"scale": torch.tensor(0.5), "lr": torch.tensor(1e-3),
                           "c1": torch.tensor(0.1), "c2": torch.tensor(0.05)}, AdamWConfig()),
                         {}),
        "sum_squares": (opt.sum_squares, opt._sum_squares_plain,
                        ([r(4, 5, dtype=torch.bfloat16), r(7)],), {}),
    }


def _layout(out):
    if isinstance(out, (tuple, list)):
        return [_layout(o) for o in out]
    return None if out is None else (tuple(out.shape), out.dtype)


def _to(x, device):
    if isinstance(x, list):
        return [_to(t, device) for t in x]
    return x.to(device) if isinstance(x, torch.Tensor) else x


@pytest.mark.parametrize("name", sorted(_inputs()))
def test_each_wrapper_on_meta_gives_its_plain_layout_and_its_cost(name):
    fn, plain, args, kwargs = _inputs()[name]
    want = plain(*args, **kwargs)
    margs = [_to(a, META) for a in args]
    before = registry.launch_counts()
    got = fn(*margs, **kwargs)
    assert _layout(got) == _layout(want)
    with CostMode() as meta:
        fn(*margs, **kwargs)
    with CostMode() as cpu:
        fn(*args, **kwargs)
    assert registry.launch_counts() == before                 # no launch counted
    cost = registry.KernelRegistry().entry(name).cost(*margs, **kwargs)
    assert meta.kernels == {name: [1, float(cost.flops), float(cost.bytes)]} == cpu.kernels
    assert meta.total() == {"flops": float(cost.flops), "bytes accessed": float(cost.bytes)}
    assert cpu.total() == meta.total()


def test_meta_route_does_not_touch_a_call_without_a_mode():
    """Without a counting mode a CPU call is the plain version's, as
    before, and counts nothing."""
    x, w = torch.randn(2, 8), torch.randn(8)
    from repro_torch.kernels.rmsnorm import rmsnorm
    assert torch.equal(rmsnorm(x, w), ref.rmsnorm(x, w))
    assert registry.counting_mode() is None


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _dense_layer():
    """h2o-danube SMOKE cut to one layer: 4 heads and 2 kv heads of 16,
    d 64, d_ff 128, vocab 128, f32; over model=2 each lane owns whole
    heads (no gather)."""
    return get_smoke("h2o-danube-1.8b").scaled(n_layers=1)


def test_collective_bytes_of_a_dense_layer_by_hand():
    cfg = _dense_layer()
    f32 = 4
    # a lane's pieces (model = 2) by the partition rules, and the ZeRO-1
    # rule puts data on a dim of every leaf (each has one that 16 divides)
    pieces = {"['embed']['embedding']": 64 * 64, "['embed']['unembed']": 64 * 64,
              "['final_norm']['scale']": 64,
              "['layers']['attn']['w_q']": 64 * 32, "['layers']['attn']['w_k']": 64 * 16,
              "['layers']['attn']['w_v']": 64 * 16, "['layers']['attn']['w_o']": 32 * 64,
              "['layers']['ln_attn']['scale']": 64, "['layers']['ln_mlp']['scale']": 64,
              "['layers']['mlp']['w_gate']": 64 * 64, "['layers']['mlp']['w_up']": 64 * 64,
              "['layers']['mlp']['w_down']": 64 * 64}
    for mesh, rows in (((1, 2), 4), ((2, 2), 2)):
        rec = dryrun.run_cell("h2o-danube-1.8b", TINY, mesh=dryrun.meta_mesh(mesh),
                              cfg_override=cfg, microbatches=1, verbose=False)
        x = rows * 8 * 64 * f32                  # a lane's copy of the residual stream
        # forward: the embedding's, the attention's and the MLP's reduce;
        # backward: the copies before the attention, the MLP and the logits
        want = {"all-reduce": 6 * x}
        if mesh[0] == 2:
            want["reduce-scatter"] = want["all-gather"] = f32 * sum(pieces.values())
        assert rec["roofline"]["coll_breakdown"] == want, mesh
        events = rec["_events"]
        assert collective_bytes(events) == want
        data = {n for _, n, _, axis in events if axis == "data"}
        assert data == (set(pieces) if mesh[0] == 2 else set())


def test_diagnose_sources_sum_to_the_totals(capsys):
    """qwen3-14b's 2-layer variant at train_4k on the production mesh (40
    heads over 16 lanes: q, k and v gathered on every lane)."""
    rec = diagnose("qwen3-14b", "train_4k", top=10 ** 6)
    events = rec["_events"]
    total = collective_bytes(events)
    summed = {}
    for kind, name, b in collective_sources(events, top=10 ** 6):
        summed[kind] = summed.get(kind, 0) + b
        assert name != "?"
    assert summed == total and total["all-gather"] > 0
    printed = capsys.readouterr().out
    assert "totals/chip:" in printed and "_project_qkv_lanes" in printed
    assert two_layers(get_config("zamba2-2.7b")).n_layers == 2
    assert two_layers(get_config("whisper-large-v3")).enc_layers == 2
    assert two_layers(get_config("deepseek-v2-lite-16b")).n_layers == 3


# ---------------------------------------------------------------------------
# Memory, the whole dry run, the flags
# ---------------------------------------------------------------------------

_J_MEMORY = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding
from repro.configs import get_smoke
from repro.launch.specs import build_lowerable, fit_pspecs
from repro.models.common import mesh_axes, resolve_tree
mesh = Mesh(np.array(jax.devices()[:16]).reshape(4, 4), ("data", "model"))
low = build_lowerable("qwen3-14b", "train_4k", cfg_override=get_smoke("qwen3-14b"),
                      microbatches=1)
with mesh, mesh_axes(mesh):
    fitted = fit_pspecs(resolve_tree(low.in_pspecs), low.specs, mesh)
shard = 0
for specs, ps in zip(low.specs, fitted):
    for s, p in zip(jax.tree.leaves(specs), jax.tree.leaves(
            ps, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))):
        shard += int(np.prod(NamedSharding(mesh, p).shard_shape(s.shape))) * s.dtype.itemsize
try:
    from repro.launch.dryrun import _compile_cell
    compiled = _compile_cell(low, mesh).memory_analysis().argument_size_in_bytes
except Exception as e:
    compiled = -1
print("ARGS", compiled, shard)
"""


def test_argument_bytes_equal_the_reference_memory_analysis():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _J_MEMORY], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    compiled, shard = (int(v) for v in r.stdout.split("ARGS")[1].split())
    rec = dryrun.run_cell("qwen3-14b", "train_4k", mesh=dryrun.meta_mesh((4, 4)),
                          cfg_override=get_smoke("qwen3-14b"), microbatches=1,
                          skip_analysis=True, verbose=False)
    got = rec["memory"]["argument_size_in_bytes"]
    assert got == shard
    if compiled >= 0:                            # the reference compiled it
        assert got == compiled
    assert rec["memory"]["alias_size_in_bytes"] < got


JAX_RECORD_KEYS = {"arch", "shape", "kind", "mesh", "chips", "multi_pod", "note", "memory",
                   "roofline", "raw_cost_body_once", "compile_s", "status"}


def test_run_cell_on_the_granite_smoke_cut():
    """``tests/test_system.py``'s reduced cell: granite SMOKE in bf16 on a
    (4, 4) mesh, one microbatch."""
    cfg = get_smoke("granite-moe-1b-a400m").scaled(param_dtype="bfloat16", dtype="bfloat16")
    rec = dryrun.run_cell("granite-moe-1b-a400m", "train_4k", mesh=dryrun.meta_mesh((4, 4)),
                          verbose=False, cfg_override=cfg, microbatches=1)
    assert set(rec) - {"_events"} == JAX_RECORD_KEYS
    assert rec["status"] == "ok" and rec["chips"] == 16 and rec["kind"] == "train"
    roof = rec["roofline"]
    assert roof["flops_per_chip"] > 0 and roof["coll_bytes_per_chip"] >= 0
    assert set(roof) == set(Roofline(1, 1, 1, {}, 1).to_dict(1))
    assert set(rec["memory"]) == {"argument_size_in_bytes", "output_size_in_bytes",
                                  "alias_size_in_bytes", "temp_size_in_bytes"}
    assert rec["memory"]["temp_size_in_bytes"] > 0
    assert "no remat" in rec["note"]
    assert rec["raw_cost_body_once"]["flops"] <= roof["flops_per_chip"]


def test_opt_refuses_the_reference_levers(capsys):
    for lever in ("opt_seq_parallel=1", "unroll_layers=1", "use_pallas=0"):
        with pytest.raises(ValueError, match=lever.split("=")[0]):
            dryrun.main(["--arch", "qwen3-14b", "--shape", "train_4k", "--opt", lever])
    assert dryrun.parse_overrides(["remat=0", "n_layers=2"]) == {"remat": False, "n_layers": 2}


def test_a_cell_the_port_cannot_place_names_the_leaf():
    with pytest.raises(ValueError, match=r"\['embed'\]\['embedding'\].*49155"):
        dryrun.run_cell("granite-moe-1b-a400m", "train_4k", verbose=False)


def test_a_production_decode_cell_fits_one_card():
    rec = dryrun.run_cell("zamba2-2.7b", "long_500k", verbose=False)
    mem = rec["memory"]
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"] < 80e9
    assert rec["roofline"]["bottleneck"] == "memory"
    assert rec["roofline"]["coll_breakdown"] == {}


def test_make_train_state_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(get_smoke("qwen3-14b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_state(model, 0)
    state = make_train_state(model, 0, device="cpu")
    assert tree_flatten(state["params"])[0][1].device.type == "cpu"
