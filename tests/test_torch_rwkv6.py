"""The port's RWKV6 pieces against the JAX package's, on the same numpy
inputs made from a seed.

* ``wkv6``: the wrapper on CPU tensors (its plain version) against the JAX
  Pallas kernel run as ``tests/test_kernels.py`` runs it (interpret mode off
  the TPU), with and without an input state, and with the state carried
  across two calls.  f32 tolerances: rtol 1e-4 / atol 1e-5 for the output
  and the final state (sums over D taken in another order).
* The arithmetic of the CUDA ``wkv6_kernel``, emulated in plain torch
  (column slices, row groups whose partial sums meet in the kernel's
  shuffle order, ``fmaf`` state updates, tiles of staged steps), against
  the same JAX kernel at the same tolerances.
* The gradient: the plain version ``ref.wkv6_bwd`` (autograd through
  ``ref.wkv6``) against ``jax.vjp`` through the JAX package's plain
  ``kref.wkv6`` (what ``jax.grad`` trains through), head sizes 8 and 64,
  with and without an input state and a final-state gradient: f32 within
  rtol 1e-4 + 1e-6 x max |grad| (measured up to 3.2e-7 x max), bf16 r/k/v
  within the forward's bf16 band, 2e-2 x max |grad|.  The arithmetic of
  the CUDA ``wkv6_bwd_kernel`` (the forward's state checkpoints every
  ``CHUNK`` steps, each chunk's states recomputed from its checkpoint, the
  steps run backwards, the sums in the kernel's shuffle and warp order)
  emulated in plain torch against the same ``jax.vjp``, with T no multiple
  of the chunk and with decays that underflow to 0 in f32; ``Wkv6Fn`` on
  CPU tensors against autograd through the plain version, counting no
  launch.
* The model's layers (``_group_norm``, ``time_mix``, ``channel_mix``)
  against ``repro.models.rwkv6``'s at f32 1e-5, with and without the
  carried shift vectors and WKV state.

The whole model and its serving path are compared in
``tests/test_torch_lm.py``; the CUDA kernel is held against the plain
version on the card by ``chip_smoke.py``.
"""
import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.kernels import ref as jref
from repro.kernels.wkv6 import wkv6 as j_wkv6
from repro.models import rwkv6 as jrwkv
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.registry import KernelRegistry, launch_counts
from repro_torch.kernels import _build, ref
from repro_torch.kernels.wkv6 import CHUNK, Wkv6Fn, wkv6, wkv6_bwd
from repro_torch.models import build_model
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models.common import tree_flatten, tree_map

WKV = dict(rtol=1e-4, atol=1e-5)
LAYER = dict(rtol=1e-5, atol=1e-5)


def _wkv_inputs(rng, b, t, h, d, with_state):
    r, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3))
    w = (rng.standard_normal((b, t, h, d)) * 0.5).astype(np.float32)
    u = rng.standard_normal((h, d)).astype(np.float32)
    s = rng.standard_normal((b, h, d, d)).astype(np.float32) if with_state else None
    return r, k, v, w, u, s


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("shape", [(1, 16, 2, 8), (2, 37, 3, 8), (1, 9, 2, 64), (4, 1, 3, 8)],
                         ids=["tile", "ragged-T", "head-64", "decode"])
@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
def test_wkv6_matches_pallas(rng, shape, with_state):
    args = _wkv_inputs(rng, *shape, with_state)
    want_o, want_s = j_wkv6(*map(_j, args))
    got_o, got_s = wkv6(*map(_t, args))
    assert got_o.dtype == torch.float32 and got_s.shape == want_s.shape
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **WKV)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **WKV)


def test_wkv6_chunked_state_passing(rng):
    """Two calls carrying the state equal one call, in both packages."""
    r, k, v, w, u, s0 = _wkv_inputs(rng, 2, 21, 2, 8, True)
    cut = 13
    o1, s1 = wkv6(*(_t(x[:, :cut]) for x in (r, k, v, w)), _t(u), _t(s0))
    o2, s2 = wkv6(*(_t(x[:, cut:]) for x in (r, k, v, w)), _t(u), s1)
    want_o, want_s = j_wkv6(*map(_j, (r, k, v, w, u, s0)))
    np.testing.assert_allclose(torch.cat([o1, o2], 1).numpy(), np.asarray(want_o), **WKV)
    np.testing.assert_allclose(s2.numpy(), np.asarray(want_s), **WKV)


def test_wkv6_writes_the_final_state_in_place(rng):
    """``state_out=state`` (how decode updates ``cache["wkv"][i]``) leaves
    the final state in the input's storage."""
    r, k, v, w, u, s0 = map(_t, _wkv_inputs(rng, 2, 5, 3, 8, True))
    want_o, want_s = ref.wkv6(r, k, v, w, u, s0.clone())
    state = s0.clone()
    out, final = wkv6(r, k, v, w, u, state, state_out=state)
    assert final.data_ptr() == state.data_ptr()
    np.testing.assert_array_equal(out.numpy(), want_o.numpy())
    np.testing.assert_array_equal(state.numpy(), want_s.numpy())


def test_wkv6_plain_version_matches_the_jax_oracle_in_bf16(rng):
    """bf16 r/k/v (the full-width activation dtype): the output is rounded to
    bf16 once, so within 2e-2 of max |out| of the JAX oracle on the same bf16
    inputs; the f32 state within 1e-4."""
    r, k, v, w, u, s0 = _wkv_inputs(rng, 1, 12, 2, 16, True)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (r, k, v)]
    tb = [torch.from_numpy(x).to(torch.bfloat16) for x in (r, k, v)]
    want_o, want_s = jref.wkv6(*jb, jnp.asarray(w), jnp.asarray(u), jnp.asarray(s0))
    got_o, got_s = wkv6(*tb, _t(w), _t(u), _t(s0))
    assert got_o.dtype == torch.bfloat16
    want_o = np.asarray(want_o, np.float32)
    np.testing.assert_allclose(got_o.float().numpy(), want_o, rtol=0,
                               atol=2e-2 * np.abs(want_o).max())
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-4, atol=1e-4)


def _fma(a, b, c):
    """``fmaf`` on f32 tensors: the product is exact in f64 and the sum is
    rounded once to f64, then to f32 (this double rounding can differ from
    the card's single one by an ulp, far inside the tolerances)."""
    return (a.double() * b.double() + c.double()).float()


def _butterfly(x):
    """The sum over the last axis that lane 0 holds after an xor-shuffle
    reduction with offsets n/2, n/4, ..., 1."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _wkv6_layout_emulation(r, k, v, w, u, state=None):
    """The arithmetic of ``wkv6_kernel`` (``csrc/rwkv_kernels.cu``) in plain
    torch, with its ``WkvLayout``: the G = min(8, D) lanes of a column pair
    hold rows g, g + G, ... of both columns; per step and column each lane
    takes ``o[m & 1] = fmaf(r_i, s_ij, o[m & 1])`` and ``s_ij = fmaf(s_ij,
    decay_i, k_i * v_j)`` over its rows m and adds its two partials; the G
    lane sums of a column meet in a reduce-scatter whose adds pair the lanes
    as an xor-shuffle reduction does (offsets G/2, ..., 1); ``o_j =
    fmaf(a_t, v_j, sum)``.  Steps are staged in tiles of 64 (D < 32) or
    2048 / D steps: ``decay = exp(-exp(w))`` once per (step, row), and
    ``a_t`` as (r_i * u_i) * k_i reduced in shuffle order over warps of
    min(D, 32) rows, the D / 32 warp sums added in order.  Which block owns
    a column, and when a tile is staged, change no value, so neither is a
    loop here."""
    b, t, h, d = r.shape
    groups = min(8, d)
    rows, tile = d // groups, 64 if d < 32 else 2048 // d
    lanes = min(d, 32)
    rf, kf, vf, uf = r.float(), k.float(), v.float(), u.float()
    s = torch.zeros(b, h, d, d) if state is None else state.float().clone()
    sv = s.view(b, h, rows, groups, d)             # row i = m * G + g
    out = torch.empty(b, t, h, d)
    for t0 in range(0, t, tile):
        nt = min(tile, t - t0)
        decay = torch.exp(-torch.exp(w[:, t0:t0 + nt].float()))
        parts = _butterfly((rf[:, t0:t0 + nt] * uf * kf[:, t0:t0 + nt])
                           .reshape(b, nt, h, d // lanes, lanes))
        a = torch.zeros(b, nt, h)
        for q in range(d // lanes):
            a = a + parts[..., q]
        for tt in range(nt):
            ti = t0 + tt
            vj = vf[:, ti][:, :, None, :]          # (B, H, 1, D) over columns j
            ri, ki, di = (x.reshape(b, h, rows, groups)
                          for x in (rf[:, ti], kf[:, ti], decay[:, tt]))
            o = [torch.zeros(b, h, groups, d), torch.zeros(b, h, groups, d)]
            for m in range(rows):
                o[m & 1] = _fma(ri[:, :, m, :, None], sv[:, :, m], o[m & 1])
                sv[:, :, m] = _fma(sv[:, :, m], di[:, :, m, :, None],
                                   ki[:, :, m, :, None] * vj)
            lane_sums = _butterfly((o[0] + o[1]).transpose(-1, -2))   # (B, H, D)
            out[:, ti] = _fma(a[:, tt, :, None], vf[:, ti], lane_sums)
    return out.to(r.dtype), s


@pytest.mark.parametrize("shape", [(1, 16, 2, 8), (2, 37, 3, 8), (1, 9, 2, 64), (2, 37, 3, 64),
                                   (4, 1, 3, 8), (4, 1, 3, 64)],
                         ids=["tile", "ragged-T", "head-64", "head-64-two-tiles", "decode",
                              "decode-64"])
@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
def test_wkv6_kernel_arithmetic_matches_pallas(rng, shape, with_state):
    """The kernel's layout and summation order stay inside the tolerances
    that ``test_wkv6_matches_pallas`` holds the plain version to (37 steps
    at D = 64 are a 32-step tile and a ragged second)."""
    args = _wkv_inputs(rng, *shape, with_state)
    want_o, want_s = j_wkv6(*map(_j, args))
    got_o, got_s = _wkv6_layout_emulation(*map(_t, args))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **WKV)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **WKV)


@pytest.mark.parametrize("d", [8, 64])
def test_wkv6_kernel_arithmetic_decodes_from_a_carried_state(rng, d):
    """A prefill of 36 steps, then one T = 1 decode step from its final state
    (as ``rwkv6.py`` decodes), equals the JAX kernel over all 37 steps."""
    r, k, v, w, u, s0 = _wkv_inputs(rng, 2, 37, 3, d, True)
    o1, s1 = _wkv6_layout_emulation(*(_t(x[:, :36]) for x in (r, k, v, w)), _t(u), _t(s0))
    o2, s2 = _wkv6_layout_emulation(*(_t(x[:, 36:]) for x in (r, k, v, w)), _t(u), s1)
    want_o, want_s = j_wkv6(*map(_j, (r, k, v, w, u, s0)))
    np.testing.assert_allclose(torch.cat([o1, o2], 1).numpy(), np.asarray(want_o), **WKV)
    np.testing.assert_allclose(s2.numpy(), np.asarray(want_s), **WKV)


def test_wkv6_kernel_arithmetic_fits_the_bf16_tolerance(rng):
    """bf16 r/k/v at the full-width head size: the emulated kernel within
    2e-2 of max |out| of the JAX oracle on the same bf16 inputs (the
    tolerance ``chip_smoke.py`` holds the card to), the state within 1e-4."""
    r, k, v, w, u, s0 = _wkv_inputs(rng, 1, 40, 2, 64, True)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (r, k, v)]
    tb = [torch.from_numpy(x).to(torch.bfloat16) for x in (r, k, v)]
    want_o, want_s = jref.wkv6(*jb, jnp.asarray(w), jnp.asarray(u), jnp.asarray(s0))
    got_o, got_s = _wkv6_layout_emulation(*tb, _t(w), _t(u), _t(s0))
    assert got_o.dtype == torch.bfloat16
    want_o = np.asarray(want_o, np.float32)
    np.testing.assert_allclose(got_o.float().numpy(), want_o, rtol=0,
                               atol=2e-2 * np.abs(want_o).max())
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-4, atol=1e-4)


def test_wkv6_checks_shapes_before_choosing_a_device():
    x = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="one"):
        wkv6(x, x, x, torch.zeros(1, 4, 2, 4), torch.zeros(2, 8))
    with pytest.raises(ValueError, match="u "):
        wkv6(x, x, x, x, torch.zeros(3, 8))
    with pytest.raises(ValueError, match="state"):
        wkv6(x, x, x, x, torch.zeros(2, 8), torch.zeros(1, 2, 8, 4))
    m = torch.empty(1, 4, 2, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        wkv6(m, m, m, m, torch.empty(2, 8, device="meta"))


def test_wkv6_registered_and_cpu_runs_count_no_launch(rng):
    reg = KernelRegistry()
    assert reg.load("wkv6") == ["wkv6", "wkv6_bwd"]
    assert reg.ref("wkv6") is ref.wkv6 and reg.ref("wkv6_bwd") is ref.wkv6_bwd
    before = launch_counts()
    reg.get("wkv6")(*map(_t, _wkv_inputs(rng, 1, 3, 2, 8, False)[:5]))
    assert launch_counts() == before


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
            "long long": ctypes.c_longlong, "float": ctypes.c_float}


def test_c_entry_points_match_their_ctypes_signatures():
    """Every ``extern "C"`` entry point of ``csrc/*.cu`` is bound with the
    C types of its prototype, argument for argument (a pointer bound as an
    int would be cut to 32 bits; a missing argument would be garbage)."""
    protos = {}
    for src in _build.sources():
        for name, args in re.findall(r"^int (rt_\w+)\(([^)]*)\)", src.read_text(), re.M):
            protos[name] = [re.sub(r"\s*\w+$", "", a.strip()) for a in args.split(",")]
    assert set(protos) == set(_build._SIGNATURES), sorted(set(protos) ^ set(_build._SIGNATURES))
    assert {"rt_wkv6", "rt_wkv6_bwd"} <= set(protos)
    for name, types in protos.items():
        assert list(_build._SIGNATURES[name]) == [_C_TYPES[t] for t in types], name


# ---------------------------------------------------------------------------
# the gradient
# ---------------------------------------------------------------------------

def _jax_grads(r, k, v, w, u, s, do, ds):
    """``jax.vjp`` through the JAX package's plain wkv6 (its scan):
    (dr, dk, dv, dw, du, ds0 or None)."""
    if s is None:
        _, vjp = jax.vjp(lambda *a: jref.wkv6(*a), *map(jnp.asarray, (r, k, v, w, u)))
    else:
        _, vjp = jax.vjp(jref.wkv6, *map(jnp.asarray, (r, k, v, w, u, s)))
    final = jnp.zeros((r.shape[0],) + (r.shape[2],) + (r.shape[3],) * 2, jnp.float32) \
        if ds is None else jnp.asarray(ds)
    got = vjp((jnp.asarray(do), final))
    return tuple(np.asarray(g, np.float32) for g in got) + ((None,) if s is None else ())


def _bwd_inputs(rng, b, t, h, d, with_state, with_dstate, w_shift=0.0):
    r, k, v, w, u, s = _wkv_inputs(rng, b, t, h, d, with_state)
    do = rng.standard_normal((b, t, h, d)).astype(np.float32)
    ds = rng.standard_normal((b, h, d, d)).astype(np.float32) if with_dstate else None
    return r, k, v, (w + np.float32(w_shift)).astype(np.float32), u, s, do, ds


def _assert_grads(got, want, rtol=1e-4, atol=1e-6):
    assert (got[5] is None) == (want[5] is None)
    for name, g, wv in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
        if wv is None:
            continue
        g = g.float().numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(g, wv, rtol=rtol, atol=atol * float(np.abs(wv).max()),
                                   err_msg=name)


@pytest.mark.parametrize("shape", [(2, 12, 2, 8), (1, 40, 2, 64)], ids=["head-8", "head-64"])
@pytest.mark.parametrize("with_state,with_dstate", [(False, False), (True, False), (True, True)],
                         ids=["zeros", "state", "state-and-final-grad"])
def test_wkv6_bwd_plain_version_matches_jax_grad(rng, shape, with_state, with_dstate):
    args = _bwd_inputs(rng, *shape, with_state, with_dstate)
    got = ref.wkv6_bwd(*map(_t, args))
    assert got[0].dtype == torch.float32 and got[4].shape == (shape[2], shape[3])
    _assert_grads(got, _jax_grads(*args))


def test_wkv6_bwd_plain_version_in_bf16(rng):
    """bf16 r/k/v and output gradient (the full-width dtype): dr, dk, dv
    come back in bf16, every gradient within 2e-2 x max |grad| of
    ``jax.vjp`` on the same bf16 inputs."""
    r, k, v, w, u, s, do, _ = _bwd_inputs(rng, 1, 20, 2, 64, True, False)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (r, k, v)]
    _, vjp = jax.vjp(jref.wkv6, *jb, jnp.asarray(w), jnp.asarray(u), jnp.asarray(s))
    want = [np.asarray(g, np.float32) for g in vjp((jnp.asarray(do, jnp.bfloat16),
                                                     jnp.zeros((1, 2, 64, 64), jnp.float32)))]
    tb = [torch.from_numpy(x).to(torch.bfloat16) for x in (r, k, v)]
    got = ref.wkv6_bwd(*tb, _t(w), _t(u), _t(s), torch.from_numpy(do).to(torch.bfloat16))
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [torch.float32] * 3
    _assert_grads(got, want, rtol=0, atol=2e-2)


def _up(x):
    """The sum over the last axis that lane 0 holds after an xor-shuffle
    reduction with offsets 1, 2, ..., n/2 (neighbours first)."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def _wkv6_bwd_emulation(r, k, v, w, u, state, dout, dstate=None):
    """The arithmetic of ``wkv6_kernel<CKPT>`` + ``wkv6_bwd_kernel`` +
    ``wkv6_bwd_finish_kernel`` in plain torch, with the forward's
    ``WkvLayout``.  The forward writes the state entering every CHUNK-th
    step (``s = fmaf(s, a, k v)`` a step); the backward runs the chunks last
    to first, recomputes each chunk's states from its checkpoint the same
    way (never dividing by a decay), then runs its steps backwards: per
    column pair, ``fmaf(x_j, y_j, x_j1 * y_j1)`` products for dr, dk and dw,
    summed over the warp's 4 pairs by xor shuffles (offsets G, 2 G:
    neighbours first), over the warps in order, then over the column
    blocks of 32 in order; dv as the lanes' sequential ``fmaf`` over their
    rows, met in the forward's reduce-scatter; the u terms once (column
    block 0); G = fmaf(a_i, G, r_i do_j); v . do and sum_i (r_i u_i) k_i
    reduced in shuffle order over min(D, 32) rows, the D / 32 sums in
    order; du a per-(batch, head) sum over the steps, last to first, then
    over the batch in order."""
    b, t, h, d = r.shape
    groups, lanes = min(8, d), min(d, 32)
    rows, ny = d // groups, d // lanes
    warps = lanes // 2 * groups // 32
    rf, kf, vf, dof, uf = (x.float() for x in (r, k, v, dout, u))
    ew = torch.exp(w.float())
    a = torch.exp(-ew)

    def step(s, ti):
        return _fma(s, a[:, ti, :, :, None], kf[:, ti, :, :, None] * vf[:, ti, :, None, :])

    s = torch.zeros(b, h, d, d) if state is None else state.float().clone()
    ckpts = []
    for ti in range(t):
        if ti % CHUNK == 0:
            ckpts.append(s)
        s = step(s, ti)

    def staged(x):
        parts = _butterfly(x.reshape(b, t, h, d // lanes, lanes))
        acc = torch.zeros(b, t, h)
        for q in range(d // lanes):
            acc = acc + parts[..., q]
        return acc

    vdo, bonus = staged(vf * dof), staged(rf * uf * kf)

    def colsum(x):                       # (b, h, d, d / 2 pairs) -> (ny, b, h, d)
        x = _up(x.reshape(b, h, d, ny, warps, 32 // groups))
        acc = torch.zeros(b, h, d, ny)
        for wp in range(warps):
            acc = acc + x[..., wp]
        return acc.permute(3, 0, 1, 2)

    G = torch.zeros(b, h, d, d) if dstate is None else dstate.float().clone()
    part = torch.zeros(ny, 3, b, t, h, d)
    dv = torch.empty(b, t, h, d)
    du_acc = torch.zeros(b, h, d)
    for ci in reversed(range(len(ckpts))):
        t0 = ci * CHUNK
        states = [ckpts[ci]]
        for ti in range(t0, min(t0 + CHUNK, t) - 1):
            states.append(step(states[-1], ti))
        for tt in reversed(range(len(states))):
            ti = t0 + tt
            sp = states[tt].reshape(b, h, d, d // 2, 2)
            gp = G.reshape(b, h, d, d // 2, 2)
            doj = dof[:, ti].reshape(b, h, 1, d // 2, 2)
            vj = vf[:, ti].reshape(b, h, 1, d // 2, 2)
            dr = colsum(_fma(sp[..., 0], doj[..., 0], sp[..., 1] * doj[..., 1]))
            dk = colsum(_fma(gp[..., 0], vj[..., 0], gp[..., 1] * vj[..., 1]))
            dw = colsum(_fma(sp[..., 0], gp[..., 0], sp[..., 1] * gp[..., 1]))
            ri, ki, vd = rf[:, ti], kf[:, ti], vdo[:, ti, :, None]
            dr[0] = _fma(uf * ki, vd, dr[0])
            dk[0] = _fma(uf * ri, vd, dk[0])
            du_acc = _fma(ri * ki, vd, du_acc)
            dw = dw * -(ew[:, ti] * a[:, ti])
            part[:, 0, :, ti], part[:, 1, :, ti], part[:, 2, :, ti] = dr, dk, dw
            gr, kr = G.view(b, h, rows, groups, d), ki.view(b, h, rows, groups)
            lane = torch.zeros(b, h, groups, d)
            for m in range(rows):
                lane = _fma(gr[:, :, m], kr[:, :, m, :, None], lane)
            dv[:, ti] = _fma(bonus[:, ti, :, None], dof[:, ti],
                             _butterfly(lane.transpose(-1, -2)))
            G = _fma(a[:, ti, :, :, None], G, ri[..., None] * dof[:, ti, :, None, :])
    sums = torch.zeros(3, b, t, h, d)
    for y in range(ny):
        sums = sums + part[y]
    du = torch.zeros(h, d)
    for bb in range(b):
        du = du + du_acc[bb]
    return (sums[0].to(r.dtype), sums[1].to(r.dtype), dv.to(r.dtype), sums[2], du,
            None if state is None else G)


@pytest.mark.parametrize("shape", [(2, 37, 3, 8), (1, 37, 2, 64), (2, 16, 2, 64), (3, 5, 2, 8)],
                         ids=["head-8-ragged", "head-64-ragged", "one-chunk", "short"])
@pytest.mark.parametrize("with_state,with_dstate", [(False, False), (True, True)],
                         ids=["zeros", "state-and-final-grad"])
def test_wkv6_bwd_kernel_arithmetic_matches_jax_grad(rng, shape, with_state, with_dstate):
    """T = 37 is two whole chunks of 16 and a ragged third; the kernel's
    layout and summation order stay inside the plain version's band."""
    args = _bwd_inputs(rng, *shape, with_state, with_dstate)
    _assert_grads(_wkv6_bwd_emulation(*map(_t, args)), _jax_grads(*args))


@pytest.mark.parametrize("d", [8, 64])
def test_wkv6_bwd_kernel_arithmetic_with_decays_that_underflow(rng, d):
    """w around 7 (exp(w) over 104): exp(-exp(w)) is 0 in f32, so no state
    could be recovered by dividing by the decay; the recomputation from
    the checkpoints needs none, and dw is 0 where the decay is, as in
    ``jax.vjp``."""
    args = _bwd_inputs(rng, 2, 37, 2, d, True, True, w_shift=7.0)
    assert not np.exp(-np.exp(args[3])).any()
    got = _wkv6_bwd_emulation(*map(_t, args))
    assert np.isfinite(got[3].numpy()).all()
    _assert_grads(got, _jax_grads(*args))


def test_wkv6_bwd_kernel_arithmetic_fits_the_bf16_tolerance(rng):
    """bf16 r/k/v and output gradient at the full-width head size: the
    emulated kernel within 2e-2 x max |grad| of ``jax.vjp`` on the same bf16
    inputs (the band ``chip_smoke.py`` holds the card to)."""
    r, k, v, w, u, s, do, _ = _bwd_inputs(rng, 1, 40, 2, 64, True, False)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (r, k, v)]
    _, vjp = jax.vjp(jref.wkv6, *jb, jnp.asarray(w), jnp.asarray(u), jnp.asarray(s))
    want = [np.asarray(g, np.float32) for g in vjp((jnp.asarray(do, jnp.bfloat16),
                                                     jnp.zeros((1, 2, 64, 64), jnp.float32)))]
    tb = [torch.from_numpy(x).to(torch.bfloat16) for x in (r, k, v)]
    got = _wkv6_bwd_emulation(*tb, _t(w), _t(u), _t(s), torch.from_numpy(do).to(torch.bfloat16))
    assert [g.dtype for g in got[:3]] == [torch.bfloat16] * 3
    _assert_grads(got, want, rtol=0, atol=2e-2)


def test_wkv6_chunk_is_the_kernels():
    src = (_build.CSRC / "rwkv_kernels.cu").read_text()
    assert int(re.search(r"constexpr int kWkvChunk = (\d+);", src).group(1)) == CHUNK


def test_wkv6_fn_on_cpu_tensors_matches_the_plain_gradient_and_counts_no_launch(rng):
    """``Wkv6Fn`` (what a CUDA training forward takes) on CPU tensors runs
    the plain versions: the gradients of autograd through ``ref.wkv6``,
    bit for bit, and no launch counted."""
    r, k, v, w, u, s, do, ds = map(_t, _bwd_inputs(rng, 2, 19, 2, 8, True, True))
    leaves = [x.clone().requires_grad_(True) for x in (r, k, v, w, u, s)]
    before = launch_counts()
    out, final = Wkv6Fn.apply(*leaves)
    torch.autograd.backward((out, final), (do, ds))
    assert launch_counts() == before
    want = ref.wkv6_bwd(r, k, v, w, u, s, do, ds)
    for leaf, g in zip(leaves, want):
        assert torch.equal(leaf.grad, g)
    assert all(torch.equal(a, b) for a, b in zip(wkv6_bwd(r, k, v, w, u, s, do, ds), want))


def test_wkv6_bwd_checks_shapes_before_choosing_a_device():
    x = torch.zeros(1, 4, 2, 8)
    u = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="dout"):
        wkv6_bwd(x, x, x, x, u, None, torch.zeros(1, 4, 2, 4))
    with pytest.raises(ValueError, match="dstate"):
        wkv6_bwd(x, x, x, x, u, None, x, torch.zeros(1, 2, 8, 4))
    m = torch.empty(1, 4, 2, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_bwd(m, m, m, m, torch.empty(2, 8, device="meta"), None, m)


# ---------------------------------------------------------------------------
# model layers
# ---------------------------------------------------------------------------

def _cfgs():
    return j_get_smoke("rwkv6-3b"), get_smoke("rwkv6-3b")


def _layer_params(rng, cfg):
    """Random f32 arrays for one layer's time-mix and channel-mix (the
    zero-initialised mixes and decay drawn too, so they matter)."""
    specs = trwkv.layer_specs(cfg)
    return {part: {k: (rng.standard_normal(s.shape) * 0.3).astype(np.float32)
                   for k, s in specs[part].items()} for part in ("tm", "cm")}


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
def test_time_mix_matches_reference(rng, carried):
    jcfg, tcfg = _cfgs()
    p = _layer_params(rng, tcfg)["tm"]
    nh, dh = tcfg.d_model // tcfg.rwkv_head_dim, tcfg.rwkv_head_dim
    x = rng.standard_normal((2, 7, tcfg.d_model)).astype(np.float32)
    shift = rng.standard_normal((2, tcfg.d_model)).astype(np.float32) if carried else None
    state = rng.standard_normal((2, nh, dh, dh)).astype(np.float32) if carried else None
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want = jrwkv.time_mix(jp, jnp.asarray(x), jcfg, lambda *a: jref.wkv6(*a),
                          _j(shift), _j(state))
    got = trwkv.time_mix(tree_map(torch.from_numpy, p), torch.from_numpy(x), tcfg,
                         _t(shift), _t(state))
    for g, w, tol in zip(got, want, (WKV, LAYER, WKV)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
def test_channel_mix_matches_reference(rng, carried):
    jcfg, tcfg = _cfgs()
    p = _layer_params(rng, tcfg)["cm"]
    x = rng.standard_normal((2, 5, tcfg.d_model)).astype(np.float32)
    shift = rng.standard_normal((2, tcfg.d_model)).astype(np.float32) if carried else None
    want = jrwkv.channel_mix({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg,
                             _j(shift))
    got = trwkv.channel_mix(tree_map(torch.from_numpy, p), torch.from_numpy(x), tcfg,
                            _t(shift))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **LAYER)


def test_group_norm_matches_reference(rng):
    x = rng.standard_normal((2, 3, 64)).astype(np.float32) * 3 + 1
    scale, bias = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    want = jrwkv._group_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 8, 8)
    got = trwkv._group_norm(*map(torch.from_numpy, (x, scale, bias)), 8, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)


def test_init_params_gives_each_leaf_its_reference_role():
    """Zero token-shift mixes and decay base, unit group-norm scale, zero
    bias, f32 ``u``, and the JAX ``dense_init`` fan-in (the first per-layer
    axis: 5 for ``tm_w2``)."""
    model = build_model(get_smoke("rwkv6-3b").scaled(n_layers=3, d_model=256,
                                                     rwkv_head_dim=32))
    params = dict(tree_flatten(model.init_params(torch.Generator().manual_seed(0))))
    tm = "['layers']['tm']"
    for leaf in ("maa_x", "maa_w", "maa_k", "maa_v", "maa_r", "maa_g", "decay", "gn_bias"):
        assert not params[f"{tm}['{leaf}']"].any(), leaf
    assert not params["['layers']['cm']['maa_k']"].any()
    assert bool((params[f"{tm}['gn_scale']"] == 1).all())
    assert bool((params["['ln0']['scale']"] == 1).all())
    assert params[f"{tm}['u']"].dtype == torch.float32 and params[f"{tm}['u']"].std() > 0
    std = float(params[f"{tm}['tm_w2']"].std())
    assert abs(std - 5 ** -0.5) < 0.05 * 5 ** -0.5, std
    std = float(params[f"{tm}['td_w2']"].std())
    assert abs(std - 64 ** -0.5) < 0.05 * 64 ** -0.5, std


def test_full_width_state_is_the_published_size():
    """rwkv6-3b's decode state per slot: 2 x 32 x 2560 shift values and
    32 x 40 x 64 x 64 f32 WKV state (21 MB), whatever ``max_len`` is."""
    model = build_model(get_config("rwkv6-3b"))
    specs = model.cache_specs(4, 2048)
    assert specs == model.cache_specs(4, 16)
    assert tuple(specs["wkv"].shape) == (32, 4, 40, 64, 64)
    assert tuple(specs["tm_shift"].shape) == (32, 4, 2560)
    n = sum(int(np.prod(s.shape)) for _, s in tree_flatten(model.param_specs()))
    assert 3.0e9 < n < 3.2e9, n
