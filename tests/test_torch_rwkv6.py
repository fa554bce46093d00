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
  the chunk-parallel CUDA backward (the forward's state checkpoints every
  ``CHUNK`` steps; the chunk-level scan of the state gradient; each
  chunk's closed forms with its 3xTF32 products, tiles of relative decays
  and sums in the kernels' shuffle, warp and group order) emulated in
  plain torch against the same ``jax.vjp``: two whole chunks and a ragged
  third, one whole chunk, T shorter than a chunk, and decays that
  underflow to 0 in f32 (dw exactly 0 there); ``Wkv6Fn`` on CPU tensors
  against autograd through the plain version, counting no launch.
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
    m = torch.empty(1, 4, 2, 8, device="meta")    # a dry run's trace: the plain layout
    out, final = wkv6(m, m, m, m, torch.empty(2, 8, device="meta"))
    assert (out.device.type, tuple(out.shape), tuple(final.shape)) == ("meta", (1, 4, 2, 8),
                                                                       (1, 2, 8, 8))


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


def _tf32(x):
    """f32 -> the TF32 value of the kernels' ``tf32_bits`` (round to nearest,
    ties away from zero: add 0x1000 to the bit pattern, clear 13 bits)."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32).view(torch.float32)


def _mma3(acc, a, b, a_exact, b_exact):
    """``acc (.., M, N) + a (.., M, K) @ b (.., K, N)`` as the kernels' 3xTF32
    ``mma.sync`` m16n8k8 steps: each operand split into TF32 hi and lo, per
    8-deep k-step a_lo b_hi, a_hi b_lo, a_hi b_hi in that order, each an
    exact sum of 8 products added to the f32 accumulator with one rounding
    (a bf16 operand is exact in TF32: its lo is 0 and its terms are
    skipped)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a.float() - ah), _tf32(b.float() - bh)
    terms = ([] if a_exact else [(al, bh)]) + ([] if b_exact else [(ah, bl)]) + [(ah, bh)]
    for k0 in range(0, a.shape[-1], 8):
        for x, y in terms:
            acc = (acc.double() + x[..., k0:k0 + 8].double() @ y[..., k0:k0 + 8, :].double()
                   ).float()
    return acc


_TS = 8   # steps of a tile of the chunk kernel's FMA part


def _wkv6_bwd_emulation(r, k, v, w, u, state, dout, dstate=None):
    """The arithmetic of ``wkv6_kernel<CKPT>`` (the state entering every
    CHUNK-th step, ``s = fmaf(s, a, k v)`` a step),
    ``wkv6_bwd_contrib_kernel``, ``wkv6_bwd_scan_kernel``,
    ``wkv6_bwd_chunk_kernel`` and ``wkv6_bwd_du_kernel`` in plain torch,
    with the decays a = exp(-exp(w)) (1 past the end of T).

    * The scan, chunks last to first: G_end of each chunk written, then
      G = fmaf(tot, G, (r * pre)^T do) with pre the exclusive prefix product
      of the decays (a chain; the term formed for every chunk at once) and
      tot the chunk's whole product; ds0 is the last G.
    * Each chunk: K~ = suf * k (suf the exclusive suffix product), P =
      rowsum(S0 * G_end) as an fmaf chain over j, the bonus sums
      sum_i (r_i u_i) k_i in shuffle order; the 3xTF32 products do S0^T,
      v G_end^T, do v^T (A, whose diagonal is v . do) and K~ G_end; then per
      row the 8-step tiles of the triangle tau < sigma, each group of rows
      taking sigma-tiles a and NTILE - 1 - a, the tiles of a from the
      diagonal down to tau-tile 0, every decay a product of per-step decays
      over its span (never a quotient): dr and dk as fmaf over the tile in
      order, B (sum_i E r_sigma k_tau) summed over each warp's rows in
      shuffle order and over its warps in order, dlambda's pairs
      tau < t < sigma as within-tile prefix, suffix and between-tile sums;
      dv = fmaf(bonus, do, K~ G_end + B^T do), dk and dlambda closing the
      chunk in two passes over its steps; du over the chunk's steps, then
      over batches and chunks in order."""
    b, t, h, d = r.shape
    C, nt_ = CHUNK, CHUNK // _TS
    groups, rw = nt_ // 2, min(d, 32)
    nc = -(-t // C)
    exact = r.dtype == torch.bfloat16
    ew = torch.exp(w.float())
    a_real = torch.exp(-ew)

    def chunked(x, fill=0.0):     # (b, t, h, d) -> (b, h, nc, C, d), padded with fill
        x = x.float()
        if nc * C > t:
            x = torch.cat([x, x.new_full((b, nc * C - t, h, d), fill)], 1)
        return x.view(b, nc, C, h, d).permute(0, 3, 1, 2, 4)

    rf, kf, vf, dof = (chunked(x) for x in (r, k, v, dout))
    af = chunked(a_real, 1.0)
    uf = u.float()[None, :, None, :]
    s = torch.zeros(b, h, d, d) if state is None else state.float().clone()
    ck = []
    rt, kt, vt = r.float(), k.float(), v.float()
    for ti in range(t):
        if ti % C == 0:
            ck.append(s)
        s = _fma(s, a_real[:, ti, :, :, None], kt[:, ti, :, :, None] * vt[:, ti, :, None, :])
    s0 = torch.stack(ck, 2)                                   # (b, h, nc, d, d)

    g = torch.zeros(b, h, d, d) if dstate is None else dstate.float().clone()
    g_end = [None] * nc
    for c in reversed(range(nc)):
        g_end[c] = g
        p, rhat = torch.ones(b, h, d), []
        for tt in range(C):
            rhat.append(rf[:, :, c, tt] * p)
            p = p * af[:, :, c, tt]
        contrib = _mma3(torch.zeros(b, h, d, d), torch.stack(rhat, -1), dof[:, :, c], False,
                        exact)
        g = _fma(p[..., None], g, contrib)
    ds0 = g
    ge = torch.stack(g_end, 2)                                # (b, h, nc, d, d)

    def step(x, tt):                                          # (.., C, d) -> (.., d) at tt
        return x[..., tt, :]

    suf, kt_ = torch.ones(b, h, nc, d), torch.empty(b, h, nc, C, d)
    for tt in reversed(range(C)):
        kt_[..., tt, :] = suf * step(kf, tt)
        suf = suf * step(af, tt)
    tot = suf
    pp = torch.zeros(b, h, nc, d)
    for j in range(d):
        pp = _fma(s0[..., j], ge[..., j], pp)
    ru = rf * uf[..., None, :]
    lane = ru[..., :rw] * kf[..., :rw]
    for m in range(1, d // rw):
        lane = _fma(ru[..., m * rw:(m + 1) * rw], kf[..., m * rw:(m + 1) * rw], lane)
    bonus = _butterfly(lane)                                  # (b, h, nc, C)
    zero_cd = torch.zeros(b, h, nc, C, d)
    xdr = _mma3(zero_cd, dof, s0.transpose(-1, -2), exact, False)
    xdk = _mma3(zero_cd, vf, ge.transpose(-1, -2), exact, False)
    am = _mma3(torch.zeros(b, h, nc, C, C), dof, vf.transpose(-1, -2), exact, exact)
    vdo = torch.diagonal(am, dim1=-2, dim2=-1)                # (b, h, nc, C)
    acc_dv = _mma3(zero_cd, kt_, ge, False, False)

    dkp = torch.zeros(groups, b, h, nc, C, d)
    lamp = torch.zeros(groups, b, h, nc, C, d)
    bp = torch.zeros(d // rw, b, h, nc, C, C)
    dr, xr_r = torch.empty(b, h, nc, C, d), torch.empty(b, h, nc, C, d)

    def b_partials(bb, sig, tau):                             # bb: (b, h, nc, d) a pair
        parts = _butterfly(bb.reshape(b, h, nc, d // rw, rw))
        for wp in range(d // rw):
            bp[wp, ..., sig, tau] = parts[..., wp]

    for q in range(groups):
        for a in (q, nt_ - 1 - q):
            sg = [a * _TS + s_ for s_ in range(_TS)]
            pre_a = torch.ones(b, h, nc, d)
            for x in range(a * _TS):
                pre_a = pre_a * step(af, x)
            lp = [torch.ones(b, h, nc, d)]
            for s_ in range(1, _TS):
                lp.append(lp[-1] * step(af, sg[s_ - 1]))
            rs = [step(rf, x) for x in sg]
            dr_acc, lam_a = [None] * _TS, [torch.zeros(b, h, nc, d) for _ in range(_TS)]
            for bt in range(a, -1, -1):
                tg = [bt * _TS + q_ for q_ in range(_TS)]
                ks = [step(kf, x) for x in tg]
                if bt == a:                                   # the diagonal tile
                    e = {}
                    for s_ in range(_TS):
                        for q_ in range(s_ - 1, -1, -1):
                            e[s_, q_] = (torch.ones(b, h, nc, d) if q_ == s_ - 1
                                         else e[s_, q_ + 1] * step(af, tg[q_ + 1]))
                else:
                    ls = [None] * _TS
                    ls[_TS - 1] = torch.ones(b, h, nc, d)
                    for q_ in range(_TS - 2, -1, -1):
                        ls[q_] = ls[q_ + 1] * step(af, tg[q_ + 1])
                    tile_prod = ls[0] * step(af, tg[0])
                    lps = [x * span for x in lp]
                    e = {(s_, q_): lps[s_] * ls[q_] for s_ in range(_TS) for q_ in range(_TS)}
                drt = [torch.zeros(b, h, nc, d) for _ in range(_TS)]
                dkt = [torch.zeros(b, h, nc, d) for _ in range(_TS)]
                m = {}
                for s_ in range(_TS):
                    for q_ in range(_TS):
                        if (s_, q_) not in e:
                            bp[..., sg[s_], tg[q_]] = 0.0
                            continue
                        ek, er = e[s_, q_] * ks[q_], e[s_, q_] * rs[s_]
                        av = am[..., sg[s_], tg[q_], None]
                        drt[s_] = _fma(ek, av, drt[s_])
                        dkt[q_] = _fma(er, av, dkt[q_])
                        b_partials(er * ks[q_], sg[s_], tg[q_])
                        if bt == a:
                            m[s_, q_] = rs[s_] * (ek * av)
                for q_ in range(_TS):
                    dkp[q, ..., tg[q_], :] += dkt[q_]
                if bt == a:
                    for s_ in range(_TS):
                        run = torch.zeros(b, h, nc, d)
                        for q_ in range(s_ - 1):
                            run = run + m[s_, q_]
                            lam_a[q_ + 1] = lam_a[q_ + 1] + run
                    dr_acc = drt
                    span = torch.ones(b, h, nc, d)
                    continue
                run = torch.zeros(b, h, nc, d)
                for q_ in range(_TS):
                    if q_:
                        lamp[q, ..., tg[q_], :] += run
                    run = _fma(ks[q_], dkt[q_], run)
                run = torch.zeros(b, h, nc, d)
                for s_ in range(_TS - 1, -1, -1):
                    if s_ < _TS - 1:
                        lam_a[s_] = lam_a[s_] + run
                    run = _fma(rs[s_], drt[s_], run)
                for c_ in range(bt + 1, a):
                    lamp[q, ..., c_ * _TS:(c_ + 1) * _TS, :] += run[..., None, :]
                dr_acc = [x + y for x, y in zip(dr_acc, drt)]
                span = span * tile_prod
            for s_, x in enumerate(sg):
                xr = (pre_a * lp[s_]) * step(xdr, x)
                dr[..., x, :] = _fma(uf * step(kf, x), vdo[..., x, None], xr + dr_acc[s_])
                xr_r[..., x, :] = rs[s_] * xr
                lamp[q, ..., x, :] += lam_a[s_]

    bsum = bp[0]
    for wp in range(1, d // rw):
        bsum = bsum + bp[wp]
    bt_mat = torch.tril(bsum, -1).transpose(-1, -2)           # [tau][sigma], sigma > tau
    dv = _fma(bonus[..., None], dof, _mma3(acc_dv, bt_mat, dof, False, exact))
    dk, dw = torch.empty(b, h, nc, C, d), torch.empty(b, h, nc, C, d)
    suf, s1 = torch.ones(b, h, nc, d), torch.zeros(b, h, nc, d)
    l1, y = [None] * C, [None] * C
    for tt in reversed(range(C)):
        dki = dkp[0, ..., tt, :]
        for q in range(1, groups):
            dki = dki + dkp[q, ..., tt, :]
        xk = suf * step(xdk, tt)
        dk[..., tt, :] = _fma(uf * step(rf, tt), vdo[..., tt, None], xk + dki)
        y[tt] = step(kf, tt) * xk
        l1[tt] = s1
        s1 = s1 + step(xr_r, tt)
        suf = suf * step(af, tt)
    s2 = torch.zeros(b, h, nc, d)
    ewc = chunked(ew)
    for tt in range(C):
        lam = (tot * pp + l1[tt]) + s2
        for q in range(groups):
            lam = lam + lamp[q, ..., tt, :]
        s2 = s2 + y[tt]
        dw[..., tt, :] = -(step(ewc, tt) * lam)
    du_part = torch.zeros(b, h, nc, d)
    for tt in range(C):
        live = (torch.arange(nc) * C + tt < t)[None, None, :, None]
        du_part = torch.where(live, _fma(step(rf, tt) * step(kf, tt), vdo[..., tt, None],
                                         du_part), du_part)
    du = torch.zeros(h, d)
    for bb_ in range(b):
        for c in range(nc):
            du = du + du_part[bb_, :, c]

    def unchunk(x):
        return x.permute(0, 2, 3, 1, 4).reshape(b, nc * C, h, d)[:, :t]

    return (unchunk(dr).to(r.dtype), unchunk(dk).to(r.dtype), unchunk(dv).to(r.dtype),
            unchunk(dw), du, None if state is None else ds0)


@pytest.mark.parametrize("shape", [(2, 2 * CHUNK + 5, 3, 8), (1, 2 * CHUNK + 5, 2, 64),
                                   (2, CHUNK, 2, 64), (3, 5, 2, 8), (1, CHUNK, 3, 8),
                                   (2, CHUNK - 12, 2, 64)],
                         ids=["head-8-ragged", "head-64-ragged", "one-chunk", "short",
                              "one-chunk-head-8", "short-head-64"])
@pytest.mark.parametrize("with_state,with_dstate", [(False, False), (True, True)],
                         ids=["zeros", "state-and-final-grad"])
def test_wkv6_bwd_kernel_arithmetic_matches_jax_grad(rng, shape, with_state, with_dstate):
    """T = 2 CHUNK + 5 is two whole chunks and a ragged third, T = CHUNK
    one whole chunk, T < CHUNK one ragged chunk; the kernels' arithmetic
    and summation order stay inside the plain version's band."""
    args = _bwd_inputs(rng, *shape, with_state, with_dstate)
    _assert_grads(_wkv6_bwd_emulation(*map(_t, args)), _jax_grads(*args))


@pytest.mark.parametrize("d", [8, 64])
def test_wkv6_bwd_kernel_arithmetic_with_decays_that_underflow(rng, d):
    """w around 7 (exp(w) over 104): exp(-exp(w)) is 0 in f32, so no state
    could be recovered by dividing by the decay; the recomputation from
    the checkpoints needs none, and dw is 0 where the decay is, as in
    ``jax.vjp``."""
    args = _bwd_inputs(rng, 2, 2 * CHUNK + 5, 2, d, True, True, w_shift=7.0)
    assert not np.exp(-np.exp(args[3])).any()
    got = _wkv6_bwd_emulation(*map(_t, args))
    assert np.isfinite(got[3].numpy()).all()
    _assert_grads(got, _jax_grads(*args))


def test_wkv6_bwd_kernel_arithmetic_fits_the_bf16_tolerance(rng):
    """bf16 r/k/v and output gradient at the full-width head size: the
    emulated kernel within 2e-2 x max |grad| of ``jax.vjp`` on the same bf16
    inputs (the band ``chip_smoke.py`` holds the card to)."""
    r, k, v, w, u, s, do, _ = _bwd_inputs(rng, 1, 2 * CHUNK + 5, 2, 64, True, False)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (r, k, v)]
    _, vjp = jax.vjp(jref.wkv6, *jb, jnp.asarray(w), jnp.asarray(u), jnp.asarray(s))
    want = [np.asarray(g, np.float32) for g in vjp((jnp.asarray(do, jnp.bfloat16),
                                                     jnp.zeros((1, 2, 64, 64), jnp.float32)))]
    tb = [torch.from_numpy(x).to(torch.bfloat16) for x in (r, k, v)]
    got = _wkv6_bwd_emulation(*tb, _t(w), _t(u), _t(s), torch.from_numpy(do).to(torch.bfloat16))
    assert [g.dtype for g in got[:3]] == [torch.bfloat16] * 3
    _assert_grads(got, want, rtol=0, atol=2e-2)


def test_wkv6_chunk_is_the_kernels():
    """The emulation's chunk and tile are the kernels'."""
    src = (_build.CSRC / "rwkv_kernels.cu").read_text()
    assert int(re.search(r"constexpr int kWkvChunk = (\d+);", src).group(1)) == CHUNK
    assert int(re.search(r"constexpr int kBwdTile = (\d+);", src).group(1)) == _TS


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
    m = torch.empty(1, 4, 2, 8, device="meta")    # a dry run's trace: the plain layout
    grads = wkv6_bwd(m, m, m, m, torch.empty(2, 8, device="meta"), None, m)
    assert [None if g is None else tuple(g.shape) for g in grads] == \
        [(1, 4, 2, 8)] * 4 + [(2, 8), None]


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
