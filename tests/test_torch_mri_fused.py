"""The arithmetic of the CUDA ``dft_recon_kernel`` (3xTF32 tensor-core
products), emulated in plain torch, against the JAX package's whole-chain
``fused_recon`` kernel (interpret mode off the TPU), and its fragment and
shared-memory index arithmetic walked lane by lane, with the tiling
constants read from the ``.cu``.

The emulation follows the kernel step by step: every operand split into a
TF32 pair (hi = tf32(x), lo = tf32(x - hi), round to nearest with ties away
from zero, as ``cvt.rna.tf32.f32``); per 8-deep k-step the twelve products
of a complex 3xTF32 step in the kernel's order, each one m16n8k8 ``mma``
(the 8 exact products summed and added with one rounding) into a zeroed
f32 partial, which is then added to the running f32 sum; T rounded to f32
and split again; the epilogue's ``fmaf``s and the coil sum in coil order.
The tensor core's own summation inside a k-step is not specified bit for
bit, so the emulation is held to the DFT tolerance (rtol/atol 1e-4, as
``test_torch_kernels.py``), not bitwise.  A single TF32 pass (hi*hi only)
misses that tolerance: the control shows why the kernel issues three.  The
kernel itself is held against the plain version on the card by
``chip_smoke.py``.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mri_fused import _dft_fits as j_dft_fits, fused_recon as j_recon
from repro_torch.kernels import _build
from repro_torch.kernels.mri_fused import (MAX_DFT_DIM, RECON_ROWS, SMEM_OPTIN_BYTES, dft_fits,
                                           idft_fragment_table, idft_matrix, recon_smem_bytes)

DFT = dict(rtol=1e-4, atol=1e-4)
RAGGED = (2, 3, 37, 45)      # inside both gates; H, W no multiple of 8 or 16


def _source() -> str:
    return (_build.CSRC / "mri_kernels.cu").read_text()


def _constants():
    """(rows a block, warps a block, column tiles a warp, mma m, n, k) from
    the kernel's source."""
    src = _source()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (kRecon\w+) = (\d+);", src)}
    m, n, k = map(int, re.search(r"mma\.sync\.aligned\.m(\d+)n(\d+)k(\d+)\.row\.col\.f32\.tf32",
                                 src).groups())
    return const["kReconRows"], const["kReconWarps"], const["kReconTiles"], m, n, k


def _stride(n: int) -> int:
    """``recon_stride`` evaluated from its source text."""
    body = re.search(r"int recon_stride\(int n\) \{ return (.+?); \}", _source()).group(1)
    return eval(body.replace("/", "//"), {}, {"n": n})


# ---------------------------------------------------------------------------
# plain-torch emulation of the kernel's arithmetic
# ---------------------------------------------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _planes(z: torch.Tensor):
    """complex64 -> (hi re, hi im, lo re, lo im), the kernel's split."""
    hr, lr = _split(z.real)
    hi, li = _split(z.imag)
    return hr, hi, lr, li


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _cmma(yr, yi, a, b, eq, k0, k1, passes):
    """One k-step [k0, k1) of the complex product, as ``cmma_3xtf32`` issues
    it (passes=3) or hi*hi alone (passes=1): each term one m16n8k8 step
    (the exact products summed, then added to a zeroed f32 partial with one
    rounding), then the partial added to the running f32 sum."""
    ahr, ahi, alr, ali = (p[..., k0:k1] for p in a)
    bhr, bhi, blr, bli = (p[..., k0:k1, :] for p in b)

    def step(d, x, y):
        return (d.double() + torch.einsum(eq, x.double(), y.double())).float()

    if passes == 3:
        terms_r = [(ahr, blr), (alr, bhr), (ahr, bhr), (-ahi, bli), (-ali, bhi), (-ahi, bhi)]
        terms_i = [(ahr, bli), (alr, bhi), (ahr, bhi), (ahi, blr), (ali, bhr), (ahi, bhr)]
    else:
        terms_r = [(ahr, bhr), (-ahi, bhi)]
        terms_i = [(ahr, bhi), (ahi, bhr)]
    pr = torch.zeros_like(yr)
    pi = torch.zeros_like(yi)
    for x, y in terms_r:
        pr = step(pr, x, y)
    for x, y in terms_i:
        pi = step(pi, x, y)
    return yr + pr, yi + pi


def emulate_dft_recon(k, s, combine, norm, passes=3, fpm=None):
    """(F, C, H, W) complex64 k-space -> (F, H, W), the kernel's arithmetic.
    ``s`` is one map set (C, H, W), or map sets (S, C, H, W) of which frame
    f reads set f // ``fpm``, as the kernel's ``s + (f / fpm * coils + c)
    * hw``."""
    f, c, h, w = k.shape
    if s.ndim == 3:
        s, fpm = s[None], f
    s = s[torch.arange(f) // fpm]                 # (F, C, H, W): each frame's set
    _, _, _, _, _, kstep = _constants()

    mh = _planes(torch.from_numpy(idft_matrix(h, norm)))
    mw = _planes(torch.from_numpy(idft_matrix(w, norm)))
    kp = _planes(k)
    # stage 1: T[f, c, a, w] = sum_h M_H[a, h] K[f, c, h, w]
    tr = torch.zeros((f, c, h, w), dtype=torch.float32)
    ti = torch.zeros_like(tr)
    for k0 in range(0, h, kstep):
        tr, ti = _cmma(tr, ti, mh, kp, "ak,fckw->fcaw", k0, min(k0 + kstep, h), passes)
    tp = _planes(torch.complex(tr, ti))
    # stage 2: Y[f, c, a, b] = sum_w T[f, c, a, w] M_W[w, b]
    yr = torch.zeros_like(tr)
    yi = torch.zeros_like(tr)
    for k0 in range(0, w, kstep):
        yr, yi = _cmma(yr, yi, tp, mw, "fcak,kb->fcab", k0, min(k0 + kstep, w), passes)
    # epilogue: p = Y conj(S) with the kernel's fmaf, summed in coil order
    acc_re = torch.zeros((f, h, w), dtype=torch.float32)
    acc_im = torch.zeros_like(acc_re)
    for ci in range(c):
        sr, si = s[:, ci].real, s[:, ci].imag
        y_r, y_i = yr[:, ci], yi[:, ci]
        px = _fma(y_r, sr, y_i * si)
        py = _fma(y_i, sr, -y_r * si)
        if combine == "rss":
            acc_re = acc_re + _fma(px, px, py * py)
        else:
            acc_re = acc_re + px
            acc_im = acc_im + py
    if combine == "rss":
        return torch.sqrt(acc_re)
    return torch.complex(acc_re, acc_im)


def _inputs(rng, shape):
    f, c, h, w = shape

    def cplx(*sh):
        return (rng.standard_normal(sh) + 1j * rng.standard_normal(sh)).astype(np.complex64)

    return cplx(f, c, h, w), cplx(c, h, w)


def _scaled_pair(rng, combine, norm, passes):
    k, s = _inputs(rng, RAGGED)
    _, _, h, w = RAGGED
    want = np.asarray(j_recon(jnp.asarray(k), jnp.asarray(s), combine=combine, norm=norm))
    got = emulate_dft_recon(torch.from_numpy(k), torch.from_numpy(s), combine, norm,
                            passes).numpy()
    scale = 1.0 if norm != "forward" else 1.0 / np.sqrt(h * w)  # forward: no 1/n
    return got * scale, want * scale


@pytest.mark.parametrize("norm", ["ortho", "backward", "forward"])
@pytest.mark.parametrize("combine", ["sum", "rss"])
def test_3xtf32_emulation_matches_jax_fused_recon(rng, combine, norm):
    f, c, h, w = RAGGED
    assert j_dft_fits(c, h, w) and dft_fits(f, c, h, w)
    got, want = _scaled_pair(rng, combine, norm, passes=3)
    np.testing.assert_allclose(got, want, **DFT)


@pytest.mark.parametrize("combine", ["sum", "rss"])
def test_single_tf32_pass_misses_the_dft_tolerance(rng, combine):
    """The negative control: with hi*hi alone (one TF32 pass, 11 significant
    bits an operand) the same inputs fall outside rtol/atol 1e-4."""
    got, want = _scaled_pair(rng, combine, "ortho", passes=1)
    excess = np.abs(got - want) / (DFT["atol"] + DFT["rtol"] * np.abs(want))
    assert excess.max() > 2.0, excess.max()
    got3, _ = _scaled_pair(np.random.default_rng(0), combine, "ortho", passes=3)
    excess3 = np.abs(got3 - want) / (DFT["atol"] + DFT["rtol"] * np.abs(want))
    assert excess3.max() < 0.5 * excess.max()


def test_map_set_emulation_matches_jax_vmap(rng):
    """A stream's batch (B, F, C, H, W) with one map set a slice: the
    emulation, frames folded (B * F) and frame f reading map set f // F as
    the kernel does, against a vmap of the JAX ``fused_recon`` over the
    batch (one pallas_call grid axis more), at the DFT tolerance; and the
    index expression is the kernel's own."""
    assert re.search(r"const float2\* sc = s \+ \(static_cast<long long>\(f / fpm\) \* coils "
                     r"\+ c\) \* hw;", _source())
    b = 2
    f, c, h, w = RAGGED
    k = np.stack([_inputs(rng, RAGGED)[0] for _ in range(b)])
    s = np.stack([_inputs(rng, RAGGED)[1] for _ in range(b)])
    for combine in ("sum", "rss"):
        want = np.asarray(jax.vmap(lambda kk, ss: j_recon(kk, ss, combine=combine))(
            jnp.asarray(k), jnp.asarray(s)))
        got = emulate_dft_recon(torch.from_numpy(k.reshape(b * f, c, h, w)),
                                torch.from_numpy(s), combine, "ortho", fpm=f).numpy()
        np.testing.assert_allclose(got.reshape(want.shape), want, **DFT)


# ---------------------------------------------------------------------------
# the TF32 split
# ---------------------------------------------------------------------------

def test_tf32_split_is_nearest_ties_away_and_exact_to_22_bits(rng):
    """hi = tf32(x): the bits plus half a TF32 unit, cut to 10 mantissa bits
    (nearest, ties away from zero), in the kernel and the emulation alike;
    lo = tf32(x - hi); hi + lo holds x to 2^-22."""
    src = _source()
    assert "return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;" in src
    assert "lo = tf32_bits(x - __uint_as_float(hi));" in src
    one_ulp = 2.0 ** -10                   # TF32's last mantissa bit at 1.0
    x = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2), 1 + one_ulp / 4, 1 + 3 * one_ulp / 4,
                      0.0, -0.0, 3.0])
    assert _tf32(x).tolist() == [1 + one_ulp, -(1 + one_ulp), 1, 1 + one_ulp, 0, -0.0, 3]
    v = torch.from_numpy(rng.standard_normal(10_000).astype(np.float32))
    hi, lo = _split(v)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert bool(((hi - v).abs() <= v.abs() * 2.0 ** -11).all())
    assert bool(((hi.double() + lo.double() - v.double()).abs()
                 <= v.double().abs() * 2.0 ** -22).all())


# ---------------------------------------------------------------------------
# the kernel's index arithmetic, lane by lane
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", [1, 7, 45, 64, 65, 131, 160, 256])
def test_output_fragments_cover_the_row_tile_once(w):
    """Warp q, lane (g, t), tile j < kTiles = ceil(W / 64), element e owns
    row g + 8 (e >> 1) and column (q + 8 j) 8 + 2t + (e & 1) of the block's
    16 rows.  Only a warp's last tile may lie past W padded to 8 (the kernel
    branches on that one alone); together they cover every column once."""
    rows, warps, tiles, m, n, _ = _constants()
    assert rows == m == RECON_ROWS == 16 and n == 8
    wk = -(-w // 8) * 8
    k_tiles = -(-w // (warps * 8))
    assert 1 <= k_tiles <= tiles
    seen = np.zeros((rows, wk), np.int64)
    for q in range(warps):
        last_tile = (q + (k_tiles - 1) * warps) * 8 < wk
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for j in range(k_tiles):
                tile = q + j * warps
                if j < k_tiles - 1:
                    assert tile * 8 < wk            # never empty
                elif not last_tile:
                    continue
                for e in range(4):
                    seen[g + (e >> 1) * 8, tile * 8 + 2 * t + (e & 1)] += 1
    np.testing.assert_array_equal(seen, 1)


def test_operand_fragments_and_shared_memory_banks():
    """A (16 x 8: a0..a3 at rows g, g + 8 and columns t, t + 4) and B (8 x 8:
    b0, b1 at rows t, t + 4, column g) cover their tiles once a k-step.  In
    an A-operand tile, (row r, column k, plane p) sits at (r % 8) stride +
    (k / 8) 64 + 16 p + 4 (k % 4) + 2 ((k / 4) % 2) + r / 8, so lane (g, t)
    finds (a0, a1, a2, a3) of plane p as the 4 floats from g * stride +
    (k0 / 8) 64 + 16 p + 4 t (one 16-byte load, the mma's register order);
    each element has one place, and the 8 lanes of a quarter warp hit 32
    distinct banks for every depth the gate admits."""
    a = np.zeros((16, 8), np.int64)
    b = np.zeros((8, 8), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for r, c in ((g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)):
            a[r, c] += 1
        b[t, g] += 1
        b[t + 4, g] += 1
    np.testing.assert_array_equal(a, 1)
    np.testing.assert_array_equal(b, 1)
    src = _source()
    assert ("return (r & 7) * rs + (k >> 3) * 64 + p * 16 + (k & 3) * 4 + ((k >> 2) & 1) * 2 "
            "+ (r >> 3);" in src)

    def offset(s, r, k, p):
        return (r & 7) * s + (k >> 3) * 64 + p * 16 + (k & 3) * 4 + ((k >> 2) & 1) * 2 + (r >> 3)

    for n in (1, 8, 37, 131, 160, 256):
        s = _stride(n)
        kn = -(-n // 8) * 8
        places = {offset(s, r, k, p) for r in range(16) for k in range(kn) for p in range(4)}
        assert len(places) == 16 * kn * 4 and max(places) < 8 * s
        for k0 in range(0, kn, 8):
            for g in range(8):
                for t in range(4):
                    for p in range(4):
                        base = g * s + (k0 >> 3) * 64 + 16 * p + 4 * t
                        frag = [offset(s, r, c, p) for r, c in
                                ((g, k0 + t), (g + 8, k0 + t), (g, k0 + t + 4),
                                 (g + 8, k0 + t + 4))]
                        assert frag == list(range(base, base + 4))
    for n in range(1, MAX_DFT_DIM + 1):
        s = _stride(n)
        for quarter in range(4):
            banks = set()
            for lane in range(8 * quarter, 8 * quarter + 8):
                g, t = lane >> 2, lane & 3
                banks |= {(g * s + 4 * t + i) % 32 for i in range(4)}
            assert len(banks) == 32, (n, s)


@pytest.mark.parametrize("n", [1, 45, 160])
def test_fragment_order_table(n):
    """M_W as the B operand loads it: at [k-group, t, column] the 4 floats
    (re of row 8 k-group + t, re of row + t + 4, im of the two); zero past
    row n."""
    m = idft_matrix(n, "ortho")
    table = idft_fragment_table(n, "ortho")
    groups = -(-n // 8)
    assert table.shape == (groups, 4, n, 4) and table.dtype == np.float32
    for kg in range(groups):
        for t in range(4):
            for col in range(0, n, max(1, n // 7)):
                for part, plane in enumerate((m.real, m.imag)):
                    for half in range(2):
                        row = kg * 8 + t + 4 * half
                        want = plane[row, col] if row < n else 0.0
                        assert table[kg, t, col, 2 * part + half] == want


def test_gate_from_the_kernel_constants():
    """``recon_smem_bytes`` and ``MAX_DFT_DIM`` as the .cu has them: the M_H
    and T tiles and the coil sums, no coil term; the 8 warps' tiles span
    256 columns; every admitted H, W fits the opt-in shared memory, and
    160 x 160 leaves room for two blocks an SM."""
    rows, warps, tiles, _, _, _ = _constants()
    src = _source()
    assert ("(8LL * (recon_stride(h) + recon_stride(w)) + 1LL * kReconRows * acc_stride(w)) *"
            in src)
    acc = re.search(r"int acc_stride\(int w\) \{ return (.+?); \}", src).group(1)
    assert MAX_DFT_DIM == tiles * warps * 8
    for h, w in ((1, 1), (37, 45), (160, 160), (256, 256), (256, 1)):
        acc_w = eval(acc.replace("/", "//"), {}, {"w": w})
        assert recon_smem_bytes(h, w) == (rows // 2 * (_stride(h) + _stride(w))
                                          + rows * acc_w) * 4
    assert recon_smem_bytes(256, 256) <= SMEM_OPTIN_BYTES
    assert 2 * (recon_smem_bytes(160, 160) + 1024) <= 228 * 1024
    assert dft_fits(1, 4096, 256, 256)
