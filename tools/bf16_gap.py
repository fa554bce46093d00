#!/usr/bin/env python3
"""How far an architecture's bf16 logits fall from its f32 ones, in the JAX
package and in the port, at a reduced width on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/bf16_gap.py [--arch A] [--width D]

Builds ``--arch`` (zamba2-2.7b by default) at width ``--width`` (640; heads
of 80, feed-forward 4 D) and the depth of ``chip_smoke.py``'s card-against-
CPU check (one superblock of a hybrid, else 2 layers), random weights from
seed 0 (each package its own init; the bf16 run takes the f32 weights
rounded), and runs a 64-token prompt and 4 decode steps teacher-forced
from the f32 run.  Prints max |bf16 - f32| / max |f32 logit| of the
prefill and of each step, per package: the gap that the reference's own
arithmetic has in bf16, which ``chip_smoke.py``'s bf16 band must admit.
Like the parity tests, it imports both packages, so it lives beside the
repo's other tools and not among the port's measurement scripts
(``scripts/``, which import no JAX); the port itself imports no JAX.
"""
from __future__ import annotations

import argparse

import numpy as np


def _cfg(get_config, arch: str, width: int):
    cfg = get_config(arch)
    depth = cfg.attn_every if cfg.family == "hybrid" else 2
    heads = max(1, width // 80)
    return cfg.scaled(n_layers=depth, d_model=width, n_heads=heads, n_kv_heads=heads,
                      d_head=80, d_ff=4 * width)


def jax_gaps(arch: str, width: int, tokens: np.ndarray):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import build_model

    cfg = _cfg(get_config, arch, width).scaled(remat=False)
    m16, m32 = build_model(cfg), build_model(cfg.scaled(param_dtype="float32", dtype="float32"))
    p32 = m32.init_params(jax.random.key(0))
    shapes = jax.eval_shape(lambda: m16.init_params(jax.random.key(0)))
    p16 = jax.tree_util.tree_map(lambda a, s: a.astype(s.dtype), p32, shapes)
    runs = {k: (m, p, m.init_cache(1, 128), jax.jit(m.decode_step))
            for k, (m, p) in {"f32": (m32, p32), "bf16": (m16, p16)}.items()}
    logits = {k: jax.jit(m.prefill)(p, jnp.asarray(tokens), c) for k, (m, p, c, _) in runs.items()}
    gaps = []
    for i in range(5):
        want = np.asarray(logits["f32"][0], np.float32)
        gaps.append(float(np.abs(np.asarray(logits["bf16"][0], np.float32) - want).max()
                          / np.abs(want).max()))
        if i == 4:
            break
        tok = jnp.argmax(logits["f32"][0], -1).astype(jnp.int32)
        logits = {k: step(p, tok, jnp.int32(tokens.shape[1] + i), logits[k][1])
                  for k, (m, p, c, step) in runs.items()}
    return gaps


def port_gaps(arch: str, width: int, tokens: np.ndarray):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_flatten
    from repro_torch.processes.lm import TreeCodec

    cfg = _cfg(get_config, arch, width)
    m16, m32 = build_model(cfg), build_model(cfg.scaled(param_dtype="float32", dtype="float32"))
    p32 = m32.init_params(torch.Generator().manual_seed(0))
    specs = dict(tree_flatten(m16.param_specs()))
    p16 = TreeCodec(m16.param_specs()).unflatten(
        {n: t.to(torch.bfloat16) if str(specs[n].dtype) == "bfloat16" else t
         for n, t in tree_flatten(p32)})
    toks = torch.from_numpy(tokens)
    runs = {"f32": (m32, p32), "bf16": (m16, p16)}
    caches = {k: m.init_cache(1, 128) for k, (m, _) in runs.items()}
    logits = {k: m.prefill(p, toks, caches[k])[0] for k, (m, p) in runs.items()}
    gaps = []
    for i in range(5):
        want = logits["f32"]
        gaps.append(float((logits["bf16"] - want).abs().max() / want.abs().max()))
        if i == 4:
            break
        tok = want.argmax(-1).to(torch.int32)
        logits = {k: m.decode_step(p, tok, tokens.shape[1] + i, caches[k])[0]
                  for k, (m, p) in runs.items()}
    return gaps


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--width", type=int, default=640)
    args = ap.parse_args(argv)
    from repro_torch.configs import get_config

    vocab = get_config(args.arch).vocab
    tokens = np.random.default_rng(0).integers(0, vocab, (1, 64)).astype(np.int32)
    for name, fn in (("JAX package", jax_gaps), ("port", port_gaps)):
        gaps = fn(args.arch, args.width, tokens)
        print(f"{name}: {args.arch} width {args.width}, max |bf16 - f32| / max |f32 logit|, "
              "prefill then 4 decode steps (CPU): "
              + ", ".join(f"{100 * g:.2f} %" for g in gaps))


if __name__ == "__main__":
    main()
