"""Training steps of a decoder through the program's ``TrainProcess``: one
CUDA graph a step (forward, remat recompute, backward, clip, AdamW), a new
batch uploaded from the host into the captured input each step.

Set-up builds the one step object from the seed's weights, captures it,
and drives it through its first ``checked_steps`` steps by the window's
own call and feed.  From those it keeps each step's loss, each leaf's norm
of the first step's gradient as AdamW received it (``m / (1 - b1)`` after
one step) and each leaf's norm of its change over the checked steps (the
f32 master weights).  The window goes on with the same object.  Once it
has closed and the program's state is freed, the plain reference takes
the same steps in f32 from the same weights and batches.  With a control,
the reference's steps in a lower precision (or with half of each batch)
take the program's place in the check.

Mix parameters: ``batch``, ``seq``, ``checked_steps``, ``optimizer``.
"""
from __future__ import annotations

import time
from typing import Dict

import torch

from perfbench import mixes, weights
from perfbench.drivers.common import check, free, peak_bytes, sync
from perfbench.drivers.lm_common import program_model
from perfbench.reference import decoder_lm


def leaf_norms(tree) -> Dict[str, float]:
    from repro_torch.core.arena import tree_flatten
    return {n: float(torch.linalg.vector_norm(t.float())) for n, t in tree_flatten(tree)}


def run(run) -> dict:
    from repro_torch.core.arena import tree_flatten
    from repro_torch.optim import AdamWConfig, Schedule, adamw_init
    from repro_torch.train import TrainConfig
    from repro_torch.train.step import TrainProcess

    cfg, mix, dev = run.config, run.mix, run.device
    b, s, vocab = int(mix["batch"]), int(mix["seq"]), int(cfg["vocab"])
    opt = mix["optimizer"]
    checked = int(mix["checked_steps"])
    model = program_model(cfg)
    flat, views = weights.make_flat(cfg, run.seed, dev)
    params = weights.nest(views)
    state = {"params": params, "opt": adamw_init(params)}
    tcfg = TrainConfig(opt=AdamWConfig(
        b1=opt["b1"], b2=opt["b2"], eps=opt["eps"], weight_decay=opt["weight_decay"],
        clip_norm=opt["clip_norm"],
        schedule=Schedule(kind="constant", base_lr=opt["lr"], warmup_steps=0)))
    proc = TrainProcess(model, tcfg)

    def batch(i):
        return {k: torch.from_numpy(v) for k, v in mixes.train_batch(run.seed, i, b, s, vocab)
                .items()}
    proc.init(state, batch(0))
    losses, grad_norms = [], {}
    for i in range(checked):
        state, met = proc.launch(state, batch(i))
        losses.append(float(met["loss"]))
        if i == 0:
            grad_norms = {n: g / (1.0 - opt["b1"]) for n, g in leaf_norms(state["opt"]["m"])
                          .items()}
    _, init = weights.make_flat(cfg, run.seed, dev)
    change = {n: float(torch.linalg.vector_norm(m - init[n].float()))
              for n, m in tree_flatten(state["opt"]["master"])}
    del init, _
    free(dev)
    step = checked
    sync(dev)

    t0 = run.open_window()
    steps = 0
    while True:
        with run.mark("step"), run.span("step"):
            proc.launch(state, batch(step))
            sync(dev)
        step += 1
        steps += 1
        now = time.perf_counter()
        if run.tracing() and now - t0 >= run.trace_seconds():
            run.stop_trace()
            run.counters["traced_steps"] = steps
        if now - t0 >= run.seconds:
            break
    elapsed = run.close_window()

    peak = peak_bytes(dev)
    del proc, state, params, views, flat, model
    free(dev)
    t_ref = time.perf_counter()
    _, init = weights.make_flat(cfg, run.seed, dev)
    batches = [{k: v.to(dev) for k, v in batch(i).items()} for i in range(checked)]
    ref = decoder_lm.train(cfg, init, batches, opt)
    found = gaps(losses, grad_norms, change, ref)
    out = {"metrics": {"train_tokens_per_s": steps * b * s / elapsed, "setup_s": run.setup_s},
           "attempted": steps, "failed": 0, "memory_peak_bytes": peak}
    out["notes"] = [f"reference {time.perf_counter() - t_ref:.3f} s"]
    out["notes"] += [f"worst leaf of {k}: {v}" for k, v in worst(grad_norms, change, ref).items()]
    if run.control:
        out["program"] = found
        free(dev)
        if run.control == "half_batch":      # the fault: half the rows, the mean over the rest
            low = decoder_lm.train(cfg, init, [{k: v[:b // 2] for k, v in x.items()}
                                               for x in batches], opt)
        else:
            low = decoder_lm.train(cfg, init, batches, opt, rounding=run.control)
        found = gaps(low["losses"], low["grad_norms"], low["change_norms"], ref)
    lim = run.limits
    out["checks"] = [check(k, v, lim[k]) for k, v in found.items() if k in lim]
    out["notes"] += [f"{k} {v!r} (not compared)" for k, v in found.items() if k not in lim]
    return out


def worst(grad_norms, change, ref) -> Dict[str, str]:
    """Which leaf sets each leaf gap, with both norms."""
    out = {}
    for key, prog, want in (("grad_norm_gap", grad_norms, ref["grad_norms"]),
                            ("change_norm_gap", change, ref["change_norms"])):
        still = decoder_lm.still_leaves(ref["grad_norms"]) if key == "change_norm_gap" else set()
        names = [n for n in want if n not in still]
        med = sorted(want[n] for n in names)[len(names) // 2]
        n = max(names, key=lambda n: abs(prog[n] - want[n]) / max(want[n], med))
        out[key] = f"{n} program {prog[n]!r} reference {want[n]!r} median {med!r}"
    return out


def gaps(losses, grad_norms, change, ref) -> Dict[str, float]:
    """The numbers read: the worst step's loss gap, and the worst leaf's gap
    of the first gradient's norm and of the change's norm (the change
    leaving out the leaves whose reference gradient is nought to
    rounding).  Those with a limit in the cell's limits file are
    compared."""
    still = decoder_lm.still_leaves(ref["grad_norms"])
    return {"loss_rel_gap": max(decoder_lm.rel_gap(a, r) for a, r in zip(losses, ref["losses"])),
            "grad_norm_gap": decoder_lm.leaf_gap(grad_norms, ref["grad_norms"]),
            "change_norm_gap": decoder_lm.leaf_gap(change, ref["change_norms"], still)}
