r"""Multi-pod dry run of the port: where each cell fits, and its roofline on
the H100, with no card (the counterpart of ``repro/launch/dryrun.py``).

For every (architecture x input-shape) cell, trace the program the port
runs for one card of the production mesh (16 x 16, or 2 x 16 x 16) on
``meta`` tensors (:class:`~repro_torch.launch.roofline.CostMode`: flops,
bytes, the peak of live bytes, and the collectives the cross-lane
operators record), and print a memory record (it fits) and the roofline
terms at the H100's data-sheet rates.  The JAX package compiles the
GSPMD program on a faked 256/512-device host instead; this describes the
port's own program:

* **train**: the data lanes run alike, so one data lane's model group of M
  lanes is traced: one microbatch's forward and backward (its rows of the
  data lane's rows), scaled by the microbatches; the accumulation of each
  data lane's gradient into the first group's f32 sums (the port's
  reduction; M lanes alike), scaled by microbatches x data lanes; then,
  once, the update of the first card's pieces (its ZeRO-1 master piece
  where the state is split over data) and the data axis's traffic.  A card
  is the busiest lane: the lanes' work / M plus the first lane's own (the
  cross-lane operators' sums).  A group of more than one lane runs without
  remat across distinct cards (``ModelGroup.one_device``), so that is the
  program traced.  Arguments are placed by the fitted specs (a dim the
  axes do not divide is replicated, as ``_compile_cell`` fits them); a
  parameter whose ``model`` split the fit drops cannot be placed (the
  port's lanes need their pieces), and the cell is an error naming it.
* **prefill / decode**: each lane holds the whole weights; a data lane's
  rows prefill on one lane, and decode slots run in strips over
  ``model`` (replicated where the strips do not divide), one lane's strip
  traced.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] [--out results.jsonl]
    python -m repro_torch.launch.dryrun --all --mesh 1,1     # what fits one card
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, SHAPES, cells, get_config
from repro_torch.core.arena import torch_dtype, tree_flatten, tree_unflatten
from repro_torch.launch.mesh import Mesh, model_axis_size, resolve_spec
from repro_torch.launch.roofline import (CostMode, Roofline, collective_bytes,
                                         collective_seconds, model_flops, wire_bytes)
from repro_torch.launch.specs import (build_lowerable, fit_pspecs, piece_shape, placed_bytes,
                                      resolve_shape)
from repro_torch.models import build_model
from repro_torch.models.common import MODEL, ArchConfig, partition_tree, tree_map
from repro_torch.models.parallel import ModelGroup
from repro_torch.optim.adamw import adamw_scalars, update_leaf
from repro_torch.train.step import (compress_grads, loss_and_grads, record_data_traffic,
                                    splits_over_data)

#: the reference's GSPMD / TPU levers (besides every ``opt_*``), which the
#: port has no counterpart of
REFUSED_LEVERS = ("unroll_layers", "use_pallas")

META = torch.device("meta")


def meta_mesh(shape, axis_names=("data", "model")) -> Mesh:
    """A mesh of ``meta`` devices: what only the dry run places on (the
    port's other entry points refuse a platform that is neither the CPU
    nor CUDA, ``check_present``)."""
    n = int(np.prod(shape))
    return Mesh(np.array([META] * n, dtype=object).reshape(shape), axis_names)


def meta_production_mesh(multi_pod: bool = False) -> Mesh:
    """The production mesh, ``(data 16, model 16)`` or ``(pod 2, data 16,
    model 16)``, of ``meta`` devices."""
    if multi_pod:
        return meta_mesh((2, 16, 16), ("pod", "data", "model"))
    return meta_mesh((16, 16))


# ---------------------------------------------------------------------------
# Costs
# ---------------------------------------------------------------------------

def _cost(mode: CostMode, start: Dict[str, float], events: int) -> Dict[str, Any]:
    """A lane's costs since ``start`` (a :meth:`CostMode.per_lane`) and the
    events recorded after the first ``events``."""
    now = mode.per_lane()
    return {"flops": now["flops"] - start["flops"],
            "bytes": now["bytes accessed"] - start["bytes accessed"],
            "coll": collective_bytes(mode.events[events:]), "events": mode.events[events:]}


def _scaled(parts) -> Dict[str, Any]:
    """The sum of ``(cost, times)`` parts."""
    out = {"flops": 0.0, "bytes": 0.0, "coll": {}, "events": []}
    for c, k in parts:
        out["flops"] += k * c["flops"]
        out["bytes"] += k * c["bytes"]
        for kind, b in c["coll"].items():
            out["coll"][kind] = out["coll"].get(kind, 0) + k * b
        out["events"] += [(kind, name, k * b, axis) for kind, name, b, axis in c["events"]]
    return out


def _public(c: Dict[str, Any]) -> Dict[str, Any]:
    return {"flops": float(c["flops"]), "bytes": float(c["bytes"]),
            "coll": {k: int(v) for k, v in c["coll"].items()}}


# ---------------------------------------------------------------------------
# Placing
# ---------------------------------------------------------------------------

def _meta(spec, shape=None, device=META) -> torch.Tensor:
    return torch.empty(tuple(spec.shape if shape is None else shape),
                       dtype=torch_dtype(spec.dtype), device=device)


def _pieces(specs_tree, pspec_tree, mesh: Mesh, device=META):
    """A position's pieces of a tree placed by fitted specs, as empty
    tensors."""
    shape = dict(mesh.shape)
    pspecs = dict(tree_flatten(pspec_tree))
    return tree_unflatten((n, _meta(s, piece_shape(s.shape, pspecs[n], shape), device))
                          for n, s in tree_flatten(specs_tree))


def unplaceable(model, params_specs, fitted, mesh: Mesh) -> Optional[str]:
    """The first parameter whose partition rule splits a dim over
    ``model`` where the fit replicates it: the port's lanes run on their
    pieces of such a leaf, so the cell cannot be placed (None if every
    leaf can)."""
    m = model_axis_size(mesh)
    if m == 1:
        return None
    specs = dict(tree_flatten(params_specs))
    rules = dict(tree_flatten(fitted))
    wanted = dict(tree_flatten(partition_tree(params_specs, model.partition_rules())))
    for name, spec in wanted.items():
        spec = resolve_spec(spec, mesh)
        for d, e in enumerate(spec):
            axes = () if e is None else (e,) if isinstance(e, str) else e
            got = rules[name][d] if d < len(rules[name]) else None
            got = () if got is None else (got,) if isinstance(got, str) else got
            if MODEL in axes and MODEL not in got:
                return (f"cannot place {name} {tuple(specs[name].shape)}: dim {d} of size "
                        f"{specs[name].shape[d]} does not split over model={m}")
    return None


# ---------------------------------------------------------------------------
# Tracing a cell
# ---------------------------------------------------------------------------

def _trace_train(low, mesh: Mesh, in_ps, skip_analysis: bool):
    """One data lane's model group: a microbatch, its accumulation, the
    update of the first card's pieces (see the module docstring).  The
    arguments are made before the counting starts."""
    m = model_axis_size(mesh)
    n_data = mesh.devices.size // m
    cfg = low.cfg.scaled(remat=False) if m > 1 else low.cfg
    model = build_model(cfg) if m > 1 else low.model
    state_specs, batch_specs = low.specs
    sps, bps = in_ps
    lanes = [_pieces(state_specs["params"], sps["params"], mesh) for _ in range(m)]
    opt = _pieces(state_specs["opt"], sps["opt"], mesh)
    ef = _pieces(state_specs["ef"], sps["ef"], mesh) if low.tcfg.compress_grads else None
    batch_lane = _pieces(batch_specs, bps, mesh)
    rows = next(iter(batch_lane.values())).shape[0]
    mb = low.tcfg.microbatches
    mb_eff = max(1, min(mb, rows))
    part = {k: v[: rows // mb_eff] for k, v in batch_lane.items()}
    group = ModelGroup([META] * m) if m > 1 else None
    accumulate = mb_eff * n_data > 1
    masters = dict(tree_flatten(sps["opt"]["master"]))
    notes = []
    if mb_eff != mb:
        notes.append(f"microbatches capped at a data lane's {rows} rows")
    if m > 1:
        notes.append("no remat (a model group over distinct cards)")

    with CostMode(lanes=m) as mode:
        if accumulate:   # the first group's f32 sums, one tree a model lane
            accs = [tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=META), t)
                    for t in lanes]
        start, ev = mode.per_lane(), len(mode.events)
        metrics, grads = loss_and_grads(model, lanes if group else lanes[0], part, group)
        body = _cost(mode, start, ev)
        add = {"flops": 0.0, "bytes": 0.0, "coll": {}, "events": []}
        if accumulate:
            start, ev = mode.per_lane(), len(mode.events)
            with torch.no_grad():
                for acc, lane_g in zip(accs, grads if group else [grads]):
                    for (_, a), (_, b) in zip(tree_flatten(acc), tree_flatten(lane_g)):
                        a.add_(b.float())
            add = _cost(mode, start, ev)
            del grads
            grads0 = accs[0]
        else:
            grads0 = grads if group is None else grads[0]

        start, ev = mode.per_lane(), len(mode.events)
        with torch.no_grad(), mode.home():
            params0 = lanes[0]
            if accumulate:
                for _, g in tree_flatten(grads0):
                    g.div_(mb_eff * n_data)
            record_data_traffic([(n, p.numel() * p.element_size(), splits_over_data(masters[n]))
                                 for n, p in tree_flatten(params0)], n_data)
            if ef is not None:
                grads0 = compress_grads(grads0, ef)
            sc = adamw_scalars(opt["step"], grads0, low.tcfg.opt)
            trees = [dict(tree_flatten(t)) for t in
                     (params0, opt["master"], grads0, opt["m"], opt["v"])]
            for name in trees[0]:
                p, master, g, mm, vv = (t[name] for t in trees)
                if tuple(master.shape) == tuple(p.shape):
                    update_leaf(p, master, g, mm, vv, sc, low.tcfg.opt)
                else:                    # a ZeRO-1 piece: its slice of the lane's piece
                    sl = tuple(slice(0, n) for n in master.shape)
                    new = torch.empty(master.shape, dtype=p.dtype, device=p.device)
                    update_leaf(new, master, g[sl], mm, vv, sc, low.tcfg.opt)
                    p[sl].copy_(new)
            opt["step"].copy_(sc["step"])
        update = _cost(mode, start, ev)
    if skip_analysis:
        total = _scaled([(body, 1), (add, 1), (update, 1)])
    else:
        total = _scaled([(body, mb_eff), (add, mb_eff * n_data), (update, 1)])
    out_bytes = sum(t.numel() * t.element_size() for t in
                    list(metrics.values()) + [sc["lr"], sc["grad_norm"]]
                    if isinstance(t, torch.Tensor))
    return mode, _scaled([(body, 1), (add, 1)]), total, out_bytes, notes


def _trace_serve(low, mesh: Mesh, in_ps):
    """One lane's prefill of its data lane's rows, or its strip of decode
    slots, with the whole weights."""
    args = [_pieces(s, p, mesh) if isinstance(s, dict) else _meta(
        s, piece_shape(s.shape, p, dict(mesh.shape))) for s, p in zip(low.specs, in_ps)]
    with CostMode() as mode, torch.no_grad():
        logits, _ = low.fn(*args)
        cost = _cost(mode, {"flops": 0.0, "bytes accessed": 0.0}, 0)
    return mode, cost, cost, logits.numel() * logits.element_size(), []


def fit_cell(low, mesh: Mesh):
    """The cell's argument specs fitted to ``mesh`` (the JAX package's
    ``_compile_cell`` fit), axes the mesh lacks left out first."""
    return tuple(fit_pspecs(tree_map(lambda s: resolve_spec(s, mesh), p), s, mesh)
                 if isinstance(s, dict) else fit_pspecs(resolve_spec(p, mesh), s, mesh)
                 for p, s in zip(low.in_pspecs, low.specs))


def run_cell(arch: str, shape, *, multi_pod: bool = False, verbose: bool = True,
             mesh: Optional[Mesh] = None, skip_analysis: bool = False,
             **build_kw) -> Dict[str, Any]:
    """Dry-run one cell on ``mesh`` (the meta production mesh by default):
    the JAX package's record keys (``memory``, ``roofline``,
    ``raw_cost_body_once``, ``compile_s``: the trace's seconds, ...).
    Raises ``ValueError`` for a cell the port cannot place."""
    t0 = time.time()
    if mesh is None:
        mesh = meta_production_mesh(multi_pod)
    n_chips = int(mesh.devices.size)
    shape_spec = resolve_shape(shape)
    low = build_lowerable(arch, shape_spec, **build_kw)
    in_ps = fit_cell(low, mesh)
    if low.kind == "train":
        why = unplaceable(low.model, low.specs[0]["params"], in_ps[0]["params"], mesh)
        if why is not None:
            raise ValueError(f"{arch} x {shape_spec.name} on {dict(mesh.shape)}: {why}")
    m = model_axis_size(mesh)
    if low.kind == "train":
        mode, raw, total, out_extra, notes = _trace_train(low, mesh, in_ps, skip_analysis)
    else:
        mode, raw, total, out_extra, notes = _trace_serve(low, mesh, in_ps)
    args = [placed_bytes(s, p, mesh) for s, p in zip(low.specs, in_ps)]
    donated = sum(args[i] for i in low.donate)
    mem = {"argument_size_in_bytes": int(sum(args)),
           "output_size_in_bytes": int(donated + out_extra),
           "alias_size_in_bytes": int(donated),
           "temp_size_in_bytes": int(mode.peak_lane_bytes)}

    cfg = low.cfg
    params_specs = low.specs[0]["params"] if low.kind == "train" else low.specs[0]
    mf = model_flops(cfg, params_specs, low.kind, shape_spec.batch, shape_spec.seq)
    n_data = n_chips // m
    spans = {"model": m, "data": (n_data - 1) * m + 1}
    roof = Roofline(flops=total["flops"], hbm_bytes=total["bytes"],
                    coll_bytes=wire_bytes(total["coll"]),
                    coll_breakdown={k: int(v) for k, v in total["coll"].items()},
                    model_flops=mf, peak="bf16_tensor" if cfg.dtype == "bfloat16" else "fp32",
                    coll_s=collective_seconds(total["events"], spans))
    note = "; ".join([low.note] + notes)
    rec = {
        "arch": arch, "shape": shape_spec.name, "kind": low.kind,
        "mesh": dict(mesh.shape), "chips": n_chips,
        "multi_pod": multi_pod, "note": note,
        "memory": mem,
        "roofline": roof.to_dict(n_chips),
        "raw_cost_body_once": _public(raw),
        "compile_s": round(time.time() - t0, 1),
        "status": "ok",
    }
    rec["_events"] = total["events"]
    if verbose:
        print(f"== {arch} x {shape_spec.name} [{low.kind}] mesh={dict(mesh.shape)} "
              f"({rec['compile_s']}s) {note} ==")
        print(f"   memory a card: {mem} ({(sum(args) + mem['temp_size_in_bytes']) / 2**30:.2f} "
              f"GiB arguments + temp)")
        print(f"   cost a card: flops={roof.flops:.3e} bytes={roof.hbm_bytes:.3e}")
        print(f"   collectives a card: {roof.coll_breakdown} -> {roof.coll_bytes:.3e} B")
        print(f"   roofline (H100 80GB HBM3 data sheet): compute={roof.t_compute*1e3:.2f}ms "
              f"memory={roof.t_memory*1e3:.2f}ms "
              f"collective={roof.t_collective*1e3:.2f}ms "
              f"-> {roof.bottleneck}-bound; "
              f"useful_flops={roof.useful_flops_ratio(n_chips):.2%} "
              f"mfu_bound={roof.mfu_bound(n_chips):.2%}")
    return rec


def parse_overrides(items) -> Dict[str, Any]:
    """``k=v`` overrides of :class:`~repro_torch.models.common.ArchConfig`
    fields (0 / 1 for a boolean field, numbers as numbers).  The
    reference's ``opt_*``, ``unroll_layers`` and ``use_pallas`` levers are
    refused: they steer its GSPMD / TPU program, and the port has no
    counterpart."""
    fields = {f.name: f for f in dataclasses.fields(ArchConfig)}
    out: Dict[str, Any] = {}
    for kv in items:
        k, _, v = kv.partition("=")
        if k.startswith("opt_") or k in REFUSED_LEVERS:
            raise ValueError(f"--opt {k}: a lever of the reference's GSPMD / TPU program, which "
                             "the port has no counterpart of")
        if k not in fields:
            raise ValueError(f"--opt {k}: not an ArchConfig field")
        default = fields[k].default
        if isinstance(default, bool):
            out[k] = bool(int(v))
        elif isinstance(default, int) and not isinstance(default, bool):
            out[k] = int(v)
        elif isinstance(default, float):
            out[k] = float(v)
        else:
            out[k] = None if v == "None" else (int(v) if v.lstrip("-").isdigit() else v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true", help="run every runnable cell")
    ap.add_argument("--multi-pod", action="store_true",
                    help="2x16x16 (512 cards) instead of 16x16 (256)")
    ap.add_argument("--both-meshes", action="store_true",
                    help="run each cell on single-pod AND multi-pod meshes")
    ap.add_argument("--mesh", default=None,
                    help="another meta mesh instead, 'data,model' or 'pod,data,model' (e.g. "
                         "1,1: does a cell fit one card; 4,1 or 1,4: four)")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--skip-analysis", action="store_true",
                    help="record one microbatch, unscaled")
    ap.add_argument("--opt", nargs="*", default=[],
                    help="ArchConfig overrides, e.g. remat=0 (the reference's opt_* levers "
                         "are refused)")
    args = ap.parse_args(argv)
    overrides = parse_overrides(args.opt)

    if args.all:
        todo = [(a, s) for a, s, ok, _ in cells(include_skips=False)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required unless --all")
        todo = [(args.arch, args.shape)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    mesh = None
    if args.mesh:
        shape = tuple(int(n) for n in args.mesh.split(","))
        mesh = meta_mesh(shape, ("pod", "data", "model")[-len(shape):])
        meshes = [len(shape) == 3]
    build_kw = dict(microbatches=args.microbatches, zero1=not args.no_zero1,
                    compress_grads=args.compress_grads)
    failures = 0
    t0 = time.time()
    for arch, shape in todo:
        for mp in meshes:
            try:
                kw = dict(build_kw)
                if overrides:
                    kw["cfg_override"] = get_config(arch).scaled(**overrides)
                rec = run_cell(arch, shape, multi_pod=mp, mesh=mesh,
                               skip_analysis=args.skip_analysis, **kw)
                rec.pop("_events")
            except Exception as e:
                failures += 1
                rec = {"arch": arch, "shape": shape, "multi_pod": mp,
                       "status": "error", "error": repr(e)}
                print(f"== {arch} x {shape} multi_pod={mp} FAILED: {e!r}", file=sys.stderr)
                if not isinstance(e, ValueError):
                    traceback.print_exc()
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    print(f"dryrun: {len(todo) * len(meshes)} cell(s), {failures} error(s), "
          f"{time.time() - t0:.1f} s")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
