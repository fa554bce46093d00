"""Tensor parallelism over a mesh's ``model`` axis: Megatron-LM's operators
for one process that drives every lane of a model group.

Within one data lane, the M lanes of a :class:`ModelGroup` each hold a
copy of the residual stream ``x (B, S, D)`` and their own pieces of the
parameters the partition rules split over ``model``
(``DecoderLM.partition_rules``): a lane runs its heads, its columns of the
hidden layer, its experts and its rows of the vocabulary.  The operators
below connect the lanes; each takes every lane's tensor and returns every
lane's tensor:

* :func:`copy` (Megatron's *f*): the identity; its backward sums the
  lanes' gradients.  It stands before every use of a replicated tensor by
  a lane's own piece of work (a column-split projection, a lane's
  experts, a lane's heads of the MLA latents), so that each lane's copy
  receives the whole gradient.
* :func:`reduce` (*g*): sums the lanes' partial outputs (a row-split
  projection's) and places a copy of the sum on every lane; its backward
  is the identity on each lane.
* :func:`gather`: concatenates a tensor's pieces and places the whole on
  every lane; its backward hands each lane the slice of its own piece.
  Its result is used alike on every lane, or through a :func:`copy`.
* :func:`single`: one lane's copy of a replicated value (the MoE metrics
  that enter the loss once, not M times); its backward hands the gradient
  to every lane.
* :func:`split` (Megatron's *scatter*): each lane's own piece of a tensor
  every lane holds alike (a lane's heads of a replicated decay or norm
  scale); its backward gathers the pieces' gradients onto every lane.  It
  is ``copy`` followed by each lane's slice, with the zero sums left out.
* :func:`allreduce`: the sum of the lanes' partial values on every lane,
  whose backward also sums (``copy`` after ``reduce``): a statistic over
  a dimension split over the lanes, such as Mamba2's gated RMS norm over
  the whole ``d_inner``.
* :func:`regroup`: a column-split product's output redistributed into the
  column ranges each lane needs (Mamba2's fused ``in_proj``, whose
  contiguous pieces do not line up with heads: each lane takes its heads'
  ``z``, ``x`` and ``dt`` and the ``B`` and ``C`` every head shares); its
  backward sums each column's gradients over the lanes that read it.

A replicated parameter (a norm's scale, the router) is used only by work
that every lane repeats alike, or through a :func:`copy` (the qk-norm of
a lane's heads), so every lane's copy of it gets the same, whole
gradient.  Every sum runs in a fixed order: in f32, in lane order, on the
group's first device, then cast to the activation dtype (no float atomics,
no reliance on autograd's order of accumulation), so restarts and
CUDA-graph replays stay bit for bit.

The vocabulary-parallel embedding (:func:`embed`) and cross-entropy
(:func:`cross_entropy`) keep the vocabulary in pieces: no lane holds the
``(B, S, V)`` logits.

The JAX package has no such module: there GSPMD inserts the collectives
that the partition rules and ``repro.models.common.constrain`` imply.

**What crosses lanes.**  While a recorder is active (:func:`recording`;
:class:`repro_torch.launch.roofline.CostMode` is one), each operator
reports, in its forward and in its backward, the collective a
multi-process program would run for it, with the bytes a lane sends or
receives (the larger of a lane's input and output, as the JAX package reads
collectives from HLO) and an op name, the qualified names of the last
three calls inside ``repro_torch.models`` that led to the operator:

=============  ===========================  ===========================
operator       forward                      backward
=============  ===========================  ===========================
``copy``       none (the identity)          ``all-reduce`` of a lane's
                                            gradient
``reduce``     ``all-reduce`` of a lane's   none (the identity)
               partial
``gather``     ``all-gather`` of the whole  none (each lane's slice)
``single``     none (the first lane's)      ``collective-permute``: the
                                            gradient to every lane
``split``      none (each lane's slice)     ``all-gather`` of the whole
``regroup``    ``all-to-all``               ``all-to-all``
=============  ===========================  ===========================

``allreduce`` is a ``reduce`` and a ``copy``.  The work inside an
operator (the sums in lane order, the copies) runs on the group's first
lane, and the recorder is told so (its ``home()``).  With no recorder an
operator's cost is one ``None`` check.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Tensors = List[torch.Tensor]

_REC = threading.local()


def recorder():
    """The recorder active in this thread (:func:`recording`), or None."""
    return getattr(_REC, "rec", None)


@contextlib.contextmanager
def recording(rec) -> Iterator[None]:
    """Send the cross-lane traffic of the operators called inside (their
    backward too, in whatever thread autograd runs it) to ``rec``, an
    object with ``collective(kind, nbytes, name, axis)`` and a ``home()``
    context (:class:`repro_torch.launch.roofline.CostMode`)."""
    outer = recorder()
    _REC.rec = rec
    try:
        yield
    finally:
        _REC.rec = outer


def op_name(depth: int = 3) -> str:
    """The qualified names of the last ``depth`` calls inside
    ``repro_torch.models`` (this module's own left out) on the calling
    stack, outermost first, joined by ``/``."""
    names: List[str] = []
    frame = sys._getframe(1)
    while frame is not None and len(names) < depth:
        module = frame.f_globals.get("__name__", "")
        if module.startswith("repro_torch.models") and module != __name__:
            names.append(f"{module.rsplit('.', 1)[-1]}.{frame.f_code.co_qualname}")
        frame = frame.f_back
    return "/".join(reversed(names)) or "?"


def _nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def _traffic(ctx, rec, kind: Optional[str], nbytes: int):
    """Record one operator's forward (``kind`` None: no traffic) with
    ``rec`` and keep the recorder and the op name for its backward;
    returns the ``home()`` context its own work runs in."""
    ctx.rec = rec
    if rec is None:
        return contextlib.nullcontext()
    ctx.name = op_name()
    if kind is not None:
        rec.collective(kind, nbytes, ctx.name, "model")
    return rec.home()


def _back(ctx, kind: Optional[str], nbytes: int):
    """Record one operator's backward with the recorder of its forward;
    returns the ``home()`` context its own work runs in."""
    rec = ctx.rec
    if rec is None:
        return contextlib.nullcontext()
    if kind is not None:
        rec.collective(kind, nbytes, ctx.name, "model")
    return rec.home()


@dataclasses.dataclass(frozen=True)
class ModelGroup:
    """The lanes of one model group: their devices (one a lane, in lane
    order; a device may repeat) and, for a dimension split over them, the
    piece each lane owns (:meth:`piece`)."""

    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        object.__setattr__(self, "devices", tuple(torch.device(d) for d in self.devices))

    @property
    def size(self) -> int:
        """M, the lanes of the group."""
        return len(self.devices)

    @property
    def one_device(self) -> bool:
        """Every lane on one device.  Only then may a training forward
        recompute its layers in the backward (remat): PyTorch's
        non-reentrant checkpoint recomputes a segment in whichever of the
        autograd engine's device threads first needs it, with no lock, and
        over distinct cards two threads start it at once (measured on two
        H100s), so there the layers keep their activations (the same
        values)."""
        return len(set(self.devices)) == 1

    @property
    def home(self) -> torch.device:
        """The first lane's device, where the sums run."""
        return self.devices[0]

    def piece(self, n: int, lane: int) -> Tuple[int, int]:
        """``(start, stop)`` of the piece of a dimension of ``n`` that
        ``lane`` owns; a dimension that M does not divide raises, as
        ``piece_index`` and a JAX ``NamedSharding`` do."""
        if n % self.size:
            raise ValueError(f"a dimension of {n} does not split into {self.size} pieces "
                             "over 'model'")
        k = n // self.size
        return lane * k, (lane + 1) * k

    def head_split(self, heads: int, kv_heads: int) -> str:
        """How a GQA layer's heads fall on the lanes, as the reference's
        ``constrain`` drops an axis that does not divide a dimension:
        ``"heads"`` (M divides H and Hkv: each lane owns whole q and kv
        heads), ``"q"`` (M divides H only: each lane gathers k and v and
        keeps the kv heads its q heads read) or ``"none"`` (the layer's
        q, k and v are gathered and its attention runs on every lane)."""
        if heads % self.size:
            return "none"
        return "heads" if kv_heads % self.size == 0 else "q"


def _on(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t if t.device == device else t.to(device)


def _sum(group: ModelGroup, xs: Sequence[Optional[torch.Tensor]], like: torch.Tensor
         ) -> torch.Tensor:
    """The lanes' tensors summed in f32 (f64 for f64 ones) in lane order on
    the group's first device, cast to ``like``'s dtype (a lane's None
    counts as zero)."""
    acc = torch.zeros(like.shape, dtype=torch.promote_types(like.dtype, torch.float32),
                      device=group.home)
    for x in xs:
        if x is not None:
            acc.add_(_on(x, group.home))
    return acc.to(like.dtype)


def _place(group: ModelGroup, s: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """A copy of ``s`` on every lane's device (the first lane keeps ``s``)."""
    return (s,) + tuple(s.to(d, copy=True) for d in group.devices[1:])


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        with _traffic(ctx, recorder(), None, 0):
            return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        like = next(g for g in gs if g is not None)
        with _back(ctx, "all-reduce", _nbytes(like)):
            return (None,) + _place(ctx.group, _sum(ctx.group, gs, like))


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *partials):
        with _traffic(ctx, recorder(), "all-reduce", _nbytes(partials[0])):
            return _place(group, _sum(group, partials, partials[0]))

    @staticmethod
    def backward(ctx, *gs):
        return (None,) + gs


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, dim, *pieces):
        ctx.group, ctx.dim = group, dim
        ctx.sizes = [p.shape[dim] for p in pieces]
        with _traffic(ctx, recorder(), "all-gather", sum(_nbytes(p) for p in pieces)):
            return _place(group, torch.cat([_on(p, group.home) for p in pieces], dim))

    @staticmethod
    def backward(ctx, *gs):
        out, start = [], 0
        for g, n in zip(gs, ctx.sizes):
            out.append(None if g is None else g.narrow(ctx.dim, start, n).contiguous())
            start += n
        return (None, None) + tuple(out)


class _Single(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        _traffic(ctx, recorder(), None, 0)
        return xs[0].view_as(xs[0])

    @staticmethod
    def backward(ctx, g):
        with _back(ctx, "collective-permute", _nbytes(g)):
            return (None,) + tuple(_on(g, d) for d in ctx.group.devices)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, dim, *xs):
        ctx.group, ctx.dim = group, dim
        n = xs[0].shape[dim]
        with _traffic(ctx, recorder(), None, 0):
            return tuple(x.narrow(dim, a, b - a).contiguous()
                         for lane, x in enumerate(xs) for a, b in [group.piece(n, lane)])

    @staticmethod
    def backward(ctx, *gs):
        like = next(g for g in gs if g is not None)
        with _back(ctx, "all-gather", _nbytes(like) * len(gs)):
            whole = torch.cat([_on(like.new_zeros(like.shape) if g is None else g,
                                   ctx.group.home) for g in gs], ctx.dim)
            return (None, None) + _place(ctx.group, whole)


def _regroup_bytes(pieces_bytes: int, want_cols: int, n: int) -> int:
    """A lane's all-to-all bytes: the larger of its piece and what it
    receives (``want_cols`` of the pieces' ``n`` columns)."""
    return max(pieces_bytes, pieces_bytes * want_cols // max(n, 1))


class _Regroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, ranges, *pieces):
        n = pieces[0].shape[-1]
        ctx.group, ctx.ranges, ctx.n = group, ranges, n
        ctx.dtype = pieces[0].dtype
        ctx.nbytes = _regroup_bytes(_nbytes(pieces[0]), max(sum(b - a for a, b in want)
                                                            for want in ranges), n)
        with _traffic(ctx, recorder(), "all-to-all", ctx.nbytes):
            return tuple(torch.cat([_on(pieces[lane][..., a:b], dev)
                                    for lane, a, b, _ in _spans(want, n)], -1)
                         for dev, want in zip(group.devices, ranges))

    @staticmethod
    def backward(ctx, *gs):
        with _back(ctx, "all-to-all", ctx.nbytes):
            return _Regroup._backward(ctx, *gs)

    @staticmethod
    def _backward(ctx, *gs):
        group, n = ctx.group, ctx.n
        accs: List[Optional[torch.Tensor]] = [None] * group.size
        for g, want in zip(gs, ctx.ranges):      # in lane order, in f32, on the first lane
            if g is None:
                continue
            for lane, a, b, at in _spans(want, n):
                if accs[lane] is None:
                    accs[lane] = torch.zeros(g.shape[:-1] + (n,), dtype=torch.promote_types(
                        g.dtype, torch.float32), device=group.home)
                accs[lane][..., a:b] += _on(g[..., at:at + b - a], group.home)
        return (None, None) + tuple(None if acc is None else _on(acc.to(ctx.dtype), dev)
                                    for acc, dev in zip(accs, group.devices))


def _spans(want: Sequence[Tuple[int, int]], n: int):
    """``(lane, start, stop, offset)`` of each part of the global column
    ranges ``want`` that one piece of ``n`` columns holds: the piece's
    lane, the part's columns within the piece and its first column within
    the ranges' concatenation."""
    at = 0
    for a, b in want:
        for lane in range(a // n, (b - 1) // n + 1):
            lo, hi = max(a, lane * n), min(b, (lane + 1) * n)
            yield lane, lo - lane * n, hi - lane * n, at + lo - a
        at += b - a


def copy(group: ModelGroup, xs: Sequence[torch.Tensor]) -> Tensors:
    """Megatron's *f*: every lane's tensor as it is; the backward gives
    each lane the sum of the lanes' gradients."""
    return list(_Copy.apply(group, *xs))


def reduce(group: ModelGroup, partials: Sequence[torch.Tensor]) -> Tensors:
    """Megatron's *g*: the sum of the lanes' partial outputs, a copy on
    every lane; the backward is the identity on each lane."""
    return list(_Reduce.apply(group, *partials))


def gather(group: ModelGroup, pieces: Sequence[torch.Tensor], dim: int = -1) -> Tensors:
    """The lanes' pieces concatenated along ``dim`` in lane order, a copy
    on every lane; the backward hands each lane the slice of its piece of
    its own copy's gradient."""
    return list(_Gather.apply(group, dim % pieces[0].dim(), *pieces))


def single(group: ModelGroup, xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The first lane's copy of a value every lane holds alike; the
    backward hands the gradient to every lane."""
    return _Single.apply(group, *xs)


def split(group: ModelGroup, xs: Sequence[torch.Tensor], dim: int = -1) -> Tensors:
    """Megatron's *scatter*: each lane's piece (:meth:`ModelGroup.piece`)
    along ``dim`` of its copy of a tensor the lanes hold alike; the
    backward gathers the pieces' gradients in lane order and places the
    whole on every lane."""
    return list(_Split.apply(group, dim % xs[0].dim(), *xs))


def allreduce(group: ModelGroup, partials: Sequence[torch.Tensor]) -> Tensors:
    """The lanes' partial values summed (:func:`reduce`), a copy on every
    lane, whose backward sums the lanes' gradients (:func:`copy`): each
    lane's partial receives the gradient of every lane's use of the sum."""
    return copy(group, reduce(group, partials))


def regroup(group: ModelGroup, pieces: Sequence[torch.Tensor],
            ranges: Sequence[Sequence[Tuple[int, int]]]) -> Tensors:
    """The lanes' equal pieces of a last dimension (a column-split
    product's outputs, in lane order) redistributed: lane ``m`` receives
    the concatenation of the global column ranges ``ranges[m]``.  The
    backward hands each piece the gradient of its columns summed over the
    lanes that read them, in f32 in lane order on the group's first
    device."""
    return list(_Regroup.apply(group, tuple(tuple(r) for r in ranges), *pieces))


def sub(trees: Sequence[dict], key: str) -> list:
    """Each lane's ``key`` subtree of the lanes' parameter trees."""
    return [t[key] for t in trees]


def copy_tree(group: ModelGroup, trees: Sequence[dict]) -> List[dict]:
    """:func:`copy` of every leaf of the lanes' (replicated) parameter
    subtrees, e.g. a norm's scale used by a lane's own heads."""
    keys = sorted(trees[0])
    out = [dict() for _ in trees]
    for k in keys:
        if isinstance(trees[0][k], dict):
            sub = copy_tree(group, [t[k] for t in trees])
        else:
            sub = copy(group, [t[k] for t in trees])
        for o, s in zip(out, sub):
            o[k] = s
    return out


# ---------------------------------------------------------------------------
# The vocabulary in pieces
# ---------------------------------------------------------------------------

def embed(group: ModelGroup, tokens: torch.Tensor, tables: Sequence[torch.Tensor],
          dtype: torch.dtype) -> Tensors:
    """The vocabulary-parallel lookup: each lane embeds the tokens in its
    row range of the table (``tables``: each lane's rows) through
    ``F.embedding`` on the shifted ids (a deterministic backward), writes
    zeros elsewhere, and the lanes' rows are :func:`reduce` d: the
    one-table lookup, bit for bit (one lane adds a row, the others zero)."""
    vocab = tables[0].shape[0] * group.size
    partials = []
    for lane, (dev, table) in enumerate(zip(group.devices, tables)):
        a, b = group.piece(vocab, lane)
        tok = _on(tokens, dev).long()
        inside = (tok >= a) & (tok < b)
        rows = F.embedding(torch.where(inside, tok - a, torch.zeros_like(tok)), table)
        partials.append(torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                                         device=dev)).to(dtype))
    return reduce(group, partials)


def cross_entropy(group: ModelGroup, logits: Sequence[torch.Tensor], labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The vocabulary-parallel mean token cross-entropy, on the group's
    first device: each lane takes the logsumexp of its columns (``logits``:
    each lane's ``(..., V/M)`` f32 columns), the lanes' values are combined
    by a logsumexp in lane order, and the gold logit comes from the lane
    that owns the label (the lanes' values summed in lane order, one of
    them nonzero).  With ``mask``, the mean over the positions it weights,
    as :func:`~repro_torch.models.layers.cross_entropy`."""
    home = group.home
    vocab = logits[0].shape[-1] * group.size
    logz = torch.logsumexp(torch.stack([_on(torch.logsumexp(lg, dim=-1), home)
                                        for lg in logits]), dim=0)
    gold = None
    for lane, lg in enumerate(logits):
        a, b = group.piece(vocab, lane)
        lab = _on(labels, lg.device).long()
        inside = (lab >= a) & (lab < b)
        picked = torch.gather(lg, -1, torch.where(inside, lab - a, torch.zeros_like(lab))[..., None])
        picked = _on(torch.where(inside, picked[..., 0], torch.zeros((), dtype=lg.dtype,
                                                                      device=lg.device)), home)
        gold = picked if gold is None else gold + picked
    nll = logz - gold
    if mask is not None:
        mask = _on(mask, home).to(nll.dtype)
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()
