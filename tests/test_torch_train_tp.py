"""The port's training over a mesh's ``model`` axis (Megatron-style tensor
parallelism and experts over ``model``, a vocabulary-parallel loss) on CPU
lanes (``make_data_mesh([cpu] * n, model=m)``, one CPU named n times),
against the JAX package's GSPMD step and the port's own no-mesh step.

* **The operators** of :mod:`repro_torch.models.parallel`: ``copy`` and
  ``gather`` (around a column-split product), ``reduce`` (after a
  row-split one), ``single``, ``split`` (each lane's piece of a
  replicated tensor), ``allreduce`` (a statistic over split columns),
  ``regroup`` (a column-split output into overlapping ranges that cross
  the pieces' boundary), the vocabulary-parallel embedding and
  cross-entropy, each against its one-lane form, forward and backward,
  under ``torch.autograd.gradcheck`` in f64; twice give equal bits.
* **Against the JAX package**: a subprocess runs the reference's
  ``TrainProcess`` on an Auto ``(pod 1, data 2, model 2)`` and ``(1, 1,
  4)`` mesh of four forced host devices for qwen3-14b, granite-moe-1b-
  a400m and deepseek-v2-lite-16b SMOKE over three draws of a CRC-32
  ``KeyGen`` (:data:`TP_DRAWS`, about 75 s).  The port's step from each
  draw's initial state: the metrics of three steps within rtol 1e-5;
  after one step every state piece within rtol 1e-4 and twice the
  family's gradient band (``tests/test_torch_train.py``'s
  ``FAMILY_GRAD_ATOL``) x its leaf's max: the lanes' f32 sums are a
  second summation order beside the two packages' (the model-axis
  gradient lies up to 8e-7 x max |grad| from the port's no-mesh one on
  qwen3-14b; measured up to 1.12 x the dense band, on one element of m
  of one draw, and under 1 x for the others), except the parameters and master of an element whose
  gradient is under 100 x AdamW's eps: its first Adam step g / (|g| +
  eps) moves with the f32 rounding of g (measured: every element outside
  the band had |g| <= 8.5e-8, and moved at most 0.11 lr), so there it is
  held within 2 lr; after three steps, over the draws, the port's mean
  rms distance from an f64 run of its no-mesh step no more than 1.5x the
  reference's (``test_torch_train_mesh.assert_as_close_to_f64``;
  measured over these five draws 0.88 to 1.39 over the six cases, over
  draws 0-9 0.90 to 1.39; for deepseek-v2-lite on (1, 2, 2) the port's
  no-mesh step lies as far: draw 0's rms 2.35e-7 against the model-axis
  step's 1.45e-7 and the reference's 6.4e-8).
  The port's data lanes take the reference's microbatch semantics (PR
  30's lane rule), so on ``(1, 2, 2)`` the reference runs
  ``microbatches=2``: the MoE load-balance loss is a per-microbatch mean
  there as here (one global batch would take it over all eight rows).
  The reference's microbatch ``loss`` metric adds that loss, where its
  one-batch metric does not; the subprocess takes the cross-entropy of
  each microbatch (``model.loss_fn``'s ``loss``) before the step, the
  metric the port reports either way.
* **Against the port's no-mesh step**: all seven ``DecoderLM`` archs at
  ``model`` 2 and 4: the loss within rtol 1e-5, every lane's gradient
  piece within the same bands of the no-mesh gradient's slice, one
  step's ``grad_norm`` within rtol 1e-5; ``(data 2, model 2)`` bit for
  bit ``(data 1, model 2)`` with ``microbatches=2``; the head splits
  where M does not divide Hkv (qwen3 at ``model`` 4, and a config whose
  lanes read kv heads in unequal runs) and where M does not divide H (the
  layer replicated); a masked batch weights the data lanes by tokens.
* One capture holds every lane of a group on one device (the recorder of
  ``tests/test_torch_train.py``): replays bit for bit the eager steps,
  each lane's kernel launches counted.
* Every family's parameter pieces on (2, 2) are the slices their
  partition rules give (rwkv6, zamba2 and whisper train over ``model``
  too: ``tests/test_torch_train_tp_families.py``).  A vocabulary that M
  does not divide raises, as JAX does.
* ``Trainer(mesh=)`` on ``(data 2, model 2)``: a failure at step 3
  resumed on the same mesh ends bit for bit where an uninterrupted run
  does; resumes onto ``(4, 1)`` and onto one device within 1e-6.
"""
import tempfile

import numpy as np
import pytest
import torch
from torch.autograd import gradcheck

from repro_torch import interop
from repro_torch.configs import get_smoke
from repro_torch.core.arena import tree_flatten
from repro_torch.core.registry import launch_counts
from repro_torch.data.pipeline import StreamConfig, TokenStream
from repro_torch.launch.mesh import Sharded, make_data_mesh
from repro_torch.models import build_model
from repro_torch.models import layers as tlayers
from repro_torch.models import parallel as tp
from repro_torch.models.layers import kv_heads_of_lane
from repro_torch.train import (Trainer, TrainerConfig, TrainProcess, make_mesh_train_step,
                               make_train_state, make_train_step, shard_state, state_pspecs,
                               to_named)
from repro_torch.train.step import accumulate_grads, loss_and_grads, mesh_lanes
from test_torch_train import FAMILY_GRAD_ATOL, GRAD_ATOL, GRAD_RTOL, captured  # noqa: F401
from test_torch_train_mesh import (F64_MULTIPLE, STABLE_KEYS, _of, _stream, _tcfg,
                                   assert_as_close_to_f64, f64_distance, f64_steps, run_jax)

CPU = torch.device("cpu")
DECODERS = ["qwen3-14b", "h2o-danube-1.8b", "qwen2-7b", "minitron-8b", "granite-moe-1b-a400m",
            "deepseek-v2-lite-16b", "internvl2-2b"]
OTHERS = ["rwkv6-3b", "zamba2-2.7b", "whisper-large-v3"]
GROUP = tp.ModelGroup((CPU, CPU))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread for this module's SMOKE-size work: its small
    products run faster so, and a loaded host's threads do not spin."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(data, model):
    return make_data_mesh([CPU] * (data * model), model=model)


def _band(cfg):
    return FAMILY_GRAD_ATOL.get(cfg.family, GRAD_ATOL)


def _close(got, want, band, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=GRAD_RTOL, atol=band * float(np.abs(want).max()),
                               err_msg=msg)


# ---------------------------------------------------------------------------
# the operators
# ---------------------------------------------------------------------------

def _f64(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g, dtype=torch.float64).requires_grad_(True)


def _lanes_of(x):
    """A replicated input as the lanes hold it: each lane a copy, whose
    gradient (the whole one, on every lane) is read on the first."""
    return [x] + [x.detach().requires_grad_(False) for _ in GROUP.devices[1:]]


def _column(x, w0, w1):
    """copy, a column-split product, gather, single: x @ [w0 w1]."""
    xs = tp.copy(GROUP, _lanes_of(x))
    return tp.single(GROUP, tp.gather(GROUP, [xs[0] @ w0, xs[1] @ w1]))


def _row(x, w0, w1):
    """Each lane's columns of x through its rows of w, reduce, single:
    x @ [w0; w1]."""
    k = w0.shape[0]
    xs = tp.copy(GROUP, _lanes_of(x))
    return tp.single(GROUP, tp.reduce(GROUP, [xs[0][..., :k] @ w0, xs[1][..., k:] @ w1]))


def _mlp(x, u0, u1, d0, d1):
    """copy, each lane's hidden columns, its rows of the down product,
    reduce: a two-lane MLP, as ``apply_mlp`` runs it."""
    xs = tp.copy(GROUP, _lanes_of(x))
    ys = tp.reduce(GROUP, [torch.tanh(xs[0] @ u0) @ d0, torch.tanh(xs[1] @ u1) @ d1])
    return tp.single(GROUP, [y * y for y in ys])


def _embed(t0, t1):
    tokens = torch.tensor([[0, 5, 3, 7], [6, 6, 1, 2]])
    return tp.single(GROUP, tp.embed(GROUP, tokens, [t0, t1], torch.float64))


def _ce(l0, l1):
    labels = torch.tensor([[0, 5, 3, 7], [6, 6, 1, 2]])
    mask = torch.tensor([[1.0, 0.0, 1.0, 1.0], [1.0, 1.0, 0.0, 1.0]], dtype=torch.float64)
    return tp.cross_entropy(GROUP, [l0, l1], labels, mask)


def _split(x):
    """split, each lane's own work on its piece, gather: tanh(x)."""
    return tp.single(GROUP, tp.gather(GROUP, [torch.tanh(p) for p in
                                              tp.split(GROUP, _lanes_of(x))]))


def _allreduce(x0, x1):
    """Each lane's columns scaled by the lanes' summed sum of squares (the
    gated RMS norm of Mamba2 over lanes): x / |x| over the whole row."""
    sums = tp.allreduce(GROUP, [(x * x).sum(-1, keepdim=True) for x in (x0, x1)])
    return tp.single(GROUP, tp.gather(GROUP, [x * torch.rsqrt(s) for x, s in
                                              zip((x0, x1), sums)]))


#: column ranges that cross the pieces' boundary (4) and that both lanes read
REGROUP = [[(0, 2), (3, 6)], [(1, 5), (7, 8)]]


def _regroup(p0, p1):
    """regroup of a column-split output into overlapping ranges, each
    lane's own work on its columns, gather."""
    outs = tp.regroup(GROUP, [p0, p1], REGROUP)
    return tp.single(GROUP, tp.gather(GROUP, [torch.tanh(o) * (lane + 1)
                                              for lane, o in enumerate(outs)]))


def _regroup_one(p0, p1):
    whole = torch.cat([p0, p1], -1)
    return torch.cat([torch.tanh(torch.cat([whole[..., a:b] for a, b in ranges], -1)) * (lane + 1)
                      for lane, ranges in enumerate(REGROUP)], -1)


OPERATORS = {
    "copy-gather": (_column, lambda x, w0, w1: x @ torch.cat([w0, w1], 1),
                    lambda: (_f64(2, 3, 4), _f64(4, 5, seed=1), _f64(4, 5, seed=2))),
    "reduce": (_row, lambda x, w0, w1: x @ torch.cat([w0, w1], 0),
               lambda: (_f64(2, 3, 6), _f64(3, 4, seed=1), _f64(3, 4, seed=2))),
    "mlp": (_mlp, lambda x, u0, u1, d0, d1: (torch.tanh(x @ torch.cat([u0, u1], 1))
                                             @ torch.cat([d0, d1], 0)) ** 2,
            lambda: (_f64(2, 3, 4), _f64(4, 3, seed=1), _f64(4, 3, seed=2),
                     _f64(3, 4, seed=3), _f64(3, 4, seed=4))),
    "embed": (_embed, lambda t0, t1: torch.nn.functional.embedding(
        torch.tensor([[0, 5, 3, 7], [6, 6, 1, 2]]), torch.cat([t0, t1])),
        lambda: (_f64(4, 3), _f64(4, 3, seed=1))),
    "split": (_split, torch.tanh, lambda: (_f64(2, 3, 4),)),
    "allreduce": (_allreduce, lambda x0, x1: torch.cat([x0, x1], -1) * torch.rsqrt(
        (torch.cat([x0, x1], -1) ** 2).sum(-1, keepdim=True)),
        lambda: (_f64(2, 3, 3), _f64(2, 3, 3, seed=1))),
    "regroup": (_regroup, _regroup_one, lambda: (_f64(2, 3, 4), _f64(2, 3, 4, seed=1))),
    "cross-entropy": (_ce, lambda l0, l1: tlayers.cross_entropy(
        torch.cat([l0, l1], -1), torch.tensor([[0, 5, 3, 7], [6, 6, 1, 2]]),
        torch.tensor([[1.0, 0.0, 1.0, 1.0], [1.0, 1.0, 0.0, 1.0]], dtype=torch.float64)),
        lambda: (_f64(2, 4, 4), _f64(2, 4, 4, seed=1))),
}


@pytest.mark.parametrize("name", sorted(OPERATORS))
def test_operator_matches_its_one_lane_form_forward_and_backward(name):
    lanes, one, inputs = OPERATORS[name]
    args = inputs()
    assert gradcheck(lanes, args)
    got, want = lanes(*args), one(*args)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(9), dtype=torch.float64)
    ga = torch.autograd.grad(got, args, g)
    wa = torch.autograd.grad(want, args, g)
    for a, b in zip(ga, wa):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    again = lanes(*args)
    assert torch.equal(again, got)
    assert all(torch.equal(a, b) for a, b in zip(torch.autograd.grad(again, args, g), ga))


def test_reduce_sums_in_f32_in_lane_order_on_the_first_lane():
    """bf16 partials: the f32 sum in lane order, cast once, on every lane;
    an embedding of one lane's rows is the one-table lookup bit for bit."""
    parts = [torch.tensor([1.0, 2 ** -9]).bfloat16(), torch.tensor([2 ** -9, 1.0]).bfloat16(),
             torch.tensor([2 ** -9, 2 ** -9]).bfloat16()]
    group = tp.ModelGroup((CPU,) * 3)
    out = tp.reduce(group, parts)
    want = (parts[0].float() + parts[1].float() + parts[2].float()).bfloat16()
    assert all(torch.equal(o, want) for o in out) and len({o.data_ptr() for o in out}) == 3
    table = torch.randn(12, 5).bfloat16()
    tokens = torch.tensor([[0, 11, 4, 4, 7]])
    got = tp.embed(group, tokens, list(table.chunk(3)), torch.bfloat16)
    assert all(torch.equal(g, torch.nn.functional.embedding(tokens, table)) for g in got)


@pytest.mark.parametrize("h,hkv,m,want", [
    (4, 2, 4, [[0], [0], [1], [1]]),            # qwen3 SMOKE at model 4
    (32, 8, 16, [[i // 2] for i in range(16)]),  # a full config at model 16
    (12, 3, 4, [[0], [0, 1, 1], [1, 1, 2], [2]]),  # unequal runs: a kv head a q head
    (8, 8, 4, [[0, 1], [2, 3], [4, 5], [6, 7]]),
])
def test_kv_heads_each_lane_reads(h, hkv, m, want):
    assert [kv_heads_of_lane(h, hkv, lane, m) for lane in range(m)] == want


def test_head_split_follows_the_reference_constrain():
    g4 = tp.ModelGroup((CPU,) * 4)
    assert g4.head_split(8, 4) == "heads" and g4.head_split(4, 2) == "q"
    assert g4.head_split(6, 2) == "none" and tp.ModelGroup((CPU,) * 16).head_split(40, 8) == "none"
    with pytest.raises(ValueError, match="does not split"):
        g4.piece(6, 0)


# ---------------------------------------------------------------------------
# against the JAX package's GSPMD step
# ---------------------------------------------------------------------------

JAX_ARCHS = ["qwen3-14b", "granite-moe-1b-a400m", "deepseek-v2-lite-16b"]
SHAPES = [(1, 2, 2), (1, 1, 4)]
TP_DRAWS = tuple(range(5))
#: AdamW's eps (``AdamWConfig``)
EPS = 1e-8

_JAX_TP = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
""" + STABLE_KEYS + r"""
from jax.sharding import Mesh
from repro.configs import get_smoke
from repro.data.pipeline import StreamConfig, TokenStream
from repro.models import build_model
from repro.optim import AdamWConfig, Schedule
from repro.train import TrainConfig, TrainProcess, make_train_state
assert len(jax.devices()) == 4

def named(t):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}

out = {}
draws = [int(s) for s in sys.argv[4].split(",")]
# with a fifth argument, a directory: the first arch's first draw's state
# after three steps on the first mesh, saved there as a sharded checkpoint
ckpt_dir = sys.argv[5] if len(sys.argv) > 5 else None
for arch in sys.argv[2].split(","):
    cfg = get_smoke(arch)
    model = build_model(cfg)
    frames = (dict(kind="encdec", enc_frames=6, d_model=cfg.d_model)
              if cfg.family == "encdec" else {})
    stream = TokenStream(StreamConfig(vocab=cfg.vocab, seq=12, batch=8, **frames))
    for shape in [tuple(int(n) for n in s.split("x")) for s in sys.argv[3].split(",")]:
        # an Auto (pod, data, model) mesh: jax.make_mesh's Explicit axes are
        # refused by the reference's constrain
        mesh = Mesh(np.array(jax.devices(), dtype=object).reshape(shape),
                    ("pod", "data", "model"))
        mb = shape[1]
        tcfg = TrainConfig(microbatches=mb, opt=AdamWConfig(schedule=Schedule(
            kind="constant", base_lr=1e-3, warmup_steps=0)))
        ce = jax.jit(lambda p, b: model.loss_fn(p, b)[1]["loss"])
        for seed in draws:
            key = f"{arch}/{'x'.join(map(str, shape))}/{seed}/"
            state = make_train_state(model, jax.random.key(seed))
            out.update({f"{arch}/{seed}/init{k}": v for k, v in named(state).items()})
            proc = TrainProcess(model, tcfg, mesh).init(state, stream.batch_at(0))
            metrics = []
            for i in range(3):
                batch = stream.batch_at(i)
                rows = len(batch["tokens"]) // mb
                loss = np.mean([float(ce(state["params"], {k: v[j * rows:(j + 1) * rows]
                                                           for k, v in batch.items()}))
                                for j in range(mb)])
                state, m = proc.launch(state, batch)
                metrics.append([loss] + [float(m[k]) for k in ("grad_norm", "lr")])
                if i in (0, 2):
                    out.update({f"{key}step{i + 1}{k}": v for k, v in named(state).items()})
            out[key + "metrics"] = np.array(metrics)
            if ckpt_dir:
                from repro.ckpt import save_checkpoint
                save_checkpoint(ckpt_dir, 3, state, sharded=True)
                ckpt_dir = None
np.savez(sys.argv[1], **out)
"""


def _assert_first_step(placed, want, band, msg):
    """Every piece of the state after one step within :func:`_close`'s
    ``band`` of the reference's; a parameter or master element whose
    gradient (m / (1 - b1) after one step) is under 100 eps within 2 lr."""
    for name, s in tree_flatten(placed):
        moment = name.startswith(("['opt']['m']", "['opt']['v']", "['opt']['step']"))
        leaf = name.split("']", 2)[-1] if name.startswith("['opt']") else name[len("['params']"):]
        grad = np.abs(want["['opt']['m']" + leaf]) / 0.1 if not moment else None
        for k, piece in enumerate(s.pieces):
            got, w = piece.float().numpy(), want[name][s.slices(k)].astype(np.float32)
            if moment:
                _close(got, w, band, f"{msg} {name} piece {k}")
                continue
            tiny = grad[s.slices(k)] < 100 * EPS
            _close(np.where(tiny, w, got), w, band, f"{msg} {name} piece {k}")
            assert np.abs(got - w)[tiny].max(initial=0.0) <= 2e-3, (msg, name, k)


@pytest.fixture(scope="module")
def jax_tp():
    """The JAX package's states and metrics of :data:`JAX_ARCHS` on the
    :data:`SHAPES` meshes over :data:`TP_DRAWS`, from a subprocess."""
    return run_jax(_JAX_TP, ",".join(JAX_ARCHS), ",".join("x".join(map(str, s)) for s in SHAPES),
                   ",".join(map(str, TP_DRAWS)), timeout=900)


def against_the_gspmd_step(arch, shape, jax_out, draws, norm_rtol=1e-5, later_by_f64=False):
    """The port's ``TrainProcess`` on ``shape``'s (data, model) lanes from
    each draw's initial state against the reference's GSPMD step
    (``jax_out``, :data:`_JAX_TP`'s output): the metrics of three steps
    (loss and lr within rtol 1e-5, grad_norm within ``norm_rtol``; with
    ``later_by_f64`` the second and third steps' loss and grad_norm are
    judged as the state is, below), every state piece after one step
    (:func:`_assert_first_step`), and after three, over the draws, the mean
    rms distance from an f64 run of the port's no-mesh step at most 1.5x
    the reference's (and with ``later_by_f64`` the later metrics' median
    relative distance from that run's, over the draws and steps, at most
    1.5x the reference's, or 1e-5: after an Adam step these metrics carry
    the heavy-tailed noise of elements at near-zero gradients, which
    moves one draw's grad_norm by up to 3e-4 in either package)."""
    cfg = get_smoke(arch)
    model = build_model(cfg)
    _, data, m = shape
    batches = [_stream(cfg).batch_at(i) for i in range(3)]
    port, reference, later = [], [], []
    for seed in draws:
        key = f"{arch}/{'x'.join(map(str, shape))}/{seed}/"
        init = _of(jax_out, f"{arch}/{seed}/init")
        state = interop.train_state_from_reference(init, cfg, "cpu")
        proc = TrainProcess(model, _tcfg(), mesh=_mesh(data, m)).init(state, batches[0])
        got = []
        for i, batch in enumerate(batches):
            placed, metrics = proc.launch(state, batch)
            got.append([float(metrics[k]) for k in ("loss", "grad_norm", "lr")])
            if i == 0:
                _assert_first_step(placed, _of(jax_out, key + "step1"), 2 * _band(cfg),
                                   f"draw {seed}")
        want = jax_out[key + "metrics"]
        for i in range(len(batches)):
            for j, (k, rtol) in enumerate(zip(("loss", "grad_norm", "lr"),
                                              (1e-5, norm_rtol, 1e-5))):
                if k == "lr" or not (later_by_f64 and i):
                    np.testing.assert_allclose(got[i][j], want[i][j], rtol=rtol,
                                               err_msg=f"{k} draw {seed} step {i}")
        truth_metrics = []
        truth = f64_steps(arch, init, batches, microbatches=data, metrics=truth_metrics)
        port.append(f64_distance({n: s.full().numpy() for n, s in tree_flatten(placed)}, truth))
        reference.append(f64_distance(_of(jax_out, key + "step3"), truth))
        later += [(abs(got[i][j] - t[j]) / abs(t[j]), abs(want[i][j] - t[j]) / abs(t[j]))
                  for i, t in enumerate(truth_metrics) if i for j in (0, 1)]
    assert_as_close_to_f64(port, reference, arch)
    if later_by_f64:
        p, r = np.median(np.array(later), axis=0)
        assert p <= max(F64_MULTIPLE * r, 1e-5), (arch, p, r, later)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_model_axis_matches_the_jax_gspmd_step(arch, shape, jax_tp):
    against_the_gspmd_step(arch, shape, jax_tp, TP_DRAWS)


# ---------------------------------------------------------------------------
# against the port's own no-mesh step
# ---------------------------------------------------------------------------

def _batch(cfg, rows=8, seq=12, seed=0):
    return _stream(cfg, batch=rows, seq=seq).batch_at(seed)


def _placed(model, state, mesh):
    return shard_state(state, to_named(state_pspecs(model, state), mesh))


def _against_no_mesh(cfg, m):
    """The loss and every lane's gradient piece of a (1, m) group, and one
    step's metrics, against the no-mesh step."""
    model = build_model(cfg)
    batch = _batch(cfg)
    state = make_train_state(model, 0, device="cpu")
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    metrics, grads = loss_and_grads(model, state["params"], tensors)
    mesh = _mesh(1, m)
    placed = _placed(model, state, mesh)
    (lanes, group), = mesh_lanes(placed["params"], mesh)
    tp_metrics, tp_grads = loss_and_grads(model, lanes, tensors, group)
    np.testing.assert_allclose(float(tp_metrics["loss"]), float(metrics["loss"]), rtol=1e-5)
    whole, pieces = dict(tree_flatten(grads)), dict(tree_flatten(placed["params"]))
    for lane, tree in enumerate(tp_grads):
        for name, g in tree_flatten(tree):
            assert tuple(g.shape) == tuple(pieces[name].pieces[lane].shape), name
            _close(g.numpy(), whole[name][pieces[name].slices(lane)].numpy(), _band(cfg),
                   f"{name} lane {lane}")
    _, want = make_train_step(model, _tcfg())(make_train_state(model, 0, device="cpu"), batch)
    proc = TrainProcess(model, _tcfg(), mesh=mesh).init(make_train_state(model, 0, device="cpu"), batch)
    _, got = proc.launch(proc.state, batch)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", DECODERS)
def test_loss_gradient_pieces_and_norm_match_the_no_mesh_step(arch, m):
    _against_no_mesh(get_smoke(arch), m)


@pytest.mark.parametrize("heads,kv,m", [(12, 3, 4), (6, 2, 4)], ids=["unequal-runs", "replicated"])
def test_head_splits_that_m_does_not_divide(heads, kv, m):
    """M divides H but not Hkv, and a lane's q heads read kv heads in
    unequal runs (one kv head a q head); M does not divide H, so the
    attention runs on every lane (each keeps its rows of the output)."""
    cfg = get_smoke("qwen3-14b").scaled(n_heads=heads, n_kv_heads=kv, d_head=8)
    assert tp.ModelGroup((CPU,) * m).head_split(heads, kv) == ("q" if heads % m == 0 else "none")
    _against_no_mesh(cfg, m)


def _run(model, mesh, batch, steps=2, **kw):
    proc = TrainProcess(model, _tcfg(**kw), mesh=mesh).init(make_train_state(model, 0, device="cpu"), batch)
    out = [proc.launch(proc.state, batch)[1] for _ in range(steps)]
    return proc.state, out


@pytest.mark.parametrize("arch", DECODERS)
def test_two_groups_equal_one_group_with_two_microbatches_bit_for_bit(arch):
    """PR 30's lane rule carried to model groups: (data 2, model 2) is
    (data 1, model 2) with ``microbatches=2`` bit for bit, every piece."""
    cfg = get_smoke(arch)
    model = build_model(cfg)
    batch = _batch(cfg)
    a, ma = _run(model, _mesh(2, 2), batch)
    b, mb = _run(model, _mesh(1, 2), batch, microbatches=2)
    for x, y in zip(ma, mb):
        assert all(torch.equal(x[k], y[k]) for k in y)
    for (name, s), (_, t) in zip(tree_flatten(a), tree_flatten(b)):
        assert torch.equal(s.full(), t.full()), name
        # the replicas of one model coordinate are one value
        for k, p in enumerate(s.pieces):
            assert torch.equal(p, s.full()[s.slices(k)]), (name, k)


def test_masked_batch_weights_the_data_lanes_by_their_tokens():
    """A seeded ``loss_mask`` gives the two data lanes 38 and 17 tokens:
    the (2, 2) step is the no-mesh step over the whole batch (loss rtol
    1e-6, state atol 2e-5, as PR 30's data lanes)."""
    cfg = get_smoke("qwen3-14b")
    model = build_model(cfg)
    batch = dict(_batch(cfg))
    rng = np.random.default_rng(5)
    batch["loss_mask"] = (rng.random((8, 12)) < np.repeat([0.8, 0.35], 4)[:, None]) \
        .astype(np.float32)
    one = make_train_state(model, 0, device="cpu")
    _, want = make_train_step(model, _tcfg())(one, batch)
    state, (got,) = _run(model, _mesh(2, 2), batch, steps=1)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)
    for (name, s), (_, t) in zip(tree_flatten(state), tree_flatten(one)):
        np.testing.assert_allclose(s.full().float().numpy(), t.float().numpy(), rtol=0,
                                   atol=2e-5, err_msg=name)


def test_model_split_gradients_stay_in_their_pieces():
    """The accumulated gradient of a (2, 2) mesh: each model lane's pieces
    in f32 on the first group's lane, none of a split leaf whole."""
    cfg = get_smoke("granite-moe-1b-a400m")
    model = build_model(cfg)
    mesh = _mesh(2, 2)
    placed = _placed(model, make_train_state(model, 0, device="cpu"), mesh)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    _, grads = accumulate_grads(model, mesh_lanes(placed["params"], mesh), batch)
    assert len(grads) == 2
    params = dict(tree_flatten(placed["params"]))
    split = 0
    for lane, tree in enumerate(grads):
        for name, g in tree_flatten(tree):
            assert g.dtype == torch.float32
            assert tuple(g.shape) == tuple(params[name].pieces[lane].shape), name
            split += tuple(g.shape) != params[name].shape
    assert split == 2 * sum(1 for s in params.values() if not s.replicated) > 0


def test_one_capture_holds_every_lane_of_a_group(captured):
    """As on the card: a (1, 2) group on one device makes one capture, each
    launch one replay, bit for bit the eager steps; each lane launches its
    norms and its attention."""
    cfg = get_smoke("qwen3-14b")
    model = build_model(cfg)
    stream = _stream(cfg)
    mesh = _mesh(1, 2)
    placed = _placed(model, make_train_state(model, 2, device="cpu"), mesh)
    captured.state = {f"{n}/{k}": p for n, s in tree_flatten(placed)
                      for k, p in enumerate(s.pieces)}
    proc = TrainProcess(model, _tcfg(), mesh=mesh).init(placed, stream.batch_at(0))
    assert captured.events == ["capture"] and int(placed["opt"]["step"].pieces[0]) == 0
    eager = _placed(model, make_train_state(model, 2, device="cpu"), mesh)
    step = make_mesh_train_step(model, _tcfg(), mesh)
    for i in range(3):
        out, metrics = proc.launch(placed, stream.batch_at(i))
        eager, want = step(eager, stream.batch_at(i))
        assert out is placed and torch.equal(metrics["loss"], want["loss"])
    assert (proc.captures, proc.replays) == (1, 3)
    for (name, x), (_, y) in zip(tree_flatten(placed), tree_flatten(eager)):
        assert all(torch.equal(p, q) for p, q in zip(x.pieces, y.pieces)), name
    per_step = {"rmsnorm": 2 * (2 * (4 * cfg.n_layers) + 1), "flash_attention": 2 * 2 * cfg.n_layers}
    counts = launch_counts()
    # init's warm-up (the group's two lanes), each replay, the eager steps
    assert {k: counts[k] for k in per_step} == {k: (1 + 3 + 3) * v for k, v in per_step.items()}


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DECODERS + OTHERS)
def test_every_piece_is_its_rules_piece(arch):
    """On a (2, 2) mesh every parameter piece is the slice of the whole
    leaf that its partition rule gives the grid position (the pieces a
    ``sharded-v1`` checkpoint holds), and some leaves are split."""
    model = build_model(get_smoke(arch))
    mesh = _mesh(2, 2)
    state = make_train_state(model, 0, device="cpu")
    whole = dict(tree_flatten(state["params"]))
    placed = dict(tree_flatten(_placed(model, state, mesh)["params"]))
    specs = dict(tree_flatten(state_pspecs(model, state)["params"]))
    places = dict(tree_flatten(to_named(state_pspecs(model, state)["params"], mesh)))
    assert any("model" in s for s in specs.values())
    for n, s in placed.items():
        assert s.placement == places[n], n
        for k, piece in enumerate(s.pieces):
            assert torch.equal(piece, whole[n][s.slices(k)]), (n, k)
        if "model" in specs[n]:
            assert s.pieces[0].numel() < whole[n].numel(), n


def test_a_vocabulary_the_model_axis_does_not_divide_raises():
    model = build_model(get_smoke("qwen3-14b").scaled(vocab=129))
    state = make_train_state(model, 0, device="cpu")
    with pytest.raises(ValueError, match="does not split into 2 pieces"):
        TrainProcess(model, _tcfg(), mesh=_mesh(1, 2)).init(state, _batch(model.cfg))


# ---------------------------------------------------------------------------
# Trainer(mesh=) with a model axis
# ---------------------------------------------------------------------------

def _trainer(d, shape):
    cfg = TrainerConfig(total_steps=6, ckpt_dir=d, ckpt_interval=2, log_every=100, train=_tcfg())
    return Trainer(build_model(get_smoke("qwen3-14b")), cfg,
                   mesh=_mesh(*shape) if shape else None, device="cpu", log_fn=lambda _m: None)


def _full(leaf):
    return leaf.full() if isinstance(leaf, Sharded) else leaf


def test_trainer_on_a_model_axis_restarts_bit_for_bit_and_resumes_on_other_shapes():
    stream = _stream(get_smoke("qwen3-14b"))
    with tempfile.TemporaryDirectory() as d:
        a = _trainer(f"{d}/a", (2, 2)).fit(stream, 0)
        b = _trainer(f"{d}/b", (2, 2)).fit_with_restarts(stream, 0, failure_schedule=[3])
        for (name, x), (_, y) in zip(tree_flatten(a), tree_flatten(b)):
            assert all(torch.equal(p, q) for p, q in zip(x.pieces, y.pieces)), name
        for shape in ((4, 1), None):
            tr = _trainer(f"{d}/c{shape}", (2, 2))
            with pytest.raises(RuntimeError, match="simulated"):
                tr.fit(stream, 0, simulate_failure_at=3)
            c = _trainer(f"{d}/c{shape}", shape).fit(stream, 0)
            for (name, x), (_, y) in zip(tree_flatten(a), tree_flatten(c)):
                np.testing.assert_allclose(_full(y).float().numpy(), x.full().float().numpy(),
                                           rtol=0, atol=1e-6, err_msg=f"{name} onto {shape}")


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)])
def test_mesh_state_bytes_count_each_positions_pieces(shape):
    from repro_torch.launch.train import mesh_state_bytes
    from repro_torch.train import init_mesh_state
    model = build_model(get_smoke("deepseek-v2-lite-16b"))
    mesh = _mesh(*shape)
    state = init_mesh_state(model, 0, mesh, compress=True)
    held = [[0, 0] for _ in range(mesh.devices.size)]
    for name, s in tree_flatten(state):
        for k, p in enumerate(s.pieces):
            held[k][0 if name.startswith("['params']") else 1] += p.numel() * p.element_size()
    assert [tuple(h) for h in held] == mesh_state_bytes(model, mesh, compress=True)
