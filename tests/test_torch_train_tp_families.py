"""rwkv6-3b, zamba2-2.7b and whisper-large-v3 trained over a mesh's
``model`` axis on CPU lanes (``make_data_mesh([cpu] * n, model=m)``), at
SMOKE size, against the JAX package's GSPMD step and the port's own
no-mesh step; the machinery and the decoder family are in
``tests/test_torch_train_tp.py``.

* **Against the JAX package**: the subprocess of ``test_torch_train_tp.py``
  (:data:`~test_torch_train_tp._JAX_TP`) runs the reference's
  ``TrainProcess`` on an Auto ``(pod 1, data 2, model 2)`` and ``(1, 1,
  4)`` mesh of four forced host devices for the three families over
  :data:`DRAWS` of a CRC-32 ``KeyGen`` (whisper's SMOKE vocabulary of 128
  splits over 4, so it runs on both meshes).  The port's step from each
  draw's initial state: the first step's loss and lr within rtol 1e-5 and
  its grad_norm within the family's rtol of ``test_torch_train.py``'s
  ``STEP_BANDS`` (the packages' gradients already differ so: rwkv6 1e-3,
  zamba2 1e-4, whisper 1e-5); after one step every state piece within
  twice the family's ``FAMILY_GRAD_ATOL`` band x its leaf's max
  (``_assert_first_step``); after three, over the draws, the mean rms
  distance of the state from an f64 run of the port's no-mesh step at
  most 1.5x the reference's, and the second and third steps' loss and
  grad_norm judged the same way: their median relative distance from the
  f64 run's at most 1.5x the reference's, or 1e-5 (``lr`` within rtol
  1e-5 at every step).  After an Adam step the metrics carry the noise of
  elements at near-zero gradients, heavy-tailed over draws: on draws 0-5
  the port's own no-mesh step lies up to 8.8e-5 (loss) and 2.5e-2
  (grad_norm, rwkv6 draw 3) from the reference's mesh step, zamba2's
  grad_norm up to 2.3e-4; the model axis's step up to 2.6e-5 and 3.4e-3,
  and 2.9e-4.  The reference's mesh step runs for all three families on
  both meshes.
* **Against the port's no-mesh step** at ``model`` 2 and 4: the loss
  within rtol 1e-5, every lane's gradient piece within the family's band
  of the no-mesh gradient's slice (ssm 3e-4, hybrid 2e-5, encdec 1e-6 x
  the leaf's max |grad|, rtol 1e-4), one step's metrics within rtol 1e-5.
* ``(data 2, model 2)`` bit for bit ``(data 1, model 2)`` with
  ``microbatches=2``, every piece.
* **The redistributions**: Mamba2's ``in_proj`` products regrouped into
  each lane's ``z``, ``x``, ``B``, ``C`` and ``dt`` are the one-lane
  ``zxbcdt``'s columns bit for bit (and zamba2-2.7b's full-width cut:
  lane 0 holds all of ``z`` and 104 columns of ``xBC``); RWKV6's gathered
  LoRA weights give the one-lane streams and decay bit for bit.
* One capture holds every lane of a rwkv6 group (the recorder of
  ``tests/test_torch_train.py``): replays bit for bit the eager steps,
  each lane's ``wkv6`` on its heads counted.
* **Checkpoints**: ``Trainer(mesh=)`` over ``(2, 2)`` with a failure at
  step 3 ends bit for bit where an uninterrupted run does; its checkpoint
  and a ``sharded-v1`` one of the placed state are read by the JAX
  package byte for byte; the reference's ``sharded-v1`` checkpoint of its
  ``(1, 2, 2)`` whisper state restores onto the port's ``(2, 2)`` lanes,
  each piece the rule's, byte for byte.
"""
import tempfile

import numpy as np
import pytest
import torch

from repro.ckpt import restore_checkpoint as j_restore_checkpoint
from repro_torch.ckpt import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.arena import tree_flatten, tree_unflatten
from repro_torch.core.registry import launch_counts
from repro_torch.kernels import ref
from repro_torch.launch.mesh import Sharded
from repro_torch.models import build_model
from repro_torch.models import mamba2 as M2
from repro_torch.models import parallel as tp
from repro_torch.models import rwkv6 as R6
from repro_torch.train import (Trainer, TrainerConfig, TrainProcess, make_mesh_train_step,
                               make_train_state, state_pspecs, to_named)
from repro_torch.train.step import mesh_lanes, train_state_specs
from test_torch_train import STEP_BANDS, captured  # noqa: F401  (the capture recorder)
from test_torch_train_mesh import _of, _stream, _tcfg
from test_torch_train_tp import (_JAX_TP, SHAPES, _against_no_mesh, _batch, _mesh, _placed,
                                 _run, against_the_gspmd_step, run_jax)

CPU = torch.device("cpu")
ARCHS = ["rwkv6-3b", "zamba2-2.7b", "whisper-large-v3"]
DRAWS = tuple(range(6))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread for this module's SMOKE-size work, as in
    ``test_torch_train_tp.py``."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# against the JAX package's GSPMD step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_families(tmp_path_factory):
    """The reference's states and metrics of :data:`ARCHS` on the
    :data:`~test_torch_train_tp.SHAPES` meshes over :data:`DRAWS`, and its
    sharded checkpoint of whisper's (1, 2, 2) state after three steps of
    draw 0, from a subprocess."""
    d = tmp_path_factory.mktemp("jax_families")
    out = run_jax(_JAX_TP, ",".join(["whisper-large-v3", "rwkv6-3b", "zamba2-2.7b"]),
                  ",".join("x".join(map(str, s)) for s in SHAPES), ",".join(map(str, DRAWS)),
                  str(d / "ckpt"), timeout=900)
    return {**out, "ckpt": str(d / "ckpt")}


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_axis_matches_the_jax_gspmd_step_for_each_family(arch, shape, jax_families):
    family = get_smoke(arch).family
    against_the_gspmd_step(arch, shape, jax_families, DRAWS, norm_rtol=STEP_BANDS[family][0],
                           later_by_f64=True)


def test_a_jax_model_axis_checkpoint_restores_onto_the_port_lanes(jax_families):
    """The reference's sharded checkpoint of its (pod 1, data 2, model 2)
    whisper state, restored onto the port's (2, 2) lanes by
    ``state_pspecs``: every piece is its rule's piece of the reference's
    state, byte for byte."""
    arch = "whisper-large-v3"
    model = build_model(get_smoke(arch))
    mesh = _mesh(2, 2)
    like = make_train_state(model, 0, device="cpu")
    back = restore_checkpoint(jax_families["ckpt"], like,
                              shardings=to_named(state_pspecs(model, like), mesh))
    want = _of(jax_families, f"{arch}/1x2x2/0/step3")
    assert set(want) == {n for n, _ in tree_flatten(back)}
    for name, s in tree_flatten(back):
        assert isinstance(s, Sharded) and s.placement.mesh is mesh, name
        for k, piece in enumerate(s.pieces):
            assert piece.numpy().tobytes() == np.ascontiguousarray(
                want[name][s.slices(k)]).tobytes(), (name, k)


# ---------------------------------------------------------------------------
# against the port's own no-mesh step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradient_pieces_and_norm_match_the_no_mesh_step(arch, m):
    _against_no_mesh(get_smoke(arch), m)


@pytest.mark.parametrize("arch", ARCHS)
def test_two_groups_equal_one_group_with_two_microbatches_bit_for_bit(arch):
    cfg = get_smoke(arch)
    model = build_model(cfg)
    batch = _batch(cfg)
    a, ma = _run(model, _mesh(2, 2), batch)
    b, mb = _run(model, _mesh(1, 2), batch, microbatches=2)
    for x, y in zip(ma, mb):
        assert all(torch.equal(x[k], y[k]) for k in y)
    for (name, s), (_, t) in zip(tree_flatten(a), tree_flatten(b)):
        assert torch.equal(s.full(), t.full()), name
        for k, p in enumerate(s.pieces):
            assert torch.equal(p, s.full()[s.slices(k)]), (name, k)


# ---------------------------------------------------------------------------
# the redistributions
# ---------------------------------------------------------------------------

def _lanes(model, m, seed=0):
    """The one-lane parameters of ``model`` from ``seed``, a (1, m) group's
    lanes of them and the group."""
    mesh = _mesh(1, m)
    placed = _placed(model, make_train_state(model, seed, device="cpu"), mesh)["params"]
    (lanes, group), = mesh_lanes(placed, mesh)
    return make_train_state(model, seed, device="cpu")["params"], lanes, group


@pytest.mark.parametrize("m", [2, 4])
def test_mamba2_in_proj_regrouped_is_the_one_lane_zxbcdt(m):
    """Each lane's regrouped ``in_proj`` product is the one-lane product's
    columns of its heads' z, x, dt and the shared B and C, bit for bit;
    the backward hands each piece its columns' gradient summed over the
    lanes that read them (B and C: every lane)."""
    cfg = get_smoke("zamba2-2.7b")
    model = build_model(cfg)
    params, lanes, group = _lanes(model, m)
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator().manual_seed(3))
    w = params["mamba_layers"]["mamba"]["in_proj"][0, 1]
    pieces = [lane["mamba_layers"]["mamba"]["in_proj"][0, 1] for lane in lanes]
    whole = x @ w
    cols = M2.lane_columns(cfg, group)
    got = tp.regroup(group, [x @ p for p in pieces], cols)
    for lane, g in enumerate(got):
        want = torch.cat([whole[..., a:b] for a, b in cols[lane]], -1)
        assert torch.equal(g, want), lane
    pieces = [p.detach().double().requires_grad_(True) for p in
              (x @ q for q in pieces)]
    outs = tp.regroup(group, pieces, cols)
    gs = [torch.randn(o.shape, dtype=torch.float64, generator=torch.Generator().manual_seed(i))
          for i, o in enumerate(outs)]
    grads = torch.autograd.grad(outs, pieces, gs)
    want = torch.zeros(whole.shape, dtype=torch.float64)
    for g, ranges in zip(gs, cols):
        at = 0
        for a, b in ranges:
            want[..., a:b] += g[..., at:at + b - a]
            at += b - a
    torch.testing.assert_close(torch.cat(grads, -1), want, rtol=0, atol=0)


def test_mamba2_lane_columns_at_full_width():
    """zamba2-2.7b's ``in_proj`` is (2560, 10448): at model 2 its pieces cut
    at column 5224, so lane 0 holds all of z and the first 104 columns of
    xBC, lane 1 the rest and all 80 dt columns; each lane needs 5288."""
    cfg = get_config("zamba2-2.7b")
    group = tp.ModelGroup((CPU, CPU))
    cols = M2.lane_columns(cfg, group)
    assert M2.mamba2_specs(cfg)["in_proj"].shape == (2560, 10448)
    assert cols == [[(0, 2560), (5120, 7680), (10240, 10368), (10368, 10408)],
                    [(2560, 5120), (7680, 10240), (10240, 10368), (10408, 10448)]]
    assert [sum(b - a for a, b in c) for c in cols] == [5288, 5288]


@pytest.mark.parametrize("m", [2, 4])
def test_rwkv6_gathered_lora_gives_the_one_lane_streams(m):
    """The gathered LoRA weights give every lane the one-lane streams and
    decay bit for bit (tm_w1's pieces cut inside its 32-wide groups)."""
    cfg = get_smoke("rwkv6-3b")
    model = build_model(cfg)
    params, lanes, group = _lanes(model, m)
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator().manual_seed(4))
    sx = R6._shift(x) - x
    one = {k: v[1] for k, v in params["layers"]["tm"].items()}
    want = R6._streams(one, x, sx, one["tm_w1"], one["tm_w2"])
    want_w = R6._decay(one, want[:, :, 0], one["td_w1"], one["td_w2"])
    tm = [{k: v[1] for k, v in lane["layers"]["tm"].items()} for lane in lanes]
    assert tm[0]["tm_w1"].shape[-1] == 5 * R6.TM_LORA // m
    whole = {n: tp.gather(group, [t[n] for t in tm], dim) for n, dim in (
        ("tm_w1", -1), ("tm_w2", -1), ("td_w1", -1), ("td_w2", 0))}
    for lane in range(m):
        got = R6._streams(tm[lane], x, sx, whole["tm_w1"][lane], whole["tm_w2"][lane])
        assert torch.equal(got, want), lane
        assert torch.equal(R6._decay(tm[lane], got[:, :, 0], whole["td_w1"][lane],
                                     whole["td_w2"][lane]), want_w), lane


# ---------------------------------------------------------------------------
# the captured step
# ---------------------------------------------------------------------------

def test_one_capture_holds_every_lane_of_a_rwkv6_group(captured, monkeypatch):
    """A (1, 2) rwkv6 group on one device: one capture, each launch one
    replay, bit for bit the eager steps; each lane runs ``wkv6`` on its
    heads (``ref.wkv6`` counts a launch, as the kernel does) and the norms
    on the whole rows."""
    from repro_torch.core import registry
    heads = []

    def counted(r, *a, _plain=ref.wkv6, **kw):
        registry.count_launch("wkv6")
        heads.append(r.shape[2])
        return _plain(r, *a, **kw)

    monkeypatch.setattr(ref, "wkv6", counted)
    cfg = get_smoke("rwkv6-3b")
    model = build_model(cfg)
    stream = _stream(cfg)
    mesh = _mesh(1, 2)
    placed = _placed(model, make_train_state(model, 2, device="cpu"), mesh)
    captured.state = {f"{n}/{k}": p for n, s in tree_flatten(placed)
                      for k, p in enumerate(s.pieces)}
    proc = TrainProcess(model, _tcfg(), mesh=mesh).init(placed, stream.batch_at(0))
    assert captured.events == ["capture"]
    eager = _placed(model, make_train_state(model, 2, device="cpu"), mesh)
    step = make_mesh_train_step(model, _tcfg(), mesh)
    for i in range(3):
        out, metrics = proc.launch(placed, stream.batch_at(i))
        eager, want = step(eager, stream.batch_at(i))
        assert out is placed and torch.equal(metrics["loss"], want["loss"])
    assert (proc.captures, proc.replays) == (1, 3)
    for (name, x), (_, y) in zip(tree_flatten(placed), tree_flatten(eager)):
        assert all(torch.equal(p, q) for p, q in zip(x.pieces, y.pieces)), name
    # each lane: ln0 and the final norm, each layer's two norms and its
    # recurrence, the layers run twice (remat recomputes them)
    assert cfg.remat
    per_step = {"rmsnorm": 2 * (2 * 2 * cfg.n_layers + 2), "wkv6": 2 * 2 * cfg.n_layers}
    counts = launch_counts()
    assert {k: counts[k] for k in per_step} == {k: (1 + 3 + 3) * v for k, v in per_step.items()}
    assert set(heads) == {cfg.d_model // cfg.rwkv_head_dim // 2}


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _trainer(d, arch):
    cfg = TrainerConfig(total_steps=5, ckpt_dir=d, ckpt_interval=2, log_every=100, train=_tcfg())
    return Trainer(build_model(get_smoke(arch)), cfg, mesh=_mesh(2, 2), log_fn=lambda _m: None)


def test_trainer_restart_on_a_model_axis_and_its_checkpoints_in_the_jax_package():
    """zamba2 over (data 2, model 2): a failure at step 3 resumed on the
    same mesh ends bit for bit where an uninterrupted run does; the
    trainer's last checkpoint and a ``sharded-v1`` one of its placed state
    are the state's bytes in the JAX package's ``restore_checkpoint``."""
    arch = "zamba2-2.7b"
    stream = _stream(get_smoke(arch))
    model = build_model(get_smoke(arch))
    with tempfile.TemporaryDirectory() as d:
        a = _trainer(f"{d}/a", arch).fit(stream, 0)
        b = _trainer(f"{d}/b", arch).fit_with_restarts(stream, 0, failure_schedule=[3])
        for (name, x), (_, y) in zip(tree_flatten(a), tree_flatten(b)):
            assert all(torch.equal(p, q) for p, q in zip(x.pieces, y.pieces)), name
        save_checkpoint(f"{d}/sharded", 5, a, sharded=True)
        like = tree_unflatten((n, np.zeros(s.shape, s.dtype))
                              for n, s in tree_flatten(train_state_specs(model)))
        for path in (f"{d}/a", f"{d}/sharded"):
            named = dict(tree_flatten(j_restore_checkpoint(path, like)))
            for name, s in tree_flatten(a):
                got = np.asarray(named[name])
                want = s.full()
                want = (want.view(torch.int16).numpy() if want.dtype == torch.bfloat16
                        else want.numpy())
                assert got.view(want.dtype).tobytes() == want.tobytes(), (path, name)
