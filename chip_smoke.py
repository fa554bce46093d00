#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and builds the
   hand-written CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, all started together).
2. Holds every kernel against its plain PyTorch version on the card, at the
   paper's case-study size (16x8x160x160 complex64), an odd small shape, the
   C=64 wide-W regression shape, and for ``fused_recon`` shapes on both sides
   of its gate (inside it also a ragged 3x5x97x131 and 117 coils at
   256x256); then times kernel, plain version and one library call at the
   case-study size (CUDA events; device times from CUDA-graph replays over
   input copies that exceed L2, so inputs come from DRAM), and for
   ``fused_recon`` also the two-launch route (cuFFT + the fused epilogue
   kernel), its time at 33 frames against 16 (what limits it) and ptxas's
   registers, spills and shared memory of ``dft_recon_kernel``.  The
   batched maps form of ``complex_elementprod``, ``fused_epilogue`` and
   ``fused_recon`` (a stream's batch (B, F, C, H, W) with one map set a
   slice) at B = 8 x CONFIG and a ragged (3, 5, 3, 97, 131), one map set
   bit for bit the single-map call, and its times at B = 8.
3. Drives the main path through the user entry points (``CLapp`` ->
   ``KData``/``XData`` -> ``SimpleMRIRecon`` in modes staged / fused /
   fused_kernel, the §IV-B RSS variants, and a 384x384 matrix outside the
   fused kernel's gate), checks each result against a complex128 numpy
   oracle, and shows through the launch counts that every kernel ran.
   Each process is compiled (captured into a CUDA graph on its second
   launch, replayed after): each phase checks one capture and a replay
   for every later launch, then uploads a second k-space (the frames in
   reverse order) into the same input and checks the replays against its
   oracle, and prints the launch p50 beside the kernels' device time a
   launch (``torch.profiler`` over 10 replays).
   Then file in, file out (``[io]``): ``CONFIG``'s k-space and maps
   written to an npz (the maps first) and read with ``KData(path,
   variables=[k-space, maps])``, reconstructed in the three modes, each
   image saved with ``matlab_save`` and read back with ``np.load`` against
   the oracle, and a new k-space replayed and saved with ``SyncSource.AUTO``
   (which must sync the device copy first); wall ms of the load, the
   pinned upload, the launches, the device-to-host copy and the save.
   ``[join]``: the fan-in graph ``Pipeline.from_graph`` (the maps a second
   input edge) bit for bit against the single-arena and the aux-bound
   graphs, ``fuse=True`` within 1e-4, and 6 runs with new k-space and maps
   on runs 5-6, each against its oracle: 1 capture, replays on runs 2-6,
   no input blob moved; its launch p50 beside the linear graph's.
   ``[example]``: ``repro_torch.launch.mri_recon.main`` with ``--pipeline
   --join`` and ``--kernel --join``, each with ``--stream 16 --batch 8``
   (the demos' stream and serve parts run too).  ``[stream]``:
   ``SimpleMRIRecon.stream`` at ``CONFIG``, batch 8, 24 slices with their
   own maps (no tail), 19 (a tail of 3: a twin of its own) and 21 (a tail
   of 5: padded), in staged / fused / fused_kernel and fused_kernel RSS:
   each item against the sequential ``launch()`` (bit for bit in the kernel
   mode, rtol 1e-6 where cuFFT transforms a batch) and the oracle, kernel
   launches = batches, each twin captured once at its second launch and
   replayed after; wall ms a slice streamed beside sequential
   ``host2device`` + ``launch()``, and from a ``torch.profiler`` trace the
   kernels' device time a batch, the copy stream's GB/s, the share of
   upload time overlapping a kernel and the device's idle share.
   ``[serve]``: ``Pipeline.run(mode="serve")`` over the fan-in graph
   (shared maps bit for bit against the aux-bound graph; per-slice maps
   against the single-arena graph), then a ``PipelineServer(batch=4,
   flush_timeout=0.02)`` fed 10 requests from a second thread after
   ``warmup()``: p50/p99 latency, every response against its oracle, no
   capture in the worker thread.  ``[profile]``: the phases of profiled
   launches (``ProfileParameters``): 25 launches of each mode at ``CONFIG``,
   the k-space uploaded by the first (exactly 25 samples, one "compute" a
   stage a launch, one "transfer", no "compile"; each launch's "compute"
   between the kernels' device time from ``torch.profiler`` and its
   sample), beside 50 unprofiled replays; the 24-slice stream at batch 8
   on a new process (3 "transfer", 3 "compute", 1 "compile", then a second
   stream with no "compile") and the copy rate of its "transfer" phases
   beside ``[stream]``'s.  ``[mesh]`` (before ``[profile]``): the MRI path
   over the lanes of a mesh (``repro_torch.launch.mesh``).  Part 1 is the
   app over every visible card (one lane a card), part 2 a two-lane mesh
   on card 0 (``make_data_mesh([cuda:0, cuda:0])``) and a (data=1,
   model=2) mesh on card 0 whose lane splits the frames over the two.
   Each part streams 24 slices at batch 8 in staged, fused and
   fused_kernel mode with ``sharded=True``, ``split="proportional"`` and
   ``lanes=True`` beside the one-device stream, and serves 8 at batch 4:
   every output against the same slice's ``launch()`` on a one-card app
   (bit for bit in the kernel mode, rtol 1e-6 under cuFFT), each lane given
   rows must have launched every kernel of the path; wall ms a slice, the
   split vectors, twins and captures a lane, launches a lane and a device;
   ``CLapp.split`` replicas each run one launch.  ``[frontdoor]`` (after
   ``[serve]``): the control plane (``repro_torch.serve.FrontDoor``) in
   front of two ``PipelineReplica`` s of ``SimpleMRIRecon`` fused_kernel
   at ``CONFIG`` (``CLapp.split(2)`` of card 0 named twice, servers
   warmed before the FrontDoor starts): 48 requests over 24 k-spaces
   under each routing policy, bit for bit the direct server and within
   1e-4 of the oracle, both replicas serving, no twin captured in a
   worker thread, one ``dft_recon_kernel`` launch a batch; a fault
   injected into r1 requeued to r0 and r1 readmitted by its probe;
   overload (capacity 8, ``"shed"``, the replicas gated) sheds only batch
   work and a 1 ms deadline times out unlaunched; ``warm_start`` of new
   maps from a checkpoint.  Then two h2o-danube-1.8b ``LMServer``
   replicas at full width, each on its own split app of card 0, behind
   ``FrontDoor(policy="least-outstanding")``: 8 prompts of 17-1024
   tokens, first cold (each decode step captured in its replica's thread
   while the other replica runs), then warm (no capture); every request's
   tokens equal a lone server's.  Requests/s, p50/p99 by class and
   replica beside a direct server, the split and each replica's rate; one
   request in flight at a time, end to end, through the FrontDoor beside
   the direct server's and replica r0's own submit + drain from the main
   thread and from a worker thread, in turns, the FrontDoor's host time a
   request and a ``torch.profiler`` summary of r0's submit + drain in
   each thread; the ``frontdoor_requests_*`` metric lines.  Each of these phases counts its kernel launches from 0.
4. Holds the LM kernels (``rmsnorm``, ``flash_attention``) against their
   plain versions on the card (bf16 at rtol/atol 2e-2, f32 at rtol 1e-4 /
   atol 1e-5) at the qwen3-14b and rwkv6-3b serving shapes (the
   1000-token prefill for a ragged causal tail), at the whisper-large-v3
   encoder's (1, 20, 1500, 64) with ``causal=False`` in bf16 and in f32 (the
   FMA kernel at d 64, as the 2-layer f32 run reaches it) and a ragged
   causal decoder prefill (1, 20, 211, 64) bf16, at head dim 16 (the SMOKE
   configs', which ``repro_torch.launch.serve_lm`` serves on the card), at
   the minitron-8b, granite-moe-1b-a400m and deepseek-v2-lite-16b serving
   shapes (rmsnorm rows of 4096, 1024, 2048 and deepseek's 512-wide latent
   norm; flash_attention q (1, 32, S, 128) / kv (1, 8, S, 128) and q
   (1, 16, S, 64) / kv (1, 8, S, 64)), at the zamba2-2.7b and internvl2-2b
   ones (rmsnorm rows of 2560 and 2048; flash_attention (1, 32, S, 80)
   MHA, bf16 and f32, and q (1, 16, S, 128) / kv (1, 8, S, 128) with
   S = 256 patches + 64 tokens, bf16 and f32), and
   at odd ones that reach every rmsnorm variant; ``wkv6`` at the rwkv6-3b prefill (1, 1024, 40,
   64) bf16, ragged cases (several batches on the grid and a T that is no
   multiple of the staged tile), the SMOKE head size, the decode shape with
   its state written in place (bf16 and f32) and a decode step from a zero
   state; and ``negate`` bit for bit (a misaligned view, sizes one element
   either side of a whole batch of vectors, in place too).  Times them at
   the serving shapes (rmsnorm at the prefill, decode and q/k-norm shapes;
   flash_attention at the qwen3-14b prefill and at the whisper encoder
   shape, non-causal) beside ``F.rms_norm``,
   ``F.scaled_dot_product_attention`` and ``torch.rsub`` (yardsticks only;
   no single PyTorch call computes the wkv6 recurrence), times wkv6 at 1
   and 4 prefill batches (what limits it), prints ptxas's registers, spills and shared memory for the
   flash_attention, rmsnorm, wkv6 and negate kernels, and times each step
   of the rmsnorm wrapper's host path at the decode shape against
   ``F.rms_norm``.  ``[chooser]``: ``KernelChooser.calibrate`` for every
   registered kernel at those shapes (t_kernel, t_plain, the bound from the
   kernel's cost model and its verdict; a calibration inside a capture must
   raise), then the MRI path under ``"auto"``, counting its launches.
5. Serves qwen3-14b, then rwkv6-3b, at full width (random bf16 weights
   made on the card from a seed) through ``LMServer``: 10 requests of
   17-1024 prompt tokens, 4 slots, 32 new tokens each; checks the tokens,
   that every kernel of the model ran on every prefill and step, and that
   the decode state never moved host to device; the decode step is
   captured once and replayed on every later step; ``[profile]``: the
   decode profile holds one "compute" a step and a slot release and no
   "transfer", the prefill profile the JAX LMServer's counts.  Then two more requests
   repeat the first prompt (a prompt length seen before): their first
   token must be the first request's, and no prefill, splice or release
   may have been captured.  After each, runs the
   first 2 layers of the same weights on the card (in bf16 and in f32) and
   on a CPU app in f32, and compares the logits; then runs those 2 layers
   through ``DecodeSession`` for 32 eager and 32 replayed decode steps from
   the same prefilled state and checks that the tokens are identical and
   the decode state bit for bit (or, where cuBLAS chose otherwise under
   capture, the logits within the bands of ``PERF.md`` §2).
   Then serves whisper-large-v3 at full width (random bf16 weights made on
   the card) through ``LMServer(batch=4, max_len=448, enc_len=1500)``: 10
   requests of 4-224 prompt tokens, each with its own (1500, 1280) f32
   frames, 32 new tokens each; checks the tokens, ``flash_attention``
   launched 64 times an admission (32 encoder and 32 decoder prefill
   layers) and never in a decode step, the decode state never moved host to
   device, the decode step captured once and replayed after (it reads each
   slot's spliced cross K/V); the first request twice more (its prompt and
   frames) must start with its first token; every prefill pipe reads the
   server's one frames Data, uploaded once an admission.  Then 2 encoder
   and 2 decoder layers of the same weights on the card (bf16, f32)
   against a CPU app (f32) within the bands of ``PERF.md`` §2, and
   ``DecodeSession(enc_len=1500)``, whose prefill is the fan-in graph
   frames -> ``WhisperEncode`` ~ tokens -> ``WhisperPrefill`` on the
   ``enc`` edge: 32 eager against 32 replayed decode steps.
   Then serves minitron-8b (dense, squared ReLU, half rotary),
   granite-moe-1b-a400m (MoE, top-8 of 32 experts) and deepseek-v2-lite-16b
   (MLA attention, top-6 of 64 routed experts plus 2 shared, a dense layer
   0) the same way as qwen3-14b, each after the weights of the one before
   are freed; the 2-layer cut of deepseek is layer 0 and one stacked layer.
   For the MoE pair the 2-layer check also runs the CPU in bf16 (its own
   bf16 gap printed beside the card's) and prints the share of (token, k)
   router choices that differ from the CPU f32 run's in each run.
   Then zamba2-2.7b (hybrid: 54 Mamba2 layers, one shared attention block
   every 6) and internvl2-2b (vlm, served text-only as the JAX
   ``LMServer`` serves it) the same way; the "2-layer" cut of zamba2 is one
   superblock (the shared block and 6 Mamba2 layers; the CPU also in bf16,
   its gap printed), and internvl2's 2-layer check prefills a (1, 256,
   2048) f32 patch prefix from the seed before its 64 tokens and decodes
   at positions 320 + i.
5t. Training (``[train-kernels]``, ``[train]``, ``[train-ckpt]``): the
   hand-written backward kernels ``rmsnorm_bwd`` and
   ``flash_attention_bwd`` against autograd through the plain versions
   (bf16 within 2e-2 x max |grad|, f32 within rtol 1e-4 + 1e-5 x max
   |grad|), each run twice bit for bit, at the h2o-danube-1.8b training
   shapes ((4, 32, 2048, 80) / (4, 8, 2048, 80), window 4096; rows of
   2560), the window active at (1, 32, 5120, 80) and at (1, 32, 333, 80)
   / kv 8, window 100 (ragged at the bf16 kernels' 64-row tiles),
   qwen3-14b's (1, 40, 1024, 128) / kv 8 and q/k-norm rows of 128,
   lm-100m's f32 (8, 12, 256, 64) / kv 4 and rows of 768, head dim 16,
   non-causal cases and 20 rows that see no key (dq 0, nothing added to dk, dv); the forward with its
   log-sum-exp writes the output bit for bit as without; times against
   bound and library call (SDPA's backward with ``enable_gqa``,
   ``F.rms_norm``'s backward, with one host call of each beside the
   kernel's) and ptxas's registers, spills and shared
   memory of the bf16 tensor-core kernels (``flash_bwd_delta_kernel``,
   ``flash_bwd_mma_dkdv_kernel``, ``flash_bwd_mma_dq_kernel``) and the f32
   FMA ones.  The flash backward also at whisper-large-v3's encoder (8, 20,
   1500, 64) non-causal and decoder (8, 20, 448, 64) and zamba2-2.7b's
   shared block (4, 32, 2048, 80) MHA.  ``wkv6_bwd`` (with the training
   forward's state checkpoints, whose output and final state must be the
   serving forward's bit for bit) at the rwkv6-3b training shape (4, 2048,
   40, 64) bf16, a ragged bf16 case with a state and a final-state
   gradient, f32 at head sizes 64 and 8, and w + 7 (every decay 0 in f32:
   dw exactly 0, every gradient finite) in bf16 and f32, against autograd
   through ``ref.wkv6`` in the same bands, twice bit for bit; its max
   |err| beside the plain version's own bf16 gap; its time against bound
   and plain version (no library call computes it), the checkpointing
   forward's beside it with the checkpoints' bytes; ptxas of its kernels
   (``wkv6_bwd_contrib_kernel``, ``wkv6_bwd_scan_kernel``,
   ``wkv6_bwd_chunk_kernel`` with its dynamic shared memory,
   ``wkv6_bwd_du_kernel``) and of the checkpointing forward.  AdamW's two
   kernels (``optim_kernels.cu``, :func:`adamw_checks`): the update bit for
   bit the plain ``update_leaf`` given the same scalars (bf16 and f32
   parameters at 1, 7, 2560, 6,553,600 and 81,920,000 elements, a piece at
   an odd offset, an f32 gradient of bf16 parameters, no clip; a tensor
   that is not is named and held to 1 ulp), each leaf's sum of squares
   within 1e-6 of a float64 one (a piece at an odd offset among them), the
   clip's norm the same bits over two replays of a captured norm and
   within 1e-6 of a float64 one; one step at danube's full-width leaves
   against the plain step, every leaf of it updated bit for bit the plain
   version and its sum of squares within 1e-6, the bytes bound and
   ``torch._fused_adamw_`` (:func:`adamw_times`).  The optimizer's
   launches (an ``adamw_update`` a leaf, ``sum_squares`` a leaf and one)
   join the exact counts of every training run below.  Then h2o-danube-1.8b at full width (random bf16 weights made
   on the card from a seed): 6 ``Trainer`` steps at batch 4 x 2048 on the
   ``TokenStream`` (the loss falls; 1 capture, 6 replays; exact launch
   counts of init's warm-up and each step: forward, remat recompute and
   backward of both kernels), step p50 over 5 more replays, tokens/s, MFU,
   peak memory, a ``torch.profiler`` breakdown of one replayed step and
   AdamW alone; a 2-layer full-width cut's loss and every gradient leaf
   on the card (f32, then bf16) against the CPU's f32 within ``PERF.md``
   §2's bands; the bf16 cut's 3 steps replayed through ``TrainProcess``
   bit for bit 3 eager ``make_train_step`` steps (batch 1 x 256), with
   exact launch counts that stay out of the ``{"kernels"}`` line's.  The
   same for rwkv6-3b and zamba2-2.7b at batch 4 x 2048 and
   whisper-large-v3 at batch 8 x 448 tokens with 1500 frames a sample (4
   steps, p50 over 3 replays; MFU from the parameters each token or frame
   passes through), their cuts 2 layers, one superblock, and 2 encoder +
   2 decoder layers, the CPU also in bf16: where its own gap exceeds the
   danube bf16 band, the card's band is twice that gap.  Then
   ``repro_torch.launch.train_lm`` (lm-100m, f32) for 40
   steps into a temporary directory (the loss improves), 10 steps with a
   failure at step 6 and a checkpoint every 4 bit for bit an
   uninterrupted 10, and those 10 replayed steps bit for bit 10 eager
   ones.  Then ``[mesh-lm]``, the LM stack over the lanes of a mesh that
   names card 0 twice: qwen3-14b served over a (data 1, model 2) group
   (the decode slots in two strips, one graph; tokens against ``[lm]``'s
   with the flips counted, the strips' logits within the bf16 band),
   h2o-danube-1.8b trained at full width over 2 data lanes (ZeRO-1
   pieces; bit for bit a one-lane ``microbatches=2`` step after 2 steps,
   exact launches, the loss falls over 4; p50, tokens/s, MFU, peak, piece
   bytes), and lm-100m over 2 lanes (a sharded save restored onto 2 lanes
   without and onto one with a gather, a restart, all bit for bit); with
   more than one visible card, lm-100m and qwen3-14b over every card too.
   Then ``[mesh-tp]``, training over a mesh's model axis on card 0:
   h2o-danube-1.8b at full width over a (data 1, model 2) group (the
   group's gradient against the no-mesh one in PERF.md's bands, 5
   replayed steps bit for bit 5 eager ones, exact launches of each lane's
   norms and heads, each lane's bytes against ``mesh_state_bytes``, p50,
   tokens/s, MFU, peak), lm-100m over a (1, 2) group (a restart bit for
   bit), and an f32 cut of deepseek-v2-lite-16b (layer 0 and two MoE
   layers, 32 experts and 8 MLA heads a lane) on a (data 2, model 2) grid
   against the no-mesh step (m and v within 1e-4 x max, no router choice
   moved).
5d. ``[dryrun]`` (after ``[mesh-tp]``): the port's dry run
   (``repro_torch.launch.dryrun``, a trace on ``meta`` tensors, on the
   host) of qwen3-14b x train_4k, deepseek-v2-lite-16b x decode_32k and
   zamba2-2.7b x long_500k on the (16, 16) production mesh: each one's
   memory a card, roofline terms at the H100's data-sheet rates and the
   trace's seconds.  Then h2o-danube-1.8b's train step at ``[train]``'s
   batch 4 x 2048 dry-run on a one-lane mesh and run eagerly on the card
   (``make_train_step``, random bf16 weights from a seed) under the same
   counting mode: its flops and bytes must equal the trace's exactly, and
   the card's peak (its arguments plus ``torch.cuda.max_memory_allocated``
   above what was allocated before it) over the trace's arguments + temp
   must lie in :data:`DRYRUN_PEAK_BAND`; the eager step's p50 (3 steps,
   no counting) beside the roofline's ``t_bound``.
6. Runs the paper's listing 1 (``repro_torch.launch.quickstart``:
   ``Pipeline(app) | Negate(app)`` on a 256x256 8-bit PNG that the script
   writes) on the card, replayed from its second run, bit for bit, and
   reads its ``output.png`` back: 1 - x in 8 bits.  Temporary files live in
   a ``tempfile`` directory that the script removes.
7. Ends with a ``{"kernels": [...]}`` line (the LM kernels' launches are
   the sums over the eight serves, the five training runs,
   ``[mesh-lm]`` and ``[mesh-tp]``; the backward kernels', over the training runs; their ``replaces`` names the forward
   kernel's ``pallas_call``, since the JAX package has no backward kernel)
   and a
   ``{"ok": true, "device": {...}}`` line.

``[wall]`` lines give the seconds since the start at each phase's end and,
in each LM serve, after the serve and after its card-against-CPU check:
where the script's own time goes.  Any failure exits non-zero.  Without a
CUDA device it exits non-zero at once.
"""
from __future__ import annotations

import gc
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = "src/repro_torch/kernels/csrc/mri_kernels.cu"
LM_SRC = "src/repro_torch/kernels/csrc/lm_kernels.cu"
RWKV_SRC = "src/repro_torch/kernels/csrc/rwkv_kernels.cu"
OPTIM_SRC = "src/repro_torch/kernels/csrc/optim_kernels.cu"
NEG_SRC = "src/repro_torch/kernels/csrc/negate_kernels.cu"

#: the card's peak over the dry run's arguments + temp for the same step
#: (``[dryrun]``): allocator rounding and the kernels' scratch, which the
#: trace leaves out, may only add a little
DRYRUN_PEAK_BAND = (0.95, 1.10)


def dryrun_phase(dev, smi, wall) -> None:
    """[dryrun]: see the module docstring (5d)."""
    import torch
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.core.arena import tree_flatten
    from repro_torch.launch.dryrun import meta_mesh, run_cell
    from repro_torch.launch.roofline import CostMode
    from repro_torch.models import build_model
    from repro_torch.train import TrainConfig, make_train_state, make_train_step

    for arch, shape in (("qwen3-14b", "train_4k"), ("deepseek-v2-lite-16b", "decode_32k"),
                        ("zamba2-2.7b", "long_500k")):
        rec = run_cell(arch, shape, verbose=False)
        mem, roof = rec["memory"], rec["roofline"]
        card = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        print(f"[dryrun] {arch} x {shape} on the (16, 16) production mesh (meta, traced in "
              f"{rec['compile_s']} s on the host): a card holds arguments "
              f"{mem['argument_size_in_bytes'] / 2**30:.3f} GiB + temp "
              f"{mem['temp_size_in_bytes'] / 2**30:.3f} GiB = {card / 2**30:.3f} GiB "
              f"({'fits' if card < 80e9 else 'does not fit'} 80 GB); flops "
              f"{roof['flops_per_chip']:.4e}, bytes {roof['hbm_bytes_per_chip']:.4e}, "
              f"collectives {roof['coll_breakdown']}; roofline at the H100 SXM's data-sheet "
              f"rates: compute {roof['t_compute_s'] * 1e3:.3f} ms, memory "
              f"{roof['t_memory_s'] * 1e3:.3f} ms, collective {roof['t_collective_s'] * 1e3:.3f}"
              f" ms -> {roof['bottleneck']}-bound, mfu_bound {roof['mfu_bound']:.4f} "
              f"({rec['note']})")
    wall("after [dryrun]'s production cells")

    arch, batch, seq = "h2o-danube-1.8b", 4, 2048
    cfg = get_config(arch)
    rec = run_cell(arch, ShapeSpec("train_2k", "train", seq, batch), mesh=meta_mesh((1, 1)),
                   microbatches=1, verbose=False)
    mem, roof = rec["memory"], rec["roofline"]
    traced = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    model = build_model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    state = make_train_state(model, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    data = {k: torch.randint(0, cfg.vocab, (batch, seq), device=dev, dtype=torch.int32,
                             generator=gen) for k in ("tokens", "labels")}
    step = make_train_step(model, TrainConfig())
    args = sum(t.numel() * t.element_size()
               for t in [leaf for _, leaf in tree_flatten(state)] + list(data.values()))
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with CostMode() as counted:
        step(state, data)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - before + args
    got = counted.total()
    want = {"flops": roof["flops_per_chip"], "bytes accessed": roof["hbm_bytes_per_chip"]}
    ratio = peak / traced
    print(f"[dryrun] {smi}: {arch} train step at batch {batch} x {seq} (bf16, one lane): the "
          f"card counted flops {got['flops']:.6e}, bytes {got['bytes accessed']:.6e}; the "
          f"meta trace {want['flops']:.6e}, {want['bytes accessed']:.6e} "
          f"({'equal' if got == want else 'DIFFERENT'}); kernels counted "
          f"{ {k: int(v[0]) for k, v in counted.kernels.items()} }; peak {peak / 2**30:.3f} GiB "
          f"(arguments {args / 2**30:.3f} GiB + max_memory_allocated above the "
          f"{before / 2**30:.3f} GiB before) against the trace's "
          f"{traced / 2**30:.3f} GiB (arguments {mem['argument_size_in_bytes'] / 2**30:.3f} + "
          f"temp {mem['temp_size_in_bytes'] / 2**30:.3f}): ratio {ratio:.4f}, band "
          f"{DRYRUN_PEAK_BAND}")
    if got != want:
        raise SystemExit(f"chip_smoke: [dryrun] the card's step counted {got}, the meta "
                         f"trace {want}")
    if not DRYRUN_PEAK_BAND[0] <= ratio <= DRYRUN_PEAK_BAND[1]:
        raise SystemExit(f"chip_smoke: [dryrun] the card's peak over the trace's is {ratio:.4f}, "
                         f"outside {DRYRUN_PEAK_BAND}")
    times = []
    for _ in range(3):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        step(state, data)
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    p50 = statistics.median(times)
    bound_ms = max(roof["t_compute_s"], roof["t_memory_s"], roof["t_collective_s"]) * 1e3
    print(f"[dryrun] {smi}: {arch} eager step p50 {p50:.2f} ms over 3 (each "
          f"{', '.join(f'{t:.2f}' for t in times)} ms) against the roofline's t_bound "
          f"{bound_ms:.2f} ms ({roof['bottleneck']}-bound: compute "
          f"{roof['t_compute_s'] * 1e3:.2f}, memory {roof['t_memory_s'] * 1e3:.2f} ms at the "
          f"data sheet's 989 TFLOP/s bf16 and 3.35 TB/s): {p50 / bound_ms:.2f}x")
    del state, data, step
    gc.collect()
    torch.cuda.empty_cache()
    wall("after [dryrun]")


def ptxas_usage(log: str, *fragments: str) -> tuple[int | None, int | None, int | None]:
    """(registers a thread, static shared bytes a block, spill-store bytes)
    that ptxas reported in ``log`` for the first kernel whose mangled name
    holds every one of ``fragments``."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and all(f in line for f in fragments):
            spill = None
            for nxt in lines[i + 1:]:
                st = re.search(r"(\d+) bytes spill stores", nxt)
                if st:
                    spill = int(st.group(1))
                m = re.search(r"Used (\d+) registers", nxt)
                if m:
                    smem = re.search(r"(\d+) bytes smem", nxt)
                    return int(m.group(1)), int(smem.group(1)) if smem else 0, spill
    return None, None, None


# The training measurements below are shared with scripts/train_step_p50.py,
# which runs them on whichever ``repro_torch`` comes first on ``sys.path``
# (so one call can time two trees, each in a fresh process).

def wkv6_bwd_smem(d: int, bf16: bool, chunk: int = 32) -> int:
    """Dynamic shared memory bytes of ``wkv6_bwd_chunk_kernel`` (its
    ``WkvBwdLayout``: r, k, v, do rows padded to d + 8 (bf16) or d + 4;
    decays; S0 and G_end, later the groups' dk and dlambda partials; two
    (C, d + 8) product tiles; K~, later B's warp partials; do v^T; the
    per-row and per-step sums; the tiles' prefix products; exp(w)), each
    region rounded up to 16 bytes."""
    def r16(x):
        return (x + 15) // 16 * 16

    c, tiles = chunk, chunk // 8
    groups, rw = tiles // 2, min(d, 32)
    staged = 4 * r16(c * (d + 8 if bf16 else d + 4) * (2 if bf16 else 4))
    return (staged + r16(c * d * 4) + r16(max(2 * d * (d + 4), 2 * groups * c * d) * 4)
            + 2 * r16(c * (d + 8) * 4) + r16(max(c * (d + 4), d // rw * c * c) * 4)
            + r16(c * (c + 8) * 4) + 2 * r16(d * 4) + r16(c * 4) + r16(tiles * d * 4)
            + r16(c * d * 4))


def loop_ms(fn, reps: int = 5) -> float:
    """Device time of one call: CUDA events around ``reps`` calls in a
    row after two warm-up calls (calls of a millisecond or more, so the
    host's launches hide behind the device's work)."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def backward_times(rand) -> dict:
    """Device ms a call of the two backward kernels at the h2o-danube-1.8b
    training shapes, each beside one PyTorch call computing the same
    function on the same inputs (``rand(*shape, dtype=...)`` makes them):
    ``rmsnorm_bwd`` at x (8192, 2560) bf16 against ``F.rms_norm``'s
    backward; ``flash_attention_bwd`` at a layer (q (4, 32, 2048, 80), k
    and v (4, 8, 2048, 80), bf16, causal, window 4096, with the forward's
    output and log-sum-exp) against SDPA's backward (``enable_gqa``).
    Returns the four times and the two kernels' arguments."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import _forward, flash_attention_bwd
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd

    bf16 = torch.bfloat16
    x, w, dy = rand(4 * 2048, 2560, dtype=bf16), rand(2560, dtype=bf16), \
        rand(4 * 2048, 2560, dtype=bf16)
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y_lib = F.rms_norm(xg, (2560,), wg, 1e-6)
    out = {"rmsnorm_bwd_ms": loop_ms(lambda: rmsnorm_bwd(x, w, dy), reps=50),
           "rms_norm_backward_ms": loop_ms(
               lambda: torch.autograd.grad(y_lib, (xg, wg), dy, retain_graph=True), reps=20)}
    del xg, wg, y_lib
    q, k, v = rand(4, 32, 2048, 80, dtype=bf16), rand(4, 8, 2048, 80, dtype=bf16), \
        rand(4, 8, 2048, 80, dtype=bf16)
    do = rand(4, 32, 2048, 80, dtype=bf16)
    o, lse = _forward(q, k, v, True, 4096, 80 ** -0.5, True)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
    out["flash_attention_bwd_ms"] = loop_ms(
        lambda: flash_attention_bwd(q, k, v, o, do, lse, causal=True, window=4096))
    out["sdpa_backward_ms"] = loop_ms(
        lambda: torch.autograd.grad(o_lib, (qg, kg, vg), do, retain_graph=True))
    out["rmsnorm_args"], out["flash_args"] = (x, w, dy), (q, k, v, o, do, lse)
    return out


def wkv6_bwd_times(rand) -> dict:
    """Device ms a call of ``wkv6_bwd`` at a rwkv6-3b layer ((4, 2048, 40,
    64) bf16 r/k/v and output gradient, f32 w, no state; ``rand(*shape,
    dtype=...)`` makes them) with the training forward's state
    checkpoints, beside the training forward (which writes them) and the
    serving forward on the same inputs; the checkpoints' bytes.  Returns
    the times, the bytes and the backward's arguments."""
    import torch
    from repro_torch.kernels.wkv6 import _forward, wkv6, wkv6_bwd

    bf16, shape = torch.bfloat16, (4, 2048, 40, 64)
    r, k, v = (rand(*shape, dtype=bf16) for _ in range(3))
    w, u, do = rand(*shape) * 0.5, rand(40, 64) * 0.5, rand(*shape, dtype=bf16)
    _, _, ckpt = _forward(r, k, v, w, u, None, None, with_ckpt=True)
    return {"wkv6_bwd_ms": loop_ms(lambda: wkv6_bwd(r, k, v, w, u, None, do, ckpt=ckpt), reps=20),
            "wkv6_train_forward_ms": loop_ms(
                lambda: _forward(r, k, v, w, u, None, None, with_ckpt=True), reps=20),
            "wkv6_serve_forward_ms": loop_ms(lambda: wkv6(r, k, v, w, u), reps=20),
            "ckpt_bytes": ckpt.numel() * ckpt.element_size(),
            "wkv6_args": (r, k, v, w, u, do, ckpt)}


def optimizer_launches(model) -> dict:
    """Launches of the optimizer's kernels a training step makes on one
    card: an ``adamw_update`` a parameter leaf, and ``sum_squares``' partial
    pass a leaf and its one final pass."""
    from repro_torch.core.arena import tree_flatten
    n = len(tree_flatten(model.param_specs()))
    return {"adamw_update": n, "sum_squares": n + 1}


#: the lengths the AdamW kernel is held to bit for bit at: 1, 7 (the scalar
#: tail alone), a norm scale (2560), one layer's square projection (2560 x
#: 2560) and the embedding (32000 x 2560); danube's stacked leaves (157M to
#: 425M elements) are compared in :func:`adamw_times`
ADAMW_LENGTHS = (1, 7, 2560, 6_553_600, 81_920_000)


def compare_update(label: str, kern, plain, worst: dict) -> float:
    """The kernel's p, master, m and v (``kern``) against the plain
    update's (``plain``): each tensor's largest distance in ulps goes into
    ``worst``; a tensor that is not bit for bit is named, and one more than
    1 ulp off stops the run.  Returns the largest |kernel - plain|."""
    import torch

    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    err = 0.0
    for name, a, b in zip(("p", "master", "m", "v"), kern, plain):
        ulps = int((a.view(ints[a.dtype]).long() - b.view(ints[b.dtype]).long()).abs().max())
        err = max(err, float((a.float() - b.float()).abs().max()))
        worst[name] = max(worst[name], ulps)
        if ulps:
            print(f"[train-kernels] {label}: {name} NOT bit for bit, "
                  f"{int((a != b).sum())} elements differ, by at most {ulps} ulp")
        if ulps > 1:
            raise SystemExit(f"chip_smoke: [train-kernels] {label}: {name} differs from "
                             f"the plain version by {ulps} ulp")
    return err


def check_sum_squares(label: str, g) -> float:
    """``sum_squares``' kernel on one piece against a float64 sum of its
    squares: the relative gap, held to 1e-6."""
    from repro_torch.optim import adamw as opt

    want = float(g.double().square().sum())
    got = float(opt._sum_squares_kernel([g]))
    gap = abs(got - want) / want
    if gap > 1e-6:
        raise SystemExit(f"chip_smoke: [train-kernels] sum_squares of {label} ({g.numel()} "
                         f"{g.dtype}): {got!r} against the float64 {want!r}, {gap:.3e} of it "
                         "(limit 1e-6)")
    return gap


def adamw_checks(dev, smi: str) -> dict:
    """[train-kernels] AdamW's two kernels against their plain versions on
    the card (``optim/adamw.py``): the update (``_update_leaf_kernel``)
    against ``_update_leaf_plain`` given the same scalars, bit for bit in
    master, m, v and the parameter (:func:`compare_update`), for bf16 and
    f32 parameters at :data:`ADAMW_LENGTHS`, a piece at an odd element
    offset (every pointer misaligned: the scalar-load variant), an f32
    gradient beside bf16 parameters (the int8 compression's) and no clip
    (the scale a Python 1.0).  The clip's norm (``global_norm`` through
    ``sum_squares``) over a tree of danube-sized leaves and odd ones, one
    piece at an odd element offset (the scalar-load variant): each leaf's
    sum of squares within 1e-6 of a float64 sum of it
    (:func:`check_sum_squares`), and the norm captured into a CUDA graph:
    two replays give the same bits, an eager call gives them too, and it
    lies within 1e-6 of a float64 norm.  Returns the largest ulp distance
    of each tensor, the largest |kernel - plain|, and the largest leaf's
    and the norm's relative gaps."""
    import torch
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim import adamw as opt

    bf16, f32 = torch.bfloat16, torch.float32
    cfg = AdamWConfig(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    gen = torch.Generator(device=dev).manual_seed(7)

    def randn(n, std, dtype=f32):
        return (torch.randn(n, generator=gen, device=dev) * std).to(dtype)

    step = torch.full((), 3.0, device=dev)
    scalars = {"scale": torch.full((), 0.37, device=dev), "lr": torch.full((), 3e-4, device=dev),
               "c1": 1.0 - torch.pow(cfg.b1, step), "c2": 1.0 - torch.pow(cfg.b2, step)}
    worst = {k: 0 for k in ("p", "master", "m", "v")}
    err = 0.0
    unclipped = {**scalars, "scale": 1.0}      # no clip: the scale a Python 1.0
    cases = [(dt, dt, n, 0, scalars) for dt in (bf16, f32) for n in ADAMW_LENGTHS]
    cases += [(bf16, bf16, 6_553_600 - 5, 3, scalars), (f32, f32, 6_553_600 - 5, 3, scalars),
              (bf16, f32, 2560 * 7, 0, scalars), (bf16, bf16, 2560 * 7, 0, unclipped)]
    for p_dt, g_dt, n, off, sc in cases:
        p0 = randn(n + off, 0.02, p_dt)
        bases = [p0, p0.float() + randn(n + off, 1e-5), randn(n + off, 1e-4),
                 randn(n + off, 1e-4).square()]
        g = randn(n + off, 1e-3, g_dt)[off:]
        kern = [t.clone()[off:] for t in bases]
        plain = [t.clone()[off:] for t in bases]
        opt._update_leaf_kernel(*kern[:2], g, *kern[2:], sc, cfg)
        opt._update_leaf_plain(*plain[:2], g, *plain[2:], sc, cfg)
        torch.cuda.synchronize(dev)
        label = (f"adamw_update {n} {p_dt} parameters, {g_dt} gradient, offset {off}"
                 f"{'' if sc is scalars else ', no clip'}")
        err = max(err, compare_update(label, kern, plain, worst))
        del p0, bases, g, kern, plain
    print(f"[train-kernels] {smi}: adamw_update against the plain update_leaf, same scalars, "
          f"{len(cases)} cases (bf16 and f32 at {ADAMW_LENGTHS}, offset 3, f32 gradient of "
          f"bf16 parameters, no clip): largest ulp distance {worst}, largest |kernel - plain| "
          f"{err!r}{' (bit for bit)' if not any(worst.values()) else ''}")
    torch.cuda.empty_cache()

    # the norm: danube's leaf sizes (the embedding, a projection, an MLP
    # matrix, a norm scale) in bf16, odd f32 leaves, and a bf16 piece that
    # starts 3 elements into its buffer
    tree = {f"l{i}": randn(n, std, dt) for i, (n, std, dt) in enumerate(
        ((81_920_000, 1e-4, bf16), (6_553_600, 3e-3, bf16), (17_694_720, 1e-3, bf16),
         (2560, 1.0, bf16), (7, 2.0, f32), (100_003, 1e-2, f32)))}
    tree["odd"] = randn(1_000_003 + 3, 1e-2, bf16)[3:]
    leaf_gap = max(check_sum_squares(f"leaf {k}", t) for k, t in tree.items())
    eager = opt.global_norm(tree)
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = opt.global_norm(tree)
    runs = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize(dev)
        runs.append(captured.clone())
    want = float(sum(t.double().square().sum() for t in tree.values())) ** 0.5
    gap = abs(float(runs[0]) - want) / want
    same = all(torch.equal(r.view(torch.int32), eager.view(torch.int32)) for r in runs)
    print(f"[train-kernels] {smi}: sum_squares leaf by leaf against float64 over {len(tree)} "
          f"leaves (one at element offset 3): largest gap {leaf_gap:.3e} of the leaf's sum "
          f"(limit 1e-6); global_norm over them ({sum(t.numel() for t in tree.values())} "
          f"elements), captured: two replays and an eager call "
          f"{'bit for bit' if same else 'DIFFER'} ({float(runs[0])!r}); against the float64 "
          f"norm {want!r}: {gap:.3e} of it (limit 1e-6)")
    if not same or gap > 1e-6:
        raise SystemExit("chip_smoke: [train-kernels] the clip's norm is not deterministic "
                         "or not within 1e-6 of the float64 norm")
    del graph, captured, runs, tree, eager
    torch.cuda.empty_cache()
    return {"ulps": worst, "max_abs_err": err, "leaf_gap": leaf_gap, "norm_gap": gap}


def adamw_times(dev, peaks: dict) -> dict:
    """One eager AdamW step (``adamw_update``: the clip's norm, the
    scalars, an update a leaf) at h2o-danube-1.8b's full-width leaves in
    bf16, built and timed by ``scripts/adamw_time.py``'s functions (the
    ``danube.train`` cell's AdamW): device ms of the kernels' step; the
    same step through the plain versions (``_update_leaf_plain``,
    ``_sum_squares_plain`` swapped in for the kernels); then, given one
    step's scalars, each leaf updated by the kernel and by the plain
    version from the same state, compared bit for bit
    (:func:`compare_update`), and each leaf's gradient's sum of squares
    against a float64 sum (:func:`check_sum_squares`);
    ``torch._fused_adamw_`` on the f32 master, an f32 copy of the gradient,
    m and v as a library yardstick (no clip, no cast: the port never calls
    it); the launches of one step; and the bound of the step's bytes at
    ``peaks``."""
    import importlib.util

    import torch
    from repro_torch.core.arena import tree_flatten
    from repro_torch.core.registry import launch_counts, reset_launch_counts
    from repro_torch.optim import adamw as opt
    from repro_torch.optim import adamw_update

    spec = importlib.util.spec_from_file_location("adamw_time",
                                                  ROOT / "scripts" / "adamw_time.py")
    at = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(at)
    params, grads, state = at.danube_state(dev)
    cfg = at.CFG
    bound_ms = at.bound_ms(params, grads, state, peaks)

    def step():
        adamw_update(params, grads, state, cfg)
    step()
    torch.cuda.synchronize(dev)
    reset_launch_counts()
    step()
    torch.cuda.synchronize(dev)
    launches = {k: v for k, v in launch_counts().items() if v}
    kernel_ms = statistics.median(at.step_ms(step))
    swapped = {"_update_leaf_kernel": opt._update_leaf_plain,
               "_sum_squares_kernel": opt._sum_squares_plain}
    saved = {k: getattr(opt, k) for k in swapped}
    for k, fn in swapped.items():
        setattr(opt, k, fn)
    try:
        plain_ms = statistics.median(at.step_ms(step))
    finally:
        for k, fn in saved.items():
            setattr(opt, k, fn)

    # every leaf, kernel against plain from the same state (the moments no
    # longer 0 after the timed steps), given the same scalars
    sc = opt.adamw_scalars(state["step"], grads, cfg)
    flat = [dict(tree_flatten(t)) for t in (params, state["master"], grads, state["m"],
                                            state["v"])]
    worst = {k: 0 for k in ("p", "master", "m", "v")}
    err = leaf_gap = 0.0
    for name in flat[0]:
        p, w, g, m, v = (t[name] for t in flat)
        plain = [t.clone() for t in (p, w, m, v)]
        opt._update_leaf_kernel(p, w, g, m, v, sc, cfg)
        opt._update_leaf_plain(plain[0], plain[1], g, plain[2], plain[3], sc, cfg)
        torch.cuda.synchronize(dev)
        label = f"danube's leaf {name} ({g.numel()} elements)"
        err = max(err, compare_update(f"adamw_update at {label}", [p, w, m, v], plain, worst))
        del plain
        leaf_gap = max(leaf_gap, check_sum_squares(label, g))
        torch.cuda.empty_cache()

    masters = list(flat[1].values())
    g32 = [g.float() for g in flat[2].values()]
    ms_, vs_ = list(flat[3].values()), list(flat[4].values())
    steps = [torch.ones((), dtype=torch.float32, device=dev) for _ in masters]
    library_ms = statistics.median(at.step_ms(lambda: torch._fused_adamw_(
        masters, g32, ms_, vs_, [], steps, lr=1e-5, beta1=0.9, beta2=0.95, weight_decay=0.1,
        eps=1e-8, amsgrad=False, maximize=False)))
    out = {"elements": sum(g.numel() for g in flat[2].values()), "leaves": len(flat[0]),
           "steps": at.STEPS,
           "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "launches": launches, "ulps": worst, "max_abs_err": err,
           "leaf_gap": leaf_gap}
    del g32, steps, masters, ms_, vs_, flat, params, grads, state
    torch.cuda.empty_cache()
    return out


def per_step_launches(cfg) -> dict:
    """Launches of each kernel a training step makes: the forward, its
    remat recompute (every norm and kernel inside a checkpointed layer or
    superblock runs twice) and the backward."""
    if cfg.family == "ssm":        # rwkv6: ln1, ln2 a layer; ln0 and the final norm outside
        n = cfg.n_layers
        return {"rmsnorm": 2 * 2 * n + 2, "rmsnorm_bwd": 2 * n + 2, "wkv6": 2 * n,
                "wkv6_bwd": n}
    if cfg.family == "hybrid":     # zamba2: the shared block's 2 norms and each Mamba2 layer's
        n_super = cfg.n_layers // cfg.attn_every
        inner = 2 * n_super + cfg.n_layers
        return {"rmsnorm": 2 * inner + 1, "rmsnorm_bwd": inner + 1,
                "flash_attention": 2 * n_super, "flash_attention_bwd": n_super}
    if cfg.family == "encdec":     # whisper: LayerNorms are plain; one self-attention a layer
        n = cfg.enc_layers + cfg.dec_layers
        return {"flash_attention": 2 * n, "flash_attention_bwd": n}
    norms = 4 if cfg.qk_norm else 2                    # a decoder layer's rmsnorm calls
    return {"rmsnorm": 2 * norms * cfg.n_layers + 1, "flash_attention": 2 * cfg.n_layers,
            "rmsnorm_bwd": norms * cfg.n_layers + 1, "flash_attention_bwd": cfg.n_layers}


def model_flops(cfg, specs, batch: int, seq: int, frames: int = 0) -> tuple[float, str]:
    """(flops of one training step, its formula): 6 x the parameters a
    token passes through x the tokens.  For zamba2 the shared block counts
    once a superblock (it runs n_super times); for whisper the encoder's
    parameters (and the decoder's cross K/V projections, which read the
    encoder states) count against the frames, the rest of the decoder's
    (learned positions left out: a lookup) against the decoder tokens."""
    n_of = {name: int(np.prod(spec.shape)) for name, spec in specs}
    total = sum(n_of.values())
    if cfg.family == "hybrid":
        n_super = cfg.n_layers // cfg.attn_every
        shared = sum(n for k, n in n_of.items() if k.startswith("['shared']"))
        eff = total + (n_super - 1) * shared
        return (6.0 * eff * batch * seq,
                f"6 x (N + {n_super - 1} x the shared block's {shared}) = 6 x {eff} x "
                f"{batch * seq} tokens")
    if cfg.family == "encdec":
        on_frames = sum(n for k, n in n_of.items()
                        if k.startswith(("['enc_layers']", "['enc_norm']"))
                        or k.endswith(("['cross_attn']['w_k']", "['cross_attn']['w_v']")))
        on_tokens = total - on_frames - n_of["['pos_dec']"]
        return (6.0 * (on_frames * batch * frames + on_tokens * batch * seq),
                f"6 x ({on_frames} encoder and cross K/V parameters x {batch * frames} frames "
                f"+ {on_tokens} decoder parameters x {batch * seq} tokens)")
    return 6.0 * total * batch * seq, f"6 N tokens = 6 x {total} x {batch * seq}"


def step_ms_by_kind(run) -> tuple[dict, dict]:
    """(device ms by kind of kernel, the "other" kind's ms by kernel name)
    of ``run()`` (one replayed training step) under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    buckets: dict = {}
    other: dict = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0.0))
        nm = ev.key.lower()
        if t <= 0 or nm.startswith(("cudagraph", "memcpy", "memset")):
            continue
        kind = ("flash backward" if "flash_bwd" in nm else
                "flash forward" if "flash_mma" in nm or "flash_fma" in nm else
                "rmsnorm backward" if "rmsnorm_bwd" in nm or "rmsnorm_dw" in nm else
                "rmsnorm forward" if "rmsnorm" in nm else
                "wkv6 backward" if "wkv6_bwd" in nm else
                "wkv6 forward" if "wkv6" in nm else
                "AdamW (update and the clip's sum of squares)" if "adamw_update" in nm
                or "sumsq_" in nm else
                "GEMMs" if any(s in nm for s in ("gemm", "xmma", "cutlass", "cublas",
                                                 "nvjet", "sm90_", "ampere")) else
                "other (elementwise and reductions: AdamW's scalars, casts, the embedding, "
                "the loss, plain-torch norms and Mamba2's SSD)")
        buckets[kind] = buckets.get(kind, 0.0) + t / 1e3
        if kind.startswith("other"):
            other[ev.key[:60]] = t / 1e3
    return buckets, other


def print_by_kind(label: str, buckets: dict, other: dict) -> None:
    """One line of :func:`step_ms_by_kind`'s kinds, largest first, and the
    eight largest kernels of the "other" kind."""
    total = sum(buckets.values())
    print(f"{label}, torch.profiler device ms by kind: "
          + "; ".join(f"{k} {v:.2f} ({v / total:.3f})" for k, v in
                      sorted(buckets.items(), key=lambda kv: -kv[1]))
          + f"; total {total:.2f}; the largest of the other kinds: "
          + "; ".join(f"{k} {v:.2f}" for k, v in sorted(other.items(),
                                                        key=lambda kv: -kv[1])[:8]))


def fit_and_time(arch: str, dev, peaks: dict, steps: int = 6, batch: int = 4,
                 seq: int = 2048, reps: int = 5, enc_frames: int = 0) -> dict:
    """``arch`` at full width, random bf16 weights made on the card from
    seed 0: ``steps`` Trainer steps at batch x seq on the TokenStream of
    its family (an encoder-decoder's batches carry ``enc_frames`` frames a
    sample; AdamW, constant lr 1e-5; init's warm-up and capture included),
    with their launch counts and peak memory; then ``reps`` more replayed
    steps, each between two CUDA events (the batch's upload included):
    their p50, tokens/s and MFU (:func:`model_flops` against ``peaks``'
    bf16 tensor rate); then one replayed step under ``torch.profiler``, its
    device ms by kind of kernel."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.arena import tree_flatten
    from repro_torch.core.registry import launch_counts, reset_launch_counts
    from repro_torch.data.pipeline import StreamConfig, TokenStream
    from repro_torch.launch.train import check_fits
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, Schedule
    from repro_torch.train import TrainConfig, Trainer, TrainerConfig

    cfg = get_config(arch)
    check_fits(cfg, dev)
    model = build_model(cfg)
    specs = tree_flatten(model.param_specs())
    n_params = sum(int(np.prod(s.shape)) for _, s in specs)
    flops, flops_txt = model_flops(cfg, specs, batch, seq, enc_frames)
    kind = "encdec" if cfg.family == "encdec" else "lm"
    stream = TokenStream(StreamConfig(vocab=cfg.vocab, seq=seq, batch=batch, seed=0, kind=kind,
                                      d_model=cfg.d_model, enc_frames=enc_frames))
    tcfg = TrainerConfig(total_steps=steps, log_every=1, train=TrainConfig(
        opt=AdamWConfig(schedule=Schedule(kind="constant", base_lr=1e-5, warmup_steps=0))))
    trainer = Trainer(model, tcfg, device=dev, log_fn=lambda _msg: None)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    state = trainer.fit(stream, 0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = {k: v for k, v in launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated(dev)
    proc = trainer.process
    captures, replays = proc.captures, proc.replays
    step_ms = []
    for i in range(reps):
        batch_i = stream.batch_at(steps + i)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        proc.launch(state, batch_i)
        e1.record()
        e1.synchronize()
        step_ms.append(e0.elapsed_time(e1))
    p50 = statistics.median(step_ms)
    tokens = batch * seq
    buckets, other = step_ms_by_kind(lambda: proc.launch(state, stream.batch_at(steps + reps)))
    return {"cfg": cfg, "stream": stream, "tcfg": tcfg, "trainer": trainer, "state": state,
            "n_params": n_params, "fit_s": fit_s, "counts": counts, "captures": captures,
            "replays": replays, "peak": peak,
            "losses": [loss for _, loss in trainer.history], "step_ms": step_ms,
            "step_p50_ms": p50, "tokens_per_s": tokens / p50 * 1e3,
            "model_flops": flops, "flops_formula": flops_txt,
            "mfu": flops / (p50 * 1e-3) / peaks["bf16_tensor"],
            "buckets": buckets, "other": other}


def frontdoor_phase(dev, smi, cfg, stack, oracle, wall, get_config) -> dict:
    """[frontdoor]: ``repro_torch.serve.FrontDoor`` in front of replicas on
    ``dev`` (see the module docstring); ``stack`` holds (k-space, maps) per
    slice, ``oracle(k, maps)`` the complex128 reference.  Fails on any
    check; returns the LM part's kernel launches (the main path's)."""
    import tempfile
    import threading

    import torch

    from repro_torch.ckpt import save_checkpoint
    from repro_torch.core import CLapp, Data, DeviceTraits, DeviceType, KData, Pipeline
    from repro_torch.core.registry import launch_counts
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.models import build_model
    from repro_torch.processes import FusedMRIRecon, SimpleMRIRecon
    from repro_torch.processes.lm import weights_data
    from repro_torch.serve import (CallableReplica, FrontDoor, LMServer, PipelineReplica,
                                   PriorityClass, SamplingConfig)

    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def one_device_app():
        return CLapp().init(device_traits=DeviceTraits(index=dev.index or 0) if cuda
                            else DeviceTraits(type=DeviceType.CPU))

    def split_apps(n):
        root = one_device_app()
        root.set_mesh(make_data_mesh([dev] * n))
        return root.split(n)

    def fail(msg):
        raise SystemExit(f"chip_smoke: [frontdoor] {msg}")

    def pct(xs, q):
        return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else float("nan")

    def kd(i):
        return KData({"kdata": stack[i][0], "sensitivity_maps": stack[i][1]})

    reference = {}

    def oracle_of(k, maps):               # the stack's arrays: one oracle each pair
        key = (id(k), id(maps))
        if key not in reference:
            reference[key] = oracle(k, maps)
        return reference[key]

    def fused(counts):
        return counts.get("mriFusedRecon", 0)

    n_k, n_req = len(stack), 2 * len(stack)
    classes = ["interactive" if i % 3 == 0 else "batch" for i in range(n_req)]

    # -- the direct server: each k-space's result, and the burst beside ---------
    app = one_device_app()
    direct = (Pipeline(app) | SimpleMRIRecon(app, mode="fused_kernel")).serve(batch=4)
    direct.warmup(kd(0))
    rids = [direct.submit(kd(i)) for i in range(n_k)]
    by_rid = {r.rid: r.data.device_view("xdata").clone() for r in direct.drain()}
    want = [by_rid[r] for r in rids]
    for i, w in enumerate(want):
        np.testing.assert_allclose(w.cpu().numpy(), oracle_of(*stack[i]), rtol=1e-4, atol=1e-4,
                                   err_msg=f"[frontdoor] direct server, k-space {i}")
    sync()
    t0 = time.perf_counter()
    for i in range(n_req):
        direct.submit(kd(i % n_k))
    resp = direct.drain()
    sync()
    direct_s = time.perf_counter() - t0
    direct_lat = [r.latency_s * 1e3 for r in resp]

    # -- two replicas on card 0 named twice ------------------------------------
    processed = {}                        # id(payload) -> (replica, seconds of its batch)
    gate = threading.Event()              # closed only in the overload part
    gate.set()
    waiting = []                          # replicas that reached the closed gate

    def replica(i, a):
        server = (Pipeline(a) | SimpleMRIRecon(a, mode="fused_kernel")).serve(batch=4)
        server.warmup(kd(0))
        rep = PipelineReplica(f"r{i}", server, probe_request=kd(0))
        plain = rep.process

        def process(payloads):
            if not gate.is_set():
                waiting.append(rep.name)
                gate.wait()
            t = time.perf_counter()
            out = plain(payloads)
            dt = time.perf_counter() - t
            for p in payloads:
                processed[id(p)] = (rep.name, dt)
            return out
        rep.process = process
        return rep

    reps = [replica(i, a) for i, a in enumerate(split_apps(2))]
    captures = {r.name: {k: bp.captures for k, bp in r.server._plan.twins.items()}
                for r in reps}

    def check_ok(outs, fids, idx, label):
        for fid, i in zip(fids, idx):
            o = outs.get(fid)
            if o is None or o.status != "ok":
                fail(f"{label}: request {fid} ended as {o}")
            got = o.result.device_view("xdata")
            if not torch.equal(got, want[i]):
                fail(f"{label}: request {fid} (k-space {i}) is not bit for bit the direct "
                     f"server's (max diff {float((got - want[i]).abs().max()):.3e})")
            np.testing.assert_allclose(got.cpu().numpy(), oracle_of(*stack[i]), rtol=1e-4,
                                       atol=1e-4, err_msg=f"[frontdoor] {label} {fid}")

    def launches_a_batch(before, label):
        batches = sum(r.server.launches for r in reps) - before[1]
        got = fused(launch_counts()) - before[0]
        if got != batches:
            fail(f"{label}: {got} dft_recon_kernel launches for {batches} batches")
        return batches

    def mark():
        return fused(launch_counts()), sum(r.server.launches for r in reps)

    for policy in ("round-robin", "least-outstanding", "profile"):
        fd = FrontDoor(reps, capacity=64, policy=policy)
        before = mark()
        sync()
        t0 = time.perf_counter()
        payloads = [kd(i % n_k) for i in range(n_req)]
        fids = [fd.submit(p, priority=c) for p, c in zip(payloads, classes)]
        outs = {o.rid: o for o in fd.drain(timeout=300.0)}
        sync()
        total_s = time.perf_counter() - t0
        check_ok(outs, fids, [i % n_k for i in range(n_req)], policy)
        batches = launches_a_batch(before, policy)
        split = {r.name: sum(1 for o in outs.values() if o.replica == r.name) for r in reps}
        if min(split.values()) == 0:
            fail(f"{policy}: the split {split} left a replica idle")
        lat = {c: [o.latency_s * 1e3 for o in outs.values() if o.priority == c]
               for c in ("interactive", "batch")}
        by_rep = {n: [o.latency_s * 1e3 for o in outs.values() if o.replica == n] for n in split}
        print(f"[frontdoor] {smi}: MRI {cfg} fused_kernel, policy {policy}: {n_req} requests "
              f"over {n_k} k-spaces ({n_req // 3} interactive) through 2 PipelineReplicas "
              f"(batch 4) in {total_s * 1e3:.1f} ms = {n_req / total_s:.1f} requests/s "
              f"(the direct server {n_req / direct_s:.1f}: p50 {pct(direct_lat, 50):.2f}, "
              f"p99 {pct(direct_lat, 99):.2f} ms); p50/p99 ms interactive "
              f"{pct(lat['interactive'], 50):.2f}/{pct(lat['interactive'], 99):.2f}, batch "
              f"{pct(lat['batch'], 50):.2f}/{pct(lat['batch'], 99):.2f}; by replica "
              + ", ".join(f"{n} {pct(v, 50):.2f}/{pct(v, 99):.2f}" for n, v in by_rep.items())
              + f"; split {split}, rates (items/s) "
              + ", ".join(f"{r.name} {r.rate:.1f}" for r in reps)
              + f"; {batches} batches, one dft_recon_kernel launch each; every result bit "
              "for bit the direct server's and within 1e-4 of the oracle")
        fd.close()
    after = {r.name: {k: bp.captures for k, bp in r.server._plan.twins.items()} for r in reps}
    if after != captures:
        fail(f"twins captured in a worker thread: {captures} -> {after}")

    # -- one request in flight: the FrontDoor end to end beside direct calls -----
    # The same request's submit (its host snapshot) + drain (upload, launch,
    # synchronize), each on the host clock, four ways in turns (A B C D D C
    # B A): the direct server and replica r0 from the main thread, r0 from
    # a plain worker thread, and r0 behind a FrontDoor (fd.submit to
    # fd.collect's return), whose latency less r0's process time is the
    # FrontDoor's host time.
    def submit_drain(server, p):
        t0 = time.perf_counter()
        server.submit(p)
        t1 = time.perf_counter()
        server.drain()
        return (t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3

    def in_thread(fn):
        box = {}
        t = threading.Thread(target=lambda: box.setdefault("out", fn()))
        t.start()
        t.join()
        return box["out"]

    fd = FrontDoor(reps[:1], capacity=64)
    host_us = []

    def through_door(p):
        t0 = time.perf_counter()
        rid = fd.submit(p)
        (o,) = fd.collect(1, timeout=60.0)
        e2e = (time.perf_counter() - t0) * 1e3
        if o.rid != rid or o.status != "ok":
            fail(f"one at a time: request {rid} ended as {o}")
        host_us.append((o.latency_s - processed[id(p)][1]) * 1e6)
        return processed[id(p)][1] * 1e3, e2e

    ways = {"direct, main thread": lambda p: submit_drain(direct, p),
            "r0, main thread": lambda p: submit_drain(reps[0].server, p),
            "r0, a worker thread": None,
            "r0 behind the FrontDoor": through_door}
    seen = {w: [] for w in ways}

    def turn(way, idx):
        if ways[way] is None:
            return in_thread(lambda: [submit_drain(reps[0].server, kd(i)) for i in idx])
        return [ways[way](kd(i)) for i in idx]
    for way in ways:                          # a first pass of each, not kept
        turn(way, range(4))
    host_us.clear()
    half = n_k // 2
    for k, way in enumerate(list(ways) + list(ways)[::-1]):
        seen[way] += turn(way, range(half) if k < len(ways) else range(half, n_k))
    fd.close()
    e2e = {w: pct([t for _, t in v], 50) for w, v in seen.items()}
    print(f"[frontdoor] {smi}: one request in flight at a time, {n_k} requests each way, in "
          "turns: p50 (p99) ms end to end "
          + ", ".join(f"{w} {e2e[w]:.3f} ({pct([t for _, t in v], 99):.3f})"
                      for w, v in seen.items())
          + "; of which the process (submit + drain; r0 behind the FrontDoor: in its worker "
          f"thread) p50 {pct([t for t, _ in seen['r0 behind the FrontDoor']], 50):.3f} and "
          f"the submit (a {sum(a.nbytes for a in stack[0]) / 1e6:.2f} MB host snapshot) p50 "
          + ", ".join(f"{w} {pct([t for t, _ in v], 50):.3f}" for w, v in seen.items()
                      if w != "r0 behind the FrontDoor")
          + f"; the FrontDoor's host time (latency less r0's process) p50 "
          f"{pct(host_us, 50):.1f} us, p99 {pct(host_us, 99):.1f} us; end to end the "
          f"FrontDoor adds {e2e['r0 behind the FrontDoor'] - e2e['r0, a worker thread']:.3f} "
          f"ms to r0 in a worker thread, "
          f"{e2e['r0 behind the FrontDoor'] - e2e['direct, main thread']:.3f} ms to the "
          "direct server")

    # a profile of r0's submit + drain, 4 requests a turn, in the main thread
    # and in a worker thread, in turns (main, worker, worker, main)
    from torch.profiler import ProfilerActivity, profile

    def profiled():
        with profile(activities=[ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda) as prof:
            for i in range(4):
                submit_drain(reps[0].server, kd(i))
        return {e.key: e.self_cpu_time_total for e in prof.key_averages()
                if e.key != "Activity Buffer Request"}      # the profiler's own
    where = {"the main thread": [], "a worker thread": []}
    for w in ("the main thread", "a worker thread", "a worker thread", "the main thread"):
        where[w].append(profiled() if w == "the main thread" else in_thread(profiled))
    for w, profs in where.items():
        us = {k: sum(p.get(k, 0.0) for p in profs) / (4e3 * len(profs))
              for k in set().union(*profs)}
        top = sorted(us.items(), key=lambda kv: -kv[1])[:6]
        print(f"[frontdoor] {smi}: torch.profiler, r0's submit + drain in {w}, ms a request "
              f"(2 turns of 4): self CPU {sum(us.values()):.3f}; the most: "
              + ", ".join(f"{k} {v:.3f}" for k, v in top))

    # -- a fault in r1: requeued to r0, r1 readmitted by its probe ----------------
    plan = reps[1].server._plan

    def boom(items):
        raise RuntimeError("injected launch failure")
    plan.stack_group = boom
    fd = FrontDoor(reps, capacity=64, policy="round-robin", probe_interval_s=0.02,
                   max_retries=2)
    fids = [fd.submit(kd(i)) for i in range(12)]
    outs = {o.rid: o for o in fd.drain(timeout=120.0)}
    check_ok(outs, fids, range(12), "fault")
    requeued = fd.metrics.counter("frontdoor_requests_requeued_total").value()
    down = fd.health()["replicas"]["r1"]
    if requeued < 1 or down["healthy"] or "injected" not in (down["last_error"] or ""):
        fail(f"fault: requeued {requeued}, r1 {down}")
    served_by = sorted({o.replica for o in outs.values()})
    del plan.stack_group
    deadline = time.perf_counter() + 60.0
    while not reps[1].healthy and time.perf_counter() < deadline:
        time.sleep(0.005)
    if not reps[1].healthy:
        fail("fault: r1's probe never readmitted it")
    fids = [fd.submit(kd(i)) for i in range(8)]
    outs2 = {o.rid: o for o in fd.drain(timeout=120.0)}
    check_ok(outs2, fids, range(8), "after the fault")
    if "r1" not in {o.replica for o in outs2.values()}:
        fail("after the fault: r1 served nothing")
    fault_lines = [ln for ln in fd.metrics.render().splitlines()
                   if ln.startswith("frontdoor_requests_")]
    fd.close()
    print(f"[frontdoor] {smi}: fault in r1 (stack_group raises): 12 requests all ok, served "
          f"by {served_by}, {requeued:.0f} requeued; r1 readmitted by its probe and serving "
          f"again (8 more ok, {sum(o.replica == 'r1' for o in outs2.values())} on r1)")
    for ln in fault_lines:
        print(f"[frontdoor] {ln}")

    # -- overload: capacity 8, "shed", the replicas gated --------------------------
    gate.clear()
    fd = FrontDoor(reps, capacity=8, overflow="shed", policy="least-outstanding",
                   classes=[PriorityClass("interactive", 0), PriorityClass("rt", 1, 0.001),
                            PriorityClass("batch", 2)])
    before = mark()
    plugs = [fd.submit(kd(i), priority="interactive") for i in range(2)]

    def settle(pred, what):
        deadline = time.perf_counter() + 30.0
        while not pred():
            if time.perf_counter() > deadline:
                fail(f"overload: timed out waiting for {what}")
            time.sleep(0.002)
    settle(lambda: sorted(waiting) == ["r0", "r1"], "each replica to hold a plug at the gate")
    fill = [fd.submit(kd(2 + i), priority="batch") for i in range(8)]
    settle(lambda: fd.queue_depth == 0 and all(len(fd._inboxes[r.name]) == r.max_batch
                                               for r in reps),
           "the 8 fill requests to fill both inboxes")
    rt_payload = kd(10)
    t_rt = time.perf_counter()
    rt = fd.submit(rt_payload, priority="rt")
    queued = [fd.submit(kd(11 + i), priority="batch") for i in range(7)]
    urgent = [fd.submit(kd(18 + i), priority="interactive") for i in range(4)]
    while time.perf_counter() < t_rt + 0.002:
        time.sleep(0.0005)                # the rt request's deadline passes queued
    gate.set()
    outs = {o.rid: o for o in fd.drain(timeout=120.0)}
    m = fd.metrics
    shed = {c: m.counter("frontdoor_requests_shed_total").value(**{"class": c})
            for c in ("interactive", "rt", "batch")}
    timed_out = m.counter("frontdoor_requests_timed_out_total").value(**{"class": "rt"})
    statuses = [outs[f].status for f in queued]
    if (outs[rt].status != "timed_out" or timed_out != 1 or shed != {"interactive": 0,
                                                                      "rt": 0, "batch": 4}
            or statuses != ["shed"] * 4 + ["ok"] * 3 or id(rt_payload) in processed):
        fail(f"overload: rt {outs[rt].status}, shed {shed}, timed out {timed_out}, queued "
             f"batch {statuses}, rt launched {id(rt_payload) in processed}")
    check_ok(outs, plugs + fill + queued[4:] + urgent,
             [0, 1] + list(range(2, 10)) + list(range(15, 18)) + list(range(18, 22)),
             "overload")
    batches = launches_a_batch(before, "overload")
    overload_lines = [ln for ln in m.render().splitlines()
                      if ln.startswith("frontdoor_requests_")]
    fd.close()
    print(f"[frontdoor] {smi}: overload (capacity 8, shed, both replicas gated with a plug "
          f"in service and 4 ahead each, then 8 queued and 4 interactive): 4 batch requests shed, no interactive one; the rt request "
          f"(1 ms deadline) timed out and never reached a replica; {batches} batches, one "
          "dft_recon_kernel launch each; the rest ok, bit for bit")
    for ln in overload_lines:
        print(f"[frontdoor] {ln}")

    # -- warm_start: new maps from a checkpoint into a running replica ------------
    a = one_device_app()
    maps = Data({"sensitivity_maps": stack[0][1]})
    proc = FusedMRIRecon(a)
    server = (Pipeline(a) | proc.bind(smaps=maps)).serve(batch=4)
    server.warmup(Data({"kdata": stack[0][0]}))
    rep = PipelineReplica("w", server)
    caps = {k: bp.captures for k, bp in server._plan.twins.items()}
    fd = FrontDoor([rep], capacity=16)
    fids = [fd.submit(Data({"kdata": stack[i][0]})) for i in range(4)]
    outs = {o.rid: o for o in fd.drain(timeout=60.0)}
    for fid, i in zip(fids, range(4)):
        np.testing.assert_allclose(outs[fid].result.device_view("xdata").cpu().numpy(),
                                   oracle_of(stack[i][0], stack[0][1]), rtol=1e-4, atol=1e-4,
                                   err_msg=f"[frontdoor] warm_start, before, {i}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_warm_") as d:
        save_checkpoint(d, 5, {"sensitivity_maps": stack[1][1]}, sharded=True)
        step = rep.warm_start(d, proc.in_handles["smaps"])
    fids = [fd.submit(Data({"kdata": stack[i][0]})) for i in range(4)]
    outs = {o.rid: o for o in fd.drain(timeout=60.0)}
    for fid, i in zip(fids, range(4)):
        np.testing.assert_allclose(outs[fid].result.device_view("xdata").cpu().numpy(),
                                   oracle_of(stack[i][0], stack[1][1]), rtol=1e-4, atol=1e-4,
                                   err_msg=f"[frontdoor] warm_start, after, {i}")
    fd.close()
    if step != 5 or {k: bp.captures for k, bp in server._plan.twins.items()} != caps:
        fail(f"warm_start: step {step}, captures {caps} -> "
             f"{ {k: bp.captures for k, bp in server._plan.twins.items()} }")
    print(f"[frontdoor] {smi}: warm_start restored step {step} (a sharded-v1 checkpoint of "
          "new maps) into a running replica's bound maps: the next 4 results within 1e-4 of "
          "the new maps' oracle, no new capture")
    wall("after [frontdoor] MRI")

    # -- LM: two LMServer replicas at full width on card 0 --------------------------
    lm_arch, max_len = "h2o-danube-1.8b", 1088   # slots hold a 1024-token prompt + 32
    lm_cfg = get_config(lm_arch)
    model = build_model(lm_cfg)

    def weights_on(a):
        weights, wcodec = weights_data(model.param_specs())
        a.addData(weights)
        gen = torch.Generator(device=a.device).manual_seed(0)
        model.init_params(gen, out=wcodec.unflatten(weights.device_views()))
        return weights

    sampling = SamplingConfig(max_new_tokens=32)
    rng = np.random.default_rng(3)
    lengths = [int(n) for n in rng.integers(17, 1025, size=8)]
    prompts = [rng.integers(0, lm_cfg.vocab, n).tolist() for n in lengths]
    lm_classes = ["interactive" if i % 3 == 0 else "batch" for i in range(8)]
    servers = []

    def lm_replica(i, a):
        lm = LMServer(model, weights_on(a), batch=2, max_len=max_len, sampling=sampling,
                      app=a)
        servers.append(lm)

        def decode(prompt):
            rid = lm.submit(list(prompt))
            return lm.run()[rid]
        return CallableReplica(f"lm{i}", decode, max_batch=2)

    lm_reps = [lm_replica(i, a) for i, a in enumerate(split_apps(2))]
    sync()
    per_layer = 2 + 2 * lm_cfg.qk_norm + lm_cfg.mla

    def expected():
        return {"rmsnorm": sum((per_layer * lm_cfg.n_layers + 1) * (s.admitted + s.steps)
                               for s in servers),
                "flash_attention": sum(lm_cfg.n_layers * s.admitted for s in servers)}

    lm_counts, runs = {}, []
    served_total = {r.name: 0 for r in lm_reps}   # the totals after the last run
    steps_total = [(0, 0)] * len(servers)
    for label in ("cold", "warm"):
        before, exp0 = launch_counts(), expected()
        fd = FrontDoor(lm_reps, capacity=16, policy="least-outstanding")
        sync()
        t0 = time.perf_counter()
        fids = [fd.submit(p, priority=c) for p, c in zip(prompts, lm_classes)]
        outs = {o.rid: o for o in fd.drain(timeout=600.0)}
        sync()
        run_s = time.perf_counter() - t0
        fd.close()
        lm_lines = [ln for ln in fd.metrics.render().splitlines()
                    if ln.startswith("frontdoor_requests_")]
        bad = [f for f in fids if f not in outs or outs[f].status != "ok"]
        if bad:
            fail(f"LM {label}: requests {[outs.get(f) for f in bad]}")
        got = {k: v - before.get(k, 0) for k, v in launch_counts().items()
               if v != before.get(k, 0)}
        exp = {k: v - exp0[k] for k, v in expected().items()}
        if any(got.get(k, 0) != v for k, v in exp.items()):
            fail(f"LM {label}: launches {got}, expected {exp}")
        for k, v in got.items():
            lm_counts[k] = lm_counts.get(k, 0) + v
        # this run's own served requests and decode steps' (captures, replays)
        steps = [(st.captures, st.replays)
                 for st in (s.decode_pipe.build().executor for s in servers)]
        served = {r.name: r.served - served_total[r.name] for r in lm_reps}
        caps = [(c - c0, r - r0) for (c, r), (c0, r0) in zip(steps, steps_total)]
        served_total = {r.name: r.served for r in lm_reps}
        steps_total = steps
        runs.append((label, run_s, outs, caps, served, lm_lines))
    caps_cold, caps_warm = runs[0][3], runs[1][3]
    if [c for c, _ in caps_cold] != [1, 1] or [c for c, _ in caps_warm] != [0, 0]:
        fail(f"LM decode step captures: cold {caps_cold}, warm {caps_warm} (one each "
             "expected, none in the warm run)")

    # a lone server of the same shape, each prompt alone
    solo_app = one_device_app()
    solo = LMServer(model, weights_on(solo_app), batch=2, max_len=max_len,
                    sampling=sampling, app=solo_app)
    sync()
    t0 = time.perf_counter()
    lone = []
    for p in prompts:
        rid = solo.submit(p)
        lone.append(solo.run()[rid])
    sync()
    solo_s = time.perf_counter() - t0
    for label, _, outs, _, _, _ in runs:
        for i, f in enumerate(sorted(outs)):
            if list(outs[f].result) != lone[i]:
                fail(f"LM {label}: request {f}'s tokens differ from a lone server's")
    tokens = 8 * 32
    for label, run_s, outs, caps, served, lm_lines in runs:
        lat = {c: [o.latency_s * 1e3 for o in outs.values() if o.priority == c]
               for c in ("interactive", "batch")}
        print(f"[frontdoor] {smi}: {lm_arch} at full width, 2 LMServer replicas (2 slots, "
              f"max_len {max_len}, 32 new tokens) on {dev}, least-outstanding, {label}: "
              f"8 prompts of {min(lengths)}-{max(lengths)} tokens in {run_s * 1e3:.1f} ms = "
              f"{tokens / run_s:.1f} tokens/s (a lone server, each prompt alone, "
              f"{tokens / solo_s:.1f}); p50/p99 ms interactive "
              f"{pct(lat['interactive'], 50):.1f}/{pct(lat['interactive'], 99):.1f}, batch "
              f"{pct(lat['batch'], 50):.1f}/{pct(lat['batch'], 99):.1f}; served {served}; "
              f"decode steps (captures, replays) {caps}; every request's tokens equal the "
              "lone server's")
        for ln in lm_lines:
            print(f"[frontdoor] {label}: {ln}")
    print(f"[frontdoor] LM launches {lm_counts}: every prefill and decode step's rmsnorm and "
          "flash_attention as a lone server counts them")
    wall("after [frontdoor] LM")
    return lm_counts


def main() -> None:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; "
                 "this script runs only on a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.mri_recon import CONFIG
    from repro_torch.core import (CLapp, Data, DeviceTraits, KData, PlatformTraits,
                                  ProcessChain, ProfileParameters, XData)
    from repro_torch.core.registry import launch_counts, reset_launch_counts
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.coil_combine import rss, ximage_sum
    from repro_torch.kernels.complex_elementprod import complex_elementprod
    from repro_torch.kernels.mri_fused import (dft_fits, fused_epilogue, fused_recon,
                                               idft_tables, recon_smem_bytes)
    from repro_torch.launch.mri_recon import oracle_recon as oracle, synthetic_kdata
    from repro_torch.launch.roofline import card_peaks, kernel_cost, roofline_terms
    from repro_torch.processes import (FFT, ComplexElementProd, ComplexElementProdParams,
                                       FFTParams, FusedMRIRecon, FusedReconParams,
                                       RSSCombine, SimpleMRIRecon)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def wall(label):
        """Where the script's own time goes: seconds since it started."""
        print(f"[wall] {label}: {time.perf_counter() - t_start:.1f} s since the start")

    # -- 1. the card and the build ------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    print(smi)
    print(f"torch.cuda.get_device_name: {name}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    try:
        peaks = card_peaks(name)
    except KeyError as err:
        raise SystemExit(f"chip_smoke: {err}") from None

    def bound_of(kname, *args, **kwargs):
        """(bound ms, "bytes" or "operations", the cost's bytes and
        operations) of one call of registered kernel ``kname`` on these
        arguments: its cost model at this card's data-sheet rates."""
        t_ops, t_bytes = (t * 1e3 for t in roofline_terms(kname, *args, peaks=peaks, **kwargs))
        cost = kernel_cost(kname, *args, **kwargs)
        return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
                f"{cost.bytes / 1e6:.3f} MB, {cost.flops / 1e9:.4f} GFLOP at {cost.peak}")
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] {time.perf_counter() - t0:.2f} s (nvcc {_build.BUILD_INFO['seconds']:.2f} s, "
          f"cached={_build.BUILD_INFO['cached']}) -> {_build.BUILD_INFO['path']}")
    for line in _build.BUILD_INFO["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[ptxas] {line.strip()}")

    wall("before section 2")
    # -- 2. every kernel against its plain version --------------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def crand(*shape):
        return torch.randn(shape, dtype=torch.complex64, device=dev, generator=gen)

    cfg = (CONFIG.frames, CONFIG.coils, CONFIG.height, CONFIG.width)
    odd, wide, big = (2, 3, 24, 20), (1, 64, 2, 17000), (8, 16, 384, 384)
    # inside the DFT gate: H and W no multiple of the 16-row or 8-column
    # tiles, and 256x256 with 117 coils (past the former 113-coil limit)
    ragged, edge = (3, 5, 97, 131), (1, 117, 256, 256)
    elem_tol, sum_tol, wide_tol, dft_tol = (2e-6, 1e-5), (2e-6, 2e-5), (2e-5, 2e-4), (1e-4, 1e-4)
    max_err: dict = {}

    def check(label, kname, got, want, tol, at_config):
        torch.cuda.synchronize()
        rtol, atol = tol
        err = (got - want).abs()
        bad = err > atol + rtol * want.abs()
        abs_err = float(err.max())
        rel_err = float((err / want.abs().clamp_min(1e-30)).max())
        ok = not bool(bad.any())
        print(f"[check] {label}: max_abs {abs_err:.3e} max_rel {rel_err:.3e} "
              f"(rtol {rtol:g}, atol {atol:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"chip_smoke: {label} disagrees with its plain version")
        if at_config:
            max_err[kname] = max(max_err.get(kname, 0.0), abs_err)

    for shape, tag in ((cfg, "CONFIG"), (odd, "odd"), (wide, "wide-W")):
        f, c, h, w = shape
        tol = wide_tol if tag == "wide-W" else sum_tol
        a, b = crand(f, c, h, w), crand(c, h, w)
        for conj in (False, True):
            check(f"complex_elementprod conj={conj} {shape}", "complex_elementprod",
                  complex_elementprod(a, b, conj), ref.complex_elementprod(a, b, conj),
                  elem_tol, tag == "CONFIG")
        a_copy = a.clone()  # in place, as on the staged chain's arena
        complex_elementprod(a_copy, b, True, out=a_copy)
        check(f"complex_elementprod in place {shape}", "complex_elementprod",
              a_copy, ref.complex_elementprod(a, b, True), elem_tol, tag == "CONFIG")
        check(f"ximage_sum {shape}", "ximage_sum", ximage_sum(a), ref.ximage_sum(a),
              tol, tag == "CONFIG")
        check(f"rss {shape}", "rss", rss(a), ref.rss(a), tol, tag == "CONFIG")
        for comb in ("sum", "rss"):
            check(f"fused_epilogue {comb} {shape}", "fused_epilogue",
                  fused_epilogue(a, b, comb), ref.mri_fused_epilogue(a, b, comb),
                  tol, tag == "CONFIG")
    same_a, same_b = crand(*odd), crand(*odd)
    check(f"complex_elementprod same-shape {odd}", "complex_elementprod",
          complex_elementprod(same_a, same_b, True),
          ref.complex_elementprod(same_a, same_b, True), elem_tol, False)
    for shape, norms in ((cfg, ("ortho",)), (odd, ("ortho", "backward", "forward")),
                         (ragged, ("ortho", "backward", "forward")), (edge, ("ortho",)),
                         (big, ("ortho",)), (wide, ("ortho",))):
        f, c, h, w = shape
        k, s = crand(*shape), crand(*shape[1:])
        side = "inside" if dft_fits(f, c, h, w) else "outside"
        for norm in norms:
            for comb in ("sum", "rss"):
                check(f"fused_recon {comb} norm={norm} {shape} ({side} the gate)",
                      "fused_recon", fused_recon(k, s, comb, norm),
                      ref.mri_fused_recon(k, s, comb, norm), dft_tol, shape == cfg)
    if (not all(dft_fits(*sh) for sh in (cfg, ragged, edge))
            or dft_fits(*big) or dft_fits(*wide)):
        raise SystemExit("chip_smoke: fused_recon gate does not split the shapes as planned")
    del a, b, a_copy, k, s

    # [kernels] the batched maps form: a stream's batch (B, F, C, H, W) with
    # one map set a slice (B, C, H, W), as a vmap over the JAX kernels; at
    # B = 8 x CONFIG and a ragged (3, 5, 3, 97, 131).  Then one map set for
    # the whole batch, and B equal map sets, each bit for bit the single-map
    # call on the batch folded into frames (B * F, C, H, W): frame f reads
    # map set f / fpm, so one set is today's arithmetic exactly.
    for shape, tag in (((8,) + cfg, "B=8 x CONFIG"), ((3, 5, 3, 97, 131), "ragged")):
        b5, f5 = shape[0], shape[1]
        k5, s4 = crand(*shape), crand(b5, *shape[2:])
        fold = k5.view(b5 * f5, *shape[2:])
        at_cfg = tag != "ragged"
        for conj in (False, True):
            check(f"[kernels] complex_elementprod per-slice maps conj={conj} {shape}",
                  "complex_elementprod", complex_elementprod(k5, s4, conj),
                  ref.complex_elementprod(k5, s4, conj), elem_tol, at_cfg)
        for comb in ("sum", "rss"):
            check(f"[kernels] fused_epilogue {comb} per-slice maps {shape}", "fused_epilogue",
                  fused_epilogue(k5, s4, comb), ref.mri_fused_epilogue(k5, s4, comb),
                  sum_tol, at_cfg)
            check(f"[kernels] fused_recon {comb} per-slice maps {shape} (inside the gate: "
                  f"{dft_fits(b5 * f5, *shape[2:])})", "fused_recon",
                  fused_recon(k5, s4, comb), ref.mri_fused_recon(k5, s4, comb), dft_tol,
                  at_cfg)
        one, same = s4[0].contiguous(), s4[:1].expand_as(s4).contiguous()
        pairs = {
            "complex_elementprod": (lambda m: complex_elementprod(k5, m, True),
                                    lambda: complex_elementprod(fold, one, True)),
            "fused_epilogue sum": (lambda m: fused_epilogue(k5, m, "sum"),
                                   lambda: fused_epilogue(fold, one, "sum")),
            "fused_epilogue rss": (lambda m: fused_epilogue(k5, m, "rss"),
                                   lambda: fused_epilogue(fold, one, "rss")),
            "fused_recon sum": (lambda m: fused_recon(k5, m, "sum"),
                                lambda: fused_recon(fold, one, "sum")),
            "fused_recon rss": (lambda m: fused_recon(k5, m, "rss"),
                                lambda: fused_recon(fold, one, "rss")),
        }
        for kname, (batched, single) in pairs.items():
            want = single().view(-1)
            exact_one = bool(torch.equal(batched(one).view(-1), want))
            exact_same = bool(torch.equal(batched(same).view(-1), want))
            print(f"[kernels] {kname} {shape}: one map set bit for bit the single-map call "
                  f"on ({b5 * f5}, {', '.join(map(str, shape[2:]))}) "
                  f"{'ok' if exact_one else 'FAIL'}; {b5} equal map sets "
                  f"{'ok' if exact_same else 'FAIL'}")
            if not (exact_one and exact_same):
                raise SystemExit(f"chip_smoke: {kname} with one map set is not the single-map "
                                 "call bit for bit")
        del k5, s4, fold, one, same

    wall("before section 3")
    # -- 3. times at the case-study size -------------------------------------
    def events_ms(run, reps):
        times = []
        for _ in range(reps):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            run()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return statistics.median(times)

    def device_ms(fn, sets, reps=25):
        """Device time of one call: ``fn(*inputs)`` for each input set of
        ``sets`` in turn, captured in one CUDA graph, so no host work sits
        between the calls; median of ``reps`` replays after warm-up,
        divided by the number of calls."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for inputs in sets[:3]:
                fn(*inputs)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for inputs in sets:
                fn(*inputs)
        for _ in range(3):
            graph.replay()
        ms = events_ms(graph.replay, reps) / len(sets)
        del graph
        return ms

    def call_ms(fn, reps=30):
        """One call from the host, host overhead included (median)."""
        for _ in range(5):
            fn()
        return events_ms(fn, reps)

    f, c, h, w = cfg
    hw, n = h * w, f * c * h * w
    x, s = crand(*cfg), crand(c, h, w)
    tables = idft_tables(h, w, "ortho", dev)
    # Cold timing: the calls of one graph walk over enough copies of the
    # inputs that a copy comes round again only after more than three L2s
    # of other traffic, so each call reads its inputs from DRAM, as the
    # DRAM bound assumes.  Warm timing repeats the one input set.
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    in_bytes = (n + c * hw) * 8
    copies = max(2, -(-3 * l2 // in_bytes) + 1)
    cold = [(x, s, tables)] + [(x.clone(), s.clone(), (tables[0].clone(), tables[1].clone()))
                               for _ in range(copies - 1)]
    warm = [(x, s, tables)] * copies
    print(f"[time] L2 {l2 / 2**20:.0f} MiB; cold timing walks {copies} input copies "
          f"of {in_bytes / 1e6:.1f} MB")
    timed = {
        "complex_elementprod": (
            lambda x, s, t: complex_elementprod(x, s, True),
            lambda x, s, t: ref.complex_elementprod(x, s, True),
            lambda x, s, t: x * s.conj(),
            lambda x, s, t: bound_of("complexElementProd", x, s, True),
            "src/repro/kernels/complex_elementprod.py:60"),
        "ximage_sum": (
            lambda x, s, t: ximage_sum(x), lambda x, s, t: ref.ximage_sum(x),
            lambda x, s, t: x.sum(1),
            lambda x, s, t: bound_of("xImageSum", x), "src/repro/kernels/coil_combine.py:59"),
        "rss": (
            lambda x, s, t: rss(x), lambda x, s, t: ref.rss(x),
            lambda x, s, t: torch.linalg.vector_norm(x, dim=1),
            lambda x, s, t: bound_of("rss", x), "src/repro/kernels/coil_combine.py:59"),
        "fused_epilogue": (
            lambda x, s, t: fused_epilogue(x, s), lambda x, s, t: ref.mri_fused_epilogue(x, s),
            lambda x, s, t: torch.einsum("fchw,chw->fhw", x, s.conj()),
            lambda x, s, t: bound_of("mriFusedEpilogue", x, s),
            "src/repro/kernels/mri_fused.py:104"),
        "fused_recon": (
            lambda x, s, t: fused_recon(x, s, tables=t),
            lambda x, s, t: ref.mri_fused_recon(x, s),
            lambda x, s, t: torch.einsum("fchw,chw->fhw", torch.fft.ifft2(x, norm="ortho"),
                                         s.conj()),
            lambda x, s, t: bound_of("mriFusedRecon", x, s, tables=t),
            "src/repro/kernels/mri_fused.py:194"),
    }
    rows = {}
    for kname, (kern, plain, lib, bound, replaces) in timed.items():
        bound_ms, bound_by, cost_txt = bound(x, s, tables)
        ms, plain_ms, lib_ms = device_ms(kern, cold), device_ms(plain, cold), device_ms(lib, cold)
        warm_ms, warm_lib = device_ms(kern, warm), device_ms(lib, warm)
        rows[kname] = dict(name=kname, route="cuda", source=SRC, replaces=replaces,
                           ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=lib_ms, max_abs_err=max_err[kname])
        print(f"[time] {kname} at {cfg}: cold-L2 device ms: kernel {ms:.5f}, "
              f"plain {plain_ms:.5f}, library {lib_ms:.5f}, bound {rows[kname]['bound_ms']:.5f} "
              f"({bound_by}: {cost_txt}); "
              f"warm-L2 device ms: kernel {warm_ms:.5f}, library {warm_lib:.5f}; "
              f"one host call: kernel {call_ms(lambda: kern(x, s, tables)):.5f}, "
              f"library {call_ms(lambda: lib(x, s, tables)):.5f}")
    # fused_recon beside the route it has to beat to earn its gate (a
    # yardstick): cuFFT, then the port's fused epilogue kernel (two
    # launches); then at 33 frames against 16.  The grid is ceil(H / 16) x F
    # blocks, two resident an SM: 160 blocks fit one round on 132 SMs (28
    # SMs hold two), 330 take two rounds.  A ratio near 2 says each block's
    # own latency sets the time; near 1.5 (3 blocks against 2 on the busiest
    # SM), an SM's throughput.
    def two_launch(x, s, t):
        return fused_epilogue(torch.fft.ifft2(x, norm="ortho"), s)

    print(f"[time] {smi}: fused_recon at {cfg}: two-launch route fused_epilogue(ifft2(k)) "
          f"cold-L2 device ms {device_ms(two_launch, cold):.5f}, warm "
          f"{device_ms(two_launch, warm):.5f}; dft_recon_kernel cold "
          f"{rows['fused_recon']['ms']:.5f}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    by_frames = {}
    for frames in (16, 33):
        xf = crand(frames, c, h, w)
        nb = (xf.numel() + c * hw) * 8
        sets = [(xf, s, tables)] + [(xf.clone(), s.clone(), tables)
                                    for _ in range(max(2, -(-3 * l2 // nb) + 1) - 1)]
        by_frames[frames] = device_ms(lambda x, s, t: fused_recon(x, s, tables=t), sets)
        del xf, sets
    print(f"[time] {smi}: fused_recon at (F, {c}, {h}, {w}), cold-L2 device ms: F=16 "
          f"{by_frames[16]:.5f} ({-(-h // 16) * 16} blocks), F=33 {by_frames[33]:.5f} "
          f"({-(-h // 16) * 33} blocks) on {sms} SMs; ratio {by_frames[33] / by_frames[16]:.3f}")
    for tag, rss_flag in (("sum", 0), ("rss", 1)):     # kTiles = ceil(W / 64) tiles a warp
        for tiles, (th, tw) in ((-(-w // 64), (h, w)), (4, (256, 256))):
            regs, smem, spill = ptxas_usage(_build.BUILD_INFO["log"],
                                            f"dft_recon_kernelILb{rss_flag}ELi{tiles}E")
            print(f"[ptxas] dft_recon_kernel<{tag}, kTiles={tiles}>: {regs} registers a "
                  f"thread, {spill} bytes spilled, {smem} + {recon_smem_bytes(th, tw)} "
                  f"(dynamic, at {th}x{tw}) bytes shared memory a block")
    del x, s, tables, cold, warm
    # the batched maps form at a stream's batch, B = 8 x CONFIG (210 MB of
    # k-space, past L2, so two input copies suffice for cold timing): one
    # map set a slice against one map set for all, which must cost the same
    bk = crand(8, *cfg)
    b_sets = [(bk, crand(8, c, h, w)), (bk.clone(), crand(8, c, h, w))]
    b_one = [(k_, s_[0].contiguous()) for k_, s_ in b_sets]
    b_tables = idft_tables(h, w, "ortho", dev)
    batched_ms = {}
    for kname, fn in (("complex_elementprod", lambda k_, s_: complex_elementprod(k_, s_, True)),
                      ("fused_epilogue", lambda k_, s_: fused_epilogue(k_, s_)),
                      ("fused_recon", lambda k_, s_: fused_recon(k_, s_, tables=b_tables))):
        batched_ms[kname] = (device_ms(fn, b_sets), device_ms(fn, b_one))
        print(f"[time] {smi}: {kname} at (8,) + {cfg}, cold-L2 device ms: one map set a slice "
              f"(8, {c}, {h}, {w}) {batched_ms[kname][0]:.5f}, one map set for all "
              f"{batched_ms[kname][1]:.5f} (a launch per 8 slices; single slice "
              f"{rows[kname]['ms']:.5f})")
    del bk, b_sets, b_one, b_tables

    wall("before section 4")
    # -- 4. the main path through the entry points ---------------------------
    kdata, smaps, _ = synthetic_kdata(*cfg)
    want_sum, want_rss = oracle(kdata, smaps), oracle(kdata, smaps, "rss")
    reset_launch_counts()

    from torch.profiler import ProfilerActivity, profile

    def busy_ms(fn, reps=10):
        """Device time of the kernels of one call of ``fn``: the CUDA
        kernels' self time under ``torch.profiler`` over ``reps`` calls, or
        None when the trace holds no kernels."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as trace:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in trace.key_averages()
                   if e.device_type.name == "CUDA")
        return busy / reps / 1e3 if busy > 0 else None

    def timed_launch(proc, prof):
        """One unprofiled launch between two CUDA events on the compute
        stream (a profiled launch's own timer), its time a sample of
        ``prof``: the launch latency a caller sees, not that of a profiled
        staged graph, which also records each stage's events."""
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        proc.launch()
        e1.record()
        e1.synchronize()
        prof.record(e0.elapsed_time(e1) / 1e3)

    def run_phase(label, build, k, want, expect, launches=20):
        """``launches`` launches of the built process on ``k``, then a
        second k-space (``k``'s frames in reverse order) uploaded into the
        same input and launched again: each result against its oracle."""
        app = CLapp().init(PlatformTraits(), DeviceTraits())
        before = launch_counts()
        t0 = time.perf_counter()
        proc, h_in, h_out = build(app)
        proc.init()
        torch.cuda.synchronize()
        init_ms = (time.perf_counter() - t0) * 1e3
        prof = ProfileParameters(enable=True)
        again = 1 if launches == 1 else 5   # in place (listing 6) overwrites its input
        for kdata_in, want_out, n in ((k, want, launches), (k[::-1], want[::-1], again)):
            if kdata_in is not k:
                next(a for a in app.getData(h_in) if a.name == "kdata").set_host(
                    np.ascontiguousarray(kdata_in))
                app.host2device(h_in)
            for _ in range(n):
                timed_launch(proc, prof)
            app.device2Host(h_out)
            got = app.getData(h_out).get_ndarray(0).host
            if got.shape != want_out.shape or not np.isfinite(got).all():
                raise SystemExit(f"chip_smoke: {label}: bad output {got.shape}")
            np.testing.assert_allclose(got, want_out, rtol=1e-4, atol=1e-4, err_msg=label)
        total = launches + again
        graph = getattr(proc, "chain", proc)    # SimpleMRIRecon launches its chain
        if (graph.captures, graph.replays) != (1, total - 1):
            raise SystemExit(f"chip_smoke: {label}: {graph.captures} captures and "
                             f"{graph.replays} replays over {total} launches, expected 1 and "
                             f"{total - 1}")
        delta = {k: v - before.get(k, 0) for k, v in launch_counts().items()}
        missing = [k for k in expect if delta.get(k, 0) < launches]
        if missing:
            raise SystemExit(f"chip_smoke: {label}: kernels {missing} did not run "
                             f"on every launch (counts {delta})")
        replays = graph.replays
        busy = busy_ms(proc.launch) if launches > 1 else None
        busy_txt = "not measured" if busy is None else f"{busy:.4f} ms"
        print(f"[path] {label}: init {init_ms:.2f} ms, launch p50 {prof.p50() * 1e3:.4f} ms "
              f"over {total} (captures {graph.captures}, replays {replays}; a second "
              f"k-space from launch {launches + 1}), kernels' device time a launch {busy_txt}, "
              f"max abs err vs oracle {np.abs(got - want_out).max():.3e}, "
              f"launches {{{', '.join(f'{k}: {v}' for k, v in delta.items() if v)}}}")

    def recon(mode, in_place=False, k=kdata, sm=smaps):
        def build(app):
            h_in = app.addData(KData({"kdata": k, "sensitivity_maps": sm}))
            h_out = app.addData(XData({"xdata": np.zeros((k.shape[0],) + k.shape[2:],
                                                         np.complex64)}))
            p = SimpleMRIRecon(app, mode=mode, in_place=in_place)
            p.in_handle, p.out_handle = h_in, h_out
            return p, h_in, h_out
        return build

    def rss_chain(app):
        h_in = app.addData(KData({"kdata": kdata, "sensitivity_maps": smaps}))
        h_work = app.addData(app.getData(h_in).spec_clone())
        h_out = app.addData(XData({"xdata": np.zeros(want_rss.shape, np.float32)}))
        p_fft, p_prod, p_rss = FFT(app), ComplexElementProd(app), RSSCombine(app)
        p_fft.in_handle, p_fft.out_handle = h_in, h_work
        p_fft.set_launch_parameters(FFTParams("backward", var="kdata"))
        p_prod.in_handle = p_prod.out_handle = h_work
        p_prod.set_launch_parameters(ComplexElementProdParams(conjugate=True))
        p_rss.in_handle, p_rss.out_handle = h_work, h_out
        return ProcessChain(app, [p_fft, p_prod, p_rss], mode="staged"), h_in, h_out

    def fused_rss(app):
        h_in = app.addData(KData({"kdata": kdata, "sensitivity_maps": smaps}))
        h_out = app.addData(XData({"xdata": np.zeros(want_rss.shape, np.float32)}))
        p = FusedMRIRecon(app)
        p.in_handle, p.out_handle = h_in, h_out
        p.set_launch_parameters(FusedReconParams(combine="rss"))
        return p, h_in, h_out

    run_phase("SimpleMRIRecon staged", recon("staged"), kdata, want_sum,
              ["complexElementProd", "xImageSum"])
    run_phase("SimpleMRIRecon fused", recon("fused"), kdata, want_sum,
              ["complexElementProd", "xImageSum"])
    run_phase("SimpleMRIRecon fused_kernel", recon("fused_kernel"), kdata, want_sum,
              ["mriFusedRecon"])
    run_phase("SimpleMRIRecon staged in_place (listing 6)", recon("staged", True), kdata,
              want_sum, ["complexElementProd", "xImageSum"], launches=1)
    run_phase("FFT > ComplexElementProd > RSSCombine (§IV-B)", rss_chain, kdata, want_rss,
              ["complexElementProd", "rss"])
    run_phase("FusedMRIRecon combine=rss (§IV-B)", fused_rss, kdata, want_rss,
              ["mriFusedRecon"])
    k_big, s_big, _ = synthetic_kdata(*big, seed=1)
    run_phase(f"SimpleMRIRecon fused_kernel {big} (outside the gate)",
              recon("fused_kernel", k=k_big, sm=s_big), k_big, oracle(k_big, s_big),
              ["mriFusedEpilogue"], launches=5)
    counts = launch_counts()
    names = {"complex_elementprod": "complexElementProd", "ximage_sum": "xImageSum",
             "rss": "rss", "fused_epilogue": "mriFusedEpilogue",
             "fused_recon": "mriFusedRecon"}
    idle = [k for k, reg in names.items() if counts.get(reg, 0) == 0]
    if idle:
        raise SystemExit(f"chip_smoke: kernels {idle} never launched on the main path")

    wall("before section 4b")
    # -- 4b. file in, file out: I/O, the fan-in graph and the example --------
    import tempfile

    from repro_torch.core import NDArray, Pipeline, SyncSource
    from repro_torch.data.io import load_any, save_any
    from repro_torch.launch import mri_recon
    from repro_torch.processes import CombineParams, XImageSum

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    io_counts: dict = {}          # launches of the phases below, by kernel

    def counted(label, fn, expect):
        """``fn()`` with the launch counts set to 0 just before it and read
        just after; fails unless every kernel of ``expect`` launched."""
        reset_launch_counts()
        out = fn()
        got = {k: v for k, v in launch_counts().items() if v}
        for k, v in got.items():
            io_counts[k] = io_counts.get(k, 0) + v
        missing = [k for k in expect if not got.get(k)]
        if missing:
            raise SystemExit(f"chip_smoke: [{label}]: kernels {missing} did not run "
                             f"(launches {got})")
        print(f"[{label}] launches {got}")
        wall(f"after [{label}]")
        return out

    def wall_ms(t0):
        return (time.perf_counter() - t0) * 1e3

    def file_modes():
        """[io]: k-space and maps through a file into all three modes, each
        image through a file back: wall ms of each step."""
        path = f"{tmp.name}/kspace.npz"
        save_any(path, {"maps": smaps, "ksp": kdata})     # the file's order: maps first
        if np.load(path).files != ["maps", "ksp"]:
            raise SystemExit("chip_smoke: [io] the k-space file's variable order is not "
                             "(maps, ksp)")
        k_rev, want_rev = np.ascontiguousarray(kdata[::-1]), want_sum[::-1]
        for mode in ("staged", "fused", "fused_kernel"):
            app = CLapp().init()
            t0 = time.perf_counter()
            data_in = KData(path, variables=["ksp", "maps"])  # not the file's order
            load = wall_ms(t0)
            if not (np.array_equal(data_in.kdata.host, kdata)
                    and np.array_equal(data_in.smaps.host, smaps)):
                raise SystemExit("chip_smoke: [io] KData paired the file's variables by "
                                 "their order, not by the requested names")
            t0 = time.perf_counter()
            h_in = app.addData(data_in)
            app.wait_transfers()
            upload = wall_ms(t0)
            data_out = XData([NDArray(shape=want_sum.shape, dtype=np.complex64, name="xdata")])
            h_out = app.addData(data_out)
            proc = SimpleMRIRecon(app, mode=mode, in_place=False)
            proc.in_handle, proc.out_handle = h_in, h_out
            proc.init()
            launch = []
            for _ in range(11):                  # eager, capturing, 9 replays
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                proc.launch()
                torch.cuda.synchronize()
                launch.append(wall_ms(t0))
            t0 = time.perf_counter()
            app.device2Host(h_out)
            d2h = wall_ms(t0)
            out = f"{tmp.name}/outputFrames_{mode}.npz"
            t0 = time.perf_counter()
            data_out.matlab_save(out, "XData", SyncSource.HOST_ONLY)
            save = wall_ms(t0)
            got = np.load(out)["xdata"]
            if got.shape != want_sum.shape or not np.isfinite(got).all():
                raise SystemExit(f"chip_smoke: [io] {mode}: bad image {got.shape}")
            np.testing.assert_allclose(got, want_sum, rtol=1e-4, atol=1e-4, err_msg=mode)
            # a new k-space, launched by a replay: save(AUTO) must sync the
            # device copy first, not write the stale host image
            next(a for a in app.getData(h_in) if a.name == "kdata").set_host(k_rev)
            app.host2device(h_in)
            proc.launch()
            data_out.save(f"{tmp.name}/auto_{mode}.npz")
            got_auto = np.load(f"{tmp.name}/auto_{mode}.npz")["xdata"]
            np.testing.assert_allclose(got_auto, want_rev, rtol=1e-4, atol=1e-4,
                                       err_msg=f"{mode} save(AUTO) after a replay")
            graph = proc.chain
            if (graph.captures, graph.replays) != (1, 11):
                raise SystemExit(f"chip_smoke: [io] {mode}: {graph.captures} captures, "
                                 f"{graph.replays} replays over 12 launches")
            print(f"[io] {smi}: {mode} at {cfg}, wall ms: load {load:.3f} (npz, "
                  f"{(kdata.nbytes + smaps.nbytes) / 1e6:.1f} MB k-space + maps), pinned upload {upload:.3f}, launch eager "
                  f"{launch[0]:.3f}, capturing {launch[1]:.3f}, replayed p50 "
                  f"{statistics.median(launch[2:]):.4f} (9), device to host {d2h:.3f}, save "
                  f"{save:.3f}; max abs err vs oracle {np.abs(got - want_sum).max():.3e}; "
                  "save(AUTO) after a replay on a new k-space holds the new image")

    counted("io", file_modes, ["complexElementProd", "xImageSum", "mriFusedRecon"])

    def fanin(app, fuse=False):
        """The fan-in graph, its nodes handed over out of order."""
        fft = FFT(app).bind(infile="kspace", outfile="xspace",
                            params=FFTParams("backward", var="kdata"))
        prod = ComplexElementProd(app).bind(infile="xspace", outfile="weighted", smaps="smaps",
                                            params=ComplexElementProdParams(conjugate=True))
        comb = XImageSum(app).bind(infile="weighted", outfile="image", params=CombineParams())
        return Pipeline.from_graph(app, [comb, prod, fft], output="image", fuse=fuse)

    def linear(app, smaps_bound=None):
        prod = ComplexElementProd(app).bind(
            params=ComplexElementProdParams(conjugate=True),
            **({} if smaps_bound is None else {"smaps": smaps_bound}))
        return (Pipeline(app) | FFT(app).bind(infile="kspace", outfile="xspace",
                                              params=FFTParams("backward", var="kdata"))
                | prod | XImageSum(app).bind(params=CombineParams()))

    def join_phase():
        """[join]: the fan-in, arena and aux-bound graphs bit for bit; fused
        within 1e-4; 6 runs of the join graph, new inputs on runs 5-6."""
        app = CLapp().init()
        item = {"kspace": Data({"kdata": kdata}), "smaps": Data({"sensitivity_maps": smaps})}
        got_join = fanin(app).run(item).get_ndarray(0).host.copy()
        got_arena = linear(app).run(KData({"kdata": kdata, "sensitivity_maps": smaps})
                                    ).get_ndarray(0).host.copy()
        got_aux = linear(app, Data({"sensitivity_maps": smaps})).run(
            Data({"kdata": kdata})).get_ndarray(0).host.copy()
        if not (np.array_equal(got_join, got_arena) and np.array_equal(got_join, got_aux)):
            raise SystemExit("chip_smoke: [join] fan-in, arena and aux-bound graphs differ")
        np.testing.assert_allclose(got_join, want_sum, rtol=1e-4, atol=1e-4)
        got_fused = fanin(app, fuse=True).run(item).get_ndarray(0).host
        np.testing.assert_allclose(got_fused, got_join, rtol=1e-4, atol=1e-4)
        print(f"[join] {cfg}: fan-in graph == arena graph == aux-bound graph bit for bit; "
              f"fuse=True within 1e-4 of staged (bit for bit: "
              f"{np.array_equal(got_fused, got_join)}, max abs diff "
              f"{np.abs(got_fused - got_join).max():.3e})")

        k5, s5, _ = synthetic_kdata(*cfg, seed=5)
        k6, s6, _ = synthetic_kdata(*cfg, seed=6)
        runs = [(kdata, smaps)] * 4 + [(k5, s5), (k6, s6)]
        lin, lin_in = linear(app), [KData({"kdata": k, "sensitivity_maps": s}) for k, s in runs]
        pipe = fanin(app)
        times = {"fan-in": ProfileParameters(enable=True), "linear": ProfileParameters(enable=True)}
        blobs = None
        for r, (k, s) in enumerate(runs):
            out = pipe.run({"kspace": Data({"kdata": k}), "smaps": Data({"sensitivity_maps": s})},
                           profile=times["fan-in"])
            np.testing.assert_allclose(out.get_ndarray(0).host, oracle(k, s), rtol=1e-4,
                                       atol=1e-4, err_msg=f"join run {r + 1}")
            built = pipe.build()
            now = {e: app.getData(h).device_blob.data_ptr()
                   for e, h in built.input_handles.items()}
            if blobs is not None and now != blobs:
                raise SystemExit(f"chip_smoke: [join] an input edge's blob moved on run "
                                 f"{r + 1}: {blobs} -> {now}")
            blobs = now
            lin.run(lin_in[r], profile=times["linear"])
        ex = pipe.build().executor
        if (ex.captures, ex.replays) != (1, 5):
            raise SystemExit(f"chip_smoke: [join] 6 runs gave {ex.captures} captures and "
                             f"{ex.replays} replays; expected 1 capture (run 2) and replays "
                             "on runs 2-6")
        counts6 = (ex.captures, ex.replays)
        p50 = {n: statistics.median(p.samples[2:]) * 1e3 for n, p in times.items()}
        up = {n: statistics.median(p.phases["transfer"][2:]) * 1e3 for n, p in times.items()}
        # the same replays with no upload before them, and their kernels' device time
        bare, busy = {}, {}
        for n, graph in (("fan-in", ex), ("linear", lin.build().executor)):
            prof = ProfileParameters(enable=True)
            for _ in range(10):
                graph.launch(prof)
            bare[n] = prof.p50() * 1e3
            busy[n] = busy_ms(lambda: graph.launch(ProfileParameters(enable=True)))
        if (ex.captures, ex.replays) != (1, 5 + 10 + 10):
            raise SystemExit(f"chip_smoke: [join] the bare replays recaptured ({ex.captures})")
        print(f"[join] {smi}: 6 runs of the fan-in graph (new k-space and maps on runs 5-6, "
              f"each against its oracle): 1 eager, 1 capturing, 4 replays (captures "
              f"{counts6[0]}, replays {counts6[1]}, no recapture, input blobs kept); launch "
              f"p50 of runs 3-6 {p50['fan-in']:.4f} ms beside the linear graph's "
              f"{p50['linear']:.4f} ms; input upload p50 {up['fan-in']:.4f} ms (2 edges) "
              f"and {up['linear']:.4f} ms (1 arena); with no upload before it, replay p50 "
              f"{bare['fan-in']:.4f} and {bare['linear']:.4f} ms, kernels' device time a "
              f"launch (torch.profiler) {' and '.join('not measured' if b is None else f'{b:.4f} ms' for b in busy.values())}")

    counted("join", join_phase, ["complexElementProd", "xImageSum"])

    def example_phase():
        """[example]: the port's MRI example, file in, file out."""
        for argv in (["--pipeline", "--join", "--stream", "16", "--batch", "8"],
                     ["--kernel", "--join", "--stream", "16", "--batch", "8"]):
            out = f"{tmp.name}/example.npz"
            res = mri_recon.main(argv + ["--out", out])
            got = np.load(out)["xdata"]
            np.testing.assert_allclose(got, want_sum, rtol=1e-4, atol=1e-4,
                                       err_msg=" ".join(argv))
            if not res["device"].startswith("cuda"):
                raise SystemExit(f"chip_smoke: [example] ran on {res['device']}")
            st = res["stream"]
            if st["n"] != 16 or sum(st["launches"].values()) != 4:
                raise SystemExit(f"chip_smoke: [example] --stream 16 --batch 8 gave {st}")
            print(f"[example] {smi}: main({argv}): --stream 16 --batch 8 {st['ms']:.1f} ms, "
                  f"{st['ms_per_slice']:.3f} ms a slice (the first stream, which sets up the "
                  f"twins, {st['first_ms']:.1f} ms), the last slice "
                  f"{'bit for bit with' if st['exact'] else 'within 1e-6 of'} launch(), max abs "
                  f"err vs oracle {st['max_abs_err']:.3e}")
            print(f"[example] {smi}: main({argv}) on {res['device']}: wall ms load "
                  f"{res['load_ms']:.3f}, upload {res['upload_ms']:.3f}, launch "
                  f"{res['launch_ms']:.3f}, device to host {res['d2h_ms']:.3f}, save "
                  f"{res['save_ms']:.3f}; max abs err vs oracle {res['max_abs_err']:.3e}; "
                  f"join {'bit for bit with' if res['join']['exact'] else 'within 1e-4 of'} "
                  "the launch")

    counted("example", example_phase, ["complexElementProd", "xImageSum", "mriFusedRecon"])

    wall("before section 4c")
    # -- 4c. [stream] and [serve]: the many slice stacks of a study ----------
    # 24 slices at CONFIG, each with its own k-space and its own maps (the
    # phantom's maps turned by a phase and scaled a slice), so the per-slice
    # map sets of the batched kernels are exercised.

    from repro_torch.core.stream import _BatchPlan

    n_slices = 24
    stack = []
    for i in range(n_slices):
        k_i, s_i, _ = synthetic_kdata(*cfg, seed=100 + i)
        stack.append((k_i, (s_i * np.complex64((1 + 0.05 * i) * np.exp(0.3j * i)))
                      .astype(np.complex64)))
    oracles = {"sum": [oracle(k, sm) for k, sm in stack],
               "rss": [oracle(k, sm, "rss") for k, sm in stack]}

    def kd(i):
        return KData({"kdata": stack[i][0], "sensitivity_maps": stack[i][1]})

    def deltas(fn):
        before = launch_counts()
        out = fn()
        return out, {k: v - before.get(k, 0) for k, v in launch_counts().items()
                     if v != before.get(k, 0)}

    def merged(intervals):
        """Sorted, merged (start, end) intervals."""
        out = []
        for a, b in sorted(intervals):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def overlap(a, b, union):
        return sum(max(0.0, min(b, y) - max(a, x)) for x, y in union)

    def event_timeline(run):
        """``run()`` with a CUDA event recorded before and after every upload
        (on the copy stream) and every batch launch (twin launch and the
        unbatching copy, on the compute stream); returns ``run``'s result,
        the upload intervals (start ms, end ms, bytes) and the launch
        intervals, from an event recorded before ``run``."""
        from unittest import mock

        from repro_torch.core import stream as stream_mod

        def timed():
            return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

        marks = {"upload": [], "launch": []}
        upload0, call0 = stream_mod._DeviceStreams.upload, stream_mod.BatchedProcess.__call__

        def upload(self, dev, host):
            a, b = timed()
            a.record(self.copy)
            upload0(self, dev, host)
            b.record(self.copy)
            marks["upload"].append((a, b, dev.numel()))

        def call(self):
            a, b = timed()
            a.record()
            out = call0(self)
            b.record()
            marks["launch"].append((a, b, 0))
            return out

        start = torch.cuda.Event(enable_timing=True)
        start.record()
        with mock.patch.object(stream_mod._DeviceStreams, "upload", upload), \
                mock.patch.object(stream_mod.BatchedProcess, "__call__", call):
            out = run()
        torch.cuda.synchronize()
        return out, {k: [(start.elapsed_time(a), start.elapsed_time(b), n) for a, b, n in v]
                     for k, v in marks.items()}

    def device_trace(tr, label):
        """(category, name, start us, end us, bytes) of each device activity
        (kernel, memcpy, memset) in a torch.profiler trace, read from its
        chrome trace, which holds every activity the profiler recorded."""
        path = f"{tmp.name}/trace_{label.replace(' ', '_')}.json"
        tr.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        return [(e["cat"], e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                 int((e.get("args") or {}).get("bytes", 0) or 0))
                for e in events
                if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and e.get("dur", 0) > 0]

    def stream_phase():
        """[stream]: SimpleMRIRecon.stream at CONFIG, batch 8: 24 slices (no
        tail), 19 (a tail of 3: waste 5/8, a twin of its own) and 21 (a tail
        of 5: waste 3/8, padded), in staged / fused / fused_kernel and
        fused_kernel RSS; each item against the sequential launch() and the
        oracle; kernel launches = batches; every twin captured once, at its
        second launch, and replayed after; then the timing and trace lines."""
        report = {}
        for mode, comb in (("staged", "sum"), ("fused", "sum"), ("fused_kernel", "sum"),
                           ("fused_kernel", "rss")):
            label = f"{mode}{' rss' if comb == 'rss' else ''}"
            app = CLapp().init()
            h_in = app.addData(kd(0))
            out_dt = np.float32 if comb == "rss" else np.complex64
            h_out = app.addData(XData({"xdata": np.zeros((cfg[0],) + cfg[2:], out_dt)}))
            if comb == "rss":
                proc = FusedMRIRecon(app)
                proc.set_launch_parameters(FusedReconParams(combine="rss"))
            else:
                proc = SimpleMRIRecon(app, mode=mode, in_place=False)
            proc.in_handle, proc.out_handle = h_in, h_out
            proc.init()
            expect = (["mriFusedRecon"] if mode == "fused_kernel"
                      else ["complexElementProd", "xImageSum"])
            # sequential: host2device + launch() a slice, the reference
            seq, seq_ms = [], []
            d_in = app.getData(h_in)
            for i in range(n_slices):
                for dst, src in zip(d_in, kd(i)):
                    dst.set_host(src.host)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                app.host2device(h_in)
                proc.launch()
                torch.cuda.synchronize()
                seq_ms.append(wall_ms(t0))
                seq.append(app.getData(h_out).device_view("xdata").cpu().numpy().copy())
            exact = mode == "fused_kernel"

            def check_items(outs, n, what):
                if len(outs) != n:
                    raise SystemExit(f"chip_smoke: [stream] {label} {what}: {len(outs)} results "
                                     f"for {n} slices")
                err = 0.0
                for i, o in enumerate(outs):
                    got = o.device_view("xdata").cpu().numpy()
                    if got.shape != seq[i].shape or not np.isfinite(got).all():
                        raise SystemExit(f"chip_smoke: [stream] {label} {what}: bad item {i}")
                    if exact:
                        np.testing.assert_array_equal(got, seq[i], err_msg=f"{label} {what} {i}")
                    else:
                        np.testing.assert_allclose(got, seq[i], rtol=1e-6, atol=1e-6,
                                                   err_msg=f"{label} {what} {i}")
                    np.testing.assert_allclose(got, oracles[comb][i], rtol=1e-4, atol=1e-4,
                                               err_msg=f"{label} {what} {i} oracle")
                    err = max(err, float(np.abs(got - oracles[comb][i]).max()))
                return err

            walls, errs, runs = {}, {}, []
            trace = None
            # the twins of both upload slots set up alone (Data, pinned buffers,
            # the twins' init), as the first stream does before its loop
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _BatchPlan(proc, 8).init()
            torch.cuda.synchronize()
            setup_ms = wall_ms(t0)
            for tag, n in (("cold 24", 24), ("warm 24", 24), ("timed 24", 24),
                           ("events 24", 24), ("traced 24", 24), ("19", 19), ("21", 21)):
                items = [kd(i) for i in range(n)]
                torch.cuda.synchronize()
                if tag.startswith("events"):
                    t0 = time.perf_counter()
                    (outs, got), timeline = event_timeline(
                        lambda: deltas(lambda: proc.stream(items, batch=8)))
                    walls[tag] = wall_ms(t0)
                elif tag.startswith("traced"):
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as trace:
                        t0 = time.perf_counter()
                        outs, got = deltas(lambda: proc.stream(items, batch=8))
                        torch.cuda.synchronize()
                        walls[tag] = wall_ms(t0)
                else:
                    t0 = time.perf_counter()
                    outs, got = deltas(lambda: proc.stream(items, batch=8))
                    torch.cuda.synchronize()
                    walls[tag] = wall_ms(t0)
                batches = -(-n // 8)
                bad = {k: got.get(k, 0) for k in expect if got.get(k, 0) != batches}
                if bad:
                    raise SystemExit(f"chip_smoke: [stream] {label} {n} slices: kernel launches "
                                     f"{got}, expected {batches} of each of {expect}")
                errs[tag] = check_items(outs, n, tag)
                runs.append((tag, got))
            target = proc._stream_target()
            twins = target._stream_twins
            for key, bp in sorted(twins.items()):
                if (bp.captures, bp.replays) != (int(bp.launches >= 2), max(bp.launches - 1, 0)):
                    raise SystemExit(f"chip_smoke: [stream] {label}: twin (rows, slot) {key}: "
                                     f"{bp.captures} captures, {bp.replays} replays over "
                                     f"{bp.launches} launches")
            if (3, 0) not in twins or (5, 0) in twins or twins[(3, 0)].launches != 1:
                raise SystemExit(f"chip_smoke: [stream] {label}: tail twins {sorted(twins)}; "
                                 "expected one for 3 rows (waste 5/8) and none for 5 (padded)")
            twin_txt = ", ".join(f"{k}: {bp.launches} launches/{bp.captures} capture/"
                                 f"{bp.replays} replays" for k, bp in sorted(twins.items()))
            seq_p50 = statistics.median(seq_ms[2:])
            print(f"[stream] {smi}: {label} at {cfg}, batch 8, per-slice maps: wall ms a "
                  f"slice streamed {walls['timed 24'] / 24:.3f} (24 slices, every batch a "
                  f"replay: {walls['timed 24']:.1f} ms; the twins of batch 8 set up in "
                  f"{setup_ms:.1f} ms, then the first stream, eager, {walls['cold 24']:.1f} ms, "
                  f"the second, which captures, {walls['warm 24']:.1f} ms) beside sequential "
                  f"host2device + launch() "
                  f"{seq_p50:.3f} ms a slice (p50 of 22, replayed); 19 slices "
                  f"{walls['19']:.1f} ms (tail of 3: its own twin), 21 slices {walls['21']:.1f} "
                  f"ms (tail of 5: padded); every item "
                  f"{'bit for bit' if exact else 'within rtol 1e-6 of'} the sequential "
                  f"launch(), max abs err vs oracle {max(errs.values()):.3e}; kernel launches "
                  f"= batches in every run; twins {twin_txt}")
            # the upload ring from CUDA events around each upload and launch
            ups, lau = timeline["upload"], timeline["launch"]
            if not ups or not lau:
                raise SystemExit(f"chip_smoke: [stream] {label}: no upload or launch seen "
                                 f"through the stream seam ({len(ups)}, {len(lau)})")
            lu = merged([(a, b) for a, b, _ in lau])
            up_ms = sum(b - a for a, b, _ in ups)
            over = sum(overlap(a, b, lu) for a, b, _ in ups)
            busy = sum(b - a for a, b in merged([(a, b) for a, b, _ in ups + lau]))
            print(f"[stream] {smi}: {label} 24-slice stream, CUDA events around each upload "
                  f"and batch launch: {len(ups)} uploads, "
                  f"{sum(n for _, _, n in ups) / 1e9:.3f} GB in {up_ms:.3f} ms = "
                  f"{sum(n for _, _, n in ups) / up_ms / 1e6:.2f} GB/s on the copy stream "
                  f"(each {', '.join(f'{b - a:.3f}' for a, b, _ in ups)} ms); batch launches "
                  f"{', '.join(f'{b - a:.3f}' for a, b, _ in lau)} ms (twin replay and the "
                  f"unbatching copy); share of upload time overlapping a launch "
                  f"{over / up_ms:.3f}; device busy {busy:.2f} ms of the "
                  f"{walls['events 24']:.1f} ms wall: idle share "
                  f"{1 - busy / walls['events 24']:.3f}")
            ev = device_trace(trace, label)
            kern = [(a, b, nm) for cat, nm, a, b, _ in ev if cat == "kernel"]
            marker = "dft_recon_kernel" if mode == "fused_kernel" else "cprod_kernel"
            seen = sum(marker in nm for _, _, nm in kern)
            if not seen:
                print(f"[stream] {label}: the torch.profiler trace holds no {marker}: the "
                      "kernels' device time a batch not measured")
            else:
                mine = sum(b - a for a, b, nm in kern if any(
                    t in nm for t in ("cprod_kernel", "coil_combine_kernel",
                                      "fused_epilogue_kernel", "dft_recon_kernel")))
                h2d = sum("HtoD" in nm for cat, nm, _, _, _ in ev if cat == "gpu_memcpy")
                print(f"[stream] {smi}: {label} traced 24-slice stream (torch.profiler, chrome "
                      f"trace; it holds {seen} of the 3 batches' {marker} launches and {h2d} of "
                      f"the 3 uploads): kernels' device time a batch "
                      f"{sum(b - a for a, b, _ in kern) / seen / 1e3:.3f} ms (the hand-written "
                      f"kernels' {mine / seen / 1e3:.3f} ms)")
            report[label] = dict(walls, gbps=sum(n for _, _, n in ups) / up_ms / 1e6)
            del proc, app
            gc.collect()
            torch.cuda.empty_cache()
        return report

    stream_report = counted("stream", stream_phase,
                            ["complexElementProd", "xImageSum", "mriFusedRecon"])

    def serve_phase():
        """[serve]: Pipeline.run(mode="serve") over the linear, fan-in and
        aux-bound graphs (shared maps bit for bit against the aux-bound
        graph, per-slice maps against the single-arena graph); then a
        PipelineServer(batch=4, flush_timeout=0.02) fed 10 requests from a
        second thread, its twins captured by warmup() before: p50/p99
        latency, every response against its oracle."""
        import threading

        app = CLapp().init()
        maps0 = stack[0][1]
        kst = [Data({"kdata": stack[i][0]}) for i in range(5)]
        shared = [{"kspace": d, "smaps": Data({"sensitivity_maps": maps0})} for d in kst]
        want = linear(app, Data({"sensitivity_maps": maps0})).run(kst, mode="stream", batch=2)
        prof = ProfileParameters(enable=True)
        got = fanin(app).run(shared, mode="serve", batch=2, profile=prof)
        for i, (g, w_) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g.get_ndarray(0).host, w_.get_ndarray(0).host,
                                          err_msg=f"[serve] shared maps {i}")
            np.testing.assert_allclose(g.get_ndarray(0).host, oracle(stack[i][0], maps0),
                                       rtol=1e-4, atol=1e-4, err_msg=f"[serve] shared {i}")
        per = [{"kspace": Data({"kdata": stack[i][0]}),
                "smaps": Data({"sensitivity_maps": stack[i][1]})} for i in range(5)]
        got_per = fanin(app).run(per, mode="serve", batch=2)
        want_per = linear(app).run([kd(i) for i in range(5)], mode="serve", batch=2)
        for i, (g, w_) in enumerate(zip(got_per, want_per)):
            np.testing.assert_array_equal(g.get_ndarray(0).host, w_.get_ndarray(0).host,
                                          err_msg=f"[serve] per-slice maps {i}")
            np.testing.assert_allclose(g.get_ndarray(0).host, oracles["sum"][i], rtol=1e-4,
                                       atol=1e-4, err_msg=f"[serve] per-slice {i}")
        print(f"[serve] {cfg}: Pipeline.run(mode='serve') at batch 2 over 5 slices (a padded "
              f"tail): the fan-in graph with shared maps bit for bit the aux-bound graph "
              f"streamed, with per-slice maps bit for bit the single-arena graph served; "
              f"latency p50 {prof.p50() * 1e3:.2f} ms, p99 {prof.p99() * 1e3:.2f} ms")

        # the threaded server: submit touches no CUDA call; warmup() captured
        # every twin, so the worker thread only replays
        pipe = Pipeline(app) | SimpleMRIRecon(app, mode="fused_kernel").bind()
        server = pipe.serve(batch=4, flush_timeout=0.02)
        before = launch_counts().get("mriFusedRecon", 0)
        server.warmup(kd(0))
        warm = launch_counts().get("mriFusedRecon", 0) - before
        plan = server._plan
        captured = {k: bp.captures for k, bp in plan.twins.items()}
        errors = []

        def submitter():
            try:
                for i in range(10):
                    server.submit(kd(i))
                    time.sleep(0.004)
            except BaseException as e:   # reaches the main thread's check below
                errors.append(e)

        t = threading.Thread(target=submitter, name="chip-smoke-submitter")
        t0 = time.perf_counter()
        t.start()
        resps = server.collect(10, timeout=120.0)
        total_ms = wall_ms(t0)
        t.join(timeout=60.0)
        server.close()
        if errors or t.is_alive() or len(resps) != 10:
            raise SystemExit(f"chip_smoke: [serve] threaded server: {len(resps)} responses, "
                             f"submitter errors {errors}, alive {t.is_alive()}")
        for r in resps:
            got = r.data.device_view("xdata").cpu().numpy()
            np.testing.assert_allclose(got, oracles["sum"][r.rid], rtol=1e-4, atol=1e-4,
                                       err_msg=f"[serve] request {r.rid}")
        after = {k: bp.captures for k, bp in plan.twins.items()}
        served = launch_counts().get("mriFusedRecon", 0) - before - warm
        if after != captured or any(v != 1 for v in after.values()) or served != server.launches:
            raise SystemExit(f"chip_smoke: [serve] captures {captured} -> {after} (the worker "
                             f"must capture nothing), mriFusedRecon launches {served} for "
                             f"{server.launches} batches")
        lat = sorted(r.latency_s * 1e3 for r in resps)
        print(f"[serve] {smi}: PipelineServer(batch=4, flush_timeout=0.02) over SimpleMRIRecon "
              f"fused_kernel at {cfg}: 10 requests from a second thread (4 ms apart) in "
              f"{total_ms:.1f} ms, {server.launches} batched launches; latency p50 "
              f"{float(np.percentile(lat, 50)):.2f} ms, p99 {float(np.percentile(lat, 99)):.2f} "
              f"ms (min {lat[0]:.2f}, max {lat[-1]:.2f}); warmup() captured twins "
              f"{sorted(after)} ({warm} launches), none captured in the worker; every "
              "response within 1e-4 of its oracle")

    counted("serve", serve_phase, ["complexElementProd", "xImageSum", "mriFusedRecon"])

    # -- 4c'. [frontdoor]: the control plane in front of MRI and LM replicas ----
    from repro_torch.configs import get_config as full_config

    fd_counts = counted("frontdoor", lambda: frontdoor_phase(
        dev, smi, cfg, stack, oracle, wall, full_config),
        ["mriFusedRecon", "rmsnorm", "flash_attention"])
    gc.collect()                      # free the replicas' weights
    torch.cuda.empty_cache()

    # -- 4d. [mesh]: the MRI path over the lanes of a mesh --------------------
    from repro_torch.launch.mesh import make_data_mesh

    mesh_expect = {"staged": ["complexElementProd", "xImageSum"],
                   "fused": ["complexElementProd", "xImageSum"],
                   "fused_kernel": ["mriFusedRecon"]}

    def mesh_phase():
        """[mesh]: SimpleMRIRecon over the lanes of a mesh, at CONFIG.  Part 1
        is the app over every visible card (one lane a card); part 2 a
        two-lane mesh on card 0 (``make_data_mesh([cuda:0, cuda:0])``, the
        port's counterpart of the JAX package's forced host devices) and a
        (data=1, model=2) mesh on card 0 whose lane splits the frames over
        the two.  Each part streams 24 slices at batch 8 in the three modes
        with sharded=True, split="proportional" and lanes=True (untimed
        until a stream captures nothing new, then timed), part 1 also
        without a mesh (the one-device stream), and serves 8 at batch 4;
        every timed and served output against the same slice's launch() on
        a one-card app, on the card (bit for bit in the kernel mode, rtol
        1e-6 under cuFFT); each lane given rows must have launched every
        kernel of the path; CLapp.split replicas each run one launch."""
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)    # each card's context made before any timed stream
        n = 24
        items = [kd(i) for i in range(n)]
        one_device = {}

        def reference(mode):
            """launch() of each slice on a one-card app, kept on card 0."""
            app = CLapp().init(device_traits=DeviceTraits(count=1))
            h_in = app.addData(kd(0))
            h_out = app.addData(XData({"xdata": np.zeros((cfg[0],) + cfg[2:], np.complex64)}))
            proc = SimpleMRIRecon(app, mode=mode, in_place=False)
            proc.in_handle, proc.out_handle = h_in, h_out
            proc.init()
            d_in, want = app.getData(h_in), []
            for i in range(n):
                for dst, src in zip(d_in, kd(i)):
                    dst.set_host(src.host)
                app.host2device(h_in)
                proc.launch()
                want.append(app.getData(h_out).device_view("xdata").clone())
            proc.chain._release_stream()
            return want

        def held(outs, want, exact, what):
            """Each result against its launch(), compared on card 0."""
            if len(outs) != len(want):
                raise SystemExit(f"chip_smoke: [mesh] {what}: {len(outs)} results for "
                                 f"{len(want)} slices")
            for i, (o, w_) in enumerate(zip(outs, want)):
                got = o.device_view("xdata").to(w_.device)
                if got.shape != w_.shape or not bool(torch.isfinite(torch.view_as_real(got)).all()):
                    raise SystemExit(f"chip_smoke: [mesh] {what}: bad item {i}")
                same = torch.equal(got, w_) if exact else \
                    torch.allclose(got, w_, rtol=1e-6, atol=1e-6)
                if not same:
                    raise SystemExit(f"chip_smoke: [mesh] {what}: item {i} differs from its "
                                     f"launch() by {float((got - w_).abs().max()):.3e} "
                                     + ("(bit for bit expected)" if exact else "(rtol 1e-6)"))

        def twins_of(target, lanes):
            """(lane, twin) pairs: the lane twins, or the one-device twins as lane 0."""
            if lanes:
                return [(key[0][0], bp) for key, bp in target._lane_twins.items()]
            return [(0, bp) for bp in target._stream_twins.values()]

        def stream_cell(part, app, proc, mode, want, label, kw):
            target = proc.chain
            lanes = kw.get("sharded", False)
            for _ in range(2):                     # until a stream captures nothing new
                before = sum(bp.captures for _, bp in twins_of(target, lanes))
                proc.stream(items, batch=8, **kw)
                after = sum(bp.captures for _, bp in twins_of(target, lanes))
                if after == before and all(bp.launches >= 2 for _, bp in twins_of(target, lanes)
                                           if bp.launches):
                    break
            lanes = lanes and bool(target._lane_twins)
            before = {id(bp): dict(bp.kernel_launches) for _, bp in twins_of(target, lanes)}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = proc.stream(items, batch=8, **kw)
            for d in range(torch.cuda.device_count()):
                torch.cuda.synchronize(d)
            ms = wall_ms(t0)
            held(outs, want, mode == "fused_kernel", f"{part} {mode} {label}")
            per_lane, caps, devices = {}, {}, {}
            for j, bp in twins_of(target, lanes):
                c = caps.setdefault(j, [0, 0])
                c[0] += 1
                c[1] += bp.captures
                t = per_lane.setdefault(j, {})
                for k, v in bp.kernel_launches.items():
                    d = v - before.get(id(bp), {}).get(k, 0)
                    if d:
                        t[k] = t.get(k, 0) + d
            vectors = list(target.split_vectors) if lanes else [(8,)] * 3
            given = ([j for j in range(len(app.mesh.groups)) if any(v[j] for v in vectors)]
                     if lanes else [0])
            for j in given:
                missing = [k for k in mesh_expect[mode] if not per_lane.get(j, {}).get(k)]
                if missing:
                    raise SystemExit(f"chip_smoke: [mesh] {part} {mode} {label}: lane {j} was "
                                     f"given rows but launched no {missing} (launches "
                                     f"{per_lane})")
            for j, t in per_lane.items():
                d = devices.setdefault(str(app.mesh.groups[j][0]) if lanes else str(app.device),
                                       {})
                for k, v in t.items():
                    d[k] = d.get(k, 0) + v
            return ms, vectors, per_lane, devices, caps

        def part_run(part, app, with_one_device):
            shape = app.mesh.shape
            for mode in ("staged", "fused", "fused_kernel"):
                want = wants[mode]
                h_in = app.addData(kd(0))
                h_out = app.addData(XData({"xdata": np.zeros((cfg[0],) + cfg[2:],
                                                             np.complex64)}))
                proc = SimpleMRIRecon(app, mode=mode, in_place=False)
                proc.in_handle, proc.out_handle = h_in, h_out
                proc.init()
                if with_one_device:
                    one_device[mode] = stream_cell(part, app, proc, mode, want, "one-device",
                                                   {})[0] / n
                for label, kw in (("sharded", dict(sharded=True)),
                                  ("proportional", dict(sharded=True, split="proportional")),
                                  ("lanes", dict(sharded=True, lanes=True))):
                    ms, vectors, per_lane, devices, caps = stream_cell(
                        part, app, proc, mode, want, label, kw)
                    rates = (f"; lane rates (items/s) "
                             f"{[round(r, 1) for r in app.device_profiles.rates(range(shape['data']))]}"
                             if label == "proportional" else "")
                    print(f"[mesh] {smi}: {part} (mesh {shape}) {mode} {label}: "
                          f"{ms / n:.3f} ms a slice over {n} slices at batch 8 ({ms:.1f} ms) "
                          f"beside the one-device stream's {one_device[mode]:.3f} (part 1); "
                          f"split vectors {vectors}; twins/captures a lane "
                          f"{ {j: tuple(c) for j, c in sorted(caps.items())} }; launches a lane "
                          f"{dict(sorted(per_lane.items()))}, a device {devices}{rates}")
                if mode == "fused_kernel":
                    serve_pipe = Pipeline(app) | SimpleMRIRecon(app, mode=mode)
                    served = serve_pipe.run(items[:8], mode="serve", batch=4, sharded=True)
                    held(served, want[:8], True, f"{part} {mode} serve")
                    serve_pipe.build().executor.chain._release_stream()
                    print(f"[mesh] {smi}: {part} {mode}: Pipeline.run(mode='serve', batch=4, "
                          "sharded=True) over 8 slices, each bit for bit its launch()")
                proc.chain._release_stream()
                app.delData(h_in)
                app.delData(h_out)
                torch.cuda.empty_cache()

        def replicas(part, app):
            reps = app.split(len(app.mesh.device_list))
            for i, r in enumerate(reps):
                got = (Pipeline(r) | SimpleMRIRecon(r, mode="fused_kernel")).run(kd(i),
                                                                                sync=False)
                held([got], [wants["fused_kernel"][i]], True, f"{part} replica {i}")
            print(f"[mesh] {smi}: {part}: CLapp.split({len(reps)}) replicas on "
                  f"{[str(r.device) for r in reps]}, each one launch bit for bit launch()")

        wants = {mode: reference(mode) for mode in ("staged", "fused", "fused_kernel")}
        cards = torch.cuda.device_count()
        app1 = CLapp().init()
        part_run(f"part 1 ({cards} card(s))", app1, True)
        replicas("part 1", app1)
        wall("after [mesh] part 1")
        app2 = CLapp().init()
        app2.set_mesh(make_data_mesh([dev, dev]))
        part_run("part 2 (two lanes on card 0)", app2, False)
        replicas("part 2", app2)
        # the model axis: one lane, a group of two on card 0, frames split
        app3 = CLapp().init()
        app3.set_mesh(make_data_mesh([dev, dev], model=2))
        pipe = Pipeline(app3) | SimpleMRIRecon(app3, mode="fused_kernel")
        first = launch_counts().get("mriFusedRecon", 0)
        for i in range(3):           # the pipeline's one output Data: held run by run
            held([pipe.run(kd(i), sync=False)], [wants["fused_kernel"][i]], True,
                 f"model axis launch {i}")
        pieces = launch_counts().get("mriFusedRecon", 0) - first
        if pieces != 6:
            raise SystemExit(f"chip_smoke: [mesh] model axis: {pieces} dft_recon launches for "
                             "3 launches over a model group of 2; expected 6 (a piece each)")
        held(pipe.run(items, mode="stream", batch=8, sharded=True), wants["fused_kernel"], True,
             "model axis stream")
        chain = pipe.build().executor.chain
        caps = [(key, bp.captures, dict(bp.kernel_launches)) for key, bp in chain._lane_twins.items()]
        print(f"[mesh] {smi}: part 2 model axis (mesh {app3.mesh.shape}, frames split over 2 "
              f"pieces on card 0): 3 launches ({pieces} dft_recon_kernel launches) and a "
              f"24-slice sharded stream at batch 8, bit for bit launch(); twins (lane key, "
              f"captures, launches) {caps}")
        chain._release_stream()
        wall("after [mesh] part 2")

    counted("mesh", mesh_phase, ["complexElementProd", "xImageSum", "mriFusedRecon"])

    def phase_counts(prof):
        return {k: len(v) for k, v in prof.phases.items()}

    def profile_phase():
        """[profile]: the phases of profiled launches and streams.  MRI at
        CONFIG in staged / fused / fused_kernel: 25 profiled launches, the
        k-space uploaded by the first; exactly 25 samples, one "compute" a
        stage a launch (staged 3, else 1), one "transfer" (the launch that
        uploaded), no "compile"; each launch's "compute" total at most its
        sample (1 us of event resolution beside it) and at least 0.95 of the
        kernels' device time a launch from torch.profiler (the kernels vary
        from launch to launch); then 50 unprofiled replays beside them.
        Streams of the 24 slices with their own maps at batch 8 on a new
        process (staged, fused_kernel): 3 "transfer", 3 "compute" and 1
        "compile" (its one row count, the JAX package's one compile-cache
        miss), then a second stream with none; the copy rate of the
        "transfer" phases beside [stream]'s copy-stream events."""
        for mode, stages in (("staged", 3), ("fused", 1), ("fused_kernel", 1)):
            app = CLapp().init()
            h_in = app.addData(KData({"kdata": kdata, "sensitivity_maps": smaps}),
                               to_device=False)
            h_out = app.addData(XData({"xdata": np.zeros(want_sum.shape, np.complex64)}))
            proc = SimpleMRIRecon(app, mode=mode, in_place=False)
            proc.in_handle, proc.out_handle = h_in, h_out
            proc.init()
            prof = ProfileParameters(enable=True)
            for _ in range(25):
                proc.launch(prof)
            app.device2Host(h_out)
            np.testing.assert_allclose(app.getData(h_out).get_ndarray(0).host, want_sum,
                                       rtol=1e-4, atol=1e-4, err_msg=f"[profile] {mode}")
            want = {"transfer": 1, "compute": 25 * stages}
            if len(prof.samples) != 25 or phase_counts(prof) != want:
                raise SystemExit(f"chip_smoke: [profile] {mode}: {len(prof.samples)} samples, "
                                 f"phases {phase_counts(prof)}, expected 25 and {want}")
            comp = prof.phases["compute"]
            per = [sum(comp[i * stages:(i + 1) * stages]) * 1e3 for i in range(25)]
            samples = [t * 1e3 for t in prof.samples]
            kern = busy_ms(lambda: proc.launch(ProfileParameters(enable=True)))
            if kern is None:
                raise SystemExit(f"chip_smoke: [profile] {mode}: the torch.profiler trace holds "
                                 "no kernels")
            outside = [i for i in range(25)
                       if not 0.95 * kern <= per[i] <= samples[i] + 1e-3]
            if outside:
                raise SystemExit(f"chip_smoke: [profile] {mode}: launches {outside}: compute "
                                 f"{[round(per[i], 5) for i in outside]} ms outside the kernels' "
                                 f"{kern:.5f} ms and the samples "
                                 f"{[round(samples[i], 5) for i in outside]} ms")
            graph = proc.chain
            for _ in range(3):
                proc.launch()
            unprof = events_ms(proc.launch, 50)
            print(f"[profile] {smi}: SimpleMRIRecon {mode} at {cfg}, 25 profiled launches: "
                  f"samples {len(prof.samples)}, mean {prof.mean() * 1e3:.5f} ms, p50 "
                  f"{prof.p50() * 1e3:.5f}, p99 {prof.p99() * 1e3:.5f}; phases "
                  + ", ".join(f"{k} {len(v)} ({sum(v) * 1e3:.4f} ms)"
                              for k, v in prof.phases.items())
                  + f"; a launch's compute p50 {statistics.median(per):.5f} ms (min "
                  f"{min(per):.5f}, max {max(per):.5f}) between the kernels' device time "
                  f"{kern:.5f} ms and its sample; unprofiled replay p50 {unprof:.5f} ms "
                  f"(captures {graph.captures}"
                  + ("; the profiled launches replay a graph of their own, which records "
                     "each stage's events)" if mode != "fused" else ")"))
            del proc, app
        for mode in ("staged", "fused_kernel"):
            app = CLapp().init()
            h_in = app.addData(kd(0))
            h_out = app.addData(XData({"xdata": np.zeros((cfg[0],) + cfg[2:], np.complex64)}))
            proc = SimpleMRIRecon(app, mode=mode, in_place=False)
            proc.in_handle, proc.out_handle = h_in, h_out
            proc.init()
            layout_bytes = app.getData(h_in).layout.total_bytes
            profs = []
            for run in range(2):
                prof = ProfileParameters(enable=True)
                outs = proc.stream([kd(i) for i in range(24)], batch=8, profile=prof)
                for i, o in enumerate(outs):
                    np.testing.assert_allclose(o.device_view("xdata").cpu().numpy(),
                                               oracles["sum"][i], rtol=1e-4, atol=1e-4,
                                               err_msg=f"[profile] stream {mode} {run} {i}")
                want = {"transfer": 3, "compute": 3}
                if run == 0:
                    want["compile"] = 1
                if len(prof.samples) != 1 or phase_counts(prof) != want:
                    raise SystemExit(f"chip_smoke: [profile] stream {mode} run {run}: phases "
                                     f"{phase_counts(prof)}, expected {want}")
                profs.append(prof)
            moved = 3 * 8 * layout_bytes
            rates = [moved / p.phase_total("transfer") / 1e9 for p in profs]
            print(f"[profile] {smi}: SimpleMRIRecon.stream {mode}, 24 slices with their own "
                  f"maps at batch 8, a new process: first stream "
                  + ", ".join(f"{k} {len(v)} ({sum(v) * 1e3:.3f} ms)"
                              for k, v in profs[0].phases.items())
                  + "; second stream "
                  + ", ".join(f"{k} {len(v)} ({sum(v) * 1e3:.3f} ms)"
                              for k, v in profs[1].phases.items())
                  + f"; copy rate from the transfer phases (pack into pinned memory, copy "
                  f"and landing: {moved / 1e9:.3f} GB a stream) {rates[0]:.2f} / "
                  f"{rates[1]:.2f} GB/s beside [stream]'s copy-stream events "
                  f"{stream_report[mode]['gbps']:.2f} GB/s; a batch's transfer "
                  + ", ".join(f"{t * 1e3:.3f}" for t in profs[1].phases["transfer"])
                  + " ms, its compute "
                  + ", ".join(f"{t * 1e3:.3f}" for t in profs[1].phases["compute"]) + " ms")
            del proc, app, outs
            gc.collect()
            torch.cuda.empty_cache()

    counted("profile", profile_phase, ["complexElementProd", "xImageSum", "mriFusedRecon"])
    del stack, oracles

    wall("before section 5")
    # -- 5. LM and listing-1 kernels against their plain versions ------------
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.negate import negate
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.launch import quickstart
    from repro_torch.models import build_model, moe as moe_mod
    from repro_torch.models.common import tree_map
    from repro_torch.core.arena import device_view
    from repro_torch.processes.lm import DecodeSession, weights_data
    from repro_torch.serve import LMServer, SamplingConfig, ServeEngine

    bf16, f32 = torch.bfloat16, torch.float32
    lm_tol = {bf16: (2e-2, 2e-2), f32: (1e-4, 1e-5)}   # (rtol, atol); bf16: one
    # rounding of the output plus another order of sums

    def rand(*shape, dtype=f32):
        return torch.randn(shape, device=dev, generator=gen).to(dtype)

    def bit_for_bit(label, first, second):
        if not torch.equal(first, second):
            raise SystemExit(f"chip_smoke: {label}: two runs differ")

    # rmsnorm: the serving shapes, then each kernel variant: narrow rows of
    # 3 and 20 vectors, wide rows past 2048 vectors, a width that is no
    # multiple of the vector (scalar kernel), and mixed x / weight types
    for shape, dtype, w_dtype, on_path in (
            ((1024, 5120), bf16, bf16, True), ((4, 5120), bf16, bf16, True),
            ((1 * 40 * 1024, 128), bf16, bf16, True), ((1024, 2560), bf16, bf16, True),
            # minitron-8b, granite-moe-1b-a400m, deepseek-v2-lite-16b (its
            # residual rows, then the kv latent's), prefill and decode
            ((1024, 4096), bf16, bf16, True), ((4, 4096), bf16, bf16, True),
            ((1024, 1024), bf16, bf16, True), ((4, 1024), bf16, bf16, True),
            ((1024, 2048), bf16, bf16, True), ((4, 2048), bf16, bf16, True),
            ((1024, 512), bf16, bf16, True), ((4, 512), bf16, bf16, True),
            ((4, 2560), bf16, bf16, True),    # zamba2-2.7b decode
            # [mesh-lm]: qwen3-14b's decode strip of 2 slots (hidden rows,
            # then its q- and k-norm rows), a 2-row lane of h2o-danube-1.8b
            # (2 x 2048) and of lm-100m (4 x 256)
            ((2, 5120), bf16, bf16, True), ((2 * 40, 128), bf16, bf16, True),
            ((2 * 8, 128), bf16, bf16, True), ((2 * 2048, 2560), bf16, bf16, True),
            ((4 * 256, 768), f32, f32, True),
            # [mesh-tp]: every lane of h2o-danube-1.8b's (1, 2) group norms
            # the whole 4 x 2048 rows; a lane of the f32 deepseek-v2-lite-16b
            # cut's (2, 2) grid its 1 x 2048 rows and their kv latents
            ((4 * 2048, 2560), bf16, bf16, True), ((2048, 2048), f32, f32, True),
            ((2048, 512), f32, f32, True),
            ((64, 512), f32, f32, False),     # the 2-layer f32 runs' latent norm
            ((21, 80), f32, f32, False), ((9, 24), bf16, bf16, False),
            ((3, 20480), bf16, bf16, False), ((5, 100), bf16, bf16, False),
            ((7, 2560), bf16, f32, False), ((5, 5120), f32, bf16, False)):
        x, w = rand(*shape, dtype=dtype), rand(shape[-1], dtype=w_dtype)
        got = rmsnorm(x, w)
        bit_for_bit(f"rmsnorm {shape}", got, rmsnorm(x, w))
        check(f"rmsnorm {shape} {dtype} weight {w_dtype}", "rmsnorm", got.float(),
              ref.rmsnorm(x, w).float(), lm_tol[dtype], on_path)
    flash_cases = (  # q shape, kv shape, causal, window, dtype, on the path
        ((1, 40, 1024, 128), (1, 8, 1024, 128), True, None, bf16, True),  # qwen3-14b prefill
        ((4, 40, 512, 128), (4, 8, 512, 128), True, None, bf16, True),
        ((2, 6, 37, 80), (2, 2, 53, 80), True, 16, bf16, False),  # ragged, window
        ((2, 8, 100, 64), (2, 2, 100, 64), False, None, bf16, False),
        ((1, 40, 1000, 128), (1, 8, 1000, 128), True, None, bf16, True),  # ragged tail
        ((2, 8, 1, 128), (2, 8, 300, 128), True, None, bf16, False),  # one query
        ((2, 8, 70, 128), (2, 4, 90, 128), True, 33, f32, False),
        # whisper-large-v3: the encoder over 1500 frames, non-causal, in bf16
        # (served) and f32 (the 2-layer f32 run: the FMA kernel at d 64), and
        # a ragged causal decoder prefill
        ((1, 20, 1500, 64), (1, 20, 1500, 64), False, None, bf16, True),
        ((1, 20, 1500, 64), (1, 20, 1500, 64), False, None, f32, False),
        ((1, 20, 211, 64), (1, 20, 211, 64), True, None, bf16, True),
        # minitron-8b and granite-moe-1b-a400m prefills, a whole 1024-token
        # prompt and a ragged one
        ((1, 32, 1024, 128), (1, 8, 1024, 128), True, None, bf16, True),
        ((1, 32, 611, 128), (1, 8, 611, 128), True, None, bf16, True),
        ((1, 16, 1024, 64), (1, 8, 1024, 64), True, None, bf16, True),
        ((1, 16, 611, 64), (1, 8, 611, 64), True, None, bf16, True),
        # zamba2-2.7b's shared block (MHA, head dim 80): a whole 1024-token
        # prompt, a ragged one, and the one-superblock f32 run's (FMA kernel)
        ((1, 32, 1024, 80), (1, 32, 1024, 80), True, None, bf16, True),
        ((1, 32, 611, 80), (1, 32, 611, 80), True, None, bf16, True),
        ((1, 32, 64, 80), (1, 32, 64, 80), True, None, f32, False),
        # internvl2-2b: a 1024-token prompt, and 256 patches + 64 tokens in
        # bf16 and in f32 (the 2-layer prefix check)
        ((1, 16, 1024, 128), (1, 8, 1024, 128), True, None, bf16, True),
        ((1, 16, 320, 128), (1, 8, 320, 128), True, None, bf16, False),
        ((1, 16, 320, 128), (1, 8, 320, 128), True, None, f32, False),
        # head dim 16, the SMOKE configs' (repro_torch.launch.serve_lm on the card)
        ((2, 4, 37, 16), (2, 4, 37, 16), True, None, bf16, False),
        ((2, 4, 37, 16), (2, 2, 53, 16), False, None, f32, False),
        # [mesh-lm]'s training forwards: a 2-row lane of h2o-danube-1.8b
        # (window 4096) and a 4-row lane of lm-100m
        ((2, 32, 2048, 80), (2, 8, 2048, 80), True, 4096, bf16, True),
        ((4, 12, 256, 64), (4, 4, 256, 64), True, None, f32, True),
        # [mesh-tp]: a lane's heads of h2o-danube-1.8b over model 2, and of
        # lm-100m's (1, 2) group (its restart)
        ((4, 16, 2048, 80), (4, 4, 2048, 80), True, 4096, bf16, True),
        ((8, 6, 256, 64), (8, 2, 256, 64), True, None, f32, True),
        # [mesh-tp] parts 5 and 6: a lane's heads over a (1, 2) group of
        # zamba2-2.7b's shared block (16 of 32, MHA) and of whisper-large-v3's
        # encoder (10 of 20 over 1500 frames) and decoder (448 tokens), in
        # bf16 (TrainProcess) and f32 (the cut against the no-mesh step)
        ((4, 16, 2048, 80), (4, 16, 2048, 80), True, None, bf16, True),
        ((4, 16, 2048, 80), (4, 16, 2048, 80), True, None, f32, True),
        ((8, 10, 1500, 64), (8, 10, 1500, 64), False, None, bf16, True),
        ((8, 10, 1500, 64), (8, 10, 1500, 64), False, None, f32, True),
        ((8, 10, 448, 64), (8, 10, 448, 64), True, None, bf16, True),
        ((8, 10, 448, 64), (8, 10, 448, 64), True, None, f32, True))
    for qs, ks, causal, window, dtype, on_path in flash_cases:
        q, k, v = rand(*qs, dtype=dtype), rand(*ks, dtype=dtype), rand(*ks, dtype=dtype)
        got = flash_attention(q, k, v, causal=causal, window=window)
        bit_for_bit(f"flash_attention q{qs}", got,
                    flash_attention(q, k, v, causal=causal, window=window))
        check(f"flash_attention q{qs} kv{ks} causal={causal} window={window} {dtype}",
              "flash_attention", got.float(),
              ref.attention(q, k, v, causal=causal, window=window).float(),
              lm_tol[dtype], on_path)
    del x, w, q, k, v, got

    # wkv6 at the rwkv6-3b prefill (bf16 r/k/v, f32 w), ragged cases (3
    # batches, and 77 steps: no multiple of the staged tile), the SMOKE
    # head size, the decode step with its state updated in place, and a
    # decode step from a zero state (no state tensor).
    # Tolerances: the output is a sum over D taken in another order than the
    # plain version's einsum, so it is compared against its scale: within
    # 2e-2 x max |out| in bf16 (one output rounding) and 1e-5 x max |out| +
    # rtol 1e-4 in f32; the state has no sum (rtol 1e-4, atol 1e-5 x max |s|).
    def wkv_inputs(b, t, h, d, dtype):     # r, k, v, w, u and the input state
        r, k, v = (rand(b, t, h, d, dtype=dtype) for _ in range(3))
        return r, k, v, rand(b, t, h, d) * 0.5, rand(h, d) * 0.5, rand(b, h, d, d)

    for shape, dtype, in_place, on_path, zero in (
            ((1, 1024, 40, 64), bf16, False, True, False),
            # [mesh-tp] part 4: a lane's 20 of rwkv6-3b's 40 heads over a (1, 2)
            # group at its training batch, bf16 (TrainProcess) and f32 (the cut)
            ((4, 2048, 20, 64), bf16, False, True, False),
            ((4, 2048, 20, 64), f32, False, True, False),
            ((2, 37, 3, 64), f32, False, False, False),
            ((3, 77, 40, 64), bf16, False, False, False),
            ((2, 16, 8, 8), f32, False, False, False),
            ((4, 1, 40, 64), bf16, True, True, False),
            ((4, 1, 40, 64), f32, True, False, False),
            ((1, 1, 40, 64), bf16, False, False, True)):
        r, k, v, w, u, s0 = wkv_inputs(*shape, dtype)
        if zero:
            s0 = None
        want_o, want_s = ref.wkv6(r, k, v, w, u, s0)
        if in_place:
            got_s = s0.clone()
            got_o, final = wkv6(r, k, v, w, u, got_s, state_out=got_s)
            if final.data_ptr() != got_s.data_ptr():
                raise SystemExit("chip_smoke: wkv6 did not write its state in place")
        else:
            got_o, got_s = wkv6(r, k, v, w, u, s0)
        scale = float(want_o.float().abs().max())
        out_tol = (0.0, 2e-2 * scale) if dtype == bf16 else (1e-4, 1e-5 * scale)
        label = (f"wkv6 {shape} {dtype}{' state in place' if in_place else ''}"
                 f"{' zero state' if zero else ''}")
        check(f"{label} out", "wkv6", got_o.float(), want_o.float(), out_tol, on_path)
        check(f"{label} state", "wkv6_state", got_s, want_s,
              (1e-4, 1e-5 * float(want_s.abs().max())), False)
    del r, k, v, w, u, s0, want_o, want_s, got_o, got_s
    # negate: the serving sizes and 1000003 (batches of U = 4 16-byte vectors
    # a thread, a ragged last warp and a tail; 256 x 256 takes one vector a
    # thread), n = V * U +- 1 (one element either side of V * U: one vector
    # a thread, and tails), and a misaligned view (the scalar loop)
    negate_cases = [((256, 256), f32, False), ((4096, 4096), f32, False),
                    ((1000003,), f32, False), ((1000003,), bf16, False),
                    ((4096, 4096), f32, True), ((1000003,), bf16, True)]
    negate_cases += [((16 // t.itemsize * 4 + e,), t, False) for t in (f32, bf16) for e in (-1, 1)]
    for shape, dtype, misaligned in negate_cases:
        x = rand(*shape, dtype=dtype)
        if misaligned:
            x = x.view(-1)[1:]
        got, want = negate(x), ref.negate(x)
        label = f"negate {tuple(x.shape)} {dtype}{' misaligned view' if misaligned else ''}"
        same = bool(torch.equal(got, want))
        negate(x, out=x)
        same_in_place = bool(torch.equal(x, want))
        print(f"[check] {label}: bit-exact {'ok' if same else 'FAIL'}, in place "
              f"{'ok' if same_in_place else 'FAIL'}")
        if not (same and same_in_place):
            raise SystemExit(f"chip_smoke: {label} is not bit-exact")
        max_err["negate"] = 0.0
    del x, got, want

    wall("before section 6")
    # -- 6. kernel times at the serving shapes ---------------------------------
    def cold_and_warm(make):
        first = make()
        nbytes = sum(t.numel() * t.element_size() for t in first)
        copies = max(2, -(-3 * l2 // nbytes) + 1)
        return [first] + [make() for _ in range(copies - 1)], [first] * copies

    def time_kernel(kname, source, replaces, at, make, kern, plain, lib, registered,
                    plain_sets=None, **cost_kwargs):
        """Cold- and warm-L2 device times of the kernel, its plain version
        (over ``plain_sets`` input copies when it is too slow for all of
        them) and one library call; the bound from the cost model of the
        kernel ``registered`` on the first input set and ``cost_kwargs``."""
        cold, warm = cold_and_warm(make)
        bound_ms, bound_by, cost_txt = bound_of(registered, *cold[0], **cost_kwargs)
        ms, warm_ms = device_ms(kern, cold), device_ms(kern, warm)
        plain_ms = (device_ms(plain, cold) if plain_sets is None
                    else device_ms(plain, cold[:plain_sets], reps=3))
        lib_ms = device_ms(lib, cold) if lib is not None else None
        warm_lib = device_ms(lib, warm) if lib is not None else None
        row = dict(name=kname, route="cuda", source=source, replaces=replaces, ms=ms,
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=lib_ms, max_abs_err=max_err.get(kname, 0.0))
        lib_txt = "none" if lib is None else f"{lib_ms:.5f}"
        warm_lib_txt = "none" if lib is None else f"{warm_lib:.5f}"
        host_lib_txt = "none" if lib is None else f"{call_ms(lambda: lib(*cold[0])):.5f}"
        print(f"[time] {kname} at {at}: cold-L2 device ms ({len(cold)} input copies): "
              f"kernel {ms:.5f}, plain {plain_ms:.5f}, library {lib_txt}, "
              f"bound {bound_ms:.5f} ({bound_by}: {cost_txt}); warm-L2 device ms: kernel {warm_ms:.5f}, "
              f"library {warm_lib_txt}; one host call: kernel "
              f"{call_ms(lambda: kern(*cold[0])):.5f}, library {host_lib_txt}")
        del cold, warm
        return row

    # rmsnorm at the qwen3-14b prefill (1024 rows, the row kept), decode (4
    # rows) and per-head q/k-norm (40 heads x 1024 tokens, 128 wide) shapes
    seq = 1024
    for tag, (n_rows, d) in (("prefill", (seq, 5120)), ("decode", (4, 5120)),
                             ("q/k norm", (40 * seq, 128))):
        row = time_kernel(
            "rmsnorm", LM_SRC, "src/repro/kernels/rmsnorm.py:40",
            f"{tag} x ({n_rows}, {d}) bf16",
            lambda n_rows=n_rows, d=d: (rand(n_rows, d, dtype=bf16), rand(d, dtype=bf16)),
            lambda x, w: rmsnorm(x, w), lambda x, w: ref.rmsnorm(x, w),
            lambda x, w: F.rms_norm(x, (x.shape[-1],), w, 1e-6), "rmsnorm")
        if tag == "prefill":
            rows["rmsnorm"] = row
    rows["flash_attention"] = time_kernel(
        "flash_attention", LM_SRC, "src/repro/kernels/flash_attention.py:124",
        f"q (1, 40, {seq}, 128) kv (1, 8, {seq}, 128) bf16 causal",
        lambda: (rand(1, 40, seq, 128, dtype=bf16), rand(1, 8, seq, 128, dtype=bf16),
                 rand(1, 8, seq, 128, dtype=bf16)),
        lambda q, k, v: flash_attention(q, k, v), lambda q, k, v: ref.attention(q, k, v),
        lambda q, k, v: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                       enable_gqa=True),
        "flash_attention")
    # the whisper-large-v3 encoder's attention: 1500 frames, 20 heads of 64,
    # no mask; every query sees every key
    enc_t = 1500
    whisper_flash = time_kernel(
        "flash_attention", LM_SRC, "src/repro/kernels/flash_attention.py:124",
        f"q/k/v (1, 20, {enc_t}, 64) bf16 non-causal (whisper-large-v3 encoder)",
        lambda: tuple(rand(1, 20, enc_t, 64, dtype=bf16) for _ in range(3)),
        lambda q, k, v: flash_attention(q, k, v, causal=False),
        lambda q, k, v: ref.attention(q, k, v, causal=False),
        lambda q, k, v: F.scaled_dot_product_attention(q, k, v),
        "flash_attention", plain_sets=2, causal=False)
    print(f"[time] {smi}: flash_attention at the whisper encoder shape: kernel / SDPA "
          f"{whisper_flash['ms'] / whisper_flash['library_ms']:.3f}, bound / kernel "
          f"{whisper_flash['bound_ms'] / whisper_flash['ms']:.3f}")
    log = _build.BUILD_INFO["log"]
    for d in (128, 80, 64, 16):        # dynamic shared memory: Q, K, V tiles of 64 rows
        regs, smem, spill = ptxas_usage(log, f"flash_mma_kernelILi{d}E")
        print(f"[ptxas] flash_mma_kernel D={d}: {regs} registers a thread, {spill} bytes "
              f"spilled, {smem} + {3 * 64 * (d + 8) * 2} (dynamic) bytes shared memory a block")
    for d in (128, 64, 16):
        regs, smem, spill = ptxas_usage(log, f"flash_fma_kernelILi{d}E")
        print(f"[ptxas] flash_fma_kernel (f32) D={d}: {regs} registers a thread, {spill} bytes "
              f"spilled, {smem} bytes shared memory a block")
    for kind, tmpl in (("wide", "Li4E"), ("wide", "Li8E"), ("narrow", "Li16E"),
                       ("narrow", "Li32E")):
        regs, smem, spill = ptxas_usage(log, f"rmsnorm_{kind}_kernelI13__nv_bfloat16S", tmpl)
        print(f"[ptxas] rmsnorm_{kind}_kernel<bf16, bf16, {tmpl[2:-1]}>: {regs} registers a "
              f"thread, {spill} bytes spilled, {smem} bytes shared memory a block")

    # the rmsnorm wrapper's host path at the decode shape (4, 5120) bf16, where
    # the kernel takes less time than the host: each step alone, then the
    # whole call, the former wrapper's steps (a device switch and back and a
    # torch.cuda.Stream object on every call) and F.rms_norm, in us a call
    # (time.perf_counter over 10^4 calls, no synchronise inside)
    from repro_torch.kernels.common import check_cuda, launch, launch_stream
    from repro_torch.kernels.rmsnorm import DTYPES as NORM_DTYPES

    def host_us(fn, n=10_000):
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        us = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return us

    lib = _build.library()
    x, w = rand(4, 5120, dtype=bf16), rand(5120, dtype=bf16)
    out = torch.empty_like(x)
    stream = launch_stream(x)

    def former_steps():
        check_cuda("x", x, NORM_DTYPES)
        check_cuda("weight", w, NORM_DTYPES, device=x.device)
        o = torch.empty_like(x)
        with torch.cuda.device(x.device):
            lib.rt_rmsnorm(x.data_ptr(), w.data_ptr(), o.data_ptr(), 4, 5120, 1, 1, 1e-6,
                           torch.cuda.current_stream(x.device).cuda_stream)

    def device_guard():
        with torch.cuda.device(x.device):
            pass

    parts = {
        "checks": lambda: (check_cuda("x", x, NORM_DTYPES),
                           check_cuda("weight", w, NORM_DTYPES, device=x.device)),
        "empty_like": lambda: torch.empty_like(x),
        "device guard (with torch.cuda.device)": device_guard,
        "current-device query (launch)": lambda: torch._C._cuda_getDevice() == x.get_device(),
        "stream (torch.cuda.current_stream)": lambda: torch.cuda.current_stream(
            x.device).cuda_stream,
        "stream (launch_stream)": lambda: launch_stream(x),
        "ctypes call, no launch (rows 0)": lambda: lib.rt_rmsnorm(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), 0, 5120, 1, 1, 1e-6, stream),
        "ctypes call and launch": lambda: lib.rt_rmsnorm(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), 4, 5120, 1, 1, 1e-6, stream),
        "launch() with the ctypes call": lambda: launch(
            lib.rt_rmsnorm, x, x.data_ptr(), w.data_ptr(), out.data_ptr(), 4, 5120, True, True,
            1e-6),
        "former wrapper's steps": former_steps,
        "rmsnorm()": lambda: rmsnorm(x, w),
        "F.rms_norm": lambda: F.rms_norm(x, (5120,), w, 1e-6),
    }
    host = {k: host_us(fn) for k, fn in parts.items()}
    print(f"[host] {smi}: rmsnorm host path at (4, 5120) bf16, us a call over 10^4 calls: "
          + ", ".join(f"{k} {v:.3f}" for k, v in host.items()))
    print(f"[host] rmsnorm() / F.rms_norm one host call: "
          f"{host['rmsnorm()'] / host['F.rms_norm']:.3f}")
    del x, w, out

    # wkv6 at the rwkv6-3b prefill (1, 1024, 40, 64) and decode (4, 1, 40, 64)
    # shapes.  No single PyTorch call computes the recurrence, so there is
    # no library time.
    for tag, (b, t, h, d) in (("prefill", (1, seq, 40, 64)), ("decode", (4, 1, 40, 64))):
        row = time_kernel(
            "wkv6", RWKV_SRC, "src/repro/kernels/wkv6.py:82",
            f"{tag} ({b}, {t}, {h}, {d}) bf16 r/k/v, f32 w and state",
            lambda b=b, t=t, h=h, d=d: wkv_inputs(b, t, h, d, bf16),
            lambda r, k, v, w, u, s: wkv6(r, k, v, w, u, s),
            lambda r, k, v, w, u, s: ref.wkv6(r, k, v, w, u, s), None, "wkv6",
            plain_sets=2 if t > 1 else None)
        if tag == "prefill":
            rows["wkv6"] = row
    # what limits wkv6: 4 prefill batches put 4x the blocks on the card; a
    # latency-bound kernel with idle SMs takes about as long as at 1 batch,
    # one bound by an SM's throughput as long as its busiest SM's share grows
    # (a decode step of one head, (1, 1, 1, 64), is the path of one block
    # alone: launch, loads, staging, one step, stores)
    scaling = {}
    for key, (b, t, h) in ((1, (1, seq, 40)), (4, (4, seq, 40)), ("one", (1, 1, 1))):
        cold, _ = cold_and_warm(lambda b=b, t=t, h=h: wkv_inputs(b, t, h, 64, bf16))
        scaling[key] = device_ms(lambda r, k, v, w, u, s: wkv6(r, k, v, w, u, s), cold)
        del cold
    print(f"[time] {smi}: wkv6 at (B, {seq}, 40, 64) bf16, cold-L2 device ms: B=1 "
          f"{scaling[1]:.5f}, B=4 {scaling[4]:.5f}; ratio {scaling[4] / scaling[1]:.3f}; "
          f"decode of one head (1, 1, 1, 64): {scaling['one']:.5f}")
    for tag, mangled in (("bf16", "13__nv_bfloat16"), ("f32", "f")):
        for d in (64, 8):
            regs, smem, spill = ptxas_usage(log, f"wkv6_kernelI{mangled}Li{d}ELb0E")
            print(f"[ptxas] wkv6_kernel<{tag}, D={d}>: {regs} registers a thread, {spill} bytes "
                  f"spilled, {smem} bytes shared memory a block")
    for tag, mangled in (("f32", "negate_kernelIfE"), ("bf16", "negate_kernelI13__nv_bfloat16E")):
        regs, smem, spill = ptxas_usage(log, mangled)
        print(f"[ptxas] negate_kernel<{tag}>: {regs} registers a thread, {spill} bytes spilled, "
              f"{smem} bytes shared memory a block")
    for n in (4096, 256):        # beyond L2, then the quickstart's image (the row kept)
        rows["negate"] = time_kernel(
            "negate", NEG_SRC, "src/repro/kernels/negate.py:34", f"({n}, {n}) f32",
            lambda n=n: (rand(n, n),), lambda x: negate(x), lambda x: ref.negate(x),
            lambda x: torch.rsub(x, 1.0), "negate_kernel")
    torch.cuda.empty_cache()

    wall("before section 6b")
    # -- 6b. [chooser]: every registered kernel calibrated ---------------------
    from repro_torch.launch.roofline import default_chooser, resolve_backend

    def chooser_phase():
        """[chooser]: ``KernelChooser.calibrate`` for every registered kernel at
        the shapes of PERF.md §6 (the MRI kernels at CONFIG, rmsnorm at the
        qwen3-14b prefill, flash_attention at the qwen3-14b prefill and the
        whisper encoder, wkv6 at the rwkv6-3b prefill, negate at 256^2 and
        4096^2): each timed on the card, its bound from its cost model, its
        verdict; "auto" runs the kernel whatever the verdict.  A calibration
        inside a CUDA-graph capture raises.  Then the MRI path under "auto"
        (SimpleMRIRecon's default), 3 launches each of staged and
        fused_kernel, whose launch counts show the hand kernels ran."""
        chooser = default_chooser()
        f, c, h, w = cfg
        x, sm = crand(*cfg), crand(c, h, w)
        q, kk, vv = (rand(1, hh, seq, 128, dtype=bf16) for hh in (40, 8, 8))
        # the backward kernels at the h2o-danube-1.8b training shapes (a
        # layer's attention with the forward's output and log-sum-exp)
        dq_shape, dkv_shape = (4, 32, 2048, 80), (4, 8, 2048, 80)
        bwd_args = (rand(*dq_shape, dtype=bf16), rand(*dkv_shape, dtype=bf16),
                    rand(*dkv_shape, dtype=bf16), rand(*dq_shape, dtype=bf16),
                    rand(*dq_shape, dtype=bf16),
                    torch.zeros(dq_shape[:3], dtype=f32, device=dev))
        calls = [
            ("complexElementProd", (x, sm, True), {}, f"{cfg} complex64, conj"),
            ("xImageSum", (x,), {}, f"{cfg} complex64"),
            ("rss", (x,), {}, f"{cfg} complex64"),
            ("mriFusedEpilogue", (x, sm), {}, f"{cfg} complex64"),
            ("mriFusedRecon", (x, sm), {"tables": idft_tables(h, w, "ortho", dev)},
             f"{cfg} complex64, DFT kernel"),
            ("rmsnorm", (rand(seq, 5120, dtype=bf16), rand(5120, dtype=bf16)), {},
             f"({seq}, 5120) bf16"),
            ("flash_attention", (q, kk, vv), {}, f"q (1, 40, {seq}, 128) kv (1, 8, {seq}, 128) "
             "bf16 causal (qwen3-14b prefill)"),
            ("flash_attention", tuple(rand(1, 20, 1500, 64, dtype=bf16) for _ in range(3)),
             {"causal": False}, "(1, 20, 1500, 64) bf16 non-causal (whisper encoder)"),
            ("wkv6", wkv_inputs(1, seq, 40, 64, bf16), {},
             f"(1, {seq}, 40, 64) bf16 r/k/v, f32 w, u and state"),
            ("negate_kernel", (rand(256, 256),), {}, "(256, 256) f32"),
            ("negate_kernel", (rand(4096, 4096),), {}, "(4096, 4096) f32"),
            ("rmsnorm_bwd", (rand(8192, 2560, dtype=bf16), rand(2560, dtype=bf16),
                             rand(8192, 2560, dtype=bf16)), {},
             "x (8192, 2560) bf16 (h2o-danube-1.8b, batch 4 x 2048)"),
            ("flash_attention_bwd", bwd_args, {"causal": True, "window": 4096},
             "q (4, 32, 2048, 80) kv (4, 8, 2048, 80) bf16 causal window 4096, o and lse "
             "(h2o-danube-1.8b, a layer)"),
            # the kernel's call without checkpoints runs the checkpointing
            # forward first, as the plain version's autograd runs its forward
            ("wkv6_bwd", wkv_inputs(4, 2048, 40, 64, bf16)[:5]
             + (None, rand(4, 2048, 40, 64, dtype=bf16)), {},
             "(4, 2048, 40, 64) bf16 r/k/v and output gradient, f32 w and u, no state "
             "(rwkv6-3b, a layer; the forward with checkpoints included)"),
        ]
        for kname, args, kw, at in calls:
            rec = chooser.calibrate(kname, *args, **kw)
            if not (rec.timed and 0 < rec.t_kernel_s < float("inf")
                    and 0 < rec.t_plain_s < float("inf") and rec.bound_s > 0
                    and chooser.lookup(kname, *args, **kw) is rec
                    and resolve_backend("auto", kname, *(a for a in args
                                                         if isinstance(a, torch.Tensor)))):
                raise SystemExit(f"chip_smoke: [chooser] {kname} at {at}: record {rec}")
            print(f"[chooser] {smi}: {kname} at {at}: t_kernel {rec.t_kernel_s * 1e3:.5f} ms, "
                  f"t_plain {rec.t_plain_s * 1e3:.5f} ms (one call's device time, min of "
                  f"{chooser.reps}, warm, zero inputs); bound {rec.bound_s * 1e3:.5f} ms, "
                  f"{rec.bound}-bound (compute {rec.t_compute_est_s * 1e3:.5f}, memory "
                  f"{rec.t_memory_est_s * 1e3:.5f}); verdict {rec.backend}: {rec.reason}")
        plain = sorted({r.kernel for r in chooser.records() if r.backend == "plain"})
        print(f"[chooser] {len(chooser.records())} records; \"plain\" verdicts (findings for "
              f"the redesign queue; \"auto\" runs the kernel all the same): {plain or 'none'}")
        g = torch.cuda.CUDAGraph()
        refused = False
        with torch.cuda.graph(g):
            x.add_(0)
            try:
                chooser.calibrate("rss", crand(2, 3, 8, 8))
            except RuntimeError:
                refused = True
        del g
        if not refused:
            raise SystemExit("chip_smoke: [chooser] calibrate ran inside a CUDA-graph capture")
        del x, sm, q, kk, vv, calls, bwd_args
        for mode in ("staged", "fused_kernel"):
            app = CLapp().init()
            h_out = app.addData(XData({"xdata": np.zeros(want_sum.shape, np.complex64)}))
            proc = SimpleMRIRecon(app, mode=mode, in_place=False)
            proc.in_handle = app.addData(KData({"kdata": kdata, "sensitivity_maps": smaps}))
            proc.out_handle = h_out
            for _ in range(3):
                proc.launch()
            app.device2Host(h_out)
            np.testing.assert_allclose(app.getData(h_out).get_ndarray(0).host, want_sum,
                                       rtol=1e-4, atol=1e-4, err_msg=f"[chooser] {mode}")
            del proc, app
        torch.cuda.empty_cache()

    counted("chooser", chooser_phase, ["complexElementProd", "xImageSum", "mriFusedRecon"])

    wall("before section 7")
    # -- 7. the LM serving path at full width: qwen3-14b, then rwkv6-3b -------
    # the 2-layer bf16 runs' band, a share of max |logit|, where a family's
    # differs from 2e-2 (why: the comment at its check below, PERF.md §2)
    BF16_BAND = {"ssm": 5e-2, "moe": 4e-2, "hybrid": 5e-2}
    #: each serve's first 10 requests: tokens, tokens/s, decode p50 ms
    lm_runs: dict = {}

    def serve_full_width(arch, expect, enc_len=None):
        """Serve 10 requests (32 new tokens each) through 4 slots of ``LMServer``
        at full width with random bf16 weights made on the card from seed 0:
        prompts of 17-1024 tokens and max_len 2048, or, for an encoder-decoder
        (``enc_len`` frames a request, each its own (enc_len, d) f32 frames from
        the seed), 4-224 tokens and max_len 448.  Check the tokens, that every
        kernel of ``expect(cfg, server)`` launched exactly that often, that the
        decode state never moved host to device and that the decode step was
        captured once and replayed after; then the first request twice more.
        Then run 2 layers of the same weights (2 encoder and 2 decoder layers
        of an encoder-decoder) once on the card and once on a CPU app in f32
        and compare the logits.  Returns the run's launch counts."""
        cfg = get_config(arch)
        model = build_model(cfg)
        app = CLapp().init(PlatformTraits(), DeviceTraits())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        weights, wcodec = weights_data(model.param_specs())
        app.addData(weights)
        params = model.init_params(torch.Generator(device=app.device).manual_seed(0),
                                   out=wcodec.unflatten(weights.device_views()))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(int(np.prod(e.shape)) for e in weights.layout.entries)
        print(f"[lm] {arch} weights: {n_params} parameters, "
              f"{weights.layout.total_bytes / 1e9:.3f} GB arena (bf16"
              f"{', u f32' if cfg.family == 'ssm' else ''}"
              f"{', A_log, D and dt_bias f32' if cfg.family == 'hybrid' else ''}"
              f"{', router f32' if cfg.n_experts else ''}), made on the card from seed 0 in "
              f"{init_s:.3f} s")
        (lo, hi), max_len = ((4, 225), 448) if enc_len else ((17, 1025), 2048)
        server = LMServer(model, weights, batch=4, max_len=max_len, enc_len=enc_len,
                          sampling=SamplingConfig(max_new_tokens=32), app=app)
        rng = np.random.default_rng(0)
        lengths = [int(n) for n in rng.integers(lo, hi, size=10)]
        prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lengths]
        frames = [rng.standard_normal((enc_len, cfg.d_model), dtype=np.float32)
                  if enc_len else None for _ in lengths]
        for prompt, fr in zip(prompts, frames):
            server.submit(prompt, frames=fr)
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        results = server.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = launch_counts()
        bad = [i for i, r in enumerate(results)
               if len(r) != 32 or not all(0 <= t < cfg.vocab for t in r)]
        if len(results) != len(lengths) or bad:
            raise SystemExit(f"chip_smoke: {arch} LMServer requests {bad} did not get 32 "
                             f"tokens in [0, {cfg.vocab})")
        want_counts = expect(cfg, server)
        if any(counts.get(k, 0) != n for k, n in want_counts.items()):
            raise SystemExit(f"chip_smoke: {arch}: kernels did not run on every prefill and "
                             f"step: launches {counts}, expected {want_counts}")
        state_h2d = app.h2d_bytes.get(server.state_h, 0)
        if state_h2d or server.decode_profile.phase_total("transfer"):
            raise SystemExit(f"chip_smoke: {arch}: the decode state moved {state_h2d} bytes "
                             "host to device")
        step = server.decode_pipe.build().executor
        if (step.captures, step.replays) != (1, server.steps - 1):
            raise SystemExit(f"chip_smoke: {arch}: decode step captured {step.captures} and "
                             f"replayed {step.replays} times over {server.steps} steps, "
                             f"expected 1 and {server.steps - 1}")
        n_tokens = sum(len(r) for r in results)
        prefill_ms = [t * 1e3 for t in server.prefill_profile.samples]
        decode_ms = [t * 1e3 for t in server.decode_profile.samples]
        lm_runs[arch] = {"results": [list(r) for r in results], "tokens_per_s": n_tokens / run_s,
                         "decode_p50": statistics.median(decode_ms)}
        audio = f", {enc_len} frames each" if enc_len else ""
        print(f"[lm] {smi}: LMServer {arch}, 10 requests (prompt lengths {lengths}{audio}), "
              f"4 slots, max_len {max_len}{f', enc_len {enc_len}' if enc_len else ''}: "
              f"{n_tokens} tokens in {run_s:.3f} s = {n_tokens / run_s:.2f} tokens/s; "
              f"{server.admitted} prefills, {server.steps} decode steps")
        print(f"[lm] {arch} prefill ms per prompt (length: ms): "
              f"{', '.join(f'{n}: {t:.2f}' for n, t in zip(lengths, prefill_ms))}; "
              f"mean {statistics.mean(prefill_ms):.2f}; first {prefill_ms[0]:.2f}, mean of the "
              f"other {len(prefill_ms) - 1} {statistics.mean(prefill_ms[1:]):.2f}")
        print(f"[lm] {smi}: {arch} decode step: graph captures {step.captures}, replays "
              f"{step.replays} over {server.steps} steps")
        print(f"[lm] {arch} decode ms per step: p50 {statistics.median(decode_ms):.3f}, "
              f"mean {statistics.mean(decode_ms):.3f}, min {min(decode_ms):.3f}, "
              f"max {max(decode_ms):.3f}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
              f"{', '.join(f'{k} {n}' for k, n in counts.items() if n)}; decode state h2d "
              f"bytes {state_h2d}")

        # [profile]: the decode profile holds one "compute" a step and one a
        # slot release (the JAX LMServer's counts) and no "transfer"; the
        # samples stay one a step.  The prefill profile: a "compute" a prefill
        # and a splice, a "transfer" a prompt (and its frames), and the zero
        # state's, made with the server
        dec, pre = server.decode_profile, server.prefill_profile
        want_dec = {"compute": server.steps + len(lengths)}
        uploads = (2 if enc_len else 1) * server.admitted + 1
        want_pre = {"transfer": uploads, "compute": 2 * server.admitted}
        if (phase_counts(dec) != want_dec or len(dec.samples) != server.steps
                or phase_counts(pre) != want_pre):
            raise SystemExit(f"chip_smoke: [profile] {arch} LMServer: decode phases "
                             f"{phase_counts(dec)} over {len(dec.samples)} samples, expected "
                             f"{want_dec} over {server.steps}; prefill phases "
                             f"{phase_counts(pre)}, expected {want_pre}")
        print(f"[profile] {smi}: LMServer {arch} at full width: decode phases compute "
              f"{len(dec.phases['compute'])} (one a step, {server.steps}, and one a slot "
              f"release, {len(lengths)}; {dec.phase_total('compute') * 1e3:.3f} ms), no "
              f"transfer; samples {len(dec.samples)} (a step's compute is its sample), p50 "
              f"{dec.p50() * 1e3:.3f}, p99 "
              f"{dec.p99() * 1e3:.3f}; prefill phases "
              + ", ".join(f"{k} {len(v)} ({sum(v) * 1e3:.3f} ms)" for k, v in pre.phases.items()))

        # a prompt length seen before: the first request twice more (with its
        # frames)
        n_before = len(results)
        for _ in range(2):
            server.submit(prompts[0], frames=frames[0])
        results = server.run()
        repeat_ms = [t * 1e3 for t in server.prefill_profile.samples[n_before:]]
        eager_procs = ([p.build().executor for p in server._prefill_pipes.values()]
                       + list(server._splice.values()) + list(server._release.values()))
        captured = [type(p).__name__ for p in eager_procs if p.captures or p.replays]
        repeats = results[n_before:]
        if (captured or any(r[0] != results[0][0] for r in repeats)
                or any(len(r) != 32 or not all(0 <= t < cfg.vocab for t in r) for r in repeats)
                or (step.captures, step.replays) != (1, server.steps - 1)):
            raise SystemExit(f"chip_smoke: {arch}: the repeated prompt length: captured "
                             f"{captured}, first tokens {[r[0] for r in repeats]} against "
                             f"{results[0][0]}, decode step {step.captures} captures and "
                             f"{step.replays} replays over {server.steps} steps")
        print(f"[lm] {smi}: {arch} first prompt ({lengths[0]} tokens"
              f"{', its frames' if enc_len else ''}) twice more: "
              f"prefill ms {', '.join(f'{t:.2f}' for t in repeat_ms)} (eager; no prefill, "
              f"splice or release captured), first tokens equal the first request's, the 32 "
              f"tokens of each equal to it {sum(r == results[0] for r in repeats)} of 2 (every "
              f"row decodes at the batch's largest position, so later tokens depend on the "
              f"other slots); decode step replays {step.replays} over "
              f"{server.steps} steps; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        if enc_len:
            # every prefill pipe reads the server's one frames Data
            holders = [h for h, d in app._data.items() if "frames" in d.names]
            frames_h2d = app.h2d_bytes.get(server._frames_h, 0)
            if (holders != [server._frames_h]
                    or frames_h2d != server.admitted * frames[0].nbytes):
                raise SystemExit(f"chip_smoke: {arch}: frames Data registered {holders} "
                                 f"(expected [{server._frames_h}]), {frames_h2d} bytes "
                                 f"uploaded over {server.admitted} admissions")
            print(f"[lm] {arch}: {len(server._prefill_pipes)} prefill pipes read "
                  f"{len(holders)} frames Data; {frames_h2d} bytes uploaded into it over "
                  f"{server.admitted} admissions")
        del server, frames
        wall(f"{arch} served")

        # whole model, 2 layers at full width: the same weights on the card
        # (kernels) and on the CPU (plain versions), teacher-forced from the
        # CPU f32 run, compared against the CPU f32 logits:
        # * the card in f32: the kernels only sum in another order, so
        #   max |card - cpu| <= 1e-3 * max |cpu logit|;
        # * the card in bf16: activations round at every layer boundary, so
        #   the logits agree to a share of their scale: 2e-2 * max |logit|
        #   for the dense and encdec families; 5e-2 * max |logit| for RWKV6,
        #   whose bf16 rounding of the decay and of the group-normed WKV
        #   output costs more: the CPU alone (plain versions) puts its bf16
        #   logits 3.0-3.2 % of max |logit| from its f32 ones on these
        #   weights, and an H100 in bf16 read 3.5 %; 4e-2 * max |logit| for
        #   the MoE family (granite-moe, deepseek), whose bf16 router inputs
        #   flip some (token, k) expert choices (0.5-1.3 % of them, the CPU
        #   alone as much as the card) and whose random expert stacks take
        #   the reference's fan-in of E, not D, so their outputs are large
        #   beside the residual: the CPU alone puts its bf16 logits 1.3-2.0 %
        #   of max |logit| from its f32 ones on these weights, and an H100 in
        #   bf16 read 1.4-2.1 % (twice the CPU's own gap is the bound);
        #   for the hybrid family (zamba2) the larger of 5e-2 * max |logit|
        #   and twice the CPU's own bf16 gap at the same step: its bf16
        #   rounding of the in_proj output (dt, B, C, x) compounds through
        #   the chunked scan, about 1 % of the residual a Mamba2 layer, so
        #   the CPU alone puts its bf16 logits 3.9-14.1 % of max |logit|
        #   from its f32 ones on these weights, and the JAX package's own
        #   bf16 run 5.8-24.5 % at width 640 (two runs of
        #   tools/bf16_gap.py on a CPU): no fixed band under 5e-2 holds
        #   the reference's math.  The CPU's
        #   own bf16 gap is printed beside both.
        # (deepseek: "2 layers" is the dense layer 0 and one stacked layer;
        # zamba2: one superblock, the shared block and 6 Mamba2 layers;
        # internvl2: the prefill takes a 256-patch f32 prefix first)
        if enc_len:
            two = cfg.scaled(enc_layers=2, dec_layers=2, n_layers=4)
            cut, depth = ("enc_layers", "dec_layers"), 2
        elif cfg.family == "hybrid":
            two, cut, depth = cfg.scaled(n_layers=cfg.attn_every), ("mamba_layers",), 1
        else:
            two, cut = cfg.scaled(n_layers=2), ("layers",)
            depth = 2 - (1 if cfg.first_dense_ff else 0)
        two32 = two.scaled(param_dtype="float32", dtype="float32")
        p_bf16 = dict(params, **{k: tree_map(lambda a: a[:depth], params[k]) for k in cut})
        p_f32 = tree_map(lambda a: a.float(), p_bf16)
        cpu = torch.device("cpu")
        runs = {"card bf16": (build_model(two), p_bf16, dev),
                "card f32": (build_model(two32), p_f32, dev),
                "cpu f32": (build_model(two32), tree_map(lambda a: a.cpu(), p_f32), cpu)}
        if cfg.family in ("ssm", "moe", "hybrid"):
            runs["cpu bf16"] = (build_model(two), tree_map(lambda a: a.cpu(), p_bf16), cpu)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 64)))
        audio_in = (torch.from_numpy(rng.standard_normal((1, enc_len, cfg.d_model),
                                                         dtype=np.float32)),) if enc_len else ()
        n_patch = cfg.n_patches if cfg.family == "vlm" else 0
        prefix = {"prefix_embeds": torch.from_numpy(rng.standard_normal(
            (1, n_patch, cfg.d_model), dtype=np.float32))} if n_patch else {}
        cache_args = (1, 128 + n_patch) + ((enc_len,) if enc_len else ())
        caches = {k: m.init_cache(*cache_args, device=d) for k, (m, _, d) in runs.items()}
        logits = {k: [] for k in runs}
        # each MoE layer's (token, k) router choices, by run (the layer's
        # dispatch, read through the module the forward calls)
        choices = {k: [] for k in runs}
        moe_inner = moe_mod._moe

        def recording(run):
            def _moe(p, x, c):
                out = moe_inner(p, x, c)
                choices[run].append(out[2].cpu())
                return out
            return _moe

        try:
            for k, (m, prm, d) in runs.items():
                moe_mod._moe = recording(k)
                lg, caches[k] = m.prefill(prm, *(a.to(d) for a in audio_in), toks.to(d),
                                          caches[k], **{n: a.to(d) for n, a in prefix.items()})
                logits[k].append(lg.float().cpu())
            for i in range(4):
                tok = logits["cpu f32"][-1].argmax(dim=-1).to(torch.int32)
                for k, (m, prm, d) in runs.items():
                    moe_mod._moe = recording(k)
                    lg, caches[k] = m.decode_step(
                        prm, tok.to(d),
                        torch.tensor(n_patch + 64 + i, dtype=torch.int32, device=d),
                        caches[k])
                    logits[k].append(lg.float().cpu())
        finally:
            moe_mod._moe = moe_inner
        if cfg.n_experts:
            # a choice flips where one run picks an expert the CPU f32 run does
            # not (the order within the top k does not change the output)
            def flips(run):
                n = diff = 0
                for a, b in zip(choices[run], choices["cpu f32"]):
                    same = (a[..., :, None] == b[..., None, :]).any(-1)
                    n, diff = n + same.numel(), diff + int((~same).sum())
                return diff, n
            flip = {k: flips(k) for k in runs if k != "cpu f32"}
            print(f"[lm-check] {arch}{'' if enc_len else ' 2 layers'}: router choices "
                  f"(token, k) that differ from the CPU f32 run's, prefill of 64 tokens and "
                  f"4 decode steps over {len(choices['cpu f32'])} MoE layer calls: "
                  + ", ".join(f"{k} {d} of {n} ({100 * d / n:.3f} %)"
                              for k, (d, n) in flip.items()))
        layers = (f" 2+2 layers, {enc_len} frames," if enc_len
                  else " one superblock," if cfg.family == "hybrid"
                  else f" 2 layers, {n_patch}-patch prefix," if n_patch else "")
        failed = []
        for step, label in enumerate(["prefill last-token logits"]
                                     + [f"decode step {i} logits" for i in range(4)]):
            want = logits["cpu f32"][step]
            scale = float(want.abs().max())
            gap = {k: float((v[step] - want).abs().max()) for k, v in logits.items()}
            limits = {"card f32": 1e-3 * scale,
                      "card bf16": BF16_BAND.get(cfg.family, 2e-2) * scale}
            if cfg.family == "hybrid":
                limits["card bf16"] = max(limits["card bf16"], 2 * gap["cpu bf16"])
            ok = all(gap[k] <= lim for k, lim in limits.items()) and all(
                bool(torch.isfinite(v[step]).all()) for v in logits.values())
            print(f"[lm-check] {arch}{layers} {label}: max |card - cpu f32| in f32 "
                  f"{gap['card f32']:.4e} (limit {limits['card f32']:.4e}), in bf16 "
                  f"{gap['card bf16']:.4e} (limit {limits['card bf16']:.4e})"
                  + (f"; cpu bf16 - cpu f32 {gap['cpu bf16']:.4e}" if "cpu bf16" in gap else "")
                  + f"; max |logit| {scale:.4e} {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(label)
        if failed:               # after every step's line is printed
            raise SystemExit(f"chip_smoke: 2-layer {arch} {', '.join(failed)} disagree with "
                             "the CPU")
        del runs, caches
        wall(f"{arch} card against CPU")
        eager_against_replayed(cfg, two, p_bf16, rng, enc_len=enc_len)
        if cfg.family == "dense":
            engine_against_server(two, p_bf16, rng)
        wall(f"after {arch}")
        return counts

    def device_weights(app, model, params):
        """``params`` (tensors on the card) as a weights Data of ``app``:
        a spec-only arena on the card filled by device copies, so the
        weights make no round trip through the host."""
        weights, wcodec = weights_data(model.param_specs())
        app.addData(weights)
        views = weights.device_views()
        for leaf, t in wcodec.flatten(params).items():
            views[leaf].copy_(t)
        return weights, wcodec

    def engine_against_server(two, p_bf16, rng):
        """``ServeEngine`` (the former API, a shim over ``LMServer``) on the
        2-layer full-width model: 3 prompts, 2 slots, 8 new tokens; its
        tokens must be ``LMServer``'s.  Both read one weights Data."""
        app = CLapp().init()
        model = build_model(two)
        weights, _ = device_weights(app, model, p_bf16)
        prompts = [rng.integers(0, two.vocab, n).tolist() for n in (17, 40, 64)]
        outs = {}
        for cls in (LMServer, ServeEngine):
            srv = cls(model, weights, batch=2, max_len=128,
                      sampling=SamplingConfig(max_new_tokens=8), app=app)
            for pr in prompts:
                srv.submit(pr)
            outs[cls.__name__] = srv.run()
        same = outs["LMServer"] == outs["ServeEngine"]
        print(f"[lm-check] {smi}: 2-layer {two.name}: ServeEngine tokens == LMServer tokens "
              f"({len(prompts)} prompts, 8 new tokens, 2 slots): {same}")
        if not same or any(len(r) != 8 for r in outs["ServeEngine"]):
            raise SystemExit(f"chip_smoke: ServeEngine tokens {outs['ServeEngine']} differ from "
                             f"LMServer's {outs['LMServer']}")

    def eager_against_replayed(cfg, two, p_bf16, rng, steps=32, enc_len=None):
        """The 2-layer full-width model through ``DecodeSession``: ``steps``
        eager decode steps (``init()`` before each keeps the launch eager),
        then from the same prefilled state ``steps`` replays of the step's
        graph (an encoder-decoder prefilled through the fan-in graph from
        ``enc_len`` frames a row).  The tokens must be identical; the decode state bit for bit,
        since the replay runs the same kernels on the same addresses.  If it
        is not (cuBLAS chose another algorithm under capture), the max abs
        difference of each cache leaf is printed and one more step's logits
        from either state are held to the bands of ``PERF.md`` §2."""
        app = CLapp().init(PlatformTraits(), DeviceTraits())
        model = build_model(two)
        weights, wcodec = device_weights(app, model, p_bf16)
        sess = DecodeSession(app, model, weights, batch=4, max_len=256, enc_len=enc_len)
        frames = (rng.standard_normal((4, enc_len, two.d_model), dtype=np.float32)
                  if enc_len else None)
        sess.prefill(rng.integers(0, two.vocab, (4, 64)).astype(np.int32), frames=frames)
        step = sess.decode_pipe.build().executor
        blob = sess.state.device_blob
        start = blob.clone()
        eager = []
        for _ in range(steps):
            step.init()
            eager.append(sess.step())
        eager_state = blob.clone()
        blob.copy_(start)
        replayed = [sess.step() for _ in range(steps)]
        if (step.captures, step.replays) != (1, steps):
            raise SystemExit(f"chip_smoke: 2-layer {cfg.name}: {step.captures} captures and "
                             f"{step.replays} replays, expected 1 and {steps}")
        same_tokens = all(np.array_equal(a, b) for a, b in zip(eager, replayed))
        same_state = bool(torch.equal(eager_state, blob))
        gaps = ""
        if not same_state:
            layout = sess.state.layout
            eager_views = {e.name: device_view(eager_state, e) for e in layout.entries}
            now = sess.state.device_views()
            gaps = "; max abs difference by leaf: " + ", ".join(
                f"{n} {float((now[n].float() - v.float()).abs().max()):.4e}"
                for n, v in eager_views.items() if v.dtype.is_floating_point)
            params = wcodec.unflatten(weights.device_views())
            logits = []
            for state in (eager_views, now):
                cache = sess.ccodec.unflatten({n: state[n].clone() for n in sess.ccodec.names})
                lg, _ = model.decode_step(params, state["token"].clone(),
                                          state["positions"].max(), cache)
                logits.append(lg.float())
            scale = float(logits[0].abs().max())
            band = BF16_BAND.get(cfg.family, 2e-2) * scale
            gap = float((logits[1] - logits[0]).abs().max())
            gaps += f"; next-step logits max abs difference {gap:.4e} (limit {band:.4e})"
            if gap > band:
                raise SystemExit(f"chip_smoke: 2-layer {cfg.name}: replayed logits outside "
                                 "the band")
        print(f"[lm-check] {smi}: 2-layer {cfg.name}, {steps} eager against {steps} replayed "
              f"decode steps (batch 4, 64-token prompts"
              f"{f', {enc_len} frames a row, fan-in prefill' if enc_len else ''}): "
              f"tokens identical {same_tokens}, "
              f"decode state bit for bit {same_state}{gaps}")
        if not same_tokens:
            raise SystemExit(f"chip_smoke: 2-layer {cfg.name}: replayed tokens differ")

    def dense_kernels(cfg, server):
        """A decoder forward: ln_attn and ln_mlp a layer, q_norm and k_norm
        with qk-norm, the kv latent's norm with MLA, the final norm; flash
        attention a layer of a prefill, none with MLA (plain-torch
        attention, the reference's) and none in a decode step."""
        per_layer = 2 + 2 * cfg.qk_norm + cfg.mla
        return {"rmsnorm": (per_layer * cfg.n_layers + 1) * (server.admitted + server.steps),
                "flash_attention": 0 if cfg.mla else cfg.n_layers * server.admitted}

    def rwkv_kernels(cfg, server):    # ln0, ln1 and ln2 per layer, final norm
        forwards = server.admitted + server.steps
        return {"rmsnorm": (2 * cfg.n_layers + 2) * forwards,
                "wkv6": cfg.n_layers * forwards, "flash_attention": 0}

    def whisper_kernels(cfg, server):  # every encoder and decoder prefill layer
        return {"flash_attention": (cfg.enc_layers + cfg.dec_layers) * server.admitted,
                "rmsnorm": 0, "wkv6": 0}

    def hybrid_kernels(cfg, server):
        """A Zamba2 forward: ln a Mamba2 layer, ln_attn and ln_mlp a
        superblock (the shared block's), the final norm (the gated norm
        inside Mamba2 is inline f32, the reference's); flash attention once
        a superblock of a prefill."""
        n_super = cfg.n_layers // cfg.attn_every
        return {"rmsnorm": (cfg.n_layers + 2 * n_super + 1) * (server.admitted + server.steps),
                "flash_attention": n_super * server.admitted, "wkv6": 0}

    lm_counts = serve_full_width("qwen3-14b", dense_kernels)
    gc.collect()                      # free the qwen3-14b weights and server
    torch.cuda.empty_cache()
    rwkv_counts = serve_full_width("rwkv6-3b", rwkv_kernels)
    gc.collect()
    torch.cuda.empty_cache()
    whisper_counts = serve_full_width("whisper-large-v3", whisper_kernels, enc_len=1500)
    gc.collect()
    torch.cuda.empty_cache()
    # minitron, the MoE pair (deepseek's 31.4 GB of weights only after the
    # others' are freed), then the hybrid and the VLM
    new_counts = []
    for arch, expect in (("minitron-8b", dense_kernels), ("granite-moe-1b-a400m", dense_kernels),
                         ("deepseek-v2-lite-16b", dense_kernels),
                         ("zamba2-2.7b", hybrid_kernels), ("internvl2-2b", dense_kernels)):
        new_counts.append(serve_full_width(arch, expect))
        gc.collect()
        torch.cuda.empty_cache()

    wall("before section 7t")
    # -- 7t. training: the backward kernels, h2o-danube-1.8b, lm-100m ---------
    from repro_torch.ckpt import latest_step
    from repro_torch.core.arena import torch_dtype, tree_flatten, tree_unflatten
    from repro_torch.data.pipeline import StreamConfig, TokenStream
    from repro_torch.kernels.flash_attention import _forward as flash_forward
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd
    from repro_torch.kernels.wkv6 import CHUNK as wkv6_chunk
    from repro_torch.kernels.wkv6 import _forward as wkv6_forward
    from repro_torch.kernels.wkv6 import wkv6_bwd
    from repro_torch.launch import train_lm
    from repro_torch.optim import adamw_update
    from repro_torch.train import Trainer, TrainProcess, make_train_state, make_train_step
    from repro_torch.train.step import loss_and_grads

    train_counts: dict = {}       # the main path's launches in the training runs

    def add_counts(counts):
        for k, v in counts.items():
            train_counts[k] = train_counts.get(k, 0) + v

    def grads_check(label, kname, got, want, names, dtype, on_path):
        """Each gradient against the plain backward's: bf16 within 2e-2 x
        max |grad| (one rounding of each output plus sums in another
        order), f32 within rtol 1e-4 + 1e-5 x max |grad|."""
        for g, w, nm in zip(got, want, names):
            scale = float(w.float().abs().max())
            tol = (0.0, 2e-2 * scale) if dtype == bf16 else (1e-4, 1e-5 * scale)
            check(f"{label} {nm}", kname, g.float(), w.float(), tol, on_path)

    def same_twice(label, first, second):
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            raise SystemExit(f"chip_smoke: [train-kernels] {label}: two runs differ")

    def train_kernels_phase():
        """[train-kernels]: rmsnorm_bwd and flash_attention_bwd (the
        gradients of the kernels of src/repro/kernels/rmsnorm.py:40 and
        flash_attention.py:124, which have no TPU kernel of their own: the
        "replaces" of their rows names the forward's) against the
        plain backward (autograd through ref.rmsnorm / ref.attention) at the
        training shapes, each run twice (bit for bit); a forward with the
        log-sum-exp writes the same output bit for bit as one without;
        rows that see no key get zero gradient; times against bound and
        library call; ptxas's registers, spills and shared memory."""
        for shape, dtype, w_dtype, on_path in (
                ((4 * 2048, 2560), bf16, bf16, True),      # h2o-danube-1.8b, batch 4 x 2048
                ((8 * 256, 768), f32, f32, True),          # lm-100m, batch 8 x 256
                ((2 * 2048, 2560), bf16, bf16, True),      # [mesh-lm]: a 2-row danube lane
                ((4 * 256, 768), f32, f32, True),          # [mesh-lm]: a 4-row lm-100m lane
                ((2048, 2048), f32, f32, True),            # [mesh-tp]: a deepseek f32 lane
                ((2048, 512), f32, f32, True),             # and its kv latents
                ((1024, 5120), bf16, bf16, False),         # qwen3-14b hidden rows
                ((40 * 1024, 128), bf16, bf16, False),     # qwen3-14b q/k-norm rows
                ((2 * 12, 16), f32, f32, False),           # SMOKE head width
                ((7, 5120), f32, bf16, False), ((300, 2560), bf16, f32, False)):
            x, w, dy = rand(*shape, dtype=dtype), rand(shape[-1], dtype=w_dtype), \
                rand(*shape, dtype=dtype)
            got = rmsnorm_bwd(x, w, dy)
            same_twice(f"rmsnorm_bwd {shape}", got, rmsnorm_bwd(x, w, dy))
            grads_check(f"rmsnorm_bwd {shape} {dtype} weight {w_dtype}", "rmsnorm_bwd", got,
                        ref.rmsnorm_bwd(x, w, dy), ("dx", "dw"), dtype, on_path)
        del x, w, dy, got
        bwd_cases = (  # q shape, kv shape, causal, window, dtype, on the path
            ((4, 32, 2048, 80), (4, 8, 2048, 80), True, 4096, bf16, True),   # h2o-danube-1.8b
            ((1, 32, 5120, 80), (1, 8, 5120, 80), True, 4096, bf16, False),  # the window active
            ((1, 32, 333, 80), (1, 8, 333, 80), True, 100, bf16, False),     # ragged at 64, window
            ((1, 40, 1024, 128), (1, 8, 1024, 128), True, None, bf16, False),  # qwen3-14b
            ((8, 12, 256, 64), (8, 4, 256, 64), True, None, f32, True),      # lm-100m
            ((2, 4, 37, 16), (2, 2, 37, 16), True, 8, f32, False),           # SMOKE, window 8
            ((2, 4, 37, 16), (2, 2, 37, 16), True, None, bf16, False),
            ((2, 8, 100, 64), (2, 2, 100, 64), False, None, bf16, False),    # non-causal
            ((1, 4, 77, 80), (1, 1, 77, 80), False, None, f32, False),
            ((2, 6, 70, 128), (2, 2, 90, 128), True, 33, f32, False),       # Sq < Skv
            # whisper-large-v3's encoder over 1500 frames, non-causal (1500 is
            # no multiple of the 64-row tiles) and its decoder's 448 tokens,
            # batch 8; zamba2-2.7b's shared block, MHA, batch 4 x 2048
            ((8, 20, 1500, 64), (8, 20, 1500, 64), False, None, bf16, True),
            ((8, 20, 448, 64), (8, 20, 448, 64), True, None, bf16, True),
            ((4, 32, 2048, 80), (4, 32, 2048, 80), True, None, bf16, True),
            # [mesh-lm]: a 2-row lane of h2o-danube-1.8b, a 4-row lane of lm-100m
            ((2, 32, 2048, 80), (2, 8, 2048, 80), True, 4096, bf16, True),
            ((4, 12, 256, 64), (4, 4, 256, 64), True, None, f32, True),
            # [mesh-tp]: a lane's heads of h2o-danube-1.8b over model 2 and of
            # lm-100m over model 2
            ((4, 16, 2048, 80), (4, 4, 2048, 80), True, 4096, bf16, True),
            ((8, 6, 256, 64), (8, 2, 256, 64), True, None, f32, True),
            # [mesh-tp] parts 5 and 6: a lane's heads of zamba2-2.7b's shared
            # block and of whisper-large-v3's encoder and decoder over a (1, 2)
            # group, bf16 (TrainProcess) and f32 (the cut)
            ((4, 16, 2048, 80), (4, 16, 2048, 80), True, None, bf16, True),
            ((4, 16, 2048, 80), (4, 16, 2048, 80), True, None, f32, True),
            ((8, 10, 1500, 64), (8, 10, 1500, 64), False, None, bf16, True),
            ((8, 10, 1500, 64), (8, 10, 1500, 64), False, None, f32, True),
            ((8, 10, 448, 64), (8, 10, 448, 64), True, None, bf16, True),
            ((8, 10, 448, 64), (8, 10, 448, 64), True, None, f32, True))
        for qs, ks, causal, window, dtype, on_path in bwd_cases:
            q, k, v = rand(*qs, dtype=dtype), rand(*ks, dtype=dtype), rand(*ks, dtype=dtype)
            do = rand(*qs, dtype=dtype)
            scale = qs[-1] ** -0.5
            o, lse = flash_forward(q, k, v, causal, window, scale, True)
            if not torch.equal(o, flash_forward(q, k, v, causal, window, scale, False)[0]):
                raise SystemExit(f"chip_smoke: flash_attention q{qs}: the output with the "
                                 "log-sum-exp differs from the one without")
            got = flash_attention_bwd(q, k, v, o, do, lse, causal=causal, window=window)
            same_twice(f"flash_attention_bwd q{qs}", got,
                       flash_attention_bwd(q, k, v, o, do, lse, causal=causal, window=window))
            grads_check(f"flash_attention_bwd q{qs} kv{ks} causal={causal} window={window} "
                        f"{dtype}", "flash_attention_bwd", got,
                        ref.attention_bwd(q, k, v, o, do, causal=causal, window=window),
                        ("dq", "dk", "dv"), dtype, on_path)
            del q, k, v, do, o, lse, got
            torch.cuda.empty_cache()
        # 20 of 70 queries see no key (causal, queries aligned to the end of
        # 50 keys): their dq is 0 and they add nothing to dk, dv; the plain
        # version (which gives such rows a uniform softmax) is held against
        # the kernel with their output gradient zeroed
        for dtype in (bf16, f32):
            q, k, v = rand(1, 4, 70, 64, dtype=dtype), rand(1, 2, 50, 64, dtype=dtype), \
                rand(1, 2, 50, 64, dtype=dtype)
            do = rand(1, 4, 70, 64, dtype=dtype)
            o, lse = flash_forward(q, k, v, True, None, 0.125, True)
            got = flash_attention_bwd(q, k, v, o, do, lse)
            do0 = do.clone()
            do0[:, :, :20] = 0
            got0 = flash_attention_bwd(q, k, v, o, do0, lse)
            if not (bool((got[0][:, :, :20] == 0).all()) and torch.equal(got[1], got0[1])
                    and torch.equal(got[2], got0[2]) and bool(torch.isinf(lse[:, :, :20]).all())):
                raise SystemExit(f"chip_smoke: flash_attention_bwd {dtype}: rows that see no "
                                 "key changed the gradients")
            grads_check(f"flash_attention_bwd rows without keys {dtype}", "flash_attention_bwd",
                        got0, ref.attention_bwd(q, k, v, o, do0), ("dq", "dk", "dv"), dtype,
                        False)
        print(f"[train-kernels] rows that see no key: dq 0, nothing added to dk and dv, lse "
              "+inf (bf16 and f32)")

        # wkv6_bwd (with the training forward's checkpoints) at the rwkv6-3b
        # training shape (bf16 r/k/v and output gradient, f32 w, no state), a
        # ragged bf16 case with a state and a final-state gradient (77 steps:
        # two 32-step chunks and 13), ragged f32 at head size 64 and the SMOKE
        # head size 8, and w + 7 (w clamped at -2 first, so exp(-exp(w)) is 0
        # in f32 at every step: dw must be exactly 0) in bf16 and f32, each
        # against autograd through ref.wkv6 and run twice bit for bit; the
        # training forward's output and final state are the serving
        # forward's bit for bit
        for shape, dtype, stateful, on_path, shift in (
                ((4, 2048, 40, 64), bf16, False, True, 0.0),
                # [mesh-tp] part 4: a lane's 20 heads over a (1, 2) group
                ((4, 2048, 20, 64), bf16, False, True, 0.0),
                ((4, 2048, 20, 64), f32, False, True, 0.0),
                ((3, 77, 40, 64), bf16, True, False, 0.0),
                ((2, 37, 3, 64), f32, True, False, 0.0), ((2, 100, 4, 8), f32, True, False, 0.0),
                ((3, 77, 40, 64), bf16, True, False, 7.0), ((2, 69, 3, 64), f32, True, False, 7.0),
                ((2, 100, 4, 8), f32, True, False, 7.0)):
            b_, t_, h_, d_ = shape
            r, k, v, w, u, s0 = wkv_inputs(*shape, dtype)
            s0 = s0 if stateful else None
            if shift:   # w >= 5: exp(-exp(w)) < 1e-64, 0 in f32 at every step
                w = w.clamp(min=-2.0) + shift
                if bool(torch.exp(-torch.exp(w)).any()):
                    raise SystemExit(f"chip_smoke: wkv6_bwd {shape} w + {shift}: a decay "
                                     "does not underflow")
            do = rand(*shape, dtype=dtype)
            ds = rand(b_, h_, d_, d_) if stateful else None
            o_ck, s_ck, ckpt = wkv6_forward(r, k, v, w, u, s0, None, with_ckpt=True)
            o_sv, s_sv = wkv6(r, k, v, w, u, s0)
            if not (torch.equal(o_ck, o_sv) and torch.equal(s_ck, s_sv)):
                raise SystemExit(f"chip_smoke: wkv6 {shape}: the training forward's output or "
                                 "state differs from the serving forward's")
            names = ("dr", "dk", "dv", "dw", "du") + (("ds0",) if stateful else ())
            got = wkv6_bwd(r, k, v, w, u, s0, do, ds, ckpt=ckpt)[:len(names)]
            same_twice(f"wkv6_bwd {shape}", got,
                       wkv6_bwd(r, k, v, w, u, s0, do, ds, ckpt=ckpt)[:len(names)])
            want = ref.wkv6_bwd(r, k, v, w, u, s0, do, ds)[:len(names)]
            label = (f"wkv6_bwd {shape} {dtype}"
                     f"{' state and final-state gradient' if stateful else ''}"
                     f"{f' w + {shift}' if shift else ''}")
            if not all(bool(torch.isfinite(g.float()).all()) for g in got):
                raise SystemExit(f"chip_smoke: {label}: a gradient is not finite")
            if shift and bool(got[3].any()):
                raise SystemExit(f"chip_smoke: {label}: dw is not 0 where every decay is")
            grads_check(label, "wkv6_bwd", got, want, names, dtype, on_path)
            if shift:
                print(f"[train-kernels] {label}: every decay 0 in f32, dw exactly 0, finite, "
                      "twice bit for bit")
            if dtype == bf16 and not stateful:
                # the plain version's own bf16 gap: its bf16 run against its f32
                # run on the same (bf16-valued) inputs, beside the kernel's
                want32 = ref.wkv6_bwd(r.float(), k.float(), v.float(), w, u, None, do.float())
                gaps = [(float((g.float() - x).abs().max() / x.abs().max()),
                         float((p_.float() - x).abs().max() / x.abs().max()))
                        for g, p_, x in zip(got, want, want32)]
                print(f"[train-kernels] {smi}: wkv6_bwd {shape} bf16, max |err| / max |grad| "
                      f"against the plain version's f32 run, kernel vs plain bf16: "
                      + ", ".join(f"{nm} {kg:.3e} vs {pg:.3e}" for nm, (kg, pg) in
                                  zip(names, gaps)))
                del want32
            del r, k, v, w, u, s0, do, ds, o_ck, s_ck, ckpt, o_sv, s_sv, got, want
            torch.cuda.empty_cache()

        # times at the h2o-danube-1.8b training shapes
        bt = backward_times(rand)
        x, w, dy = bt["rmsnorm_args"]
        bound_ms, bound_by, cost_txt = bound_of("rmsnorm_bwd", x, w, dy)
        ms, lib_ms = bt["rmsnorm_bwd_ms"], bt["rms_norm_backward_ms"]
        plain_ms = loop_ms(lambda: ref.rmsnorm_bwd(x, w, dy), reps=10)
        host_ms = call_ms(lambda: rmsnorm_bwd(x, w, dy))
        xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y_lib = F.rms_norm(xg, (x.shape[-1],), wg, 1e-6)
        lib_host_ms = call_ms(lambda: torch.autograd.grad(y_lib, (xg, wg), dy, retain_graph=True))
        del xg, wg, y_lib
        rows["rmsnorm_bwd"] = dict(name="rmsnorm_bwd", route="cuda", source=LM_SRC,
                                   replaces="src/repro/kernels/rmsnorm.py:40", ms=ms,
                                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                   library_ms=lib_ms, max_abs_err=max_err["rmsnorm_bwd"])
        print(f"[time] {smi}: rmsnorm_bwd at x (8192, 2560) bf16 (h2o-danube-1.8b, batch 4 x "
              f"2048), device ms a call: kernel {ms:.5f}, plain {plain_ms:.5f}, library "
              f"(F.rms_norm backward) {lib_ms:.5f}, bound {bound_ms:.5f} ({bound_by}: "
              f"{cost_txt}); one host call: kernel {host_ms:.5f}, library {lib_host_ms:.5f}")
        del x, w, dy
        q, k, v, o, do, lse = bt["flash_args"]
        ms, lib_ms = bt["flash_attention_bwd_ms"], bt["sdpa_backward_ms"]
        del bt
        bound_ms, bound_by, cost_txt = bound_of("flash_attention_bwd", q, k, v, o, do, lse,
                                                causal=True, window=4096)
        plain_ms = loop_ms(lambda: ref.attention_bwd(q, k, v, o, do, causal=True, window=4096),
                           reps=2)
        fwd_ms = loop_ms(lambda: flash_forward(q, k, v, True, 4096, 80 ** -0.5, True))
        host_ms = call_ms(lambda: flash_attention_bwd(q, k, v, o, do, lse, causal=True,
                                                      window=4096), reps=5)
        qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
        o_lib = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
        lib_host_ms = call_ms(lambda: torch.autograd.grad(o_lib, (qg, kg, vg), do,
                                                          retain_graph=True), reps=5)
        del qg, kg, vg, o_lib
        rows["flash_attention_bwd"] = dict(
            name="flash_attention_bwd", route="cuda", source=LM_SRC,
            replaces="src/repro/kernels/flash_attention.py:124", ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
            max_abs_err=max_err["flash_attention_bwd"])
        print(f"[time] {smi}: flash_attention_bwd at q (4, 32, 2048, 80) kv (4, 8, 2048, 80) "
              f"bf16 causal window 4096 (h2o-danube-1.8b, a layer), device ms a call: kernel "
              f"{ms:.5f}, plain {plain_ms:.5f}, library (SDPA backward, enable_gqa) "
              f"{lib_ms:.5f}, bound {bound_ms:.5f} ({bound_by}: {cost_txt}); kernel / bound "
              f"{ms / bound_ms:.1f}, kernel / SDPA backward {ms / lib_ms:.2f}; the forward with "
              f"log-sum-exp {fwd_ms:.5f}; one host call: kernel {host_ms:.5f}, library "
              f"{lib_host_ms:.5f}")
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
        # wkv6_bwd at the rwkv6-3b training shape (a layer: bf16 r/k/v and
        # output gradient, f32 w, no state) with the forward's checkpoints;
        # no PyTorch call computes this gradient, so there is no library time
        wt = wkv6_bwd_times(rand)
        r, k, v, w, u, do, ckpt = wt["wkv6_args"]
        ms, fwd_ms, serve_ms = wt["wkv6_bwd_ms"], wt["wkv6_train_forward_ms"], \
            wt["wkv6_serve_forward_ms"]
        del wt
        plain_ms = loop_ms(lambda: ref.wkv6_bwd(r, k, v, w, u, None, do), reps=1)
        host_ms = call_ms(lambda: wkv6_bwd(r, k, v, w, u, None, do, ckpt=ckpt), reps=5)
        bound_ms, bound_by, cost_txt = bound_of("wkv6_bwd", r, k, v, w, u, None, do)
        rows["wkv6_bwd"] = dict(
            name="wkv6_bwd", route="cuda", source=RWKV_SRC,
            replaces="src/repro/kernels/wkv6.py:82", ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            max_abs_err=max_err["wkv6_bwd"])
        print(f"[time] {smi}: wkv6_bwd at (4, 2048, 40, 64) bf16 r/k/v, f32 w, no state "
              f"(rwkv6-3b, a layer), device ms a call: kernel {ms:.5f}, plain {plain_ms:.5f}, "
              f"library none, bound {bound_ms:.5f} ({bound_by}: {cost_txt}); kernel / bound "
              f"{ms / bound_ms:.1f}; the training forward (with checkpoints every "
              f"{wkv6_chunk} steps, {ckpt.numel() * 4 / 1e6:.1f} MB; the backward's G at each "
              f"chunk's end the same) {fwd_ms:.5f}, the serving forward {serve_ms:.5f}; one host "
              f"call {host_ms:.5f}")
        del r, k, v, w, u, do, ckpt
        log = _build.BUILD_INFO["log"]
        # dynamic shared memory of the bf16 kernels (lm_kernels.cu's
        # dkdv_smem_bytes / dq_smem_bytes: six 64-row bf16 tiles padded to
        # D + 8, and the dK/dV kernel's two (lse, delta) pairs of 64 floats)
        # and of the f32 ones (BwdSmem, at most: 32-row f32 tiles)
        def fma_smem(d):
            return 4 * (2 * 32 * (d + 1) + 2 * 32 * d + 2 * 32 * 33 + 64 + 3)

        for kern, dyn in (
                ("flash_bwd_delta_kernel", lambda d: 0),
                ("flash_bwd_mma_dkdv_kernel", lambda d: 6 * 64 * (d + 8) * 2 + 4 * 64 * 4),
                ("flash_bwd_mma_dq_kernel", lambda d: 6 * 64 * (d + 8) * 2),
                ("flash_bwd_dkdv_kernel", fma_smem), ("flash_bwd_dq_kernel", fma_smem)):
            for d in (80, 64, 128, 16):
                regs, smem, spill = ptxas_usage(log, f"{kern}ILi{d}E")
                label = f"{kern}<D={d}>" + ("" if "mma" in kern or "delta" in kern else " (f32)")
                print(f"[ptxas] {label}: {regs} registers a thread, {spill} bytes spilled, "
                      f"{smem} bytes static shared memory + {dyn(d)} dynamic a block")
        for tag, mangled in (("bf16", "13__nv_bfloat16"), ("f32", "f")):
            for d in (64, 8):
                for kern, dyn in (("wkv6_bwd_contrib_kernel", 0),
                                  ("wkv6_bwd_chunk_kernel", wkv6_bwd_smem(d, tag == "bf16"))):
                    regs, smem, spill = ptxas_usage(log, f"{kern}I{mangled}Li{d}E")
                    print(f"[ptxas] {kern}<{tag}, D={d}>: {regs} registers a thread, {spill} "
                          f"bytes spilled, {smem} bytes static shared memory + {dyn} dynamic a "
                          "block")
                regs, smem, spill = ptxas_usage(log, f"wkv6_kernelI{mangled}Li{d}ELb1E")
                print(f"[ptxas] wkv6_kernel<{tag}, D={d}, checkpoints>: {regs} registers a "
                      f"thread, {spill} bytes spilled, {smem} bytes shared memory a block")
        for kern in ("wkv6_bwd_scan_kernel", "wkv6_bwd_du_kernel"):
            regs, smem, spill = ptxas_usage(log, kern)
            print(f"[ptxas] {kern}: {regs} registers a thread, {spill} bytes spilled, {smem} "
                  "bytes shared memory a block")
        for tmpl in ("Li16E", "Li4E", "Li1E"):
            regs, smem, spill = ptxas_usage(log, "rmsnorm_bwd_kernelI13__nv_bfloat16S", tmpl)
            print(f"[ptxas] rmsnorm_bwd_kernel<bf16, bf16, J={tmpl[2:-1]}>: {regs} registers a "
                  f"thread, {spill} bytes spilled, {smem} bytes shared memory a block")
        for label, frags in (("adamw_update_kernel<bf16, bf16, vector>",
                              ("adamw_update_kernelI13__nv_bfloat16S", "Lb1E")),
                             ("adamw_update_kernel<f32, f32, vector>",
                              ("adamw_update_kernelIffLb1E",)),
                             ("sumsq_partial_kernel<bf16, vector>",
                              ("sumsq_partial_kernelI13__nv_bfloat16Lb1E",)),
                             ("sumsq_final_kernel", ("sumsq_final_kernel",))):
            regs, smem, spill = ptxas_usage(log, *frags)
            print(f"[ptxas] {label}: {regs} registers a thread, {spill} bytes spilled, {smem} "
                  "bytes shared memory a block")
        torch.cuda.empty_cache()

        # AdamW's two kernels (optim/adamw.py): bit for bit against the plain
        # update, the clip's norm deterministic; then one step at danube's
        # full-width leaves against the plain step (and every leaf compared
        # with it), the library's fused AdamW and the bytes bound
        ac = adamw_checks(dev, smi)
        at = adamw_times(dev, peaks)
        rows["adamw_update"] = dict(
            name="adamw_update", route="cuda", source=OPTIM_SRC, replaces="none",
            ms=at["kernel_ms"], plain_ms=at["plain_ms"], bound_ms=at["bound_ms"],
            bound_by="bytes", library_ms=at["library_ms"],
            max_abs_err=max(ac["max_abs_err"], at["max_abs_err"]))
        print(f"[train-kernels] {smi}: adamw_update against the plain update_leaf at "
              f"h2o-danube-1.8b's {at['leaves']} full-width leaves, same scalars: largest ulp "
              f"distance {at['ulps']}, largest |kernel - plain| {at['max_abs_err']!r}"
              f"{' (bit for bit)' if not any(at['ulps'].values()) else ''}; sum_squares leaf "
              f"by leaf against float64: largest gap {at['leaf_gap']:.3e} of the leaf's sum "
              "(limit 1e-6)")
        print(f"[time] {smi}: AdamW step (clip's norm, scalars, an update a leaf) at "
              f"h2o-danube-1.8b's {at['leaves']} full-width leaves ({at['elements']} bf16 "
              f"parameters), median device ms of {at['steps']} steps: kernels "
              f"{at['kernel_ms']:.5f}, plain {at['plain_ms']:.5f}, library (torch._fused_adamw_ "
              f"on f32 master, gradient, m and v; no clip, no cast) {at['library_ms']:.5f}, "
              f"bound {at['bound_ms']:.5f} "
              f"(bytes); kernels / bound {at['kernel_ms'] / at['bound_ms']:.2f}; launches a "
              f"step {at['launches']}")
        torch.cuda.empty_cache()

    def quiet(_msg):
        pass

    def max_diff(a, b):
        return max(float((x.float() - y.float()).abs().max())
                   for (_, x), (_, y) in zip(tree_flatten(a), tree_flatten(b)))

    def cut_of(cfg):
        """The first layers of ``cfg`` that ``[train-check]`` runs, and what
        they are: 2 layers; zamba2's first superblock (the shared block and
        its attn_every Mamba2 layers); whisper's first 2 encoder and 2
        decoder layers."""
        if cfg.family == "hybrid":
            return {"n_layers": cfg.attn_every}, (f"one superblock (the shared block and "
                                                  f"{cfg.attn_every} Mamba2 layers)")
        if cfg.family == "encdec":
            return {"enc_layers": 2, "dec_layers": 2}, "2 encoder and 2 decoder layers"
        return {"n_layers": 2}, "2 layers"

    def train_full_width(arch, steps=6, batch=4, seq=2048, reps=5, enc_frames=0):
        """[train]: ``arch`` at full width, random bf16 weights made on the
        card from seed 0, ``steps`` Trainer steps at batch x seq (and
        ``enc_frames`` frames a sample for an encoder-decoder) on the
        TokenStream (AdamW, constant lr 1e-5): the loss falls; one capture,
        then a replay a step; exact launch counts (init's warm-up forward
        and backward, then each step's forward, remat recompute and
        backward); step p50 over ``reps`` more replays, tokens/s, MFU against
        the bf16 tensor rate, peak memory; a torch.profiler breakdown of one
        replayed step; AdamW alone.  Then ``[train-check]``: the cut of
        :func:`cut_of` on the card against the CPU's f32, and its bf16
        steps replayed against eager ones."""
        run = fit_and_time(arch, dev, peaks, steps=steps, batch=batch, seq=seq, reps=reps,
                           enc_frames=enc_frames)
        cfg, stream, tcfg, state = run["cfg"], run["stream"], run["tcfg"], run["state"]
        n_params, counts, losses = run["n_params"], run["counts"], run["losses"]
        add_counts(counts)
        want = {k: v * (steps + 1) for k, v in per_step_launches(cfg).items()}
        want.update({k: v * steps for k, v in optimizer_launches(run["trainer"].model).items()})
        passes = (run["captures"], run["replays"])
        frames_txt = f" (and {enc_frames} frames a sample)" if enc_frames else ""
        print(f"[train] {smi}: {arch} at full width ({n_params} parameters, bf16, AdamW with "
              f"f32 master, m and v), {steps} Trainer steps at batch {batch} x {seq}{frames_txt} "
              f"on the TokenStream in {run['fit_s']:.1f} s (init's warm-up and capture included): losses "
              f"{', '.join(f'{x:.4f}' for x in losses)}; captures {passes[0]}, replays "
              f"{passes[1]}; launches {counts} (expected {want}: {steps} replayed steps "
              "and init's warm-up forward and backward, each with its remat recompute; "
              "AdamW's kernels in the steps alone)")
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise SystemExit(f"chip_smoke: [train] {arch}: the loss did not fall: {losses}")
        if passes != (1, steps):
            raise SystemExit(f"chip_smoke: [train] {arch}: {passes[0]} captures and "
                             f"{passes[1]} replays; expected 1 and {steps}")
        if {k: counts.get(k, 0) for k in want} != want:
            raise SystemExit(f"chip_smoke: [train] {arch}: launches {counts}, expected {want}")
        p50, model_flops = run["step_p50_ms"], run["model_flops"]
        print(f"[train] {smi}: {arch} replayed step ms (the batch's upload included): "
              f"{', '.join(f'{t:.2f}' for t in run['step_ms'])}; p50 {p50:.2f}; "
              f"{run['tokens_per_s']:.0f} tokens/s; MFU {run['mfu']:.4f} ({run['flops_formula']} "
              f"= {model_flops:.3e} flops a step; bound "
              f"{model_flops / peaks['bf16_tensor'] * 1e3:.1f} ms at the bf16 tensor rate); peak "
              f"memory {run['peak'] / 2**30:.2f} GiB allocated "
              f"({torch.cuda.max_memory_reserved(dev) / 2**30:.2f} GiB reserved) of "
              f"{torch.cuda.get_device_properties(dev).total_memory / 2**30:.2f} GiB")
        print_by_kind(f"[train] {smi}: {arch} one replayed step", run["buckets"], run["other"])
        # the captured step (its graph's memory pool: 40 GiB for zamba2) goes
        # before AdamW runs alone beside the state
        del run["trainer"]
        gc.collect()
        torch.cuda.empty_cache()
        zero_grads = tree_unflatten((n, torch.zeros_like(p))
                                    for n, p in tree_flatten(state["params"]))
        adamw_ms = loop_ms(lambda: adamw_update(state["params"], zero_grads, state["opt"],
                                                tcfg.train.opt), reps=3)
        print(f"[train] {smi}: {arch} AdamW update alone (eager, {n_params} parameters, bf16 "
              f"gradients): {adamw_ms:.2f} ms")
        del run, state, zero_grads
        gc.collect()
        torch.cuda.empty_cache()

        # the cut at full width: loss and every gradient on the card (f32,
        # then bf16) against the CPU's f32; for rwkv6, zamba2 and whisper
        # the CPU also runs bf16, and where its own gap exceeds the danube
        # band, the card's bf16 band is twice that gap
        cut, cut_txt = cut_of(cfg)
        two32 = cfg.scaled(**cut, param_dtype="float32", dtype="float32")
        m32, m16 = build_model(two32), build_model(cfg.scaled(**cut))
        p_cpu = m32.init_params(torch.Generator().manual_seed(1), device="cpu")
        small = {k: torch.from_numpy(np.ascontiguousarray(v[:1, :256]))
                 for k, v in stream.batch_at(0).items()}
        t0 = time.perf_counter()
        want_m, want_g = loss_and_grads(m32, p_cpu, small)
        cpu_s = time.perf_counter() - t0
        want_flat = tree_flatten(want_g)

        def gaps_of(got_m, got_g):
            loss_gap = abs(float(got_m["loss"]) - float(want_m["loss"])) / abs(float(want_m["loss"]))
            gaps = {n: float((g.float().cpu() - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                    for (n, g), (_, w) in zip(tree_flatten(got_g), want_flat)}
            return loss_gap, gaps

        def cast(params, model_d, device):
            """Each leaf in its spec's dtype (a bf16 model keeps rwkv6's u and
            Mamba2's A_log, D and dt_bias in f32)."""
            specs = dict(tree_flatten(model_d.param_specs()))
            return tree_unflatten((n, t.to(device, torch_dtype(specs[n].dtype)))
                                  for n, t in tree_flatten(params))

        bands = dict(TRAIN_BAND)
        if cfg.family in ("ssm", "hybrid", "encdec"):
            cpu16_m, cpu16_g = loss_and_grads(m16, cast(p_cpu, m16, "cpu"), small)
            cpu_loss_gap, cpu_gaps = gaps_of(cpu16_m, cpu16_g)
            cpu_worst = max(cpu_gaps.values())
            danube = TRAIN_BAND["bf16"]
            bands["bf16"] = (danube[0] if cpu_loss_gap <= danube[0] else 2 * cpu_loss_gap,
                             danube[1] if cpu_worst <= danube[1] else 2 * cpu_worst)
            print(f"[train-check] {smi}: {arch} {cut_txt} at full width, batch 1 x 256, CPU bf16 "
                  f"against CPU f32: loss gap {cpu_loss_gap:.3e}, worst gradient leaf "
                  f"{max(cpu_gaps, key=cpu_gaps.get)} {cpu_worst:.3e} x its max |grad|: the "
                  f"card's bf16 band (loss, leaf) {bands['bf16']}")
            del cpu16_g
        for label, model_d in (("f32", m32), ("bf16", m16)):
            p_dev = cast(p_cpu, model_d, dev)
            got_m, got_g = loss_and_grads(model_d, p_dev,
                                          {k: v.to(dev) for k, v in small.items()})
            loss_gap, gaps = gaps_of(got_m, got_g)
            worst = max(gaps, key=gaps.get)
            band = bands[label]
            print(f"[train-check] {smi}: {arch} {cut_txt} at full width, batch 1 x 256, card "
                  f"{label} against CPU f32 ({cpu_s:.1f} s on the CPU): loss {float(got_m['loss']):.6f} "
                  f"vs {float(want_m['loss']):.6f} (gap {loss_gap:.3e} of it, band "
                  f"{band[0]:g}); worst gradient leaf {worst} {gaps[worst]:.3e} x its max |grad| "
                  f"(band {band[1]:g}); median leaf {statistics.median(gaps.values()):.3e}")
            if loss_gap > band[0] or gaps[worst] > band[1]:
                raise SystemExit(f"chip_smoke: [train-check] {arch} {label} outside its band")
            del p_dev, got_g
        del p_cpu, want_g, want_flat
        replay_against_eager(arch, m16, tcfg.train, stream)
        gc.collect()
        torch.cuda.empty_cache()

    def replay_against_eager(arch, model, tcfg, stream, steps=3):
        """[train-check]: the bf16 cut's steps replayed through TrainProcess
        (init's eager forward and backward, one capture, then a replay a
        step) against the same steps run eagerly through make_train_step,
        from equal states, in lockstep: the whole train state bit for bit
        after every step (the bf16 backward kernels run in both), with exact
        launch counts: init's warm-up and ``steps`` replays, and ``steps``
        eager steps.  A check, not the main path: its launches stay out of
        the ``{"kernels"}`` line's."""
        batches = [{k: torch.from_numpy(np.ascontiguousarray(v[:1, :256]))
                    for k, v in stream.batch_at(i).items()} for i in range(steps)]
        reset_launch_counts()
        replayed = make_train_state(model, 0, device=dev)
        eager = make_train_state(model, 0, device=dev)
        if max_diff(replayed, eager) != 0.0:
            raise SystemExit(f"chip_smoke: [train-check] {arch}: two states from one seed differ")
        proc = TrainProcess(model, tcfg).init(replayed, batches[0])
        step = make_train_step(model, tcfg)
        gaps = []
        for i, bt in enumerate(batches):
            proc.launch(replayed, bt)
            eager, _ = step(eager, bt)
            torch.cuda.synchronize()
            gaps.append(max_diff(replayed, eager))
            if gaps[-1] != 0.0:
                differ = [n for (n, a), (_, b) in zip(tree_flatten(replayed), tree_flatten(eager))
                          if not torch.equal(a, b)]
                raise SystemExit(f"chip_smoke: [train-check] {arch} bf16: replayed step {i} "
                                 f"differs from the eager one in {len(differ)} leaves, first "
                                 f"{differ[:6]} (max |difference| {gaps[-1]:.3e})")
        counts = {k: v for k, v in launch_counts().items() if v}
        want = {k: v * (1 + 2 * steps) for k, v in per_step_launches(model.cfg).items()}
        # AdamW a step: one update a leaf, the sum of squares' pass a leaf and
        # its final pass (the captured step's tally, added at each replay)
        want.update({k: v * 2 * steps for k, v in optimizer_launches(model).items()})
        print(f"[train-check] {smi}: {arch} {cut_of(model.cfg)[1]} at full width, bf16, batch "
              f"1 x 256: {steps} "
              f"steps replayed through TrainProcess (captures {proc.captures}, replays "
              f"{proc.replays}) against {steps} eager make_train_step steps: max |difference| "
              f"over the whole train state after each step {', '.join(f'{g:.3e}' for g in gaps)}; "
              f"launches {counts} (expected {want})")
        if (proc.captures, proc.replays) != (1, steps):
            raise SystemExit(f"chip_smoke: [train-check] {arch}: {proc.captures} captures and "
                             f"{proc.replays} replays; expected 1 and {steps}")
        if {k: counts.get(k, 0) for k in want} != want:
            raise SystemExit(f"chip_smoke: [train-check] {arch} bf16 replay against eager: "
                             f"launches {counts}, expected {want}")

    # PERF.md §2: the card's loss and each gradient leaf against the CPU's
    # f32, as (share of the loss, share of the leaf's max |grad|)
    TRAIN_BAND = {"f32": (1e-4, 1e-3), "bf16": (2e-2, 5e-2)}
    # PERF.md §2: a model group's f32 cut against the no-mesh step, as
    # shares of the loss, of grad_norm and of each leaf's max |grad|
    TP_F32_BAND = {"loss": 1e-4, "grad_norm": 1e-4, "piece": 1e-3}

    def train_ckpt_phase():
        """[train-ckpt]: repro_torch.launch.train_lm (lm-100m, f32) for 40
        steps into a temporary directory (the loss must improve); then 10
        steps with a failure at step 6 and a checkpoint every 4 against an
        uninterrupted 10 (bit for bit), and the uninterrupted run's replayed
        steps against the same 10 steps run eagerly (bit for bit)."""
        reset_launch_counts()
        t0 = time.perf_counter()
        tr = train_lm.main(["--steps", "40"])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = {k: v for k, v in launch_counts().items() if v}
        add_counts(counts)
        cfg = train_lm.lm_100m()
        want = {k: 41 * v for k, v in per_step_launches(cfg).items()}
        want.update({k: 40 * v for k, v in optimizer_launches(build_model(cfg)).items()})
        print(f"[train-ckpt] {smi}: train_lm.main(['--steps', '40']) (lm-100m, f32, batch 8 x "
              f"256) in {run_s:.1f} s: loss {tr.history[0][1]:.4f} -> {tr.history[-1][1]:.4f}; "
              f"captures {tr.process.captures}, replays {tr.process.replays}; launches "
              f"{counts} (expected {want})")
        if {k: counts.get(k, 0) for k in want} != want:
            raise SystemExit(f"chip_smoke: [train-ckpt] launches {counts}, expected {want}")
        stream = TokenStream(StreamConfig(vocab=cfg.vocab, seq=256, batch=8, seed=0))
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
            t0 = time.perf_counter()
            ta = Trainer(build_model(cfg), train_lm.trainer_config(10, f"{d}/a", 4),
                         device=dev, log_fn=quiet)
            sa = ta.fit(stream, 0)
            tb = Trainer(build_model(cfg), train_lm.trainer_config(10, f"{d}/b", 4),
                         device=dev, log_fn=quiet)
            sb = tb.fit_with_restarts(stream, 0, failure_schedule=[6])
            restart_s = time.perf_counter() - t0
            steps_b = (latest_step(f"{d}/a"), latest_step(f"{d}/b"))
            gap = max_diff(sa, sb)
            print(f"[train-ckpt] {smi}: 10 steps with a failure at step 6 (resumed from the "
                  f"step-4 checkpoint) against 10 uninterrupted, checkpoints every 4 (latest "
                  f"{steps_b}): max |difference| over the whole train state {gap:.3e} "
                  f"({restart_s:.1f} s)")
            if gap != 0.0 or steps_b != (10, 10):
                raise SystemExit("chip_smoke: [train-ckpt] the restarted run does not end "
                                 "where the uninterrupted one does")
            model = build_model(cfg)
            eager = make_train_state(model, 0, device=dev)
            step = make_train_step(model, train_lm.trainer_config(10, d).train)
            for i in range(10):
                eager, _ = step(eager, stream.batch_at(i))
            gap = max_diff(sa, eager)
            print(f"[train-ckpt] {smi}: the uninterrupted run's 10 replayed steps against the "
                  f"same 10 steps eager: max |difference| over the whole train state {gap:.3e}")
            if gap != 0.0:
                raise SystemExit("chip_smoke: [train-ckpt] replayed steps differ from eager ones")
        del tr, ta, tb, sa, sb, eager
        gc.collect()
        torch.cuda.empty_cache()

    def mesh_lm_phase():
        """[mesh-lm]: the LM stack over the lanes of a mesh on card 0 (the
        mesh names it twice; one process drives every lane).
        1. qwen3-14b served over a (data 1, model 2) group: the decode
           slots in two strips of 2, captured in one graph; its tokens
           against [lm]'s one-lane server (same weights and traffic), the
           captures, replays and launches; then the server's DecodeStep
           on clones of its state under the group and with no mesh:
           tokens, logits within the bf16 band, and each product of the
           step against itself on a strip's rows (which ones differ).
        2. h2o-danube-1.8b trained at full width over 2 data lanes
           (``Trainer(mesh=)``, batch 4 x 2048, ZeRO-1 pieces placed leaf
           by leaf): after 2 steps the state and metrics bit for bit a
           one-lane ``TrainProcess(microbatches=2)``; exact launch counts;
           the peak memory's growth over the one-lane run's within what
           ``train_state_bytes`` counts for the second lane; 2 more steps
           (the loss falls); step p50 over 3 replays, tokens/s, MFU, each
           lane's piece bytes.
        3. lm-100m over 2 lanes: a sharded save from both lanes restored
           onto 2 lanes (no "gather") and one (gather), bit for bit; a
           failure at step 6 of 10 resumed on 2 lanes bit for bit an
           uninterrupted 10."""
        import contextlib
        import dataclasses
        import os
        from repro_torch.ckpt import restore_checkpoint, save_checkpoint
        from repro_torch.core.process import _compiling_under
        from repro_torch.launch.mesh import Mesh, make_data_mesh
        from repro_torch.launch.train import check_fits, train_state_bytes
        from repro_torch.optim import AdamWConfig, Schedule
        from repro_torch.train import TrainConfig, TrainerConfig, state_pspecs, to_named

        def rows_trace(b, rows):
            """Each product of the code run under it (matmul and ``@``,
            einsum, bmm, F.linear, softmax, the rmsnorm kernel) whose
            output leads with ``b`` rows is computed again on each strip of
            ``rows`` rows of its inputs (every input that leads with ``b``
            rows cut, the rest as they are); returns the mode and a table
            {op and output shape: [calls, calls whose strips differ from
            the batch's rows, max |diff| / max |out|]}."""
            from torch.overrides import TorchFunctionMode
            import torch.nn.functional as F
            from repro_torch.models import layers
            table: dict = {}

            def cut(a, i):
                return (a[i * rows:(i + 1) * rows] if isinstance(a, torch.Tensor) and a.dim()
                        and a.shape[0] == b else a)

            def compare(name, fn, args, kwargs, out):
                if not (isinstance(out, torch.Tensor) and out.dim() and out.shape[0] == b):
                    return
                row = table.setdefault(f"{name} {tuple(out.shape)}", [0, 0, 0.0])
                row[0] += 1
                scale = float(out.float().abs().max()) or 1.0
                gaps = [float((fn(*[cut(a, i) for a in args],
                                  **{k: cut(v, i) for k, v in kwargs.items()}).float()
                               - cut(out, i).float()).abs().max()) for i in range(b // rows)]
                row[1] += max(gaps) > 0
                row[2] = max(row[2], max(gaps) / scale)

            products = {torch.matmul: "matmul", torch.Tensor.matmul: "matmul",  # and @
                        torch.einsum: "einsum", torch.bmm: "bmm", F.linear: "linear",
                        torch.softmax: "softmax", torch.Tensor.softmax: "softmax"}

            class Mode(TorchFunctionMode):
                def __torch_function__(self, func, types, args=(), kwargs=None):
                    out = func(*args, **(kwargs or {}))
                    if func in products:
                        compare(products[func], func, args, kwargs or {}, out)
                    return out

            kernel = layers.rmsnorm

            def traced_rmsnorm(*args, **kwargs):
                out = kernel(*args, **kwargs)
                compare("rmsnorm kernel", kernel, args, kwargs, out)
                return out

            @contextlib.contextmanager
            def tracing():
                layers.rmsnorm = traced_rmsnorm
                try:
                    with Mode():
                        yield
                finally:
                    layers.rmsnorm = kernel

            return tracing(), table

        def serve(model, group):
            """qwen3-14b's weights from seed 0 on the group's first card and
            [lm]'s traffic through LMServer over a (data 1, model n) group;
            returns the app, the weights' tree, the server, its tokens,
            seconds and launches."""
            app = CLapp().init(PlatformTraits(), DeviceTraits())
            app.set_mesh(Mesh([group]))
            weights, wcodec = weights_data(model.param_specs())
            app.addData(weights)
            model.init_params(torch.Generator(device=app.device).manual_seed(0),
                              out=wcodec.unflatten(weights.device_views()))
            server = LMServer(model, weights, batch=4, max_len=2048,
                              sampling=SamplingConfig(max_new_tokens=32), app=app)
            rng = np.random.default_rng(0)
            for n in rng.integers(17, 1025, size=10):
                server.submit(rng.integers(0, model.cfg.vocab, int(n)).tolist())
            reset_launch_counts()
            for d in set(group):
                torch.cuda.synchronize(d)
            t0 = time.perf_counter()
            results = server.run()
            for d in set(group):
                torch.cuda.synchronize(d)
            return (app, weights, server, results, time.perf_counter() - t0,
                    {k: v for k, v in launch_counts().items() if v})

        def flips_of(results, want):
            return ([sum(a != b for a, b in zip(r, w)) for r, w in zip(results, want)],
                    [next((i for i, (a, b) in enumerate(zip(r, w)) if a != b), None)
                     for r, w in zip(results, want)])

        # -- 1. qwen3-14b over a (1, 2) group --------------------------------
        arch = "qwen3-14b"
        cfg = get_config(arch)
        model = build_model(cfg)
        app, weights, server, results, run_s, counts = serve(model, [dev, dev])
        step = server.decode_pipe.build().executor
        per_layer = 2 + 2 * cfg.qk_norm
        want = {"rmsnorm": (per_layer * cfg.n_layers + 1) * (server.admitted + 2 * server.steps),
                "flash_attention": cfg.n_layers * server.admitted}
        one = lm_runs[arch]
        flips, first = flips_of(results, one["results"])
        strip_tokens = results
        n_tokens = sum(len(r) for r in results)
        decode_ms = [t * 1e3 for t in server.decode_profile.samples]
        print(f"[mesh-lm] {smi}: LMServer {arch} over a (data 1, model 2) group on {dev} "
              f"(the decode step's 4 slots in 2 strips of 2, one weights Data): {n_tokens} "
              f"tokens in {run_s:.3f} s = {n_tokens / run_s:.2f} tokens/s (one lane, [lm]: "
              f"{one['tokens_per_s']:.2f}); decode p50 {statistics.median(decode_ms):.3f} ms "
              f"(one lane {one['decode_p50']:.3f}); {server.admitted} prefills, "
              f"{server.steps} decode steps")
        print(f"[mesh-lm] {arch} tokens against the one-lane server's: requests with a flip "
              f"{sum(1 for f in flips if f)} of {len(flips)}, tokens that differ "
              f"{sum(flips)} of {n_tokens} (first flip at token {first}; a flip makes the "
              "rest of its request differ)")
        print(f"[mesh-lm] {smi}: {arch} decode step on {dev}: captures {step.captures}, "
              f"replays {step.replays} over {server.steps} steps (both strips in one graph); "
              f"launches {counts} (expected {want}: each step's forward twice, one a strip)")
        bad = [i for i, r in enumerate(results)
               if len(r) != 32 or not all(0 <= t < cfg.vocab for t in r)]
        if bad or (step.captures, step.replays) != (1, server.steps - 1):
            raise SystemExit(f"chip_smoke: [mesh-lm] {arch}: requests {bad} lack 32 tokens in "
                             f"range, or the step made {step.captures} captures and "
                             f"{step.replays} replays")
        if {k: counts.get(k, 0) for k in want} != want:
            raise SystemExit(f"chip_smoke: [mesh-lm] {arch}: launches {counts}, expected {want}")
        add_counts(counts)
        # the server's DecodeStep, launched eagerly on clones of its state
        # (every slot spliced by the run's admissions, re-activated) once
        # under the (1, 2) group and once with no mesh: the tokens bit for
        # bit, the logits (each decode_step call's, recorded) within the
        # bf16 band; the no-mesh step traced product by product against
        # the same product on each strip's rows of its inputs
        state = {n: server.state.device_view(n) for n in server.state.names}
        state["active"].fill_(1)
        aux = {"weights": weights.device_views()}
        seen = []
        decode = model.decode_step

        def recorded(*args, **kwargs):
            out = decode(*args, **kwargs)
            seen.append(out[0])
            return out

        tracing, table = rows_trace(4, 2)
        model.decode_step = recorded
        try:
            with _compiling_under(app.mesh):
                got = step.apply({n: v.clone() for n, v in state.items()}, aux, None)
            strips, seen[:] = torch.cat(seen), []
            with _compiling_under(None), tracing:
                want = step.apply({n: v.clone() for n, v in state.items()}, aux, None)
            full = seen[0]
        finally:
            del model.decode_step
        torch.cuda.synchronize()
        gap = float((strips.float() - full.float()).abs().max())
        scale = float(full.float().abs().max())
        argmax_flips = int((strips.argmax(-1) != full.argmax(-1)).sum())
        same = [n for n in got if torch.equal(got[n], want[n])]
        differ = {k: v for k, v in table.items() if v[1]}
        print(f"[mesh-lm] {smi}: {arch} DecodeStep of the server's state (4 slots, cache "
              f"2048, positions {state['positions'].tolist()}) under the (1, 2) group against "
              f"no mesh: tokens {got['token'].flatten().tolist()} / "
              f"{want['token'].flatten().tolist()}, state leaves bit for bit {len(same)} of "
              f"{len(got)}; logits max |strips - batch| {gap:.4e} = {gap / scale:.3e} x max "
              f"|logit| ({scale:.3f}; band 2e-2), argmax flips {argmax_flips} of 4")
        print(f"[mesh-lm] {arch} products of the no-mesh step against the same product on "
              f"each 2-row strip of its inputs (calls, calls that differ, max |diff| / max "
              f"|out|): {len(differ)} of {len(table)} kinds differ: "
              + "; ".join(f"{k}: {v[0]}, {v[1]}, {v[2]:.3e}" for k, v in table.items()))
        if not gap <= 2e-2 * scale or argmax_flips != int(
                (got["token"] != want["token"]).sum()):
            raise SystemExit(f"chip_smoke: [mesh-lm] {arch}: strip logits {gap:.4e} from the "
                             f"full batch's, beyond 2e-2 x {scale:.3f}, or the tokens do not "
                             "follow the logits")
        if gap > 0 and not differ:
            raise SystemExit(f"chip_smoke: [mesh-lm] {arch}: the strips' logits differ, but "
                             "no product differs on a strip's rows")
        del server, step, app, weights, aux, state, got, want, strips, full, seen, decode
        gc.collect()
        torch.cuda.empty_cache()
        wall("after [mesh-lm] part 1 (qwen3-14b served over 2 strips)")

        # -- 2. h2o-danube-1.8b trained over 2 data lanes ---------------------
        arch = "h2o-danube-1.8b"
        cfg = get_config(arch)
        model = build_model(cfg)
        stream = TokenStream(StreamConfig(vocab=cfg.vocab, seq=2048, batch=4, seed=0))
        opt = AdamWConfig(schedule=Schedule(kind="constant", base_lr=1e-5, warmup_steps=0))
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)      # what earlier phases left on the card
        t0 = time.perf_counter()
        state = make_train_state(model, 0, device=dev)
        proc = TrainProcess(model, TrainConfig(microbatches=2, opt=opt)).init(
            state, stream.batch_at(0))
        for i in range(2):
            state, metrics = proc.launch(state, stream.batch_at(i))
        torch.cuda.synchronize()
        want_state = {k: v.cpu() for k, v in tree_flatten(state)}
        want_metrics = {k: v.cpu() for k, v in metrics.items()}
        one_s = time.perf_counter() - t0
        peak_one = torch.cuda.max_memory_allocated(dev)
        del proc, state, metrics
        gc.collect()
        torch.cuda.empty_cache()
        check_fits(cfg, dev, lanes=2)
        mesh = make_data_mesh([dev, dev])
        tcfg = TrainerConfig(total_steps=2, log_every=1, train=TrainConfig(opt=opt))
        trainer = Trainer(model, tcfg, mesh=mesh, log_fn=quiet)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        placed = trainer.fit(stream, 0)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = {k: v for k, v in launch_counts().items() if v}
        peak = torch.cuda.max_memory_allocated(dev)
        proc = trainer.process
        per_step = per_step_launches(cfg)
        want = {k: v * (1 + 2 * 2) for k, v in per_step.items()}
        diffs = []
        for name, s in tree_flatten(placed):
            ref_leaf = want_state[name].to(dev)
            diffs += [(name, k) for k, p in enumerate(s.pieces)
                      if not torch.equal(p, ref_leaf[s.slices(k)])]
        metric_diffs = [k for k, v in want_metrics.items()
                        if not torch.equal(proc.metrics[k].cpu(), v)]
        pieces = {k: sum(s.pieces[k].numel() * s.pieces[k].element_size()
                         for _, s in tree_flatten(placed["opt"])) for k in range(2)}
        replicas = {k: sum(s.pieces[k].numel() * s.pieces[k].element_size()
                           for _, s in tree_flatten(placed["params"])) for k in range(2)}
        print(f"[mesh-lm] {smi}: {arch} at full width over 2 data lanes on {dev} "
              f"(Trainer(mesh=), batch 4 x 2048 on the TokenStream, AdamW lr 1e-5): 2 steps in "
              f"{fit_s:.1f} s (init, warm-up and capture included; the one-lane "
              f"TrainProcess(microbatches=2) took {one_s:.1f} s with its host copy); captures "
              f"{proc.captures}, replays {proc.replays}; launches {counts} (expected {want}: "
              "init's warm-up forward and backward of one lane, then each step's two lanes)")
        print(f"[mesh-lm] {arch} after 2 steps against the one-lane microbatches=2 step: "
              f"state pieces that differ {len(diffs)} of "
              f"{sum(len(s.pieces) for _, s in tree_flatten(placed))} {diffs[:4]}; metrics "
              f"that differ {metric_diffs} of {sorted(want_metrics)}")
        if diffs or metric_diffs:
            raise SystemExit(f"chip_smoke: [mesh-lm] {arch}: 2 lanes differ from the one-lane "
                             "microbatches=2 step")
        # the second lane adds what train_state_bytes counts for it (a
        # parameter replica), within 1 GiB of transients (a leaf's f32
        # copy, a new bf16 piece, the allocator's rounding); placing the
        # state beside an unplaced one would add 14 bytes a parameter
        counted = train_state_bytes(cfg, lanes=2)
        growth = counted - train_state_bytes(cfg, microbatches=2)
        print(f"[mesh-lm] {smi}: {arch} peak memory over the {base / 2**30:.2f} GiB that "
              f"earlier phases left allocated: one lane, microbatches=2 "
              f"{(peak_one - base) / 2**30:.2f} GiB (train_state_bytes "
              f"{train_state_bytes(cfg, microbatches=2) / 2**30:.2f}); 2 lanes "
              f"{(peak - base) / 2**30:.2f} GiB (train_state_bytes {counted / 2**30:.2f}, so "
              f"{(peak - base - counted) / 2**30:.2f} GiB of activations and transients); "
              f"growth {(peak - peak_one) / 2**30:.2f} GiB against the "
              f"{growth / 2**30:.2f} GiB counted (+ 1 GiB)")
        if base > 4 * 2**30:
            raise SystemExit(f"chip_smoke: [mesh-lm] {base / 2**30:.2f} GiB of earlier phases "
                             "still allocated before the training runs")
        if peak - peak_one > growth + 2**30:
            raise SystemExit(f"chip_smoke: [mesh-lm] {arch}: 2 lanes peak at "
                             f"{peak / 2**30:.2f} GiB, {(peak - peak_one) / 2**30:.2f} GiB over "
                             f"one lane's, beyond the {growth / 2**30:.2f} GiB counted + 1 GiB")
        if (proc.captures, proc.replays) != (1, 2) or \
                {k: counts.get(k, 0) for k in want} != want:
            raise SystemExit(f"chip_smoke: [mesh-lm] {arch}: {proc.captures} captures, "
                             f"{proc.replays} replays, launches {counts}; expected 1, 2 and "
                             f"{want}")
        add_counts(counts)
        del want_state
        losses = [loss for _, loss in trainer.history]
        reset_launch_counts()
        for i in (2, 3):
            _, metrics = proc.launch(placed, stream.batch_at(i))
            losses.append(float(metrics["loss"]))
        step_ms = []
        for i in range(3):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            proc.launch(placed, stream.batch_at(4 + i))
            e1.record()
            e1.synchronize()
            step_ms.append(e0.elapsed_time(e1))
        counts = {k: v for k, v in launch_counts().items() if v}
        add_counts(counts)
        p50 = statistics.median(step_ms)
        specs = tree_flatten(model.param_specs())
        flops, flops_txt = model_flops(cfg, specs, 4, 2048)
        print(f"[mesh-lm] {smi}: {arch} 2 lanes, losses of steps 0-3 "
              f"{', '.join(f'{x:.4f}' for x in losses)}; replayed step ms "
              f"{', '.join(f'{t:.2f}' for t in step_ms)} (the batch's upload included); p50 "
              f"{p50:.2f}; {4 * 2048 / p50 * 1e3:.0f} tokens/s; MFU "
              f"{flops / (p50 * 1e-3) / peaks['bf16_tensor']:.4f} ({flops_txt}); each lane's "
              f"parameter replica {replicas[0] / 1e9:.3f} / {replicas[1] / 1e9:.3f} GB and ZeRO-1 "
              f"optimizer pieces (master, m, v, step) {pieces[0] / 1e9:.3f} / "
              f"{pieces[1] / 1e9:.3f} GB")
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise SystemExit(f"chip_smoke: [mesh-lm] {arch}: the loss did not fall: {losses}")
        del trainer, proc, placed, metrics
        gc.collect()
        torch.cuda.empty_cache()
        wall("after [mesh-lm] part 2 (h2o-danube-1.8b over 2 lanes)")

        # -- 3. lm-100m over 2 lanes: sharded save, restore, restart -----------
        cfg = train_lm.lm_100m()
        stream = TokenStream(StreamConfig(vocab=cfg.vocab, seq=256, batch=8, seed=0))
        two = make_data_mesh([dev, dev])
        reset_launch_counts()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_ckpt_") as d:
            t0 = time.perf_counter()
            sa = Trainer(build_model(cfg), train_lm.trainer_config(10, f"{d}/a", 4), mesh=two,
                         log_fn=quiet).fit(stream, 0)
            sb = Trainer(build_model(cfg), train_lm.trainer_config(10, f"{d}/b", 4), mesh=two,
                         log_fn=quiet).fit_with_restarts(stream, 0, failure_schedule=[6])
            restart_s = time.perf_counter() - t0
            differ = [n for (n, x), (_, y) in zip(tree_flatten(sa), tree_flatten(sb))
                      if not all(torch.equal(p, q) for p, q in zip(x.pieces, y.pieces))]
            print(f"[mesh-lm] {smi}: lm-100m over 2 lanes, 10 steps with a failure at step 6 "
                  f"(resumed on 2 lanes from the step-4 checkpoint) against 10 uninterrupted: "
                  f"leaves whose pieces differ {len(differ)} of {len(tree_flatten(sa))} "
                  f"({restart_s:.1f} s)")
            if differ:
                raise SystemExit(f"chip_smoke: [mesh-lm] the restarted run differs: {differ[:4]}")
            prof = ProfileParameters(enable=True)
            t0 = time.perf_counter()
            save_checkpoint(f"{d}/sharded", 10, sa, sharded=True, profile=prof)
            save_s = time.perf_counter() - t0
            files = sorted(os.listdir(f"{d}/sharded/step_0000000010"))
            like = make_train_state(build_model(cfg), 1, device=dev)
            results = {}
            for label, mesh in (("2 lanes", two), ("one lane", make_data_mesh([dev]))):
                rprof = ProfileParameters(enable=True)
                t0 = time.perf_counter()
                back = restore_checkpoint(f"{d}/sharded", like, profile=rprof, shardings=to_named(
                    state_pspecs(build_model(cfg), like), mesh))
                torch.cuda.synchronize()
                same = all(torch.equal(x.full(dev), y.full(dev))
                           for (_, x), (_, y) in zip(tree_flatten(back), tree_flatten(sa)))
                results[label] = (same, "gather" in rprof.phases, time.perf_counter() - t0)
            print(f"[mesh-lm] {smi}: lm-100m sharded save from 2 lanes in {save_s:.2f} s "
                  f"({', '.join(files)}; no gather: {'gather' not in prof.phases}); restored "
                  + "; ".join(f"onto {k}: bit for bit {v[0]}, gather {v[1]}, {v[2]:.2f} s"
                              for k, v in results.items()))
            if 'gather' in prof.phases or results != {
                    "2 lanes": (True, False, results["2 lanes"][2]),
                    "one lane": (True, True, results["one lane"][2])}:
                raise SystemExit(f"chip_smoke: [mesh-lm] lm-100m checkpoints: {results}")
        add_counts({k: v for k, v in launch_counts().items() if v})
        del sa, sb, back, like
        gc.collect()
        torch.cuda.empty_cache()
        wall("after [mesh-lm] part 3 (lm-100m sharded save, restore, restart over 2 lanes)")

        # -- 4. every visible card, where there are more than one ------------
        cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        n = len(cards)
        if n < 2 or 8 % n:            # lm-100m's 8 rows a lane a card
            return
        model = build_model(train_lm.lm_100m())
        stream = TokenStream(StreamConfig(vocab=model.cfg.vocab, seq=256, batch=8, seed=0))
        tcfg = train_lm.trainer_config(3, None)
        want = Trainer(model, dataclasses.replace(tcfg, train=dataclasses.replace(
            tcfg.train, microbatches=n)), device=dev, log_fn=quiet).fit(stream, 0)
        got = Trainer(model, tcfg, mesh=make_data_mesh(cards), log_fn=quiet).fit(stream, 0)
        differ = [k for (k, x), (_, y) in zip(tree_flatten(got), tree_flatten(want))
                  if not torch.equal(x.full(dev), y)]
        print(f"[mesh-lm] {smi}: lm-100m over {n} cards (a lane a card, eager steps): 3 steps "
              f"bit for bit a one-card microbatches={n} run: {not differ} {differ[:4]}")
        if differ:
            raise SystemExit(f"chip_smoke: [mesh-lm] lm-100m over {n} cards differs: {differ}")
        del want, got
        if 4 % n == 0:
            app, _, server, results, run_s, counts = serve(
                build_model(get_config("qwen3-14b")), cards)
            add_counts(counts)
            flips, first = flips_of(results, strip_tokens)
            bad = [i for i, r in enumerate(results) if len(r) != 32]
            print(f"[mesh-lm] {smi}: qwen3-14b over a (data 1, model {n}) group of {n} cards "
                  f"(a weights replica a card, strips copied, eager): "
                  f"{sum(map(len, results)) / run_s:.2f} tokens/s, decode p50 "
                  f"{statistics.median(server.decode_profile.samples) * 1e3:.3f} ms; requests "
                  f"flipped against part 1's strips {sum(1 for f in flips if f)} of 10 (first "
                  f"flips {first})")
            if bad:
                raise SystemExit(f"chip_smoke: [mesh-lm] qwen3-14b over {n} cards: requests "
                                 f"{bad} lack 32 tokens")
            del app, server
            gc.collect()
        wall(f"after [mesh-lm] part 4 ({n} cards)")

    def mesh_tp_phase():
        """[mesh-tp]: every family trained over a mesh's model axis on
        card 0 (the mesh names it twice, then four times; one process
        drives every lane): Megatron-style tensor parallelism by the
        partition rules, experts over ``model``, a vocabulary-parallel
        loss (``repro_torch.models.parallel``).
        1. h2o-danube-1.8b at full width over a (data 1, model 2) group,
           random bf16 weights from seed 0, batch 4 x 2048: the group's
           loss, grad_norm and every lane's gradient piece against the
           no-mesh gradient of the same parameters and batch, in the
           bands PERF.md states (loss rtol 1e-3, grad_norm rtol 1e-2, each
           piece within 5e-2 x its leaf's max |grad|); then
           ``TrainProcess(mesh=)`` (AdamW, constant lr 1e-5): 1 capture, 5
           replayed steps (the loss falls), exact launch counts (each lane
           norms the whole rows and runs its 16 heads), step p50,
           tokens/s, MFU, peak memory, each lane's parameter and ZeRO-1
           bytes against ``mesh_state_bytes``; the 5 replayed steps bit
           for bit 5 eager ``make_mesh_train_step`` steps from the seed.
        2. lm-100m (f32) over a (1, 2) group: a failure at step 6 of 10
           resumed from the step-4 checkpoint ends bit for bit where an
           uninterrupted run does (a danube train state's checkpoint is
           26 GB).
        3. A cut of deepseek-v2-lite-16b at full width, layer 0 (dense)
           and two MoE layers (64 routed experts, 32 a lane; 8 MLA heads
           a lane), f32, on a (data 2, model 2) grid, batch 2 x 2048: one
           step against the no-mesh step with ``microbatches=2`` (PR 30's
           lane rule): loss and grad_norm within rtol 1e-4, every m and v
           piece (the gradient, in ZeRO-1 pieces over data and model)
           within rtol 1e-4 + 1e-4 x its leaf's max, the router's choices
           the same (in bf16 the lanes' other rounding moves 5-10 % of
           them, as any other order of sums does).
        4-6. rwkv6-3b (batch 4 x 2048; wkv6 and its backward on 20 of 40
           heads a lane), zamba2-2.7b (4 x 2048; the SSD on 40 of 80 heads
           a lane, the shared block on 16 of 32) and whisper-large-v3 (8 x
           448 with 1500 frames; 10 of 20 heads a lane, the cross attention
           too) over a (1, 2) group: the f32 cut at full width against the
           no-mesh gradient (``TP_F32_BAND``: in bf16 the lanes' other
           rounding moves the noisiest leaves, rwkv6's decay and zamba2's
           conv taps, by 0.3-0.5 x their max |grad|, as bf16 against f32
           does on one lane), ``TrainProcess(mesh=)`` at full width and
           depth in bf16, and the bf16 cut's replayed steps against eager
           ones (:func:`family_part`)."""
        from repro_torch.launch.mesh import make_data_mesh
        from repro_torch.launch.train import mesh_state_bytes
        from repro_torch.optim import AdamWConfig, Schedule
        from repro_torch.optim.adamw import global_norm
        from repro_torch.train import (TrainConfig, init_mesh_state, shard_state, state_pspecs,
                                       to_named)
        from repro_torch.train.step import (device_batch, gradient_pieces, make_mesh_train_step,
                                            mesh_lanes, train_state_specs)

        def worst_gap(got, want, placed):
            """(gap / the leaf's max |want|, name, lane) of the worst piece."""
            flat, pieces = dict(tree_flatten(want)), dict(tree_flatten(placed))
            out = []
            for lane, tree in enumerate(got):
                for n, g in tree_flatten(tree):
                    w = flat[n][pieces[n].slices(lane)].float()
                    scale = max(float(flat[n].float().abs().max()), 1e-30)
                    out.append((float((g.float() - w).abs().max()) / scale, n, lane))
            return max(out)

        # -- 1. h2o-danube-1.8b over a (data 1, model 2) group ----------------
        arch = "h2o-danube-1.8b"
        cfg = get_config(arch)
        model = build_model(cfg)
        stream = TokenStream(StreamConfig(vocab=cfg.vocab, seq=2048, batch=4, seed=0))
        opt = AdamWConfig(schedule=Schedule(kind="constant", base_lr=1e-5, warmup_steps=0))
        tcfg = TrainConfig(opt=opt)
        mesh = make_data_mesh([dev, dev], model=2)
        batch = device_batch(stream.batch_at(0), dev)
        reset_launch_counts()
        params = model.init_params(torch.Generator(device=dev).manual_seed(0), device=dev)
        m_one, g_one = loss_and_grads(model, params, batch)
        norm_one = float(global_norm(g_one))
        placed = shard_state(params, to_named(state_pspecs(model, train_state_specs(model))[
            "params"], mesh))
        del params
        t0 = time.perf_counter()
        (lanes, group), = mesh_lanes(placed, mesh)
        m_tp, g_tp = loss_and_grads(model, lanes, batch, group)
        norm_tp = float(global_norm(gradient_pieces(g_tp, placed, mesh)))
        torch.cuda.synchronize()
        grad_s = time.perf_counter() - t0
        add_counts({k: v for k, v in launch_counts().items() if v})
        gap, gap_name, gap_lane = worst_gap(g_tp, g_one, placed)
        loss_one, loss_tp = float(m_one["loss"]), float(m_tp["loss"])
        loss_gap, norm_gap = abs(loss_tp - loss_one) / loss_one, abs(norm_tp - norm_one) / norm_one
        print(f"[mesh-tp] {smi}: {arch} at full width over a (data 1, model 2) group on {dev} "
              f"(bf16, batch 4 x 2048, {cfg.n_heads // 2} of {cfg.n_heads} heads and "
              f"{cfg.n_kv_heads // 2} of {cfg.n_kv_heads} kv heads a lane): loss "
              f"{loss_tp:.6f} against the no-mesh {loss_one:.6f} (rel {loss_gap:.3e}, band "
              f"1e-3); grad_norm {norm_tp:.6f} against {norm_one:.6f} (rel {norm_gap:.3e}, band "
              f"1e-2); worst gradient piece {gap:.4e} x its leaf's max |grad| ({gap_name}, lane "
              f"{gap_lane}; band 5e-2); the group's forward and backward {grad_s:.2f} s eager")
        if not (loss_gap <= 1e-3 and norm_gap <= 1e-2 and gap <= 5e-2):
            raise SystemExit(f"chip_smoke: [mesh-tp] {arch}: the model axis's gradient lies "
                             "outside its band")
        del g_one, g_tp, lanes, placed, m_one, m_tp, batch
        gc.collect()
        torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        state = init_mesh_state(model, 0, mesh)
        proc = TrainProcess(model, tcfg, mesh=mesh).init(state, stream.batch_at(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        losses, step_ms = [], []
        for i in range(5):
            bt = stream.batch_at(i)         # made on the host before the timed span
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            metrics = proc.launch(state, bt)[1]
            e1.record()
            e1.synchronize()
            step_ms.append(e0.elapsed_time(e1))
            losses.append(float(metrics["loss"]))
        counts = {k: v for k, v in launch_counts().items() if v}
        peak = torch.cuda.max_memory_allocated(dev)
        add_counts(counts)
        per_step = {k: 2 * v for k, v in per_step_launches(cfg).items()}
        want = {k: v * (1 + 5) for k, v in per_step.items()}
        held = [[0, 0], [0, 0]]
        for name, s in tree_flatten(state):
            for k, p in enumerate(s.pieces):
                held[k][0 if name.startswith("['params']") else 1] += p.numel() * p.element_size()
        counted = mesh_state_bytes(model, mesh)
        p50 = statistics.median(step_ms)
        flops, flops_txt = model_flops(cfg, tree_flatten(model.param_specs()), 4, 2048)
        passes = (proc.captures, proc.replays)
        last = {k: v.clone() for k, v in proc.metrics.items()}
        print(f"[mesh-tp] {smi}: {arch} TrainProcess over the (1, 2) group: init (the state "
              f"placed leaf by leaf, the group's warm-up, the capture) {init_s:.1f} s; captures "
              f"{passes[0]}, replays {passes[1]}; losses {', '.join(f'{x:.4f}' for x in losses)}; "
              f"launches {counts} (expected {want}: init's warm-up and 5 steps, each lane its "
              f"norms and its heads' attention, {per_step} a step); replayed step ms "
              f"{', '.join(f'{t:.2f}' for t in step_ms)} (the batch's upload included); p50 "
              f"{p50:.2f}; {4 * 2048 / p50 * 1e3:.0f} tokens/s; MFU "
              f"{flops / (p50 * 1e-3) / peaks['bf16_tensor']:.4f} ({flops_txt}); peak "
              f"{(peak - base) / 2**30:.2f} GiB over the {base / 2**30:.2f} GiB earlier phases "
              f"left; each lane's parameters {held[0][0] / 1e9:.3f} / {held[1][0] / 1e9:.3f} GB "
              f"and ZeRO-1 pieces (master, m, v, step) {held[0][1] / 1e9:.3f} / "
              f"{held[1][1] / 1e9:.3f} GB against mesh_state_bytes "
              f"{[tuple(round(b / 1e9, 3) for b in c) for c in counted]} GB")
        if passes != (1, 5) or {k: counts.get(k, 0) for k in want} != want:
            raise SystemExit(f"chip_smoke: [mesh-tp] {arch}: {passes} captures and replays, "
                             f"launches {counts}; expected (1, 5) and {want}")
        if [tuple(h) for h in held] != counted:
            raise SystemExit(f"chip_smoke: [mesh-tp] {arch}: the lanes hold {held} bytes, "
                             f"mesh_state_bytes counts {counted}")
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise SystemExit(f"chip_smoke: [mesh-tp] {arch}: the loss did not fall: {losses}")
        del proc, metrics
        gc.collect()
        torch.cuda.empty_cache()
        reset_launch_counts()
        eager = init_mesh_state(model, 0, mesh)
        step = make_mesh_train_step(model, tcfg, mesh)
        for i in range(5):
            eager, em = step(eager, stream.batch_at(i))
        torch.cuda.synchronize()
        add_counts({k: v for k, v in launch_counts().items() if v})
        differ = [(n, k) for (n, x), (_, y) in zip(tree_flatten(state), tree_flatten(eager))
                  for k, (p, q) in enumerate(zip(x.pieces, y.pieces)) if not torch.equal(p, q)]
        metric_differ = [k for k in last if not torch.equal(last[k], em[k])]
        print(f"[mesh-tp] {arch} 5 replayed steps against 5 eager make_mesh_train_step steps "
              f"from the seed: pieces that differ {len(differ)} of "
              f"{sum(len(s.pieces) for _, s in tree_flatten(state))} {differ[:4]}; the last "
              f"step's metrics that differ {metric_differ}")
        if differ or metric_differ:
            raise SystemExit(f"chip_smoke: [mesh-tp] {arch}: replayed steps differ from eager")
        del state, eager, em, step, last
        gc.collect()
        torch.cuda.empty_cache()
        wall("after [mesh-tp] part 1 (h2o-danube-1.8b over a (1, 2) group)")

        # -- 2. lm-100m over a (1, 2) group: a restart ---------------------------
        cfg2 = train_lm.lm_100m()
        stream2 = TokenStream(StreamConfig(vocab=cfg2.vocab, seq=256, batch=8, seed=0))
        reset_launch_counts()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_tp_ckpt_") as d:
            t0 = time.perf_counter()
            sa = Trainer(build_model(cfg2), train_lm.trainer_config(10, f"{d}/a", 4), mesh=mesh,
                         log_fn=quiet).fit(stream2, 0)
            sb = Trainer(build_model(cfg2), train_lm.trainer_config(10, f"{d}/b", 4), mesh=mesh,
                         log_fn=quiet).fit_with_restarts(stream2, 0, failure_schedule=[6])
            restart_s = time.perf_counter() - t0
        differ = [n for (n, x), (_, y) in zip(tree_flatten(sa), tree_flatten(sb))
                  if not all(torch.equal(p, q) for p, q in zip(x.pieces, y.pieces))]
        add_counts({k: v for k, v in launch_counts().items() if v})
        print(f"[mesh-tp] {smi}: lm-100m over a (1, 2) group, 10 steps with a failure at step 6 "
              f"(resumed on the group from the step-4 checkpoint) against 10 uninterrupted: "
              f"leaves whose pieces differ {len(differ)} of {len(tree_flatten(sa))} "
              f"({restart_s:.1f} s)")
        if differ:
            raise SystemExit(f"chip_smoke: [mesh-tp] lm-100m: the restarted run differs: "
                             f"{differ[:4]}")
        del sa, sb
        gc.collect()
        torch.cuda.empty_cache()
        wall("after [mesh-tp] part 2 (lm-100m restart over a (1, 2) group)")

        # -- 3. the deepseek-v2-lite-16b cut on a (data 2, model 2) grid -------
        arch = "deepseek-v2-lite-16b"
        cfg3 = get_config(arch).scaled(n_layers=3, param_dtype="float32", dtype="float32")
        model3 = build_model(cfg3)
        batch3 = TokenStream(StreamConfig(vocab=cfg3.vocab, seq=2048, batch=2, seed=0)).batch_at(0)
        grid = make_data_mesh([dev] * 4, model=2)
        routes: list = []
        route = moe_mod._route

        def recorded(p, x, c):
            out = route(p, x, c)
            routes.append(out[2].clone())
            return out

        moe_mod._route = recorded
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        try:
            t0 = time.perf_counter()
            one = make_train_state(model3, 0, device=dev)
            want = make_train_step(model3, TrainConfig(microbatches=2, opt=opt))(one, batch3)[1]
            # the no-mesh m and v wait on the host: both states do not fit the card
            moments = {n: t.cpu() for n, t in tree_flatten(one["opt"])
                       if n.startswith(("['m']", "['v']"))}
            del one
            gc.collect()
            torch.cuda.empty_cache()
            one_routes, routes[:] = routes[:], []
            t1 = time.perf_counter()
            tp_state = init_mesh_state(model3, 0, grid)
            got = make_mesh_train_step(model3, TrainConfig(opt=opt), grid)(tp_state, batch3)[1]
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            peak = torch.cuda.max_memory_allocated(dev)
        finally:
            moe_mod._route = route
        add_counts({k: v for k, v in launch_counts().items() if v})
        lane0 = routes[::2]          # each group's lanes route alike; the first lane's
        flips = (sum(int((a != b).sum()) for a, b in zip(one_routes, lane0))
                 if len(lane0) == len(one_routes) else -1)
        gaps = []
        for group_name in ("m", "v"):
            for n, s in tree_flatten(tp_state["opt"][group_name]):
                w = moments[f"['{group_name}']{n}"]
                scale = max(float(w.abs().max()), 1e-30)
                for k, p in enumerate(s.pieces):
                    wk = w[s.slices(k)].to(dev)
                    d = (p - wk).abs() - 1e-4 * wk.abs()
                    gaps.append((float(d.max()) / scale, f"['{group_name}']{n}", k))
        worst = max(gaps)
        rel = {k: abs(float(got[k]) - float(want[k])) / abs(float(want[k]))
               for k in ("loss", "grad_norm")}
        print(f"[mesh-tp] {smi}: {arch} cut (layer 0 and 2 MoE layers at full width: 64 routed "
              f"experts, 32 a lane; 8 MLA heads a lane; f32) on a (data 2, model 2) grid on "
              f"{dev}, batch 2 x 2048, one eager step against the no-mesh step with "
              f"microbatches=2: loss {float(got['loss']):.6f} / {float(want['loss']):.6f}, "
              f"grad_norm {float(got['grad_norm']):.6f} / {float(want['grad_norm']):.6f} (rel "
              f"{rel['loss']:.3e} / {rel['grad_norm']:.3e}, band 1e-4); worst m or v piece "
              f"beyond rtol 1e-4: {worst[0]:.4e} x its leaf's max ({worst[1]}, position "
              f"{worst[2]}; band 1e-4); router choices that differ {flips} of "
              f"{sum(r.numel() for r in one_routes)} (no-mesh step "
              f"{t1 - t0:.1f} s, the grid's {t2 - t1:.1f} s; peak {(peak - base) / 2**30:.2f} GiB "
              f"over the {base / 2**30:.2f} GiB left before)")
        if not (rel["loss"] <= 1e-4 and rel["grad_norm"] <= 1e-4 and worst[0] <= 1e-4
                and flips == 0):
            raise SystemExit(f"chip_smoke: [mesh-tp] {arch}: the (2, 2) grid's step lies "
                             "outside its band of the no-mesh step")
        del tp_state, moments, routes, one_routes, lane0
        gc.collect()
        torch.cuda.empty_cache()
        wall("after [mesh-tp] part 3 (the deepseek-v2-lite-16b cut on a (2, 2) grid)")

        # -- 4-6. rwkv6-3b, zamba2-2.7b and whisper-large-v3 over a (1, 2) group --
        def family_part(part, arch, batch, seq, frames=0, steps=4):
            """``arch`` over a (data 1, model 2) group on card 0: (a) its f32
            cut (:func:`cut_of`) at full width and at the batch of (b)
            against the no-mesh gradient of the same parameters and batch
            (``TP_F32_BAND``); (b) at full width and depth, bf16, random
            weights from seed 0: ``TrainProcess(mesh=)``, 1 capture and
            ``steps`` replays (the loss falls), exact launch counts (each
            lane its heads' kernels, norms over the whole rows), step p50,
            tokens/s, MFU, peak memory, each lane's bytes against
            ``mesh_state_bytes``; (c) the bf16 cut's replayed steps against
            eager ``make_mesh_train_step`` steps, bit for bit."""
            cfg = get_config(arch)
            model = build_model(cfg)
            kw = dict(kind="encdec", d_model=cfg.d_model, enc_frames=frames) if frames else {}
            stream = TokenStream(StreamConfig(vocab=cfg.vocab, seq=seq, batch=batch, seed=0,
                                              **kw))
            shape_txt = f"batch {batch} x {seq}" + (f" with {frames} frames" if frames else "")
            cut, cut_txt = cut_of(cfg)

            # (a) the f32 cut against the no-mesh gradient
            m32 = build_model(cfg.scaled(**cut, param_dtype="float32", dtype="float32"))
            batch_dev = device_batch(stream.batch_at(0), dev)
            reset_launch_counts()
            params = m32.init_params(torch.Generator(device=dev).manual_seed(0), device=dev)
            m_one, g_one = loss_and_grads(m32, params, batch_dev)
            norm_one = float(global_norm(g_one))
            placed = shard_state(params, to_named(state_pspecs(m32, train_state_specs(m32))[
                "params"], mesh))
            del params
            t0 = time.perf_counter()
            (lanes, group), = mesh_lanes(placed, mesh)
            m_tp, g_tp = loss_and_grads(m32, lanes, batch_dev, group)
            norm_tp = float(global_norm(gradient_pieces(g_tp, placed, mesh)))
            torch.cuda.synchronize()
            grad_s = time.perf_counter() - t0
            counts = {k: v for k, v in launch_counts().items() if v}
            add_counts(counts)
            # the no-mesh forward and backward, then each of the two lanes'
            want = {k: 3 * v for k, v in per_step_launches(m32.cfg).items()}
            gap, gap_name, gap_lane = worst_gap(g_tp, g_one, placed)
            loss_one, loss_tp = float(m_one["loss"]), float(m_tp["loss"])
            rel = {"loss": abs(loss_tp - loss_one) / loss_one,
                   "grad_norm": abs(norm_tp - norm_one) / norm_one, "piece": gap}
            print(f"[mesh-tp] {smi}: {arch} {cut_txt} at full width, f32, {shape_txt}, over a "
                  f"(data 1, model 2) group on {dev} against the no-mesh step: loss "
                  f"{loss_tp:.6f} / {loss_one:.6f} (rel {rel['loss']:.3e}), grad_norm "
                  f"{norm_tp:.6f} / {norm_one:.6f} (rel {rel['grad_norm']:.3e}), worst gradient "
                  f"piece {gap:.4e} x its leaf's max |grad| ({gap_name}, lane {gap_lane}); bands "
                  f"{TP_F32_BAND}; the group's forward and backward {grad_s:.2f} s eager; "
                  f"launches {counts} (expected {want})")
            if any(rel[k] > TP_F32_BAND[k] for k in TP_F32_BAND):
                raise SystemExit(f"chip_smoke: [mesh-tp] {arch}: the model axis's f32 gradient "
                                 "lies outside its band of the no-mesh one")
            if {k: counts.get(k, 0) for k in want} != want:
                raise SystemExit(f"chip_smoke: [mesh-tp] {arch} f32 cut: launches {counts}, "
                                 f"expected {want}")
            del g_one, g_tp, lanes, placed, m_one, m_tp, batch_dev
            gc.collect()
            torch.cuda.empty_cache()

            # (b) TrainProcess over the group at full width and depth
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            reset_launch_counts()
            t0 = time.perf_counter()
            state = init_mesh_state(model, 0, mesh)
            proc = TrainProcess(model, tcfg, mesh=mesh).init(state, stream.batch_at(0))
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            losses, step_ms = [], []
            for i in range(steps):
                bt = stream.batch_at(i)     # made on the host before the timed span
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                metrics = proc.launch(state, bt)[1]
                e1.record()
                e1.synchronize()
                step_ms.append(e0.elapsed_time(e1))
                losses.append(float(metrics["loss"]))
            counts = {k: v for k, v in launch_counts().items() if v}
            peak = torch.cuda.max_memory_allocated(dev)
            add_counts(counts)
            per_step = {k: 2 * v for k, v in per_step_launches(cfg).items()}
            want = {k: v * (1 + steps) for k, v in per_step.items()}
            held = [[0, 0], [0, 0]]
            for name, s_ in tree_flatten(state):
                for k, p in enumerate(s_.pieces):
                    held[k][0 if name.startswith("['params']") else 1] += \
                        p.numel() * p.element_size()
            counted = mesh_state_bytes(model, mesh)
            p50 = statistics.median(step_ms)
            flops, flops_txt = model_flops(cfg, tree_flatten(model.param_specs()), batch, seq,
                                           frames)
            passes = (proc.captures, proc.replays)
            print(f"[mesh-tp] {smi}: {arch} TrainProcess at full width over the (1, 2) group, "
                  f"bf16, {shape_txt}: init {init_s:.1f} s; captures {passes[0]}, replays "
                  f"{passes[1]}; losses {', '.join(f'{x:.4f}' for x in losses)}; launches "
                  f"{counts} (expected {want}: init's warm-up and {steps} steps, {per_step} a "
                  f"step); replayed step ms {', '.join(f'{t:.2f}' for t in step_ms)} (the "
                  f"batch's upload included); p50 {p50:.2f}; {batch * seq / p50 * 1e3:.0f} "
                  f"tokens/s; MFU {flops / (p50 * 1e-3) / peaks['bf16_tensor']:.4f} "
                  f"({flops_txt}); peak {(peak - base) / 2**30:.2f} GiB over the "
                  f"{base / 2**30:.2f} GiB earlier phases left; each lane's parameters "
                  f"{held[0][0] / 1e9:.3f} / {held[1][0] / 1e9:.3f} GB and ZeRO-1 pieces "
                  f"{held[0][1] / 1e9:.3f} / {held[1][1] / 1e9:.3f} GB against mesh_state_bytes "
                  f"{[tuple(round(b / 1e9, 3) for b in c) for c in counted]} GB")
            if passes != (1, steps) or {k: counts.get(k, 0) for k in want} != want:
                raise SystemExit(f"chip_smoke: [mesh-tp] {arch}: {passes} captures and replays, "
                                 f"launches {counts}; expected (1, {steps}) and {want}")
            if [tuple(h) for h in held] != counted:
                raise SystemExit(f"chip_smoke: [mesh-tp] {arch}: the lanes hold {held} bytes, "
                                 f"mesh_state_bytes counts {counted}")
            if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
                raise SystemExit(f"chip_smoke: [mesh-tp] {arch}: the loss did not fall: {losses}")
            print_by_kind(f"[mesh-tp] {smi}: {arch} one replayed step of the (1, 2) group",
                          *step_ms_by_kind(lambda: proc.launch(state, stream.batch_at(steps))))
            del proc, metrics, state
            gc.collect()
            torch.cuda.empty_cache()

            # (c) the bf16 cut's replayed steps against eager ones over the group
            m16 = build_model(cfg.scaled(**cut))
            small = [{k: torch.from_numpy(np.ascontiguousarray(v[:1, :256]))
                      for k, v in stream.batch_at(i).items()} for i in range(3)]
            reset_launch_counts()
            replayed = init_mesh_state(m16, 0, mesh)
            eager = init_mesh_state(m16, 0, mesh)
            proc = TrainProcess(m16, tcfg, mesh=mesh).init(replayed, small[0])
            step = make_mesh_train_step(m16, tcfg, mesh)
            for bt in small:
                proc.launch(replayed, bt)
                eager, _ = step(eager, bt)
            torch.cuda.synchronize()
            differ = [(n, k) for (n, x), (_, y) in zip(tree_flatten(replayed), tree_flatten(eager))
                      for k, (p, q) in enumerate(zip(x.pieces, y.pieces)) if not torch.equal(p, q)]
            print(f"[mesh-tp] {smi}: {arch} {cut_txt} at full width, bf16, batch 1 x 256, over "
                  f"the (1, 2) group: 3 steps replayed through TrainProcess (captures "
                  f"{proc.captures}, replays {proc.replays}) against 3 eager "
                  f"make_mesh_train_step steps: pieces that differ {len(differ)} of "
                  f"{sum(len(x.pieces) for _, x in tree_flatten(replayed))} {differ[:4]}")
            if differ or (proc.captures, proc.replays) != (1, 3):
                raise SystemExit(f"chip_smoke: [mesh-tp] {arch}: the bf16 cut's replayed steps "
                                 "differ from eager ones")
            del proc, replayed, eager, step
            gc.collect()
            torch.cuda.empty_cache()
            wall(f"after [mesh-tp] part {part} ({arch} over a (1, 2) group)")

        family_part(4, "rwkv6-3b", 4, 2048)
        family_part(5, "zamba2-2.7b", 4, 2048)
        family_part(6, "whisper-large-v3", 8, 448, frames=1500)

    train_kernels_phase()
    wall("after [train-kernels]")
    train_full_width("h2o-danube-1.8b")
    wall("after [train] h2o-danube-1.8b")
    # rwkv6, zamba2 and whisper: 4 steps and a p50 over 3 replays each;
    # whisper at its published decoder context (448) and encoder length
    # (1500 frames)
    for arch, kw in (("rwkv6-3b", {}), ("zamba2-2.7b", {}),
                     ("whisper-large-v3", dict(batch=8, seq=448, enc_frames=1500))):
        train_full_width(arch, steps=4, reps=3, **kw)
        wall(f"after [train] {arch}")
    train_ckpt_phase()
    wall("after [train-ckpt]")
    mesh_lm_phase()
    mesh_tp_phase()
    wall("after [mesh-tp]")
    missing = [k for k in ("rmsnorm", "flash_attention", "rmsnorm_bwd", "flash_attention_bwd",
                           "wkv6", "wkv6_bwd") if not train_counts.get(k)]
    if missing:
        raise SystemExit(f"chip_smoke: the training runs launched no {missing}")
    dryrun_phase(dev, smi, wall)

    wall("before section 8")
    # -- 8. the paper's listing 1 (quickstart) on the card, file in, file out --
    img8 = (quickstart.synthetic_image() * 255.0 + 0.5).astype(np.uint8)
    in_png, out_png = f"{tmp.name}/input.png", f"{tmp.name}/output.png"
    save_any(in_png, {"img": img8})
    reset_launch_counts()
    qs = quickstart.run(runs=10, in_path=in_png, out_path=out_png)
    qs_counts = launch_counts()
    if (qs_counts["negate_kernel"] != 11 or not qs["device"].startswith("cuda")
            or (qs["captures"], qs["replays"]) != (1, 10)):
        raise SystemExit(f"chip_smoke: quickstart ran on {qs['device']} with launches "
                         f"{qs_counts}, {qs['captures']} captures and {qs['replays']} "
                         "replays; expected 11 negate_kernel launches on the card, 1 "
                         "capture and 10 replays")
    back = load_any(out_png)["data"]
    x = img8.astype(np.float32) / np.float32(255.0)
    want8 = (np.clip(1.0 - x, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if not (np.array_equal(back, want8) and np.array_equal(back, 255 - img8)):
        raise SystemExit("chip_smoke: quickstart's output.png is not 1 - x in 8 bits")
    print(f"[path] {smi}: quickstart (Pipeline | Negate, 256x256 8-bit PNG in, PNG out) on "
          f"{qs['device']}: mean launch {qs['mean_launch_s'] * 1e3:.4f} ms, p50 "
          f"{np.median(qs['launch_s']) * 1e3:.4f} over 10 runs (captures {qs['captures']}, "
          f"replays {qs['replays']}; each run, the first capturing: "
          f"{', '.join(f'{t * 1e3:.4f}' for t in qs['launch_s'])} ms), output == 1 - x bit for "
          f"bit, {qs['out_path']} read back == 255 - input, negate_kernel launches "
          f"{qs_counts['negate_kernel']}")
    tmp.cleanup()

    wall("before section 9")
    # -- 9. result lines -----------------------------------------------------
    kernels = []
    serves = [lm_counts, rwkv_counts, whisper_counts, fd_counts] + new_counts
    launches = {"rmsnorm": sum(c.get("rmsnorm", 0) for c in serves + [train_counts]),
                "flash_attention": sum(c.get("flash_attention", 0)
                                       for c in serves + [train_counts]),
                "rmsnorm_bwd": train_counts["rmsnorm_bwd"],
                "flash_attention_bwd": train_counts["flash_attention_bwd"],
                "wkv6": rwkv_counts["wkv6"] + train_counts["wkv6"],
                "wkv6_bwd": train_counts["wkv6_bwd"], "negate": qs_counts["negate_kernel"],
                "adamw_update": train_counts["adamw_update"]}
    launches.update({k: counts[reg] + io_counts.get(reg, 0) for k, reg in names.items()})
    for kname in ["negate"] + list(names) + ["rmsnorm", "flash_attention", "wkv6",
                                             "rmsnorm_bwd", "flash_attention_bwd", "wkv6_bwd",
                                             "adamw_update"]:
        row = dict(rows[kname], launches=launches[kname])
        kernels.append({key: row[key] for key in (
            "name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
