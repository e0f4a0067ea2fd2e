#!/usr/bin/env python3
"""GPU smoke of the PyTorch port: CAGroup3D eval and training on one NVIDIA
card, ScanNet and then SUN RGB-D (the yaw path), then RBGNet on both, then
KITTI's SECOND family, then ``--dist``.

Run from the repository root on a machine with a CUDA GPU:

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits 1 without the final line.
Phases 3-11 (7b and 7c among them) run once per configuration
(``Path``): first tools/cfgs/scannet_models/CAGroup3D.yaml, then
tools/cfgs/sunrgbd_models/CAGroup3D.yaml (10 classes, three votes per
voxel, headed boxes, rotated NMS and IoU losses) on synthetic scenes with
headed GT boxes; each line names its ``config``.  The kernels' launch
counters are set to 0 just before each path's main-path run and read just
after it.

1. device  -- CUDA must be available; prints the card's name and power limit
   as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``.
2. build   -- compiles the hand-written kernels (csrc/*.cu) with nvcc, one
   process per source in parallel; prints each kernel's registers, static
   shared memory and spill bytes (``ptxas -v``).
3. warm-up -- builds the full-width CAGroup3D from the configuration's
   YAML (INPUT_CAP 65536, FINE_CAP 4096, seeded init, semantic gate open,
   class prior lifted so the RoI head gets proposals) and answers one
   100k-point request, recording the inputs of every K1 (sparse conv) and K2
   (segment sum) call.
4. k1      -- every recorded K1 call, kernel against its plain PyTorch
   version on the same inputs, grouped by main-path form (a)-(f); bars:
   relative error < 2e-2 of the output's largest magnitude, per-row error
   < 1e-3 (see ``row_err``), invalid query rows exactly 0, every
   source table key-sorted with invalid rows last (the kernel's contract),
   and a second call on the same inputs giving the same bits; each shape
   prints the plan it took (``k1_plan``: tile width, column tiles per
   block, offset split) and each form's time with the previous kernel
   design and whether this run is within half of it, and the time of the
   library yardstick, one ``torch.bmm`` on the zero-filled gathered
   operand (built before timing; ``library_ms``).  The earlier designs'
   times were taken on the ScanNet path and are printed there only.
5. k2      -- the recorded (overflowing) K2 call and a non-overflowing one
   with its groups and rows (ScanNet G=18, P=65536; SUN RGB-D G=10,
   P=131072: three votes and the voxel per stride-2 row), F=64,
   cap=4096; counts exact, sums within both bars, the same bits from a
   second call; the plan (rows per block, blocks).
6. requests -- launch counters reset, three 100k-point scenes (synthetic
   seeds 0, 1, 2) through ``forward_eval``; outputs finite with the
   expected shapes, both kernels launched, headed boxes on the yaw path;
   per-scene latency.
7. reference -- a tiny configuration's forward on the card (kernels)
   against the same model on the CPU (plain versions): same valid and
   labels, boxes within 1e-2, scores within 1e-3, stage by stage on the
   same inputs (head; proposals from seeded logits; the RoI stage with the
   rotated grid cells the devices floor apart counted), then the whole
   forward, held on ScanNet and printed on the yaw path
   (``phase_reference``).
7b. test-cli -- the eval entry point: a synthetic tree of four 100k-point
   scenes (``write_indoor_tree``; ScanNet points in a raw frame under a
   z-rotated, translated axis-align matrix, SUN RGB-D headed boxes), a
   checkpoint of the YAML's full-width model (seeded, gate open and prior
   lifted as in 6) saved with ``save_checkpoint``, and the ``test`` CLI
   (``cagroup3d_tpu_torch.tools.test``) run in-process over it at batch 1:
   result.pkl holds every scene; ``forward_eval``'s inputs equal the
   loader's batches bitwise on the card and result.pkl equals its outputs
   unpadded by ``pred_valid`` bitwise; every loaded GT box holds the points
   the writer counted in it in the aligned frame; the GT as predictions
   scores mAP and mAR 1.0, shifted past each box's BEV diagonal 0.0; the
   model's mAP and mAR are finite in [0, 1] for every class of the tree;
   K1 and K2 launched.  It prints the harness's ms/scene, the loader's
   share and whether two direct calls give the same bits
   (``phase_test_cli``).
7d. demo (ScanNet) -- the ``demo`` CLI (``cagroup3d_tpu_torch.tools.demo``)
   in-process on two 100k-point scenes, a ``.bin`` and an ``.npy``, with a
   checkpoint of phase 6's model: each ``--out_file`` equals
   ``forward_eval`` at epoch 1000 on the same batches bit for bit, K1 and
   K2 launched, the ``.bin`` read by the C++ library of
   ``datasets/native_io`` (not its numpy fallback), and ``--render_dir``
   failing on a missing matplotlib before the first scene (``phase_demo``).
7c. train-cli -- the training entry point: a one-batch 100k-point
   synthetic tree of 2 scenes (CLI_TRAIN_BATCH) with REPEAT.train 1, the
   ``train`` CLI (``cagroup3d_tpu_torch.tools.train``) run in-process at
   the YAML's full width and ``--batch_size 2``, with the model as users
   build it:
   ``--epochs 1`` (one step), then ``--epochs 2``, which resumes
   from ``checkpoint_epoch_1.pkl``; then the ``test`` CLI on
   ``checkpoint_epoch_2.pkl`` over the same tree (mAP printed only).
   Held: every step's and every logged loss finite, the resume logged,
   the checkpoints' epoch and it, their keys the model's parameters and
   buffers, K1 and K3 launched in the steps and K2 in the eval.  It
   prints ms per step (loader wait plus step), the loader's share and the
   peak GB (``phase_train_cli``).
8. k3      -- one full-width training step of one scene (forward, losses,
   ``backward()``), recording every K1 call (forward and feature backward)
   and every K3 call; each against its plain version on the same inputs,
   grouped by main-path form (a)-(f), with the bars of phase 4 (same
   bits on a second call included) and every source table key-sorted;
   kernel, plain, library and bound ms per form, plans and earlier times
   as in 4 (K3: ``k3_plan``'s tile width and pair split, and the bytes of
   its map scratch).
9. train   -- full-width CAGroup3D trained with the YAML's OPTIMIZATION
   (AdamW, lr 1e-3, wd 1e-4, clip 10) at its BATCH_SIZE_PER_GPU synthetic
   100k-point scenes per step (ScanNet 4, SUN RGB-D 8): TRAIN_STEPS
   (ScanNet) or TRAIN_STEPS_YAW timed steps with the launch counters
   reset before them, the first timed (no warm-up step: the model ran
   phase 8's step, and phase 7c's B-scene steps ran in this process); loss and tb finite (the yaw path's
   ``rcnn_loss_iou`` among them), every backbone, head and RoI
   parameter's gradient finite and each module's non-zero, parameters and
   BN running stats changed, K1 and K3 launched; peak memory.
10. train-reference -- one training step of the tiny configuration (at
   ``cpu_caps``: half its caps, k3 class convs) at
   B = 2 on the card against the same step on the CPU, same draws, zero
   votes (a vote's floor is the one discrete step that f32 round-off
   moves): loss within 1e-3; per module, the worst parameter's gradient
   error and the whole gradient's error in norm within 2e-2 or within
   twice what the CPU step itself moves when every weight is scaled by
   1 + 1e-7.  The step is chaotic: bf16-rounded conv inputs and
   cotangents turn f32 round-off into bf16 ulps that train-mode BN over
   the deep maps' few voxels amplifies, so one ulp of the weights moves
   the CPU's backbone gradient by about half its norm (see
   ``grad_report``).
11. learn  -- the tiny configuration, one fixed B = 2 batch, 30 steps: the
   loss falls at least nine tenths of the drop the JAX package's step makes
   on the CPU in the same setting (``JAX_LEARN_DROP``, ``JAX_LEARN_DROP_YAW``
   from ``tests/learn_margin.py [--yaw]``).  Like every learn phase it
   runs at the end, beside the dist phase, in a process of its own
   (``LearnJobs``: ``python3 chip_smoke.py --learn <job>``), and its line
   is printed after the dist phase's.

Then RBGNet (tools/cfgs/{scannet,sunrgbd}_models/RBGNet.yaml; lines
tagged ``"config": "rbgnet_scannet"`` / ``"rbgnet_sunrgbd"``), at full
width on synthetic scenes; its path has no hand-written kernel, and every
RBGNet phase holds that K1, K2 and K3 launch 0 times:
rbgnet-requests -- the YAML's seeded model through ``build_network``; a
   warm-up and three 100k-point scenes through ``forward_eval`` at batch 1;
   outputs finite with the expected shapes, headed boxes on SUN RGB-D;
   ms per scene and one synchronized stage split (backbone and its FPS,
   vote module with aggregation and predictions, ray grouping and its
   FPS, boxes and NMS; ``rbg_stage_split``).
rbgnet-test-cli -- phase 7b's checks on RBGNet: the ``test`` CLI over a
   4-scene 100k-point tree with a checkpoint of that model; result.pkl
   equals the forward's outputs unpadded, the GT-as-predictions oracle
   scores 1.0, the model's mAP finite in [0, 1].
rbgnet-train -- phase 9 on RBGNet: the YAML's OPTIMIZATION (AdamW, lr
   0.006, wd 0.01, clip 10) at B = 8, RBG_TRAIN_STEPS timed steps (no
   warm-up, as in 9); loss, tb and every gradient finite, each module's non-zero,
   parameters and BN running stats changed; ms per step, peak GB.
rbgnet-train-cli -- the ``train`` CLI for one epoch over an 8-scene tree
   with REPEAT.train 1 (one step at B = 8): losses finite, the
   checkpoint's keys the model's (``phase_rbg_train_cli``).
rbgnet-reference -- the tiny configuration (``TINY_RBG``), card against
   CPU, stage by stage on the same inputs at phase 7's bars, discrete
   steps that part the devices counted (``phase_rbg_reference``).
rbgnet-learn -- (at the end, ``LearnJobs``) the tiny configuration on
   one fixed B = 2 batch, 60 steps: the drop of the loss's ungated part (``rbg_drop`` of
   ``rbg_learn_loss``: 1 - the median of the second half / the first) at
   least nine tenths of the JAX package's (``JAX_LEARN_DROP_RBG``,
   ``JAX_LEARN_DROP_RBG_YAW`` from ``tests/learn_margin.py --rbgnet
   [--yaw]``).

Then SECOND on KITTI (tools/cfgs/kitti_models/second.yaml; lines tagged
``"config": "kitti_second"``; its lattice packs keys at (11, 11, 8), set
only around the model's own forward):
second-requests -- the YAML's full-width SECOND (seeded, built with the
   KITTI dataset config, class prior lifted so the NMS sees its 1024
   candidates); a warm-up frame records every K1 call (11: 8 submanifold,
   3 strided at coords) and the bits it launched at, each replayed
   against its plain version with phase 4's bars (``k1`` lines, forms g
   and h, with time, bound and ``library_ms``); then three synthetic
   120k-point frames (``kitti_frame``) at batch 1: ms/scene, peak GB, K1's
   launches a scene, finite outputs, two calls the same bits, and the
   NMS's row-blocked overlap matrix (``nms_blocks``) the same bits at two
   block sizes, at 1024 and 4096 boxes.
second-reference -- the tiny SECOND (``TINY_SECOND``, the widths of
   tests/test_outdoor.py::second_cfg, at KITTI's grid) card against CPU
   stage by stage on the CPU's inputs: voxel and level lattices exact,
   features within 2e-2, the BEV map exact, the 2-D backbone and head
   within 1e-3, the NMS keep mask exact (``phase_second_reference``).
second-test-cli -- an 8-frame raw KITTI tree (``write_kitti_tree``, 18
   objects a frame) with its infos, a checkpoint of the full-width model
   and the ``test`` CLI in-process at batch 1: result.pkl equals the
   recorded ``forward_eval`` outputs bitwise, the batches hold the
   writer's in-range points, the GT as predictions scores the official
   3D AP R40 of 100 on every class and difficulty (0 moved 2 m), K1 11
   launches a frame, two calls the same bits; ms/scene and the loader's
   share (``phase_second_test_cli``).
Training, on a raw tree of four 120k-point train frames, one batch:
second-train -- the full-width SECOND (seeded, as users build it) at the
   YAML's B = 4 through ``KittiDataset`` in train mode (gt sampling, the
   world flip, rotation and scaling): one step records every K1 call,
   forward (11 a scene) and feature backward (10: the stem's input takes
   no gradient), and every K3 call (11), each replayed against its plain
   version at (11, 11, 8) with phase 8's bars (``k3`` lines, forms g and
   h); then SECOND_TRAIN_STEPS timed adam_onecycle steps: ms/step, peak
   GB, the assigner's ms a scene, the launches, the loss finite with a
   box term, every parameter and BN buffer moved (``phase_second_train``).
grad-bits -- the same model and one batch: the training loss's forward
   and backward with all device memory free, with all but 12 GB held
   back, and with all free again; every gradient the same bits in the
   three runs (the 2-D convs run off cuDNN, whose algorithms follow the
   free memory; ``phase_grad_bits``).
second-train-reference -- the tiny SECOND's training step at KITTI's grid
   on the card against the CPU, phase 10's bars (the assigner's IoU
   matrices within 1e-4, the card reading the CPU's).
second-train-cli -- the ``train`` CLI for an epoch and a resumed second,
   then the ``test`` CLI on ``checkpoint_epoch_2.pkl``.
Then, on the same train tree, the rest of KITTI's SECOND family
(``run_zoo_path``; lines tagged ``"config": "kitti_pointpillar"``,
``"kitti_second_multihead"``, ``"kitti_second_iou"``,
``"kitti_centerpoint"``), for each of pointpillar.yaml,
second_multihead.yaml, second_iou.yaml and centerpoint.yaml:
zoo-requests -- the YAML's full-width model (seeded, prior lifted) with
   its own dataset config: a warm-up frame records every K1 call (the
   SECOND variants and CenterPoint 11 at (11, 11, 8); PointPillar none),
   each replayed
   against its plain version (``k1`` lines); two 120k-point frames at
   batch 1: ms/scene, peak GB, K1's launches, finite padded outputs, two
   calls on one frame the same bits.
zoo-reference -- the tiny model (``tiny_zoo_config``) card against CPU:
   eval stages on the CPU's inputs (BEV map, 2-D backbone, head, then
   the prediction on seeded class logits), then one B = 2 training step
   (the loss within 1e-3, phase 10's gradient bars; the CPU's IoU
   matrices and, for SECOND-IoU, its proposals handed to the card).
zoo-train -- one full-width B = 4 ``make_train_step`` step through
   KittiDataset in train mode with the YAML's DATA_CONFIG: ms/step, peak
   GB, launches (K1 21 and K3 11 a scene for the SECOND variants and
   CenterPoint), every K1 and K3 call replayed against its plain version
   (``k3`` lines); the loss finite with a box term, every parameter and
   buffer moved; SECOND-IoU's training proposals' ms a scene.
   CenterPoint then runs ``grad-bits`` as SECOND does.
zoo-train-cli -- pointpillar.yaml's and centerpoint.yaml's ``train`` CLI
   for an epoch and a resumed second, then the ``test`` CLI (PointPillar:
   K1 and K3 launch no time; CenterPoint: both launch).
second-learn -- (at the end, ``LearnJobs``) the tiny SECOND on a 16 x 16
   m grid, one fixed B = 2 batch, 30 steps: the loss falls at least nine tenths as far as the JAX
   package's (``JAX_LEARN_DROP_SECOND``, ``tests/learn_margin.py
   --second``).
bits -- a tiny CAGroup3D built and run afterwards launches K1 at 10/10/10.

Then the multi-card path (``--dist``, one process per card), on this one
card (``phase_dist``):
dist -- two ranks spawned over gloo (NCCL takes one rank a card), each
   with one scene of a two-scene step, against one process of the two
   scenes on the same parameters, batch and generator: the ScanNet YAML's
   full-width CAGroup3D, the tiny SUN RGB-D CAGroup3D, the tiny SUN
   RGB-D RBGNet, and the tiny SECOND, PointPillar, SECOND-multihead,
   SECOND-IoU and CenterPoint on KITTI's range (``DIST_CASES``, one
   spawn).  Held: the
   first step's loss and every tb term within 1e-5 relative, the ranks'
   parameters and BN buffers the same bits after two steps, every
   module's gradients within phase 10's bars, K1 and K3 launched in each
   CAGroup3D and SECOND-family rank (none in RBGNet's or PointPillar's).
   Then the ``train`` CLI with ``--dist`` under ``torchrun --standalone
   --nproc_per_node 1`` (NCCL) for an epoch on a small tree, and the
   ``test`` CLI on its checkpoint under torchrun with ``--dist`` and as
   one plain process: result.pkl the same bits, the same mAP lines.

The line before the last is {"kernels": [...]}: per kernel the launches of
both CAGroup3D paths' main-path runs summed (and of both paths' CLI runs,
``train_cli_launches``; of every RBGNet run, ``rbgnet_launches``; of
SECOND's requests and CLI, ``second_launches`` and
``second_test_cli_launches``; of SECOND's timed training steps and its
``train`` CLI, ``second_train_launches`` and ``second_train_cli_launches``;
of the dist phase's ranks, ``dist_launches``; of the demo phase,
``demo_launches``), the ScanNet path's times
and each path's own under ``paths`` (``kitti_second``: K1 over one SECOND
frame's eval calls, and under ``train`` K1's and K3's over one B = 4
training step's calls).  The last is {"ok": true, "device": {...}}.
"""
import copy
import json
import os
import re
import statistics
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
CFGS = {name: os.path.join(HERE, "tools", "cfgs", f"{name}_models",
                           "CAGroup3D.yaml") for name in ("scannet", "sunrgbd")}
CFG = CFGS["scannet"]
RBG_CFGS = {name: os.path.join(HERE, "tools", "cfgs", f"{name}_models",
                               "RBGNet.yaml") for name in ("scannet",
                                                           "sunrgbd")}
INPUT_CAP, FINE_CAP, N_POINTS = 65536, 4096, 100_000
TOL, ROW_TOL = 2e-2, 1e-3
TRAIN_STEPS, TRAIN_STEPS_YAW, LEARN_STEPS = 1, 1, 30
RBG_TRAIN_STEPS, RBG_LEARN_STEPS = 2, 60
RBG_LEARN_SEEDS = (11,)                 # rbgnet-learn's fixed batches
CLI_SCENES = 8
# phase 7c's batch (the YAMLs ask 4 and 8; phase 9 trains at them), cut to
# keep the whole script under ten minutes (4 until the demo phase came)
CLI_TRAIN_BATCH = 2
NEEDED = ("a_", "b_", "c_", "d_", "e_", "f_")    # the main-path forms
EVAL_KERNELS = ("sparse_conv", "segsum")        # CAGroup3D's eval launches
STEPS_PER_EPOCH = 1000          # no LR decay step inside these runs
# the drop, 1 - last / first loss, that the JAX package's step makes on
# the CPU in the learn setting (tests/learn_margin.py; the port's CPU step
# made 0.3653 in the same run); the random streams of the two packages
# differ, so the card must reach nine tenths of it
JAX_LEARN_DROP = 0.3663
# the same for the SUN RGB-D configuration on headed scenes
# (tests/learn_margin.py --yaw; the port's CPU step made 0.2190)
JAX_LEARN_DROP_YAW = 0.2285
# RBGNet's learn drops (``rbg_drop`` of ``rbg_learn_loss`` over
# RBG_LEARN_STEPS steps, the mean over the RBG_LEARN_SEEDS batches) that
# the JAX package's step makes on the CPU (tests/learn_margin.py --rbgnet
# [--yaw] --seeds 11; the port's CPU step made 0.6962 and 0.7572 in the
# same runs)
JAX_LEARN_DROP_RBG = 0.6693
JAX_LEARN_DROP_RBG_YAW = 0.7806
# K1's ms per main-path form with its first design (a 64 x 64 WMMA tile
# rebuilding its kernel map per column tile; this script on an NVIDIA H100
# 80GB HBM3 at 700.00 W): the redesign's bar is half of each, printed
# beside this run's time (not a failure: runs differ by ~30%)
K1_MS_BEFORE = {
    "k1": {"a_backbone_subm_k3": 12.877, "b_backbone_down_k3": 5.209,
           "c_head_offset_k3": 0.287, "d_head_cls_k9": 5.547,
           "e_head_expand_k5": 0.660, "f_roi_grid_k5": 0.781},
    "k1_train_forward": {"a_backbone_subm_k3": 11.820,
                         "b_backbone_down_k3": 4.966,
                         "c_head_offset_k3": 0.321, "d_head_cls_k9": 5.322,
                         "e_head_expand_k5": 0.626, "f_roi_grid_k5": 0.633},
    "k1_feature_backward": {"a_backbone_subm_k3": 12.305,
                            "b_backbone_down_k3": 5.739,
                            "c_head_offset_k3": 0.300,
                            "d_head_cls_k9": 5.738,
                            "e_head_expand_k5": 0.726,
                            "f_roi_grid_k5": 0.814}}
# K3's ms per main-path form with its first design (a block per (group,
# offset, 64 x 64 dW tile, query chunk) searching the source table per
# query; this script on an NVIDIA H100 80GB HBM3 at 700.00 W): the
# redesign's bar is half of each
K3_MS_BEFORE = {"a_backbone_subm_k3": 13.498, "b_backbone_down_k3": 6.178,
                "c_head_offset_k3": 0.405, "d_head_cls_k9": 6.038,
                "e_head_expand_k5": 0.517, "f_roi_grid_k5": 0.790}
MS_BEFORE = {**K1_MS_BEFORE, "k3_weight_backward": K3_MS_BEFORE}
# the library yardstick (one torch.bmm on the gathered operand) runs in
# chunks of groups of at most this many operand bytes
LIB_CHUNK_BYTES = 1 << 30
# the card's peak rates (NVIDIA data sheet, H100 SXM, dense, 700 W)
HBM_BYTES_PER_S, BF16_FLOPS = 3.35e12, 989e12


T0 = time.time()


def emit(obj):
    """One JSON line; a phase's line carries the script's elapsed seconds
    (``elapsed_s``)."""
    if "phase" in obj:
        obj = dict(obj, elapsed_s=round(time.time() - T0, 1))
    print(json.dumps(obj), flush=True)


def fail(phase, msg):
    emit({"phase": phase, "ok": False, "error": msg})
    raise SystemExit(1)


def time_ms(fn, reps):
    """CUDA-event ms of one call of ``fn``, the mean of ``reps`` calls
    after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def timed_call(fn):
    """(fn(), CUDA-event ms of that one call)."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def rel_err(a, b):
    """max |a - b| over the tensor, relative to max |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))


def row_err(a, b):
    """Largest per-row error: max |a - b| over a row's channels divided by
    that row's max |b|, floored at a tenth of the tensor's max |b| so that
    rows near zero in both do not divide by zero.  A row that is wrong
    while small fails it even where ``rel_err`` stays low."""
    import torch
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    floor = 0.1 * b.abs().max().clamp_min(1e-12)
    den = torch.maximum(b.abs().amax(-1), floor)
    return float(((a - b).abs().amax(-1) / den).max())


def against_before(kind, name, f):
    """This run's ms of a K1 or K3 form beside its first design's and the
    half bar."""
    old = MS_BEFORE.get(kind, {}).get(name)
    return {} if old is None else {"ms_before": old,
                                   "half_of_before": f["ms"] <= old / 2}


def bound(n_bytes, flops):
    """(ms, "bytes" | "operations"): the least time the card could take,
    the larger of the bytes over the memory rate and the bf16 FLOPs over
    the tensor-core rate."""
    tb, to = n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def conv_hits(src_lat, src_valid, K, qry_lat=None, qry_valid=None):
    """(query, offset) pairs with a source neighbour: the pairs a sparse
    conv over these tables multiplies."""
    import torch
    from cagroup3d_tpu_torch.core.kernel_maps import kernel_offsets
    from cagroup3d_tpu_torch.ops.sparse_conv import _hits
    if qry_lat is None:
        qry_lat, qry_valid = src_lat, src_valid
    offs = torch.as_tensor(kernel_offsets(K), device=src_lat.device)
    n = torch.zeros((), dtype=torch.int64, device=src_lat.device)
    for o in range(offs.shape[0]):
        n += _hits(src_lat, src_valid, qry_lat, qry_valid, offs[o])[1].sum()
    return int(n)


def conv_cost(G, N, NQ, C, Cout, Gw, K, hits, subm):
    """(bytes, FLOPs) of one K1 launch: keys (once for the submanifold
    form), bf16 features and weights read once, f32 output written once,
    2 FLOPs per multiply-add of the hit rows."""
    keys = 4 * G * N + (0 if subm else 4 * G * NQ)
    n_bytes = keys + 2 * G * N * C + 2 * Gw * K ** 3 * C * Cout + \
        4 * G * NQ * Cout
    return n_bytes, 2 * hits * C * Cout


def dw_cost(G, N, NQ, C, Cout, Gw, K, hits, subm):
    """(bytes, FLOPs) of one K3 launch: keys, bf16 features and cotangent
    read once, f32 dW written once."""
    keys = 4 * G * N + (0 if subm else 4 * G * NQ)
    n_bytes = keys + 2 * G * N * C + 2 * G * NQ * Cout + \
        4 * Gw * K ** 3 * C * Cout
    return n_bytes, 2 * hits * C * Cout


def bwd_forms(calls, group_of):
    """Main-path form of each recorded backward call, in autograd order:
    the RoI grid conv (f), the head's per-class k5 (e) and k9 (d), its
    feature_offset k3 (c, the first single-table k3 after the head's),
    then the backbone (a subm, b down)."""
    forms, seen_head, c_done = [], False, False
    for args, _ in calls:
        G, K, query = group_of(args)
        if G > 1:
            seen_head = True
            forms.append("d_head_cls_k9" if K == 9 else f"e_head_expand_k{K}")
        elif query:
            forms.append(f"f_roi_grid_k{K}" if K == 5
                         else f"b_backbone_down_k{K}")
        elif seen_head and not c_done and K == 3:
            c_done = True
            forms.append(f"c_head_offset_k{K}")
        else:
            forms.append(f"a_backbone_subm_k{K}")
    return forms


def gathered(src_lat, src_valid, feats, K, qry_lat=None, qry_valid=None):
    """The zero-filled gathered operand of a sparse conv, bf16 [G, NQ,
    K^3 C]: per offset each query's neighbour row (invalid rows zeroed) or
    zeros -- the TPU kernel's own formulation, a dense [QW, K C] tile per
    query block."""
    import torch
    from cagroup3d_tpu_torch.core.kernel_maps import kernel_offsets
    from cagroup3d_tpu_torch.core.sparse import zero_invalid
    from cagroup3d_tpu_torch.ops.sparse_conv import _hits
    if qry_lat is None:
        qry_lat, qry_valid = src_lat, src_valid
    G, _, C = feats.shape
    f16 = zero_invalid(feats, src_valid).to(torch.bfloat16)
    offs = torch.as_tensor(kernel_offsets(K), device=feats.device)
    op = torch.zeros(G, qry_lat.shape[1], offs.shape[0] * C,
                     dtype=torch.bfloat16, device=feats.device)
    for o in range(offs.shape[0]):
        pos, hit = _hits(src_lat, src_valid, qry_lat, qry_valid, offs[o])
        op[:, :, o * C:(o + 1) * C] = zero_invalid(torch.gather(
            f16, 1, pos[..., None].expand(-1, -1, C)), hit)
    return op


def bmm_ms(a, b):
    """ms of torch.bmm(a, b) in chunks of groups (no operand chunk above
    LIB_CHUNK_BYTES), summed."""
    import torch
    n = max(1, LIB_CHUNK_BYTES // (a[0].numel() * a.element_size()))
    return sum(time_ms(lambda i=i: torch.bmm(a[i:i + n], b[i:i + n]), 3)
               for i in range(0, a.shape[0], n))


def library_conv_ms(src_lat, src_valid, feats, w, K, qry_lat=None,
                    qry_valid=None):
    """K1's yardstick: one torch.bmm of the gathered operand [G, NQ, K^3 C]
    (built before timing, as K2's ids are) with the weights [G, K^3 C,
    Cout]."""
    import torch
    op = gathered(src_lat, src_valid, feats, K, qry_lat, qry_valid)
    G = op.shape[0]
    wg = w.to(torch.bfloat16)[torch.arange(G, device=w.device) % w.shape[0]]
    return bmm_ms(op, wg.reshape(G, op.shape[2], -1))


def library_dw_ms(src_lat, src_valid, feats, gout, K, Gw, qry_lat=None,
                  qry_valid=None):
    """K3's yardstick: one torch.bmm of the gathered operand, transposed
    [G, K^3 C, NQ], with the cotangent [G, NQ, Cout] (the sum over groups
    that share weights left out)."""
    import torch
    op = gathered(src_lat, src_valid, feats, K, qry_lat, qry_valid)
    return bmm_ms(op.transpose(1, 2), gout.to(torch.bfloat16))


def grads_of(model, prefix=""):
    """{name: gradient (f64, on the CPU)} of the model's parameters under
    ``prefix``."""
    return {k: p.grad.detach().double().cpu() for k, p in
            model.named_parameters() if k.startswith(prefix)}


def grad_report(model_a, model_b, prefix):
    """Per-parameter gradient errors of model_a against model_b (models,
    or their ``grads_of``) under ``prefix``: (worst name, worst relative
    error in norm, number compared, whole-vector relative error, cosine).
    A gradient below 1e-4 of the group's largest norm (a BN bias whose
    gradient the next BN cancels) is round-off on both sides and is held
    only to that floor."""
    import torch
    ga, gb = ({k: v for k, v in (m if isinstance(m, dict) else grads_of(m))
               .items() if k.startswith(prefix)} for m in (model_a, model_b))
    norms = {k: float(v.norm()) for k, v in gb.items()}
    floor = 1e-4 * max(norms.values())
    errs, floor_ok = {}, True
    for k in gb:
        if norms[k] < floor:
            floor_ok &= float(ga[k].norm()) < 10 * floor
        else:
            errs[k] = float((ga[k] - gb[k]).norm()) / norms[k]
    a = torch.cat([v.reshape(-1) for v in ga.values()])
    b = torch.cat([gb[k].reshape(-1) for k in ga])
    worst = max(errs, key=errs.get)
    return dict(worst=worst, worst_rel=errs[worst], compared=len(errs),
                floor_ok=floor_ok,
                vector_rel=float((a - b).norm() / b.norm()),
                cosine=float(a @ b / (a.norm() * b.norm())))


def held_grads(gpu_m, cpu_m, pert_m, prefixes):
    """Phase 10's gradient bars, per module prefix: the card's worst
    parameter and whole gradient within TOL of the CPU's, or within twice
    what the CPU's gradient moves in ``pert_m`` (its weights scaled by
    1 + 1e-7).  Returns ({prefix: report}, all held)."""
    reports = {}
    for pre in prefixes:
        card, noise = grad_report(gpu_m, cpu_m, pre), \
            grad_report(pert_m, cpu_m, pre)
        card["noise_worst_rel"] = noise["worst_rel"]
        card["noise_vector_rel"] = noise["vector_rel"]
        card["ok"] = (card["floor_ok"] and
                      card["worst_rel"] <= max(TOL, 2 * noise["worst_rel"])
                      and card["vector_rel"] <=
                      max(TOL, 2 * noise["vector_rel"]))
        reports[pre] = card
    return reports, all(r["ok"] for r in reports.values())


def build_model(mc, n_cls, device, seed, train=False):
    """Seeded model with the semantic gate open: every voxel in every class
    map, so the per-class maps fill (and overflow at full caps) as a
    trained model's do.  Eval phases open it wide (logit 5) and lift the
    class prior so the RoI head gets proposals; training phases open it
    just above the threshold (score 0.3 > SEMANTIC_THR 0.15) and keep the
    prior, since a wide gate or a lifted prior makes the focal losses of
    the negatives swamp the rest; jittered GT boxes stand in for the
    proposals there (``tiny_train_config``)."""
    import torch
    from cagroup3d_tpu_torch.models import build_network
    m = build_network(mc, n_cls, generator=torch.Generator().manual_seed(seed),
                      device=device)
    open_gate(m, train)
    return m


def open_gate(m, train):
    import math
    import torch
    with torch.no_grad():
        if train:
            m.dense_head.semantic_conv.bias.fill_(math.log(0.3 / 0.7))
        else:
            m.dense_head.semantic_conv.bias.fill_(5.0)
            m.dense_head.cls_conv.bias.fill_(2.0)


def tiny_config(seed_cfg=CFG):
    """Phase 7's tiny configuration of the flagship (16 channels, small
    caps): (model_cfg, class_names, full config)."""
    from cagroup3d_tpu_torch.models import load_config
    cfg = load_config(seed_cfg)
    tiny_model(cfg.MODEL)
    return cfg.MODEL, list(cfg.CLASS_NAMES), cfg


def tiny_model(tc):
    """Set a model configuration's widths and caps to the tiny ones, in
    place."""
    tc.BACKBONE_3D.update(CAPS={1: 2048, 2: 2048, 4: 1024, 8: 512, 16: 256,
                                32: 128, 64: 32, 128: 16, 256: 8, 512: 8},
                          PLANES=16, SPP_PLANES=16, OUT_CHANNELS=16)
    tc.INPUT_CAP = 2048
    tc.DENSE_HEAD.update(OUT_CHANNELS=16, FINE_CAP=1024, EXPAND_CAP=1024,
                         MAX_ROIS=64, NMS_PER_CLS_CAP=32)
    tc.DENSE_HEAD.NMS_CONFIG.NMS_PRE = 256
    tc.ROI_HEAD.update(MLPS=[[16, 32, 32]], REG_FC=[32, 32], GRID_CAP=2048,
                       NMS_PER_CLS_CAP=32, MAX_OUT=32)


def tiny_train_config(seed_cfg=CFG):
    """The tiny configuration for the training phases: larger class maps,
    no RoI dropout, and jittered GT boxes among the proposals
    (``ROI_GT_AUG``; an untrained one-stage net proposes no box that
    overlaps a GT by IoU 0.3, which would leave the RoI loss and its
    gradients at zero)."""
    tc, names, cfg = tiny_config(seed_cfg)
    tc.DENSE_HEAD.update(FINE_CAP=2048, EXPAND_CAP=1024)
    tc.ROI_HEAD.DP_RATIO = 0.0
    tc.ROI_GT_AUG = 0.05
    return tc, names, cfg


# RBGNet's tiny widths (tests/test_rbgnet.py::tiny_rbg_cfg) by configuration
# key below MODEL; the YAML keeps its classes, bins, radii and thresholds
TINY_RBG = {
    "BACKBONE_3D.SA_CONFIG.NPOINTS": [128, 64, 32, 16],
    "BACKBONE_3D.SA_CONFIG.NSAMPLE": [8, 8, 4, 4],
    "BACKBONE_3D.SA_CONFIG.MLPS": [[16, 16, 32], [32, 32, 32], [32, 32, 32],
                                   [32, 32, 32]],
    "BACKBONE_3D.SA_CONFIG.FBS_MLPS": [[-1, -1], [16, 16], [16, 16],
                                       [16, 16]],
    "BACKBONE_3D.SA_CONFIG.TOPK": [-1, 48, 24, 12],
    "BACKBONE_3D.SA_CONFIG.FG_NSAMPLE": [-1, 48, 24, 12],
    "BACKBONE_3D.FP_MLPS": [[32, 32], [32, 32]],
    "POINT_HEAD.VOTE_MODULE_CFG.IN_CHANNELS": 32,
    "POINT_HEAD.VOTE_MODULE_CFG.CONV_CHANNELS": [32, 32],
    "POINT_HEAD.VOTE_AGGREGATION_CFG.NUM_POINTS": 16,
    "POINT_HEAD.VOTE_AGGREGATION_CFG.NUM_SAMPLE": 4,
    "POINT_HEAD.VOTE_AGGREGATION_CFG.MLP_CHANNELS": [32, 16, 16, 16],
    "POINT_HEAD.PRED_LAYER_CFG.IN_CHANNELS": 16,
    "POINT_HEAD.PRED_LAYER_CFG.SHARED_CONV_CHANNELS": [16, 16],
    "POINT_HEAD.FPS_NUM_SAMPLE": 128,
    "POINT_HEAD.RAY_NUM": 18,
    "POINT_HEAD.RAY_BASED_GROUP.RAY_NUM": 18,
    "POINT_HEAD.RAY_BASED_GROUP.SEED_FEAT_DIM": 32,
    "POINT_HEAD.RAY_BASED_GROUP.FPS_NUM_SAMPLE": 128,
    "POINT_HEAD.RAY_BASED_GROUP.SA_NUM_SAMPLE": 4,
    "POINT_HEAD.RAY_BASED_GROUP.NUM_SEED_POINTS": 64,
}


def tiny_rbg_model(mc):
    """Set an RBGNet model configuration's widths to the tiny ones, in
    place."""
    for key, value in TINY_RBG.items():
        *path, leaf = key.split(".")
        d = mc
        for p in path:
            d = d[p]
        d[leaf] = copy.deepcopy(value)
    return mc


def tiny_rbg_set():
    """The tiny widths as the CLIs' ``--set`` arguments."""
    return [x for k, v in TINY_RBG.items() for x in (f"MODEL.{k}", repr(v))]


TINY_SCENE = dict(n_points=4000, room=(3.0, 3.0, 2.5), n_objects=4)
TINY_TRAIN_SCENE = dict(n_points=1500, room=(3.0, 3.0, 2.5), n_objects=4)


def synthetic_train_batch(seed: int, device, batch_size: int,
                          n_points: int = 100_000, n_classes: int = 18,
                          **kw):
    """B synthetic scenes as a ``forward_train`` batch on ``device``
    (``yaw=True``: headed GT boxes, for SUN RGB-D).  The generator leaves
    the semantic/instance masks empty; here (test data, not a feature of
    the port) a point inside GT box i takes that box's class and instance
    id i + 1 (the first box in index order wins; id 0 stays the unlabelled
    background), so the ScanNet vote targets are not all empty."""
    import numpy as np
    import torch
    from cagroup3d_tpu_torch.utils.synthetic import (box_local_xy,
                                                     synthetic_batch)
    b = synthetic_batch(np.random.RandomState(seed), batch_size=batch_size,
                        n_points=n_points, point_cap=n_points,
                        n_classes=n_classes, **kw)
    for s in range(batch_size):
        xyz = b["points"][s, :, :3]
        for i in np.nonzero(b["gt_valid"][s])[0][::-1]:
            box = b["gt_boxes"][s, i]
            inside = np.all(np.abs(box_local_xy(xyz[:, :2], box)) <
                            box[3:5] / 2, axis=-1)
            inside &= np.abs(xyz[:, 2] - box[2]) < box[5] / 2
            inside &= b["points_valid"][s]
            b["semantic_mask"][s, inside] = int(box[7])
            b["instance_mask"][s, inside] = i + 1
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def k1_form(i, calls):
    args, kw = calls[i]
    G, K = args[2].shape[0], args[4]
    has_q = kw.get("qry_lat", args[5] if len(args) > 5 else None) is not None
    if G > 1:
        return "d_head_cls_k9" if K == 9 else f"e_head_expand_k{K}"
    if has_q:
        return f"f_roi_grid_k{K}" if K == 5 else f"b_backbone_down_k{K}"
    nxt = calls[i + 1][0][2].shape[0] if i + 1 < len(calls) else 1
    return f"c_head_offset_k{K}" if nxt > 1 else f"a_backbone_subm_k{K}"


def recorder(fn, log):
    """fn, logging the (args, kw) of every call into ``log``."""
    def rec(*args, **kw):
        log.append((args, kw))
        return fn(*args, **kw)
    rec.launches = 0     # a wrapper bumps the counter of its module's name
    return rec


def k1_args(args, kw):
    """(src_lat, src_valid, src_feats, w, K, qry_lat, qry_valid) of a
    recorded sparse_conv call."""
    a = list(args) + [None] * (7 - len(args))
    a[5] = kw.get("qry_lat", a[5])
    a[6] = kw.get("qry_valid", a[6])
    return a


def replay(calls, forms, run, plain, info, library):
    """Replay recorded calls with the kernel and the plain version on the
    same inputs and gather per-form stats: errors (``rel_err``,
    ``row_err``), zero rows, sorted sources, whether a second kernel call
    gives the same bits, CUDA-event ms of both (the plain version's on its
    reference call, so that it runs once), the bound ms and the library
    yardstick's ms (``library(args, kw)``).  ``info(args, kw)`` ->
    (zero-row mask or None, source tables that must be key-sorted, (bytes,
    FLOPs), shape dict with the launch's plan)."""
    import torch
    stats = {}
    with torch.no_grad():
        for (args, kw), form in zip(calls, forms):
            got = run(*args, **kw)
            ref, plain_ms = timed_call(lambda: plain(*args, **kw))
            again = run(*args, **kw)
            rows, tables, (n_bytes, flops), shape = info(args, kw)
            f = stats.setdefault(form, dict(
                calls=0, max_rel=0.0, max_row=0.0, max_abs=0.0, ms=0.0,
                plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bytes=0, flops=0,
                zero_ok=True,
                sorted=True, same_bits=True, shapes=[]))
            f["calls"] += 1
            f["same_bits"] &= bool(torch.equal(got, again))
            f["max_rel"] = max(f["max_rel"], rel_err(got, ref))
            f["max_row"] = max(f["max_row"], row_err(got, ref))
            f["max_abs"] = max(f["max_abs"], float((got - ref).abs().max()))
            if rows is not None:
                f["zero_ok"] &= bool((got[~rows] == 0).all())
            f["sorted"] &= all(sources_sorted_(*t) for t in tables)
            f["ms"] += time_ms(lambda: run(*args, **kw), 5)
            f["plain_ms"] += plain_ms
            f["library_ms"] += library(*args, **kw)
            f["bytes"] += n_bytes
            f["flops"] += flops
            if shape not in f["shapes"]:
                f["shapes"].append(shape)
    for f in stats.values():
        f["bound_ms"], f["bound_by"] = bound(f["bytes"], f["flops"])
        f["ok"] = (f["max_rel"] < TOL and f["max_row"] < ROW_TOL and
                   f["zero_ok"] and f["sorted"] and f["same_bits"])
    return stats


def k1_plan(*shape):
    from cagroup3d_tpu_torch.ops.sparse_conv import k1_plan as plan
    return plan(*shape)


def sources_sorted_(lat, valid):
    from cagroup3d_tpu_torch.ops.sparse_conv import sources_sorted
    return sources_sorted(lat, valid)


def k1_info(args, kw):
    src_lat, src_valid, feats, w, K, qry_lat, qry_valid = k1_args(args, kw)
    G, N, C = feats.shape
    Gw, _, _, Cout = w.shape
    NQ = N if qry_lat is None else qry_lat.shape[1]
    hits = conv_hits(src_lat, src_valid, K, qry_lat, qry_valid)
    rows = src_valid if qry_lat is None else qry_valid
    return (rows, [(src_lat, src_valid)],
            conv_cost(G, N, NQ, C, Cout, Gw, K, hits, qry_lat is None),
            dict(G=G, N=N, NQ=NQ, C=C, Cout=Cout, K=K,
                 plan=k1_plan(G, NQ, C, Cout, K)._asdict()))


def dfeats_info(args, kw):
    """Feature backward: K1 with the query table as the source."""
    src_lat, src_valid, w, K, gout, qry_lat, qry_valid = \
        (list(args) + [None, None])[:7]
    G, NQ, Cout = gout.shape
    N, C = src_lat.shape[1], w.shape[2]
    hits = conv_hits(src_lat, src_valid, K, qry_lat, qry_valid)
    subm = qry_lat is None
    tables = [(src_lat, src_valid)] if subm else [(qry_lat, qry_valid)]
    return (src_valid, tables,
            conv_cost(G, NQ, N, Cout, C, w.shape[0], K, hits, subm),
            dict(G=G, N=NQ, NQ=N, C=Cout, Cout=C, K=K,
                 plan=k1_plan(G, N, Cout, C, K)._asdict()))


def dw_args(args):
    """(src_lat, src_valid, feats, gout, K, Gw, qry_lat, qry_valid) of a
    recorded sparse_conv_dw call."""
    return (list(args) + [None, None])[:8]


def dw_info(args, kw):
    from cagroup3d_tpu_torch.ops.sparse_conv import _k3_scratch, k3_plan
    src_lat, src_valid, feats, gout, K, Gw, qry_lat, qry_valid = dw_args(args)
    G, N, C = feats.shape
    NQ, Cout = gout.shape[1], gout.shape[2]
    hits = conv_hits(src_lat, src_valid, K, qry_lat, qry_valid)
    plan = k3_plan(G, NQ, C, Cout, K)
    _, scratch, map_bytes = _k3_scratch(G, N, NQ, C, Cout, Gw, K,
                                        qry_lat is not None, plan.split)
    return (None, [(src_lat, src_valid)],
            dw_cost(G, N, NQ, C, Cout, Gw, K, hits, qry_lat is None),
            dict(G=G, N=N, NQ=NQ, C=C, Cout=Cout, Gw=Gw, K=K,
                 plan=plan._asdict(), map_scratch_bytes=map_bytes,
                 scratch_bytes=scratch))


def dfeats_library_ms(src_lat, src_valid, w, K, gout, qry_lat=None,
                      qry_valid=None):
    """The feature backward's yardstick: K1's with the query table as the
    source, the cotangent as the rows and ``w_rev_t(w)``."""
    from cagroup3d_tpu_torch.ops.sparse_conv import w_rev_t
    if qry_lat is None:
        return library_conv_ms(src_lat, src_valid, gout, w_rev_t(w), K)
    return library_conv_ms(qry_lat, qry_valid, gout, w_rev_t(w), K, src_lat,
                           src_valid)


def total(stats):
    """Summed ms, plain ms, library ms, bound (over all forms' bytes and
    FLOPs) and the largest absolute error of a replay's forms."""
    ms_b, by = bound(sum(f["bytes"] for f in stats.values()),
                     sum(f["flops"] for f in stats.values()))
    return dict(ms=sum(f["ms"] for f in stats.values()),
                plain_ms=sum(f["plain_ms"] for f in stats.values()),
                library_ms=sum(f["library_ms"] for f in stats.values()),
                bound_ms=ms_b, bound_by=by,
                max_abs=max(f["max_abs"] for f in stats.values()))


def phase_k3(model, dev, needed, path):
    """Phase 8: record and replay every K1 and K3 call of one training
    step of one full-width scene of ``path`` (a ``Path``).  Returns (K1
    totals, K3 totals)."""
    import torch
    import cagroup3d_tpu_torch.ops.sparse_conv as ops_sc
    from cagroup3d_tpu_torch.core import sparse_conv as core_conv
    from cagroup3d_tpu_torch.ops.sparse_conv import (
        sparse_conv, sparse_conv_dfeats, sparse_conv_dfeats_plain,
        sparse_conv_dw, sparse_conv_dw_plain, sparse_conv_plain)

    fwd_calls, dfe_calls, dw_calls = [], [], []
    core_conv.sparse_conv = recorder(sparse_conv, fwd_calls)
    ops_sc.sparse_conv_dfeats = recorder(sparse_conv_dfeats, dfe_calls)
    ops_sc.sparse_conv_dw = recorder(sparse_conv_dw, dw_calls)
    try:
        t0 = time.time()
        batch1 = synthetic_train_batch(10, dev, 1, N_POINTS, **path.scene)
        loss, _, _ = model.forward_train(batch1,
                                         torch.Generator().manual_seed(0))
        loss.backward()
        torch.cuda.synchronize()
        step1_s = time.time() - t0
    finally:
        core_conv.sparse_conv = sparse_conv
        ops_sc.sparse_conv_dfeats = sparse_conv_dfeats
        ops_sc.sparse_conv_dw = sparse_conv_dw
    model.zero_grad(set_to_none=True)
    fwd_stats = replay(fwd_calls, [k1_form(i, fwd_calls)
                                   for i in range(len(fwd_calls))],
                       sparse_conv, sparse_conv_plain, k1_info,
                       library_conv_ms)
    dfe_stats = replay(dfe_calls, bwd_forms(
        dfe_calls, lambda a: (a[4].shape[0], a[3], len(a) > 5 and
                              a[5] is not None)),
        sparse_conv_dfeats, sparse_conv_dfeats_plain, dfeats_info,
        dfeats_library_ms)
    dw_stats = replay(dw_calls, bwd_forms(
        dw_calls, lambda a: (a[2].shape[0], a[4], len(a) > 6 and
                             a[6] is not None)),
        sparse_conv_dw, sparse_conv_dw_plain, dw_info, library_dw_ms)
    for kind, st_ in (("k1_train_forward", fwd_stats),
                      ("k1_feature_backward", dfe_stats),
                      ("k3_weight_backward", dw_stats)):
        for name, f in sorted(st_.items()):
            emit({"phase": "k3", "config": path.name, "kernel": kind,
                  "form": name, **f, **path.against_before(kind, name, f)})
    bad = [k for st_ in (fwd_stats, dfe_stats, dw_stats)
           for k, f in st_.items() if not f["ok"]]
    missing = [p for p in needed if not any(n.startswith(p) for n in dw_stats)
               or not any(n.startswith(p) for n in dfe_stats)]
    if bad or missing:
        fail("k3", f"a training-step kernel call disagrees with its plain "
                   f"version or is unsorted ({bad}), or a form is missing "
                   f"({missing})")
    emit({"phase": "k3", "config": path.name, "ok": True,
          "step_seconds": round(step1_s, 3),
          "k1_forward_calls": len(fwd_calls),
          "k1_backward_calls": len(dfe_calls), "k3_calls": len(dw_calls)})
    k1_train = total({**{"f" + k: v for k, v in fwd_stats.items()},
                      **{"b" + k: v for k, v in dfe_stats.items()}})
    return k1_train, total(dw_stats)


def phase_train(model, dev, gpu, power, path, n_points=N_POINTS):
    """Phase 9: B-scene training steps at full width (B and the optimizer
    from the YAML).  Returns the launch counts of the timed steps."""
    import torch
    from cagroup3d_tpu_torch.parallel.mesh import make_train_step
    from cagroup3d_tpu_torch.training.optimization import build_optimizer
    opt_cfg = path.cfg.OPTIMIZATION
    B = int(opt_cfg.BATCH_SIZE_PER_GPU)
    opt, _ = build_optimizer(model, opt_cfg, STEPS_PER_EPOCH)
    step = make_train_step(model, opt, torch.Generator().manual_seed(1),
                           device=dev)
    batches = [synthetic_train_batch(20 + i, dev, B, n_points, **path.scene)
               for i in range(path.train_steps)]
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    torch.cuda.synchronize()
    launch_counts(reset=True)
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses, tbs = [], [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, tb = step(b, 0.0)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        tbs.append({k: float(v) for k, v in tb.items()})
    train_launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    groups = {}
    for k, p in model.named_parameters():
        g_ = groups.setdefault(k.split(".")[0], dict(n=0, finite=True,
                                                     sq=0.0, zero=0))
        g_["n"] += 1
        g_["finite"] &= p.grad is not None and bool(
            torch.isfinite(p.grad).all())
        if p.grad is not None:
            n2 = float(p.grad.double().pow(2).sum())
            g_["sq"] += n2
            g_["zero"] += n2 == 0.0
    after = model.state_dict()
    params = {k for k, _ in model.named_parameters()}
    changed = {kind: sum(not torch.equal(before[k], after[k]) for k in after
                         if (kind == "params") == (k in params))
               for kind in ("params", "buffers")}
    finite = all(map(lambda x: x == x and abs(x) < float("inf"),
                     losses + [v for t in tbs for v in t.values()]))
    grads_ok = all(g_["finite"] and g_["sq"] > 0 for g_ in groups.values())
    ok = (finite and grads_ok and changed["params"] > 0 and
          changed["buffers"] > 0 and not path.launches_bad(
              train_launches, ("sparse_conv", "sparse_conv_dw")))
    phase = "train" if path.kernels else "rbgnet-train"
    emit({"phase": phase, "config": path.name, "ok": ok, "gpu": gpu,
          "power_limit": power, "scenes_per_step": B,
          "points_per_scene": n_points,
          "steps": path.train_steps, "ms_per_step": step_ms,
          "median_ms": sorted(step_ms)[len(step_ms) // 2],
          "peak_memory_gb": peak_gb, "losses": losses, "tb": tbs[-1],
          "grad_norm_by_module": {k: g_["sq"] ** 0.5
                                  for k, g_ in groups.items()},
          "zero_grad_params": {k: g_["zero"] for k, g_ in groups.items()},
          "changed": changed, "launches": train_launches})
    if path.yaw and path.kernels and \
            not all("rcnn_loss_iou" in t for t in tbs):
        fail("train", "the yaw path's RoI IoU loss is missing")
    if not ok:
        fail(phase, "non-finite loss or gradients, a module without "
                    "gradient, nothing updated, or the kernels' launches "
                    "break the path's rule")
    return train_launches


def learn_batch(path):
    """The tiny scenes of phases 10 and 11 (two, seed 11) on the CPU."""
    return synthetic_train_batch(11, "cpu", 2, **path.scene,
                                 **TINY_TRAIN_SCENE)


def phase_train_reference(dev, path):
    """Phase 10: the tiny training step on the card against the CPU, at
    ``cpu_caps`` (the plain k9 class conv's backward was most of the
    CPU's steps)."""
    import torch
    ttc, names, _ = tiny_train_config(path.cfg_path)
    n_names = len(names)
    cpu_m = build_model(cpu_caps(copy.deepcopy(ttc)), n_names, "cpu", seed=1,
                        train=True)
    with torch.no_grad():
        # zero votes: a voted point floors into its per-class voxel, and
        # one f32 ulp of a random vote (the card sums BN statistics in
        # another order) moves boundary points into other voxels, so the
        # two devices would train on different class maps
        cpu_m.get_parameter("dense_head.offset_block.6.kernel").zero_()
    gpu_m = copy.deepcopy(cpu_m).to(dev)
    tb_cpu = learn_batch(path)
    res = {}
    for name_, m_, b_ in (("cpu", cpu_m, tb_cpu),
                          ("gpu", gpu_m, {k: v.to(dev) for k, v in
                                          tb_cpu.items()})):
        loss, tb, _ = m_.forward_train(b_, torch.Generator().manual_seed(7))
        loss.backward()
        res[name_] = (float(loss.detach()),
                      {k: float(v.detach()) for k, v in tb.items()})
    loss_rel = abs(res["gpu"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    # the step's own sensitivity: the CPU step again with every weight
    # scaled by 1 + 1e-7 (about one f32 ulp)
    pert_m = copy.deepcopy(cpu_m)
    with torch.no_grad():
        for p_ in pert_m.parameters():
            p_.grad = None
            p_.mul_(1 + 1e-7)
    pert_m.forward_train(tb_cpu, torch.Generator().manual_seed(7))[0] \
        .backward()
    reports, grads_ok = held_grads(gpu_m, cpu_m, pert_m, (
        "backbone_3d.", "dense_head.", "roi_head."))
    ok = loss_rel < 1e-3 and grads_ok
    emit({"phase": "train-reference", "config": path.name, "ok": ok,
          "scenes": 2,
          "loss_cpu": res["cpu"][0], "loss_gpu": res["gpu"][0],
          "loss_rel": loss_rel, "tb_cpu": res["cpu"][1],
          "tb_gpu": res["gpu"][1], "grads": reports})
    if not ok:
        fail("train-reference", "card and CPU training steps disagree")


def phase_learn(dev, path):
    """Phase 11: the tiny model's loss falls on one fixed batch (phase
    10's)."""
    import torch
    from cagroup3d_tpu_torch.parallel.mesh import make_train_step
    from cagroup3d_tpu_torch.training.optimization import build_optimizer
    ttc, names, _ = tiny_train_config(path.cfg_path)
    batch = learn_batch(path)
    learn_m = build_model(ttc, len(names), "cpu", seed=1,
                          train=True).to(dev)
    lopt, _ = build_optimizer(learn_m, path.cfg.OPTIMIZATION,
                              STEPS_PER_EPOCH)
    lstep = make_train_step(learn_m, lopt, torch.Generator().manual_seed(0),
                            device=dev)
    lb = {k: v.to(dev) for k, v in batch.items()}
    curve = [float(lstep(lb, 0.0)[0]) for _ in range(LEARN_STEPS)]
    drop = 1.0 - curve[-1] / curve[0]
    margin = 0.9 * path.jax_learn_drop
    ok = all(c == c for c in curve) and drop >= margin
    emit({"phase": "learn", "config": path.name, "ok": ok,
          "steps": LEARN_STEPS, "losses": curve, "drop": drop,
          "required_drop": margin})
    if not ok:
        fail("learn", f"the loss fell by {drop:.3f}, less than nine tenths "
                      f"of the JAX package's {path.jax_learn_drop}")


class Path:
    """One configuration's main path: the YAML, its synthetic scenes
    (class count, headed boxes for the yaw path), the timed training steps
    and the JAX package's learn drop.  CAGroup3D's paths launch the
    kernels (``kernels``).  The ``test`` CLI phases' trees have
    ``cli_scenes`` scenes (the ``train`` CLI's RBGNet tree CLI_SCENES, one
    B = 8 batch)."""
    kernels = True
    cli_scenes = CLI_SCENES // 2

    def __init__(self, name, train_steps, jax_learn_drop, cfg_path=None,
                 dataset=None):
        from cagroup3d_tpu_torch.models import load_config
        self.name, self.cfg_path = name, cfg_path or CFGS[name]
        self.dataset = dataset or name
        self.cfg = load_config(self.cfg_path)
        self.n_cls = len(self.cfg.CLASS_NAMES)
        self.yaw = self._yaw()
        self.scene = dict(n_classes=self.n_cls, yaw=self.yaw)
        self.train_steps, self.jax_learn_drop = train_steps, jax_learn_drop

    def _yaw(self):
        return bool(self.cfg.MODEL.DENSE_HEAD.WITH_YAW)

    def detector(self):
        from cagroup3d_tpu_torch.models.detectors.cagroup3d import CAGroup3D
        return CAGroup3D

    def eval_model(self, dev):
        """The full-width model users evaluate (phase 7b's checkpoint)."""
        return build_model(copy.deepcopy(self.cfg.MODEL), self.n_cls, dev,
                           seed=0)

    def launches_bad(self, launches, needed=None):
        """Whether a run's launch counts break the path's rule: each kernel
        of ``needed`` (all by default) launched (CAGroup3D), or none at all
        (RBGNet)."""
        if self.kernels:
            return min(launches[k] for k in needed or launches) <= 0
        return max(launches.values()) != 0

    def against_before(self, kind, name, f):
        """The first designs' times were taken on the ScanNet path."""
        return against_before(kind, name, f) if self.name == "scannet" \
            else {}


def phase_eval_kernels(model, dev, path):
    """Phases 3-5: the warm-up request, recording every K1 and K2 call,
    then each against its plain version.  Returns (K1 form stats, K1
    totals, K2 stats)."""
    import torch
    from cagroup3d_tpu_torch.core import sparse_conv as core_conv
    from cagroup3d_tpu_torch.core import voxelize as core_vox
    from cagroup3d_tpu_torch.core.hashing import INVALID_KEY, pack_coords
    from cagroup3d_tpu_torch.ops.segsum import (k2_plan, segment_sums,
                                                segment_sums_plain)
    from cagroup3d_tpu_torch.ops.sparse_conv import (sparse_conv,
                                                     sparse_conv_plain)
    from cagroup3d_tpu_torch.utils.synthetic import synthetic_request
    tag = {"config": path.name}
    k1_calls, k2_calls = [], []
    core_conv.sparse_conv = recorder(sparse_conv, k1_calls)
    core_vox.segment_sums = recorder(segment_sums, k2_calls)
    try:
        t0 = time.time()
        out = model.forward_eval(synthetic_request(0, dev, N_POINTS,
                                                   **path.scene),
                                 cur_epoch=10)
        torch.cuda.synchronize()
        warm_s = time.time() - t0
    finally:
        core_conv.sparse_conv = sparse_conv
        core_vox.segment_sums = segment_sums
    emit({"phase": "warm-up", **tag, "ok": True, "seconds": round(warm_s, 3),
          "k1_calls": len(k1_calls), "k2_calls": len(k2_calls),
          "overflow": int(out["overflow"].sum())})

    # 4. K1 against its plain version at every recorded call
    forms = replay(k1_calls, [k1_form(i, k1_calls)
                              for i in range(len(k1_calls))],
                   sparse_conv, sparse_conv_plain, k1_info,
                   library_conv_ms)
    for name, f in sorted(forms.items()):
        emit({"phase": "k1", **tag, "form": name, **f,
              **path.against_before("k1", name, f)})
    k1_ok = all(f["ok"] for f in forms.values())
    missing = [p for p in NEEDED if not any(n.startswith(p) for n in forms)]
    if missing or not k1_ok:
        fail("k1", f"K1 disagrees with its plain version, a source table "
                   f"is not key-sorted or a form is missing: "
                   f"missing={missing}")

    # 5. K2 against its plain version: the recorded (overflowing) call and
    # a non-overflowing one with the recorded call's groups and rows
    g = torch.Generator(device="cpu").manual_seed(0)
    G, P = k2_calls[0][0][0].shape
    F = 64
    lat = torch.randint(0, 15, (G, P, 3), generator=g, dtype=torch.int32)
    keys = pack_coords(lat, torch.rand(G, P, generator=g) < 0.9).to(dev)
    sk, _ = torch.sort(keys, dim=1, stable=True)
    fs = torch.randn(G, P, F, generator=g).to(dev).to(torch.bfloat16)
    cases = [("main_path", k2_calls[0][0]),
             ("no_overflow", (sk.contiguous(), fs.contiguous(), FINE_CAP))]
    k2_stats = dict(max_abs=0.0, ms=0.0, plain_ms=0.0)
    for name, args in cases:
        sk_, fs_, cap = args
        ns, nc = segment_sums(*args)
        rs, rc = segment_sums_plain(*args)
        ns2, nc2 = segment_sums(*args)
        same_bits = bool(torch.equal(ns, ns2) and torch.equal(nc, nc2))
        n_unique = int(((sk_[:, 1:] != sk_[:, :-1]) &
                        (sk_[:, 1:] != INVALID_KEY)).sum(1).max()) + 1
        counts_ok = bool((nc == rc).all())
        rel, row = rel_err(ns, rs), row_err(ns, rs)
        ok = counts_ok and rel < TOL and row < ROW_TOL and same_bits
        ms = time_ms(lambda: segment_sums(*args), 10)
        plain_ms = time_ms(lambda: segment_sums_plain(*args), 10)
        # bound: the rows the early stop needs (runs < cap), keys and bf16
        # features read once, f32 sums and i32 counts written once
        Gk, Pk, Fk = fs_.shape
        head = torch.ones_like(sk_, dtype=torch.bool)
        head[:, 1:] = sk_[:, 1:] != sk_[:, :-1]
        okk = sk_ != INVALID_KEY
        uid = torch.cumsum((head & okk).int(), 1) - 1
        need = okk & (uid < cap)
        rows = int(need.sum())
        b_ms, b_by = bound(rows * (4 + 2 * Fk) + Gk * cap * (4 * Fk + 4),
                           rows * Fk)
        # the library yardstick: one index_add_ of the rows into their
        # segments (ids precomputed), the sums without the counts
        seg = (torch.where(need, uid, torch.full_like(uid, cap)) +
               torch.arange(Gk, device=dev)[:, None] * (cap + 1)
               ).reshape(-1)
        rows_f = fs_.reshape(-1, Fk).float()
        lib_ms = time_ms(lambda: torch.zeros(
            Gk * (cap + 1), Fk, device=dev).index_add_(0, seg, rows_f), 10)
        emit({"phase": "k2", **tag, "case": name, "ok": ok,
              "G": sk_.shape[0], "P": sk_.shape[1], "F": fs_.shape[2],
              "cap": cap, "max_unique_per_group": n_unique,
              "overflows": n_unique > cap, "counts_exact": counts_ok,
              "max_rel": rel, "max_row": row, "same_bits": same_bits,
              "plan": k2_plan(*sk_.shape),
              "ms": ms,
              "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
              "rows_needed": rows, "library_ms": lib_ms})
        if not ok:
            fail("k2", f"K2 disagrees with its plain version ({name})")
        k2_stats["max_abs"] = max(k2_stats["max_abs"],
                                  float((ns - rs).abs().max()))
        if name == "main_path":
            k2_stats.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by, library_ms=lib_ms)
    return forms, total(forms), k2_stats


def phase_requests(model, dev, gpu, power, path):
    """Phase 6: launch counters reset, three 100k-point scenes through
    ``forward_eval``.  Returns the launch counts."""
    import torch
    from cagroup3d_tpu_torch.utils.synthetic import synthetic_request
    launch_counts(reset=True)
    lat_ms, outs = [], []
    for seed in (0, 1, 2):
        batch = synthetic_request(seed, dev, N_POINTS, **path.scene)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.forward_eval(batch, cur_epoch=10)
        torch.cuda.synchronize()
        lat_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    launches = launch_counts()
    R = model.roi_head.max_out
    for out in outs:
        if tuple(out["pred_boxes"].shape) != (1, R, 7) or \
                tuple(out["pred_scores"].shape) != (1, R):
            fail("requests", f"bad output shapes "
                             f"{ {k: tuple(v.shape) for k, v in out.items()} }")
        if not all(bool(torch.isfinite(v.float()).all()) for v in out.values()):
            fail("requests", "non-finite outputs")
    if path.launches_bad(launches, EVAL_KERNELS):
        fail("requests", f"a kernel was not launched on the main path: "
                         f"{launches}")
    valid = [o["pred_valid"][0] for o in outs]
    headings = [o["pred_boxes"][0, v, 6] for o, v in zip(outs, valid)]
    emit({"phase": "requests", "config": path.name, "ok": True, "gpu": gpu,
          "power_limit": power, "scenes": 3, "points_per_scene": N_POINTS,
          "ms_per_scene": lat_ms, "median_ms": sorted(lat_ms)[1],
          "launches": launches,
          "detections": [int(v.sum()) for v in valid],
          "headed_detections": [int((h != 0).sum()) for h in headings],
          "overflow": [int(o["overflow"].sum()) for o in outs]})
    if path.yaw and not any(int((h != 0).sum()) for h in headings):
        fail("requests", "the yaw path returned no headed box")
    return launches


def agree(got, ref, exact, box_like):
    """Card outputs against the CPU's: ``exact`` keys equal, the others'
    largest error within 1e-2 (``box_like``) or 1e-3."""
    res, ok = {}, True
    for k, r in ref.items():
        g = got[k].cpu()
        if k in exact:
            res[k] = bool((g == r).all())
            ok &= res[k]
        else:
            res[k] = float((g - r).abs().max())
            ok &= res[k] < (1e-2 if k in box_like else 1e-3)
    res["ok"] = ok
    return res


def reference_model(path, zero_votes=None, cos_code=None):
    """Phase 7's tiny model on the CPU: on the yaw path (by default) zero
    votes and a cos code of one (``phase_reference``)."""
    import torch
    tc, _, _ = tiny_config(path.cfg_path)
    m = build_model(tc, path.n_cls, "cpu", seed=1)
    with torch.no_grad():
        if path.yaw if zero_votes is None else zero_votes:
            m.get_parameter("dense_head.offset_block.6.kernel").zero_()
        if path.yaw if cos_code is None else cos_code:
            m.get_parameter("roi_head.reg_pred_layer.bias")[6] = 1.0
    return m


def phase_reference(dev, path, seed=3):
    """Phase 7: a tiny model on the card against the same model on the
    CPU, stage by stage on the same inputs, then the whole forward.

    The untrained tiny model is ill-conditioned for a comparison of its
    discrete steps: its candidate scores lie within an ulp of each other,
    so one ulp of a sigmoid picks other proposals; its votes and rotated
    RoI grid points floor into lattice cells, so one ulp moves a boundary
    point into another cell; its RoI head's (cos, sin) heading codes are
    round-off about zero, whose ``atan2`` is any angle.  So the yaw path
    runs with zero votes, as in 10, and a cos code of one; the proposal
    stage gets the CPU's head outputs with seeded N(0, 1) class and
    centerness logits; the RoI stage counts the grid points that the
    devices floor into different cells, holds the rois they do not
    touch, and its final boxes when they touch none.  The whole forward
    is held on ScanNet and printed on the yaw path (ROADMAP.md
    section 3)."""
    import torch
    from cagroup3d_tpu_torch.core.module import flat_state
    from cagroup3d_tpu_torch.utils.synthetic import synthetic_request
    cpu_model = reference_model(path)
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    req = synthetic_request(seed, "cpu", **dict(TINY_SCENE, **path.scene))
    keys = ("boxes", "scores", "labels", "valid")
    run, stages, props, roi, cells = {}, {}, {}, {}, {}
    with torch.no_grad():
        for name, m, d in (("cpu", cpu_model, "cpu"), ("gpu", gpu_model, dev)):
            P, S = flat_state(m)
            ctx, _, _, _, feat, head, _ = m._forward_scene(
                P, S, req["points"][0].to(d), req["points_valid"][0].to(d),
                m.semantic_threshold(10))
            run[name] = (m, d, P, S, ctx, feat, head)
        head = run["cpu"][6]
        stages["head"] = agree(run["gpu"][6], head,
                               ("points", "points_valid", "semantic_points",
                                "semantic_valid"),
                               ("bbox_preds", "voxel_offsets"))
        g = torch.Generator().manual_seed(0)
        head = dict(head, **{k: torch.randn(head[k].shape, generator=g)
                             for k in ("cls_scores", "centernesses")})
        for name, (m, d, *_) in run.items():
            props[name] = dict(zip(keys, m.dense_head.get_bboxes(
                {k: v.to(d) for k, v in head.items()})))
        stages["proposals"] = agree(props["gpu"], props["cpu"],
                                    ("labels", "valid"), ("boxes",))
        for name, (m, d, P, S, ctx, feat, _) in run.items():
            rois = [props["cpu"][k].to(d) for k in keys]
            roi[name] = m.roi_head(P, S, ctx, feat, *rois)
            cells[name] = m.roi_head.grid_lattice(
                m.roi_head.pcdet_rois(rois[0])).cpu()
    apart = (cells["gpu"] != cells["cpu"]).any(-1).reshape(
        len(props["cpu"]["valid"]), -1)
    keep = props["cpu"]["valid"] & ~apart.any(1)
    reg = roi.pop("gpu"), roi.pop("cpu")
    final = agree({k: v for k, v in reg[0].items() if k != "rcnn_reg"},
                  {k: v for k, v in reg[1].items() if k != "rcnn_reg"},
                  ("batch_pred_valid", "batch_cls_preds"),
                  ("batch_box_preds",))
    stages["roi"] = dict(
        grid_points_apart=int(apart.sum()), rois_touched=int(
            apart.any(1).sum()), rois_compared=int(keep.sum()),
        rcnn_reg_rel=rel_err(reg[0]["rcnn_reg"].cpu()[keep],
                             reg[1]["rcnn_reg"][keep]), final=final)
    stages["roi"]["ok"] = (stages["roi"]["rcnn_reg_rel"] < TOL and
                           int(keep.sum()) > 0 and
                           (final["ok"] or bool(apart.any())))
    ref = cpu_model.forward_eval(req, cur_epoch=10)
    got = gpu_model.forward_eval({k: v.to(dev) for k, v in req.items()},
                                 cur_epoch=10)
    pred = ("pred_valid", "pred_labels", "pred_boxes", "pred_scores")
    whole = agree({k: got[k] for k in pred}, {k: ref[k] for k in pred},
                  pred[:2], pred[2:3])
    ok = all(st["ok"] for st in stages.values()) and (
        whole["ok"] or path.yaw)
    emit({"phase": "reference", "config": path.name, "ok": ok,
          "detections": int(ref["pred_valid"].sum()), "whole_forward": whole,
          "whole_forward_held": not path.yaw, "stages": stages})
    if not ok or int(ref["pred_valid"].sum()) == 0:
        fail("reference", "card and CPU disagree on the tiny model")


class Recording:
    """A CLI's loader, keeping each batch it yields and the seconds its
    consumer waited for each (``waits``)."""

    def __init__(self, loader):
        self.loader, self.batches, self.waits = loader, [], []

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            try:
                b = next(it)
            except StopIteration:
                return
            self.waits.append(time.perf_counter() - t0)
            self.batches.append(b)
            yield b


def phase_test_cli(dev, gpu, power, path):
    """Phase 7b: the ``test`` CLI (``cagroup3d_tpu_torch.tools.test``) in
    this process on a synthetic tree of ``path.cli_scenes`` 100k-point scenes
    (``write_indoor_tree``: ScanNet points in a raw frame with a z rotation
    and translation as each scene's axis-align matrix, SUN RGB-D headed
    boxes), evaluating a checkpoint of the YAML's full-width model as
    users build it (seeded, gate open and class prior lifted as in
    ``build_model``), at batch 1.  Held: result.pkl has every scene;
    ``forward_eval``'s recorded inputs equal the loader's batches bitwise,
    on the card, and each scene's boxes, scores and labels in result.pkl
    equal that call's outputs unpadded by ``pred_valid`` bitwise; every
    loaded GT box holds the points the writer counted in it in the
    aligned frame; the GT as predictions scores mAP and mAR 1.0 at both
    thresholds, and 0.0 with every box moved along x past its BEV diagonal
    (plus 10 m); the model's mAP and mAR finite in [0, 1] for every class
    of the tree; K1 and K2 launched; two direct ``forward_eval`` calls on
    one batch give the same bits (CAGroup3D: every float sum of its eval
    forward has a fixed order; ``profile_port.py``'s ``bits`` phase finds
    the first op apart; printed only for RBGNet)."""
    import pickle
    import tempfile
    import numpy as np
    import torch
    from cagroup3d_tpu_torch.tools import test as cli
    from cagroup3d_tpu_torch.training.checkpoint import save_checkpoint
    from cagroup3d_tpu_torch.utils.synthetic import (points_in_boxes,
                                                     write_indoor_tree)
    names = list(path.cfg.CLASS_NAMES)
    calls, loaders, harness_s = [], [], []
    Detector = path.detector()
    forward, build_loader, evaluate = (Detector.forward_eval,
                                       cli.build_dataloader,
                                       cli.eval_one_epoch)

    def recorded(self, batch, cur_epoch=None):
        t0 = time.perf_counter()
        out = forward(self, batch, cur_epoch=cur_epoch)
        torch.cuda.synchronize()
        calls.append((self, dict(batch), dict(out),
                      (time.perf_counter() - t0) * 1e3))
        return out

    def recording_loader(**kw):
        ds, loader, sampler = build_loader(**kw)
        loaders.append((ds, Recording(loader)))
        return ds, loaders[-1][1], sampler

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = evaluate(*a, **kw)
        harness_s.append(time.perf_counter() - t0)
        return out

    cwd, t_phase = os.getcwd(), time.time()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_test_cli_") as tmp:
        tree = os.path.join(tmp, path.name)
        counts = write_indoor_tree(tree, path.dataset, names, path.cli_scenes,
                                   n_points=N_POINTS, seed=0)
        ckpt = os.path.join(tmp, "checkpoint_epoch_10.pkl")
        save_checkpoint(ckpt, path.eval_model(dev))
        torch.cuda.empty_cache()
        args, cfg = cli.parse_config(["--cfg_file", path.cfg_path, "--ckpt",
                                      ckpt, "--set", "DATA_CONFIG.DATA_PATH",
                                      tree])
        Detector.forward_eval = recorded
        cli.build_dataloader, cli.eval_one_epoch = recording_loader, timed
        launch_counts(reset=True)
        try:
            os.chdir(tmp)
            ret = cli.main(args, cfg)[ckpt]
        finally:
            os.chdir(cwd)
            Detector.forward_eval = forward
            cli.build_dataloader, cli.eval_one_epoch = build_loader, evaluate
        launches = launch_counts()
        eval_dir = os.path.join(tmp, "output", cfg.EXP_GROUP_PATH, cfg.TAG,
                                args.extra_tag, "eval")
        with open(os.path.join(eval_dir, "result.pkl"), "rb") as f:
            det = pickle.load(f)
    dataset, loader = loaders[0]
    batches, bad = loader.batches, []
    if not len(det) == len(calls) == len(batches) == path.cli_scenes:
        bad.append(f"{len(det)} scenes in result.pkl, {len(calls)} calls, "
                   f"{len(batches)} batches")
    on_card = all(next(m.parameters()).is_cuda and inp["points"].is_cuda and
                  inp["points_valid"].is_cuda for m, inp, _, _ in calls)
    inputs_equal = outputs_equal = True
    frame_boxes, frame_ok, det_n = 0, True, []
    for (m, inp, out, _), b, d in zip(calls, batches, det):
        inputs_equal &= all(torch.equal(inp[k].cpu(), torch.from_numpy(b[k]))
                            for k in ("points", "points_valid"))
        v = out["pred_valid"][0].cpu().numpy()
        mine = dict(boxes_3d=out["pred_boxes"][0].cpu().numpy()[v],
                    scores_3d=out["pred_scores"][0].cpu().numpy()[v],
                    labels_3d=out["pred_labels"][0].cpu().numpy()[v].astype(
                        np.int64))
        outputs_equal &= d["frame_id"] == b["frame_id"][0] and all(
            d[k].dtype == x.dtype and np.array_equal(d[k], x)
            for k, x in mine.items())
        det_n.append(int(v.sum()))
        pts = b["points"][0][b["points_valid"][0]]
        gt = b["gt_boxes"][0][b["gt_valid"][0]]
        n_in = points_in_boxes(pts[:, :3], gt[:, :7]).sum(0)
        frame_ok &= np.array_equal(n_in, counts[b["frame_id"][0]])
        frame_boxes += len(gt)
    if not on_card:
        bad.append("the model or its inputs were not on the card")
    if not inputs_equal:
        bad.append("forward_eval's inputs differ from the loader's batches")
    if not outputs_equal:
        bad.append("result.pkl differs from forward_eval's outputs")
    if not frame_ok or frame_boxes == 0:
        bad.append("the points inside the loaded GT boxes differ from the "
                   "writer's counts (frame)")

    def oracle(shift):
        preds, fids = [], []
        for b in batches:
            gt = b["gt_boxes"][0][b["gt_valid"][0]].copy()
            gt[:, 0] += shift * (np.hypot(gt[:, 3], gt[:, 4]) + 10.0)
            preds.append(dict(pred_boxes=gt[:, :7],
                              pred_scores=np.ones(len(gt), np.float32),
                              pred_labels=gt[:, 7].astype(np.int64)))
            fids.append(b["frame_id"][0])
        annos = dataset.generate_prediction_dicts({"frame_id": fids}, preds,
                                                  names)
        r, _ = dataset.evaluation(annos, names)
        return {k: r[k] for k in ("mAP_0.25", "mAP_0.50", "mAR_0.25",
                                  "mAR_0.50")}

    hit, miss = oracle(0.0), oracle(1.0)
    if set(hit.values()) != {1.0}:
        bad.append(f"the GT as predictions does not score 1.0: {hit}")
    if miss["mAP_0.25"] != 0.0 or miss["mAP_0.50"] != 0.0:
        bad.append(f"the shifted GT does not score 0.0: {miss}")
    present = sorted({names[int(c)] for info in dataset.infos
                      for c in info["annos"]["class"]})
    keys = [f"{n}_{m}_{t}" for n in present for m in ("AP", "rec")
            for t in ("0.25", "0.50")] + \
        [f"{m}_{t}" for m in ("mAP", "mAR") for t in ("0.25", "0.50")]
    if not all(k in ret and np.isfinite(ret[k]) and 0.0 <= ret[k] <= 1.0
               for k in keys):
        bad.append("the model's mAP/mAR is missing, not finite or out of "
                   "[0, 1] for a class of the tree")
    if path.launches_bad(launches, EVAL_KERNELS):
        bad.append(f"kernel launches break the path's rule: {launches}")
    with torch.inference_mode():
        two = [calls[0][0].forward_eval(calls[0][1], cur_epoch=10)
               for _ in range(2)]
    two_same = all(torch.equal(two[0][k], two[1][k]) for k in two[0])
    if path.kernels and not two_same:
        bad.append("two direct forward_eval calls on one batch give "
                   "different bits (profile_port.py's bits phase names the "
                   "first op apart)")
    ms = harness_s[0] * 1e3 / path.cli_scenes
    phase = "test-cli" if path.kernels else "rbgnet-test-cli"
    emit({"phase": phase, "config": path.name, "ok": not bad,
          "gpu": gpu, "power_limit": power, "scenes": len(det),
          "points_per_scene": N_POINTS, "batch_size": 1,
          "ms_per_scene": ms,
          "loader_share": sum(loader.waits) / harness_s[0],
          "forward_ms": [c[3] for c in calls],
          "forward_median_ms": float(np.median([c[3] for c in calls])),
          "launches": launches,
          "detections": det_n, "gt_boxes_checked": frame_boxes,
          "classes": len(present),
          **{k: ret[k] for k in ("mAP_0.25", "mAP_0.50", "mAR_0.25",
                                 "mAR_0.50")},
          "oracle": hit, "oracle_shifted": miss,
          "two_calls_same_bits": two_same,
          "seconds": time.time() - t_phase})
    if bad:
        fail(phase, "; ".join(bad))
    return launches


class TrainCliRecording:
    """The ``train`` CLI's synchronized steps (ms, loss, tb), loaders
    (``Recording``) and built models, recorded between ``start()`` and
    ``stop()``."""

    def __init__(self):
        self.steps, self.loaders, self.models = [], [], []
        self.saved = None

    def start(self):
        import torch
        from cagroup3d_tpu_torch.tools import train as cli
        from cagroup3d_tpu_torch.training import train_loop
        self.saved = (train_loop.make_train_step, cli.build_dataloader,
                      cli.build_network)
        make_step, build_loader, build_net = self.saved

        def recorded_step(*a, **kw):
            step = make_step(*a, **kw)

            def timed(batch, cur_epoch=0.0):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss, tb = step(batch, cur_epoch)
                torch.cuda.synchronize()
                self.steps.append(dict(
                    ms=(time.perf_counter() - t0) * 1e3, loss=float(loss),
                    tb={k: float(v) for k, v in tb.items()}))
                return loss, tb
            return timed

        def recording_loader(**kw):
            ds, loader, sampler = build_loader(**kw)
            self.loaders.append(Recording(loader))
            return ds, self.loaders[-1], sampler

        def recording_net(*a, **kw):
            self.models.append(build_net(*a, **kw))
            return self.models[-1]

        train_loop.make_train_step = recorded_step
        cli.build_dataloader, cli.build_network = (recording_loader,
                                                   recording_net)

    def stop(self):
        """Put the CLI's functions back (a no-op unless started)."""
        from cagroup3d_tpu_torch.tools import train as cli
        from cagroup3d_tpu_torch.training import train_loop
        if self.saved is not None:
            (train_loop.make_train_step, cli.build_dataloader,
             cli.build_network), self.saved = self.saved, None


def run_train_cli(tmp, cfg_path, data, train_args=()):
    """The ``train`` CLI in this process from the directory ``tmp`` with
    the overrides ``data`` (``--set ...``) and ``train_args`` (its own
    flags): ``--epochs 1``, then
    ``--epochs 2``, which resumes, then the ``test`` CLI on
    ``checkpoint_epoch_2.pkl``.  Returns the recording (``rec``), the
    last model the CLI built, both checkpoints, the training logs and
    metrics.jsonl's lines, the launches of the training calls and of the
    evaluation, the training calls' peak GB and the evaluation's
    metrics."""
    import glob
    import pickle
    import torch
    from cagroup3d_tpu_torch.tools import test as test_cli
    from cagroup3d_tpu_torch.tools import train as cli
    cwd = os.getcwd()
    torch.cuda.empty_cache()
    launch_counts(reset=True)
    torch.cuda.reset_peak_memory_stats()
    rec = TrainCliRecording()
    try:
        os.chdir(tmp)
        rec.start()
        for epochs in (1, 2):
            args, cfg = cli.parse_config(["--cfg_file", cfg_path, "--epochs",
                                          str(epochs), *train_args, *data])
            out = cli.main(args, cfg)
        train_launches = launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        ckpt = str(out / "ckpt" / "checkpoint_epoch_2.pkl")
        model = rec.models[-1]
        rec.models.clear()
        torch.cuda.empty_cache()
        launch_counts(reset=True)
        targs, tcfg = test_cli.parse_config(
            ["--cfg_file", cfg_path, "--ckpt", ckpt, *data])
        ret = test_cli.main(targs, tcfg)[ckpt]
        eval_launches = launch_counts()
    finally:
        os.chdir(cwd)
        rec.stop()
    out = os.path.join(tmp, out)
    ckpts = {}
    for e in (1, 2):
        with open(os.path.join(out, "ckpt", f"checkpoint_epoch_{e}.pkl"),
                  "rb") as f:
            ckpts[e] = pickle.load(f)
    logs = ""
    for log in sorted(glob.glob(os.path.join(out, "log_train_*.txt"))):
        with open(log) as f:
            logs += f.read()
    with open(os.path.join(out, "metrics.jsonl")) as f:
        metrics = [json.loads(ln) for ln in f]
    return dict(rec=rec, model=model, ckpts=ckpts, logs=logs,
                metrics=metrics, train_launches=train_launches,
                eval_launches=eval_launches, peak_gb=peak_gb, ret=ret)


def phase_train_cli(dev, gpu, power, path):
    """Phase 7c: the ``train`` CLI (``cagroup3d_tpu_torch.tools.train``) in
    this process on a synthetic tree of one batch of 100k-point scenes
    (``write_indoor_tree``) with REPEAT.train 1, at the YAML's full width
    and its batch up to CLI_TRAIN_BATCH, with its model as users build it
    (seeded, nothing opened or lifted): ``--epochs 1`` (one step of
    CLI_TRAIN_BATCH scenes; phase 9 trains at the YAML's), then ``--epochs
    2``, which must auto-resume from
    ``checkpoint_epoch_1.pkl``; then the ``test`` CLI evaluates
    ``checkpoint_epoch_2.pkl`` over the same tree (its mAP printed, not
    held: the model is untrained).  Held: every step's loss and tb and
    every loss in metrics.jsonl finite; the second call's log says it
    resumed from epoch 1; the checkpoints' ``epoch`` and ``it`` (1 and 2
    epochs of steps); the checkpoint's keys equal the model's parameters
    and buffers; the model on the card; K1 and K3 launched during the
    CLI's steps and K2 during its eval.  Printed: ms per step (the wait
    for the loader plus the synchronized step), the loader's share of it
    and the peak GB of the training calls."""
    import tempfile
    import numpy as np
    from cagroup3d_tpu_torch.utils.synthetic import write_indoor_tree
    names = list(path.cfg.CLASS_NAMES)
    B = n_scenes = min(CLI_TRAIN_BATCH,
                       int(path.cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU))
    steps_per_epoch = 1
    t_phase, bad = time.time(), []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_cli_") as tmp:
        tree = os.path.join(tmp, path.name)
        write_indoor_tree(tree, path.name, names, n_scenes,
                          n_points=N_POINTS, seed=1)
        run = run_train_cli(tmp, path.cfg_path,
                            ["--set", "DATA_CONFIG.DATA_PATH", tree,
                             "DATA_CONFIG.REPEAT.train", "1"],
                            train_args=("--batch_size", str(B)))
    rec, model, ckpts, logs, logged = (run[k] for k in (
        "rec", "model", "ckpts", "logs", "metrics"))
    train_launches, eval_launches, ret = (run[k] for k in (
        "train_launches", "eval_launches", "ret"))
    finite = all(np.isfinite([s["loss"], *s["tb"].values()]).all()
                 for s in rec.steps) and all(
        np.isfinite(v) for ln in logged for k, v in ln.items()
        if k.startswith("train/loss"))
    if not finite or not rec.steps or not logged:
        bad.append("a step's or a logged loss is not finite, or none was "
                   "logged")
    if len(rec.steps) != 2 * steps_per_epoch:
        bad.append(f"{len(rec.steps)} steps, not {2 * steps_per_epoch}")
    its = {e: (c["epoch"], c["it"]) for e, c in ckpts.items()}
    if its != {1: (1, steps_per_epoch), 2: (2, 2 * steps_per_epoch)}:
        bad.append(f"checkpoint (epoch, it): {its}")
    resumed = re.search(r"auto-resuming from \S*checkpoint_epoch_1\.pkl "
                        r"\(epoch 1\)", logs) is not None
    if not resumed:
        bad.append("the second call did not log its resume from epoch 1")
    keys_ok = (set(ckpts[2]["params"]) ==
               {k for k, _ in model.named_parameters()} and
               set(ckpts[2]["state"]) == {k for k, _ in model.named_buffers()})
    if not keys_ok:
        bad.append("the checkpoint's keys differ from the model's parameters "
                   "and buffers")
    if not next(model.parameters()).is_cuda:
        bad.append("the model was not on the card")
    if min(train_launches["sparse_conv"], train_launches["sparse_conv_dw"],
           eval_launches["segsum"]) <= 0:
        bad.append(f"a kernel was not launched: train {train_launches}, "
                   f"eval {eval_launches}")
    waits = [w * 1e3 for ld in rec.loaders for w in ld.waits]
    ms = [w + s["ms"] for w, s in zip(waits, rec.steps)]
    emit({"phase": "train-cli", "config": path.name, "ok": not bad,
          "gpu": gpu, "power_limit": power, "scenes": n_scenes,
          "points_per_scene": N_POINTS, "batch_size": B,
          "steps_per_epoch": steps_per_epoch, "ms_per_step": ms,
          "median_ms": float(np.median(ms)) if ms else None,
          "loader_share": sum(waits) / sum(ms) if ms else None,
          "peak_memory_gb": run["peak_gb"],
          "losses": [s["loss"] for s in rec.steps],
          "tb": rec.steps[-1]["tb"] if rec.steps else None,
          "checkpoints": its, "resumed": resumed,
          "train_launches": train_launches, "eval_launches": eval_launches,
          **{k: ret[k] for k in ("mAP_0.25", "mAP_0.50", "mAR_0.25",
                                 "mAR_0.50")},
          "seconds": time.time() - t_phase})
    if bad:
        fail("train-cli", "; ".join(bad))
    return train_launches, eval_launches


DEMO_SEEDS = (40, 41)       # the demo phase's two scenes


def phase_demo(model, mc, dev, gpu, power, path):
    """Phase 7d (``demo``, after 7b; ScanNet): the ``demo`` CLI
    (``cagroup3d_tpu_torch.tools.demo``) in this process on two 100k-point
    scenes, one a ``.bin`` in a directory, one an ``.npy`` file (two
    runs), evaluating a checkpoint of ``model`` (the YAML's full-width
    CAGroup3D at ``mc``, gate open and class prior lifted as phase 6
    builds it).  Held: each ``--out_file`` holds the boxes, scores and
    labels of ``model.forward_eval`` at epoch 1000 on the same
    ``DemoDataset`` batches, bit for bit; K1 and K2 launched in the demo
    runs (``launch_counts``); the ``.bin`` scenes read through the C++
    library of ``datasets/native_io`` (the phase fails on its numpy
    fallback); ``--render_dir`` fails naming matplotlib before the first
    scene where matplotlib is missing (launching nothing), or else writes
    a PNG a scene.  Prints the demo's ms a scene (its whole call, model
    build and checkpoint load included, over its scenes), the ms of its
    ``forward_eval`` calls and those of direct warm calls on the same
    batches."""
    import pickle
    import tempfile
    import numpy as np
    import torch
    from cagroup3d_tpu_torch.datasets import native_io
    from cagroup3d_tpu_torch.tools import demo
    from cagroup3d_tpu_torch.training.checkpoint import save_checkpoint
    from cagroup3d_tpu_torch.utils.synthetic import synthetic_request
    t_phase, bad, out = time.time(), [], {}
    built, fwd_ms = [], []

    def build_network(*a, **kw):            # the demo's model, its forwards
        m = real_build(*a, **kw)            # timed
        inner = m.forward_eval

        def timed(batch, cur_epoch=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = inner(batch, cur_epoch=cur_epoch)
            torch.cuda.synchronize()
            fwd_ms.append((time.perf_counter() - t0) * 1e3)
            return res
        m.forward_eval = timed
        built.append(m)
        return m

    real_build = demo.build_network
    with tempfile.TemporaryDirectory(prefix="chip_smoke_demo_") as tmp:
        ckpt = os.path.join(tmp, "demo.pkl")
        save_checkpoint(ckpt, model)
        os.makedirs(os.path.join(tmp, "bins"))
        for seed, name in zip(DEMO_SEEDS, ("bins/scene_a.bin",
                                           "scene_b.npy")):
            req = synthetic_request(seed, "cpu", N_POINTS, **path.scene)
            pts = req["points"][0][req["points_valid"][0]].numpy()
            if name.endswith(".bin"):
                pts.tofile(os.path.join(tmp, name))
            else:
                np.save(os.path.join(tmp, name), pts)
        runs = (("bin", os.path.join(tmp, "bins"), ".bin"),
                ("npy", os.path.join(tmp, "scene_b.npy"), ".npy"))
        demo.build_network = build_network
        launch_counts(reset=True)
        try:
            for tag, data, ext in runs:
                args, cfg = demo.parse_config([
                    "--cfg_file", path.cfg_path, "--data_path", data,
                    "--ext", ext, "--ckpt", ckpt, "--out_file",
                    os.path.join(tmp, tag + ".pkl")])
                cfg.MODEL = copy.deepcopy(mc)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                demo.main(args, cfg)
                torch.cuda.synchronize()
                out[tag] = dict(seconds=time.perf_counter() - t0)
            launches = launch_counts()
            args, cfg = demo.parse_config([
                "--cfg_file", path.cfg_path, "--data_path", runs[0][1],
                "--ckpt", ckpt, "--render_dir", os.path.join(tmp, "png")])
            cfg.MODEL = copy.deepcopy(mc)
            try:
                demo.main(args, cfg)
                render = dict(raised=None, pngs=len(os.listdir(
                    os.path.join(tmp, "png"))))
                if render["pngs"] != 1:
                    bad.append(f"--render_dir wrote {render['pngs']} PNGs")
            except RuntimeError as e:
                render = dict(raised=str(e))
                if "matplotlib" not in str(e) or \
                        launch_counts() != launches or \
                        len(built) != len(runs):
                    bad.append(f"--render_dir failed otherwise: {e}")
        finally:
            demo.build_network = real_build
        direct_ms = []
        for tag, data, ext in runs:
            ds = demo.DemoDataset(data, ext)
            with open(os.path.join(tmp, tag + ".pkl"), "rb") as f:
                dumped = pickle.load(f)
            same = len(dumped) == len(ds) == 1
            for i in range(len(ds)):
                b = {k: torch.from_numpy(v).to(dev)
                     for k, v in ds.batch(i).items()}
                with torch.inference_mode():
                    model.forward_eval(b, cur_epoch=1000.0)     # warm
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    o = model.forward_eval(b, cur_epoch=1000.0)
                    torch.cuda.synchronize()
                direct_ms.append((time.perf_counter() - t0) * 1e3)
                v = o["pred_valid"][0].cpu().numpy()
                want = dict(boxes=o["pred_boxes"][0].cpu().numpy()[v],
                            scores=o["pred_scores"][0].cpu().numpy()[v],
                            labels=o["pred_labels"][0].cpu().numpy()[v])
                same = same and dumped[i]["file"] == ds.files[i] and all(
                    dumped[i][k].dtype == w.dtype and
                    dumped[i][k].tobytes() == w.tobytes()
                    for k, w in want.items())
                out[tag].update(detections=int(v.sum()),
                                io_path=ds.io_path)
            out[tag]["same_bits"] = same
            if not same:
                bad.append(f"{tag}: --out_file is not forward_eval's "
                           f"outputs bit for bit")
    if out["bin"]["io_path"] != "native" or native_io.io_path() != "native":
        bad.append(f"the .bin scenes were read on the numpy path "
                   f"({native_io.fallback_reason()})")
    if min(launches["sparse_conv"], launches["segsum"]) <= 0:
        bad.append(f"K1 or K2 was not launched by the demo: {launches}")
    if sum(o["detections"] for o in out.values()) == 0:
        bad.append("the demo detected nothing")
    ms = [o["seconds"] * 1e3 for o in out.values()]
    emit({"phase": "demo", "config": path.name, "ok": not bad, "gpu": gpu,
          "power_limit": power, "runs": out, "launches": launches,
          "render": render, "demo_ms_per_scene": ms,
          "demo_forward_ms": fwd_ms, "direct_forward_ms": direct_ms,
          "seconds": time.time() - t_phase})
    if bad:
        fail("demo", "; ".join(bad))
    return launches


def run_path(dev, gpu, power, path):
    """Phases 3-10 (with 7b and 7c) on one configuration at full width
    (phase 11 runs at the end, ``LearnJobs``).  Returns what the
    ``kernels`` line needs."""
    import torch
    from cagroup3d_tpu_torch.models.model_utils.cagroup_utils import \
        bias_init_with_prob
    mc = copy.deepcopy(path.cfg.MODEL)
    mc.INPUT_CAP = INPUT_CAP
    mc.DENSE_HEAD.FINE_CAP = FINE_CAP
    model = build_model(mc, path.n_cls, dev, seed=0)
    forms, k1_eval, k2_stats = phase_eval_kernels(model, dev, path)
    eval_launches = phase_requests(model, dev, gpu, power, path)
    phase_reference(dev, path)
    phase_test_cli(dev, gpu, power, path)
    demo_launches = phase_demo(model, mc, dev, gpu, power, path) \
        if path.name == "scannet" else None
    cli_train, cli_eval = phase_train_cli(dev, gpu, power, path)

    # 8-11. the training step
    model.roi_gt_aug = 0.05        # see tiny_train_config
    with torch.no_grad():           # the prior back (see build_model)
        model.dense_head.cls_conv.bias.fill_(bias_init_with_prob(0.01))
    open_gate(model, train=True)
    k1_train, k3_train = phase_k3(model, dev, NEEDED, path)
    train_launches = phase_train(model, dev, gpu, power, path)
    del model
    torch.cuda.empty_cache()
    phase_train_reference(dev, path)
    return dict(k1_eval=k1_eval, k1_eval_max_abs=max(
        f["max_abs"] for f in forms.values()), k2=k2_stats,
        eval_launches=eval_launches, k1_train=k1_train, k3_train=k3_train,
        train_launches=train_launches, cli_train=cli_train, cli_eval=cli_eval,
        demo_launches=demo_launches)


# ---------------------------------------------------------------------------
# RBGNet (the PointNet2-FBS backbone and the ray-based-grouping head)
# ---------------------------------------------------------------------------

class RbgPath(Path):
    """One RBGNet configuration (tools/cfgs/<dataset>_models/RBGNet.yaml):
    its main path launches none of the kernels."""
    kernels = False

    def __init__(self, dataset, jax_learn_drop):
        super().__init__(f"rbgnet_{dataset}", RBG_TRAIN_STEPS,
                         jax_learn_drop, cfg_path=RBG_CFGS[dataset],
                         dataset=dataset)

    def _yaw(self):
        return bool(self.cfg.MODEL.POINT_HEAD.BOX_CODER.WITH_ROT)

    def detector(self):
        from cagroup3d_tpu_torch.models.detectors.rbgnet import RBGNet
        return RBGNet

    def eval_model(self, dev):
        return rbg_model(self.cfg.MODEL, self.n_cls, dev, seed=0)

    def against_before(self, kind, name, f):
        return {}


def rbg_model(mc, n_cls, device, seed):
    """A seeded RBGNet of the configuration ``mc`` (copied) through
    ``build_network``."""
    import torch
    from cagroup3d_tpu_torch.models import build_network
    return build_network(copy.deepcopy(mc), n_cls,
                         generator=torch.Generator().manual_seed(seed),
                         device=device)


def launch_counts(reset=False):
    """The kernels' launch counters (set to 0 first with ``reset``)."""
    from cagroup3d_tpu_torch.ops.segsum import segment_sums
    from cagroup3d_tpu_torch.ops.sparse_conv import sparse_conv, sparse_conv_dw
    fns = {"sparse_conv": sparse_conv, "sparse_conv_dw": sparse_conv_dw,
           "segsum": segment_sums}
    if reset:
        for f in fns.values():
            f.launches = 0
    return {k: f.launches for k, f in fns.items()}


def rbg_stage_split(model, batch):
    """One synchronized ``forward_eval``, ms per stage: the backbone (and
    its FPS), the vote module with the aggregation and the predictions
    (the head less the ray grouping), the ray grouping (and its FPS),
    boxes with NMS."""
    import torch
    from cagroup3d_tpu_torch.core import pointnet2 as pn2
    from cagroup3d_tpu_torch.models.dense_heads.rbg_head import \
        RayBasedGrouping
    ms, where = {}, ["other"]

    def timed(name, fn, fps=False):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if not fps:
                outer, where[0] = where[0], name
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                key = f"{where[0]}_fps" if fps else name
                ms[key] = ms.get(key, 0.0) + (time.perf_counter() - t0) * 1e3
                if not fps:
                    where[0] = outer
        return run

    head, bb = model.point_head, model.backbone_3d
    fps, rbg_call = pn2.farthest_point_sample, RayBasedGrouping.__call__
    pn2.farthest_point_sample = timed("fps", fps, fps=True)
    RayBasedGrouping.__call__ = timed("ray_grouping", rbg_call)
    bb.forward = timed("backbone", bb.forward)
    head.forward = timed("head", head.forward)
    head.generate_predicted_boxes = timed("boxes_nms",
                                          head.generate_predicted_boxes)
    try:
        timed("total", model.forward_eval)(batch)
    finally:
        pn2.farthest_point_sample, RayBasedGrouping.__call__ = fps, rbg_call
        for m, name in ((bb, "forward"), (head, "forward"),
                        (head, "generate_predicted_boxes")):
            del m.__dict__[name]
    ms["vote_aggregation_predictions"] = ms.pop("head") - ms["ray_grouping"]
    ms["fps_total"] = sum(v for k, v in ms.items() if k.endswith("_fps"))
    ms["fps_share"] = ms["fps_total"] / ms["total"]
    return ms


def phase_rbg_requests(model, dev, gpu, power, path):
    """rbgnet-requests: a warm-up and three 100k-point scenes through
    ``forward_eval`` at batch 1, launch counters reset; outputs finite of
    the expected shapes, headed boxes on SUN RGB-D, no kernel launched;
    then one synchronized stage split.  Returns the launch counts."""
    import torch
    from cagroup3d_tpu_torch.utils.synthetic import synthetic_request
    reqs = [synthetic_request(seed, dev, N_POINTS, **path.scene)
            for seed in (3, 0, 1, 2)]
    t0 = time.time()
    model.forward_eval(reqs[0])
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    launch_counts(reset=True)
    lat_ms, outs = [], []
    for batch in reqs[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(model.forward_eval(batch))
        torch.cuda.synchronize()
        lat_ms.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts()
    head = model.point_head
    M, bad = min(model.max_out, head.num_classes * head.num_proposal), []
    for out in outs:
        shapes = {k: tuple(v.shape) for k, v in out.items()}
        if shapes != {"pred_boxes": (1, M, 7), "pred_scores": (1, M),
                      "pred_labels": (1, M), "pred_valid": (1, M)}:
            bad.append(f"bad output shapes {shapes}")
        if not all(bool(torch.isfinite(v.float()).all())
                   for v in out.values()):
            bad.append("non-finite outputs")
    valid = [o["pred_valid"][0] for o in outs]
    headed = [int((o["pred_boxes"][0, v, 6] != 0).sum())
              for o, v in zip(outs, valid)]
    if path.yaw and not any(headed):
        bad.append("the SUN RGB-D configuration returned no headed box")
    if path.launches_bad(launches):
        bad.append(f"a kernel was launched on RBGNet's path: {launches}")
    split = rbg_stage_split(model, reqs[1])
    emit({"phase": "rbgnet-requests", "config": path.name, "ok": not bad,
          "gpu": gpu, "power_limit": power, "scenes": 3,
          "points_per_scene": N_POINTS, "warm_up_seconds": warm_s,
          "ms_per_scene": lat_ms, "median_ms": sorted(lat_ms)[1],
          "launches": launches, "detections": [int(v.sum()) for v in valid],
          "headed_detections": headed, "stage_ms": split})
    if bad:
        fail("rbgnet-requests", "; ".join(bad))
    return launches


def phase_rbg_train_cli(dev, gpu, power, path):
    """rbgnet-train-cli: the ``train`` CLI in this process for one epoch
    over a CLI_SCENES-scene 100k-point tree with REPEAT.train 1 (one step
    at the YAML's B = 8) with the model as users build it.  Held: the
    step's loss and tb finite, the checkpoint's epoch and it (1, 1) and
    its keys the model's parameters and buffers, the model on the card, no
    kernel launched.  Printed: ms per step (loader wait plus step) and the
    peak GB.  Resume does not depend on the model; it is held on
    CAGroup3D's paths (phase 7c)."""
    import pickle
    import tempfile
    import numpy as np
    import torch
    from cagroup3d_tpu_torch.tools import train as cli
    from cagroup3d_tpu_torch.utils.synthetic import write_indoor_tree
    B = int(path.cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    cwd, t_phase, bad = os.getcwd(), time.time(), []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rbg_train_") as tmp:
        tree = os.path.join(tmp, path.name)
        write_indoor_tree(tree, path.dataset, list(path.cfg.CLASS_NAMES),
                          CLI_SCENES, n_points=N_POINTS, seed=1)
        torch.cuda.empty_cache()
        launch_counts(reset=True)
        torch.cuda.reset_peak_memory_stats()
        rec = TrainCliRecording()
        try:
            os.chdir(tmp)
            rec.start()
            args, cfg = cli.parse_config(
                ["--cfg_file", path.cfg_path, "--epochs", "1", "--set",
                 "DATA_CONFIG.DATA_PATH", tree, "DATA_CONFIG.REPEAT.train",
                 "1"])
            out = os.path.join(tmp, cli.main(args, cfg))
            launches = launch_counts()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
        finally:
            os.chdir(cwd)
            rec.stop()
        with open(os.path.join(out, "ckpt", "checkpoint_epoch_1.pkl"),
                  "rb") as f:
            ckpt = pickle.load(f)
    steps, model = rec.steps, rec.models[-1]
    n_steps = CLI_SCENES // B
    if len(steps) != n_steps or not all(
            np.isfinite([s["loss"], *s["tb"].values()]).all() for s in steps):
        bad.append(f"{len(steps)} steps (not {n_steps}) or a non-finite "
                   f"loss")
    if (ckpt["epoch"], ckpt["it"]) != (1, n_steps):
        bad.append(f"checkpoint (epoch, it) {(ckpt['epoch'], ckpt['it'])}")
    if set(ckpt["params"]) != {k for k, _ in model.named_parameters()} or \
            set(ckpt["state"]) != {k for k, _ in model.named_buffers()}:
        bad.append("the checkpoint's keys differ from the model's")
    if not next(model.parameters()).is_cuda:
        bad.append("the model was not on the card")
    if path.launches_bad(launches):
        bad.append(f"a kernel was launched on RBGNet's path: {launches}")
    waits = [w * 1e3 for ld in rec.loaders for w in ld.waits]
    ms = [w + s["ms"] for w, s in zip(waits, steps)]
    emit({"phase": "rbgnet-train-cli", "config": path.name, "ok": not bad,
          "gpu": gpu, "power_limit": power, "scenes": CLI_SCENES,
          "points_per_scene": N_POINTS, "batch_size": B, "ms_per_step": ms,
          "loader_share": sum(waits) / sum(ms) if ms else None,
          "peak_memory_gb": peak_gb, "losses": [s["loss"] for s in steps],
          "tb": steps[-1]["tb"] if steps else None, "launches": launches,
          "seconds": time.time() - t_phase})
    if bad:
        fail("rbgnet-train-cli", "; ".join(bad))
    return launches


class Discrete:
    """Inside ``with``: the port's FPS and ball queries (``core.pointnet2``)
    recorded in call order (``replay=False``), or, replaying, each call's
    own result compared with the recorded one (differing entries counted
    in ``flips``) and the recorded one returned on the call's device, so
    that the stage downstream sees the recorded run's discrete steps."""

    def __init__(self):
        self.calls, self.flips, self.replay, self.i = [], {}, False, 0

    def start(self, replay):
        """Record a new run (``replay=False``) or replay the last one."""
        self.replay, self.i = replay, 0
        if not replay:
            self.calls = []
        return self

    def __enter__(self):
        from cagroup3d_tpu_torch.core import pointnet2 as pn2
        self.pn2 = pn2
        self.orig = {n: getattr(pn2, n) for n in ("farthest_point_sample",
                                                  "ball_query")}
        for n, fn in self.orig.items():
            setattr(pn2, n, self._wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.pn2, n, fn)

    def _wrap(self, name, fn):
        def run(*a, **kw):
            out = fn(*a, **kw)
            got = out if isinstance(out, tuple) else (out,)
            if not self.replay:
                self.calls.append(tuple(t.cpu() for t in got))
                return out
            ref = self.calls[self.i]
            self.i += 1
            self.flips[name] = self.flips.get(name, 0) + sum(
                int((g.cpu() != r).sum()) for g, r in zip(got, ref))
            ref = tuple(r.to(got[0].device) for r in ref)
            return ref if isinstance(out, tuple) else ref[0]
        return run


def phase_rbg_reference(dev, path, seed=3):
    """rbgnet-reference: the tiny configuration (``TINY_RBG`` widths on the
    YAML) on the card against the same model on the CPU, stage by stage on
    the same inputs at phase 7's bars (boxes 1e-2, scores 1e-3): the
    backbone with the CPU's FPS and ball-query results injected (the
    card's own counted where they differ), the head on the CPU's backbone
    outputs (the same injection; the intersection classifier's gating
    argmax counted where it differs), the boxes on the CPU's head
    outputs.  Then the whole forward without injection: held when no
    discrete step (FPS, radius, gating argmax) parted the stages, printed
    otherwise."""
    import torch
    from cagroup3d_tpu_torch.core.module import Ctx, flat_state
    from cagroup3d_tpu_torch.utils.synthetic import synthetic_request
    tc = tiny_rbg_model(copy.deepcopy(path.cfg.MODEL))
    cpu_m = rbg_model(tc, path.n_cls, "cpu", seed=1)
    gpu_m = copy.deepcopy(cpu_m).to(dev)
    req = synthetic_request(seed, "cpu", **dict(TINY_SCENE, **path.scene))
    pts, pv = req["points"], req["points_valid"]
    rec, stages, res = Discrete(), {}, {}
    box_like = ("fp_xyz", "center", "vote_points", "aggregated_points",
                "seed_points", "boxes")
    with torch.no_grad(), rec:
        for name, m, d in (("cpu", cpu_m, "cpu"), ("gpu", gpu_m, dev)):
            P, S = flat_state(m)
            rec.start(replay=name == "gpu")
            res[name] = m.backbone_3d(P, S, Ctx(), pts[..., :3].to(d),
                                      pts[..., 3:6].to(d) / 255.0, pv.to(d))
        bb = res["cpu"]
        keys = ("fp_xyz", "fp_features", "fp_valid", "fp_indices")
        stages["backbone"] = agree({k: res["gpu"][k] for k in keys},
                                   {k: bb[k] for k in keys},
                                   ("fp_valid", "fp_indices"), box_like)
        for name, m, d in (("cpu", cpu_m, "cpu"), ("gpu", gpu_m, dev)):
            P, S = flat_state(m)
            rec.start(replay=name == "gpu")
            res[name] = m.point_head(P, S, Ctx(), {
                k: v.to(d) if torch.is_tensor(v) else v
                for k, v in bb.items()})
        head = res["cpu"]
        keys = [k for k in head if k != "ray_fps_idx"]
        stages["head"] = agree({k: res["gpu"][k] for k in keys},
                               {k: head[k] for k in keys},
                               ("seed_valid",), box_like)
        gating = {k: int((res["gpu"][k].argmax(-1).cpu() !=
                          head[k].argmax(-1)).sum())
                  for k in ("coarse_intersec_score", "fine_intersec_score")}
        for name, m, d in (("cpu", cpu_m, "cpu"), ("gpu", gpu_m, dev)):
            res[name] = dict(zip(("boxes", "scores", "labels", "valid"),
                                 m.point_head.generate_predicted_boxes(
                {k: v.to(d) for k, v in head.items()}, pts[..., :3].to(d),
                pv.to(d), max_out=m.max_out)))
        stages["boxes"] = agree(res["gpu"], res["cpu"], ("labels", "valid"),
                                box_like)
    flips = dict(rec.flips, gating=sum(gating.values()))
    ref = cpu_m.forward_eval(req)
    got = gpu_m.forward_eval({k: v.to(dev) for k, v in req.items()})
    pred = ("pred_valid", "pred_labels", "pred_boxes", "pred_scores")
    whole = agree({k: got[k] for k in pred}, {k: ref[k] for k in pred},
                  pred[:2], pred[2:3])
    held = not any(flips.values())
    ok = all(st["ok"] for st in stages.values()) and (whole["ok"] or
                                                      not held)
    emit({"phase": "rbgnet-reference", "config": path.name, "ok": ok,
          "detections": int(ref["pred_valid"].sum()),
          "discrete_flips": flips, "whole_forward": whole,
          "whole_forward_held": held, "stages": stages})
    if not ok or int(ref["pred_valid"].sum()) == 0:
        fail("rbgnet-reference", "card and CPU disagree on the tiny RBGNet")


def rbg_learn_loss(tb):
    """The part of RBGNet's loss that every step carries: the vote,
    objectness and foreground-sampling terms of its ``tb``.  The box terms
    (the Chamfer center's proposal side, size, heading, scale, semantic,
    IoU and intersection) are means over the positive proposals and 0
    while none is positive, so the whole loss jumps between two levels as
    the tiny model's proposals turn positive and back, in both packages."""
    return float(tb["vote_loss"]) + float(tb["objectness_loss"]) + sum(
        float(v) for k, v in tb.items() if k.startswith("sample_loss_"))


def rbg_drop(curve):
    """RBGNet's learn drop: 1 - the median of the curve's second half / its
    first value, over ``rbg_learn_loss`` values."""
    return 1.0 - statistics.median(curve[len(curve) // 2:]) / curve[0]


def phase_rbg_learn(dev, path):
    """rbgnet-learn: the tiny configuration trained from the same weights
    on each of the RBG_LEARN_SEEDS fixed B = 2 batches for RBG_LEARN_STEPS
    steps: the mean drop (``rbg_drop``) of the loss's ungated part
    (``rbg_learn_loss``) is at least nine tenths of the JAX package's in
    the same setting (``tests/learn_margin.py --rbgnet [--yaw]``).  The
    whole loss is printed beside it."""
    import torch
    from cagroup3d_tpu_torch.parallel.mesh import make_train_step
    from cagroup3d_tpu_torch.training.optimization import build_optimizer
    tc = tiny_rbg_model(copy.deepcopy(path.cfg.MODEL))
    curves, losses = [], []
    for seed in RBG_LEARN_SEEDS:
        m = rbg_model(tc, path.n_cls, "cpu", seed=1).to(dev)
        opt, _ = build_optimizer(m, path.cfg.OPTIMIZATION, STEPS_PER_EPOCH)
        step = make_train_step(m, opt, torch.Generator().manual_seed(0),
                               device=dev)
        batch = synthetic_train_batch(seed, dev, 2, **path.scene,
                                      **TINY_TRAIN_SCENE)
        runs = [step(batch, 0.0) for _ in range(RBG_LEARN_STEPS)]
        losses.append([float(loss) for loss, _ in runs])
        curves.append([rbg_learn_loss(tb) for _, tb in runs])
    drops = [rbg_drop(c) for c in curves]
    drop = sum(drops) / len(drops)
    margin = 0.9 * path.jax_learn_drop
    ok = all(x == x for c in losses for x in c) and drop >= margin
    emit({"phase": "rbgnet-learn", "config": path.name, "ok": ok,
          "steps": RBG_LEARN_STEPS, "seeds": list(RBG_LEARN_SEEDS),
          "drops": drops, "drop": drop, "required_drop": margin,
          "ungated_losses": curves, "losses": losses})
    if not ok:
        fail("rbgnet-learn", f"the ungated loss fell by {drop:.3f}, less "
                             f"than nine tenths of the JAX package's "
                             f"{path.jax_learn_drop}")


def run_rbg_path(dev, gpu, power, path):
    """RBGNet's phases on one configuration at full width (``rbgnet-learn``
    runs at the end, ``LearnJobs``).  Returns the kernels' launches summed
    over its runs (all 0)."""
    import torch
    model = rbg_model(path.cfg.MODEL, path.n_cls, dev, seed=0)
    runs = [phase_rbg_requests(model, dev, gpu, power, path),
            phase_test_cli(dev, gpu, power, path)]
    runs.append(phase_train(model, dev, gpu, power, path))
    del model
    torch.cuda.empty_cache()
    runs.append(phase_rbg_train_cli(dev, gpu, power, path))
    phase_rbg_reference(dev, path)
    return {k: sum(r[k] for r in runs) for k in runs[0]}


# ---------------------------------------------------------------------------
# SECOND on KITTI (MeanVFE, VoxelBackBone8x, HeightCompression,
# BaseBEVBackbone, AnchorHeadSingle; key bits (11, 11, 8))
# ---------------------------------------------------------------------------

KITTI_CFG = os.path.join(HERE, "tools", "cfgs", "kitti_models", "second.yaml")
KITTI_TAG = {"config": "kitti_second"}
# 8 frames of 18 objects: 48 a class, enough for the GT oracle's AP R40 of
# 100 (4 frames give 57.5)
KITTI_POINTS, KITTI_CLI_FRAMES = 120_000, 8
SECOND_K1_PER_SCENE = 11      # 8 submanifold and 3 strided convs
# tests/test_outdoor.py::second_cfg's widths (the tiny SECOND), on the
# YAML's model and the dataset's range and voxel size
TINY_SECOND = dict(INPUT_CAP=4096,
                   CAPS={1: 4096, 2: 2048, 4: 1024, 8: 512},
                   LAYER_NUMS=[2, 2], NUM_FILTERS=[32, 64],
                   NUM_UPSAMPLE_FILTERS=[32, 32],
                   NMS_CONFIG=dict(SCORE_THRESH=0.1, NMS_THRESH=0.01,
                                   NMS_PRE_MAXSIZE=512), MAX_OUT=64)
# SECOND training on KITTI
SECOND_TRAIN_STEPS = 1          # timed B = 4 steps after the recorded one
SECOND_TRAIN_POINTS = 120_000   # a train frame's points, before sampling
SECOND_LEARN_STEPS = 30
# How far the tiny SECOND's loss falls in SECOND_LEARN_STEPS steps on one
# fixed batch (second_learn_batch) from the JAX package's step on the CPU
# (``JAX_PLATFORMS=cpu python tests/learn_margin.py --second``; the port's
# CPU step 0.9116)
JAX_LEARN_DROP_SECOND = 0.9193
# second-learn's tiny SECOND: TINY_SECOND's widths on the 16 x 16 m range
# of tests/test_outdoor.py::second_cfg (384 anchors): the JAX package's
# assigner computes its whole IoU matrix, which at the YAML's 211,200
# anchors takes 15 GB of the CPU, so learn_margin.py runs it here
LEARN_GRID = dict(POINT_CLOUD_RANGE=[0.0, -8.0, -3.0, 16.0, 8.0, 1.1],
                  VOXEL_SIZE=[0.25, 0.25, 0.1])


def tiny_second_config(cfg, learn=False):
    """The YAML's MODEL at TINY_SECOND's widths (``learn``: on
    LEARN_GRID's range and voxel size)."""
    mc = copy.deepcopy(cfg.MODEL)
    t = TINY_SECOND
    mc.INPUT_CAP = t["INPUT_CAP"]
    mc.BACKBONE_3D.CAPS = t["CAPS"]
    mc.BACKBONE_2D.update({k: t[k] for k in (
        "LAYER_NUMS", "NUM_FILTERS", "NUM_UPSAMPLE_FILTERS")})
    mc.DENSE_HEAD.update(NMS_CONFIG=t["NMS_CONFIG"], MAX_OUT=t["MAX_OUT"])
    if learn:
        mc.update(copy.deepcopy(LEARN_GRID))
    return mc


def kitti_config():
    from cagroup3d_tpu_torch.models import load_config
    return load_config(KITTI_CFG)


def second_model(cfg, dev, seed, tiny=False, lift=True):
    """A seeded SECOND of the KITTI YAML through ``build_network`` with the
    dataset config (``dataset_meta``); ``tiny``: TINY_SECOND's widths;
    ``lift``: the class prior lifted (bias 0, scores about 0.5), so that
    the untrained model's candidates pass the score threshold and NMS
    sees its full candidate set."""
    import torch
    from cagroup3d_tpu_torch.models import build_network
    from cagroup3d_tpu_torch.models.detectors.detector3d_template import \
        dataset_meta
    mc = tiny_second_config(cfg) if tiny else copy.deepcopy(cfg.MODEL)
    m = build_network(mc, len(cfg.CLASS_NAMES),
                      generator=torch.Generator().manual_seed(seed),
                      device=dev, dataset=dataset_meta(cfg.DATA_CONFIG,
                                                       cfg.CLASS_NAMES))
    if lift:
        with torch.no_grad():
            m.dense_head.get_parameter("conv_cls.bias").zero_()
    return m


def kitti_request(cfg, seed, dev, n_points=KITTI_POINTS):
    """One synthetic 120k-point lidar frame (``kitti_frame``) prepared as
    the KITTI dataset prepares a frame (range mask, POINT_CAP padding) at
    batch 1 on ``dev``."""
    import numpy as np
    import torch
    from cagroup3d_tpu_torch.datasets.dataset import prepare_outdoor_sample
    from cagroup3d_tpu_torch.utils.synthetic import kitti_frame
    pts, names, boxes = kitti_frame(np.random.RandomState(seed), n_points)
    d = prepare_outdoor_sample(
        dict(points=pts, gt_boxes=boxes, gt_names=names,
             frame_id=str(seed)), np.random.RandomState(seed),
        augmentor=None, shuffle_points=False,
        class_names=list(cfg.CLASS_NAMES),
        pc_range=cfg.DATA_CONFIG.POINT_CLOUD_RANGE,
        point_cap=int(cfg.DATA_CONFIG.get("POINT_CAP", 65536)), max_gt=64)
    return {k: torch.from_numpy(d[k][None]).to(dev)
            for k in ("points", "points_valid")}


def second_k1_form(args, kw):
    return "h_second_down_k3" if k1_args(args, kw)[5] is not None \
        else "g_second_subm_k3"


def phase_second_requests(dev, gpu, power, cfg):
    """second-requests: the YAML's full-width SECOND (seeded, class prior
    lifted), built with the KITTI dataset config.  A warm-up frame records
    every K1 call and the key bits each launched at; each call is then
    replayed against its plain version at the model's bits with phase 4's
    bars and printed per form with its time, bound and ``library_ms``.
    Then, launch counters reset, three 120k-point frames at batch 1:
    ms/scene, the peak GB and K1's launches (11 a scene); outputs finite
    with the expected shapes; two direct ``forward_eval`` calls the same
    bits; and the NMS's row-blocked overlap matrix at N = 4096 (the same
    bits at two block sizes; 1024 rows against the whole matrix), its
    time and peak GB.  Returns (K1 form stats, K1 totals, launches)."""
    import torch
    import cagroup3d_tpu_torch.models.backbones_3d.spconv_backbone as sb
    from cagroup3d_tpu_torch.core import hashing
    from cagroup3d_tpu_torch.core import sparse_conv as core_conv
    from cagroup3d_tpu_torch.core.module import Ctx
    from cagroup3d_tpu_torch.ops.sparse_conv import (sparse_conv,
                                                     sparse_conv_plain)
    t_phase, bad = time.time(), []
    model = second_model(cfg, dev, seed=0)
    reqs = [kitti_request(cfg, seed, dev) for seed in (10, 0, 1, 2)]
    calls, bits = [], []

    def rec(*args, **kw):
        bits.append(hashing.key_bits())
        calls.append((args, kw))
        return sparse_conv(*args, **kw)

    core_conv.sparse_conv = sb.sparse_conv = rec
    try:
        t0 = time.time()
        warm = model.forward_eval(reqs[0])
        torch.cuda.synchronize()
        warm_s = time.time() - t0
    finally:
        core_conv.sparse_conv = sb.sparse_conv = sparse_conv
    with hashing.key_bits_scope(model.key_bits):
        forms = replay(calls, [second_k1_form(*c) for c in calls],
                       sparse_conv, sparse_conv_plain, k1_info,
                       library_conv_ms)
        voxels = [int(model.vfe(Ctx(), r["points"][0], r["points_valid"][0],
                                model.voxel_size, model.point_cloud_range,
                                model.input_cap).valid.sum())
                  for r in reqs[1:]]
    for name, f in sorted(forms.items()):
        emit({"phase": "k1", **KITTI_TAG, "form": name, "gpu": gpu,
              "power_limit": power, **f})
    if not all(f["ok"] for f in forms.values()) or len(forms) != 2:
        bad.append(f"K1 disagrees with its plain version at SECOND's calls "
                   f"or a form is missing: {sorted(forms)}")
    if len(calls) != SECOND_K1_PER_SCENE or \
            set(bits) != {tuple(model.key_bits)} or \
            tuple(model.key_bits) != (11, 11, 8):
        bad.append(f"{len(calls)} K1 calls a scene at bits {set(bits)}")

    launch_counts(reset=True)
    torch.cuda.reset_peak_memory_stats()
    lat_ms, outs = [], []
    for r in reqs[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(model.forward_eval(r))
        torch.cuda.synchronize()
        lat_ms.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    M = model.dense_head.max_out
    for out in outs:
        shapes = {k: tuple(v.shape) for k, v in out.items()}
        if shapes != {"pred_boxes": (1, M, 7), "pred_scores": (1, M),
                      "pred_labels": (1, M), "pred_valid": (1, M),
                      "overflow": (1,)}:
            bad.append(f"bad output shapes {shapes}")
        if not all(bool(torch.isfinite(v.float()).all())
                   for v in out.values()):
            bad.append("non-finite outputs")
    if launches["sparse_conv"] != 3 * SECOND_K1_PER_SCENE or \
            launches["segsum"] or launches["sparse_conv_dw"]:
        bad.append(f"launches {launches}, expected K1 "
                   f"{SECOND_K1_PER_SCENE} a scene and no other kernel")
    again = model.forward_eval(reqs[1])
    two_same = all(torch.equal(outs[0][k], again[k]) for k in again)
    if not two_same:
        bad.append("two forward_eval calls on one frame differ")
    if hashing.key_bits() != (10, 10, 10):
        bad.append(f"the global key bits are {hashing.key_bits()} after "
                   f"SECOND's forward")

    nms_stats = nms_blocks(dev)
    bad += [f"the overlap matrix of {n} boxes changes with its row blocks"
            for n, st_ in nms_stats.items() if not st_["blocks_same_bits"]]
    emit({"phase": "second-requests", **KITTI_TAG, "ok": not bad,
          "gpu": gpu, "power_limit": power, "scenes": 3,
          "points_per_frame": KITTI_POINTS,
          "points_in_range": [int(r["points_valid"].sum())
                              for r in reqs[1:]],
          "voxels": voxels, "key_bits": list(model.key_bits),
          "warm_up_seconds": warm_s, "ms_per_scene": lat_ms,
          "median_ms": sorted(lat_ms)[1], "peak_memory_gb": peak_gb,
          "launches": launches,
          "k1_launches_per_scene": launches["sparse_conv"] / 3,
          "detections": [int(o["pred_valid"].sum()) for o in outs],
          "overflow": [int(o["overflow"].sum()) for o in outs],
          "two_calls_same_bits": two_same, "nms": nms_stats,
          "seconds": time.time() - t_phase})
    if bad:
        fail("second-requests", "; ".join(bad))
    del model
    torch.cuda.empty_cache()
    return forms, total(forms), launches


def nms_blocks(dev, n=4096):
    """Rotated greedy NMS on ``n`` random boxes and on the first 1024 (a
    head's NMS_CONFIG may ask for 4096 candidates; the YAML's head takes
    the JAX package's default 1024): the row-blocked overlap matrix at two
    block sizes (at 1024 one of them the whole matrix) the same bits; the
    NMS's ms and peak GB."""
    import torch
    from cagroup3d_tpu_torch.core import nms as nms_mod
    g = torch.Generator().manual_seed(0)
    boxes = torch.cat([torch.rand(n, 2, generator=g) * 60,
                       torch.rand(n, 1, generator=g),
                       torch.rand(n, 3, generator=g) * 3 + 0.5,
                       torch.rand(n, 1, generator=g) * 6 - 3], 1).to(dev)
    scores = torch.rand(n, generator=g).to(dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    out = {}
    for m in sorted({min(1024, n), n}):
        b = boxes[:m]
        mats = [nms_mod.overlap_matrix(b, 0.01, True, block_pairs=bp)
                for bp in (m * m, m * 128)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        keep = nms_mod.greedy_nms(b, scores[:m], valid[:m], 0.01,
                                  rotated=True)
        torch.cuda.synchronize()
        out[m] = dict(blocks_same_bits=bool(torch.equal(*mats)),
                      ms=(time.perf_counter() - t0) * 1e3,
                      peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                      kept=int(keep.sum()))
    return out


def phase_second_reference(dev, cfg):
    """second-reference: the tiny SECOND (TINY_SECOND's widths at KITTI's
    range and voxel size, so at (11, 11, 8) bits) on the card against the
    same model on the CPU, stage by stage on the CPU's inputs: the VFE's
    voxels and every backbone level's lattice exact, their features within
    2e-2 of the largest magnitude (K1's bars); the BEV map exact, the 2-D
    backbone and the head outputs within 1e-3 relative; on the CPU's head
    outputs with seeded class logits the decoded boxes within 1e-2 and
    scores within 1e-3, and the NMS keep mask (valid), labels exact."""
    import torch
    from cagroup3d_tpu_torch.core import hashing
    from cagroup3d_tpu_torch.core.module import Ctx, flat_state
    from cagroup3d_tpu_torch.core.sparse import SparseTensor
    cpu = second_model(cfg, "cpu", seed=1, tiny=True)
    gpu_m = copy.deepcopy(cpu).to(dev)
    req = kitti_request(cfg, 5, "cpu")
    st_ok, stages = True, {}

    def to(st, d):
        return SparseTensor(st.coords.to(d), st.feats.to(d), st.valid.to(d),
                            st.stride)

    def same_st(a, b):
        return bool(torch.equal(a.coords.cpu(), b.coords) and
                    torch.equal(a.valid.cpu(), b.valid))

    with torch.no_grad(), hashing.key_bits_scope(cpu.key_bits):
        Pc, Sc = flat_state(cpu)
        Pg, Sg = flat_state(gpu_m)
        args = (cpu.voxel_size, cpu.point_cloud_range, cpu.input_cap)
        vc = cpu.vfe(Ctx(), req["points"][0], req["points_valid"][0], *args)
        vg = gpu_m.vfe(Ctx(), req["points"][0].to(dev),
                       req["points_valid"][0].to(dev), *args)
        stages["vfe"] = dict(lattice_exact=same_st(vg, vc),
                             voxels=int(vc.valid.sum()),
                             feats_rel=rel_err(vg.feats.cpu(), vc.feats))
        bc = cpu.backbone_3d(Pc, Sc, Ctx(), vc)
        bg = gpu_m.backbone_3d(Pg, Sg, Ctx(), to(vc, dev))
        for k, c in list(bc["multi_scale_3d_features"].items()) + [
                ("out", bc["encoded_spconv_tensor"])]:
            g = bg["encoded_spconv_tensor"] if k == "out" else \
                bg["multi_scale_3d_features"][k]
            stages[k] = dict(lattice_exact=same_st(g, c),
                             voxels=int(c.valid.sum()),
                             feats_rel=rel_err(g.feats.cpu(), c.feats))
    grid = cpu.final_grid()
    with torch.no_grad():
        bev_c = cpu.map_to_bev_module(bc["encoded_spconv_tensor"], grid)
        bev_g = gpu_m.map_to_bev_module(to(bc["encoded_spconv_tensor"], dev),
                                        grid)
        stages["bev"] = dict(exact=bool(torch.equal(bev_g.cpu(), bev_c)))
        b2c = cpu.backbone_2d(Pc, Sc, bev_c)
        b2g = gpu_m.backbone_2d(Pg, Sg, bev_c.to(dev))
        stages["backbone_2d"] = dict(rel=rel_err(b2g.cpu(), b2c))
        hc = cpu.dense_head(Pc, b2c)
        hg = gpu_m.dense_head(Pg, b2c.to(dev))
        stages["head"] = {k: rel_err(hg[k].cpu(), hc[k]) for k in hc}
        # the untrained head's scores lie within ulps of each other, so the
        # devices' top-k orders differ; seeded N(0, 2) class logits part
        # them (phase 7 does the same for CAGroup3D's proposals)
        hc = dict(hc, cls_preds=torch.randn(
            hc["cls_preds"].shape, generator=torch.Generator().manual_seed(
                0)) * 2)
        pc = cpu.dense_head.generate_predicted_boxes(hc)
        pg = gpu_m.dense_head.generate_predicted_boxes(
            {k: v.to(dev) for k, v in hc.items()})
    names = ("boxes", "scores", "labels", "valid")
    stages["boxes"] = agree(dict(zip(names, pg)), dict(zip(names, pc)),
                            ("labels", "valid"), ("boxes",))
    for k in ("vfe", "x_conv1", "x_conv2", "x_conv3", "x_conv4", "out"):
        st_ok &= stages[k]["lattice_exact"] and stages[k]["feats_rel"] < TOL
    st_ok &= stages["vfe"]["feats_rel"] < 1e-5 and stages["bev"]["exact"]
    st_ok &= stages["backbone_2d"]["rel"] < 1e-3 and \
        max(stages["head"].values()) < 1e-3 and stages["boxes"]["ok"]
    kept = int(pc[3].sum())
    emit({"phase": "second-reference", **KITTI_TAG, "ok": st_ok and kept > 0,
          "key_bits": list(cpu.key_bits), "detections": kept,
          "stages": stages})
    if not st_ok or kept == 0:
        fail("second-reference", "card and CPU disagree on the tiny SECOND")


def phase_second_test_cli(dev, gpu, power, cfg):
    """second-test-cli: a raw KITTI tree of KITTI_CLI_FRAMES 120k-point
    frames with 18 labelled objects each (``write_kitti_tree``, then its
    infos), a checkpoint of the YAML's full-width SECOND (seeded, prior
    lifted) and the ``test`` CLI run in-process over it at batch 1.
    Held: result.pkl has every frame; ``forward_eval``'s inputs equal the
    loader's batches bitwise, on the card, and result.pkl's boxes, scores
    and labels equal its outputs unpadded by ``pred_valid`` bitwise; each
    batch holds the points of its frame inside the range that the writer
    counted; the GT as predictions scores the official 3D AP R40 of 100
    on every class and difficulty, and 0 moved 2 m along x; the model's
    metrics finite; K1 launched 11 times a frame; two direct calls the
    same bits.  Prints ms/scene and the loader's share."""
    import pickle
    import tempfile
    import numpy as np
    import torch
    from cagroup3d_tpu_torch.datasets import kitti_eval as KE
    from cagroup3d_tpu_torch.models.detectors.second_net import SECONDNet
    from cagroup3d_tpu_torch.tools import test as cli
    from cagroup3d_tpu_torch.training.checkpoint import save_checkpoint
    from cagroup3d_tpu_torch.utils.synthetic import write_kitti_tree
    names = list(cfg.CLASS_NAMES)
    calls, loaders, harness_s, bad = [], [], [], []
    forward, build_loader, evaluate = (SECONDNet.forward_eval,
                                       cli.build_dataloader,
                                       cli.eval_one_epoch)

    def recorded(self, batch, cur_epoch=None):
        out = forward(self, batch, cur_epoch=cur_epoch)
        calls.append((self, dict(batch), dict(out)))
        return out

    def recording_loader(**kw):
        ds, loader, sampler = build_loader(**kw)
        loaders.append((ds, Recording(loader)))
        return ds, loaders[-1][1], sampler

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = evaluate(*a, **kw)
        harness_s.append(time.perf_counter() - t0)
        return out

    cwd, t_phase = os.getcwd(), time.time()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_kitti_") as tmp:
        tree = os.path.join(tmp, "kitti")
        t0 = time.time()
        in_range = write_kitti_tree(tree, KITTI_CLI_FRAMES,
                                    n_points=KITTI_POINTS, seed=0)
        tree_s = time.time() - t0
        ckpt = os.path.join(tmp, "checkpoint_epoch_80.pkl")
        save_checkpoint(ckpt, second_model(cfg, "cpu", seed=0))
        args, cfg_cli = cli.parse_config(
            ["--cfg_file", KITTI_CFG, "--ckpt", ckpt, "--set",
             "DATA_CONFIG.DATA_PATH", tree])
        SECONDNet.forward_eval = recorded
        cli.build_dataloader, cli.eval_one_epoch = recording_loader, timed
        launch_counts(reset=True)
        try:
            os.chdir(tmp)
            ret = cli.main(args, cfg_cli)[ckpt]
        finally:
            os.chdir(cwd)
            SECONDNet.forward_eval = forward
            cli.build_dataloader, cli.eval_one_epoch = build_loader, evaluate
        launches = launch_counts()
        eval_dir = os.path.join(tmp, "output", cfg_cli.EXP_GROUP_PATH,
                                cfg_cli.TAG, args.extra_tag, "eval")
        with open(os.path.join(eval_dir, "result.pkl"), "rb") as f:
            det = pickle.load(f)
    dataset, loader = loaders[0]
    batches = loader.batches
    if not len(det) == len(calls) == len(batches) == KITTI_CLI_FRAMES:
        bad.append(f"{len(det)} frames in result.pkl, {len(calls)} calls, "
                   f"{len(batches)} batches")
    on_card = all(next(m.parameters()).is_cuda and inp["points"].is_cuda
                  for m, inp, _ in calls)
    inputs_equal = outputs_equal = points_ok = True
    for (m, inp, out), b, d in zip(calls, batches, det):
        inputs_equal &= all(torch.equal(inp[k].cpu(), torch.from_numpy(b[k]))
                            for k in ("points", "points_valid"))
        v = out["pred_valid"][0].cpu().numpy()
        mine = dict(boxes_lidar=out["pred_boxes"][0].cpu().numpy()[v],
                    score=out["pred_scores"][0].cpu().numpy()[v],
                    pred_labels=out["pred_labels"][0].cpu().numpy()[v])
        outputs_equal &= str(d["frame_id"]) == b["frame_id"][0] and all(
            d[k].dtype == x.dtype and np.array_equal(d[k], x)
            for k, x in mine.items())
        points_ok &= int(b["points_valid"][0].sum()) == \
            in_range[b["frame_id"][0]]
    if not on_card:
        bad.append("the model or its inputs were not on the card")
    if not inputs_equal:
        bad.append("forward_eval's inputs differ from the loader's batches")
    if not outputs_equal:
        bad.append("result.pkl differs from forward_eval's outputs")
    if not points_ok:
        bad.append("a batch's points differ from the writer's count in range")

    def oracle(shift):
        preds, fids = [], []
        for info in dataset.infos:
            a = info["annos"]
            gt = a["gt_boxes_lidar"].copy()
            gt[:, 0] += shift
            preds.append(dict(pred_boxes=gt,
                              pred_scores=np.full(len(gt), 0.9, np.float32),
                              pred_labels=np.array(
                                  [names.index(n) for n in
                                   a["name"][:len(gt)]], np.int32)))
            fids.append(info["point_cloud"]["lidar_idx"])
        annos = dataset.generate_prediction_dicts({"frame_id": fids}, preds,
                                                  names)
        r, _ = dataset.evaluation(annos, names)
        return {f"{c}_3d/{d}_R40": float(r[f"{c}_3d/{d}_R40"])
                for c in names for d in ("easy", "moderate", "hard")}

    t0 = time.perf_counter()
    hit = oracle(0.0)
    eval_s = time.perf_counter() - t0
    miss = oracle(2.0)
    if set(hit.values()) != {100.0}:
        bad.append(f"the GT as predictions does not score 100: {hit}")
    if set(miss.values()) != {0.0}:
        bad.append(f"the GT moved 2 m does not score 0: {miss}")
    if not ret or not all(np.isfinite(float(v)) for v in ret.values()):
        bad.append("the model's metrics are missing or not finite")
    if launches["sparse_conv"] != SECOND_K1_PER_SCENE * KITTI_CLI_FRAMES:
        bad.append(f"K1 launched {launches['sparse_conv']} times over "
                   f"{KITTI_CLI_FRAMES} frames")
    with torch.inference_mode():
        two = [calls[0][0].forward_eval(calls[0][1]) for _ in range(2)]
    two_same = all(torch.equal(two[0][k], two[1][k]) for k in two[0])
    if not two_same:
        bad.append("two direct forward_eval calls give different bits")
    emit({"phase": "second-test-cli", **KITTI_TAG, "ok": not bad,
          "gpu": gpu, "power_limit": power, "frames": len(det),
          "points_per_frame": KITTI_POINTS,
          "points_in_range": sorted(in_range.values()),
          "batch_size": 1, "tree_seconds": tree_s,
          "ms_per_scene": harness_s[0] * 1e3 / KITTI_CLI_FRAMES,
          "loader_share": sum(loader.waits) / harness_s[0],
          "launches": launches,
          "detections": [len(d["name"]) for d in det],
          "Car_3d/moderate_R40": float(ret.get("Car_3d/moderate_R40",
                                               float("nan"))),
          "oracle_R40": sorted(set(hit.values())),
          "oracle_shifted_R40": sorted(set(miss.values())),
          "two_calls_same_bits": two_same,
          "oracle_eval_seconds": eval_s,
          "matcher": KE.native_error() or "native",
          "seconds": time.time() - t_phase})
    if bad:
        fail("second-test-cli", "; ".join(bad))
    return launches


def second_learn_batch(seed, B=2, P=2000, G=8):
    """tests/test_outdoor.py::outdoor_batch's scenes (three box-shaped
    objects on a ground plane in LEARN_GRID's range, the labels 0, 1, 2),
    as numpy arrays."""
    import numpy as np
    rng = np.random.RandomState(seed)
    pts = np.zeros((B, P, 4), np.float32)
    pvalid = np.zeros((B, P), bool)
    gt = np.zeros((B, G, 8), np.float32)
    gt_valid = np.zeros((B, G), bool)
    for b in range(B):
        n, n_obj = P - 100 * b, 3
        ctr = np.stack([rng.rand(n_obj) * 12 + 2, rng.rand(n_obj) * 12 - 6,
                        rng.rand(n_obj) * 0.5 - 1.5], -1)
        size = np.stack([rng.rand(n_obj) * 2 + 2, rng.rand(n_obj) + 1,
                         rng.rand(n_obj) + 1], -1)
        yaw = rng.rand(n_obj) * np.pi - np.pi / 2
        per = n // (n_obj + 1)
        for i in range(n_obj):
            u = (rng.rand(per, 3) - 0.5) * 0.9 * size[i]
            c, s_ = np.cos(yaw[i]), np.sin(yaw[i])
            xy = np.stack([u[:, 0] * c - u[:, 1] * s_,
                           u[:, 0] * s_ + u[:, 1] * c, u[:, 2]], -1)
            pts[b, i * per:(i + 1) * per, :3] = ctr[i] + xy
            gt[b, i] = [*ctr[i], *size[i], yaw[i], i % 3]
            gt_valid[b, i] = True
        pts[b, n_obj * per:n, 0] = rng.rand(n - n_obj * per) * 15
        pts[b, n_obj * per:n, 1] = rng.rand(n - n_obj * per) * 14 - 7
        pts[b, n_obj * per:n, 2] = -1.7
        pts[b, :n, 3] = rng.rand(n)
        pvalid[b, :n] = True
    return dict(points=pts, points_valid=pvalid, gt_boxes=gt,
                gt_valid=gt_valid)


def kitti_train_batch(cfg, seeds, dev, n_points):
    """Synthetic lidar frames (``kitti_frame``) with their labelled boxes,
    prepared as the KITTI dataset prepares a frame (no augmentation), one
    scene a seed, on ``dev``."""
    import numpy as np
    import torch
    from cagroup3d_tpu_torch.datasets.dataset import prepare_outdoor_sample
    from cagroup3d_tpu_torch.utils.synthetic import kitti_frame
    items = []
    for seed in seeds:
        pts, names, boxes = kitti_frame(np.random.RandomState(seed), n_points)
        items.append(prepare_outdoor_sample(
            dict(points=pts, gt_boxes=boxes, gt_names=names,
                 frame_id=str(seed)), np.random.RandomState(seed),
            augmentor=None, shuffle_points=False,
            class_names=list(cfg.CLASS_NAMES),
            pc_range=cfg.DATA_CONFIG.POINT_CLOUD_RANGE,
            point_cap=int(cfg.DATA_CONFIG.get("POINT_CAP", 65536)),
            max_gt=64))
    return {k: torch.from_numpy(np.stack([d[k] for d in items])).to(dev)
            for k in ("points", "points_valid", "gt_boxes", "gt_valid")}


def second_bwd_form(qry):
    return "h_second_down_k3" if qry is not None else "g_second_subm_k3"


def phase_second_train(dev, gpu, power, cfg, tree):
    """second-train: the YAML's full-width SECOND (seeded, as users build
    it) trained at its BATCH_SIZE_PER_GPU of 4 on the frames of ``tree``
    through ``KittiDataset`` in train mode (gt sampling from its database,
    the world flip, rotation and scaling).  One step records every K1 call
    (forward and feature backward) and every K3 call; each is replayed
    against its plain version at the model's key bits (11, 11, 8) with
    phase 8's bars, its plan, bound and ``library_ms``.  Then, launch
    counters reset, SECOND_TRAIN_STEPS synchronized ``make_train_step``
    steps (adam_onecycle): ms/step, peak GB, the assigner's ms a scene,
    K1 launched 21 and K3 11 times a scene (the stem's features take no
    gradient), the loss finite, ``rpn_loss_loc`` > 0, every BN buffer and
    parameter moved.  Returns (K1 totals, K3 totals, launches)."""
    import numpy as np
    import torch
    import cagroup3d_tpu_torch.models.backbones_3d.spconv_backbone as sb
    import cagroup3d_tpu_torch.ops.sparse_conv as ops_sc
    from cagroup3d_tpu_torch.core import hashing
    from cagroup3d_tpu_torch.core import sparse_conv as core_conv
    from cagroup3d_tpu_torch.datasets import build_dataloader
    from cagroup3d_tpu_torch.ops.sparse_conv import (
        sparse_conv, sparse_conv_dfeats, sparse_conv_dfeats_plain,
        sparse_conv_dw, sparse_conv_dw_plain, sparse_conv_plain)
    from cagroup3d_tpu_torch.parallel.mesh import make_train_step
    from cagroup3d_tpu_torch.training.optimization import build_optimizer
    t_phase, bad = time.time(), []
    names = list(cfg.CLASS_NAMES)
    B = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    dc = copy.deepcopy(cfg.DATA_CONFIG)
    dc.DATA_PATH = tree
    np.random.seed(0)
    t0 = time.time()
    _, loader, _ = build_dataloader(dc, names, B, training=True)
    nb = next(iter(loader))
    loader_s = time.time() - t0
    batch = {k: torch.from_numpy(v).to(dev) for k, v in nb.items()
             if k != "frame_id"}
    model = second_model(cfg, dev, seed=0, lift=False)
    fwd_calls, dfe_calls, dw_calls = [], [], []
    core_conv.sparse_conv = sb.sparse_conv = recorder(sparse_conv, fwd_calls)
    ops_sc.sparse_conv_dfeats = recorder(sparse_conv_dfeats, dfe_calls)
    ops_sc.sparse_conv_dw = recorder(sparse_conv_dw, dw_calls)
    try:
        t0 = time.time()
        loss, _, _ = model.forward_train(batch,
                                         torch.Generator().manual_seed(0))
        loss.backward()
        torch.cuda.synchronize()
        first_s = time.time() - t0
    finally:
        core_conv.sparse_conv = sb.sparse_conv = sparse_conv
        ops_sc.sparse_conv_dfeats = sparse_conv_dfeats
        ops_sc.sparse_conv_dw = sparse_conv_dw
    model.zero_grad(set_to_none=True)
    with hashing.key_bits_scope(model.key_bits):
        fwd_stats = replay(fwd_calls, [second_k1_form(*c) for c in fwd_calls],
                           sparse_conv, sparse_conv_plain, k1_info,
                           library_conv_ms)
        dfe_stats = replay(dfe_calls, [second_bwd_form(
            (list(a) + [None] * 7)[5]) for a, _ in dfe_calls],
            sparse_conv_dfeats, sparse_conv_dfeats_plain, dfeats_info,
            dfeats_library_ms)
        dw_stats = replay(dw_calls, [second_bwd_form(
            (list(a) + [None] * 8)[6]) for a, _ in dw_calls],
            sparse_conv_dw, sparse_conv_dw_plain, dw_info, library_dw_ms)
    for kind, st_ in (("k1_train_forward", fwd_stats),
                      ("k1_feature_backward", dfe_stats),
                      ("k3_weight_backward", dw_stats)):
        for name, f in sorted(st_.items()):
            emit({"phase": "k3", **KITTI_TAG, "kernel": kind, "form": name,
                  "gpu": gpu, "power_limit": power, **f})
    per_scene = (len(fwd_calls) / B, len(dfe_calls) / B, len(dw_calls) / B)
    if per_scene != (SECOND_K1_PER_SCENE, SECOND_K1_PER_SCENE - 1,
                     SECOND_K1_PER_SCENE):
        bad.append(f"K1 forward, K1 backward and K3 calls a scene: "
                   f"{per_scene}")
    if not all(f["ok"] for st_ in (fwd_stats, dfe_stats, dw_stats)
               for f in st_.values()) or \
            not all(len(st_) == 2 for st_ in (fwd_stats, dfe_stats,
                                              dw_stats)):
        bad.append("a training-step kernel call disagrees with its plain "
                   "version, or a form is missing")

    opt, _ = build_optimizer(model, cfg.OPTIMIZATION, STEPS_PER_EPOCH,
                             total_epochs=int(cfg.OPTIMIZATION.NUM_EPOCHS))
    step = make_train_step(model, opt, torch.Generator().manual_seed(0),
                           device=dev)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    torch.cuda.empty_cache()
    launch_counts(reset=True)
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses, tbs = [], [], []
    for _ in range(SECOND_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, tb = step(batch, 0.0)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        tbs.append({k: float(v) for k, v in tb.items()})
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    moved = sum(not torch.equal(v, before[k])
                for k, v in model.state_dict().items())
    gt = batch["gt_boxes"]
    assigner_ms = []
    for i in range(B):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lab = model.dense_head.assign_targets(
            gt[i, :, :7], gt[i, :, 7].long(), batch["gt_valid"][i])[0]
        torch.cuda.synchronize()
        assigner_ms.append((time.perf_counter() - t0) * 1e3)
    n = SECOND_TRAIN_STEPS * B
    if launches["sparse_conv"] != n * (2 * SECOND_K1_PER_SCENE - 1) or \
            launches["sparse_conv_dw"] != n * SECOND_K1_PER_SCENE or \
            launches["segsum"]:
        bad.append(f"launches {launches}")
    if not all(np.isfinite([x, *t.values()]).all()
               for x, t in zip(losses, tbs)) or \
            not tbs[-1]["rpn_loss_loc"] > 0:
        bad.append(f"the loss is not finite or has no box term: {tbs[-1]}")
    if moved != len(before):
        bad.append(f"{len(before) - moved} parameters or buffers unchanged")
    if hashing.key_bits() != (10, 10, 10):
        bad.append(f"the global key bits are {hashing.key_bits()}")
    emit({"phase": "second-train", **KITTI_TAG, "ok": not bad, "gpu": gpu,
          "power_limit": power, "scenes_per_step": B,
          "points_per_frame": SECOND_TRAIN_POINTS,
          "points_in_range": batch["points_valid"].sum(1).tolist(),
          "gt_boxes_per_scene": batch["gt_valid"].sum(1).tolist(),
          "loader_seconds": loader_s, "recorded_step_seconds": first_s,
          "ms_per_step": step_ms, "median_ms": sorted(step_ms)[
              len(step_ms) // 2], "assigner_ms_per_scene": assigner_ms,
          "positive_anchors": int((lab > 0).sum()),
          "peak_memory_gb": peak_gb, "losses": losses, "tb": tbs[-1],
          "launches": launches, "calls_per_scene": per_scene,
          "seconds": time.time() - t_phase})
    if bad:
        fail("second-train", "; ".join(bad))
    del model, step, opt
    torch.cuda.empty_cache()
    k1_train = total({**{"f" + k: v for k, v in fwd_stats.items()},
                      **{"b" + k: v for k, v in dfe_stats.items()}})
    return k1_train, total(dw_stats), launches


def phase_second_train_reference(dev, cfg):
    """second-train-reference: the tiny SECOND's training step at KITTI's
    range and voxel size ((11, 11, 8) bits), B = 2 synthetic frames of
    30k points, on the card against the same step on the CPU, as phase 10
    holds CAGroup3D's: the loss within 1e-3 relative; per module the
    worst parameter's gradient and the whole gradient within 2e-2 in norm
    or within twice what the CPU step's own gradient moves when every
    weight is scaled by 1 + 1e-7.  The assigner's IoU matrices are held
    within 1e-4 and the card's step reads the CPU's: anchors of one class
    that a GT contains tie in exact arithmetic, and the round-off picks
    the force-matched one."""
    import torch
    cpu_m = second_model(cfg, "cpu", seed=1, tiny=True, lift=False)
    gpu_m = copy.deepcopy(cpu_m).to(dev)
    b_cpu = kitti_train_batch(cfg, (5, 6), "cpu", 30_000)
    gt = b_cpu["gt_boxes"]
    ious = [cpu_m.dense_head.match_iou(gt[i, :, :7], gt[i, :, 7].long(),
                                       b_cpu["gt_valid"][i])
            for i in range(len(gt))]
    iou_err = max(float((gpu_m.dense_head.match_iou(
        gt[i, :, :7].to(dev), gt[i, :, 7].long().to(dev),
        b_cpu["gt_valid"][i].to(dev)).cpu() - ious[i]).abs().max())
        for i in range(len(gt)))
    res = {}
    for name_, m_, b_ in (("cpu", cpu_m, b_cpu),
                          ("gpu", gpu_m, {k: v.to(dev) for k, v in
                                          b_cpu.items()}),
                          ("noise", None, b_cpu)):
        if name_ == "noise":        # the CPU step with weights * (1 + 1e-7)
            m_ = copy.deepcopy(cpu_m)
            with torch.no_grad():
                for p_ in m_.parameters():
                    p_.grad = None
                    p_.mul_(1 + 1e-7)
            pert_m = m_
        it = iter(ious)
        m_.dense_head.match_iou = lambda *a, _d=b_["points"].device: \
            next(it).to(_d)
        try:
            loss, tb, _ = m_.forward_train(b_,
                                           torch.Generator().manual_seed(7))
        finally:
            del m_.dense_head.match_iou
        loss.backward()
        res[name_] = (float(loss.detach()),
                      {k: float(v.detach()) for k, v in tb.items()})
    loss_rel = abs(res["gpu"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    reports, grads_ok = held_grads(gpu_m, cpu_m, pert_m, (
        "backbone_3d.", "backbone_2d.", "dense_head."))
    ok = loss_rel < 1e-3 and iou_err < 1e-4 and grads_ok and \
        res["cpu"][1]["rpn_loss_loc"] > 0
    emit({"phase": "second-train-reference", **KITTI_TAG, "ok": ok,
          "scenes": 2, "key_bits": list(cpu_m.key_bits),
          "iou_max_abs": iou_err, "loss_cpu": res["cpu"][0],
          "loss_gpu": res["gpu"][0], "loss_rel": loss_rel,
          "tb_cpu": res["cpu"][1], "tb_gpu": res["gpu"][1],
          "grads": reports})
    if not ok:
        fail("second-train-reference",
             "card and CPU SECOND training steps disagree")


def phase_second_train_cli(dev, gpu, power, cfg, tree, cfg_path=KITTI_CFG,
                           tag=KITTI_TAG, phase="second-train-cli",
                           kernels=True):
    """second-train-cli (and ``zoo-train-cli`` for another KITTI YAML at
    ``cfg_path``, ``tag``; without ``kernels`` K1 and K3 must launch no
    time): the ``train`` CLI in this process on ``tree``
    (one batch of train frames) at the YAML's full width and batch,
    ``--epochs 1`` and then ``--epochs 2``, which must resume from
    ``checkpoint_epoch_1.pkl`` (the optimizer's count restored); then the
    ``test`` CLI on ``checkpoint_epoch_2.pkl`` over the tree's val split.
    Held: every step's loss finite, two steps, the checkpoints' epoch and
    it, the resume logged, K1 and K3 launched in the steps and K1 in the
    evaluation, the metrics finite.  Printed: ms per step (the wait for
    the loader plus the synchronized step), the loader's share and the
    peak GB of the training calls.  Returns the steps' launches."""
    import tempfile
    import numpy as np
    t_phase, bad = time.time(), []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_second_cli_") as tmp:
        run = run_train_cli(tmp, cfg_path,
                            ["--set", "DATA_CONFIG.DATA_PATH", tree])
    rec, ckpts, logs, ret = (run[k] for k in ("rec", "ckpts", "logs",
                                              "ret"))
    train_launches, eval_launches = run["train_launches"], \
        run["eval_launches"]
    if len(rec.steps) != 2 or not all(
            np.isfinite([s["loss"], *s["tb"].values()]).all()
            for s in rec.steps):
        bad.append(f"{len(rec.steps)} steps, or a non-finite loss")
    its = {e: (c["epoch"], c["it"], c["opt_state"]["count"])
           for e, c in ckpts.items()}
    if its != {1: (1, 1, 1), 2: (2, 2, 2)}:
        bad.append(f"checkpoint (epoch, it, count): {its}")
    if re.search(r"auto-resuming from \S*checkpoint_epoch_1\.pkl "
                 r"\(epoch 1\)", logs) is None:
        bad.append("the second call did not log its resume from epoch 1")
    launched = (train_launches["sparse_conv"],
                train_launches["sparse_conv_dw"], eval_launches["sparse_conv"])
    if (min(launched) <= 0) if kernels else (max(launched) > 0):
        bad.append(f"K1/K3 launches: train {train_launches}, eval "
                   f"{eval_launches}")
    if not ret or not all(np.isfinite(float(v)) for v in ret.values()):
        bad.append("the metrics are missing or not finite")
    waits = [w * 1e3 for ld in rec.loaders for w in ld.waits]
    ms = [w + s["ms"] for w, s in zip(waits, rec.steps)]
    emit({"phase": phase, **tag, "ok": not bad,
          "gpu": gpu, "power_limit": power,
          "batch_size": int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU),
          "ms_per_step": ms, "loader_share": sum(waits) / sum(ms)
          if ms else None, "peak_memory_gb": run["peak_gb"],
          "losses": [s["loss"] for s in rec.steps], "checkpoints": its,
          "train_launches": train_launches, "eval_launches": eval_launches,
          "Car_3d/moderate_R40": float(ret.get("Car_3d/moderate_R40",
                                               float("nan"))),
          "seconds": time.time() - t_phase})
    if bad:
        fail(phase, "; ".join(bad))
    return train_launches


def phase_second_learn(dev, cfg):
    """second-learn: the tiny SECOND on LEARN_GRID, one fixed B = 2 batch
    (``second_learn_batch(11)``), SECOND_LEARN_STEPS steps of the YAML's
    adam_onecycle: the loss falls at least nine tenths as far as the JAX
    package's step makes it fall on the CPU (JAX_LEARN_DROP_SECOND)."""
    import torch
    from cagroup3d_tpu_torch.models import build_network
    from cagroup3d_tpu_torch.parallel.mesh import make_train_step
    from cagroup3d_tpu_torch.training.optimization import build_optimizer
    m = build_network(tiny_second_config(cfg, learn=True),
                      len(cfg.CLASS_NAMES),
                      generator=torch.Generator().manual_seed(1), device=dev)
    opt, _ = build_optimizer(m, cfg.OPTIMIZATION, STEPS_PER_EPOCH,
                             total_epochs=int(cfg.OPTIMIZATION.NUM_EPOCHS))
    step = make_train_step(m, opt, torch.Generator().manual_seed(0),
                           device=dev)
    b = {k: torch.from_numpy(v).to(dev)
         for k, v in second_learn_batch(11).items()}
    curve = [float(step(b, 0.0)[0]) for _ in range(SECOND_LEARN_STEPS)]
    drop = 1.0 - curve[-1] / curve[0]
    margin = 0.9 * JAX_LEARN_DROP_SECOND
    ok = all(c == c for c in curve) and drop >= margin
    emit({"phase": "second-learn", **KITTI_TAG, "ok": ok,
          "steps": SECOND_LEARN_STEPS, "losses": curve, "drop": drop,
          "required_drop": margin})
    if not ok:
        fail("second-learn", f"the loss fell by {drop:.3f}, less than nine "
                             f"tenths of the JAX package's "
                             f"{JAX_LEARN_DROP_SECOND}")


def phase_bits_after_second(dev):
    """bits: a CAGroup3D built and run after the SECOND phases packs keys
    at 10/10/10: the tiny ScanNet model's forward on the card, every K1
    launch recorded with the global key bits."""
    import torch
    from cagroup3d_tpu_torch.core import hashing
    from cagroup3d_tpu_torch.core import sparse_conv as core_conv
    from cagroup3d_tpu_torch.ops.sparse_conv import sparse_conv
    from cagroup3d_tpu_torch.utils.synthetic import synthetic_request
    tc, names, _ = tiny_config()
    m = build_model(tc, len(names), dev, seed=1)
    bits = []

    def rec(*args, **kw):
        bits.append(hashing.key_bits())
        return sparse_conv(*args, **kw)

    core_conv.sparse_conv = rec
    try:
        out = m.forward_eval(synthetic_request(3, dev, **TINY_SCENE),
                             cur_epoch=10)
    finally:
        core_conv.sparse_conv = sparse_conv
    ok = set(bits) == {(10, 10, 10)} and \
        bool(torch.isfinite(out["pred_boxes"]).all())
    emit({"phase": "bits", **KITTI_TAG, "ok": ok,
          "cagroup3d_k1_calls": len(bits),
          "key_bits": sorted({tuple(b) for b in bits})})
    if not ok:
        fail("bits", f"CAGroup3D after SECOND packed keys at {set(bits)}")


# ---------------------------------------------------------------------------
# The rest of KITTI's anchor family on SECOND's base: PointPillar (PillarVFE,
# PointPillarScatter), SECOND-multihead (AnchorHeadMulti) and SECOND-IoU
# (SECONDHead)
# ---------------------------------------------------------------------------

ZOO = ("pointpillar", "second_multihead", "second_iou", "centerpoint")
ZOO_CFGS = {n: os.path.join(HERE, "tools", "cfgs", "kitti_models",
                            f"{n}.yaml") for n in ZOO}
ZOO_K1_PER_SCENE = {"pointpillar": 0, "second_multihead": 11,
                    "second_iou": 11, "centerpoint": 11}
ZOO_FRAMES = 2          # timed eval frames a model (the first warms up too)
ZOO_CLI = ("pointpillar", "centerpoint")  # the YAMLs whose CLIs run
GRAD_BITS = ("centerpoint",)    # the zoo YAMLs of the grad-bits phase
ZOO_TRAIN_FRAME_POINTS = 20_000     # zoo-reference's frames


def zoo_tag(name):
    return {"config": f"kitti_{name}"}


def tiny_zoo_config(name, cfg):
    """The YAML's MODEL at tiny widths on its dataset's range and voxel
    size (the SECOND variants and CenterPoint at TINY_SECOND's widths, so
    at (11, 11, 8) bits; PointPillar's pillars at 10/10/10)."""
    if name == "pointpillar":
        mc = copy.deepcopy(cfg.MODEL)
        mc.INPUT_CAP = 16384
        mc.VFE.NUM_FILTERS = [16]
        mc.MAP_TO_BEV.NUM_BEV_FEATURES = 16
        mc.BACKBONE_2D.update(LAYER_NUMS=[1, 1, 1], NUM_FILTERS=[16, 32, 32],
                              NUM_UPSAMPLE_FILTERS=[16, 16, 16])
        mc.DENSE_HEAD.update(NMS_CONFIG=copy.deepcopy(
            TINY_SECOND["NMS_CONFIG"]), MAX_OUT=TINY_SECOND["MAX_OUT"])
        return mc
    mc = tiny_second_config(cfg)
    if name == "second_multihead":
        mc.DENSE_HEAD.SHARED_CONV_NUM_FILTER = 16
        mc.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE = 128
    elif name == "centerpoint":
        mc.DENSE_HEAD.SHARED_CONV_CHANNEL = 16
        mc.DENSE_HEAD.POST_PROCESSING.MAX_OBJ_PER_SAMPLE = 128
        mc.DENSE_HEAD.POST_PROCESSING.NMS_CONFIG.update(
            NMS_PRE_MAXSIZE=128, NMS_POST_MAXSIZE=64)
    else:
        mc.ROI_HEAD.update(SHARED_FC=[32, 32], IOU_FC=[32])
        mc.ROI_HEAD.ROI_GRID_POOL.IN_CHANNEL = sum(
            TINY_SECOND["NUM_UPSAMPLE_FILTERS"])
        mc.ROI_HEAD.TARGET_CONFIG.ROI_PER_IMAGE = 32
        mc.ROI_HEAD.NMS_CONFIG.TRAIN.update(NMS_PRE_MAXSIZE=256,
                                            NMS_POST_MAXSIZE=64)
        mc.ROI_HEAD.NMS_CONFIG.TEST.update(NMS_PRE_MAXSIZE=256,
                                           NMS_POST_MAXSIZE=32)
    return mc


def zoo_model(name, cfg, dev, seed, tiny=False, lift=True):
    """A seeded model of the zoo YAML ``name`` through ``build_network``
    with its dataset config; ``tiny``: ``tiny_zoo_config``; ``lift``: the
    class prior lifted (biases 0; CenterHead's heatmap bias too), so the
    untrained model's candidates pass the score threshold and its NMS sees
    its full candidate set."""
    import torch
    from cagroup3d_tpu_torch.models import build_network
    from cagroup3d_tpu_torch.models.detectors.detector3d_template import \
        dataset_meta
    mc = tiny_zoo_config(name, cfg) if tiny else copy.deepcopy(cfg.MODEL)
    m = build_network(mc, len(cfg.CLASS_NAMES),
                      generator=torch.Generator().manual_seed(seed),
                      device=dev, dataset=dataset_meta(cfg.DATA_CONFIG,
                                                       cfg.CLASS_NAMES))
    if lift:
        with torch.no_grad():
            for k, p in m.dense_head.named_parameters():
                if k.endswith(("cls.bias", "cls.out.bias", "hm.out.bias")):
                    p.zero_()
    return m


def anchor_tables(model):
    """The model's anchor target assigners: the single head itself, each
    sub-head's anchors, or none (CenterHead)."""
    heads = getattr(model.dense_head, "heads", None)
    if isinstance(heads, list):
        return [h["targets"] for h in heads]
    return [model.dense_head] if hasattr(model.dense_head, "match_iou") \
        else []


def score_map(key):
    """Whether a dense head's output ``key`` holds class logits (the anchor
    heads' ``cls_preds*``, CenterHead's ``hm_{g}``)."""
    return key.startswith(("cls_preds", "hm_"))


def box_term(tb):
    """A KITTI model's box regression loss from its tb terms (the anchor
    heads' ``rpn_loss_loc``; CenterHead's ``loc_loss_head_{g}`` summed)."""
    if "rpn_loss_loc" in tb:
        return tb["rpn_loss_loc"]
    return sum(v for k, v in tb.items() if k.startswith("loc_loss_head_"))


def phase_zoo_requests(dev, gpu, power, name, cfg):
    """zoo-requests: the YAML's full-width model (seeded, class prior
    lifted) with the KITTI dataset config of its YAML.  A warm-up frame
    records every K1 call (the SECOND variants: 11 a frame at (11, 11,
    8); PointPillar: none), each replayed against its plain version at
    the model's bits with phase 4's bars.  Then, launch counters reset,
    ZOO_FRAMES 120k-point frames at batch 1, the first the warm-up's
    frame again: ms/frame, the peak GB, K1's launches; the outputs finite
    and padded alike; the two calls on the first frame the same bits; the
    key bits back at 10/10/10.  (``profile_port.py --config kitti_<name>``
    splits a frame by stage.)  Returns (K1 form stats, launches)."""
    import torch
    import cagroup3d_tpu_torch.models.backbones_3d.spconv_backbone as sb
    from cagroup3d_tpu_torch.core import hashing
    from cagroup3d_tpu_torch.core import sparse_conv as core_conv
    from cagroup3d_tpu_torch.ops.sparse_conv import (sparse_conv,
                                                     sparse_conv_plain)
    t_phase, bad, tag = time.time(), [], zoo_tag(name)
    model = zoo_model(name, cfg, dev, seed=0)
    reqs = [kitti_request(cfg, seed, dev) for seed in range(ZOO_FRAMES)]
    calls, bits = [], []

    def rec(*args, **kw):
        bits.append(hashing.key_bits())
        calls.append((args, kw))
        return sparse_conv(*args, **kw)

    core_conv.sparse_conv = sb.sparse_conv = rec
    try:
        t0 = time.time()
        warm = model.forward_eval(reqs[0])
        torch.cuda.synchronize()
        warm_s = time.time() - t0
    finally:
        core_conv.sparse_conv = sb.sparse_conv = sparse_conv
    forms = {}
    if calls:
        with hashing.key_bits_scope(model.key_bits):
            forms = replay(calls, [second_k1_form(*c) for c in calls],
                           sparse_conv, sparse_conv_plain, k1_info,
                           library_conv_ms)
        for form, f in sorted(forms.items()):
            emit({"phase": "k1", **tag, "form": form, "gpu": gpu,
                  "power_limit": power, **f})
        if not all(f["ok"] for f in forms.values()) or len(forms) != 2:
            bad.append(f"K1 disagrees with its plain version or a form is "
                       f"missing: {sorted(forms)}")
    want_bits = {(11, 11, 8)} if ZOO_K1_PER_SCENE[name] else set()
    if len(calls) != ZOO_K1_PER_SCENE[name] or set(bits) != want_bits:
        bad.append(f"{len(calls)} K1 calls a frame at bits {set(bits)}")

    launch_counts(reset=True)
    torch.cuda.reset_peak_memory_stats()
    lat_ms, outs = [], []
    for r in reqs[:ZOO_FRAMES]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(model.forward_eval(r))
        torch.cuda.synchronize()
        lat_ms.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    shapes = {k: tuple(v.shape) for k, v in outs[0].items()}
    M = shapes["pred_boxes"][1]
    if shapes != {"pred_boxes": (1, M, 7), "pred_scores": (1, M),
                  "pred_labels": (1, M), "pred_valid": (1, M),
                  "overflow": (1,)} or M == 0 or any(
            {k: tuple(v.shape) for k, v in o.items()} != shapes
            for o in outs):
        bad.append(f"bad output shapes {shapes}")
    if not all(bool(torch.isfinite(v.float()).all()) for o in outs
               for v in o.values()):
        bad.append("non-finite outputs")
    if launches["sparse_conv"] != ZOO_FRAMES * ZOO_K1_PER_SCENE[name] or \
            launches["segsum"] or launches["sparse_conv_dw"]:
        bad.append(f"launches {launches}")
    two_same = all(torch.equal(outs[0][k], warm[k]) for k in warm)
    if not two_same:
        bad.append("two forward_eval calls on one frame differ")
    if hashing.key_bits() != (10, 10, 10):
        bad.append(f"the global key bits are {hashing.key_bits()}")
    emit({"phase": "zoo-requests", **tag, "ok": not bad, "gpu": gpu,
          "power_limit": power, "scenes": ZOO_FRAMES,
          "points_per_frame": KITTI_POINTS,
          "points_in_range": [int(r["points_valid"].sum())
                              for r in reqs[:ZOO_FRAMES]],
          "key_bits": list(model.key_bits), "grid": list(model.grid_size),
          "warm_up_seconds": warm_s, "ms_per_scene": lat_ms,
          "median_ms": sorted(lat_ms)[len(lat_ms) // 2],
          "peak_memory_gb": peak_gb, "launches": launches,
          "k1_launches_per_scene": launches["sparse_conv"] / ZOO_FRAMES,
          "outputs_per_scene": M,
          "detections": [int(o["pred_valid"].sum()) for o in outs],
          "overflow": [int(o["overflow"].sum()) for o in outs],
          "two_calls_same_bits": two_same,
          "seconds": time.time() - t_phase})
    if bad:
        fail("zoo-requests", f"{name}: " + "; ".join(bad))
    del model
    torch.cuda.empty_cache()
    return forms, launches


class Feed:
    """Hands a model recorded discrete inputs inside the block: each anchor
    table's IoU matrices (scene by scene) and, with ``props``, the
    SECOND-IoU proposals (scene by scene), moved to ``dev``."""

    def __init__(self, model, ious, props, dev):
        self.model, self.ious, self.props, self.dev = model, ious, props, dev

    def __enter__(self):
        for t, mats in zip(anchor_tables(self.model), self.ious):
            it = iter(mats)
            t.match_iou = lambda *a, _it=it: next(_it).to(self.dev)
        if self.props is not None:
            it = iter(self.props)
            self.model.proposals = lambda out, train, _it=it: tuple(
                x.to(self.dev) for x in next(_it))
        return self

    def __exit__(self, *exc):
        for t in anchor_tables(self.model):
            del t.match_iou
        if self.props is not None:
            del self.model.proposals


def phase_zoo_reference(dev, name, cfg):
    """zoo-reference: the tiny model (``tiny_zoo_config``) on the card
    against the same model on the CPU.  Eval of a 20k-point frame, stage
    by stage on the CPU's inputs: the BEV map within 2e-2 of its largest magnitude (the SECOND
    variants' sparse half in bf16 on both sides, as ``second-reference``
    holds it; PointPillar's f32 pillars within 1e-4), the 2-D backbone and
    every head output within 1e-3; on the CPU's head outputs with seeded
    class logits the predictions (SECOND-IoU: proposals, IoU head, score
    fusion, NMS) with labels and valid masks exact, boxes within 1e-2,
    scores within 1e-3.  Then one training step (B = 2 frames of 20k
    points): the assigner's IoU matrices within 1e-4 and the card's step
    reading the CPU's (ties, see ``second-train-reference``), SECOND-IoU's
    card step reading the CPU's training proposals (its dropout and RoI
    sampling draw from CPU generators, the same on both); the loss within
    1e-3 relative and each module's gradients within phase 10's bars."""
    import torch
    from cagroup3d_tpu_torch.core.module import Ctx, flat_state
    tag = zoo_tag(name)
    cpu = zoo_model(name, cfg, "cpu", seed=1, tiny=True)
    gpu_m = copy.deepcopy(cpu).to(dev)
    req = kitti_request(cfg, 5, "cpu", ZOO_TRAIN_FRAME_POINTS)
    stages = {}
    Pc, Sc = flat_state(cpu)
    Pg, Sg = flat_state(gpu_m)
    pts, pv = req["points"][0], req["points_valid"][0]
    with torch.no_grad():
        with cpu.bits_scope():
            bev_c = cpu.bev_map(Pc, Sc, Ctx(), pts, pv)
            bev_g = gpu_m.bev_map(Pg, Sg, Ctx(), pts.to(dev), pv.to(dev))
        stages["bev"] = rel_err(bev_g.cpu(), bev_c)
        b2c = cpu.backbone_2d(Pc, Sc, bev_c)
        b2g = gpu_m.backbone_2d(Pg, Sg, bev_c.to(dev))
        stages["backbone_2d"] = rel_err(b2g.cpu(), b2c)
        hc = cpu.dense_head(Pc, b2c, S=Sc)
        hg = gpu_m.dense_head(Pg, b2c.to(dev), S=Sg)
        stages["head"] = max(rel_err(hg[k].cpu(), hc[k]) for k in hc)
        gen = torch.Generator().manual_seed(0)
        hc = {k: torch.randn(v.shape, generator=gen) * 2
              if score_map(k) else v for k, v in hc.items()}
        pc = cpu.predict(Pc, Sc, Ctx(), hc, b2c, pts, pv)
        pg = gpu_m.predict(Pg, Sg, Ctx(), {k: v.to(dev) for k, v in
                                           hc.items()}, b2c.to(dev),
                           pts.to(dev), pv.to(dev))
    names = ("boxes", "scores", "labels", "valid")
    stages["predict"] = agree(dict(zip(names, pg)), dict(zip(names, pc)),
                              ("labels", "valid"), ("boxes",))
    kept = int(pc[3].sum())
    eval_ok = stages["bev"] < (1e-4 if name == "pointpillar" else TOL) and \
        stages["backbone_2d"] < 1e-3 and stages["head"] < 1e-3 and \
        stages["predict"]["ok"] and kept > 0

    b_cpu = kitti_train_batch(cfg, (5, 6), "cpu", ZOO_TRAIN_FRAME_POINTS)
    gt, gv = b_cpu["gt_boxes"], b_cpu["gt_valid"]
    ious = [[t.match_iou(gt[i, :, :7], gt[i, :, 7].long(), gv[i])
             for i in range(len(gt))] for t in anchor_tables(cpu)]
    iou_err = max((float((tg.match_iou(
        gt[i, :, :7].to(dev), gt[i, :, 7].long().to(dev),
        gv[i].to(dev)).cpu() - ious[j][i]).abs().max())
        for j, tg in enumerate(anchor_tables(gpu_m))
        for i in range(len(gt))), default=0.0)
    props = None
    if hasattr(cpu, "proposals"):
        props, make = [], cpu.proposals

        def recorded(out, train):
            props.append(tuple(x.detach().clone() for x in make(out, train)))
            return props[-1]
    res, pert_m = {}, None
    for name_, m_, b_ in (("cpu", cpu, b_cpu),
                          ("gpu", gpu_m, {k: v.to(dev) for k, v in
                                          b_cpu.items()}),
                          ("noise", None, b_cpu)):
        if name_ == "noise":        # the CPU step with weights * (1 + 1e-7)
            m_ = copy.deepcopy(cpu)
            with torch.no_grad():
                for p_ in m_.parameters():
                    p_.grad = None
                    p_.mul_(1 + 1e-7)
            pert_m = m_
        d = b_["points"].device
        if name_ == "cpu" and props is not None:
            cpu.proposals = recorded
        try:
            with Feed(m_, ious, None if name_ == "cpu" else props, d):
                loss, tb, _ = m_.forward_train(
                    b_, torch.Generator().manual_seed(7))
        finally:
            if name_ == "cpu" and props is not None:
                del cpu.proposals
        loss.backward()
        res[name_] = (float(loss.detach()),
                      {k: float(v.detach()) for k, v in tb.items()})
    loss_rel = abs(res["gpu"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    prefixes = [p for p in ("vfe.", "backbone_3d.", "backbone_2d.",
                            "dense_head.", "roi_head.")
                if any(k.startswith(p) for k, _ in cpu.named_parameters())]
    reports, grads_ok = held_grads(gpu_m, cpu, pert_m, prefixes)
    ok = eval_ok and loss_rel < 1e-3 and iou_err < 1e-4 and grads_ok and \
        box_term(res["cpu"][1]) > 0
    emit({"phase": "zoo-reference", **tag, "ok": ok,
          "key_bits": list(cpu.key_bits), "stages": stages,
          "detections": kept, "train_scenes": 2, "iou_max_abs": iou_err,
          "loss_cpu": res["cpu"][0], "loss_gpu": res["gpu"][0],
          "loss_rel": loss_rel, "tb_cpu": res["cpu"][1],
          "tb_gpu": res["gpu"][1], "grads": reports})
    if not ok:
        fail("zoo-reference", f"card and CPU disagree on the tiny {name}")


def phase_zoo_train(dev, gpu, power, name, cfg, tree):
    """zoo-train: the YAML's full-width model (seeded, as users build it)
    trained at its BATCH_SIZE_PER_GPU of 4 on the frames of ``tree``
    through ``KittiDataset`` in train mode with the YAML's DATA_CONFIG.
    One synchronized ``make_train_step`` step (adam_onecycle), launch
    counters reset before it: ms/step, the peak GB, the launches
    (PointPillar: none; the SECOND variants: K1 21 and K3 11 a scene, the
    stem's features taking no gradient), the loss finite with a box term,
    every parameter and BN buffer moved.  The step records every K1 call
    (forward and feature backward) and every K3 call, each replayed after
    it against its plain version at (11, 11, 8) with phase 8's bars.
    SECOND-IoU: the ms of each scene's training proposals (the top 9000
    anchors, NMS at 0.8, 512 kept) inside the step.  Returns (K1 totals,
    K3 totals, launches); the totals are None without calls."""
    import numpy as np
    import torch
    import cagroup3d_tpu_torch.models.backbones_3d.spconv_backbone as sb
    import cagroup3d_tpu_torch.ops.sparse_conv as ops_sc
    from cagroup3d_tpu_torch.core import hashing
    from cagroup3d_tpu_torch.core import sparse_conv as core_conv
    from cagroup3d_tpu_torch.datasets import build_dataloader
    from cagroup3d_tpu_torch.ops.sparse_conv import (
        sparse_conv, sparse_conv_dfeats, sparse_conv_dfeats_plain,
        sparse_conv_dw, sparse_conv_dw_plain, sparse_conv_plain)
    from cagroup3d_tpu_torch.parallel.mesh import make_train_step
    from cagroup3d_tpu_torch.training.optimization import build_optimizer
    t_phase, bad, tag = time.time(), [], zoo_tag(name)
    names = list(cfg.CLASS_NAMES)
    B = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    dc = copy.deepcopy(cfg.DATA_CONFIG)
    dc.DATA_PATH = tree
    np.random.seed(0)
    _, loader, _ = build_dataloader(dc, names, B, training=True)
    nb = next(iter(loader))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in nb.items()
             if k != "frame_id"}
    model = zoo_model(name, cfg, dev, seed=0, lift=False)
    opt, _ = build_optimizer(model, cfg.OPTIMIZATION, STEPS_PER_EPOCH,
                             total_epochs=int(cfg.OPTIMIZATION.NUM_EPOCHS))
    step = make_train_step(model, opt, torch.Generator().manual_seed(0),
                           device=dev)
    before = {k_: v.clone() for k_, v in model.state_dict().items()}
    proposal_ms = []
    if hasattr(model, "proposals"):
        make = model.proposals

        def timed_proposals(out, train):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            props = make(out, train)
            torch.cuda.synchronize()
            proposal_ms.append((time.perf_counter() - t0) * 1e3)
            return props
        model.proposals = timed_proposals
    fwd_calls, dfe_calls, dw_calls = [], [], []
    torch.cuda.empty_cache()
    launch_counts(reset=True)
    # K3's wrapper bumps the counter of its module name, here the recorder
    dw_rec = recorder(sparse_conv_dw, dw_calls)
    core_conv.sparse_conv = sb.sparse_conv = recorder(sparse_conv, fwd_calls)
    ops_sc.sparse_conv_dfeats = recorder(sparse_conv_dfeats, dfe_calls)
    ops_sc.sparse_conv_dw = dw_rec
    torch.cuda.reset_peak_memory_stats()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, tb = step(batch, 0.0)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    finally:
        core_conv.sparse_conv = sb.sparse_conv = sparse_conv
        ops_sc.sparse_conv_dfeats = sparse_conv_dfeats
        ops_sc.sparse_conv_dw = sparse_conv_dw
        model.__dict__.pop("proposals", None)
    launches = launch_counts()
    launches["sparse_conv_dw"] += dw_rec.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tb = {k_: float(v) for k_, v in tb.items()}
    moved = sum(not torch.equal(v, before[k_])
                for k_, v in model.state_dict().items())
    k = ZOO_K1_PER_SCENE[name]
    per_scene = (len(fwd_calls) / B, len(dfe_calls) / B, len(dw_calls) / B)
    if per_scene != ((k, k - 1, k) if k else (0, 0, 0)):
        bad.append(f"K1 forward, K1 backward and K3 calls a scene: "
                   f"{per_scene}")
    if launches["sparse_conv"] != B * (2 * k - 1 if k else 0) or \
            launches["sparse_conv_dw"] != B * k or launches["segsum"]:
        bad.append(f"launches {launches}")
    if not np.isfinite([float(loss), *tb.values()]).all() or \
            not box_term(tb) > 0:
        bad.append(f"the loss is not finite or has no box term: {tb}")
    if moved != len(before):
        bad.append(f"{len(before) - moved} parameters or buffers unchanged")
    if hashing.key_bits() != (10, 10, 10):
        bad.append(f"the global key bits are {hashing.key_bits()}")
    k1_train = k3_train = None
    if fwd_calls:
        with hashing.key_bits_scope(model.key_bits):
            fwd_stats = replay(fwd_calls, [second_k1_form(*c)
                                           for c in fwd_calls],
                               sparse_conv, sparse_conv_plain, k1_info,
                               library_conv_ms)
            dfe_stats = replay(dfe_calls, [second_bwd_form(
                (list(a) + [None] * 7)[5]) for a, _ in dfe_calls],
                sparse_conv_dfeats, sparse_conv_dfeats_plain, dfeats_info,
                dfeats_library_ms)
            dw_stats = replay(dw_calls, [second_bwd_form(
                (list(a) + [None] * 8)[6]) for a, _ in dw_calls],
                sparse_conv_dw, sparse_conv_dw_plain, dw_info,
                library_dw_ms)
        for kind, st_ in (("k1_train_forward", fwd_stats),
                          ("k1_feature_backward", dfe_stats),
                          ("k3_weight_backward", dw_stats)):
            for form, f in sorted(st_.items()):
                emit({"phase": "k3", **tag, "kernel": kind, "form": form,
                      "gpu": gpu, "power_limit": power, **f})
        if not all(f["ok"] for st_ in (fwd_stats, dfe_stats, dw_stats)
                   for f in st_.values()) or \
                not all(len(st_) == 2 for st_ in (fwd_stats, dfe_stats,
                                                  dw_stats)):
            bad.append("a training-step kernel call disagrees with its "
                       "plain version, or a form is missing")
        k1_train = total({**{"f" + k_: v for k_, v in fwd_stats.items()},
                          **{"b" + k_: v for k_, v in dfe_stats.items()}})
        k3_train = total(dw_stats)
    emit({"phase": "zoo-train", **tag, "ok": not bad, "gpu": gpu,
          "power_limit": power, "scenes_per_step": B,
          "points_in_range": batch["points_valid"].sum(1).tolist(),
          "gt_boxes_per_scene": batch["gt_valid"].sum(1).tolist(),
          "ms_per_step": step_ms, "peak_memory_gb": peak_gb,
          "loss": float(loss), "tb": tb, "launches": launches,
          "calls_per_scene": per_scene,
          "train_proposals_ms_per_scene": proposal_ms,
          "seconds": time.time() - t_phase})
    if bad:
        fail("zoo-train", f"{name}: " + "; ".join(bad))
    del model, step, opt
    torch.cuda.empty_cache()
    return k1_train, k3_train, launches


# the device memory left free in each grad-bits run (None: all of it)
GRAD_BITS_FREE_GB = (None, 12.0, None)


def phase_grad_bits(dev, gpu, power, name, cfg, tree):
    """grad-bits: whether the full-width training gradients depend on the
    free device memory, as cuDNN's choice of algorithm does.  The YAML
    ``name``'s model (second.yaml's SECOND or a zoo YAML's, seeded, its
    prior kept) and one B = 4 batch of ``tree``'s train frames (gt
    sampling, ``np.random`` seeded): the training loss's forward and
    backward once for each of GRAD_BITS_FREE_GB, the device memory held
    back by one allocation so that that many GB stay free.  Held: every
    parameter's gradient the same bits in every run.  Printed: each run's
    free GB as its forward starts and its peak GB, and per module whether
    its gradients differ from the first run's and their largest difference
    relative to its largest gradient."""
    import numpy as np
    import torch
    from cagroup3d_tpu_torch.datasets import build_dataloader
    tag = KITTI_TAG if name == "second" else zoo_tag(name)
    t_phase = time.time()
    dc = copy.deepcopy(cfg.DATA_CONFIG)
    dc.DATA_PATH = tree
    B = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    np.random.seed(0)
    _, loader, _ = build_dataloader(dc, list(cfg.CLASS_NAMES), B,
                                    training=True)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             next(iter(loader)).items() if k != "frame_id"}
    model = second_model(cfg, dev, seed=0, lift=False) if name == "second" \
        else zoo_model(name, cfg, dev, seed=0, lift=False)
    runs = []
    for free_gb in GRAD_BITS_FREE_GB:
        model.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
        held = None
        if free_gb is not None:
            free = torch.cuda.mem_get_info(dev)[0]
            held = torch.empty(max(int(free - free_gb * 1e9), 0),
                               dtype=torch.uint8, device=dev)
        free = torch.cuda.mem_get_info(dev)[0] / 1e9
        torch.cuda.reset_peak_memory_stats()
        loss, _, _ = model.forward_train(batch,
                                         torch.Generator().manual_seed(0))
        loss.backward()
        torch.cuda.synchronize()
        runs.append(dict(free_gb=free,
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                         loss=float(loss.detach()),
                         grads={k: p.grad.detach().clone()
                                for k, p in model.named_parameters()
                                if p.grad is not None}))
        del held, loss
    ref = runs[0]["grads"]
    modules = sorted({k.split(".")[0] for k in ref})
    parts = []
    for r in runs[1:]:
        d = {}
        for m in modules:
            ks = [k for k in ref if k.split(".")[0] == m]
            diff = max(float((r["grads"][k] - ref[k]).abs().max())
                       for k in ks)
            scale = max(float(ref[k].abs().max()) for k in ks)
            d[m] = dict(same_bits=all(torch.equal(r["grads"][k], ref[k])
                                      for k in ks),
                        max_rel=diff / max(scale, 1e-30))
        parts.append(d)
    ok = all(v["same_bits"] for d in parts for v in d.values()) and \
        all(r["loss"] == runs[0]["loss"] for r in runs)
    emit({"phase": "grad-bits", **tag, "ok": ok, "gpu": gpu,
          "power_limit": power, "scenes": B,
          "free_gb": [r["free_gb"] for r in runs],
          "peak_memory_gb": [r["peak_gb"] for r in runs],
          "losses": [r["loss"] for r in runs],
          "against_first_run": parts, "seconds": time.time() - t_phase})
    del model, runs, ref
    torch.cuda.empty_cache()
    if not ok:
        fail("grad-bits", f"{name}: the gradients' bits follow the free "
                          f"device memory")


def run_zoo_path(dev, gpu, power, tree):
    """The zoo's phases, model by model (``zoo-requests``,
    ``zoo-reference``, ``zoo-train``), then the ``train`` and ``test``
    CLIs of ZOO_CLI's YAMLs on ``tree`` (``zoo-train-cli``).  Returns what
    the ``kernels`` line needs."""
    from cagroup3d_tpu_torch.models import load_config
    out = {}
    for name in ZOO:
        cfg = load_config(ZOO_CFGS[name])
        forms, launches = phase_zoo_requests(dev, gpu, power, name, cfg)
        phase_zoo_reference(dev, name, cfg)
        k1_train, k3_train, train_launches = phase_zoo_train(
            dev, gpu, power, name, cfg, tree)
        if name in GRAD_BITS:
            phase_grad_bits(dev, gpu, power, name, cfg, tree)
        out[name] = dict(k1_eval=total(forms) if forms else None,
                         k1_train=k1_train, k3_train=k3_train,
                         launches=launches, train_launches=train_launches)
    for name in ZOO_CLI:
        cfg = load_config(ZOO_CFGS[name])
        out[name]["cli_train_launches"] = phase_second_train_cli(
            dev, gpu, power, cfg, tree, cfg_path=ZOO_CFGS[name],
            tag=zoo_tag(name), phase="zoo-train-cli",
            kernels=bool(ZOO_K1_PER_SCENE[name]))
    return out


def run_kitti_path(dev, gpu, power):
    """The SECOND phases on KITTI (eval, then training on a tree of one
    batch of train frames), the zoo's phases on that tree
    (``run_zoo_path``), then the CAGroup3D bits check.  Returns what the
    ``kernels`` line needs."""
    import tempfile
    from cagroup3d_tpu_torch.utils.synthetic import write_kitti_tree
    cfg = kitti_config()
    forms, k1_eval, launches = phase_second_requests(dev, gpu, power, cfg)
    phase_second_reference(dev, cfg)
    cli_launches = phase_second_test_cli(dev, gpu, power, cfg)
    B = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_kitti_train_") as d:
        tree = os.path.join(d, "kitti")
        write_kitti_tree(tree, B, n_points=SECOND_TRAIN_POINTS, seed=3,
                         n_train=B)
        k1_train, k3_train, train_launches = phase_second_train(
            dev, gpu, power, cfg, tree)
        phase_grad_bits(dev, gpu, power, "second", cfg, tree)
        phase_second_train_reference(dev, cfg)
        cli_train_launches = phase_second_train_cli(dev, gpu, power, cfg,
                                                    tree)
        zoo = run_zoo_path(dev, gpu, power, tree)
    phase_bits_after_second(dev)
    return dict(k1_eval=k1_eval, k1_train=k1_train, k3_train=k3_train,
                max_abs=dict(sparse_conv=max(
                    [f["max_abs"] for f in forms.values()] +
                    [k1_train["max_abs"]]),
                    sparse_conv_dw=k3_train["max_abs"]),
                launches=launches, cli_launches=cli_launches,
                train_launches=train_launches,
                cli_train_launches=cli_train_launches, zoo=zoo)


# ---------------------------------------------------------------------------
# dist: W ranks of b scenes against one process of W * b scenes
# ---------------------------------------------------------------------------

DIST_TIMEOUT_S = 300        # each rank's process-group timeout
DIST_STEPS = 2


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(fn, rank, world, port, timeout_s, args):
    import datetime
    import torch.distributed as dist
    timeout = datetime.timedelta(seconds=timeout_s)
    # the rendezvous store lives in the parent (``run_ranks``): a rank that
    # hosted it could tear it down while another still talks to it, and
    # the C++ runtime aborts that rank at exit
    store = dist.TCPStore("127.0.0.1", port, world, is_master=False,
                          timeout=timeout)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world, timeout=timeout)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    # done: leave without the interpreter's teardown, where gloo's threads
    # at times abort the process ("terminate called without an active
    # exception") after its work and results are complete
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def run_ranks(fn, args, world=2, timeout_s=DIST_TIMEOUT_S, during=None):
    """fn(rank, world, *args) in ``world`` processes (``spawn``), joined in
    a gloo process group over the loopback interface whose collectives
    raise after ``timeout_s``; ``during()`` runs here meanwhile and its
    result is returned.  Raises if a rank exits non-zero (the others are
    killed then) or runs ``timeout_s`` + 60 s."""
    import datetime
    import multiprocessing as mp
    import torch.distributed as dist
    ctx = mp.get_context("spawn")
    port = free_port()
    store = dist.TCPStore("127.0.0.1", port, world, is_master=True,
                          timeout=datetime.timedelta(seconds=timeout_s),
                          wait_for_workers=False)
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world, port, timeout_s, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.time() + timeout_s + 60
    out = None
    try:
        if during is not None:
            out = during()
        while any(p.is_alive() for p in procs) and time.time() < deadline:
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        del store            # after every rank has exited
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise RuntimeError(f"{fn.__name__}: the ranks' exit codes {codes} "
                           f"(negative: killed; the limit {timeout_s} s)")
    return out


def step_case(spec):
    """(model, optimizer, batch) of a dist comparison, the same on every
    call: ``spec`` kind ("cagroup3d", "rbgnet" or "kitti", with the KITTI
    YAML's ``name``), cfg (the YAML), tiny (the tiny widths of phases
    10-11 and rbgnet-learn, or the YAML's with phase 9's caps; KITTI:
    ``kitti_step_case``), device, B (the global batch) and seed (the
    batch's).  The votes are zeroed (CAGroup3D's as in phase 10, RBGNet's
    offsets): a vote's floor, FPS over the votes and the radius groups
    around them are discrete steps that round-off moves, and the ranks add
    some sums in another order than the one process."""
    import torch
    from cagroup3d_tpu_torch.models import load_config
    from cagroup3d_tpu_torch.training.optimization import build_optimizer
    cfg = load_config(spec["cfg"])
    n_cls = len(cfg.CLASS_NAMES)
    dev = torch.device(spec["device"])
    tiny = spec["tiny"]
    if spec["kind"] == "kitti":
        model, batch = kitti_step_case(spec, cfg, dev)
        opt, _ = build_optimizer(model, cfg.OPTIMIZATION, STEPS_PER_EPOCH)
        return model, opt, batch
    if spec["kind"] == "rbgnet":
        mc = copy.deepcopy(cfg.MODEL)
        model = rbg_model(tiny_rbg_model(mc) if tiny else mc, n_cls, dev,
                          seed=1)
        yaw = bool(mc.POINT_HEAD.BOX_CODER.WITH_ROT)
        w = model.get_parameter("point_head.vote_module.conv_out.weight")
        per = w.shape[1] // model.point_head.voter.vote_per_seed
        with torch.no_grad():
            for p in (w, model.get_parameter(
                    "point_head.vote_module.conv_out.bias")):
                p.view(*p.shape[:-1], -1, per)[..., :3] = 0.0
    else:
        if tiny:
            mc = tiny_train_config(spec["cfg"])[0]
            if spec.get("cpu_caps"):
                cpu_caps(mc)
        else:
            mc = copy.deepcopy(cfg.MODEL)
            mc.INPUT_CAP, mc.DENSE_HEAD.FINE_CAP = INPUT_CAP, FINE_CAP
            mc.ROI_GT_AUG = 0.05                # see tiny_train_config
        model = build_model(mc, n_cls, dev, seed=1, train=True)
        with torch.no_grad():
            model.get_parameter("dense_head.offset_block.6.kernel").zero_()
        yaw = bool(mc.DENSE_HEAD.WITH_YAW)
    opt, _ = build_optimizer(model, cfg.OPTIMIZATION, STEPS_PER_EPOCH)
    scene = TINY_TRAIN_SCENE if tiny else dict(n_points=N_POINTS)
    if spec.get("cpu_caps"):
        scene = dict(scene, n_points=1000)
    batch = synthetic_train_batch(spec["seed"], dev, spec["B"],
                                  n_classes=n_cls, yaw=yaw, **scene)
    return model, opt, batch


# The dist phase's KITTI models on the CPU (``cpu_caps`` in the spec): a
# 16 x 16 m range (tests/test_torch_kitti_zoo_cli.py's), 96 x 96 pillars
# of the YAML's 0.16 m, or 64 x 64 x 40 voxels, where the card's cases run
# on KITTI's own range and voxel size (K1 and K3 at (11, 11, 8) bits)
SMALL_KITTI_GRID = {
    "pointpillar": dict(POINT_CLOUD_RANGE=[0.0, -7.68, -3.0, 15.36, 7.68,
                                           1.0]),
    "second": dict(POINT_CLOUD_RANGE=[0.0, -8.0, -3.0, 16.0, 8.0, 2.0],
                   VOXEL_SIZE=[0.25, 0.25, 0.125])}


def kitti_step_case(spec, cfg, dev):
    """(model, batch) of a KITTI dist comparison: the YAML ``spec["name"]``
    at tiny widths (``tiny_zoo_config``; second.yaml: ``tiny_second_
    config``), seeded, its class prior kept, and spec["B"] frames: on
    KITTI's range two ``kitti_train_batch`` frames of
    ZOO_TRAIN_FRAME_POINTS points, or with ``cpu_caps`` on
    SMALL_KITTI_GRID's range the scenes of ``second_learn_batch``."""
    import torch
    from cagroup3d_tpu_torch.models import build_network
    from cagroup3d_tpu_torch.models.detectors.detector3d_template import \
        dataset_meta
    name = spec["name"]
    mc = tiny_second_config(cfg) if name == "second" else \
        tiny_zoo_config(name, cfg)
    seeds = range(spec["seed"], spec["seed"] + spec["B"])
    if spec.get("cpu_caps"):
        mc.update(copy.deepcopy(SMALL_KITTI_GRID[
            "pointpillar" if name == "pointpillar" else "second"]))
        if "VOXEL_SIZE" in mc.DENSE_HEAD:       # CenterHead's own
            mc.DENSE_HEAD.VOXEL_SIZE = list(mc.VOXEL_SIZE)
        b = second_learn_batch(spec["seed"], B=spec["B"])
        batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    else:
        batch = kitti_train_batch(cfg, seeds, dev, ZOO_TRAIN_FRAME_POINTS)
    model = build_network(mc, len(cfg.CLASS_NAMES),
                          generator=torch.Generator().manual_seed(1),
                          device=dev, dataset=dataset_meta(cfg.DATA_CONFIG,
                                                           cfg.CLASS_NAMES))
    return model, batch


def cpu_caps(mc):
    """A tiny CAGroup3D configuration cut further for CPU tests, in place:
    half the caps and k3 class convs (the plain k9 conv's backward
    dominates a CPU step)."""
    mc.BACKBONE_3D.CAPS = {1: 1024, 2: 1024, 4: 512, 8: 256, 16: 128,
                           32: 64, 64: 16, 128: 8, 256: 8, 512: 8}
    mc.INPUT_CAP = 1024
    mc.DENSE_HEAD.update(CLS_KERNEL=3, FINE_CAP=256, EXPAND_CAP=256)
    mc.ROI_HEAD.GRID_CAP = 512
    return mc


def record_steps(step, model, batch, steps=DIST_STEPS):
    """``steps`` training steps on ``batch``: each step's loss and tb, the
    gradients of the first update (``grads_of``, after the clip) and the
    parameters and buffers after the last step (on the CPU)."""
    out = dict(loss=[], tb=[])
    for i in range(steps):
        loss, tb = step(batch, 0.0)
        out["loss"].append(float(loss))
        out["tb"].append({k: float(v) for k, v in tb.items()})
        if i == 0:
            out["grads"] = grads_of(model)
    out["state"] = {k: v.detach().cpu().clone()
                    for k, v in model.state_dict().items()}
    return out


def dist_step_rank(rank, world, specs, out_dir):
    """One rank of ``dist_step_compare``, for each of ``specs`` in turn: the
    global scenes rank*b .. rank*b + b - 1 through ``make_train_step`` over
    the process group; writes ``record_steps`` and its kernels' launches
    to ``out_dir/rank<r>_<case>.pt``."""
    import torch
    import torch.distributed as dist
    from cagroup3d_tpu_torch.parallel.mesh import make_train_step
    for i, spec in enumerate(specs):
        if torch.device(spec["device"]).type == "cpu":
            torch.set_num_threads(1)
        model, opt, batch = step_case(spec)
        b = spec["B"] // world
        local = {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}
        launch_counts(reset=True)
        step = make_train_step(model, opt, torch.Generator().manual_seed(7),
                               device=spec["device"], group=dist.group.WORLD)
        rec = record_steps(step, model, local)
        rec["launches"] = launch_counts()
        torch.save(rec, os.path.join(out_dir, f"rank{rank}_{i}.pt"))
        del model, opt, batch, local, step
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def dist_step_compare(specs, out_dir, world=2, noise=False):
    """For each of ``specs``: ``world`` ranks of B / world scenes each
    (``dist_step_rank``; one spawn of the ranks runs every spec) against
    one process at B on the same parameters, batch and generator (run
    here meanwhile).  Returns a report a spec: the first step's loss and
    tb terms, relative errors against the one process; whether the ranks'
    parameters and buffers are the same bits after DIST_STEPS steps; per
    module the first update's gradients against the one process
    (``grad_report``, of rank 0; with ``noise`` beside what the
    one-process step itself moves when every weight is scaled by
    1 + 1e-7, as phase 10 does); the ranks' kernel launches; the seconds
    of the one process."""
    import torch
    from cagroup3d_tpu_torch.parallel.mesh import make_train_step

    def one_process(spec, scale=None, steps=DIST_STEPS):
        model, opt, batch = step_case(spec)
        if scale is not None:
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(scale)
        step = make_train_step(model, opt, torch.Generator().manual_seed(7),
                               device=spec["device"])
        return record_steps(step, model, batch, steps)

    def references():
        out = []
        for spec in specs:
            t = time.time()
            ref = one_process(spec)
            pert = one_process(spec, 1 + 1e-7, steps=1) if noise else None
            out.append((ref, pert, time.time() - t))
        return out

    refs = run_ranks(dist_step_rank, (specs, out_dir), world,
                     during=references)

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    reports = []
    for i, (ref, pert, t_one) in enumerate(refs):
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}_{i}.pt"))
                 for r in range(world)]
        tb0 = ref["tb"][0]
        if any(set(r["tb"][0]) != set(tb0) for r in ranks):
            raise RuntimeError("the ranks' tb terms are not the one "
                               "process's")
        st0 = ranks[0]["state"]
        grads = {}
        for pre in sorted({k.split(".")[0] + "." for k in ref["grads"]}):
            g = grad_report(ranks[0]["grads"], ref["grads"], pre)
            if pert is not None:
                n_ = grad_report(pert["grads"], ref["grads"], pre)
                g.update(noise_worst_rel=n_["worst_rel"],
                         noise_vector_rel=n_["vector_rel"])
            grads[pre] = g
        reports.append(dict(
            loss=ref["loss"], loss_ranks=[r["loss"] for r in ranks],
            loss_rel=max(rel(r["loss"][0], ref["loss"][0]) for r in ranks),
            tb_rel={k: max(rel(r["tb"][0][k], v) for r in ranks)
                    for k, v in tb0.items()},
            ranks_same_bits=all(torch.equal(st0[k], r["state"][k])
                                for r in ranks[1:] for k in st0),
            grads=grads, launches=[r["launches"] for r in ranks],
            one_process_s=t_one))
    return reports


# the dist phase's comparisons: (name, spec) over two ranks on the card
KITTI_DIST = ("second", "pointpillar", "second_multihead", "second_iou",
              "centerpoint")
DIST_CASES = (
    ("scannet", dict(kind="cagroup3d", cfg=CFGS["scannet"], tiny=False)),
    ("sunrgbd_tiny", dict(kind="cagroup3d", cfg=CFGS["sunrgbd"], tiny=True)),
    ("rbgnet_sunrgbd_tiny", dict(kind="rbgnet", cfg=RBG_CFGS["sunrgbd"],
                                 tiny=True))) + tuple(
    (f"kitti_{n}_tiny", dict(kind="kitti", name=n, tiny=True, cfg=dict(
        ZOO_CFGS, second=KITTI_CFG)[n])) for n in KITTI_DIST)

DIST_CLI_SCENES, DIST_CLI_POINTS = 2, 20_000


def phase_dist(dev, gpu, power):
    """The dist phase: training on several cards (``--dist``), two ranks on
    this one card over gloo (NCCL takes one rank a card), then the CLIs
    under torchrun over NCCL.

    1. For each of DIST_CASES (the ScanNet YAML's full-width CAGroup3D,
       the tiny SUN RGB-D CAGroup3D, the tiny SUN RGB-D RBGNet, the tiny
       KITTI anchor family; seeded, votes zeroed, ``step_case``): two
       ranks of one scene each through
       ``make_train_step`` over a process group, against one process of
       the two scenes with the same parameters, batch and generator
       (``dist_step_compare``).  Held: the first step's loss and every tb
       term within 1e-5 relative; the ranks' parameters and BN buffers the
       same bits after DIST_STEPS steps; per module the first update's
       gradients (rank 0's, after the average over the ranks) within
       phase 10's bars (the worst parameter's error and the whole
       gradient's in norm within 2e-2 or twice what the one process moves
       when every weight is scaled by 1 + 1e-7); K1 and K3 launched in
       each rank (CAGroup3D, the SECOND family), or none of K1-K3
       (RBGNet, PointPillar).
    2. (``DistCli``; its train run starts first and overlaps part 1.)
       The ``train`` CLI with ``--dist`` under ``torchrun --standalone
       --nproc_per_node 1`` (NCCL) for one epoch on a DIST_CLI_SCENES-
       scene tree (REPEAT.train 1, B = 2), starting (``--ckpt``) from the
       YAML's full-width model with phase 6's open gate and lifted prior,
       so that the trained model detects; then the ``test`` CLI on its
       checkpoint twice, under torchrun with ``--dist`` and in this
       process without it.  Held: the runs under torchrun exit 0, the
       checkpoint's epoch and step count, result.pkl the same bits with
       detections in it, the same mAP and mAR lines in the two logs."""
    import tempfile
    t_phase, bad, cases = time.time(), [], {}
    cli = DistCli(dev)
    specs = [dict(base, device=str(dev), B=2, seed=21)
             for _, base in DIST_CASES]
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as tmp:
            reports = dist_step_compare(specs, tmp, noise=True)
    except BaseException:
        cli.abort()
        raise
    t_ranks = time.time() - t_phase
    for (name, base), rep in zip(DIST_CASES, reports):
        why = []
        if rep["loss_rel"] >= 1e-5:
            why.append(f"loss {rep['loss_rel']:.3g} apart")
        worst = max(rep["tb_rel"], key=rep["tb_rel"].get)
        if rep["tb_rel"][worst] >= 1e-5:
            why.append(f"tb {worst} {rep['tb_rel'][worst]:.3g} apart")
        if not rep["ranks_same_bits"]:
            why.append("the ranks' parameters or buffers differ")
        for pre, g in rep["grads"].items():
            g["ok"] = (g["floor_ok"] and g["worst_rel"] <= max(
                TOL, 2 * g["noise_worst_rel"]) and g["vector_rel"] <= max(
                TOL, 2 * g["noise_vector_rel"]))
            if not g["ok"]:
                why.append(f"{pre} gradients apart")
        kernels = base["kind"] == "cagroup3d" or (   # K1 and K3, or none
            base["kind"] == "kitti" and base["name"] != "pointpillar")
        for r, la in enumerate(rep["launches"]):
            if kernels and min(la["sparse_conv"], la["sparse_conv_dw"]) <= 0:
                why.append(f"rank {r} launched K1 or K3 no time: {la}")
            if not kernels and max(la.values()) != 0:
                why.append(f"rank {r} launched a kernel: {la}")
        rep["ok"] = not why
        cases[name] = rep
        bad += [f"{name}: {w}" for w in why]
    cli = cli.finish()
    bad += cli.pop("bad")
    emit({"phase": "dist", "ok": not bad, "gpu": gpu, "power_limit": power,
          "ranks": 2, "cases": cases, "cli": cli, "ranks_seconds": t_ranks,
          "seconds": time.time() - t_phase})
    if bad:
        fail("dist", "; ".join(bad))
    return {k: sum(la[k] for c in cases.values() for la in c["launches"])
            for k in ("sparse_conv", "segsum", "sparse_conv_dw")}


class DistCli:
    """Part 2 of the dist phase.  ``DistCli(dev)`` writes the tree and the
    start checkpoint and starts the ``train`` CLI under torchrun in the
    background (its start-up overlaps part 1); ``finish()`` waits for it,
    runs the ``test`` CLI on its checkpoint under torchrun and here, and
    returns the report with ``bad``.  Each run's log lines (on stderr,
    with times) are kept in the report."""

    def __init__(self, dev):
        import tempfile
        from cagroup3d_tpu_torch.models import load_config
        from cagroup3d_tpu_torch.training.checkpoint import save_checkpoint
        from cagroup3d_tpu_torch.utils.synthetic import write_indoor_tree
        self.cfg_path = CFGS["scannet"]
        cfg = load_config(self.cfg_path)
        self.env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [HERE] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        self.torchrun = [sys.executable, "-m", "torch.distributed.run",
                         "--standalone", "--nproc_per_node", "1", "-m"]
        self.out, self.bad = {}, []
        self._tmp = tempfile.TemporaryDirectory(
            prefix="chip_smoke_dist_cli_")
        self.tmp = self._tmp.name
        tree = os.path.join(self.tmp, "tree")
        write_indoor_tree(tree, "scannet", cfg.CLASS_NAMES, DIST_CLI_SCENES,
                          n_points=DIST_CLI_POINTS, seed=3)
        start = os.path.join(self.tmp, "start.pkl")
        save_checkpoint(start, build_model(copy.deepcopy(cfg.MODEL),
                                           len(cfg.CLASS_NAMES), dev, seed=0))
        self.data = ["--set", "DATA_CONFIG.DATA_PATH", tree,
                     "DATA_CONFIG.POINT_CAP", str(DIST_CLI_POINTS),
                     "DATA_CONFIG.REPEAT.train", "1"]
        self.train = self._start("train", [
            "cagroup3d_tpu_torch.tools.train", "--dist", "--cfg_file",
            self.cfg_path, "--batch_size", "2", "--epochs", "1", "--ckpt",
            start, *self.data])

    def _start(self, name, args):
        cwd = os.path.join(self.tmp, name)
        os.makedirs(cwd)
        err = open(os.path.join(self.tmp, name + ".err"), "w")
        proc = subprocess.Popen(self.torchrun + args, cwd=cwd, env=self.env,
                                stdout=subprocess.DEVNULL, stderr=err)
        return name, proc, err, time.time()

    def _wait(self, run):
        name, proc, err, t0 = run
        try:
            rc = proc.wait(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        err.close()
        with open(err.name) as f:
            text = f.read()
        log = re.findall(r"\d\d:\d\d:\d\d,\d+ .*", text)
        self.out[name] = dict(rc=rc, seconds=time.time() - t0,
                              log=log[:6] + log[-3:])
        if rc != 0:
            self.bad.append(f"{name} exited {rc}: {text[-2000:]}")
        return rc == 0

    def abort(self):
        """Stop the train run and remove the tree (part 1 failed)."""
        self.train[1].kill()
        self.train[1].wait()
        self.train[2].close()
        self._tmp.cleanup()

    def finish(self):
        import glob
        try:
            ok = self._wait(self.train)
            ckpts = glob.glob(os.path.join(self.tmp, "train", "**",
                                           "checkpoint_epoch_1.pkl"),
                              recursive=True, include_hidden=True)
            if ok and len(ckpts) == 1:
                self._test(ckpts[0])
            elif ok:
                self.bad.append(f"checkpoints written: {ckpts}")
        finally:
            self._tmp.cleanup()
        return dict(self.out, bad=self.bad)

    def _test(self, ckpt):
        import glob
        import pickle
        from cagroup3d_tpu_torch.tools import test as test_cli
        with open(ckpt, "rb") as f:
            ck = pickle.load(f)
        out, bad = self.out, self.bad
        out["checkpoint"] = (ck["epoch"], ck["it"])
        if out["checkpoint"] != (1, DIST_CLI_SCENES // 2):
            bad.append(f"checkpoint (epoch, it) {out['checkpoint']}")
        test = ["--cfg_file", self.cfg_path, "--ckpt", ckpt, *self.data]
        run = self._start("test_dist", ["cagroup3d_tpu_torch.tools.test",
                                        "--dist", *test])
        os.makedirs(os.path.join(self.tmp, "test_one"))
        cwd, t = os.getcwd(), time.time()
        try:                            # the one process: this one
            os.chdir(os.path.join(self.tmp, "test_one"))
            test_cli.main(*test_cli.parse_config(test))
        finally:
            os.chdir(cwd)
        out["test_one"] = dict(seconds=time.time() - t)
        if not self._wait(run):
            return
        res, maps = {}, {}
        for name in ("test_dist", "test_one"):
            (pkl,) = glob.glob(os.path.join(self.tmp, name, "**",
                                            "result.pkl"), recursive=True,
                               include_hidden=True)
            with open(pkl, "rb") as f:
                res[name] = pickle.load(f)
            (log,) = glob.glob(os.path.join(os.path.dirname(pkl),
                                            "log_eval_*.txt"))
            with open(log) as f:
                maps[name] = re.findall(r"(m(?:AP|AR)_0\.\d+: \S+)",
                                        f.read())
        a, b = res["test_dist"], res["test_one"]
        same = len(a) == len(b) == DIST_CLI_SCENES and all(
            x.keys() == y.keys() and all(
                str(x[k]) == str(y[k]) if k == "frame_id" else
                x[k].tobytes() == y[k].tobytes() for k in x)
            for x, y in zip(a, b))
        out.update(result_same_bits=same, maps=maps,
                   detections=sum(len(x["labels_3d"]) for x in b))
        if not same or out["detections"] == 0:
            bad.append("result.pkl of the test CLI with --dist differs "
                       "from the one process's, or holds no detection")
        if maps["test_dist"] != maps["test_one"] or \
                len(maps["test_one"]) != 4:
            bad.append(f"the mAP lines differ: {maps}")


# ---------------------------------------------------------------------------
# the learn phases: loss-only checks bound by the host's Python, each in a
# process of its own beside the dist phase
# ---------------------------------------------------------------------------

LEARN_JOBS = ("scannet", "sunrgbd", "rbgnet_scannet", "rbgnet_sunrgbd",
              "second")
LEARN_TIMEOUT_S = 900


def cagroup_paths():
    return (Path("scannet", TRAIN_STEPS, JAX_LEARN_DROP),
            Path("sunrgbd", TRAIN_STEPS_YAW, JAX_LEARN_DROP_YAW))


def rbg_paths():
    return (RbgPath("scannet", JAX_LEARN_DROP_RBG),
            RbgPath("sunrgbd", JAX_LEARN_DROP_RBG_YAW))


def learn_job(job):
    """One of LEARN_JOBS in this process (``chip_smoke.py --learn <job>``):
    phase 11 of a CAGroup3D path, ``rbgnet-learn`` of an RBGNet path
    (``rbgnet_<dataset>``) or ``second-learn``."""
    import torch
    from cagroup3d_tpu_torch.ops import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for n in ("sparse_conv", "segsum"):
        build.load(n)
    dev = torch.device("cuda", 0)
    if job == "second":
        phase_second_learn(dev, kitti_config())
    elif job.startswith("rbgnet_"):
        (path,) = [p for p in rbg_paths() if p.name == job]
        phase_rbg_learn(dev, path)
    else:
        (path,) = [p for p in cagroup_paths() if p.name == job]
        phase_learn(dev, path)


class LearnJobs:
    """The learn phases of every path (phase 11 of both CAGroup3D paths,
    ``rbgnet-learn`` of both RBGNet paths, ``second-learn``), each in a
    process of its own started together: they hold only how far a loss
    falls, the card is mostly idle under their host-bound steps, and in
    one process they took about two minutes one after another.
    ``finish()`` waits for them, prints their lines and fails if one
    failed; ``abort()`` stops them."""

    def __init__(self):
        import tempfile
        self._tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_learn_")
        self.runs = []
        for job in LEARN_JOBS:
            out = open(os.path.join(self._tmp.name, job + ".out"), "w+")
            err = open(os.path.join(self._tmp.name, job + ".err"), "w+")
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--learn", job],
                cwd=HERE, stdout=out, stderr=err)
            self.runs.append((job, proc, out, err))

    def abort(self):
        for _, proc, out, err in self.runs:
            proc.kill()
            proc.wait()
            out.close()
            err.close()
        self._tmp.cleanup()

    def finish(self):
        bad = []
        try:
            for job, proc, out, err in self.runs:
                try:
                    rc = proc.wait(timeout=LEARN_TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    rc = proc.wait()
                out.seek(0)
                for line in out:
                    if line.startswith("{"):
                        emit(json.loads(line))
                if rc != 0:
                    err.seek(0)
                    bad.append(f"{job} exited {rc}: {err.read()[-2000:]}")
        finally:
            self.abort()
        if bad:
            fail("learn", "; ".join(bad))


def zoo_max_abs(z, counter):
    """A zoo model's largest replay error of a kernel (0 without calls)."""
    keys = {"sparse_conv": ("k1_eval", "k1_train"),
            "sparse_conv_dw": ("k3_train",)}.get(counter, ())
    return max([z[k]["max_abs"] for k in keys if z[k] is not None] + [0.0])


def kernel_line(res, rbg, kitti, dist):
    """The ``kernels`` line: each kernel's launches summed over the paths'
    main-path runs (K1, K3: the timed training steps; K2: the requests)
    and, as ``train_cli_launches``, over the ``train`` CLI's runs (K1, K3:
    its steps; K2: the ``test`` CLI on its checkpoint), as
    ``rbgnet_launches``, over every RBGNet run (none launches a kernel),
    as ``second_launches`` and ``second_test_cli_launches``, over
    SECOND's three requests and its ``test`` CLI run, as
    ``second_train_launches`` and ``second_train_cli_launches``, over
    SECOND's timed B = 4 training steps and its ``train`` CLI's steps,
    as ``zoo_launches``, ``zoo_train_launches`` and
    ``zoo_train_cli_launches``, over the zoo's eval frames, its timed
    B = 4 steps and ZOO_CLI's ``train`` CLIs (each model's own under
    ``paths``, ``kitti_<name>``), as ``dist_launches``, over the dist
    phase's ranks, and, as ``demo_launches``, over the demo phase's two
    scenes; its largest
    error over every replay, and its times from the ScanNet path, with
    each path's own beside them (``kitti_second``: K1's eval calls of one
    frame, and under ``train`` K1's and K3's calls of one B = 4 training
    step)."""
    def times(st):
        return {k: st[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")}

    def k1(r):
        return dict(times(r["k1_train"]), eval_ms=r["k1_eval"]["ms"],
                    eval_bound_ms=r["k1_eval"]["bound_ms"],
                    eval_library_ms=r["k1_eval"]["library_ms"],
                    launches=r["train_launches"]["sparse_conv"],
                    train_cli_launches=r["cli_train"]["sparse_conv"])

    def k2(r):
        return dict(times(r["k2"]), launches=r["eval_launches"]["segsum"],
                    train_cli_launches=r["cli_eval"]["segsum"])

    def k3(r):
        return dict(times(r["k3_train"]),
                    launches=r["train_launches"]["sparse_conv_dw"],
                    train_cli_launches=r["cli_train"]["sparse_conv_dw"])

    out = []
    for name, fn, src, line, err, counter in (
            ("K1 sparse_conv", k1, "sparse_conv.cu", "pallas_conv.py:124",
             lambda r: max(r["k1_train"]["max_abs"], r["k1_eval_max_abs"]),
             "sparse_conv"),
            ("K2 segsum", k2, "segsum.cu", "pallas_segsum.py:64",
             lambda r: r["k2"]["max_abs"], "segsum"),
            ("K3 sparse_conv_dw", k3, "sparse_conv.cu", "pallas_conv.py:472",
             lambda r: r["k3_train"]["max_abs"], "sparse_conv_dw")):
        paths = {p: fn(r) for p, r in res.items()}
        second = {"launches": kitti["launches"][counter],
                  "train_launches": kitti["train_launches"][counter]}
        if counter == "sparse_conv":
            second.update(times(kitti["k1_eval"]),
                          train=times(kitti["k1_train"]))
        elif counter == "sparse_conv_dw":
            second.update(train=times(kitti["k3_train"]))
        zoo = {}
        for zname, z in kitti["zoo"].items():
            zoo[f"kitti_{zname}"] = e = {
                "launches": z["launches"][counter],
                "train_launches": z["train_launches"][counter]}
            if "cli_train_launches" in z:
                e["train_cli_launches"] = z["cli_train_launches"][counter]
            if counter == "sparse_conv" and z["k1_eval"] is not None:
                e.update(times(z["k1_eval"]), train=times(z["k1_train"]))
            elif counter == "sparse_conv_dw" and z["k3_train"] is not None:
                e.update(train=times(z["k3_train"]))
        out.append({"name": name, "route": "cuda",
                    "source": "cagroup3d_tpu_torch/csrc/" + src,
                    "replaces": "cagroup3d_tpu/ops/" + line,
                    **paths["scannet"],
                    "launches": sum(v["launches"] for v in paths.values()),
                    "train_cli_launches": sum(v["train_cli_launches"]
                                              for v in paths.values()),
                    "rbgnet_launches": sum(r[counter] for r in rbg.values()),
                    "second_launches": kitti["launches"][counter],
                    "second_test_cli_launches": kitti["cli_launches"][
                        counter],
                    "second_train_launches": kitti["train_launches"][
                        counter],
                    "second_train_cli_launches": kitti[
                        "cli_train_launches"][counter],
                    "dist_launches": dist[counter],
                    "demo_launches": sum(r["demo_launches"][counter]
                                         for r in res.values()
                                         if r["demo_launches"] is not None),
                    "zoo_launches": sum(v["launches"] for v in zoo.values()),
                    "zoo_train_launches": sum(v["train_launches"]
                                              for v in zoo.values()),
                    "zoo_train_cli_launches": sum(
                        v.get("train_cli_launches", 0) for v in zoo.values()),
                    "max_abs_err": max([err(r) for r in res.values()] + [
                        kitti["max_abs"].get(counter, 0.0)] + [
                        zoo_max_abs(z, counter)
                        for z in kitti["zoo"].values()]),
                    "paths": dict(paths, kitti_second=second, **zoo)})
    return {"kernels": out}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        from cagroup3d_tpu_torch.ops import build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. device ---------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    gpu = torch.cuda.get_device_name(0)
    power = smi[0].split(",")[-1].strip() if smi else "unknown"
    emit({"phase": "device", "ok": True, "gpu": gpu, "power_limit": power,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # 2. build ----------------------------------------------------------
    t0 = time.time()
    from concurrent.futures import ThreadPoolExecutor
    names_cu = ("sparse_conv", "segsum")
    with ThreadPoolExecutor(len(names_cu)) as ex:     # one nvcc per source
        libs = dict(zip(names_cu, (os.path.relpath(p, HERE) for p in
                                   ex.map(build.build, names_cu))))
    for n in libs:
        build.load(n)
    ptxas = {n: [{"kernel": re.sub(r"^_ZN\w+?_cu_[0-9a-f]{8}\d+", "", k),
                  "registers": r, "static_smem": m, "spill_bytes": sp}
                 for k, r, m, sp in build.ptxas_report(n)] for n in libs}
    emit({"phase": "build", "ok": True, "seconds": round(time.time() - t0, 2),
          "libraries": libs, "ptxas": ptxas})

    # 3-10 on each configuration ------------------------------------------
    res = {}
    for path in cagroup_paths():
        res[path.name] = run_path(dev, gpu, power, path)
    # RBGNet on each configuration ----------------------------------------
    rbg = {}
    for path in rbg_paths():
        rbg[path.name] = run_rbg_path(dev, gpu, power, path)
    # SECOND on KITTI ------------------------------------------------------
    kitti = run_kitti_path(dev, gpu, power)
    # training over two ranks, and the CLIs with --dist, beside the learn
    # phases ---------------------------------------------------------------
    learn = LearnJobs()
    try:
        dist = phase_dist(dev, gpu, power)
    except BaseException:
        learn.abort()
        raise
    learn.finish()
    emit(kernel_line(res, rbg, kitti, dist))
    emit({"ok": True, "device": {"platform": "gpu", "kind": gpu,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--learn"]:
            sys.exit(learn_job(sys.argv[2]))
        sys.exit(main())
    except SystemExit:
        raise
    except Exception:  # report any phase's failure and exit non-zero
        traceback.print_exc()
        sys.exit(1)
