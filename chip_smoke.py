#!/usr/bin/env python3
"""GPU smoke of the PyTorch port: CAGroup3D eval and training on one NVIDIA
card, ScanNet and then SUN RGB-D (the yaw path).

Run from the repository root on a machine with a CUDA GPU:

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits 1 without the final line.
Phases 3-11 (7b among them) run once per configuration (``Path``): first
tools/cfgs/scannet_models/CAGroup3D.yaml, then
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
7b. test-cli -- the eval entry point: a synthetic tree of eight 100k-point
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
   100k-point scenes per step (ScanNet 4, SUN RGB-D 8): one warm-up and
   TRAIN_STEPS (ScanNet) or TRAIN_STEPS_YAW timed steps with the launch
   counters reset before them; loss and tb finite (the yaw path's
   ``rcnn_loss_iou`` among them), every backbone, head and RoI
   parameter's gradient finite and each module's non-zero, parameters and
   BN running stats changed, K1 and K3 launched; peak memory.
10. train-reference -- one training step of the tiny configuration at
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
   from ``tests/learn_margin.py [--yaw]``).

The line before the last is {"kernels": [...]}: per kernel the launches of
both paths' main-path runs summed, the ScanNet path's times and each
path's own under ``paths``.  The last is {"ok": true, "device": {...}}.
"""
import copy
import json
import os
import re
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
CFGS = {name: os.path.join(HERE, "tools", "cfgs", f"{name}_models",
                           "CAGroup3D.yaml") for name in ("scannet", "sunrgbd")}
CFG = CFGS["scannet"]
INPUT_CAP, FINE_CAP, N_POINTS = 65536, 4096, 100_000
TOL, ROW_TOL = 2e-2, 1e-3
TRAIN_STEPS, TRAIN_STEPS_YAW, LEARN_STEPS = 3, 2, 30
TEST_CLI_SCENES = 8
NEEDED = ("a_", "b_", "c_", "d_", "e_", "f_")    # the main-path forms
STEPS_PER_EPOCH = 1000          # no LR decay step inside these runs
# the drop, 1 - last / first loss, that the JAX package's step makes on
# the CPU in the learn setting (tests/learn_margin.py; the port's CPU step
# made 0.3653 in the same run); the random streams of the two packages
# differ, so the card must reach nine tenths of it
JAX_LEARN_DROP = 0.3663
# the same for the SUN RGB-D configuration on headed scenes
# (tests/learn_margin.py --yaw; the port's CPU step made 0.2190)
JAX_LEARN_DROP_YAW = 0.2285
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


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(phase, msg):
    emit({"phase": phase, "ok": False, "error": msg})
    raise SystemExit(1)


def time_ms(fn, reps):
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


def grad_report(model_a, model_b, prefix):
    """Per-parameter gradient errors of model_a against model_b under
    ``prefix``: (worst name, worst relative error in norm, number
    compared, whole-vector relative error, cosine).  A gradient below
    1e-4 of the group's largest norm (a BN bias whose gradient the next BN
    cancels) is round-off on both sides and is held only to that floor."""
    import torch
    ga = {k: p.grad.detach().double().cpu() for k, p in
          model_a.named_parameters() if k.startswith(prefix)}
    gb = {k: p.grad.detach().double().cpu() for k, p in
          model_b.named_parameters() if k.startswith(prefix)}
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


def replay(calls, forms, run, plain, info, reps_plain, library):
    """Replay recorded calls with the kernel and the plain version on the
    same inputs and gather per-form stats: errors (``rel_err``,
    ``row_err``), zero rows, sorted sources, whether a second kernel call
    gives the same bits, CUDA-event ms of both, the bound ms and the
    library yardstick's ms (``library(args, kw)``).  ``info(args, kw)`` ->
    (zero-row mask or None, source tables that must be key-sorted, (bytes,
    FLOPs), shape dict with the launch's plan)."""
    import torch
    stats = {}
    with torch.no_grad():
        for (args, kw), form in zip(calls, forms):
            got, ref = run(*args, **kw), plain(*args, **kw)
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
            f["plain_ms"] += time_ms(lambda: plain(*args, **kw), reps_plain)
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
                       sparse_conv, sparse_conv_plain, k1_info, 2,
                       library_conv_ms)
    dfe_stats = replay(dfe_calls, bwd_forms(
        dfe_calls, lambda a: (a[4].shape[0], a[3], len(a) > 5 and
                              a[5] is not None)),
        sparse_conv_dfeats, sparse_conv_dfeats_plain, dfeats_info, 2,
        dfeats_library_ms)
    dw_stats = replay(dw_calls, bwd_forms(
        dw_calls, lambda a: (a[2].shape[0], a[4], len(a) > 6 and
                             a[6] is not None)),
        sparse_conv_dw, sparse_conv_dw_plain, dw_info, 2, library_dw_ms)
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
    from cagroup3d_tpu_torch.ops.segsum import segment_sums
    from cagroup3d_tpu_torch.ops.sparse_conv import sparse_conv, sparse_conv_dw
    from cagroup3d_tpu_torch.parallel.mesh import make_train_step
    from cagroup3d_tpu_torch.training.optimization import build_optimizer
    opt_cfg = path.cfg.OPTIMIZATION
    B = int(opt_cfg.BATCH_SIZE_PER_GPU)
    opt, _ = build_optimizer(model, opt_cfg, STEPS_PER_EPOCH)
    step = make_train_step(model, opt, torch.Generator().manual_seed(1),
                           device=dev)
    batches = [synthetic_train_batch(20 + i, dev, B, n_points, **path.scene)
               for i in range(path.train_steps + 1)]
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    step(batches[0], 0.0)                                      # warm-up
    torch.cuda.synchronize()
    sparse_conv.launches = sparse_conv_dw.launches = 0
    segment_sums.launches = 0
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses, tbs = [], [], []
    for b in batches[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, tb = step(b, 0.0)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        tbs.append({k: float(v) for k, v in tb.items()})
    train_launches = {"sparse_conv": sparse_conv.launches,
                      "sparse_conv_dw": sparse_conv_dw.launches,
                      "segsum": segment_sums.launches}
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
          changed["buffers"] > 0 and train_launches["sparse_conv"] > 0 and
          train_launches["sparse_conv_dw"] > 0)
    emit({"phase": "train", "config": path.name, "ok": ok, "gpu": gpu,
          "power_limit": power, "scenes_per_step": B,
          "points_per_scene": n_points,
          "steps": path.train_steps, "ms_per_step": step_ms,
          "median_ms": sorted(step_ms)[len(step_ms) // 2],
          "peak_memory_gb": peak_gb, "losses": losses, "tb": tbs[-1],
          "grad_norm_by_module": {k: g_["sq"] ** 0.5
                                  for k, g_ in groups.items()},
          "zero_grad_params": {k: g_["zero"] for k, g_ in groups.items()},
          "changed": changed, "launches": train_launches})
    if path.yaw and not all("rcnn_loss_iou" in t for t in tbs):
        fail("train", "the yaw path's RoI IoU loss is missing")
    if not ok:
        fail("train", "non-finite loss or gradients, a module without "
                      "gradient, nothing updated, or K1/K3 not launched")
    return train_launches


def phase_train_reference(dev, path):
    """Phase 10: the tiny training step on the card against the CPU."""
    import torch
    ttc, names, _ = tiny_train_config(path.cfg_path)
    n_names = len(names)
    cpu_m = build_model(ttc, n_names, "cpu", seed=1, train=True)
    with torch.no_grad():
        # zero votes: a voted point floors into its per-class voxel, and
        # one f32 ulp of a random vote (the card sums BN statistics in
        # another order) moves boundary points into other voxels, so the
        # two devices would train on different class maps
        cpu_m.get_parameter("dense_head.offset_block.6.kernel").zero_()
    gpu_m = copy.deepcopy(cpu_m).to(dev)
    tb_cpu = synthetic_train_batch(11, "cpu", 2, **path.scene,
                                   **TINY_TRAIN_SCENE)
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
    reports, ok = {}, loss_rel < 1e-3
    for pre in ("backbone_3d.", "dense_head.", "roi_head."):
        card, noise = grad_report(gpu_m, cpu_m, pre), \
            grad_report(pert_m, cpu_m, pre)
        card["noise_worst_rel"] = noise["worst_rel"]
        card["noise_vector_rel"] = noise["vector_rel"]
        card["ok"] = (card["floor_ok"] and
                      card["worst_rel"] <= max(TOL, 2 * noise["worst_rel"])
                      and card["vector_rel"] <=
                      max(TOL, 2 * noise["vector_rel"]))
        ok &= card["ok"]
        reports[pre] = card
    emit({"phase": "train-reference", "config": path.name, "ok": ok,
          "scenes": 2,
          "loss_cpu": res["cpu"][0], "loss_gpu": res["gpu"][0],
          "loss_rel": loss_rel, "tb_cpu": res["cpu"][1],
          "tb_gpu": res["gpu"][1], "grads": reports})
    if not ok:
        fail("train-reference", "card and CPU training steps disagree")
    return ttc, n_names, tb_cpu


def phase_learn(dev, ttc, n_names, batch, path):
    """Phase 11: the tiny model's loss falls on one fixed batch."""
    import torch
    from cagroup3d_tpu_torch.parallel.mesh import make_train_step
    from cagroup3d_tpu_torch.training.optimization import build_optimizer
    learn_m = build_model(ttc, n_names, "cpu", seed=1, train=True).to(dev)
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
    and the JAX package's learn drop."""

    def __init__(self, name, train_steps, jax_learn_drop):
        from cagroup3d_tpu_torch.models import load_config
        self.name, self.cfg_path = name, CFGS[name]
        self.cfg = load_config(self.cfg_path)
        self.n_cls = len(self.cfg.CLASS_NAMES)
        self.yaw = bool(self.cfg.MODEL.DENSE_HEAD.WITH_YAW)
        self.scene = dict(n_classes=self.n_cls, yaw=self.yaw)
        self.train_steps, self.jax_learn_drop = train_steps, jax_learn_drop

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
                   sparse_conv, sparse_conv_plain, k1_info, 2,
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
    from cagroup3d_tpu_torch.ops.segsum import segment_sums
    from cagroup3d_tpu_torch.ops.sparse_conv import sparse_conv
    from cagroup3d_tpu_torch.utils.synthetic import synthetic_request
    sparse_conv.launches = 0
    segment_sums.launches = 0
    lat_ms, outs = [], []
    for seed in (0, 1, 2):
        batch = synthetic_request(seed, dev, N_POINTS, **path.scene)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.forward_eval(batch, cur_epoch=10)
        torch.cuda.synchronize()
        lat_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    launches = {"sparse_conv": sparse_conv.launches,
                "segsum": segment_sums.launches}
    R = model.roi_head.max_out
    for out in outs:
        if tuple(out["pred_boxes"].shape) != (1, R, 7) or \
                tuple(out["pred_scores"].shape) != (1, R):
            fail("requests", f"bad output shapes "
                             f"{ {k: tuple(v.shape) for k, v in out.items()} }")
        if not all(bool(torch.isfinite(v.float()).all()) for v in out.values()):
            fail("requests", "non-finite outputs")
    if min(launches.values()) <= 0:
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


def phase_test_cli(dev, gpu, power, path):
    """Phase 7b: the ``test`` CLI (``cagroup3d_tpu_torch.tools.test``) in
    this process on a synthetic tree of TEST_CLI_SCENES 100k-point scenes
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
    of the tree; K1 and K2 launched.  Printed only: whether two direct
    calls on one batch give the same bits (``profile_port.py``'s ``bits``
    phase finds the first op apart)."""
    import pickle
    import tempfile
    import numpy as np
    import torch
    from cagroup3d_tpu_torch.models.detectors.cagroup3d import CAGroup3D
    from cagroup3d_tpu_torch.ops.segsum import segment_sums
    from cagroup3d_tpu_torch.ops.sparse_conv import sparse_conv
    from cagroup3d_tpu_torch.tools import test as cli
    from cagroup3d_tpu_torch.training.checkpoint import save_checkpoint
    from cagroup3d_tpu_torch.utils.synthetic import (points_in_boxes,
                                                     write_indoor_tree)
    names = list(path.cfg.CLASS_NAMES)
    calls, batches, loaders, harness_s = [], [], [], []
    forward, build_loader, evaluate = (CAGroup3D.forward_eval,
                                       cli.build_dataloader,
                                       cli.eval_one_epoch)

    def recorded(self, batch, cur_epoch=None):
        t0 = time.perf_counter()
        out = forward(self, batch, cur_epoch=cur_epoch)
        torch.cuda.synchronize()
        calls.append((self, dict(batch), dict(out),
                      (time.perf_counter() - t0) * 1e3))
        return out

    class Recording:
        """The CLI's loader, keeping each batch and the time the harness
        waits for it."""

        def __init__(self, loader):
            self.loader, self.wait_s = loader, 0.0

        def __len__(self):
            return len(self.loader)

        def __iter__(self):
            it = iter(self.loader)
            while True:
                t0 = time.perf_counter()
                try:
                    b = next(it)
                except StopIteration:
                    return
                self.wait_s += time.perf_counter() - t0
                batches.append(b)
                yield b

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
        counts = write_indoor_tree(tree, path.name, names, TEST_CLI_SCENES,
                                   n_points=N_POINTS, seed=0)
        ckpt = os.path.join(tmp, "checkpoint_epoch_10.pkl")
        save_checkpoint(ckpt, build_model(copy.deepcopy(path.cfg.MODEL),
                                          path.n_cls, dev, seed=0))
        torch.cuda.empty_cache()
        args, cfg = cli.parse_config(["--cfg_file", path.cfg_path, "--ckpt",
                                      ckpt, "--set", "DATA_CONFIG.DATA_PATH",
                                      tree])
        CAGroup3D.forward_eval = recorded
        cli.build_dataloader, cli.eval_one_epoch = recording_loader, timed
        sparse_conv.launches = 0
        segment_sums.launches = 0
        try:
            os.chdir(tmp)
            ret = cli.main(args, cfg)[ckpt]
        finally:
            os.chdir(cwd)
            CAGroup3D.forward_eval = forward
            cli.build_dataloader, cli.eval_one_epoch = build_loader, evaluate
        launches = {"sparse_conv": sparse_conv.launches,
                    "segsum": segment_sums.launches}
        eval_dir = os.path.join(tmp, "output", cfg.EXP_GROUP_PATH, cfg.TAG,
                                args.extra_tag, "eval")
        with open(os.path.join(eval_dir, "result.pkl"), "rb") as f:
            det = pickle.load(f)
    dataset, loader = loaders[0]
    bad = []
    if not len(det) == len(calls) == len(batches) == TEST_CLI_SCENES:
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
    if min(launches.values()) <= 0:
        bad.append(f"a kernel was not launched: {launches}")
    with torch.inference_mode():
        two = [calls[0][0].forward_eval(calls[0][1], cur_epoch=10)
               for _ in range(2)]
    two_same = all(torch.equal(two[0][k], two[1][k]) for k in two[0])
    ms = harness_s[0] * 1e3 / TEST_CLI_SCENES
    emit({"phase": "test-cli", "config": path.name, "ok": not bad,
          "gpu": gpu, "power_limit": power, "scenes": len(det),
          "points_per_scene": N_POINTS, "batch_size": 1,
          "ms_per_scene": ms, "loader_share": loader.wait_s / harness_s[0],
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
        fail("test-cli", "; ".join(bad))


def run_path(dev, gpu, power, path):
    """Phases 3-11 (with 7b) on one configuration at full width.  Returns what the
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

    # 8-11. the training step
    model.roi_gt_aug = 0.05        # see tiny_train_config
    with torch.no_grad():           # the prior back (see build_model)
        model.dense_head.cls_conv.bias.fill_(bias_init_with_prob(0.01))
    open_gate(model, train=True)
    k1_train, k3_train = phase_k3(model, dev, NEEDED, path)
    train_launches = phase_train(model, dev, gpu, power, path)
    del model
    torch.cuda.empty_cache()
    ttc, n_names, tiny_batch = phase_train_reference(dev, path)
    phase_learn(dev, ttc, n_names, tiny_batch, path)
    return dict(k1_eval=k1_eval, k1_eval_max_abs=max(
        f["max_abs"] for f in forms.values()), k2=k2_stats,
        eval_launches=eval_launches, k1_train=k1_train, k3_train=k3_train,
        train_launches=train_launches)


def kernel_line(res):
    """The ``kernels`` line: each kernel's launches summed over the paths'
    main-path runs (K1, K3: the timed training steps; K2: the requests),
    its largest error over every replay, and its times from the ScanNet
    path, with each path's own beside them."""
    def times(st):
        return {k: st[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")}

    def k1(r):
        return dict(times(r["k1_train"]), eval_ms=r["k1_eval"]["ms"],
                    eval_bound_ms=r["k1_eval"]["bound_ms"],
                    eval_library_ms=r["k1_eval"]["library_ms"],
                    launches=r["train_launches"]["sparse_conv"])

    def k2(r):
        return dict(times(r["k2"]), launches=r["eval_launches"]["segsum"])

    def k3(r):
        return dict(times(r["k3_train"]),
                    launches=r["train_launches"]["sparse_conv_dw"])

    out = []
    for name, fn, src, line, err in (
            ("K1 sparse_conv", k1, "sparse_conv.cu", "pallas_conv.py:124",
             lambda r: max(r["k1_train"]["max_abs"], r["k1_eval_max_abs"])),
            ("K2 segsum", k2, "segsum.cu", "pallas_segsum.py:64",
             lambda r: r["k2"]["max_abs"]),
            ("K3 sparse_conv_dw", k3, "sparse_conv.cu", "pallas_conv.py:472",
             lambda r: r["k3_train"]["max_abs"])):
        paths = {p: fn(r) for p, r in res.items()}
        out.append({"name": name, "route": "cuda",
                    "source": "cagroup3d_tpu_torch/csrc/" + src,
                    "replaces": "cagroup3d_tpu/ops/" + line,
                    **paths["scannet"],
                    "launches": sum(v["launches"] for v in paths.values()),
                    "max_abs_err": max(err(r) for r in res.values()),
                    "paths": paths})
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

    # 3-11 on each configuration ------------------------------------------
    res = {}
    for path in (Path("scannet", TRAIN_STEPS, JAX_LEARN_DROP),
                 Path("sunrgbd", TRAIN_STEPS_YAW, JAX_LEARN_DROP_YAW)):
        res[path.name] = run_path(dev, gpu, power, path)
    emit(kernel_line(res))
    emit({"ok": True, "device": {"platform": "gpu", "kind": gpu,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except Exception:  # report any phase's failure and exit non-zero
        traceback.print_exc()
        sys.exit(1)
