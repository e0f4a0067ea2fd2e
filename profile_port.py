#!/usr/bin/env python3
"""Where the time of the PyTorch port's eval forward goes, on one CUDA card.

Run from the repository root on a machine with a CUDA GPU:

    python3 profile_port.py [--config scannet|sunrgbd|rbgnet_scannet|
        rbgnet_sunrgbd|kitti_second|kitti_pointpillar|
        kitti_second_multihead|kitti_second_iou|kitti_centerpoint]
        [--scenes 9]
        [--out profile.json]

It builds the configuration of ``chip_smoke.py`` (full-width CAGroup3D of
the ``--config`` YAML -- ScanNet, or SUN RGB-D on headed scenes --,
INPUT_CAP 65536, FINE_CAP 4096, seeded init, semantic gate open, class
prior lifted), answers three warm-up 100k-point scenes (synthetic seeds
0-2), then measures, one JSON line per phase:

1. wall    -- ``forward_eval`` over ``--scenes`` scenes (seeds 0, 1, 2
   cycling), host clock around a synchronized call: ms per scene.
2. stages  -- the same scenes through ``forward_eval`` with each stage
   (voxelize, backbone, dense head, proposals, RoI head) bracketed by
   synchronizations, host clock: median ms per stage.  The proposals
   stage holds the head's greedy NMS, the RoI head stage the final one;
   ``nms_head`` and ``nms_roi`` are those two calls alone.
3. device  -- ``torch.profiler`` over three scenes, CUDA kernel rows only:
   kernel ms and kernel launches per scene, K1, K2 and K3 kernel ms and
   launches per scene (every pass of each), the ten largest kernels, and
   the busy share = kernel ms per scene / median wall ms of phase 1 (one
   stream, so kernels do not overlap).  Also the peak device memory of
   the run.
4. bits    -- two direct ``forward_eval`` calls on scene 0: whether
   their outputs are the same bits and, if not, the first recorded stage
   or float-summing op whose outputs differ, and whether its inputs were
   the same (``two_calls``).  Different bits fail the run (exit 1, after
   the line): every float sum of the eval forward has a fixed order.
5. train   -- the training step of ``chip_smoke.py`` phase 9 (the YAML's
   BATCH_SIZE_PER_GPU full-width scenes, AdamW): after one warm-up step,
   the host-clock ms of
   ``--train-steps`` steps split into forward (``forward_train`` with the
   losses), ``backward()`` and the optimizer update, each bracketed by
   synchronizations; then ``torch.profiler`` over one step: kernel ms and
   launches per step, K1 and K3 kernel ms (every pass of each) and
   launches, K3's ms per pass (prep, map, scan, fill, gemm, reduce), busy
   share = kernel ms / step ms, the ten largest kernels, and the peak
   device memory.

``--config rbgnet_scannet`` / ``rbgnet_sunrgbd`` profiles the YAML's
full-width RBGNet instead (seeded, ``chip_smoke.rbg_model``), with three
warm-up scenes: ``wall`` as above; ``stages``, the median ms of
``chip_smoke.rbg_stage_split`` (backbone and its FPS, vote module with
aggregation and predictions, ray grouping and its FPS, boxes and NMS);
``device`` and ``train`` (the YAML's B = 8 step) as above; none of K1,
K2 and K3 runs on RBGNet's path.

``--config kitti_second`` profiles the KITTI YAML's full-width SECOND of
``chip_smoke.py``'s ``second-requests`` (seeded, class prior lifted) on
three synthetic 120k-point frames (``chip_smoke.kitti_request``), with
three warm-up frames: ``wall``; ``stages``, the median ms and the peak GB
of each stage (vfe, backbone_3d, map_to_bev, backbone_2d, head, boxes:
decode, top-k and NMS), with ``nms`` the greedy NMS alone inside
``boxes`` and ``nms_loop`` its sequential loop (NMS minus its overlap
matrix); ``device``; ``bits``, the two calls' outputs; then ``train``, the YAML's
B = 4 training step of the same model (as users build it: the class prior
not lifted) on synthetic frames with their boxes
(``chip_smoke.kitti_train_batch``), split as above, and ``train_split``,
its forward further split into the assigner (the targets of the B
scenes), the anchor loss without the assigner, and the rest of the
forward (the VFE, both backbones and the head).

``--config kitti_pointpillar``, ``kitti_second_multihead``,
``kitti_second_iou`` and ``kitti_centerpoint`` profile the other KITTI
YAMLs' full-width models of ``chip_smoke.py``'s ``zoo-requests`` and
``zoo-train`` the same way (PointPillar has no ``backbone_3d`` stage).
Their ``boxes`` stage is the model's prediction: SECOND-multihead's per-class NMS over its three
heads; SECOND-IoU's proposals (``proposals`` alone too), IoU head, score
fusion and final NMS, where ``nms`` sums the scene's two NMS calls.  In
SECOND-IoU's ``train_split`` the training proposals (the top 9000 anchors
a scene, NMS at 0.8) are timed per scene, with the NMS alone
(``proposal_nms_ms_per_scene``); the assigner's ms sum every head's.
CenterPoint's ``boxes`` stage is its peak decode (the top 500 peaks) and
one NMS; its assigner is CenterHead's target assignment (the dense
gaussian heatmaps and the regression targets of a scene).

The card's name and power limit are printed first, as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives them.
"""
import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time
from collections import defaultdict

HERE = os.path.dirname(os.path.abspath(__file__))
# kernel-name parts of each kernel's passes (csrc/*.cu): K1 prep, map +
# gather-GEMM and split reduce; K2 head count and run reduce; K3 prep, map,
# scan, fill, GEMM and reduce
K1_NAME, K2_NAME, K3_NAME = "spconv_k1_", "segsum_k2_", "spconv_k3_"


def emit(obj, log):
    log.append(obj)
    print(json.dumps(obj), flush=True)


def timed(fn, name, times):
    """``fn`` with its calls timed between synchronizations into
    ``times[name]`` (ms)."""
    import torch

    def run(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
        return out
    return run


def tensors(x):
    """Every tensor in a nest of dicts, lists, tuples and dataclasses, in
    order."""
    import torch
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    elif hasattr(x, "__dataclass_fields__"):
        x = list(vars(x).values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in tensors(v)]
    return []


def same_bits(a, b):
    """Whether two nests hold the same tensors, bit for bit."""
    import torch
    ta, tb = tensors(a), tensors(b)
    return len(ta) == len(tb) and all(bool(torch.equal(x, y))
                                      for x, y in zip(ta, tb))


def two_calls(model, batch):
    """Two direct ``forward_eval`` calls on one batch, recording the outputs
    (and inputs) of every stage (backbone, dense head, proposals, RoI head)
    and op that sums floats (the backbone's ``avg_pool`` and
    ``interpolate_at``, the head maps' fixed-order ``segment_sum``, K1,
    K2).
    Returns (same bits, None or the first recorded call whose outputs
    differ: its name, index and whether its inputs were the same)."""
    import torch
    from cagroup3d_tpu_torch.core import sparse_conv as core_conv
    from cagroup3d_tpu_torch.core import voxelize as core_vox
    from cagroup3d_tpu_torch.models.backbones_3d import biresnet
    targets = [(biresnet, "avg_pool"), (biresnet, "interpolate_at"),
               (core_conv, "sparse_conv"), (core_vox, "segment_sums"),
               (core_vox, "segment_sum"),
               (model.backbone_3d, "forward"), (model.dense_head, "forward"),
               (model.dense_head, "get_bboxes"), (model.roi_head, "forward")]

    def logged(name, fn, log):
        def call(*a, **kw):
            out = fn(*a, **kw)
            log.append((name, [t.clone() for t in tensors((a, kw))],
                        [t.clone() for t in tensors(out)]))
            return out
        return call

    logs, outs = [], []
    with torch.inference_mode():
        for _ in range(2):
            log = []
            saved = [(o, n, getattr(o, n), n in vars(o)) for o, n in targets]
            for o, n, fn, _ in saved:
                name = f"{type(o).__name__}.{n}" if isinstance(
                    o, torch.nn.Module) else n
                setattr(o, n, logged(name, fn, log))
            try:
                outs.append(model.forward_eval(batch, cur_epoch=10))
            finally:
                for o, n, fn, own in saved:
                    if own:
                        setattr(o, n, fn)
                    else:
                        delattr(o, n)
            logs.append(log)
    if same_bits(outs[0], outs[1]):
        return True, None
    for i, ((name, i0, o0), (_, i1, o1)) in enumerate(zip(*logs)):
        if not same_bits(o0, o1):
            return False, {"call": name, "index": i,
                           "same_inputs": same_bits(i0, i1)}
    return False, None


def kernel_rows(prof):
    """{kernel name: [ms, launches]} of a profile's CUDA kernel rows."""
    kernels = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            k = kernels[e.name]
            k[0] += e.time_range.elapsed_us() / 1e3
            k[1] += 1
    return kernels


def kernel_summary(kernels, n, wall_ms, unit):
    """Kernel ms and launches per ``unit`` (over ``n`` of them), the hand-
    written kernels' ms and launches (K3's ms by pass too), the busy share
    against ``wall_ms`` and the ten largest kernels."""
    total_ms = sum(v[0] for v in kernels.values()) / n
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    hand = {}
    for k, part in (("k1", K1_NAME), ("k2", K2_NAME), ("k3", K3_NAME)):
        rows = [v for name, v in kernels.items() if part in name]
        hand[f"{k}_ms_per_{unit}"] = sum(v[0] for v in rows) / n
        hand[f"{k}_launches_per_{unit}"] = sum(v[1] for v in rows) / n
    k3_pass = defaultdict(float)
    for name, v in kernels.items():
        m = re.search(K3_NAME + r"(\w+)", name)
        if m:
            k3_pass[m.group(1)] += v[0] / n
    return {f"kernel_ms_per_{unit}": total_ms if kernels else "not measured",
            f"kernel_launches_per_{unit}":
                sum(v[1] for v in kernels.values()) / n,
            **hand, "k3_ms_by_pass": dict(k3_pass),
            "busy_share": (total_ms / wall_ms if kernels
                           else "not measured"),
            "top_kernels": [{"name": name[:80], f"ms_per_{unit}": v[0] / n,
                             f"launches_per_{unit}": v[1] / n}
                            for name, v in top]}


def wall_phase(forward, batches, n, card, log):
    """1. wall: ``forward`` over ``n`` scenes (``batches`` cycling), host
    clock around a synchronized call.  Returns the median ms."""
    import torch
    wall = []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward(batches[i % len(batches)])
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(wall)
    emit({"phase": "wall", **card, "ms_per_scene": wall, "median_ms": med},
         log)
    return med


def device_phase(forward, batches, wall_ms, card, dev, log):
    """3. device: ``torch.profiler`` over one ``forward`` of each batch."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for b in batches:
            forward(b)
        torch.cuda.synchronize()
    emit({"phase": "device", **card, "scenes": len(batches),
          **kernel_summary(kernel_rows(prof), len(batches), wall_ms,
                           "scene"),
          "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}, log)


def train_phase(forward, opt, batches, B, steps, card, dev, log):
    """5. train: the ``B``-scene training step whose forward is ``forward``
    (batch -> loss), after one warm-up step: ``steps`` steps split into forward,
    ``backward()`` and the optimizer update, each bracketed by
    synchronizations (host clock), then ``torch.profiler`` over one
    more."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    split = defaultdict(list)

    def train_step(batch):
        opt.zero_grad()
        for part in ("forward", "backward", "update"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if part == "forward":
                loss = forward(batch)
            elif part == "backward":
                loss.backward()
            else:
                opt.step()
            torch.cuda.synchronize()
            split[part].append((time.perf_counter() - t0) * 1e3)
        split["step"].append(sum(split[k][-1] for k in
                                 ("forward", "backward", "update")))

    train_step(batches[0])                              # warm-up
    split.clear()
    torch.cuda.reset_peak_memory_stats(dev)
    for i in range(steps):
        train_step(batches[i % len(batches)])
    med = {k: statistics.median(v) for k, v in split.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train_step(batches[-1])
        torch.cuda.synchronize()
    emit({"phase": "train", **card,
          "scenes_per_step": B,
          "steps": steps, "median_ms": med,
          **kernel_summary(kernel_rows(prof), 1, med["step"], "step"),
          "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}, log)


def profile_rbgnet(args, card, dev, log):
    """The ``--config rbgnet_*`` phases (module docstring)."""
    import torch
    from chip_smoke import (N_POINTS, RBG_CFGS, STEPS_PER_EPOCH, rbg_model,
                            rbg_stage_split, synthetic_train_batch)
    from cagroup3d_tpu_torch.models import load_config
    from cagroup3d_tpu_torch.training.optimization import build_optimizer
    from cagroup3d_tpu_torch.utils.synthetic import synthetic_request
    dataset = args.config.split("_", 1)[1]
    cfg = load_config(RBG_CFGS[dataset])
    names = cfg.CLASS_NAMES
    model = rbg_model(cfg.MODEL, len(names), dev, seed=0)
    scene = dict(n_classes=len(names),
                 yaw=bool(cfg.MODEL.POINT_HEAD.BOX_CODER.WITH_ROT))
    batches = [synthetic_request(s, dev, N_POINTS, **scene)
               for s in (0, 1, 2)]
    for b in batches:                                   # warm-up
        model.forward_eval(b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    wall_med = wall_phase(model.forward_eval, batches, args.scenes, card,
                          log)
    splits = [rbg_stage_split(model, batches[i % 3])
              for i in range(args.scenes)]
    emit({"phase": "stages", **card, "scenes": args.scenes,
          "median_ms": {k: statistics.median(s[k] for s in splits)
                        for k in splits[0]}}, log)
    device_phase(model.forward_eval, batches, wall_med, card, dev, log)

    opt, _ = build_optimizer(model, cfg.OPTIMIZATION, STEPS_PER_EPOCH)
    B = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    tb = [synthetic_train_batch(20 + i, dev, B, N_POINTS, **scene)
          for i in range(2)]
    train_phase(lambda b: model.forward_train(b)[0], opt, tb, B,
                args.train_steps, card, dev, log)
    return log


def kitti_model(name, cfg, dev, lift):
    """The ``--config kitti_<name>`` model of ``chip_smoke.py`` (seeded;
    ``lift``: the class prior lifted)."""
    from chip_smoke import second_model, zoo_model
    if name == "second":
        return second_model(cfg, dev, seed=0, lift=lift)
    return zoo_model(name, cfg, dev, seed=0, lift=lift)


def profile_second(args, card, dev, log):
    """The ``--config kitti_*`` phases (module docstring)."""
    import torch
    from chip_smoke import ZOO_CFGS, kitti_config, kitti_request
    from cagroup3d_tpu_torch.core import nms as nms_mod
    from cagroup3d_tpu_torch.core.module import Ctx, flat_state
    from cagroup3d_tpu_torch.models import load_config
    name = args.config[len("kitti_"):]
    cfg = kitti_config() if name == "second" else load_config(
        ZOO_CFGS[name])
    model = kitti_model(name, cfg, dev, lift=True)
    batches = [kitti_request(cfg, s, dev) for s in (0, 1, 2)]
    for b in batches:                                   # warm-up
        model.forward_eval(b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    wall_med = wall_phase(model.forward_eval, batches, args.scenes, card,
                          log)

    times, peaks = defaultdict(list), defaultdict(list)

    def staged(fn, name):
        def run(*a, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            peaks[name].append(torch.cuda.max_memory_allocated(dev) / 1e9)
            return out
        return run

    mods = [(m, n) for m, n in (
        (model.vfe, "vfe"), (model.backbone_3d, "backbone_3d"),
        (model.map_to_bev_module, "map_to_bev"),
        (model.backbone_2d, "backbone_2d"), (model.dense_head, "head"))
        if m is not None]
    saved = (nms_mod.greedy_nms, nms_mod.overlap_matrix)
    for mod, mname in mods:
        mod.forward = staged(mod.forward, mname)
    # boxes: decode, top-k and NMS (SECOND-IoU: its proposals, the IoU
    # head, the score fusion and the final NMS; ``proposals`` alone too)
    model.predict = staged(model.predict, "boxes")
    if hasattr(model, "proposals"):
        model.proposals = staged(model.proposals, "proposals")
    nms_mod.greedy_nms = timed(saved[0], "nms", times)
    nms_mod.overlap_matrix = timed(saved[1], "nms_overlap_matrix", times)
    try:
        with torch.no_grad(), model.bits_scope():
            P, S = flat_state(model)
            for i in range(args.scenes):
                b = batches[i % 3]
                pts, pv = b["points"][0], b["points_valid"][0]
                out, bev2d = model.forward_scene(P, S, Ctx(), pts, pv)
                model.predict(P, S, Ctx(), out, bev2d, pts, pv)
    finally:
        for mod, _ in mods:
            del mod.__dict__["forward"]
        for k in ("predict", "proposals"):
            model.__dict__.pop(k, None)
        nms_mod.greedy_nms, nms_mod.overlap_matrix = saved
    # per scene: SECOND-IoU runs two NMS calls a scene (its proposals and
    # the final one), the others one
    calls = len(times["nms"]) // args.scenes
    nms_scene = [sum(times["nms"][i * calls:(i + 1) * calls])
                 for i in range(args.scenes)]
    med = {k: statistics.median(v) for k, v in times.items()}
    med["nms"] = statistics.median(nms_scene)
    med["nms_loop"] = med["nms"] - calls * med["nms_overlap_matrix"]
    emit({"phase": "stages", **card, "scenes": args.scenes,
          "median_ms": med, "nms_calls_per_scene": calls,
          "peak_gb": {k: max(v) for k, v in peaks.items()},
          "sum_of_stage_medians_ms": sum(med[n] for _, n in mods) +
          med["boxes"], "nms_share_of_wall": med["nms"] / wall_med}, log)
    device_phase(model.forward_eval, batches, wall_med, card, dev, log)
    outs = [model.forward_eval(batches[0]) for _ in range(2)]
    same = same_bits(outs[0], outs[1])
    emit({"phase": "bits", **card, "two_calls_same_bits": same}, log)
    del model, outs
    torch.cuda.empty_cache()
    profile_second_train(args, name, cfg, card, dev, log)
    return 0 if same else 1


def profile_second_train(args, name, cfg, card, dev, log):
    """``train`` and ``train_split`` of ``--config kitti_*``."""
    import torch
    from chip_smoke import (KITTI_POINTS, STEPS_PER_EPOCH, anchor_tables,
                            kitti_train_batch)
    from cagroup3d_tpu_torch.core import nms as nms_mod
    from cagroup3d_tpu_torch.training.optimization import build_optimizer
    model = kitti_model(name, cfg, dev, lift=False)
    opt, _ = build_optimizer(model, cfg.OPTIMIZATION, STEPS_PER_EPOCH,
                             total_epochs=int(cfg.OPTIMIZATION.NUM_EPOCHS))
    B = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    tb = [kitti_train_batch(cfg, range(20 + B * i, 20 + B * (i + 1)), dev,
                            KITTI_POINTS) for i in range(2)]
    head, inner = model.dense_head, defaultdict(list)
    # the target assigners: each anchor table's, or CenterHead's targets
    tables = [(t, "assign_targets") for t in anchor_tables(model)] or \
        [(head, "assign_targets_single")]
    for t, meth in tables:
        setattr(t, meth, timed(getattr(t, meth), "assigner", inner))
    head.loss = timed(head.loss, "loss", inner)
    saved_nms = nms_mod.greedy_nms
    if hasattr(model, "proposals"):
        # SECOND-IoU's training proposals: the top 9000 anchors a scene
        # through the greedy NMS
        model.proposals = timed(model.proposals, "proposals", inner)
        nms_mod.greedy_nms = timed(saved_nms, "proposal_nms", inner)
    gen = torch.Generator().manual_seed(0)
    try:
        train_phase(lambda b: model.forward_train(b, gen)[0], opt, tb, B,
                    args.train_steps, card, dev, log)
    finally:
        for t, meth in tables:
            t.__dict__.pop(meth, None)
        del head.__dict__["loss"]
        model.__dict__.pop("proposals", None)
        nms_mod.greedy_nms = saved_nms
    # the first calls are the warm-up step's, the last the profiled step's
    n = len(tables) * B
    steps = [slice(i * n, (i + 1) * n) for i in range(1, args.train_steps +
                                                       1)]
    assigner = [sum(inner["assigner"][s]) for s in steps]
    loss = [inner["loss"][i] - a for i, a in zip(range(1, len(steps) + 1),
                                                  assigner)]
    med = {"assigner": statistics.median(assigner),
           "loss_without_assigner": statistics.median(loss)}
    extra = {}
    if "proposals" in inner:
        per = [inner[k][B:B * (args.train_steps + 1)]
               for k in ("proposals", "proposal_nms")]
        med["proposals_per_step"] = statistics.median(
            sum(per[0][i * B:(i + 1) * B]) for i in range(args.train_steps))
        extra = {"proposals_ms_per_scene": per[0],
                 "proposal_nms_ms_per_scene": per[1]}
    # a step's assigner calls run head by head, scene by scene
    per_scene = [sum(inner["assigner"][s.start + h * B + j]
                     for h in range(len(tables)))
                 for s in steps for j in range(B)]
    emit({"phase": "train_split", **card, "scenes_per_step": B,
          "median_ms": med, "assigner_ms_per_scene": per_scene, **extra},
         log)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=("scannet", "sunrgbd",
                                         "rbgnet_scannet", "rbgnet_sunrgbd",
                                         "kitti_second", "kitti_pointpillar",
                                         "kitti_second_multihead",
                                         "kitti_second_iou",
                                         "kitti_centerpoint"),
                    default="scannet")
    ap.add_argument("--scenes", type=int, default=9)
    ap.add_argument("--train-steps", type=int, default=3)
    ap.add_argument("--out", default=None,
                    help="also write every phase's JSON to this file")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_port: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from chip_smoke import CFGS, FINE_CAP, INPUT_CAP, N_POINTS, build_model
    from cagroup3d_tpu_torch.models import load_config
    from cagroup3d_tpu_torch.models.dense_heads import cagroup_head
    from cagroup3d_tpu_torch.models.roi_heads import cagroup_roi_head
    from cagroup3d_tpu_torch.utils.synthetic import synthetic_request
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log = []

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    card = dict(gpu=torch.cuda.get_device_name(0),
                power_limit=smi[0].split(",")[-1].strip() if smi else None)

    if args.config.startswith("rbgnet_"):
        card["config"] = args.config
        profile_rbgnet(args, card, dev, log)
        return write(log, args.out)
    if args.config.startswith("kitti_"):
        card["config"] = args.config
        rc = profile_second(args, card, dev, log)
        write(log, args.out)
        return rc
    cfg = load_config(CFGS[args.config])
    mc, names = cfg.MODEL, cfg.CLASS_NAMES
    mc.INPUT_CAP = INPUT_CAP
    mc.DENSE_HEAD.FINE_CAP = FINE_CAP
    model = build_model(mc, len(names), dev, seed=0)
    scene = dict(n_classes=len(names), yaw=bool(mc.DENSE_HEAD.WITH_YAW))
    card["config"] = args.config
    batches = [synthetic_request(s, dev, N_POINTS, **scene)
               for s in (0, 1, 2)]
    for b in batches:                                   # warm-up
        model.forward_eval(b, cur_epoch=10)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    # 1. wall -------------------------------------------------------------
    def forward(b):
        return model.forward_eval(b, cur_epoch=10)
    wall_med = wall_phase(forward, batches, args.scenes, card, log)

    # 2. stages -------------------------------------------------------------
    times = defaultdict(list)
    saved = dict(head_nms=cagroup_head.multiclass_nms,
                 roi_nms=cagroup_roi_head.multiclass_nms)
    model._voxelize_scene = timed(model._voxelize_scene, "voxelize", times)
    for mod, name in ((model.backbone_3d, "backbone"),
                      (model.dense_head, "dense_head"),
                      (model.roi_head, "roi_head")):
        mod.forward = timed(mod.forward, name, times)
    model.dense_head.get_bboxes = timed(model.dense_head.get_bboxes,
                                        "proposals", times)
    cagroup_head.multiclass_nms = timed(saved["head_nms"], "nms_head", times)
    cagroup_roi_head.multiclass_nms = timed(saved["roi_nms"], "nms_roi",
                                            times)
    try:
        for i in range(args.scenes):
            model.forward_eval(batches[i % 3], cur_epoch=10)
    finally:                       # drop the instance-level wrappers
        del model.__dict__["_voxelize_scene"]
        for mod in (model.backbone_3d, model.dense_head, model.roi_head):
            del mod.__dict__["forward"]
        del model.dense_head.__dict__["get_bboxes"]
        cagroup_head.multiclass_nms = saved["head_nms"]
        cagroup_roi_head.multiclass_nms = saved["roi_nms"]
    med = {k: statistics.median(v) for k, v in times.items()}
    stage_sum = sum(med[k] for k in ("voxelize", "backbone", "dense_head",
                                     "proposals", "roi_head"))
    emit({"phase": "stages", **card, "scenes": args.scenes,
          "median_ms": med, "sum_of_stage_medians_ms": stage_sum}, log)

    # 3. device -------------------------------------------------------------
    device_phase(forward, batches, wall_med, card, dev, log)

    # 4. bits -------------------------------------------------------------
    same, apart = two_calls(model, batches[0])
    emit({"phase": "bits", **card, "two_calls_same_bits": same,
          "first_apart": apart}, log)
    if not same:
        write(log, args.out)
        print("profile_port: two forward_eval calls on one batch give "
              "different bits", file=sys.stderr)
        return 1

    # 5. train -------------------------------------------------------------
    from chip_smoke import STEPS_PER_EPOCH, open_gate, synthetic_train_batch
    from cagroup3d_tpu_torch.models.model_utils.cagroup_utils import \
        bias_init_with_prob
    from cagroup3d_tpu_torch.training.optimization import build_optimizer
    with torch.no_grad():           # chip_smoke.py's training settings
        model.dense_head.cls_conv.bias.fill_(bias_init_with_prob(0.01))
    open_gate(model, train=True)
    model.roi_gt_aug = 0.05
    opt, _ = build_optimizer(model, cfg.OPTIMIZATION, STEPS_PER_EPOCH)
    gen = torch.Generator().manual_seed(1)
    B = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    tb = [synthetic_train_batch(20 + i, dev, B, N_POINTS, **scene)
          for i in range(2)]
    train_phase(lambda b: model.forward_train(b, gen)[0], opt, tb, B,
                args.train_steps, card, dev, log)
    return write(log, args.out)


def write(log, out):
    """Every phase's JSON to ``out`` too, when given."""
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(log, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
