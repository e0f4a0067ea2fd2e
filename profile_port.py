#!/usr/bin/env python3
"""Where the time of the PyTorch port's eval forward goes, on one CUDA card.

Run from the repository root on a machine with a CUDA GPU:

    python3 profile_port.py [--config scannet|sunrgbd] [--scenes 9]
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
   kernel ms and kernel launches per scene, K1 and K2 kernel ms per
   scene (every pass of each), the ten largest kernels, and the busy
   share = kernel ms per
   scene / median wall ms of phase 1 (one stream, so kernels do not
   overlap).  Also the peak device memory of the run.
4. train   -- the training step of ``chip_smoke.py`` phase 9 (the YAML's
   BATCH_SIZE_PER_GPU full-width scenes, AdamW): after one warm-up step,
   the host-clock ms of
   ``--train-steps`` steps split into forward (``forward_train`` with the
   losses), ``backward()`` and the optimizer update, each bracketed by
   synchronizations; then ``torch.profiler`` over one step: kernel ms and
   launches per step, K1 and K3 kernel ms (every pass of each) and
   launches, K3's ms per pass (prep, map, scan, fill, gemm, reduce), busy
   share = kernel ms / step ms, the ten largest kernels, and the peak
   device memory.

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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=("scannet", "sunrgbd"),
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
    wall = []
    for i in range(args.scenes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.forward_eval(batches[i % 3], cur_epoch=10)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    emit({"phase": "wall", **card, "ms_per_scene": wall,
          "median_ms": statistics.median(wall)}, log)

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
    from torch.profiler import ProfilerActivity, profile
    n_prof = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for b in batches[:n_prof]:
            model.forward_eval(b, cur_epoch=10)
        torch.cuda.synchronize()
    kernels = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            k = kernels[e.name]
            k[0] += e.time_range.elapsed_us() / 1e3
            k[1] += 1
    total_ms = sum(v[0] for v in kernels.values()) / n_prof
    n_launch = sum(v[1] for v in kernels.values()) / n_prof
    k1 = sum(v[0] for n, v in kernels.items() if K1_NAME in n)
    k2 = sum(v[0] for n, v in kernels.items() if K2_NAME in n)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    emit({"phase": "device", **card, "scenes": n_prof,
          "kernel_ms_per_scene": total_ms if kernels else "not measured",
          "kernel_launches_per_scene": n_launch,
          "k1_ms_per_scene": k1 / n_prof, "k2_ms_per_scene": k2 / n_prof,
          "busy_share": (total_ms / statistics.median(wall)
                         if kernels else "not measured"),
          "top_kernels": [{"name": n[:80], "ms_per_scene": v[0] / n_prof,
                           "launches_per_scene": v[1] / n_prof}
                          for n, v in top],
          "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}, log)

    # 4. train -------------------------------------------------------------
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
    split = defaultdict(list)

    def train_step(batch):
        opt.zero_grad()
        for part in ("forward", "backward", "update", "step"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if part == "forward":
                loss = model.forward_train(batch, gen)[0]
            elif part == "backward":
                loss.backward()
            elif part == "update":
                opt.step()
            torch.cuda.synchronize()
            split[part].append((time.perf_counter() - t0) * 1e3)
        split["step"][-1] = sum(split[k][-1] for k in
                                ("forward", "backward", "update"))

    train_step(tb[0])                                   # warm-up
    split.clear()
    torch.cuda.reset_peak_memory_stats(dev)
    for i in range(args.train_steps):
        train_step(tb[i % 2])
    step_med = statistics.median(split["step"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train_step(tb[1])
        torch.cuda.synchronize()
    kernels = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            k = kernels[e.name]
            k[0] += e.time_range.elapsed_us() / 1e3
            k[1] += 1
    total_ms = sum(v[0] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    k3_pass = defaultdict(float)
    for n, v in kernels.items():
        m = re.search(K3_NAME + r"(\w+)", n)
        if m:
            k3_pass[m.group(1)] += v[0]
    emit({"phase": "train", **card, "scenes_per_step": B,
          "steps": args.train_steps,
          "median_ms": {k: statistics.median(v) for k, v in split.items()},
          "kernel_ms_per_step": total_ms if kernels else "not measured",
          "kernel_launches_per_step": sum(v[1] for v in kernels.values()),
          "k1_ms_per_step": sum(v[0] for n, v in kernels.items()
                                if K1_NAME in n),
          "k3_ms_per_step": sum(v[0] for n, v in kernels.items()
                                if K3_NAME in n),
          "k1_launches_per_step": sum(v[1] for n, v in kernels.items()
                                      if K1_NAME in n),
          "k3_launches_per_step": sum(v[1] for n, v in kernels.items()
                                      if K3_NAME in n),
          "k3_ms_by_pass": dict(k3_pass),
          "busy_share": (total_ms / step_med if kernels
                         else "not measured"),
          "top_kernels": [{"name": n[:80], "ms_per_step": v[0],
                           "launches_per_step": v[1]} for n, v in top],
          "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}, log)

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(log, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
