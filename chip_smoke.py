#!/usr/bin/env python3
"""GPU smoke of the PyTorch port: ScanNet CAGroup3D eval on one NVIDIA card.

Run from the repository root on a machine with a CUDA GPU:

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits 1 without the final line.

1. device  -- CUDA must be available; prints the card's name and power limit
   as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``.
2. build   -- compiles the hand-written kernels (csrc/*.cu) with nvcc.
3. warm-up -- builds the full-width ScanNet CAGroup3D from
   tools/cfgs/scannet_models/CAGroup3D.yaml (INPUT_CAP 65536, FINE_CAP 4096,
   seeded init, semantic gate open, class prior lifted so the RoI head gets
   proposals) and answers one 100k-point request, recording the inputs of
   every K1 (sparse conv) and K2 (segment sum) call.
4. k1      -- every recorded K1 call, kernel against its plain PyTorch
   version on the same inputs, grouped by main-path form (a)-(f); bars:
   relative error < 2e-2 of the output's largest magnitude, per-row error
   < 1e-3 (see ``row_err``), invalid query rows exactly 0, and every
   source table key-sorted with invalid rows last (the kernel's contract).
5. k2      -- the recorded (overflowing) K2 call and a non-overflowing one
   at G=18, P=65536, F=64, cap=4096; counts exact, sums within both bars.
6. requests -- launch counters reset, three 100k-point scenes (synthetic
   seeds 0, 1, 2) through ``forward_eval``; outputs finite with the
   expected shapes, both kernels launched; per-scene latency.
7. reference -- a tiny configuration's forward on the card (kernels)
   against the same model on the CPU (plain versions).

The line before the last is {"kernels": [...]}, the last is
{"ok": true, "device": {...}}.
"""
import copy
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(HERE, "tools", "cfgs", "scannet_models", "CAGroup3D.yaml")
INPUT_CAP, FINE_CAP, N_POINTS = 65536, 4096, 100_000
TOL, ROW_TOL = 2e-2, 1e-3


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


def build_model(mc, n_cls, device, seed):
    import torch
    from cagroup3d_tpu_torch.models import build_network
    m = build_network(mc, n_cls, generator=torch.Generator().manual_seed(seed),
                      device=device)
    with torch.no_grad():
        m.dense_head.semantic_conv.bias.fill_(5.0)   # the gate opens
        m.dense_head.cls_conv.bias.fill_(2.0)        # proposals for the RoI head
    return m


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


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        from cagroup3d_tpu_torch.core import sparse_conv as core_conv
        from cagroup3d_tpu_torch.core import voxelize as core_vox
        from cagroup3d_tpu_torch.models import load_model_config
        from cagroup3d_tpu_torch.ops import build
        from cagroup3d_tpu_torch.ops.segsum import (segment_sums,
                                                    segment_sums_plain)
        from cagroup3d_tpu_torch.ops.sparse_conv import (sources_sorted,
                                                         sparse_conv,
                                                         sparse_conv_plain)
        from cagroup3d_tpu_torch.core.hashing import INVALID_KEY, pack_coords
        from cagroup3d_tpu_torch.utils.synthetic import synthetic_request
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
    libs = {n: os.path.relpath(build.build(n), HERE)
            for n in ("sparse_conv", "segsum")}
    for n in libs:
        build.load(n)
    emit({"phase": "build", "ok": True, "seconds": round(time.time() - t0, 2),
          "libraries": libs})

    # 3. warm-up request, recording the kernels' main-path inputs ------
    mc, names = load_model_config(CFG)
    mc.INPUT_CAP = INPUT_CAP
    mc.DENSE_HEAD.FINE_CAP = FINE_CAP
    model = build_model(mc, len(names), dev, seed=0)
    k1_calls, k2_calls = [], []

    def recorder(fn, log):
        def rec(*args, **kw):
            log.append((args, kw))
            return fn(*args, **kw)
        return rec

    core_conv.sparse_conv = recorder(sparse_conv, k1_calls)
    core_vox.segment_sums = recorder(segment_sums, k2_calls)
    try:
        t0 = time.time()
        out = model.forward_eval(synthetic_request(0, dev, N_POINTS),
                                 cur_epoch=10)
        torch.cuda.synchronize()
        warm_s = time.time() - t0
    finally:
        core_conv.sparse_conv = sparse_conv
        core_vox.segment_sums = segment_sums
    emit({"phase": "warm-up", "ok": True, "seconds": round(warm_s, 3),
          "k1_calls": len(k1_calls), "k2_calls": len(k2_calls),
          "overflow": int(out["overflow"].sum())})

    # 4. K1 against its plain version at every recorded call ------------
    forms = {}
    for i, (args, kw) in enumerate(k1_calls):
        form = k1_form(i, k1_calls)
        got = sparse_conv(*args, **kw)
        ref = sparse_conv_plain(*args, **kw)
        qv = kw.get("qry_valid", args[6] if len(args) > 6 else None)
        valid = qv if qv is not None else args[1]
        f = forms.setdefault(form, dict(calls=0, max_rel=0.0, max_row=0.0,
                                        max_abs=0.0, ms=0.0, plain_ms=0.0,
                                        zero_ok=True, sorted=True, shapes=[]))
        f["calls"] += 1
        f["max_rel"] = max(f["max_rel"], rel_err(got, ref))
        f["max_row"] = max(f["max_row"], row_err(got, ref))
        f["max_abs"] = max(f["max_abs"], float((got - ref).abs().max()))
        f["zero_ok"] &= bool((got[~valid] == 0).all())
        f["sorted"] &= sources_sorted(args[0], args[1])
        K = args[4]
        f["ms"] += time_ms(lambda: sparse_conv(*args, **kw), 5)
        f["plain_ms"] += time_ms(lambda: sparse_conv_plain(*args, **kw),
                                 2 if K >= 9 else 5)
        shape = dict(G=args[2].shape[0], N=args[2].shape[1],
                     NQ=got.shape[1], C=args[2].shape[2], Cout=got.shape[2],
                     K=K)
        if shape not in f["shapes"]:
            f["shapes"].append(shape)
    for name, f in sorted(forms.items()):
        f["ok"] = (f["max_rel"] < TOL and f["max_row"] < ROW_TOL and
                   f["zero_ok"] and f["sorted"])
        emit({"phase": "k1", "form": name, **f})
    k1_ok = all(f["ok"] for f in forms.values())
    needed = ("a_", "b_", "c_", "d_", "e_", "f_")
    missing = [p for p in needed if not any(n.startswith(p) for n in forms)]
    if missing or not k1_ok:
        fail("k1", f"K1 disagrees with its plain version, a source table "
                   f"is not key-sorted or a form is missing: "
                   f"missing={missing}")
    k1_stats = dict(max_abs=max(f["max_abs"] for f in forms.values()),
                    ms=sum(f["ms"] for f in forms.values()),
                    plain_ms=sum(f["plain_ms"] for f in forms.values()))

    # 5. K2 against its plain version --------------------------------------
    g = torch.Generator(device="cpu").manual_seed(0)
    G, P, F = 18, 65536, 64
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
        n_unique = int(((sk_[:, 1:] != sk_[:, :-1]) &
                        (sk_[:, 1:] != INVALID_KEY)).sum(1).max()) + 1
        counts_ok = bool((nc == rc).all())
        rel, row = rel_err(ns, rs), row_err(ns, rs)
        ok = counts_ok and rel < TOL and row < ROW_TOL
        ms = time_ms(lambda: segment_sums(*args), 10)
        plain_ms = time_ms(lambda: segment_sums_plain(*args), 10)
        emit({"phase": "k2", "case": name, "ok": ok,
              "G": sk_.shape[0], "P": sk_.shape[1], "F": fs_.shape[2],
              "cap": cap, "max_unique_per_group": n_unique,
              "overflows": n_unique > cap, "counts_exact": counts_ok,
              "max_rel": rel, "max_row": row, "ms": ms,
              "plain_ms": plain_ms})
        if not ok:
            fail("k2", f"K2 disagrees with its plain version ({name})")
        k2_stats["max_abs"] = max(k2_stats["max_abs"],
                                  float((ns - rs).abs().max()))
        if name == "main_path":
            k2_stats["ms"], k2_stats["plain_ms"] = ms, plain_ms

    # 6. requests through the main path, counting launches ---------------
    sparse_conv.launches = 0
    segment_sums.launches = 0
    lat_ms, outs = [], []
    for seed in (0, 1, 2):
        batch = synthetic_request(seed, dev, N_POINTS)
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
    emit({"phase": "requests", "ok": True, "gpu": gpu, "power_limit": power,
          "scenes": 3, "points_per_scene": N_POINTS,
          "ms_per_scene": lat_ms, "median_ms": sorted(lat_ms)[1],
          "launches": launches,
          "detections": [int(o["pred_valid"].sum()) for o in outs],
          "overflow": [int(o["overflow"].sum()) for o in outs]})

    # 7. reference: a tiny model on the card vs the same model on the CPU --
    tc, _ = load_model_config(CFG)
    tc.BACKBONE_3D.update(CAPS={1: 2048, 2: 2048, 4: 1024, 8: 512, 16: 256,
                                32: 128, 64: 32, 128: 16, 256: 8, 512: 8},
                          PLANES=16, SPP_PLANES=16, OUT_CHANNELS=16)
    tc.INPUT_CAP = 2048
    tc.DENSE_HEAD.update(OUT_CHANNELS=16, FINE_CAP=1024, EXPAND_CAP=1024,
                         MAX_ROIS=64, NMS_PER_CLS_CAP=32)
    tc.DENSE_HEAD.NMS_CONFIG.NMS_PRE = 256
    tc.ROI_HEAD.update(MLPS=[[16, 32, 32]], REG_FC=[32, 32], GRID_CAP=2048,
                       NMS_PER_CLS_CAP=32, MAX_OUT=32)
    cpu_model = build_model(tc, len(names), "cpu", seed=1)
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    small = dict(n_points=4000, room=(3.0, 3.0, 2.5), n_objects=4)
    ref = cpu_model.forward_eval(synthetic_request(3, "cpu", **small),
                                 cur_epoch=10)
    got = gpu_model.forward_eval(synthetic_request(3, dev, **small),
                                 cur_epoch=10)
    got = {k: v.cpu() for k, v in got.items()}
    same_valid = bool((got["pred_valid"] == ref["pred_valid"]).all())
    same_labels = bool((got["pred_labels"] == ref["pred_labels"]).all())
    box_err = float((got["pred_boxes"] - ref["pred_boxes"]).abs().max())
    score_err = float((got["pred_scores"] - ref["pred_scores"]).abs().max())
    ok = same_valid and same_labels and box_err < 1e-2 and score_err < 1e-3
    emit({"phase": "reference", "ok": ok, "detections":
          int(ref["pred_valid"].sum()), "same_valid": same_valid,
          "same_labels": same_labels, "max_box_err": box_err,
          "max_score_err": score_err})
    if not ok or int(ref["pred_valid"].sum()) == 0:
        fail("reference", "card and CPU disagree on the tiny model")

    emit({"kernels": [
        {"name": "K1 sparse_conv", "route": "cuda",
         "source": "cagroup3d_tpu_torch/csrc/sparse_conv.cu",
         "replaces": "cagroup3d_tpu/ops/pallas_conv.py:124",
         "launches": launches["sparse_conv"],
         "max_abs_err": k1_stats["max_abs"], "ms": k1_stats["ms"],
         "plain_ms": k1_stats["plain_ms"]},
        {"name": "K2 segsum", "route": "cuda",
         "source": "cagroup3d_tpu_torch/csrc/segsum.cu",
         "replaces": "cagroup3d_tpu/ops/pallas_segsum.py:64",
         "launches": launches["segsum"],
         "max_abs_err": k2_stats["max_abs"], "ms": k2_stats["ms"],
         "plain_ms": k2_stats["plain_ms"]}]})
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
