#!/usr/bin/env python3
"""Phase 7 of ``chip_smoke.py`` over more request seeds, on one CUDA card.

Run from the repository root on a machine with a CUDA GPU:
    python3 reference_sweep.py [--seeds 3 11]
For each configuration (ScanNet, then SUN RGB-D on headed scenes) and each
request seed in the range it prints one JSON line: the tiny model's whole
eval forward on the card against the CPU, at phase 7's bars
(``chip_smoke.agree``), for three models -- ``as_built`` (phase 7's seeded
model, nothing conditioned), ``zero_votes`` (its votes zeroed) and
``phase7`` (the model phase 7 compares: on the yaw path zero votes and a
cos code of one) -- and whether phase 7 itself passed at that seed.  The
last line counts, per configuration, the seeds on which each agreed.

With ``--ckpt`` it instead compares a trained model: the overfit gate's
checkpoint (``python -m cagroup3d_tpu_torch.tools.overfit_check
[--yaw] --out_dir DIR`` writes ``DIR/checkpoint.pkl``) in the gate's tiny
model, whole forward on the card against the CPU on each of the gate's
ten scenes at phase 7's bars, one line per scene, then both devices' mAP
through the gate's evaluation:
    python3 reference_sweep.py --ckpt DIR/checkpoint.pkl [--yaw]
"""
import argparse
import copy
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs=2, default=(3, 11),
                    help="first and last request seed")
    ap.add_argument("--ckpt", default=None,
                    help="the overfit gate's checkpoint: compare it instead")
    ap.add_argument("--yaw", action="store_true",
                    help="with --ckpt: the gate's yaw model")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("reference_sweep: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from cagroup3d_tpu_torch.utils.synthetic import synthetic_request
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    pred = ("pred_valid", "pred_labels", "pred_boxes", "pred_scores")
    if args.ckpt is not None:
        return trained(args.ckpt, args.yaw, dev, pred)
    seeds = range(args.seeds[0], args.seeds[1] + 1)
    counts = {}
    for path in (cs.Path("scannet", cs.TRAIN_STEPS, cs.JAX_LEARN_DROP),
                 cs.Path("sunrgbd", cs.TRAIN_STEPS_YAW,
                         cs.JAX_LEARN_DROP_YAW)):
        models = {"as_built": cs.reference_model(path, False, False),
                  "zero_votes": cs.reference_model(path, True, False),
                  "phase7": cs.reference_model(path)}
        models = {k: (m, copy.deepcopy(m).to(dev)) for k, m in models.items()}
        small = dict(cs.TINY_SCENE, **path.scene)
        n = counts[path.name] = dict.fromkeys(list(models) + ["phase7_passed"],
                                              0)
        for seed in seeds:
            line = {"config": path.name, "seed": seed}
            for name, (cpu_m, gpu_m) in models.items():
                ref = cpu_m.forward_eval(synthetic_request(seed, "cpu",
                                                           **small),
                                         cur_epoch=10)
                got = gpu_m.forward_eval(synthetic_request(seed, dev,
                                                           **small),
                                         cur_epoch=10)
                res = cs.agree({k: got[k] for k in pred},
                               {k: ref[k] for k in pred}, pred[:2],
                               pred[2:3])
                line[name] = res
                n[name] += res["ok"]
            try:
                cs.phase_reference(dev, path, seed)
                line["phase7_passed"] = True
            except SystemExit:
                line["phase7_passed"] = False
            n["phase7_passed"] += line["phase7_passed"]
            print(json.dumps(line), flush=True)
    print(json.dumps({"seeds": [seeds[0], seeds[-1]], "agreed": counts}))
    return 0


def trained(path, yaw, dev, pred):
    """The gate's trained tiny model, card against CPU, on its scenes."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from cagroup3d_tpu_torch.tools import overfit_check as gate
    cpu_m = gate.build_network(gate.gate_model_cfg(yaw), gate.N_CLASSES,
                               device="cpu")
    cpu_m.load_jax_params(path)
    gpu_m = copy.deepcopy(cpu_m).to(dev)
    data = gate.overfit_scenes(np.random.RandomState(0), B=10,
                               P=gate.SCENE_POINTS, G=gate.SCENE_BOXES,
                               n_classes=gate.N_CLASSES, yaw=yaw)
    agreed = 0
    for i in range(len(data["points"])):
        b = {k: torch.from_numpy(data[k][i:i + 1])
             for k in ("points", "points_valid")}
        ref = cpu_m.forward_eval(b, cur_epoch=gate.EVAL_EPOCH)
        got = gpu_m.forward_eval({k: v.to(dev) for k, v in b.items()},
                                 cur_epoch=gate.EVAL_EPOCH)
        res = cs.agree({k: got[k] for k in pred}, {k: ref[k] for k in pred},
                       pred[:2], pred[2:3])
        agreed += res["ok"]
        print(json.dumps({"ckpt": path, "yaw": yaw, "scene": i,
                          "detections": int(ref["pred_valid"].sum()),
                          **res}), flush=True)
    m_cpu = gate.evaluate(cpu_m, data, "cpu")
    m_gpu = gate.evaluate(gpu_m, data, dev)
    print(json.dumps({"ckpt": path, "yaw": yaw, "scenes": len(data["points"]),
                      "agreed": agreed,
                      "cpu": dict(zip(("map25", "map50", "overflow"), m_cpu)),
                      "gpu": dict(zip(("map25", "map50", "overflow"),
                                      m_gpu))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
