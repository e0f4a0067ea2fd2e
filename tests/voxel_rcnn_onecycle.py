"""Voxel R-CNN (voxel_rcnn_car.yaml) under the ``train`` CLI's compressed
one-cycle schedule: the port and the JAX package on the CPU, from the same
parameters, over the same batches, step by step.

The ``train`` CLI on a tree of four train frames at the YAML's batch of 2
runs ``--epochs 1`` (two steps of a two-step one-cycle) and then resumes
with ``--epochs 2`` (two more steps of a four-step one).  A two-step
one-cycle has no warm-up step, so the first update already takes the peak
learning rate LR (0.01), then 0.005, 0.0075 and 0.0025, where the published
80-epoch schedule spends 32 epochs climbing from LR / DIV_FACTOR.  This
script runs those four steps (the same learning rates and adam betas,
GRAD_NORM_CLIP, weight decay) on three trainers:

- ``jax_stop``: the JAX package's ``make_train_step`` with the gradient
  stopped at the proposals, as the port and the reference do;
- ``port``: the port's ``make_train_step``;
- ``jax``: the JAX package's ``make_train_step`` as its CLI runs it (the
  gradient flows through the proposals into the anchor head's boxes).

Each step prints the loss and its terms, the learning rate, the largest
anchor-head box regression output (``box_preds``) and the largest size of
the boxes it decodes (``box_size``: the proposals' candidates), where the
divergence shows first.  By default the RoI sampling and dropout draw from
each package's own generator and the port picks its own proposals, so the
R-CNN terms differ at the scale of that noise, and Adam's first update,
about LR times the sign of each gradient, carries it into every
parameter.  ``--fed`` takes those out of the port-against-``jax_stop``
comparison: DP_RATIO 0 for all three, and the port reads, step by step,
``jax_stop``'s proposals, its RoI sampling draws and its assigner IoU
matrices, as ``tests/test_torch_voxel_rcnn.py`` does for one step.

    JAX_PLATFORMS=cpu python tests/voxel_rcnn_onecycle.py [--full] \
        [--fed] [--out results.json]

Without ``--full`` the model is voxel_rcnn_car.yaml at the tiny widths of
``tests/dist_jobs.py::tiny_kitti_cfg`` on its 16 x 16 m range; with
``--full`` the published widths and voxel size on a 16 x 16 m range
(3200 anchors instead of 70400) and 1024 training NMS candidates instead
of 9000, so that the JAX package's step fits a CPU.  The frames are
``utils/synthetic.write_kitti_tree``'s, through the port's train loader
(gt sampling and the world augmentations, ``np.random`` seeded).
"""
import argparse
import copy
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE)]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from cagroup3d_tpu.config import EasyDict as JEasyDict  # noqa: E402
from cagroup3d_tpu.config import cfg_from_yaml_file as jload_cfg  # noqa
from cagroup3d_tpu.models import build_network as jbuild  # noqa: E402
from cagroup3d_tpu.parallel.mesh import make_train_step as jstep_fn  # noqa
from cagroup3d_tpu.training import optimization as jopt  # noqa: E402
from cagroup3d_tpu_torch.datasets import build_dataloader  # noqa: E402
from cagroup3d_tpu_torch.models import build_network, load_config  # noqa
from cagroup3d_tpu_torch.models.detectors.detector3d_template import \
    dataset_meta  # noqa: E402
from cagroup3d_tpu_torch.parallel.mesh import make_train_step  # noqa: E402
from cagroup3d_tpu_torch.training import optimization as popt  # noqa: E402
from cagroup3d_tpu_torch.utils.synthetic import write_kitti_tree  # noqa

YAML = str(HERE.parent / "tools" / "cfgs" / "kitti_models" /
           "voxel_rcnn_car.yaml")
CUT_RANGE = [0.0, -8.0, -3.0, 16.0, 8.0, 1.0]
B, FRAMES, STEPS = 2, 4, 4
KEYS = ("points", "points_valid", "gt_boxes", "gt_valid")


def configs(full, fed):
    """(port cfg, JAX cfg) of the YAML, cut as the module docstring says."""
    from dist_jobs import tiny_kitti_cfg
    out = []
    for cfg in (load_config(YAML), jload_cfg(YAML, JEasyDict())):
        if full:
            cfg.DATA_CONFIG.POINT_CLOUD_RANGE = list(CUT_RANGE)
            cfg.MODEL.INPUT_CAP = 16384
            cfg.MODEL.BACKBONE_3D.CAPS = {1: 16384, 2: 8192, 4: 4096,
                                          8: 2048}
            # at 9000 candidates the JAX package's training step asks
            # the CPU for 374 GB
            cfg.MODEL.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_PRE_MAXSIZE = 1024
        else:
            tiny_kitti_cfg("voxel_rcnn_car", cfg)
        if fed:
            cfg.MODEL.ROI_HEAD.DP_RATIO = 0.0
        out.append(cfg)
    return out


def cli_schedule(fns):
    """(lr, beta1) functions of the update count under the CLI's two calls:
    counts 0-1 from the two-step one-cycle, then from the four-step one
    (``fns(total)`` gives a package's (lr_fn, mom_fn)); ``pick(c, a, b)``
    chooses between the two."""
    (lr1, m1), (lr2, m2) = fns(2), fns(4)
    return (lambda c, pick: pick(c, lr1, lr2),
            lambda c, pick: pick(c, m1, m2))


def batches(cfg, names):
    np.random.seed(0)
    _, loader, _ = build_dataloader(cfg.DATA_CONFIG, names, B, training=True)
    out = []
    for _ in range(STEPS * B // FRAMES):
        out += [{k: np.asarray(b[k]) for k in KEYS} for b in loader]
    return out[:STEPS]


def fed_inputs(jm, cfg, data, props):
    """Per step, what the port reads of the ``jax_stop`` step: each scene's
    proposals, its RoI sampling draws (the scene ``Ctx``'s first
    ``next_rng`` under ``jax.random.PRNGKey(step)``) and the assigner's
    IoU matrices."""
    from test_torch_kitti_zoo import _jax_ious
    from test_torch_train_units import _jax_draws
    head = jm.dense_head
    n_roi = int(cfg.MODEL.ROI_HEAD.TARGET_CONFIG.ROI_PER_IMAGE)
    ious = jax.jit(lambda g, v: _jax_ious(
        [(head.anchors_np, head.anchor_cls_np)], g[..., :7],
        g[..., 7].astype(jnp.int32), v)[0])
    out = []
    for i, b in enumerate(data):
        draws = []
        for r in jax.random.split(jax.random.PRNGKey(i), B):
            _, sub = jax.random.split(r)
            draws.append(_jax_draws(sub, props[i][0][0].shape[0], n_roi))
        out.append(dict(props=[tuple(torch.from_numpy(np.array(a))
                                     for a in p) for p in props[i]],
                        draws=draws, ious=np.asarray(ious(
                            jnp.asarray(b["gt_boxes"]),
                            jnp.asarray(b["gt_valid"])))))
    return out


def run_port(cfg, names, P0, S0, data, rec, fed=None):
    pm = build_network(copy.deepcopy(cfg.MODEL), len(names), device="cpu",
                       dataset=dataset_meta(cfg.DATA_CONFIG, names))
    pm.load_jax_params(P0, S0)
    opt, _ = popt.build_optimizer(pm, cfg.OPTIMIZATION, FRAMES // B,
                                  total_epochs=1)
    lr, mom = cli_schedule(lambda t: popt.onecycle_schedules(
        cfg.OPTIMIZATION, t))

    def pick(c, a, b):
        return a(c) if c < 2 else b(c)
    opt.schedule = lambda c: lr(c, pick)
    opt.momentum = lambda c: mom(c, pick)
    head = pm.dense_head
    decoded = head.decoded_boxes

    def watch(out):
        rec["box_preds"].append(float(out["box_preds"].abs().max()))
        boxes, scores = decoded(out)
        rec["box_size"].append(float(boxes[:, 3:6].abs().max()))
        return boxes, scores

    head.decoded_boxes = watch
    step = make_train_step(pm, opt, torch.Generator().manual_seed(0),
                           device="cpu")
    for i, b in enumerate(data):
        draws = None
        if fed is not None:
            props = iter(fed[i]["props"])
            proposals = pm.proposals
            pm.proposals = lambda out, train: (proposals(out, train),
                                               next(props))[1]
            ious = iter(fed[i]["ious"])
            head.match_iou = lambda *a: torch.from_numpy(next(ious))
            draws = fed[i]["draws"]
        try:
            loss, tb = step({k: torch.from_numpy(v) for k, v in b.items()},
                            roi_draws=draws)
        finally:
            if fed is not None:
                del pm.proposals, head.match_iou
        yield i, opt.schedule(i), float(loss), \
            {k: float(v) for k, v in tb.items()}


def run_jax(cfg, jm, P, S, data, rec, stop):
    ocfg = cfg.OPTIMIZATION
    lr, mom = cli_schedule(lambda t: jopt.onecycle_schedules(ocfg, t))
    wd = float(ocfg.WEIGHT_DECAY)

    def pick(c, a, b):
        return jnp.where(c < 2, a(c), b(c))

    @optax.inject_hyperparams
    def adam(learning_rate, b1):
        return optax.chain(optax.add_decayed_weights(wd),
                           optax.scale_by_adam(b1=b1, b2=0.99),
                           optax.scale_by_learning_rate(learning_rate))

    tx = optax.chain(optax.clip_by_global_norm(float(ocfg.GRAD_NORM_CLIP)),
                     adam(learning_rate=lambda c: lr(c, pick),
                          b1=lambda c: mom(c, pick)))
    head, roi = jm.dense_head, jm.roi_head
    decoded, layer = head.decoded_boxes, roi.proposal_layer

    def watch(out):
        boxes, scores = decoded(out)
        jax.debug.callback(lambda a, s: (
            rec["box_preds"].append(float(np.max(a))),
            rec["box_size"].append(float(np.max(s)))),
            jnp.max(jnp.abs(out["box_preds"])),
            jnp.max(jnp.abs(boxes[:, 3:6])))
        return boxes, scores

    def proposals(*a, **kw):
        out = layer(*a, **kw)
        jax.debug.callback(lambda *o: rec["props"].append(
            [np.asarray(x) for x in o]), *out)
        return jax.lax.stop_gradient(out) if stop else out

    head.decoded_boxes, roi.proposal_layer = watch, proposals
    try:
        step = jstep_fn(jm, tx, donate=False)
        opt_state = tx.init(P)
        for i, b in enumerate(data):
            P, S, opt_state, loss, tb = step(
                P, S, opt_state, {k: jnp.asarray(v) for k, v in b.items()},
                jax.random.PRNGKey(i), 0.0)
            yield i, float(lr(i, lambda c, a, b: a(c) if c < 2 else b(c))), \
                float(loss), {k: float(v) for k, v in tb.items()}
    finally:
        del head.decoded_boxes, roi.proposal_layer


def rpn_first_step(cfg, jm, P, S, P0, S0, names, batch):
    """The one-stage half's training loss on ``batch`` at the initial
    parameters (no proposals, no RoI head): the JAX package's
    ``SECONDNet.forward_train``, the port's ``SECONDNet.train_heads`` after
    ``train_maps``, the port again reading the JAX assigner's IoU
    matrices."""
    from cagroup3d_tpu.models.detectors.second_net import SECONDNet as JNet
    from cagroup3d_tpu_torch.models.detectors.second_net import SECONDNet
    from test_torch_kitti_zoo import _jax_ious
    head = jm.dense_head
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    _, jtb, _ = jax.jit(lambda P, b: JNet.forward_train(
        jm, P, S, b, jax.random.PRNGKey(0)))(P, jb)
    ious = np.asarray(jax.jit(lambda g, v: _jax_ious(
        [(head.anchors_np, head.anchor_cls_np)], g[..., :7],
        g[..., 7].astype(jnp.int32), v)[0])(jb["gt_boxes"], jb["gt_valid"]))
    out = {"jax": {k: float(v) for k, v in jtb.items()}}
    pm = build_network(copy.deepcopy(cfg.MODEL), len(names), device="cpu",
                       dataset=dataset_meta(cfg.DATA_CONFIG, names))
    pm.load_jax_params(P0, S0)
    tb_ = {k: torch.from_numpy(v) for k, v in batch.items()}
    for name in ("port", "port_fed_ious"):
        if name == "port_fed_ious":
            it = iter(ious)
            pm.dense_head.match_iou = lambda *a: torch.from_numpy(
                np.array(next(it)))
        with torch.no_grad():
            PP, SS, ctxs, bev = pm.train_maps(tb_, torch.Generator())
            _, tb, _ = SECONDNet.train_heads(pm, PP, SS, ctxs, bev, tb_)
        out[name] = {k: float(v) for k, v in tb.items()}
    for name, tb in out.items():
        print(f"first step, one-stage half, {name:13s} " + " ".join(
            f"{k} {v:.6g}" for k, v in sorted(tb.items()) if "loss" in k))
    return out


def scenes(props):
    """The proposals a step's callbacks recorded, one tuple a scene (the
    callback sees a scene or the vmapped batch)."""
    if len(props) == B:
        return props
    (batched,) = props
    return [tuple(a[s] for a in batched) for s in range(B)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="published widths on a 16 x 16 m range")
    ap.add_argument("--fed", action="store_true",
                    help="DP_RATIO 0; the port reads jax_stop's proposals, "
                         "draws and IoU matrices")
    ap.add_argument("--trainers", default="jax_stop,port,jax",
                    help="which trainers to run, in this order (with "
                         "--fed, jax_stop before port)")
    ap.add_argument("--rpn0", action="store_true",
                    help="only the one-stage half's loss on the first "
                         "batch at the initial parameters, the port with "
                         "and without the JAX assigner's IoU matrices")
    ap.add_argument("--out", help="write the records here as JSON")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(args.threads)
    cfg, jcfg = configs(args.full, args.fed)
    names = list(cfg.CLASS_NAMES)
    res = {"full": args.full, "fed": args.fed, "runs": {}}
    with tempfile.TemporaryDirectory(prefix="vrcnn_onecycle_") as tree:
        write_kitti_tree(tree, FRAMES, seed=3, n_train=FRAMES)
        for c in (cfg, jcfg):
            c.DATA_CONFIG.DATA_PATH = tree
        data = batches(cfg, names)
    res["gt_per_batch"] = [int(b["gt_valid"].sum()) for b in data]
    jm = jbuild(copy.deepcopy(jcfg.MODEL), len(names),
                dataset=dataset_meta(jcfg.DATA_CONFIG, names))
    P, S = jax.jit(jm.init)(jax.random.PRNGKey(0))
    P0 = {k: np.asarray(v) for k, v in P.items()}
    S0 = {k: np.asarray(v) for k, v in S.items()}
    if args.rpn0:
        res["rpn0"] = rpn_first_step(cfg, jm, P, S, P0, S0, names, data[0])
        args.trainers = ""
    props = []
    runs = {"jax_stop": lambda rec: run_jax(jcfg, jm, P, S, data, rec, True),
            "port": lambda rec: run_port(
                cfg, names, P0, S0, data, rec,
                fed_inputs(jm, cfg, data, props) if args.fed else None),
            "jax": lambda rec: run_jax(jcfg, jm, P, S, data, rec, False)}
    for name in filter(None, args.trainers.split(",")):
        run = runs[name]
        rec = {"box_preds": [], "box_size": [], "props": []}
        steps = []
        for i, lr, loss, tb in run(rec):
            n = len(rec["box_preds"]) // (i + 1)
            steps.append(dict(step=i, lr=lr, loss=loss, tb=tb,
                              box_preds=max(rec["box_preds"][-n:]),
                              box_size=max(rec["box_size"][-n:])))
            if name == "jax_stop":
                props.append(scenes(rec["props"]))
                rec["props"] = []
            s = steps[-1]
            print(f"{name:9s} step {i} lr {lr:.5f} loss {loss:.6g} "
                  f"box_preds {s['box_preds']:.4g} box_size "
                  f"{s['box_size']:.4g} " + " ".join(
                      f"{k} {v:.5g}" for k, v in sorted(tb.items())
                      if "loss" in k), flush=True)
        res["runs"][name] = steps
    for a, b in (("port", "jax_stop"), ("jax", "jax_stop")):
        if a not in res["runs"] or b not in res["runs"]:
            continue
        for sa, sb in zip(res["runs"][a], res["runs"][b]):
            rel = {k: abs(sa["tb"][k] - v) / max(abs(v), 1e-12)
                   for k, v in sb["tb"].items() if "loss" in k}
            print(f"{a} against {b}, step {sa['step']}: loss terms' largest "
                  f"relative difference {max(rel.values()):.3g} "
                  f"({max(rel, key=rel.get)}); box_preds "
                  f"{sa['box_preds']:.5g} / {sb['box_preds']:.5g}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main()
