"""What the spawned ranks of ``tests/test_torch_dist.py`` and
``tests/test_torch_kitti_dist.py`` run.

A rank imports neither JAX nor the JAX package (this module and
``chip_smoke`` import the port alone), so it starts in seconds.  Each job
is ``fn(rank, world, *args)`` for ``chip_smoke.run_ranks``, which joins
the ranks in a gloo process group first, and writes what it computed to
``out_dir/rank<r>.pt``.
"""
import copy
import os
import pickle

import numpy as np
import torch

from chip_smoke import SMALL_KITTI_GRID, cpu_caps, tiny_model


def _save(out_dir, rank, obj):
    torch.save(obj, os.path.join(out_dir, f"rank{rank}.pt"))


def bn_rank(rank, world, arrays, out_dir):
    """Train-mode BN of this rank's block of scenes (``arrays``: x [B, N,
    C], mask [B, N], weight, bias, running mean and var, cotangent [B, N,
    C]), one thread a scene meeting at a ``SceneSync`` over the process
    group: the output, the running-stat updates and the gradient of
    sum(y * cotangent) w.r.t. x."""
    import torch.distributed as dist
    from cagroup3d_tpu_torch.core.module import Ctx, apply_bn
    from cagroup3d_tpu_torch.core.norm import SceneSync
    from cagroup3d_tpu_torch.models.detectors.cagroup3d import run_scenes
    torch.set_num_threads(1)
    a = {k: torch.from_numpy(v) for k, v in arrays.items()}
    b = a["x"].shape[0] // world
    blk = slice(rank * b, (rank + 1) * b)
    x = a["x"][blk].clone().requires_grad_(True)
    P = {"bn.weight": a["weight"], "bn.bias": a["bias"]}
    S = {"bn.running_mean": a["rm"], "bn.running_var": a["rv"]}
    sync = SceneSync(b, dist.group.WORLD)
    ctxs = [Ctx(train=True, sync=sync, scene=i) for i in range(b)]
    ys = run_scenes(lambda i: apply_bn(P, S, ctxs[i], "bn", x[i],
                                       a["mask"][blk][i]), b, sync)
    y = torch.stack(ys)
    loss = sync.attach((y * a["cot"][blk]).sum())
    loss.backward()
    _save(out_dir, rank, dict(y=y.detach(), grad=x.grad,
                              updates=ctxs[0].updates))


def loss_rank(rank, world, cfg, n_cls, head, path, out_dir):
    """The tiny model's ``head`` loss ("dense_head" or "roi_head") on this
    rank's scene of the pickled two-scene inputs at ``path`` (arrays with a
    leading scene axis), over the process group: its tb terms and the
    gradients w.r.t. the float inputs named in ``path``'s ``grad_keys``."""
    import torch.distributed as dist
    from cagroup3d_tpu_torch.config import EasyDict
    from cagroup3d_tpu_torch.models import build_network
    torch.set_num_threads(1)
    with open(path, "rb") as f:
        inputs = pickle.load(f)
    blk = slice(rank, rank + 1)
    outs = {k: torch.from_numpy(np.array(v[blk])).requires_grad_(
        k in inputs["grad_keys"]) for k, v in inputs["outs"].items()}
    args = [torch.from_numpy(np.array(v[blk])) for v in inputs["args"]]
    pm = build_network(EasyDict(cfg), n_cls, device="cpu")
    group = dist.group.WORLD
    if head == "dense_head":
        loss, tb = pm.dense_head.loss(outs, *args, ins_cap=16, group=group)
    else:
        loss, tb = pm.roi_head.loss(outs, group=group)
    loss.backward()
    _save(out_dir, rank, dict(
        tb={k: float(v) for k, v in tb.items()},
        grads={k: outs[k].grad for k in inputs["grad_keys"]}))


def tiny_cli_cfg(cfg, root, n_points, repeat=None):
    """The YAML's CAGroup3D at ``chip_smoke.tiny_model``'s widths and
    ``cpu_caps`` on the tree at ``root`` (every point loaded), as the CLI
    tests set it after parsing."""
    tiny_model(cfg.MODEL)
    cpu_caps(cfg.MODEL)
    dc = cfg.DATA_CONFIG
    dc.DATA_PATH = str(root)
    dc.POINT_CAP = n_points
    dc.MAX_GT = 16
    for aug in (dc.DATA_AUGMENTOR_TRAIN, dc.DATA_AUGMENTOR_TEST):
        for st in aug.AUG_CONFIG_LIST:
            if st.NAME == "indoor_point_sample":
                st.num_points = n_points
    if repeat is not None:
        dc.REPEAT.train = repeat
    return cfg


def cli_rank(rank, world, which, argv, root, n_points, cwd, out_dir):
    """The ``which`` CLI ("train" or "test") with ``--dist`` on this rank,
    in ``cwd``, at ``tiny_cli_cfg`` over the tree at ``root``: torchrun's
    environment is set to this process group's.  Saves main's return and,
    for "train", the model's parameters and buffers after training."""
    import torch.distributed as dist
    from cagroup3d_tpu_torch.tools import test as test_cli
    from cagroup3d_tpu_torch.tools import train as train_cli
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT="0")       # the group exists already
    cli = train_cli if which == "train" else test_cli
    args, cfg = cli.parse_config([*argv, "--dist", "--device", "cpu"])
    tiny_cli_cfg(cfg, root, n_points, repeat=1)
    state = {}
    if which == "train":
        real = cli.train_model

        def train_model(model, *a, **kw):
            out = real(model, *a, **kw)
            state.update({k: v.detach().clone()
                          for k, v in model.state_dict().items()})
            return out
        cli.train_model = train_model
    os.chdir(cwd)
    ret = cli.main(args, cfg)
    assert dist.get_world_size() == world
    _save(out_dir, rank, dict(ret=ret, state=state))


# ---------------------------------------------------------------------------
# KITTI's anchor family (tests/test_torch_kitti_dist.py)
# ---------------------------------------------------------------------------

def tiny_kitti_cfg(name, cfg):
    """The KITTI YAML ``name``'s cfg at tiny widths on
    ``chip_smoke.SMALL_KITTI_GRID``'s 16 x 16 m range (the dataset's range
    too, so the frames are masked to it), in place."""
    mc = cfg.MODEL
    grid = SMALL_KITTI_GRID["pointpillar" if name == "pointpillar" else
                            "second"]
    mc.update(copy.deepcopy(grid))
    cfg.DATA_CONFIG.POINT_CLOUD_RANGE = list(grid["POINT_CLOUD_RANGE"])
    mc.INPUT_CAP = 4096
    if name == "pointpillar":
        mc.VFE.NUM_FILTERS = [16]
        mc.MAP_TO_BEV.NUM_BEV_FEATURES = 16
        # the JAX package reads no channel count from the map (see
        # test_torch_kitti_zoo.py), so name it for both
        mc.BACKBONE_2D.update(IN_CHANNELS=16, LAYER_NUMS=[1, 1, 1],
                              NUM_FILTERS=[8, 16, 16],
                              NUM_UPSAMPLE_FILTERS=[8, 8, 8])
        mc.DENSE_HEAD.NMS_CONFIG = dict(NMS_PRE_MAXSIZE=128)
    else:
        mc.BACKBONE_3D.CAPS = {1: 4096, 2: 2048, 4: 1024, 8: 512}
        mc.BACKBONE_2D.update(LAYER_NUMS=[1, 1], NUM_FILTERS=[16, 32],
                              NUM_UPSAMPLE_FILTERS=[16, 16])
    if name == "centerpoint":
        mc.DENSE_HEAD.SHARED_CONV_CHANNEL = 8
        mc.DENSE_HEAD.VOXEL_SIZE = list(mc.VOXEL_SIZE)
    if name == "second_multihead":
        mc.DENSE_HEAD.SHARED_CONV_NUM_FILTER = 8
        mc.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE = 256
    if name == "second_iou":
        mc.ROI_HEAD.update(SHARED_FC=[16, 16], IOU_FC=[16])
        mc.ROI_HEAD.ROI_GRID_POOL.IN_CHANNEL = 32
        mc.ROI_HEAD.TARGET_CONFIG.ROI_PER_IMAGE = 16
        mc.ROI_HEAD.NMS_CONFIG.TRAIN.update(NMS_PRE_MAXSIZE=256,
                                            NMS_POST_MAXSIZE=64)
        mc.ROI_HEAD.NMS_CONFIG.TEST.update(NMS_PRE_MAXSIZE=128,
                                           NMS_POST_MAXSIZE=32)
    return cfg


def kitti_units_rank(rank, world, path, out_dir):
    """This rank's block of the pickled inputs at ``path``, over the
    process group: the BEV BN (``bn2d`` in train mode on b scenes, pooled
    over the ranks through a one-scene ``SceneSync``; the output, the
    running-stat updates and the gradient of sum(y * cotangent) w.r.t. x),
    then for each entry of ``losses`` the head loss of the model built
    from its cfg on this rank's scene (the tb terms and the gradients
    w.r.t. the float inputs named in ``grad_keys``; AnchorHeadMulti's
    assigners read the given IoU matrices)."""
    import torch.distributed as dist
    from cagroup3d_tpu_torch.config import EasyDict
    from cagroup3d_tpu_torch.core.norm import SceneSync
    from cagroup3d_tpu_torch.models import build_network
    from cagroup3d_tpu_torch.models.backbones_2d.base_bev_backbone import \
        bn2d
    torch.set_num_threads(1)
    with open(path, "rb") as f:
        inputs = pickle.load(f)
    group = dist.group.WORLD
    a = {k: torch.from_numpy(v) for k, v in inputs["bn"].items()}
    b = a["x"].shape[0] // world
    blk = slice(rank * b, (rank + 1) * b)
    x = a["x"][blk].clone().requires_grad_(True)
    sync, updates = SceneSync(1, group), {}
    y = bn2d({"bn.weight": a["weight"], "bn.bias": a["bias"]},
             {"bn.running_mean": a["rm"], "bn.running_var": a["rv"]}, "bn",
             x, updates, sync)
    sync.attach((y * a["cot"][blk]).sum()).backward()
    out = dict(bn=dict(y=y.detach(), grad=x.grad, updates=updates))
    for name, case in inputs["losses"].items():
        pm = build_network(EasyDict(case["cfg"]), case["n_cls"], device="cpu")
        outs = {k: torch.from_numpy(np.array(v[rank:rank + 1]))
                .requires_grad_(k in case["grad_keys"])
                for k, v in case["outs"].items()}
        if name == "roi_head":
            loss, tb = pm.roi_head.loss(outs, group=group)
        else:
            for h, iou in zip(pm.dense_head.heads, case["ious"]):
                h["targets"].match_iou = \
                    lambda *_, t=torch.from_numpy(iou[rank]): t
            args = [torch.from_numpy(np.array(v[rank:rank + 1]))
                    for v in case["args"]]
            loss, tb = pm.dense_head.loss(outs, *args, group=group)
        loss.backward()
        out[name] = dict(tb={k: float(v) for k, v in tb.items()},
                         grads={k: outs[k].grad for k in case["grad_keys"]})
    _save(out_dir, rank, out)


def kitti_cli_rank(rank, world, test_argv, train_argv, name, root, cwd,
                   out_dir):
    """The ``test`` CLI and then the ``train`` CLI with ``--dist`` on this
    rank, in ``cwd``, at ``tiny_kitti_cfg(name)`` over the KITTI tree at
    ``root``: torchrun's environment is set to this process group's.
    Saves the test CLI's return, the train CLI's output directory and the
    model's parameters and buffers after training."""
    from cagroup3d_tpu_torch.tools import test as test_cli
    from cagroup3d_tpu_torch.tools import train as train_cli
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT="0")       # the group exists already
    os.chdir(cwd)
    tail = ["--dist", "--device", "cpu", "--set", "DATA_CONFIG.DATA_PATH",
            str(root)]
    args, cfg = test_cli.parse_config([*test_argv, *tail])
    ret = test_cli.main(args, tiny_kitti_cfg(name, cfg))
    state = {}
    real = train_cli.train_model

    def train_model(model, *a, **kw):
        out = real(model, *a, **kw)
        state.update({k: v.detach().clone()
                      for k, v in model.state_dict().items()})
        return out
    train_cli.train_model = train_model
    args, cfg = train_cli.parse_config([*train_argv, *tail])
    out = train_cli.main(args, tiny_kitti_cfg(name, cfg))
    _save(out_dir, rank, dict(test=ret, train=str(out), state=state))
