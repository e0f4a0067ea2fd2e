"""What the spawned ranks of ``tests/test_torch_dist.py`` run.

A rank imports neither JAX nor the JAX package (this module and
``chip_smoke`` import the port alone), so it starts in seconds.  Each job
is ``fn(rank, world, *args)`` for ``chip_smoke.run_ranks``, which joins
the ranks in a gloo process group first, and writes what it computed to
``out_dir/rank<r>.pt``.
"""
import os
import pickle

import numpy as np
import torch

from chip_smoke import cpu_caps, tiny_model


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
