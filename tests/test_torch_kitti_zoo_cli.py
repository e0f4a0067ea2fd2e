"""The port's CLIs, dataset and key bits on centerpoint.yaml,
pointpillar.yaml, second_multihead.yaml, second_iou.yaml and
voxel_rcnn_car.yaml (``--device cpu``, tiny widths,
synthetic KITTI trees from ``utils/synthetic.write_kitti_tree``): the
``train`` CLI trains each YAML's model for one epoch, its checkpoint holds
the JAX init's names and shapes (``jax.eval_shape``) and the ``test`` CLI
evaluates it; pointpillar.yaml's own DATA_CONFIG (range, voxel size, its
gt sampling groups) gives the JAX package's batches bit for bit; a
CAGroup3D built after each model packs keys at 10/10/10; ``--dist``
training issues each model's cross-rank BN sums in one order.
"""
import copy
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

from cagroup3d_tpu.config import EasyDict as JEasyDict
from cagroup3d_tpu.config import cfg_from_yaml_file as jload_cfg
from cagroup3d_tpu.core import hashing as jhash
from cagroup3d_tpu.datasets import build_dataloader as jbuild_loader
from cagroup3d_tpu.models import build_network as jbuild
from cagroup3d_tpu_torch.core import hashing
from cagroup3d_tpu_torch.datasets import build_dataloader
from cagroup3d_tpu_torch.models import build_network
from cagroup3d_tpu_torch.tools import test as cli
from cagroup3d_tpu_torch.tools import train as tcli
from cagroup3d_tpu_torch.utils.synthetic import write_kitti_tree
from test_torch_kitti import _load, _same
from test_torch_kitti_zoo import YAMLS, bits
from test_outdoor import outdoor_batch
from dist_jobs import tiny_kitti_cfg

torch.set_num_threads(1)
assert bits        # the key-bits fixture (autouse) of the zoo tests
NAMES = ["Car", "Pedestrian", "Cyclist"]
tiny = tiny_kitti_cfg      # the YAML's cfg at tiny widths on 16 x 16 m


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Two frames of 20k points, 12 objects each, both in the train
    split."""
    root = tmp_path_factory.mktemp("kitti_zoo")
    write_kitti_tree(root, 2, n_points=20_000, seed=4, n_objects=12,
                     n_train=2)
    return root


@pytest.mark.parametrize("name", sorted(YAMLS))
def test_train_and_test_cli(name, tree, monkeypatch, tmp_path):
    """The ``train`` CLI (one epoch, batch 2: one step) and the ``test``
    CLI on its checkpoint, for each YAML: the loss finite, the checkpoint
    at epoch 1 with the JAX init's names and shapes, the metrics
    returned, the key bits back at the defaults."""
    tail = ["--set", "DATA_CONFIG.DATA_PATH", str(tree)]
    cfg_file = str(Path(YAMLS[name]).resolve())
    args, cfg = tcli.parse_config(["--cfg_file", cfg_file, "--batch_size",
                                   "2", "--epochs", "1", "--device", "cpu"] +
                                  tail)
    tiny(name, cfg)
    monkeypatch.chdir(tmp_path)
    out = tcli.main(args, cfg)
    assert hashing.key_bits() == (10, 10, 10)
    ck = _load(out / "ckpt" / "checkpoint_epoch_1.pkl")
    assert (ck["epoch"], ck["it"]) == (1, 1)
    jcfg = tiny(name, jload_cfg(cfg_file, JEasyDict()))
    jcfg.DATA_CONFIG.DATA_PATH = str(tree)
    prev = (jhash.XBITS, jhash.YBITS, jhash.ZBITS)
    names = list(jcfg.CLASS_NAMES)      # voxel_rcnn_car.yaml: Car only
    try:
        jds, _, _ = jbuild_loader(jcfg.DATA_CONFIG, names, 1, training=False)
        jm = jbuild(jcfg.MODEL, len(names), dataset=jds)
    finally:
        jhash.set_key_bits(*prev)
    jP, jS = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    for mine, theirs in ((ck["params"], jP), (ck["state"], jS)):
        assert {k: np.shape(v) for k, v in mine.items()} == \
            {k: tuple(v.shape) for k, v in theirs.items()}
    targs, tcfg = cli.parse_config(
        ["--cfg_file", cfg_file, "--device", "cpu", "--ckpt",
         str(out / "ckpt" / "checkpoint_epoch_1.pkl")] + tail)
    tiny(name, tcfg)
    res = cli.main(targs, tcfg)
    (metrics,) = res.values()
    assert "Car_3d/moderate_R40" in metrics
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert hashing.key_bits() == (10, 10, 10)


def test_pointpillar_batches_match_jax(tree):
    """pointpillar.yaml's DATA_CONFIG (its range [0, -39.68, -3, 69.12,
    39.68, 1], pillars of 0.16 x 0.16 x 4 m, 32 points a pillar, its gt
    sampling groups): the eval loader's batches and, from the same
    ``np.random`` seed, the train loader's batch (gt sampling, the world
    flip, rotation and scaling) equal the JAX package's bit for bit; the
    model reads its VFE cap and grid from that config."""
    cfg_file = YAMLS["pointpillar"]
    from cagroup3d_tpu_torch.models import load_config
    from cagroup3d_tpu_torch.models.detectors.detector3d_template import \
        dataset_meta
    cfg, jcfg = load_config(cfg_file), jload_cfg(cfg_file, JEasyDict())
    runs = []
    for c, loader_fn in ((cfg, build_dataloader), (jcfg, jbuild_loader)):
        c.DATA_CONFIG.DATA_PATH = str(tree)
        assert list(c.DATA_CONFIG.POINT_CLOUD_RANGE) == \
            [0, -39.68, -3, 69.12, 39.68, 1]
        out = list(loader_fn(c.DATA_CONFIG, NAMES, 1, training=False)[1])
        np.random.seed(0)
        out += list(loader_fn(c.DATA_CONFIG, NAMES, 2, training=True)[1])
        runs.append(out)
    _same(runs[0], runs[1], "batches")
    assert len(runs[0]) == 3
    assert runs[0][2]["gt_valid"].sum() > runs[0][0]["gt_valid"].sum()
    pm = build_network(copy.deepcopy(cfg.MODEL), 3, device="cpu",
                       dataset=dataset_meta(cfg.DATA_CONFIG, NAMES))
    assert pm.vfe.max_points == 32 and pm.grid_size == [432, 496, 1]
    assert pm.voxel_size == [0.16, 0.16, 4.0]


def test_cagroup3d_after_the_zoo_keeps_default_bits():
    """Each of the tiny zoo models run (CenterPoint and the two SECOND
    variants at KITTI's range and voxel size, where they pack at (11, 11,
    8); the pillars open no scope), then a CAGroup3D built and run after
    them packs keys at 10/10/10."""
    import __graft_entry__
    from cagroup3d_tpu.utils.synthetic import synthetic_batch
    from test_torch_kitti_zoo import CFGS
    seen = []
    for name in sorted(CFGS):
        c = CFGS[name]()
        if name != "pointpillar":
            c.POINT_CLOUD_RANGE = [0.0, -40.0, -3.0, 70.4, 40.0, 1.0]
            c.VOXEL_SIZE = [0.05, 0.05, 0.1]
        m = build_network(c, num_class=2, device="cpu")
        b = outdoor_batch(np.random.RandomState(0), B=1)
        out = m.forward_eval({k: torch.from_numpy(np.array(b[k]))
                              for k in ("points", "points_valid")})
        assert torch.isfinite(out["pred_boxes"]).all()
        seen.append(tuple(m.key_bits))
        assert hashing.key_bits() == (10, 10, 10)
    assert seen == [(10, 10, 10) if name == "pointpillar" else (11, 11, 8)
                    for name in sorted(CFGS)]
    jm = __graft_entry__._build_model(tiny=True)
    cm = build_network(jm.model_cfg, num_class=18, device="cpu")
    sb = synthetic_batch(np.random.RandomState(0), batch_size=1,
                         n_points=500, point_cap=512, room=(3.0, 3.0, 2.5),
                         n_objects=2)
    out = cm.forward_eval({k: torch.from_numpy(sb[k]) for k in
                           ("points", "points_valid")})
    assert torch.isfinite(out["pred_boxes"]).all()
    assert hashing.key_bits() == (10, 10, 10)
    assert hashing.key_extents() == (1024, 1024, 1024)


@pytest.mark.parametrize("name", sorted(YAMLS))
def test_dist_raises(name, monkeypatch):
    """``--dist`` training no longer raises for the zoo: with two ranks
    faked in one process (``test_torch_kitti_dist.collective_order``),
    each model's training forward issues one cross-rank BN sum a BN, in
    the same numbered order as either rank, and its backward the reverse
    order."""
    from test_torch_kitti_dist import check_collective_order
    from test_torch_kitti_zoo import CFGS
    b = {k: torch.from_numpy(np.array(v)) for k, v in
         outdoor_batch(np.random.RandomState(0), B=2).items()}
    check_collective_order(
        lambda: build_network(CFGS[name](), num_class=2, device="cpu"), b,
        monkeypatch)
