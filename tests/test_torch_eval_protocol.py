"""PyTorch port vs the JAX package: the eval entry point's host side.

The indoor mAP evaluator, the indoor augmentor stages, the ScanNet and
SUN RGB-D datasets and their loader (train and test mode), the eval
harness ``eval_one_epoch`` and the ``test`` CLI, on trees that the port's
``write_indoor_tree`` writes from seeded synthetic scenes.

Everything compared here is numpy on both sides, so the comparisons are
exact: the evaluator's dicts within 1e-12, everything else equal.  The
forward itself is held to the JAX package by ``test_torch_detector.py``
and ``test_torch_yaw.py``; here the JAX harness is handed the port
model's own ``forward_eval`` outputs, so no JAX model graph is traced.
The tiny model is ``chip_smoke.tiny_model``'s widths at smaller caps and
with a k3 class conv (``_tiny_cfg``), which keeps this file inside 20 s.
"""
import copy
import importlib
import logging
import pickle
import threading

import numpy as np
import pytest
import torch

import cagroup3d_tpu.datasets as jds
from cagroup3d_tpu.datasets import augmentor as jaug
from cagroup3d_tpu.training import eval_utils as jeu
from cagroup3d_tpu.training.checkpoint import \
    save_checkpoint as jax_save_checkpoint

import cagroup3d_tpu_torch.datasets as pds
from cagroup3d_tpu_torch.config import EasyDict
from cagroup3d_tpu_torch.core.module import flat_state
from cagroup3d_tpu_torch.datasets import augmentor as paug
from cagroup3d_tpu_torch.datasets import indoor_eval as pev
from cagroup3d_tpu_torch.datasets.scannet_dataset import ScannetDataset
from cagroup3d_tpu_torch.datasets.sunrgbd_dataset import SunrgbdDataset
from cagroup3d_tpu_torch.models import load_config
from cagroup3d_tpu_torch.tools import test as cli
from cagroup3d_tpu_torch.training import eval_utils as peu
from cagroup3d_tpu_torch.training.checkpoint import save_checkpoint
from cagroup3d_tpu_torch.utils.synthetic import (points_in_boxes,
                                                 synthetic_scene,
                                                 write_indoor_tree)
from chip_smoke import CFGS, build_model, cpu_caps, tiny_model

# the JAX package's datasets/__init__.py binds the name to the function
jev = importlib.import_module("cagroup3d_tpu.datasets.indoor_eval")
torch.set_num_threads(1)

SCENE = dict(n_points=2000, n_objects=5, room=(3.0, 3.0, 2.5))
EVAL_EPOCH = 10       # the CLI evaluates a single checkpoint at NUM_EPOCHS


# ---------------------------------------------------------------------------
# evaluator
# ---------------------------------------------------------------------------

def _boxes(rng, n, yaw):
    b = np.concatenate([rng.rand(n, 3) * 4, rng.rand(n, 3) + 0.3,
                        rng.rand(n, 1) * 2 * np.pi if yaw
                        else np.zeros((n, 1))], 1)
    return b.astype(np.float32)


def _annos(case, seed=0, n_scenes=4, n_cls=5):
    """(gt_annos, dt_annos) of seeded random scenes: per scene some GT
    boxes, each predicted with jitter (or near-coincident), plus false
    positives."""
    rng = np.random.RandomState(seed)
    yaw = case == "headed"
    gt_annos, dt_annos = [], []
    for s in range(n_scenes):
        n = rng.randint(2, 7)
        gb = _boxes(rng, n, yaw)
        labels = rng.randint(0, n_cls, n)
        if case == "gt_without_pred":
            labels[labels == 3] = 2
            labels[0] = 3
        if case == "pred_without_gt":
            labels[labels == 4] = 1
        if case == "empty_scene" and s == 1:
            gt_annos.append(dict(gt_num=0))
        else:
            gt_annos.append(dict(gt_num=n, gt_boxes_upright_depth=gb,
                                 **{"class": labels}))
        jit = 1e-6 if case == "near_coincident" else 0.15
        pb = gb + (rng.randn(*gb.shape) * jit).astype(np.float32)
        pb[:, 3:6] = np.abs(pb[:, 3:6])
        fp = _boxes(rng, 3, yaw)
        plab = np.concatenate([labels, rng.randint(0, n_cls, 3)])
        if case == "pred_without_gt":
            plab[-1] = 4
        if case == "gt_without_pred":
            keep = plab != 3
            pb = np.concatenate([pb, fp])[keep]
            plab = plab[keep]
        else:
            pb = np.concatenate([pb, fp])
        dt_annos.append(dict(labels_3d=plab, boxes_3d=pb,
                             scores_3d=rng.rand(len(plab))))
    return gt_annos, dt_annos


@pytest.mark.parametrize("yaw", [False, True])
@pytest.mark.parametrize("near", [False, True])
def test_overlaps_equal(yaw, near):
    rng = np.random.RandomState(int(yaw) + 2 * int(near))
    a = _boxes(rng, 9, yaw)
    b = a + np.float32(1e-6) * rng.randn(*a.shape).astype(np.float32) \
        if near else _boxes(rng, 7, yaw)
    np.testing.assert_array_equal(
        pev.rotated_intersection_np(a[:, [0, 1, 3, 4, 6]],
                                    b[:, [0, 1, 3, 4, 6]]),
        jev.rotated_intersection_np(a[:, [0, 1, 3, 4, 6]],
                                    b[:, [0, 1, 3, 4, 6]]))
    for crit in (-1, 0, 1, 2):
        np.testing.assert_array_equal(pev.d3_box_overlap(a, b, crit),
                                      jev.d3_box_overlap(a, b, crit))


@pytest.mark.parametrize("case", ["axis_aligned", "headed", "empty_scene",
                                  "pred_without_gt", "gt_without_pred",
                                  "near_coincident"])
def test_indoor_eval_equal(case, capsys):
    gt, dt = _annos(case)
    label2cat = {i: f"c{i}" for i in range(5)}
    got = pev.indoor_eval(copy.deepcopy(gt), copy.deepcopy(dt),
                          [0.25, 0.5], label2cat)
    table = capsys.readouterr().out
    ref = jev.indoor_eval(gt, dt, [0.25, 0.5], label2cat)
    assert table == capsys.readouterr().out
    assert got.keys() == ref.keys()
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-12, k
    if case == "gt_without_pred":
        assert got["c3_AP_0.25"] == 0.0 and "c3_rec_0.50" in got
    if case == "pred_without_gt":
        assert got["c4_AP_0.25"] == 0.0
    if case == "near_coincident":
        assert got["mAR_0.50"] == 1.0


# ---------------------------------------------------------------------------
# augmentor
# ---------------------------------------------------------------------------

STAGES = [
    dict(NAME="global_alignment", rotation_axis=2),
    dict(NAME="point_seg_class_mapping",
         valid_cat_ids=[3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33,
                        34, 36, 39], max_cat_id=40),
    dict(NAME="random_world_flip", ALONG_AXIS_LIST=["x", "y"]),
    dict(NAME="random_world_rotation", WORLD_ROT_ANGLE=[-0.087266, 0.087266]),
    dict(NAME="random_world_rotation_mmdet3d",
         WORLD_ROT_ANGLE=[-0.523599, 0.523599]),
    dict(NAME="random_world_scaling", WORLD_SCALE_RANGE=[0.85, 1.15]),
    dict(NAME="random_world_translation", ALONG_AXIS_LIST=["x", "y", "z"],
         NOISE_TRANSLATE_STD=0.1),
    dict(NAME="indoor_point_sample", num_points=1500),
]


def _aug_cfg(stages):
    return EasyDict(DISABLE_AUG_LIST=["placeholder"],
                    AUG_CONFIG_LIST=stages)


def _sample(seed):
    rng = np.random.RandomState(seed)
    pts, gt = synthetic_scene(rng, 1000, room=(3.0, 3.0, 2.5), n_objects=4,
                              yaw=True)
    a = 0.7
    m = np.eye(4, dtype=np.float32)
    m[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    m[:3, 3] = [1.0, -2.0, 0.5]
    return dict(points=pts, gt_boxes=gt[:, :7].copy(),
                gt_names=np.array(["chair", "bed", "sofa", "otherprop"]),
                gt_boxes_mask=np.array([True, True, True, False]),
                semantic_mask=rng.randint(0, 41, len(pts)).astype(np.int64),
                instance_mask=rng.randint(0, 5, len(pts)).astype(np.int64),
                axis_align_matrix=m)


@pytest.mark.parametrize("stage", STAGES + [STAGES],
                         ids=[s["NAME"] for s in STAGES] + ["all"])
@pytest.mark.parametrize("seed", [0, 1])
def test_augmentor_stage_equal(stage, seed):
    cfg = _aug_cfg(stage if isinstance(stage, list) else [stage])
    outs = []
    for mod in (paug, jaug):
        d = _sample(seed)
        np.random.seed(seed)
        outs.append(mod.DataAugmentor(None, copy.deepcopy(cfg),
                                      ["chair", "bed", "sofa"]).forward(d))
        outs[-1]["next_draw"] = np.random.rand(1)
    got, ref = outs
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("name", ["random_local_rotation",
                                  "random_local_translation",
                                  "random_world_frustum_dropout"])
def test_augmentor_unported_stage_raises(name):
    with pytest.raises(NotImplementedError, match=name):
        paug.DataAugmentor(None, _aug_cfg([dict(NAME=name)]), ["chair"])


# ---------------------------------------------------------------------------
# datasets and loader
# ---------------------------------------------------------------------------

def _data_cfg(name, root, n_points):
    """The dataset YAML as the model YAML includes it, on ``root``, with
    POINT_CAP the tree's point count and SUN RGB-D's point sample at it
    (so the test-mode sample keeps every point)."""
    cfg = load_config(CFGS[name])
    dc = cfg.DATA_CONFIG
    dc.DATA_PATH = str(root)
    dc.POINT_CAP = n_points
    dc.MAX_GT = 16
    for aug in (dc.DATA_AUGMENTOR_TRAIN, dc.DATA_AUGMENTOR_TEST):
        for st in aug.AUG_CONFIG_LIST:
            if st.NAME == "indoor_point_sample":
                st.num_points = n_points
    return cfg


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{name: (root, writer counts)}: 3-scene trees of both datasets."""
    out = {}
    for name in ("scannet", "sunrgbd"):
        root = tmp_path_factory.mktemp(name)
        names = load_config(CFGS[name]).CLASS_NAMES
        out[name] = root, write_indoor_tree(root, name, names, 3, seed=1,
                                            **SCENE)
    return out


def _batches(mod, cfg, training, batch_size=2):
    np.random.seed(7)
    _, loader, _ = mod.build_dataloader(
        copy.deepcopy(cfg.DATA_CONFIG), cfg.CLASS_NAMES, batch_size,
        training=training, seed=3)
    loader.set_epoch(1)
    return list(loader)


def _frame_counts(batch):
    """Per scene, the loaded points inside each valid GT box."""
    out = []
    for s in range(len(batch["frame_id"])):
        pts = batch["points"][s][batch["points_valid"][s]]
        gt = batch["gt_boxes"][s][batch["gt_valid"][s]]
        out.append(points_in_boxes(pts[:, :3], gt[:, :7]).sum(0))
    return out


@pytest.mark.parametrize("training", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("name", ["scannet", "sunrgbd"])
def test_loader_batches_equal(trees, name, training):
    root, counts = trees[name]
    cfg = _data_cfg(name, root, SCENE["n_points"])
    got = _batches(pds, cfg, training)
    ref = _batches(jds, cfg, training)
    assert len(got) == len(ref) == (3 * cfg.DATA_CONFIG.REPEAT.train // 2
                                    if training else 2)
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in r:
            if k == "frame_id":
                assert g[k] == r[k]
                continue
            assert g[k].dtype == r[k].dtype and g[k].shape == r[k].shape, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
        assert g["points"].shape == (len(g["frame_id"]),
                                     SCENE["n_points"], 6)
        assert g["gt_boxes"].shape == (len(g["frame_id"]), 16, 8)
        # the class filter drops the out-of-class object
        assert (g["gt_valid"].sum(1) == SCENE["n_objects"] - 1).all()
    if not training:
        for b in got:
            for fid, c in zip(b["frame_id"], _frame_counts(b)):
                np.testing.assert_array_equal(c, counts[fid])
                assert c.min() > 0


def _wrong_matrix(self, info):
    return np.eye(4, dtype=np.float32)


def _wrong_heading(self, annos):
    b = np.asarray(annos["gt_boxes_upright_depth"])[:, :7].astype(np.float32)
    b[:, 6] = -b[:, 6]
    return b


@pytest.mark.parametrize("name,attr,fault", [
    ("scannet", "get_axis_align_matrix", _wrong_matrix),
    ("sunrgbd", "get_gt", _wrong_heading)])
def test_frame_check_sees_a_frame_fault(trees, monkeypatch, name, attr,
                                        fault):
    """The frame check fails a loader that skips the axis-align matrix
    (ScanNet) or flips the heading (SUN RGB-D)."""
    root, counts = trees[name]
    cls = ScannetDataset if name == "scannet" else SunrgbdDataset
    monkeypatch.setattr(cls, attr, fault)
    b = _batches(pds, _data_cfg(name, root, SCENE["n_points"]), False)[0]
    assert any(not np.array_equal(c, counts[fid])
               for fid, c in zip(b["frame_id"], _frame_counts(b)))


def test_unported_dataset_and_stage_raise(trees):
    cfg = _data_cfg("scannet", trees["scannet"][0], SCENE["n_points"])
    dc = copy.deepcopy(cfg.DATA_CONFIG)
    dc.DATASET = "NuScenesDataset"
    with pytest.raises(NotImplementedError, match="NuScenesDataset"):
        pds.build_dataloader(dc, cfg.CLASS_NAMES, 1, training=False)
    dc = copy.deepcopy(cfg.DATA_CONFIG)
    dc.DATA_AUGMENTOR_TRAIN.AUG_CONFIG_LIST.append(
        EasyDict(NAME="random_local_rotation"))
    with pytest.raises(NotImplementedError, match="random_local_rotation"):
        pds.build_dataloader(dc, cfg.CLASS_NAMES, 1, training=True)


def test_loader_raises_worker_error_and_stops_early():
    """An error while loading reaches the consumer (the JAX package's
    loader waits forever there; ROADMAP.md section 3), and a consumer that
    stops early stops the prefetch thread."""

    class Items:
        def __len__(self):
            return 6

        def __getitem__(self, i):
            if i == 3:
                raise KeyError("scene 3")
            return i

        def collate_batch(self, items):
            return items

    loader = pds.DataLoader(Items(), batch_size=1, drop_last=False)
    got = []
    with pytest.raises(KeyError, match="scene 3"):
        for b in loader:
            got += b
    assert got == [0, 1, 2]
    n_threads = threading.active_count()
    it = iter(loader)
    assert next(it) == [0]
    it.close()
    assert threading.active_count() == n_threads


# ---------------------------------------------------------------------------
# harness and CLI
# ---------------------------------------------------------------------------

def _tiny_cfg(cfg, root):
    """``chip_smoke.tiny_model``'s widths at half its caps with a k3 class
    conv (the plain sparse conv's cost on the CPU follows the caps and the
    kernel volume: about 0.8 s a forward instead of 4 s)."""
    tiny_model(cfg.MODEL)
    cpu_caps(cfg.MODEL)
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    cfg.DATA_CONFIG.POINT_CAP = SCENE["n_points"]
    return cfg


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _logger(name):
    log = logging.getLogger(name)
    log.handlers.clear()
    log.propagate = False
    log.addHandler(_Records())
    log.setLevel(logging.INFO)
    return log


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """The tiny ScanNet model on a 2-scene tree, evaluated directly by the
    port's harness: the model, cfg, tree, result dir, returned dict, log
    lines and the forward's outputs by input."""
    root = tmp_path_factory.mktemp("harness_tree")
    cfg = _tiny_cfg(load_config(CFGS["scannet"]), root)
    write_indoor_tree(root, "scannet", cfg.CLASS_NAMES, 2, seed=2, **SCENE)
    model = build_model(cfg.MODEL, len(cfg.CLASS_NAMES), "cpu", seed=1)
    outs = {}
    forward = model.forward_eval     # the bound method

    def recorded(batch, cur_epoch=None):
        out = forward(batch, cur_epoch=cur_epoch)
        key = (batch["points"].numpy().tobytes(),
               batch["points_valid"].numpy().tobytes(), cur_epoch)
        outs[key] = {k: v.numpy() for k, v in out.items()}
        return out

    model.forward_eval = recorded
    ds, loader, _ = pds.build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 1,
                                         training=False)
    log = _logger("port_harness")
    res = tmp_path_factory.mktemp("port_result")
    ret = peu.eval_one_epoch(model, ds, loader, EVAL_EPOCH, log,
                             result_dir=res)
    del model.forward_eval
    return dict(model=model, cfg=cfg, root=root, res=res, ret=ret,
                lines=log.handlers[0].lines, outs=outs)


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _assert_annos_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in r:
            if k == "frame_id":
                assert g[k] == r[k]
            else:
                assert np.asarray(g[k]).dtype == np.asarray(r[k]).dtype, k
                np.testing.assert_array_equal(g[k], r[k], err_msg=k)


def test_eval_one_epoch_equal(harness, tmp_path):
    """The JAX package's harness, handed the port model's outputs on the
    batches its own loader gives, writes the same result.pkl, counts the
    same recall and returns the same dict as the port's."""
    h = harness
    calls = []

    def eval_step(params, state, batch, epoch):
        key = (np.asarray(batch["points"]).tobytes(),
               np.asarray(batch["points_valid"]).tobytes(), int(epoch))
        calls.append(key in h["outs"])
        return dict(h["outs"][key])

    ds, loader, _ = jds.build_dataloader(
        copy.deepcopy(h["cfg"].DATA_CONFIG), h["cfg"].CLASS_NAMES, 1,
        training=False)
    log = _logger("jax_harness")
    ret = jeu.eval_one_epoch(None, eval_step, None, None, ds, loader,
                             EVAL_EPOCH, log, result_dir=tmp_path)
    assert calls == [True, True]
    got = _load(h["res"] / "result.pkl")
    _assert_annos_equal(got, _load(tmp_path / "result.pkl"))
    assert sum(len(a["labels_3d"]) for a in got) > 0
    assert h["ret"] == ret
    assert {"mAP_0.25", "mAP_0.50", "mAR_0.25", "mAR_0.50"} <= set(ret)

    def recall(lines):
        return [ln for ln in lines if ln.startswith("recall_")]
    assert recall(h["lines"]) == recall(log.handlers[0].lines)
    assert len(recall(h["lines"])) == 2


def _params_np(model):
    P, S = flat_state(model)
    return ({k: v.detach().numpy().copy() for k, v in P.items()},
            {k: v.detach().numpy().copy() for k, v in S.items()})


def _cli(h, argv, monkeypatch, tmp_path, root=None):
    root = str(root or h["root"])
    args, cfg = cli.parse_config(
        ["--cfg_file", CFGS["scannet"], "--device", "cpu", *argv,
         "--set", "DATA_CONFIG.DATA_PATH", root])
    assert cfg.DATA_CONFIG.DATA_PATH == root
    _tiny_cfg(cfg, root)
    monkeypatch.chdir(tmp_path)
    return cli.main(args, cfg), \
        tmp_path / "output" / cfg.EXP_GROUP_PATH / cfg.TAG / "default" / \
        "eval"


def test_cli_reads_jax_checkpoint(harness, monkeypatch, tmp_path):
    """A checkpoint written by the JAX package's save_checkpoint from the
    tiny model's weights gives the detections of the model itself."""
    h = harness
    ckpt = str(tmp_path / "checkpoint_epoch_10.pkl")
    jax_save_checkpoint(ckpt, *_params_np(h["model"]), epoch=10)
    res, eval_dir = _cli(h, ["--ckpt", ckpt], monkeypatch, tmp_path)
    assert list(res) == [ckpt] and res[ckpt] == h["ret"]
    _assert_annos_equal(_load(eval_dir / "result.pkl"),
                        _load(h["res"] / "result.pkl"))


def test_cli_eval_all_in_epoch_order(harness, monkeypatch, tmp_path):
    """``--eval_all`` evaluates the checkpoints of both packages in epoch
    order (not write order) and stops when the wait runs out (a one-scene
    tree: two forwards)."""
    h = harness
    root = tmp_path / "tree"
    write_indoor_tree(root, "scannet", h["cfg"].CLASS_NAMES, 1, seed=3,
                      **SCENE)
    d = tmp_path / "ckpts"
    d.mkdir()
    save_checkpoint(str(d / "checkpoint_epoch_2.pkl"), h["model"], epoch=2)
    jax_save_checkpoint(str(d / "checkpoint_epoch_1.pkl"),
                        *_params_np(h["model"]), epoch=1)
    res, eval_dir = _cli(h, ["--eval_all", "--ckpt_dir", str(d),
                             "--max_waiting_mins", "0"], monkeypatch,
                         tmp_path, root)
    assert [p.rsplit("/", 1)[-1] for p in res] == [
        "checkpoint_epoch_1.pkl", "checkpoint_epoch_2.pkl"]
    one, two = (_load(eval_dir / f"epoch_{e}" / "result.pkl")
                for e in (1, 2))
    _assert_annos_equal(one, two)
    assert len(one) == 1 and len(one[0]["labels_3d"]) > 0


def test_dist_and_missing_card_raise(harness, monkeypatch, tmp_path):
    """``--dist`` outside torchrun, and ``eval_one_epoch(dist=True)``
    without a process group, raise instead of running one process
    (``tests/test_torch_dist.py`` runs them over two ranks)."""
    h = harness
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        _cli(h, ["--ckpt", "x.pkl", "--dist"], monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="process group"):
        peu.eval_one_epoch(h["model"], None, [], 0, None, dist=True)
    args, _ = cli.parse_config(["--cfg_file", CFGS["scannet"]])
    assert args.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _cli(h, ["--ckpt", "x.pkl", "--device", "cuda"], monkeypatch,
             tmp_path)
