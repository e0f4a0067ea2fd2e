"""PyTorch port vs the JAX package: KITTI infos, the eval dataset and its
batches, the prediction dicts, the official evaluator (the Python mirror
and the native matcher), and the ``test`` CLI (``--device cpu``) against
the JAX ``eval_one_epoch`` on a tiny SECOND, on synthetic KITTI trees
(``tests/test_kitti_infos.make_raw_kitti`` and the port's
``utils/synthetic.write_kitti_tree``).

Everything is compared exactly: both packages run the same numpy.
"""
import pickle
import shutil

import numpy as np
import jax
import pytest
import torch

from cagroup3d_tpu.config import EasyDict as JEasyDict
from cagroup3d_tpu.config import cfg_from_yaml_file as jload_cfg
from cagroup3d_tpu.core import hashing as jhash
from cagroup3d_tpu.datasets import build_dataloader as jbuild_loader
from cagroup3d_tpu.datasets import kitti_eval as JKE
from cagroup3d_tpu.datasets import kitti_infos as JKI
from cagroup3d_tpu.datasets.kitti_dataset import KittiDataset as JKitti
from cagroup3d_tpu.models import build_network as jbuild
from cagroup3d_tpu.training.checkpoint import save_checkpoint as jsave
from cagroup3d_tpu.training.eval_utils import eval_one_epoch as jeval
from cagroup3d_tpu_torch.config import EasyDict, cfg_from_yaml_file
from cagroup3d_tpu_torch.core import hashing
from cagroup3d_tpu_torch.datasets import build_dataloader
from cagroup3d_tpu_torch.datasets import kitti_eval as KE
from cagroup3d_tpu_torch.datasets import kitti_infos as KI
from cagroup3d_tpu_torch.datasets.kitti_dataset import KittiDataset
from cagroup3d_tpu_torch.models import build_network
from cagroup3d_tpu_torch.models.detectors.detector3d_template import \
    dataset_meta
from cagroup3d_tpu_torch.tools import test as cli
from cagroup3d_tpu_torch.utils.synthetic import write_kitti_tree
from test_kitti_eval import perfect_case, rand_frame
from test_kitti_infos import make_raw_kitti

torch.set_num_threads(1)
CFG = "tools/cfgs/kitti_models/second.yaml"
NAMES = ["Car", "Pedestrian", "Cyclist"]


def _same(a, b, path=""):
    """Deep equality of pickled structures (arrays by value and dtype)."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys(), path
        for k in b:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(b, np.ndarray):
        assert np.asarray(a).dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def _load(p):
    with open(p, "rb") as f:
        return pickle.load(f)


def _data_cfgs(root):
    cfg = cfg_from_yaml_file(CFG, EasyDict())
    jcfg = jload_cfg(CFG, JEasyDict())
    for c in (cfg, jcfg):
        c.DATA_CONFIG.DATA_PATH = str(root)
    return cfg, jcfg


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Six port-written frames of 30k points and 24 objects (48 of each
    class, enough for an AP of 100), and the JAX package's infos of the
    same raw tree in a copy."""
    root = tmp_path_factory.mktemp("kitti")
    in_range = write_kitti_tree(root, 6, n_points=30_000, seed=1,
                                n_objects=24, n_train=2)
    jroot = tmp_path_factory.mktemp("kitti_jax")
    shutil.copytree(root / "training", jroot / "training")
    shutil.copytree(root / "ImageSets", jroot / "ImageSets")
    JKI.create_kitti_infos(jroot, logger=None)
    return root, jroot, in_range


@pytest.mark.parametrize("source", ["make_raw_kitti", "write_kitti_tree"])
def test_infos_and_gt_database_match_jax(tmp_path, tree, source):
    """create_kitti_infos: the infos of every split, the dbinfos and the
    gt database's point files equal the JAX package's (a raw tree with
    images, whose sizes the port reads from the PNG header, and the
    writer's tree without images)."""
    if source == "make_raw_kitti":
        mine, ref = tmp_path / "port", tmp_path / "jax"
        for r in (mine, ref):
            make_raw_kitti(r, ids=("000000", "000001", "000002"))
        KI.create_kitti_infos(mine, logger=None)
        JKI.create_kitti_infos(ref, logger=None)
        shape = KI._image_shape(mine / "training/image_2/000000.png")
        assert shape.tolist() == JKI._image_shape(
            ref / "training/image_2/000000.png").tolist() == [375, 1242]
    else:
        mine, ref, _ = tree
    for name in ("kitti_infos_train.pkl", "kitti_infos_val.pkl",
                 "kitti_infos_trainval.pkl", "kitti_dbinfos_train.pkl"):
        _same(_load(mine / name), _load(ref / name), name)
    db = sorted(p.name for p in (ref / "gt_database").iterdir())
    assert db == sorted(p.name for p in (mine / "gt_database").iterdir())
    assert db
    for n in db:
        assert (mine / "gt_database" / n).read_bytes() == \
            (ref / "gt_database" / n).read_bytes()


def test_dataset_batches_match_jax(tree):
    """KittiDataset(eval): every frame and the loader's batches (batch 4,
    the last batch short) equal the JAX package's; points are 4 columns
    and frame_id a list of strings."""
    root, _, in_range = tree
    cfg, jcfg = _data_cfgs(root)
    ds = KittiDataset(cfg.DATA_CONFIG, NAMES, training=False)
    jds = JKitti(jcfg.DATA_CONFIG, NAMES, training=False)
    assert len(ds) == len(jds) == 6
    for i in range(6):
        _same(ds[i], jds[i], f"frame {i}")
        assert int(ds[i]["points_valid"].sum()) == \
            in_range[ds[i]["frame_id"]]
    _, loader, _ = build_dataloader(cfg.DATA_CONFIG, NAMES, 4,
                                    training=False)
    _, jloader, _ = jbuild_loader(jcfg.DATA_CONFIG, NAMES, 4,
                                  training=False)
    got, ref = list(loader), list(jloader)
    _same(got, ref, "batches")
    assert got[0]["points"].shape == (4, 65536, 4)
    assert got[1]["frame_id"] == ["000004", "000005"]
    with pytest.raises(NotImplementedError, match="training"):
        KittiDataset(cfg.DATA_CONFIG, NAMES, training=True)


def _gt_as_predictions(ds, shift=0.0):
    """Per frame the GT boxes of the infos as predictions (score 0.9,
    label the class), optionally moved by ``shift`` m along x."""
    preds = []
    for info in ds.infos:
        a = info["annos"]
        keep = np.isin(a["name"][:len(a["gt_boxes_lidar"])], NAMES)
        boxes = a["gt_boxes_lidar"][keep].copy()
        boxes[:, 0] += shift
        labels = np.array([NAMES.index(n) for n in
                           a["name"][:len(keep)][keep]], np.int32)
        preds.append(dict(pred_boxes=boxes,
                          pred_scores=np.full(len(boxes), 0.9, np.float32),
                          pred_labels=labels))
    return preds


def test_prediction_dicts_and_evaluation_match_jax(tree):
    """generate_prediction_dicts and the official evaluation (dict and
    table) equal the JAX package's on noisy predictions; GT boxes as
    predictions score 3D AP R40 100 on every class and difficulty the tree
    has, and 0 moved by 2 m."""
    root, _, _ = tree
    cfg, jcfg = _data_cfgs(root)
    ds = KittiDataset(cfg.DATA_CONFIG, NAMES, training=False)
    jds = JKitti(jcfg.DATA_CONFIG, NAMES, training=False)
    rs = np.random.RandomState(0)
    preds = _gt_as_predictions(ds)
    for p in preds:
        p["pred_boxes"][:, :3] += rs.randn(len(p["pred_boxes"]), 3) * 0.3
        p["pred_scores"] = rs.rand(len(p["pred_boxes"])).astype(np.float32)
    batch = {"frame_id": [i["point_cloud"]["lidar_idx"] for i in ds.infos]}
    annos = ds.generate_prediction_dicts(batch, preds, NAMES)
    _same(annos, jds.generate_prediction_dicts(batch, preds, NAMES))
    ret, table = ds.evaluation(annos, NAMES)
    jret, jtable = jds.evaluation(annos, NAMES)
    assert table == jtable
    _same({k: float(v) for k, v in ret.items()},
          {k: float(v) for k, v in jret.items()})
    for shift, want in ((0.0, 100.0), (2.0, 0.0)):
        annos = ds.generate_prediction_dicts(
            batch, _gt_as_predictions(ds, shift), NAMES)
        ret, _ = ds.evaluation(annos, NAMES)
        for c in NAMES:
            for d in ("easy", "moderate", "hard"):
                assert ret[f"{c}_3d/{d}_R40"] == pytest.approx(want), (c, d)


def test_official_eval_cases():
    """The evaluator on tests/test_kitti_eval.py's cases equals the JAX
    package's to the bit (the Python mirror on both sides), and perfect
    detections score 100."""
    gt, dt = perfect_case()
    ret_str, ret = KE.get_official_eval_result(gt, dt, ["Car"], native=False)
    jstr, jret = JKE.get_official_eval_result(gt, dt, ["Car"])
    assert ret_str == jstr and ret == jret
    assert ret["Car_3d/easy_R40"] > 99.0 and ret["Car_aos/easy_R40"] > 99.0
    rs = np.random.RandomState(0)
    frames = [rand_frame(rs, rs.randint(0, 8), rs.randint(0, 10))
              for _ in range(20)]
    gts = [f[0] for f in frames]
    dts = [f[1] for f in frames]
    for names in (["Car"], ["Car", "Pedestrian"]):
        ret_str, ret = KE.get_official_eval_result(gts, dts, names,
                                                   native=False)
        jstr, jret = JKE.get_official_eval_result(gts, dts, names)
        assert ret_str == jstr
        _same(ret, jret)


def test_native_matcher_matches_mirror():
    """The C++ matcher, built with the host compiler into .kernel_build/,
    against its Python mirror on random frames, every metric."""
    if KE.native_lib() is None:
        pytest.skip("no host C++ compiler")
    rs = np.random.RandomState(0)
    for metric in (0, 1, 2):
        frames = []
        for _ in range(12):
            gt, dt = rand_frame(rs, rs.randint(0, 8), rs.randint(0, 10))
            ov = KE._frame_overlaps([gt], [dt], metric)[0]
            _, ig, idt, dc = KE.clean_data(gt, dt, 0, 1)
            frames.append(dict(
                overlaps=ov,
                gt_datas=np.concatenate([gt["bbox"], gt["alpha"][:, None]],
                                        1),
                dt_datas=np.concatenate([dt["bbox"], dt["alpha"][:, None],
                                         dt["score"][:, None]], 1),
                ignored_gt=np.asarray(ig, np.int64),
                ignored_det=np.asarray(idt, np.int64), dc_bboxes=dc))
        thr = np.linspace(0.05, 0.95, 13)
        np.testing.assert_allclose(
            KE.stats_batch(frames, metric, 0.5, thr, True, native=True),
            KE.stats_batch(frames, metric, 0.5, thr, True, native=False),
            rtol=1e-10, atol=1e-10)


def _tiny_second(model_cfg):
    """second.yaml's MODEL at tiny widths on a 16 x 16 m range with a
    power-of-two voxel size (64 x 64 x 40 voxels, the final level 2 deep)."""
    model_cfg.update(
        POINT_CLOUD_RANGE=[0.0, -8.0, -3.0, 16.0, 8.0, 2.0],
        VOXEL_SIZE=[0.25, 0.25, 0.125], INPUT_CAP=4096)
    model_cfg.BACKBONE_3D.CAPS = {1: 4096, 2: 2048, 4: 1024, 8: 512}
    model_cfg.BACKBONE_2D.update(LAYER_NUMS=[1, 1], NUM_FILTERS=[16, 32],
                                 NUM_UPSAMPLE_FILTERS=[16, 16])
    model_cfg.DENSE_HEAD.update(NMS_CONFIG=dict(
        SCORE_THRESH=0.1, NMS_THRESH=0.01, NMS_PRE_MAXSIZE=512), MAX_OUT=64)
    return model_cfg


def test_cli_matches_jax_eval_one_epoch(monkeypatch, tmp_path):
    """The port's ``test`` CLI (``--device cpu``) on a JAX-package
    checkpoint of the tiny SECOND (class prior lifted so that it detects)
    writes the result.pkl and returns the metrics of the JAX
    ``eval_one_epoch`` over the JAX loader's batches, handed the port
    model's outputs (the model's own parity is test_torch_second.py's)."""
    root = tmp_path / "tree"
    write_kitti_tree(root, 2, n_points=20_000, seed=2)
    _, jcfg = _data_cfgs(root)
    _tiny_second(jcfg.MODEL)
    jcfg.DATA_CONFIG.POINT_CLOUD_RANGE = jcfg.MODEL.POINT_CLOUD_RANGE
    old = (jhash.XBITS, jhash.YBITS, jhash.ZBITS)
    jhash.set_key_bits(10, 10, 10)
    try:
        jds, jloader, _ = jbuild_loader(jcfg.DATA_CONFIG, NAMES, 1,
                                        training=False)
        jm = jbuild(jcfg.MODEL, 3, dataset=jds)
        P, S = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    finally:
        jhash.set_key_bits(*old)
    rs = np.random.RandomState(0)
    P = {k: (np.zeros(v.shape, np.float32) if k == "dense_head.conv_cls.bias"
             else rs.randn(*v.shape).astype(np.float32) * 0.1)
         for k, v in P.items()}
    S = {k: (np.ones if k.endswith("var") else np.zeros)(v.shape, np.float32)
         for k, v in S.items()}
    ckpt = str(tmp_path / "checkpoint_epoch_80.pkl")
    jsave(ckpt, P, S, epoch=80)
    args, cfg = cli.parse_config(["--cfg_file", CFG, "--device", "cpu",
                                  "--ckpt", ckpt, "--set",
                                  "DATA_CONFIG.DATA_PATH", str(root)])
    _tiny_second(cfg.MODEL)
    cfg.DATA_CONFIG.POINT_CLOUD_RANGE = cfg.MODEL.POINT_CLOUD_RANGE
    monkeypatch.chdir(tmp_path)
    res = cli.main(args, cfg)
    assert hashing.key_bits() == (10, 10, 10)
    got = _load(tmp_path / "output" / cfg.EXP_GROUP_PATH / cfg.TAG /
                "default" / "eval" / "result.pkl")

    pm = build_network(cfg.MODEL, 3, device="cpu",
                       dataset=dataset_meta(cfg.DATA_CONFIG, NAMES))
    pm.load_jax_params(P, S)

    def step(params, state, batch, epoch):
        out = pm.forward_eval({k: torch.from_numpy(np.array(batch[k]))
                               for k in ("points", "points_valid")})
        return {k: v.numpy() for k, v in out.items()}

    ref = jeval(None, step, P, S, jds, jloader, 80, _Log(),
                result_dir=tmp_path / "jax")
    want = _load(tmp_path / "jax" / "result.pkl")
    assert len(want) == 2 and all(len(a["name"]) > 0 for a in want)
    _same(got, want)
    assert res[ckpt] == ref


class _Log:
    def info(self, msg):
        pass

    warning = info
