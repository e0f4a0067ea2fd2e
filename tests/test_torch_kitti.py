"""PyTorch port vs the JAX package: KITTI infos, the eval dataset and its
batches, the prediction dicts, the official evaluator (the Python mirror
and the native matcher), and the ``test`` CLI (``--device cpu``) against
the JAX ``eval_one_epoch`` on a tiny SECOND, on synthetic KITTI trees
(``tests/test_kitti_infos.make_raw_kitti`` and the port's
``utils/synthetic.write_kitti_tree``).

Everything is compared exactly: both packages run the same numpy.
"""
import copy
import pickle
import shutil
from pathlib import Path

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
    dc = copy.deepcopy(cfg.DATA_CONFIG)
    dc.DATA_AUGMENTOR.AUG_CONFIG_LIST.append(
        EasyDict(NAME="random_local_rotation", LOCAL_ROT_ANGLE=0.1))
    with pytest.raises(NotImplementedError, match="random_local_rotation"):
        KittiDataset(dc, NAMES, training=True)


def test_train_frames_and_batches_match_jax(tree):
    """KittiDataset(train) from the same ``np.random`` seed as the JAX
    package's: the augmentor's output (gt sampling over the tree's
    database, the world flip, rotation and scaling: points, boxes and
    names), every frame over two passes (the sampler's permutations move
    on) and the loader's batch, bit for bit; gt sampling pastes boxes."""
    from cagroup3d_tpu.datasets.augmentor import DataAugmentor as JAug
    from cagroup3d_tpu_torch.datasets.augmentor import DataAugmentor
    root = tree[0]
    cfg, jcfg = _data_cfgs(root)
    runs = []
    for aug_cls, ds_cls, c, loader_fn in (
            (DataAugmentor, KittiDataset, cfg, build_dataloader),
            (JAug, JKitti, jcfg, jbuild_loader)):
        np.random.seed(0)
        ds = ds_cls(c.DATA_CONFIG, NAMES, training=True)
        info = ds.infos[0]
        d = dict(points=ds.get_points(info["point_cloud"]["lidar_idx"]),
                 gt_boxes=np.asarray(info["annos"]["gt_boxes_lidar"],
                                     np.float32).copy(),
                 gt_names=info["annos"]["name"][
                     info["annos"]["name"] != "DontCare"])
        d["gt_boxes_mask"] = np.isin(d["gt_names"], NAMES)
        n_gt = len(d["gt_boxes"])
        out = [aug_cls(root, c.DATA_CONFIG.DATA_AUGMENTOR, NAMES).forward(d)]
        out += [ds[i] for _ in range(2) for i in range(len(ds))]
        _, loader, _ = loader_fn(c.DATA_CONFIG, NAMES, 2, training=True)
        out += list(loader)
        out.append(np.random.rand(1))
        runs.append(out)
    _same(runs[0], runs[1], "train")
    assert len(runs[0][0]["gt_boxes"]) > n_gt
    assert runs[0][1]["gt_valid"].sum() > n_gt
    assert len(runs[0]) == 1 + 4 + 1 + 1


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


def _jax_train_cli():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "jax_tools_train", "tools/train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_cli_matches_jax_and_resumes(tree, monkeypatch, tmp_path):
    """The port's ``train`` CLI on second.yaml against the JAX
    ``tools/train.py`` up to its ``train_model`` call (a recorder in its
    place; the JAX run with ``--fix_random_seed``, the port's seeds are
    always fixed): the parsed cfg, the train loader's batch (gt sampling
    included) and adam_onecycle's lr and momentum over the run.  Then the
    port CLI trains the tiny SECOND for one epoch and resumes for a second
    (the optimizer's count and beta1 restored); its checkpoint holds the
    JAX init's names and shapes (``jax.eval_shape``) and the port's
    ``test`` CLI evaluates it."""
    import functools
    import sys
    import cagroup3d_tpu.config as jconfig
    import cagroup3d_tpu.training.train_loop as jloop
    from cagroup3d_tpu.training.checkpoint import load_checkpoint as jload
    from cagroup3d_tpu.training.optimization import onecycle_schedules
    from cagroup3d_tpu_torch.tools import train as tcli
    from cagroup3d_tpu_torch.training import train_loop
    root = tree[0]
    tail = ["--set", "DATA_CONFIG.DATA_PATH", str(root)]
    cfg_file = str(Path(CFG).resolve())
    argv = ["--cfg_file", cfg_file, "--batch_size", "2", "--epochs", "3"] + \
        tail
    seen = {}
    jmod = _jax_train_cli()
    monkeypatch.setattr(jconfig, "cfg", jconfig.EasyDict())
    monkeypatch.setattr(sys, "argv", ["train.py", "--fix_random_seed",
                                      *argv])
    jargs, jcfg = jmod.parse_config()
    args, cfg = tcli.parse_config(argv[:6] + ["--device", "cpu"] + tail)
    assert _same_cfg(cfg, jcfg)
    for c in (cfg, jcfg):
        _tiny_second(c.MODEL)
        c.DATA_CONFIG.POINT_CLOUD_RANGE = c.MODEL.POINT_CLOUD_RANGE

    def jax_train(model, tx, schedule, train_step, params, state, opt_state,
                  train_loader, total_epochs, ckpt_dir, logger, **kw):
        seen["jax"] = (list(train_loader), schedule, total_epochs,
                       jax.tree_util.tree_map(np.shape, (params, state)))

    def port_train(model, optimizer, train_loader, total_epochs, ckpt_dir,
                   logger, **kw):
        seen["port"] = (list(train_loader), optimizer, total_epochs)

    monkeypatch.setattr(jmod, "parse_config", lambda: (jargs, jcfg))
    monkeypatch.setattr(jloop, "train_model", jax_train)
    monkeypatch.setattr(tcli, "train_model", port_train)
    monkeypatch.chdir(tmp_path)
    old = (jhash.XBITS, jhash.YBITS, jhash.ZBITS)
    jhash.set_key_bits(10, 10, 10)
    try:
        jmod.main()
    finally:
        jhash.set_key_bits(*old)
    tcli.main(args, cfg)
    (jb, jsched, jep, jshapes), (pb, opt, pep) = seen["jax"], seen["port"]
    assert len(pb) == len(jb) == 1 and pep == jep == 3
    _same(pb, jb, "batches")
    assert int(pb[0]["gt_valid"].sum()) > 2 * 24 // 2
    _, jmom = onecycle_schedules(jcfg.OPTIMIZATION, 3)
    for t in range(4):
        assert abs(opt.schedule(t) - float(jsched(t))) <= \
            1e-6 * float(jsched(t))
        assert abs(opt.momentum(t) - float(jmom(t))) <= 1e-6

    monkeypatch.setattr(tcli, "train_model", functools.partial(
        train_loop.train_model, log_interval=1))
    for epochs in ("1", "2"):
        a, c = tcli.parse_config(argv[:4] + ["--epochs", epochs, "--device",
                                             "cpu"] + tail)
        _tiny_second(c.MODEL)
        c.DATA_CONFIG.POINT_CLOUD_RANGE = c.MODEL.POINT_CLOUD_RANGE
        out = tcli.main(a, c)
    assert hashing.key_bits() == (10, 10, 10)
    one = _load(out / "ckpt" / "checkpoint_epoch_1.pkl")
    two = _load(out / "ckpt" / "checkpoint_epoch_2.pkl")
    assert (one["epoch"], two["epoch"], two["it"]) == (1, 2, 2)
    assert two["opt_state"]["count"] == 2
    from cagroup3d_tpu_torch.training.optimization import \
        onecycle_schedules as port_onecycle
    # the second step's beta1, of the 2-epoch run's schedule
    assert two["opt_state"]["opt"]["param_groups"][0]["betas"][0] == \
        port_onecycle(c.OPTIMIZATION, 2)[1](1)
    assert any(not np.array_equal(one["params"][k], two["params"][k])
               for k in one["params"])
    ck = jload(str(out / "ckpt" / "checkpoint_epoch_2.pkl"))
    P, S = jshapes
    for mine, theirs in ((ck["params"], P), (ck["state"], S)):
        assert {k: v.shape for k, v in mine.items()} == theirs
    targs, tcfg = cli.parse_config(
        ["--cfg_file", cfg_file, "--device", "cpu", "--ckpt",
         str(out / "ckpt" / "checkpoint_epoch_2.pkl")] + tail)
    _tiny_second(tcfg.MODEL)
    tcfg.DATA_CONFIG.POINT_CLOUD_RANGE = tcfg.MODEL.POINT_CLOUD_RANGE
    res = cli.main(targs, tcfg)
    assert len(res) == 1


def _same_cfg(a, b):
    def plain(d):
        if isinstance(d, dict):
            return {k: plain(v) for k, v in d.items()}
        if isinstance(d, (list, tuple)):
            return [plain(v) for v in d]
        return d
    return plain(a) == plain(b)
