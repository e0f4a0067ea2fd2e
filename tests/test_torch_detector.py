"""PyTorch port vs the JAX package: the tiny ScanNet CAGroup3D eval forward
(``__graft_entry__._build_model(tiny=True)``, semantic gate open) compared
stage by stage on identical parameters and inputs.

The backbone cuts run the JAX side jitted (its outputs do not depend on
XLA's fusion choices); the head, proposal and RoI stages run it eagerly,
op by op like PyTorch, because jitted XLA contracts the vote add into a
fused multiply-add and the per-class lattices then floor a few boundary
points differently.  Each stage is fed the JAX output of the stage before,
so a discrete step (threshold, top-k, NMS) sees identical inputs.

Tolerances: coordinates, masks and labels exact; features within 2e-2 of
the reference's max magnitude (bf16 conv gathers on both sides, summed in
another order); boxes and scores within 1e-3 absolute.
"""
import os
import subprocess
import sys
import tempfile

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__
from cagroup3d_tpu.core.module import Ctx as JCtx
from cagroup3d_tpu.utils.synthetic import synthetic_batch
from cagroup3d_tpu_torch.core import sparse_conv as core_conv
from cagroup3d_tpu_torch.core.module import Ctx
from cagroup3d_tpu_torch.core.sparse import SparseTensor
from cagroup3d_tpu_torch.models import build_network
from cagroup3d_tpu_torch.ops.sparse_conv import sources_sorted, sparse_conv

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BB_CUTS = ["stem", "layer1", "layer2", "fuse3", "fuse4", "layer5", "spp",
           None]
HEAD_CUTS = ["sem_offsets", "maps", "cls_convs", "up_fuse", None]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    return torch.from_numpy(np.array(x))


def _st(jst):
    return SparseTensor(_t(jst.coords), _t(jst.feats), _t(jst.valid),
                        jst.stride)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-9)


def _same_st(p, j, tol=2e-2):
    np.testing.assert_array_equal(p.valid.numpy(), np.asarray(j.valid))
    np.testing.assert_array_equal(p.coords.numpy(), np.asarray(j.coords))
    assert p.stride == j.stride
    assert _rel(p.feats.numpy(), j.feats) < tol


@pytest.fixture(scope="module")
def setup():
    jm = __graft_entry__._build_model(tiny=True)
    P, S = jax.jit(jm.init)(jax.random.PRNGKey(0))
    P = dict(P)
    # open the semantic gate (every voxel in every class map) and lift the
    # class prior so the untrained net emits proposals for the RoI head
    P["dense_head.semantic_conv.bias"] = P["dense_head.semantic_conv.bias"] * 0 + 5.0
    P["dense_head.cls_conv.bias"] = P["dense_head.cls_conv.bias"] * 0 + 2.0
    pm = build_network(jm.model_cfg, num_class=18, device="cpu")
    pm.load_jax_params({k: np.asarray(v) for k, v in P.items()},
                       {k: np.asarray(v) for k, v in S.items()})
    b = synthetic_batch(np.random.RandomState(0), batch_size=1,
                        n_points=1000, point_cap=1024, room=(3.0, 3.0, 2.5),
                        n_objects=4)
    pts, pv = b["points"][0], b["points_valid"][0]
    st, origin, _ = jm._voxelize_scene(jnp.asarray(pts), jnp.asarray(pv))

    @jax.jit
    def backbone_cuts(P, S, st):
        ctx = JCtx(train=False)
        return {str(c): jm.backbone_3d(P, S, ctx, st, stop_after=c)
                for c in BB_CUTS}

    bb = backbone_cuts(P, S, st)
    return dict(jm=jm, P=P, S=S, pm=pm, pts=pts, pv=pv, st=st,
                origin=origin, bb=bb, cache={})


def _port_ps(pm):
    return dict(pm.named_parameters()), dict(pm.named_buffers())


def _jax_head(setup, cut):
    """JAX head output at ``cut`` (eager), from the JAX backbone output."""
    key = ("head", cut)
    if key not in setup["cache"]:
        setup["cache"][key] = setup["jm"].dense_head.forward(
            setup["P"], setup["S"], JCtx(train=False), setup["bb"]["None"],
            jnp.float32(0.05), stop_after=cut)
    return setup["cache"][key]


def test_load_jax_params_rejects_bad_names(setup):
    pm = build_network(setup["jm"].model_cfg, num_class=18, device="cpu")
    P = {k: np.asarray(v) for k, v in setup["P"].items()}
    S = {k: np.asarray(v) for k, v in setup["S"].items()}
    with pytest.raises(KeyError):
        pm.load_jax_params({k: v for k, v in P.items()
                            if k != "roi_head.reg_pred_layer.bias"}, S)
    bad = dict(P)
    bad["backbone_3d.conv1.0.kernel"] = np.zeros((27, 3, 5), np.float32)
    with pytest.raises(ValueError):
        pm.load_jax_params(bad, S)


def test_load_jax_checkpoint_file(setup, tmp_path):
    from cagroup3d_tpu.training.checkpoint import save_checkpoint
    path = str(tmp_path / "ckpt.pkl")
    save_checkpoint(path, setup["P"], setup["S"])
    pm = build_network(setup["jm"].model_cfg, num_class=18, device="cpu")
    pm.load_jax_params(path)
    for k, v in pm.named_parameters():
        np.testing.assert_array_equal(v.detach().numpy(),
                                      np.asarray(setup["P"][k]))


def test_voxelize_scene(setup):
    ctx = Ctx()
    st, origin, _ = setup["pm"]._voxelize_scene(
        _t(setup["pts"]), _t(setup["pv"]), ctx.stats)
    _same_st(st, setup["st"], tol=1e-6)
    np.testing.assert_allclose(origin.numpy(), np.asarray(setup["origin"]))


@pytest.mark.parametrize("cut", BB_CUTS, ids=[str(c) for c in BB_CUTS])
def test_backbone_cut(setup, cut):
    P, S = _port_ps(setup["pm"])
    with torch.no_grad():
        out = setup["pm"].backbone_3d(P, S, Ctx(), _st(setup["st"]),
                                      stop_after=cut)
    ref = setup["bb"][str(cut)]
    if isinstance(ref, tuple):
        for p, j in zip(out, ref):
            _same_st(p, j)
    else:
        _same_st(out, ref)


@pytest.mark.parametrize("cut", HEAD_CUTS, ids=[str(c) for c in HEAD_CUTS])
def test_head_cut(setup, cut):
    ref = _jax_head(setup, cut)
    P, S = _port_ps(setup["pm"])
    with torch.no_grad():
        out = setup["pm"].dense_head(P, S, Ctx(), _st(setup["bb"]["None"]),
                                     0.05, stop_after=cut)
    assert set(out) == set(ref)
    for k, v in out.items():
        r = np.asarray(ref[k])
        v = v.numpy()
        if r.dtype == bool or np.issubdtype(r.dtype, np.integer):
            np.testing.assert_array_equal(v, r, err_msg=k)
        else:
            assert v.shape == r.shape, k
            assert _rel(v, r) < 2e-2, (k, _rel(v, r))


def _jax_props(setup):
    if "props" not in setup["cache"]:
        setup["cache"]["props"] = setup["jm"].dense_head.get_bboxes(
            _jax_head(setup, None))
    return setup["cache"]["props"]


def test_proposals(setup):
    ref = _jax_props(setup)
    head = {k: _t(v) for k, v in _jax_head(setup, None).items()}
    boxes, scores, labels, valid = setup["pm"].dense_head.get_bboxes(head)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref[3]))
    assert valid.sum() > 0
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(boxes.numpy(), np.asarray(ref[0]), atol=1e-3)
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref[1]), atol=1e-3)


def _jax_roi(setup):
    if "roi" not in setup["cache"]:
        b, s, l, v = _jax_props(setup)
        setup["cache"]["roi"] = setup["jm"].roi_head.forward_test(
            setup["P"], setup["S"], JCtx(train=False), setup["bb"]["None"],
            b, s, l.astype(jnp.int32), v)
    return setup["cache"]["roi"]


def test_roi_head(setup):
    ref = _jax_roi(setup)
    b, s, l, v = (_t(x) for x in _jax_props(setup))
    P, S = _port_ps(setup["pm"])
    with torch.no_grad():
        out = setup["pm"].roi_head(P, S, Ctx(), _st(setup["bb"]["None"]),
                                   b, s, l, v)
    assert _rel(out["rcnn_reg"].numpy(), ref["rcnn_reg"]) < 2e-2
    np.testing.assert_array_equal(out["batch_pred_valid"].numpy(),
                                  np.asarray(ref["batch_pred_valid"]))
    assert out["batch_pred_valid"].sum() > 0
    np.testing.assert_array_equal(out["batch_cls_preds"].numpy(),
                                  np.asarray(ref["batch_cls_preds"]))
    np.testing.assert_allclose(out["batch_box_preds"].numpy(),
                               np.asarray(ref["batch_box_preds"]), atol=1e-3)
    np.testing.assert_allclose(out["batch_score_preds"].numpy(),
                               np.asarray(ref["batch_score_preds"]),
                               atol=1e-3)


def test_forward_eval_end_to_end(setup):
    """The port's whole forward_eval against the JAX stage chain (final
    boxes shifted back by the JAX origin)."""
    ref = _jax_roi(setup)
    out = setup["pm"].forward_eval(
        {"points": _t(setup["pts"][None]),
         "points_valid": _t(setup["pv"][None])}, cur_epoch=10)
    assert out["pred_boxes"].shape == (1, 32, 7)
    np.testing.assert_array_equal(out["pred_valid"][0].numpy(),
                                  np.asarray(ref["batch_pred_valid"]))
    np.testing.assert_array_equal(out["pred_labels"][0].numpy(),
                                  np.asarray(ref["batch_cls_preds"]))
    boxes = np.asarray(ref["batch_box_preds"]).copy()
    boxes[:, :3] += np.asarray(setup["origin"])
    np.testing.assert_allclose(out["pred_boxes"][0].numpy(), boxes,
                               atol=1e-3)
    np.testing.assert_allclose(out["pred_scores"][0].numpy(),
                               np.asarray(ref["batch_score_preds"]),
                               atol=1e-3)


def test_main_path_sources_are_key_sorted(setup, monkeypatch):
    """Every K1 call of the forward hands it a key-sorted source table with
    invalid rows last, the contract the kernel relies on."""
    calls = []

    def record(src_lat, src_valid, *args, **kw):
        calls.append(sources_sorted(src_lat, src_valid))
        return sparse_conv(src_lat, src_valid, *args, **kw)

    monkeypatch.setattr(core_conv, "sparse_conv", record)
    setup["pm"].forward_eval(
        {"points": _t(setup["pts"][None]),
         "points_valid": _t(setup["pv"][None])}, cur_epoch=10)
    assert len(calls) > 30
    assert all(calls), [i for i, ok in enumerate(calls) if not ok]


def test_port_imports_no_jax():
    """The port's tiny eval forward and one tiny training step, ScanNet and
    SUN RGB-D (the yaw path, headed GT boxes), of CAGroup3D and of RBGNet,
    SECOND's KITTI eval and one training step (a synthetic tree's
    infos, the eval and the train loader with gt sampling, a tiny
    forward at KITTI's grid, the prediction dicts and the official
    evaluation), and the tiny PointPillar, SECOND-multihead, SECOND-IoU,
    CenterPoint and Voxel R-CNN of their YAMLs (``chip_smoke.tiny_zoo_config``: an eval
    forward and one training step each), and the imports of the ``demo``
    CLI, ``native_io`` (its library built or its fallback chosen) and the
    headless renderer, run in three processes (the indoor models, SECOND,
    the zoo) where jax and the JAX package are blocked."""
    prelude = (
        "import sys; sys.modules['jax'] = None\n"
        "sys.modules['cagroup3d_tpu'] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from cagroup3d_tpu_torch.models import build_network, load_config\n"
        "from cagroup3d_tpu_torch.parallel.mesh import make_train_step\n"
        "from cagroup3d_tpu_torch.training.optimization import "
        "build_optimizer\n"
        "from cagroup3d_tpu_torch.utils.synthetic import synthetic_batch\n"
        "import cagroup3d_tpu_torch.datasets\n"
        "import cagroup3d_tpu_torch.training.eval_utils\n"
        "import cagroup3d_tpu_torch.tools.test\n"
        "import cagroup3d_tpu_torch.tools.train\n"
        "import cagroup3d_tpu_torch.tools.overfit_check\n"
        "import cagroup3d_tpu_torch.tools.demo\n"
        "import cagroup3d_tpu_torch.tools.visual_utils.headless_vis_utils\n"
        "from cagroup3d_tpu_torch.datasets import native_io\n"
        "assert native_io.io_path() in ('native', 'numpy')\n"
        "import cagroup3d_tpu_torch.utils.commu_utils\n"
        "from chip_smoke import synthetic_train_batch\n")
    indoor = (
        "for name in ('scannet', 'sunrgbd'):\n"
        "    cfg = load_config(f'tools/cfgs/{name}_models/CAGroup3D.yaml')\n"
        "    mc, names = cfg.MODEL, cfg.CLASS_NAMES\n"
        "    yaw = bool(mc.DENSE_HEAD.WITH_YAW)\n"
        "    mc.BACKBONE_3D.update(CAPS={1: 1024, 2: 1024, 4: 512, 8: 256, "
        "16: 128, 32: 64, 64: 16, 128: 8, 256: 8, 512: 8}, PLANES=8, "
        "SPP_PLANES=8, OUT_CHANNELS=8)\n"
        "    mc.INPUT_CAP = 1024\n"
        "    mc.DENSE_HEAD.update(OUT_CHANNELS=8, CLS_KERNEL=3, FINE_CAP=256, "
        "EXPAND_CAP=128, MAX_ROIS=16, NMS_PER_CLS_CAP=16)\n"
        "    mc.DENSE_HEAD.NMS_CONFIG.NMS_PRE = 64\n"
        "    mc.ROI_HEAD.update(MLPS=[[8, 16, 16]], REG_FC=[16, 16], "
        "GRID_CAP=512, NMS_PER_CLS_CAP=16, MAX_OUT=16, ROI_PER_IMAGE=8)\n"
        "    m = build_network(mc, len(names), device='cpu')\n"
        "    b = synthetic_batch(np.random.RandomState(0), batch_size=1, "
        "n_points=1000, point_cap=1024, room=(3., 3., 2.5), n_objects=4, "
        "n_classes=len(names), yaw=yaw)\n"
        "    out = m.forward_eval({k: torch.from_numpy(b[k]) for k in "
        "('points', 'points_valid')})\n"
        "    assert torch.isfinite(out['pred_boxes']).all()\n"
        "    opt, _ = build_optimizer(m, cfg.OPTIMIZATION, 10)\n"
        "    step = make_train_step(m, opt, device='cpu')\n"
        "    tb = step(synthetic_train_batch(0, 'cpu', 1, n_points=1000, "
        "room=(3., 3., 2.5), n_objects=4, n_classes=len(names), "
        "yaw=yaw))[1]\n"
        "    assert all(bool(torch.isfinite(v)) for v in tb.values()), tb\n"
        "    assert ('rcnn_loss_iou' in tb) == yaw, tb\n"
        "    assert opt.count == 1\n"
        "import cagroup3d_tpu_torch.core.pointnet2\n"
        "import cagroup3d_tpu_torch.models.detectors.rbgnet\n"
        "from chip_smoke import tiny_rbg_model\n"
        "for name in ('scannet', 'sunrgbd'):\n"
        "    cfg = load_config(f'tools/cfgs/{name}_models/RBGNet.yaml')\n"
        "    names = cfg.CLASS_NAMES\n"
        "    m = build_network(tiny_rbg_model(cfg.MODEL), len(names), "
        "device='cpu')\n"
        "    b = synthetic_train_batch(0, 'cpu', 2, n_points=1000, "
        "room=(3., 3., 2.5), n_objects=4, n_classes=len(names), "
        "yaw=name == 'sunrgbd')\n"
        "    out = m.forward_eval({k: b[k][:1] for k in ('points', "
        "'points_valid')})\n"
        "    assert torch.isfinite(out['pred_boxes']).all()\n"
        "    opt, _ = build_optimizer(m, cfg.OPTIMIZATION, 10)\n"
        "    tb = make_train_step(m, opt, device='cpu')(b)[1]\n"
        "    assert all(bool(torch.isfinite(v)) for v in tb.values()), tb\n")
    kitti = (
        "import tempfile\n"
        "import cagroup3d_tpu_torch.tools.create_infos\n"
        "from cagroup3d_tpu_torch.datasets import build_dataloader\n"
        "from cagroup3d_tpu_torch.utils.synthetic import write_kitti_tree\n"
        "cfg = load_config('tools/cfgs/kitti_models/second.yaml')\n"
        "names = cfg.CLASS_NAMES\n"
        "mc = cfg.MODEL\n"
        "mc.INPUT_CAP = 4096\n"
        "mc.BACKBONE_3D.CAPS = {1: 4096, 2: 2048, 4: 1024, 8: 512}\n"
        "mc.BACKBONE_2D.update(LAYER_NUMS=[1, 1], NUM_FILTERS=[16, 32], "
        "NUM_UPSAMPLE_FILTERS=[16, 16])\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    write_kitti_tree(d, 1, n_points=20000)\n"
        "    cfg.DATA_CONFIG.DATA_PATH = d\n"
        "    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, names, 1, "
        "training=False)\n"
        "    m = build_network(mc, len(names), device='cpu', dataset=ds)\n"
        "    assert m.key_bits == (11, 11, 8)\n"
        "    b = next(iter(loader))\n"
        "    out = m.forward_eval({k: torch.from_numpy(b[k]) for k in "
        "('points', 'points_valid')})\n"
        "    assert torch.isfinite(out['pred_boxes']).all()\n"
        "    v = out['pred_valid'][0]\n"
        "    annos = ds.generate_prediction_dicts(b, [dict(pred_boxes="
        "out['pred_boxes'][0][v].numpy(), pred_scores=out['pred_scores']"
        "[0][v].numpy(), pred_labels=out['pred_labels'][0][v].numpy())], "
        "names)\n"
        "    ret, table = ds.evaluation(annos, names)\n"
        "    assert 'Car_3d/moderate_R40' in ret, ret\n"
        "    from cagroup3d_tpu_torch.training.optimization import "
        "build_optimizer\n"
        "    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, names, 1, "
        "training=True)\n"
        "    m = build_network(mc, len(names), device='cpu', dataset=ds)\n"
        "    opt, _ = build_optimizer(m, cfg.OPTIMIZATION, 1, "
        "total_epochs=2)\n"
        "    b = next(iter(loader))\n"
        "    loss, tb = make_train_step(m, opt, device='cpu')("
        "{k: torch.from_numpy(v) for k, v in b.items() if k != 'frame_id'})\n"
        "    assert bool(torch.isfinite(loss)), tb\n"
        "    assert float(tb['rpn_loss_loc']) > 0, tb\n")
    zoo = (
        "from chip_smoke import ZOO, ZOO_CFGS, box_term, kitti_request, "
        "kitti_train_batch, tiny_zoo_config, zoo_model\n"
        "for name in ZOO:\n"
        "    cfg = load_config(ZOO_CFGS[name])\n"
        "    m = zoo_model(name, cfg, 'cpu', seed=0, tiny=True)\n"
        "    out = m.forward_eval(kitti_request(cfg, 0, 'cpu', "
        "n_points=20000))\n"
        "    assert torch.isfinite(out['pred_boxes']).all()\n"
        "    assert int(out['pred_valid'].sum()) > 0, name\n"
        "    opt, _ = build_optimizer(m, cfg.OPTIMIZATION, 1, "
        "total_epochs=2)\n"
        "    loss, tb = make_train_step(m, opt, device='cpu')("
        "kitti_train_batch(cfg, (1,), 'cpu', 20000))\n"
        "    assert bool(torch.isfinite(loss)), tb\n"
        "    assert float(box_term(tb)) > 0, tb\n"
        "    assert ('rcnn_loss_iou' in tb) == (name == 'second_iou'), tb\n"
        "    assert ('rcnn_loss_corner' in tb) == (name == 'voxel_rcnn_car'),"
        " tb\n")
    epilogue = (
        "assert sys.modules['jax'] is None\n"
        "assert sys.modules['cagroup3d_tpu'] is None\n"
        "print('OK')\n")
    # three processes at once (the indoor models, SECOND's KITTI path, the
    # zoo: 12, 28 and 30 s alone), each blocking jax and the JAX package
    env = dict(os.environ, PYTHONPATH=REPO)
    runs = []
    try:
        for part in (indoor, kitti, zoo):
            out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile(
                "w+")
            runs.append((subprocess.Popen(
                [sys.executable, "-c", prelude + part + epilogue], cwd=REPO,
                env=env, stdout=out, stderr=err, text=True), out, err))
        for proc, out, err in runs:
            rc = proc.wait(timeout=300)
            out.seek(0)
            err.seek(0)
            assert rc == 0, err.read()[-2000:]
            assert out.read().strip().endswith("OK")
    finally:
        for proc, out, err in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
            err.close()
