"""PyTorch port vs the JAX package: the rest of KITTI's anchor family on
SECOND's base -- PointPillar (PillarVFE, PointPillarScatter) and SECOND
with AnchorHeadMulti (second_multihead.yaml) here, SECOND-IoU (SECONDHead)
in ``test_torch_second_iou.py`` with the helpers of this file -- at tiny
widths (``tests/test_outdoor.py::pillar_cfg``, ``second_cfg`` with the
multi-head of second_multihead.yaml, ``tests/test_second_iou.py::
second_iou_cfg``; the head alone also at ``tests/test_nuscenes.py``'s
AnchorHeadMulti config), on identical parameters and inputs from numpy
seeds.

Each stage is fed the JAX output of the stage before, so a discrete step
(top-k, NMS, the assigner) sees identical inputs.  The sparse half of the
two SECOND variants (MeanVFE, VoxelBackBone8x, HeightCompression) is
SECOND's, which ``test_torch_second.py`` and ``test_torch_second_train.py``
hold; here their stages run from a seeded BEV map on.  PointPillar has no
sparse conv and is held whole, from the points on.

Where the untrained head's scores tie within ulps (every anchor at the
class prior), the proposals and the NMS run on seeded class logits, and the
training comparisons hand the port the JAX step's proposals; the assigner
reads the JAX IoU matrices (contained anchors tie in exact arithmetic, see
``test_torch_second_train.py``).  The RoI sampling takes the JAX step's
draws, and SECOND-IoU's dropout is off (``DP_RATIO`` 0) in the training
comparisons: the port draws its masks from a ``torch.Generator``.  The
JAX step stops the gradient at the proposals, as the reference and the
port do (the JAX package's own SECOND-IoU lets it flow into the box
predictions; ROADMAP.md section 3).

Tolerances: lattices, masks, labels, NMS keep masks exact; f32 features,
head outputs, decoded boxes and IoU logits within 1e-4 relative to the
largest magnitude (1e-5 for the VFE); loss terms within 1e-4 relative;
gradients within 1e-3 in norm per module; BN running statistics within
1e-4 of each buffer's scale; the target layer's IoUs within 1e-4 (boxes
60 m out lose about that to the shoelace sum's cancellation).
"""
import copy
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cagroup3d_tpu.config import EasyDict as JEasyDict
from cagroup3d_tpu.config import cfg_from_yaml_file as jload_cfg
from cagroup3d_tpu.core import hashing as jhash
from cagroup3d_tpu.core.module import Ctx as JCtx
from cagroup3d_tpu.models import build_network as jbuild
from cagroup3d_tpu.models.dense_heads.anchor_head import bev_iou as jbev_iou
from cagroup3d_tpu.models.dense_heads.anchor_head_multi import \
    AnchorHeadMulti as JMulti
from cagroup3d_tpu_torch.config import EasyDict
from cagroup3d_tpu_torch.core import hashing
from cagroup3d_tpu_torch.core.module import Ctx, flat_state
from cagroup3d_tpu_torch.core.sparse import SparseTensor
from cagroup3d_tpu_torch.models import build_network, load_config
from cagroup3d_tpu_torch.models.dense_heads.anchor_head_multi import \
    AnchorHeadMulti
from cagroup3d_tpu_torch.models.detectors.cagroup3d import run_scenes
from cagroup3d_tpu_torch.core.norm import SceneSync
from cagroup3d_tpu_torch.models.detectors.detector3d_template import \
    dataset_meta
from test_centerpoint import centerpoint_cfg
from test_nuscenes import multihead_cfg as nusc_multihead_cfg
from test_outdoor import outdoor_batch, pillar_cfg, second_cfg
from test_second_iou import second_iou_cfg

torch.set_num_threads(1)
DEFAULT_BITS = (10, 10, 10)
NAMES = ["Car", "Pedestrian", "Cyclist"]
YAMLS = {"centerpoint": "tools/cfgs/kitti_models/centerpoint.yaml",
         "pointpillar": "tools/cfgs/kitti_models/pointpillar.yaml",
         "second_multihead": "tools/cfgs/kitti_models/second_multihead.yaml",
         "second_iou": "tools/cfgs/kitti_models/second_iou.yaml"}


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def _rel_norm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


def multihead_cfg():
    """second_cfg with second_multihead.yaml's head: a shared 3x3 conv,
    one 1x1 sub-head per class, direction bins, the model's
    POST_PROCESSING NMS."""
    c = second_cfg()
    c.DENSE_HEAD.NAME = "AnchorHeadMulti"
    c.DENSE_HEAD.update(SHARED_CONV_NUM_FILTER=16, USE_MULTIHEAD=True,
                        SEPARATE_MULTIHEAD=True,
                        RPN_HEAD_CFGS=[dict(HEAD_CLS_NAME=["Car"]),
                                       dict(HEAD_CLS_NAME=["Pedestrian"])])
    c.POST_PROCESSING = EasyDict(dict(
        RECALL_THRESH_LIST=[0.3, 0.5, 0.7], SCORE_THRESH=0.1,
        NMS_CONFIG=dict(MULTI_CLASSES_NMS=True, NMS_THRESH=0.1,
                        NMS_PRE_MAXSIZE=128, NMS_POST_MAXSIZE=64)))
    return c


def iou_cfg(dp_ratio=0.3):
    c = second_iou_cfg()
    c.ROI_HEAD.ROI_GRID_POOL.IN_CHANNEL = 64
    c.ROI_HEAD.DP_RATIO = dp_ratio
    return c


CFGS = {"centerpoint": centerpoint_cfg, "pointpillar": pillar_cfg,
        "second_multihead": multihead_cfg, "second_iou": iou_cfg}


@pytest.fixture(autouse=True)
def bits():
    """Both packages' key bits at the defaults during a test and restored
    after it (a JAX SECONDNet widens the JAX package's for good)."""
    old = (jhash.XBITS, jhash.YBITS, jhash.ZBITS), hashing.key_bits()
    jhash.set_key_bits(*DEFAULT_BITS)
    hashing.set_key_bits(*DEFAULT_BITS)
    yield
    jhash.set_key_bits(*old[0])
    hashing.set_key_bits(*old[1])


def _seeded_state(S, seed=1):
    """BN statistics off their init, so eval BN is not the identity."""
    rs = np.random.RandomState(seed)
    return {k: (np.abs(rs.randn(*np.shape(v))) + 0.5 if k.endswith("var")
                else rs.randn(*np.shape(v)) * 0.1).astype(np.float32)
            for k, v in S.items()}


@functools.lru_cache(maxsize=None)
def _models(name, dp_ratio=0.3):
    """(JAX model, P, S, port model with the same parameters and BN
    statistics) of a tiny configuration."""
    cfg_fn = CFGS[name]
    cfg = cfg_fn(dp_ratio) if name == "second_iou" else cfg_fn()
    prev = (jhash.XBITS, jhash.YBITS, jhash.ZBITS)
    jhash.set_key_bits(*DEFAULT_BITS)
    try:
        jm = jbuild(copy.deepcopy(cfg), num_class=2)
    finally:
        jhash.set_key_bits(*prev)
    P, S = jax.jit(jm.init)(jax.random.PRNGKey(0))
    P = {k: np.asarray(v) for k, v in P.items()}
    S = _seeded_state(S)
    pm = build_network(cfg, num_class=2, device="cpu")
    pm.load_jax_params(P, S)
    return jm, {k: jnp.asarray(v) for k, v in P.items()}, \
        {k: jnp.asarray(v) for k, v in S.items()}, pm


def _batch(seed=0, B=2, P=2000):
    return {k: np.array(v) for k, v in
            outdoor_batch(np.random.RandomState(seed), B=B, P=P).items()}


def _bev(shape, seed=3):
    """A seeded BEV map [B, H, W, C] (the sparse half's output)."""
    return np.abs(np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _jax_ious(tables, boxes, labels, gvalid):
    """Inside the JAX step: the assigner's [B, A, G] IoU matrix of each
    (anchors, anchor classes) table, so that the port reads the step's own
    round-off (see the module docstring)."""
    return [jax.vmap(lambda g, lab, v, a=a, c=c: jnp.where(
        (jnp.asarray(c)[:, None] == lab[None, :]) & v[None, :],
        jbev_iou(jnp.asarray(a), g), -1.0))(boxes, labels, gvalid)
        for a, c in tables]


def _feed_ious(targets, ious):
    """The port's assigner ``targets`` reads ``ious`` scene by scene."""
    it = iter(ious)
    targets.match_iou = lambda *a: _t(next(it))


def _grads_close(pm, jg, prefixes, tol=1e-3):
    PP = dict(pm.named_parameters())
    for pre in prefixes:
        names = sorted(k for k in jg if k.startswith(pre))
        assert names and all(PP[k].grad is not None for k in names), pre
        a = np.concatenate([PP[k].grad.numpy().ravel() for k in names])
        r = np.concatenate([np.asarray(jg[k]).ravel() for k in names])
        assert _rel_norm(a, r) < tol, pre


def _updates_close(upd, jupd, tol=1e-4):
    assert set(upd) == set(jupd)
    for k, v in upd.items():
        assert _rel(v, jupd[k]) < tol, k


# ---------------------------------------------------------------- YAMLs
@pytest.mark.parametrize("name", sorted(YAMLS))
def test_params_match_jax_init_names_and_shapes(name):
    """``build_network`` of each YAML (with its KITTI dataset config) has
    the JAX init's parameter and state names and shapes
    (``jax.eval_shape``), its grid, key bits and VFE cap.  One divergence:
    the JAX package builds PointPillar's 2-D backbone for 256 input
    channels (BaseBEVBackbone's default; the YAML names none), where the
    pillar map has 64; the port passes the map's channels on, as pcdet
    does."""
    cfg = load_config(YAMLS[name])
    jcfg = jload_cfg(YAMLS[name], JEasyDict())
    pm = build_network(cfg.MODEL, 3, device="cpu",
                       dataset=dataset_meta(cfg.DATA_CONFIG, NAMES))

    class _DS:
        point_cloud_range = np.asarray(jcfg.DATA_CONFIG.POINT_CLOUD_RANGE)
        dataset_cfg = jcfg.DATA_CONFIG
        class_names = jcfg.CLASS_NAMES

    prev = (jhash.XBITS, jhash.YBITS, jhash.ZBITS)
    try:
        jm = jbuild(jcfg.MODEL, 3, dataset=_DS())
        jbits = (jhash.XBITS, jhash.YBITS, jhash.ZBITS)
    finally:
        jhash.set_key_bits(*prev)
    jP, jS = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    mine_p = {k: tuple(v.shape) for k, v in pm.named_parameters()}
    theirs_p = {k: tuple(v.shape) for k, v in jP.items()}
    if name == "pointpillar":
        k = "backbone_2d.blocks.0.0.weight"
        assert (mine_p.pop(k), theirs_p.pop(k)) == ((3, 3, 64, 64),
                                                    (3, 3, 256, 64))
    assert mine_p == theirs_p
    assert {k: tuple(v.shape) for k, v in pm.named_buffers()} == \
        {k: tuple(v.shape) for k, v in jS.items()}
    assert list(pm.grid_size) == list(jm.grid_size)
    assert pm.final_grid() == tuple(int(e) for e in jm._final_grid())
    assert pm.key_bits == jbits
    assert hashing.key_bits() == DEFAULT_BITS
    if name == "pointpillar":
        assert pm.grid_size == [432, 496, 1] and pm.key_bits == DEFAULT_BITS
        assert pm.vfe.max_points == jm.vfe.max_points == 32
        assert pm.backbone_3d is None
        assert pm.dense_head.anchors_np.shape == (216 * 248 * 6, 7)
    else:
        assert pm.key_bits == (11, 11, 8) and pm.final_grid() == (176, 200,
                                                                  2)
    if name == "second_multihead":
        assert (pm.dense_head.nms_pre, pm.dense_head.nms_post) == (4096, 500)
        assert [len(h["targets"].anchors_np) for h in pm.dense_head.heads] \
            == [len(h["anchors"]) for h in jm.dense_head.heads] == \
            [70400] * 3
    if name == "second_iou":
        assert pm.roi_head.in_ch * 49 == 25088
    if name == "centerpoint":
        assert pm.dense_head.fmap_hw == jm.dense_head.fmap_hw == (200, 176)
        assert pm.dense_head.voxel_size == jm.dense_head.voxel_size
        assert pm.dense_head.group_class_ids == [[0, 1, 2]]


# -------------------------------------------------------------- PointPillar
def _jax_vfe(jm, P, S, train):
    def vfe(points, pvalid, vs, axis_name=None, rng=None):
        ctx = JCtx(train=train, axis_name=axis_name, rng=rng)
        st = jm.vfe(P, S, ctx, points, pvalid, vs, jm.point_cloud_range,
                    jm.input_cap)
        return st, ctx.updates
    return vfe


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_pillar_vfe_and_scatter(train):
    """PillarVFE on two scenes (arrival-capped at 5 points a pillar, the
    intensities scaled so the features differ by column): the pillar
    lattice and masks exact, the max-pooled features within 1e-5; in
    training the BN pools both scenes (SceneSync threads against the JAX
    ``scene`` vmap) and its running-stat updates match; the scattered map
    exact."""
    jm, P, S, pm = _models("pointpillar")
    pm.vfe.max_points = jm.vfe.max_points = 5
    try:
        b = _batch(0)
        b["points"][:, ::7, 3] *= 3
        vs = jnp.asarray(jm.voxel_size, jnp.float32)
        jfn = _jax_vfe(jm, P, S, train)
        if train:
            jst, jupd = jax.jit(jax.vmap(
                lambda p, v: jfn(p, v, vs, "scene",
                                 jax.random.PRNGKey(0)),
                axis_name="scene"))(jnp.asarray(b["points"]),
                                    jnp.asarray(b["points_valid"]))
            jupd = {k: v[0] for k, v in jupd.items()}
        else:
            outs = [jax.jit(jfn)(jnp.asarray(b["points"][i]),
                                 jnp.asarray(b["points_valid"][i]), vs)
                    for i in range(2)]
            jst = jax.tree_util.tree_map(lambda *x: jnp.stack(x),
                                         *[o[0] for o in outs])
        sync = SceneSync(2) if train else None
        ctxs = [Ctx(train=train, sync=sync, scene=i) for i in range(2)]
        sts = run_scenes(lambda i: pm.vfe(
            ctxs[i], _t(b["points"][i]), _t(b["points_valid"][i]),
            pm.voxel_size, pm.point_cloud_range, pm.input_cap), 2, sync)
    finally:
        pm.vfe.max_points = jm.vfe.max_points = None
    for i, st in enumerate(sts):
        np.testing.assert_array_equal(st.valid.numpy(),
                                      np.asarray(jst.valid[i]))
        np.testing.assert_array_equal(st.coords.numpy(),
                                      np.asarray(jst.coords[i]))
        assert _rel(st.feats.detach().numpy(), jst.feats[i]) < 1e-5
        assert int(st.valid.sum()) > 100
    if train:
        _updates_close(ctxs[0].updates, jupd, 1e-5)
        return
    grid = jm._final_grid()
    jst0 = jax.tree_util.tree_map(lambda x: x[0], jst)
    jbev = jm.map_to_bev_module(P, S, JCtx(), jst0, grid)
    bev = pm.map_to_bev_module(SparseTensor(
        _t(jst0.coords), _t(jst0.feats), _t(jst0.valid), 1), grid)
    assert bev.shape == (32, 64, 64)
    np.testing.assert_array_equal(bev.permute(1, 2, 0).numpy(),
                                  np.asarray(jbev))


def test_pointpillar_eval_stages():
    """The eval forward stage by stage: the pillars' map from the points,
    the 2-D backbone and the head on the JAX map, and the decoded boxes on
    seeded class logits (the NMS after them is SECOND's, held by
    ``test_torch_second.py``); the whole ``forward_eval`` finite and
    padded to MAX_OUT."""
    jm, P, S, pm = _models("pointpillar")
    b = _batch(1, B=1)

    def jstages(points, pvalid, vs):
        ctx = JCtx()
        st = jm.vfe(P, S, ctx, points, pvalid, vs, jm.point_cloud_range,
                    jm.input_cap)
        bev = jm.map_to_bev_module(P, S, ctx, st, jm._final_grid())
        bev2 = jm.backbone_2d(P, S, ctx, bev)
        return bev, bev2, jm.dense_head.forward(P, S, ctx, bev2)

    jbev, jbev2, jout = jax.jit(jstages)(
        jnp.asarray(b["points"][0]), jnp.asarray(b["points_valid"][0]),
        jnp.asarray(jm.voxel_size, jnp.float32))
    PP = {k: v.detach() for k, v in pm.named_parameters()}
    SS = dict(pm.named_buffers())
    with torch.no_grad():
        bev = pm.bev_map(PP, SS, Ctx(), _t(b["points"][0]),
                         _t(b["points_valid"][0]))
        bev2 = pm.backbone_2d(PP, SS, _t(jbev).permute(2, 0, 1))
        out = pm.dense_head(PP, _t(jbev2).permute(2, 0, 1), S=SS)
    assert _rel(bev.permute(1, 2, 0).numpy(), jbev) < 1e-5
    assert _rel(bev2.permute(1, 2, 0).numpy(), jbev2) < 1e-4
    for k in jout:
        assert _rel(out[k].numpy(), jout[k]) < 1e-4, k
    logits = np.random.RandomState(0).randn(
        *jout["cls_preds"].shape).astype(np.float32) * 2
    jboxes, jscores = jax.jit(jm.dense_head.decoded_boxes)(
        dict(jout, cls_preds=jnp.asarray(logits)))
    boxes, scores = pm.dense_head.decoded_boxes(
        {k: _t(v) for k, v in dict(jout, cls_preds=logits).items()})
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jboxes), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               rtol=1e-6, atol=1e-6)
    whole = pm.forward_eval({k: _t(b[k]) for k in ("points",
                                                   "points_valid")})
    assert whole["pred_boxes"].shape == (1, 64, 7)
    assert torch.isfinite(whole["pred_boxes"]).all()


def _jax_pillar_step(jm, P, S, b):
    gt = jnp.asarray(b["gt_boxes"])
    boxes, labels = gt[..., :-1], gt[..., -1].astype(jnp.int32)
    gvalid = jnp.asarray(b["gt_valid"])

    def step(P, vs):
        def scene(points, pvalid, r):
            ctx = JCtx(train=True, axis_name="scene", rng=r)
            st = jm.vfe(P, S, ctx, points, pvalid, vs, jm.point_cloud_range,
                        jm.input_cap)
            bev = jm.map_to_bev_module(P, S, ctx, st, jm._final_grid())
            out = jm.dense_head.forward(P, S, ctx,
                                        jm.backbone_2d(P, S, ctx, bev))
            return out, ctx.updates, ctx.stats

        outs, upd, stats = jax.vmap(scene, axis_name="scene")(
            jnp.asarray(b["points"]), jnp.asarray(b["points_valid"]),
            jax.random.split(jax.random.PRNGKey(1), len(b["points"])))
        loss, tb = jm.dense_head.loss(outs, boxes, labels, gvalid)
        for k, v in stats.items():
            tb[k] = jnp.sum(v).astype(jnp.float32)
        head = jm.dense_head
        return loss, (tb, {k: v[0] for k, v in upd.items()}, _jax_ious(
            [(head.anchors_np, head.anchor_cls_np)], boxes, labels, gvalid))

    return jax.tree_util.tree_map(np.asarray, jax.jit(jax.value_and_grad(
        step, has_aux=True))(P, jnp.asarray(jm.voxel_size, jnp.float32)))


def test_pointpillar_training_step():
    """The whole PointPillar step (``forward_train`` and ``backward()``,
    B = 2) against the JAX step: the loss and every tb term within 1e-4,
    every BN buffer's update within 1e-4, and the gradients of the VFE,
    the 2-D backbone and the head within 1e-3 in norm.  The port's
    assigner reads the JAX IoU matrices."""
    jm, P, S, pm = _models("pointpillar")
    b = _batch(0)
    (jloss, (jtb, jupd, (jiou,))), jg = _jax_pillar_step(jm, P, S, b)
    head = pm.dense_head
    _feed_ious(head, jiou)
    pm.zero_grad()
    try:
        loss, tb, upd = pm.forward_train({k: _t(v) for k, v in b.items()},
                                         torch.Generator().manual_seed(0))
    finally:
        del head.match_iou
    loss.backward()
    assert set(tb) == set(jtb) | {"loss_all"}
    for k in jtb:
        assert abs(float(tb[k]) - float(jtb[k])) <= \
            1e-4 * abs(float(jtb[k])) + 1e-7, k
    assert float(tb["rpn_loss_loc"]) > 0
    _updates_close(upd, jupd)
    _grads_close(pm, jg, ("vfe.", "backbone_2d.", "dense_head."))


# ------------------------------------------------------------ multi-head
def _jax_heads_step(jm, P, S, bevs, b, tables, iou_head=False):
    """The JAX training step from BEV maps [B, H, W, C] on (2-D backbone,
    head, loss; with ``iou_head`` the proposals, their gradient stopped,
    the RoI sampling and the IoU loss too): ((loss, (tb, BN updates,
    extras, the assigner's IoU matrices of each anchor table)),
    gradients)."""
    gt = jnp.asarray(b["gt_boxes"])
    boxes, labels = gt[..., :-1], gt[..., -1].astype(jnp.int32)
    gvalid = jnp.asarray(b["gt_valid"])
    pcr, vs = jm.point_cloud_range, jm.voxel_size

    def step(P):
        def scene(bev, bx, lab, v, r):
            ctx = JCtx(train=True, axis_name="scene", rng=r)
            bev2d = jm.backbone_2d(P, S, ctx, bev)
            out = jm.dense_head.forward(P, S, ctx, bev2d)
            extra = {}
            if iou_head:
                props = jax.lax.stop_gradient(jm._proposals(out, train=True))
                extra = dict(zip(("rois", "scores", "labels", "valid"),
                                 props))
                extra["roi_out"] = jm.roi_head.forward_train(
                    P, S, ctx, *props, bx, lab, v, bev2d, pcr, vs)
            return out, ctx.updates, extra

        outs, upd, extra = jax.vmap(scene, axis_name="scene")(
            jnp.asarray(bevs), boxes, labels, gvalid,
            jax.random.split(jax.random.PRNGKey(1), len(bevs)))
        loss, tb = jm.dense_head.loss(outs, boxes, labels, gvalid)
        if iou_head:
            loss_r, tb_r = jm.roi_head.loss(extra["roi_out"])
            tb.update(tb_r)
            loss = loss + loss_r
        return loss, (tb, {k: v[0] for k, v in upd.items()}, extra,
                      _jax_ious(tables, boxes, labels, gvalid))

    return jax.tree_util.tree_map(np.asarray, jax.jit(jax.value_and_grad(
        step, has_aux=True))(P))


def _scene_ctxs(B, seed=0):
    return [Ctx(train=True, generator=torch.Generator().manual_seed(seed + i),
                scene=i) for i in range(B)]


def test_multihead_eval_stages():
    """SECOND-multihead from a seeded BEV map: the 2-D backbone, the
    shared conv and every sub-head's anchor-major outputs, each head's
    anchors, the decoded boxes with their class columns, and the
    multi-class NMS on seeded class logits (keep masks, labels exact)."""
    jm, P, S, pm = _models("second_multihead")
    PP = {k: v.detach() for k, v in pm.named_parameters()}
    SS = dict(pm.named_buffers())
    jbev = _bev((1, 8, 8, 256))[0]
    jout = jax.jit(lambda x: jm.dense_head.forward(
        P, S, JCtx(), jm.backbone_2d(P, S, JCtx(), x)))(jnp.asarray(jbev))
    bev2 = pm.backbone_2d(PP, SS, _t(jbev).permute(2, 0, 1))
    out = pm.dense_head(PP, bev2, S=SS)
    assert set(out) == set(jout)
    for k in jout:
        assert _rel(out[k].numpy(), jout[k]) < 1e-4, k
    for h, jh in zip(pm.dense_head.heads, jm.dense_head.heads):
        np.testing.assert_array_equal(h["targets"].anchors_np, jh["anchors"])
        np.testing.assert_array_equal(h["targets"].anchor_cls_np,
                                      jh["anchor_cls"])
    rs = np.random.RandomState(0)
    jout = {k: (jnp.asarray(rs.randn(*v.shape).astype(np.float32) * 2)
                if k.startswith("cls") else v) for k, v in jout.items()}
    tout = {k: _t(v) for k, v in jout.items()}
    boxes, scores = pm.dense_head.decoded_boxes(tout)
    jres = jax.jit(jm.dense_head.generate_predicted_boxes)(jout)
    res = pm.dense_head.generate_predicted_boxes(tout)
    assert boxes.shape[0] == scores.shape[0] == 2 * 128
    np.testing.assert_array_equal(res[3].numpy(), np.asarray(jres[3]))
    np.testing.assert_array_equal(res[2].numpy(), np.asarray(jres[2]))
    assert int(res[3].sum()) > 2 and len(set(res[2][res[3]].tolist())) == 2
    np.testing.assert_allclose(res[0].numpy(), np.asarray(jres[0]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res[1].numpy(), np.asarray(jres[1]),
                               rtol=1e-6, atol=1e-6)


def test_multihead_training_from_bev():
    """SECOND-multihead's ``train_heads`` (B = 2, train-mode BN over both
    maps) on the seeded BEV maps against the JAX step: every loss term
    within 1e-4 (the normalizer counts the positives of every head), the
    BN updates within 1e-4, the 2-D backbone's and the head's gradients
    within 1e-3 in norm.  Each head's assigner reads its JAX IoU
    matrices."""
    jm, P, S, pm = _models("second_multihead")
    b = _batch(0)
    bevs = _bev((2, 8, 8, 256))
    (jloss, (jtb, jupd, _, jious)), jg = _jax_heads_step(
        jm, P, S, bevs, b, [(h["anchors"], h["anchor_cls"])
                            for h in jm.dense_head.heads])
    for h, jiou in zip(pm.dense_head.heads, jious):
        _feed_ious(h["targets"], jiou)
    pm.zero_grad()
    PP, SS = flat_state(pm)
    try:
        loss, tb, upd = pm.train_heads(PP, SS, _scene_ctxs(2),
                                       _t(bevs).permute(0, 3, 1, 2),
                                       {k: _t(v) for k, v in b.items()})
    finally:
        for h in pm.dense_head.heads:
            del h["targets"].match_iou
    loss.backward()
    assert set(tb) == set(jtb)
    for k in jtb:
        assert abs(float(tb[k]) - float(jtb[k])) <= \
            1e-4 * abs(float(jtb[k])) + 1e-7, k
    assert float(tb["rpn_loss_loc"]) > 0
    _updates_close(upd, jupd)
    _grads_close(pm, jg, ("backbone_2d.", "dense_head."))


def test_multihead_separate_reg_head_alone():
    """The nuScenes AnchorHeadMulti config (two heads, one of two classes,
    separate 3x3 regression branches, a 9-value sin/cos box code,
    positive and negative class weights) as a module alone: its outputs on
    a seeded map in eval, and in training its loss and every parameter's
    gradient against the JAX head's."""
    c = nusc_multihead_cfg()
    names = [a["class_name"] for a in c.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG]
    kw = dict(num_class=3, class_names=names, grid_size=[64, 64, 41],
              point_cloud_range=c.POINT_CLOUD_RANGE, input_channels=64)
    jh = JMulti(c.DENSE_HEAD, **kw)
    P, S = jax.jit(jh.init)(jax.random.PRNGKey(2))
    S = {k: jnp.asarray(v) for k, v in _seeded_state(S).items()}
    ph = AnchorHeadMulti(c.DENSE_HEAD, **kw)
    from cagroup3d_tpu_torch.core.module import load_jax_params
    load_jax_params(ph, {k[len("dense_head."):]: np.asarray(v)
                         for k, v in P.items()},
                    {k[len("dense_head."):]: np.asarray(v)
                     for k, v in S.items()})
    PP, SS = flat_state(ph, "dense_head")
    bev = _bev((2, 8, 8, 64), seed=4)
    jout = jh.forward(P, S, JCtx(), jnp.asarray(bev[0]))
    out = ph(PP, _t(bev[0]).permute(2, 0, 1), S=SS)
    for k in jout:
        assert _rel(out[k].detach().numpy(), jout[k]) < 1e-4, k
    rs = np.random.RandomState(5)
    G = 4
    gt = np.zeros((2, G, 10), np.float32)
    for i in range(2):
        gt[i, :, :3] = np.c_[rs.rand(G, 2) * 12 + [2, -6], rs.rand(G) - 1.5]
        gt[i, :, 3:6] = rs.rand(G, 3) + [3.5, 1.4, 1.4]
        gt[i, :, 6] = rs.rand(G) * 6 - 3
        gt[i, :, 7:9] = rs.randn(G, 2)
        gt[i, :, 9] = np.arange(G) % 3
    gvalid = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], bool)
    jgt = jnp.asarray(gt)
    tables = [(h["anchors"], h["anchor_cls"]) for h in jh.heads]

    def jloss(P):
        outs, upd = jax.vmap(lambda x: (lambda ctx: (jh.forward(
            P, S, ctx, x), ctx.updates))(JCtx(train=True,
                                              axis_name="scene")),
            axis_name="scene")(jnp.asarray(bev))
        labels = jgt[..., 9].astype(jnp.int32)
        loss, tb = jh.loss(outs, jgt[..., :9], labels, jnp.asarray(gvalid))
        return loss, (tb, {k: v[0] for k, v in upd.items()}, _jax_ious(
            tables, jgt[..., :9], labels, jnp.asarray(gvalid)))

    (jl, (jtb, jupd, jious)), jg = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(P)
    for h, jiou in zip(ph.heads, jious):
        _feed_ious(h["targets"], np.asarray(jiou))
    upd = {}
    try:
        outs = ph(PP, _t(bev).permute(0, 3, 1, 2), S=SS, updates=upd)
        loss, tb = ph.loss(outs, _t(gt[..., :9]), _t(gt[..., 9]).long(),
                           _t(gvalid))
    finally:
        for h in ph.heads:
            del h["targets"].match_iou
    loss.backward()
    for k in jtb:
        assert abs(float(tb[k]) - float(jtb[k])) <= \
            1e-4 * abs(float(jtb[k])) + 1e-7, k
    assert float(tb["rpn_loss_loc"]) > 0
    _updates_close(upd, {f"dense_head.{k}" if not k.startswith(
        "dense_head.") else k: v for k, v in jupd.items()})
    grads = {n: p.grad for n, p in ph.named_parameters()}
    names = sorted(jg)
    a = np.concatenate([grads[k[len("dense_head."):]].numpy().ravel()
                        for k in names])
    r = np.concatenate([np.asarray(jg[k]).ravel() for k in names])
    assert _rel_norm(a, r) < 1e-3
