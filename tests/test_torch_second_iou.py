"""PyTorch port vs the JAX package: SECOND-IoU's second stage (the
proposal layer, the rotated BEV sampler, SECONDHead's IoU branch and loss,
the score fusion, points in boxes and the proposal target layer's
``flip_gt_heading``) at the tiny widths of
``tests/test_second_iou.py::second_iou_cfg``, on identical parameters and
inputs from numpy seeds.  The conditioning and the tolerances are
``test_torch_kitti_zoo.py``'s (its module docstring): the training
comparison runs at ``DP_RATIO`` 0 with the JAX step's proposals, sampling
draws and IoU matrices handed to the port; the eval comparison on seeded
class logits.
"""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cagroup3d_tpu.core.module import Ctx as JCtx
from cagroup3d_tpu.core.roi_pools import points_in_boxes as jpib
from cagroup3d_tpu.models.roi_heads.second_head import \
    sample_bev_rotated as jsample
from cagroup3d_tpu.models.roi_heads.target_assigner.\
    cagroup_proposal_target_layer import ProposalTargetLayer as JPTL
from cagroup3d_tpu_torch.core.module import Ctx, flat_state
from cagroup3d_tpu_torch.core.roi_pools import points_in_boxes
from cagroup3d_tpu_torch.models.roi_heads.second_head import \
    sample_bev_rotated
from cagroup3d_tpu_torch.models.roi_heads.target_assigner.\
    cagroup_proposal_target_layer import ProposalTargetLayer
from test_torch_kitti_zoo import (_batch, _bev, _feed_ious, _grads_close,
                                  _jax_heads_step, _models, _rel,
                                  _scene_ctxs, _t, _updates_close, bits)
from test_torch_train_units import _jax_draws

torch.set_num_threads(1)
assert bits        # the key-bits fixture (autouse) of the zoo tests


def _boxes(rs, n, x0=0.0, spread=12.0):
    return np.concatenate([rs.rand(n, 2) * spread + [x0, -spread / 2],
                           rs.rand(n, 1) - 1.5, rs.rand(n, 3) * 3 + 0.5,
                           rs.rand(n, 1) * 6 - 3], 1).astype(np.float32)


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_proposal_layer_matches_jax(train):
    """The proposal layer on 300 seeded boxes jittered about 40 centres,
    some invalid, with NMS_PRE_MAXSIZE 250: the rois, scores, labels and
    valid mask against the JAX layer's (boxes exact: they are gathered);
    the NMS suppresses some and keeps some.  (The overlap matrix's row
    blocks are ``test_torch_second.py::test_nms_blocks_and_keep``'s.)"""
    jm, _, _, pm = _models("second_iou")
    nc = {"TRAIN": dict(NMS_PRE_MAXSIZE=250, NMS_POST_MAXSIZE=250,
                        NMS_THRESH=0.8),
          "TEST": dict(NMS_PRE_MAXSIZE=250, NMS_POST_MAXSIZE=200,
                       NMS_THRESH=0.3)}
    rs = np.random.RandomState(7 + train)
    centres = _boxes(rs, 40)
    boxes = centres[rs.randint(0, 40, 300)] + np.concatenate(
        [rs.randn(300, 3) * 0.1, rs.randn(300, 4) * 0.02], 1).astype(
        np.float32)
    scores = rs.rand(300).astype(np.float32)
    labels = rs.randint(0, 2, 300).astype(np.int32)
    valid = rs.rand(300) > 0.05
    old = jm.roi_head.nms_cfg, pm.roi_head.nms_cfg
    jm.roi_head.nms_cfg = pm.roi_head.nms_cfg = nc
    try:
        ref = jax.jit(jm.roi_head.proposal_layer, static_argnums=4)(
            jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels),
            jnp.asarray(valid), train)
        got = pm.roi_head.proposal_layer(_t(boxes), _t(scores), _t(labels),
                                         _t(valid), train)
    finally:
        jm.roi_head.nms_cfg, pm.roi_head.nms_cfg = old
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert 10 < int(got[3].sum()) < got[3].numel()


def test_sample_bev_rotated_matches_jax():
    """The rotated G x G bilinear sampler on a seeded map, rotated RoIs
    inside, across the edge and outside of it: within 1e-5 relative."""
    rs = np.random.RandomState(8)
    bev = rs.randn(20, 24, 5).astype(np.float32)          # [H, W, C]
    rois = _boxes(rs, 40, x0=-2.0, spread=14.0)
    got = sample_bev_rotated(_t(bev).permute(2, 0, 1), _t(rois), 7,
                             (-1.0, -6.0), (0.5, 0.6))
    ref = jsample(jnp.asarray(bev), jnp.asarray(rois), 7, (-1.0, -6.0),
                  (0.5, 0.6))
    assert got.shape == (40, 7 * 7 * 5)
    assert _rel(got.numpy(), ref) < 1e-5
    assert (np.abs(np.asarray(ref)) < 1e-12).any()     # taps off the map


def test_points_in_boxes_matches_jax():
    """points_in_boxes on seeded rotated boxes and points, some of either
    invalid: exact."""
    rs = np.random.RandomState(9)
    boxes = _boxes(rs, 30)
    pts = np.concatenate([rs.rand(3000, 2) * 12 + [0, -6],
                          rs.rand(3000, 1) * 3 - 3], 1).astype(np.float32)
    pv, bv = rs.rand(3000) > 0.1, rs.rand(30) > 0.1
    got = points_in_boxes(_t(pts), _t(pv), _t(boxes), _t(bv))
    ref = jpib(jnp.asarray(pts), jnp.asarray(pv), jnp.asarray(boxes),
               jnp.asarray(bv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert int(got.sum()) > 30


SCORE_TYPES = {
    "iou": {}, "cls": {},
    "weighted_iou_cls": dict(SCORE_WEIGHTS=dict(iou=0.7, cls=0.3)),
    "num_pts_iou_cls": dict(SCORE_THRESH=dict(cls=2.0, iou=40.0)),
    "score_by_class": dict(SCORE_BY_CLASS=dict(Car="iou",
                                               Pedestrian="cls"))}


@pytest.mark.parametrize("stype", sorted(SCORE_TYPES))
def test_fused_scores_match_jax(stype):
    """Every SCORE_TYPE of the score fusion on seeded IoU and class scores,
    labels, proposals and points: within 1e-6."""
    jm, _, _, pm = _models("second_iou")
    rs = np.random.RandomState(10)
    boxes = _boxes(rs, 32)
    iou_s, cls_s = (rs.rand(32).astype(np.float32) for _ in range(2))
    labels = rs.randint(0, 2, 32).astype(np.int32)
    pts = np.concatenate([rs.rand(2000, 2) * 12 + [0, -6],
                          rs.rand(2000, 1) * 3 - 3], 1).astype(np.float32)
    pv = rs.rand(2000) > 0.1
    olds = []
    for m in (jm, pm):
        nc = m.model_cfg.POST_PROCESSING.NMS_CONFIG
        olds.append(copy.deepcopy(nc))
        for k, v in dict(SCORE_TYPE=stype, **copy.deepcopy(
                SCORE_TYPES[stype])).items():
            nc[k] = v             # the EasyDict's item setter nests dicts
    try:
        ref = jm._fused_scores(jnp.asarray(iou_s), jnp.asarray(cls_s),
                               jnp.asarray(labels), jnp.asarray(boxes),
                               jnp.asarray(pts), jnp.asarray(pv))
        got = pm.fused_scores(_t(iou_s), _t(cls_s), _t(labels), _t(boxes),
                              _t(pts), _t(pv))
    finally:
        for m, o in zip((jm, pm), olds):
            m.model_cfg.POST_PROCESSING.NMS_CONFIG = o
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_second_iou_eval_stages():
    """The eval forward from a seeded BEV map on: the 2-D map and the head
    outputs; then, on seeded class logits, the test-time proposals, the IoU
    branch (eval BN) on the JAX proposals, and the whole prediction --
    fused scores (``weighted_iou_cls``), the NMS over the proposals and the
    top ``NMS_POST_MAXSIZE`` -- through each package's ``forward_eval``
    with its scene stage returning these head outputs: boxes, scores,
    labels and valid mask against the JAX package's."""
    jm, P, S, pm = _models("second_iou")
    PP = {k: v.detach() for k, v in pm.named_parameters()}
    SS = dict(pm.named_buffers())
    pcr, vs = jm.point_cloud_range, jm.voxel_size
    b = _batch(2, B=1)

    def jstages(bev, logits, points, pvalid):
        ctx = JCtx()
        bev2 = jm.backbone_2d(P, S, ctx, bev)
        head = jm.dense_head.forward(P, S, ctx, bev2)
        out = dict(head, cls_preds=logits)
        props = jm._proposals(out, train=False)
        iou = jm.roi_head.forward_test(P, S, ctx, *props, bev2, pcr,
                                       vs)["rcnn_iou"]
        jm._scene_bev = lambda *a, **kw: (JCtx(), out, bev2)
        try:
            res = jm.forward_eval(P, S, dict(points=points[None],
                                             points_valid=pvalid[None]))
        finally:
            del jm._scene_bev
        return bev2, head, props, iou, res

    jbev = _bev((1, 8, 8, 256))[0]
    bev2 = pm.backbone_2d(PP, SS, _t(jbev).permute(2, 0, 1))
    out = pm.dense_head(PP, bev2, S=SS)
    logits = np.random.RandomState(11).randn(
        *out["cls_preds"].shape).astype(np.float32) * 2
    jbev2, jout, jprops, jiou, jres = jax.jit(jstages)(
        jnp.asarray(jbev), jnp.asarray(logits),
        jnp.asarray(b["points"][0]), jnp.asarray(b["points_valid"][0]))
    assert _rel(bev2.detach().permute(1, 2, 0).numpy(), jbev2) < 1e-4
    for k in jout:
        assert _rel(out[k].detach().numpy(), jout[k]) < 1e-4, k
    tout = {k: _t(v) for k, v in dict(jout, cls_preds=logits).items()}
    props = pm.proposals(tout, False)
    for g, r in zip(props, jprops):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_array_equal(props[3].numpy(), np.asarray(jprops[3]))
    tb2 = _t(jbev2).permute(2, 0, 1)
    iou = pm.roi_head.forward_test(PP, SS, Ctx(), _t(jprops[0]),
                                   _t(jprops[3]), tb2, pm.point_cloud_range,
                                   pm.voxel_size)
    assert _rel(iou.detach().numpy(), jiou) < 1e-4
    pm.forward_scene = lambda *a, **kw: (tout, tb2)
    try:
        res = pm.forward_eval({k: _t(v) for k, v in b.items()})
    finally:
        del pm.forward_scene
    np.testing.assert_array_equal(res["pred_valid"].numpy(),
                                  np.asarray(jres["pred_valid"]))
    np.testing.assert_array_equal(res["pred_labels"].numpy(),
                                  np.asarray(jres["pred_labels"]))
    assert int(res["pred_valid"].sum()) > 0
    for k in ("pred_boxes", "pred_scores"):
        np.testing.assert_allclose(res[k].numpy(), np.asarray(jres[k]),
                                   rtol=1e-5, atol=1e-5)


def test_second_iou_training_from_bev():
    """``train_heads`` (B = 2, DP_RATIO 0) on seeded BEV maps against the
    JAX step with the proposals' gradient stopped: the RPN and RCNN loss
    terms within 1e-4, every BN update within 1e-4, and the gradients of
    the 2-D backbone, the anchor head and the RoI head within 1e-3 in
    norm.  The port reads the JAX step's proposals, IoU matrices and
    sampling draws."""
    jm, P, S, pm = _models("second_iou", dp_ratio=0.0)
    b = _batch(0)
    bevs = _bev((2, 8, 8, 256))
    head = jm.dense_head
    (_, (jtb, jupd, extra, (jiou,))), jg = _jax_heads_step(
        jm, P, S, bevs, b, [(head.anchors_np, head.anchor_cls_np)],
        iou_head=True)
    R = extra["rois"].shape[1]
    n_roi = pm.roi_head.proposal_target_layer.roi_per_image
    draws = []
    for r in jax.random.split(jax.random.PRNGKey(1), 2):
        _, sub = jax.random.split(r)        # the scene ctx's next_rng()
        draws.append(_jax_draws(sub, R, n_roi))
    props = iter([tuple(_t(extra[k][i]) for k in ("rois", "scores",
                                                  "labels", "valid"))
                  for i in range(2)])
    pm.proposals = lambda out, train: next(props)
    _feed_ious(pm.dense_head, jiou)
    pm.zero_grad()
    PP, SS = flat_state(pm)
    try:
        loss, tb, upd = pm.train_heads(PP, SS, _scene_ctxs(2),
                                       _t(bevs).permute(0, 3, 1, 2),
                                       {k: _t(v) for k, v in b.items()},
                                       roi_draws=draws)
    finally:
        del pm.proposals, pm.dense_head.match_iou
    loss.backward()
    assert set(tb) == set(jtb)
    for k in jtb:
        assert abs(float(tb[k]) - float(jtb[k])) <= \
            1e-4 * abs(float(jtb[k])) + 1e-7, k
    assert float(tb["rcnn_loss_iou"]) > 0
    _updates_close(upd, jupd)
    _grads_close(pm, jg, ("backbone_2d.", "dense_head.", "roi_head."))


@pytest.mark.parametrize("loss_type", ["BinaryCrossEntropy", "L2",
                                       "smoothL1"])
def test_iou_loss_matches_jax(loss_type):
    """SECONDHead's IoU loss of each IOU_LOSS on seeded logits and labels
    (some ignored): within 1e-6."""
    jm, _, _, pm = _models("second_iou")
    rs = np.random.RandomState(12)
    fwd = dict(rcnn_iou=rs.randn(2, 16).astype(np.float32),
               rcnn_cls_labels=np.where(rs.rand(2, 16) < 0.2, -1.0,
                                        rs.rand(2, 16)).astype(np.float32))
    old = jm.roi_head.iou_loss, pm.roi_head.iou_loss
    jm.roi_head.iou_loss = pm.roi_head.iou_loss = loss_type
    try:
        ref = jm.roi_head.loss({k: jnp.asarray(v) for k, v in fwd.items()})
        got = pm.roi_head.loss({k: _t(v) for k, v in fwd.items()})
    finally:
        jm.roi_head.iou_loss, pm.roi_head.iou_loss = old
    for k in ref[1]:
        assert abs(float(got[1][k]) - float(ref[1][k])) <= \
            1e-6 * abs(float(ref[1][k])), k


@pytest.mark.parametrize("flip", [True, False], ids=["flip", "no_flip"])
def test_flip_gt_heading_matches_jax(flip):
    """The proposal target layer with ``flip_gt_heading`` both ways
    (CAGroup3D's mmdet3d-heading GT flipped, the default; KITTI's pcdet
    boxes as they are, SECOND-IoU's) on rois jittered about headed GT boxes
    55-65 m out, with the JAX package's draws: the sampled rois, GT,
    labels and masks exact; the IoUs and the class targets within 5e-5 of
    the same layer's in float64, and from the JAX package's no further
    than the JAX package's own jitted f32 values lie from float64 (about
    2.5e-4 at 60 m: the shoelace sums cancel) plus 5e-5."""
    rs = np.random.RandomState(13 + flip)
    R, G = 60, 6
    gt = _boxes(rs, G, x0=55.0, spread=10.0)
    glab = rs.randint(0, 3, G).astype(np.int32)
    gvalid = np.arange(G) < 5
    src = rs.randint(0, G, R)
    rois = gt[src] + np.concatenate([rs.randn(R, 3) * 0.3,
                                     rs.randn(R, 3) * 0.05,
                                     rs.randn(R, 1) * 0.1], -1).astype(
        np.float32)
    rois[:, 6] = (-1.0 if flip else 1.0) * gt[src, 6] + rs.randn(R) * 0.1
    rois[:, 3:6] = np.abs(rois[:, 3:6]) + 0.05
    rlab, rvalid = glab[src], rs.rand(R) < 0.9
    scores = rs.rand(R).astype(np.float32)
    kw = dict(roi_per_image=16, fg_ratio=0.5, reg_fg_thresh=0.55,
              cls_fg_thresh=0.75, cls_bg_thresh=0.25)
    rng = jax.random.PRNGKey(3)
    ref = jax.jit(lambda *a: JPTL(**kw)(*a, flip_gt_heading=flip))(
        rng, *(jnp.asarray(a) for a in (rois, scores, rlab, rvalid, gt, glab,
                                         gvalid)))
    got, f64 = (ProposalTargetLayer(**kw)(
        None, _t(rois).to(dt), _t(scores), _t(rlab), _t(rvalid),
        _t(gt).to(dt), _t(glab), _t(gvalid), draws=_jax_draws(rng, R, 16),
        flip_gt_heading=flip) for dt in (torch.float32, torch.float64))
    for k in ("rois", "gt_of_rois", "gt_label_of_rois", "roi_labels",
              "reg_valid_mask"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]),
                                      err_msg=k)
    for k in ("gt_iou_of_rois", "rcnn_cls_labels"):
        mine, theirs, exact = (np.asarray(x[k], np.float64)
                               for x in (got, ref, f64))
        assert np.abs(mine - exact).max() < 5e-5, k
        assert (np.abs(mine - theirs) <= np.abs(theirs - exact) + 5e-5).all()
    assert float(got["gt_iou_of_rois"].max()) > 0.55
    assert (got["gt_of_rois"][:, 6] * (-1 if flip else 1)).tolist() == \
        [float(gt[i, 6]) for i in _asg(got, gt, flip)]


def _asg(got, gt, flip):
    """Each sampled roi's GT row, found by the GT centre it holds."""
    return [int(np.flatnonzero((gt[:, :6] == g[:6]).all(1))[0])
            for g in got["gt_of_rois"].numpy()]
