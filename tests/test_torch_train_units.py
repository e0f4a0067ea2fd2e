"""PyTorch port vs the JAX package: the training pieces one by one, on the
same seeded inputs (``np.random.RandomState``).

Config loader and synthetic scenes (the port's own copies) equal; the
cyclic capacity window, train-mode voxelization and the paired head maps
exact in coordinates, masks and inverse maps (features within 1e-2: bf16
rows); train-mode batch norm, pooled over two scenes as the JAX package's
vmapped ``psum`` pools them, and every loss function with its gradient
within 1e-5; the assigner, the vote targets and the proposal sampling
(with the JAX package's draws handed to the port) exact; the optimizer and
the LR schedule within 1e-6 of optax; checkpoints round-trip and the JAX
package's pickles load.  K3's and the feature backward's plain versions
(the arithmetic the CUDA kernels repeat) are held to ``jax.grad`` through
the Pallas kernels in interpret mode at the K1 bar, 2e-2.
"""
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from cagroup3d_tpu import config as jconfig
from cagroup3d_tpu.core import norm as jnorm
from cagroup3d_tpu.core import voxelize as jvox
from cagroup3d_tpu.core.voxelize import unique_voxels_classes
from cagroup3d_tpu.models.dense_heads.cagroup_head import \
    CAGroup3DHead as JHead
from cagroup3d_tpu.models.dense_heads.cagroup_head import \
    nearest_point_index as j_nearest
from cagroup3d_tpu.models.roi_heads.target_assigner.\
    cagroup_proposal_target_layer import ProposalTargetLayer as JPTL
from cagroup3d_tpu.ops.pallas_conv import (conv_at_coords_mxu,
                                           subm_conv_classes_mxu)
from cagroup3d_tpu.training import checkpoint as jckpt
from cagroup3d_tpu.training import optimization as jopt
from cagroup3d_tpu.utils import loss_utils as JL
from cagroup3d_tpu.utils import synthetic as jsyn
from cagroup3d_tpu_torch import config as pconfig
from cagroup3d_tpu_torch.core import voxelize
from cagroup3d_tpu_torch.core.module import Ctx, apply_bn
from cagroup3d_tpu_torch.core.norm import SceneSync
from cagroup3d_tpu_torch.models import build_network
from cagroup3d_tpu_torch.models.dense_heads.cagroup_head import (
    CAGroup3DHead, nearest_point_index)
from cagroup3d_tpu_torch.models.detectors.cagroup3d import run_scenes
from cagroup3d_tpu_torch.models.roi_heads.target_assigner.\
    cagroup_proposal_target_layer import ProposalTargetLayer
from cagroup3d_tpu_torch.ops.sparse_conv import (sparse_conv,
                                                 sparse_conv_dfeats_plain,
                                                 sparse_conv_dw_plain)
from cagroup3d_tpu_torch.training import checkpoint as pckpt
from cagroup3d_tpu_torch.training.optimization import (Optimizer,
                                                       build_lr_schedule,
                                                       onecycle_schedules)
from cagroup3d_tpu_torch.utils import loss_utils as L
from cagroup3d_tpu_torch.utils import synthetic as psyn

torch.set_num_threads(1)
CFG = "tools/cfgs/scannet_models/CAGroup3D.yaml"


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(a, b):
    a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-9)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------ the port's copies
def test_synthetic_and_config_are_the_jax_packages():
    kw = dict(batch_size=2, n_points=3000, point_cap=3200, n_objects=5)
    a = psyn.synthetic_batch(np.random.RandomState(3), **kw)
    b = jsyn.synthetic_batch(np.random.RandomState(3), **kw)
    assert set(a) == set(b)
    for k in a:
        _eq(a[k], b[k])
    pc = pconfig.cfg_from_yaml_file(CFG, pconfig.EasyDict())
    jc = jconfig.cfg_from_yaml_file(CFG, jconfig.EasyDict())
    assert pc == jc and pc.DATA_CONFIG.DATASET == jc.DATA_CONFIG.DATASET
    pconfig.cfg_from_list(["OPTIMIZATION.LR", "0.5"], pc)
    jconfig.cfg_from_list(["OPTIMIZATION.LR", "0.5"], jc)
    assert pc.OPTIMIZATION.LR == jc.OPTIMIZATION.LR == 0.5


def test_train_batch_masks_follow_gt_boxes():
    from chip_smoke import synthetic_train_batch
    b = synthetic_train_batch(0, "cpu", 1, n_points=2000, room=(3., 3., 2.5),
                              n_objects=3)
    ins, sem = b["instance_mask"][0], b["semantic_mask"][0]
    assert int(ins.max()) >= 1
    for i in range(3):
        box = b["gt_boxes"][0, i]
        sel = ins == i + 1
        assert bool((sem[sel] == int(box[7])).all())
        inside = ((b["points"][0, sel, :3] - box[:3]).abs() <
                  box[3:6] / 2).all(-1)
        assert bool(inside.all())


# --------------------------------------------------------- train-mode BN
def _jax_bn_train(x, m, w, b, rm, rv, axis_name=None):
    return jnorm.masked_batch_norm(x, m, w, b, rm, rv, train=True,
                                   axis_name=axis_name)


@pytest.mark.parametrize("n_scenes", [1, 2])
def test_train_batch_norm(n_scenes):
    rs = np.random.RandomState(n_scenes)
    x = rs.randn(n_scenes, 50, 6).astype(np.float32) * 2 + 1
    m = rs.rand(n_scenes, 50) < 0.7
    w, b = rs.rand(6).astype(np.float32) + 0.5, rs.randn(6).astype(np.float32)
    rm, rv = rs.randn(6).astype(np.float32), rs.rand(6).astype(np.float32) + 1
    cot = rs.randn(n_scenes, 50, 6).astype(np.float32)

    def jloss(x, w, b):
        y, (nrm, nrv) = jax.vmap(lambda xi, mi: _jax_bn_train(
            xi, mi, w, b, rm, rv, "scene"), axis_name="scene")(x, m)
        return jnp.sum(y * cot), (y, nrm[0], nrv[0])

    (_, (jy, jrm, jrv)), jg = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(x, w, b)

    xt, wt, bt = (_t(a).requires_grad_(True) for a in (x, w, b))
    P = {"bn.weight": wt, "bn.bias": bt}
    S = {"bn.running_mean": _t(rm), "bn.running_var": _t(rv)}
    sync = SceneSync(n_scenes) if n_scenes > 1 else None
    ctxs = [Ctx(train=True, sync=sync, scene=i) for i in range(n_scenes)]
    ys = run_scenes(lambda i: apply_bn(P, S, ctxs[i], "bn", xt[i], _t(m[i])),
                    n_scenes, sync)
    y = torch.stack(ys)
    (y * _t(cot)).sum().backward()
    assert _rel(y, jy) < 1e-5
    for c in ctxs:
        assert _rel(c.updates["bn.running_mean"], jrm) < 1e-5
        assert _rel(c.updates["bn.running_var"], jrv) < 1e-5
    for got, ref in zip((xt.grad, wt.grad, bt.grad), jg):
        assert _rel(got, ref) < 1e-5


# ------------------------------------------------------ the drop window
def test_window_ranks_with_offset():
    n = np.array([5, 64, 65, 300, 1000], np.int32)
    for off in (0, 1, 17, 299, (1 << 30) - 3):
        _eq(voxelize._window_ranks(_t(n), 64, off),
            jvox._window_ranks(jnp.asarray(n), 64, jnp.int32(off)))


@pytest.mark.parametrize("mode,off", [("first", 5), ("mean", 123456),
                                      ("first", 0)])
def test_unique_voxels_drop_offset(mode, off):
    rs = np.random.RandomState(2)
    P = 700
    lat = rs.randint(0, 9, (P, 3)).astype(np.int32)
    feats = rs.randn(P, 5).astype(np.float32)
    valid = rs.rand(P) < 0.85
    st, inv = voxelize.unique_voxels(_t(lat), _t(feats), _t(valid), 64,
                                     mode=mode, drop_offset=off)
    jst, jinv = jax.jit(lambda a, b, c: jvox.unique_voxels(
        a, b, c, 64, mode=mode, drop_offset=jnp.int32(off)))(
        lat, feats, valid)
    _eq(st.coords, jst.coords)
    _eq(st.valid, jst.valid)
    _eq(inv, jinv)
    assert _rel(st.feats, jst.feats) < 1e-2


@pytest.mark.parametrize("off", [None, 7, 40_000])
def test_paired_maps_train(off):
    rs = np.random.RandomState(7)
    G, P, F = 3, 512, 16
    lat = rs.randint(-3, 14, (G, P, 3)).astype(np.int32)
    feats = rs.randn(P, F).astype(np.float32)
    sel = rs.rand(G, P) < 0.7
    sel[1] = False
    ft = _t(feats).requires_grad_(True)
    (fc, ff, fv), (cc, cf, cv), (of, oc) = \
        voxelize.unique_voxels_classes_paired(_t(lat), ft, _t(sel), 64, 32,
                                              3, train=True, drop_offset=off)
    jd = None if off is None else jnp.int32(off)
    (jfc, jff, jfv), (jcc, jcf, jcv), (jof, joc) = jax.jit(
        lambda a, b, c: jvox.unique_voxels_classes_paired(
            a, b, c, 64, 32, 3, return_stats=True, drop_offset=jd,
            train=True))(lat, feats, sel)
    for a, b in ((fc, jfc), (fv, jfv), (cc, jcc), (cv, jcv), (of, jof),
                 (oc, joc)):
        _eq(a, b)
    assert _rel(ff, jff) < 1e-2
    assert _rel(cf, jcf) < 1e-2
    # the gradient w.r.t. the shared rows against the JAX VJP
    rs = np.random.RandomState(8)
    cf_cot, cc_cot = (rs.randn(*a.shape).astype(np.float32)
                      for a in (jff, jcf))
    _, vjp = jax.vjp(lambda f: tuple(
        m[1] for m in jvox.unique_voxels_classes_paired(
            jnp.asarray(lat), f, jnp.asarray(sel), 64, 32, 3,
            drop_offset=jd, train=True)[:2]), jnp.asarray(feats))
    torch.autograd.backward((ff, cf), (_t(cf_cot), _t(cc_cot)))
    jg = vjp((jnp.asarray(cf_cot), jnp.asarray(cc_cot)))[0]
    assert float(ft.grad.abs().sum()) > 0
    assert _rel(ft.grad, jg) < 1e-2


@pytest.mark.parametrize("off", [None, 5])
def test_unique_voxels_mean_train(off):
    """The mean-mode voxel table under a training window: the per-voxel
    sums (fixed-order ``segment_sum``) and their VJP against the JAX
    package's."""
    rs = np.random.RandomState(3)
    lat = rs.randint(0, 9, (600, 3)).astype(np.int32)
    feats = rs.randn(600, 5).astype(np.float32)
    valid = rs.rand(600) < 0.9
    ft = _t(feats).requires_grad_(True)
    st, inv = voxelize.unique_voxels(_t(lat), ft, _t(valid), 256,
                                     drop_offset=off)
    jd = None if off is None else jnp.int32(off)
    fn = jax.jit(lambda f: jvox.unique_voxels(
        jnp.asarray(lat), f, jnp.asarray(valid), 256, drop_offset=jd))
    jst, jinv = fn(feats)
    _eq(st.coords, jst.coords)
    _eq(inv, jinv)
    assert _rel(st.feats.detach(), jst.feats) < 1e-6
    cot = rs.randn(*jst.feats.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda f: fn(f)[0].feats, jnp.asarray(feats))
    st.feats.backward(_t(cot))
    assert _rel(ft.grad, vjp(jnp.asarray(cot))[0]) < 1e-5


# ------------------------------------------------------------ the losses
def _grad_pair(jfn, pfn, *arrays):
    """Loss values and gradients w.r.t. the first array, both packages."""
    jv, jg = jax.value_and_grad(jfn)(*(jnp.asarray(a) for a in arrays))
    x = _t(arrays[0]).requires_grad_(True)
    pv = pfn(x, *(_t(a) for a in arrays[1:]))
    pv.backward()
    return (pv, jv), (x.grad, jg)


def test_losses():
    rs = np.random.RandomState(0)
    pred = (rs.randn(40, 5) * 3).astype(np.float32)
    labels = rs.randint(-1, 5, 40).astype(np.int32)
    wgt = (rs.rand(40) > 0.3).astype(np.float32)
    cases = [
        (lambda p, lab, w: JL.focal_loss_with_labels(p, lab, w,
                                                     avg_factor=7.0),
         lambda p, lab, w: L.focal_loss_with_labels(p, lab, w,
                                                    avg_factor=7.0),
         (pred, labels, wgt)),
        (lambda p, t: JL.sigmoid_focal_loss(p, t),
         lambda p, t: L.sigmoid_focal_loss(p, t),
         (pred, (rs.rand(40, 5) > 0.8).astype(np.float32))),
        (lambda p, t, w: JL.binary_cross_entropy(p, t, w, avg_factor=3.0),
         lambda p, t, w: L.binary_cross_entropy(p, t, w, avg_factor=3.0),
         (pred[:, 0], rs.rand(40).astype(np.float32), wgt)),
    ]
    a, b = rs.randn(30, 3).astype(np.float32), rs.randn(30, 3).astype(
        np.float32) * 0.05
    w3 = rs.rand(30, 1).astype(np.float32)
    for red, avg in (("sum", None), ("mean", None), ("mean", 4.0)):
        cases.append((
            lambda p, t, w, red=red, avg=avg: JL.smooth_l1(
                p, t, w, beta=0.04, reduction=red, avg_factor=avg),
            lambda p, t, w, red=red, avg=avg: L.smooth_l1(
                p, t, w, beta=0.04, reduction=red, avg_factor=avg),
            (a * 0.05, b, w3)))
    tgt = rs.randn(30, 6).astype(np.float32)
    tgt[3, 2] = np.nan
    cases.append((
        lambda p, t: jnp.sum(JL.weighted_smooth_l1(
            p, t, code_weights=[1., 2, 1, 1, 1, .5]) ** 2),
        lambda p, t: (L.weighted_smooth_l1(
            p, t, code_weights=[1., 2, 1, 1, 1, .5]) ** 2).sum(),
        (rs.randn(30, 6).astype(np.float32), tgt)))
    box = np.concatenate([rs.randn(30, 3), rs.rand(30, 3) + 0.2,
                          np.zeros((30, 1))], -1).astype(np.float32)
    box2 = box + rs.randn(30, 7).astype(np.float32) * 0.1
    box2[:, 6] = 0
    cases.append((
        lambda p, t, w: JL.iou3d_loss(p, t, w, avg_factor=2.0,
                                      with_yaw=False),
        lambda p, t, w: L.iou3d_loss(p, t, w, avg_factor=2.0,
                                     with_yaw=False),
        (box[:, :6], box2, rs.rand(30).astype(np.float32))))
    for jfn, pfn, arrays in cases:
        (pv, jv), (pg, jg) = _grad_pair(jfn, pfn, *arrays)
        assert _rel(pv, jv) < 1e-5
        assert _rel(pg, jg) < 1e-5
    # the rotated IoU loss (SUN RGB-D): headed boxes near their targets
    yawed = box.copy()
    yawed[:, 6] = rs.rand(30) * 4 * np.pi - 2 * np.pi
    yawed2 = yawed + rs.randn(30, 7).astype(np.float32) * 0.1
    w = rs.rand(30).astype(np.float32)
    jv, jg = jax.jit(jax.value_and_grad(
        lambda p, t: JL.iou3d_loss(p, t, jnp.asarray(w), avg_factor=2.0,
                                   with_yaw=True)))(jnp.asarray(yawed),
                                                    jnp.asarray(yawed2))
    x = _t(yawed).requires_grad_(True)
    pv = L.iou3d_loss(x, _t(yawed2), _t(w), avg_factor=2.0, with_yaw=True)
    pv.backward()
    assert _rel(pv, jv) < 1e-5
    assert _rel(x.grad, jg) < 1e-5


# ------------------------------------------------ assigner, vote targets
def _heads(n_cls=4):
    cfg = pconfig.cfg_from_yaml_file(CFG, pconfig.EasyDict()).MODEL.DENSE_HEAD
    cfg.update(N_CLASSES=n_cls, OUT_CHANNELS=8, CLS_KERNEL=3)
    jcfg = jconfig.EasyDict(dict(cfg))
    return CAGroup3DHead(cfg), JHead(jcfg)


def _scene(seed, n_cls=4, G=6, N=300):
    rs = np.random.RandomState(seed)
    boxes = np.concatenate([rs.rand(G, 3) * 2, rs.rand(G, 3) * 0.8 + 0.3,
                            np.zeros((G, 1))], -1).astype(np.float32)
    boxes[1] = boxes[0]                            # a duplicate box: ties
    labels = rs.randint(0, n_cls, G).astype(np.int32)
    gvalid = np.arange(G) < G - 1
    pts = (rs.rand(n_cls, N, 3) * 2.4 - 0.2).astype(np.float32)
    pts = np.round(pts / 0.05) * 0.05              # lattice-like: ties
    pvalid = rs.rand(n_cls, N) < 0.9
    return boxes, labels, gvalid, pts.astype(np.float32), pvalid


@pytest.mark.parametrize("seed", [0, 1])
def test_assigner(seed):
    head, jhead = _heads()
    boxes, labels, gvalid, pts, pvalid = _scene(seed)
    ct, bt, lab = head.assigner.assign(_t(pts), _t(pvalid), _t(boxes),
                                       _t(labels), _t(gvalid))
    jct, jbt, jlab = jax.jit(jhead.assigner.assign)(pts, pvalid, boxes,
                                                    labels, gvalid)
    _eq(lab, jlab)
    assert (np.asarray(jlab) >= 0).sum() > 10
    assert _rel(ct, jct) < 1e-5
    assert _rel(bt, jbt) < 1e-5
    sl, si = head.assigner.assign_semantic(_t(pts[0]), _t(pvalid[0]),
                                           _t(boxes), _t(labels), _t(gvalid),
                                           4)
    jsl, jsi = jhead.assigner.assign_semantic(pts[0], pvalid[0], boxes,
                                              labels, gvalid, 4)
    _eq(sl, jsl)
    _eq(si, jsi)


@pytest.mark.parametrize("seed", [0, 1])
def test_vote_targets_and_nearest_point(seed):
    head, jhead = _heads()
    boxes, labels, gvalid, pts, pvalid = _scene(seed)
    rs = np.random.RandomState(seed + 10)
    # raw points at arbitrary floats, as scans give them: exact distance
    # ties then do not occur, and XLA's fused distance arithmetic cannot
    # reorder near-ties
    scene = (rs.rand(900, 3) * 2.2).astype(np.float32)
    svalid = rs.rand(900) < 0.95
    ins = rs.randint(0, 6, 900).astype(np.int32)
    sem = np.where(ins > 0, labels[np.clip(ins - 1, 0, 5)], 4).astype(
        np.int32)
    idx = nearest_point_index(_t(pts[0]), _t(pvalid[0]), _t(scene),
                              _t(svalid), chunk=256)
    jidx = j_nearest(pts[0], pvalid[0], scene, svalid, chunk=256)
    _eq(idx, jidx)
    vt, vm = head._vote_targets_scannet(_t(pts[0]), _t(pvalid[0]),
                                        _t(scene), _t(svalid), _t(sem),
                                        _t(ins), _t(boxes), _t(gvalid), 16)
    jvt, jvm = jhead._vote_targets_scannet(pts[0], pvalid[0], scene, svalid,
                                           sem, ins, boxes, gvalid, 16)
    _eq(vm, jvm)
    assert np.asarray(jvm).sum() > 10
    assert _rel(vt, jvt) < 1e-5


# ----------------------------------------------------- proposal sampling
def _jax_draws(rng, n_rois, n_roi):
    """The draws JAX's ``sample(rng, ...)`` makes, as the port's inputs."""
    r1, r2, r3, r4 = jax.random.split(rng, 4)
    u = np.stack([np.asarray(jax.random.uniform(r, (n_rois,)))
                  for r in (r1, r2, r3)])
    rint = np.asarray(jax.random.randint(r4, (n_roi,), 0, 1 << 30))
    return _t(u), _t(rint).long()


@pytest.mark.parametrize("case", ["mixed", "no_bg", "no_fg", "few"])
def test_proposal_target_layer(case):
    seed = {"mixed": 0, "no_bg": 1, "no_fg": 2, "few": 3}[case]
    rs = np.random.RandomState(seed)
    R, G = 40, 6
    gt = np.concatenate([rs.rand(G, 3) * 3, rs.rand(G, 3) + 0.3,
                         np.zeros((G, 1))], -1).astype(np.float32)
    glab = rs.randint(0, 3, G).astype(np.int32)
    gvalid = np.arange(G) < 5
    src = rs.randint(0, G, R)
    jit = {"mixed": 0.3, "no_bg": 0.02, "no_fg": 3.0, "few": 0.3}[case]
    rois = gt[src] + np.concatenate([rs.randn(R, 3) * jit,
                                     rs.randn(R, 3) * 0.1 * jit,
                                     np.zeros((R, 1))], -1).astype(np.float32)
    rois[:, 3:6] = np.abs(rois[:, 3:6]) + 0.05
    rois[:, 6] = 0
    rlab = glab[src]
    rvalid = rs.rand(R) < (0.2 if case == "few" else 0.9)
    scores = rs.rand(R).astype(np.float32)
    ptl = ProposalTargetLayer(roi_per_image=16, fg_ratio=0.9)
    jptl = JPTL(roi_per_image=16, fg_ratio=0.9)
    rng = jax.random.PRNGKey(seed)
    ref = jptl(rng, *(jnp.asarray(a) for a in (rois, scores, rlab, rvalid,
                                               gt, glab, gvalid)))
    got = ptl(None, _t(rois), _t(scores), _t(rlab), _t(rvalid), _t(gt),
              _t(glab), _t(gvalid), draws=_jax_draws(rng, R, 16))
    for k in ("rois", "gt_of_rois", "gt_label_of_rois", "gt_iou_of_rois",
              "roi_scores", "roi_labels", "reg_valid_mask",
              "rcnn_cls_labels"):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    jsel = jptl.sample(rng, jptl.max_iou_with_same_class(
        *(jnp.asarray(a) for a in (rois, rlab, rvalid, gt, glab, gvalid)))[0],
        jnp.asarray(rvalid))
    _eq(got["sampled"], jsel)
    # headed GT and rois (SUN RGB-D): the rotated 3D IoU matches them
    yawed, yrois = gt.copy(), rois.copy()
    yawed[:, 6] = rs.rand(G) * 2 * np.pi
    yrois[:, 6] = -yawed[src, 6] + rs.randn(R).astype(np.float32) * 0.2
    ref = jptl(rng, *(jnp.asarray(a) for a in (yrois, scores, rlab, rvalid,
                                               yawed, glab, gvalid)))
    got = ptl(None, _t(yrois), _t(scores), _t(rlab), _t(rvalid), _t(yawed),
              _t(glab), _t(gvalid), draws=_jax_draws(rng, R, 16))
    for k in ("rois", "gt_of_rois", "gt_iou_of_rois", "reg_valid_mask",
              "rcnn_cls_labels"):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


# ------------------------------------------------ optimizer and schedule
@pytest.mark.parametrize("name,warmup", [("adamW", False), ("adamW", True),
                                         ("adam", False), ("sgd", False),
                                         ("adam_onecycle", False)])
def test_optimizer_matches_optax(name, warmup):
    """Each optimizer's schedule and updates (clipped and unclipped steps,
    weight decay) against the JAX package's optax chain; adam_onecycle's
    lr and momentum over a whole run of 3 epochs."""
    cfg = dict(OPTIMIZER=name, LR=0.01, WEIGHT_DECAY=0.01, MOMENTUM=0.9,
               DECAY_STEP_LIST=[1, 2], LR_DECAY=0.1, LR_CLIP=1e-4,
               GRAD_NORM_CLIP=1.0, LR_WARMUP=warmup, WARMUP_EPOCH=1,
               DIV_FACTOR=10, MOMS=[0.95, 0.85], PCT_START=0.4)
    steps_per_epoch, epochs = 3, 3
    tx, jsched = jopt.build_optimizer(jconfig.EasyDict(cfg), steps_per_epoch,
                                      total_epochs=epochs)
    sched = build_lr_schedule(pconfig.EasyDict(cfg), steps_per_epoch,
                              total_epochs=epochs)
    for s in range(10):
        assert abs(sched(s) - float(jsched(s))) <= 1e-6 * float(jsched(s))
    if name == "adam_onecycle":
        jlr, jmom = jopt.onecycle_schedules(jconfig.EasyDict(cfg),
                                            steps_per_epoch * epochs)
        lr, mom = onecycle_schedules(pconfig.EasyDict(cfg),
                                     steps_per_epoch * epochs)
        for s in range(steps_per_epoch * epochs + 2):
            assert abs(lr(s) - float(jlr(jnp.int32(s)))) <= 1e-6 * lr(s)
            assert abs(mom(s) - float(jmom(jnp.int32(s)))) <= 1e-6
    rs = np.random.RandomState(0)
    params = {"a": rs.randn(4, 3).astype(np.float32),
              "b": rs.randn(5).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
    opt = Optimizer(list(tp.values()), pconfig.EasyDict(cfg),
                    steps_per_epoch, total_epochs=epochs)
    for i in range(8):
        scale = 5.0 if i % 2 else 0.1            # clipped and unclipped
        g = {k: (rs.randn(*v.shape) * scale).astype(np.float32)
             for k, v in params.items()}
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.zero_grad()
        for k, p in tp.items():
            p.grad = _t(g[k])
        opt.step()
    for k in params:
        assert _rel(tp[k], jp[k]) < 1e-6, k
    with pytest.raises(NotImplementedError, match="rmsprop"):
        Optimizer(list(tp.values()), pconfig.EasyDict(dict(
            cfg, OPTIMIZER="rmsprop")), 3)


# ------------------------------------------------------------ checkpoints
def _tiny_model(seed):
    cfg = pconfig.cfg_from_yaml_file(CFG, pconfig.EasyDict())
    mc = cfg.MODEL
    mc.BACKBONE_3D.update(PLANES=8, SPP_PLANES=8, OUT_CHANNELS=8)
    mc.DENSE_HEAD.update(OUT_CHANNELS=8, CLS_KERNEL=3)
    mc.ROI_HEAD.update(MLPS=[[8, 16, 16]], REG_FC=[16, 16])
    return build_network(mc, 18, generator=torch.Generator().manual_seed(
        seed), device="cpu"), cfg


def test_checkpoint_round_trip_and_jax_pickles(tmp_path):
    m, cfg = _tiny_model(0)
    opt = Optimizer(m.parameters(), cfg.OPTIMIZATION, 10)
    for p in m.parameters():
        p.grad = torch.ones_like(p) * 0.1
    opt.step()
    path = str(tmp_path / "checkpoint_epoch_1.pkl")
    pckpt.save_checkpoint(path, m, opt, epoch=1, it=7)
    m2, _ = _tiny_model(1)
    opt2 = Optimizer(m2.parameters(), cfg.OPTIMIZATION, 10)
    ck = pckpt.load_checkpoint(path)
    assert ck["epoch"] == 1 and ck["it"] == 7
    pckpt.restore(m2, opt2, ck)
    for (k, a), (_, b) in zip(m.state_dict().items(),
                              m2.state_dict().items()):
        _eq(a, b)
    assert opt2.count == 1
    st = opt2.opt.state_dict()["state"]
    ref = opt.opt.state_dict()["state"]
    for i in ref:
        _eq(st[i]["exp_avg"], ref[i]["exp_avg"])
    assert pckpt.latest_checkpoint(str(tmp_path)) == path
    # the JAX package's pickle of the same flat dicts loads into the port
    jpath = str(tmp_path / "jax.pkl")
    jckpt.save_checkpoint(jpath, {k: v.detach().numpy() for k, v in
                                  m.named_parameters()},
                          {k: v.numpy() for k, v in m.named_buffers()})
    m3, _ = _tiny_model(2)
    pckpt.restore(m3, None, pckpt.load_checkpoint(jpath))
    for (k, a), (_, b) in zip(m.state_dict().items(),
                              m3.state_dict().items()):
        _eq(a, b)
    with open(path, "rb") as f:          # and the port's loads into JAX's
        assert set(pickle.load(f)["params"]) == set(jckpt.load_checkpoint(
            jpath)["params"])


# -------------------------------------- K3 and the backward, plain vs JAX
def _classes(seed, G=3, P=600, C=64, cap=256, side=14):
    rs = np.random.RandomState(seed)
    lat = rs.randint(0, side, (G, P, 3)).astype(np.int32)
    feats = rs.randn(G, P, C).astype(np.float32)
    valid = rs.rand(G, P) > 0.2
    return jax.jit(lambda a, b, c: unique_voxels_classes(
        a, b, c, cap, mode="mean"))(lat, feats, valid)


@pytest.mark.parametrize("k,w_groups,C", [(3, 0, 64), (5, 0, 32),
                                          (3, 1, 16)])
def test_backward_subm_against_jax_grad(k, w_groups, C):
    fc, ff, fv = _classes(k + C, C=C)
    G = ff.shape[0]
    Gw = w_groups or G
    rs = np.random.RandomState(1)
    w = rs.randn(Gw, k ** 3, C, 32).astype(np.float32) * 0.1
    cot = rs.randn(G, ff.shape[1], 32).astype(np.float32)
    jdf, jdw = jax.jit(jax.grad(lambda f, ww: jnp.sum(subm_conv_classes_mxu(
        fc, fv, f, ww, k, 1, w_groups=w_groups) * cot), argnums=(0, 1)))(
        ff, w)
    dw = sparse_conv_dw_plain(_t(fc), _t(fv), _t(ff), _t(cot), k, Gw)
    df = sparse_conv_dfeats_plain(_t(fc), _t(fv), _t(w), k, _t(cot))
    assert _rel(dw, jdw) < 2e-2
    assert _rel(df, jdf) < 2e-2
    f, ww = _t(ff).requires_grad_(True), _t(w).requires_grad_(True)
    (sparse_conv(_t(fc), _t(fv), f, ww, k) * _t(cot)).sum().backward()
    assert _rel(ww.grad, jdw) < 2e-2
    assert _rel(f.grad, jdf) < 2e-2


@pytest.mark.parametrize("k,stride,cin", [(3, 2, 64), (5, 2, 16)])
def test_backward_at_coords_against_jax_grad(k, stride, cin):
    rs = np.random.RandomState(k)

    def table(seed, P, C):
        r = np.random.RandomState(seed)
        st, _ = jax.jit(lambda a, b, c: jvox.unique_voxels(a, b, c, 256))(
            r.randint(0, 12, (P, 3)).astype(np.int32),
            r.randn(P, C).astype(np.float32), r.rand(P) < 0.9)
        return st

    src, qry = table(2, 500, cin), table(3, 400, 1)
    w = rs.randn(k ** 3, cin, 48).astype(np.float32) * 0.1
    cot = rs.randn(qry.coords.shape[0], 48).astype(np.float32)
    scoords = src.coords * stride
    jdf, jdw = jax.jit(jax.grad(lambda f, ww: jnp.sum(conv_at_coords_mxu(
        scoords, src.valid, f, stride, qry.coords, qry.valid, k, ww) * cot),
        argnums=(0, 1)))(src.feats, w)
    args = (_t(src.coords)[None], _t(src.valid)[None])
    q = (_t(qry.coords)[None], _t(qry.valid)[None])
    dw = sparse_conv_dw_plain(*args, _t(src.feats)[None], _t(cot)[None], k,
                              1, *q)[0]
    df = sparse_conv_dfeats_plain(*args, _t(w)[None], k, _t(cot)[None],
                                  *q)[0]
    assert _rel(dw, jdw) < 2e-2
    assert _rel(df, jdf) < 2e-2


def test_train_model_and_auto_resume(tmp_path):
    """One epoch of one batch through ``train_model`` on the CPU: the
    checkpoint it writes restores model and optimizer via ``auto_resume``."""
    import logging
    from chip_smoke import synthetic_train_batch
    from cagroup3d_tpu_torch.training.train_loop import auto_resume, train_model

    class Loader:
        def __init__(self, batch):
            self.batch = {k: v.numpy() for k, v in batch.items()}

        def set_epoch(self, epoch):
            self.epoch = epoch

        def __iter__(self):
            return iter([self.batch])

    m, cfg = _tiny_model(3)
    m.roi_head.proposal_target_layer.roi_per_image = 8
    opt = Optimizer(m.parameters(), cfg.OPTIMIZATION, 1)
    batch = synthetic_train_batch(0, "cpu", 1, n_points=800,
                                  room=(3., 3., 2.5), n_objects=3)
    log = logging.getLogger("train_model_test")
    it = train_model(m, opt, Loader(batch), 1, str(tmp_path), log,
                     log_interval=1, device="cpu",
                     metrics_path=str(tmp_path / "metrics.jsonl"))
    assert it == 1 and opt.count == 1
    rec = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert len(rec) == 1 and '"train/loss":' in rec[0]
    m2, _ = _tiny_model(4)
    opt2 = Optimizer(m2.parameters(), cfg.OPTIMIZATION, 1)
    assert auto_resume(str(tmp_path), m2, opt2, log) == (1, 1)
    assert opt2.count == 1
    for (k, a), (_, b) in zip(m.state_dict().items(),
                              m2.state_dict().items()):
        _eq(a, b)


def test_scene_sync_stress():
    """Eight scene threads through 200 meetings each, with a short switch
    interval: every scene gets the in-order sum of that meeting's slots
    (a lost or overwritten slot breaks it), and a failing scene aborts
    the others instead of leaving them waiting."""
    import sys
    import threading
    n, rounds = 8, 200
    sync = SceneSync(n)
    got = [[] for _ in range(n)]

    def scene(i):
        for r in range(rounds):
            got[i].append(sync.allreduce(i, (torch.tensor(float(r * n + i)),
                                             ))[0])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=scene, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    want = [float(sum(r * n + i for i in range(n))) for r in range(rounds)]
    for i in range(n):
        assert [float(v) for v in got[i]] == want

    def failing(i):
        if i == 1:
            raise ValueError("scene 1 fails")
        return sync2.allreduce(i, (torch.ones(()),))

    sync2 = SceneSync(3)
    with pytest.raises(RuntimeError, match="scene 1") as e:
        run_scenes(failing, 3, sync2)
    assert isinstance(e.value.__cause__, ValueError)
