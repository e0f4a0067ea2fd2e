"""PyTorch port vs the JAX package: CenterPoint on SECOND's base -- the
CenterNet utilities, the penalty-reduced focal loss and CenterHead (maps,
targets, loss, decode, NMS, the loss split over ranks) -- at the tiny
widths of ``tests/test_centerpoint.py::centerpoint_cfg`` (one group of two
classes on an 8 x 8 map), with the JAX init's parameters loaded into the
port and inputs from numpy seeds.  The sparse half (MeanVFE,
VoxelBackBone8x, HeightCompression) is SECOND's, which
``test_torch_second.py`` holds; here the head's stages run from a seeded
BEV map on, as ``test_torch_kitti_zoo.py`` runs the anchor heads'.

The untrained heatmap is flat (every logit near -2.19), so the decode, the
NMS and the whole ``forward_eval`` run on seeded ``hm`` logits.  The JAX
stages are jitted (eager JAX of the greedy NMS takes tens of seconds).

Tolerances: inds, masks, labels, NMS keep masks and peak indices exact;
gaussian radii within 1e-6 relative, heatmaps within 1e-6 absolute,
regression targets within 1e-5; the focal loss and its gradient within
1e-6 relative; head maps and decoded boxes within 1e-4 relative to the
largest magnitude (1e-5 for boxes, scores 1e-6); loss terms within 1e-4
relative; gradients within 1e-3 in norm per module (``_grads_close``); BN
running statistics within 1e-4; the whole ``forward_eval``'s boxes within
2e-2 (the sparse half's bf16 gathers on both sides); two faked ranks
against one process within 1e-5.
"""
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cagroup3d_tpu.core.module import Ctx as JCtx
from cagroup3d_tpu.models.model_utils import centernet_utils as jcu
from cagroup3d_tpu.utils import loss_utils as JL
from cagroup3d_tpu_torch.core.module import flat_state
from cagroup3d_tpu_torch.models.backbones_2d.base_bev_backbone import (
    conv2d_same, conv_transpose2d_same)
from cagroup3d_tpu_torch.models.dense_heads import center_head
from cagroup3d_tpu_torch.models.model_utils import centernet_utils as cu
from cagroup3d_tpu_torch.utils import loss_utils as L
from test_torch_kitti_zoo import (_batch, _bev, _grads_close,
                                  _jax_heads_step, _models, _rel, _rel_norm,
                                  _scene_ctxs, _t, _updates_close, bits)

torch.set_num_threads(1)
assert bits        # the key-bits fixture (autouse) of the zoo tests


def _port_outs(jout):
    """The JAX head's per-group dicts of [(B,) H, W, c] maps as the port's
    flat dict of [(B,) c, H, W] maps."""
    return {f"{k}_{g}": _t(v).movedim(-1, -3) for g, d in enumerate(jout)
            for k, v in d.items()}


def _gt(seed, B=2, G=6):
    """Seeded GT boxes [B, G, 8] (label last, 0-based) on the tiny 16 x 16
    m range with some invalid rows, two boxes sharing a class and a map
    cell, and a zero-size box."""
    rs = np.random.RandomState(seed)
    gt = np.zeros((B, G, 8), np.float32)
    gt[..., 0] = rs.rand(B, G) * 15.5
    gt[..., 1] = rs.rand(B, G) * 15.5 - 7.75
    gt[..., 2] = rs.rand(B, G) - 1.5
    gt[..., 3:6] = rs.rand(B, G, 3) * [3.0, 1.5, 1.5] + [0.5, 0.4, 1.0]
    gt[..., 6] = rs.rand(B, G) * 2 * np.pi - np.pi
    gt[..., 7] = rs.randint(0, 2, (B, G))
    gt[0, 1, :2] = gt[0, 0, :2] + 0.1
    gt[0, 1, 7] = gt[0, 0, 7]
    gt[1, 2, 3] = 0.0
    valid = rs.rand(B, G) < 0.8
    valid[:, 0] = True
    return gt, valid


# ------------------------------------------------------------ utilities
def test_gaussian_radius_and_heatmaps():
    """``gaussian_radius`` on seeded sizes; ``draw_gaussians_dense`` with
    two classes, objects of one class sharing a cell (the max), centers on
    and off integers, an invalid object and centers at the map's edge."""
    rs = np.random.RandomState(0)
    h, w = (rs.rand(64) * 20 + 0.1).astype(np.float32), \
        (rs.rand(64) * 20 + 0.1).astype(np.float32)
    for ov in (0.1, 0.5, 0.7):
        r = cu.gaussian_radius(_t(h), _t(w), ov)
        jr = jcu.gaussian_radius(jnp.asarray(h), jnp.asarray(w), ov)
        assert _rel(r.numpy(), jr) < 1e-6
    centers = np.array([[10.3, 20.7], [10.9, 20.2], [40.0, 5.0],
                        [0.0, 0.0], [63.5, 31.5], [30.0, 30.0]], np.float32)
    radii = np.array([3, 2, 2, 4, 2, 5], np.int32)
    cls_ids = np.array([0, 0, 1, 1, 0, 1], np.int32)
    valid = np.array([True, True, True, True, True, False])
    hm = cu.draw_gaussians_dense(_t(centers), _t(radii), _t(cls_ids),
                                 _t(valid), 2, (32, 64))
    jhm = jcu.draw_gaussians_dense(*map(jnp.asarray, (centers, radii,
                                                      cls_ids, valid)),
                                   2, (32, 64))
    assert hm.shape == (2, 32, 64)
    np.testing.assert_allclose(hm.numpy(), np.asarray(jhm), rtol=0,
                               atol=1e-6)
    assert float(hm[0, 20, 10]) == 1.0 and float(hm[1, 30, 30]) == 0.0


def test_topk_peaks_ties():
    """Peaks of a heatmap whose values repeat (quantized to 1/8): scores,
    classes, pixels and coordinates exactly ``jax.lax.top_k``'s, ties to
    the lower flat index."""
    rs = np.random.RandomState(1)
    hm = (np.floor(rs.rand(3, 8, 10) * 8) / 8).astype(np.float32)
    got = cu.topk_peaks(_t(hm), 50)
    want = jax.jit(jcu.topk_peaks, static_argnums=1)(jnp.asarray(hm), 50)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("positives", [True, False], ids=["pos", "no_pos"])
def test_focal_loss_centernet(positives):
    """The loss and its gradient against the JAX package's, with and
    without positives (then the negative term unnormalized), and with a
    mask."""
    rs = np.random.RandomState(2)
    pred = rs.rand(2, 6, 7, 3).astype(np.float32) * 0.98 + 0.01
    gt = rs.rand(2, 6, 7, 3).astype(np.float32) * 0.9
    if positives:
        gt[0, 1, 2, 0] = gt[1, 4, 4, 2] = 1.0
    mask = (rs.rand(2, 6, 7, 3) < 0.7).astype(np.float32)
    for m in (None, mask):
        p = _t(pred).requires_grad_()
        lo = L.focal_loss_centernet(p, _t(gt), None if m is None else _t(m))
        lo.backward()
        jl, jg = jax.value_and_grad(lambda x: JL.focal_loss_centernet(
            x, jnp.asarray(gt), None if m is None else jnp.asarray(m)))(
            jnp.asarray(pred))
        assert _rel(float(lo.detach()), float(jl)) < 1e-6
        assert _rel(p.grad.numpy(), jg) < 1e-6


# ------------------------------------------------------------------ head
def test_build_and_head_maps():
    """The tiny CenterPoint built without a dataset takes its classes from
    ``CLASS_NAMES_EACH_HEAD``; the 2-D backbone and every head map on a
    seeded BEV map (eval BN on seeded statistics) against the JAX
    package's."""
    jm, P, S, pm = _models("centerpoint")
    assert pm.class_names == jm.class_names == ["Car", "Pedestrian"]
    assert pm.dense_head.fmap_hw == jm.dense_head.fmap_hw == (8, 8)
    PP, SS = flat_state(pm)
    jbev = _bev((1, 8, 8, 256))[0]
    jout = jax.jit(lambda x: jm.dense_head.forward(
        P, S, JCtx(), jm.backbone_2d(P, S, JCtx(), x)))(jnp.asarray(jbev))
    with torch.no_grad():
        out = pm.dense_head(PP, pm.backbone_2d(PP, SS, _t(jbev).permute(
            2, 0, 1)), S=SS)
    want = _port_outs(jout)
    assert set(out) == set(want) == {"center_0", "center_z_0", "dim_0",
                                     "rot_0", "hm_0"}
    for k, v in want.items():
        assert out[k].shape == v.shape
        assert _rel(out[k].numpy(), v.numpy()) < 1e-4, k


@pytest.mark.parametrize("groups", [1, 2], ids=["one_group", "two_groups"])
def test_targets(groups):
    """``assign_targets_single`` per scene against the JAX package's, also
    with one group a class (nuScenes-style multi-group heads): heatmaps,
    inds, masks and regression targets."""
    jm, P, S, pm = _models("centerpoint")
    heads = [jm.dense_head, pm.dense_head]
    saved = [(h.groups, h.group_class_ids) for h in heads]
    if groups == 2:
        for h in heads:
            h.groups, h.group_class_ids = [["Car"], ["Pedestrian"]], [[0],
                                                                      [1]]
    try:
        gt, valid = _gt(3)
        for b in range(2):
            args = (gt[b, :, :7], gt[b, :, 7].astype(np.int32), valid[b])
            want = jax.jit(jm.dense_head.assign_targets_single)(
                *map(jnp.asarray, args))
            got = pm.dense_head.assign_targets_single(
                _t(args[0]), _t(args[1]).long(), _t(args[2]))
            assert len(got) == len(want) == groups
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g["inds"].numpy(),
                                              np.asarray(w["inds"]))
                np.testing.assert_array_equal(g["mask"].numpy(),
                                              np.asarray(w["mask"]))
                np.testing.assert_allclose(g["heatmap"].numpy(),
                                           np.asarray(w["heatmap"]), rtol=0,
                                           atol=1e-6)
                np.testing.assert_allclose(g["target"].numpy(),
                                           np.asarray(w["target"]),
                                           rtol=1e-5, atol=1e-5)
                assert float(g["heatmap"].max()) == 1.0
        assert not got[-1]["mask"][2]          # the zero-size box
    finally:
        for h, (gr, ids) in zip(heads, saved):
            h.groups, h.group_class_ids = gr, ids


def test_training_from_bev():
    """``train_heads`` (B = 2, train-mode BN over both maps) on seeded BEV
    maps against the JAX step: the loss and every tb term within 1e-4, the
    BN updates within 1e-4, the 2-D backbone's and the head's gradients
    within 1e-3 in norm."""
    jm, P, S, pm = _models("centerpoint")
    b = _batch(0)
    bevs = _bev((2, 8, 8, 256))
    (jloss, (jtb, jupd, _, _)), jg = _jax_heads_step(jm, P, S, bevs, b, [])
    pm.zero_grad()
    PP, SS = flat_state(pm)
    loss, tb, upd = pm.train_heads(PP, SS, _scene_ctxs(2),
                                   _t(bevs).permute(0, 3, 1, 2),
                                   {k: _t(v) for k, v in b.items()})
    loss.backward()
    assert set(tb) == set(jtb) == {"hm_loss_head_0", "loc_loss_head_0",
                                   "rpn_loss"}
    for k in jtb:
        assert abs(float(tb[k]) - float(jtb[k])) <= \
            1e-4 * abs(float(jtb[k])) + 1e-7, k
    assert float(tb["loc_loss_head_0"]) > 0
    assert abs(float(loss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    _updates_close(upd, jupd)
    _grads_close(pm, jg, ("backbone_2d.", "dense_head."))


def _seeded_maps(jout, seed=0):
    """Seeded head outputs of the JAX head's shapes: ``hm`` logits, center
    offsets in [0, 1), z about -1 m, log sizes about a car's and a
    pedestrian's, headings' (cos, sin) of any angle."""
    rs = np.random.RandomState(seed)

    def seeded(k, shape):
        x = rs.randn(*shape).astype(np.float32)
        if k == "center":
            return rs.rand(*shape)
        if k == "center_z":
            return 0.3 * x - 1
        if k == "dim":
            return 0.3 * x + np.log([2.5, 1.2, 1.5])
        return 2 * x if k == "hm" else x

    return [{k: jnp.asarray(seeded(k, v.shape).astype(np.float32))
             for k, v in d.items()} for d in jout]


def test_decode_and_nms():
    """On seeded head outputs (``_seeded_maps``): the decoded peaks
    (boxes, scores, labels, valid), ``decoded_boxes``' class scores and
    ``generate_predicted_boxes``' rotated NMS (the two classes' peaks at
    one cell share a box, so NMS suppresses) against the JAX package's."""
    jm, P, S, pm = _models("centerpoint")
    jbev = _bev((1, 8, 8, 256), seed=5)[0]
    jout = _seeded_maps(jax.jit(lambda x: jm.dense_head.forward(
        P, S, JCtx(), jm.backbone_2d(P, S, JCtx(), x)))(jnp.asarray(jbev)))
    tout = _port_outs(jout)
    want = jax.jit(jm.dense_head._decode_groups)(jout)
    got = pm.dense_head._decode_groups(tout)
    for i in (2, 3):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    assert _rel(got[0].numpy(), want[0]) < 1e-5
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6, atol=1e-6)
    jb, jf = jax.jit(jm.dense_head.decoded_boxes)(jout)
    b, f = pm.dense_head.decoded_boxes(tout)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-6,
                               atol=1e-6)
    jres = jax.jit(jm.dense_head.generate_predicted_boxes)(jout)
    res = pm.dense_head.generate_predicted_boxes(tout)
    np.testing.assert_array_equal(res[3].numpy(), np.asarray(jres[3]))
    np.testing.assert_array_equal(res[2].numpy(), np.asarray(jres[2]))
    n_valid = int(got[3].sum())
    assert 0 < int(res[3].sum()) < n_valid     # NMS kept some, dropped some
    assert _rel(res[0].numpy(), jres[0]) < 1e-5
    np.testing.assert_allclose(res[1].numpy(), np.asarray(jres[1]),
                               rtol=1e-6, atol=1e-6)


def test_forward_eval_on_seeded_heatmap():
    """The whole ``forward_eval`` from the points (one scene), both
    packages' heads handing on the same seeded ``hm`` logits: valid masks
    and labels exact, scores within 1e-6, boxes within 2e-2 of their
    largest magnitude (the sparse half's bf16 gathers)."""
    jm, P, S, pm = _models("centerpoint")
    b = _batch(4, B=1)
    H, W = pm.dense_head.fmap_hw
    hm = (np.random.RandomState(6).randn(H, W, 2) * 2).astype(np.float32)
    jfwd = jm.dense_head.forward

    def jforward(*a, **kw):
        return [dict(d, hm=jnp.asarray(hm)) for d in jfwd(*a, **kw)]

    pfwd = pm.dense_head.forward

    def pforward(*a, **kw):
        return dict(pfwd(*a, **kw), hm_0=_t(hm).permute(2, 0, 1))

    def jeval(bt, vs):
        # the voxel size goes in as an argument: closed over, XLA multiplies
        # by its reciprocal and floors points into other voxels than the
        # eager division, which the port follows
        saved, jm.voxel_size = jm.voxel_size, vs
        try:
            return jm.forward_eval(P, S, bt)
        finally:
            jm.voxel_size = saved

    jm.dense_head.forward, pm.dense_head.forward = jforward, pforward
    try:
        want = jax.jit(jeval)({k: jnp.asarray(b[k]) for k in (
            "points", "points_valid")}, jnp.asarray(jm.voxel_size,
                                                    jnp.float32))
        got = pm.forward_eval({k: _t(b[k]) for k in ("points",
                                                     "points_valid")})
    finally:
        jm.dense_head.forward = jfwd
        del pm.dense_head.forward
    assert got["pred_boxes"].shape == (1, 64, 7)
    for k in ("pred_valid", "pred_labels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_allclose(got["pred_scores"].numpy(),
                               np.asarray(want["pred_scores"]), rtol=1e-6,
                               atol=1e-6)
    assert int(got["pred_valid"].sum()) > 10
    assert _rel(got["pred_boxes"].numpy(), want["pred_boxes"]) < 2e-2


# --------------------------------------------------------------- --dist
class _TwoRanks:
    """Two ranks faked by two threads of this process: ``global_sum``
    meets the other thread and returns the sum of both ranks' tensors (in
    rank order)."""

    def __init__(self):
        self.barrier = threading.Barrier(2)
        self.slots = [None, None]

    def global_sum(self, t, group=None):
        r = group
        self.slots[r] = t.detach().clone()
        self.barrier.wait()
        out = self.slots[0] + self.slots[1]
        self.barrier.wait()
        return out


@pytest.mark.parametrize("case", ["both", "one", "none"])
def test_two_ranks_equal_one_process(case, monkeypatch):
    """The head's loss over two faked ranks of one scene each (seeded head
    outputs, ``_gt``'s objects; ``one``: rank 1's scene without a valid
    object, ``none``: no positive on either rank) against one process over
    both scenes: the ranks' mean loss and tb terms within 1e-5, and each
    rank's gradient of its scene's maps over W within 1e-5 in norm of the
    one process's."""
    jm, P, S, pm = _models("centerpoint")
    head = pm.dense_head
    gt, valid = _gt(7)
    if case == "one":
        valid[1] = False
    if case == "none":
        valid[:] = False
    rs = np.random.RandomState(8)
    PP, SS = flat_state(pm)
    with torch.no_grad():
        shapes = {k: (2,) + v.shape for k, v in head(
            PP, torch.zeros(64, 8, 8), S=SS).items()}
    outs = {k: (rs.randn(*s) * (2.0 if k.startswith("hm") else 0.5)
                ).astype(np.float32) for k, s in shapes.items()}

    def run(sl, group=None):
        o = {k: _t(v[sl]).requires_grad_() for k, v in outs.items()}
        loss, tb = head.loss(o, _t(gt[sl, :, :7]), _t(gt[sl, :, 7]).long(),
                             _t(valid[sl]), group=group)
        loss.backward()
        return float(loss), {k: float(v) for k, v in tb.items()}, \
            {k: v.grad for k, v in o.items()}

    ref = run(slice(0, 2))
    fake = _TwoRanks()
    monkeypatch.setattr(center_head, "group_size", lambda group: 2)
    monkeypatch.setattr(center_head, "global_sum", fake.global_sum)
    ranks = [None, None]

    def rank(r):
        ranks[r] = run(slice(r, r + 1), group=r)

    threads = [threading.Thread(target=rank, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert all(r is not None for r in ranks)
    assert _rel(np.mean([r[0] for r in ranks]), ref[0]) < 1e-5
    for k, v in ref[1].items():
        assert _rel(np.mean([r[1][k] for r in ranks]), v) < 1e-5, k
    if case == "none":
        assert ref[1]["loc_loss_head_0"] == 0.0
    for k in outs:
        mine = torch.cat([r[2][k] / 2 for r in ranks])
        assert _rel_norm(mine.numpy(), ref[2][k].numpy()) < 1e-5, k


# -------------------------------------------------- the 2-D convs' backward
class _CudnnAtConvs(TorchDispatchMode):
    """Records ``torch.backends.cudnn.enabled`` at every convolution and
    convolution backward that reaches the dispatcher."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in ("convolution", "convolution_backward"):
            self.seen.append((name, torch.backends.cudnn.enabled))
        return func(*args, **(kwargs or {}))


def test_bev_convs_backward_without_cudnn():
    """The 2-D convs (``conv2d_same`` at strides 1 and 2,
    ``conv_transpose2d_same``) and the tiny CenterPoint's head and 2-D
    backbone in training run forward and backward with cuDNN off, cuDNN
    being on around them; their gradients equal those of autograd's own
    convolution backward."""
    rs = np.random.RandomState(9)
    x = _t(rs.randn(2, 4, 6, 6).astype(np.float32))
    w = _t(rs.randn(3, 3, 4, 5).astype(np.float32))
    wt = _t(rs.randn(2, 2, 4, 5).astype(np.float32))
    cudnn = torch.backends.cudnn
    saved = cudnn.enabled
    cudnn.enabled = True
    try:
        for fn, wgt, s in ((conv2d_same, w, 1), (conv2d_same, w, 2),
                           (conv_transpose2d_same, wt, 2)):
            xs, ws = x.clone().requires_grad_(), wgt.clone().requires_grad_()
            with _CudnnAtConvs() as rec:
                fn(xs, ws, s).square().sum().backward()
            assert [n for n, _ in rec.seen] == ["convolution",
                                                "convolution_backward"]
            assert not any(on for _, on in rec.seen)
            assert cudnn.enabled
            # autograd's own convolution backward on the same convolution
            xr, wr = x.clone().requires_grad_(), wgt.clone().requires_grad_()
            if fn is conv2d_same:
                y = torch.nn.functional.conv2d(torch.nn.functional.pad(
                    xr, (1, 1, 1, 1) if s == 1 else (0, 1, 0, 1)),
                    wr.permute(3, 2, 0, 1), stride=s)
            else:
                y = torch.nn.functional.conv_transpose2d(
                    xr, wr.flip(0, 1).permute(2, 3, 0, 1), stride=s)
            y.square().sum().backward()
            assert torch.allclose(xs.grad, xr.grad, rtol=1e-6, atol=1e-6)
            assert torch.allclose(ws.grad, wr.grad, rtol=1e-6, atol=1e-6)
        jm, P, S, pm = _models("centerpoint")
        PP, SS = flat_state(pm)
        pm.zero_grad()
        b = _batch(0)
        with _CudnnAtConvs() as rec:
            loss, _, _ = pm.train_heads(PP, SS, _scene_ctxs(2),
                                        _t(_bev((2, 8, 8, 256))).permute(
                                            0, 3, 1, 2),
                                        {k: _t(v) for k, v in b.items()})
            loss.backward()
        n_conv = sum(n == "convolution" for n, _ in rec.seen)
        n_bwd = sum(n == "convolution_backward" for n, _ in rec.seen)
        assert n_conv == n_bwd == 6 + 2 + 1 + 10  # blocks, deblocks, head
        assert not any(on for _, on in rec.seen)
    finally:
        cudnn.enabled = saved
