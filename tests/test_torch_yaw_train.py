"""PyTorch port vs the JAX package: the SUN RGB-D yaw path's training
stages on the tiny yaw model of ``tests/test_torch_yaw.py``, under the
rules of ``tests/test_torch_train_stages.py``: the train-mode yaw head
(outputs and per-parameter gradients, jitted JAX under a scene vmap) and
its loss on the JAX head's outputs, then the RoI training forward and loss
with the JAX package's sampling draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from cagroup3d_tpu.core.module import Ctx as JCtx
from cagroup3d_tpu.core.sparse import SparseTensor as JST
from cagroup3d_tpu_torch.core.module import Ctx
from test_torch_train_stages import _grads_close, _jax_draws, _rel, _rel_norm
from cagroup3d_tpu_torch.core.sparse import SparseTensor
from test_torch_yaw import (N_CLS, _backbone, _grid_cells_apart, _t,
                            model)  # noqa: F401 (the fixture)

torch.set_num_threads(1)


def _port_st(jst, grad=False):
    f = _t(jst.feats).requires_grad_(grad)
    return SparseTensor(_t(jst.coords), f, _t(jst.valid), jst.stride)


def _head_cot(n2, cap):
    rs = np.random.RandomState(100)
    shapes = dict(semantic_scores=(n2, N_CLS), voxel_offsets=(n2, 9),
                  centernesses=(N_CLS, cap, 1), bbox_preds=(N_CLS, cap, 8),
                  cls_scores=(N_CLS, cap, N_CLS))
    return {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}


HEAD_FLOAT_OUTS = ("semantic_scores", "voxel_offsets", "centernesses",
                   "bbox_preds", "cls_scores")


def test_tiny_yaw_train_head(model):
    """Train-mode yaw head (jitted JAX under a scene vmap): outputs,
    per-parameter gradients and the input-feature gradient within 2e-2;
    then the yaw loss on the JAX outputs: targets, the loss and every tb
    entry within 1e-3, its gradients within 2e-2."""
    pm, jm, P, S = (model[k] for k in ("pm", "jm", "P", "S"))
    _, jst, origin, sc = _backbone(model, train=True)
    cap = pm.dense_head.fine_cap
    cot = _head_cot(jst.cap, cap)
    hp = {k: v for k, v in P.items() if k.startswith("dense_head.")}

    # the loss on the JAX head's outputs, GT in the voxel frame
    gt = sc["gt_boxes"][None].copy()
    gt[..., :3] -= origin
    args = (gt[..., :7], gt[..., 7].astype(np.int32), sc["gt_valid"][None],
            sc["points"][None, :, :3] - origin, sc["points_valid"][None])

    def f(hp, feats):
        def one(coords, valid, feats):
            return jm.dense_head.forward(
                {**P, **hp}, S, JCtx(train=True, axis_name="scene"),
                JST(coords, feats, valid, jst.stride), jnp.float32(0.15))
        out = jax.vmap(one, axis_name="scene")(
            jst.coords[None], jst.valid[None], feats[None])
        out = {k: v[0] for k, v in out.items()}
        return sum(jnp.sum(out[k] * cot[k]) for k in HEAD_FLOAT_OUTS), out

    @jax.jit
    def jhead_and_loss(hp, feats):
        (_, out), grads = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(hp, feats)
        outs = {k: v[None] for k, v in out.items()}
        rest = {k: v for k, v in outs.items() if k not in HEAD_FLOAT_OUTS}
        (_, tb), g = jax.value_and_grad(
            lambda fl: jm.dense_head.loss({**rest, **fl}, *args),
            has_aux=True)({k: outs[k] for k in HEAD_FLOAT_OUTS})
        return out, grads, tb, g

    jout, (jgh, jgf), jtb, jg = jhead_and_loss(hp, jst.feats)
    st = _port_st(jst, grad=True)
    pm.zero_grad()
    out = pm.dense_head(dict(pm.named_parameters()),
                        dict(pm.named_buffers()), Ctx(train=True), st, 0.15)
    for k in ("points_valid", "semantic_valid"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))
    for k in HEAD_FLOAT_OUTS:
        assert _rel(out[k], jout[k]) < 2e-2, k
    sum((out[k] * _t(cot[k])).sum() for k in HEAD_FLOAT_OUTS).backward()
    assert _grads_close(pm, jgh, "dense_head.") > 25
    assert _rel_norm(st.feats.grad, jgf) < 2e-2

    mine = {k: _t(np.asarray(v)[None]).requires_grad_(k in HEAD_FLOAT_OUTS)
            for k, v in jout.items()}
    loss, tb = pm.dense_head.loss(mine, *(_t(a) for a in args))
    loss.backward()
    assert float(jtb["loss_bbox"]) > 0 and float(jtb["loss_vote"]) > 0
    assert set(tb) == set(jtb)
    for k in tb:
        assert _rel(tb[k], jtb[k]) < 1e-3, (k, float(tb[k]), float(jtb[k]))
    for k in HEAD_FLOAT_OUTS:
        assert torch.isfinite(mine[k].grad).all(), k
        assert _rel_norm(mine[k].grad, jg[k]) < 2e-2, k


def test_tiny_yaw_train_roi(model):
    """RoI training forward + loss (smooth-L1 of the sin/cos codes and the
    rotated IoU loss) with the JAX package's sampling draws; the rois are
    jittered headed GT (foreground) and a few far boxes."""
    pm, jm, P, S = (model[k] for k in ("pm", "jm", "P", "S"))
    _, jst, origin, sc = _backbone(model, train=True)
    gt = sc["gt_boxes"].copy()
    gt[:, :3] -= origin
    G = int(sc["gt_valid"].sum())
    gt, gvalid = gt[:8], sc["gt_valid"][:8]
    rs = np.random.RandomState(9)
    aug = gt[:G, :7] + np.concatenate([rs.randn(G, 3) * 0.03,
                                       rs.randn(G, 3) * 0.02,
                                       rs.randn(G, 1) * 0.1], -1)
    far = gt[:2, :7] + np.array([0, 0, 5, 0, 0, 0, 0.3])
    rois = np.concatenate([aug, aug * [1, 1, 1, 1, 1, 1, -1], far])
    rois[:, 6] *= -1                  # the head's (mmdet3d) heading
    rois = rois.astype(np.float32)
    R = len(rois)
    scores = np.full(R, 0.9, np.float32)
    labels = np.concatenate([gt[:G, 7], gt[:G, 7], gt[:2, 7]]).astype(
        np.int32)
    valid = np.ones(R, bool)
    glab = gt[:, 7].astype(np.int32)
    key = jax.random.PRNGKey(3)
    rp = {k: v for k, v in P.items() if k.startswith("roi_head.")}

    def jfn(rp, feats, rois):
        out = jm.roi_head.forward_train(
            {**P, **rp}, S, JCtx(train=True, rng=key), jst.with_feats(feats),
            rois, jnp.asarray(scores), jnp.asarray(labels),
            jnp.asarray(valid), jnp.asarray(gt[:, :7]), jnp.asarray(glab),
            jnp.asarray(gvalid))
        loss, tb = jm.roi_head.loss({k: v[None] for k, v in out.items()})
        return loss, (out, tb)

    (jl, (jout, jtb)), (jgr, jgf, jgro) = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1, 2), has_aux=True))(rp, jst.feats, rois)
    draws = _jax_draws(jax.random.split(key)[1], R, 16)
    st = _port_st(jst, grad=True)
    rt = _t(rois).requires_grad_(True)
    pm.zero_grad()
    out = pm.roi_head.forward_train(
        dict(pm.named_parameters()), dict(pm.named_buffers()),
        Ctx(train=True), st, rt, _t(scores), _t(labels), _t(valid),
        _t(gt[:, :7]), _t(glab), _t(gvalid), draws=draws)
    np.testing.assert_array_equal(out["rois"].detach().numpy(),
                                  np.asarray(jout["rois"]))
    np.testing.assert_allclose(out["gt_of_rois"].detach().numpy(),
                               np.asarray(jout["gt_of_rois"]), atol=2e-6)
    assert int(out["reg_valid_mask"].sum()) > 0
    n_apart, _ = _grid_cells_apart(model, out["rois"].detach().numpy())
    print(f"RoI grid points in different lattice cells (against the JAX "
          f"package's eager grid): {n_apart}")
    loss, tb = pm.roi_head.loss({k: v[None] for k, v in out.items()})
    assert set(tb) == set(jtb) and float(jtb["rcnn_loss_iou"]) > 0
    for k in tb:
        assert _rel(tb[k], jtb[k]) < 1e-3, (k, float(tb[k]), float(jtb[k]))
    loss.backward()
    assert _grads_close(pm, jgr, "roi_head.") >= 10
    assert _rel_norm(st.feats.grad, jgf) < 2e-2
    assert float(np.abs(np.asarray(jgro)).max()) > 0
    assert torch.isfinite(rt.grad).all()
    assert _rel_norm(rt.grad, jgro) < 2e-2
