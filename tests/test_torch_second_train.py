"""PyTorch port vs the JAX package: SECOND's training step
(``tests/test_outdoor.py::second_cfg`` at tiny widths, B = 2), at the
default key bits and at KITTI's range and voxel size, where the lattice
packs at (11, 11, 8).

One jitted JAX graph a grid gives the reference: the step of the JAX
``SECONDNet.forward_train`` (the voxel size passed in as an argument, so
points floor into voxels by an IEEE division, as in the port; closed over,
XLA multiplies by its reciprocal), with each scene's BEV map and the
assigner's targets beside the loss, the tb terms, the BN updates and the
gradients.  At KITTI's grid the objects sit at x 52-66 m, past the 10-bit
x field, and the 2-D backbone strides 4 and 2 with anchors at stride 32
(44 x 50 locations): the JAX assigner computes its whole [A, G] IoU matrix,
15 GB at the YAML's 211,200 anchors.

The assigner's IoU matrix is held to the JAX package's within 1e-4 (f32
clippings of boxes 60 m from the origin: the shoelace sums cancel); where
a GT contains several anchors of its class (the tiny config's car-sized
"pedestrians"), their IoUs tie in exact arithmetic, and the clippings'
round-off (XLA's and torch's differ by about 1e-6) picks the force-matched
one, so the comparisons below run the port's assigner on the JAX step's
IoU matrices.  Tolerances: anchor labels and regression weights exact,
regression targets within 2 ulp (XLA's f32 log is not torch's); fed the
JAX BEV maps, every loss and tb term within 1e-5 relative, the 2-D
backbone's and the head's gradients within 1e-4 in norm and their BN
updates within 1e-5 of each buffer's scale; the whole step's loss within
1e-3 relative and every BN buffer within 1e-3 of its scale (the BEV maps
carry the sparse backbone's bf16 round-off: about 1% in norm).  The
sparse backbone's gradient is chaotic: bf16 gathers and cotangents on both
sides, and train-mode BN over the few voxels of a tiny scene's deep levels
(ROADMAP.md section 3); so, as ``chip_smoke.py`` holds the card to the
CPU, it must lie within 2e-2 in norm of the JAX step's or within twice
what the JAX step's own gradient moves when every weight is scaled by
1 + 1e-7.  ``test_backward_outside_scope`` holds the sparse backbone's VJP
alone, with eval BN and a positive cotangent, within 2e-2 in norm, with
``backward()`` called after the key bits' scope has closed.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cagroup3d_tpu.core import hashing as jhash
from cagroup3d_tpu.core.module import Ctx as JCtx
from cagroup3d_tpu.models import build_network as jbuild
from cagroup3d_tpu.models.dense_heads.anchor_head import bev_iou
from cagroup3d_tpu_torch.core import hashing
from cagroup3d_tpu_torch.core.module import Ctx, flat_state
from cagroup3d_tpu_torch.core.sparse import SparseTensor
from cagroup3d_tpu_torch.models import build_network
from cagroup3d_tpu_torch.parallel.mesh import make_train_step
from test_outdoor import outdoor_batch, second_cfg

torch.set_num_threads(1)

KITTI_RANGE = [0.0, -40.0, -3.0, 70.4, 40.0, 1.0]
KITTI_VOXEL = [0.05, 0.05, 0.1]
DEFAULT_BITS = (10, 10, 10)
KITTI_SHIFT = 50.0          # m along x: lattice x 1000-1320 > 1015


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def _rel_norm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


def _cfg(kitti: bool):
    c = second_cfg()
    if kitti:
        c.POINT_CLOUD_RANGE = KITTI_RANGE
        c.VOXEL_SIZE = KITTI_VOXEL
        c.BACKBONE_2D.LAYER_STRIDES = [4, 2]
        for a in c.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG:
            a["feature_map_stride"] = 32
    return c


def _batch(kitti: bool):
    b = {k: np.array(v) for k, v in
         outdoor_batch(np.random.RandomState(0), B=2).items()}
    if kitti:
        b["points"][..., 0] += KITTI_SHIFT
        b["gt_boxes"][..., 0] += KITTI_SHIFT
    return b


@pytest.fixture
def bits():
    """Both packages' key bits at the defaults during the test and restored
    after it (a JAX SECONDNet widens the JAX package's bits for good)."""
    old = (jhash.XBITS, jhash.YBITS, jhash.ZBITS), hashing.key_bits()
    jhash.set_key_bits(*DEFAULT_BITS)
    hashing.set_key_bits(*DEFAULT_BITS)
    yield
    jhash.set_key_bits(*old[0])
    hashing.set_key_bits(*old[1])


@functools.lru_cache(maxsize=None)
def _models(kitti: bool):
    """(JAX model, P, S, port model with the same parameters and BN
    statistics, JAX bits), built once a grid."""
    prev = (jhash.XBITS, jhash.YBITS, jhash.ZBITS)
    jhash.set_key_bits(*DEFAULT_BITS)
    jm = jbuild(_cfg(kitti), num_class=2)
    jbits = (jhash.XBITS, jhash.YBITS, jhash.ZBITS)
    jhash.set_key_bits(*prev)
    P, S = jax.jit(jm.init)(jax.random.PRNGKey(0))
    rs = np.random.RandomState(1)
    S = {k: (np.abs(rs.randn(*np.shape(v))) + 0.5 if k.endswith("var")
             else rs.randn(*np.shape(v)) * 0.1).astype(np.float32)
         for k, v in S.items()}
    pm = build_network(_cfg(kitti), num_class=2, device="cpu")
    pm.load_jax_params({k: np.asarray(v) for k, v in P.items()}, S)
    return jm, dict(P), {k: jnp.asarray(v) for k, v in S.items()}, pm, jbits


def _jax_step(jm, P, S, b, jbits):
    """The JAX training step on batch ``b`` at ``P`` and at ``P`` scaled by
    1 + 1e-7: ((loss, (tb, BN updates, BEV maps [B, H, W, C], the
    assigner's IoU matrices [B, A, G], targets (labels, reg targets, reg
    weights))), gradients) at each, under the JAX model's bits."""
    gt = jnp.asarray(b["gt_boxes"])
    boxes, labels = gt[..., :-1], gt[..., -1].astype(jnp.int32)
    gvalid = jnp.asarray(b["gt_valid"])
    head = jm.dense_head
    anchors, acls = jnp.asarray(head.anchors_np), \
        jnp.asarray(head.anchor_cls_np)

    def step(P, vs):
        def scene(points, pvalid, r):
            ctx = JCtx(train=True, axis_name="scene", rng=r)
            st = jm.vfe(P, S, ctx, points, pvalid, vs, jm.point_cloud_range,
                        jm.input_cap)
            bb = jm.backbone_3d(P, S, ctx, st)
            bev = jm.map_to_bev_module(P, S, ctx,
                                       bb["encoded_spconv_tensor"],
                                       jm._final_grid())
            out = head.forward(P, S, ctx, jm.backbone_2d(P, S, ctx, bev))
            return out, ctx.updates, ctx.stats, bev

        outs, upd, stats, bevs = jax.vmap(scene, axis_name="scene")(
            jnp.asarray(b["points"]), jnp.asarray(b["points_valid"]),
            jax.random.split(jax.random.PRNGKey(1), len(b["points"])))
        loss, tb = head.loss(outs, boxes, labels, gvalid)
        for k, v in stats.items():
            tb[k] = jnp.sum(v).astype(jnp.float32)
        ious = jax.vmap(lambda g, lab, v: jnp.where(
            (acls[:, None] == lab[None, :]) & v[None, :],
            bev_iou(anchors, g), -1.0))(boxes, labels, gvalid)
        tgts = jax.vmap(head.assign_targets)(boxes, labels, gvalid)
        return loss, (tb, {k: v[0] for k, v in upd.items()}, bevs, ious,
                      tgts)

    prev = (jhash.XBITS, jhash.YBITS, jhash.ZBITS)
    jhash.set_key_bits(*jbits)
    try:
        fn = jax.jit(jax.value_and_grad(step, has_aux=True))
        vs = jnp.asarray(jm.voxel_size, jnp.float32)
        out = [fn(P, vs), fn({k: v * (1 + 1e-7) for k, v in P.items()}, vs)]
    finally:
        jhash.set_key_bits(*prev)
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module", params=[False, True],
                ids=["default", "kitti"])
def setup(request):
    kitti = request.param
    jm, P, S, pm, jbits = _models(kitti)
    b = _batch(kitti)
    ref, pert = _jax_step(jm, P, S, b, jbits)
    return dict(kitti=kitti, jm=jm, P=P, S=S, pm=pm, jbits=jbits, b=b,
                ref=ref, jax_noise=pert[1])


@pytest.fixture
def jax_iou(setup, monkeypatch):
    """The port's assigner reads the JAX step's IoU matrices, scene by
    scene in batch order (see the module docstring)."""
    ious = iter(setup["ref"][0][1][3])
    monkeypatch.setattr(setup["pm"].dense_head, "match_iou",
                        lambda *a: _t(next(ious)))


def test_targets_match_jax(setup, bits):
    """The assigner on the batch's GTs: the IoU matrix within 1e-4 of the
    JAX package's (-1 off class exactly); on the JAX matrix, labels and
    regression weights exact and regression targets within 2 ulp;
    positives exist."""
    pm, b = setup["pm"], setup["b"]
    (_, (_, _, _, jiou, (jlab, jtgt, jw))), _ = setup["ref"]
    head = pm.dense_head
    match_iou = head.match_iou
    for i in range(len(b["gt_boxes"])):
        g = (_t(b["gt_boxes"][i, :, :7]), _t(b["gt_boxes"][i, :, 7]).long(),
             _t(b["gt_valid"][i]))
        iou = match_iou(*g).numpy()
        np.testing.assert_array_equal(iou == -1, jiou[i] == -1)
        np.testing.assert_allclose(iou, jiou[i], rtol=0, atol=1e-4)
        head.match_iou = lambda *a: _t(jiou[i])
        try:
            lab, tgt, w = head.assign_targets(*g)
        finally:
            del head.match_iou
        np.testing.assert_array_equal(lab.numpy(), jlab[i])
        np.testing.assert_array_equal(w.numpy(), jw[i])
        np.testing.assert_allclose(tgt.numpy(), jtgt[i], rtol=2.5e-7,
                                   atol=2.5e-7)
        assert int((lab > 0).sum()) > 0


def test_loss_on_jax_bev_maps(setup, bits, jax_iou):
    """The 2-D backbone, head and anchor loss fed the JAX step's BEV maps:
    every loss and tb term, the gradients of ``backbone_2d`` and
    ``dense_head`` and the 2-D backbone's BN updates against the JAX
    step's."""
    pm, b = setup["pm"], setup["b"]
    (_, (jtb, jupd, jbevs, _, _)), jg = setup["ref"]
    PP, SS = flat_state(pm)
    pm.zero_grad()
    upd = {}
    bev2d = pm.backbone_2d(PP, SS, _t(jbevs).permute(0, 3, 1, 2),
                           updates=upd)
    gt = _t(b["gt_boxes"])
    loss, tb = pm.dense_head.loss(pm.dense_head(PP, bev2d), gt[..., :7],
                                  gt[..., 7].long(), _t(b["gt_valid"]))
    loss.backward()
    for k, v in tb.items():
        assert abs(float(v.detach()) - float(jtb[k])) <= \
            1e-5 * abs(float(jtb[k])), k
    assert float(tb["rpn_loss_loc"]) > 0
    for pre in ("backbone_2d.", "dense_head."):
        names = [k for k in jg if k.startswith(pre)]
        a = np.concatenate([PP[k].grad.numpy().ravel() for k in names])
        r = np.concatenate([jg[k].ravel() for k in names])
        assert _rel_norm(a, r) < 1e-4, pre
    assert set(upd) == {k for k in jupd if k.startswith("backbone_2d.")}
    for k, v in upd.items():
        assert _rel(v, jupd[k]) < 1e-5, k


def test_training_step_matches_jax(setup, bits, jax_iou):
    """The whole step through ``make_train_step``'s forward and
    ``backward()`` (the key bits' scope closed before it): the loss, the
    tb keys, every BN buffer's update, and the sparse backbone's gradient
    (chaotic: see the module docstring)."""
    pm, b = setup["pm"], setup["b"]
    (jloss, (jtb, jupd, _, _, _)), jg = setup["ref"]
    pm.zero_grad()
    loss, tb, upd = pm.forward_train({k: _t(v) for k, v in b.items()},
                                     torch.Generator().manual_seed(0))
    assert hashing.key_bits() == DEFAULT_BITS
    loss.backward()
    loss = float(loss.detach())
    assert abs(loss - float(jloss)) <= 1e-3 * abs(float(jloss))
    assert set(tb) == set(jtb) | {"loss_all"}
    for k in jtb:
        if k.startswith("overflow/"):
            assert float(tb[k]) == float(jtb[k]), k
    assert set(upd) == set(jupd)
    for k, v in upd.items():
        assert _rel(v, jupd[k]) < 1e-3, k
    names = [k for k in jg if k.startswith("backbone_3d.")]
    PP = dict(pm.named_parameters())
    assert all(PP[k].grad is not None for k in names)
    a = np.concatenate([PP[k].grad.numpy().ravel() for k in names])
    r = np.concatenate([jg[k].ravel() for k in names])
    noise = np.concatenate([setup["jax_noise"][k].ravel() for k in names])
    assert _rel_norm(a, r) <= max(2e-2, 2 * _rel_norm(noise, r))


def test_make_train_step_updates_buffers(bits):
    """``make_train_step`` on the CPU with adam_onecycle: the step's loss
    is the forward's, and one step writes every BN buffer and moves every
    parameter."""
    from cagroup3d_tpu_torch.config import EasyDict
    from cagroup3d_tpu_torch.training.optimization import build_optimizer
    pm = build_network(_cfg(False), num_class=2, device="cpu")
    batch = {k: _t(v) for k, v in _batch(False).items()}
    with torch.no_grad():
        want = pm.forward_train(batch, torch.Generator())[0]
    opt, _ = build_optimizer(pm, EasyDict(dict(
        OPTIMIZER="adam_onecycle", LR=0.003, WEIGHT_DECAY=0.01,
        MOMS=[0.95, 0.85], PCT_START=0.4, DIV_FACTOR=10,
        GRAD_NORM_CLIP=10)), 1, total_epochs=2)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    step = make_train_step(pm, opt, device=torch.device("cpu"))
    loss, tb = step(batch)
    assert float(loss) == float(want) == float(tb["loss_all"])
    assert {k for k, v in pm.state_dict().items()
            if not torch.equal(v, before[k])} == set(before)
    assert opt.count == 1 and opt.opt.param_groups[0]["betas"] == (
        opt.momentum(0), 0.99)


def test_backward_outside_scope(bits):
    """The key-bits repair: at KITTI's grid ((11, 11, 8) bits; the
    objects at x 52-66 m, lattice x past the 10-bit field) the sparse
    backbone's forward runs inside the model's scope and ``backward()``
    after it has closed, as the training step calls it; its parameters'
    gradient (eval BN, a positive cotangent on the BEV level) within 2e-2
    in norm of the JAX VJP, and each conv's weight gradient within 0.25
    (bf16 round-off grows towards the input, to about 0.13 at the stem;
    packed at 10/10/10, the stride-1 convs lose most of their pairs and
    their gradients are off by nearly 1)."""
    jm, P, S, pm, jbits = _models(True)
    b = _batch(True)
    pts, pv = b["points"][0], b["points_valid"][0]
    prev = (jhash.XBITS, jhash.YBITS, jhash.ZBITS)
    jhash.set_key_bits(*jbits)
    try:
        jst = jax.jit(lambda p, v, vs: jm.vfe(
            P, S, JCtx(), p, v, vs, jm.point_cloud_range, jm.input_cap))(
            jnp.asarray(pts), jnp.asarray(pv),
            jnp.asarray(jm.voxel_size, jnp.float32))
        bp = {k: v for k, v in P.items() if k.startswith("backbone_3d.")}

        def f(bp):
            return jm.backbone_3d({**P, **bp}, S, JCtx(), jst)[
                "encoded_spconv_tensor"].feats

        jout, vjp = jax.vjp(jax.jit(f), bp)
        cot = np.abs(np.random.RandomState(5).randn(*jout.shape)).astype(
            np.float32)
        (jg,) = jax.jit(vjp)(jnp.asarray(cot))
    finally:
        jhash.set_key_bits(*prev)
    assert (np.asarray(jst.coords)[np.asarray(jst.valid), 0] > 1015).any()
    pm.zero_grad()
    PP, SS = flat_state(pm)
    with hashing.key_bits_scope(pm.key_bits):
        out = pm.backbone_3d(PP, SS, Ctx(), SparseTensor(
            _t(jst.coords), _t(jst.feats), _t(jst.valid), 1))
    assert hashing.key_bits() == DEFAULT_BITS
    feats = out["encoded_spconv_tensor"].feats
    assert _rel(feats.detach(), jout) < 2e-2
    (feats * _t(cot)).sum().backward()
    names = sorted(bp)
    a = np.concatenate([PP[k].grad.numpy().ravel() for k in names])
    r = np.concatenate([np.asarray(jg[k]).ravel() for k in names])
    assert _rel_norm(a, r) < 2e-2
    for k in names:
        if k.endswith(".kernel"):
            assert _rel_norm(PP[k].grad, jg[k]) < 0.25, k


def test_force_match_duplicates_match_jax(bits):
    """Several GTs forcing one anchor: the last in GT order decides, as the
    JAX package's scatter does; padded (invalid) GTs point at anchor 0 and
    clear it.  Labels, targets and weights against the JAX assigner."""
    jm, _, _, pm, _ = _models(False)
    anchors = pm.dense_head.anchors_np
    car = np.flatnonzero(pm.dense_head.anchor_cls_np == 0)
    a = anchors[car[5]]
    gt = np.zeros((6, 8), np.float32)
    valid = np.zeros(6, bool)
    # two small cars on one car anchor (both force it), a car far outside
    # the range (its best IoU is 0: it points at the first car anchor)
    gt[0, :7] = [a[0], a[1], a[2], 0.5, 0.5, 1.0, 0.0]
    gt[1, :7] = [a[0] + 0.05, a[1], a[2], 0.6, 0.4, 1.0, 0.3]
    gt[2, :7] = [500.0, 0.0, -1.0, 3.9, 1.6, 1.5, 0.0]
    gt[3, :7] = [a[0] + 3.0, a[1] + 1.0, a[2], 0.8, 0.6, 1.7, 0.1]
    gt[3, 7] = 1
    valid[:4] = True
    ref = jax.jit(jm.dense_head.assign_targets)(
        jnp.asarray(gt[:, :7]), jnp.asarray(gt[:, 7].astype(np.int32)),
        jnp.asarray(valid))
    got = pm.dense_head.assign_targets(_t(gt[:, :7]), _t(gt[:, 7]).long(),
                                       _t(valid))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                               rtol=2.5e-7, atol=2.5e-7)
    assert int((got[0] > 0).sum()) > 0 and int(got[0][0]) == 0


def test_dist_raises_for_second(monkeypatch):
    """``--dist`` training no longer raises for SECOND: with two ranks
    faked in one process (``test_torch_kitti_dist.collective_order``), its
    training forward issues one cross-rank BN sum a BN (the sparse half's
    from the scene threads, then the BEV maps'), in the same numbered
    order as either rank, and its backward the reverse order."""
    from test_torch_kitti_dist import check_collective_order
    batch = {k: _t(v) for k, v in _batch(False).items()}
    check_collective_order(
        lambda: build_network(_cfg(False), num_class=2, device="cpu"), batch,
        monkeypatch)
