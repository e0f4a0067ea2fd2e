"""PyTorch port vs the JAX package: RBGNet's point-based modules on the CPU.

The PointNet++ ops (``core/pointnet2.py``), the SA and FP modules, the
PointNet2-FBS backbone, the vote module and its Chamfer distance, the box
coder, aligned 3D NMS and the cross-entropy / axis-aligned IoU losses,
each on the same seeded inputs and weights.  The port's functions take a
leading scene axis; the JAX ones take one scene and are vmapped here
(training-mode batch norm with ``axis_name="scene"``, whose ``psum`` pools
the scenes as the port's batched rows do).

Tolerances: f32 on both sides.  Indices (FPS, ball query, three-NN, the
backbone's index chains), found masks, NMS keep masks, labels and classes
exactly equal; float outputs within 1e-4 of the output's largest
magnitude; the backbone's training gradient within 1e-3 relative in norm
per parameter.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cagroup3d_tpu.config import EasyDict
from cagroup3d_tpu.core import pointnet2 as jpn2
from cagroup3d_tpu.core.module import Ctx as JCtx
from cagroup3d_tpu.models.backbones_3d import pointnet2_modules as jmods
from cagroup3d_tpu.models.backbones_3d.pointnet2_fbs_backbone import \
    PointNet2FBSBackbone as JBackbone
from cagroup3d_tpu.models.model_utils import rbgnet_utils as jutils
from cagroup3d_tpu.models.model_utils import vote_module as jvote
from cagroup3d_tpu.utils import loss_utils as jloss
from cagroup3d_tpu_torch.core import pointnet2 as pn2
from cagroup3d_tpu_torch.core.module import Ctx, flat_state
from cagroup3d_tpu_torch.models.backbones_3d.pointnet2_fbs_backbone import \
    PointNet2FBSBackbone
from cagroup3d_tpu_torch.models.backbones_3d.pointnet2_modules import (
    FPModule, SAModule)
from cagroup3d_tpu_torch.models.model_utils import rbgnet_utils as utils
from cagroup3d_tpu_torch.models.model_utils.vote_module import (
    VoteModule, chamfer_distance)
from cagroup3d_tpu_torch.utils import loss_utils as L

torch.set_num_threads(1)
TOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, tol=TOL):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-12)
    assert np.abs(got - ref).max() <= tol * scale, \
        np.abs(got - ref).max() / scale


def _equal(got, ref):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def _scenes(rng, B=2, N=300, scale=2.0):
    """Seeded scenes [B, N, 3] with the last rows of each scene invalid
    (scene b keeps N - 60 b points)."""
    xyz = (rng.rand(B, N, 3) * scale).astype(np.float32)
    valid = np.arange(N)[None, :] < (N - 60 * np.arange(B))[:, None]
    return xyz, valid


def _jax_params(P, S):
    return ({k: jnp.asarray(v.detach().numpy()) for k, v in P.items()},
            {k: jnp.asarray(v.numpy()) for k, v in S.items()})


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def test_fps_matches_jax():
    rng = np.random.RandomState(0)
    xyz, valid = _scenes(rng, B=3)
    valid[2] = False
    valid[2, 40:60] = True           # 20 valid points, 32 samples: repeats
    got = pn2.farthest_point_sample(_t(xyz), _t(valid), 32)
    ref = jax.vmap(lambda x, v: jpn2.farthest_point_sample(x, v, 32))(
        jnp.asarray(xyz), jnp.asarray(valid))
    _equal(got, ref)
    assert got.dtype == torch.int64
    assert set(got[2].tolist()) <= set(range(40, 60))


@pytest.mark.parametrize("chunk_elems", [1 << 26, 1 << 12])
def test_ball_query_matches_jax(chunk_elems, monkeypatch):
    """Several query chunks (a small element budget) give what one does."""
    monkeypatch.setattr(pn2, "CHUNK_ELEMS", chunk_elems)
    rng = np.random.RandomState(1)
    xyz, valid = _scenes(rng)
    centers = (rng.rand(2, 70, 3) * 2.0).astype(np.float32)
    cvalid = rng.rand(2, 70) < 0.8
    got_i, got_f = pn2.ball_query(0.3, 8, _t(xyz), _t(valid), _t(centers),
                                  _t(cvalid))
    ref_i, ref_f = jax.vmap(lambda *a: jpn2.ball_query(0.3, 8, *a))(
        jnp.asarray(xyz), jnp.asarray(valid), jnp.asarray(centers),
        jnp.asarray(cvalid))
    _equal(got_i, ref_i)
    _equal(got_f, ref_f)
    assert got_f.any() and not got_f.all()


def test_three_nn_interpolate_matches_jax():
    rng = np.random.RandomState(2)
    known, kvalid = _scenes(rng, N=40)
    unknown, uvalid = _scenes(rng, N=120)
    feats = rng.randn(2, 40, 5).astype(np.float32)
    dist, idx = pn2.three_nn(_t(unknown), _t(uvalid), _t(known), _t(kvalid))
    rdist, ridx = jax.vmap(jpn2.three_nn)(
        jnp.asarray(unknown), jnp.asarray(uvalid), jnp.asarray(known),
        jnp.asarray(kvalid))
    _equal(idx, ridx)
    _close(dist, rdist)
    assert not dist.requires_grad
    got = pn2.three_interpolate(_t(feats), idx, dist)
    ref = jax.vmap(jpn2.three_interpolate)(jnp.asarray(feats), ridx, rdist)
    _close(got, ref)


@pytest.mark.parametrize("zero_query", [False, True])
def test_query_and_group_matches_jax(zero_query):
    rng = np.random.RandomState(3)
    xyz, valid = _scenes(rng)
    feats = rng.randn(2, 300, 4).astype(np.float32)
    centers = (rng.rand(2, 30, 3) * 2.6 - 0.3).astype(np.float32)
    centers[:, :3] = 50.0                       # balls that find nothing
    cvalid = np.ones((2, 30), bool)
    out, idx, found = pn2.query_and_group(
        0.25, 6, _t(xyz), _t(valid), _t(centers), _t(cvalid), feats=_t(feats),
        zero_query=zero_query)
    r_out, r_idx, r_found = jax.vmap(lambda *a: jpn2.query_and_group(
        0.25, 6, *a, zero_query=zero_query))(
        jnp.asarray(xyz), jnp.asarray(valid), jnp.asarray(centers),
        jnp.asarray(cvalid), jnp.asarray(feats))
    _equal(idx, r_idx)
    _equal(found, r_found)
    _equal(out, r_out)
    assert not found[:, :3].any()
    if zero_query:
        assert (out[:, :3] == 0).all()


# ---------------------------------------------------------------------------
# SA / FP modules
# ---------------------------------------------------------------------------

def _jax_apply(fn, train, *args):
    """fn(ctx, *per-scene args) vmapped over scenes (BN pooled over them
    in training), jitted."""
    def scene(*a):
        ctx = JCtx(train=train, axis_name="scene")
        return fn(ctx, *a), ctx.updates
    return jax.jit(jax.vmap(scene, axis_name="scene"))(*args)


def _module_params(module, path):
    P, S = {}, {}
    module.init(P, S, torch.Generator().manual_seed(0), path)
    return P, S


@pytest.mark.parametrize("train", [False, True])
def test_sa_module_matches_jax(train):
    """FPS centers, then centers injected through ``sample_idx``."""
    rng = np.random.RandomState(4)
    xyz, valid = _scenes(rng)
    feats = rng.randn(2, 300, 6).astype(np.float32)
    sa = SAModule(48, 0.4, 8, [6, 16, 32])
    jsa = jmods.SAModule(48, 0.4, 8, [6, 16, 32])
    P, S = _module_params(sa, "sa")
    JP, JS = _jax_params(P, S)
    inj = np.stack([rng.permutation(240)[:48] for _ in range(2)])
    for sample_idx in (None, inj):
        ctx = Ctx(train=train)
        got = sa(P, S, ctx, "sa", _t(xyz), _t(feats), _t(valid),
                 sample_idx=None if sample_idx is None else _t(sample_idx))
        args = [jnp.asarray(a) for a in (xyz, feats, valid)]
        if sample_idx is None:
            ref, upd = _jax_apply(lambda c, x, f, v: jsa(JP, JS, c, "sa", x, f,
                                                         v), train, *args)
        else:
            ref, upd = _jax_apply(lambda c, x, f, v, i: jsa(
                JP, JS, c, "sa", x, f, v, sample_idx=i), train, *args,
                jnp.asarray(sample_idx))
        _close(got[0], ref[0])
        _close(got[1].detach(), ref[1])
        _equal(got[2], ref[2])
        _equal(got[3], ref[3])
        for k, v in upd.items():
            _close(ctx.updates[k], v[0])
        assert len(ctx.updates) == (len(upd) if train else 0)


@pytest.mark.parametrize("train", [False, True])
def test_fp_module_matches_jax(train):
    rng = np.random.RandomState(5)
    fine, fvalid = _scenes(rng, N=200)
    coarse, cvalid = _scenes(rng, N=64)
    ffeats = rng.randn(2, 200, 8).astype(np.float32)
    cfeats = rng.randn(2, 64, 16).astype(np.float32)
    fp = FPModule([24, 32, 16])
    P, S = _module_params(fp, "fp")
    JP, JS = _jax_params(P, S)
    ctx = Ctx(train=train)
    got = fp(P, S, ctx, "fp", _t(fine), _t(ffeats), _t(fvalid), _t(coarse),
             _t(cfeats), _t(cvalid))
    ref, upd = _jax_apply(lambda c, *a: jmods.FPModule([24, 32, 16])(
        JP, JS, c, "fp", *a), train,
        *[jnp.asarray(a) for a in (fine, ffeats, fvalid, coarse, cfeats,
                                   cvalid)])
    _close(got.detach(), ref)
    for k, v in upd.items():
        _close(ctx.updates[k], v[0])


# ---------------------------------------------------------------------------
# the FBS backbone
# ---------------------------------------------------------------------------

FBS_CFG = dict(
    IN_CHANNELS=3,
    SA_CONFIG=dict(NPOINTS=[128, 64, 32, 16], RADIUS=[0.2, 0.4, 0.8, 1.2],
                   NSAMPLE=[8, 8, 4, 4],
                   MLPS=[[16, 16, 32], [32, 32, 32], [32, 32, 32],
                         [32, 32, 32]],
                   FBS_MLPS=[[-1, -1], [16, 16], [16, 16], [16, 16]],
                   TOPK=[-1, 48, 24, 12], FG_NSAMPLE=[-1, 40, 24, 10]),
    FP_MLPS=[[32, 32], [32, 32]])


@pytest.fixture(scope="module")
def fbs():
    """The backbone on two 400-point scenes (the second with 300 valid),
    eval and train, with the train gradient of a seeded linear functional
    of its outputs, in both packages."""
    rng = np.random.RandomState(6)
    xyz, valid = _scenes(rng, N=400, scale=3.0)
    valid[1, 300:] = False
    rgb = rng.rand(2, 400, 3).astype(np.float32)
    cfg = EasyDict(FBS_CFG)
    net = PointNet2FBSBackbone(cfg, torch.Generator().manual_seed(0))
    jnet = JBackbone(cfg)
    P, S = flat_state(net, "backbone_3d")
    JP, JS = _jax_params(P, S)
    W = rng.randn(2, 64, 32).astype(np.float32)
    WS = [rng.randn(2, n, 2).astype(np.float32) for n in (128, 64, 32)]
    jxyz, jrgb, jvalid = map(jnp.asarray, (xyz, rgb, valid))

    def run(JP, train):
        def scene(x, f, v):
            ctx = JCtx(train=train, axis_name="scene")
            return jnet(JP, JS, ctx, x, f, v), ctx.updates
        return jax.vmap(scene, axis_name="scene")(jxyz, jrgb, jvalid)

    def functional(out):
        return jnp.sum(out["fp_features"] * W) + sum(
            jnp.sum(s * w) for (s, _), w in zip(out["sa_scores"], WS))

    @jax.jit
    def ref(JP):
        ev, _ = run(JP, False)
        (_, (tr, upd)), g = jax.value_and_grad(
            lambda p: (lambda o: (functional(o[0]), o))(run(p, True)),
            has_aux=True)(JP)
        return ev, tr, upd, g

    ev, tr, upd, g = ref(JP)
    out = {}
    for train in (False, True):
        ctx = Ctx(train=train)
        o = net(P, S, ctx, _t(xyz), _t(rgb), _t(valid))
        if train:
            (( o["fp_features"] * _t(W)).sum() + sum(
                (s * _t(w)).sum() for (s, _), w in zip(o["sa_scores"], WS))
             ).backward()
        out[train] = (o, ctx.updates)
    return dict(net=net, ref={False: (ev, {}), True: (tr, upd)}, out=out,
                grad=g)


@pytest.mark.parametrize("train", [False, True])
def test_fbs_backbone_matches_jax(fbs, train):
    got, upd = fbs["out"][train]
    ref, rupd = fbs["ref"][train]
    for k in ("fp_xyz", "fp_features"):
        _close(got[k].detach(), ref[k])
    for k in ("fp_valid", "fp_indices", "points_valid"):
        _equal(got[k], ref[k])
    assert got["fp_xyz"].shape == (2, 64, 3)
    assert len(got["sa_scores"]) == len(ref["sa_scores"]) == 3
    for (s, i), (rs, ri) in zip(got["sa_scores"], ref["sa_scores"]):
        _close(s.detach(), rs)
        _equal(i, ri)
    assert set(upd) == set(rupd)
    for k, v in rupd.items():
        _close(upd[k], v[0])


def test_fbs_backbone_gradient_matches_jax(fbs):
    worst = {}
    for k, p in fbs["net"].named_parameters():
        ref = np.asarray(fbs["grad"]["backbone_3d." + k], np.float64)
        worst[k] = np.linalg.norm(p.grad.double().numpy() - ref) / \
            np.linalg.norm(ref)
    assert max(worst.values()) < 1e-3, max(worst.items(), key=lambda x: x[1])


def test_fbs_foreground_sampling_takes_the_top_margins(fbs):
    """Level 1's centers: FG_NSAMPLE from the TOPK highest foreground
    margins among the valid points, the rest from the other valid ones."""
    got, _ = fbs["out"][False]
    score = got["sa_scores"][0][0]
    sm = torch.softmax(score, -1)
    idx = got["fp_indices"]                    # level 1's, into the input
    lvl0 = got["sa_scores"][0][1]              # level 0's, into the input
    for b in range(2):
        v = torch.isin(lvl0[b], torch.nonzero(torch.arange(400) <
                                               (400 if b == 0 else 300))[:, 0])
        margin = torch.where(v, sm[b, :, 1] - sm[b, :, 0],
                             torch.tensor(-1e10))
        top = set(lvl0[b][torch.argsort(-margin, stable=True)[:48]].tolist())
        chosen = idx[b].tolist()
        assert set(chosen[:40]) <= top
        assert not set(chosen[40:]) & top


# ---------------------------------------------------------------------------
# vote module, Chamfer distance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
def test_vote_module_matches_jax(train):
    rng = np.random.RandomState(7)
    xyz, valid = _scenes(rng, N=64)
    feats = rng.randn(2, 64, 8).astype(np.float32) * valid[..., None]
    cfg = dict(IN_CHANNELS=8, VOTE_PER_SEED=1, GT_PER_SEED=3,
               CONV_CHANNELS=(8, 8), NORM_FEATS=True, WITH_RES_FEAT=True,
               VOTE_LOSS=dict(LOSS_DST_WEIGHT=10.0))
    vm, jvm = VoteModule(cfg), jvote.VoteModule(cfg)
    P, S = {}, {}
    vm.init(P, S, torch.Generator().manual_seed(0), "vm")
    JP, JS = _jax_params(P, S)
    ctx = Ctx(train=train)
    got = vm(P, S, ctx, _t(xyz), _t(feats), _t(valid), prefix="vm")
    ref, upd = _jax_apply(lambda c, *a: jvm(JP, JS, c, *a, prefix="vm"),
                          train, *map(jnp.asarray, (xyz, feats, valid)))
    for g, r in zip(got, ref):
        _close(g.detach(), r)
    for k, v in upd.items():
        _close(ctx.updates[k], v[0])
    tgt = (rng.rand(2, 64, 9) * 0.3).astype(np.float32)
    mask = rng.rand(2, 64) < 0.7
    loss = vm.get_loss(_t(xyz), got[0], _t(valid), _t(mask), _t(tgt))
    rloss = jax.vmap(jvm.get_loss)(jnp.asarray(xyz), ref[0],
                                   jnp.asarray(valid), jnp.asarray(mask),
                                   jnp.asarray(tgt))
    _close(loss.detach(), rloss)


def test_chamfer_distance_matches_jax():
    rng = np.random.RandomState(8)
    src = rng.rand(2, 30, 3).astype(np.float32)
    dst = rng.rand(2, 12, 3).astype(np.float32)
    sv = rng.rand(2, 30) < 0.8
    dv = rng.rand(2, 12) < 0.7
    got = chamfer_distance(_t(src), _t(sv), _t(dst), _t(dv))
    ref = jax.vmap(jvote.chamfer_distance)(
        *map(jnp.asarray, (src, sv, dst, dv)))
    _close(got[0], ref[0])
    _close(got[1], ref[1])


# ---------------------------------------------------------------------------
# coder, NMS, losses
# ---------------------------------------------------------------------------

def test_generate_ray_equals_jax():
    for n in (18, 66):
        _equal(utils.generate_ray(n), jutils.generate_ray(n))


@pytest.mark.parametrize("with_rot", [False, True])
def test_coder_matches_jax(with_rot):
    rng = np.random.RandomState(9)
    boxes = np.concatenate([rng.rand(20, 3) * 4, rng.rand(20, 3) + 0.2,
                            (rng.rand(20, 1) - 0.5) * 4 * np.pi],
                           1).astype(np.float32)
    labels = rng.randint(0, 10, 20).astype(np.int32)
    coder = utils.RBGBBoxCoder(66, 12, 10, with_rot=with_rot)
    jcoder = jutils.RBGBBoxCoder(66, 12, 10, with_rot=with_rot)
    got = coder.encode(_t(boxes), _t(labels))
    ref = jcoder.encode(jnp.asarray(boxes), jnp.asarray(labels))
    assert set(got) == set(ref)
    for k in ref:
        if np.asarray(ref[k]).dtype.kind == "f":
            _close(got[k], ref[k])
        else:
            _equal(got[k], ref[k])
    logits = rng.randn(20, 12).astype(np.float32)
    res = rng.randn(20, 12).astype(np.float32) * 0.3
    _close(coder.decode_dir(_t(logits), _t(res)),
           jcoder.decode_dir(jnp.asarray(logits), jnp.asarray(res)))
    cls, r = utils.angle2class(_t(boxes[:, 6]), 12)
    jcls, jr = jutils.angle2class(jnp.asarray(boxes[:, 6]), 12)
    _equal(cls, jcls)
    _close(r, jr)
    _close(utils.class2angle(cls, r, 12), jutils.class2angle(jcls, jr, 12))


def test_aligned_3d_nms_matches_jax():
    """Scene 0 random boxes; scene 1 near-duplicates across classes and
    invalid rows.  Keep masks exactly equal."""
    rng = np.random.RandomState(10)
    lo = rng.rand(2, 60, 3).astype(np.float32) * 3
    hi = lo + rng.rand(2, 60, 3).astype(np.float32) + 0.3
    boxes = np.concatenate([lo, hi], -1)
    boxes[1, 30:] = boxes[1, :30] + 0.05
    scores = rng.rand(2, 60).astype(np.float32)
    classes = rng.randint(0, 3, (2, 60)).astype(np.int32)
    valid = np.ones((2, 60), bool)
    valid[1, ::7] = False
    got = utils.aligned_3d_nms(_t(boxes), _t(scores), _t(classes), _t(valid),
                               0.25)
    ref = jax.vmap(lambda *a: jutils.aligned_3d_nms(*a, 0.25))(
        *map(jnp.asarray, (boxes, scores, classes, valid)))
    _equal(got, ref)
    assert 0 < int(got.sum()) < 120
    assert not got[~_t(valid)].any()


def test_rbgnet_losses_match_jax():
    rng = np.random.RandomState(11)
    logits = rng.randn(3, 40, 2).astype(np.float32)
    labels = rng.randint(0, 2, (3, 40)).astype(np.int32)
    for w in (None, [0.2, 0.8]):
        _close(L.cross_entropy_with_logits(_t(logits), _t(labels), w),
               jloss.cross_entropy_with_logits(jnp.asarray(logits),
                                               jnp.asarray(labels), w))
    a = np.concatenate([rng.rand(50, 3), rng.rand(50, 3) + 1.0], 1)
    b = a + (rng.rand(50, 6) - 0.5) * 0.8
    a, b = a.astype(np.float32), b.astype(np.float32)
    w = rng.rand(50).astype(np.float32)
    _close(L.axis_aligned_iou_corners(_t(a), _t(b)),
           jloss.axis_aligned_iou_corners(jnp.asarray(a), jnp.asarray(b)))
    pa = _t(a).requires_grad_()
    loss = L.axis_aligned_iou_loss(pa, _t(b), _t(w))
    loss.backward()
    rl, rg = jax.value_and_grad(lambda x: jloss.axis_aligned_iou_loss(
        x, jnp.asarray(b), jnp.asarray(w)))(jnp.asarray(a))
    _close(loss.detach(), rl)
    _close(pa.grad, rg)
