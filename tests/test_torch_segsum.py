"""K2 (sorted-run segment sums, ops/segsum.py) against the JAX package's
Pallas kernel in interpret mode (``sorted_segment_sums``) and a numpy
oracle.  Counts exact; sums within 2e-2 (bf16 rows, f32 sums).

The CUDA kernel is compared with this plain version in
``test_torch_cuda.py`` (on a GPU) and by ``chip_smoke.py`` at the main
path's shapes.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cagroup3d_tpu.core.hashing import INVALID_KEY, pack_coords
from cagroup3d_tpu.ops.pallas_segsum import sorted_segment_sums
from cagroup3d_tpu_torch.ops.segsum import segment_sums

torch.set_num_threads(1)


def _sorted_case(seed, G, P, F, side, occ, empty_group=False):
    rs = np.random.RandomState(seed)
    lat = rs.randint(0, side, (G, P, 3)).astype(np.int32)
    valid = rs.rand(G, P) < occ
    if empty_group:
        valid[-1] = False
    feats = rs.randn(G, P, F).astype(np.float32)
    keys = np.asarray(pack_coords(jnp.asarray(lat), jnp.asarray(valid)))
    order = np.argsort(keys, axis=1, kind="stable")
    sk = np.take_along_axis(keys, order, axis=1)
    fs = np.take_along_axis(feats, order[..., None], axis=1)
    fs[sk == int(INVALID_KEY)] = 0.0
    # the kernels read bf16 rows
    fs = np.asarray(torch.from_numpy(fs).to(torch.bfloat16).float())
    return sk, fs


def _oracle(sk, fs, cap):
    """Per group: sums/counts of the first ``cap`` key runs."""
    G, P = sk.shape
    sums = np.zeros((G, cap, fs.shape[-1]), np.float64)
    cnts = np.zeros((G, cap), np.int64)
    for g in range(G):
        uid, prev = -1, None
        for i in range(P):
            if sk[g, i] == int(INVALID_KEY):
                break
            if sk[g, i] != prev:
                uid, prev = uid + 1, sk[g, i]
            if uid < cap:
                sums[g, uid] += fs[g, i]
                cnts[g, uid] += 1
    return sums, cnts


CASES = {
    "overflow": dict(G=4, P=1024, F=32, side=12, occ=0.8, cap=64),
    "no_overflow_empty_group": dict(G=3, P=512, F=16, side=5, occ=0.5,
                                    cap=256, empty_group=True),
    "non_pow2_rows": dict(G=2, P=1280, F=16, side=10, occ=0.7, cap=64),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_segment_sums(name):
    c = dict(CASES[name])
    cap = c.pop("cap")
    sk, fs = _sorted_case(11, **c)
    sums, cnts = segment_sums(torch.from_numpy(sk),
                              torch.from_numpy(fs).to(torch.bfloat16), cap)
    jsums, jcnts = sorted_segment_sums(jnp.asarray(sk), jnp.asarray(fs), cap,
                                       interpret=True)
    osums, ocnts = _oracle(sk, fs, cap)
    np.testing.assert_array_equal(cnts.numpy(), np.asarray(jcnts))
    np.testing.assert_array_equal(cnts.numpy(), ocnts)
    for ref in (jsums, osums):
        ref = np.asarray(ref, np.float64)
        err = np.abs(sums.numpy() - ref).max() / (np.abs(ref).max() + 1e-9)
        assert err < 2e-2, err
    if c.get("empty_group"):
        assert (cnts.numpy()[-1] == 0).all()
