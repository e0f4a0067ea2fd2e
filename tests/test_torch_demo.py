"""The port's ``demo`` CLI, ``datasets/native_io`` and headless renderer
against the JAX package's (``tools/demo.py``,
``cagroup3d_tpu/datasets/native_io.py``,
``tools/visual_utils/headless_vis_utils.py``) on the CPU:

1. ``DemoDataset``: the batches of a ``.bin`` directory (one scene above
   the 100,000-point cap), an ``.npy`` file and a single ``.bin`` file
   equal the JAX demo's bit for bit.
2. The demo (``--device cpu``, a JAX-package checkpoint of the tiny
   CAGroup3D or RBGNet, a two-scene tree): its ``--out_file`` equals the
   port model's own ``forward_eval`` at epoch 1000 on those batches bit
   for bit, and the JAX demo's ``main()``, its ``make_eval_step``
   patched to return the port's outputs, writes the same pickle and logs
   the same lines.
3. ``native_io``: the native paths and the numpy paths each give the JAX
   module's bits at the same seed; rows are copied exactly up to the cap
   and distinct source rows above it; a missing file raises ``IOError``;
   the path taken is reported.
4. ``draw_scenes``: the PNG equals the JAX renderer's pixel for pixel;
   with matplotlib blocked, ``--render_dir`` fails naming matplotlib
   before any scene runs.
"""
import importlib.util
import logging
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cagroup3d_tpu.datasets import native_io as jnative
from cagroup3d_tpu.training.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from cagroup3d_tpu_torch.core.module import flat_state
from cagroup3d_tpu_torch.datasets import native_io
from cagroup3d_tpu_torch.models import build_network
from cagroup3d_tpu_torch.tools import demo
from cagroup3d_tpu_torch.tools.visual_utils import headless_vis_utils
from cagroup3d_tpu_torch.utils.synthetic import synthetic_batch
from chip_smoke import (CFGS, RBG_CFGS, build_model, cpu_caps, rbg_model,
                        tiny_model, tiny_rbg_model)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def _jax_module(name, rel):
    """A module of the JAX package's ``tools/`` loaded from its file."""
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jdemo = _jax_module("jax_tools_demo", "tools/demo.py")
jvis = _jax_module("jax_headless_vis_utils",
                   "tools/visual_utils/headless_vis_utils.py")


def _scene(rs, n):
    return np.concatenate([rs.rand(n, 3) * [6, 6, 2.5], rs.rand(n, 3)],
                          1).astype(np.float32)


# ---------------------------------------------------------------------------
# 1. DemoDataset
# ---------------------------------------------------------------------------

def test_demo_dataset_batches_match_jax(tmp_path):
    rs = np.random.RandomState(0)
    d = tmp_path / "bins"
    d.mkdir()
    for name, n in (("b_big", 100_517), ("a_small", 3001), ("c", 100_000)):
        _scene(rs, n).tofile(d / f"{name}.bin")
    wide = np.concatenate([_scene(rs, 2500), rs.rand(2500, 2)], 1)
    np.save(tmp_path / "one.npy", wide.astype(np.float64))
    cases = [(d, ".bin"), (tmp_path / "one.npy", ".npy"),
             (d / "a_small.bin", ".bin")]
    for path, ext in cases:
        mine, theirs = demo.DemoDataset(path, ext), \
            jdemo.DemoDataset(path, ext)
        assert mine.files == theirs.files and len(mine) == len(theirs)
        for i in range(len(theirs)):
            a, b = mine.batch(i), theirs.batch(i)
            assert a.keys() == b.keys()
            for k in b:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                assert a[k].tobytes() == b[k].tobytes(), (path, i, k)
            assert mine[i].tobytes() == theirs[i].tobytes()
    assert demo.DemoDataset(d).batch(1)["points_valid"].all()
    assert demo.DemoDataset(d).io_path == native_io.io_path()


# ---------------------------------------------------------------------------
# 2. the demo's output
# ---------------------------------------------------------------------------

YAMLS = {"cagroup3d": CFGS["scannet"], "rbgnet": RBG_CFGS["scannet"]}


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Two synthetic ScanNet-like rooms of 3000 and 2800 points."""
    d = tmp_path_factory.mktemp("demo_scenes")
    b = synthetic_batch(np.random.RandomState(0), batch_size=2,
                        n_points=3000, point_cap=3000, room=(3.0, 3.0, 2.5),
                        n_objects=4)
    for i in range(2):
        pts = b["points"][i][b["points_valid"][i]][:3000 - 200 * i]
        pts.tofile(d / f"scene{i}.bin")
    return d


class _Lines(logging.Handler):
    """The messages of one logger's own records."""

    def __init__(self, name):
        super().__init__()
        self.name_, self.lines = name, []

    def emit(self, record):
        if record.name == self.name_:
            self.lines.append(record.getMessage())


def _with_capture(create, handler):
    def wrapped(*a, **kw):
        logger = create(*a, **kw)
        logger.addHandler(handler)
        return logger
    return wrapped


def _port_run(kind, scenes, tmp_path, monkeypatch):
    """The port demo on ``scenes`` with a JAX-package checkpoint of the
    tiny ``kind`` model (gate open, prior lifted: it detects): (results,
    log lines, the model loaded from the checkpoint, args, cfg)."""
    ckpt, out = tmp_path / "ckpt.pkl", tmp_path / "dets.pkl"
    args, cfg = demo.parse_config([
        "--cfg_file", YAMLS[kind], "--data_path", str(scenes), "--ckpt",
        str(ckpt), "--out_file", str(out), "--device", "cpu"])
    n = len(cfg.CLASS_NAMES)
    if kind == "cagroup3d":
        tiny_model(cfg.MODEL)
        cpu_caps(cfg.MODEL)
        src = build_model(cfg.MODEL, n, "cpu", seed=1)
    else:
        tiny_rbg_model(cfg.MODEL)
        src = rbg_model(cfg.MODEL, n, "cpu", seed=1)
    P, S = flat_state(src)
    jax_save_checkpoint(str(ckpt), {k: v.detach().numpy() for k, v in
                                    P.items()},
                        {k: v.numpy() for k, v in S.items()})
    lines = _Lines("cagroup3d_tpu_torch")
    monkeypatch.setattr(demo, "create_logger", _with_capture(
        demo.create_logger, lines))
    ret = demo.main(args, cfg)
    with open(out, "rb") as f:
        dumped = pickle.load(f)
    model = build_network(cfg.MODEL, n, device="cpu")
    model.load_jax_params(str(ckpt))
    return ret, dumped, lines.lines, model, args, cfg


def _same_results(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys() == {"boxes", "scores", "labels", "file"}
        assert x["file"] == y["file"]
        for k in ("boxes", "scores", "labels"):
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape
            assert x[k].tobytes() == y[k].tobytes(), k


@pytest.mark.parametrize("kind", ["cagroup3d", "rbgnet"])
def test_demo_output_is_forward_eval_and_jax_format(kind, scenes, tmp_path,
                                                    monkeypatch):
    ret, dumped, lines, model, args, cfg = _port_run(kind, scenes, tmp_path,
                                                     monkeypatch)
    _same_results(ret, dumped)
    ds = demo.DemoDataset(scenes)
    outs = []
    for i in range(len(ds)):
        b = {k: torch.from_numpy(v) for k, v in ds.batch(i).items()}
        with torch.inference_mode():
            outs.append({k: v.numpy() for k, v in model.forward_eval(
                b, cur_epoch=1000.0).items()})
    want = [dict(boxes=o["pred_boxes"][0][o["pred_valid"][0]],
                 scores=o["pred_scores"][0][o["pred_valid"][0]],
                 labels=o["pred_labels"][0][o["pred_valid"][0]], file=f)
            for o, f in zip(outs, ds.files)]
    _same_results(dumped, want)
    assert sum(len(x["boxes"]) for x in dumped) > 0

    # the JAX demo's main() on the port's outputs
    import cagroup3d_tpu.config as jconfig
    import cagroup3d_tpu.parallel as jparallel
    import cagroup3d_tpu.utils.common_utils as jcommon
    from cagroup3d_tpu.config import EasyDict as JEasyDict
    epochs = []

    def make_eval_step(jmodel):
        def step(params, state, batch, cur_epoch):
            epochs.append(float(cur_epoch))
            pts = np.asarray(batch["points"])
            i = next(j for j in range(len(ds))
                     if ds.batch(j)["points"].tobytes() == pts.tobytes())
            return outs[i]
        return step

    jlines = _Lines("cagroup3d_tpu_r0")
    jout = tmp_path / "jax_dets.pkl"
    monkeypatch.setattr(jparallel, "make_eval_step", make_eval_step)
    monkeypatch.setattr(jconfig, "cfg", JEasyDict())
    monkeypatch.setattr(jcommon, "create_logger", _with_capture(
        jcommon.create_logger, jlines))
    monkeypatch.setattr(sys, "argv", [
        "demo.py", "--cfg_file", args.cfg_file, "--data_path", str(scenes),
        "--ckpt", args.ckpt, "--out_file", str(jout)])
    jdemo.main()
    with open(jout, "rb") as f:
        _same_results(dumped, pickle.load(f))
    assert epochs == [1000.0] * len(ds)
    assert lines[:-2] == jlines.lines[:-2]
    assert lines[-2:] == [f"wrote {args.out_file}", "Demo done."]
    assert jlines.lines[-2:] == [f"wrote {jout}", "Demo done."]
    assert any(" score=" in x for x in lines)


# ---------------------------------------------------------------------------
# 3. native_io
# ---------------------------------------------------------------------------

def _files(tmp_path, sizes=(500, 3000)):
    rs = np.random.RandomState(0)
    pts, ins, sem = [], [], []
    for i, n in enumerate(sizes):
        p = tmp_path / f"s{i}.bin"
        rs.rand(n, 6).astype(np.float32).tofile(p)
        pts.append(str(p))
        for lst, tag in ((ins, "i"), (sem, "m")):
            q = tmp_path / f"{tag}{i}.bin"
            rs.randint(0, 10, n).astype(np.int64).tofile(q)
            lst.append(str(q))
    return pts, ins, sem


def _same_batch(a, b):
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


@pytest.mark.parametrize("numpy_path", [False, True])
def test_native_io_matches_jax(numpy_path, tmp_path, monkeypatch):
    if numpy_path:
        monkeypatch.setattr(jnative, "_LIB", None)
        monkeypatch.setattr(jnative, "_TRIED", True)
        monkeypatch.setattr(native_io, "_state", dict(
            decided=True, lib=None, reason="blocked by the test"))
        assert native_io.io_path() == "numpy"
        assert native_io.fallback_reason() == "blocked by the test"
    else:
        assert native_io.available() and jnative.available()
        assert native_io.io_path() == "native"
        assert native_io.fallback_reason() is None
    pts, ins, sem = _files(tmp_path)
    for seed in (0, 7):
        for kw in (dict(), dict(ins_paths=ins), dict(ins_paths=ins,
                                                     sem_paths=sem)):
            mine = native_io.load_batch(pts, 1024, seed=seed, **kw)
            _same_batch(mine, jnative.load_batch(pts, 1024, seed=seed, **kw))
    p, valid, i_, s_ = native_io.load_batch(pts, 1024, ins, sem, seed=3)
    assert p.shape == (2, 1024, 6) and valid.dtype == bool
    assert valid[0].sum() == 500 and valid[1].sum() == 1024
    src0 = np.fromfile(pts[0], np.float32).reshape(-1, 6)
    assert p[0, :500].tobytes() == src0.tobytes()
    assert not p[0, 500:].any()
    assert (i_[0, :500] == np.fromfile(ins[0], np.int64)).all()
    src1 = np.fromfile(pts[1], np.float32).reshape(-1, 6)
    rows = {r.tobytes(): j for j, r in enumerate(src1)}
    picked = [rows[r.tobytes()] for r in p[1]]       # every row a source row
    assert len(set(picked)) == 1024                   # distinct
    sem1 = np.fromfile(sem[1], np.int64)
    assert (s_[1] == sem1[picked]).all()
    with pytest.raises(IOError):
        native_io.load_batch([str(tmp_path / "nope.bin")], 64)
    with pytest.raises(IOError):
        native_io.read_points(str(tmp_path / "nope.bin"), 64)
    got, n = native_io.read_points(pts[1], 1000)
    assert n == 1000 and got.tobytes() == src1[:1000].tobytes()
    got, n = native_io.read_points(pts[0], 1000)
    assert n == 500 and got[:500].tobytes() == src0.tobytes()
    assert not got[500:].any()


# ---------------------------------------------------------------------------
# 4. draw_scenes
# ---------------------------------------------------------------------------

def test_draw_scenes_matches_jax_pixels(tmp_path):
    import matplotlib.image as mpimg
    rng = np.random.RandomState(0)
    pts = (rng.randn(800, 6) * 3).astype(np.float32)
    gt = np.array([[2.0, 1.0, 0.0, 4.0, 2.0, 1.5, 0.3]], np.float32)
    det = np.array([[2.1, 1.0, 0.0, 4.1, 2.0, 1.5, 0.35],
                    [-3.0, 4.0, 0.2, 0.8, 0.8, 1.7, -1.2]], np.float32)
    kw = dict(gt_boxes=gt, ref_boxes=det, ref_labels=np.array([0, 3]),
              ref_scores=np.array([0.9, 0.4], np.float32), title="scene")
    a = headless_vis_utils.draw_scenes(pts, save_path=tmp_path / "p.png",
                                       **kw)
    b = jvis.draw_scenes(pts, save_path=tmp_path / "j.png", **kw)
    pa, pb = mpimg.imread(a), mpimg.imread(b)
    assert pa.shape == pb.shape and pa.shape[0] > 500
    assert np.array_equal(pa, pb)


def test_render_dir_without_matplotlib_fails_first(scenes, tmp_path,
                                                   monkeypatch):
    built = []
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setattr(demo, "build_network",
                        lambda *a, **k: built.append(a))
    args, cfg = demo.parse_config([
        "--cfg_file", CFGS["scannet"], "--data_path", str(scenes),
        "--render_dir", str(tmp_path / "png"), "--device", "cpu",
        "--out_file", str(tmp_path / "dets.pkl")])
    with pytest.raises(RuntimeError, match="--render_dir needs matplotlib"):
        demo.main(args, cfg)
    assert not built and not (tmp_path / "dets.pkl").exists()
    assert not (tmp_path / "png").exists()


def test_demo_needs_the_card_by_default(scenes, monkeypatch):
    args, cfg = demo.parse_config(["--cfg_file", CFGS["scannet"],
                                   "--data_path", str(scenes)])
    assert args.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main(args, cfg)
