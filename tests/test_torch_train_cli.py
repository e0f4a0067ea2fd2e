"""The port's ``train`` CLI (``cagroup3d_tpu_torch/tools/train.py``) against
the JAX package's ``tools/train.py`` on the CPU: the parsed configuration,
the seeded train loader's batches and the lr schedule equal the JAX CLI's;
training writes, prunes and resumes checkpoints that both packages and the
port's ``test`` CLI read.

The JAX CLI runs for real up to its ``train_model`` call (seeding, loader,
the jitted tiny model init, optax, auto-resume), which a recorder stands
in for.  Trees are 2-3 small synthetic scenes (``write_indoor_tree``) and
the model is the YAML's at tiny widths (set after parsing, as users' YAMLs
set them), so a training step takes a few seconds.
"""
import functools
import glob
import importlib.util
import json
import pickle
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import cagroup3d_tpu.config as jconfig
import cagroup3d_tpu.training.train_loop as jloop
from cagroup3d_tpu.models import build_network as jax_build_network
from cagroup3d_tpu.training.checkpoint import \
    load_checkpoint as jax_load_checkpoint
from cagroup3d_tpu.training.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from cagroup3d_tpu.training.optimization import \
    build_optimizer as jax_build_optimizer
from cagroup3d_tpu_torch.core.module import flat_state
from cagroup3d_tpu_torch.tools import test as test_cli
from cagroup3d_tpu_torch.tools import train as cli
from cagroup3d_tpu_torch.training import train_loop
from cagroup3d_tpu_torch.utils.synthetic import write_indoor_tree

from dist_jobs import tiny_cli_cfg

REPO = Path(__file__).resolve().parent.parent
NAMES = ("scannet", "sunrgbd")
SCENE = dict(n_points=1000, n_objects=4, room=(3.0, 3.0, 2.5))


def _cfg_file(name):
    return f"tools/cfgs/{name}_models/CAGroup3D.yaml"


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_tools_train", REPO / "tools" / "train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_parse(monkeypatch, argv):
    """The JAX CLI's (module, args, cfg) for ``argv``, on a fresh global
    cfg."""
    mod = _jax_cli()
    monkeypatch.setattr(jconfig, "cfg", jconfig.EasyDict())
    monkeypatch.setattr(sys, "argv", ["train.py", *argv])
    return (mod, *mod.parse_config())


def _plain(d):
    if isinstance(d, dict):
        return {k: _plain(v) for k, v in d.items()}
    if isinstance(d, (list, tuple)):
        return [_plain(v) for v in d]
    return d


def _tiny(cfg, root, repeat=None):
    """The YAML's model at tiny widths (``chip_smoke.tiny_model``, half its
    caps, a k3 class conv) on the tree at ``root``, every point loaded;
    ``repeat`` sets the train split's REPEAT (``dist_jobs.tiny_cli_cfg``)."""
    return tiny_cli_cfg(cfg, root, SCENE["n_points"], repeat)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{name: root}: 2-scene trees of both datasets."""
    out = {}
    for name in NAMES:
        root = tmp_path_factory.mktemp(name)
        names = jconfig.cfg_from_yaml_file(
            str(REPO / _cfg_file(name)), jconfig.EasyDict()).CLASS_NAMES
        write_indoor_tree(root, name, names, 2, seed=4, **SCENE)
        out[name] = root
    return out


def _run(name, root, argv, monkeypatch, cwd, repeat=1, train=None):
    """The port CLI's main on ``root`` at tiny widths from ``cwd``, with
    ``train`` in place of ``train_model`` when given.  Returns (main's
    output directory, cfg)."""
    args, cfg = cli.parse_config(["--cfg_file", str(REPO / _cfg_file(name)),
                                  "--device", "cpu", "--batch_size", "2",
                                  *argv])
    _tiny(cfg, root, repeat)
    if train is not None:
        monkeypatch.setattr(cli, "train_model", train)
    monkeypatch.chdir(cwd)
    return cwd / cli.main(args, cfg), cfg


# ---------------------------------------------------------------------------
# configuration, loader, schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_parse_config_equal(name, monkeypatch):
    argv = ["--cfg_file", _cfg_file(name), "--epochs", "3", "--extra_tag",
            "x", "--set", "OPTIMIZATION.LR", "0.002",
            "DATA_CONFIG.DATA_PATH", "/data/tree"]
    monkeypatch.chdir(REPO)
    _, jargs, jcfg = _jax_parse(monkeypatch, argv)
    args, cfg = cli.parse_config(argv)
    assert _plain(cfg) == _plain(jcfg)
    assert cfg.TAG == jcfg.TAG == "CAGroup3D"
    assert cfg.EXP_GROUP_PATH == jcfg.EXP_GROUP_PATH == \
        f"cfgs/{name}_models"
    assert cfg.OPTIMIZATION.LR == 0.002
    for k in ("cfg_file", "batch_size", "epochs", "extra_tag", "ckpt",
              "max_ckpt_save_num", "dist", "set_cfgs"):
        assert getattr(args, k) == getattr(jargs, k), k
    assert args.device == "cuda" and args.max_ckpt_save_num == 5


@pytest.mark.parametrize("name", NAMES)
def test_loader_and_schedule_equal_jax_cli(name, trees, monkeypatch,
                                           tmp_path):
    """Both CLIs run to their ``train_model`` call (the YAML's REPEAT: 10
    or 4 batches an epoch): the loader's first-epoch batches are equal
    bitwise and the optimizer's lr schedule is the JAX optax schedule's at
    every step of the run."""
    seen = {}

    def jax_train(model, tx, schedule, train_step, params, state, opt_state,
                  train_loader, total_epochs, ckpt_dir, logger, **kw):
        train_loader.set_epoch(kw["start_epoch"])
        seen["jax"] = (list(train_loader), schedule, total_epochs)

    def port_train(model, optimizer, train_loader, total_epochs, ckpt_dir,
                   logger, **kw):
        train_loader.set_epoch(kw["start_epoch"])
        seen["port"] = (list(train_loader), optimizer.schedule, total_epochs)

    argv = ["--cfg_file", str(REPO / _cfg_file(name)), "--batch_size", "2"]
    jmod, jargs, jcfg = _jax_parse(monkeypatch, argv)
    _tiny(jcfg, trees[name])
    monkeypatch.setattr(jmod, "parse_config", lambda: (jargs, jcfg))
    monkeypatch.setattr(jloop, "train_model", jax_train)
    monkeypatch.chdir(tmp_path)
    jmod.main()
    (tmp_path / "port").mkdir()
    _run(name, trees[name], [], monkeypatch, tmp_path / "port",
         repeat=None, train=port_train)

    (jb, jsched, jepochs), (pb, psched, pepochs) = seen["jax"], seen["port"]
    reps = jcfg.DATA_CONFIG.REPEAT.train
    assert len(pb) == len(jb) == reps and pepochs == jepochs
    for g, r in zip(pb, jb):
        assert g.keys() == r.keys()
        for k in r:
            if k == "frame_id":
                assert list(g[k]) == list(r[k])
                continue
            assert g[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
    got = [psched(t) for t in range(jepochs * len(jb) + 1)]
    ref = [float(jsched(t)) for t in range(jepochs * len(jb) + 1)]
    assert got == ref
    assert len(set(got)) == 3      # both decay steps fall inside the run


# ---------------------------------------------------------------------------
# training, checkpoints, resume
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained(trees, tmp_path_factory):
    """The port CLI trained on the 2-scene ScanNet tree (REPEAT 1, B = 2:
    one step an epoch), logging every step, with the lr decaying after
    epoch 1: first ``--epochs 1``, then ``--epochs 2`` in the same output
    directory.  Returns the output directory, the cfg and the log text
    of each call."""
    mp = pytest.MonkeyPatch()
    cwd = tmp_path_factory.mktemp("train_cli")
    logs = []
    try:
        mp.setattr(cli, "train_model",
                   functools.partial(train_loop.train_model, log_interval=1))
        for epochs in ("1", "2"):
            args, cfg = cli.parse_config(
                ["--cfg_file", str(REPO / _cfg_file("scannet")), "--device",
                 "cpu", "--batch_size", "2", "--epochs", epochs])
            _tiny(cfg, trees["scannet"], repeat=1)
            cfg.OPTIMIZATION.DECAY_STEP_LIST = [1]
            mp.chdir(cwd)
            rel = cli.main(args, cfg)
            logs.append("".join(Path(p).read_text() for p in sorted(
                glob.glob(str(cwd / rel / "log_train_*.txt")))))
    finally:
        mp.undo()
    return dict(out=cwd / rel, rel=rel, cfg=cfg, logs=logs)


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_train_writes_and_resumes(trained):
    out = trained["out"]
    one = _load(out / "ckpt" / "checkpoint_epoch_1.pkl")
    two = _load(out / "ckpt" / "checkpoint_epoch_2.pkl")
    assert (one["epoch"], one["it"]) == (1, 1)
    assert (two["epoch"], two["it"]) == (2, 2)
    assert one["opt_state"]["count"] == 1 and two["opt_state"]["count"] == 2
    first, second = trained["logs"][0], trained["logs"][1][len(
        trained["logs"][0]):]
    assert "auto-resuming" not in first
    ckpt_1 = trained["rel"] / "ckpt" / "checkpoint_epoch_1.pkl"
    assert f"auto-resuming from {ckpt_1} (epoch 1)" in second
    assert "Start training" in second and "End training" in second
    # the second call trained on from the restored weights
    assert any(not np.array_equal(one["params"][k], two["params"][k])
               for k in one["params"])

    lines = [json.loads(s) for s in
             (out / "metrics.jsonl").read_text().splitlines()]
    assert [ln["step"] for ln in lines] == [1, 2]
    for ln in lines:
        losses = [v for k, v in ln.items() if k.startswith("train/loss")]
        assert losses and all(np.isfinite(losses)), ln
    _, schedule = jax_build_optimizer(trained["cfg"].OPTIMIZATION, 1,
                                      total_epochs=2)
    assert [ln["train/lr"] for ln in lines] == \
        [float(schedule(ln["step"])) for ln in lines]
    assert lines[0]["train/lr"] < float(schedule(0))     # decayed


def test_checkpoint_loads_in_both_packages(trained, trees, monkeypatch,
                                           tmp_path):
    """The port's checkpoint holds the JAX model's parameter and state
    names and shapes (JAX ``load_checkpoint``), and the port's ``test``
    CLI evaluates it."""
    path = trained["out"] / "ckpt" / "checkpoint_epoch_2.pkl"
    ck = jax_load_checkpoint(str(path))
    cfg = trained["cfg"]
    jmodel = jax_build_network(model_cfg=cfg.MODEL,
                               num_class=len(cfg.CLASS_NAMES))
    P, S = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    for mine, theirs in ((ck["params"], P), (ck["state"], S)):
        assert set(mine) == set(theirs)
        for k, v in theirs.items():
            assert mine[k].shape == v.shape and mine[k].dtype == v.dtype, k

    args, tcfg = test_cli.parse_config(
        ["--cfg_file", str(REPO / _cfg_file("scannet")), "--device", "cpu",
         "--ckpt", str(path)])
    _tiny(tcfg, trees["scannet"])
    monkeypatch.chdir(tmp_path)
    ret = test_cli.main(args, tcfg)[str(path)]
    assert 0.0 <= ret["mAP_0.25"] <= 1.0


def test_max_ckpt_save_num_prunes(trees, monkeypatch, tmp_path):
    """Three epochs with ``--max_ckpt_save_num 2`` keep the last two
    checkpoints (the step itself is a stub: pruning is the loop's)."""
    def fake_step(model, optimizer, generator, device, **kw):
        def step(batch, cur_epoch=0.0):
            optimizer.count += 1
            return torch.tensor(1.0), {}
        return step

    monkeypatch.setattr(train_loop, "make_train_step", fake_step)
    out, _ = _run("scannet", trees["scannet"],
                  ["--epochs", "3", "--max_ckpt_save_num", "2"], monkeypatch,
                  tmp_path)
    kept = sorted(p.name for p in (out / "ckpt").iterdir())
    assert kept == ["checkpoint_epoch_2.pkl", "checkpoint_epoch_3.pkl"]
    assert _load(out / "ckpt" / "checkpoint_epoch_3.pkl")["it"] == 3


def test_ckpt_loads_jax_checkpoint(trees, monkeypatch, tmp_path):
    """``--ckpt`` with a checkpoint written by the JAX package's
    ``save_checkpoint`` starts training from exactly its weights."""
    seen = {}

    def record(model, optimizer, train_loader, total_epochs, ckpt_dir,
               logger, **kw):
        seen["P"], seen["S"] = flat_state(model)

    args, cfg = cli.parse_config(["--cfg_file",
                                  str(REPO / _cfg_file("scannet")),
                                  "--device", "cpu"])
    _tiny(cfg, trees["scannet"])
    model = cli.build_network(cfg.MODEL, len(cfg.CLASS_NAMES), device="cpu")
    rng = np.random.RandomState(0)
    P, S = ({k: (v.detach().numpy() + rng.randn(*v.shape).astype(
        v.detach().numpy().dtype) if v.is_floating_point() else
        v.detach().numpy()) for k, v in d.items()}
        for d in flat_state(model))
    ckpt = tmp_path / "jax_checkpoint.pkl"
    jax_save_checkpoint(str(ckpt), P, S, epoch=3, it=30)
    _run("scannet", trees["scannet"], ["--ckpt", str(ckpt)], monkeypatch,
         tmp_path, train=record)
    for mine, ref in ((seen["P"], P), (seen["S"], S)):
        assert set(mine) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(mine[k].detach().numpy(), ref[k],
                                          err_msg=k)


def test_dist_and_missing_card_raise(trees, monkeypatch, tmp_path):
    """``--dist`` outside torchrun raises instead of training in one
    process (``tests/test_torch_dist.py`` trains over two ranks)."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        _run("scannet", trees["scannet"], ["--dist"], monkeypatch, tmp_path)
    args, _ = cli.parse_config(["--cfg_file",
                                str(REPO / _cfg_file("scannet"))])
    assert args.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run("scannet", trees["scannet"], ["--device", "cuda"], monkeypatch,
             tmp_path)


# ---------------------------------------------------------------------------
# the NaN guard (tests/test_nan_guard.py's cases on the port's step) and
# --profile_dir / --workers
# ---------------------------------------------------------------------------

class _StubModel(torch.nn.Module):
    """The training step's model contract at its smallest:
    forward_train(batch, generator, cur_epoch, roi_draws) -> (loss, tb,
    running-stat updates)."""

    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(w)
        self.register_buffer("ema", torch.zeros(()))

    def forward_train(self, batch, generator, cur_epoch=0.0, roi_draws=None):
        h = torch.tanh(batch["x"] @ self.w)
        loss = torch.log1p(h ** 2).mean()
        return loss, {"loss": loss}, {"ema": self.ema * 0.9 + loss * 0.1}


def _stub(poison=False):
    from cagroup3d_tpu_torch.config import EasyDict
    from cagroup3d_tpu_torch.parallel.mesh import make_train_step
    from cagroup3d_tpu_torch.training.optimization import Optimizer
    w = torch.ones(8, 4) * 0.3
    if poison:
        w[0, 0] = float("nan")
    model = _StubModel(w)
    opt = Optimizer(model.parameters(), EasyDict(OPTIMIZER="adam", LR=1e-3),
                    1)
    batch = {"x": torch.from_numpy(np.random.RandomState(0).randn(16, 8)
                                   .astype(np.float32))}
    return model, opt, batch, make_train_step


def test_nan_guard_clean_step_passes():
    model, opt, batch, make_train_step = _stub()
    loss, tb = make_train_step(model, opt, device="cpu", nan_guard=True)(
        batch)
    assert np.isfinite(float(loss))


def test_nan_guard_poisoned_params_raise():
    model, opt, batch, make_train_step = _stub(poison=True)
    step = make_train_step(model, opt, device="cpu", nan_guard=True)
    with pytest.raises(FloatingPointError, match="(?i)nan|inf"):
        step(batch)
    assert torch.isnan(model.w[0, 0]) and float(model.ema) == 0.0


def test_nan_guard_env_var_enables_guard(monkeypatch):
    monkeypatch.setenv("CAGROUP_NAN_GUARD", "1")
    model, opt, batch, make_train_step = _stub(poison=True)
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        make_train_step(model, opt, device="cpu")(batch)


def test_nan_guard_off_by_default(monkeypatch):
    monkeypatch.delenv("CAGROUP_NAN_GUARD", raising=False)
    model, opt, batch, make_train_step = _stub(poison=True)
    loss, _ = make_train_step(model, opt, device="cpu")(batch)
    # the unguarded step silently produces a non-finite loss (what the
    # guard exists to catch loudly)
    assert not np.isfinite(float(loss))


def test_profile_dir_and_workers(trees, monkeypatch, tmp_path):
    """``--profile_dir`` writes a torch.profiler trace of the run;
    ``--workers`` is accepted (the loader collates in one thread).  The
    step is a stub with one torch op: the trace is the CLI's."""
    def fake_step(model, optimizer, generator, device, **kw):
        def step(batch, cur_epoch=0.0):
            optimizer.count += 1
            return torch.ones(3).sum(), {}
        return step

    monkeypatch.setattr(train_loop, "make_train_step", fake_step)
    trace = tmp_path / "trace"
    _run("scannet", trees["scannet"], ["--epochs", "1", "--workers", "2",
                                       "--profile_dir", str(trace)],
         monkeypatch, tmp_path)
    text = (trace / "trace.json").read_text()
    assert '"traceEvents"' in text and "aten::" in text
