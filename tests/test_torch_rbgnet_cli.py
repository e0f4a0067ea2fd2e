"""RBGNet through the port's ``build_network``, checkpoints and CLIs, on
the CPU.

``build_network`` builds RBGNet from both RBGNet YAMLs with the JAX
model's parameter and buffer names, shapes and dtypes (``jax.eval_shape``
of its init, at full width); ``load_jax_params`` reads a JAX-package
RBGNet checkpoint and rejects bad names and shapes; the port's ``test``
CLI (``--device cpu``) and one ``train`` CLI epoch run each YAML's RBGNet
at tiny widths given through ``--set`` (``chip_smoke.tiny_rbg_set``) on a
2-scene synthetic tree.
"""
import json
import pickle
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import cagroup3d_tpu.config as jconfig
from cagroup3d_tpu.models import build_network as jax_build_network
from cagroup3d_tpu.training.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from cagroup3d_tpu_torch.models import build_network, load_config
from cagroup3d_tpu_torch.models.detectors.rbgnet import RBGNet
from cagroup3d_tpu_torch.tools import test as test_cli
from cagroup3d_tpu_torch.tools import train as train_cli
from cagroup3d_tpu_torch.training.checkpoint import save_checkpoint
from cagroup3d_tpu_torch.utils.synthetic import write_indoor_tree
from chip_smoke import tiny_rbg_model, tiny_rbg_set

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
NAMES = ("scannet", "sunrgbd")
SCENE = dict(n_points=1000, n_objects=4, room=(3.0, 3.0, 2.5))


def _cfg_file(name):
    return str(REPO / f"tools/cfgs/{name}_models/RBGNet.yaml")


def _jax_shapes(name, tiny=False):
    """(params, state) of the JAX model's init as ShapeDtypeStructs."""
    cfg = jconfig.cfg_from_yaml_file(_cfg_file(name), jconfig.EasyDict())
    if tiny:
        tiny_rbg_model(cfg.MODEL)
    jm = jax_build_network(cfg.MODEL, num_class=len(cfg.CLASS_NAMES))
    return jax.eval_shape(jm.init, jax.random.PRNGKey(0))


def _specs(table):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in table.items()}


@pytest.mark.parametrize("name", NAMES)
def test_build_network_matches_jax_names_and_shapes(name):
    cfg = load_config(_cfg_file(name))
    m = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), device="cpu")
    assert isinstance(m, RBGNet)
    jp, js = _jax_shapes(name)
    assert _specs(dict(m.named_parameters())) == _specs(jp)
    assert _specs(dict(m.named_buffers())) == _specs(js)
    assert m.point_head.with_rot == (name == "sunrgbd")


def test_build_network_defaults_to_the_card_and_rejects_unported():
    cfg = load_config(_cfg_file("scannet"))
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            build_network(cfg.MODEL, len(cfg.CLASS_NAMES))
    cfg.MODEL.NAME = "PointRCNN"
    with pytest.raises(NotImplementedError):
        build_network(cfg.MODEL, 18, device="cpu")


def test_load_jax_params_reads_rbgnet_checkpoint(tmp_path):
    """A JAX-package checkpoint of the tiny SUN RGB-D RBGNet (random
    values under the JAX init's names) loads bitwise; a missing name, an
    extra one and a wrong shape raise."""
    jp, js = _jax_shapes("sunrgbd", tiny=True)
    rng = np.random.RandomState(0)
    P = {k: rng.randn(*v.shape).astype(v.dtype) for k, v in jp.items()}
    S = {k: rng.rand(*v.shape).astype(v.dtype) for k, v in js.items()}
    path = str(tmp_path / "ckpt.pkl")
    jax_save_checkpoint(path, P, S)
    cfg = load_config(_cfg_file("sunrgbd"))
    m = build_network(tiny_rbg_model(cfg.MODEL), len(cfg.CLASS_NAMES),
                      device="cpu")
    m.load_jax_params(path)
    for table, ref in ((m.named_parameters(), P), (m.named_buffers(), S)):
        for k, v in table:
            np.testing.assert_array_equal(v.detach().numpy(), ref[k])
    key = "point_head.raybasedgrouping.fuse_layer.mlp.layer0.conv.weight"
    with pytest.raises(KeyError):
        m.load_jax_params({k: v for k, v in P.items() if k != key}, S)
    with pytest.raises(KeyError):
        m.load_jax_params(dict(P, extra=np.zeros(3, np.float32)), S)
    with pytest.raises(ValueError):
        m.load_jax_params(dict(P, **{key: np.zeros((3, 3), np.float32)}), S)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    out = {}
    for name in NAMES:
        root = tmp_path_factory.mktemp(name)
        write_indoor_tree(root, name, load_config(_cfg_file(name))
                          .CLASS_NAMES, 2, seed=4, **SCENE)
        out[name] = root
    return out


def _small_data(cfg, root):
    """The tree at ``root``, every point loaded (data caps are not
    settable through ``--set``)."""
    dc = cfg.DATA_CONFIG
    dc.DATA_PATH = str(root)
    dc.POINT_CAP = SCENE["n_points"]
    dc.MAX_GT = 16
    for aug in (dc.DATA_AUGMENTOR_TRAIN, dc.DATA_AUGMENTOR_TEST):
        for st in aug.AUG_CONFIG_LIST:
            if st.NAME == "indoor_point_sample":
                st.num_points = SCENE["n_points"]
    return cfg


@pytest.mark.parametrize("name", NAMES)
def test_test_cli_runs_rbgnet(name, trees, tmp_path, monkeypatch):
    args, cfg = test_cli.parse_config(
        ["--cfg_file", _cfg_file(name), "--device", "cpu", "--ckpt",
         str(tmp_path / "checkpoint_epoch_3.pkl"), "--set", *tiny_rbg_set()])
    _small_data(cfg, trees[name])
    assert cfg.MODEL.POINT_HEAD.RAY_NUM == 18
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), device="cpu")
    save_checkpoint(args.ckpt, model, epoch=3)
    monkeypatch.chdir(tmp_path)
    ret = test_cli.main(args, cfg)[args.ckpt]
    out = tmp_path / "output" / cfg.EXP_GROUP_PATH / cfg.TAG / "default"
    with open(out / "eval" / "result.pkl", "rb") as f:
        det = pickle.load(f)
    assert len(det) == 2
    for k in ("mAP_0.25", "mAP_0.50", "mAR_0.25", "mAR_0.50"):
        assert np.isfinite(ret[k]) and 0.0 <= ret[k] <= 1.0
    for d in det:
        assert d["boxes_3d"].shape[1] == 7
        assert len(d["boxes_3d"]) == len(d["scores_3d"]) == \
            len(d["labels_3d"])


@pytest.mark.parametrize("name", NAMES)
def test_train_cli_runs_rbgnet_epoch(name, trees, tmp_path, monkeypatch):
    """One epoch at batch 2 over the 2-scene tree (REPEAT.train 1): one
    step, a finite logged loss, a checkpoint with the model's keys."""
    args, cfg = train_cli.parse_config(
        ["--cfg_file", _cfg_file(name), "--device", "cpu", "--epochs", "1",
         "--batch_size", "2", "--set", "DATA_CONFIG.REPEAT.train", "1",
         *tiny_rbg_set()])
    _small_data(cfg, trees[name])
    built = []
    build = train_cli.build_network

    def recording(*a, **kw):
        built.append(build(*a, **kw))
        return built[-1]

    monkeypatch.setattr(train_cli, "build_network", recording)
    monkeypatch.chdir(tmp_path)
    out = tmp_path / train_cli.main(args, cfg)
    with open(out / "ckpt" / "checkpoint_epoch_1.pkl", "rb") as f:
        ck = pickle.load(f)
    model = built[0]
    assert isinstance(model, RBGNet)
    assert (ck["epoch"], ck["it"]) == (1, 1)
    assert set(ck["params"]) == {k for k, _ in model.named_parameters()}
    assert set(ck["state"]) == {k for k, _ in model.named_buffers()}
    with open(out / "metrics.jsonl") as f:
        logged = [json.loads(ln) for ln in f]
    losses = [v for ln in logged for k, v in ln.items()
              if k.startswith("train/")]
    assert logged and all(np.isfinite(losses))
    assert "train/sample_loss_2" in logged[0]
