"""The port's overfit gate (``cagroup3d_tpu_torch/tools/overfit_check.py``)
against the JAX package's ``tools/overfit_check.py`` on the CPU: the tiny
configuration and the synthetic scenes equal the JAX tests' own, the
scene draws equal the JAX gate's, the gate's evaluation equals the JAX
``indoor_eval`` on the same annotations, and a short run prints the JAX
gate's JSON keys.  The 2400-step gate itself runs on the card."""
import json
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from cagroup3d_tpu.datasets.indoor_eval import indoor_eval as jax_indoor_eval
from cagroup3d_tpu_torch.tools import overfit_check as gate

from test_detector import synthetic_batch, tiny_cfg

REPO = Path(__file__).resolve().parent.parent
# the JAX gate's output keys (tools/overfit_check.py), without and with --ab
KEYS = ["map25", "map50", "steps", "overflow", "yaw", "ok"]
AB_KEYS = ["ab_loose_map25", "ab_loose_map50", "ab_loose_overflow",
           "ab_delta", "ab_budget", "ab_ok"]
# what the JAX gate's records add to its line
RECORD_ONLY = {"commit", "command", "hardware", "date", "train_seconds",
               "note"}


def _plain(d):
    if isinstance(d, dict):
        return {k: _plain(v) for k, v in d.items()}
    if isinstance(d, (list, tuple)):
        return [_plain(v) for v in d]
    return d


@pytest.mark.parametrize("with_yaw", [False, True])
def test_tiny_cfg_equal(with_yaw):
    assert _plain(gate.tiny_cfg(4, with_yaw)) == \
        _plain(tiny_cfg(4, with_yaw))
    cfg = gate.gate_model_cfg(with_yaw)
    assert (cfg.DENSE_HEAD.FINE_CAP, cfg.DENSE_HEAD.EXPAND_CAP) == (1024, 512)


@pytest.mark.parametrize("yaw", [False, True])
def test_overfit_scenes_equal(yaw):
    """Key by key, and the generator left in the same state (the gate draws
    its scene indices from it next)."""
    r_port, r_jax = np.random.RandomState(5), np.random.RandomState(5)
    got = gate.overfit_scenes(r_port, B=10, P=1200, G=8, n_classes=4,
                              yaw=yaw)
    ref = synthetic_batch(r_jax, B=10, P=1200, G=8, n_classes=4, yaw=yaw)
    assert got.keys() == ref.keys()
    for k in ref:
        assert isinstance(got[k], np.ndarray)
        r = np.asarray(ref[k])
        assert got[k].dtype == r.dtype, k
        np.testing.assert_array_equal(got[k], r, err_msg=k)
    assert r_port.randint(1 << 30) == r_jax.randint(1 << 30)


def test_scene_draws_and_optimizer(monkeypatch, tmp_path):
    """100 steps of the gate with the step recorded instead of taken: each
    batch is the two scenes the JAX gate's ``rng.choice`` draws, at
    cur_epoch 5, from a generator seeded 1, with AdamW (weight decay 1e-4)
    after a clip of 10 at a constant lr."""
    seen = {"batches": []}

    def record_step(model, optimizer, generator, device):
        seen.update(opt=optimizer, gen=generator.get_state())

        def step(batch, cur_epoch):
            seen["batches"].append((batch, cur_epoch))
            return torch.tensor(1.0), {}
        return step

    monkeypatch.setattr(gate, "make_train_step", record_step)
    monkeypatch.setattr(gate, "evaluate", lambda *a: (0.0, 0.0, 0))
    assert gate.main(["--steps", "100", "--device", "cpu", "--out_dir",
                      str(tmp_path)]) == 1

    rng = np.random.RandomState(0)
    data = synthetic_batch(rng, B=10, P=1200, G=8, n_classes=4, yaw=False)
    assert len(seen["batches"]) == 100
    for batch, cur_epoch in seen["batches"]:
        ids = rng.choice(10, 2, replace=False)
        assert cur_epoch == 5
        assert batch.keys() == data.keys()
        for k, v in data.items():
            np.testing.assert_array_equal(batch[k].numpy(),
                                          np.asarray(v)[ids], err_msg=k)
    opt = seen["opt"]
    assert [opt.schedule(t) for t in (0, 1, 1000, 2399)] == \
        [float(np.float32(1.5e-3))] * 4
    assert opt.clip == 10.0
    assert isinstance(opt.opt, torch.optim.AdamW)
    assert opt.opt.defaults["weight_decay"] == 1e-4
    assert torch.equal(seen["gen"], torch.Generator().manual_seed(1)
                       .get_state())


class GTModel:
    """Returns each scene's GT boxes as its predictions (score 1), moved
    ``shift`` m along x."""

    def __init__(self, data, shift):
        self.data, self.shift = data, shift

    def forward_eval(self, batch, cur_epoch=None):
        assert cur_epoch == 100
        i = next(i for i in range(len(self.data["points"])) if np.array_equal(
            self.data["points"][i], batch["points"][0].numpy()))
        R = 32
        gt, valid = self.data["gt_boxes"][i], self.data["gt_valid"][i]
        boxes = np.zeros((1, R, 7), np.float32)
        boxes[0, :len(gt)] = gt[:, :7]
        boxes[0, :, 0] += self.shift
        labels = np.zeros((1, R), np.int64)
        labels[0, :len(gt)] = gt[:, 7]
        pvalid = np.zeros((1, R), bool)
        pvalid[0, :len(gt)] = valid
        return dict(pred_boxes=torch.from_numpy(boxes),
                    pred_scores=torch.ones(1, R),
                    pred_labels=torch.from_numpy(labels),
                    pred_valid=torch.from_numpy(pvalid),
                    overflow=torch.tensor([3]))


@pytest.mark.parametrize("yaw", [False, True])
def test_evaluate_oracle_equals_jax(yaw, capsys):
    """GT as predictions scores 1.0, moved 1 m 0.0, as the JAX
    ``indoor_eval`` scores the same annotations."""
    data = gate.overfit_scenes(np.random.RandomState(0), B=10, yaw=yaw)
    for shift, want in ((0.0, 1.0), (1.0, 0.0)):
        m25, m50, ovf = gate.evaluate(GTModel(data, shift), data, "cpu")
        assert (m25, m50, ovf) == (want, want, 30)
        gt_annos, dt_annos = [], []
        for i in range(10):
            gb = data["gt_boxes"][i][data["gt_valid"][i]]
            moved = gb[:, :7].copy()
            moved[:, 0] += shift
            dt_annos.append(dict(boxes_3d=moved, scores_3d=np.ones(len(gb)),
                                 labels_3d=gb[:, 7].astype(np.int64)))
            gt_annos.append(dict(gt_num=len(gb),
                                 gt_boxes_upright_depth=gb[:, :7],
                                 **{"class": gb[:, 7].astype(np.int64)}))
        ret = jax_indoor_eval(gt_annos, dt_annos, [0.25, 0.5],
                              {i: f"c{i}" for i in range(4)})
        assert (ret["mAP_0.25"], ret["mAP_0.50"]) == (m25, m50)


@pytest.mark.parametrize("ab,yaw", [(True, False), (False, True)],
                         ids=["ab", "yaw"])
def test_short_run_prints_the_jax_keys(ab, yaw, capsys, tmp_path):
    """A 3-step, 2-scene run on the CPU prints one JSON line with the JAX
    gate's keys (and the ``ab_*`` keys with ``--ab``), saves the trained
    weights, and fails the bar (exit 1)."""
    argv = ["--steps", "3", "--scenes", "2", "--device", "cpu", "--out_dir",
            str(tmp_path)] + ["--ab"] * ab + ["--yaw"] * yaw
    assert gate.main(argv) == 1
    lines = []
    for ln in capsys.readouterr().out.splitlines():
        try:
            lines.append(json.loads(ln))
        except ValueError:
            continue
    assert len(lines) == 1
    res = lines[0]
    assert list(res) == KEYS + AB_KEYS * ab
    with open(REPO / f"OVERFIT{'_YAW' * yaw}_r05.json") as f:
        assert set(json.load(f)) - RECORD_ONLY <= set(KEYS + AB_KEYS)
    assert res["steps"] == 3 and res["yaw"] == yaw and res["ok"] is False
    assert 0.0 <= res["map25"] <= 1.0 and res["overflow"] > 0
    if ab:
        assert res["ab_budget"] == 0.05
        assert res["ab_loose_overflow"] < res["overflow"]
    with open(tmp_path / "checkpoint.pkl", "rb") as f:
        ck = pickle.load(f)
    assert ck["it"] == 3
    model = gate.build_network(gate.gate_model_cfg(yaw), 4, device="cpu")
    model.load_jax_params(ck["params"], ck["state"])


def test_missing_card_raises(monkeypatch):
    assert gate.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gate.main([])
