"""The port's fit and replay tools against ``fav_tpu``'s, on the CPU.

* ``fav_tpu_torch/tools/fit_maha.py`` against the recipe of the
  repository's ``tools/fit_maha.py`` (``fav_tpu``'s ``fit_feature_gaussians``
  on the first 90% of the features, the RMD quantiles of the held-out 10%
  by its ``mahalanobis_scores``), fed the same features. Tolerances: the
  fit's arrays within 1e-10 (the same float64 numpy, cast to float32 the
  same way); the quantiles within 1e-4 relative of the largest score
  (float32 quadratic forms summed in another order, as
  ``tests/test_torch_conformal_maha.py`` bounds the scores). The command
  line on a tiny weight copy: the JAX tool's JSON keys, the default path
  beside the weights, a file ``fav_tpu``'s ``load_fit`` reads, and a
  service that then serves the column.
* ``fav_tpu_torch/tools/replay.py`` against ``fav_tpu/tools/replay.py`` on
  a CSV written by the port's ``SessionLogger``: the same JSON, exactly
  (both replay the same float64 recurrence on the same parsed values),
  exit 0 within the tolerance; a tampered row flagged at the same row by
  both, exit 1.
"""

from __future__ import annotations

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from fav_tpu.models import mahalanobis as jmaha  # noqa: E402
from fav_tpu.tools import replay as jreplay  # noqa: E402
from fav_tpu_torch.config import ModelParams, TrustParams  # noqa: E402
from fav_tpu_torch.core.session_log import SessionLogger  # noqa: E402
from fav_tpu_torch.core.trust import TrustEngine  # noqa: E402
from fav_tpu_torch.data.cifar import synthetic_cifar10  # noqa: E402
from fav_tpu_torch.models.cnn import create_model  # noqa: E402
from fav_tpu_torch.models.mahalanobis import load_fit  # noqa: E402
from fav_tpu_torch.serving.inference import MAHA_FIT_SUFFIX, InferenceService  # noqa: E402
from fav_tpu_torch.tools import fit_maha, replay  # noqa: E402
from fav_tpu_torch.utils.checkpoint import random_flax_params, save_flax_npz  # noqa: E402

TINY = ModelParams(widths=(8, 16), dense_width=16)
FIT_TOL = 1e-10
QUANTILE_RTOL = 1e-4
JAX_TOOL_KEYS = {"checkpoint", "fit_images", "feature_dim", "rmd_q50", "rmd_q99", "out", "data_source"}


@pytest.fixture(scope="module")
def small_dataset():
    return synthetic_cifar10(train_size=200, test_size=10)


@pytest.fixture
def tiny_stem(tmp_path):
    stem = str(tmp_path / "tiny")
    save_flax_npz(stem + ".npz", random_flax_params(create_model(TINY), 11))
    with open(stem + ".metadata.json", "w") as f:
        json.dump({"temperature": 1.0, "widths": list(TINY.widths), "dense_width": TINY.dense_width}, f)
    return stem


@pytest.mark.parametrize("n", [200, 9], ids=["held-out", "in-sample"])
def test_fit_on_the_same_features_equals_fav_tpus_recipe(n, tiny_stem, small_dataset, monkeypatch, tmp_path):
    """The JAX tool's recipe on the features the port's tool collects: 90%
    for the Gaussians and 10% for the quantiles, or every image for both
    below ten images."""
    rng = np.random.default_rng(12)
    means = rng.normal(0.0, 2.0, (10, 16))
    labels = small_dataset.train_labels[:n]
    feats = (means[labels] + rng.normal(0.0, 1.0, (n, 16))).astype(np.float32)
    monkeypatch.setattr(fit_maha, "collect_features", lambda model, images: feats[: len(images)])
    out = str(tmp_path / "fit.npz")
    report = fit_maha.fit_checkpoint(tiny_stem, n, out, device="cpu", dataset=small_dataset)
    n_fit = int(n * 0.9) if n >= 10 else n
    want = jmaha.fit_feature_gaussians(feats[:n_fit], labels[:n_fit], 10)
    rmd = np.asarray(jmaha.mahalanobis_scores(jnp.asarray(feats[n_fit:] if n_fit < n else feats), want)["rmd"],
                     np.float64)
    got = load_fit(out)
    for name in ("class_means", "prec", "bg_mean", "bg_prec"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), atol=FIT_TOL,
                                   rtol=0, err_msg=name)
    scale = np.abs(rmd).max()
    for q, key in ((0.50, "rmd_q50"), (0.99, "rmd_q99")):
        assert abs(getattr(got, key) - np.quantile(rmd, q)) <= QUANTILE_RTOL * scale, key
        assert report[key + "_exact"] == getattr(got, key)
    assert report["fit_images"] == n and report["feature_dim"] == 16


def test_fit_cli_writes_beside_the_weights_and_the_server_serves_it(tiny_stem, small_dataset, monkeypatch,
                                                                    capsys):
    monkeypatch.setattr(fit_maha, "load_cifar10", lambda: small_dataset)
    fit_maha.main(["--checkpoint", tiny_stem, "--fit-images", "100", "--device", "cpu"])
    report = json.loads(capsys.readouterr().out)
    assert set(report) == JAX_TOOL_KEYS
    assert report["out"] == tiny_stem + MAHA_FIT_SUFFIX and report["fit_images"] == 100
    assert report["feature_dim"] == TINY.dense_width and report["data_source"] == "synthetic"
    ref = jmaha.load_fit(report["out"])  # fav_tpu reads the port's file
    assert ref.class_means.shape == (10, TINY.dense_width) and ref.rmd_q99 > ref.rmd_q50
    assert round(ref.rmd_q50, 3) == report["rmd_q50"]
    svc = InferenceService(TINY, checkpoint_dir=tiny_stem, device="cpu")
    rows, _ = svc.score_batch(small_dataset.test_images[:2])
    assert svc.has_feature_distance and rows.shape == (2, 7)


def test_fit_tool_refuses_missing_weights_and_runs_on_the_card_by_default(tiny_stem, tmp_path):
    with pytest.raises(SystemExit):
        fit_maha.main(["--checkpoint", str(tmp_path / "none"), "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fit_maha.fit_checkpoint(tiny_stem)


def session_csv(seed: int, ticks: int = 150) -> str:
    """A session CSV as the server logs it: the port's engine and logger
    over scripted statuses and anomalies, the timestamps from a clock that
    advances by each tick's jittered dt."""
    rng = np.random.default_rng(seed)
    statuses = ["VISION_OK"] * 40 + ["VISION_CORRUPTED"] * 20 + ["VISION_FROZEN"] * 30 + ["VISION_OK"] * 60
    clock = [1.7e9]
    engine = TrustEngine(TrustParams(), clock=lambda: clock[0])
    log = SessionLogger()
    for i in range(ticks):
        dt = 1.0 / 30.0 + float(rng.normal(0.0, 0.002))
        clock[0] += dt
        anomaly = float(rng.uniform(0.0, 0.3 if i < 100 else 0.9))
        log.log(engine.update(statuses[i % len(statuses)], anomaly, dt), anomaly)
    return log.get_csv()


def _run_both(path: str, capsys) -> tuple[tuple[int, dict], tuple[int, dict]]:
    rc = replay.main([path])
    ours = json.loads(capsys.readouterr().out)
    jrc = jreplay.main([path])
    theirs = json.loads(capsys.readouterr().out)
    return (rc, ours), (jrc, theirs)


@pytest.mark.parametrize("seed", [0, 1])
def test_replay_of_a_port_session_equals_fav_tpus(seed, tmp_path, capsys):
    text = session_csv(seed)
    assert replay.replay_csv(text) == jreplay.replay_csv(text)
    path = str(tmp_path / "session.csv")
    with open(path, "w", newline="") as f:
        f.write(text)
    (rc, ours), (jrc, theirs) = _run_both(path, capsys)
    assert ours == theirs and rc == jrc == 0 and ours["ok"] and ours["first_gross_divergence"] is None
    assert ours["rows"] == 150 and set(ours["max_dev"]) == set(replay.TRACKED)


def test_a_tampered_row_is_flagged_at_the_same_row_by_both(tmp_path, capsys):
    lines = session_csv(2).split("\r\n")
    header = lines[0].split(",")
    row = lines[71].split(",")
    col = header.index("reliability")
    row[col] = f"{float(row[col]) + 0.2:.6f}"  # 70 rows in: a gross edit of the logged reliability
    lines[71] = ",".join(row)
    path = str(tmp_path / "tampered.csv")
    with open(path, "w", newline="") as f:
        f.write("\r\n".join(lines))
    (rc, ours), (jrc, theirs) = _run_both(path, capsys)
    assert ours == theirs and rc == jrc == 1 and not ours["ok"]
    assert ours["first_gross_divergence"]["row"] == 71 and ours["first_gross_divergence"]["field"] == "reliability"


def test_replay_empty_and_foreign_csvs_as_fav_tpu():
    assert replay.replay_csv("") == jreplay.replay_csv("")
    foreign = "a,b\n1,2\n"
    for fn in (replay.replay_csv, jreplay.replay_csv):
        with pytest.raises(ValueError, match="not a session CSV"):
            fn(foreign)
