"""The server's Mahalanobis ``feature_distance`` column against ``fav_tpu``,
on the CPU.

The port's ``InferenceService`` (``fav_tpu_torch/serving/inference.py``)
serves the distance in ``msp`` mode when a fit lies beside the weights
(``<stem>.maha_fit.npz``). ``fav_tpu``'s service is not run here (its own
tests mark it slow); its column math is, at the function level:
``features_and_logits`` -> ``mahalanobis_scores`` -> ``normalized_rmd`` on
the same weights and frames, with a fit that ``fav_tpu`` wrote.

* A tiny vgg stem under ``tmp_path`` (widths (8, 16), dense 16, parameters
  from a numpy seed) and 16 frames. Tolerance class: the bf16 forward. The
  features are bf16 activations, each within ``FEATURE_TOL`` (0.125) of
  flax's (``tests/test_torch_conformal_maha.py``); a normalized distance
  moves by the quadratic form's change over ``q99 - q50``. Both forwards
  are eager; flax's runs the 64 fit images and the 16 frames as one batch
  of 80, whose sums XLA blocks otherwise, and a few bf16 roundings land
  apart: the distances differ by up to 0.019 on these frames, within
  ``FDIST_ATOL`` (0.05).
* The layout: the distance is column 6 under ``msp``, 7 under a monitor
  (the ``gated`` preset), and the other columns are those of the service
  without a fit, exactly. A stale fit (another feature size) is warned
  about and left out; no fit, no field.
* The committed goldens: ``weights/student_nano.maha_golden.npz`` (written
  by ``fav_tpu``'s ``tools/fit_maha.py`` on the synthetic set, 10240
  images), ``weights/student_std.maha_golden.npz`` (the same recipe through
  ``fav_tpu``'s functions on ``student_std``'s standardizing forward: the
  JAX tool rebuilds its model without ``standardize_input``), and
  ``weights/maha.golden.json``: the fits' quantiles and ``fav_tpu``'s
  served ``feature_distance`` of both deployments (``msp`` on
  ``student_nano``, ``gated``: ``student_std`` gated by ``student_nano``)
  on ``scripted_serve.serve_golden_inputs``. The port, given the same fits
  beside copies of its weights, holds them within ``GOLDEN_FDIST_ATOL``;
  ``chip_smoke.py`` holds the card to the same golden. No name under
  ``weights/`` that a stem reads ends in ``.maha_fit.npz``: the shipped
  server streams no distance, as ``fav_tpu``'s does not.

Run as a script with ``--write`` to regenerate the goldens:

    JAX_PLATFORMS=cpu python tests/test_torch_maha_serving.py --write
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from fav_tpu.models import mahalanobis as jmaha  # noqa: E402

WEIGHTS = os.path.join(REPO, "fav_tpu_torch", "weights")
JAX_CKPT = os.path.join(REPO, "fav_tpu", "checkpoints")
GOLDEN = os.path.join(WEIGHTS, "maha.golden.json")
FIT_IMAGES = 10240
# deployment: (predictor, monitor, the distance's column)
DEPLOYMENTS = {"msp": ("student_nano", None, 6), "gated": ("student_std", "student_nano", 7)}


def golden_fit_path(name: str) -> str:
    return os.path.join(WEIGHTS, f"{name}.maha_golden.npz")


def _write_fits() -> dict:
    """The golden fits, written by ``fav_tpu``: ``student_nano``'s by its
    ``tools/fit_maha.py``, ``student_std``'s by the same recipe through its
    functions on the standardizing forward. Returns each fit's report."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import fit_maha

    from fav_tpu.config import ModelParams, model_params_from_metadata
    from fav_tpu.data.cifar import load_cifar10
    from fav_tpu.models.cnn import create_model
    from fav_tpu.utils.checkpoint import restore_checkpoint

    reports = {}
    fit_maha.main(["--checkpoint", os.path.join(JAX_CKPT, "student_nano"), "--fit-images", str(FIT_IMAGES),
                   "--out", golden_fit_path("student_nano")])
    ds = load_cifar10()
    ckpt = os.path.join(JAX_CKPT, "student_std")
    with open(os.path.join(ckpt, "metadata.json")) as f:
        meta = json.load(f)
    mp = model_params_from_metadata(ModelParams(), meta)
    model = create_model(mp)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32))
    variables, _ = restore_checkpoint(ckpt, variables)
    feats = jmaha.collect_features(model, variables, jnp.asarray(ds.train_images[:FIT_IMAGES]))
    n_fit = int(FIT_IMAGES * 0.9)
    fit = jmaha.fit_feature_gaussians(feats[:n_fit], ds.train_labels[:n_fit], mp.num_classes)
    rmd = np.asarray(jmaha.mahalanobis_scores(jnp.asarray(feats[n_fit:]), fit)["rmd"], np.float64)
    fit = dataclasses.replace(fit, rmd_q50=float(np.quantile(rmd, 0.50)), rmd_q99=float(np.quantile(rmd, 0.99)))
    jmaha.save_fit(golden_fit_path("student_std"), fit)
    for name in ("student_nano", "student_std"):
        fit = jmaha.load_fit(golden_fit_path(name))
        reports[name] = {"file": os.path.basename(golden_fit_path(name)), "fit_images": FIT_IMAGES,
                         "feature_dim": int(fit.class_means.shape[1]), "rmd_q50": fit.rmd_q50,
                         "rmd_q99": fit.rmd_q99, "data_source": ds.source,
                         "writer": "tools/fit_maha.py" if name == "student_nano"
                         else "tools/fit_maha.py's recipe on the standardizing forward"}
    return reports


def jax_served_distances(name: str, inputs: np.ndarray) -> np.ndarray:
    """``fav_tpu``'s ``InferenceService`` rows of a deployment with the golden
    fit beside a copy of its predictor's checkpoint: the distance column."""
    from fav_tpu.serving.inference import InferenceService

    pred, mon, col = DEPLOYMENTS[name]
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, pred)
        shutil.copytree(os.path.join(JAX_CKPT, pred), ckpt)
        shutil.copy(golden_fit_path(pred), os.path.join(ckpt, jmaha.FIT_FILENAME))
        svc = InferenceService(checkpoint_dir=ckpt, monitor_dir=os.path.join(JAX_CKPT, mon) if mon else None)
        svc._ensure_model()
        assert svc.has_feature_distance and svc._col_rmd == col
        rows = np.asarray(svc._dispatch(list(inputs)), np.float32)[: len(inputs)]
    return rows[:, col]


def write() -> None:
    from fav_tpu_torch.serving.app import _frame_for_model
    from fav_tpu_torch.tools.scripted_serve import serve_golden_inputs

    fits = _write_fits()
    inputs = serve_golden_inputs(_frame_for_model)
    golden = {
        "about": "fav_tpu's Mahalanobis fits of student_nano and student_std (beside them as "
                 "<stem>.maha_golden.npz) and its InferenceService's feature_distance on "
                 "serve_golden_inputs() with each fit beside its predictor; written by "
                 "tests/test_torch_maha_serving.py --write",
        "inputs": "fav_tpu_torch.tools.scripted_serve.serve_golden_inputs(app._frame_for_model)",
        "fits": fits,
        "deployments": {name: {"predictor": pred, "monitor": mon, "column": col,
                               "feature_distance": jax_served_distances(name, inputs).tolist()}
                        for name, (pred, mon, col) in DEPLOYMENTS.items()},
    }
    with open(GOLDEN, "w") as f:
        json.dump(golden, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    if "--write" not in sys.argv[1:]:
        sys.exit("usage: python tests/test_torch_maha_serving.py --write")
    jax.config.update("jax_platforms", "cpu")
    write()
    sys.exit(0)

import asyncio  # noqa: E402

import pytest  # noqa: E402

from fav_tpu.models.cnn import FailureAwareCNN as JaxCNN  # noqa: E402
from fav_tpu_torch.config import ModelParams  # noqa: E402
from fav_tpu_torch.models.cnn import create_model  # noqa: E402
from fav_tpu_torch.serving.inference import MAHA_FIT_SUFFIX, InferenceService  # noqa: E402
from fav_tpu_torch.utils.checkpoint import random_flax_params, save_flax_npz  # noqa: E402
from test_torch_models import _nest  # noqa: E402

TINY = ModelParams(widths=(8, 16), dense_width=16)
FDIST_ATOL = 0.05
# the goldens: fav_tpu's jitted service (XLA fuses a conv with its bias
# and skips a bf16 rounding) against the port's eager rounding, at the
# nano widths: 0.016 (msp) and 0.020 (gated) on the CPU; the bound leaves
# about five times that for cuDNN's bf16 on the card
GOLDEN_FDIST_ATOL = 0.1
B = 16


def _tiny_stem(root, name: str, seed: int) -> tuple[str, dict]:
    """A tiny vgg weight copy ``<root>/<name>`` from a numpy seed; returns
    the stem and fav_tpu's variables of the same parameters."""
    flat = random_flax_params(create_model(TINY), seed)
    stem = os.path.join(str(root), name)
    save_flax_npz(stem + ".npz", flat)
    with open(stem + ".metadata.json", "w") as f:
        json.dump({"temperature": 1.1, "widths": list(TINY.widths), "dense_width": TINY.dense_width, "arch": "vgg"},
                  f)
    return stem, {"params": _nest(flat)}


def _jax_fit(feats: np.ndarray, seed: int):
    """A fit that fav_tpu writes: Gaussians on ``feats`` with random labels
    from ``seed``, the quantiles from the same features."""
    fit = jmaha.fit_feature_gaussians(feats, np.random.default_rng(seed).integers(0, 10, len(feats)), 10)
    rmd = np.asarray(jmaha.mahalanobis_scores(jnp.asarray(feats, jnp.float32), fit)["rmd"], np.float64)
    return dataclasses.replace(fit, rmd_q50=float(np.quantile(rmd, 0.5)), rmd_q99=float(np.quantile(rmd, 0.99)))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(predictor stem with a fit written by fav_tpu, monitor stem without
    one, fav_tpu's distances of the frames, the frames, the 64 features the
    fit was made from). One eager flax forward (the bf16 class's reference:
    under ``jit`` XLA skips a bf16 rounding, which moves these distances by
    up to 0.13) gives the fit's features (64 random images) and the
    frames' (the last 16)."""
    root = tmp_path_factory.mktemp("maha_stems")
    stem, variables = _tiny_stem(root, "tiny", 5)
    mon, _ = _tiny_stem(root, "tiny_monitor", 6)
    jmodel = JaxCNN(widths=TINY.widths, dense_width=TINY.dense_width)
    images = np.random.default_rng(8).random((64 + B, 32, 32, 3), dtype=np.float32)
    feats = jmaha.features_and_logits(jmodel, variables, jnp.asarray(images))[0]
    fit_feats = np.asarray(feats[:64], np.float64)
    fit = _jax_fit(fit_feats, 7)
    jmaha.save_fit(stem + MAHA_FIT_SUFFIX, fit)
    want = np.asarray(jmaha.normalized_rmd(jmaha.mahalanobis_scores(feats[64:], fit)["rmd"], fit), np.float32)
    return stem, mon, want, images[64:], fit_feats


def _service(stem: str, monitor: str | None = None, **kw) -> InferenceService:
    return InferenceService(TINY, checkpoint_dir=stem, monitor_dir=monitor, device="cpu", **kw)


def _stem_without_fit(stem: str, root) -> str:
    bare = os.path.join(str(root), "bare")
    for ext in (".npz", ".metadata.json"):
        shutil.copy(stem + ext, bare + ext)
    return bare


def test_served_feature_distance_matches_fav_tpu(tiny, tmp_path):
    stem, _, want, frames, _ = tiny
    svc = _service(stem)
    rows, _ = svc.score_batch(frames)
    assert svc.has_feature_distance and svc.info()["feature_distance"] is True
    assert rows.shape == (B, 7) and svc._col_rmd == 6
    assert np.all(rows[:, 6] >= 0.0) and np.abs(rows[:, 6] - want).max() <= FDIST_ATOL
    bare_rows, _ = _service(_stem_without_fit(stem, tmp_path)).score_batch(frames)
    np.testing.assert_array_equal(rows[:, :6], bare_rows)


def test_gated_layout_puts_the_distance_at_column_7(tiny):
    stem, mon, _, frames, _ = tiny
    msp, _ = _service(stem).score_batch(frames)
    svc = _service(stem, mon)
    rows, probs = svc.score_batch(frames)
    assert rows.shape == (B, 8) and (svc._col_self_conf, svc._col_rmd) == (6, 7)
    np.testing.assert_array_equal(rows[:, 7], msp[:, 6])
    np.testing.assert_array_equal(rows[:, 6], probs.max(-1))


def test_stale_fit_is_warned_about_and_left_out(tiny, tmp_path, capsys):
    stem, _, _, frames, fit_feats = tiny
    stale = _stem_without_fit(stem, tmp_path)
    jmaha.save_fit(stale + MAHA_FIT_SUFFIX, _jax_fit(fit_feats[:, :8], 9))
    svc = _service(stale)
    rows, _ = svc.score_batch(frames)
    assert "stale fit" in capsys.readouterr().err
    assert rows.shape == (B, 6) and not svc.has_feature_distance and "feature_distance" not in svc.info()


def _served(svc, frames) -> list[dict]:
    async def run():
        try:
            return await asyncio.gather(*[svc.score_frame(f) for f in frames])
        finally:
            await svc.close()

    return asyncio.run(run())


def test_the_wire_field_is_there_with_a_fit_and_absent_without(tiny, tmp_path):
    stem, _, _, frames, _ = tiny
    svc = _service(stem, max_wait_ms=50.0)
    rows, _ = svc.score_batch(frames[:4])
    for row, d in zip(rows, _served(svc, frames[:4])):
        assert d["feature_distance"] == round(float(row[6]), 4)
    bare = _served(_service(_stem_without_fit(stem, tmp_path)), frames[:2])
    assert all("feature_distance" not in d for d in bare)


def test_random_weights_serve_no_distance(tiny, tmp_path):
    """A fit beside weights that do not load is never applied: the service
    serves random weights marked degraded, without the column."""
    stem, _, _, frames, _ = tiny
    broken = os.path.join(str(tmp_path), "broken")
    shutil.copy(stem + ".metadata.json", broken + ".metadata.json")
    shutil.copy(stem + MAHA_FIT_SUFFIX, broken + MAHA_FIT_SUFFIX)
    np.savez(broken + ".npz", **{"Conv_0/kernel": np.zeros((3, 3, 3, 8), np.float32)})
    svc = _service(broken)
    rows, _ = svc.score_batch(frames[:2])
    assert svc.degraded and not svc.has_feature_distance and rows.shape == (2, 6)


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


def test_golden_fits_load_in_both_packages_and_no_stem_reads_them(golden):
    from fav_tpu_torch.models.mahalanobis import load_fit

    for name, report in golden["fits"].items():
        path = golden_fit_path(name)
        port, ref = load_fit(path), jmaha.load_fit(path)
        np.testing.assert_array_equal(port.prec.numpy(), np.asarray(ref.prec))
        assert (port.rmd_q50, port.rmd_q99) == (report["rmd_q50"], report["rmd_q99"]) == (ref.rmd_q50, ref.rmd_q99)
        assert port.class_means.shape == (10, report["feature_dim"])
    assert not [f for f in os.listdir(WEIGHTS) if f.endswith(MAHA_FIT_SUFFIX)]


@pytest.mark.parametrize("name", list(DEPLOYMENTS))
def test_port_holds_the_maha_golden_on_the_cpu(golden, name, tmp_path):
    from fav_tpu_torch.serving.app import _frame_for_model
    from fav_tpu_torch.tools.scripted_serve import serve_golden_inputs

    pred, mon, col = DEPLOYMENTS[name]
    stems = {}
    for stem in filter(None, (pred, mon)):
        stems[stem] = os.path.join(str(tmp_path), stem)
        for ext in (".npz", ".metadata.json"):
            shutil.copy(os.path.join(WEIGHTS, stem + ext), stems[stem] + ext)
    shutil.copy(golden_fit_path(pred), stems[pred] + MAHA_FIT_SUFFIX)
    svc = InferenceService(checkpoint_dir=stems[pred], monitor_dir=stems.get(mon), device="cpu")
    rows, _ = svc.score_batch(serve_golden_inputs(_frame_for_model))
    want = np.asarray(golden["deployments"][name]["feature_distance"], np.float32)
    assert svc._col_rmd == col == golden["deployments"][name]["column"]
    assert np.abs(rows[:, col] - want).max() <= GOLDEN_FDIST_ATOL
