"""The port's pretrain CLI and the entry points around the trainers, on
the CPU: every mode writes weights ``load_weights`` reads back, with the
JAX package's metadata keys for that mode (``fav_tpu/models/
pretrain.py`` plus ``format``); every ``parser.error`` of :441-483 fires
with its text; ``--shard`` raises naming ROADMAP.md Queue 1 item 10;
DeepAugment needs the autoencoder's weights; ``evaluate`` trains a ViT
for its grid; the AugMix draws carry each option.

Moved from ``tests/test_torch_trainers.py``, which keeps the trainers'
steps held to ``fav_tpu``, their megasteps and the golden, so that
``--dist loadfile`` runs the two halves on two workers. The sizes are
that file's: widths (8, 16).
"""

from __future__ import annotations

import json
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (REPO, os.path.join(REPO, "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from fav_tpu_torch.data.cifar import synthetic_cifar10  # noqa: E402
from fav_tpu_torch.models import evaluate as tev  # noqa: E402
from fav_tpu_torch.models import pretrain  # noqa: E402
from fav_tpu_torch.models.cnn import ConvAutoencoder  # noqa: E402
from fav_tpu_torch.ops import augment as ta  # noqa: E402
from fav_tpu_torch.ops import deepaugment as tda  # noqa: E402
from fav_tpu_torch.utils.checkpoint import load_weights  # noqa: E402


# ── the CLI ──────────────────────────────────────────────────────────────

CLASSIFIER_KEYS = {"accuracy", "temperature", "conformal_alpha", "conformal_qhat", "ece", "ece_uncalibrated",
                   "failure_auroc", "data_source", "train_steps", "ensemble_size", "arch", "widths", "dense_width",
                   "format"}
CALIBRATED_KEYS = CLASSIFIER_KEYS - {"ece_uncalibrated", "ensemble_size"}
CLI_MODES = {
    "ce": ([], CLASSIFIER_KEYS),
    "augmix": (["--augmix"], CLASSIFIER_KEYS | {"augmix", "js_lam"}),
    "sam": (["--augmix", "--sam", "0.05"], CLASSIFIER_KEYS | {"augmix", "js_lam", "sam_rho"}),
    "deepaugment": (["--deepaugment"], CLASSIFIER_KEYS | {"augmix", "js_lam", "deepaugment"}),
    "freqband": (["--freqband"], CLASSIFIER_KEYS | {"augmix", "js_lam", "freqband"}),
    "occlude": (["--occlude", "--megastep", "2"], CLASSIFIER_KEYS | {"augmix", "js_lam", "occlude"}),
    "occlude-bars": (["--occlude-bars"], CLASSIFIER_KEYS | {"augmix", "js_lam", "occlude_bars"}),
    "bf16-aug": (["--augmix", "--bf16-aug"], CLASSIFIER_KEYS | {"augmix", "js_lam", "bf16_aug"}),
    "resnet": (["--arch", "resnet", "--standardize"], CLASSIFIER_KEYS | {"standardize_input"}),
    "vit": (["--arch", "vit"], CLASSIFIER_KEYS | {"vit_dim", "vit_depth", "vit_heads"}),
    "ensemble": (["--ensemble", "3", "--megastep", "2"], CLASSIFIER_KEYS),
    "ensemble-augmix": (["--ensemble", "3", "--augmix"], CLASSIFIER_KEYS | {"augmix", "js_lam"}),
    "ensemble-augmix-ce": (["--ensemble", "3", "--augmix-ce"], CLASSIFIER_KEYS | {"augmix_ce"}),
    "autoencoder": (["--autoencoder"], {"err_baseline", "err_p95", "final_train_loss", "data_source", "train_steps",
                                        "model", "ae_widths", "ae_latent", "format"}),
    "distill-mc": (["--distill-mc", "3"], CALIBRATED_KEYS | {"distilled_from", "distill_mc_samples"}),
    "distill-ensemble": (["--distill-ensemble", "--augmix", "--occlude", "--megastep", "2"],
                         CALIBRATED_KEYS | {"distilled_from", "teacher_ensemble_size", "kd_temperature",
                                            "augmix_distill", "occlude", "ensemble_size"}),
}


@pytest.fixture(scope="module")
def cli_data():
    return synthetic_cifar10(train_size=32, test_size=16)


@pytest.fixture(scope="module")
def teachers(cli_data, tmp_path_factory):
    """A small classifier and a 3-member ensemble written by the CLI, the
    distillation modes' teachers."""
    d = tmp_path_factory.mktemp("teachers")
    base = ["--steps", "2", "--batch", "8", "--widths", "8,16", "--device", "cpu", "--log-every", "0"]
    pretrain.main(base + ["--out", str(d / "clf")], dataset=cli_data)
    pretrain.main(base + ["--ensemble", "3", "--out", str(d / "ens")], dataset=cli_data)
    return d


@pytest.mark.parametrize("mode", list(CLI_MODES))
def test_pretrain_cli_mode_writes_weights_load_weights_reads(mode, cli_data, teachers, tmp_path):
    flags, keys = CLI_MODES[mode]
    widths = [] if mode == "distill-ensemble" else ["--widths", "8,16"]  # default: half the teacher's
    teacher = {"distill-mc": ["--teacher", str(teachers / "clf")],
               "distill-ensemble": ["--teacher", str(teachers / "ens")]}.get(mode, [])
    out = tmp_path / "w"
    meta = pretrain.main(["--steps", "2", "--batch", "8", "--device", "cpu", "--log-every", "1", "--out", str(out),
                          *widths, *teacher, *flags], dataset=cli_data)
    assert set(meta) == keys
    assert json.loads((tmp_path / "w.metadata.json").read_text()) == meta
    model, stored = load_weights("w", device="cpu", directory=tmp_path)
    assert stored == meta and meta["train_steps"] == 2
    if mode == "autoencoder":
        assert isinstance(model, ConvAutoencoder) and model.widths == (8, 16) and meta["err_baseline"] > 0
        return
    members = model if isinstance(model, list) else [model]
    assert len(members) == (3 if mode.startswith("ensemble") else 1)
    logits = torch.stack([m(torch.from_numpy(cli_data.test_images)) for m in members])
    assert logits.shape[1:] == (16, 10) and bool(torch.isfinite(logits).all())
    if mode == "distill-ensemble":
        assert meta["widths"] == [4, 8] and meta["teacher_ensemble_size"] == 3
    assert 0.0 <= meta["accuracy"] <= 1.0 and meta["temperature"] > 0


PARSER_ERRORS = {
    "deepaugment-ensemble": (["--deepaugment", "--ensemble", "2"], "--deepaugment is single-model only"),
    "freqband-ensemble": (["--freqband", "--ensemble", "2"], "--freqband is single-model or KD only"),
    "occlude-ensemble": (["--occlude", "--ensemble", "2"], "--occlude is single-model or KD only"),
    "bars-ensemble": (["--occlude-bars", "--ensemble", "2"], "--occlude-bars is single-model only"),
    "bars-kd": (["--occlude-bars", "--distill-ensemble"], "--occlude-bars is single-model only"),
    "bf16-ensemble": (["--augmix", "--bf16-aug", "--ensemble", "2"], "--bf16-aug covers the plain AugMix"),
    "bf16-distill-mc": (["--augmix", "--bf16-aug", "--distill-mc", "2"], "--bf16-aug covers the plain AugMix"),
    "bf16-autoencoder": (["--augmix", "--bf16-aug", "--autoencoder"], "--bf16-aug covers the plain AugMix"),
    "bf16-sam": (["--augmix", "--bf16-aug", "--sam", "0.05"], "--bf16-aug covers the plain AugMix"),
    "bf16-deepaugment": (["--bf16-aug", "--deepaugment"], "--bf16-aug covers the plain AugMix"),
    "bf16-alone": (["--bf16-aug"], "--bf16-aug needs the AugMix chain"),
    "augmix-ce-alone": (["--augmix-ce"], "--augmix-ce requires --ensemble"),
    "megastep-distill-mc": (["--megastep", "2", "--distill-mc", "2"], "--megastep does not cover"),
    "megastep-autoencoder": (["--megastep", "2", "--autoencoder"], "--megastep does not cover"),
}


@pytest.mark.parametrize("case", list(PARSER_ERRORS))
def test_pretrain_parser_errors_fire(case, capsys):
    argv, text = PARSER_ERRORS[case]
    with pytest.raises(SystemExit) as exc:
        pretrain.main([*argv, "--device", "cpu"], dataset=object())
    assert exc.value.code == 2 and text in capsys.readouterr().err


def test_pretrain_shard_raises_naming_queue_item_10():
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 10"):
        pretrain.main(["--ensemble", "2", "--shard", "--device", "cpu"], dataset=object())


def test_deepaugment_needs_the_autoencoder_weights(tmp_path):
    with pytest.raises(FileNotFoundError, match="autoencoder"):
        tda.load_augmenter(tmp_path, device="cpu")
    ae = tda.load_augmenter(device="cpu")  # the committed copy: 32/64/128, latent 128
    assert isinstance(ae, ConvAutoencoder) and ae.widths == (32, 64, 128)


def test_evaluate_trains_a_vit_for_its_grid(monkeypatch):
    monkeypatch.setenv(tev.DEVICE_ENV, "cpu")
    ds = synthetic_cifar10(train_size=256, test_size=16)
    result = tev.main(["--arch", "vit", "--checkpoint", "no_such_weights", "--train-steps", "2", "--num-images", "16",
                       "--corruptions", "contrast"], dataset=ds)
    assert result["summary"]["model"] == "trained:2steps"


def test_augmix_draws_carry_each_option():
    d = ta.augmix_draws(torch.Generator().manual_seed(0), 4, freq=True, occlude=True, bars=True)
    n = 12
    assert d.freq_gains.shape == (n, 4) and d.occ_ctr.shape == (n, 2, 2) and d.bar_angle.shape == (n, 3)
    assert float(d.freq_gains.min()) >= 0.25 - 1e-6 and float(d.freq_gains.max()) <= 4.0 + 1e-6
    assert float(d.occ_half.max()) <= 0.3 and float(d.bar_wid.max()) <= 0.08 and float(d.bar_len.max()) <= 0.45
    assert ta.num_ops(True, True, True) == 11
