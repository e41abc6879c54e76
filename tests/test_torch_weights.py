"""The port's committed weights against the JAX package's checkpoints.

``fav_tpu_torch/weights/student_nano.npz``, ``student_std.npz`` and
``classifier.npz`` hold the flax parameters of
``fav_tpu/checkpoints/student_nano``, ``student_std`` (the ``gated``
preset's predictor) and ``classifier`` (the evaluation grid's default
model, widths 64/128/256) as numpy arrays; ``student_compact`` and
``student_occl_acc`` (the compact students, 32/64/128), ``classifier_occl``,
``classifier_freq``, ``classifier_deepaug`` and ``distilled`` (64/128/256)
those of the other shipped classifiers; ``autoencoder.npz``,
``vit.npz`` and ``ensemble.npz`` those of the autoencoder (widths
32/64/128, latent 128), the ViT (dim 128, depth 4, heads 4) and the
five-member vgg ensemble (every leaf stacked on a leading member axis),
because the orbax checkpoints need JAX and orbax to read and the machine
with the card has neither. ``<name>.golden.json`` holds the JAX package's
eager bf16 outputs for a few fixed images (logits; each member's logits
for the ensemble; each image's reconstruction error for the
autoencoder), which ``chip_smoke.py`` holds the port to on the card. ``serve.golden.json`` (written by ``tests/test_torch_inference.py
--write``) holds the JAX ``InferenceService`` rows of both deployments on
fixed frames and the states the JAX app reaches on the scripted streams;
the last tests here pin it.

Run as a script with ``--write`` to regenerate the weights, metadata and
goldens of all twelve copies (``--write NAME ...`` for some of them):

    JAX_PLATFORMS=cpu python tests/test_torch_weights.py --write

As a test, each committed array must equal the orbax checkpoint's exactly,
the metadata copy must equal the checkpoint's, and the golden logits must
equal a fresh JAX forward within float32 rounding, so the copies cannot go
stale.
"""

from __future__ import annotations

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from fav_tpu.config import ModelParams, model_params_from_metadata  # noqa: E402
from fav_tpu.models.cnn import ConvAutoencoder, FailureAwareCNN, create_model  # noqa: E402
from fav_tpu.utils.checkpoint import restore_checkpoint  # noqa: E402

CHECKPOINTS = os.path.join(REPO, "fav_tpu", "checkpoints")
CKPT = os.path.join(CHECKPOINTS, "student_nano")
WEIGHTS = os.path.join(REPO, "fav_tpu_torch", "weights")
NPZ = os.path.join(WEIGHTS, "student_nano.npz")
META = os.path.join(WEIGHTS, "student_nano.metadata.json")
GOLDEN = os.path.join(WEIGHTS, "student_nano.golden.json")
GOLDEN_SEED = 0
GOLDEN_BATCH = 8
STUDENTS = ("student_nano", "student_std")
FAMILIES = ("autoencoder", "vit", "ensemble")
# the other shipped single classifiers: the compact students (vgg 32/64/128)
# and the full-width recipes (64/128/256)
SHIPPED = ("student_compact", "student_occl_acc", "classifier_occl", "classifier_freq", "classifier_deepaug",
           "distilled")
COPIES = STUDENTS + ("classifier",) + SHIPPED


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = np.asarray(v, dtype=np.float32)
    return out


def _nano_model(meta):
    """The flax student a checkpoint's metadata describes (``student_std``
    standardizes its input)."""
    return FailureAwareCNN(widths=tuple(meta["widths"]), dense_width=meta["dense_width"],
                           standardize_input=bool(meta.get("standardize_input", False)))


def restore_nano(name: str = "student_nano"):
    """(flat params without the ``params/`` prefix, metadata) of the student
    ``name`` from orbax."""
    with open(os.path.join(CHECKPOINTS, name, "metadata.json")) as f:
        meta = json.load(f)
    model = _nano_model(meta)
    # shapes only: tracing init is enough for orbax, and compiling it op by op
    # would cost most of this file's time
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32))
    template = jax.tree.map(lambda s: jax.device_put(np.zeros(s.shape, s.dtype)), shapes)
    variables, meta = restore_checkpoint(os.path.join(CHECKPOINTS, name), template)
    return _flat(variables["params"]), meta


def portable_metadata(meta: dict) -> dict:
    """The checkpoint's metadata with absolute paths made relative to the repo."""
    out = dict(meta)
    for k, v in meta.items():
        if isinstance(v, str) and os.path.isabs(v) and "fav_tpu/" in v:
            out[k] = v[v.index("fav_tpu/"):]
    return out


def golden_images() -> np.ndarray:
    return np.random.default_rng(GOLDEN_SEED).random((GOLDEN_BATCH, 32, 32, 3), dtype=np.float32)


def jax_logits(params: dict, meta: dict, images: np.ndarray) -> np.ndarray:
    # eager, op by op: each op rounds to bf16 where the flax module says it
    # does. Under jit XLA fuses a conv with its bias and skips that rounding,
    # which moves bf16 logits by up to ~0.1 on these images.
    logits = _nano_model(meta).apply({"params": _tree(params)}, jnp.asarray(images))
    return np.asarray(logits, dtype=np.float32)


def family_model(meta: dict):
    """The flax module a family checkpoint's metadata describes: the
    autoencoder from ``ae_widths``/``ae_latent``, else the classifier of
    its ``arch`` (an ensemble's members are that classifier)."""
    if meta.get("model") == "ConvAutoencoder":
        return ConvAutoencoder(widths=tuple(meta["ae_widths"]), latent=int(meta["ae_latent"]))
    return create_model(model_params_from_metadata(ModelParams(), meta))


def restore_family(name: str):
    """(flat params, metadata) of ``autoencoder``, ``vit`` or ``ensemble``
    from orbax; the ensemble's leaves keep their leading member axis."""
    with open(os.path.join(CHECKPOINTS, name, "metadata.json")) as f:
        meta = json.load(f)
    model = family_model(meta)
    sample = jnp.zeros((1, 32, 32, 3), jnp.float32)
    if meta.get("ensemble_size"):
        keys = jax.random.split(jax.random.PRNGKey(0), meta["ensemble_size"])
        shapes = jax.eval_shape(jax.vmap(lambda k: model.init(k, sample)), keys)
    else:
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), sample)
    template = jax.tree.map(lambda s: jax.device_put(np.zeros(s.shape, s.dtype)), shapes)
    variables, meta = restore_checkpoint(os.path.join(CHECKPOINTS, name), template)
    return _flat(variables["params"]), meta


def family_golden(params: dict, meta: dict, images: np.ndarray) -> dict:
    """The JAX package's eager outputs on ``images``: ``errors`` (per-image
    reconstruction MSE) for the autoencoder, ``member_logits`` [M, B, C]
    for an ensemble, ``logits`` for a classifier."""
    model = family_model(meta)
    x = jnp.asarray(images)
    if meta.get("model") == "ConvAutoencoder":
        recon = model.apply({"params": _tree(params)}, x)
        return {"errors": [float(v) for v in np.asarray(ConvAutoencoder.reconstruction_error(recon, x), np.float32)]}
    if meta.get("ensemble_size"):
        members = [{k: v[m] for k, v in params.items()} for m in range(meta["ensemble_size"])]
        logits = [np.asarray(model.apply({"params": _tree(p)}, x), np.float32) for p in members]
        return {"member_logits": [[[float(v) for v in row] for row in lg] for lg in logits]}
    logits = np.asarray(model.apply({"params": _tree(params)}, x), np.float32)
    return {"logits": [[float(v) for v in row] for row in logits]}


def _tree(params: dict) -> dict:
    tree: dict = {}
    for path, v in params.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def write_family(name: str) -> None:
    params, meta = restore_family(name)
    npz, meta_path, golden = (os.path.join(WEIGHTS, name + ext)
                              for ext in (".npz", ".metadata.json", ".golden.json"))
    np.savez(npz, **params)
    with open(meta_path, "w") as f:
        json.dump(portable_metadata(meta), f, indent=2)
        f.write("\n")
    with open(golden, "w") as f:
        json.dump({"seed": GOLDEN_SEED, "shape": [GOLDEN_BATCH, 32, 32, 3],
                   "images": "numpy.random.default_rng(seed).random(shape, dtype=float32)",
                   "compute_dtype": "bfloat16", **family_golden(params, meta, golden_images())}, f, indent=1)
        f.write("\n")
    print(f"wrote {npz} ({sum(v.size for v in params.values())} values), {meta_path}, {golden}")


def write(names=()) -> None:
    for name in names or COPIES + FAMILIES:
        write_family(name)


if __name__ == "__main__":
    if "--write" not in sys.argv[1:]:
        sys.exit("usage: python tests/test_torch_weights.py --write")
    jax.config.update("jax_platforms", "cpu")
    write([a for a in sys.argv[1:] if a != "--write"])
    sys.exit(0)

import pytest  # noqa: E402


@pytest.fixture(scope="module")
def restored():
    return restore_nano()


def test_npz_has_the_nano_tree(restored):
    params, _ = restored
    with np.load(NPZ) as data:
        committed = {k: data[k] for k in data.files}
    assert sorted(committed) == sorted(params)
    assert sum(v.size for v in committed.values()) == 125_834
    assert {k.split("/")[0] for k in committed} == (
        {f"Conv_{i}" for i in range(9)} | {f"GroupNorm_{i}" for i in range(6)} | {"Dense_0", "Dense_1"})


def test_npz_equals_orbax_checkpoint(restored):
    """Array by array, bit for bit: the copy is the checkpoint."""
    params, _ = restored
    with np.load(NPZ) as data:
        for k, v in params.items():
            assert data[k].dtype == np.float32
            np.testing.assert_array_equal(data[k], v, err_msg=k)


def test_metadata_copy_equals_checkpoint(restored):
    _, meta = restored
    with open(META) as f:
        assert json.load(f) == portable_metadata(meta)


def test_golden_logits_equal_jax_forward(restored):
    """The golden logits are the JAX package's eager bf16 forward of the
    golden images; 1e-5 leaves room for float32 reassociation between XLA
    builds."""
    params, meta = restored
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert golden["seed"] == GOLDEN_SEED and golden["shape"] == [GOLDEN_BATCH, 32, 32, 3]
    np.testing.assert_allclose(np.asarray(golden["logits"], np.float32),
                               jax_logits(params, meta, golden_images()), atol=1e-5, rtol=0)


# ── student_std: the gated preset's predictor ────────────────────────────

STD = {ext: os.path.join(WEIGHTS, "student_std" + ext) for ext in (".npz", ".metadata.json", ".golden.json")}


@pytest.fixture(scope="module")
def restored_std():
    return restore_nano("student_std")


def test_std_npz_equals_orbax_checkpoint(restored_std):
    """Array by array, bit for bit, the same tree as nano's (widths 16/32/64)."""
    params, _ = restored_std
    with np.load(STD[".npz"]) as data:
        assert sorted(data.files) == sorted(params)
        for k, v in params.items():
            assert data[k].dtype == np.float32
            np.testing.assert_array_equal(data[k], v, err_msg=k)


def test_std_metadata_carries_what_serving_reads(restored_std):
    _, meta = restored_std
    with open(STD[".metadata.json"]) as f:
        copy = json.load(f)
    assert copy == portable_metadata(meta)
    assert copy["temperature"] == 1.1526 and copy["conformal_qhat"] == 0.90856
    assert copy["standardize_input"] is True and copy["widths"] == [16, 32, 64] and copy["dense_width"] == 64
    assert not any(isinstance(v, str) and v.startswith("/") for v in copy.values())  # no absolute paths


def test_std_golden_logits_equal_jax_forward(restored_std):
    params, meta = restored_std
    with open(STD[".golden.json"]) as f:
        golden = json.load(f)
    assert golden["seed"] == GOLDEN_SEED and golden["shape"] == [GOLDEN_BATCH, 32, 32, 3]
    np.testing.assert_allclose(np.asarray(golden["logits"], np.float32),
                               jax_logits(params, meta, golden_images()), atol=1e-5, rtol=0)


# ── classifier: the evaluation grid's default model ──────────────────────

CLASSIFIER = {ext: os.path.join(WEIGHTS, "classifier" + ext) for ext in (".npz", ".metadata.json", ".golden.json")}


@pytest.fixture(scope="module")
def restored_classifier():
    return restore_nano("classifier")


def test_classifier_npz_equals_orbax_checkpoint(restored_classifier):
    """Array by array, bit for bit: widths 64/128/256, dense 256,
    1,990,154 float32 parameters."""
    params, _ = restored_classifier
    with np.load(CLASSIFIER[".npz"]) as data:
        assert sorted(data.files) == sorted(params)
        for k, v in params.items():
            assert data[k].dtype == np.float32
            np.testing.assert_array_equal(data[k], v, err_msg=k)
    assert sum(v.size for v in params.values()) == 1_990_154


def test_classifier_metadata_carries_what_evaluate_reads(restored_classifier):
    _, meta = restored_classifier
    with open(CLASSIFIER[".metadata.json"]) as f:
        copy = json.load(f)
    assert copy == portable_metadata(meta)
    assert copy["temperature"] == 0.9414 and copy["widths"] == [64, 128, 256] and copy["dense_width"] == 256


def test_classifier_golden_logits_equal_jax_forward(restored_classifier):
    params, meta = restored_classifier
    with open(CLASSIFIER[".golden.json"]) as f:
        golden = json.load(f)
    assert golden["seed"] == GOLDEN_SEED and golden["shape"] == [GOLDEN_BATCH, 32, 32, 3]
    np.testing.assert_allclose(np.asarray(golden["logits"], np.float32),
                               jax_logits(params, meta, golden_images()), atol=1e-5, rtol=0)


# ── the other shipped classifiers ────────────────────────────────────────

SHIPPED_META = {
    # what evaluate, serving and the checkpoint tools read from each copy
    "student_compact": {"temperature": 1.1333, "conformal_qhat": 0.90689, "widths": [32, 64, 128],
                        "dense_width": 128, "distilled_from": "fav_tpu/checkpoints/ensemble"},
    "student_occl_acc": {"temperature": 0.931, "conformal_qhat": 0.90493, "widths": [32, 64, 128],
                         "dense_width": 128, "occlude": True},
    "classifier_occl": {"temperature": 0.8557, "conformal_qhat": 0.90088, "widths": [64, 128, 256],
                        "dense_width": 256, "augmix": True, "occlude": True},
    "classifier_freq": {"temperature": 0.894, "conformal_qhat": 0.90205, "widths": [64, 128, 256],
                        "dense_width": 256, "augmix": True, "freqband": True},
    "classifier_deepaug": {"temperature": 0.7531, "conformal_qhat": 0.91084, "widths": [64, 128, 256],
                           "dense_width": 256, "augmix": True, "deepaugment": True},
    "distilled": {"temperature": 0.9096, "conformal_qhat": 0.90428, "widths": [64, 128, 256],
                  "dense_width": 256, "distill_mc_samples": 20},
}
SHIPPED_VALUES = {"student_compact": 499_466, "student_occl_acc": 499_466}


@pytest.fixture(scope="module")
def restored_shipped():
    return {name: restore_family(name) for name in SHIPPED}


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_npz_equals_orbax_checkpoint(restored_shipped, name):
    """Array by array, bit for bit: the compact students hold 499,466
    float32 values, the full-width classifiers 1,990,154."""
    params, _ = restored_shipped[name]
    with np.load(os.path.join(WEIGHTS, name + ".npz")) as data:
        assert sorted(data.files) == sorted(params)
        for k, v in params.items():
            assert data[k].dtype == np.float32
            np.testing.assert_array_equal(data[k], v, err_msg=k)
    assert sum(v.size for v in params.values()) == SHIPPED_VALUES.get(name, 1_990_154)


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_metadata_carries_what_the_tools_read(restored_shipped, name):
    _, meta = restored_shipped[name]
    with open(os.path.join(WEIGHTS, name + ".metadata.json")) as f:
        copy = json.load(f)
    assert copy == portable_metadata(meta)
    assert {k: copy[k] for k in SHIPPED_META[name]} == SHIPPED_META[name]
    assert copy["arch"] == "vgg" and not copy.get("ensemble_size")


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_golden_logits_equal_jax_forward(restored_shipped, name):
    """The JAX package's eager bf16 logits (float32 rounding between XLA
    builds: 1e-5)."""
    params, meta = restored_shipped[name]
    with open(os.path.join(WEIGHTS, name + ".golden.json")) as f:
        golden = json.load(f)
    assert golden["seed"] == GOLDEN_SEED and golden["shape"] == [GOLDEN_BATCH, 32, 32, 3]
    np.testing.assert_allclose(np.asarray(golden["logits"], np.float32),
                               np.asarray(family_golden(params, meta, golden_images())["logits"], np.float32),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", COPIES)
def test_port_forward_holds_the_golden(name):
    """The port's bf16 forward of each copy (student_std through
    ``standardize_image``, ddof 0) on the golden images, on the CPU: within
    the 0.125 logit bound chip_smoke.py holds the card to, argmax equal."""
    import torch

    from fav_tpu_torch.utils.checkpoint import load_student

    model, meta = load_student(name, device="cpu")
    assert model.standardize_input is bool(meta.get("standardize_input", False))
    with open(os.path.join(WEIGHTS, name + ".golden.json")) as f:
        want = np.asarray(json.load(f)["logits"], np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(golden_images())).numpy()
    assert np.abs(got - want).max() <= 0.125
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


# ── the other families: autoencoder, vit, ensemble ───────────────────────

FAMILY_META = {
    # what serving and evaluate read from each copy's metadata
    "autoencoder": {"model": "ConvAutoencoder", "ae_widths": [32, 64, 128], "ae_latent": 128,
                    "err_baseline": 0.007118},
    "vit": {"arch": "vit", "vit_dim": 128, "vit_depth": 4, "vit_heads": 4, "temperature": 0.7976},
    "ensemble": {"arch": "vgg", "ensemble_size": 5, "widths": [64, 128, 256], "temperature": 1.0985},
}
FAMILY_VALUES = {"autoencoder": 481_539, "vit": 546_186, "ensemble": 5 * 1_990_154}


@pytest.fixture(scope="module")
def restored_families():
    return {name: restore_family(name) for name in FAMILIES}


@pytest.mark.parametrize("name", FAMILIES)
def test_family_npz_equals_orbax_checkpoint(restored_families, name):
    """Array by array, bit for bit; the ensemble's leaves keep the member axis."""
    params, meta = restored_families[name]
    with np.load(os.path.join(WEIGHTS, name + ".npz")) as data:
        assert sorted(data.files) == sorted(params)
        for k, v in params.items():
            assert data[k].dtype == np.float32
            np.testing.assert_array_equal(data[k], v, err_msg=k)
    assert sum(v.size for v in params.values()) == FAMILY_VALUES[name]
    if name == "ensemble":
        assert {v.shape[0] for v in params.values()} == {5}


@pytest.mark.parametrize("name", FAMILIES)
def test_family_metadata_carries_what_serving_reads(restored_families, name):
    _, meta = restored_families[name]
    with open(os.path.join(WEIGHTS, name + ".metadata.json")) as f:
        copy = json.load(f)
    assert copy == portable_metadata(meta)
    assert {k: copy[k] for k in FAMILY_META[name]} == FAMILY_META[name]


@pytest.mark.parametrize("name", FAMILIES)
def test_family_golden_equals_jax_forward(restored_families, name):
    """The goldens are the JAX package's eager bf16 outputs (float32
    rounding between XLA builds: 1e-5; the errors relative)."""
    params, meta = restored_families[name]
    with open(os.path.join(WEIGHTS, name + ".golden.json")) as f:
        golden = json.load(f)
    assert golden["seed"] == GOLDEN_SEED and golden["shape"] == [GOLDEN_BATCH, 32, 32, 3]
    fresh = family_golden(params, meta, golden_images())
    assert set(fresh) <= set(golden)
    for key, want in fresh.items():
        got = np.asarray(golden[key], np.float64)
        if key == "errors":
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=0)
        else:
            np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", FAMILIES)
def test_family_port_forward_holds_the_golden(name):
    """``load_weights`` rebuilds each copy's model from its metadata; its bf16
    forward on the CPU holds the golden as chip_smoke.py holds the card:
    logits (each member's) within 0.125 and argmax equal, the
    autoencoder's errors within AE_ERR_RTOL (relative)."""
    import torch

    from fav_tpu_torch.models.cnn import ConvAutoencoder
    from fav_tpu_torch.tools.scripted_serve import AE_ERR_RTOL
    from fav_tpu_torch.utils.checkpoint import load_weights

    model, meta = load_weights(name, device="cpu")
    with open(os.path.join(WEIGHTS, name + ".golden.json")) as f:
        golden = json.load(f)
    x = torch.from_numpy(golden_images())
    with torch.no_grad():
        if name == "autoencoder":
            assert isinstance(model, ConvAutoencoder) and model.widths == (32, 64, 128) and model.latent == 128
            err = ConvAutoencoder.reconstruction_error(model(x), x).numpy()
            assert np.abs(err / np.asarray(golden["errors"]) - 1.0).max() <= AE_ERR_RTOL
            return
        outs = [m(x).numpy() for m in model] if name == "ensemble" else [model(x).numpy()]
    wants = golden["member_logits"] if name == "ensemble" else [golden["logits"]]
    assert len(outs) == len(wants) == (meta.get("ensemble_size") or 1)
    for got, want in zip(outs, wants):
        want = np.asarray(want, np.float32)
        assert np.abs(got - want).max() <= 0.125
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


# ── serve.golden.json (tests/test_torch_inference.py --write) ─────────────

SERVE = os.path.join(WEIGHTS, "serve.golden.json")


@pytest.fixture(scope="module")
def serve_golden():
    with open(SERVE) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["msp", "gated"])
def test_serve_golden_rows_equal_fav_tpu_service(serve_golden, name):
    """The committed rows are fav_tpu's InferenceService on the golden's
    frames (float32 rounding between XLA builds: 1e-5)."""
    from test_torch_inference import golden_inputs, jax_rows

    want = jax_rows(name, golden_inputs())
    got = np.asarray(serve_golden["deployments"][name]["rows"], np.float32)
    assert got.shape == want.shape == (16, 7 if name == "gated" else 6)
    np.testing.assert_array_equal(got[:, [0, 5]], want[:, [0, 5]])  # predictions and set sizes
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_serve_golden_states_equal_fav_tpu_app(serve_golden):
    """One stream of each kind, re-driven through fav_tpu's app in
    lockstep, ends where the committed golden says; every stream of a kind
    ends in its kind's status and policy."""
    from test_torch_inference import jax_lockstep_states

    from fav_tpu_torch.sim.frames import MONITOR_STREAMS

    states = serve_golden["deployments"]["msp"]["states"]
    picks = [next(j for j, (k, _) in enumerate(MONITOR_STREAMS) if k == kind)
             for kind in ("ok", "frozen", "blank", "corrupted")]
    assert jax_lockstep_states("msp", picks) == [states[j] for j in picks]
    expect = {"ok": ("VISION_OK", "VISION_ALLOWED"), "frozen": ("VISION_FROZEN", "VISION_DEGRADED"),
              "blank": ("VISION_BLANK", "VISION_BLOCKED"), "corrupted": ("VISION_CORRUPTED", "VISION_BLOCKED")}
    for name in ("msp", "gated"):
        for (kind, _), s in zip(MONITOR_STREAMS, serve_golden["deployments"][name]["states"]):
            assert (s["vision_status"], s["policy_state"]) == expect[kind]


def test_serve_golden_playground_and_keys_equal_fav_tpu(serve_golden):
    from fav_tpu.config import DEFAULT_CONFIG
    from fav_tpu.serving.app import run_playground_sequence

    pg = serve_golden["playground"]
    assert run_playground_sequence(pg["events"], DEFAULT_CONFIG) == pg["results"]
    assert {"reliability", "policy_state", "vision_status", "source_mode", "failure_events", "frame",
            "dt"} <= set(serve_golden["ws_state_keys"])
