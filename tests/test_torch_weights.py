"""The port's committed weights against the JAX package's checkpoints.

``fav_tpu_torch/weights/student_nano.npz`` and ``student_std.npz`` hold the
flax parameters of ``fav_tpu/checkpoints/student_nano`` and
``student_std`` (the ``gated`` preset's predictor) as numpy arrays, because
the orbax checkpoints need JAX and orbax to read and the machine with the
card has neither. ``<name>.golden.json`` holds the JAX package's eager bf16
logits for a few fixed images, which ``chip_smoke.py`` holds the port to on
the card. ``serve.golden.json`` (written by ``tests/test_torch_inference.py
--write``) holds the JAX ``InferenceService`` rows of both deployments on
fixed frames and the states the JAX app reaches on the scripted streams;
the last tests here pin it.

Run as a script with ``--write`` to regenerate the weights, metadata and
logit goldens of both students:

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

from fav_tpu.models.cnn import FailureAwareCNN  # noqa: E402
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
    tree: dict = {}
    for path, v in params.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    # eager, op by op: each op rounds to bf16 where the flax module says it
    # does. Under jit XLA fuses a conv with its bias and skips that rounding,
    # which moves bf16 logits by up to ~0.1 on these images.
    logits = _nano_model(meta).apply({"params": tree}, jnp.asarray(images))
    return np.asarray(logits, dtype=np.float32)


def write() -> None:
    for name in STUDENTS:
        write_student(name)


def write_student(name: str) -> None:
    params, meta = restore_nano(name)
    npz, meta_path, golden = (os.path.join(WEIGHTS, name + ext)
                              for ext in (".npz", ".metadata.json", ".golden.json"))
    np.savez(npz, **params)
    with open(meta_path, "w") as f:
        json.dump(portable_metadata(meta), f, indent=2)
        f.write("\n")
    logits = jax_logits(params, meta, golden_images())
    with open(golden, "w") as f:
        json.dump({"seed": GOLDEN_SEED, "shape": [GOLDEN_BATCH, 32, 32, 3],
                   "images": "numpy.random.default_rng(seed).random(shape, dtype=float32)",
                   "compute_dtype": "bfloat16",
                   "logits": [[float(v) for v in row] for row in logits]}, f, indent=1)
        f.write("\n")
    print(f"wrote {npz} ({sum(v.size for v in params.values())} values), {meta_path}, {golden}")


if __name__ == "__main__":
    if "--write" not in sys.argv[1:]:
        sys.exit("usage: python tests/test_torch_weights.py --write")
    jax.config.update("jax_platforms", "cpu")
    write()
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


@pytest.mark.parametrize("name", STUDENTS)
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
