"""The port's committed nano weights against the JAX package's checkpoint.

``fav_tpu_torch/weights/student_nano.npz`` holds the flax parameters of
``fav_tpu/checkpoints/student_nano`` as numpy arrays, because the orbax
checkpoint needs JAX and orbax to read and the machine with the card has
neither. ``student_nano.golden.json`` holds the JAX package's bf16 logits
for a few fixed images, which ``chip_smoke.py`` holds the port to on the
card.

Run as a script with ``--write`` to regenerate both files:

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

CKPT = os.path.join(REPO, "fav_tpu", "checkpoints", "student_nano")
WEIGHTS = os.path.join(REPO, "fav_tpu_torch", "weights")
NPZ = os.path.join(WEIGHTS, "student_nano.npz")
META = os.path.join(WEIGHTS, "student_nano.metadata.json")
GOLDEN = os.path.join(WEIGHTS, "student_nano.golden.json")
GOLDEN_SEED = 0
GOLDEN_BATCH = 8


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
    return FailureAwareCNN(widths=tuple(meta["widths"]), dense_width=meta["dense_width"])


def restore_nano():
    """(flat params without the ``params/`` prefix, metadata) from orbax."""
    with open(os.path.join(CKPT, "metadata.json")) as f:
        meta = json.load(f)
    model = _nano_model(meta)
    # shapes only: tracing init is enough for orbax, and compiling it op by op
    # would cost most of this file's time
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32))
    template = jax.tree.map(lambda s: jax.device_put(np.zeros(s.shape, s.dtype)), shapes)
    variables, meta = restore_checkpoint(CKPT, template)
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
    params, meta = restore_nano()
    np.savez(NPZ, **params)
    with open(META, "w") as f:
        json.dump(portable_metadata(meta), f, indent=2)
        f.write("\n")
    logits = jax_logits(params, meta, golden_images())
    with open(GOLDEN, "w") as f:
        json.dump({"seed": GOLDEN_SEED, "shape": [GOLDEN_BATCH, 32, 32, 3],
                   "images": "numpy.random.default_rng(seed).random(shape, dtype=float32)",
                   "compute_dtype": "bfloat16",
                   "logits": [[float(v) for v in row] for row in logits]}, f, indent=1)
        f.write("\n")
    print(f"wrote {NPZ} ({sum(v.size for v in params.values())} values), {META}, {GOLDEN}")


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
