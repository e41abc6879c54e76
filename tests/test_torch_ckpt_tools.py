"""The port's checkpoint tools and quickstart against ``fav_tpu`` and the
repository's JAX tools, on the CPU.

Every tool runs on small synthetic sets (``synthetic_cifar10`` with a few
hundred images: the port's bytes are ``fav_tpu``'s, ``tests/
test_torch_data.py``), tiny vgg copies (widths 8/16) made from a numpy
seed and the ``student_nano`` copy; the JAX tools' recipes run on
``fav_tpu``'s functions fed the same inputs (the JAX tools themselves
compile op by op for tens of seconds on the CPU). Tolerance classes:

* **exact**: stacked leaves, weights passed through, recipe flags;
* **float32 rounding** (``FIT_RTOL`` 1e-5 relative on a temperature, 1e-6
  on ECE and AUROC, 1e-5 on a qhat rounded to five places): the same
  logits through the port's and ``fav_tpu``'s fits, metrics and APS
  quantile with ``fav_tpu``'s ``PRNGKey(13)`` uniforms;
* **the bf16 forward** (``scripted_serve.CONF_ATOL``, 0.05 on a
  probability; ``tools/scripted_serve.py:compare_rows`` for served rows):
  the port's bf16 forward against flax's jitted one, where a tool's output
  depends on the forward; a conformal quantile moves no more than the
  scores it is taken over;
* **the families' element bounds** (``ELEMENT_TOL`` 1e-6 for brightness
  and contrast, ``REASSOC_TOL`` 3e-6 for defocus blur, as
  ``tests/test_torch_sweep.py`` holds the grid's families to the oracle):
  the defense-in-depth cells that draw nothing; their analyzer statuses
  equal on every frame (none of these frames lies on a threshold), the
  mean entropy within 0.01 (a pixel within the bound of a half step may
  round to the other uint8 level);
* **statistical**: cells and views drawn by ``jax.random`` (snow, fog, the
  AugMix views), which Philox cannot replay: held to the law's bounds.

``fav_tpu_torch/weights/tools.golden.json`` holds the JAX tools' outputs at
full size on the shipped checkpoints (the stack of ``classifier``,
``classifier_freq`` and ``classifier_occl``, the refit of ``classifier``
over 7 views, draw 0's defense rows and the weather probe at 512 images),
which ``chip_smoke.py`` phase 17 holds the port's tools to on the card.
Run as a script to regenerate it (about two minutes on the CPU):

    JAX_PLATFORMS=cpu python tests/test_torch_ckpt_tools.py --write
"""

from __future__ import annotations

import functools
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from fav_tpu.models import calibration as jcal  # noqa: E402
from fav_tpu.models import conformal as jconf  # noqa: E402
from fav_tpu_torch.config import ModelParams  # noqa: E402
from fav_tpu_torch.data.cifar import synthetic_cifar10  # noqa: E402
from fav_tpu_torch.models.cnn import create_model  # noqa: E402
from fav_tpu_torch.tools import scripted_serve as ss  # noqa: E402
from fav_tpu_torch.utils.checkpoint import (WEIGHTS_DIR, load_flax_npz, load_weights,  # noqa: E402
                                            random_flax_params, save_flax_npz)

TINY = ModelParams(widths=(8, 16), dense_width=16)
TRAIN, TEST = 128, 256  # the small set: one quickstart batch; 128 held-out rows fit, 128 report
FIT_RTOL = 1e-5
METRIC_TOL = 1e-6
QHAT_TOL = 1e-5
ELEMENT_TOL = 1e-6
REASSOC_TOL = 3e-6
DEFENSE_IMAGES = 64


GOLDEN = os.path.join(REPO, "fav_tpu_torch", "weights", "tools.golden.json")
STACK_MEMBERS = ("classifier", "classifier_freq", "classifier_occl")
REFIT_CHECKPOINT, REFIT_VIEWS, REFIT_SEED = "classifier", 7, 1234
PROBE_IMAGES = 512  # the defense and weather probes at chip_smoke.py's size
CHUNK = 500  # images per JAX forward: the recipes' logits, in bounded memory


def _jax_forward(name: str):
    """``fav_tpu``'s jitted forward of the orbax checkpoint ``name`` over
    chunks of ``CHUNK`` images, and its metadata."""
    from test_torch_weights import _tree, family_model, restore_family

    params, meta = restore_family(name)
    model = family_model(meta)
    apply = jax.jit(lambda x: model.apply({"params": _tree(params)}, x))

    def forward(x):
        return jnp.concatenate([apply(jnp.asarray(x[i:i + CHUNK])) for i in range(0, x.shape[0], CHUNK)])

    return forward, meta


def write_golden() -> None:
    """The JAX tools' outputs at full size on the shipped checkpoints, the
    recipes of ``tools/stack_ensemble.py``, ``tools/refit_temperature.py``,
    ``tools/defense_in_depth.py`` and ``tools/diagnose_weather.py`` line for
    line, with the forwards in chunks of ``CHUNK`` images."""
    from fav_tpu.data.cifar import load_cifar10
    from fav_tpu.ops.augment import augmix
    from fav_tpu.ops.corruptions import corruption_fn
    from tools.defense_in_depth import analyze_cells
    from tools.diagnose_weather import lowfreq_fraction

    ds = load_cifar10()
    n_val = ds.test_images.shape[0] // 2
    val_x, val_y = ds.test_images[:n_val], jnp.asarray(ds.test_labels[:n_val])
    test_x, test_y = ds.test_images[n_val:], jnp.asarray(ds.test_labels[n_val:])
    out = {"data_source": ds.source, "test_images": int(ds.test_images.shape[0])}

    # stack_ensemble.py:86-111 on the logit-averaged forward of the members
    forwards = [_jax_forward(m) for m in STACK_MEMBERS]
    val_logits = jnp.mean(jnp.stack([f(val_x) for f, _ in forwards]), axis=0)
    logits = jnp.mean(jnp.stack([f(test_x) for f, _ in forwards]), axis=0)
    temperature = float(jcal.fit_temperature(val_logits, val_y))
    probs = jax.nn.softmax(logits / temperature, axis=-1)
    conf = jnp.max(probs, axis=-1)
    correct = (jnp.argmax(probs, -1) == test_y).astype(jnp.float32)
    fails = jcal.failure_labels(jnp.argmax(probs, -1), test_y)
    out["stack"] = {"members": list(STACK_MEMBERS), "temperature_exact": temperature, "metadata": {
        "accuracy": round(float(jnp.mean(correct)), 4),
        "temperature": round(temperature, 4),
        **jconf.calibration_metadata(jax.nn.softmax(val_logits / temperature, -1), val_y),
        "ece": round(float(jcal.expected_calibration_error(conf, correct)), 4),
        "failure_auroc": round(float(jcal.auroc(1.0 - conf, fails)), 4),
        "ensemble_size": len(STACK_MEMBERS),
        "member_recipes": [{k: m[k] for k in ("augmix", "freqband", "occlude", "train_steps") if k in m}
                           for _, m in forwards],
    }}

    # refit_temperature.py:95-133 on the clean split and its AugMix views
    fwd, _ = _jax_forward(REFIT_CHECKPOINT)
    key = jax.random.PRNGKey(REFIT_SEED)
    view_fn = jax.jit(lambda k, x: augmix(k, x))
    sets = [fwd(val_x)] + [fwd(view_fn(jax.random.fold_in(key, i), jnp.asarray(val_x))) for i in range(REFIT_VIEWS)]
    t_clean = float(jcal.fit_temperature(sets[0], val_y))
    t_shift = float(jcal.fit_temperature(jnp.concatenate(sets), jnp.tile(val_y, len(sets))))
    aug, aug_y = jnp.concatenate(sets[1:]), jnp.tile(val_y, REFIT_VIEWS)

    def ece_at(lg, y, t):
        p = jax.nn.softmax(lg / t, axis=-1)
        return round(float(jcal.expected_calibration_error(jnp.max(p, -1), (jnp.argmax(p, -1) == y)
                                                           .astype(jnp.float32))), 4)

    out["refit"] = {"checkpoint": REFIT_CHECKPOINT, "views": REFIT_VIEWS, "seed": REFIT_SEED,
                    "t_clean": t_clean, "t_shift": t_shift, "report": {
                        "temperature_cleanfit": round(t_clean, 4), "temperature_shiftfit": round(t_shift, 4),
                        "val_acc_augmented_views": round(float(jnp.mean(jnp.argmax(aug, -1) == aug_y)), 4),
                        "ece_clean_val": {"cleanfit_T": ece_at(sets[0], val_y, t_clean),
                                          "shiftfit_T": ece_at(sets[0], val_y, t_shift)},
                        "ece_augmented_val": {"cleanfit_T": ece_at(aug, aug_y, t_clean),
                                              "shiftfit_T": ece_at(aug, aug_y, t_shift)}}}

    # defense_in_depth.py:analyze_cells, draw 0
    out["defense"] = {"draws": [0], "num_images": PROBE_IMAGES, "rows": analyze_cells([0], PROBE_IMAGES)}

    # diagnose_weather.py:83-106, the probe of its default checkpoint
    fwd, meta = _jax_forward("classifier")
    temp = float(meta.get("temperature", 1.0))
    x, y = jnp.asarray(ds.test_images[:PROBE_IMAGES]), jnp.asarray(ds.test_labels[:PROBE_IMAGES])
    key = jax.random.PRNGKey(42)
    views = {"clean": x, "augmix": jax.jit(augmix)(key, x)}
    for fi, fam in enumerate(("fog", "snow", "frost", "gaussian_noise")):
        for sev in (1, 3, 5):
            views[f"{fam}_s{sev}"] = jax.jit(corruption_fn(fam), static_argnums=2)(
                jax.random.fold_in(key, fi * 10 + sev), x, sev)
    weather = {}
    for name, v in views.items():
        p = jax.nn.softmax(fwd(v) / temp, axis=-1)
        preds = jnp.argmax(p, axis=-1)
        weather[name] = {
            "acc": float(jnp.mean((preds == y).astype(jnp.float32))),
            "conf": float(jnp.mean(jnp.max(p, axis=-1))),
            "pred_hist": [float(h) for h in jnp.zeros(10).at[preds].add(1.0) / preds.shape[0]],
            "lum_mean": float(jnp.mean(v)),
            "lum_std": float(jnp.mean(jnp.std(v.reshape(v.shape[0], -1), axis=1))),
            "lowfreq_frac": float(jnp.mean(lowfreq_fraction(v))),
        }
    out["weather"] = {"checkpoint": "classifier", "num_images": PROBE_IMAGES, "views": weather}
    with open(GOLDEN, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"wrote {GOLDEN}")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: JAX_PLATFORMS=cpu python tests/test_torch_ckpt_tools.py --write")
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    write_golden()
    sys.exit(0)

import pytest  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread, so that a loaded machine shares its cores among
    fewer threads (the tiny forwards here gain nothing from more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_ds():
    return synthetic_cifar10(train_size=TRAIN, test_size=TEST)


def tiny_copy(directory, name: str, seed: int, **meta) -> str:
    """A tiny vgg copy ``<directory>/<name>.npz`` + metadata. Returns the stem."""
    stem = os.path.join(str(directory), name)
    save_flax_npz(stem + ".npz", random_flax_params(create_model(TINY), seed))
    meta = {"arch": "vgg", "widths": list(TINY.widths), "dense_width": TINY.dense_width, "temperature": 1.0, **meta}
    with open(stem + ".metadata.json", "w") as f:
        json.dump(meta, f)
    return stem


def jax_u(n: int) -> np.ndarray:
    """The uniforms ``fav_tpu``'s ``calibration_metadata`` draws (PRNGKey(13))."""
    return np.array(jax.random.uniform(jax.random.PRNGKey(13), (n, 1), jnp.float32))


def _logits(seed: int, n: int, scale: float = 3.0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 10, n).astype(np.int32)
    logits = rng.normal(0.0, scale, (n, 10)).astype(np.float32)
    logits[np.arange(n), y] += rng.normal(1.5, 1.0, n).astype(np.float32)  # better than chance, not certain
    return logits, y


# ── stack_ensemble ────────────────────────────────────────────────────────


def test_stacked_leaves_equal_the_members_exactly():
    from fav_tpu_torch.tools.stack_ensemble import stack_trees

    trees = [random_flax_params(create_model(TINY), s) for s in (1, 2, 3)]
    stacked = stack_trees(trees)
    assert sorted(stacked) == sorted(trees[0])
    for k, v in stacked.items():
        assert v.shape == (3,) + trees[0][k].shape and v.dtype == np.float32
        for m, tree in enumerate(trees):
            np.testing.assert_array_equal(v[m], tree[k])
    trees[1] = {k: v[..., :1] if k.endswith("bias") else v for k, v in trees[1].items()}
    with pytest.raises(ValueError, match="parameter trees"):
        stack_trees(trees)


def test_ensemble_metadata_equals_the_jax_tools_on_the_same_logits():
    """The JAX tool's lines, on fav_tpu's functions, against the port's
    metadata function fed the same logits and fav_tpu's uniforms: float32
    rounding, the keys in the same order."""
    from fav_tpu_torch.tools.stack_ensemble import ensemble_metadata

    val_logits, val_y = _logits(0, 400)
    logits, test_y = _logits(1, 400)
    metas = [{"augmix": True, "train_steps": 3000, "arch": "vgg", "widths": [8, 16], "dense_width": 16},
             {"occlude": True, "freqband": True, "train_steps": 10, "js_lam": 12.0, "widths": [8, 16],
              "dense_width": 16}]
    t = torch.from_numpy
    got = ensemble_metadata(t(val_logits), t(val_y), t(logits), t(test_y), metas, ["a", "b"], "synthetic",
                            u=t(jax_u(400)))
    temperature = float(jcal.fit_temperature(jnp.asarray(val_logits), jnp.asarray(val_y)))
    probs = jax.nn.softmax(jnp.asarray(logits) / temperature, axis=-1)
    conf = jnp.max(probs, axis=-1)
    preds = jnp.argmax(probs, axis=-1)
    correct = (preds == test_y).astype(jnp.float32)
    fails = jcal.failure_labels(preds, jnp.asarray(test_y))
    want = {
        "accuracy": round(float(jnp.mean(correct)), 4),
        "temperature": round(temperature, 4),
        **jconf.calibration_metadata(jax.nn.softmax(jnp.asarray(val_logits) / temperature, -1), jnp.asarray(val_y)),
        "ece": round(float(jcal.expected_calibration_error(conf, correct)), 4),
        "failure_auroc": round(float(jcal.auroc(1.0 - conf, fails)), 4),
        "data_source": "synthetic",
        "ensemble_size": 2,
        "stacked_from": ["a", "b"],
        "member_recipes": [{k: m[k] for k in ("augmix", "freqband", "occlude", "train_steps") if k in m}
                           for m in metas],
        "arch": "vgg",
        "widths": [8, 16],
        "dense_width": 16,
    }
    assert list(got) == list(want)
    for k, v in want.items():
        if isinstance(v, float):
            assert abs(got[k] - v) <= (QHAT_TOL if k == "conformal_qhat" else 1e-4 + 1e-9), (k, got[k], v)
        else:
            assert got[k] == v, k
    # the unrounded fit and metrics within float32 rounding
    from fav_tpu_torch.models.calibration import auroc, expected_calibration_error, fit_temperature

    t_port = float(fit_temperature(t(val_logits), t(val_y)))
    assert abs(t_port - temperature) <= FIT_RTOL * temperature
    p_conf = torch.softmax(t(logits) / t_port, -1).amax(-1)
    p_correct = (torch.softmax(t(logits) / t_port, -1).argmax(-1) == t(test_y)).to(torch.float32)
    assert abs(float(expected_calibration_error(p_conf, p_correct))
               - float(jcal.expected_calibration_error(conf, correct))) <= METRIC_TOL
    assert abs(float(auroc(1.0 - p_conf, 1.0 - p_correct)) - float(jcal.auroc(1.0 - conf, fails))) <= METRIC_TOL


def test_stacked_copy_loads_as_its_members(tmp_path, small_ds):
    """Two tiny members stacked and read back by ``load_weights``: two
    models whose logits are the members' own, so their mean is too."""
    from fav_tpu_torch.tools import stack_ensemble

    a = tiny_copy(tmp_path, "a", 1, augmix=True, train_steps=5)
    b = tiny_copy(tmp_path, "b", 2, occlude=True, train_steps=5)
    out = str(tmp_path / "ens")
    meta = stack_ensemble.stack([a, b], out, "cpu", small_ds)
    assert meta["ensemble_size"] == 2 and meta["stacked_from"] == [a, b] and meta["format"] == "npz"
    assert meta["member_recipes"] == [{"augmix": True, "train_steps": 5}, {"occlude": True, "train_steps": 5}]
    stacked_npz = load_flax_npz(out + ".npz")
    for m, stem in enumerate((a, b)):
        for k, v in load_flax_npz(stem + ".npz").items():
            np.testing.assert_array_equal(stacked_npz[k][m], v, err_msg=k)
    members, read = load_weights("ens", device="cpu", directory=tmp_path, members=2)
    assert read == meta and len(members) == 2
    x = torch.from_numpy(small_ds.test_images[:16])
    with torch.no_grad():
        own = [load_weights(n, device="cpu", directory=tmp_path)[0](x) for n in ("a", "b")]
        stacked = [m(x) for m in members]
    for s, o in zip(stacked, own):
        torch.testing.assert_close(s, o, rtol=0, atol=0)
    torch.testing.assert_close(torch.stack(stacked).mean(0), torch.stack(own).mean(0), rtol=0, atol=0)


def test_stack_refuses_disagreeing_architectures(tmp_path, small_ds):
    from fav_tpu_torch.tools import stack_ensemble

    a = tiny_copy(tmp_path, "a", 1)
    b = str(tmp_path / "b")
    wide = ModelParams(widths=(8, 8), dense_width=8)
    save_flax_npz(b + ".npz", random_flax_params(create_model(wide), 2))
    with open(b + ".metadata.json", "w") as f:
        json.dump({"arch": "vgg", "widths": [8, 8], "dense_width": 8}, f)
    with pytest.raises(ValueError, match="disagree on architecture"):
        stack_ensemble.stack([a, b], str(tmp_path / "x"), "cpu", small_ds)
    with pytest.raises(SystemExit):
        stack_ensemble.main([a, "--out", str(tmp_path / "x"), "--device", "cpu"])
    assert not os.path.exists(tmp_path / "x.npz")


# ── refit_temperature ─────────────────────────────────────────────────────


def test_refit_fits_equal_fav_tpus_on_the_same_logit_sets():
    """The clean and the shift fit, the views' accuracy and the four ECEs of
    the JAX tool's lines on the same logit sets: float32 rounding."""
    from fav_tpu_torch.tools.refit_temperature import fit_report

    sets, y = [], None
    for i in range(4):
        logits, labels = _logits(10, 300, scale=3.0 + i)
        sets.append(logits * (1.0 + 0.3 * i))
        y = labels
    t = torch.from_numpy
    got = fit_report([t(s) for s in sets], t(y))
    j_y = jnp.asarray(y)
    t_clean = float(jcal.fit_temperature(jnp.asarray(sets[0]), j_y))
    t_shift = float(jcal.fit_temperature(jnp.concatenate([jnp.asarray(s) for s in sets]), jnp.tile(j_y, 4)))
    assert abs(got["t_clean"] - t_clean) <= FIT_RTOL * t_clean
    assert abs(got["t_shift"] - t_shift) <= FIT_RTOL * t_shift
    assert t_shift > t_clean  # the views' larger logits at lower accuracy need more smoothing

    def ece_at(logits, labels, temp):
        probs = jax.nn.softmax(logits / temp, axis=-1)
        return float(jcal.expected_calibration_error(jnp.max(probs, -1),
                                                     (jnp.argmax(probs, -1) == labels).astype(jnp.float32)))

    aug = jnp.concatenate([jnp.asarray(s) for s in sets[1:]])
    aug_y = jnp.tile(j_y, 3)
    assert abs(got["val_acc_augmented_views"] - float(jnp.mean(jnp.argmax(aug, -1) == aug_y))) <= 5e-5
    for key, (logits, labels) in (("ece_clean_val", (jnp.asarray(sets[0]), j_y)), ("ece_augmented_val", (aug, aug_y))):
        for tkey, temp in (("cleanfit_T", t_clean), ("shiftfit_T", t_shift)):
            assert abs(got[key][tkey] - ece_at(logits, labels, temp)) <= 5e-5 + METRIC_TOL, (key, tkey)


# the report's keys, in order (tools/refit_temperature.py:117-133)
JAX_REFIT_KEYS = ["checkpoint", "views", "view_pool", "temperature_cleanfit", "temperature_shiftfit",
                  "val_acc_augmented_views", "ece_clean_val", "ece_augmented_val"]


@functools.lru_cache(maxsize=None)
def jax_nano():
    """``fav_tpu``'s jitted forward of the ``student_nano`` parameters (the
    copy equals the orbax checkpoint: ``tests/test_torch_weights.py``)."""
    from fav_tpu.config import ModelParams as JaxModelParams, model_params_from_metadata
    from fav_tpu.models.cnn import create_model as jax_create_model

    meta = json.loads((WEIGHTS_DIR / "student_nano.metadata.json").read_text())
    model = jax_create_model(model_params_from_metadata(JaxModelParams(), meta))
    tree: dict = {}
    for path, v in load_flax_npz(WEIGHTS_DIR / "student_nano.npz").items():
        node = tree
        *parents, leaf = path.split("/")
        for q in parents:
            node = node.setdefault(q, {})
        node[leaf] = jnp.asarray(v)
    apply = jax.jit(lambda x: model.apply({"params": tree}, x))
    return lambda x: np.asarray(apply(jnp.asarray(x)), np.float32)


def _nano_copy(tmp_path, name: str, drop=()) -> str:
    for ext in (".npz", ".metadata.json"):
        shutil.copy(WEIGHTS_DIR / f"student_nano{ext}", tmp_path / f"{name}{ext}")
    meta_path = tmp_path / f"{name}.metadata.json"
    meta = json.loads(meta_path.read_text())
    meta_path.write_text(json.dumps({k: v for k, v in meta.items() if k not in drop}))
    return str(tmp_path / name)


def test_refit_report_and_copy_against_the_jax_tool(tmp_path, small_ds):
    """``student_nano`` refit on the small set: the JAX tool's report keys;
    the clean fit (no draw) against ``fav_tpu``'s fit of its own forward
    within the bf16 class; ``--out`` writes the three temperature keys and
    the weights bit-equal. The shift fit rests on AugMix views, another
    draw than the JAX tool's: ``chip_smoke.py`` holds it at full size."""
    from fav_tpu_torch.tools import refit_temperature

    stem = _nano_copy(tmp_path, "src")
    out = str(tmp_path / "refit")
    report = refit_temperature.refit(stem, views=2, out=out, device="cpu", dataset=small_ds)
    assert [k for k in report if k not in ("t_clean", "t_shift")] == JAX_REFIT_KEYS
    assert report["checkpoint"] == stem and report["view_pool"] == {"freqband": False, "occlude": False}
    n_val = TEST // 2
    t_jax = float(jcal.fit_temperature(jnp.asarray(jax_nano()(small_ds.test_images[:n_val])),
                                       jnp.asarray(small_ds.test_labels[:n_val])))
    assert abs(report["t_clean"] / t_jax - 1.0) <= ss.CONF_ATOL
    with open(out + ".metadata.json") as f:
        meta = json.load(f)
    assert meta["temperature"] == report["temperature_shiftfit"]
    assert meta["temperature_cleanfit"] == report["temperature_cleanfit"]
    assert meta["temperature_refit"] == {"views": 2, "freqband": False, "occlude": False, "seed": 1234}
    assert meta["conformal_qhat"] == 0.90855 and meta["format"] == "npz"
    with open(out + ".npz", "rb") as f, open(stem + ".npz", "rb") as g:
        assert f.read() == g.read()


def test_refit_refuses_an_ensemble(tmp_path, small_ds):
    from fav_tpu_torch.tools import refit_temperature

    stem = tiny_copy(tmp_path, "ens", 4, ensemble_size=5)
    with pytest.raises(ValueError, match="single-model"):
        refit_temperature.refit(stem, views=1, device="cpu", dataset=small_ds)


# ── defense_in_depth ──────────────────────────────────────────────────────

DRAW_FREE = {"contrast": ELEMENT_TOL, "brightness": ELEMENT_TOL, "defocus_blur": REASSOC_TOL}


@pytest.fixture(scope="module")
def defense_rows(small_ds):
    from fav_tpu_torch.tools import defense_in_depth

    return defense_in_depth.analyze_cells([0], DEFENSE_IMAGES, device="cpu", datasets={0: small_ds})


def _jax_analyze(x):
    from fav_tpu.config import AnalyzerParams
    from fav_tpu.ops.signal import analyze_frame_jax, init_analyzer_carry

    frames = jnp.round(x[..., ::-1] * 255.0).astype(jnp.uint8)
    _, m = analyze_frame_jax(AnalyzerParams(), init_analyzer_carry(x.shape[1], x.shape[2], (x.shape[0],)), frames)
    return m


@pytest.mark.parametrize("cell", [("clean", 0)] + [(n, s) for n, s in
                                                    [("contrast", 2), ("contrast", 3), ("contrast", 4),
                                                     ("contrast", 5), ("brightness", 5), ("defocus_blur", 1)]])
def test_defense_draw_free_cells_equal_fav_tpus(cell, small_ds, defense_rows):
    """The port's cell batch against ``apply_corruption`` under the sweep's
    key (the families' element bounds), and the analyzer's statuses of it
    against ``analyze_frame_jax``'s on the JAX batch: equal on every frame;
    the row's rates are those statuses'."""
    from fav_tpu.ops.corruptions import apply_corruption
    from fav_tpu.parallel.sweep import cell_key as jax_cell_key
    from fav_tpu_torch.tools import defense_in_depth

    name, sev = cell
    images = small_ds.test_images[:DEFENSE_IMAGES]
    if sev:
        got = defense_in_depth.cell_batch(torch.from_numpy(images), name, sev).numpy()
        want = np.asarray(apply_corruption(name, jax_cell_key(jax.random.PRNGKey(42), name, sev),
                                           jnp.asarray(images), sev))
        np.testing.assert_allclose(got, want, atol=DRAW_FREE[name], rtol=0)
    else:
        got = want = images
    status = defense_in_depth.analyze_batch(torch.from_numpy(got))[0].numpy()
    m = _jax_analyze(jnp.asarray(want))
    np.testing.assert_array_equal(status, np.asarray(m.status))
    row = next(r for r in defense_rows if r["cell"] == ("clean" if not sev else f"{name}/{sev}"))
    assert row["flag_rate"] == round(float((status != 0).mean()), 4)
    assert row["blank_rate"] == round(float((status == 2).mean()), 4)
    assert row["corrupted_rate"] == round(float((status == 3).mean()), 4)
    assert abs(row["mean_brightness"] - float(jnp.mean(m.mean_brightness))) <= 0.05 + 1e-3
    # a pixel within the family's bound of a half step can round to the
    # other uint8 level: the entropy moves by a few thousandths at most
    assert abs(row["mean_entropy"] - float(jnp.mean(m.entropy))) <= 0.01


@pytest.mark.parametrize("name", ["snow", "fog"])
def test_defense_random_cells_hold_the_jax_law(name, small_ds, defense_rows):
    """Snow's and fog's draws are Philox's, not ``jax.random``'s: their rows
    against the JAX tool's on the same images within the law's spread:
    flag rates within 4 binomial standard errors (and 2 frames), mean
    brightness within 4% of the range."""
    from fav_tpu.ops.corruptions import apply_corruption
    from fav_tpu.parallel.sweep import cell_key as jax_cell_key

    images = jnp.asarray(small_ds.test_images[:DEFENSE_IMAGES])
    for r in (r for r in defense_rows if r["cell"].startswith(name + "/")):
        sev = int(r["cell"].split("/")[1])
        m = _jax_analyze(apply_corruption(name, jax_cell_key(jax.random.PRNGKey(42), name, sev), images, sev))
        flag = float(jnp.mean(m.status != 0))
        se = np.sqrt(max(flag * (1 - flag), 1.0 / DEFENSE_IMAGES) / DEFENSE_IMAGES)
        assert abs(r["flag_rate"] - flag) <= 4 * se + 2 / DEFENSE_IMAGES, (r, flag)
        assert abs(r["mean_brightness"] - float(jnp.mean(m.mean_brightness))) <= 0.04 * 255, r


def test_defense_markdown_and_json_keys_equal_the_jax_tools(tmp_path, small_ds, defense_rows, monkeypatch):
    from tools import defense_in_depth as jax_tool
    from fav_tpu_torch.tools import defense_in_depth

    assert defense_in_depth.CELLS == jax_tool.CELLS
    assert defense_in_depth.markdown(defense_rows) == jax_tool.markdown(defense_rows)
    assert [r["cell"] for r in defense_rows] == ["clean"] + [f"{n}/{s}" for n, s in jax_tool.CELLS]
    monkeypatch.setattr(defense_in_depth, "load_draw", lambda draw: small_ds)
    out = tmp_path / "d.json"
    rows = defense_in_depth.main(["--draws", "0", "--num-images", "8", "--json", str(out), "--device", "cpu"])
    saved = json.loads(out.read_text())
    assert set(saved) == {"rows", "cells"} and saved["rows"] == rows
    assert set(rows[0]) == {"draw", "cell", "flag_rate", "blank_rate", "corrupted_rate", "mean_anomaly",
                            "mean_brightness", "mean_entropy"}


def test_load_draw_sets_the_draw_and_puts_the_variable_back(monkeypatch):
    from fav_tpu_torch.tools import defense_in_depth

    seen = []
    monkeypatch.setattr(defense_in_depth, "load_cifar10", lambda: seen.append(os.environ["FAV_SYNTH_DRAW"]))
    monkeypatch.delenv("FAV_SYNTH_DRAW", raising=False)
    defense_in_depth.load_draw(2)
    assert seen == ["2"] and "FAV_SYNTH_DRAW" not in os.environ
    monkeypatch.setenv("FAV_SYNTH_DRAW", "1")
    defense_in_depth.load_draw(0)
    assert seen == ["2", "0"] and os.environ["FAV_SYNTH_DRAW"] == "1"


# ── diagnose_weather ──────────────────────────────────────────────────────


@pytest.mark.parametrize("shape", [(6, 32, 32, 3), (3, 24, 40, 3)])
def test_lowfreq_fraction_equals_the_jax_tools(shape, small_ds):
    """On fixed images (synthetic test images, and uniform noise off the
    square): within 1e-6."""
    from tools.diagnose_weather import lowfreq_fraction as jax_lowfreq
    from fav_tpu_torch.tools.diagnose_weather import lowfreq_fraction

    x = np.random.default_rng(5).random(shape, dtype=np.float32)
    if shape[1:3] == (32, 32):
        x[:3] = small_ds.test_images[:3]
    got = lowfreq_fraction(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_lowfreq(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_diagnose_probes_every_view(tmp_path, small_ds):
    from fav_tpu_torch.tools import diagnose_weather

    stem = tiny_copy(tmp_path, "w", 6, temperature=0.9)
    res = diagnose_weather.diagnose(stem, 16, "cpu", small_ds)
    assert res["n"] == 16 and list(res["views"]) == ["clean", "augmix"] + [
        f"{f}_s{s}" for f in ("fog", "snow", "frost", "gaussian_noise") for s in (1, 3, 5)]
    for m in res["views"].values():
        assert abs(sum(m["pred_hist"]) - 1.0) <= 1e-6 and 0 <= m["lowfreq_frac"] <= 1 and 0 <= m["acc"] <= 1
    assert res["views"]["snow_s5"]["lum_mean"] > res["views"]["clean"]["lum_mean"]
    assert res["views"]["fog_s5"]["lowfreq_frac"] > res["views"]["clean"]["lowfreq_frac"]
    assert len(diagnose_weather.table(res["views"]).splitlines()) == 15


# ── quickstart ────────────────────────────────────────────────────────────


def test_quickstart_runs_end_to_end_and_its_replay_equals_fav_tpus(small_ds, capsys):
    """``--steps 5`` on the CPU: the five stages, and the trust replay of
    its scenario equal to ``fav_tpu``'s ``simulate_sequence`` in float32
    (the recurrence in the same order: 1e-6)."""
    from fav_tpu.config import DEFAULT_CONFIG
    from fav_tpu.core.trust_jax import init_carry, simulate_sequence
    from fav_tpu_torch import quickstart

    res = quickstart.main(["--steps", "5", "--device", "cpu"], dataset=small_ds)
    out = capsys.readouterr().out
    assert all(f"[{i}/5]" in out for i in range(1, 6))
    assert sorted(res["grid"]) == sorted(quickstart.SWEEP_CORRUPTIONS)
    assert all(sorted(cells) == [1, 3, 5] for cells in res["grid"].values())
    assert res["temperature"] > 0 and 0 <= res["ece"] <= 1 and 0 <= res["sev5_anomaly"] <= 1
    statuses, anomalies = quickstart.trust_scenario(res["sev5_anomaly"])
    n = len(statuses)
    _, outs = simulate_sequence(DEFAULT_CONFIG.trust, jnp.asarray(statuses, jnp.int32), jnp.asarray(anomalies),
                                jnp.ones(n, bool), jnp.full(n, 1 / 30),
                                init_carry(DEFAULT_CONFIG.trust, dtype=jnp.float32))
    np.testing.assert_allclose(res["reliability"], np.asarray(outs.reliability), atol=1e-6, rtol=0)
    assert res["policy"] == np.asarray(outs.policy).tolist()


# ── the member trainers ───────────────────────────────────────────────────


@pytest.mark.parametrize("tool", ["train_occl_members", "train_student_members"])
def test_member_trainers_pass_the_jax_trainers_flags(tool, monkeypatch, tmp_path):
    """A spy on both packages' ``pretrain.main``: the same recipe flags,
    steps, megastep and seeds, one run per seed, outputs at
    ``OUTDIR/<prefix><seed>``."""
    import importlib

    from fav_tpu.models import pretrain as jax_pretrain
    from fav_tpu_torch.models import pretrain

    calls = {"jax": [], "port": []}
    monkeypatch.setattr(jax_pretrain, "main", lambda argv: calls["jax"].append(argv) or {})
    monkeypatch.setattr(pretrain, "main", lambda argv, dataset=None: calls["port"].append(argv) or {})
    argv = ["--steps", "4", "--megastep", "2", "--seeds", "3,5", "--outdir", str(tmp_path)]
    importlib.import_module(f"tools.{tool}").main(argv)
    importlib.import_module(f"fav_tpu_torch.tools.{tool}").main(argv + ["--device", "cpu"])
    assert len(calls["port"]) == len(calls["jax"]) == 2
    for got, want in zip(calls["port"], calls["jax"]):
        assert got == want + ["--device", "cpu"]
    assert calls["jax"][1][-1] == os.path.join(str(tmp_path), ("occl_m5" if "occl" in tool else "student_m5"))


def test_member_trainer_writes_a_copy_the_stack_reads(tmp_path, small_ds):
    """One seed for one step at a tiny width through the real pretrain: a
    prefix that ``load_weights`` reads."""
    from fav_tpu_torch.models import pretrain
    from fav_tpu_torch.tools import train_occl_members

    real = pretrain.main
    try:
        pretrain.main = lambda argv, dataset=None: real(argv + ["--widths", "8,16", "--batch", "8"], dataset)
        train_occl_members.main(["--steps", "1", "--megastep", "1", "--seeds", "1", "--outdir", str(tmp_path),
                                 "--device", "cpu"], dataset=small_ds)
    finally:
        pretrain.main = real
    model, meta = load_weights("occl_m1", device="cpu", directory=tmp_path)
    assert meta["occlude"] is True and meta["augmix"] is True and meta["widths"] == [8, 16]


# ── backfill_conformal ────────────────────────────────────────────────────


def test_backfill_puts_back_the_jax_qhat(tmp_path, small_ds):
    """A copy of ``student_nano`` with its threshold removed, backfilled by
    the port from ``fav_tpu``'s uniforms, against the JAX tool's recipe
    (``tools/backfill_conformal.py:66-73``: ``fav_tpu``'s forward, its
    temperature, ``calibration_metadata``) on the same set: the qhats agree
    within the bf16 class, and the rest of the metadata is untouched."""
    from fav_tpu_torch.tools import backfill_conformal

    stem = _nano_copy(tmp_path, "nano", drop=("conformal_qhat", "conformal_alpha"))
    stripped = json.loads((tmp_path / "nano.metadata.json").read_text())
    n_val = TEST // 2
    logits = jnp.asarray(jax_nano()(small_ds.test_images[:n_val]))
    want = jconf.calibration_metadata(jax.nn.softmax(logits / stripped["temperature"], axis=-1),
                                      jnp.asarray(small_ds.test_labels[:n_val]))
    got = backfill_conformal.backfill(stem, "cpu", small_ds, u=torch.from_numpy(jax_u(n_val)))
    assert got["conformal_alpha"] == want["conformal_alpha"] == 0.1
    assert abs(got["conformal_qhat"] - want["conformal_qhat"]) <= ss.CONF_ATOL
    assert json.loads((tmp_path / "nano.metadata.json").read_text()) == {**stripped, **got}
    assert backfill_conformal.backfill(stem, "cpu", small_ds) is None  # now it has one


def test_backfill_skips_autoencoders_and_copies_with_a_qhat(tmp_path, capsys):
    from fav_tpu_torch.tools import backfill_conformal

    for ext in (".npz", ".metadata.json"):
        shutil.copy(WEIGHTS_DIR / f"autoencoder{ext}", tmp_path / f"ae{ext}")
    before = (tmp_path / "ae.metadata.json").read_text()
    assert backfill_conformal.backfill(str(tmp_path / "ae"), "cpu") is None
    assert (tmp_path / "ae.metadata.json").read_text() == before
    copies = backfill_conformal.shipped_copies()
    assert {os.path.basename(c) for c in copies} >= {"classifier", "student_compact", "ensemble", "autoencoder"}
    assert backfill_conformal.main(["--device", "cpu"]) == {c: None for c in copies}  # the default run
    assert "autoencoder copy" in capsys.readouterr().out


# ── serving and evaluating the new copies ─────────────────────────────────


def test_student_compact_serves_fav_tpus_rows():
    """``InferenceService(checkpoint_dir=weights/student_compact)`` against
    ``fav_tpu``'s service on its checkpoint, on the serve golden's frames:
    the bf16 class of ``compare_rows``."""
    from fav_tpu.serving.inference import InferenceService as JaxService
    from fav_tpu_torch.models.conformal import aps_all_scores
    from fav_tpu_torch.serving.app import _frame_for_model
    from fav_tpu_torch.serving.inference import InferenceService

    inputs = ss.serve_golden_inputs(_frame_for_model)
    svc = InferenceService(checkpoint_dir=str(WEIGHTS_DIR / "student_compact"), device="cpu")
    rows, probs = svc.score_batch(inputs)
    assert svc.source.endswith("student_compact") and svc.info()["conformal_qhat"] == 0.90689
    jsvc = JaxService(checkpoint_dir=os.path.join(REPO, "fav_tpu", "checkpoints", "student_compact"))
    jsvc._ensure_model()
    want = np.asarray(jsvc._dispatch(list(inputs)), np.float32)[: len(inputs)]
    err = ss.compare_rows(rows, want, aps_all_scores(torch.from_numpy(probs)).numpy(), 0.90689)
    assert err["set_size_max_diff"] <= 1, err


def test_msp_falls_back_to_student_compact(tmp_path, monkeypatch):
    from fav_tpu_torch.serving import inference

    for ext in (".npz", ".metadata.json"):
        shutil.copy(WEIGHTS_DIR / f"student_compact{ext}", tmp_path / f"student_compact{ext}")
    monkeypatch.setattr(inference, "WEIGHTS_DIR", tmp_path)
    svc = inference.InferenceService(device="cpu")
    assert svc._resolve_ckpt_dir() == str(tmp_path / "student_compact")
    svc.score_batch(np.zeros((1, 32, 32, 3), np.float32))
    assert svc.source == f"checkpoint:{tmp_path / 'student_compact'}" and not svc.degraded


def test_evaluate_runs_the_decoupled_deployment(small_ds, monkeypatch):
    """The README's decoupled deployment, ``--checkpoint student_occl_acc
    --monitor student_compact``, both copies found by their stems."""
    from fav_tpu_torch.models import evaluate

    monkeypatch.setenv(evaluate.DEVICE_ENV, "cpu")
    out = evaluate.main(["--checkpoint", "student_occl_acc", "--monitor", "student_compact", "--num-images", "16",
                         "--corruptions", "contrast"], dataset=small_ds)
    assert out["summary"]


def test_tools_golden_matches_the_tools_it_holds():
    """``weights/tools.golden.json`` (written by ``--write``) describes what
    ``chip_smoke.py`` phase 17 runs: the stacked copies' recipes, the refit
    report's keys, the defense rows' cells and the weather probe's views."""
    from fav_tpu_torch.tools import defense_in_depth, diagnose_weather
    from fav_tpu_torch.tools.stack_ensemble import RECIPE_KEYS

    with open(GOLDEN) as f:
        golden = json.load(f)
    assert golden["data_source"] == "synthetic" and golden["test_images"] == 4000
    metas = [json.loads((WEIGHTS_DIR / f"{m}.metadata.json").read_text()) for m in golden["stack"]["members"]]
    assert golden["stack"]["members"] == list(STACK_MEMBERS)
    assert golden["stack"]["metadata"]["member_recipes"] == [{k: m[k] for k in RECIPE_KEYS if k in m} for m in metas]
    assert set(golden["refit"]["report"]) == {"temperature_cleanfit", "temperature_shiftfit", "val_acc_augmented_views",
                                              "ece_clean_val", "ece_augmented_val"}
    assert golden["refit"]["report"]["temperature_cleanfit"] == round(golden["refit"]["t_clean"], 4)
    assert [r["cell"] for r in golden["defense"]["rows"]] == ["clean"] + [f"{n}/{s}" for n, s in defense_in_depth.CELLS]
    assert list(golden["weather"]["views"]) == ["clean", "augmix"] + [
        f"{f}_s{s}" for f in diagnose_weather.FAMILIES for s in diagnose_weather.SEVERITIES]
