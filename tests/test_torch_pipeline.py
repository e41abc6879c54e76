"""The port's fifteen-cell megastep on the CPU against a JAX megastep of
``bench.py``'s ``BENCH_CELLS`` built as ``bench.py:119-134`` builds it, at
batch 16 with the nano student.

The JAX side splits one key over the fifteen cells and corrupts each with
the form ``fast_corruption_fn`` routes it to where that runs on the CPU:
the band-matrix forms of ``corruptions_pallas.py`` for defocus, motion,
zoom, snow, frost and fog; the jnp oracle for the noise families,
brightness, contrast, pixelate, JPEG and elastic (whose Pallas route equals
the oracle given the same fields); and for glass, whose TPU kernel draws
from the TPU's own generator, the composite of ``fav_tpu``'s blur and
``_resample_axis`` fed ``jax.random`` uniforms. Then the eager flax bf16
forward, MSP confidence and ``anomaly_from_confidence``. The port's
megastep is given the same draws wherever a transform takes them, so every
cell but shot noise is held to the bf16 tolerance: per image 0.015 on
confidence (the logits agree within
0.0625, tests/test_torch_models.py; the gap measured here is below 0.004),
which bounds the anomaly by 0.015 x 2.5 / 0.6; the failure rate may move
only by images whose reference confidence lies within 0.015 of the 0.5
threshold.

Shot noise cannot take the oracle's Poisson draws (the port draws by its own
inverse CDF), so that cell is held within a sampling bound: the JAX cell and
the port's cell are each drawn 8 times, and the means of their scalars must
agree within 6 standard deviations of the difference of two 8-draw means,
the deviation estimated from the JAX draws, plus the bf16 tolerance.

The grid's L1 pass (``parallel/sweep.py:l1_rows``) is held to
``fav_tpu.parallel.sweep._l1_rows`` on each cell's corrupted batch:
statuses exact, anomalies within 1e-5 (``fav_tpu`` sums its statistics in
float32, the port exactly; see tests/test_torch_signal.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fav_tpu.models.cnn import FailureAwareCNN as JaxCNN
from fav_tpu.models.uncertainty import anomaly_from_confidence as jax_anomaly
from fav_tpu.ops import corruptions as jc
from fav_tpu.ops import corruptions_pallas as cp
from fav_tpu.ops import image as ji
from fav_tpu.parallel.sweep import _l1_rows as jax_l1_rows
from fav_tpu_torch.ops import corruptions as tc
from fav_tpu_torch.ops import corruptions_cuda as cuda_ops
from fav_tpu_torch.parallel.sweep import l1_rows
from fav_tpu_torch.pipeline import BENCH_CELLS, cell_scalars, entry, make_megastep
from fav_tpu_torch.utils.checkpoint import WEIGHTS_DIR, load_flax_npz, load_student

B = 16
CONF_TOL = 0.015
ANOMALY_TOL = CONF_TOL * 2.5 / 0.6
SHOT_DRAWS = 8


def _nest(flat):
    tree: dict = {}
    for path, v in flat.items():
        a, b = path.split("/")
        tree.setdefault(a, {})[b] = jnp.asarray(v)
    return tree


def _glass_uniforms(key, shape):
    """Six (B, H, W) uniform fields for glass's 3 rounds of row and column passes."""
    return [np.array(jax.random.uniform(k, shape[:3], jnp.float32)) for k in jax.random.split(key, 6)]


def _octaves(key, batch):
    """``_turbulence_matmul``'s key schedule: one split per octave."""
    out = []
    for shape in tc.octave_shapes(batch, 32, 32):
        key, k = jax.random.split(key)
        out.append(np.array(jax.random.uniform(k, shape, jnp.float32)))
    return out


def _jax_cell(name, key, x, severity):
    """One corrupted batch of the JAX megastep (see the module docstring)."""
    if name in ("defocus_blur", "motion_blur", "zoom_blur", "snow", "frost", "fog"):
        return getattr(cp, f"{name}_matmul")(key, x, severity)
    if name == "glass_blur":
        sigma, m, _ = jc.GLASS_SEV[severity - 1]
        y = ji.gaussian_blur_matmul(x, sigma).transpose(0, 3, 1, 2)
        for a, u in enumerate(_glass_uniforms(key, x.shape)):
            y = cp._resample_axis(y, jnp.asarray(u)[:, None], m, axis=2 + a % 2)
        return jnp.clip(ji.gaussian_blur_matmul(y.transpose(0, 2, 3, 1), sigma), 0.0, 1.0)
    return jc.corruption_fn(name)(key, x, severity)


@pytest.fixture(scope="module")
def setup():
    images = np.random.default_rng(11).random((B, 32, 32, 3), dtype=np.float32)
    jmodel = JaxCNN(widths=(16, 32, 64), dense_width=64)
    tree = _nest(load_flax_npz(WEIGHTS_DIR / "student_nano.npz"))
    model, _ = load_student("student_nano", device="cpu")

    def jax_conf(corrupted):
        logits = jmodel.apply({"params": tree}, corrupted)  # eager: see test_torch_models.py
        return np.asarray(jnp.max(jax.nn.softmax(logits, axis=-1), axis=-1), np.float32)

    key = jax.random.PRNGKey(42)
    keys = jax.random.split(key, len(BENCH_CELLS))  # as bench.py's megastep
    x = jnp.asarray(images)
    ref_conf = {name: jax_conf(_jax_cell(name, k, x, sev)) for (name, sev), k in zip(BENCH_CELLS, keys)}
    shot_sev = dict(BENCH_CELLS)["shot_noise"]
    shot_draws = [jax_conf(jc.corruption_fn("shot_noise")(k, x, shot_sev))
                  for k in jax.random.split(jax.random.PRNGKey(7), SHOT_DRAWS)]
    draws = dict(zip([n for n, _ in BENCH_CELLS], keys))
    return images, model, ref_conf, shot_draws, draws


def _scalars(conf: np.ndarray) -> np.ndarray:
    return np.array([conf.mean(), np.asarray(jax_anomaly(jnp.asarray(conf)), np.float32).mean(),
                     (conf < 0.5).mean()], np.float64)


def _oracle_draw_router(images, draws):
    """Families fed fav_tpu's own draws: ``fn(seed, x, severity)`` ignoring the seed."""
    shape = images.shape
    b = shape[0]

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    def route(name):
        key = draws.get(name)
        if name == "gaussian_noise":
            z = t(jax.random.normal(key, shape, jnp.float32))
            return lambda seed, x, sev: tc.gaussian_from_normal(x, z, sev)
        if name == "impulse_noise":
            k1, _ = jax.random.split(key)
            u = t(jax.random.uniform(k1, shape, jnp.float32))
            return lambda seed, x, sev: tc.impulse_from_uniform(x, u, sev)
        # make_megastep hands glass and elastic ``packed``; packing moves no
        # value (tests/test_torch_packed.py), so the oracle forms serve both arms
        if name == "glass_blur":
            us = [t(u) for u in _glass_uniforms(key, shape)]
            return lambda seed, x, sev, packed=False: tc.glass_blur_with(
                x, sev, lambda y, m, iters: tc.glass_resample_from_uniforms(y, us, m))
        if name == "motion_blur":
            idx = int(jax.random.randint(key, (), 0, 8))
            return lambda seed, x, sev: tc.motion_from_index(x, idx, sev)
        if name == "snow":
            k1, _ = jax.random.split(key)
            z = t(jax.random.normal(k1, (b, 32, 32, 1), jnp.float32))
            return lambda seed, x, sev: tc.snow_from_normal(x, z, sev)
        if name in ("frost", "fog"):
            octaves = [t(o) for o in _octaves(key, b)]
            transform = tc.frost_from_octaves if name == "frost" else tc.fog_from_octaves
            return lambda seed, x, sev: transform(x, octaves, sev)
        if name == "elastic_transform":
            def elastic(seed, x, sev, packed=False):
                ys, xs = jc._elastic_fields(key, jnp.asarray(x.numpy()), sev)
                return tc.elastic_from_fields(x, t(ys), t(xs), sev)
            return elastic
        # shot: the port's own draws; the rest draw nothing
        return cuda_ops.corruption_fn(name)

    return route


def _deterministic_bound(ref_conf: np.ndarray) -> np.ndarray:
    near = np.abs(ref_conf - 0.5) <= CONF_TOL
    return np.array([CONF_TOL, ANOMALY_TOL, near.mean() + 1e-9])


def _shot_bound(shot_draws) -> np.ndarray:
    """For the mean over SHOT_DRAWS draws of the port's cell against the mean
    over as many of the JAX cell's."""
    rows = np.stack([_scalars(c) for c in shot_draws])
    sd = rows.std(axis=0, ddof=1) * np.sqrt(2 / len(shot_draws))
    return 6 * sd + np.array([CONF_TOL, ANOMALY_TOL, 1 / B])


@pytest.mark.parametrize("name", [n for n, _ in BENCH_CELLS if n != "shot_noise"])
def test_cell_fed_oracle_draws_matches_jax(setup, name):
    images, model, ref_conf, _, draws = setup
    sev = dict(BENCH_CELLS)[name]
    x = torch.from_numpy(images)
    corrupted = _oracle_draw_router(images, draws)(name)(0, x, sev)
    with torch.no_grad():
        conf = torch.softmax(model(corrupted), -1).amax(-1).numpy()
        got = cell_scalars(model, corrupted).numpy()
    np.testing.assert_allclose(conf, ref_conf[name], atol=CONF_TOL, rtol=0)
    assert (np.abs(got - _scalars(ref_conf[name])) <= _deterministic_bound(ref_conf[name])).all()


def test_shot_cell_within_sampling_bound(setup):
    images, model, _, shot_draws, _ = setup
    ref = np.stack([_scalars(c) for c in shot_draws]).mean(axis=0)
    x = torch.from_numpy(images)
    with torch.no_grad():
        got = np.stack([cell_scalars(model, cuda_ops.shot_noise(1234 + i, x, 3)).numpy()
                        for i in range(SHOT_DRAWS)]).mean(axis=0)
    assert (np.abs(got - ref) <= _shot_bound(shot_draws)).all(), (got, ref)


def test_megastep_matches_jax_megastep(setup):
    """The [3] vector: mean confidence, mean anomaly, failure rate over the
    fifteen cells, within the mean of the cells' bounds."""
    images, model, ref_conf, shot_draws, draws = setup
    step = make_megastep(model, BENCH_CELLS, "cpu", corruption_fn=_oracle_draw_router(images, draws))
    got = step(torch.from_numpy(images), torch.Generator().manual_seed(0)).numpy()
    ref = np.stack([_scalars(ref_conf[name]) for name, _ in BENCH_CELLS]).mean(axis=0)
    # one port draw against the mean of the JAX draws: twice the variance
    # the 8-against-8 bound assumes, at most, so the shot bound doubles
    bound = np.stack([2 * _shot_bound(shot_draws) if name == "shot_noise" else _deterministic_bound(ref_conf[name])
                      for name, _ in BENCH_CELLS]).mean(axis=0)
    assert got.shape == (3,) and np.isfinite(got).all()
    assert (np.abs(got - ref) <= bound).all(), (got, ref, bound)


def test_megastep_is_reproducible_from_its_generator(setup):
    images, model, _, _, _ = setup
    x = torch.from_numpy(images)
    step = make_megastep(model, BENCH_CELLS, "cpu")
    cuda_ops.reset_launch_counts()
    a = step(x, torch.Generator().manual_seed(5))
    b = step(x, torch.Generator().manual_seed(5))
    c = step(x, torch.Generator().manual_seed(6))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    assert ((a >= 0) & (a <= 1)).all()
    assert sum(cuda_ops.launch_counts().values()) == 0  # CPU tensors take the plain versions


def test_megastep_refuses_images_on_another_device(setup):
    _, model, _, _, _ = setup
    step = make_megastep(model, BENCH_CELLS, "cpu")
    with pytest.raises(ValueError):
        step(torch.zeros((2, 32, 32, 3), device="meta"), torch.Generator().manual_seed(0))


def test_entry_runs_on_the_cpu_when_asked():
    fn, (images, seed) = entry(device="cpu")
    assert images.shape == (256, 32, 32, 3) and images.device.type == "cpu"
    out = fn(images[:4] + 0.5, seed)
    assert set(out) == {"prediction", "confidence", "anomaly"}
    assert out["prediction"].shape == (4,) and out["prediction"].dtype == torch.int64
    conf = out["confidence"]
    assert ((conf > 0) & (conf <= 1)).all() and ((out["anomaly"] >= 0) & (out["anomaly"] <= 1)).all()


# ── the grid's L1 pass ─────────────────────────────────────────────────────

L1_ANOMALY_ATOL = 1e-5


@pytest.mark.parametrize("name", [n for n, _ in BENCH_CELLS])
def test_l1_rows_match_fav_tpu(setup, name):
    images, _, _, _, draws = setup
    corrupted = _jax_cell(name, draws[name], jnp.asarray(images), dict(BENCH_CELLS)[name])
    want_status, want_anomaly = jax_l1_rows(corrupted)
    cuda_ops.reset_launch_counts()
    status, anomaly = l1_rows(torch.from_numpy(np.array(corrupted, np.float32)))
    assert sum(cuda_ops.launch_counts().values()) == 0  # the CPU takes the plain versions
    assert status.dtype == torch.int32 and status.shape == (B,)
    np.testing.assert_array_equal(status.numpy(), np.asarray(want_status))
    np.testing.assert_allclose(anomaly.numpy(), np.asarray(want_anomaly, np.float32), atol=L1_ANOMALY_ATOL, rtol=0)


def test_l1_rows_round_half_to_even_and_see_each_status():
    """Levels on .5 ties round to even as ``jnp.round`` does; black, white
    and flat images give BLANK, BLANK and CORRUPTED (entropy 0)."""
    rng = np.random.default_rng(12)
    ties = np.float32((np.arange(32 * 32 * 3) % 255 + 0.5) / 255.0).reshape(1, 32, 32, 3)
    x = np.concatenate([
        ties,
        np.zeros((1, 32, 32, 3), np.float32),
        np.ones((1, 32, 32, 3), np.float32),
        np.full((1, 32, 32, 3), 0.5, np.float32),
        rng.random((1, 32, 32, 3), dtype=np.float32),
    ])
    status, anomaly = l1_rows(torch.from_numpy(x))
    want_status, want_anomaly = jax_l1_rows(jnp.asarray(x))
    np.testing.assert_array_equal(status.numpy(), np.asarray(want_status))
    np.testing.assert_allclose(anomaly.numpy(), np.asarray(want_anomaly, np.float32), atol=L1_ANOMALY_ATOL, rtol=0)
    assert status[1:4].tolist() == [2, 2, 3]
    frames = torch.round(torch.from_numpy(x[:1]).flip(-1) * 255.0).to(torch.uint8)
    np.testing.assert_array_equal(frames.numpy(),
                                  np.asarray(jnp.round(jnp.asarray(x[:1])[..., ::-1] * 255.0).astype(jnp.uint8)))
