"""The lane-packed glass and elastic kernels (K5p, K6p) of the port against
``fav_tpu``'s packed Pallas kernels, and the packed A/B path: the wrappers'
``packed`` route, ``make_megastep(packed=True)`` and
``fav_tpu_torch.tools.ab_packed_kernels``. Batch 8 or less, 32x32x3.

Tolerance classes:

* exact: ``packed_group`` against a table of the reference's rule
  (``corruptions_pallas.py:368-370``, ``:545-547``); the packed plain glass
  against ``glass_resample_from_uniforms`` given the same uniforms (pure
  selection); the packed plain glass fed zero uniforms against
  ``glass_resample_pallas(..., interpret=True, packed=True)``: CPU
  interpret mode stubs the TPU's generator to zero bits, so every offset
  there is -m (``corruptions_pallas.py:183-185``), and a zero uniform gives
  code 0, the same offset; the packed plain elastic against
  ``elastic_from_fields`` given the same fields (the same taps in the same
  order); the CPU wrappers against the plain versions; the megastep's and
  the A/B's packed arms against their unpacked arms;
* ``WARP_TOL`` = 1e-6: the packed plain elastic given the fields of the
  jitted ``_elastic_fields`` against ``elastic_transform_pallas(...,
  interpret=True, packed=True)``, which makes its fields under its own jit:
  XLA may contract a multiply and an add into one rounding, as for the
  unpacked kernel (``tests/test_torch_families.py``, observed 1.2e-7).
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fav_tpu.ops import corruptions as jc
from fav_tpu.ops import corruptions_pallas as cp
from fav_tpu_torch.ops import corruptions as tc
from fav_tpu_torch.ops import corruptions_cuda as cuda_ops
from fav_tpu_torch.pipeline import make_megastep
from fav_tpu_torch.tools import ab_packed_kernels as ab
from fav_tpu_torch.utils.checkpoint import load_student

REPO = Path(__file__).resolve().parents[1]
WARP_TOL = 1e-6


def _images(seed: int, batch: int) -> np.ndarray:
    return np.random.default_rng(seed).random((batch, 32, 32, 3), dtype=np.float32)


def _wp(severity: int) -> int:
    return 32 + 2 * (tc.elastic_margin(severity) + 1)


@pytest.mark.parametrize("seg,batch,g", [
    (32, 6144, 4), (32, 8, 4), (32, 6, 3), (32, 5, 1), (32, 3, 3),  # glass, W = 32
    (_wp(3), 6144, 3), (_wp(3), 8, 2), (_wp(3), 7, 1),  # elastic severity 3, wp = 42
    (_wp(5), 6144, 2),  # elastic severity 5, wp = 46
])
def test_packed_group_follows_the_reference_rule(seg, batch, g):
    assert (_wp(3), _wp(5)) == (42, 46)
    assert tc.packed_group(batch, seg) == g


@pytest.mark.parametrize("m,iters", [(2, 3), (4, 2)])
@pytest.mark.parametrize("batch", [8, 6, 3])
def test_packed_glass_equals_unpacked_given_the_same_uniforms(batch, m, iters):
    x = torch.from_numpy(_images(10 + batch, batch))
    rng = np.random.default_rng(20 + batch + m)
    us = [torch.from_numpy(rng.random((batch, 32, 32), dtype=np.float32)) for _ in range(2 * iters)]
    g = tc.packed_group(batch, 32)
    assert g > 1
    got = tc.glass_resample_packed_from_uniforms(x, us, m, g)
    np.testing.assert_array_equal(got.numpy(), tc.glass_resample_from_uniforms(x, us, m).numpy())
    assert not torch.equal(got, x)


@pytest.mark.parametrize("batch", [8, 6])
def test_packed_glass_equals_pallas_packed_interpret(batch):
    x = _images(30 + batch, batch)
    m, iters = 2, 3
    us = [torch.zeros(batch, 32, 32) for _ in range(2 * iters)]
    got = tc.glass_resample_packed_from_uniforms(torch.from_numpy(x), us, m, tc.packed_group(batch, 32))
    want = cp.glass_resample_pallas(jnp.int32(3), jnp.asarray(x), m, iters, interpret=True, packed=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("severity", [3, 5])
@pytest.mark.parametrize("batch", [6, 8])
def test_packed_elastic_equals_pallas_packed_interpret(batch, severity):
    x = _images(40 + batch, batch)
    xj = jnp.asarray(x)
    key = jax.random.PRNGKey(900 + severity)
    ys, xs = jax.jit(jc._elastic_fields, static_argnums=2)(key, xj, severity)
    ys = torch.from_numpy(np.array(ys, np.float32))
    xs = torch.from_numpy(np.array(xs, np.float32))
    g = tc.packed_group(batch, _wp(severity))
    assert g > 1
    got = tc.elastic_from_fields_packed(torch.from_numpy(x), ys, xs, severity, g)
    want = cp.elastic_transform_pallas(key, xj, severity, interpret=True, packed=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=WARP_TOL, rtol=0)
    np.testing.assert_array_equal(got.numpy(), tc.elastic_from_fields(torch.from_numpy(x), ys, xs, severity).numpy())


def test_packed_wrappers_take_the_plain_versions_on_the_cpu(monkeypatch):
    x = torch.from_numpy(_images(50, 8))
    ys, xs = tc.elastic_fields(4, x, 3)
    cuda_ops.reset_launch_counts()
    got = cuda_ops.glass_resample(7, x, 2, 3, packed=True)
    np.testing.assert_array_equal(got.numpy(), tc.glass_resample_packed_plain(7, x, 2, 3).numpy())
    np.testing.assert_array_equal(got.numpy(), tc.glass_resample_plain(7, x, 2, 3).numpy())
    got = cuda_ops.elastic_warp(x, ys, xs, 3, packed=True)
    np.testing.assert_array_equal(got.numpy(), tc.elastic_from_fields_packed(x, ys, xs, 3, 2).numpy())
    for name in ("glass_blur", "elastic_transform"):
        fn = cuda_ops.corruption_fn(name)
        np.testing.assert_array_equal(fn(8, x, 3, packed=True).numpy(), fn(8, x, 3).numpy())
        np.testing.assert_array_equal(tc.corruption_fn(name)(8, x, 3, packed=True).numpy(), fn(8, x, 3).numpy())
    assert sum(cuda_ops.launch_counts().values()) == 0
    # G = 1 (batch 5 at W = 32, batch 7 at wp = 42) takes the unpacked versions, as the reference does
    for fn in ("glass_resample_packed_plain", "elastic_from_fields_packed"):
        monkeypatch.setattr(tc, fn, None)
    x5 = x[:5].contiguous()
    np.testing.assert_array_equal(cuda_ops.glass_resample(7, x5, 2, 3, packed=True).numpy(),
                                  tc.glass_resample_plain(7, x5, 2, 3).numpy())
    x7, ys7, xs7 = x[:7].contiguous(), ys[:7].contiguous(), xs[:7].contiguous()
    np.testing.assert_array_equal(cuda_ops.elastic_warp(x7, ys7, xs7, 3, packed=True).numpy(),
                                  tc.elastic_from_fields(x7, ys7, xs7, 3).numpy())


def test_packed_wrappers_check_their_input():
    x = torch.from_numpy(_images(51, 8))
    ys, xs = tc.elastic_fields(4, x, 3)
    with pytest.raises(TypeError):
        cuda_ops.glass_resample(1, x.double(), 2, 3, packed=True)
    with pytest.raises(ValueError):
        cuda_ops.glass_resample(1, x[0], 2, 3, packed=True)  # not NHWC
    with pytest.raises(ValueError):
        cuda_ops.glass_resample(1, x, 128, 1, packed=True)  # a code would not fit its byte
    with pytest.raises(ValueError):
        cuda_ops.elastic_warp(x, ys[:, :16], xs, 3, packed=True)  # field of another shape
    with pytest.raises(ValueError):
        cuda_ops.elastic_warp(x, ys, xs.transpose(1, 2), 3, packed=True)  # not contiguous
    with pytest.raises(ValueError):
        cuda_ops.elastic_warp(x, ys, xs, 6, packed=True)  # severity out of range


def test_megastep_packed_arm_reaches_the_packed_route(monkeypatch):
    """A spy on the router records what each cell is given; counters on
    the packed plain versions show the packed route ran."""
    cells = (("gaussian_noise", 3), ("glass_blur", 3), ("elastic_transform", 3))
    model, _ = load_student("student_nano", device="cpu")
    x = torch.from_numpy(_images(52, 8))
    given, ran = [], {"glass_resample_packed_plain": 0, "elastic_from_fields_packed": 0}

    def spy_router(name):
        fn = cuda_ops.corruption_fn(name)

        def routed(seed, images, severity, **kw):
            given.append((name, kw))
            return fn(seed, images, severity, **kw)
        return routed

    for name in ran:
        real = getattr(tc, name)

        def counted(*args, _real=real, _name=name):
            ran[_name] += 1
            return _real(*args)
        monkeypatch.setattr(tc, name, counted)

    outs = {}
    for packed in (True, False):
        given.clear()
        ran.update({k: 0 for k in ran})
        step = make_megastep(model, cells, "cpu", corruption_fn=spy_router, packed=packed)
        outs[packed] = step(x, torch.Generator().manual_seed(3))
        assert given == [("gaussian_noise", {}), ("glass_blur", {"packed": packed}),
                         ("elastic_transform", {"packed": packed})]
        assert ran == {k: int(packed) for k in ran}
    torch.testing.assert_close(outs[True], outs[False], rtol=0, atol=0)


def _reference_arm_names() -> list[str]:
    """The arm names of ``tools/ab_packed_kernels.py``, in its order."""
    src = (REPO / "tools" / "ab_packed_kernels.py").read_text()
    sevs = [int(s) for s in re.search(r"for sev in \(([\d, ]+)\)", src).group(1).split(",")]
    patterns = re.findall(r'arms\[f"(\w+)_sev\{sev\}_(\w+)"\]', src)
    assert len(patterns) == 4
    return [f"{family}_sev{sev}_{arm}" for sev in sevs for family, arm in patterns]


def test_run_ab_prints_the_reference_arm_names(capsys):
    names = _reference_arm_names()
    report = ab.run_ab(device="cpu", batch=8, iters=1)
    printed = capsys.readouterr().out
    assert all(f"warm {name}:" in printed for name in names)
    assert list(report["median_ms"]) == names
    assert all(v > 0 for v in report["median_ms"].values())
    assert report["device"] == "cpu" and report["batch"] == 8
    assert all(r["equal"] and r["max_abs_diff"] == 0.0 for r in report["packed_equals_unpacked"].values())
    assert "ab_packed" not in report


def test_ab_cli_megastep_arms_on_the_cpu(capsys):
    ab.main(["--device", "cpu", "--batch", "8", "--iters", "1", "--megastep"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    mega = report["ab_packed"]
    assert mega["max_abs_diff"] == 0.0 and mega["packed"]["out"] == mega["unpacked"]["out"]
    for arm in ("packed", "unpacked"):
        assert mega[arm]["ms_per_megastep"] > 0 and mega[arm]["img_per_sec"] > 0
        assert sum(mega[arm]["launches"].values()) == 0  # CPU tensors take the plain versions


def test_run_ab_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ab.run_ab(batch=8, iters=1)
