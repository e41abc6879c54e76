"""The port's serving scores against ``fav_tpu``'s, on the CPU.

* ``max_softmax_probability`` (with a temperature), ``predictive_entropy``,
  ``mutual_information``, ``prediction_sets`` (APS and LAC, with and
  without a rank penalty) and ``set_sizes`` against ``fav_tpu``'s on the
  same numpy inputs. Tolerance class: reassociation, ≤3e-6 on the floats;
  memberships and sizes exact wherever no score lies within 3e-6 of qhat.
* The ``InferenceService`` rows of both deployments (``msp`` on
  ``student_nano``; ``gated``: ``student_std`` predicting, ``student_nano``
  monitoring) against ``fav_tpu``'s ``InferenceService`` on the same
  frames. Tolerance class: the bf16 forward, against ``fav_tpu``'s jitted
  forward (XLA fuses a conv with its bias there and skips a bf16 rounding
  that the port, like flax's eager forward, keeps), as
  ``fav_tpu_torch/tools/scripted_serve.py:compare_rows`` states it and
  ``chip_smoke.py`` applies it on the card: argmax equal; the confidences
  within ``CONF_ATOL`` (0.05), the anomaly within 2.5 / 0.6 of that, the
  entropy within ``ENTROPY_ATOL`` (0.1); the mutual information within
  ``MI_ATOL`` (1e-6) of ``fav_tpu``'s 0 (one member: 0 in exact
  arithmetic); set sizes equal, or apart by no more classes than have an
  APS score within ``CONF_ATOL`` of qhat. On the CPU the rows part by at most 0.0154
  in a confidence and 0.027 in an entropy, and ``test_rows_on_the_cpu_stay_
  well_inside`` holds them to a third of the bounds.
* The ``mc_dropout``, ``ensemble`` and ``autoencoder`` modes on their
  default weights (``classifier``, ``ensemble``, ``autoencoder``) against
  ``fav_tpu``'s service on the same frames, by
  ``scripted_serve.compare_served_rows``: the bf16 class for the ensemble
  (its mutual information as an entropy, near-ties of its mean allowed),
  the reconstruction error within ``AE_ERR_RTOL`` (relative) for the
  autoencoder, and for MC dropout, whose masks are another draw of the
  same law, sampling bounds over the port's 20 replicas.
* The service's contract: a Mahalanobis fit adds the feature distance
  (``tests/test_torch_maha_serving.py``), a missing monitor fails the service, missing
  weights serve random weights marked degraded, unloadable weights say so
  (msp) or raise (the other modes), an ensemble of another member count
  raises, and one batch is one copy to the host.

``fav_tpu_torch/weights/serve.golden.json`` holds ``fav_tpu``'s rows of both
deployments for the fixed frames of
``fav_tpu_torch.tools.scripted_serve.serve_golden_inputs``, the final
states the JAX app reaches when ``drive_lockstep`` runs its live path on
the 32 scripted streams for 60 ticks, the keys of the first state its
``/ws`` streams, and the JAX playground replay of ``PLAYGROUND_EVENTS``.
``chip_smoke.py`` holds the card to it. Run as a script with ``--write`` to
regenerate it (``--write mc_dropout ensemble autoencoder`` rewrites only
those deployments' entries):

    JAX_PLATFORMS=cpu python tests/test_torch_inference.py --write

``tests/test_torch_weights.py`` pins it against a fresh JAX run.
"""

from __future__ import annotations

import asyncio
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from fav_tpu_torch.tools.scripted_serve import PLAYGROUND_EVENTS, SERVE_TICKS, serve_golden_inputs  # noqa: E402

GOLDEN = os.path.join(REPO, "fav_tpu_torch", "weights", "serve.golden.json")
JAX_CKPT = os.path.join(REPO, "fav_tpu", "checkpoints")
PORT_WEIGHTS = os.path.join(REPO, "fav_tpu_torch", "weights")
DEPLOYMENTS = {
    # name: (predictor, monitor) under each package's checkpoints
    "msp": (None, None),
    "gated": ("student_std", "student_nano"),
}
# the other uncertainty modes, each on its default weights (classifier,
# ensemble, autoencoder): a deployment of the same name
MODES = ("mc_dropout", "ensemble", "autoencoder")
REASSOC_ATOL = 3e-6


def jax_service(name: str):
    """``fav_tpu``'s InferenceService of a deployment or a mode, built (not
    started)."""
    from fav_tpu.serving.inference import InferenceService

    if name in MODES:
        svc = InferenceService(uncertainty=name)
    else:
        pred, mon = DEPLOYMENTS[name]
        svc = InferenceService(checkpoint_dir=os.path.join(JAX_CKPT, pred) if pred else None,
                               monitor_dir=os.path.join(JAX_CKPT, mon) if mon else None)
    svc._ensure_model()
    assert svc.source.startswith("checkpoint:"), svc.source
    return svc


def port_service(name: str, **kw):
    from fav_tpu_torch.serving.inference import InferenceService

    if name in MODES:
        return InferenceService(uncertainty=name, device="cpu", **kw)
    pred, mon = DEPLOYMENTS[name]
    return InferenceService(checkpoint_dir=os.path.join(PORT_WEIGHTS, pred) if pred else None,
                            monitor_dir=os.path.join(PORT_WEIGHTS, mon) if mon else None, device="cpu", **kw)


def jax_rows(name: str, inputs: np.ndarray) -> np.ndarray:
    """The first batch ``fav_tpu``'s service dispatches (for mc_dropout:
    the masks of ``fold_in(PRNGKey(7), 1)``)."""
    svc = jax_service(name)
    return np.asarray(svc._dispatch(list(inputs)), np.float32)[: len(inputs)]


def golden_inputs() -> np.ndarray:
    from fav_tpu_torch.serving.app import _frame_for_model

    return serve_golden_inputs(_frame_for_model)


def jax_lockstep_states(name: str, streams: list[int]) -> list[dict]:
    """The final states of ``fav_tpu``'s app on the scripted streams
    ``streams`` (indices into ``MONITOR_STREAMS``), driven in lockstep with
    its AnalysisService (240x320, capacity 64) and the deployment's
    InferenceService."""
    from fav_tpu.config import DEFAULT_CONFIG
    from fav_tpu.serving import app as japp
    from fav_tpu.serving.analysis import AnalysisService
    from fav_tpu_torch.sim.frames import MONITOR_STREAMS, scripted_stream
    from fav_tpu_torch.tools.scripted_serve import drive_lockstep, final_states, warm_services

    clips = [scripted_stream(*MONITOR_STREAMS[j], SERVE_TICKS) for j in streams]

    async def run():
        inference = jax_service(name)
        analysis = AnalysisService(DEFAULT_CONFIG.analyzer, height=240, width=320, capacity=64)
        await warm_services(inference, analysis)
        conns = []
        for _ in clips:
            c = japp.ConnectionState(DEFAULT_CONFIG)
            c.inference, c.analysis = inference, analysis
            conns.append(c)
        states = await drive_lockstep(japp, conns, clips)
        await inference.close()
        await analysis.close()
        return final_states(states)

    return asyncio.run(run())


def jax_ws_state_keys() -> list[str]:
    """The keys of the first state ``fav_tpu``'s app streams on ``/ws``
    (simulation mode), read over a socket with the ``websockets`` client."""
    import socket

    import websockets

    from fav_tpu.config import DEFAULT_CONFIG, ServerParams
    from fav_tpu.serving.app import create_app

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]

    async def run():
        cfg = DEFAULT_CONFIG.replace(server=ServerParams(host="127.0.0.1", port=port, model_scoring=False,
                                                         batched_analysis=False))
        srv = await create_app(cfg).serve("127.0.0.1", port)
        try:
            async with websockets.connect(f"ws://127.0.0.1:{port}/ws", open_timeout=10) as ws:
                return sorted(json.loads(await asyncio.wait_for(ws.recv(), 10)))
        finally:
            srv.close()
            await srv.wait_closed()

    return asyncio.run(run())


def write(names=()) -> None:
    """Rewrite the golden, or with ``names`` only those deployments'
    entries of the committed one."""
    from fav_tpu.config import DEFAULT_CONFIG
    from fav_tpu.serving.app import run_playground_sequence
    from fav_tpu_torch.sim.frames import MONITOR_STREAMS

    inputs = golden_inputs()
    if names:
        with open(GOLDEN) as f:
            golden = json.load(f)
    else:
        golden = {
            "about": "fav_tpu's InferenceService rows on serve_golden_inputs(), its app's final states on the "
                     "scripted streams in lockstep, its playground replay; written by "
                     "tests/test_torch_inference.py --write",
            "inputs": "fav_tpu_torch.tools.scripted_serve.serve_golden_inputs(app._frame_for_model)",
            "columns": ["prediction", "confidence", "model_anomaly", "entropy", "mutual_information",
                        "conformal_set_size", "confidence_self"],
            "ticks": SERVE_TICKS,
            "streams": [list(s) for s in MONITOR_STREAMS],
            "ws_state_keys": jax_ws_state_keys(),
            "deployments": {},
            "playground": {"events": list(PLAYGROUND_EVENTS),
                           "results": run_playground_sequence(list(PLAYGROUND_EVENTS), DEFAULT_CONFIG)},
        }
    for name in names or (*DEPLOYMENTS, *MODES):
        rows = jax_rows(name, inputs)
        pred, mon = DEPLOYMENTS.get(name, (None, None))
        golden["deployments"][name] = {
            "predictor": jax_service(name).source.split("/")[-1] if name in MODES else pred or "student_nano",
            "monitor": mon,
            "rows": [[float(f"{v:.9g}") for v in row] for row in rows.astype(np.float64)],
            "states": jax_lockstep_states(name, list(range(len(MONITOR_STREAMS)))),
        }
    with open(GOLDEN, "w") as f:
        json.dump(golden, f, indent=1)
        f.write("\n")
    print(f"wrote {GOLDEN}")


if __name__ == "__main__":
    if "--write" not in sys.argv[1:]:
        sys.exit("usage: python tests/test_torch_inference.py --write")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)  # the playground's float64, as fav_tpu's server sets it
    write([a for a in sys.argv[1:] if a != "--write"])
    sys.exit(0)

import pytest  # noqa: E402
import torch  # noqa: E402

from fav_tpu.models import conformal as jconf  # noqa: E402
from fav_tpu.models import uncertainty as junc  # noqa: E402
from fav_tpu_torch.models import conformal as tconf  # noqa: E402
from fav_tpu_torch.models import uncertainty as tunc  # noqa: E402
from fav_tpu_torch.models.conformal import aps_all_scores  # noqa: E402
from fav_tpu_torch.serving.inference import DEFAULT_WEIGHTS  # noqa: E402
from fav_tpu_torch.tools import scripted_serve as ss  # noqa: E402


def _logits(seed: int, shape=(16, 10), scale=3.0) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _probs(seed: int, shape=(16, 10)) -> np.ndarray:
    """Softmax rows with a few exact zeros and a few ties."""
    p = np.asarray(torch.softmax(torch.from_numpy(_logits(seed, shape)), -1))
    p[0, :3] = 0.0
    p[1, 2] = p[1, 5]
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def _j(x):
    import jax.numpy as jnp

    return jnp.asarray(x)


@pytest.mark.parametrize("temperature", [1.0, 1.1526, 0.7])
def test_max_softmax_probability_matches(temperature):
    x = _logits(1)
    got = tunc.max_softmax_probability(torch.from_numpy(x), temperature).numpy()
    want = np.asarray(junc.max_softmax_probability(_j(x), temperature), np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=REASSOC_ATOL)


@pytest.mark.parametrize("seed", [2, 3])
def test_predictive_entropy_matches(seed):
    p = _probs(seed)
    got = tunc.predictive_entropy(torch.from_numpy(p)).numpy()
    want = np.asarray(junc.predictive_entropy(_j(p)), np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=REASSOC_ATOL)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("members", [1, 5])
def test_mutual_information_matches(members):
    p = np.stack([_probs(10 + m) for m in range(members)])
    got = tunc.mutual_information(torch.from_numpy(p)).numpy()
    want = np.asarray(junc.mutual_information(_j(p)), np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=REASSOC_ATOL)
    if members == 1:
        assert np.abs(got).max() <= ss.MI_ATOL  # one member: 0 in exact arithmetic


@pytest.mark.parametrize("score,rank_penalty,k_reg", [("aps", 0.0, 1), ("aps", 0.05, 2), ("lac", 0.0, 1)])
@pytest.mark.parametrize("qhat", [0.5, 0.90856, 0.99])
def test_prediction_sets_and_sizes_match(score, rank_penalty, k_reg, qhat):
    """Memberships and sizes exact wherever no score lies within
    REASSOC_ATOL of qhat (the sorts tie-break alike: stable, by index)."""
    p = _probs(20 + int(qhat * 100))
    kw = {"rank_penalty": rank_penalty, "k_reg": k_reg} if score == "aps" else {}
    got = tconf.prediction_sets(torch.from_numpy(p), qhat, score=score, **kw).numpy()
    want = np.asarray(jconf.prediction_sets(_j(p), qhat, score=score, **kw))
    scores = (aps_all_scores(torch.from_numpy(p), rank_penalty, k_reg).numpy() if score == "aps" else 1.0 - p)
    if score == "aps":
        np.testing.assert_allclose(scores, np.asarray(jconf.aps_all_scores(_j(p), None, rank_penalty, k_reg)),
                                   rtol=0, atol=REASSOC_ATOL)
    clear = np.abs(scores - qhat).min(-1) > REASSOC_ATOL
    assert clear.sum() >= len(p) - 2
    np.testing.assert_array_equal(got[clear], want[clear])
    sizes = tconf.set_sizes(torch.from_numpy(got)).numpy()
    assert sizes.dtype == np.int32
    np.testing.assert_array_equal(sizes, np.asarray(jconf.set_sizes(_j(got))))
    if score == "aps":
        assert (sizes >= 1).all()  # never empty: the argmax is forced in


def test_prediction_sets_refuses_unknown_score():
    with pytest.raises(ValueError, match="unknown conformal score"):
        tconf.prediction_sets(torch.from_numpy(_probs(0)), 0.9, score="raps")


@pytest.fixture(scope="module")
def serve_golden():
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def inputs():
    return golden_inputs()


def _port_rows(name: str, inputs: np.ndarray):
    svc = port_service(name)
    rows, probs = svc.score_batch(inputs)
    return svc, rows, aps_all_scores(torch.from_numpy(probs)).numpy()


@pytest.mark.parametrize("name", list(DEPLOYMENTS))
def test_rows_match_fav_tpu_service(name, inputs):
    """The port's packed rows against a fresh run of fav_tpu's service on
    the same frames (the bf16 class of compare_rows)."""
    svc, rows, scores = _port_rows(name, inputs)
    assert rows.shape == (len(inputs), 7 if name == "gated" else 6) and rows.dtype == np.float32
    err = ss.compare_rows(rows, jax_rows(name, inputs), scores, svc.info().get("conformal_qhat"))
    assert err["set_size_max_diff"] <= 1, err


@pytest.mark.parametrize("name", list(DEPLOYMENTS))
def test_rows_on_the_cpu_stay_well_inside(name, inputs, serve_golden):
    """On the CPU the port stays within a third of the card's bounds of the
    committed golden, so the bounds are room for cuDNN, not for a fault."""
    svc, rows, scores = _port_rows(name, inputs)
    want = np.asarray(serve_golden["deployments"][name]["rows"], np.float32)
    err = ss.compare_rows(rows, want, scores, svc.info().get("conformal_qhat"))
    assert err["confidence"] <= ss.CONF_ATOL / 3 and err["entropy"] <= ss.ENTROPY_ATOL / 3, err
    assert err["mutual_information"] == 0.0  # one member: both sides compute H(p) - H(p)
    if name == "gated":
        # the operative confidence is the smaller of the two, and the anomaly follows it
        np.testing.assert_array_equal(rows[:, 1], np.minimum(rows[:, 1], rows[:, 6]))
    np.testing.assert_allclose(rows[:, 2], tunc.anomaly_from_confidence(torch.from_numpy(rows[:, 1])).numpy(),
                               rtol=0, atol=1e-7)


def test_compare_rows_catches_faults(inputs, serve_golden):
    _, rows, scores = _port_rows("msp", inputs)
    want = np.asarray(serve_golden["deployments"]["msp"]["rows"], np.float32)
    for col, delta in ((0, 1.0), (1, 2 * ss.CONF_ATOL), (3, 2 * ss.ENTROPY_ATOL), (4, 1e-3)):
        bad = rows.copy()
        bad[3, col] += delta
        with pytest.raises(AssertionError):
            ss.compare_rows(bad, want, scores, 0.90855)
    far = np.full_like(scores, 10.0)  # no score near qhat: every size is held
    bad = want.copy()
    bad[0, 5] += 1
    with pytest.raises(AssertionError, match="set sizes"):
        ss.compare_rows(want, bad, far, 0.90855)
    near = far.copy()
    near[0, 4] = 0.90855 + ss.CONF_ATOL / 2  # one class near qhat: a size one apart passes
    ss.compare_rows(want, bad, near, 0.90855)


@pytest.mark.parametrize("mode", MODES)
def test_mode_rows_match_fav_tpu_service(mode, inputs, serve_golden):
    """Each mode's rows on its default weights against a fresh run of
    fav_tpu's service on the same frames (``compare_served_rows``: the bf16
    class, the autoencoder's relative error, MC dropout's sampling bounds
    over the port's 20 replicas), and the committed golden against the same
    run (float32 rounding between XLA builds: 1e-5)."""
    svc = port_service(mode)
    rows, probs = svc.score_batch(inputs, members=True)
    want = jax_rows(mode, inputs)
    np.testing.assert_allclose(np.asarray(serve_golden["deployments"][mode]["rows"], np.float32), want,
                               rtol=0, atol=1e-5)
    assert svc.source == f"checkpoint:{os.path.join(PORT_WEIGHTS, DEFAULT_WEIGHTS[mode])}"
    assert rows.shape == want.shape == (len(inputs), 6)
    if mode == "autoencoder":
        assert probs is None and (rows[:, 0] == -1).all() and (rows[:, 5] == -1).all()
    else:
        assert probs.shape == ((20 if mode == "mc_dropout" else 5), len(inputs), 10)
    err = ss.compare_served_rows(svc, rows, probs, want)
    if mode == "ensemble":
        assert err["predictions_held"] >= len(inputs) // 3 and err["confidence"] <= ss.CONF_ATOL / 3


def test_mc_dropout_service_draws_fresh_masks_every_batch(inputs):
    """The service's generator advances: two batches of the same frames
    differ (fav_tpu folds a call counter into its key for the same end),
    and both lie within the sampling bounds of fav_tpu's rows."""
    svc = port_service("mc_dropout")
    a, pa = svc.score_batch(inputs[:8], members=True)
    b, pb = svc.score_batch(inputs[:8], members=True)
    assert not np.array_equal(a, b) and np.abs(a[:, 4]).max() > 0  # mutual information is live
    want = np.asarray(json.load(open(GOLDEN))["deployments"]["mc_dropout"]["rows"], np.float32)[:8]
    ss.compare_sampled_rows(a, want, pa, svc.info().get("conformal_qhat"))
    ss.compare_sampled_rows(b, want, pb, svc.info().get("conformal_qhat"))


@pytest.mark.parametrize("mode", MODES)
def test_mode_weights_that_fail_to_load_raise(mode, tmp_path, inputs):
    """A mode whose weight copy exists but does not load fails loudly: no
    random weights stand in (the msp path serves them marked degraded)."""
    stem = str(tmp_path / "broken")
    with open(os.path.join(PORT_WEIGHTS, DEFAULT_WEIGHTS[mode] + ".metadata.json")) as f:
        meta = json.load(f)
    with open(stem + ".metadata.json", "w") as f:
        json.dump(meta, f)
    np.savez(stem + ".npz", **{"Conv_0/kernel": np.zeros((3, 3, 3, 16), np.float32)})
    from fav_tpu_torch.serving.inference import InferenceService

    svc = InferenceService(uncertainty=mode, checkpoint_dir=stem, device="cpu")
    with pytest.raises((RuntimeError, KeyError, ValueError)):
        svc.score_batch(inputs[:1])
    with pytest.raises(RuntimeError):
        _score(InferenceService(uncertainty=mode, checkpoint_dir=stem, device="cpu"), inputs[:1])


def test_ensemble_of_another_member_count_raises(tmp_path, inputs):
    """Three members restored where the metadata says five: refused."""
    from fav_tpu_torch.serving.inference import InferenceService

    stem = str(tmp_path / "ensemble3")
    with np.load(os.path.join(PORT_WEIGHTS, "ensemble.npz")) as data:
        np.savez(stem + ".npz", **{k: data[k][:3] for k in data.files})
    with open(os.path.join(PORT_WEIGHTS, "ensemble.metadata.json")) as f:
        meta = json.load(f)
    with open(stem + ".metadata.json", "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="5 members, the weights hold 3"):
        InferenceService(uncertainty="ensemble", checkpoint_dir=stem, device="cpu").score_batch(inputs[:1])
    with pytest.raises(ValueError, match="not weights for uncertainty='mc_dropout'"):
        InferenceService(uncertainty="mc_dropout", checkpoint_dir=os.path.join(PORT_WEIGHTS, "autoencoder"),
                         device="cpu").score_batch(inputs[:1])


@pytest.mark.parametrize("mode", MODES)
def test_mode_without_weights_serves_random_marked_degraded(mode, tmp_path, inputs):
    from fav_tpu_torch.config import ModelParams
    from fav_tpu_torch.serving.inference import InferenceService

    svc = InferenceService(ModelParams(widths=(8, 16), dense_width=16, mc_samples=3, ensemble_size=2),
                           uncertainty=mode, checkpoint_dir=str(tmp_path / "none"), device="cpu")
    out = _score(svc, inputs[:3])
    assert svc.degraded and svc.source == "random_init" and len(out) == 3
    assert "mutual_information" in out[0] and (out[0]["prediction"] == -1) == (mode == "autoencoder")


def test_unknown_mode_and_monitored_autoencoder_refused():
    from fav_tpu_torch.serving.inference import InferenceService

    with pytest.raises(ValueError, match="unknown uncertainty mode"):
        InferenceService(uncertainty="energy", device="cpu")
    with pytest.raises(ValueError, match="autoencoder"):
        InferenceService(uncertainty="autoencoder", monitor_dir="x", device="cpu")


def test_mahalanobis_fit_raises(tmp_path, inputs):
    """A Mahalanobis fit beside the weights no longer raises: the service
    builds, serves the feature distance as the row's last column and says
    so in ``info()``; a fit file that cannot be read raises at the model's
    build, as ``fav_tpu``'s ``load_fit`` does
    (``tests/test_torch_maha_serving.py`` holds the column to ``fav_tpu``)."""
    from fav_tpu_torch.models.mahalanobis import MahalanobisFit, save_fit
    from fav_tpu_torch.serving.inference import InferenceService

    stem = str(tmp_path / "student")
    for ext in (".npz", ".metadata.json"):
        with open(os.path.join(PORT_WEIGHTS, "student_nano" + ext), "rb") as src, open(stem + ext, "wb") as dst:
            dst.write(src.read())
    np.savez(stem + ".maha_fit.npz", class_means=np.zeros((10, 64), np.float32))
    svc = InferenceService(checkpoint_dir=stem, device="cpu")  # builds lazily: no raise here
    with pytest.raises(KeyError):
        svc.score_batch(inputs[:1])
    eye = torch.eye(64)
    save_fit(stem + ".maha_fit.npz", MahalanobisFit(torch.zeros(10, 64), eye, torch.zeros(64), eye, 0.0, 1.0))
    svc = InferenceService(checkpoint_dir=stem, device="cpu")
    rows, _ = svc.score_batch(inputs[:3])
    assert rows.shape == (3, 7) and svc.info()["feature_distance"] is True


def _score(svc, frames):
    async def run():
        try:
            return await asyncio.gather(*[svc.score_frame(f) for f in frames])
        finally:
            await svc.close()

    return asyncio.run(run())


def test_missing_monitor_fails_loudly(tmp_path, inputs):
    svc = port_service("msp")
    svc._monitor_dir = str(tmp_path / "nothing")
    with pytest.raises(RuntimeError, match="monitor checkpoint missing"):
        _score(svc, inputs[:2])
    assert svc.source.startswith("error:")


def test_missing_weights_serve_random_marked_degraded(tmp_path, inputs):
    from fav_tpu_torch.config import ModelParams
    from fav_tpu_torch.serving.inference import InferenceService

    svc = InferenceService(ModelParams(widths=(8, 16), dense_width=16), checkpoint_dir=str(tmp_path / "none"),
                           device="cpu")
    assert not svc.degraded  # nothing built, nothing served yet
    out = _score(svc, inputs[:3])
    assert svc.degraded and svc.source == "random_init" and svc.info()["degraded"] is True
    assert len(out) == 3 and {"prediction", "confidence", "model_anomaly", "entropy"} <= set(out[0])
    assert "conformal_set_size" not in out[0]  # no calibrated qhat: the size column is -1


def test_unloadable_weights_say_so(tmp_path, inputs):
    from fav_tpu_torch.serving.inference import InferenceService

    stem = str(tmp_path / "broken")
    with open(os.path.join(PORT_WEIGHTS, "student_nano.metadata.json")) as f:
        meta = json.load(f)
    with open(stem + ".metadata.json", "w") as f:
        json.dump(meta, f)
    np.savez(stem + ".npz", **{"Conv_0/kernel": np.zeros((3, 3, 3, 16), np.float32)})
    svc = InferenceService(checkpoint_dir=stem, device="cpu")
    _score(svc, inputs[:1])
    assert svc.degraded and svc.restore_error and "checkpoint restore failed" in svc.info()["error"]


@pytest.mark.parametrize("name", list(DEPLOYMENTS))
def test_served_dicts_and_one_copy_per_batch(name, inputs, monkeypatch):
    """Through the worker: every frame's dict has the wire fields (the
    monitored one with ``confidence_self``), micro-batches form, and each
    dispatched batch is copied to the host exactly once."""
    svc = port_service(name, max_wait_ms=50.0)
    copies = []
    real = svc._dispatch

    def dispatch(frames):
        packed = real(frames)
        cpu = packed.cpu

        def counted():
            copies.append(len(frames))
            return cpu()

        packed.cpu = counted
        return packed

    async def run():
        await ss.warm_services(svc)
        monkeypatch.setattr(svc, "_dispatch", dispatch)
        try:
            return await asyncio.gather(*[svc.score_frame(f) for f in inputs])
        finally:
            await svc.close()

    out = asyncio.run(run())
    assert sum(copies) == len(inputs) and len(copies) == svc.dispatches - len(BUCKETS_WARM) < len(inputs)
    assert svc.frames_scored == len(inputs)
    for d in out:
        assert {"prediction", "confidence", "model_anomaly", "entropy", "conformal_set_size"} <= set(d)
        assert ("confidence_self" in d) == (name == "gated")
        assert "mutual_information" not in d  # msp: no member axis to disagree over
    info = svc.info()
    assert info["source"].startswith("checkpoint:") and info["device"] == "cpu"
    assert ("monitor" in info) == (name == "gated")


BUCKETS_WARM = (1, 8, 32)  # the warm-up runs each bucket once


@pytest.mark.parametrize("name", list(DEPLOYMENTS))
def test_score_batch_is_what_the_worker_serves(name, inputs):
    """``score_batch`` gives the rows the worker serves for the same frames
    in one batch, without touching the worker's counts, and the tempered
    probabilities those rows derive from."""
    svc = port_service(name, max_wait_ms=50.0)
    rows, probs = svc.score_batch(inputs)
    assert svc.dispatches == svc.frames_scored == 0
    assert rows.shape == (len(inputs), 7 if name == "gated" else 6) and probs.shape == (len(inputs), 10)
    np.testing.assert_array_equal(rows[:, 0], probs.argmax(-1))
    np.testing.assert_array_equal(rows[:, 6 if name == "gated" else 1], probs.max(-1))
    np.testing.assert_allclose(rows[:, 3], tunc.predictive_entropy(torch.from_numpy(probs)).numpy(),
                               rtol=0, atol=REASSOC_ATOL)

    async def run():
        await ss.warm_services(svc)
        try:
            return await asyncio.gather(*[svc.score_frame(f) for f in inputs])
        finally:
            await svc.close()

    served = asyncio.run(run())
    assert svc.dispatches == len(BUCKETS_WARM) + 1 and svc.outstanding == 0  # one batch, bucket 32 as above
    for row, d in zip(rows, served):
        assert d["prediction"] == int(row[0]) and d["confidence"] == round(float(row[1]), 4)
        assert d["entropy"] == round(float(row[3]), 4) and d["conformal_set_size"] == int(row[5])


def _final(status: str, policy: str) -> dict:
    return {"vision_status": status, "policy_state": policy, "reliability": 0.5}


@pytest.mark.parametrize("got, want, ok", [
    (("VISION_FROZEN", "VISION_DEGRADED"), ("VISION_FROZEN", "VISION_DEGRADED"), True),
    # an onset some 0.8 s late leaves a frozen stream one step less restricted
    (("VISION_FROZEN", "VISION_DECLINING"), ("VISION_FROZEN", "VISION_DEGRADED"), True),
    (("VISION_BLANK", "VISION_DEGRADED"), ("VISION_BLANK", "VISION_BLOCKED"), True),
    (("VISION_BLANK", "VISION_DECLINING"), ("VISION_BLANK", "VISION_BLOCKED"), False),  # two steps
    (("VISION_FROZEN", "VISION_ALLOWED"), ("VISION_FROZEN", "VISION_DECLINING"), False),  # allowed where degraded
    (("VISION_OK", "VISION_DECLINING"), ("VISION_OK", "VISION_ALLOWED"), False),  # restricted where allowed
    (("VISION_FROZEN", "VISION_BLOCKED"), ("VISION_FROZEN", "VISION_DEGRADED"), False),  # more restrictive
    (("VISION_OK", "VISION_DEGRADED"), ("VISION_FROZEN", "VISION_DEGRADED"), False),  # another status
])
def test_paced_policy_band(got, want, ok):
    """chip_smoke's paced check: statuses equal, policies equal or one step
    less restrictive, VISION_ALLOWED exactly where the golden allows."""
    import chip_smoke

    args = ("t", [_final(*got)], [_final(*want)], (0,))
    if ok:
        assert chip_smoke.check_paced_states(*args) == (got == want)
    else:
        with pytest.raises(AssertionError, match="stream 0 ends"):
            chip_smoke.check_paced_states(*args)


def test_paced_lag_reads_frame_ids_and_onsets():
    import chip_smoke

    def st(status, frame_id=None):
        s = {"vision_status": status}
        if frame_id is not None:
            s["frame_id"] = frame_id
        return [s]

    lock = [st("VISION_OK", 1), st("VISION_OK", 2), st("VISION_FROZEN", 3), st("VISION_FROZEN", 4)]
    paced = [st("UNKNOWN"), st("VISION_OK", 1), st("VISION_OK", 2), st("VISION_FROZEN", 3)]
    lag = chip_smoke.serve_paced_lag(paced, lock)
    assert lag["frame_lag_max"] == 1 and lag["onset_lag_max"] == 1  # UNKNOWN before the first analysis is no onset
