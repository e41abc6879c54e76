"""The port's training path (``fav_tpu_torch.models.train``, the CNN's train
mode, the weights and optimizer-state bridge, the pretrain CLI) against
``fav_tpu/models/train.py``, and the train-step golden that
``chip_smoke.py`` holds the card to.

The same parameters (numpy from a seed, carried by ``flax_to_torch``), the
same batch and the same AugMix views (``fav_tpu``'s, made from the step's
key) go through ``fav_tpu``'s step core and the port's, at widths (8, 16),
dense 16, batch 8, dropout 0.

Tolerance classes:

* float32 forward, 1e-4 abs on the logits (as ``tests/test_torch_models.py``):
  the libraries sum the convolutions in other orders;
* one float32 step: loss, ce and js within 1e-5 relative (js also within
  1e-7 absolute: at an untrained network it is some 3e-5, a sum of terms of
  order 0.1 that cancel, which float32 leaves to a few ulps of those terms);
  each gradient
  leaf within 1e-4 relative in norm; the updated parameters within 2e-5
  abs (2% of lr = 1e-3: at the first AdamW step the update is about
  ``lr * sign(g)``, and a gradient near eps = 1e-8 moves it by a visible
  fraction of lr). Except the biases whose gradient is 0 in exact
  arithmetic (``chip_smoke.zero_gradient_biases``: a conv followed by a
  GroupNorm of one channel per group, which removes any per-channel
  constant): both libraries compute rounding noise there, held to 1e-6
  absolute per element, and AdamW turns the noise into ±lr,
  so those biases are held to 2 lr;
* one bf16 step: loss, ce and js within 2e-2 relative; each gradient leaf
  (but the zero-gradient biases) no further from flax's bf16 gradient than
  twice flax's own bf16 gradient lies from its float32 one (both
  libraries' bf16 gradients lie far from float32 at this size, through the
  bf16 GroupNorm backward of one-channel groups); at least 90% of the
  parameters within 2e-5 (a first AdamW step moves each by ±lr with its
  gradient's sign, and the two bf16 gradients differ in sign where they are
  within their rounding of 0) and all within 2 lr + 2e-5;
* exact: the megastep against the per-step loop from one generator; the
  dropout's kept values against flax's ``h / keep_prob`` in bf16;
* statistical: the kept fraction of dropout and ``init_params``'s
  per-leaf spread against flax's law, within about five standard errors.

``fav_tpu_torch/weights/train_step.golden.json`` holds ``fav_tpu``'s draws
for one AugMix step's two views, its loss, ce and js, and per-leaf sums of
its gradient and updated parameters; the parameters and the batch are made
with numpy from a seed that the card remakes (``chip_smoke.py``), so they
are not stored. Regenerate it with

    JAX_PLATFORMS=cpu python tests/test_torch_train.py --write

As a test, the golden must equal a fresh ``fav_tpu`` step, and the port
must reproduce it on the CPU at the float32 tolerances above.
"""

from __future__ import annotations

import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from fav_tpu.models.cnn import FailureAwareCNN as JaxCNN  # noqa: E402
from fav_tpu.models.train import TrainState as JState  # noqa: E402
from fav_tpu.models.train import _augmix_step_core, _classifier_step_core  # noqa: E402
from fav_tpu.models.train import create_train_state as j_state  # noqa: E402
from fav_tpu.ops.augment import augmix as j_augmix  # noqa: E402
from fav_tpu.ops.augment import js_consistency as j_js  # noqa: E402

GOLDEN = os.path.join(REPO, "fav_tpu_torch", "weights", "train_step.golden.json")
WIDTHS, DENSE, BATCH = (8, 16), 16, 8
LR, WD, JS_LAM = 1e-3, 1e-4, 12.0
GOLDEN_SEED, GOLDEN_KEY = 7, 11

F32_LOGIT_ATOL = 1e-4
F32_LOSS_RTOL = 1e-5
F32_JS_ATOL = 1e-7
F32_GRAD_RTOL = 1e-4
F32_PARAM_ATOL = 2e-5
NULL_GRAD_ATOL = 1e-6
NULL_PARAM_ATOL = 2 * LR + F32_PARAM_ATOL
BF16_LOSS_RTOL = 2e-2
BF16_GRAD_RATIO = 2.0
BF16_PARAM_ATOL = 2 * LR + F32_PARAM_ATOL
BF16_PARAM_CLOSE_SHARE = 0.90


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = np.asarray(v, dtype=np.float32)
    return out


def _nest(flat):
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v, jnp.float32)
    return tree


def _jax_model(dtype: str) -> JaxCNN:
    return JaxCNN(widths=WIDTHS, dense_width=DENSE, dropout_rate=0.0, compute_dtype=dtype)


def _torch_model(dtype: str, params: dict):
    from fav_tpu_torch.models.cnn import FailureAwareCNN
    from fav_tpu_torch.utils.checkpoint import flax_to_torch

    model = FailureAwareCNN(widths=WIDTHS, dense_width=DENSE, dropout_rate=0.0, compute_dtype=dtype)
    model.load_state_dict(flax_to_torch(params), strict=True)
    return model


def _inputs(seed: int):
    """Parameters, images and labels as ``chip_smoke.py`` remakes them."""
    from fav_tpu_torch.models.cnn import FailureAwareCNN

    return chip_smoke.train_golden_inputs(
        FailureAwareCNN(widths=WIDTHS, dense_width=DENSE, dropout_rate=0.0), seed, BATCH)


def _jax_grads(model, params, images, labels, aug1, aug2):
    """``fav_tpu``'s AugMix loss and gradient (``_augmix_step_core``'s loss_fn)."""
    import optax

    b = images.shape[0]
    trio = jnp.concatenate([images, aug1, aug2], axis=0)

    def loss_fn(p):
        logits = model.apply(p, trio, train=True, rngs={"dropout": jax.random.PRNGKey(0)})
        lc, la, lb = logits[:b], logits[b:2 * b], logits[2 * b:]
        ce = optax.softmax_cross_entropy_with_integer_labels(lc, labels).mean()
        return ce + JS_LAM * j_js(lc, la, lb)

    return _flat(jax.jit(jax.grad(loss_fn))({"params": _nest(params)})["params"])


def _jax_views(key, images):
    k1, k2, _ = jax.random.split(key, 3)
    return j_augmix(k1, images), j_augmix(k2, images)


@functools.lru_cache(maxsize=None)
def _jax_step(dtype: str, augmix: bool):
    model = _jax_model(dtype)
    _, tx = j_state({"params": {}}, LR, WD)
    lam = jnp.float32(JS_LAM)
    if augmix:
        core = functools.partial(_augmix_step_core, model.apply, tx, js_lam=lam, freq=False)
        return model, tx, jax.jit(lambda st, x, y, k: core(state=st, images=x, labels=y, key=k))
    return model, tx, jax.jit(functools.partial(_classifier_step_core, model.apply, tx))


def _torch_grads(model) -> dict[str, np.ndarray]:
    from fav_tpu_torch.utils.checkpoint import torch_to_flax

    return torch_to_flax({n: p.grad for n, p in model.named_parameters()})


def _torch_params(model) -> dict[str, np.ndarray]:
    from fav_tpu_torch.utils.checkpoint import torch_to_flax

    return torch_to_flax(model.state_dict())


def _rel(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-12)


def _null_leaves() -> set[str]:
    return chip_smoke.zero_gradient_biases(FailureAwareCNN(widths=WIDTHS, dense_width=DENSE))


def _assert_grads(got: dict, want: dict, rtol: float) -> None:
    assert sorted(got) == sorted(want)
    null = _null_leaves()
    assert null == {"Conv_0/bias", "Conv_1/bias", "Conv_3/bias", "Conv_4/bias"}
    for k in want:
        if k in null:
            assert max(np.abs(got[k]).max(), np.abs(want[k]).max()) <= NULL_GRAD_ATOL, k
            continue
        err = np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k])
        assert err <= rtol, f"gradient {k}: relative error {err:.3e} > {rtol}"


def _assert_params(got: dict, want: dict) -> None:
    null = _null_leaves()
    for k in want:
        atol = NULL_PARAM_ATOL if k in null else F32_PARAM_ATOL
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0, err_msg=k)


# ── golden ───────────────────────────────────────────────────────────────


def golden_step() -> dict:
    """``fav_tpu``'s float32 AugMix step on the golden inputs: its draws,
    metrics, gradient and updated parameters."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_torch_augment import jax_draws

    params, images, labels = _inputs(GOLDEN_SEED)
    x, y = jnp.asarray(images), jnp.asarray(labels)
    model, tx, step = _jax_step("float32", True)
    key = jax.random.PRNGKey(GOLDEN_KEY)
    k1, k2, _ = jax.random.split(key, 3)
    aug1, aug2 = _jax_views(key, x)
    grads = _jax_grads(model, params, x, y, aug1, aug2)
    tree = {"params": _nest(params)}
    st, metrics = step(JState(tree, tx.init(tree), jnp.zeros((), jnp.int32)), x, y, key)
    new = _flat(st[0]["params"])
    draws = [{k: np.asarray(v, np.float32) for k, v in jax_draws(kk, x).items()} for kk in (k1, k2)]
    return {"draws": draws, "views": [np.asarray(aug1, np.float32), np.asarray(aug2, np.float32)],
            "metrics": {k: float(metrics[k]) for k in ("loss", "ce", "js")}, "grads": grads, "params": new}


def _sums(tree: dict) -> tuple[dict, dict]:
    return ({k: float(np.sum(v, dtype=np.float64)) for k, v in sorted(tree.items())},
            {k: float(np.sum(np.abs(v), dtype=np.float64)) for k, v in sorted(tree.items())})


def _f(v) -> float:
    return float(f"{float(v):.9g}")


def write() -> None:
    g = golden_step()
    grad_sum, grad_abs = _sums(g["grads"])
    param_sum, param_abs = _sums(g["params"])
    golden = {
        "about": "fav_tpu's float32 AugMix train step (models/train.py:_augmix_step_core, dropout 0) on "
                 "numpy inputs from `seed` (chip_smoke.train_golden_inputs); written by "
                 "tests/test_torch_train.py --write",
        "widths": list(WIDTHS), "dense_width": DENSE, "batch": BATCH, "seed": GOLDEN_SEED,
        "key": GOLDEN_KEY, "lr": LR, "weight_decay": WD, "js_lam": JS_LAM,
        "draws": [{k: np.vectorize(_f)(v).tolist() for k, v in d.items()} for d in g["draws"]],
        **{k: _f(v) for k, v in g["metrics"].items()},
        "grad_sum": grad_sum, "grad_abs_sum": grad_abs, "param_sum": param_sum, "param_abs_sum": param_abs,
    }
    with open(GOLDEN, "w") as f:
        json.dump(golden, f, separators=(",", ":"))
        f.write("\n")
    print(f"wrote {GOLDEN}")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_train.py --write")
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)  # as tests/conftest.py runs the session
    write()
    sys.exit(0)


from fav_tpu_torch.config import ModelParams  # noqa: E402
from fav_tpu_torch.data.cifar import synthetic_cifar10  # noqa: E402
from fav_tpu_torch.models import pretrain  # noqa: E402
from fav_tpu_torch.models.cnn import FailureAwareCNN, create_model, init_params  # noqa: E402
from fav_tpu_torch.models.train import (  # noqa: E402
    augmix_step_core,
    augmix_train_step,
    classifier_eval_step,
    classifier_train_step,
    create_train_state,
    make_train_megastep,
    train_classifier,
)
from fav_tpu_torch.utils.checkpoint import adamw_state_from_optax, load_student  # noqa: E402


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def fresh():
    return golden_step()


def test_golden_is_fresh(golden, fresh):
    assert golden["widths"] == list(WIDTHS) and golden["batch"] == BATCH and golden["seed"] == GOLDEN_SEED
    for stored, made in zip(golden["draws"], fresh["draws"]):
        assert sorted(stored) == sorted(made)
        for k in made:
            np.testing.assert_array_equal(np.asarray(stored[k], np.float32), made[k])
    for k in ("loss", "ce", "js"):
        assert _rel(golden[k], fresh["metrics"][k]) <= 1e-6
    for name, tree in (("grad", fresh["grads"]), ("param", fresh["params"])):
        s, a = _sums(tree)
        for k in s:
            assert abs(golden[f"{name}_sum"][k] - s[k]) <= 1e-6 * a[k] + 1e-9
            assert _rel(golden[f"{name}_abs_sum"][k], a[k]) <= 1e-6


def test_port_reproduces_the_golden_on_the_cpu(golden, fresh):
    """The card's check (``chip_smoke.check_train_golden``) run here through
    the plain shear passes."""
    report = chip_smoke.check_train_golden(golden, torch.device("cpu"))
    assert report["max_rel_err"]["loss"] <= F32_LOSS_RTOL
    # and the port's views from the stored draws are fav_tpu's
    _, images, _ = _inputs(GOLDEN_SEED)
    from fav_tpu_torch.ops.augment import augmix_apply

    for d, view in zip(golden["draws"], fresh["views"]):
        got = augmix_apply(torch.from_numpy(images), chip_smoke.draws_from_json(d, torch.device("cpu"))).numpy()
        assert np.mean(np.abs(got - view) > 2e-5) <= 1e-3


# ── one step against fav_tpu ─────────────────────────────────────────────


def _step_pair(dtype: str, augmix: bool, seed: int, key_int: int, steps_before: int = 0):
    """Run ``steps_before`` fav_tpu steps, carry params and optax state
    into the port, then one step on each side from the same views."""
    params, images, labels = _inputs(seed)
    x, y = jnp.asarray(images), jnp.asarray(labels)
    model, tx, step = _jax_step(dtype, augmix)
    tree = {"params": _nest(params)}
    st = JState(tree, tx.init(tree), jnp.zeros((), jnp.int32))
    for i in range(steps_before):
        st, _ = step(st, x, y, jax.random.PRNGKey(100 + i))
    params = _flat(st[0]["params"])
    adam = st[1][0]

    tm = _torch_model(dtype, params)
    state = create_train_state(tm, LR, WD)
    if steps_before:
        adamw_state_from_optax(state.optimizer, tm, _flat(adam.mu), _flat(adam.nu), int(adam.count))
    key = jax.random.PRNGKey(key_int)
    xt, yt = torch.from_numpy(images), torch.from_numpy(labels).long()
    if augmix:
        aug1, aug2 = _jax_views(key, x)
        want_grads = _jax_grads(model, params, x, y, aug1, aug2)
        got = augmix_step_core(state, xt, yt, torch.from_numpy(np.array(aug1, np.float32)),
                               torch.from_numpy(np.array(aug2, np.float32)), JS_LAM, None)
    else:
        import optax

        def loss_fn(p):
            logits = model.apply(p, x, train=True, rngs={"dropout": key})
            return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()

        want_grads = _flat(jax.jit(jax.grad(loss_fn))({"params": _nest(params)})["params"])
        got = classifier_train_step(state, xt, yt, None)
    st, want = step(st, x, y, key)
    return got, want, _torch_grads(tm), want_grads, _torch_params(tm), _flat(st[0]["params"])


@pytest.mark.parametrize("augmix,steps_before", [(True, 0), (True, 2), (False, 0), (False, 2)],
                         ids=["augmix", "augmix-carried-state", "ce", "ce-carried-state"])
def test_float32_step_matches_fav_tpu(augmix, steps_before):
    got, want, grads, want_grads, params, want_params = _step_pair("float32", augmix, 3, 21, steps_before)
    for k in (("loss", "ce", "js") if augmix else ("loss",)):
        g, w = float(got[k]), float(want[k])
        assert _rel(g, w) <= F32_LOSS_RTOL or (k == "js" and abs(g - w) <= F32_JS_ATOL), k
    _assert_grads(grads, want_grads, F32_GRAD_RTOL)
    _assert_params(params, want_params)


def test_bf16_step_matches_fav_tpu():
    got, want, grads, want_grads, params, want_params = _step_pair("bfloat16", True, 4, 22)
    for k in ("loss", "ce", "js"):
        assert _rel(float(got[k]), float(want[k])) <= BF16_LOSS_RTOL, k
    _, f32, _, f32_grads, _, _ = _step_pair("float32", True, 4, 22)
    null = _null_leaves()
    for k in want_grads:
        if k not in null:
            own = np.linalg.norm(want_grads[k] - f32_grads[k])
            assert np.linalg.norm(grads[k] - want_grads[k]) <= BF16_GRAD_RATIO * own, k
    close = total = 0
    for k in want_params:
        diff = np.abs(params[k] - want_params[k])
        assert diff.max() <= BF16_PARAM_ATOL, k
        close += int((diff <= F32_PARAM_ATOL).sum())
        total += diff.size
    assert close / total >= BF16_PARAM_CLOSE_SHARE


# ── the model in train mode ──────────────────────────────────────────────


def test_train_mode_logits_match_flax_without_dropout():
    params, images, _ = _inputs(5)
    want = np.asarray(_jax_model("float32").apply({"params": _nest(params)}, jnp.asarray(images), train=True,
                                                  rngs={"dropout": jax.random.PRNGKey(0)}), np.float32)
    got = _torch_model("float32", params)(torch.from_numpy(images), train=True).detach().numpy()
    np.testing.assert_allclose(got, want, atol=F32_LOGIT_ATOL, rtol=0)


def test_dropout_is_flax_form_in_bf16():
    import flax.linen as nn

    model = FailureAwareCNN(widths=WIDTHS, dense_width=DENSE, dropout_rate=0.1)
    h = torch.from_numpy(np.random.default_rng(6).normal(0, 2, (200, 500)).astype(np.float32)).to(torch.bfloat16)
    out = model._dropout(h, True, torch.Generator().manual_seed(0))
    kept = out != 0
    n = kept.numel()
    assert out.dtype == torch.bfloat16
    assert abs(float(kept.float().mean()) - 0.9) <= 5 * (0.09 / n) ** 0.5
    hj = jnp.asarray(h.float().numpy()).astype(jnp.bfloat16)
    want = np.asarray(nn.Dropout(0.1).apply({}, hj, deterministic=False,
                                            rngs={"dropout": jax.random.PRNGKey(1)}).astype(jnp.float32))
    both = kept.numpy() & (want != 0)
    assert both.mean() > 0.75
    np.testing.assert_array_equal(out.float().numpy()[both], want[both])
    assert torch.equal(model._dropout(h, False, None), h)  # eval mode draws nothing
    with pytest.raises(ValueError, match="generator"):
        model._dropout(h, True, None)


def test_init_params_follow_flax_law():
    widths, dense = (16, 32), 32
    port = create_model(ModelParams(widths=widths, dense_width=dense))
    init_params(port, torch.Generator().manual_seed(0))
    jm = JaxCNN(widths=widths, dense_width=dense)
    flax_tree = _flat(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32))["params"])
    from fav_tpu_torch.utils.checkpoint import torch_to_flax

    mine = torch_to_flax(port.state_dict())
    assert sorted(mine) == sorted(flax_tree)
    for k, v in mine.items():
        w = flax_tree[k]
        assert v.shape == w.shape, k
        if k.endswith("/kernel"):
            sigma = (1.0 / np.prod(w.shape[:-1])) ** 0.5  # lecun_normal: variance 1 / fan_in
            bound = 5 * sigma / (2 * w.size) ** 0.5  # five standard errors of a sample's spread
            assert abs(v.std() - sigma) <= bound and abs(w.std() - sigma) <= bound, k
            assert np.abs(v).max() <= 2 * sigma / 0.87962566 + 1e-6, k  # truncated at two of its σ
        else:
            np.testing.assert_array_equal(v, w, err_msg=k)  # biases 0, GroupNorm scale 1


# ── the megastep, learning and the CLI ───────────────────────────────────


def _small_dataset():
    return synthetic_cifar10(train_size=48, test_size=16)


@pytest.mark.parametrize("augmix", [True, False], ids=["augmix", "ce"])
def test_megastep_is_the_per_step_trajectory(augmix):
    ds = _small_dataset()
    chunk = np.stack([np.arange(8), np.arange(8, 16), np.arange(16, 24)])

    def fresh_state():
        model = create_model(ModelParams(widths=WIDTHS, dense_width=DENSE))  # dropout 0.1, bf16
        return create_train_state(init_params(model, torch.Generator().manual_seed(0)), LR)

    a = fresh_state()
    gen = torch.Generator().manual_seed(1)
    for idx in chunk:
        x, y = torch.from_numpy(ds.train_images[idx]), torch.from_numpy(ds.train_labels[idx])
        per_step = augmix_train_step(a, x, y, gen, JS_LAM) if augmix else classifier_train_step(a, x, y, gen)
    b = fresh_state()
    mega = make_train_megastep(augmix=augmix, js_lam=JS_LAM, device="cpu")
    b, metrics = mega(b, torch.from_numpy(ds.train_images), torch.from_numpy(ds.train_labels), chunk,
                      torch.Generator().manual_seed(1))
    assert a.step == b.step == 3
    for (n, p), (_, q) in zip(a.model.named_parameters(), b.model.named_parameters()):
        assert torch.equal(p, q), n
    assert all(torch.equal(per_step[k], metrics[k][-1]) and metrics[k].shape == (3,) for k in per_step)


def test_augmix_step_learns_a_fixed_batch():
    model = init_params(create_model(ModelParams(widths=WIDTHS, dense_width=DENSE)), torch.Generator().manual_seed(0))
    state = create_train_state(model)
    gen = torch.Generator().manual_seed(0)
    x = torch.rand((16, 32, 32, 3), generator=gen)
    y = torch.randint(0, 10, (16,), generator=gen)
    losses = [augmix_train_step(state, x, y, gen) for _ in range(12)]
    assert float(losses[-1]["loss"]) < float(losses[0]["loss"])  # memorizes the fixed batch
    assert float(losses[-1]["js"]) >= 0.0 and state.step == 12


def test_train_classifier_runs_both_paths_on_one_stream():
    ds = _small_dataset()
    kw = dict(num_steps=5, batch_size=8, augmix=True, seed=2, device="cpu")
    m1, a = train_classifier(create_model(ModelParams(widths=WIDTHS, dense_width=DENSE)), ds, **kw)
    m2, b = train_classifier(create_model(ModelParams(widths=WIDTHS, dense_width=DENSE)), ds, megastep=2, **kw)
    assert a == b and set(a) == {"loss", "accuracy", "ce", "js"} and np.isfinite(a["loss"])
    assert all(torch.equal(p, q) for p, q in zip(m1.parameters(), m2.parameters()))
    ev = classifier_eval_step(m1.eval(), torch.from_numpy(ds.test_images), torch.from_numpy(ds.test_labels))
    assert ev["logits"].shape == (16, 10) and 0.0 <= float(ev["accuracy"]) <= 1.0


@pytest.mark.parametrize("kw", [{"sam_rho": 0.05}, {"deepaugment": True}, {"freq_aug": True},
                                {"bf16_aug": True}])
def test_train_classifier_trains_each_objective(kw):
    """SAM, DeepAugment and the AugMix options train: finite metrics, a
    function of the seed, and another model than the base recipe's."""
    ds = _small_dataset()

    def run(**extra):
        model = create_model(ModelParams(widths=WIDTHS, dense_width=DENSE))
        return train_classifier(model, ds, num_steps=2, batch_size=8, augmix=True, seed=3, device="cpu", **extra)

    (m1, a), (m2, b), (base, _) = run(**kw), run(**kw), run()
    assert a == b and {"loss", "accuracy", "ce", "js"} <= set(a) and np.isfinite(a["loss"])
    assert all(torch.equal(p, q) for p, q in zip(m1.parameters(), m2.parameters()))
    assert not all(torch.equal(p, q) for p, q in zip(m1.parameters(), base.parameters()))


def test_pretrain_cli_writes_weights_load_student_reads(tmp_path, monkeypatch):
    monkeypatch.setattr(pretrain, "load_cifar10", lambda: synthetic_cifar10(train_size=32, test_size=16))
    out = tmp_path / "clf"
    meta = pretrain.main(["--steps", "3", "--batch", "8", "--widths", "8,16", "--augmix", "--megastep", "2",
                          "--log-every", "0", "--device", "cpu", "--out", str(out)])
    assert {"accuracy", "data_source", "train_steps", "augmix", "js_lam", "arch", "widths",
            "dense_width"} <= set(meta)
    assert meta["widths"] == [8, 16] and meta["dense_width"] == 16 and meta["train_steps"] == 3
    model, stored = load_student("clf", device="cpu", directory=tmp_path)
    assert stored == meta and model.widths == (8, 16)
    # --shard in a process that joined no world trains the ensemble unsharded
    meta = pretrain.main(["--ensemble", "3", "--shard", "--steps", "1", "--batch", "8", "--widths", "8,16",
                          "--log-every", "0", "--device", "cpu", "--out", str(tmp_path / "ens")])
    assert meta["ensemble_size"] == 3
