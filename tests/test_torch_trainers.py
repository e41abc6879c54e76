"""The port's remaining trainers against ``fav_tpu``: SAM, DeepAugment, deep
ensembles in their three modes, the autoencoder, MC-dropout distillation
and KD (``fav_tpu_torch.models.train``, ``models/distill.py``,
``ops/deepaugment.py``), their megasteps, and the trainers golden that
``chip_smoke.py`` holds the card to. The pretrain CLI's tests are in
``tests/test_torch_pretrain_cli.py``.

The same parameters (numpy from a seed, carried by ``flax_to_torch``), the
same batch and the same views (``fav_tpu``'s, made from the step's key)
go through ``fav_tpu``'s step core and the port's, at widths (8, 16),
dense 16, batch 8, the autoencoder at widths (8, 16), float32, dropout 0
(or, for the MC teacher, flax's own masks replayed).

Tolerance classes (those of ``tests/test_torch_train.py``):

* one float32 step: loss (and ce, js) within 1e-5 relative, js also 1e-7
  absolute; each gradient leaf within 1e-4 relative in norm; the updated
  parameters within 2e-5 absolute, except the biases whose gradient is 0
  in exact arithmetic (a conv before a one-channel-per-group GroupNorm),
  held to 1e-6 absolute in the gradient and 2 lr in the update;
* DeepAugment given ``fav_tpu``'s masks, strength and blend: the perturbed
  leaves, the float32 autoencoder's reconstruction and the view within
  1e-5 absolute;
* exact: each megastep against its per-step loop from one generator;

``fav_tpu_torch/weights/trainers.golden.json`` holds ``fav_tpu``'s draws of
the SAM, DeepAugment, ensemble (``ce``, three members) and KD (AugMix)
steps, the DeepAugment masks of the small autoencoder, their losses and
per-leaf sums of gradients and updated parameters, and the bfloat16 view
with every op option; the parameters and the batch are remade from the
seed (``chip_smoke.trainers_golden_inputs``). Regenerate it with

    JAX_PLATFORMS=cpu python tests/test_torch_trainers.py --write

As a test, the golden must equal a fresh ``fav_tpu`` run, and the port
must reproduce it on the CPU.
"""

from __future__ import annotations

import base64
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
for _p in (REPO, os.path.join(REPO, "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import chip_smoke  # noqa: E402
from fav_tpu.models.cnn import ConvAutoencoder as JaxAE  # noqa: E402
from fav_tpu.models.cnn import FailureAwareCNN as JaxCNN  # noqa: E402
from fav_tpu.models.distill import _kd_step_core, make_distill_step  # noqa: E402
from fav_tpu.models.train import TrainState as JState  # noqa: E402
from fav_tpu.models.train import (_deepaugment_step_core, _sam_step_core, autoencoder_train_step,  # noqa: E402
                                  create_train_state as j_state, make_ensemble_train_step)
from fav_tpu.ops import augment as ja  # noqa: E402
from fav_tpu.ops.deepaugment import deepaugment as j_deepaugment  # noqa: E402
from fav_tpu.ops.deepaugment import perturb_params as j_perturb  # noqa: E402
from test_torch_augment import jax_option_draws  # noqa: E402
from test_torch_train import (F32_JS_ATOL, F32_LOSS_RTOL, F32_PARAM_ATOL, _assert_grads,  # noqa: E402
                              _assert_params, _flat, _nest, _rel, _sums, _f)

GOLDEN = os.path.join(REPO, "fav_tpu_torch", "weights", "trainers.golden.json")
WIDTHS, DENSE, BATCH, AE_WIDTHS, MEMBERS = (8, 16), 16, 8, (8, 16), 3
LR, WD, JS_LAM, RHO, KD_T, HARD_W = 1e-3, 1e-4, 12.0, 0.05, 2.0, 0.3
SEED, KEY = 13, 17
F32 = jnp.float32
DA_ATOL = 1e-5
F32_GRAD_RTOL = 1e-4
AE_PARAM_ATOL = F32_PARAM_ATOL


# ── JAX side ─────────────────────────────────────────────────────────────


def _header() -> dict:
    return {"widths": list(WIDTHS), "dense_width": DENSE, "batch": BATCH, "ae_widths": list(AE_WIDTHS),
            "members": MEMBERS, "seed": SEED, "key": KEY, "lr": LR, "weight_decay": WD, "js_lam": JS_LAM,
            "rho": RHO, "kd_temperature": KD_T, "hard_weight": HARD_W}


@functools.lru_cache(maxsize=None)
def _inputs() -> dict:
    return chip_smoke.trainers_golden_inputs(_header())


def _jax_model(dropout: float = 0.0) -> JaxCNN:
    return JaxCNN(widths=WIDTHS, dense_width=DENSE, dropout_rate=dropout, compute_dtype="float32")


def _jax_ae() -> JaxAE:
    return JaxAE(widths=AE_WIDTHS, latent=AE_WIDTHS[-1], compute_dtype="float32")


def _tx():
    return j_state({"params": {}}, LR, WD)[1]


def _tree(params: dict) -> dict:
    return {"params": _nest(params)}


def _jstate(params: dict) -> JState:
    tree = _tree(params)
    return JState(tree, _tx().init(tree), jnp.zeros((), jnp.int32))


def _stack(trees: list[dict]) -> dict:
    return _tree({k: np.stack([t[k] for t in trees]) for k in trees[0]})


def _xy():
    inp = _inputs()
    return jnp.asarray(inp["images"]), jnp.asarray(inp["labels"])


def _apply(model):
    return lambda p, x: model.apply(p, x, train=True, rngs={"dropout": jax.random.PRNGKey(0)})


def _js_loss(p, x, y, a1, a2):
    import optax

    b = x.shape[0]
    logits = _apply(_jax_model())(p, jnp.concatenate([x, a1, a2]))
    lc, la, lb = logits[:b], logits[b:2 * b], logits[2 * b:]
    return optax.softmax_cross_entropy_with_integer_labels(lc, y).mean() + JS_LAM * ja.js_consistency(lc, la, lb)


def _ce_loss(p, x, y):
    import optax

    return optax.softmax_cross_entropy_with_integer_labels(_apply(_jax_model())(p, x), y).mean()


def _grads(loss_fn, tree, *args) -> dict:
    return _flat(jax.jit(jax.grad(loss_fn))(tree, *args)["params"])


@jax.jit
def _sam_grads(tree, x, y, a1, a2):
    """The gradient SAM applies: at the ascended point (``_sam_step_core`` :239-243)."""
    import optax

    g1 = jax.grad(_js_loss)(tree, x, y, a1, a2)
    scale = RHO / jnp.maximum(optax.global_norm(g1), 1e-12)
    adv = jax.tree.map(lambda p, g: p + scale * g, tree, g1)
    return jax.grad(_js_loss)(adv, x, y, a1, a2)


def _kd_loss(p, teachers, x, y, view):
    inp = x if view is None else jnp.concatenate([x, view])
    model = _jax_model()
    targets = jax.nn.softmax(jnp.mean(jax.vmap(lambda q: model.apply(q, inp))(teachers), 0) / KD_T, -1)
    logits = model.apply(p, inp)
    soft = -jnp.mean(jnp.sum(targets * jax.nn.log_softmax(logits / KD_T, -1), -1)) * KD_T ** 2
    hard = -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits[:x.shape[0]], -1), y[:, None], -1))
    return soft + HARD_W * hard


def _draws_json(d: dict) -> dict:
    return {k: np.vectorize(_f)(np.asarray(v, np.float32)).tolist() for k, v in d.items()}


def _b64(a: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(a, dtype="<f4").tobytes()).decode()


def jax_deepaugment_draws(key, ae_tree: dict, b: int) -> dict:
    """``deepaugment(key)``'s draws by its key schedule (:80-86, ``perturb_params``
    :47-57): the strength, per leaf (state-dict name, torch layout) the
    normals and the flip and zero masks, and the blend."""
    from fav_tpu_torch.utils.checkpoint import flax_to_torch

    k_s, k_p, k_b = jax.random.split(key, 3)
    strength = jax.random.uniform(k_s, (), F32, 0.1, 0.45)
    paths, _ = jax.tree_util.tree_flatten_with_path(ae_tree)
    keys = jax.random.split(k_p, len(paths))
    eps, flip, zero = {}, {}, {}
    for k, (path, w) in zip(keys, paths):
        name = "/".join(p.key for p in path[1:])
        kn, ks, kz = jax.random.split(k, 3)
        eps[name] = np.asarray(jax.random.normal(kn, w.shape, F32))
        flip[name] = np.asarray(jax.random.bernoulli(ks, 0.05 * strength, w.shape), np.float32)
        zero[name] = np.asarray(jax.random.bernoulli(kz, 0.05 * strength, w.shape), np.float32)
    eps, flip, zero = (flax_to_torch(t) for t in (eps, flip, zero))
    lam = jax.random.uniform(k_b, (b, 1, 1, 1), F32, 0.35, 1.0)
    return {"strength": float(strength), "lam": np.asarray(lam, np.float32).reshape(b),
            "leaves": {n: {"eps": eps[n].numpy(), "flip": flip[n].numpy() > 0.5, "zero": zero[n].numpy() > 0.5}
                       for n in eps}}


def f64_grads(params: dict, images: np.ndarray, loss_of_logits) -> dict:
    """The vgg classifier's gradient in float64 (torch, dropout 0) at
    ``params``: the exact gradient to float32's eyes, which tells which of
    two float32 gradients lies nearer the truth."""
    import torch.nn.functional as F

    from fav_tpu_torch.models.cnn import FailureAwareCNN
    from fav_tpu_torch.utils.checkpoint import flax_to_torch, torch_to_flax

    model = FailureAwareCNN(widths=WIDTHS, dense_width=DENSE, dropout_rate=0.0)
    model.load_state_dict(flax_to_torch(params), strict=True)
    model.double()
    h = torch.from_numpy(np.asarray(images, np.float64)).permute(0, 3, 1, 2)
    convs, norms = iter(model.convs), iter(model.norms)
    for _ in model.widths:
        for _ in range(2):
            conv, norm = next(convs), next(norms)
            h = F.relu(F.group_norm(F.conv2d(h, conv.weight, conv.bias, padding=1), norm.num_groups, norm.weight,
                                    norm.bias, norm.eps))
        conv = next(convs)
        h = F.relu(F.conv2d(F.pad(h, (0, 1, 0, 1)), conv.weight, conv.bias, stride=2))
    d0, d1 = model.dense
    loss_of_logits(F.linear(F.relu(F.linear(h.mean(dim=(-2, -1)), d0.weight, d0.bias)), d1.weight, d1.bias)).backward()
    return torch_to_flax({n: p.grad for n, p in model.named_parameters()})


def _js_of_logits(labels: np.ndarray):
    import torch.nn.functional as F

    from fav_tpu_torch.ops.augment import js_consistency

    y = torch.from_numpy(np.asarray(labels)).long()

    def loss(logits):
        b = y.shape[0]
        lc, la, lb = logits[:b], logits[b:2 * b], logits[2 * b:]
        return F.cross_entropy(lc, y) + JS_LAM * js_consistency(lc, la, lb)

    return loss


def reference_grad_rtol(r: dict, params: dict) -> float:
    """Twice the largest distance of ``fav_tpu``'s float32 gradient sums from
    float64 ones, over the leaves, in units of each leaf's absolute sum, and
    at least the float32 class's 1e-4: the bar a golden's gradient sums are
    held to where the reference itself is less accurate than that (see
    ``test_deepaugment_step_matches_fav_tpu``)."""
    x = np.asarray(_inputs()["images"])
    trio = np.concatenate([x, *(np.asarray(v) for v in r["views"])])
    from fav_tpu_torch.models.cnn import FailureAwareCNN

    g64 = f64_grads(params, trio, _js_of_logits(_inputs()["labels"]))
    null = chip_smoke.zero_gradient_biases(FailureAwareCNN(widths=WIDTHS, dense_width=DENSE))
    worst = max(abs(float(np.sum(r["grads"][k], dtype=np.float64)) - float(g64[k].sum()))
                / float(np.abs(r["grads"][k]).sum(dtype=np.float64)) for k in g64 if k not in null)
    return max(F32_GRAD_RTOL, float(f"{2 * worst:.3g}"))


def _step_result(st, metrics, grads, keys) -> dict:
    return {"metrics": {k: float(metrics[k]) for k in keys}, "grads": grads, "params": _flat(st[0]["params"])}


def fresh_run() -> dict:
    """``fav_tpu``'s SAM, DeepAugment, ensemble (``ce``) and KD steps and its
    bfloat16 view on the golden inputs: draws, views, metrics, gradients and
    updated parameters."""
    inp = _inputs()
    x, y = _xy()
    key = jax.random.PRNGKey(KEY)
    tx = _tx()
    lam, rho = jnp.float32(JS_LAM), jnp.float32(RHO)
    model = _jax_model()
    out = {}

    k1, k2, _ = jax.random.split(key, 3)
    views = (ja.augmix(k1, x), ja.augmix(k2, x))
    sam = jax.jit(functools.partial(_sam_step_core, model.apply, tx))
    st, m = sam(_jstate(inp["params"]), x, y, key, lam, rho)
    grads = _flat(_sam_grads(_tree(inp["params"]), x, y, *views)["params"])
    out["sam"] = {"draws": [jax_option_draws(k, x) for k in (k1, k2)], "views": views,
                  **_step_result(st, m, grads, ("loss", "ce", "js"))}

    ae = _jax_ae()
    ae_tree = _tree(inp["ae"])
    k1, k2, k3, _ = jax.random.split(key, 4)
    distorted = j_deepaugment(k3, x, ae.apply, ae_tree)
    views = (ja.augmix(k1, x), ja.augmix(k2, distorted))
    da = jax.jit(functools.partial(_deepaugment_step_core, model.apply, ae.apply, tx, freq=False))
    st, m = da(state=_jstate(inp["params"]), images=x, labels=y, key=key, js_lam=lam, ae_params=ae_tree)
    out["deepaugment"] = {"draws": [jax_option_draws(k, x) for k in (k1, k2)], "views": views,
                          "deepaugment": jax_deepaugment_draws(k3, ae_tree, BATCH), "distorted": distorted,
                          **_step_result(st, m, _grads(_js_loss, _tree(inp["params"]), x, y, *views),
                                         ("loss", "ce", "js"))}

    out["ensemble_ce"] = _jax_ensemble(True, "ce", key)

    step = jax.jit(_kd_step_core(model.apply, model.apply, tx, KD_T, HARD_W, True, False))
    teachers = _stack(inp["teachers"])
    st_tree = _tree(inp["params"])
    new, _, loss = step(st_tree, tx.init(st_tree), teachers, x, y, key)
    view = ja.augmix(key, x)
    out["kd"] = {"draws": [jax_option_draws(key, x)], "views": (view,), "metrics": {"loss": float(loss)},
                 "grads": _grads(_kd_loss, st_tree, teachers, x, y, view), "params": _flat(new["params"])}

    kb = jax.random.PRNGKey(KEY + 1)
    opts = dict(freq=True, occlude=True, bars=True)
    out["bf16_view"] = {"draws": jax_option_draws(kb, x, **opts),
                        "view": np.asarray(ja.augmix(kb, x, bf16=True, **opts), np.float32)}
    return out


def _jax_ensemble(augmix: bool, mode: str, key) -> list[dict]:
    """One step of ``make_ensemble_train_step`` over the members: per member
    its views (``keys[i]`` split as ``_ensemble_member_step`` splits it),
    metrics, gradient and updated parameters."""
    inp = _inputs()
    x, y = _xy()
    tx = _tx()
    stacked = _stack(inp["members"])
    states = JState(stacked, jax.vmap(tx.init)(stacked), jnp.zeros((MEMBERS,), jnp.int32))
    new, m = make_ensemble_train_step(_jax_model().apply, tx, augmix, JS_LAM, mode)(states, x, y, key)
    out = []
    for i, k in enumerate(jax.random.split(key, MEMBERS)):
        tree = _tree(inp["members"][i])
        if not augmix:
            keys, views, grads = [], (), _grads(_ce_loss, tree, x, y)
        elif mode == "ce":
            keys = [jax.random.split(k)[0]]
            views = (ja.augmix(keys[0], x),)
            grads = _grads(_ce_loss, tree, jnp.concatenate([x, views[0]]), jnp.concatenate([y, y]))
        else:
            keys = list(jax.random.split(k, 3)[:2])
            views = tuple(ja.augmix(kk, x) for kk in keys)
            grads = _grads(_js_loss, tree, x, y, *views)
        out.append({"draws": [jax_option_draws(kk, x) for kk in keys], "views": views,
                    "metrics": {"loss": float(m["loss"][i]), "accuracy": float(m["accuracy"][i])}, "grads": grads,
                    "params": {kk: v[i] for kk, v in _flat(new[0]["params"]).items()}})
    return out


def _golden_entry(r: dict) -> dict:
    grad_sum, grad_abs = _sums(r["grads"])
    param_sum, param_abs = _sums(r["params"])
    return {"draws": [_draws_json(d) for d in r["draws"]], **{k: _f(v) for k, v in r["metrics"].items()},
            "grad_sum": grad_sum, "grad_abs_sum": grad_abs, "param_sum": param_sum, "param_abs_sum": param_abs}


def _da_json(d: dict) -> dict:
    return {"strength": _f(d["strength"]), "lam": [_f(v) for v in d["lam"]],
            "leaves": {n: {"eps": _b64(leaf["eps"]), "flip": np.flatnonzero(leaf["flip"]).tolist(),
                           "zero": np.flatnonzero(leaf["zero"]).tolist()} for n, leaf in d["leaves"].items()}}


def golden_json(run: dict) -> dict:
    return {
        "about": "fav_tpu's SAM, DeepAugment, ensemble (ce) and KD (AugMix) steps at widths (8, 16), dropout 0, "
                 "float32, and its bfloat16 AugMix view with every op option, on numpy inputs from `seed` "
                 "(chip_smoke.trainers_golden_inputs); written by tests/test_torch_trainers.py --write",
        **_header(),
        "sam": _golden_entry(run["sam"]),
        "deepaugment": {**_golden_entry(run["deepaugment"]), "deepaugment": _da_json(run["deepaugment"]["deepaugment"]),
                        "grad_rtol": reference_grad_rtol(run["deepaugment"], _inputs()["params"])},
        "ensemble_ce": [_golden_entry(r) for r in run["ensemble_ce"]],
        "kd": _golden_entry(run["kd"]),
        "bf16_view": {"draws": _draws_json(run["bf16_view"]["draws"]), "view": _b64(run["bf16_view"]["view"])},
    }


def write() -> None:
    golden = golden_json(fresh_run())
    with open(GOLDEN, "w") as f:
        json.dump(golden, f, separators=(",", ":"))
        f.write("\n")
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_trainers.py --write")
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)  # as tests/conftest.py sets it for the tests
    write()
    sys.exit(0)


from fav_tpu_torch.config import ModelParams  # noqa: E402
from fav_tpu_torch.data.cifar import synthetic_cifar10  # noqa: E402
from fav_tpu_torch.models import distill as td  # noqa: E402
from fav_tpu_torch.models import train as tt  # noqa: E402
from fav_tpu_torch.models.cnn import ConvAutoencoder, FailureAwareCNN, create_model, init_params  # noqa: E402
from fav_tpu_torch.ops import deepaugment as tda  # noqa: E402
from fav_tpu_torch.utils.checkpoint import flax_to_torch, torch_to_flax  # noqa: E402
from test_torch_multiforward import _replayed_masks  # noqa: E402
from test_torch_resnet_ae import torch_masks  # noqa: E402


@pytest.fixture(scope="module")
def fresh():
    return fresh_run()


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _port_xy():
    inp = _inputs()
    return torch.from_numpy(inp["images"]), torch.from_numpy(inp["labels"]).long()


def _port_state(params: dict, dropout: float = 0.0) -> tt.TrainState:
    model = FailureAwareCNN(widths=WIDTHS, dense_width=DENSE, dropout_rate=dropout, compute_dtype="float32")
    model.load_state_dict(flax_to_torch(params), strict=True)
    return tt.create_train_state(model, LR, WD)


def _port_grads(model) -> dict:
    return torch_to_flax({n: p.grad for n, p in model.named_parameters()})


def _assert_step(got_metrics: dict, want: dict, state: tt.TrainState) -> None:
    for k, w in want["metrics"].items():
        if k == "accuracy":
            continue
        g = float(got_metrics[k])
        assert _rel(g, w) <= F32_LOSS_RTOL or (k == "js" and abs(g - w) <= F32_JS_ATOL), (k, g, w)
    _assert_grads(_port_grads(state.model), want["grads"], F32_GRAD_RTOL)
    _assert_params(torch_to_flax(state.model.state_dict()), want["params"])


def _views(r: dict) -> tuple[torch.Tensor, ...]:
    return tuple(_t(v) for v in r["views"])


# ── one step of each objective against fav_tpu ───────────────────────────


def test_sam_step_matches_fav_tpu(fresh):
    x, y = _port_xy()
    r = fresh["sam"]
    state = _port_state(_inputs()["params"])
    got = tt.sam_step_core(state, x, y, *_views(r), JS_LAM, RHO, None)
    _assert_step(got, r, state)
    assert state.step == 1


def test_deepaugment_step_matches_fav_tpu(fresh):
    """As the other steps, but for the gradient: one image of the second view
    (the flattest, per-image std 0.019) leaves ``fav_tpu``'s float32
    gradient 1.1e-3 (relative, in norm) from the float64 gradient in the
    first stage's leaves, where the port's lies within 1e-4 of it. Each
    gradient leaf is held to 1e-4 of ``fav_tpu``'s, or else must lie no
    further from the float64 gradient than ``fav_tpu``'s does."""
    x, y = _port_xy()
    r = fresh["deepaugment"]
    state = _port_state(_inputs()["params"])
    got = tt.augmix_step_core(state, x, y, *_views(r), JS_LAM, None)
    for k in ("loss", "ce", "js"):
        g, w = float(got[k]), r["metrics"][k]
        assert _rel(g, w) <= F32_LOSS_RTOL or (k == "js" and abs(g - w) <= F32_JS_ATOL), (k, g, w)
    trio = np.concatenate([_inputs()["images"], *(np.asarray(v) for v in r["views"])])
    g64 = f64_grads(_inputs()["params"], trio, _js_of_logits(_inputs()["labels"]))
    grads = _port_grads(state.model)
    null = chip_smoke.zero_gradient_biases(state.model)
    def rel(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    for k, want in r["grads"].items():
        if k.startswith("Dense_"):  # past the convolutions both agree
            assert rel(grads[k], want) <= F32_GRAD_RTOL, k
        elif k not in null and rel(grads[k], want) > F32_GRAD_RTOL:
            assert rel(grads[k], g64[k]) <= rel(want, g64[k]), k
    _assert_params(torch_to_flax(state.model.state_dict()), r["params"])


def _port_ae() -> ConvAutoencoder:
    ae = ConvAutoencoder(widths=AE_WIDTHS, latent=AE_WIDTHS[-1], compute_dtype="float32")
    ae.load_state_dict(flax_to_torch(_inputs()["ae"]), strict=True)
    return ae.eval()


def _da_draws(d: dict) -> tda.DeepAugmentDraws:
    leaves = {n: tda.Perturbation(torch.from_numpy(v["eps"].copy()), torch.from_numpy(v["flip"]),
                                  torch.from_numpy(v["zero"])) for n, v in d["leaves"].items()}
    return tda.DeepAugmentDraws(torch.tensor(d["strength"]), leaves, _t(d["lam"]))


def test_deepaugment_view_matches_fav_tpu(fresh):
    """``perturb_params``, the perturbed autoencoder and the view, given
    ``fav_tpu``'s masks, strength and blend."""
    r = fresh["deepaugment"]
    d = r["deepaugment"]
    draws = _da_draws(d)
    ae = _port_ae()
    inp = _inputs()
    key3 = jax.random.split(jax.random.PRNGKey(KEY), 4)[2]
    k_p = jax.random.split(key3, 3)[1]
    ae_tree = _tree(inp["ae"])
    want_leaves = flax_to_torch(_flat(j_perturb(k_p, ae_tree, jnp.float32(d["strength"]))["params"]))
    got_leaves = tda.perturb_params(ae.state_dict(), draws.leaves, draws.strength)
    assert sorted(got_leaves) == sorted(want_leaves)
    for n in want_leaves:
        np.testing.assert_allclose(got_leaves[n].numpy(), want_leaves[n].numpy(), atol=DA_ATOL, rtol=0, err_msg=n)
    n_flip = sum(int(p.flip.sum()) for p in draws.leaves.values())
    assert n_flip > 0 and 0.1 <= d["strength"] <= 0.45  # the masks do act
    x = torch.from_numpy(inp["images"])
    want_recon = np.asarray(_jax_ae().apply(j_perturb(k_p, ae_tree, jnp.float32(d["strength"])), jnp.asarray(x)))
    got_recon = torch.func.functional_call(ae, got_leaves, (x,)).detach().numpy()
    np.testing.assert_allclose(got_recon, want_recon, atol=DA_ATOL, rtol=0)
    got = tda.deepaugment_apply(x, ae, draws).numpy()
    np.testing.assert_allclose(got, np.asarray(r["distorted"], np.float32), atol=DA_ATOL, rtol=0)
    assert np.abs(got - inp["images"]).mean() > 1e-3


@pytest.mark.parametrize("mode", ["ce", "js", "plain"])
def test_ensemble_step_matches_fav_tpu(mode, fresh):
    want = fresh["ensemble_ce"] if mode == "ce" else _jax_ensemble(mode != "plain", mode, jax.random.PRNGKey(KEY))
    x, y = _port_xy()
    for i, r in enumerate(want):
        state = _port_state(_inputs()["members"][i])
        got = tt.ensemble_member_step_core(state, x, y, _views(r), mode, JS_LAM, None)
        assert set(got) == {"loss", "accuracy"} and float(got["accuracy"]) == r["metrics"]["accuracy"]
        _assert_step(got, r, state)


@pytest.mark.parametrize("augmix", [True, False], ids=["augmix", "clean"])
def test_kd_step_matches_fav_tpu(augmix, fresh):
    inp = _inputs()
    x, y = _port_xy()
    if augmix:
        r = fresh["kd"]
    else:
        jx, jy = _xy()
        tx = _tx()
        tree = _tree(inp["params"])
        teachers = _stack(inp["teachers"])
        step = jax.jit(_kd_step_core(_jax_model().apply, _jax_model().apply, tx, KD_T, HARD_W, False, False))
        new, _, loss = step(tree, tx.init(tree), teachers, jx, jy, jax.random.PRNGKey(KEY))
        r = {"views": (), "metrics": {"loss": float(loss)}, "grads": _grads(_kd_loss, tree, teachers, jx, jy, None),
             "params": _flat(new["params"])}
    teachers = [_port_state(p).model.eval() for p in inp["teachers"]]
    state = _port_state(inp["params"])
    view = _views(r)[0] if augmix else None
    got = td.kd_step_core(state, teachers, x, y, view, KD_T, HARD_W)
    _assert_step(got, r, state)


def test_autoencoder_step_matches_fav_tpu():
    inp = _inputs()
    x = jnp.asarray(inp["images"])
    ae = _jax_ae()
    tx = _tx()
    tree = _tree(inp["ae"])
    want_grads = _grads(lambda p, xx: jnp.mean((ae.apply(p, xx) - xx) ** 2), tree, x)
    st, m = autoencoder_train_step(ae.apply, tx, JState(tree, tx.init(tree), jnp.zeros((), jnp.int32)), x)
    state = tt.create_train_state(_port_ae(), LR, WD)
    got = tt.autoencoder_train_step(state, torch.from_numpy(inp["images"]))
    assert _rel(float(got["loss"]), float(m["loss"])) <= F32_LOSS_RTOL
    grads = _port_grads(state.model)
    assert sorted(grads) == sorted(want_grads)
    for k in want_grads:
        err = np.linalg.norm(grads[k] - want_grads[k]) / np.linalg.norm(want_grads[k])
        assert err <= F32_GRAD_RTOL, (k, err)
    new = torch_to_flax(state.model.state_dict())
    for k, v in _flat(st[0]["params"]).items():
        np.testing.assert_allclose(new[k], v, atol=AE_PARAM_ATOL, rtol=0, err_msg=k)


def test_mc_distill_step_matches_fav_tpu():
    """K = 4 teacher replicas with flax's own masks replayed (dropout 0.1);
    the student (eval mode) starts from other parameters."""
    k = 4
    inp = _inputs()
    jx = jnp.asarray(inp["images"])
    teacher = _jax_model(0.1)
    t_params, s_params = inp["teachers"][0], inp["params"]
    tx = _tx()
    key = jax.random.PRNGKey(KEY + 2)
    s_tree, t_tree = _tree(s_params), _tree(t_params)
    step = make_distill_step(teacher.apply, tx, k, 1.0)
    new, _, loss = step(s_tree, tx.init(s_tree), t_tree, jx, key)

    def targets_of(p, kk):
        return jax.nn.softmax(teacher.apply(p, jx, train=True, rngs={"dropout": kk}), -1)

    targets = jnp.mean(jax.vmap(lambda kk: targets_of(t_tree, kk))(jax.random.split(key, k)), 0)
    want_grads = _grads(lambda p: -jnp.mean(jnp.sum(targets * jax.nn.log_softmax(teacher.apply(p, jx), -1), -1)),
                        s_tree)
    port_teacher = _port_state(t_params, dropout=0.1).model
    masks = _replayed_masks(teacher, t_params, inp["images"], key, k)
    x = torch.from_numpy(inp["images"])
    got_targets = td.mc_targets(port_teacher, x, None, k, masks=torch_masks(masks))
    np.testing.assert_allclose(got_targets.numpy(), np.asarray(targets), atol=1e-5, rtol=0)
    state = _port_state(s_params, dropout=0.1)
    got = td.distill_step_core(state, x, got_targets)
    _assert_step(got, {"metrics": {"loss": float(loss)}, "grads": want_grads, "params": _flat(new["params"])}, state)


# ── the golden ───────────────────────────────────────────────────────────


def test_trainers_golden_is_fresh(golden, fresh):
    want = golden_json(fresh)
    assert {k: golden[k] for k in _header()} == _header()
    assert os.path.getsize(GOLDEN) < 1_000_000
    for name in ("sam", "deepaugment", "kd"):
        _assert_entry(golden[name], want[name])
    for g, w in zip(golden["ensemble_ce"], want["ensemble_ce"], strict=True):
        _assert_entry(g, w)
    assert golden["deepaugment"]["deepaugment"] == want["deepaugment"]["deepaugment"]
    assert _rel(golden["deepaugment"]["grad_rtol"], want["deepaugment"]["grad_rtol"]) <= 1e-2
    assert golden["bf16_view"]["draws"] == want["bf16_view"]["draws"]
    shape = (BATCH, 32, 32, 3)
    diff = np.abs(chip_smoke.b64_array(golden["bf16_view"]["view"], shape)
                  - chip_smoke.b64_array(want["bf16_view"]["view"], shape))
    # XLA's bfloat16 rounding of its inverse FFT may land one bfloat16 step
    # apart on another CPU; anywhere else the view is float32 arithmetic
    assert diff.mean() <= 1e-6 and diff.max() <= chip_smoke.BF16_VIEW_MAX


def _assert_entry(stored: dict, made: dict) -> None:
    assert stored["draws"] == made["draws"]
    for k in ("loss", "ce", "js", "accuracy"):
        if k in made:
            assert _rel(stored[k], made[k]) <= 1e-6, k
    for name in ("grad", "param"):
        for k, s in made[f"{name}_sum"].items():
            assert abs(stored[f"{name}_sum"][k] - s) <= 1e-6 * made[f"{name}_abs_sum"][k] + 1e-9, k
            assert _rel(stored[f"{name}_abs_sum"][k], made[f"{name}_abs_sum"][k]) <= 1e-6, k


def test_port_reproduces_the_trainers_golden_on_the_cpu(golden):
    """The card's check (``chip_smoke.check_trainers_golden``) run here
    through the plain shear passes."""
    report = chip_smoke.check_trainers_golden(golden, torch.device("cpu"))
    assert report["sam"]["max_rel_err"]["loss"] <= F32_LOSS_RTOL
    assert report["bf16_view"]["max"] <= chip_smoke.BF16_VIEW_MAX
    assert len(report["ensemble_ce"]) == MEMBERS


# ── megasteps against their per-step loops ───────────────────────────────


def _small_dataset():
    return synthetic_cifar10(train_size=48, test_size=16)


def _fresh_state(seed: int = 0) -> tt.TrainState:
    # dropout 0.1; float32 compute, which the CPU runs far faster than bf16
    model = create_model(ModelParams(widths=WIDTHS, dense_width=DENSE, compute_dtype="float32"))
    return tt.create_train_state(init_params(model, torch.Generator().manual_seed(seed)), LR)


def _augmenter() -> ConvAutoencoder:
    return init_params(ConvAutoencoder(widths=AE_WIDTHS, latent=AE_WIDTHS[-1]), torch.Generator().manual_seed(9))


CHUNK = np.stack([np.arange(8), np.arange(8, 16), np.arange(16, 24)])
TRAIN_MEGA = {
    "sam": (dict(augmix=True, sam_rho=RHO), lambda st, x, y, g, aug: tt.sam_augmix_train_step(st, x, y, g, JS_LAM, RHO)),
    "deepaugment": (dict(augmix=True, deepaugment=True),
                    lambda st, x, y, g, aug: tt.deepaugment_train_step(st, x, y, g, aug, JS_LAM)),
    "options": (dict(augmix=True, freq=True, occlude=True, bars=True),
                lambda st, x, y, g, aug: tt.augmix_train_step(st, x, y, g, JS_LAM, freq=True, occlude=True,
                                                              bars=True)),
    "bf16": (dict(augmix=True, bf16_aug=True),
             lambda st, x, y, g, aug: tt.augmix_train_step(st, x, y, g, JS_LAM, bf16=True)),
}


def _same_params(a, b) -> bool:
    return all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))


@pytest.mark.parametrize("objective", list(TRAIN_MEGA))
def test_train_megastep_is_the_per_step_trajectory(objective):
    kw, step = TRAIN_MEGA[objective]
    ds = _small_dataset()
    aug = _augmenter()
    a, gen = _fresh_state(), torch.Generator().manual_seed(1)
    for idx in CHUNK:
        last = step(a, torch.from_numpy(ds.train_images[idx]), torch.from_numpy(ds.train_labels[idx]), gen, aug)
    mega = tt.make_train_megastep(js_lam=JS_LAM, augmenter=aug, device="cpu", **kw)
    b, metrics = mega(_fresh_state(), torch.from_numpy(ds.train_images), torch.from_numpy(ds.train_labels), CHUNK,
                      torch.Generator().manual_seed(1))
    assert a.step == b.step == 3 and _same_params(a.model, b.model)
    assert all(torch.equal(last[k], metrics[k][-1]) for k in last)
    assert not _same_params(a.model, _fresh_state().model)


@pytest.mark.parametrize("mode", ["plain", "js", "ce"])
def test_ensemble_megastep_is_the_per_step_trajectory(mode):
    ds = _small_dataset()
    kw = dict(augmix=mode != "plain", js_lam=JS_LAM, augmix_mode="js" if mode == "plain" else mode)
    a, gen = [_fresh_state(i) for i in range(MEMBERS)], torch.Generator().manual_seed(2)
    for idx in CHUNK:
        last = tt.ensemble_train_step(a, torch.from_numpy(ds.train_images[idx]),
                                      torch.from_numpy(ds.train_labels[idx]), gen, **kw)
    mega = tt.make_ensemble_megastep(device="cpu", **kw)
    b, metrics = mega([_fresh_state(i) for i in range(MEMBERS)], torch.from_numpy(ds.train_images),
                      torch.from_numpy(ds.train_labels), CHUNK, torch.Generator().manual_seed(2))
    assert metrics["loss"].shape == (3, MEMBERS) and all(torch.equal(last[k], metrics[k][-1]) for k in last)
    assert all(s.step == 3 and _same_params(s.model, t.model) for s, t in zip(a, b))


@pytest.mark.parametrize("augmix", [True, False], ids=["augmix", "clean"])
def test_kd_megastep_is_the_per_step_trajectory(augmix):
    ds = _small_dataset()
    teachers = [_fresh_state(10 + i).model.eval() for i in range(MEMBERS)]
    a, gen = _fresh_state(), torch.Generator().manual_seed(3)
    for idx in CHUNK:
        last = td.kd_step(a, teachers, torch.from_numpy(ds.train_images[idx]), torch.from_numpy(ds.train_labels[idx]),
                          gen, KD_T, HARD_W, augmix)
    mega = td.make_kd_megastep(teachers, KD_T, HARD_W, augmix, device="cpu")
    b, metrics = mega(_fresh_state(), torch.from_numpy(ds.train_images), torch.from_numpy(ds.train_labels), CHUNK,
                      torch.Generator().manual_seed(3))
    assert _same_params(a.model, b.model) and torch.equal(last["loss"], metrics["loss"][-1])


def test_sam_passes_see_the_same_dropout_masks(monkeypatch):
    """With dropout on, both SAM passes draw the same masks, and the
    generator ends where one pass leaves it."""
    drawn = []
    real = tt.augmix_objective

    def spy(model, *args):
        g = args[-1]
        drawn.append(g.get_state().clone())
        out = real(model, *args)
        drawn.append(g.get_state().clone())
        return out

    monkeypatch.setattr(tt, "augmix_objective", spy)
    x = torch.rand((4, 32, 32, 3), generator=torch.Generator().manual_seed(0))
    y = torch.arange(4)
    gen = torch.Generator().manual_seed(4)
    tt.sam_step_core(_fresh_state(), x, y, x, x, JS_LAM, RHO, gen)
    assert torch.equal(drawn[0], drawn[2]) and torch.equal(drawn[1], drawn[3])
    assert not torch.equal(drawn[0], drawn[1]) and torch.equal(gen.get_state(), drawn[3])
