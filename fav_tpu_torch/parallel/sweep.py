"""The 15 corruptions x 5 severities evaluation grid, on one device or
sharded over a mesh's batch axes (``fav_tpu/parallel/sweep.py``).

Every (corruption, severity) cell corrupts the same images, runs the
model and scores failure detection. The device keeps the corruption, the
forward, the L1 analyzer pass and per-sample scalars; the rows of a chunk
of cells come to the host in one copy, where the rank and bin metrics
(AUROC, AUPR, FPR@95, ECE) are finished in NumPy float64
(:func:`_finalize_cell`, a copy of the JAX package's).

Cell schedule. ``jax.random.fold_in`` cannot be replayed, so a cell's
corruption seed is a Philox function of the grid seed and the cell's
**absolute** index in the ``corruptions x severities`` enumeration
(:func:`cell_key`): chunking never changes a cell's draws. The draws are
statistically, not bitwise, those of the JAX grid.

The families come from ``ops.corruptions_cuda.grid_corruption_fn`` (the
kernels K1-K4 and K6, the band-matrix families, the Philox helper, and
glass as the oracle's 2-D resample); ``plain=True`` takes the plain
versions of ``ops/corruptions.py`` and of the L1 statistics instead.

Sharded grid (:func:`sharded_sweep`). Each rank of the mesh's batch axes
corrupts, scores and analyses its rows, its draws started at its first
row's absolute index (``row`` of the families), so its rows are those of
the whole batch's grid; the per-sample rows of a chunk are gathered over
the batch axes in one collective, and every rank finishes the same metrics
from the whole batch.
"""

from __future__ import annotations

import hashlib
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from fav_tpu_torch.config import AnalyzerParams
from fav_tpu_torch.models.calibration import (
    aupr,
    auroc,
    brier_score,
    expected_calibration_error,
    failure_labels,
    fpr_at_95_tpr,
)
from fav_tpu_torch.models.uncertainty import anomaly_from_confidence, energy_score, mutual_information
from fav_tpu_torch.ops import corruptions as plain_ops
from fav_tpu_torch.ops import corruptions_cuda
from fav_tpu_torch.ops.corruptions import CORRUPTION_NAMES
from fav_tpu_torch.ops.random import fold_in as _fold_in
from fav_tpu_torch.ops.signal import analyze_frame, init_analyzer_carry
from fav_tpu_torch.parallel.mesh import Mesh, all_gather_rows, data_sharding

__all__ = [
    "GRID_SEED",
    "SEVERITIES",
    "cell_key",
    "corruption_sweep",
    "fused_sweep",
    "l1_rows",
    "sharded_sweep",
    "sweep_cell",
]

SEVERITIES = (1, 2, 3, 4, 5)
GRID_SEED = 42  # evaluate's PRNGKey(42)

# the reference analyzer constants, as the grid uses them
_L1_PARAMS = AnalyzerParams()


def cell_key(seed: int, name: str, severity: int, corruptions: Sequence[str] = CORRUPTION_NAMES,
             severities: Sequence[int] = SEVERITIES) -> int:
    """The cell's 64-bit corruption seed: words 0 and 1 of Philox draw
    ``index`` under ``seed``, ``index`` the cell's absolute place in the
    ``corruptions x severities`` enumeration (the counterpart of
    ``fold_in(key, index)``). Every sweep path takes its seeds from here."""
    idx = list(corruptions).index(name) * len(severities) + list(severities).index(severity)
    return _fold_in(seed, idx)


def l1_rows(corrupted: torch.Tensor, plain: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """The L1 analyzer over one cell's corrupted batch: float32 RGB in
    [0, 1], [B, H, W, C] -> per-sample ``(status int32 [B], anomaly float32
    [B])`` (``_l1_rows``, :75-92).

    Each image becomes a BGR uint8 frame, ``round(x 255)`` (half to even,
    as ``jnp.round``), analyzed with a fresh carry: no temporal context, so
    FROZEN cannot fire and the rows depend only on the batch. On the card
    the statistics come from one K7 launch, unless ``plain`` asks for the
    plain versions."""
    frames = torch.round(corrupted.flip(-1) * 255.0).to(torch.uint8)
    carry = init_analyzer_carry(corrupted.shape[-3], corrupted.shape[-2], corrupted.shape[:-3],
                                device=corrupted.device)
    _, m = analyze_frame(_L1_PARAMS, carry, frames, plain=plain)
    return m.status, m.anomaly_score


def _member_mi(logits: torch.Tensor, temperature) -> torch.Tensor:
    """BALD mutual information [B] of stacked member logits [M, B, C]."""
    return mutual_information(torch.softmax(logits / temperature, dim=-1))


def _split_output(out):
    """A forward may return ``(logits, extra)``, ``extra`` a dict of
    per-sample rows [B], higher more anomalous (the Mahalanobis scores);
    each becomes ``auroc_<name>`` and ``mean_<name>`` of a cell. Plain
    logits pass through as ``(logits, None)``."""
    if isinstance(out, tuple):
        return out
    return out, None


def _reduce_members(logits: torch.Tensor, temperature):
    """Stacked member logits [M, B, C] -> (their mean, the BALD row, the
    vote agreement: the share of members whose argmax is the mean's).
    Single-model [B, C] logits pass through as ``(logits, None, None)``."""
    if logits.ndim == 3:
        mean_logits = logits.mean(dim=0)
        ens_pred = mean_logits.argmax(dim=-1)
        member_pred = logits.argmax(dim=-1)
        agree = (member_pred == ens_pred[None, :]).to(torch.float32).mean(dim=0)
        return mean_logits, _member_mi(logits, temperature), agree
    return logits, None, None


def _entropy(probs: torch.Tensor) -> torch.Tensor:
    logp = torch.log(torch.where(probs > 0, probs, torch.ones_like(probs)))
    return -(probs * logp).sum(dim=-1)


def _route(plain: bool, corruption_fn=None):
    if corruption_fn is not None:
        return corruption_fn
    return plain_ops.grid_corruption_fn if plain else corruptions_cuda.grid_corruption_fn


@torch.no_grad()
def sweep_cell(name: str, forward: Callable, images: torch.Tensor, labels: torch.Tensor, seed: int,
               severity: int, temperature: float = 1.0,
               _shard: tuple[int, Callable] | None = None) -> dict[str, torch.Tensor]:
    """One cell: corrupt, forward, score; metrics as 0-dim tensors on the
    images' device (``sweep_cell``, :144). With ``_shard`` (``(row,
    gather)``, :func:`corruption_sweep`'s) the images and labels are rows
    ``row ..`` of the batch, and the logits, extra rows, L1 rows and labels
    are gathered whole before the metrics."""
    row, gather = _shard or (0, None)
    corrupted = _corrupt(corruptions_cuda.grid_corruption_fn, name, seed, images, severity, row)
    logits, extra = _split_output(forward(corrupted))
    l1 = l1_rows(corrupted)
    if gather is not None:
        logits = gather(logits, 1 if logits.ndim == 3 else 0)  # stacked member logits [M, b, C]
        labels = gather(labels)
        extra = None if extra is None else {k: gather(v) for k, v in extra.items()}
        l1 = tuple(gather(v) for v in l1)
    return _cell_metrics(logits, labels, temperature, extra, l1)


def _cell_metrics(logits, labels, temperature, extra=None, l1=None) -> dict[str, torch.Tensor]:
    """A cell's metrics on the device from its logits (``_cell_metrics``, :165)."""
    logits, mi, agree = _reduce_members(logits, temperature)
    probs = torch.softmax(logits / temperature, dim=-1)
    conf = probs.amax(dim=-1)
    preds = probs.argmax(dim=-1)
    fails = failure_labels(preds, labels)
    correct = (preds == labels).to(torch.float32)
    out = {
        "accuracy": correct.mean(),
        "mean_confidence": conf.mean(),
        "mean_entropy": _entropy(probs).mean(),
        "failure_rate": fails.to(torch.float32).mean(),
        "auroc": auroc(1.0 - conf, fails),
        # energy ranks by raw-logit evidence at T = 1
        "auroc_energy": auroc(energy_score(logits), fails),
        "aupr": aupr(1.0 - conf, fails),
        "fpr_at_95": fpr_at_95_tpr(1.0 - conf, fails),
        "ece": expected_calibration_error(conf, correct),
        "brier": brier_score(probs, labels),
        "mean_anomaly": anomaly_from_confidence(conf).mean(),
    }
    if mi is not None:
        out["mean_mi"] = mi.mean()
        out["auroc_mi"] = auroc(mi, fails)
    if agree is not None:
        gated = torch.minimum(conf, agree)
        out["mean_agreement"] = agree.mean()
        out["mean_confidence_vote"] = gated.mean()
        out["auroc_vote"] = auroc(1.0 - gated, fails)
        out["ece_vote"] = expected_calibration_error(gated, correct)
    if extra is not None:
        for k, v in extra.items():
            out[f"mean_{k}"] = v.mean()
            out[f"auroc_{k}"] = auroc(v, fails)
    if l1 is not None:
        status, l1_anom = l1
        composed = torch.maximum(l1_anom, anomaly_from_confidence(conf))
        out["l1_flag_rate"] = (status != 0).to(torch.float32).mean()
        out["l1_blank_rate"] = (status == 2).to(torch.float32).mean()
        out["l1_corrupted_rate"] = (status == 3).to(torch.float32).mean()
        out["l1_mean_anomaly"] = l1_anom.mean()
        out["auroc_l1"] = auroc(l1_anom, fails)
        out["mean_anomaly_composed"] = composed.mean()
        out["auroc_composed"] = auroc(composed, fails)
    return out


class _Stages:
    """Seconds per stage of a grid run, accumulated into ``into`` (corrupt,
    forward, l1, rows, host); on the card by CUDA events, read once per
    chunk. ``into=None`` records nothing."""

    def __init__(self, into: dict | None, device: torch.device):
        self.into = into
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def mark(self, stage: str | None) -> None:
        """End the running stage (if any) here; ``stage`` starts now."""
        if self.into is None:
            return
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        else:
            ev = time.perf_counter()
        self.marks.append((stage, ev))

    def flush(self) -> None:
        if self.into is None or not self.marks:
            return
        if self.cuda:
            torch.cuda.synchronize()
        for (stage, a), (_, b) in zip(self.marks, self.marks[1:]):
            if stage is None:
                continue
            s = a.elapsed_time(b) / 1e3 if self.cuda else b - a
            self.into[stage] = self.into.get(stage, 0.0) + s
        self.marks = []


def _rows_to_host(stacked: dict[str, torch.Tensor], gather=None) -> dict[str, np.ndarray]:
    """Every row of a chunk in ONE device-to-host copy: the rows go out as
    one flat float32 buffer (the int32 statuses, 0..3, are exact there) and
    are split and cast back on the host. ``gather`` maps the flat buffer
    [1, F] to the batch shards' buffers [S, F], shard-major; each row
    [cells, b, ...] then comes back whole, [cells, S b, ...]."""
    names = list(stacked)
    flat = torch.cat([stacked[m].to(torch.float32).reshape(-1) for m in names])[None]
    host = (flat if gather is None else gather(flat)).cpu().numpy()
    out, start = {}, 0
    for m in names:
        v = stacked[m]
        n = v.numel()
        dtype = np.int32 if v.dtype == torch.int32 else np.float32
        shards = host[:, start:start + n].reshape(host.shape[0], *v.shape)
        out[m] = np.concatenate(list(shards), axis=1).astype(dtype)
        start += n
    return out


@torch.no_grad()
def _fused_grid(cells, forward, images, labels, seed, temperature, base, want_probs=False,
                plain: bool = False, stages: _Stages | None = None, corruption_fn=None, row: int = 0,
                gather=None) -> dict[str, np.ndarray]:
    """A chunk of cells: per-sample rows [cells, B] (conf, correct, fail,
    entropy, brier, anomaly, energy, the L1 status and anomaly, and ``mi``,
    ``agree``, ``x_<name>`` and ``probs`` as the forward and ``want_probs``
    give them), on the host after one copy. Cell i of the chunk takes the
    seed of absolute index ``base + i`` (``_fused_grid``, :234). A shard
    passes its first row's index ``row`` and the ``gather`` of
    :func:`_rows_to_host`."""
    return _grid_chunk(cells, forward, None, images, labels, seed, temperature, None, base, want_probs,
                       _route(plain, corruption_fn), plain, stages, row, gather)


@torch.no_grad()
def _fused_grid_monitored(cells, forward, mon_forward, images, labels, seed, temperature, mon_temperature,
                          base, plain: bool = False, stages: _Stages | None = None,
                          corruption_fn=None, row: int = 0, gather=None) -> dict[str, np.ndarray]:
    """:func:`_fused_grid` with a monitor: the predictor's rows plus
    ``mon_conf``, the monitor's confidence on the same corrupted batch
    (``_fused_grid_monitored``, :293)."""
    return _grid_chunk(cells, forward, mon_forward, images, labels, seed, temperature, mon_temperature, base,
                       False, _route(plain, corruption_fn), plain, stages, row, gather)


def _corrupt(route, name: str, seed: int, images: torch.Tensor, sev: int, row: int) -> torch.Tensor:
    """A cell's corruption of ``images``, rows ``row ..`` of their batch (an
    injected router need not take ``row`` on a whole batch)."""
    fn = route(name)
    return fn(seed, images, sev, row=row) if row else fn(seed, images, sev)


def _grid_chunk(cells, forward, mon_forward, images, labels, seed, temperature, mon_temperature, base,
                want_probs, route, plain, stages, row=0, gather=None):
    stages = stages or _Stages(None, images.device)
    stacked: dict[str, list] = {}
    num_classes = None
    for i, (name, sev) in enumerate(cells):
        stages.mark("corrupt")
        corrupted = _corrupt(route, name, _fold_in(seed, base + i), images, sev, row)
        stages.mark("forward")
        raw, extra = _split_output(forward(corrupted))
        logits, mi, agree = _reduce_members(raw, temperature)
        probs = torch.softmax(logits / temperature, dim=-1)
        conf = probs.amax(dim=-1)
        preds = probs.argmax(dim=-1)
        num_classes = num_classes or probs.shape[-1]
        onehot = F.one_hot(labels.long(), num_classes).to(probs.dtype)
        per_sample = {
            "conf": conf,
            "correct": (preds == labels).to(torch.float32),
            "fail": failure_labels(preds, labels).to(torch.float32),
            "entropy": _entropy(probs),
            "brier": ((probs - onehot) ** 2).sum(dim=-1),
            "anomaly": anomaly_from_confidence(conf),
            "energy": energy_score(logits),
        }
        if mon_forward is not None:
            mon_probs = torch.softmax(mon_forward(corrupted) / mon_temperature, dim=-1)
            per_sample["mon_conf"] = mon_probs.amax(dim=-1)
        stages.mark("l1")
        per_sample["l1_status"], per_sample["l1_anomaly"] = l1_rows(corrupted, plain)
        stages.mark(None)
        if mi is not None:
            per_sample["mi"] = mi
            per_sample["agree"] = agree
        if extra is not None:
            for m, v in extra.items():
                per_sample[f"x_{m}"] = v
        if want_probs:
            per_sample["probs"] = probs
        for m, v in per_sample.items():
            stacked.setdefault(m, []).append(v)
    stages.mark("rows")
    host = _rows_to_host({m: torch.stack(vs) for m, vs in stacked.items()}, gather)
    stages.mark(None)
    stages.flush()
    return host


# ── host finalisation: NumPy copies of fav_tpu/parallel/sweep.py:340-504 ──

def _np_auroc(scores, labels):
    """Tie-aware Mann-Whitney AUROC (NumPy mirror of calibration.auroc)."""
    s = np.asarray(scores, np.float64).ravel()
    y = np.asarray(labels, np.float64).ravel()
    order = np.argsort(s, kind="stable")
    s_sorted, y_sorted = s[order], y[order]
    n = s.shape[0]
    ranks = np.arange(1, n + 1, dtype=np.float64)
    is_new = np.concatenate([[True], s_sorted[1:] != s_sorted[:-1]])
    group = np.cumsum(is_new) - 1
    gsum = np.zeros(n)
    gcnt = np.zeros(n)
    np.add.at(gsum, group, ranks)
    np.add.at(gcnt, group, 1.0)
    avg_rank = (gsum / np.maximum(gcnt, 1.0))[group]
    n_pos = y_sorted.sum()
    n_neg = n - n_pos
    u = (avg_rank * y_sorted).sum() - n_pos * (n_pos + 1.0) / 2.0
    return float(u / max(n_pos * n_neg, 1.0))


def _np_aupr(scores, labels):
    """Average precision with tie blocks (mirror of calibration.aupr)."""
    s = np.asarray(scores, np.float64).ravel()
    y = np.asarray(labels, np.float64).ravel()
    order = np.argsort(-s, kind="stable")
    s_sorted, y_sorted = s[order], y[order]
    n = s.shape[0]
    tp = np.cumsum(y_sorted)
    precision = tp / np.arange(1, n + 1)
    n_pos = y_sorted.sum()
    recall = tp / max(n_pos, 1.0)
    is_block_end = np.concatenate([s_sorted[1:] != s_sorted[:-1], [True]])
    ends = np.nonzero(is_block_end)[0]
    r_end = recall[ends]
    p_end = precision[ends]
    r_prev = np.concatenate([[0.0], r_end[:-1]])
    return float(np.sum((r_end - r_prev) * p_end))


def _np_fpr_at_95_tpr(scores, labels):
    """FPR at the first realizable TPR >= 0.95 (mirror of
    calibration.fpr_at_95_tpr, tie blocks grouped)."""
    s = np.asarray(scores, np.float64).ravel()
    y = np.asarray(labels, np.float64).ravel()
    order = np.argsort(-s, kind="stable")
    s_sorted, y_sorted = s[order], y[order]
    tp = np.cumsum(y_sorted)
    fp = np.cumsum(1.0 - y_sorted)
    n_pos = y_sorted.sum()
    n_neg = max(s.shape[0] - n_pos, 1.0)
    tpr = tp / max(n_pos, 1.0)
    is_block_end = np.concatenate([s_sorted[1:] != s_sorted[:-1], [True]])
    reached = (tpr >= 0.95) & is_block_end
    idx = np.nonzero(reached)[0]
    return float(fp[idx[0]] / n_neg) if idx.size else 1.0


def _np_ece(conf, correct, num_bins: int = 15):
    """Equal-width-bin ECE (mirror of calibration.expected_calibration_error;
    the binning uses the same float32 ceil so bin assignment is identical)."""
    c = np.asarray(conf, np.float32).ravel()
    k = np.asarray(correct, np.float64).ravel()
    bins = np.clip(np.ceil(c * np.float32(num_bins)).astype(np.int32) - 1, 0, num_bins - 1)
    n_b = np.zeros(num_bins)
    conf_b = np.zeros(num_bins)
    acc_b = np.zeros(num_bins)
    np.add.at(n_b, bins, 1.0)
    np.add.at(conf_b, bins, c.astype(np.float64))
    np.add.at(acc_b, bins, k)
    n_safe = np.maximum(n_b, 1.0)
    gap = np.abs(acc_b / n_safe - conf_b / n_safe)
    return float(np.sum(np.where(n_b > 0, n_b * gap, 0.0)) / c.shape[0])


def _finalize_cell(ps: dict) -> dict[str, float]:
    """One cell's per-sample rows -> its metric dict (the keys of
    :func:`_cell_metrics`). With a monitor row (``mon_conf``) the detection
    metrics and the operative ECE score the monitor's uncertainty against
    the predictor's failures, the predictor's own kept as ``auroc_self`` /
    ``ece_self``, and the min-gated pair as ``*_gated``. ``1 - conf`` is
    taken in float32 before the float64 cast, as on the device, so the tie
    blocks of the rank metrics match."""
    conf = ps["conf"]
    fails = ps["fail"]
    unc = (1.0 - np.asarray(conf, np.float32)).astype(np.float64)
    score_conf = ps.get("mon_conf", conf)
    score_unc = (1.0 - np.asarray(score_conf, np.float32)).astype(np.float64)
    out = {
        "accuracy": float(np.mean(ps["correct"])),
        "mean_confidence": float(np.mean(score_conf)),
        "mean_entropy": float(np.mean(ps["entropy"])),
        "failure_rate": float(np.mean(fails)),
        "auroc": _np_auroc(score_unc, fails),
        "auroc_energy": _np_auroc(np.asarray(ps["energy"], np.float32).astype(np.float64), fails),
        "aupr": _np_aupr(score_unc, fails),
        "fpr_at_95": _np_fpr_at_95_tpr(score_unc, fails),
        "ece": _np_ece(score_conf, ps["correct"]),
        "brier": float(np.mean(ps["brier"])),
        "mean_anomaly": float(np.mean(ps["anomaly"])),
    }
    if "mi" in ps:
        mi = np.asarray(ps["mi"], np.float32).astype(np.float64)
        out["mean_mi"] = float(np.mean(mi))
        out["auroc_mi"] = _np_auroc(mi, fails)
    if "agree" in ps:
        agree = np.asarray(ps["agree"], np.float32)
        gated = np.minimum(np.asarray(conf, np.float32), agree)
        out["mean_agreement"] = float(np.mean(agree))
        out["mean_confidence_vote"] = float(np.mean(gated))
        out["auroc_vote"] = _np_auroc((1.0 - gated).astype(np.float64), fails)
        out["ece_vote"] = _np_ece(gated, ps["correct"])
    for k in ps:
        if k.startswith("x_"):
            name = k[2:]
            v = np.asarray(ps[k], np.float32).astype(np.float64)
            out[f"mean_{name}"] = float(np.mean(v))
            out[f"auroc_{name}"] = _np_auroc(v, fails)
    if "l1_status" in ps:
        # the composed score is max(analyzer, model) in float32 first, as on the device
        status = np.asarray(ps["l1_status"])
        l1_anom = np.asarray(ps["l1_anomaly"], np.float32)
        composed = np.maximum(l1_anom, np.asarray(ps["anomaly"], np.float32))
        out["l1_flag_rate"] = float(np.mean(status != 0))
        out["l1_blank_rate"] = float(np.mean(status == 2))
        out["l1_corrupted_rate"] = float(np.mean(status == 3))
        out["l1_mean_anomaly"] = float(np.mean(l1_anom))
        out["auroc_l1"] = _np_auroc(l1_anom.astype(np.float64), fails)
        out["mean_anomaly_composed"] = float(np.mean(composed))
        out["auroc_composed"] = _np_auroc(composed.astype(np.float64), fails)
    if "mon_conf" in ps:
        out["auroc_self"] = _np_auroc(unc, fails)
        out["ece_self"] = _np_ece(conf, ps["correct"])
        gated = np.minimum(np.asarray(conf, np.float32), np.asarray(score_conf, np.float32))
        gated_unc = (1.0 - gated).astype(np.float64)
        out["auroc_gated"] = _np_auroc(gated_unc, fails)
        out["ece_gated"] = _np_ece(gated, ps["correct"])
        out["mean_confidence_gated"] = float(np.mean(gated))
    return out


def fused_sweep(
    forward: Callable,
    images: torch.Tensor,
    labels: torch.Tensor,
    seed: int = GRID_SEED,
    corruptions: Sequence[str] = CORRUPTION_NAMES,
    severities: Sequence[int] = SEVERITIES,
    temperature: float = 1.0,
    cells_per_call: int = 0,
    return_probs: bool = False,
    monitor: tuple | None = None,
    return_rows: Sequence[str] = (),
    plain: bool = False,
    timings: dict | None = None,
    corruption_fn: Callable[[str], Callable] | None = None,
    _shard: tuple[int, Callable] | None = None,
) -> Any:
    """The grid in chunks of ``cells_per_call`` cells (0: all in one), one
    device-to-host copy of rows per chunk, metrics finished on the host
    (``fused_sweep``, :507). ``forward`` maps NHWC images to logits [B, C],
    stacked member logits [M, B, C], or ``(logits, extra rows)``.

    * ``return_probs``: also the temperature-scaled prob rows, returned as
      ``(results, cells, probs)`` for conformal scoring;
    * ``return_rows``: also the named per-sample rows, as ``(results, cells,
      {name: [cells, B] ndarray})`` for the policy replay;
    * ``monitor=(mon_forward, mon_temperature)``: the decoupled pair,
      predictions from ``forward`` and the failure score from the
      monitor's confidence on the same corrupted batch (exclusive with
      ``return_probs``);
    * ``plain``: the plain versions instead of the kernels;
    * ``corruption_fn``: maps a family name to ``fn(seed, x, severity)`` in
      place of the grid router (the tests feed it ``fav_tpu``'s batches);
    * ``timings``: a dict that gains the seconds spent in ``corrupt``,
      ``forward``, ``l1``, ``rows`` (the copy) and ``host`` (finalising).

    Chunking never changes a result: each cell's seed folds in its absolute
    index. ``_shard`` (:func:`sharded_sweep`'s) is ``(row, gather)``: the
    images are rows ``row ..`` of the batch and ``gather`` makes each
    chunk's rows whole."""
    row, gather = _shard or (0, None)
    if monitor is not None and return_probs:
        raise ValueError("monitor and return_probs are mutually exclusive")
    if return_rows and return_probs:
        raise ValueError("return_rows and return_probs are mutually exclusive")
    cells = tuple((str(n), int(s)) for n in corruptions for s in severities)
    step = cells_per_call or len(cells)
    stages = _Stages(timings, images.device)
    host: dict[str, list] = {}
    for start in range(0, len(cells), step):
        chunk = cells[start:start + step]
        if monitor is not None:
            mon_forward, mon_temperature = monitor
            out = _fused_grid_monitored(chunk, forward, mon_forward, images, labels, seed, temperature,
                                        mon_temperature, start, plain, stages, corruption_fn, row, gather)
        else:
            out = _fused_grid(chunk, forward, images, labels, seed, temperature, start, return_probs, plain,
                              stages, corruption_fn, row, gather)
        for m, v in out.items():
            host.setdefault(m, []).extend(v)
    t = time.perf_counter()
    probs_rows = host.pop("probs", None)
    results: dict[str, dict[int, dict[str, float]]] = {}
    for i, (name, sev) in enumerate(cells):
        results.setdefault(name, {})[sev] = _finalize_cell({m: host[m][i] for m in host})
    if timings is not None:
        timings["host"] = timings.get("host", 0.0) + time.perf_counter() - t
    if return_probs:
        return results, cells, probs_rows
    if return_rows:
        missing = [r for r in return_rows if r not in host]
        if missing:
            raise KeyError(f"requested rows not in sweep output: {missing}")
        return results, cells, {r: np.stack(host[r]) for r in return_rows}
    return results


def corruption_sweep(
    forward: Callable,
    images: torch.Tensor,
    labels: torch.Tensor,
    seed: int = GRID_SEED,
    corruptions: Sequence[str] = CORRUPTION_NAMES,
    severities: Sequence[int] = SEVERITIES,
    temperature: float = 1.0,
    _shard: tuple[int, Callable] | None = None,
) -> dict[str, dict[int, dict[str, float]]]:
    """The grid cell by cell (``corruption_sweep``, :601): each cell's
    metrics finished on the device by ``sweep_cell`` and fetched as floats.
    The seeds are :func:`fused_sweep`'s, so both paths corrupt alike.
    ``_shard`` (:func:`sharded_sweep`'s) is ``(row, gather)``: the images
    and labels are rows ``row ..`` of the batch, and ``gather(t, dim=0)``
    makes a cell's rows whole."""
    results: dict[str, dict[int, dict[str, float]]] = {}
    for i, (name, sev) in enumerate((n, s) for n in corruptions for s in severities):
        cell = sweep_cell(name, forward, images, labels, _fold_in(seed, i), sev, temperature, _shard)
        results.setdefault(name, {})[sev] = {m: float(v) for m, v in cell.items()}
    return results


def _fingerprint(tensors) -> str:
    """A digest of tensors' bytes, shapes and dtypes."""
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().contiguous().cpu()
        h.update(f"{tuple(t.shape)}{t.dtype}".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _check_replicated(tensors) -> None:
    """Raises unless every rank of the world holds the same ``tensors``."""
    digest = _fingerprint(tensors)
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, digest)
    differ = [r for r, d in enumerate(everyone) if d != digest]
    if differ:
        raise ValueError(f"sharded_sweep: ranks {differ} hold other parameters or images than rank "
                         f"{dist.get_rank()}; the grid needs them replicated")


@torch.no_grad()
def sharded_sweep(
    mesh: Mesh,
    forward: Callable,
    images: torch.Tensor,
    labels: torch.Tensor,
    seed: int = GRID_SEED,
    corruptions: Sequence[str] = CORRUPTION_NAMES,
    severities: Sequence[int] = SEVERITIES,
    temperature: float = 1.0,
    fused: bool = False,
    cells_per_call: int = 0,
    return_probs: bool = False,
    monitor: tuple | None = None,
    return_rows: Sequence[str] = (),
    params: Sequence[torch.Tensor] = (),
    timings: dict | None = None,
) -> Any:
    """The grid with the batch sharded over the mesh's batch axes (``data``,
    or ``("dcn", "data")`` on a multi-slice mesh) and the model replicated
    (``sharded_sweep``, :627). Every rank passes the whole batch and the
    same ``forward``; ``params`` (the tensors of the forward's modules, and
    the monitor's) are checked on entry to be the same on every rank, with
    the images and labels. Each rank runs its rows; every rank returns the
    same results, those of :func:`fused_sweep` (``fused=True``, with its
    ``cells_per_call``, ``return_probs``, ``monitor`` and ``return_rows``)
    or :func:`corruption_sweep` on the whole batch: their per-sample rows
    bit for bit where the forward and the band products compute an image
    alone in the same arithmetic at any batch size, as on the CPU; on a
    card cuDNN and cuBLAS pick their algorithms by the shape, so a shard's
    rows may differ from the whole batch's in the last bits."""
    if not fused and monitor is not None:
        raise ValueError("monitor requires the fused sweep path")
    if not fused and return_rows:
        raise ValueError("return_rows requires the fused sweep path")
    _check_replicated([*params, images, labels])
    rows = data_sharding(mesh, images.shape[0])
    local_x, local_y = images[rows].contiguous(), labels[rows].contiguous()
    def gather(t, dim=0):
        return all_gather_rows(t, mesh, mesh.batch_axes, dim=dim)

    shard = (rows.start, gather)
    if fused:
        return fused_sweep(forward, local_x, local_y, seed, corruptions, severities, temperature, cells_per_call,
                           return_probs, monitor, return_rows, timings=timings, _shard=shard)
    return corruption_sweep(forward, local_x, local_y, seed, corruptions, severities, temperature, _shard=shard)
