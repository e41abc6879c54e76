#!/usr/bin/env python3
"""Drive fav_tpu_torch on one NVIDIA card: build the CUDA kernels, hold each
to its plain PyTorch version, run the fifteen-family detection megastep of
``bench.py``'s cells with the nano student, run the frame-analysis service
on scripted camera streams and the grid's L1 pass into the policy replay,
train the ``classifier`` configuration with AugMix for a few steps, run the
packed A/B of glass and elastic, serve the decision-support app's live path
and its socket, run the 15x5 evaluation grid through the port's CLI, then
the other model families and the multi-forward scorers in the server and
the grid, train every remaining objective (SAM, DeepAugment, the AugMix
options, ensembles, KD, MC distillation, the autoencoder) and the pretrain
CLI, serve the Mahalanobis feature distance and run the fit and replay
tools, quantise to int8, run the parallel paths on a world of one rank
(offset draws, the sharded grid, ``pretrain --shard``, the tensor-parallel
ViT), and report.

    python3 chip_smoke.py             # what the checks run
    python3 chip_smoke.py --profile   # adds torch.profiler tables of one megastep, one analyzer batch,
                                      # one train step and 30 live ticks of the server

Phases, each printing one ``[chip_smoke]`` line with its elapsed seconds:

1. device   -- exit non-zero at once without CUDA; print the card's name and
               power limit from nvidia-smi; float32 matmuls and convolutions
               in full float32 (TF32 off, printed);
2. build    -- compile ``fav_tpu_torch/ops/csrc`` with plain nvcc for sm_90a
               into ``build/torch_kernels/``, one nvcc per source started
               together (must stay under 60 s);
3. kernels  -- at the megastep's shape (6144, 32, 32, 3) float32, each kernel
               K1-K6 and the Philox helper against its plain version on the
               card, with its time, the plain version's time, its bound and,
               for K6, the time of ``grid_sample`` computing the same warp,
               K1 also at (7, 33, 31, 3), on a 16-byte base and on a base
               off 16 bytes (the tail and element-by-element loops),
               for K2 of ``torch.poisson`` (the draw only) and for the
               helper of ``torch.rand`` (each beside its output's mean); K2
               at severities 1-5 there and at (7, 33, 31, 3) on a base off
               16 bytes, timed at severities 3 and 1; K5 exact at
               severities 1-5 there, at (7, 33, 31, 3) and at (7, 32, 32, 3)
               on a base off 16 bytes; K5p exact to its plain version and
               to K5 at severities 1-5 there and at (12, 33, 31, 3) and
               (6, 32, 32, 3) on a base off 16 bytes;
               K7 (frame statistics and histogram) at the service's
               (32, 240, 320) and the grid's (6144, 32, 32), exact, beside
               ``torch.bincount``'s time for the histogram part, and exact
               at (3, 241, 317), (5, 2, 2) and (1, 1024, 2048) on a base
               off a 16-byte boundary (flat frames and pixels outside
               0..255 in every shape); K8
               (corrupt-normalize) at sigma 0 and 0.18 at (6144, 32, 32, 3)
               and at (7, 33, 31, 3) on a base off 16 bytes;
               K9a and K9b (the AugMix shear passes) at an AugMix view's
               chain batch (768, 32, 32, 3), m = 18 and 22, exact, beside
               ``grid_sample`` computing the same shear, in float32 and in
               bfloat16 (the ``--bf16-aug`` chain; also exact at (7, 33,
               31, 3) on a base off 16 bytes, bf16 K9a at (4, 16, 5000,
               3), whose rows pass a block's stage and go by windows, and
               bf16 K9b there and at (4, 5000, 16, 3), whose images pass
               its stage and go to the direct kernel, each by the unit its
               geometry names),
               with ``Tensor.copy_`` of the same bytes; then one line for
               the kernels redesigned last (K1, bf16 K9a, bf16 K9b): time,
               bound and share of the bound; K5p and K6p (the
               lane-packed glass and elastic kernels) at (6144, 32, 32, 3)
               against their plain versions and against K5 and K6, exact,
               K6p at severities 1-5, at batch 6144 and at batch 12 on a
               base off a 16-byte boundary, beside ``grid_sample``;
4. golden   -- the nano student's bf16 logits on fixed images against the
               JAX package's, committed in ``weights/student_nano.golden.json``;
5. megastep -- one megastep at batch 6144 over all fifteen cells with the
               launch counts reset just before and read just after (K1, K2,
               K3, K5, K6 once each, K4 twice); 2 warm-up and 8 timed
               megasteps; each family's corruption time; then one megastep
               against the same megastep through the plain versions;
6. monitor  -- the analysis service at 240x320, capacity 64, with 32
               scripted streams (8 each OK, frozen, blank, corrupted) for 60
               ticks at 30 Hz, counts reset just before: K7 once per
               dispatched batch; statuses and anomalies against the JAX
               package's golden (``weights/monitor.golden.json``); the same
               frames through a service on the plain versions give the same
               results, and both replay (tiled to 900 ticks) to the same
               policies; the trust goldens; the batched analyzer's frames/s,
               the service's dispatch-to-result latency, the replay's ms;
7. policy   -- the 15 ``BENCH_CELLS`` at batch 6144, severity 3: corrupt,
               ``l1_rows`` (K7), the nano confidence and ``grid_policy`` over
               900 ticks, counts reset just before (K7 15 times); ``l1_rows``
               through K7 equal to ``l1_rows`` through the plain versions;
8. train    -- first the JAX package's float32 AugMix step at widths (8, 16)
               (``weights/train_step.golden.json``: its draws, loss and
               per-leaf sums) reproduced through K9a/K9b; then the
               ``classifier`` configuration (widths 64/128/256, dense 256,
               dropout 0.1, bf16) from ``init_params`` on the synthetic set,
               AugMix with JS 12, batch 256, lr 1e-3: 2 warm-up steps and 20
               timed steps as two megastep chunks of 10, counts reset just
               before (K9a 4 and K9b 2 in the first step, 88 and 44 in all);
               the loss finite and falling; the views bit-equal between the
               kernel and the plain route, one step of each within a stated
               tolerance; ms per step, images/s and the split into
               augmentation, forward+backward and optimizer (CUDA events);
9. packed   -- ``fav_tpu_torch.tools.ab_packed_kernels.run_ab`` at batch
               6144: the kernel arms (glass and elastic at severities 3 and
               5, packed and unpacked, interleaved, median ms), the packed
               and unpacked outputs of each equal bit for bit; the megastep
               arms (``make_megastep(packed=True)`` and ``(packed=False)``),
               one megastep of each from equal generators with the counts
               reset just before (K5p and K6p once in the packed one, K5
               and K6 once in the unpacked one), outputs within the
               megastep tolerance, ms per megastep and img/s;
10. serve   -- the decision-support server (``serving/app.py``): for the
               default deployment (msp on ``student_nano``) and then the
               ``gated`` preset (``student_std`` gated by ``student_nano``),
               ``ConnectionState``s with the AnalysisService (240x320,
               capacity 64) and the InferenceService on the card, on
               scripted streams (8 each OK, frozen, blank, corrupted; no
               camera or cv2 needed) for 60 ticks: 32 streams (the
               services' bucket 32), one frozen stream (bucket 1, one
               camera, the usual load) and one stream of each kind (bucket
               8). Each set runs first in lockstep (each frame analyzed and
               scored before its tick, as the golden was written: final
               statuses and policies equal to the JAX app's, reliabilities
               within 1e-6, every frame analyzed and scored once, the
               set's bucket used), then through ``_tick_live`` at 30 Hz
               with the streams' own pipelines (statuses equal to the JAX
               app's, policies equal or one step less restrictive, as a
               late onset leaves them; the onset and frame lag printed);
               counts reset just before each run and read once its frames
               are back: K7 once per dispatched analysis batch and no other
               kernel; ``--profile`` adds the device's busy share over 30
               more paced ticks of the 32 streams; the service's rows for
               the golden's frames (``score_batch``) against the JAX
               service's (argmax equal, ``tools/scripted_serve.py``'s bf16
               bounds); tick wall p50/p99, both services' batch latencies,
               frames scored and analyzed per second and which JPEG encoder
               served. Then ``create_app``
               on 127.0.0.1 and a free port, driven by a stdlib-socket
               client: ``/health``, the three pages, the upload whitelist,
               ``/ws`` states with the JAX app's keys falling under
               ``set_vision frozen``, ``/ws/playground`` equal to the golden
               replay;
11. grid    -- the evaluation grid through the port's CLI
               (``fav_tpu_torch.models.evaluate``, the dataset made once):
               (a) ``classifier`` over all 75 cells at 2048 images a cell,
               counts reset just before (K1-K3 and K6 5 times, K4 10, K7
               75, K5 0, the Philox helper 85), then again timed warm with
               the split into corruption, forward, L1, the rows' copy and
               the host finalize (``--profile`` adds the device's busy
               share over a third run); (b) the ``gated`` pair
               (``--checkpoint student_std --monitor student_nano
               --policy``), the same counts; both held per cell to the JAX
               CLI's grids (``weights/grid.golden.json``; bounds at
               ``GRID_*``); (c) the 15 severity-3 cells at 512 images
               through the kernels and through the plain versions from the
               same seeds: conf within 2e-3, argmax and L1 status equal on
               at least 99.9% of rows; (d) ``--conformal 0.1`` (the
               randomised clean sets cover within 4 binomial standard
               errors of 0.9; the reported sets, which also hold the
               argmax, at least that and within 4 SE of the JAX CLI's) and
               ``--maha`` (every cell with failures scores a finite
               Mahalanobis and relative-Mahalanobis AUROC);
12. families -- the other model families and the multi-forward scorers:
               (a) the bf16 forwards of the ``vit`` copy (dim 128, depth
               4), each of the five ``ensemble`` members (vgg 64/128/256),
               the ``autoencoder`` (32/64/128, latent 128) and ResNetSmall
               at 64/128/256 (parameters from a numpy seed, no weights
               travel) on the golden images, against the JAX package's
               eager outputs (logits within 0.125 and argmax on clear
               margins; the autoencoder's per-image error within 1%
               relative); (b) the server's ``mc_dropout`` (20 replicas of
               ``classifier`` in one folded forward), ``ensemble`` and
               ``autoencoder`` modes, 32 scripted streams for 60 ticks in
               lockstep and at 30 Hz as in phase 10 (K7 once per analysis
               batch and no other kernel; final states equal to the JAX
               app's in lockstep; the source the mode's weight copy; rows
               against the JAX service's: the bf16 class, the autoencoder's
               relative error, MC dropout's sampling bounds; frames scored
               a second, inference and tick p50/p99); (c) the CLI's
               ``--ensemble 5``, ``--mc-dropout 4``, ``--tta 3`` and
               ``--arch vit --checkpoint vit`` at the reduced size of their
               JAX goldens (``weights/grid.golden.json`` ``families``: five
               families, 512 images a cell), the JSON keys equal and every
               cell within the phase-11 bounds widened as 1 / sqrt(n);
               (d) ``--ensemble 5``, ``--mc-dropout 20``, ``--tta 3`` and
               ``--arch vit`` at the CLI's defaults (75 cells x 2048),
               counts reset just before each: the grid's corruption and K7
               launches in every path, K9a 300 and K9b 150 under ``--tta
               3``; wall and split;
13. trainers -- the JAX package's SAM, DeepAugment, ensemble (``ce``) and
               KD steps at widths (8, 16) and its bfloat16 view with every
               op option (``weights/trainers.golden.json``), their views
               made from its draws through K9a/K9b, held to the CPU
               tolerances; then each remaining trainer at the width of the
               checkpoint it made, on one fixed batch of 256 synthetic
               images, 2 warm-up and 10 timed steps, counts reset just
               before and read just after: SAM (rho 0.05) on the
               ``classifier`` recipe, DeepAugment with ``weights/
               autoencoder``, the ``freq``, ``occlude`` and ``bars`` op
               options (K9a 4 and K9b 2 a step each), ``--bf16-aug`` (the
               bfloat16 pair 4 and 2, the float32 pair 0), a 5-member
               ensemble in plain CE (no kernel) and ``--augmix-ce`` (K9a
               10, K9b 5), KD from ``weights/ensemble`` into 32/64/128 with
               AugMix at T 2 (K9a 2, K9b 1), ``--distill-mc 20`` from
               ``weights/classifier`` and the 32/64/128 autoencoder (no
               kernel); the loss finite and falling over the timed steps,
               ms a step, training images a second and the split into views
               or teacher targets, forward+backward and the optimizer (CUDA
               events); then the pretrain CLI in seven modes for 2 steps,
               its weights read back by ``load_weights``;
14. maha    -- the server's Mahalanobis column: copies of ``student_nano``
               and ``student_std`` in a temporary directory, each with the
               fit ``fav_tpu`` wrote (``weights/<stem>.maha_golden.npz``)
               beside it as ``<stem>.maha_fit.npz``; the shipped ``msp``,
               ``msp`` with the fit and ``gated`` with the fit driven as in
               phase 10 over the 32 streams (K7 once per analysis batch and
               no other kernel; final states equal to the JAX app's; the
               rows but the distance against ``serve.golden.json``), the
               distance in column 6 (7 under ``gated``) of every last
               tick's scores and on the golden's frames within
               ``MAHA_FDIST_ATOL`` of ``fav_tpu``'s (``weights/
               maha.golden.json``), the inference micro-batch p50 with and
               without the column; a stale fit (another width) warned about
               and left out; ``create_app`` with the fit on 127.0.0.1: a
               live stream (a stand-in source) carrying
               ``ml_inference.feature_distance``, then ``/api/metrics``
               saying ``feature_distance``, a simulation session's
               ``get_log`` CSV replayed by ``fav_tpu_torch.tools.replay``
               (exit 0; with one reliability moved, exit 1 at that row); then
               ``fav_tpu_torch.tools.fit_maha`` on ``student_nano`` at
               10240 images, its wall time, its quantiles against
               ``fav_tpu``'s fit within ``MAHA_QUANTILE_SPAN_RTOL`` of the
               span;
15. quant   -- W8A8 quantisation (``models/quant.py``): the ``classifier``
               calibrated on 256 synthetic test images, over 1024 of them
               int8 accuracy at least the bf16 forward's less 0.01 and mean
               |d confidence| under 0.02 (``tests/test_quant.py``'s
               bounds); the ``im2col`` (``torch._int_mm``) and ``conv``
               (float64) int32 outputs equal to the bit on every quantised
               layer of ``classifier`` and ``student_nano`` at batch 64; the
               quantised nano on its golden images against ``fav_tpu``'s
               (``weights/quant.golden.json``: scales within two bf16 steps,
               logits under its scales within 0.125, argmax on clear
               margins); the bf16, int8 ``im2col`` and int8 ``conv``
               forwards of ``student_nano`` at batch 6144 and
               ``classifier`` at 2048, timed; no hand kernel launched;
16. parallel -- a world of one rank (``parallel/dist.py:init_world`` on the
               card, NCCL over a ``file://`` store), its NCCL version and a
               ``(1, 1, 1)`` mesh: K1-K3, the Philox helper (the elastic,
               snow, glass and octave draw shapes) and K6's fields on rows
               [1024, 2048) of a (2048, 32, 32, 3) batch at offset 1024,
               bit-equal to those rows of the whole batch's call and held
               to their plain versions at offset, each timed with and
               without the offset; ``sharded_sweep`` (the NCCL gather of
               each chunk's rows) on ``classifier`` over the 75 cells of
               2048 images, its per-sample rows and metrics equal to
               ``fused_sweep``'s bit for bit, both timed; ``pretrain
               --ensemble 5 --shard`` (widths 64/128/256, batch 256,
               AugMix, 3 steps) against ``pretrain --ensemble 5``; the
               tensor-parallel ``vit`` at batch 2048 against its plain
               bf16 forward; the world left before the report. Its
               launches (the sharded grid's and the training run's) join
               each kernel's count under the ``parallel`` path.

The line before the last is one JSON object listing every kernel; the last
line is ``{"ok": true, "device": {...}}``. Any failed check raises, and the
script exits non-zero without printing a result. A watchdog ends a hung run
after 480 s with every thread's stack.
"""

import faulthandler
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
REPO_DIR = Path(__file__).resolve().parent

WARMUP = 2
ITERS = 8
SEED = 20240611  # images, per-kernel seeds and megastep seeds all derive from it
BUILD_LIMIT_S = 60.0

# Card peaks by nvidia-smi name: device-memory bytes/s and float32 operations/s
# outside the tensor cores (NVIDIA data sheets, dense rates at the full power
# limit). 32-bit integer operations are counted at the float32 rate, which no
# integer pipe exceeds, so the bound stays a bound.
CARD_PEAKS = (
    ("H100 80GB HBM3", 3.35e12, 67e12),  # SXM
    ("H100 NVL", 3.9e12, 60e12),
    ("H100 PCIe", 2.0e12, 51e12),
    ("H200", 4.8e12, 67e12),
)

# Scalar operations per element, counted from csrc/corruptions.cu: one
# Philox4x32-10 call is 10 rounds of 2 mul.lo, 2 mul.hi, 4 xor and 2 key adds
# (100 operations) and feeds 4 elements; the uniform map is 4; logf, expf,
# cosf and sqrtf are taken as 12, 10, 16 and 4 (estimates of the math
# library's instruction counts); a clip is 2.
PHILOX_PER_ELEMENT = 100 / 4
OPS_PER_ELEMENT = {
    "gaussian_noise": 2 * PHILOX_PER_ELEMENT + 2 * 4 + 12 + 4 + 16 + 4 + 1 + 2,
    "impulse_noise": PHILOX_PER_ELEMENT + 4 + 2 + 1,
    # shot: set-up (Philox, uniform, lam, logf, the first expf, divide, clip)
    # plus SHOT_OPS_PER_TERM for every further term the data needs
    "shot_noise": PHILOX_PER_ELEMENT + 4 + 1 + 12 + 10 + 2 + 2,
    "brightness": 1 + 2,
    "contrast": 1 + 4 + 2,
}
SHOT_OPS_PER_TERM = 10 + 4 + 2  # expf, three adds and a subtract, compare and branch
# The Philox helper: a quarter Philox call and the uniform map per element.
PHILOX_UNIFORM_OPS = PHILOX_PER_ELEMENT + 4
# K5, per pixel and pass (shared over channels): a quarter Philox call, the
# uniform map, the code (multiply, floor, min) and the source index (add,
# two clamps, a multiply-add).
GLASS_OPS_PER_PIXEL_PASS = PHILOX_PER_ELEMENT + 4 + 3 + 5
# K6 per pixel: dy and dx and their floors (4) and four tents of 4; then
# for each channel a multiply-add (2) for every live pair of taps and a
# weighted add (2) for every live row. A tap is live where its tent is not
# zero and its offset lies in [-m, m + 1]: at most the two at floor(d) and
# floor(d) + 1 on each axis, the only ones K6 sums; the rest add zeros.
ELASTIC_OPS_PER_PIXEL = 4 + 4 * 4
ELASTIC_OPS_PER_PAIR = 2
ELASTIC_OPS_PER_ROW = 2


def elastic_live_ops(ys, xs, m: int, c: int) -> float:
    """K6's operations on the coordinates ``ys``, ``xs`` (B, H, W), counting
    only the live taps."""
    import torch

    _, h, w = ys.shape

    def live(d):
        n = torch.zeros_like(d)
        for t in (torch.floor(d), torch.floor(d) + 1):
            n += ((t >= -m) & (t <= m + 1) & (1.0 - (d - t).abs() > 0)).float()
        return n

    ny = live(ys - torch.arange(h, dtype=ys.dtype, device=ys.device).view(1, h, 1))
    nx = live(xs - torch.arange(w, dtype=xs.dtype, device=xs.device).view(1, 1, w))
    ops = ELASTIC_OPS_PER_PIXEL + c * ny * (ELASTIC_OPS_PER_PAIR * nx + ELASTIC_OPS_PER_ROW)
    return float(ops.double().sum())


# Philox helper launches in one megastep: motion 1, snow 2, frost 5, fog 5, elastic 2.
PHILOX_DRAWS_PER_MEGASTEP = 15
# Launches of one megastep over the 15 cells: K1-K3, K5 and K6 once, K4
# twice (brightness and contrast), the helper 15 times.
MEGASTEP_LAUNCHES = {"gaussian_noise": 1, "shot_noise": 1, "impulse_noise": 1, "photometric": 2,
                     "glass_resample": 1, "glass_resample_packed": 0, "elastic_warp": 1, "elastic_warp_packed": 0,
                     "frame_stats": 0, "corrupt_normalize": 0, "shear_rows": 0, "shear_cols": 0,
                     "shear_rows_bf16": 0, "shear_cols_bf16": 0,
                     "philox_uniform": PHILOX_DRAWS_PER_MEGASTEP}
# The packed megastep: K5p and K6p in place of K5 and K6.
PACKED_MEGASTEP_LAUNCHES = {**MEGASTEP_LAUNCHES, "glass_resample": 0, "glass_resample_packed": 1,
                            "elastic_warp": 0, "elastic_warp_packed": 1}

# Tolerances of kernel against plain version, on the same inputs on the card.
K1_TOL = 1e-5  # logf/cosf/sqrtf ulps between the kernel's and PyTorch's builds
K4_CONTRAST_TOL = 1e-6  # the per-image mean is summed in another order
K2_MAX_TIE_FRACTION = 1e-4  # counts may differ only where u sits on a CDF partial sum
# K2 held at every severity (k_max 145 .. 25) and, on a base 4 bytes off a
# 16-byte boundary, at a shape whose element count is a multiple neither of
# 4 nor of a warp's chunk; timed at severity 3 (the main path's) and 1 (the
# most terms)
K2_ODD_SHAPE = (7, 33, 31, 3)
K2_TIMED_SEVERITIES = (3, 1)
# K5 held exactly at every severity (m 1..4, 1..3 rounds), at the odd shape
# (H W not a multiple of 4: Philox groups straddle images) and at batch 7 of
# 32x32, both on a base 4 bytes off a 16-byte boundary
K5_ODD_BATCH = 7
# K5p held exactly at every severity, on a base 4 bytes off a 16-byte
# boundary, at 12 images of 33x31 (G = 4; H W = 1023, so Philox groups
# straddle images inside a group) and at 6 of 32x32 (packed_group lowers
# G = 4 to 3, a divisor of 6)
K5P_ODD_SHAPES = ((12, 33, 31, 3), (6, 32, 32, 3))
# K5 (pure selection) and K6 (the plain version's operations in its order,
# no contraction) are held to their plain versions exactly; so are K5p and
# K6p, to theirs and to K5 and K6 (the same draws, taps and order), and the
# Philox helper to uniform01, word for word.
K5_K6_TOL = 0.0
# Megastep through the kernels against the plain versions: the corrupted
# batches differ only as above (the band-matrix families run the same torch
# code on both routes, with bit-equal draws), and the bf16 forward turns
# that into confidence changes far below 2e-3; a failure-rate step is
# 1/92160 at fifteen cells, so 2e-3 allows some 180 images to cross
# conf = 0.5.
MEGASTEP_TOL = 2e-3
# Golden logits: the bf16 forward on the card (cuDNN) against the JAX
# package's eager bf16 forward on the CPU. Both round to bf16 at the same
# points but sum in other orders, so about one activation in 1e5 lands one
# bf16 step apart per layer; on the CPU the port stays within 0.034 of the
# golden logits (tests/test_torch_models.py), and 0.125 leaves room for
# cuDNN's orders. Argmax must agree wherever the golden top-2 margin exceeds
# twice that.
GOLDEN_ATOL = 0.125

# K7 per pixel, the function's own operations, whatever the design: the
# Laplacian (5), the four int64 sums (Σg 1, Σlap 2, Σlap² 3, Σ|g - p| 3) and
# the histogram's range test (2) and count (1).
K7_OPS_PER_PIXEL = 5 + 9 + 3
# the service's bucket 32, the megastep's batch and the evaluation grid's: timed
K7_SHAPES = ((32, 240, 320), (6144, 32, 32), (2048, 32, 32))
# held to the plain version only, on a base 4 bytes off a 16-byte boundary:
# rows not a multiple of the strip and a width not a multiple of 4, the
# smallest frame, the largest the int64 sums allow (n = 2**21), a frame
# whose 2-row strip would pass 48 KB with the block's header, and two whose
# rows pass it (column tiles, each staged row at its own 16-byte phase)
K7_CHECK_SHAPES = ((3, 241, 317), (5, 2, 2), (1, 1024, 2048), (1, 1000, 2000), (1, 3, 3000), (1, 3, 4099))
# the analysis service's other buckets (serving/analysis.py BUCKETS), one
# and up to eight cameras: frame_stats_geometry cuts their frames into
# 4-row strips (60 a frame) where bucket 32 takes 15-row strips. Held to
# the plain version only, on the service's own (aligned) base.
K7_BUCKET_SHAPES = ((1, 240, 320), (8, 240, 320))
# K6p at a batch of fewer groups than its persistent grid has blocks, on a
# base 4 bytes off a 16-byte boundary as well
K6P_SMALL_BATCH = 12
# K8 per element: with noise, K1's (two quarter Philox calls, two uniform
# maps, log, sqrt, cos and three products) and its add; the mean's add; the
# photometric part (4); the clip (2); the normalisation (2).
K8_OPS_PER_ELEMENT = {
    True: 2 * PHILOX_PER_ELEMENT + 2 * 4 + 12 + 4 + 16 + 3 + 1 + 1 + 4 + 2 + 2,
    False: 1 + 4 + 2 + 2,
}
K8_CONSTANTS = {"bright": 0.1, "contrast": 0.5, "mean": 0.5, "scale": 2.0}  # tests/test_pallas.py:89
K8_SIGMAS = (0.0, 0.18)  # as tests/test_pallas.py runs it; gaussian noise's severity-3 sigma
# K8 against its plain version: the per-image mean is summed in another
# order (as K4's contrast); with noise, K1's logf/cosf ulps as well.
K8_TOL = {False: 1e-6, True: 1e-5}
# K7 and the plain version form the same integer sums and divide them once:
# statistics and histograms are held equal, and so is everything the
# analyzer derives from them on the two routes.
# The monitor run against the JAX package's golden: fav_tpu sums in float32
# where the port's statistics are exact (tests/test_torch_signal.py), and
# the service's dicts round the anomaly to 6 digits.
MONITOR_ATOL = 1e-5 + 5e-7
MONITOR_FPS_ITERS = 20
REPLAY_RELIABILITY_TOL = 1e-12
# docs/parity.md:37 through the port's scan: (tick, field, value, tolerance)
TRUST_GOLDENS = (
    (50, "reliability", 0.510000, 1e-6),  # after FROZEN x50
    (80, "reliability", 0.0, 1e-9),  # after BLANK x30
    (180, "reliability", 0.0, 1e-9),  # after CORRUPTED x100
    (380, "reliability", 0.504917, 1e-6),  # after OK x200
    (380, "anomaly_integral", 0.036049, 1e-6),
)

# Phase 8: the classifier configuration (fav_tpu/checkpoints/classifier/
# metadata.json, the pretrain defaults), AugMix with JS 12.
TRAIN_BATCH = 256
TRAIN_LR = 1e-3
TRAIN_JS_LAM = 12.0
TRAIN_WARMUP = 2
TRAIN_CHUNKS = 2
TRAIN_K = 10
TRAIN_BREAKDOWN_STEPS = 3
# A step makes two views, each three shear passes (rows, columns, rows).
K9_LAUNCHES_PER_STEP = {"shear_rows": 4, "shear_cols": 2}
SHEAR_BATCH = 3 * TRAIN_BATCH  # an AugMix view's chain batch: width 3 x B
# K9a/K9b per element, counted from csrc/shear.cu: the clip (2), floor and
# fraction (2), two index adds and two clamps (6), the blend (4).
SHEAR_OPS_PER_ELEMENT = 14
# fav_tpu's golden step against the port's through K9a/K9b on the card (TF32
# off): cuDNN and XLA sum in other orders; the classes of
# tests/test_torch_train.py (loss, ce, js 1e-5 relative; a gradient leaf's
# sum within 1e-4 of its absolute sum; the updated parameters 2e-5 each, so
# a leaf's sum within 2e-5 per element).
TRAIN_GOLDEN_RTOL = 1e-5
# JS is a sum of p (log p - log m) terms of order 0.1 that cancel to some
# 3e-5 at an untrained network, where float32 leaves a few ulps of those
# terms: js is held to 1e-5 relative or 1e-7 absolute.
TRAIN_GOLDEN_JS_ATOL = 1e-7
TRAIN_GOLDEN_GRAD_RTOL = 1e-4
TRAIN_GOLDEN_PARAM_ATOL = 2e-5
# A conv whose GroupNorm has one channel per group has a bias gradient of 0
# in exact arithmetic (the normalisation removes any per-channel constant),
# so both libraries compute rounding noise there, which AdamW's first step
# turns into ±lr: those biases' gradients are held to 1e-6 absolute per
# element and their updated values to 2 lr.
TRAIN_GOLDEN_NULL_GRAD_ATOL = 1e-6
TRAIN_GOLDEN_NULL_PARAM_ATOL = 2 * TRAIN_LR
# One step from the same state and generator through the kernel and the
# plain route: the views are equal bit for bit, so only cuDNN's choice of
# algorithms can part them (its backward may sum with atomics). The loss
# comes from the forward, which cuDNN runs deterministically: 1e-6
# relative. An AdamW step moves a parameter by about lr at most, so
# gradients that differ in their last bits cannot part the parameters by
# more than lr.
ROUTE_LOSS_RTOL = 1e-6
ROUTE_PARAM_ATOL = TRAIN_LR


def phase(name: str, msg: str = "") -> None:
    print(f"[chip_smoke] {name:9s} t={time.perf_counter() - T0:7.2f}s  {msg}".rstrip(), flush=True)


def card_peaks(name: str) -> tuple[float, float, str]:
    for key, bw, ops in CARD_PEAKS:
        if key in name:
            return bw, ops, key
    return 3.35e12, 67e12, "H100 SXM (assumed: card not in CARD_PEAKS)"


# Cycles of a device sleep queued before a timed run (some 5 ms at the
# H100's 1.98 GHz): the host enqueues the run's launches meanwhile, so the
# events time the device and not the host's ctypes and Python per launch,
# which is longer than a small kernel (K9a/K9b: some 0.02-0.03 ms).
QUEUE_CYCLES = 10_000_000


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events
    around calls queued behind a device sleep."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def profile_step(step, step_ms: float, label: str) -> float | None:
    """Device time by kernel over one call of ``step`` (torch.profiler, CUPTI
    on the card), after one profiled warm-up call; returns the busy share,
    that device time over ``step_ms``, the step's wall time measured without
    the profiler (None where the trace holds no device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    tables = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: tables.append(p.key_averages())) as prof:
        for _ in range(2):
            step()
            torch.cuda.synchronize()
            prof.step()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    events = tables[-1] if tables else []
    # device-side events only; the step marker is mirrored on the device
    # timeline and spans the kernels, so it is left out of the sum
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA and dev_us(e) > 0
                      and not e.key.startswith("ProfilerStep")),
                     key=dev_us, reverse=True)
    if not kernels:
        phase("profile", f"{label}: no device time in the trace: not measured")
        return None
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    phase("profile", f"{label}: device kernels {busy_ms:.3f} ms of {step_ms:.3f} ms wall "
                     f"(busy share {busy_ms / step_ms:.3f}); top kernels by device time:")
    for e in kernels[:24]:
        print(f"           {dev_us(e) / 1e3:9.3f} ms {dev_us(e) / 1e3 / busy_ms:6.1%} x{e.count:<4d} {e.key[:100]}",
              flush=True)
    return busy_ms / step_ms


def k7_frames(dev, gen, b: int, h: int, w: int, offset: int = 0):
    """gray, prev [b, h, w] int32 and has_prev [b] for K7's checks: random
    levels; the first of every eight frames flat (all of them with b < 8
    but one), the top half of the last frame flat, some 1 in 1000 pixels
    outside 0..255; ``offset`` ints into their buffers, so a base off a
    16-byte boundary."""
    import torch

    def frame():
        buf = torch.empty(b * h * w + offset, dtype=torch.int32, device=dev)
        t = buf[offset:].view(b, h, w)
        t.copy_(torch.randint(0, 256, (b, h, w), generator=gen, device=dev, dtype=torch.int32))
        return t

    gray, prev = frame(), frame()
    flat = max(1, b // 8) if b > 1 else 0
    gray[:flat] = torch.randint(0, 256, (flat, 1, 1), generator=gen, device=dev, dtype=torch.int32)
    gray[-1, : h // 2] = 77
    px = gray.view(-1)
    odd = torch.randint(0, px.numel(), (max(1, px.numel() // 1000),), generator=gen, device=dev)
    px[odd] = torch.randint(-300, 600, odd.shape, generator=gen, device=dev, dtype=torch.int32)
    has_prev = torch.arange(b, device=dev) % 4 != 0
    return gray, prev, has_prev


def check_k7(dev, gen, bound) -> dict:
    """K7 against its plain version, statistics and histograms exact, at the
    service's bucket 32 and the grid's shapes (timed: the wrapper, the plain
    version and ``torch.bincount`` for the histogram part), at the service's
    other buckets (K7_BUCKET_SHAPES) and at K7_CHECK_SHAPES."""
    import torch

    from fav_tpu_torch.ops import corruptions_cuda as kern
    from fav_tpu_torch.ops import signal as sig
    from fav_tpu_torch.ops import signal_cuda

    shapes = {}
    for b, h, w in K7_SHAPES + K7_BUCKET_SHAPES + K7_CHECK_SHAPES:
        timed = (b, h, w) in K7_SHAPES
        off_base = (b, h, w) in K7_CHECK_SHAPES
        gray, prev, has_prev = k7_frames(dev, gen, b, h, w, offset=1 if off_base else 0)
        geo = signal_cuda.frame_stats_geometry(b, h, w, kern.multiprocessors(dev))
        stats, hist = signal_cuda.frame_statistics(gray, prev, has_prev)
        want_stats, want_hist = sig.frame_statistics_plain(gray, prev, has_prev)
        torch.cuda.synchronize()
        check(torch.equal(stats, want_stats), f"K7 {(b, h, w)}: statistics differ from the plain version by "
                                              f"{float((stats - want_stats).abs().max())}")
        check(torch.equal(hist, want_hist), f"K7 {(b, h, w)}: histograms differ from the plain version")
        in_range = ((gray >= 0) & (gray <= 255)).sum((1, 2)).to(torch.int32)
        check(torch.equal(hist.sum(-1), in_range), f"K7 {(b, h, w)}: a histogram does not count every pixel in 0..255")
        # a second launch finds the ticket counters at zero again
        again = signal_cuda.frame_statistics(gray, prev, has_prev)
        check(torch.equal(again[0], stats) and torch.equal(again[1], hist), f"K7 {(b, h, w)}: a second launch differs")
        layout = (f"{geo.tiles} tiles of {geo.rows}x{geo.cols} a frame, {geo.blocks} blocks of {geo.units}x{geo.team} "
                  f"threads, {geo.shared_bytes} B shared")
        if not timed:
            base = "base 4 bytes off 16" if off_base else "a bucket of the analysis service"
            phase("kernels", f"K7 frame_stats {(b, h, w)} ({base}): statistics and histograms equal to "
                             f"the plain version; {layout}")
            continue
        ms = time_ms(lambda: signal_cuda.frame_statistics(gray, prev, has_prev), reps=20)
        plain_ms = time_ms(lambda: sig.frame_statistics_plain(gray, prev, has_prev), reps=3, warmup=1)
        keys = (gray.clamp(0, 255) + 256 * torch.arange(b, device=dev, dtype=torch.int32).view(b, 1, 1)).reshape(-1).long()
        library_ms = time_ms(lambda: torch.bincount(keys, minlength=b * 256), reps=20)
        pixels = b * h * w
        # two int32 frames and the int32 flags read; statistics and histograms written
        bytes_moved = 2 * pixels * 4 + b * 4 + b * 3 * 4 + b * 256 * 4
        ops = K7_OPS_PER_PIXEL * pixels
        bound_ms, by = bound(bytes_moved, ops)
        shapes[f"{b}x{h}x{w}"] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                  "bound_by": by, "library_ms": library_ms}
        phase("kernels", f"K7 frame_stats {(b, h, w)}: statistics and histograms equal to the plain version; "
                         f"{layout}; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({by}: "
                         f"{bytes_moved / 1e6:.1f} MB, {ops / 1e9:.3f} Gop), {ms / bound_ms:.1f}x the bound; "
                         f"torch.bincount (the histogram part only) {library_ms:.4f} ms")
    return shapes


def misaligned(t):
    """A copy of ``t`` on a base 4 bytes off a 16-byte boundary."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def check_k6p_small_batch(x) -> None:
    """K6p at K6P_SMALL_BATCH images, fewer groups than its grid has
    blocks, on a base 4 bytes off a 16-byte boundary: equal to K6 and to
    its plain version at every severity."""
    import torch

    from fav_tpu_torch.ops import corruptions as plain
    from fav_tpu_torch.ops import corruptions_cuda as kern

    b = K6P_SMALL_BATCH
    xb = misaligned(x[:b])
    groups = {}
    for level in range(1, len(plain.ELASTIC_SEV) + 1):
        fy, fx = plain.elastic_fields(SEED + 14, xb, level, uniform=kern.uniform)
        g = plain.packed_group(b, xb.shape[2] + 2 * (plain.elastic_margin(level) + 1))
        got = kern.elastic_warp(xb, fy, fx, level, packed=True)
        k6 = kern.elastic_warp(xb, fy, fx, level)
        want = plain.elastic_from_fields_packed(xb, fy, fx, level, g)
        torch.cuda.synchronize()
        check(torch.equal(got, want) and torch.equal(got, k6),
              f"elastic_warp_packed batch {b} severity {level} (G={g}): max diff "
              f"{float((got - want).abs().max())} from its plain version, {float((got - k6).abs().max())} from K6")
        geo = kern.elastic_packed_geometry(b, g, *xb.shape[1:], kern.multiprocessors(x.device))
        groups[level] = (g, geo.blocks)
    phase("kernels", f"K6p elastic_warp_packed at batch {b} (base 4 bytes off 16): equal to K6 and its plain version "
                     f"at severities 1-5 (G, blocks: {groups})")


def shot_work(x, seed: int, severity: int) -> tuple[float, float, float]:
    """K2's work on ``x`` at ``severity`` with draw 0 of ``seed``: the terms
    beyond the first that this run's data needs (min(count, k_max - 1) an
    element), and the bound's bytes and operations."""
    import torch

    from fav_tpu_torch.ops import corruptions as plain
    from fav_tpu_torch.ops.random import uniform01

    n = x.numel()
    c = plain.sev_param(plain.SHOT_C, severity)
    k_max = plain.shot_k_max(severity)
    counts = plain.poisson_inverse_cdf(x * c, uniform01(seed, n, 0, device=x.device).reshape(x.shape), k_max)
    terms = float(torch.clamp(counts, max=k_max - 1).sum())
    return terms, 2 * n * 4 + 4 * k_max, OPS_PER_ELEMENT["shot_noise"] * n + SHOT_OPS_PER_TERM * terms


def shot_library(x, got, severity: int) -> tuple[float, str]:
    """``torch.poisson`` on lam = x c, made before timing: the draw only,
    without K2's scale and clip, and from another stream, so a yardstick of
    time; the note sets the mean of clip(draw / c) beside the kernel's."""
    import torch

    from fav_tpu_torch.ops import corruptions as plain

    c = plain.sev_param(plain.SHOT_C, severity)
    lam = x * c
    ms = time_ms(lambda: torch.poisson(lam), reps=20)
    mean = float(torch.clamp(torch.poisson(lam) / c, 0.0, 1.0).double().mean())
    return ms, (f"torch.poisson(x c) {ms:.4f} ms, the draw only (another stream: mean of clip(draw / c) "
                f"{mean:.6f} against the kernel's {float(got.double().mean()):.6f})")


def check_k2(x, bound) -> dict:
    """K2 against its plain version at every severity on ``x`` and, on a
    base 4 bytes off 16, at K2_ODD_SHAPE: at most K2_MAX_TIE_FRACTION of the
    elements differ, by one count at most. Timed at the severities of
    K2_TIMED_SEVERITIES other than 3, which the kernels phase times."""
    import torch

    from fav_tpu_torch.ops import corruptions as plain
    from fav_tpu_torch.ops import corruptions_cuda as kern

    seed = SEED + 2  # the kernels phase's seed for K2
    gen = torch.Generator(device=x.device).manual_seed(SEED + 20)
    odd = misaligned(torch.rand(K2_ODD_SHAPE, generator=gen, device=x.device))
    out = {}
    for level in range(1, len(plain.SHOT_C) + 1):
        c = plain.sev_param(plain.SHOT_C, level)
        rec = {}
        for label, xx in (("batch", x), ("odd", odd)):
            got = kern.shot_noise(seed, xx, level)
            diff = (got - plain.shot_noise_plain(seed, xx, level)).abs()
            torch.cuda.synchronize()
            frac = float((diff > 0).sum()) / xx.numel()
            err = float(diff.max())
            check(frac <= K2_MAX_TIE_FRACTION and err <= 1.0 / c + 1e-6,
                  f"shot_noise severity {level} at {tuple(xx.shape)}: {frac:.2e} of elements differ (limit "
                  f"{K2_MAX_TIE_FRACTION}), max diff {err} (one count: {1.0 / c})")
            rec[label] = {"differing_fraction": frac, "max_abs_err": err}
        if level in K2_TIMED_SEVERITIES and level != 3:
            ms = time_ms(lambda: kern.shot_noise(seed, x, level), reps=20)
            plain_ms = time_ms(lambda: plain.shot_noise_plain(seed, x, level), reps=3, warmup=1)
            terms, bytes_moved, ops = shot_work(x, seed, level)
            bound_ms, by = bound(bytes_moved, ops)
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by, mean_terms=1 + terms / x.numel())
            phase("kernels", f"K2 shot_noise severity {level} (k_max {plain.shot_k_max(level)}): kernel {ms:.4f} ms, "
                             f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({by}: {ops / 1e9:.3f} Gop), "
                             f"{ms / bound_ms:.2f}x the bound, mean terms per element {1 + terms / x.numel():.3f}")
        out[f"severity={level}"] = rec
    phase("kernels", f"K2 shot_noise at severities 1-5, seed {seed}: differing fractions "
                     + ", ".join(f"{r['batch']['differing_fraction']:.3e}" for r in out.values())
                     + f" at {tuple(x.shape)} and "
                     + ", ".join(f"{r['odd']['differing_fraction']:.3e}" for r in out.values())
                     + f" at {K2_ODD_SHAPE} (base 4 bytes off 16), each within {K2_MAX_TIE_FRACTION} and one count")
    return out


def check_k1_odd(x, seed: int, severity: int) -> str:
    """K1 within K1_TOL of its plain version at K2_ODD_SHAPE (n = 21483, not
    a multiple of 4: whole tiles, then the rest loop and a partial group)
    on a 16-byte base, and on a base 4 bytes off 16 (every group in the rest
    loop, element by element)."""
    import torch

    from fav_tpu_torch.ops import corruptions as plain
    from fav_tpu_torch.ops import corruptions_cuda as kern

    gen = torch.Generator(device=x.device).manual_seed(SEED + 21)
    odd = torch.rand(K2_ODD_SHAPE, generator=gen, device=x.device)
    errs = []
    for t in (odd, misaligned(odd)):
        got = kern.gaussian_noise(seed, t, severity)
        err = float((got - plain.gaussian_noise_plain(seed, t, severity)).abs().max())
        check(bool(torch.isfinite(got).all()) and err <= K1_TOL,
              f"gaussian_noise at {K2_ODD_SHAPE} on a base {t.data_ptr() % 16} bytes off 16: max diff {err} > {K1_TOL}")
        errs.append(f"{err:.3e} (base {t.data_ptr() % 16} bytes off 16)")
    return f"at {K2_ODD_SHAPE}: {', '.join(errs)}"


def check_k5(x, seed: int) -> None:
    """K5 exact to its plain version at every severity on ``x`` and, on a
    base 4 bytes off 16, at K2_ODD_SHAPE and at K5_ODD_BATCH images of
    ``x``; K5p exact to its plain version and to K5 at every severity on
    ``x`` and, on such a base, at K5P_ODD_SHAPES."""
    import torch

    from fav_tpu_torch.ops import corruptions as plain
    from fav_tpu_torch.ops import corruptions_cuda as kern

    gen = torch.Generator(device=x.device).manual_seed(SEED + 21)
    shapes = (x, misaligned(torch.rand(K2_ODD_SHAPE, generator=gen, device=x.device)), misaligned(x[:K5_ODD_BATCH]))
    packed_shapes = (x, *(misaligned(torch.rand(s, generator=gen, device=x.device)) for s in K5P_ODD_SHAPES))
    for level in range(1, len(plain.GLASS_SEV) + 1):
        _, m, iters = plain.sev_param(plain.GLASS_SEV, level)
        for xx in shapes:
            got = kern.glass_resample(seed, xx, m, iters)
            want = plain.glass_resample_plain(seed, xx, m, iters)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"glass_resample severity {level} (m={m}, iters={iters}) at "
                                          f"{tuple(xx.shape)}: max diff {float((got - want).abs().max())}, "
                                          f"expected exact")
        for xx in packed_shapes:
            got_p = kern.glass_resample(seed, xx, m, iters, packed=True)
            want_p = plain.glass_resample_packed_plain(seed, xx, m, iters)
            k5 = kern.glass_resample(seed, xx, m, iters)
            torch.cuda.synchronize()
            check(torch.equal(got_p, want_p) and torch.equal(got_p, k5),
                  f"glass_resample_packed severity {level} at {tuple(xx.shape)} (G="
                  f"{plain.packed_group(xx.shape[0], xx.shape[2])}): max diff "
                  f"{float((got_p - want_p).abs().max())} from its plain version, "
                  f"{float((got_p - k5).abs().max())} from K5, expected exact")
    groups = [plain.packed_group(s[0], s[2]) for s in (tuple(x.shape), *K5P_ODD_SHAPES)]
    phase("kernels", f"K5 glass_resample equal to its plain version at severities 1-5 (m, iters: "
                     f"{[plain.sev_param(plain.GLASS_SEV, v)[1:] for v in range(1, 6)]}) at {tuple(x.shape)}, and "
                     f"at {K2_ODD_SHAPE} and {(K5_ODD_BATCH, *x.shape[1:])} on a base 4 bytes off 16 ("
                     f"{kern.glass_shared_bytes(*x.shape[1:], 6)} B shared a block at severity 3); K5p equal to its "
                     f"plain version and to K5 at severities 1-5 at {tuple(x.shape)} and at "
                     f"{', '.join(map(str, K5P_ODD_SHAPES))} on a base 4 bytes off 16 (G {groups}; "
                     f"{kern.glass_packed_shared_bytes(groups[0], *x.shape[1:], 6)} B shared a block at severity 3)")


def check_k8(x, bound) -> dict:
    """K8 against its plain version at sigma 0 and 0.18, with the constants
    of tests/test_pallas.py:89, on ``x`` and, on a base 4 bytes off 16, at
    K2_ODD_SHAPE (d = 3069: Philox groups straddle images)."""
    import torch

    from fav_tpu_torch.ops import corruptions as plain
    from fav_tpu_torch.ops import corruptions_cuda as kern

    seed = SEED + 14
    n = x.numel()
    gen = torch.Generator(device=x.device).manual_seed(SEED + 22)
    odd = misaligned(torch.rand(K2_ODD_SHAPE, generator=gen, device=x.device))
    out = {}
    for sigma in K8_SIGMAS:
        noise = sigma > 0.0
        got = kern.corrupt_normalize(seed, x, sigma, **K8_CONSTANTS)
        want = plain.corrupt_normalize_plain(seed, x, sigma, **K8_CONSTANTS)
        odd_got = kern.corrupt_normalize(seed, odd, sigma, **K8_CONSTANTS)
        odd_want = plain.corrupt_normalize_plain(seed, odd, sigma, **K8_CONSTANTS)
        torch.cuda.synchronize()
        check(got.shape == x.shape and bool(torch.isfinite(got).all()), f"K8 sigma {sigma}: bad output")
        check(odd_got.shape == odd.shape and bool(torch.isfinite(odd_got).all()),
              f"K8 sigma {sigma} at {K2_ODD_SHAPE}: bad output")
        err = float((got - want).abs().max())
        odd_err = float((odd_got - odd_want).abs().max())
        check(err <= K8_TOL[noise], f"K8 sigma {sigma}: max diff {err} > {K8_TOL[noise]}")
        check(odd_err <= K8_TOL[noise], f"K8 sigma {sigma} at {K2_ODD_SHAPE}: max diff {odd_err} > {K8_TOL[noise]}")
        geo = kern.corrupt_normalize_geometry(n // x.shape[0], noise)
        ms = time_ms(lambda: kern.corrupt_normalize(seed, x, sigma, **K8_CONSTANTS), reps=20)
        plain_ms = time_ms(lambda: plain.corrupt_normalize_plain(seed, x, sigma, **K8_CONSTANTS), reps=3, warmup=1)
        bytes_moved = 2 * n * 4
        ops = K8_OPS_PER_ELEMENT[noise] * n
        bound_ms, by = bound(bytes_moved, ops)
        out[f"sigma={sigma}"] = {"max_abs_err": err, "odd_max_abs_err": odd_err, "ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": bound_ms, "bound_by": by}
        phase("kernels", f"K8 corrupt_normalize (sigma {sigma}): max|kernel-plain| {err:.3e}, at {K2_ODD_SHAPE} "
                         f"on a base 4 bytes off 16 {odd_err:.3e} (tol {K8_TOL[noise]}); {geo.threads} threads a "
                         f"block, {geo.groups_per_thread} groups a thread; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
                         f"bound {bound_ms:.4f} ms, {ms / bound_ms:.2f}x the bound "
                         f"({by}: {bytes_moved / 1e6:.1f} MB, {ops / 1e9:.3f} Gop); library: none (no single "
                         f"PyTorch call draws the normals and applies the fused pass)")
    return out


# bf16 K9a/K9b are also held exactly at an odd shape on a base off a 16-byte
# boundary (2 bytes off: a 6-byte pixel straddles 4-byte words)
K9_ODD_SHAPE = (7, 33, 31, 3)
# rows longer than bf16 K9a's stage (augment_cuda.ROWS_STAGE values) go by
# windows of a row; images larger than bf16 K9b's stage (wide or tall) go
# to the direct kernel
K9_WIDE_SHAPE = (4, 16, 5000, 3)
K9_TALL_SHAPE = (4, 5000, 16, 3)
# bf16 K9b's unit at each shape (augment_cuda.shear_cols_geometry)
K9B_ROUTES = {(SHEAR_BATCH, 32, 32, 3): "images", K9_ODD_SHAPE: "images", K9_WIDE_SHAPE: "direct",
              K9_TALL_SHAPE: "direct"}


def check_k9(dev, gen, bound) -> dict:
    """K9a and K9b against their plain versions at an AugMix view's chain
    batch, exact, with shifts past the clip limits, in float32 and in
    bfloat16 (the ``--bf16-aug`` chain). bf16 K9a and K9b are also held at
    ``K9_ODD_SHAPE`` on a base off 16 bytes and at ``K9_WIDE_SHAPE`` (windows
    of a row; the direct kernel), bf16 K9b at ``K9_TALL_SHAPE`` (the direct
    kernel), each by the unit its geometry names. ``grid_sample`` (bilinear,
    border, corners aligned) computes the same shear as the library
    yardstick, on the same dtype; ``Tensor.copy_`` of the same bytes is the
    practical ceiling."""
    import torch

    from fav_tpu_torch.ops import augment as aug
    from fav_tpu_torch.ops import augment_cuda

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    x32 = torch.rand((SHEAR_BATCH, 32, 32, 3), generator=gen, device=dev, dtype=torch.float32)
    for dtype, suffix in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        x = x32.to(dtype)
        b, h, w, c = x.shape
        n = x.numel()
        mx, my = aug.shift_bounds(h, w)
        x_nchw = x.permute(0, 3, 1, 2).contiguous()
        copied = torch.empty_like(x)
        copy_ms = time_ms(lambda: copied.copy_(x), reps=20)
        for base, kid, wrapper, plain_fn, m, rows in (
            ("shear_rows", "K9a", augment_cuda.shear_rows, aug.shift_rows, mx, True),
            ("shear_cols", "K9b", augment_cuda.shear_cols, aug.shift_cols, my, False),
        ):
            name = base + suffix
            delta = (torch.rand((b, h if rows else w), generator=gen, device=dev) * 2 - 1) * (m + 2)
            got = wrapper(x, delta, m)
            want = plain_fn(x, delta, m)
            torch.cuda.synchronize()
            check(got.shape == x.shape and got.dtype == dtype and torch.equal(got, want),
                  f"{name}: max diff {float((got.float() - want.float()).abs().max())} from the plain version, "
                  f"expected exact")
            odd = ""
            if dtype == torch.bfloat16:
                xo = misaligned(torch.rand(K9_ODD_SHAPE, generator=gen, device=dev).to(dtype))
                ob, oh, ow, _ = K9_ODD_SHAPE
                do = (torch.rand((ob, oh if rows else ow), generator=gen, device=dev) * 2 - 1) * (m + 2)
                check(torch.equal(wrapper(xo, do, m), plain_fn(xo, do, m)),
                      f"{name}: differs from the plain version at {K9_ODD_SHAPE} off 16 bytes")
                odd = f", and at {K9_ODD_SHAPE} on a base {xo.data_ptr() % 16} bytes off 16"
            if rows and dtype == torch.bfloat16:
                main = augment_cuda.shear_rows_bf16_geometry(b, h, w, c, sms)
                odd = (f" ({main.units} blocks of {main.rows_per_block} rows, {augment_cuda.ROWS_THREADS} "
                       f"threads, {main.shared_bytes} B shared)" + odd)
                wb, wh, ww, wc = K9_WIDE_SHAPE
                geo = augment_cuda.shear_rows_bf16_geometry(wb, wh, ww, wc, sms)
                check(geo.window > 0, f"{name}: {K9_WIDE_SHAPE} should go by windows, got {geo}")
                mw = aug.shift_bounds(wh, ww)[0]
                xw = torch.rand(K9_WIDE_SHAPE, generator=gen, device=dev).to(dtype)
                dw = (torch.rand((wb, wh), generator=gen, device=dev) * 2 - 1) * (mw + 2)
                check(torch.equal(wrapper(xw, dw, mw), plain_fn(xw, dw, mw)),
                      f"{name}: differs from the plain version at {K9_WIDE_SHAPE} (windows of {geo.window})")
                odd += (f", and at {K9_WIDE_SHAPE} (m={mw}) in windows of {geo.window} pixels, "
                        f"{geo.windows_per_row} a row")
            if not rows and dtype == torch.bfloat16:
                geos = {}
                for shape, route in K9B_ROUTES.items():
                    geo = augment_cuda.shear_cols_geometry(*shape, sms)
                    check(geo.route == route, f"{name}: {shape} should go by {route}, got {geo}")
                    geos[shape] = geo
                for shape in (K9_WIDE_SHAPE, K9_TALL_SHAPE):
                    sb, sh, sw, _ = shape
                    ms_ = aug.shift_bounds(sh, sw)[1]
                    xs = torch.rand(shape, generator=gen, device=dev).to(dtype)
                    ds = (torch.rand((sb, sw), generator=gen, device=dev) * 2 - 1) * (ms_ + 2)
                    check(torch.equal(wrapper(xs, ds, ms_), plain_fn(xs, ds, ms_)),
                          f"{name}: differs from the plain version at {shape} ({geos[shape].route})")
                main = geos[tuple(x.shape)]
                odd = (f" ({main.units} blocks, {main.images_per_block} images and {augment_cuda.COLS_THREADS} "
                       f"threads a block, {main.shared_bytes} B shared)" + odd +
                       f", and at {K9_WIDE_SHAPE} and {K9_TALL_SHAPE} on the direct kernel")
            ms = time_ms(lambda: wrapper(x, delta, m), reps=20)
            plain_ms = time_ms(lambda: plain_fn(x, delta, m), reps=3, warmup=1)
            # the same shear as sample coordinates for grid_sample
            d = torch.clamp(delta, -m, m - 1)
            ii = torch.arange(h, device=dev, dtype=torch.float32).view(1, h, 1).expand(b, h, w)
            jj = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, w).expand(b, h, w)
            if rows:
                jj = jj + d.view(b, h, 1)
            else:
                ii = ii + d.view(b, 1, w)
            grid = torch.stack([jj / (w - 1) * 2 - 1, ii / (h - 1) * 2 - 1], dim=-1).to(dtype)

            def library():
                return torch.nn.functional.grid_sample(x_nchw, grid, mode="bilinear", padding_mode="border",
                                                       align_corners=True)

            try:
                lib_err = float((library().permute(0, 2, 3, 1).float() - got.float()).abs().max())
                library_ms, lib_note = time_ms(library, reps=20), None
            except RuntimeError as e:  # the yardstick only: the kernel's own checks have passed
                library_ms, lib_note = None, f"grid_sample does not accept {dtype} here: {str(e)[:120]}"
            bytes_moved = 2 * n * x.element_size() + delta.numel() * 4
            ops = SHEAR_OPS_PER_ELEMENT * n
            bound_ms, by = bound(bytes_moved, ops)
            out[name] = {"kid": kid, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": by, "library_ms": library_ms, "library_note": lib_note, "copy_ms": copy_ms}
            lib = (f"grid_sample {library_ms:.4f} ms (max|grid_sample-kernel| {lib_err:.3e}, another order of "
                   f"operations)" if library_ms is not None else lib_note)
            phase("kernels", f"{kid} {name} at {tuple(x.shape)}, m={m}: equal to the plain version{odd}; kernel "
                             f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({by}: "
                             f"{bytes_moved / 1e6:.2f} MB, {ops / 1e9:.3f} Gop), Tensor.copy_ of the same bytes "
                             f"{copy_ms:.4f} ms; {lib}")
    return out


def train_golden_inputs(model, seed: int, batch: int):
    """The golden step's inputs, made with numpy from ``seed``: flax-path
    parameters for ``model`` (``random_flax_params``), float32 images and
    int32 labels. ``tests/test_torch_train.py`` makes the same."""
    import numpy as np

    from fav_tpu_torch.utils.checkpoint import random_flax_params

    rng = np.random.default_rng(seed)
    images = rng.random((batch, 32, 32, 3), dtype=np.float32)
    labels = rng.integers(0, 10, batch).astype(np.int32)
    return random_flax_params(model, seed), images, labels


def draws_from_json(d: dict, dev):
    """``AugMixDraws`` from the golden's lists, float32 on ``dev``."""
    import torch

    from fav_tpu_torch.ops.augment import AugMixDraws

    return AugMixDraws(**{k: torch.tensor(d[k], dtype=torch.float32, device=dev) for k in AugMixDraws._fields
                          if k in d})


def zero_gradient_biases(model) -> set[str]:
    """Flax paths of the conv biases whose gradient is 0 in exact
    arithmetic: those of a conv followed by a GroupNorm of one channel per
    group. Convs come three a stage, the first two normalised."""
    return {f"Conv_{3 * (i // 2) + i % 2}/bias" for i, norm in enumerate(model.norms)
            if norm.num_groups == norm.num_channels}


def hold_to_golden(label: str, golden: dict, metrics: dict, model, keys=("loss", "ce", "js")) -> dict:
    """A step's metrics (``keys``), the gradients left on ``model``'s
    parameters and its updated parameters held to a golden entry of
    ``fav_tpu``'s step: metrics within ``TRAIN_GOLDEN_RTOL`` relative (js
    also ``TRAIN_GOLDEN_JS_ATOL`` absolute), each gradient leaf's sum within
    ``TRAIN_GOLDEN_GRAD_RTOL`` of its absolute sum, each parameter leaf's sum
    within ``TRAIN_GOLDEN_PARAM_ATOL`` per element; the biases whose gradient
    is 0 in exact arithmetic (``zero_gradient_biases``, for the vgg models)
    within the null bounds. An entry's ``grad_rtol``, where it has one,
    replaces the gradient bound: twice the reference's own distance from a
    float64 gradient where that exceeds the float32 class (the DeepAugment
    step, ``tests/test_torch_trainers.py``)."""
    from fav_tpu_torch.utils.checkpoint import torch_to_flax

    rel = {k: abs(float(metrics[k]) - golden[k]) / abs(golden[k]) for k in keys}
    for k, err in rel.items():
        atol = TRAIN_GOLDEN_JS_ATOL if k == "js" else 0.0
        check(err <= TRAIN_GOLDEN_RTOL or abs(float(metrics[k]) - golden[k]) <= atol,
              f"{label}: {k} {float(metrics[k])} vs {golden[k]} ({err:.2e} relative)")
    grads = torch_to_flax({n: p.grad for n, p in model.named_parameters()})
    new = torch_to_flax(model.state_dict())
    null = zero_gradient_biases(model) if hasattr(model, "norms") and hasattr(model, "dense") else set()
    grad_err = param_err = 0.0
    for k, g in grads.items():
        if k in null:
            e = max(float(abs(g).max()), golden["grad_abs_sum"][k] / g.size)
            check(e <= TRAIN_GOLDEN_NULL_GRAD_ATOL, f"{label}: gradient {k} (0 in exact arithmetic) is {e:.2e}")
        else:
            e = abs(float(g.sum(dtype="float64")) - golden["grad_sum"][k]) / golden["grad_abs_sum"][k]
            tol = golden.get("grad_rtol", TRAIN_GOLDEN_GRAD_RTOL)
            check(e <= tol, f"{label}: gradient {k} sum off by {e:.2e} of its absolute sum (tol {tol})")
            grad_err = max(grad_err, e)
        e = abs(float(new[k].sum(dtype="float64")) - golden["param_sum"][k]) / new[k].size
        tol = TRAIN_GOLDEN_NULL_PARAM_ATOL if k in null else TRAIN_GOLDEN_PARAM_ATOL
        check(e <= tol, f"{label}: parameter {k} sum off by {e:.2e} per element (tol {tol})")
        if k not in null:
            param_err = max(param_err, e)
    return {"max_rel_err": rel, "grad_sum_err": grad_err, "param_sum_err_per_element": param_err,
            "zero_gradient_biases": sorted(null)}


def check_train_golden(golden: dict, dev) -> dict:
    """The JAX package's float32 AugMix step, its views made from its own
    draws by the port (on the card through K9a/K9b), its metrics and
    per-leaf sums held to the golden."""
    import torch

    from fav_tpu_torch.models.cnn import FailureAwareCNN
    from fav_tpu_torch.models.train import augmix_step_core, create_train_state
    from fav_tpu_torch.ops.augment import augmix_apply
    from fav_tpu_torch.utils.checkpoint import flax_to_torch

    model = FailureAwareCNN(widths=tuple(golden["widths"]), dense_width=golden["dense_width"], dropout_rate=0.0,
                            compute_dtype="float32")
    params, images, labels = train_golden_inputs(model, golden["seed"], golden["batch"])
    model.load_state_dict(flax_to_torch(params), strict=True)
    model.to(dev)
    x = torch.from_numpy(images).to(dev)
    y = torch.from_numpy(labels).long().to(dev)
    aug1, aug2 = (augmix_apply(x, draws_from_json(d, dev)) for d in golden["draws"])
    state = create_train_state(model, golden["lr"], golden["weight_decay"])
    metrics = augmix_step_core(state, x, y, aug1, aug2, golden["js_lam"], None)
    return hold_to_golden("train golden", golden, metrics, model)


TRAINERS_MEMBERS = 3  # ensemble members and KD teachers of the trainers golden


def b64_array(text: str, shape, dtype="float32"):
    """A little-endian array stored in a golden as base64."""
    import base64

    import numpy as np

    return np.frombuffer(base64.b64decode(text), dtype=np.dtype(dtype).newbyteorder("<")).reshape(shape)


def trainers_golden_inputs(golden: dict) -> dict:
    """The trainers golden's inputs, made with numpy from its seed: the
    classifier's parameters, images and labels (``train_golden_inputs``),
    the small autoencoder's parameters (seed + 1), the ensemble members'
    (seed + 10 + i) and the KD teachers' (seed + 20 + i), as flax paths.
    ``tests/test_torch_trainers.py`` makes the same."""
    from fav_tpu_torch.models.cnn import ConvAutoencoder, FailureAwareCNN
    from fav_tpu_torch.utils.checkpoint import random_flax_params

    seed, m = golden["seed"], golden["members"]
    model = FailureAwareCNN(widths=tuple(golden["widths"]), dense_width=golden["dense_width"], dropout_rate=0.0)
    ae = ConvAutoencoder(widths=tuple(golden["ae_widths"]), latent=golden["ae_widths"][-1])
    params, images, labels = train_golden_inputs(model, seed, golden["batch"])
    return {"params": params, "images": images, "labels": labels, "ae": random_flax_params(ae, seed + 1),
            "members": [random_flax_params(model, seed + 10 + i) for i in range(m)],
            "teachers": [random_flax_params(model, seed + 20 + i) for i in range(m)]}


def deepaugment_draws_from_json(d: dict, model, dev):
    """``DeepAugmentDraws`` from the golden: the strength, the per-image
    blend, and per leaf (state-dict name, torch layout) the normals as
    base64 float32 and the flip and zero masks as flat indices."""
    import torch

    from fav_tpu_torch.ops.deepaugment import DeepAugmentDraws, Perturbation

    leaves = {}
    for name, w in model.state_dict().items():
        leaf = d["leaves"][name]
        masks = []
        for k in ("flip", "zero"):
            mask = torch.zeros(w.numel(), dtype=torch.bool)
            mask[torch.tensor(leaf[k], dtype=torch.long)] = True
            masks.append(mask.view(w.shape).to(dev))
        eps = torch.from_numpy(b64_array(leaf["eps"], tuple(w.shape)).copy()).to(dev)
        leaves[name] = Perturbation(eps, *masks)
    return DeepAugmentDraws(torch.tensor(d["strength"], dtype=torch.float32, device=dev), leaves,
                            torch.tensor(d["lam"], dtype=torch.float32, device=dev))


# The trainers golden's bf16 view (all three op options): the port's bfloat16
# chain against the JAX package's on the same draws, the bounds of
# tests/test_torch_augment.py (the float32 inverse FFTs of the two libraries
# round to neighbouring bfloat16 values; elsewhere the views agree to the
# float32 mix).
BF16_VIEW_MEAN, BF16_VIEW_P99, BF16_VIEW_MAX = 1e-4, 2e-3, 2.0 ** -8


def check_trainers_golden(golden: dict, dev) -> dict:
    """The JAX package's SAM, DeepAugment, ensemble (``ce``) and KD steps at
    widths (8, 16), their views made from its draws by the port (on the card
    through K9a/K9b), each held to the golden as ``hold_to_golden`` holds
    the AugMix step; and its bfloat16 view with every op option."""
    import numpy as np
    import torch

    from fav_tpu_torch.models.cnn import ConvAutoencoder, FailureAwareCNN
    from fav_tpu_torch.models.distill import kd_step_core
    from fav_tpu_torch.models.train import (augmix_step_core, create_train_state, ensemble_member_step_core,
                                            sam_step_core)
    from fav_tpu_torch.ops.augment import augmix_apply
    from fav_tpu_torch.ops.deepaugment import deepaugment_apply
    from fav_tpu_torch.utils.checkpoint import flax_to_torch

    inp = trainers_golden_inputs(golden)
    x = torch.from_numpy(inp["images"]).to(dev)
    y = torch.from_numpy(inp["labels"]).long().to(dev)
    lr, wd, lam = golden["lr"], golden["weight_decay"], golden["js_lam"]

    def state(params):
        model = FailureAwareCNN(widths=tuple(golden["widths"]), dense_width=golden["dense_width"], dropout_rate=0.0,
                                compute_dtype="float32")
        model.load_state_dict(flax_to_torch(params), strict=True)
        return create_train_state(model.to(dev), lr, wd)

    def views(entry, sources):
        return [augmix_apply(src, draws_from_json(d, dev)) for d, src in zip(entry["draws"], sources)]

    report = {}
    g = golden["sam"]
    st = state(inp["params"])
    m = sam_step_core(st, x, y, *views(g, (x, x)), lam, golden["rho"], None)
    report["sam"] = hold_to_golden("trainers golden sam", g, m, st.model)

    g = golden["deepaugment"]
    ae = ConvAutoencoder(widths=tuple(golden["ae_widths"]), latent=golden["ae_widths"][-1], compute_dtype="float32")
    ae.load_state_dict(flax_to_torch(inp["ae"]), strict=True)
    ae = ae.to(dev).eval()
    distorted = deepaugment_apply(x, ae, deepaugment_draws_from_json(g["deepaugment"], ae, dev))
    st = state(inp["params"])
    m = augmix_step_core(st, x, y, *views(g, (x, distorted)), lam, None)
    report["deepaugment"] = hold_to_golden("trainers golden deepaugment", g, m, st.model)

    report["ensemble_ce"] = []
    for i, g in enumerate(golden["ensemble_ce"]):
        st = state(inp["members"][i])
        m = ensemble_member_step_core(st, x, y, tuple(views(g, (x,))), "ce", lam, None)
        report["ensemble_ce"].append(hold_to_golden(f"trainers golden ensemble member {i}", g, m, st.model,
                                                    ("loss",)))

    g = golden["kd"]
    teachers = [state(p).model.eval() for p in inp["teachers"]]
    st = state(inp["params"])
    m = kd_step_core(st, teachers, x, y, views(g, (x,))[0], golden["kd_temperature"], golden["hard_weight"])
    report["kd"] = hold_to_golden("trainers golden kd", g, m, st.model, ("loss",))

    g = golden["bf16_view"]
    got = augmix_apply(x, draws_from_json(g["draws"], dev), bf16=True).cpu().numpy()
    diff = np.abs(got - b64_array(g["view"], got.shape))
    bf16 = {"mean": float(diff.mean()), "p99": float(np.percentile(diff, 99)), "max": float(diff.max())}
    check(bf16["mean"] < BF16_VIEW_MEAN and bf16["p99"] < BF16_VIEW_P99 and bf16["max"] <= BF16_VIEW_MAX,
          f"trainers golden: the bf16 view differs from the JAX package's: {bf16}")
    report["bf16_view"] = bf16
    return report


def train_phase(dev, profile: bool = False) -> dict:
    """The AugMix training path of the ``classifier`` configuration; see the
    module docstring, phase 8."""
    import copy

    import numpy as np
    import torch

    from fav_tpu_torch.config import ModelParams
    from fav_tpu_torch.data.cifar import index_iterator, synthetic_cifar10
    from fav_tpu_torch.models.cnn import create_model, init_params
    from fav_tpu_torch.models.train import (augmix_objective, augmix_train_step, augmix_views, create_train_state,
                                            make_train_megastep)
    from fav_tpu_torch.ops import corruptions_cuda as kern
    from fav_tpu_torch.utils.checkpoint import WEIGHTS_DIR

    golden = json.loads((WEIGHTS_DIR / "train_step.golden.json").read_text())
    g = check_train_golden(golden, dev)
    phase("train", f"the JAX package's float32 AugMix step at widths {tuple(golden['widths'])}, batch "
                   f"{golden['batch']}, its draws through K9a/K9b: loss, ce, js within "
                   f"{', '.join(f'{v:.2e}' for v in g['max_rel_err'].values())} relative (tol {TRAIN_GOLDEN_RTOL}; "
                   f"js also {TRAIN_GOLDEN_JS_ATOL} abs), gradient sums within "
                   f"{g['grad_sum_err']:.2e} (tol {TRAIN_GOLDEN_GRAD_RTOL}), updated parameter sums within "
                   f"{g['param_sum_err_per_element']:.2e} per element (tol {TRAIN_GOLDEN_PARAM_ATOL}); the biases "
                   f"whose gradient is 0 in exact arithmetic ({', '.join(g['zero_gradient_biases'])}) within "
                   f"{TRAIN_GOLDEN_NULL_GRAD_ATOL} and {TRAIN_GOLDEN_NULL_PARAM_ATOL}")

    t = time.perf_counter()
    ds = synthetic_cifar10()
    data_s = time.perf_counter() - t
    images_all = torch.from_numpy(ds.train_images).to(dev)
    labels_all = torch.from_numpy(ds.train_labels).to(dev)
    mp = ModelParams()
    model = init_params(create_model(mp).to(dev), torch.Generator(device=dev).manual_seed(SEED))
    state = create_train_state(model, TRAIN_LR)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    idx_it = index_iterator(ds.train_images.shape[0], TRAIN_BATCH, seed=SEED)
    phase("train", f"classifier config: vgg widths {mp.widths}, dense {mp.dense_width}, dropout {mp.dropout_rate}, "
                   f"{mp.compute_dtype}; {sum(p.numel() for p in model.parameters())} parameters; synthetic "
                   f"draw 0 ({ds.train_images.shape[0]} train images) made in {data_s:.2f} s")

    def batch(idx):
        i = torch.from_numpy(idx).to(dev)
        return images_all.index_select(0, i), labels_all.index_select(0, i)

    losses = []
    kern.reset_launch_counts()
    torch.cuda.synchronize()
    for i in range(TRAIN_WARMUP):
        m = augmix_train_step(state, *batch(next(idx_it)), gen, TRAIN_JS_LAM)
        losses.append({k: m[k].view(1) for k in ("loss", "ce", "js")})
        if i == 0:
            torch.cuda.synchronize()
            first = kern.launch_counts()
            want = {k: K9_LAUNCHES_PER_STEP.get(k, 0) for k in first}
            check(first == want, f"train: launches in one step {first}, expected {want}")
    mega = make_train_megastep(augmix=True, js_lam=TRAIN_JS_LAM, device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(TRAIN_CHUNKS):
        chunk = np.stack([next(idx_it) for _ in range(TRAIN_K)])
        state, m = mega(state, images_all, labels_all, chunk, gen)
        losses.append(m)
    torch.cuda.synchronize()
    timed = TRAIN_CHUNKS * TRAIN_K
    step_ms = (time.perf_counter() - t) / timed * 1e3
    counts = kern.launch_counts()
    steps = TRAIN_WARMUP + timed
    want = {k: K9_LAUNCHES_PER_STEP.get(k, 0) * steps for k in counts}
    check(counts == want, f"train: launches over {steps} steps {counts}, expected {want}")
    curve = {k: torch.cat([m[k] for m in losses]).cpu().numpy() for k in ("loss", "ce", "js")}
    check(all(np.isfinite(v).all() for v in curve.values()), f"train: non-finite losses {curve}")
    check(curve["loss"][-5:].mean() < curve["loss"][:5].mean(),
          f"train: the loss does not fall: {curve['loss'].tolist()}")
    img_s = TRAIN_BATCH / (step_ms / 1e3)
    phase("train", f"{steps} steps at batch {TRAIN_BATCH} ({TRAIN_WARMUP} per-step warm-up, {TRAIN_CHUNKS} megastep "
                   f"chunks of {TRAIN_K} timed): {step_ms:.3f} ms/step, {img_s:.0f} training images/s; launches "
                   f"{counts} (first step {first})")
    phase("train", f"step 1: loss {curve['loss'][0]:.4f} ce {curve['ce'][0]:.4f} js {curve['js'][0]:.4f}; step "
                   f"{steps}: loss {curve['loss'][-1]:.4f} ce {curve['ce'][-1]:.4f} js {curve['js'][-1]:.4f}; mean of "
                   f"the first 5 {curve['loss'][:5].mean():.4f}, of the last 5 {curve['loss'][-5:].mean():.4f}")

    # where a step's time goes: CUDA events around the two views, the
    # forward and backward, and the optimizer
    x, y = batch(next(idx_it))
    split = {"augmix": 0.0, "forward_backward": 0.0, "optimizer": 0.0}
    for _ in range(TRAIN_BREAKDOWN_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        aug1, aug2 = augmix_views(gen, x)
        ev[1].record()
        loss, _ = augmix_objective(state.model, x, y, aug1, aug2, TRAIN_JS_LAM, gen)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        ev[2].record()
        state.optimizer.step()
        ev[3].record()
        torch.cuda.synchronize()
        for key, (a, b) in zip(split, ((0, 1), (1, 2), (2, 3))):
            split[key] += ev[a].elapsed_time(ev[b]) / TRAIN_BREAKDOWN_STEPS
    total = sum(split.values())
    phase("train", f"breakdown (CUDA events, mean of {TRAIN_BREAKDOWN_STEPS} steps): augmix x2 "
                   f"{split['augmix']:.3f} ms ({split['augmix'] / total:.1%}), forward+backward "
                   f"{split['forward_backward']:.3f} ms ({split['forward_backward'] / total:.1%}), optimizer "
                   f"{split['optimizer']:.3f} ms ({split['optimizer'] / total:.1%})")

    # the kernel route against the plain route from one state and generator
    seed = SEED + 5
    k_views = augmix_views(torch.Generator(device=dev).manual_seed(seed), x)
    p_views = augmix_views(torch.Generator(device=dev).manual_seed(seed), x, plain=True)
    check(all(torch.equal(a, b) for a, b in zip(k_views, p_views)), "train: views differ between the routes")
    other = copy.deepcopy(state)
    mk = augmix_train_step(state, x, y, torch.Generator(device=dev).manual_seed(seed), TRAIN_JS_LAM)
    mp_ = augmix_train_step(other, x, y, torch.Generator(device=dev).manual_seed(seed), TRAIN_JS_LAM, plain=True)
    loss_err = abs(float(mk["loss"]) - float(mp_["loss"])) / abs(float(mp_["loss"]))
    with torch.no_grad():
        param_err = max(float((a - b).abs().max()) for a, b in zip(state.model.parameters(), other.model.parameters()))
    check(loss_err <= ROUTE_LOSS_RTOL and param_err <= ROUTE_PARAM_ATOL,
          f"train: kernel vs plain route: loss {loss_err:.2e} relative, parameters {param_err:.2e}")
    phase("train", f"kernel vs plain route from one generator: both views equal bit for bit; one step's loss "
                   f"within {loss_err:.2e} relative (tol {ROUTE_LOSS_RTOL}), parameters within {param_err:.2e} "
                   f"(tol {ROUTE_PARAM_ATOL})")
    del other
    if profile:
        profile_step(lambda: augmix_train_step(state, x, y, gen, TRAIN_JS_LAM), step_ms, "one train step")
    return {"counts": counts, "first_step_counts": first, "step_ms": step_ms, "img_per_s": img_s,
            "split_ms": split, "loss_first": float(curve["loss"][0]), "loss_last": float(curve["loss"][-1]),
            "ce": [float(curve["ce"][0]), float(curve["ce"][-1])],
            "js": [float(curve["js"][0]), float(curve["js"][-1])],
            "data_s": data_s, "golden": g, "route_loss_err": loss_err, "route_param_err": param_err}


# Phase 13: the remaining trainers at the widths of the checkpoints they made
# (fav_tpu/checkpoints/*/metadata.json), each on one fixed batch of the
# synthetic set at the pretrain CLI's batch 256: 2 warm-up and 10 timed steps.
TRAINERS_WARMUP = 2
TRAINERS_TIMED = 10
TRAINERS_BREAKDOWN_STEPS = 2
SAM_RHO = 0.05
KD_TEMPERATURE = 2.0
KD_HARD_WEIGHT = 0.3
MC_DISTILL_SAMPLES = 20
STUDENT_WIDTHS = (32, 64, 128)
AE_WIDTHS = (32, 64, 128)
ENSEMBLE_MEMBERS = 5
# Launches a step: two views of three shear passes each (rows, columns,
# rows), made once even where SAM runs two passes; one view a member under
# --augmix-ce and one a KD step; none for plain CE, MC distillation and the
# autoencoder.
TRAINERS_LAUNCHES = {
    "sam": {"shear_rows": 4, "shear_cols": 2},
    "classifier_deepaug": {"shear_rows": 4, "shear_cols": 2},
    "classifier_freq": {"shear_rows": 4, "shear_cols": 2},
    "classifier_occl": {"shear_rows": 4, "shear_cols": 2},
    "occlude_bars": {"shear_rows": 4, "shear_cols": 2},
    "bf16_aug": {"shear_rows_bf16": 4, "shear_cols_bf16": 2},
    "ensemble": {},
    "ensemble_augmix_ce": {"shear_rows": 2 * ENSEMBLE_MEMBERS, "shear_cols": ENSEMBLE_MEMBERS},
    "student_compact": {"shear_rows": 2, "shear_cols": 1},
    "distilled": {},
    "autoencoder": {},
}
# The pretrain CLI on the card, 2 steps of each mode (the metadata's
# calibration on the 10,000 test images included), written under build/.
TRAINERS_CLI = {
    "sam": ["--augmix", "--sam", "0.05"],
    "deepaugment": ["--deepaugment", "--freqband"],
    "bf16_bars": ["--occlude-bars", "--bf16-aug"],
    "ensemble_augmix_ce": ["--ensemble", "5", "--augmix-ce", "--megastep", "2"],
    "autoencoder": ["--autoencoder", "--widths", "32,64,128"],
    "distill_mc": ["--distill-mc", "20"],
    "distill_ensemble": ["--distill-ensemble", "--augmix", "--widths", "32,64,128", "--megastep", "2"],
}


class Recipe:
    """One trainer on a fixed batch: ``state()`` makes its train state (a
    list for an ensemble), ``step(state, g)`` is the port's step function,
    ``prep(g)`` and ``core(state, prepped, g)`` the same step in two parts
    (the views or teacher targets, then forward, backward and AdamW) for the
    time split."""

    def __init__(self, state, step, prep, core, images: int):
        self.state, self.step, self.prep, self.core, self.images = state, step, prep, core, images


def _optimizer_events(states, events: list) -> None:
    """Wrap each state's ``optimizer.step`` to record CUDA events around it."""
    import torch

    for st in states:
        inner = st.optimizer.step

        def step(*a, _inner=inner, **k):
            e = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            e[0].record()
            out = _inner(*a, **k)
            e[1].record()
            events.append(e)
            return out

        st.optimizer.step = step


def trainers_recipes(dev, ds) -> dict:
    """The recipes of ``TRAINERS_LAUNCHES`` on the first 256 training images."""
    import copy

    import torch

    from fav_tpu_torch.config import ModelParams
    from fav_tpu_torch.models import distill as dst
    from fav_tpu_torch.models import train as trn
    from fav_tpu_torch.models.cnn import ConvAutoencoder, create_model, init_params
    from fav_tpu_torch.ops.augment import augmix
    from fav_tpu_torch.ops.deepaugment import load_augmenter
    from fav_tpu_torch.utils.checkpoint import load_weights

    x = torch.from_numpy(ds.train_images[:TRAIN_BATCH]).to(dev)
    y = torch.from_numpy(ds.train_labels[:TRAIN_BATCH]).long().to(dev)
    lam = TRAIN_JS_LAM

    def fresh(mp=None, seed=SEED):
        model = init_params(create_model(mp or ModelParams()).to(dev), torch.Generator(device=dev).manual_seed(seed))
        return trn.create_train_state(model, TRAIN_LR)

    augmenter = load_augmenter(device=dev)
    teachers, _ = load_weights("ensemble", device=dev, members=ENSEMBLE_MEMBERS)
    mc_teacher, _ = load_weights("classifier", device=dev)
    student_mp = ModelParams(widths=STUDENT_WIDTHS, dense_width=STUDENT_WIDTHS[-1])

    def augmix_recipe(**opts):
        return Recipe(fresh, lambda st, g: trn.augmix_train_step(st, x, y, g, lam, **opts),
                      lambda g: trn.augmix_views(g, x, **opts),
                      lambda st, v, g: trn.augmix_step_core(st, x, y, *v, lam, g), 3 * TRAIN_BATCH)

    def ensemble_recipe(on: bool):
        seeds = itertools.count(SEED)  # an ensemble step takes its seed: member m draws from fold_in(seed, m)

        def prep(g):
            return [trn.ensemble_member_views(g, x, on, "ce") for _ in range(ENSEMBLE_MEMBERS)]

        def core(sts, views, g):
            return [trn.ensemble_member_step_core(st, x, y, v, "ce", lam, g) for st, v in zip(sts, views)]

        return Recipe(lambda: [fresh(seed=SEED + i) for i in range(ENSEMBLE_MEMBERS)],
                      lambda sts, g: trn.ensemble_train_step(sts, x, y, next(seeds), augmix=on, augmix_mode="ce"),
                      prep, core, ENSEMBLE_MEMBERS * (2 if on else 1) * TRAIN_BATCH)

    def ae_state():
        ae = ConvAutoencoder(widths=AE_WIDTHS, latent=AE_WIDTHS[-1]).to(dev)
        return trn.create_train_state(init_params(ae, torch.Generator(device=dev).manual_seed(SEED)), TRAIN_LR)

    return {
        "sam": Recipe(fresh, lambda st, g: trn.sam_augmix_train_step(st, x, y, g, lam, SAM_RHO),
                      lambda g: trn.augmix_views(g, x),
                      lambda st, v, g: trn.sam_step_core(st, x, y, *v, lam, SAM_RHO, g), 6 * TRAIN_BATCH),
        "classifier_deepaug": Recipe(fresh, lambda st, g: trn.deepaugment_train_step(st, x, y, g, augmenter, lam),
                                     lambda g: trn.deepaugment_views(g, x, augmenter),
                                     lambda st, v, g: trn.augmix_step_core(st, x, y, *v, lam, g), 3 * TRAIN_BATCH),
        "classifier_freq": augmix_recipe(freq=True),
        "classifier_occl": augmix_recipe(occlude=True),
        "occlude_bars": augmix_recipe(bars=True),
        "bf16_aug": augmix_recipe(bf16=True),
        "ensemble": ensemble_recipe(False),
        "ensemble_augmix_ce": ensemble_recipe(True),
        "student_compact": Recipe(
            lambda: fresh(student_mp),
            lambda st, g: dst.kd_step(st, teachers, x, y, g, KD_TEMPERATURE, KD_HARD_WEIGHT, augmix=True),
            lambda g: augmix(g, x),
            lambda st, v, g: dst.kd_step_core(st, teachers, x, y, v, KD_TEMPERATURE, KD_HARD_WEIGHT),
            2 * TRAIN_BATCH),
        "distilled": Recipe(
            lambda: trn.create_train_state(copy.deepcopy(mc_teacher), TRAIN_LR),
            lambda st, g: dst.distill_step(st, mc_teacher, x, g, MC_DISTILL_SAMPLES),
            lambda g: dst.mc_targets(mc_teacher, x, g, MC_DISTILL_SAMPLES),
            lambda st, t, g: dst.distill_step_core(st, x, t), TRAIN_BATCH),
        "autoencoder": Recipe(ae_state, lambda st, g: trn.autoencoder_train_step(st, x), lambda g: None,
                              lambda st, _, g: trn.autoencoder_train_step(st, x), TRAIN_BATCH),
    }


def _loss(metrics: dict) -> float:
    """A step's loss; an ensemble's, summed over its members."""
    return float(metrics["loss"].sum())


def run_recipe(name: str, recipe: Recipe, dev, seed: int) -> dict:
    """2 warm-up and 10 timed steps with the counts reset just before and
    read just after; the loss finite and falling; ms a step, training
    images a second and the split by CUDA events over 2 more steps."""
    import numpy as np
    import torch

    from fav_tpu_torch.ops import corruptions_cuda as kern

    state = recipe.state()
    gen = torch.Generator(device=dev).manual_seed(seed)
    losses = []
    torch.cuda.synchronize()
    kern.reset_launch_counts()
    for _ in range(TRAINERS_WARMUP):
        losses.append(_loss(recipe.step(state, gen)))
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(TRAINERS_TIMED):
        losses.append(_loss(recipe.step(state, gen)))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) / TRAINERS_TIMED * 1e3
    counts = kern.launch_counts()
    steps = TRAINERS_WARMUP + TRAINERS_TIMED
    want = {k: TRAINERS_LAUNCHES[name].get(k, 0) * steps for k in counts}
    check(counts == want, f"trainers {name}: launches over {steps} steps {counts}, expected {want}")
    loss = np.asarray(losses)
    check(bool(np.isfinite(loss).all()), f"trainers {name}: non-finite losses {loss.tolist()}")
    # over the 10 timed steps: the distilled student starts as its teacher,
    # near its optimum, and its first AdamW step moves it away
    first = loss[TRAINERS_WARMUP:TRAINERS_WARMUP + 3].mean()
    check(loss[-3:].mean() < first, f"trainers {name}: the loss does not fall over the timed steps: {loss.tolist()}")

    states = state if isinstance(state, list) else [state]
    opt_events: list = []
    _optimizer_events(states, opt_events)
    split = {"views_or_targets": 0.0, "forward_backward": 0.0, "optimizer": 0.0}
    for _ in range(TRAINERS_BREAKDOWN_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        opt_events.clear()
        ev[0].record()
        prepped = recipe.prep(gen)
        ev[1].record()
        recipe.core(state, prepped, gen)
        ev[2].record()
        torch.cuda.synchronize()
        opt = sum(a.elapsed_time(b) for a, b in opt_events)
        split["views_or_targets"] += ev[0].elapsed_time(ev[1]) / TRAINERS_BREAKDOWN_STEPS
        split["forward_backward"] += (ev[1].elapsed_time(ev[2]) - opt) / TRAINERS_BREAKDOWN_STEPS
        split["optimizer"] += opt / TRAINERS_BREAKDOWN_STEPS
    img_s = TRAIN_BATCH / (step_ms / 1e3)
    phase("trainers", f"{name}: {step_ms:.3f} ms/step, {img_s:.0f} training images/s ({recipe.images} images "
                      f"through the forward a step); loss {loss[0]:.4f} -> {loss[-1]:.4f}; launches {per_step(counts, steps)} "
                      f"a step; split views/targets {split['views_or_targets']:.3f} ms, forward+backward "
                      f"{split['forward_backward']:.3f} ms, optimizer {split['optimizer']:.3f} ms")
    return {"counts": counts, "step_ms": step_ms, "img_per_s": img_s, "split_ms": split,
            "loss_first": float(loss[0]), "loss_last": float(loss[-1])}


def per_step(counts: dict, steps: int) -> dict:
    return {k: v // steps for k, v in counts.items() if v}


def trainers_phase(dev, ds) -> dict:
    """The remaining trainers; see the module docstring, phase 13."""
    import shutil

    import torch

    from fav_tpu_torch.models import pretrain
    from fav_tpu_torch.ops import corruptions_cuda as kern
    from fav_tpu_torch.utils.checkpoint import WEIGHTS_DIR, load_weights

    golden = json.loads((WEIGHTS_DIR / "trainers.golden.json").read_text())
    g = check_trainers_golden(golden, dev)
    phase("trainers", f"the JAX package's SAM, DeepAugment, ensemble (ce, {golden['members']} members) and KD steps "
                      f"at widths {tuple(golden['widths'])}, their draws through K9a/K9b: loss within "
                      f"{g['sam']['max_rel_err']['loss']:.2e}, {g['deepaugment']['max_rel_err']['loss']:.2e}, "
                      f"{max(m['max_rel_err']['loss'] for m in g['ensemble_ce']):.2e}, "
                      f"{g['kd']['max_rel_err']['loss']:.2e} relative (tol {TRAIN_GOLDEN_RTOL}); gradient sums "
                      f"within {g['sam']['grad_sum_err']:.2e}, {g['deepaugment']['grad_sum_err']:.2e} (tol "
                      f"{golden['deepaugment']['grad_rtol']}), {max(m['grad_sum_err'] for m in g['ensemble_ce']):.2e}, "
                      f"{g['kd']['grad_sum_err']:.2e}; the bf16 view (every op option) mean|diff| "
                      f"{g['bf16_view']['mean']:.2e}, p99 {g['bf16_view']['p99']:.2e}, max {g['bf16_view']['max']:.2e}")
    recipes = trainers_recipes(dev, ds)
    results, recipe_counts = {}, {}
    for i, (name, recipe) in enumerate(recipes.items()):
        results[name] = run_recipe(name, recipe, dev, SEED + 100 + i)
        recipe_counts[name] = results[name].pop("counts")
    total = {k: sum(c[k] for c in recipe_counts.values()) for k in kern.launch_counts()}

    out_dir = REPO_DIR / "build" / "torch_checkpoints" / "smoke"
    shutil.rmtree(out_dir, ignore_errors=True)
    cli = {}
    base = ["--steps", "2", "--batch", str(TRAIN_BATCH), "--log-every", "0"]
    for name, flags in TRAINERS_CLI.items():
        t = time.perf_counter()
        meta = pretrain.main([*base, *flags, "--out", str(out_dir / name)], dataset=ds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        model, stored = load_weights(name, device=dev, directory=out_dir)
        check(stored == meta, f"trainers cli {name}: metadata read back differs")
        members = model if isinstance(model, list) else [model]
        with torch.no_grad():
            out = [m(torch.from_numpy(ds.test_images[:64]).to(dev)) for m in members]
        check(all(bool(torch.isfinite(o).all()) for o in out), f"trainers cli {name}: non-finite outputs")
        cli[name] = {"wall_s": wall, "keys": sorted(meta)}
        phase("trainers", f"pretrain {' '.join(flags)} --steps 2: {wall:.2f} s wall (calibration on "
                          f"{ds.test_images.shape[0]} test images included); weights read back as "
                          f"{type(members[0]).__name__} x{len(members)}; metadata "
                          f"{', '.join(f'{k}={meta[k]}' for k in ('accuracy', 'temperature', 'err_baseline') if k in meta)}")
    return {"counts": total, "recipe_counts": recipe_counts, "recipes": results, "golden": g, "cli": cli}


def monitor_phase(dev, profile: bool = False) -> dict:
    """The analysis service on the card with the scripted streams; see the
    module docstring, phase 6."""
    import asyncio

    import numpy as np
    import torch

    from fav_tpu_torch.config import STATUS_NAMES, AnalyzerParams, TrustParams
    from fav_tpu_torch.core.policy_replay import POLICY_TICKS_DEFAULT, replay_outputs, summarize_policy
    from fav_tpu_torch.core.trust_scan import simulate_sequence
    from fav_tpu_torch.ops import corruptions_cuda as kern
    from fav_tpu_torch.ops.signal import analyze_frame, init_analyzer_carry
    from fav_tpu_torch.serving.analysis import AnalysisService
    from fav_tpu_torch.sim.frames import GOLDEN_STREAMS, MONITOR_STREAMS, MONITOR_TICKS, scripted_stream
    from fav_tpu_torch.utils.checkpoint import WEIGHTS_DIR
    from fav_tpu_torch.utils.profiling import StageTimer

    golden = json.loads((WEIGHTS_DIR / "monitor.golden.json").read_text())
    h, w = golden["height"], golden["width"]
    check(golden["ticks"] == MONITOR_TICKS and golden["streams"] == list(GOLDEN_STREAMS), "monitor golden is stale")
    clips = [scripted_stream(kind, i, MONITOR_TICKS, h, w) for kind, i in MONITOR_STREAMS]
    code = {name: i for i, name in enumerate(STATUS_NAMES)}

    async def drive(service, paced: bool):
        slots = [service.acquire_slot() for _ in clips]
        check(None not in slots, "monitor: the service refused a slot")
        check(await service.maybe_analyze(clips[0][0], slots[0]) is None, "monitor: ready before its warm-up")
        while not service.ready:
            await asyncio.sleep(0.01)
        kern.reset_launch_counts()
        service.dispatches = 0
        loop = asyncio.get_running_loop()
        start = loop.time()
        rows = []
        for tick in range(MONITOR_TICKS):
            if paced:
                await asyncio.sleep(max(0.0, start + tick / 30.0 - loop.time()))
            rows.append(await asyncio.gather(*[service.analyze(c[tick], s) for c, s in zip(clips, slots)]))
        counts, dispatches = kern.launch_counts(), service.dispatches
        await service.close()
        return rows, counts, dispatches, loop.time() - start

    timer = StageTimer(keep_samples=True)
    service = AnalysisService(AnalyzerParams(), h, w, capacity=64, timer=timer, device=dev)
    rows, counts, dispatches, run_s = asyncio.run(drive(service, paced=True))
    want = {k: 0 for k in counts}
    want["frame_stats"] = dispatches
    check(dispatches >= MONITOR_TICKS and counts == want,
          f"monitor: launch counts {counts} over {dispatches} dispatched batches; expected {want}")
    status = np.array([[code[r["vision_status"]] for r in tick] for tick in rows]).T  # [streams, ticks]
    anomaly = np.array([[r["anomaly_score"] for r in tick] for tick in rows]).T
    expect = {"ok": [0] * MONITOR_TICKS, "frozen": [0] * 5 + [1] * (MONITOR_TICKS - 5),
              "blank": [2] * MONITOR_TICKS, "corrupted": [3] * MONITOR_TICKS}
    for j, (kind, _) in enumerate(MONITOR_STREAMS):
        check(status[j].tolist() == expect[kind], f"monitor: stream {j} ({kind}) statuses {status[j].tolist()}")
    g_status = np.asarray(golden["status"])
    g_anomaly = np.asarray(golden["anomaly"])
    check(np.array_equal(status[list(GOLDEN_STREAMS)], g_status), "monitor: statuses differ from the JAX golden")
    gerr = float(np.abs(anomaly[list(GOLDEN_STREAMS)] - g_anomaly).max())
    check(gerr <= MONITOR_ATOL, f"monitor: anomalies {gerr} from the JAX golden (tol {MONITOR_ATOL})")
    lat = np.asarray(timer.samples.get("analysis_device", [])) * 1e3
    check(lat.size == dispatches, f"monitor: {lat.size} latencies for {dispatches} batches")
    phase("monitor", f"{len(clips)} streams x {MONITOR_TICKS} ticks at {h}x{w} in {run_s:.3f} s: {dispatches} "
                     f"batches, launches {counts}; statuses as scripted; the {len(GOLDEN_STREAMS)} golden streams "
                     f"equal the JAX statuses, anomalies within {gerr:.2e} (tol {MONITOR_ATOL:.2e})")
    phase("monitor", f"dispatch-to-result latency per batch: mean {lat.mean():.3f} ms, median "
                     f"{np.median(lat):.3f} ms, max {lat.max():.3f} ms ({lat.size} batches)")

    # the same frames through the plain versions on the card
    plain_rows, plain_counts, _, _ = asyncio.run(drive(
        AnalysisService(AnalyzerParams(), h, w, capacity=64, device=dev, plain=True), paced=False))
    check(plain_counts["frame_stats"] == 0, "monitor: the plain route launched K7")
    check(plain_rows == rows, "monitor: the plain route's results differ from K7's")
    idx = np.arange(POLICY_TICKS_DEFAULT) % MONITOR_TICKS
    p_status = np.array([[code[r["vision_status"]] for r in tick] for tick in plain_rows]).T
    p_anomaly = np.array([[r["anomaly_score"] for r in tick] for tick in plain_rows]).T
    torch.cuda.synchronize()
    t = time.perf_counter()
    outs = replay_outputs(status[:, idx], anomaly[:, idx].astype(np.float64), device=dev)
    torch.cuda.synchronize()
    replay_ms = (time.perf_counter() - t) * 1e3
    plain_outs = replay_outputs(p_status[:, idx], p_anomaly[:, idx].astype(np.float64), device=dev)
    check(torch.equal(outs.policy, plain_outs.policy), "monitor: policy codes differ between the routes")
    rel_err = float((outs.reliability - plain_outs.reliability).abs().max())
    check(rel_err <= REPLAY_RELIABILITY_TOL, f"monitor: reliabilities differ by {rel_err}")
    summary = summarize_policy(outs)
    plain_summary = summarize_policy(plain_outs)
    for a, b in zip(summary, plain_summary):
        check(all(a[k] == b[k] for k in a if k.startswith("policy_share")), "monitor: policy shares differ")
    phase("monitor", f"replay of [{len(clips)}, {POLICY_TICKS_DEFAULT}] on the card: {replay_ms:.3f} ms; the "
                     f"plain route's replay equal (policy codes and shares exact, reliabilities within "
                     f"{rel_err:.1e})")
    for kind in expect:
        j = next(j for j, (k, _) in enumerate(MONITOR_STREAMS) if k == kind)
        r = summary[j]
        phase("monitor", f"  {kind:9s} allowed {r['policy_share_vision_allowed']:.4f} declining "
                         f"{r['policy_share_vision_declining']:.4f} degraded {r['policy_share_vision_degraded']:.4f} "
                         f"blocked {r['policy_share_vision_blocked']:.4f}, to BLOCKED {r['time_to_blocked_s']:.3f} s, "
                         f"final reliability {r['final_reliability']:.6f}")

    # the trust goldens through the port's scan on the card
    dt = 1.0 / 30.0
    seq = ([(0, 0.019, True)] + [(1, 0.019, True)] * 50 + [(2, 0.0, False)] * 30
           + [(3, 0.0, False)] * 100 + [(0, 0.019, True)] * 200)
    st = torch.tensor([s for s, _, _ in seq], dtype=torch.int32, device=dev)
    an = torch.tensor([a for _, a, _ in seq], dtype=torch.float64, device=dev)
    ha = torch.tensor([x for _, _, x in seq], dtype=torch.bool, device=dev)
    _, trust = simulate_sequence(TrustParams(), st, an, ha, torch.full((len(seq),), dt, dtype=torch.float64,
                                                                      device=dev))
    got = []
    for tick, field, value, tol in TRUST_GOLDENS:
        v = float(getattr(trust, field)[tick])
        check(abs(v - value) <= tol, f"trust golden: {field}[{tick}] = {v}, expected {value} within {tol}")
        got.append(f"{field}[{tick}] {v:.6f}")
    phase("monitor", "trust goldens on the card (docs/parity.md:37): " + ", ".join(got))

    # the batched analyzer at bucket 32, frames already on the card
    frames = torch.from_numpy(np.stack([c[1] for c in clips])).to(dev)
    fps = {}
    for route, plain_route in (("K7", False), ("plain", True)):
        carry = init_analyzer_carry(h, w, (frames.shape[0],), device=dev)
        for _ in range(3):
            analyze_frame(AnalyzerParams(), carry, frames, plain=plain_route)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(MONITOR_FPS_ITERS):
            analyze_frame(AnalyzerParams(), carry, frames, plain=plain_route)
        torch.cuda.synchronize()
        batch_ms = (time.perf_counter() - t) / MONITOR_FPS_ITERS * 1e3
        fps[route] = {"batch_ms": batch_ms, "frames_per_s": frames.shape[0] / (batch_ms / 1e3)}
        if profile and not plain_route:
            profile_step(lambda: analyze_frame(AnalyzerParams(), carry, frames), batch_ms,
                         f"one analyzer batch of {frames.shape[0]} at {h}x{w}")
    phase("monitor", f"batched analyzer at bucket {frames.shape[0]}, {h}x{w}: {fps['K7']['batch_ms']:.3f} ms a "
                     f"batch, {fps['K7']['frames_per_s']:.0f} frames/s through K7 (plain versions "
                     f"{fps['plain']['batch_ms']:.3f} ms, {fps['plain']['frames_per_s']:.0f} frames/s)")
    return {"counts": counts, "dispatches": dispatches, "latency_ms_mean": float(lat.mean()),
            "latency_ms_median": float(np.median(lat)), "latency_ms_max": float(lat.max()),
            "replay_ms": replay_ms, "analyzer": fps, "golden_max_abs_err": gerr}


def policy_phase(model, images, dev) -> dict:
    """The grid's L1 pass and policy replay over the 15 cells; see the
    module docstring, phase 7."""
    import torch

    from fav_tpu_torch.core.policy_replay import POLICY_TICKS_DEFAULT, grid_policy
    from fav_tpu_torch.models.uncertainty import msp
    from fav_tpu_torch.ops import corruptions_cuda as kern
    from fav_tpu_torch.parallel.sweep import l1_rows
    from fav_tpu_torch.pipeline import BENCH_CELLS, SEED_HIGH

    seeds = torch.randint(0, SEED_HIGH, (len(BENCH_CELLS),), generator=torch.Generator().manual_seed(SEED + 7))
    with torch.no_grad():
        clean = model(images).argmax(-1)
    kern.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    corrupted, rows = [], {"l1_status": [], "l1_anomaly": [], "conf": [], "correct": []}
    with torch.no_grad():
        for (name, severity), seed in zip(BENCH_CELLS, seeds.tolist()):
            x = kern.corruption_fn(name)(seed, images, severity)
            status, anomaly = l1_rows(x)
            logits = model(x)
            rows["l1_status"].append(status)
            rows["l1_anomaly"].append(anomaly)
            rows["conf"].append(msp(logits))
            rows["correct"].append(logits.argmax(-1) == clean)
            corrupted.append(x)
    rows = {k: torch.stack(v) for k, v in rows.items()}
    summaries = grid_policy(BENCH_CELLS, rows, device=dev)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t
    counts = kern.launch_counts()
    expected = {**MEGASTEP_LAUNCHES, "frame_stats": len(BENCH_CELLS)}
    check(counts == expected, f"policy: launch counts {counts}, expected {expected}")
    for (name, _), x, status, anomaly in zip(BENCH_CELLS, corrupted, rows["l1_status"], rows["l1_anomaly"]):
        p_status, p_anomaly = l1_rows(x, plain=True)
        check(torch.equal(status, p_status) and torch.equal(anomaly, p_anomaly),
              f"policy: {name}: l1_rows through K7 differ from the plain versions")
    for r in summaries:
        shares = sum(v for k, v in r.items() if k.startswith("policy_share"))
        check(abs(shares - 1.0) < 1e-9 and 0.0 <= r["min_reliability"] <= r["final_reliability"] + 1e-12 <= 1.0 + 1e-12,
              f"policy: implausible summary {r}")
    phase("policy", f"{len(BENCH_CELLS)} cells at batch {images.shape[0]}: corrupt, l1_rows (K7), nano confidence "
                     f"and grid_policy over {POLICY_TICKS_DEFAULT} ticks in {step_s * 1e3:.3f} ms; launches "
                     f"{counts}; l1_rows through K7 equal to the plain versions in every cell")
    counts_l1 = rows["l1_status"].cpu()
    for i, ((name, severity), r) in enumerate(zip(BENCH_CELLS, summaries)):
        frac = [float((counts_l1[i] == c).float().mean()) for c in range(4)]
        phase("policy", f"  {name:17s} L1 ok/frozen/blank/corrupted {frac[0]:.3f}/{frac[1]:.3f}/{frac[2]:.3f}/"
                        f"{frac[3]:.3f}; allowed {r['policy_share_vision_allowed']:.4f} declining "
                        f"{r['policy_share_vision_declining']:.4f} degraded {r['policy_share_vision_degraded']:.4f} "
                        f"blocked {r['policy_share_vision_blocked']:.4f}, to BLOCKED {r['time_to_blocked_s']:.3f} s, "
                        f"final {r['final_reliability']:.6f}, allowed-wrong {r['allowed_wrong_share']:.4f}")
    return {"counts": counts, "step_ms": step_s * 1e3, "summaries": summaries}


def packed_phase(dev) -> dict:
    """The packed A/B through ``run_ab``; see the module docstring, phase 9."""
    from fav_tpu_torch.pipeline import BATCH
    from fav_tpu_torch.tools.ab_packed_kernels import run_ab

    ab = run_ab(batch=BATCH, iters=ITERS, megastep=True, device=dev, log=lambda msg: phase("packed", msg))
    for family, r in ab["packed_equals_unpacked"].items():
        check(r["equal"], f"packed: {family}: the packed arm's batch differs from the unpacked arm's by "
                          f"{r['max_abs_diff']}")
    mega = ab["ab_packed"]
    for arm, want in (("packed", PACKED_MEGASTEP_LAUNCHES), ("unpacked", MEGASTEP_LAUNCHES)):
        check(mega[arm]["launches"] == want, f"packed: {arm} megastep launches {mega[arm]['launches']}, "
                                             f"expected {want}")
    check(mega["max_abs_diff"] <= MEGASTEP_TOL, f"packed: megastep arms {mega['packed']['out']} vs "
                                                f"{mega['unpacked']['out']}")
    phase("packed", f"kernel arms at batch {BATCH}, median of {ITERS} interleaved (CUDA events): "
                    + ", ".join(f"{k} {v:.4f} ms" for k, v in ab["median_ms"].items())
                    + "; packed and unpacked batches equal bit for bit in every family")
    phase("packed", f"megastep arms: packed {mega['packed']['ms_per_megastep']:.3f} ms "
                    f"({mega['packed']['img_per_sec']:.0f} img/s), unpacked {mega['unpacked']['ms_per_megastep']:.3f} "
                    f"ms ({mega['unpacked']['img_per_sec']:.0f} img/s); outputs within {mega['max_abs_diff']:.3e} "
                    f"(tol {MEGASTEP_TOL}); K5p/K6p once in the packed megastep, K5/K6 once in the unpacked one")
    return ab


# Over the socket: the app's pages and the keys every streamed state holds
# (tests/test_serving.py:140-149, the JAX app's keys in the golden)
SERVE_PAGES = ("/", "/architecture", "/playground")
SERVE_FROZEN_STATES = 40  # states read after set_vision frozen at 60 Hz
# Lockstep final reliabilities against the JAX app's: the analysis anomalies
# part by float32 reassociation (MONITOR_ATOL) and reach a reliability only
# through the ML penalty of OK ticks (ml_gain 0.15 x integral x dt).
SERVE_RELIABILITY_ATOL = 1e-6
# The paced runs' final policies against the JAX app's lockstep ones. A
# paced stream sees its failure when its pipeline's analysis lands, one tick
# or more after the frame, so its reliability may end higher than in
# lockstep: a frozen stream (0.30/s down to 0.46) ends VISION_DECLINING in
# place of VISION_DEGRADED if its onset is some 0.8 s late. Paced policies
# may therefore be up to one step less restrictive, never VISION_ALLOWED
# where the golden is not, and always VISION_ALLOWED where it is; the
# lockstep runs hold every policy exactly.
SERVE_POLICY_BAND = 1
# Besides the 32 streams: one camera, the server's usual load (the analysis
# and inference services' bucket 1), and one stream of each kind (bucket 8).
SERVE_SMALL = {"1 camera": (8,), "4 cameras": (0, 8, 16, 24)}


def _http_get(port: int, path: str) -> tuple[int, bytes]:
    """One HTTP/1.1 GET over a stdlib socket: (status, body)."""
    import socket

    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(f"GET {path} HTTP/1.1\r\nHost: 127.0.0.1\r\nConnection: close\r\n\r\n".encode())
        buf = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    head, _, body = buf.partition(b"\r\n\r\n")
    return int(head.split(b" ", 2)[1]), body


def _http_post(port: int, path: str, body: bytes, ctype: str) -> int:
    import socket

    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(f"POST {path} HTTP/1.1\r\nHost: 127.0.0.1\r\nConnection: close\r\nContent-Type: {ctype}\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        buf = b""
        while b"\r\n" not in buf:
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    return int(buf.split(b" ", 2)[1])


class WsClient:
    """A stdlib-socket WebSocket client (RFC 6455): the handshake with its
    accept-key check, masked text frames out, unmasked frames in (7-, 16- and
    64-bit lengths), as ``tests/test_httpws_protocol.py`` drives the
    server."""

    GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

    def __init__(self, port: int, path: str):
        import base64
        import hashlib
        import os
        import socket

        self.sock = socket.create_connection(("127.0.0.1", port), timeout=30)
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall((f"GET {path} HTTP/1.1\r\nHost: 127.0.0.1\r\nUpgrade: websocket\r\nConnection: Upgrade\r\n"
                           f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n").encode())
        head = b""
        while b"\r\n\r\n" not in head:
            chunk = self.sock.recv(4096)
            check(bool(chunk), f"serve: {path}: connection closed during the handshake")
            head += chunk
        head, _, self.buf = head.partition(b"\r\n\r\n")
        accept = base64.b64encode(hashlib.sha1((key + self.GUID).encode()).digest())
        check(b" 101 " in head.split(b"\r\n")[0] + b" " and accept in head,
              f"serve: {path}: bad handshake {head[:200]!r}")

    def _read(self, n: int) -> bytes:
        while len(self.buf) < n:
            chunk = self.sock.recv(65536)
            check(bool(chunk), "serve: the server closed the WebSocket")
            self.buf += chunk
        out, self.buf = self.buf[:n], self.buf[n:]
        return out

    def send_json(self, obj) -> None:
        import os
        import struct

        payload = json.dumps(obj).encode()
        mask = os.urandom(4)
        n = len(payload)
        head = bytes([0x81]) + (bytes([0x80 | n]) if n < 126 else bytes([0x80 | 126]) + struct.pack(">H", n))
        self.sock.sendall(head + mask + bytes(b ^ mask[i % 4] for i, b in enumerate(payload)))

    def recv_json(self):
        import struct

        b0, b1 = self._read(2)
        n = b1 & 0x7F
        if n == 126:
            n = struct.unpack(">H", self._read(2))[0]
        elif n == 127:
            n = struct.unpack(">Q", self._read(8))[0]
        payload = self._read(n)
        check(b0 & 0x0F == 0x1 and b0 & 0x80, f"serve: unexpected WebSocket frame 0x{b0:02x}")
        return json.loads(payload)

    def close(self) -> None:
        self.sock.close()


def socket_checks(port: int, golden: dict) -> dict:
    """The app over a real socket: health, the three pages, an upload the
    whitelist refuses, ``/ws`` streaming states with the JAX app's keys and
    decaying under ``set_vision frozen``, ``/ws/playground`` returning the
    golden's replay. Blocking: run it off the server's event loop."""
    status, body = _http_get(port, "/health")
    check(status == 200 and json.loads(body) == {"status": "ok"}, f"serve: /health gave {status} {body[:80]!r}")
    pages = {}
    for path in SERVE_PAGES:
        status, body = _http_get(port, path)
        check(status == 200 and b"<html" in body.lower(), f"serve: GET {path} gave {status}")
        pages[path] = len(body)
    boundary = "smokeboundary"
    form = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; filename=\"evil.exe\"\r\n"
            f"Content-Type: application/octet-stream\r\n\r\nnope\r\n--{boundary}--\r\n").encode()
    status = _http_post(port, "/api/upload-video", form, f"multipart/form-data; boundary={boundary}")
    check(status == 400, f"serve: an .exe upload gave {status}, expected 400 (the whitelist)")

    ws = WsClient(port, "/ws")
    first = ws.recv_json()
    missing = set(golden["ws_state_keys"]) - set(first)
    check(not missing and first.get("source_mode") == "simulation", f"serve: /ws state lacks {sorted(missing)}")
    ws.send_json({"action": "set_tick_rate", "rate": 60})
    ws.send_json({"action": "set_vision", "mode": "frozen"})
    states = [ws.recv_json() for _ in range(SERVE_FROZEN_STATES)]
    frozen = [s["reliability"] for s in states if s.get("vision_status") == "VISION_FROZEN"]
    check(len(frozen) >= 2 and frozen[-1] < frozen[0] < 1.0 + 1e-12,
          f"serve: reliability under set_vision frozen {frozen[:3]} ... {frozen[-3:]}, expected to fall")
    ws.close()

    ws = WsClient(port, "/ws/playground")
    ws.send_json({"action": "simulate_sequence", "events": golden["playground"]["events"]})
    reply = ws.recv_json()
    ws.close()
    check(reply.get("type") == "simulation_result" and reply["results"] == golden["playground"]["results"],
          "serve: /ws/playground's replay differs from the JAX golden")
    return {"pages_bytes": pages, "frozen_reliability": [frozen[0], frozen[-1]], "frozen_states": len(frozen),
            "playground_ticks": len(reply["results"])}


def _pct(values, q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(values) * 1e3, q)) if len(values) else float("nan")


def serve_paced_lag(states: list[list[dict]], lock_states: list[list[dict]]) -> dict:
    """How far a paced run trails the lockstep run of the same streams:
    ``frame_lag`` is tick t + 1 less the id of the frame whose analysis
    tick t streamed (ids count from 1), ``onset_lag`` the ticks by which a
    stream's first analyzed status other than VISION_OK came later than in
    lockstep."""
    import numpy as np

    lags = [t + 1 - s["frame_id"] for t, tick in enumerate(states) for s in tick if "frame_id" in s]

    def onset(sts, j):  # ticks before the first analysis stream "UNKNOWN"
        return next((t for t, tick in enumerate(sts)
                     if "frame_id" in tick[j] and tick[j]["vision_status"] != "VISION_OK"), None)

    onsets = [onset(states, j) - onset(lock_states, j) for j in range(len(states[0]))
              if onset(states, j) is not None and onset(lock_states, j) is not None]
    return {"frame_lag_p99": float(np.percentile(lags, 99)) if lags else float("nan"),
            "frame_lag_max": max(lags, default=-1), "onset_lag_max": max(onsets, default=0)}


def check_paced_states(label: str, final: list[dict], want: list[dict], idx) -> int:
    """A paced run's final states against the JAX app's lockstep ones: the
    statuses equal; the policy equal or at most SERVE_POLICY_BAND steps less
    restrictive, and VISION_ALLOWED exactly where the golden allows. Returns
    the number of streams whose policy equals the golden's."""
    from fav_tpu_torch.config import POLICY_ALLOWED, POLICY_CODES

    exact = 0
    for j, got, exp in zip(idx, final, want):
        p, g = POLICY_CODES[got["policy_state"]], POLICY_CODES[exp["policy_state"]]
        band = p == g or (g != POLICY_ALLOWED and max(POLICY_ALLOWED + 1, g - SERVE_POLICY_BAND) <= p < g)
        check(got["vision_status"] == exp["vision_status"] and band,
              f"serve: {label}: stream {j} ends {got}, the JAX app in lockstep {exp}")
        exact += p == g
    return exact


def serve_phase(dev, profile: bool = False) -> dict:
    """The decision-support server on the card; see the module docstring,
    phase 10."""
    import asyncio
    import dataclasses
    import socket

    from fav_tpu_torch.config import DEFAULT_CONFIG, PRESETS
    from fav_tpu_torch.serving import app
    from fav_tpu_torch.sim.frames import MONITOR_STREAMS
    from fav_tpu_torch.utils.checkpoint import WEIGHTS_DIR

    golden = json.loads((WEIGHTS_DIR / "serve.golden.json").read_text())
    camera_sets = {f"{len(MONITOR_STREAMS)} cameras": tuple(range(len(MONITOR_STREAMS))), **SERVE_SMALL}
    report = serve_deployments(dev, (("msp", {}), ("gated", PRESETS["gated"]["server"])), camera_sets, golden,
                               profile)

    # over a real socket: the default deployment
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cfg = DEFAULT_CONFIG.replace(server=dataclasses.replace(DEFAULT_CONFIG.server, host="127.0.0.1", port=port))

    async def over_socket():
        srv = await app.create_app(cfg, device=dev).serve("127.0.0.1", port)
        try:
            return await asyncio.to_thread(socket_checks, port, golden)
        finally:
            srv.close()
            await srv.wait_closed()
            for task in asyncio.all_tasks():
                if task is not asyncio.current_task():
                    task.cancel()
            await asyncio.sleep(0)

    sock = asyncio.run(over_socket())
    phase("serve", f"over 127.0.0.1:{port}: /health, {', '.join(SERVE_PAGES)} ({sock['pages_bytes']} bytes), the "
                   f"upload whitelist, /ws states with the JAX app's keys, set_vision frozen: reliability "
                   f"{sock['frozen_reliability'][0]:.6f} -> {sock['frozen_reliability'][1]:.6f} over "
                   f"{sock['frozen_states']} states; /ws/playground's {sock['playground_ticks']} ticks equal to "
                   f"the JAX golden")
    report["socket"] = sock
    return report


def serve_deployments(dev, deployments, camera_sets: dict, golden: dict, profile: bool = False,
                      label_phase: str = "serve") -> dict:
    """Drive each deployment ``(name, server settings)`` of the server's
    live path on the card over each camera set (lockstep, then paced) and
    hold it to ``golden`` (``weights/serve.golden.json``): launch counts,
    final states, the rows of ``score_batch`` (``compare_served_rows``). A
    third element names the golden's deployment where it is not ``name``.
    A deployment that serves a feature distance streams it in every last
    state, and its column is held apart from the golden's rows: the report
    keeps it under ``feature_distance``. Returns the report per deployment,
    with the summed counts."""
    import asyncio
    import dataclasses

    import numpy as np

    from fav_tpu_torch import native
    from fav_tpu_torch.config import DEFAULT_CONFIG
    from fav_tpu_torch.io import jpeg
    from fav_tpu_torch.ops import corruptions_cuda as kern
    from fav_tpu_torch.serving import app
    from fav_tpu_torch.serving.analysis import BUCKETS, AnalysisService
    from fav_tpu_torch.serving.inference import DEFAULT_WEIGHTS, InferenceService
    from fav_tpu_torch.sim.frames import MONITOR_STREAMS, scripted_stream
    from fav_tpu_torch.tools import scripted_serve as ss
    from fav_tpu_torch.utils.profiling import StageTimer

    check(golden["ticks"] == ss.SERVE_TICKS and golden["streams"] == [list(s) for s in MONITOR_STREAMS],
          "serve golden is stale")
    built = native.prebuild()  # as create_app does: no live frame waits for g++
    check(not built["resize_area"].startswith("not built"), f"serve: the resize did not build: {built}")
    clips = [scripted_stream(kind, i, ss.SERVE_TICKS) for kind, i in MONITOR_STREAMS]
    inputs = ss.serve_golden_inputs(app._frame_for_model)
    report = {}
    for name, server, *golden_name in deployments:
        golden_name = golden_name[0] if golden_name else name
        cfg = DEFAULT_CONFIG.replace(server=dataclasses.replace(DEFAULT_CONFIG.server, **server))
        timer = StageTimer(keep_samples=True)
        inference = InferenceService(cfg.model, checkpoint_dir=cfg.server.checkpoint or None,
                                     max_wait_ms=cfg.server.inference_max_wait_ms,
                                     uncertainty=cfg.server.uncertainty, timer=timer,
                                     monitor_dir=cfg.server.monitor or None, device=dev)
        analysis = AnalysisService(cfg.analyzer, cfg.video.process_height, cfg.video.process_width,
                                   max_wait_ms=cfg.server.inference_max_wait_ms, capacity=64, timer=timer,
                                   device=dev)

        def connections(n: int) -> list:
            conns = []
            for _ in range(n):
                c = app.ConnectionState(cfg, device=dev)
                c.inference, c.analysis, c.timer = inference, analysis, timer
                conns.append(c)
            return conns

        def release(conns) -> None:
            for c in conns:
                if c.analysis_slot is not None:
                    analysis.release_slot(c.analysis_slot)

        def reset_counts() -> None:
            kern.reset_launch_counts()
            analysis.dispatches = analysis.frames_analyzed = inference.dispatches = inference.frames_scored = 0
            analysis.buckets = {}

        def read_counts() -> dict:
            return {"counts": kern.launch_counts(), "dispatches": analysis.dispatches,
                    "buckets": dict(analysis.buckets), "analyzed": analysis.frames_analyzed,
                    "scored": inference.frames_scored, "batches": inference.dispatches}

        async def drive():
            warm_s = await ss.warm_services(inference, analysis)
            stem = server.get("checkpoint") or DEFAULT_WEIGHTS.get(server.get("uncertainty", "msp"), "student_nano")
            check(not inference.degraded and inference.source.startswith("checkpoint:")
                  and inference.source.endswith(stem.split("/")[-1]),
                  f"serve: {name}: the model serves {inference.source}, not the weights {stem}")
            runs = {}
            for label, idx in camera_sets.items():
                sel = [clips[j] for j in idx]
                # lockstep: every frame analyzed and scored before its tick,
                # as the golden was written: final states comparable to the bit
                conns = connections(len(sel))
                reset_counts()
                lock_states = await ss.drive_lockstep(app, conns, sel)
                await ss.settle(inference, analysis)
                lock = read_counts()
                release(conns)
                # paced: the server's own schedule, the path users run
                conns = connections(len(sel))
                timer.samples.clear()
                reset_counts()
                t = time.perf_counter()
                states, tick_s = await ss.drive_paced(app, conns, sel)
                run_s = time.perf_counter() - t
                in_run = {"analyzed": analysis.frames_analyzed, "scored": inference.frames_scored}
                # the stopped pipelines' last frames come back before the
                # counts are read, and before the next run resets them
                await ss.settle(inference, analysis)
                paced = {**read_counts(), **in_run}
                lat = {k: list(v) for k, v in timer.samples.items()}  # before the profiled ticks add theirs
                busy = None
                if profile and len(sel) == len(clips):
                    busy = await profile_live(app, conns, sel, f"{name}: {len(sel)} streams, 30 paced ticks")
                    await ss.settle(inference, analysis)
                release(conns)
                runs[label] = {"idx": idx, "lock_states": lock_states, "lock": lock, "states": states,
                               "tick_s": tick_s, "run_s": run_s, "paced": paced, "lat": lat, "busy": busy}
            rows, probs = await asyncio.to_thread(inference.score_batch, inputs, True)
            await inference.close()
            await analysis.close()
            return warm_s, runs, rows, probs

        warm_s, runs, rows, probs = asyncio.run(drive())
        g_states = golden["deployments"][golden_name]["states"]
        fd_col = inference._col_rmd
        fdist = None if fd_col is None else rows[:, fd_col].tolist()
        if fd_col is not None:
            rows = np.delete(rows, fd_col, axis=1)
        err = ss.compare_served_rows(inference, rows, probs, np.asarray(golden["deployments"][golden_name]["rows"]))
        report[name] = {"warm_s": warm_s, "rows_max_abs_err": err, "jpeg_encoder": jpeg.last_encoder(),
                        "feature_distance_column": fd_col, "feature_distance": fdist}
        for label, run in runs.items():
            idx, n = run["idx"], len(run["idx"])
            want_states = [g_states[j] for j in idx]
            bucket = next(b for b in BUCKETS if b >= n)
            for mode in ("lock", "paced"):
                c = run[mode]
                want = {k: 0 for k in c["counts"]}
                want["frame_stats"] = c["dispatches"]
                check(c["dispatches"] >= 1 and c["counts"] == want,
                      f"serve: {name}: {label}: {mode} launch counts {c['counts']} over {c['dispatches']} "
                      f"dispatched analysis batches; expected {want}")
                check(n > 1 or c["buckets"] == {1: c["dispatches"]},
                      f"serve: {name}: {label}: {mode} analysis batches by bucket {c['buckets']}")
            lock = run["lock"]
            check(lock["dispatches"] >= ss.SERVE_TICKS and lock["buckets"].get(bucket, 0) >= 1
                  and lock["analyzed"] == lock["scored"] == ss.SERVE_TICKS * n,
                  f"serve: {name}: {label}: lockstep {lock['dispatches']} batches by bucket {lock['buckets']}, "
                  f"{lock['analyzed']} frames analyzed and {lock['scored']} scored; expected bucket {bucket} and "
                  f"{ss.SERVE_TICKS * n} of each")
            for j, got, exp in zip(idx, ss.final_states(run["lock_states"]), want_states):
                check((got["vision_status"], got["policy_state"]) == (exp["vision_status"], exp["policy_state"])
                      and abs(got["reliability"] - exp["reliability"]) <= SERVE_RELIABILITY_ATOL,
                      f"serve: {name}: {label}: lockstep stream {j} {MONITOR_STREAMS[j]} ends {got}, the JAX app "
                      f"{exp}")
            states, tick_s, run_s, paced, lat = run["states"], run["tick_s"], run["run_s"], run["paced"], run["lat"]
            exact = check_paced_states(f"{name}: {label}", ss.final_states(states), want_states, idx)
            check(all("ml_inference" in s and "model_degraded" not in s for s in states[-1]),
                  f"serve: {name}: {label}: the last tick lacks scores or says degraded")
            check(all(("feature_distance" in s["ml_inference"]) == (fd_col is not None) for s in states[-1]),
                  f"serve: {name}: {label}: feature_distance in the last tick's scores, column {fd_col}")
            lag = serve_paced_lag(states, run["lock_states"])
            r = {
                "streams": n, "ticks": len(tick_s), "run_s": run_s,
                "tick_ms_p50": _pct(tick_s, 50), "tick_ms_p99": _pct(tick_s, 99),
                "analysis_batches": paced["dispatches"], "analysis_buckets": paced["buckets"],
                "analysis_device_ms_p50": _pct(lat.get("analysis_device", []), 50),
                "analysis_device_ms_p99": _pct(lat.get("analysis_device", []), 99),
                "inference_batches": paced["batches"],
                "inference_device_ms_p50": _pct(lat.get("inference_device", []), 50),
                "inference_device_ms_p99": _pct(lat.get("inference_device", []), 99),
                "frame_analysis_ms_p50": _pct(lat.get("analysis", []), 50),
                "frame_inference_ms_p50": _pct(lat.get("inference", []), 50),
                "encode_ms_p50": _pct(lat.get("encode", []), 50),
                "frames_scored": paced["scored"], "frames_scored_per_s": paced["scored"] / run_s,
                "frames_analyzed": paced["analyzed"], "frames_analyzed_per_s": paced["analyzed"] / run_s,
                "policies_equal": exact, **lag, "busy_share": run["busy"],
                "counts": paced["counts"], "lockstep_counts": lock["counts"],
            }
            report[name][label] = r
            phase(label_phase, f"{name}: {inference.source.split('/')[-1]}"
                           f"{' gated by ' + inference.monitor_source.split('/')[-1] if inference.monitor_source else ''}"
                           f"; {label}: {n} streams x {len(tick_s)} ticks at {ss.SERVE_RATE:.0f} Hz in {run_s:.3f} s: "
                           f"K7 {paced['counts']['frame_stats']} launches = {paced['dispatches']} analysis batches "
                           f"(by bucket {paced['buckets']}), no other kernel; statuses equal to the JAX app's, "
                           f"policies equal in {exact} of {n} streams and within {SERVE_POLICY_BAND} step in the rest "
                           f"(onset up to {lag['onset_lag_max']} ticks later than in lockstep, frame lag p99 "
                           f"{lag['frame_lag_p99']:.0f} max {lag['frame_lag_max']}); in lockstep "
                           f"({lock['dispatches']} batches by bucket {lock['buckets']}, K7 "
                           f"{lock['counts']['frame_stats']}) final states equal to the JAX app's, reliabilities "
                           f"within {SERVE_RELIABILITY_ATOL}")
            phase(label_phase, f"{name}: {label}: tick wall p50 {r['tick_ms_p50']:.3f} ms p99 {r['tick_ms_p99']:.3f} ms; "
                           f"analysis dispatch-to-result p50 {r['analysis_device_ms_p50']:.3f} p99 "
                           f"{r['analysis_device_ms_p99']:.3f} ms; inference micro-batch p50 "
                           f"{r['inference_device_ms_p50']:.3f} p99 {r['inference_device_ms_p99']:.3f} ms "
                           f"({paced['batches']} batches); per frame: analysis {r['frame_analysis_ms_p50']:.3f}, "
                           f"inference {r['frame_inference_ms_p50']:.3f}, encode {r['encode_ms_p50']:.3f} ms (p50); "
                           f"{paced['scored']} frames scored ({r['frames_scored_per_s']:.1f}/s), {paced['analyzed']} "
                           f"analyzed ({r['frames_analyzed_per_s']:.1f}/s)")
        phase(label_phase, f"{name}: services warm in {warm_s:.2f} s; JPEG encoder: {jpeg.last_encoder()}; rows vs JAX: "
                       + ", ".join(f"{k} {v:.3g}" for k, v in err.items()))

    runs = [r for name, *_ in deployments for r in report[name].values() if isinstance(r, dict) and "counts" in r]
    for key in ("counts", "lockstep_counts"):
        report[key] = {k: sum(r[key][k] for r in runs) for k in runs[0][key]}
    return report


async def profile_live(app, conns, clips, label: str) -> float | None:
    """Device busy share of 30 paced live ticks (torch.profiler, CUPTI on
    the card): the device time of every kernel over the window's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fav_tpu_torch.tools import scripted_serve as ss

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        await ss.drive_paced(app, conns, clips, ticks=30)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                     key=dev_us, reverse=True)
    if not kernels:
        phase("profile", f"{label}: no device time in the trace: not measured")
        return None
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    phase("profile", f"{label}: device kernels {busy_ms:.3f} ms of {wall_ms:.3f} ms wall (busy share "
                     f"{busy_ms / wall_ms:.4f}); top kernels by device time:")
    for e in kernels[:16]:
        print(f"           {dev_us(e) / 1e3:9.3f} ms {dev_us(e) / 1e3 / busy_ms:6.1%} x{e.count:<5d} {e.key[:100]}",
              flush=True)
    return busy_ms / wall_ms


# ── phase 11: the evaluation grid ──────────────────────────────────────────

GRID_IMAGES = 2048  # evaluate's --num-images default
GRID_CHECK_IMAGES = 512  # the kernel-against-plain cells
GRID_CHECK_SEVERITY = 3
# Launches of one 75-cell grid: K1-K3 and K6 once a severity, K4 twice
# (brightness, contrast), K7 once a cell, no K5 (the grid's glass is the
# oracle's 2-D resample); the Philox helper 15 times a severity (motion 1,
# snow 2, frost 5, fog 5, elastic 2) and once a round of the grid's glass
# (``grid_launches``).
GRID_LAUNCHES_BASE = {**MEGASTEP_LAUNCHES, "gaussian_noise": 5, "shot_noise": 5, "impulse_noise": 5,
                      "photometric": 10, "glass_resample": 0, "elastic_warp": 5, "frame_stats": 75}


def grid_launches() -> dict:
    from fav_tpu_torch.ops.corruptions import GLASS_SEV

    return {**GRID_LAUNCHES_BASE,
            "philox_uniform": 5 * PHILOX_DRAWS_PER_MEGASTEP + sum(iters for _, _, iters in GLASS_SEV)}
# Kernel route against plain route on the same seeds: the corrupted batches
# differ only where a kernel's arithmetic does (K1 by logf/cosf ulps, K2 at
# a tie of u with a CDF partial sum, K4's contrast mean in another order;
# everything else exact), and the same bf16 forward turns that into
# confidence changes far below 2e-3; an argmax or an L1 status may flip at
# a tie, on at most 1 row in 1000.
GRID_CONF_TOL = 2e-3
GRID_MIN_AGREE = 0.999
# The JAX goldens (weights/grid.golden.json, the JAX CLI on the CPU at 2048
# images a cell): the draws are another stream of the same law, so accuracy
# agrees within sampling error, |d| <= 4 sqrt(2 p (1 - p) / n) + 0.01 (the
# 0.01 for the bf16 forward: XLA's jitted forward fuses conv and bias);
# motion blur draws one angle of eight for the whole cell, so both cells
# must lie within the range of the eight angles' accuracies (and the JAX
# AUROC within theirs) widened by the same bounds;
# the six families without draws see the same batches: accuracy and L1 flag
# rate within 0.01; AUROC within 0.08 where both cells have failures; the
# grid means within 0.01 (accuracy) and 0.02 (AUROC); the gated pair's
# mean policy shares within 0.03.
GRID_DRAW_FREE = ("defocus_blur", "zoom_blur", "brightness", "contrast", "pixelate", "jpeg_compression")
GRID_DRAW_FREE_TOL = 0.01
GRID_ACC_SIGMAS = 4.0
GRID_ACC_SLACK = 0.01
GRID_AUROC_TOL = 0.08
GRID_MEAN_ACC_TOL = 0.01
GRID_MEAN_AUROC_TOL = 0.02
GRID_SHARE_TOL = 0.03
# --conformal 0.1 (976 clean images): the randomised APS sets cover within 4
# binomial standard errors of 0.9, the split-conformal guarantee; the sets
# the CLI reports also hold the argmax wherever the randomised set is empty
# (the reference's never-empty rule), which only adds coverage: they must
# reach 0.9 less 4 SE and lie within 4 SE of a difference of the JAX CLI's
# own clean coverage (weights/grid.golden.json)
CONFORMAL_ALPHA = 0.1
CONFORMAL_SIGMAS = 4.0


def run_cli(ds, dev, argv, timings=None) -> dict:
    """``evaluate.main(argv)`` on the card and the dataset ``ds``, its
    printed summary swallowed; ``timings`` gains the grid's stage split."""
    import contextlib
    import io
    import os

    from fav_tpu_torch.models import evaluate

    os.environ[evaluate.DEVICE_ENV] = dev.type
    with contextlib.redirect_stdout(io.StringIO()):  # the CLI prints each summary
        return evaluate.main(argv, timings=timings, dataset=ds)


def motion_angle_ranges(forward, x, y, temperature: float, monitor=None) -> dict:
    """Motion blur draws one streak angle of eight for a whole cell
    (``motion_index``), so a cell's accuracy is one draw of an eight-way
    mixture, not a mean over images: per severity, the (min, max) accuracy
    and AUROC of the cell over the eight angles, on the same images."""
    from fav_tpu_torch.ops import corruptions as plain
    from fav_tpu_torch.parallel.sweep import GRID_SEED, SEVERITIES, fused_sweep

    per: dict = {s: [] for s in SEVERITIES}
    for idx in range(len(plain.MOTION_ANGLES)):
        def route(name, idx=idx):
            return lambda seed, images, severity: plain.motion_from_index(images, idx, severity)

        res = fused_sweep(forward, x, y, GRID_SEED, ("motion_blur",), SEVERITIES, temperature, monitor=monitor,
                          corruption_fn=route)
        for sev, c in res["motion_blur"].items():
            per[sev].append((c["accuracy"], c["auroc"]))
    return {sev: ((min(a for a, _ in v), max(a for a, _ in v)), (min(u for _, u in v), max(u for _, u in v)))
            for sev, v in per.items()}


def check_grid_golden(label: str, grid: dict, summary: dict, golden: dict, n: int, motion: dict,
                      draw_free=GRID_DRAW_FREE) -> dict:
    """Hold a grid from the card to the JAX CLI's golden (bounds above);
    the motion-blur cells to the range over their eight angles
    (``motion_angle_ranges``), widened by the same bounds. The AUROC and
    grid-mean bounds, set at 2048 images a cell, widen as 1 / sqrt(n)
    below that. ``draw_free`` names the families whose batches draw
    nothing (none where the forward itself draws: MC dropout, AugMix
    views). Returns the largest differences."""
    import math

    widen = math.sqrt(max(GRID_IMAGES / n, 1.0))
    fields = golden["fields"]
    worst = {"accuracy": 0.0, "accuracy_over_bound": 0.0, "draw_free_accuracy": 0.0, "draw_free_l1": 0.0,
             "auroc": 0.0}
    accs, aurocs, j_accs, j_aurocs = [], [], [], []
    for cell, vals in golden["cells"].items():
        name, sev = cell.split("/")
        want = dict(zip(fields, vals))
        got = grid[name][int(sev)]
        p = want["accuracy"]
        d_acc = abs(got["accuracy"] - p)
        bound_acc = GRID_ACC_SIGMAS * math.sqrt(2.0 * p * (1.0 - p) / n) + GRID_ACC_SLACK
        if name == "motion_blur":
            (lo, hi), (au_lo, au_hi) = motion[int(sev)]
            for who, acc in (("JAX", p), ("port", got["accuracy"])):
                check(lo - bound_acc <= acc <= hi + bound_acc,
                      f"{label}: {cell} {who} accuracy {acc:.4f} outside the eight angles' [{lo:.4f}, {hi:.4f}] "
                      f"+- {bound_acc:.4f}")
            if 0.0 < p < 1.0:
                check(au_lo - GRID_AUROC_TOL <= want["auroc"] <= au_hi + GRID_AUROC_TOL,
                      f"{label}: {cell} JAX AUROC {want['auroc']:.4f} outside the eight angles' "
                      f"[{au_lo:.4f}, {au_hi:.4f}] +- {GRID_AUROC_TOL}")
            worst["motion_angle_spread"] = max(worst.get("motion_angle_spread", 0.0), hi - lo)
            accs.append(got["accuracy"])
            j_accs.append(p)
            continue
        check(d_acc <= bound_acc, f"{label}: {cell} accuracy {got['accuracy']:.4f} vs JAX {p:.4f} (bound {bound_acc:.4f})")
        worst["accuracy"] = max(worst["accuracy"], d_acc)
        worst["accuracy_over_bound"] = max(worst["accuracy_over_bound"], d_acc / bound_acc)
        if name in draw_free:
            d_l1 = abs(got["l1_flag_rate"] - want["l1_flag_rate"])
            check(d_acc <= GRID_DRAW_FREE_TOL and d_l1 <= GRID_DRAW_FREE_TOL,
                  f"{label}: {cell} (no draws) accuracy {got['accuracy']:.4f} vs {p:.4f}, L1 flag rate "
                  f"{got['l1_flag_rate']:.4f} vs {want['l1_flag_rate']:.4f}")
            worst["draw_free_accuracy"] = max(worst["draw_free_accuracy"], d_acc)
            worst["draw_free_l1"] = max(worst["draw_free_l1"], d_l1)
        accs.append(got["accuracy"])
        j_accs.append(p)
        if 0.0 < p < 1.0 and got["failure_rate"] > 0.0:
            d_auroc = abs(got["auroc"] - want["auroc"])
            check(d_auroc <= GRID_AUROC_TOL * widen,
                  f"{label}: {cell} AUROC {got['auroc']:.4f} vs JAX {want['auroc']:.4f} (bound {GRID_AUROC_TOL * widen})")
            worst["auroc"] = max(worst["auroc"], d_auroc)
            aurocs.append(got["auroc"])
            j_aurocs.append(want["auroc"])
    worst["mean_accuracy"] = abs(sum(accs) / len(accs) - sum(j_accs) / len(j_accs))
    worst["mean_auroc"] = abs(sum(aurocs) / len(aurocs) - sum(j_aurocs) / len(j_aurocs))
    check(worst["mean_accuracy"] <= GRID_MEAN_ACC_TOL * widen,
          f"{label}: grid mean accuracy off JAX's by {worst['mean_accuracy']}")
    check(worst["mean_auroc"] <= GRID_MEAN_AUROC_TOL * widen, f"{label}: grid mean AUROC off JAX's by {worst['mean_auroc']}")
    if "policy" in golden:
        worst["policy_share"] = max(abs(summary["policy"][k] - v) for k, v in golden["policy"].items())
        check(worst["policy_share"] <= GRID_SHARE_TOL,
              f"{label}: mean policy shares {summary['policy']} vs JAX {golden['policy']}")
    return worst


def grid_phase(dev, ds, profile: bool = False) -> dict:
    """The evaluation grid through the port's CLI on the dataset ``ds``; see
    the module docstring, phase 11."""
    import math

    import numpy as np
    import torch

    from fav_tpu_torch.ops import corruptions_cuda as kern
    from fav_tpu_torch.ops.corruptions import CORRUPTION_NAMES
    from fav_tpu_torch.parallel.sweep import GRID_SEED, fused_sweep
    from fav_tpu_torch.utils.checkpoint import WEIGHTS_DIR, load_student

    golden = json.loads((WEIGHTS_DIR / "grid.golden.json").read_text())

    def run(argv, timings=None):
        return run_cli(ds, dev, argv, timings)

    report: dict = {}
    # (a) the classifier over all 75 cells, counts from zero
    kern.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = run([])
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    counts = kern.launch_counts()
    expected = grid_launches()
    check(counts == expected, f"grid: launch counts {counts}, expected {expected}")
    n = res["summary"]["images_per_cell"]
    check(n == GRID_IMAGES and sum(len(v) for v in res["grid"].values()) == 75, "grid: not 75 cells of 2048 images")
    cells = [c for sevs in res["grid"].values() for c in sevs.values()]
    check(all(math.isfinite(v) for c in cells for v in c.values() if isinstance(v, float)), "grid: non-finite metric")
    model, meta = load_student("classifier", device=dev)
    temperature = float(meta["temperature"])
    images = torch.from_numpy(ds.test_images[:n]).to(dev)
    labels = torch.from_numpy(ds.test_labels[:n]).to(dev)
    motion_a = motion_angle_ranges(model, images, labels, temperature)
    worst_a = check_grid_golden("grid classifier", res["grid"], res["summary"], golden["classifier"], n, motion_a)
    timings: dict = {}
    t = time.perf_counter()
    run([], timings)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    s = res["summary"]
    phase("grid", f"classifier, 75 cells x {n} images: {wall_s:.3f} s wall warm ({first_s:.3f} s the first run); "
                  f"corrupt {timings['corrupt']:.3f} s, forward {timings['forward']:.3f} s, L1 {timings['l1']:.3f} s, "
                  f"rows to host {timings['rows']:.3f} s, host finalize {timings['host']:.3f} s (CUDA events, "
                  f"host clock for the finalize); launches {counts}")
    phase("grid", f"classifier: mean corrupted accuracy {s['mean_corrupted_accuracy']} (JAX "
                  f"{golden['classifier']['summary']['mean_corrupted_accuracy']}), failure AUROC "
                  f"{s['mean_failure_auroc']} (JAX {golden['classifier']['summary']['mean_failure_auroc']}), ECE "
                  f"{s['mean_ece']}, L1 flag rate {s['mean_l1_flag_rate']}; against the JAX golden: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in worst_a.items()))
    report["classifier"] = {"wall_s": wall_s, "first_s": first_s, "timings": timings, "worst": worst_a,
                            "summary": {k: v for k, v in s.items() if not isinstance(v, list)}}
    if profile:
        report["classifier"]["busy_share"] = profile_step(lambda: run([]), wall_s * 1e3, "the classifier grid")

    # (b) the gated pair with the policy replay
    gated_argv = ["--checkpoint", "student_std", "--monitor", "student_nano", "--policy"]
    kern.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res_b = run(gated_argv)
    torch.cuda.synchronize()
    gated_s = time.perf_counter() - t
    counts_b = kern.launch_counts()
    check(counts_b == expected, f"grid gated: launch counts {counts_b}, expected {expected}")
    std, std_meta = load_student("student_std", device=dev)
    nano, nano_meta = load_student("student_nano", device=dev)
    motion_b = motion_angle_ranges(std, images, labels, float(std_meta["temperature"]),
                                   monitor=(nano, float(nano_meta["temperature"])))
    worst_b = check_grid_golden("grid gated", res_b["grid"], res_b["summary"], golden["gated"], n, motion_b)
    pol = res_b["summary"]["policy"]
    phase("grid", f"gated (student_std gated by student_nano, --policy): {gated_s:.3f} s wall; mean shares "
                  + ", ".join(f"{k[len('mean_share_vision_'):]} {pol[k]}" for k in golden["gated"]["policy"])
                  + f"; against the JAX golden: " + ", ".join(f"{k} {v:.4f}" for k, v in worst_b.items()))
    report["gated"] = {"wall_s": gated_s, "worst": worst_b, "policy": {k: pol[k] for k in golden["gated"]["policy"]}}

    # (c) the 15 severity-3 cells through the kernels and the plain versions
    x = torch.from_numpy(ds.test_images[:GRID_CHECK_IMAGES]).to(dev)
    y = torch.from_numpy(ds.test_labels[:GRID_CHECK_IMAGES]).to(dev)

    def forward(images):
        logits = model(images)
        return logits, {"pred": logits.argmax(-1).to(torch.float32)}

    rows = ("conf", "x_pred", "l1_status")
    routes = {}
    for plain_route in (False, True):
        t = time.perf_counter()
        _, _, got = fused_sweep(forward, x, y, GRID_SEED, CORRUPTION_NAMES, (GRID_CHECK_SEVERITY,), temperature,
                                return_rows=rows, plain=plain_route)
        routes[plain_route] = (got, time.perf_counter() - t)
    k_rows, p_rows = routes[False][0], routes[True][0]
    conf_err = float(np.abs(k_rows["conf"] - p_rows["conf"]).max())
    pred_agree = float((k_rows["x_pred"] == p_rows["x_pred"]).mean())
    l1_agree = float((k_rows["l1_status"] == p_rows["l1_status"]).mean())
    check(conf_err <= GRID_CONF_TOL, f"grid kernels vs plain: max |d conf| {conf_err} > {GRID_CONF_TOL}")
    check(pred_agree >= GRID_MIN_AGREE and l1_agree >= GRID_MIN_AGREE,
          f"grid kernels vs plain: argmax equal on {pred_agree}, L1 status on {l1_agree} (need {GRID_MIN_AGREE})")
    phase("grid", f"15 severity-{GRID_CHECK_SEVERITY} cells x {GRID_CHECK_IMAGES} images, kernels against plain "
                  f"versions from the same seeds: max |d conf| {conf_err:.3e} (tol {GRID_CONF_TOL}), argmax equal "
                  f"on {pred_agree:.6f}, L1 status on {l1_agree:.6f}; {routes[False][1]:.3f} s vs "
                  f"{routes[True][1]:.3f} s wall")
    report["kernels_vs_plain"] = {"conf_err": conf_err, "argmax_agree": pred_agree, "l1_agree": l1_agree,
                                  "kernel_s": routes[False][1], "plain_s": routes[True][1]}

    # (d) conformal sets and the Mahalanobis scores
    from fav_tpu_torch.models import conformal

    res_c = run(["--conformal", str(CONFORMAL_ALPHA)])
    cf = res_c["summary"]["conformal"]
    half = cf["calibration_n"]
    n_clean = ds.test_images.shape[0] - n - half
    target = 1.0 - CONFORMAL_ALPHA
    se = math.sqrt(CONFORMAL_ALPHA * target / n_clean)
    # the guarantee is on the randomised sets themselves: recompute them from
    # the same rows, qhat and uniforms, before the argmax every APS set is
    # forced to hold (which adds coverage: the reference's own 0.948 at
    # alpha 0.1, BENCH.md:1004)
    with torch.no_grad():
        cal = torch.from_numpy(ds.test_images[n:]).to(dev)
        probs = torch.softmax(model(cal) / temperature, dim=-1)
    cal_y = torch.from_numpy(ds.test_labels[n:]).to(dev).long()
    qhat = conformal.conformal_quantile(
        conformal.aps_scores(probs[:half], cal_y[:half], u=conformal.philox_row_uniforms(0, half, dev)),
        CONFORMAL_ALPHA)
    check(abs(float(qhat) - cf["qhat"]) <= 1e-6, f"grid conformal: qhat {cf['qhat']} vs recomputed {float(qhat)}")
    raw = conformal.aps_all_scores(probs[half:], u=conformal.philox_row_uniforms(1, n_clean, dev)) <= qhat
    raw_cov = float(conformal.coverage(raw, cal_y[half:]))
    check(abs(raw_cov - target) <= CONFORMAL_SIGMAS * se,
          f"grid conformal: randomised clean coverage {raw_cov} not within {CONFORMAL_SIGMAS} SE ({se:.4f}) of {target}")
    check(cf["clean_coverage"] >= target - CONFORMAL_SIGMAS * se,
          f"grid conformal: clean coverage {cf['clean_coverage']} below the certificate {target}")
    jax_cov = golden["conformal"]["clean_coverage"]
    se_pair = math.sqrt(2.0 * jax_cov * (1.0 - jax_cov) / n_clean)
    check(abs(cf["clean_coverage"] - jax_cov) <= CONFORMAL_SIGMAS * se_pair,
          f"grid conformal: clean coverage {cf['clean_coverage']} vs the JAX CLI's {jax_cov} (bound "
          f"{CONFORMAL_SIGMAS * se_pair:.4f})")
    res_m = run(["--maha"])
    fails = [c for sevs in res_m["grid"].values() for c in sevs.values() if c["failure_rate"] > 0]
    check(all(math.isfinite(c["auroc_maha"]) and math.isfinite(c["auroc_rmd"]) for c in fails),
          "grid maha: a non-finite Mahalanobis AUROC")
    sm = res_m["summary"]
    phase("grid", f"--conformal {CONFORMAL_ALPHA}: qhat {cf['qhat']:.5f} on {half} images (JAX "
                  f"{golden['conformal']['qhat']:.5f}); clean coverage on {n_clean}: randomised sets {raw_cov:.4f} "
                  f"(0.9 +- {CONFORMAL_SIGMAS * se:.4f}), with the forced argmax {cf['clean_coverage']} (JAX "
                  f"{jax_cov}), set size {cf['clean_set_size']}, "
                  f"coverage by severity {cf['coverage_by_severity']}; --maha: failure AUROC maha "
                  f"{sm['mean_failure_auroc_maha']}, rmd {sm['mean_failure_auroc_rmd']} over {len(fails)} cells "
                  f"with failures, all finite")
    report["conformal"] = {**{k: cf[k] for k in ("qhat", "clean_coverage", "clean_set_size", "coverage_by_severity")},
                           "randomised_clean_coverage": raw_cov}
    report["maha"] = {k: sm[k] for k in ("mean_failure_auroc_maha", "mean_failure_auroc_rmd")}
    report["counts"], report["gated_counts"] = counts, counts_b
    return report


# ── phase 12: the other model families and multi-forward uncertainty ────

RESNET_WIDTHS = (64, 128, 256)  # the shipped classifiers' widths; no checkpoint uses ResNetSmall
FAMILY_SERVE_MODES = ("mc_dropout", "ensemble", "autoencoder")
FAMILY_SHAPES = {"vit": "dim 128, depth 4, heads 4", "ensemble": "5 members, vgg 64/128/256",
                 "autoencoder": "32/64/128, latent 128", "resnet": "64/128/256, parameters from a numpy seed"}
# The CLI's multi-forward and ViT paths at its defaults (75 cells x 2048):
# every path launches the classifier grid's corruption and L1 kernels
# (``grid_launches``); --tta 3 adds two AugMix views a cell, each one
# affine of its three chains: K9a twice and K9b once a view.
FAMILY_TIMING = {"ensemble": ["--ensemble", "5"], "mc_dropout": ["--mc-dropout", "20"], "tta": ["--tta", "3"],
                 "vit": ["--arch", "vit", "--checkpoint", "vit"]}
TTA_VIEWS = 3


def family_launches(name: str) -> dict:
    launches = grid_launches()
    if name == "tta":
        views = 75 * (TTA_VIEWS - 1)
        launches.update(shear_rows=2 * views, shear_cols=views)
    return launches


def check_logits(label: str, got, want) -> float:
    """bf16 logits against the JAX package's eager ones: within
    ``GOLDEN_ATOL``, argmax equal wherever JAX's top two lie more than
    twice that apart. Returns the largest difference."""
    import numpy as np

    err = float(np.abs(got - want).max())
    check(np.isfinite(got).all() and err <= GOLDEN_ATOL, f"{label}: max |logit - JAX logit| {err} > {GOLDEN_ATOL}")
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * GOLDEN_ATOL
    check(bool((got.argmax(-1) == want.argmax(-1))[clear].all()), f"{label}: argmax differs from JAX's")
    return err


def families_phase(dev, ds) -> dict:
    """The other model families and the multi-forward scorers on the card;
    see the module docstring, phase 12."""
    import math

    import numpy as np
    import torch

    from fav_tpu_torch.models.cnn import ConvAutoencoder, ResNetSmall
    from fav_tpu_torch.ops import corruptions_cuda as kern
    from fav_tpu_torch.sim.frames import MONITOR_STREAMS
    from fav_tpu_torch.tools.scripted_serve import AE_ERR_RTOL
    from fav_tpu_torch.utils.checkpoint import WEIGHTS_DIR, flax_to_torch, load_weights, random_flax_params

    report: dict = {"forwards": {}}
    # (a) each forward against the JAX package's eager bf16 outputs
    for name in ("vit", "ensemble", "autoencoder", "resnet"):
        golden = json.loads((WEIGHTS_DIR / f"{name}.golden.json").read_text())
        x = torch.from_numpy(np.random.default_rng(golden["seed"]).random(tuple(golden["shape"]), dtype=np.float32))
        x = x.to(dev)
        if name == "resnet":
            model = ResNetSmall(widths=tuple(golden["widths"]))
            model.load_state_dict(flax_to_torch(random_flax_params(model, golden["param_seed"])), strict=True)
            model = model.to(dev).eval()
        else:
            model, _ = load_weights(name, device=dev)
        with torch.no_grad():
            if name == "autoencoder":
                err = ConvAutoencoder.reconstruction_error(model(x), x).cpu().numpy()
                rel = float(np.abs(err / np.asarray(golden["errors"]) - 1.0).max())
                check(np.isfinite(err).all() and rel <= AE_ERR_RTOL,
                      f"families: autoencoder reconstruction error off JAX's by {rel} (relative; bound {AE_ERR_RTOL})")
                report["forwards"][name] = {"err_rel": rel}
                what = f"reconstruction error within {rel:.2e} of JAX's (relative, bound {AE_ERR_RTOL})"
            elif name == "ensemble":
                errs = [check_logits(f"families: ensemble member {i}", m(x).cpu().numpy(),
                                     np.asarray(golden["member_logits"][i], np.float32)) for i, m in enumerate(model)]
                report["forwards"][name] = {"logit_err": max(errs)}
                what = f"{len(model)} members' logits within {max(errs):.4f} of JAX's"
            else:
                err = check_logits(f"families: {name}", model(x).cpu().numpy(), np.asarray(golden["logits"], np.float32))
                report["forwards"][name] = {"logit_err": err}
                what = f"logits within {err:.4f} of JAX's"
            if name != "autoencoder":
                what += f" (tol {GOLDEN_ATOL}), argmax equal on clear margins"
        phase("families", f"{name} ({FAMILY_SHAPES[name]}) bf16 forward on the golden's {x.shape[0]} images: {what}")
        del model

    # (b) the three serving modes on the live path
    golden = json.loads((WEIGHTS_DIR / "serve.golden.json").read_text())
    serve = serve_deployments(dev, tuple((m, {"uncertainty": m}) for m in FAMILY_SERVE_MODES),
                              {f"{len(MONITOR_STREAMS)} cameras": tuple(range(len(MONITOR_STREAMS)))}, golden,
                              label_phase="families")
    report["serve"] = serve

    # (c) the CLI's four paths held per cell to the JAX CLI's grids, reduced
    grid_golden = json.loads((WEIGHTS_DIR / "grid.golden.json").read_text())["families"]
    report["grids"] = {}
    for name, fam in grid_golden.items():
        t = time.perf_counter()
        res = run_cli(ds, dev, fam["argv"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        check(sorted(res["summary"]) == fam["summary_keys"]
              and sorted(next(iter(next(iter(res["grid"].values())).values()))) == fam["cell_keys"],
              f"families: {name}: the JSON keys differ from the JAX CLI's")
        n = res["summary"]["images_per_cell"]
        draw_free = () if name in ("mc_dropout", "tta") else GRID_DRAW_FREE
        worst = check_grid_golden(f"families {name}", res["grid"], res["summary"], fam, n, {}, draw_free)
        report["grids"][name] = {"wall_s": wall, "worst": worst}
        phase("families", f"{' '.join(fam['argv'][:fam['argv'].index('--num-images')])}: {len(fam['cells'])} cells x "
                          f"{n} images in {wall:.3f} s; mean accuracy {res['summary']['mean_corrupted_accuracy']} "
                          f"(JAX {fam['summary']['mean_corrupted_accuracy']}), AUROC "
                          f"{res['summary']['mean_failure_auroc']} (JAX {fam['summary']['mean_failure_auroc']}); "
                          f"against the JAX grid: " + ", ".join(f"{k} {v:.4f}" for k, v in worst.items()))

    # (d) each path at the CLI's defaults, timed, launches counted from zero
    report["timing"], report["counts"] = {}, {}
    for name, argv in FAMILY_TIMING.items():
        timings: dict = {}
        kern.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = run_cli(ds, dev, argv, timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = kern.launch_counts()
        check(counts == family_launches(name), f"families: {name}: launch counts {counts}, expected "
                                               f"{family_launches(name)}")
        cells = [c for sevs in res["grid"].values() for c in sevs.values()]
        check(len(cells) == 75 and res["summary"]["images_per_cell"] == GRID_IMAGES
              and all(math.isfinite(v) for c in cells for v in c.values() if isinstance(v, float)),
              f"families: {name}: not 75 finite cells of {GRID_IMAGES} images")
        report["timing"][name] = {"wall_s": wall, "timings": timings,
                                  "mean_corrupted_accuracy": res["summary"]["mean_corrupted_accuracy"],
                                  "mean_failure_auroc": res["summary"]["mean_failure_auroc"]}
        report["counts"][name] = counts
        phase("families", f"{' '.join(argv)}: 75 cells x {GRID_IMAGES} images in {wall:.3f} s wall (first run): "
                          f"corrupt {timings['corrupt']:.3f} s, forward {timings['forward']:.3f} s, L1 "
                          f"{timings['l1']:.3f} s, rows {timings['rows']:.3f} s, host {timings['host']:.3f} s; "
                          f"accuracy {res['summary']['mean_corrupted_accuracy']}, AUROC "
                          f"{res['summary']['mean_failure_auroc']}; launches {counts}")
    return report


# ── phase 14: the server's Mahalanobis column, the fit and replay tools ───

# The served feature distance on the golden's frames against fav_tpu's
# jitted service (weights/maha.golden.json): on the CPU the port lies
# 0.016 (msp) and 0.020 (gated) off; the bound leaves about five times
# that for cuDNN's bf16 (tests/test_torch_maha_serving.py).
MAHA_FDIST_ATOL = 0.1
# The fit tool's quantiles on the card against fav_tpu's tool, relative to
# the span q99 - q50 that scales the wire's distance: the features differ
# only by the bf16 forward (fav_tpu collects them under jit), and q50 is a
# small difference of two quadratic forms (3.09 of a span of 31.93 for
# student_nano), so its own relative error says little. On the CPU the
# port's tool lies 0.0051 (q50) and 0.0070 (q99) of the span from the
# golden's; the bound leaves about four times that for cuDNN's bf16.
MAHA_QUANTILE_SPAN_RTOL = 0.03
MAHA_FIT_IMAGES = 10240
MAHA_LIVE_LIMIT_S = 60.0  # for the live /ws stream to carry a scored frame
REPLAY_TAMPER_ROW = 30


class LoopVideo:
    """A stand-in live source for the app's socket check: ``start`` takes
    any path, and each ``get_frame`` gives the next frame of one scripted
    clip with a new id, as a camera would."""

    def __init__(self, params=None):
        from fav_tpu_torch.sim.frames import MONITOR_STREAMS, scripted_stream

        self.clip = scripted_stream(*MONITOR_STREAMS[0], 30)
        self.frame_id = 0
        self.running = False

    def start(self, source=0) -> bool:
        self.running = True
        return True

    def get_frame(self):
        if not self.running:
            return None, 0
        self.frame_id += 1
        return self.clip[self.frame_id % len(self.clip)].copy(), self.frame_id

    def stop(self) -> None:
        self.running = False


def replay_checks(csv_text: str, tmp: str) -> dict:
    """``fav_tpu_torch.tools.replay`` on a session CSV the app logged: exit 0;
    a copy with one reliability moved by 0.2 exits 1 and names its row."""
    import contextlib
    import io
    import os

    from fav_tpu_torch.tools import replay

    def run(text: str, name: str) -> tuple[int, dict]:
        path = os.path.join(tmp, name)
        with open(path, "w", newline="") as f:
            f.write(text)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = replay.main([path])
        return rc, json.loads(out.getvalue())

    rc, clean = run(csv_text, "session.csv")
    check(rc == 0 and clean["rows"] > REPLAY_TAMPER_ROW,
          f"maha: replay of the app's session CSV exited {rc}: {clean}")
    lines = csv_text.split("\r\n")
    col = lines[0].split(",").index("reliability")
    row = lines[REPLAY_TAMPER_ROW].split(",")
    row[col] = f"{float(row[col]) - 0.2:.6f}"
    lines[REPLAY_TAMPER_ROW] = ",".join(row)
    rc_bad, bad = run("\r\n".join(lines), "tampered.csv")
    check(rc_bad == 1 and (bad["first_gross_divergence"] or {}).get("row") == REPLAY_TAMPER_ROW,
          f"maha: the tampered session exited {rc_bad}: {bad}")
    return {"rows": clean["rows"], "max_dev": clean["max_dev"], "tampered_row": REPLAY_TAMPER_ROW}


def maha_socket_checks(port: int, tmp: str) -> dict:
    """The app with a fit over a real socket: a live stream
    (:class:`LoopVideo`) carries ``ml_inference.feature_distance``, after
    which (the model is built at first use) ``/api/metrics`` says the
    column is served; a simulation session's ``get_log`` CSV replays clean
    and a tampered copy does not. Blocking: run it off the loop."""
    ws = WsClient(port, "/ws")
    ws.send_json({"action": "set_tick_rate", "rate": 60})
    ws.send_json({"action": "set_source_mode", "mode": "video", "filepath": str(REPO_DIR / "chip_smoke.py")})
    t0 = time.perf_counter()
    scored = None
    while scored is None and time.perf_counter() - t0 < MAHA_LIVE_LIMIT_S:
        msg = ws.recv_json()
        if "feature_distance" in msg.get("ml_inference", {}):
            scored = msg
    live_s = time.perf_counter() - t0
    ws.close()
    check(scored is not None, f"maha: no live state carried ml_inference.feature_distance in {MAHA_LIVE_LIMIT_S} s")
    fd = scored["ml_inference"]["feature_distance"]
    check(fd >= 0.0 and fd == round(fd, 4), f"maha: the live feature_distance {fd}")
    status, body = _http_get(port, "/api/metrics")
    info = json.loads(body)["inference"]
    check(status == 200 and info.get("feature_distance") is True, f"maha: /api/metrics inference {info}")

    ws = WsClient(port, "/ws")
    ws.send_json({"action": "set_tick_rate", "rate": 60})
    ws.send_json({"action": "set_vision", "mode": "frozen"})
    for _ in range(SERVE_FROZEN_STATES):
        ws.recv_json()
    ws.send_json({"action": "set_vision", "mode": "normal"})
    for _ in range(SERVE_FROZEN_STATES):
        ws.recv_json()
    ws.send_json({"action": "get_log"})
    log = ws.recv_json()
    while log.get("type") != "log_data":
        log = ws.recv_json()
    ws.close()
    return {"live_feature_distance": fd, "live_s": live_s, "metrics_feature_distance": True,
            "replay": replay_checks(log["csv"], tmp)}


def maha_phase(dev, ds) -> dict:
    """The served Mahalanobis column, the fit tool and the replay tool; see
    the module docstring, phase 14."""
    import asyncio
    import contextlib
    import dataclasses
    import io
    import shutil
    import socket
    import tempfile

    import numpy as np
    import torch

    from fav_tpu_torch.config import DEFAULT_CONFIG
    from fav_tpu_torch.models.mahalanobis import load_fit, save_fit
    from fav_tpu_torch.serving import app
    from fav_tpu_torch.serving.inference import MAHA_FIT_SUFFIX, InferenceService
    from fav_tpu_torch.sim.frames import MONITOR_STREAMS
    from fav_tpu_torch.tools import fit_maha
    from fav_tpu_torch.tools import scripted_serve as ss
    from fav_tpu_torch.utils.checkpoint import WEIGHTS_DIR

    golden = json.loads((WEIGHTS_DIR / "maha.golden.json").read_text())
    serve_golden = json.loads((WEIGHTS_DIR / "serve.golden.json").read_text())
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        stems = {}
        for name in ("student_nano", "student_std"):
            stems[name] = str(Path(tmp) / name)
            for ext in (".npz", ".metadata.json"):
                shutil.copy(WEIGHTS_DIR / f"{name}{ext}", stems[name] + ext)
            shutil.copy(WEIGHTS_DIR / golden["fits"][name]["file"], stems[name] + MAHA_FIT_SUFFIX)
        deployments = (
            ("msp", {}),
            ("msp+fit", {"checkpoint": stems["student_nano"]}, "msp"),
            ("gated+fit", {"checkpoint": stems["student_std"], "monitor": stems["student_nano"]}, "gated"),
        )
        streams = {f"{len(MONITOR_STREAMS)} cameras": tuple(range(len(MONITOR_STREAMS)))}
        served = serve_deployments(dev, deployments, streams, serve_golden, label_phase="maha")
        check(served["msp"]["feature_distance"] is None, "maha: the shipped msp deployment serves a distance")
        label = next(iter(streams))
        for name, want_name in (("msp+fit", "msp"), ("gated+fit", "gated")):
            want = golden["deployments"][want_name]
            got = np.asarray(served[name]["feature_distance"], np.float64)
            err = float(np.abs(got - np.asarray(want["feature_distance"])).max())
            check(served[name]["feature_distance_column"] == want["column"] and np.isfinite(got).all()
                  and err <= MAHA_FDIST_ATOL,
                  f"maha: {name}: feature_distance in column {served[name]['feature_distance_column']}, max "
                  f"|port - fav_tpu| {err} (bound {MAHA_FDIST_ATOL}, column {want['column']})")
            report[name] = {"column": want["column"], "max_abs_err": err}
            phase("maha", f"{name}: feature_distance in column {want['column']} of the packed row, streamed in "
                          f"every stream's last tick; on the golden's {len(got)} frames max |port - fav_tpu| "
                          f"{err:.4f} (bound {MAHA_FDIST_ATOL}), mean {got.mean():.4f}")
        p50 = {name: served[name][label]["inference_device_ms_p50"] for name in ("msp", "msp+fit", "gated+fit")}
        p99 = {name: served[name][label]["inference_device_ms_p99"] for name in ("msp", "msp+fit", "gated+fit")}
        report["inference_ms_p50"], report["inference_ms_p99"] = p50, p99
        report["frames_scored_per_s"] = {name: served[name][label]["frames_scored_per_s"] for name in p50}
        report["counts"] = served["counts"]
        report["lockstep_counts"] = served["lockstep_counts"]
        phase("maha", f"{label}, inference micro-batch p50 (p99): without the column {p50['msp']:.3f} "
                      f"({p99['msp']:.3f}) ms, with it {p50['msp+fit']:.3f} ({p99['msp+fit']:.3f}) ms, gated with "
                      f"it {p50['gated+fit']:.3f} ({p99['gated+fit']:.3f}) ms; frames scored a second "
                      + ", ".join(f"{k} {v:.1f}" for k, v in report["frames_scored_per_s"].items()))

        # a stale fit, of another width: said on stderr, left out
        stale = str(Path(tmp) / "stale")
        for ext in (".npz", ".metadata.json"):
            shutil.copy(stems["student_nano"] + ext, stale + ext)
        fit = load_fit(stems["student_nano"] + MAHA_FIT_SUFFIX)
        save_fit(stale + MAHA_FIT_SUFFIX, dataclasses.replace(
            fit, class_means=fit.class_means[:, :32], prec=fit.prec[:32, :32], bg_mean=fit.bg_mean[:32],
            bg_prec=fit.bg_prec[:32, :32]))
        err_out = io.StringIO()
        svc = InferenceService(checkpoint_dir=stale, device=dev)
        with contextlib.redirect_stderr(err_out):
            rows, _ = svc.score_batch(ss.serve_golden_inputs(app._frame_for_model)[:2])
        check("stale fit" in err_out.getvalue() and not svc.has_feature_distance and rows.shape == (2, 6)
              and "feature_distance" not in svc.info(),
              f"maha: a stale fit gave rows {rows.shape}, info {svc.info()}, stderr {err_out.getvalue()!r}")
        phase("maha", "a stale fit (32 of 64 features): warned about on stderr, served without the column")

        # the app with the fit, over a real socket
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        cfg = DEFAULT_CONFIG.replace(server=dataclasses.replace(
            DEFAULT_CONFIG.server, host="127.0.0.1", port=port, checkpoint=stems["student_nano"]))

        async def over_socket():
            srv = await app.create_app(cfg, device=dev).serve("127.0.0.1", port)
            try:
                return await asyncio.to_thread(maha_socket_checks, port, tmp)
            finally:
                srv.close()
                await srv.wait_closed()
                for task in asyncio.all_tasks():
                    if task is not asyncio.current_task():
                        task.cancel()
                await asyncio.sleep(0)

        real_video = app.VideoSource
        app.VideoSource = LoopVideo
        try:
            sock = asyncio.run(over_socket())
        finally:
            app.VideoSource = real_video
        report["socket"] = sock
        phase("maha", f"over 127.0.0.1:{port}: a live /ws stream carried ml_inference.feature_distance "
                      f"{sock['live_feature_distance']} after {sock['live_s']:.2f} s, then /api/metrics said "
                      f"feature_distance; tools/replay.py on the app's get_log CSV of "
                      f"{sock['replay']['rows']} simulation ticks: exit 0, max deviations {sock['replay']['max_dev']}; "
                      f"one reliability moved by 0.2: exit 1 at row {sock['replay']['tampered_row']}")

        # the fit tool on the card, against the golden's fav_tpu fit
        t = time.perf_counter()
        fitted = fit_maha.fit_checkpoint(stems["student_nano"], MAHA_FIT_IMAGES, str(Path(tmp) / "fit.npz"),
                                         device=dev, dataset=ds)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t
        want = golden["fits"]["student_nano"]
        span = want["rmd_q99"] - want["rmd_q50"]
        rel = {k: abs(fitted[f"{k}_exact"] - want[k]) / span for k in ("rmd_q50", "rmd_q99")}
        check(fitted["fit_images"] == want["fit_images"] and fitted["feature_dim"] == want["feature_dim"]
              and max(rel.values()) <= MAHA_QUANTILE_SPAN_RTOL,
              f"maha: fit_maha on the card {fitted} against fav_tpu's {want} (relative to the span {rel})")
        report["fit"] = {"wall_s": fit_s, "rmd_q50": fitted["rmd_q50_exact"], "rmd_q99": fitted["rmd_q99_exact"],
                         "rel_err": rel}
        phase("maha", f"fav_tpu_torch.tools.fit_maha on student_nano, {MAHA_FIT_IMAGES} images: {fit_s:.3f} s wall; "
                      f"rmd_q50 {fitted['rmd_q50_exact']:.4f} rmd_q99 {fitted['rmd_q99_exact']:.4f} against "
                      f"fav_tpu's {want['rmd_q50']:.4f} {want['rmd_q99']:.4f} (off by {rel['rmd_q50']:.2e} and "
                      f"{rel['rmd_q99']:.2e} of the span; bound {MAHA_QUANTILE_SPAN_RTOL})")
    return report


# ── phase 15: W8A8 quantisation ────────────────────────────────────────────

QUANT_CALIB = 256
QUANT_EVAL = 1024
QUANT_ACC_DROP = 0.01  # tests/test_quant.py:136
QUANT_CONF_MAE = 0.02  # tests/test_quant.py:140
QUANT_EQUAL_BATCH = 64
# The quantised nano's logits on the golden images under fav_tpu's own
# calibration (weights/quant.golden.json): the nano golden's logit bound
# (tests/test_torch_quant.py), argmax held on clear margins as in phase 4.
QUANT_GOLDEN_ATOL = 0.125
# A calibrated scale against fav_tpu's jitted one: within one bf16 step
# (2^-7) on the CPU (tests/test_torch_quant.py); cuDNN sums in yet another
# order, so two steps here.
QUANT_SCALE_RTOL = 2 * 2.0 ** -7
QUANT_TIMED = {"student_nano": 6144, "classifier": 2048}
QUANT_REPS = 5


def int8_layers_equal(q, x) -> int:
    """Run ``x`` through ``q`` by the ``conv`` route, recording each int8
    convolution's inputs, and hold ``im2col`` to it on each: returns the
    number of quantised layers, all equal to the bit."""
    import torch

    from fav_tpu_torch.models import quant as tq

    calls = []
    real = tq._conv_int8

    def record(xi, k, stride):
        out = real(xi, k, stride)
        calls.append((xi, k, stride, out))
        return out

    tq._conv_int8 = record
    try:
        tq.quantized_forward(q, x, "conv")
    finally:
        tq._conv_int8 = real
    for i, (xi, k, stride, out) in enumerate(calls):
        got = tq._conv_im2col_int8(xi, k, stride)
        check(got.dtype == out.dtype == torch.int32 and torch.equal(got, out),
              f"quant: layer {i + 1} ({tuple(xi.shape)} x {tuple(k.shape)}, stride {stride}): im2col and conv differ")
    return len(calls)


def quant_phase(dev, ds) -> dict:
    """W8A8 quantisation of the shipped weights; see the module docstring,
    phase 15."""
    import numpy as np
    import torch

    from fav_tpu_torch.models import quant as tq
    from fav_tpu_torch.ops import corruptions_cuda as kern
    from fav_tpu_torch.utils.checkpoint import WEIGHTS_DIR, load_student

    report = {}
    kern.reset_launch_counts()
    # accuracy and confidence of the int8 classifier against its bf16 forward
    model, _ = load_student("classifier", device=dev)
    x = torch.from_numpy(ds.test_images[:QUANT_EVAL]).to(dev)
    y = torch.from_numpy(ds.test_labels[:QUANT_EVAL]).to(dev).long()
    q = tq.quantize_cnn(model, x[:QUANT_CALIB])
    with torch.no_grad():
        fp = model(x)
    conv, im2col = tq.quantized_forward(q, x, "conv"), tq.quantized_forward(q, x, "im2col")
    check(bool(torch.isfinite(conv).all()) and torch.equal(conv, im2col),
          "quant: classifier int8 logits non-finite, or the two routes differ")
    fp_acc = float((fp.argmax(-1) == y).float().mean())
    q_acc = float((conv.argmax(-1) == y).float().mean())
    conf_mae = float((fp.softmax(-1).amax(-1) - conv.softmax(-1).amax(-1)).abs().mean())
    check(q_acc >= fp_acc - QUANT_ACC_DROP and conf_mae < QUANT_CONF_MAE,
          f"quant: int8 accuracy {q_acc} against bf16 {fp_acc} (drop limit {QUANT_ACC_DROP}), mean |d conf| "
          f"{conf_mae} (limit {QUANT_CONF_MAE})")
    report["classifier"] = {"fp_accuracy": fp_acc, "int8_accuracy": q_acc, "conf_mae": conf_mae,
                            "act_scales": q.act_scales.tolist()}
    phase("quant", f"classifier calibrated on {QUANT_CALIB} test images: over {QUANT_EVAL}, int8 accuracy {q_acc:.4f} "
                   f"against bf16 {fp_acc:.4f} (drop limit {QUANT_ACC_DROP}), mean |d confidence| {conf_mae:.5f} "
                   f"(limit {QUANT_CONF_MAE}); im2col and conv logits equal")

    # both int8 routes on every quantised layer, to the bit
    nano, _ = load_student("student_nano", device=dev)
    qn = tq.quantize_cnn(nano, x[:QUANT_CALIB])
    layers = {name: int8_layers_equal(qq, x[:QUANT_EQUAL_BATCH]) for name, qq in (("classifier", q),
                                                                                  ("student_nano", qn))}
    report["int8_layers_equal"] = layers
    phase("quant", f"im2col (torch._int_mm) and conv (float64) int32 outputs equal to the bit at batch "
                   f"{QUANT_EQUAL_BATCH} on every quantised layer: " + ", ".join(f"{k} {v}" for k, v in layers.items()))

    # the quantised nano against fav_tpu's golden
    golden = json.loads((WEIGHTS_DIR / "quant.golden.json").read_text())
    ng = json.loads((WEIGHTS_DIR / "student_nano.golden.json").read_text())
    gimg = torch.from_numpy(np.random.default_rng(ng["seed"]).random(tuple(ng["shape"]), dtype=np.float32)).to(dev)
    qg = tq.quantize_cnn(nano, gimg)
    want_scales = np.asarray(golden["act_scales"], np.float64)
    scale_rel = float(np.abs(qg.act_scales.double().cpu().numpy() / want_scales - 1.0).max())
    check(scale_rel <= QUANT_SCALE_RTOL, f"quant: nano scales {qg.act_scales.tolist()} against fav_tpu's {want_scales}")
    qg = qg._replace(act_scales=torch.tensor(golden["act_scales"], dtype=torch.float32, device=dev))
    want = np.asarray(golden["logits"], np.float32)
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * QUANT_GOLDEN_ATOL
    errs = {}
    for algo in tq.INT8_ALGOS:
        got = tq.quantized_forward(qg, gimg, algo).cpu().numpy()
        errs[algo] = float(np.abs(got - want).max())
        check(np.isfinite(got).all() and errs[algo] <= QUANT_GOLDEN_ATOL
              and bool((got.argmax(-1) == want.argmax(-1))[clear].all()),
              f"quant: nano {algo} logits against fav_tpu's golden: max diff {errs[algo]} (bound "
              f"{QUANT_GOLDEN_ATOL}), argmax {got.argmax(-1)} vs {want.argmax(-1)}")
    report["golden"] = {"scale_rel": scale_rel, "max_abs_err": errs, "argmax_held": int(clear.sum())}
    phase("quant", f"nano calibrated on the golden's {len(want)} images: scales within {scale_rel:.2e} of fav_tpu's "
                   f"(bound {QUANT_SCALE_RTOL:.2e}, two bf16 steps); under fav_tpu's scales int8 logits max |port - fav_tpu| "
                   + ", ".join(f"{k} {v:.4f}" for k, v in errs.items())
                   + f" (bound {QUANT_GOLDEN_ATOL}), argmax equal on the {int(clear.sum())} images with a clear margin")

    # times: the bf16 forward and the two int8 forwards
    times = {}
    for name, batch in QUANT_TIMED.items():
        m = nano if name == "student_nano" else model
        qq = qn if name == "student_nano" else q
        xb = torch.rand((batch, 32, 32, 3), generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
        with torch.no_grad():
            times[name] = {"batch": batch,
                           "bf16_ms": time_ms(lambda: m(xb), reps=QUANT_REPS),
                           "int8_im2col_ms": time_ms(lambda: tq.quantized_forward(qq, xb, "im2col"), reps=QUANT_REPS),
                           "int8_conv_ms": time_ms(lambda: tq.quantized_forward(qq, xb, "conv"), reps=QUANT_REPS)}
        t_ = times[name]
        phase("quant", f"{name} at batch {batch} (CUDA events, mean of {QUANT_REPS}): bf16 forward "
                       f"{t_['bf16_ms']:.3f} ms, int8 im2col {t_['int8_im2col_ms']:.3f} ms, int8 conv (float64) "
                       f"{t_['int8_conv_ms']:.3f} ms")
        del xb
    report["times"] = times
    counts = kern.launch_counts()
    check(not any(counts.values()), f"quant: a hand kernel launched: {counts}")
    return report


# ── phase 16: the parallel paths on a world of one ─────────────────────────

PARALLEL_BATCH = GRID_IMAGES  # the offset shape (2048, 32, 32, 3), the grid's images
PARALLEL_SEVERITY = 3
PARALLEL_ROWS = ("conf", "correct", "fail", "entropy", "brier", "anomaly", "energy", "l1_status", "l1_anomaly")
PARALLEL_MEMBERS = 5  # the ensemble checkpoint's members and widths
PARALLEL_WIDTHS = "64,128,256"
PARALLEL_STEPS = 3
PARALLEL_LR = 1e-3  # pretrain's default
# pretrain --shard against pretrain on the card (tests/test_torch_parallel_train.py's
# bar): cuDNN's backward sums in no fixed order, and AdamW's first steps move a
# weight by about lr in the sign of its gradient, so a weight whose gradient
# lies within the noise moves either way. The member losses of every step
# within 1e-3 relative; each weight leaf's change from its initialisation
# within 0.25 of the plain run's change, in norm; the conv biases before
# GroupNorm, whose gradient is zero in exact arithmetic and so all noise,
# within 2 lr a step.
PARALLEL_PARAM_ATOL = 2 * PARALLEL_LR * PARALLEL_STEPS
PARALLEL_LOSS_RTOL = 1e-3
PARALLEL_DELTA_GAP = 0.25
# the tensor-parallel ViT against the plain forward, both bf16 on the card:
# each row-parallel product is summed in float32 and rounded once, where the
# plain product rounds once after cuBLAS's own float32 sum (the bf16 class
# of tests/test_torch_vit.py), argmax equal wherever the plain top two lie
# more than twice that apart
PARALLEL_TP_ATOL = 0.0625


def parallel_offsets(dev) -> dict:
    """K1-K3, the Philox helper's draws and K6's fields on rows [B/2, B) at
    offset B/2, held to the same rows of the whole batch's call and to the
    plain versions; each timed with and without the offset."""
    import torch

    from fav_tpu_torch.ops import corruptions as plain
    from fav_tpu_torch.ops import corruptions_cuda as kern

    gen = torch.Generator(device=dev).manual_seed(SEED + 400)
    x = torch.rand((PARALLEL_BATCH, 32, 32, 3), generator=gen, device=dev)
    half = PARALLEL_BATCH // 2
    xs = x[half:].contiguous()
    b, h, w, c = xs.shape
    sev = PARALLEL_SEVERITY
    out = {}
    for i, (name, kid, wrapper, plain_fn) in enumerate((
            ("gaussian_noise", "K1", kern.gaussian_noise, plain.gaussian_noise_plain),
            ("shot_noise", "K2", kern.shot_noise, plain.shot_noise_plain),
            ("impulse_noise", "K3", kern.impulse_noise, plain.impulse_noise_plain))):
        seed = SEED + 401 + i
        whole = wrapper(seed, x, sev)
        part = wrapper(seed, xs, sev, row=half)
        check(torch.equal(part, whole[half:]), f"parallel: {kid} at offset {half} differs from the whole batch's rows")
        want = plain_fn(seed, xs, sev, row=half)
        diff = (part - want).abs()
        err = float(diff.max())
        if name == "shot_noise":
            frac = float((diff > 0).sum()) / diff.numel()
            check(frac <= K2_MAX_TIE_FRACTION and err <= 1.0 / plain.sev_param(plain.SHOT_C, sev) + 1e-6,
                  f"parallel: K2 at offset: {frac:.2e} of elements differ from the plain version, max {err}")
        else:
            tol = K1_TOL if name == "gaussian_noise" else 0.0
            check(err <= tol, f"parallel: {kid} at offset: max |kernel-plain| {err} > {tol}")
        ms_off = time_ms(lambda: wrapper(seed, xs, sev, row=half), reps=20)
        ms = time_ms(lambda: wrapper(seed, xs, sev), reps=20)
        out[name] = {"kid": kid, "max_abs_err": err, "ms_offset": ms_off, "ms": ms}
        phase("parallel", f"{kid} {name} on rows [{half}, {PARALLEL_BATCH}) at offset {half}: equal to the whole "
                          f"batch's rows; max|kernel-plain| {err:.3e}; {ms_off:.4f} ms with the offset, {ms:.4f} ms "
                          f"without, at ({b}, {h}, {w}, {c})")
    # the helper at every draw shape the grid gives it, and K6 on its fields
    seed = SEED + 404
    shapes = {"elastic, snow": (h, w, 1), "glass": (h, w, 2),
              **{f"octave {o}": s[1:] for o, s in enumerate(plain.octave_shapes(b, h, w))}}
    for label, tail in shapes.items():
        for draw in (0, 1):
            whole = kern.uniform(seed, (PARALLEL_BATCH, *tail), draw, dev)
            part = kern.uniform(seed, (b, *tail), draw, dev, row=half)
            check(torch.equal(part, whole[half:]), f"parallel: helper {label} draw {draw} at offset differs")
            check(torch.equal(part, plain.uniform_field(seed, (b, *tail), draw, dev, row=half)),
                  f"parallel: helper {label} draw {draw} at offset differs from uniform_field")
    n = b * h * w * 2
    ms_off = time_ms(lambda: kern.uniform(seed, (b, h, w, 2), 0, dev, row=half), reps=20)
    ms = time_ms(lambda: kern.uniform(seed, (b, h, w, 2), 0, dev), reps=20)
    out["philox_uniform"] = {"kid": "helper", "max_abs_err": 0.0, "ms_offset": ms_off, "ms": ms}
    fy, fx = plain.elastic_fields(seed, xs, sev, uniform=kern.uniform, row=half)
    wy, wx = plain.elastic_fields(seed, x, sev, uniform=kern.uniform)
    check(torch.equal(fy, wy[half:]) and torch.equal(fx, wx[half:]), "parallel: K6's fields at offset differ")
    warped = kern.elastic_warp(xs, fy, fx, sev)
    check(torch.equal(warped, kern.elastic_transform(seed, x, sev)[half:]), "parallel: K6 at offset differs")
    check(torch.equal(warped, plain.elastic_from_fields(xs, fy, fx, sev)), "parallel: K6 at offset vs plain")
    phase("parallel", f"helper draws 0 and 1 at offset {half} (elastic and snow, glass, fog and frost octaves "
                      f"{', '.join(str(s) for s in shapes.values())}): bit-equal to the whole batch's rows and to "
                      f"uniform_field; {ms_off:.4f} ms with the offset, {ms:.4f} ms without ({n} draws); K6's fields "
                      f"and warp at offset equal to the whole batch's rows and to its plain version")
    return out


def parallel_phase(dev, ds, smi: str) -> dict:
    """The parallel paths on a world of one; see the module docstring, phase 16."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch

    from fav_tpu_torch.models import pretrain
    from fav_tpu_torch.models.vit import tensor_parallel_vit
    from fav_tpu_torch.ops import corruptions_cuda as kern
    from fav_tpu_torch.parallel.dist import destroy_world, init_world
    from fav_tpu_torch.parallel.mesh import build_mesh
    from fav_tpu_torch.parallel.sweep import GRID_SEED, fused_sweep, sharded_sweep
    from fav_tpu_torch.utils.checkpoint import load_flax_npz, load_student, load_weights

    store = tempfile.mkdtemp(prefix="fav_world_")
    world = init_world(dev, init_method=f"file://{store}/store", timeout=120)
    mesh = build_mesh((1, 1, 1))
    phase("parallel", f"world of {world.size} ({world.backend}, NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}) "
                      f"on {world.device}; mesh {mesh.shape}; {smi}")
    report: dict = {"offsets": parallel_offsets(dev), "mesh": mesh.shape, "world": world.size}
    counts = {k: 0 for k in kern.launch_counts()}

    # the sharded 15x5 grid against fused_sweep, on the classifier
    model, meta = load_student("classifier", device=dev)
    temperature = float(meta["temperature"])
    images = torch.from_numpy(ds.test_images[:GRID_IMAGES]).to(dev)
    labels = torch.from_numpy(ds.test_labels[:GRID_IMAGES]).to(dev)
    kw = dict(temperature=temperature, return_rows=PARALLEL_ROWS)
    walls = {}
    for _ in range(2):  # the first run of each warms its shapes
        torch.cuda.synchronize()
        kern.reset_launch_counts()
        t = time.perf_counter()
        sharded = sharded_sweep(mesh, model, images, labels, GRID_SEED, fused=True, params=list(model.parameters()),
                                **kw)
        torch.cuda.synchronize()
        walls["sharded"] = time.perf_counter() - t
        grid_counts = kern.launch_counts()
        t = time.perf_counter()
        whole = fused_sweep(model, images, labels, GRID_SEED, **kw)
        torch.cuda.synchronize()
        walls["fused"] = time.perf_counter() - t
    check(grid_counts == grid_launches(), f"parallel: sharded grid launches {grid_counts}, expected {grid_launches()}")
    counts = {k: counts[k] + grid_counts[k] for k in counts}
    check(sharded[1] == whole[1] and len(whole[1]) == 75, "parallel: the grids' cells differ")
    for r in PARALLEL_ROWS:
        check(np.array_equal(sharded[2][r], whole[2][r]), f"parallel: sharded row {r} differs from fused_sweep's")
    check(sharded[0] == whole[0], "parallel: the sharded grid's metrics differ from fused_sweep's")
    report["grid"] = {"sharded_s": walls["sharded"], "fused_s": walls["fused"]}
    phase("parallel", f"sharded_sweep over {mesh.shape}, classifier, 75 cells x {GRID_IMAGES} images: per-sample rows "
                      f"({', '.join(PARALLEL_ROWS)}) and metrics equal to fused_sweep's bit for bit; "
                      f"{walls['sharded']:.3f} s wall sharded, {walls['fused']:.3f} s fused (warm)")

    # pretrain --ensemble 5 --shard against pretrain --ensemble 5
    out_dir = REPO_DIR / "build" / "torch_checkpoints" / "parallel"
    shutil.rmtree(out_dir, ignore_errors=True)
    base = ["--ensemble", str(PARALLEL_MEMBERS), "--widths", PARALLEL_WIDTHS, "--batch", str(TRAIN_BATCH),
            "--augmix", "--steps", str(PARALLEL_STEPS), "--log-every", "1", "--lr", str(PARALLEL_LR),
            "--device", dev.type]
    logs, metas, pre_walls = {}, {}, {}
    for label, extra in (("shard", ["--shard"]), ("plain", []), ("init", ["--steps", "0"])):
        buf = io.StringIO()
        torch.cuda.synchronize()
        kern.reset_launch_counts()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            metas[label] = pretrain.main([*base, *extra, "--out", str(out_dir / label)], dataset=ds)
        torch.cuda.synchronize()
        pre_walls[label] = time.perf_counter() - t
        if label == "shard":
            shard_counts = kern.launch_counts()
        logs[label] = [ln for ln in buf.getvalue().splitlines() if ln.startswith("step ")]
    views = PARALLEL_MEMBERS * 2 * PARALLEL_STEPS
    want = {k: 0 for k in counts} | {"shear_rows": 2 * views, "shear_cols": views}
    check(shard_counts == want, f"parallel: pretrain --shard launches {shard_counts}, expected {want}")
    counts = {k: counts[k] + shard_counts[k] for k in counts}
    check(sorted(metas["shard"]) == sorted(metas["plain"]), "parallel: pretrain --shard metadata keys differ")
    loss = {k: np.array([[float(v) for v in ln.split("[")[1].rstrip("]").split(",")] for ln in lg])
            for k, lg in logs.items()}
    check(loss["shard"].shape == (PARALLEL_STEPS, PARALLEL_MEMBERS), f"parallel: member losses {loss['shard']}")
    check(np.allclose(loss["shard"], loss["plain"], rtol=PARALLEL_LOSS_RTOL, atol=0), f"parallel: losses {loss}")
    a, b2, w0 = (load_flax_npz(out_dir / f"{label}.npz") for label in ("shard", "plain", "init"))
    perr = max(float(np.abs(a[k] - b2[k]).max()) for k in a)
    noise = {f"Conv_{i}/bias" for i in range(3 * len(PARALLEL_WIDTHS.split(","))) if i % 3 != 2}

    def change_gap(got) -> float:
        return max(float(np.linalg.norm(got[k] - b2[k]) / np.linalg.norm(b2[k] - w0[k])) for k in b2 if k not in noise)

    gap = change_gap(a)
    check(gap <= PARALLEL_DELTA_GAP, f"parallel: pretrain --shard's weights moved {gap} off pretrain's change")
    nerr = max(float(np.abs(a[k] - b2[k]).max()) for k in noise)
    check(nerr <= PARALLEL_PARAM_ATOL, f"parallel: pretrain --shard conv biases {nerr} from pretrain's")
    check(change_gap(w0) > PARALLEL_DELTA_GAP, "parallel: the untrained control passes the weight bound")
    members, _ = load_weights("shard", device=dev, directory=out_dir)
    check(isinstance(members, list) and len(members) == PARALLEL_MEMBERS, "parallel: weights read back")
    report["pretrain"] = {"shard_s": pre_walls["shard"], "plain_s": pre_walls["plain"], "max_param_diff": perr,
                          "max_change_gap": gap}
    phase("parallel", f"pretrain --ensemble {PARALLEL_MEMBERS} --shard --widths {PARALLEL_WIDTHS} --batch "
                      f"{TRAIN_BATCH} --augmix --steps {PARALLEL_STEPS} (one rank: unsharded, as fav_tpu on one "
                      f"device) against pretrain without --shard: member losses within {PARALLEL_LOSS_RTOL} "
                      f"relative, each leaf's change from the init within {gap:.3e} of pretrain's (tol "
                      f"{PARALLEL_DELTA_GAP}; the untrained init fails it), weights within {perr:.3e}, conv "
                      f"biases before GroupNorm within {nerr:.3e} (tol {PARALLEL_PARAM_ATOL}), read back as "
                      f"{len(members)} members; "
                      f"{pre_walls['shard']:.2f} s and {pre_walls['plain']:.2f} s wall")

    # the tensor-parallel ViT on a model axis of one
    vit, _ = load_weights("vit", device=dev)
    local = tensor_parallel_vit(vit, mesh)
    with torch.no_grad():
        want_logits = vit(images)
        got = local(images)
        plain_ms = time_ms(lambda: vit(images), reps=5)
        tp_ms = time_ms(lambda: local(images), reps=5)
    want_np, got_np = want_logits.float().cpu().numpy(), got.float().cpu().numpy()
    err = float(np.abs(got_np - want_np).max())
    top2 = np.sort(want_np, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * PARALLEL_TP_ATOL
    check(np.isfinite(got_np).all() and err <= PARALLEL_TP_ATOL, f"parallel: TP ViT max diff {err}")
    check(bool((got_np.argmax(-1) == want_np.argmax(-1))[clear].all()), "parallel: TP ViT argmax differs")
    report["tp_vit"] = {"max_abs_err": err, "ms": tp_ms, "plain_ms": plain_ms}
    phase("parallel", f"tensor_parallel_vit (vit: dim 128, depth 4, 4 heads) over {mesh.shape} at batch "
                      f"{GRID_IMAGES}: max|tp-plain| {err:.4f} (tol {PARALLEL_TP_ATOL}), argmax equal on the "
                      f"{int(clear.sum())} rows with a clear margin; {tp_ms:.3f} ms against {plain_ms:.3f} ms "
                      f"(8 all-reduces of a world of one)")
    destroy_world()
    shutil.rmtree(store, ignore_errors=True)
    report["counts"] = counts
    return report


def main(argv: list[str]) -> int:
    import torch

    # ── 1. device ──────────────────────────────────────────────────────────
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0].strip()
    kind = torch.cuda.get_device_name(0)
    bw, peak_ops, peak_row = card_peaks(kind)
    phase("device", f"{kind} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
                    f"peaks used: {peak_row} {bw / 1e12:.2f} TB/s, {peak_ops / 1e12:.0f} Tops/s")
    # The band-matrix products of the corruption families are float32
    # matmuls, the counterpart of fav_tpu's Precision.HIGHEST: full float32,
    # never TF32. cuDNN convolutions would take TF32 by default; the compared
    # forward is bf16, but the setting is pinned all the same.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("device", f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
                    f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    import numpy as np

    from fav_tpu_torch.ops import _build
    from fav_tpu_torch.ops import corruptions as plain
    from fav_tpu_torch.ops import corruptions_cuda as kern
    from fav_tpu_torch.ops.random import uniform01
    from fav_tpu_torch.pipeline import BATCH, BENCH_CELLS, make_megastep
    from fav_tpu_torch.utils.checkpoint import WEIGHTS_DIR, load_student

    dev = torch.device("cuda")

    # ── 2. build ───────────────────────────────────────────────────────────
    t = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t
    check(build_s < BUILD_LIMIT_S, f"kernel build took {build_s:.1f} s (limit {BUILD_LIMIT_S} s)")
    for name, path in libs.items():
        log = path.with_suffix(".log")
        usage = [ln.strip() for ln in log.read_text().splitlines() if "Used" in ln or "Compiling entry" in ln] if log.exists() else []
        phase("build", f"{name}: {path.name} in {build_s:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
        for ln in usage:
            print(f"           ptxas {ln}", flush=True)

    # ── 3. kernels against their plain versions ───────────────────────────
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.rand((BATCH, 32, 32, 3), generator=gen, device=dev, dtype=torch.float32)
    n = x.numel()
    sev = 3
    report = {}
    specs = [
        # (entry name, kernel id, wrapper, plain version)
        ("gaussian_noise", "K1", kern.gaussian_noise, plain.gaussian_noise_plain),
        ("shot_noise", "K2", kern.shot_noise, plain.shot_noise_plain),
        ("impulse_noise", "K3", kern.impulse_noise, plain.impulse_noise_plain),
        ("brightness", "K4", kern.brightness, plain.brightness_plain),
        ("contrast", "K4", kern.contrast, plain.contrast_plain),
    ]
    for i, (name, kid, wrapper, plain_fn) in enumerate(specs):  # K1-K4
        seed = SEED + 1 + i
        got = wrapper(seed, x, sev)
        want = plain_fn(seed, x, sev)
        torch.cuda.synchronize()
        check(got.shape == x.shape and got.dtype == torch.float32, f"{name}: bad output {got.shape} {got.dtype}")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        diff = (got - want).abs()
        err = float(diff.max())
        if name == "shot_noise":
            c = plain.sev_param(plain.SHOT_C, sev)
            frac = float((diff > 0).sum()) / n
            check(frac <= K2_MAX_TIE_FRACTION, f"{name}: {frac:.2e} of elements differ (limit {K2_MAX_TIE_FRACTION})")
            check(err <= 1.0 / c + 1e-6, f"{name}: max diff {err} exceeds one count (1/c = {1.0 / c})")
            extra = f"differing fraction {frac:.3e}"
        elif name in ("impulse_noise", "brightness"):
            check(err == 0.0, f"{name}: max diff {err}, expected exact")
            extra = "exact"
        else:
            tol = K1_TOL if name == "gaussian_noise" else K4_CONTRAST_TOL
            check(err <= tol, f"{name}: max diff {err} > {tol}")
            extra = f"tol {tol}"
            if name == "gaussian_noise":
                extra += "; " + check_k1_odd(x, seed, sev)
        ms = time_ms(lambda: wrapper(seed, x, sev), reps=20)
        plain_ms = time_ms(lambda: plain_fn(seed, x, sev), reps=3, warmup=1)
        bytes_moved = 2 * n * 4
        ops = OPS_PER_ELEMENT[name] * n
        library_ms = None
        if name == "shot_noise":
            terms, bytes_k, ops_k = shot_work(x, seed, sev)
            bytes_moved, ops = bytes_k, ops_k
            extra += f" at seed {seed}, mean terms per element {1 + terms / n:.3f} of {plain.shot_k_max(sev)}"
            library_ms, lib_note = shot_library(x, got, sev)
            extra += f"; {lib_note}"
        t_bytes, t_ops = bytes_moved / bw * 1e3, ops / peak_ops * 1e3
        bound_ms = max(t_bytes, t_ops)
        report[name] = {
            "kid": kid, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "bytes": bytes_moved, "ops": ops,
            "library_ms": library_ms,
        }
        phase("kernels", f"{kid} {name}: max|kernel-plain| {err:.3e} ({extra}); kernel {ms:.4f} ms, "
                         f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({report[name]['bound_by']}: "
                         f"{bytes_moved / 1e6:.1f} MB, {ops / 1e9:.3f} Gop)")
    del got, want, diff

    b, h, w, c = x.shape
    pixels = b * h * w

    def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
        t_bytes, t_ops = bytes_moved / bw * 1e3, ops / peak_ops * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    # K2 across its range, timed at severity 1 as well
    k2_report = check_k2(x, bound)

    # the Philox helper against uniform01, word for word
    seed = SEED + 11
    got = kern.uniform(seed, (n,), 1, dev)
    want = uniform01(seed, n, 1, device=dev)
    check(torch.equal(got, want), "philox_uniform: the helper's uniforms differ from uniform01")
    ms = time_ms(lambda: kern.uniform(seed, (n,), 1, dev), reps=20)
    plain_ms = time_ms(lambda: uniform01(seed, n, 1, device=dev), reps=3, warmup=1)
    bound_ms, by = bound(4 * n, PHILOX_UNIFORM_OPS * n)
    # the library yardstick: torch.rand draws the same law from another stream
    library_ms = time_ms(lambda: torch.rand(n, device=dev), reps=20)
    lib_mean = float(torch.rand(n, device=dev).double().mean())
    report["philox_uniform"] = {"kid": "helper", "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                                "bound_ms": bound_ms, "bound_by": by, "library_ms": library_ms}
    phase("kernels", f"philox_uniform helper: bit-equal to uniform01 over {n} draws; kernel {ms:.4f} ms, "
                     f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({by}); torch.rand {library_ms:.4f} ms "
                     f"(another stream: mean {lib_mean:.6f} against the kernel's {float(got.double().mean()):.6f})")

    # K5: the glass resample cascade, exact at every severity and on odd
    # shapes; K5p exact to K5 at every severity; timed at severity 3 (m = 2,
    # 3 rounds)
    seed = SEED + 12
    check_k5(x, seed)
    _, m, iters = plain.sev_param(plain.GLASS_SEV, sev)
    got = kern.glass_resample(seed, x, m, iters)
    want = plain.glass_resample_plain(seed, x, m, iters)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(got.shape == x.shape and err <= K5_K6_TOL, f"glass_resample: max diff {err}, expected exact")
    ms = time_ms(lambda: kern.glass_resample(seed, x, m, iters), reps=20)
    plain_ms = time_ms(lambda: plain.glass_resample_plain(seed, x, m, iters), reps=3, warmup=1)
    bytes_moved = 2 * n * 4
    ops = 2 * iters * GLASS_OPS_PER_PIXEL_PASS * pixels
    bound_ms, by = bound(bytes_moved, ops)
    report["glass_resample"] = {"kid": "K5", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                "bound_ms": bound_ms, "bound_by": by, "library_ms": None}
    phase("kernels", f"K5 glass_resample (m={m}, iters={iters}): max|kernel-plain| {err:.3e} (exact); "
                     f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({by}: "
                     f"{bytes_moved / 1e6:.1f} MB, {ops / 1e9:.3f} Gop); library: none (no single PyTorch "
                     f"call draws and applies the cascade)")

    # K5p: the same cascade on groups of G = packed_group(B, W) images, held
    # to its plain version and to K5; the same bytes and operations as K5
    g5 = plain.packed_group(b, w)
    got_p = kern.glass_resample(seed, x, m, iters, packed=True)
    want_p = plain.glass_resample_packed_plain(seed, x, m, iters)
    torch.cuda.synchronize()
    err = float((got_p - want_p).abs().max())
    err_k5 = float((got_p - got).abs().max())
    check(got_p.shape == x.shape and max(err, err_k5) <= K5_K6_TOL,
          f"glass_resample_packed: max diff {err} from its plain version, {err_k5} from K5, expected exact")
    ms = time_ms(lambda: kern.glass_resample(seed, x, m, iters, packed=True), reps=20)
    plain_ms = time_ms(lambda: plain.glass_resample_packed_plain(seed, x, m, iters), reps=3, warmup=1)
    report["glass_resample_packed"] = {"kid": "K5p", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                       "bound_ms": bound_ms, "bound_by": by, "library_ms": None}
    phase("kernels", f"K5p glass_resample_packed (G={g5}): max|kernel-plain| {err:.3e}, max|K5p-K5| "
                     f"{err_k5:.3e} (exact); {kern.glass_packed_shared_bytes(g5, h, w, c, 2 * iters)} B shared a "
                     f"block; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({by}, as K5), "
                     f"{ms / bound_ms:.2f}x the bound; library: none")
    del got, want, got_p, want_p

    # K6: the elastic warp on the fields of a seed, exact at every severity
    # (m = 2 .. 6), timed at severity 3 (alpha 3.5, m = 4)
    # K6p on groups of G = packed_group(B, W + 2(m + 1)) images (3 at
    # severities 1-3, 2 at 4-5), held to its plain version and to K6
    packed_err = {}
    for level in range(1, len(plain.ELASTIC_SEV) + 1):
        fy, fx = plain.elastic_fields(SEED + 13, x, level, uniform=kern.uniform)
        got = kern.elastic_warp(x, fy, fx, level)
        diff = float((got - plain.elastic_from_fields(x, fy, fx, level)).abs().max())
        check(got.shape == x.shape and diff <= K5_K6_TOL,
              f"elastic_warp severity {level}: max diff {diff}, expected exact")
        g6 = plain.packed_group(b, w + 2 * (plain.elastic_margin(level) + 1))
        got_p = kern.elastic_warp(x, fy, fx, level, packed=True)
        diff_p = float((got_p - plain.elastic_from_fields_packed(x, fy, fx, level, g6)).abs().max())
        diff_k6 = float((got_p - got).abs().max())
        check(got_p.shape == x.shape and max(diff_p, diff_k6) <= K5_K6_TOL,
              f"elastic_warp_packed severity {level} (G={g6}): max diff {diff_p} from its plain version, "
              f"{diff_k6} from K6, expected exact")
        packed_err[level] = (g6, diff_p, diff_k6)
        if level == sev:
            ys, xs, err = fy, fx, diff
        del got, got_p, fy, fx
    em = plain.elastic_margin(sev)
    got = kern.elastic_warp(x, ys, xs, sev)
    ms = time_ms(lambda: kern.elastic_warp(x, ys, xs, sev), reps=20)
    plain_ms = time_ms(lambda: plain.elastic_from_fields(x, ys, xs, sev), reps=3, warmup=1)
    # the library yardstick: grid_sample's clamped bilinear warp, same coordinates
    x_nchw = x.permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([xs / (w - 1) * 2 - 1, ys / (h - 1) * 2 - 1], dim=-1)
    sample = torch.nn.functional.grid_sample

    def library():
        return sample(x_nchw, grid, mode="bilinear", padding_mode="border", align_corners=True)

    lib_err = float((library().permute(0, 2, 3, 1) - got).abs().max())
    library_ms = time_ms(library, reps=20)
    bytes_moved = 2 * n * 4 + 2 * pixels * 4
    ops = elastic_live_ops(ys, xs, em, c)
    bound_ms, by = bound(bytes_moved, ops)
    report["elastic_warp"] = {"kid": "K6", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": bound_ms, "bound_by": by, "library_ms": library_ms}
    phase("kernels", f"K6 elastic_warp (m={em}): max|kernel-plain| {err:.3e} (exact, and at severities "
                     f"1-5); kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({by}: "
                     f"{bytes_moved / 1e6:.1f} MB, {ops / 1e9:.3f} Gop of live taps); grid_sample "
                     f"{library_ms:.4f} ms (max|grid_sample-kernel| {lib_err:.3e}, another order of operations)")
    g6, err, err_k6 = packed_err[sev]
    geo6 = kern.elastic_packed_geometry(b, g6, h, w, c, kern.multiprocessors(dev))
    k6_ms = ms
    ms = time_ms(lambda: kern.elastic_warp(x, ys, xs, sev, packed=True), reps=20)
    plain_ms = time_ms(lambda: plain.elastic_from_fields_packed(x, ys, xs, sev, g6), reps=3, warmup=1)
    report["elastic_warp_packed"] = {"kid": "K6p", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                     "bound_ms": bound_ms, "bound_by": by, "library_ms": library_ms}
    phase("kernels", f"K6p elastic_warp_packed (m={em}, G={g6}): max|kernel-plain| {err:.3e}, max|K6p-K6| "
                     f"{err_k6:.3e} (exact, and at severities 1-5: G "
                     f"{'/'.join(str(v[0]) for v in packed_err.values())}); {geo6.blocks} blocks, "
                     f"{geo6.shared_bytes} B shared; kernel {ms:.4f} ms, plain "
                     f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({by}, as K6), {ms / bound_ms:.2f}x the bound; "
                     f"grid_sample {library_ms:.4f} ms, K6 {k6_ms:.4f} ms")
    del got, ys, xs, x_nchw, grid
    check_k6p_small_batch(x)

    # K7 at the service's and the grid's shapes; K8 at the megastep's
    k7_report = check_k7(dev, gen, bound)
    k8_report = check_k8(x, bound)
    # K9a and K9b at an AugMix view's chain batch
    k9_report = check_k9(dev, gen, bound)
    # the kernels redesigned last and their share of the bound, on one line
    # (the line an A/B of two commits reads)
    redesigned = [(f"K1 gaussian_noise at {tuple(x.shape)}", report["gaussian_noise"]),
                  (f"bf16 K9a shear_rows_bf16 at {(SHEAR_BATCH, 32, 32, 3)}", k9_report["shear_rows_bf16"]),
                  (f"bf16 K9b shear_cols_bf16 at {(SHEAR_BATCH, 32, 32, 3)}", k9_report["shear_cols_bf16"])]
    phase("kernels", "redesigned: " + "; ".join(
        f"{label} {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
        f"{100 * r['bound_ms'] / r['ms']:.1f}% of the bound" for label, r in redesigned) + f" | {smi}")

    # ── 4. the nano student against the JAX package's golden logits ──────
    model, meta = load_student("student_nano", device=dev)
    golden = json.loads((WEIGHTS_DIR / "student_nano.golden.json").read_text())
    gimg = np.random.default_rng(golden["seed"]).random(tuple(golden["shape"]), dtype=np.float32)
    with torch.no_grad():
        logits = model(torch.from_numpy(gimg).to(dev)).cpu().numpy()
    want_logits = np.asarray(golden["logits"], np.float32)
    gerr = float(np.abs(logits - want_logits).max())
    check(np.isfinite(logits).all(), "golden: non-finite logits")
    check(gerr <= GOLDEN_ATOL, f"golden: max |logit - JAX logit| {gerr} > {GOLDEN_ATOL}")
    top2 = np.sort(want_logits, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * GOLDEN_ATOL
    check(bool((logits.argmax(-1) == want_logits.argmax(-1))[clear].all()), "golden: argmax differs from JAX's")
    phase("golden", f"nano bf16 logits vs JAX: max abs diff {gerr:.4f} (tol {GOLDEN_ATOL}), argmax equal "
                    f"on the {int(clear.sum())} of {gimg.shape[0]} images with a clear margin")

    # ── 5. the megastep ────────────────────────────────────────────────────
    images = torch.rand((BATCH, 32, 32, 3), generator=gen, device=dev, dtype=torch.float32)
    megastep = make_megastep(model, BENCH_CELLS, dev)
    # one megastep, its launches counted from zero
    kern.reset_launch_counts()
    torch.cuda.synchronize()
    out = megastep(images, torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize()
    counts = kern.launch_counts()
    check(counts == MEGASTEP_LAUNCHES, f"launch counts {counts}, expected {MEGASTEP_LAUNCHES}")
    vals = out.cpu()
    check(vals.shape == (3,) and bool(torch.isfinite(vals).all()), f"megastep output {vals}")
    check(bool(((vals >= 0) & (vals <= 1)).all()), f"megastep output outside [0, 1]: {vals}")
    phase("megastep", f"{len(BENCH_CELLS)} cells at batch {BATCH}: out {[round(float(v), 6) for v in vals]}; "
                      f"launches in one megastep {counts}")

    step_gen = torch.Generator().manual_seed(SEED)
    for _ in range(WARMUP):
        megastep(images, step_gen)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(ITERS):
        megastep(images, step_gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) / ITERS * 1e3
    img_s = BATCH * len(BENCH_CELLS) / (step_ms / 1e3)
    phase("megastep", f"{step_ms:.3f} ms/megastep, {img_s:.0f} img/s ({BATCH}x{len(BENCH_CELLS)} images, "
                      f"{ITERS} timed after {WARMUP} warm-up) on {smi}")

    # where the megastep's time goes: each family's corruption, and the forwards
    family_ms = {}
    for name, s in BENCH_CELLS:
        fn = kern.corruption_fn(name)
        family_ms[name] = time_ms(lambda: fn(SEED, images, s), reps=5)
    corrupted = kern.corruption_fn("gaussian_noise")(SEED, images, 3)
    with torch.no_grad():
        forward_ms = time_ms(lambda: model(corrupted), reps=5)
    del corrupted
    corrupt_ms = sum(family_ms.values())
    phase("megastep", f"breakdown (CUDA events): {len(BENCH_CELLS)} corruptions {corrupt_ms:.3f} ms, "
                      f"{len(BENCH_CELLS)} nano forwards {forward_ms * len(BENCH_CELLS):.3f} ms "
                      f"({forward_ms:.3f} ms each)")
    phase("megastep", "per-family corruption ms: " + ", ".join(f"{k} {v:.4f}" for k, v in family_ms.items()))

    kernel_out = megastep(images, torch.Generator().manual_seed(SEED + 99))
    plain_step = make_megastep(model, BENCH_CELLS, dev, corruption_fn=plain.corruption_fn)
    plain_out = plain_step(images, torch.Generator().manual_seed(SEED + 99))
    merr = float((kernel_out - plain_out).abs().max())
    check(merr <= MEGASTEP_TOL, f"megastep kernels vs plain: {kernel_out.tolist()} vs {plain_out.tolist()}")
    phase("megastep", f"kernels vs plain versions: max abs diff {merr:.3e} (tol {MEGASTEP_TOL})")
    if "--profile" in argv:
        profile_step(lambda: megastep(images, torch.Generator().manual_seed(SEED)), step_ms, "one megastep")

    # ── 6. the analysis service on scripted streams ───────────────────────
    monitor = monitor_phase(dev, profile="--profile" in argv)

    # ── 7. the grid's L1 pass into the policy replay ──────────────────────
    policy = policy_phase(model, images, dev)

    # ── 8. the AugMix training path of the classifier configuration ──────
    train = train_phase(dev, profile="--profile" in argv)

    # ── 9. the packed A/B: kernel arms and megastep arms ──────────────────
    ab = packed_phase(dev)
    packed_counts = ab["ab_packed"]["packed"]["launches"]

    # ── 10. the decision-support server's live path and socket ────────────
    serve = serve_phase(dev, profile="--profile" in argv)

    # ── 11. the evaluation grid through the port's CLI ────────────────────
    from fav_tpu_torch.data.cifar import load_cifar10

    t = time.perf_counter()
    ds = load_cifar10()
    phase("grid", f"dataset {ds.source}: {ds.test_images.shape[0]} test images in {time.perf_counter() - t:.2f} s "
                  f"(made on the host, outside every timing below)")
    grid = grid_phase(dev, ds, profile="--profile" in argv)

    # ── 12. the other families and multi-forward uncertainty ──────────────
    families = families_phase(dev, ds)
    fam_serve = families["serve"]
    fam_grid = {k: sum(c[k] for c in families["counts"].values()) for k in grid["counts"]}

    # ── 13. the remaining trainers and the pretrain CLI ────────────────────
    trainers = trainers_phase(dev, ds)

    # ── 14. the server's Mahalanobis column, the fit and replay tools ─────
    maha = maha_phase(dev, ds)

    # ── 15. W8A8 quantisation ──────────────────────────────────────────────
    quant = quant_phase(dev, ds)

    # ── 16. the parallel paths on a world of one ──────────────────────────
    par = parallel_phase(dev, ds, smi)

    # ── report ─────────────────────────────────────────────────────────────
    pallas = "fav_tpu/ops/corruptions_pallas.py"
    csrc = "fav_tpu_torch/ops/csrc"
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    entries = []
    grid_counts = {k: grid["counts"][k] + grid["gated_counts"][k] + fam_grid[k] for k in grid["counts"]}
    for name, src, replaces, launches in (
        ("gaussian_noise", "corruptions.cu", f"{pallas}:93", counts["gaussian_noise"] + grid_counts["gaussian_noise"]),
        ("shot_noise", "corruptions.cu", f"{pallas}:107", counts["shot_noise"] + grid_counts["shot_noise"]),
        ("impulse_noise", "corruptions.cu", f"{pallas}:100", counts["impulse_noise"] + grid_counts["impulse_noise"]),
    ):
        r = report[name]
        entries.append({"name": f"{r['kid']} {name}", "route": "cuda", "source": f"{csrc}/{src}",
                        "replaces": replaces, "launches": launches, **{k: r[k] for k in keys},
                        "library_ms": r["library_ms"]})
        if name == "shot_noise":
            entries[-1]["library_note"] = "torch.poisson(x c), the draw only (no scale or clip), another stream"
            entries[-1]["variants"] = k2_report
    # K4 runs twice per megastep, once as each cell: its numbers are per launch,
    # averaged over the two, and each cell's own stand under "variants".
    b4, c4 = report["brightness"], report["contrast"]
    entries.append({
        "name": "K4 photometric", "route": "cuda", "source": f"{csrc}/corruptions.cu", "replaces": f"{pallas}:143",
        "launches": counts["photometric"] + grid_counts["photometric"],
        "max_abs_err": max(b4["max_abs_err"], c4["max_abs_err"]),
        "ms": (b4["ms"] + c4["ms"]) / 2, "plain_ms": (b4["plain_ms"] + c4["plain_ms"]) / 2,
        "bound_ms": (b4["bound_ms"] + c4["bound_ms"]) / 2, "bound_by": "bytes", "library_ms": None,
        "variants": {k: {f: report[k][f] for f in ("max_abs_err", "ms", "plain_ms", "bound_ms")}
                     for k in ("brightness", "contrast")},
    })
    for name, src, replaces, launches in (
        ("glass_resample", "glass.cu", f"{pallas}:295", counts["glass_resample"]),
        ("glass_resample_packed", "glass.cu", f"{pallas}:319", packed_counts["glass_resample_packed"]),
        ("elastic_warp", "elastic.cu", f"{pallas}:441", counts["elastic_warp"] + grid_counts["elastic_warp"]),
        ("elastic_warp_packed", "elastic.cu", f"{pallas}:478", packed_counts["elastic_warp_packed"]),
    ):
        r = report[name]
        entries.append({"name": f"{r['kid']} {name}", "route": "cuda", "source": f"{csrc}/{src}",
                        "replaces": replaces, "launches": launches, **{k: r[k] for k in keys},
                        "library_ms": r["library_ms"]})
    signal_pallas = "fav_tpu/ops/signal_pallas.py"
    k7_top = k7_report["32x240x320"]
    entries.append({
        "name": "K7 frame_stats", "route": "cuda", "source": f"{csrc}/frame_stats.cu",
        "replaces": f"{signal_pallas}:51",
        "launches": monitor["counts"]["frame_stats"] + policy["counts"]["frame_stats"]
        + serve["counts"]["frame_stats"] + serve["lockstep_counts"]["frame_stats"] + grid_counts["frame_stats"]
        + fam_serve["counts"]["frame_stats"] + fam_serve["lockstep_counts"]["frame_stats"]
        + maha["counts"]["frame_stats"] + maha["lockstep_counts"]["frame_stats"],
        **{k: k7_top[k] for k in keys}, "library_ms": k7_top["library_ms"],
        "library_note": "torch.bincount computes the histogram part only",
        "variants": k7_report,
    })
    k8_top = k8_report[f"sigma={K8_SIGMAS[-1]}"]
    entries.append({
        "name": "K8 corrupt_normalize", "route": "cuda", "source": f"{csrc}/corruptions.cu",
        "replaces": f"{pallas}:129", "launches": 0, **{k: k8_top[k] for k in keys}, "library_ms": None,
        "path_note": "no path of fav_tpu calls corrupt_normalize_pallas; held to its plain version only",
        "variants": k8_report,
    })
    augment_pallas = "fav_tpu/ops/augment_pallas.py"
    for name, replaces in (("shear_rows", f"{augment_pallas}:40"), ("shear_cols", f"{augment_pallas}:54"),
                           ("shear_rows_bf16", f"{augment_pallas}:40"), ("shear_cols_bf16", f"{augment_pallas}:54")):
        r = k9_report[name]
        entries.append({"name": f"{r['kid']} {name}", "route": "cuda", "source": f"{csrc}/shear.cu",
                        "replaces": replaces,
                        "launches": train["counts"][name] + fam_grid[name] + trainers["counts"][name],
                        **{k: r[k] for k in keys}, "library_ms": r["library_ms"]})
        if r["library_note"]:
            entries[-1]["library_note"] = r["library_note"]
    paths = {"megastep": counts, "monitor": monitor["counts"], "policy": policy["counts"], "train": train["counts"],
             "packed": packed_counts, "serve": serve["counts"], "serve_lockstep": serve["lockstep_counts"],
             "grid": grid["counts"], "grid_gated": grid["gated_counts"],
             "families_serve": fam_serve["counts"], "families_serve_lockstep": fam_serve["lockstep_counts"],
             "maha": maha["counts"], "maha_lockstep": maha["lockstep_counts"],
             **{f"families_grid_{k}": c for k, c in families["counts"].items()},
             **{f"trainers_{k}": c for k, c in trainers["recipe_counts"].items()}}
    kernel_keys = {"K1 gaussian_noise": "gaussian_noise", "K2 shot_noise": "shot_noise",
                   "K3 impulse_noise": "impulse_noise", "K4 photometric": "photometric",
                   "K5 glass_resample": "glass_resample", "K5p glass_resample_packed": "glass_resample_packed",
                   "K6 elastic_warp": "elastic_warp", "K6p elastic_warp_packed": "elastic_warp_packed",
                   "K7 frame_stats": "frame_stats", "K8 corrupt_normalize": "corrupt_normalize",
                   "K9a shear_rows": "shear_rows", "K9b shear_cols": "shear_cols",
                   "K9a shear_rows_bf16": "shear_rows_bf16", "K9b shear_cols_bf16": "shear_cols_bf16"}
    for e in entries:
        e["launches_by_path"] = {path: c[kernel_keys[e["name"]]] for path, c in paths.items()}
    paths["parallel"] = par["counts"]
    for e in entries:
        key = kernel_keys[e["name"]]
        e["launches"] += par["counts"][key]
        e["launches_by_path"]["parallel"] = par["counts"][key]
        if key in par["offsets"]:
            e["ms_offset"] = par["offsets"][key]["ms_offset"]
    r = report["philox_uniform"]
    helpers = [{"name": "philox_uniform", "route": "cuda", "source": f"{csrc}/corruptions.cu",
                "replaces": None,
                "launches": counts["philox_uniform"] + grid_counts["philox_uniform"] + par["counts"]["philox_uniform"],
                **{k: r[k] for k in keys}, "ms_offset": par["offsets"]["philox_uniform"]["ms_offset"],
                "library_ms": r["library_ms"], "library_note": "torch.rand(n), another stream",
                "launches_by_path": {path: c["philox_uniform"] for path, c in paths.items()}}]
    print(json.dumps({"kernels": entries, "helpers": helpers, "megastep_ms": step_ms, "img_per_s": img_s,
                      "family_ms": family_ms, "forward_ms": forward_ms,
                      "monitor": {k: v for k, v in monitor.items() if k != "counts"},
                      "policy_step_ms": policy["step_ms"],
                      "train": {k: v for k, v in train.items() if k != "counts"},
                      "trainers": {k: trainers[k] for k in ("recipes", "golden", "cli")},
                      "serve": {k: ({f: x for f, x in v.items() if not f.endswith("counts")} if isinstance(v, dict)
                                    else v) for k, v in serve.items() if not k.endswith("counts")},
                      "grid": {k: v for k, v in grid.items() if not k.endswith("counts")},
                      "families": {"forwards": families["forwards"], "grids": families["grids"],
                                   "timing": families["timing"],
                                   "serve": {m: {label: ({f: x for f, x in r.items() if not f.endswith("counts")}
                                                         if isinstance(r, dict) else r)
                                                 for label, r in fam_serve[m].items()}
                                             for m in FAMILY_SERVE_MODES}},
                      "maha": {k: v for k, v in maha.items() if not k.endswith("counts")}, "quant": quant,
                      "parallel": {k: v for k, v in par.items() if k != "counts"},
                      "packed_ab": {"median_ms": ab["median_ms"],
                                    "megastep": {arm: {k: ab["ab_packed"][arm][k]
                                                       for k in ("ms_per_megastep", "img_per_sec")}
                                                 for arm in ("packed", "unpacked")}}}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    faulthandler.dump_traceback_later(480, exit=True)
    rc = main(sys.argv[1:])
    faulthandler.cancel_dump_traceback_later()
    sys.exit(rc)
