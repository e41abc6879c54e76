"""fav_tpu_torch quickstart: the whole failure-aware pipeline in one script.

    python -m fav_tpu_torch.quickstart [--steps 300] [--device cpu]

Counterpart of ``examples/quickstart.py``, through the port's modules: train
a small CNN (widths 16/32, dense 32) on the synthetic CIFAR-10 stand-in,
calibrate it (temperature and ECE on 512 test images), sweep gaussian
noise (K1 on the card), fog and defocus blur at severities 1, 3 and 5 over
256 images, map the severity-5 noise confidence to the trust engine's
anomaly signal, replay a degradation scenario (healthy, degrading,
corrupted, recovering) through the trust recurrence (``core/
trust_scan.py``) and print the policy trajectory. Runs on the card unless
``--device cpu`` is given; no data needed.
"""

from __future__ import annotations

import argparse

import torch

from fav_tpu_torch.config import DEFAULT_CONFIG, STATUS_CODES, ModelParams, policy_name
from fav_tpu_torch.core.trust_scan import simulate_sequence
from fav_tpu_torch.data.cifar import load_cifar10
from fav_tpu_torch.device import resolve_device
from fav_tpu_torch.models.calibration import expected_calibration_error, fit_temperature
from fav_tpu_torch.models.cnn import create_model
from fav_tpu_torch.models.train import classifier_eval_step, train_classifier
from fav_tpu_torch.parallel.sweep import corruption_sweep

__all__ = ["SWEEP_CORRUPTIONS", "SWEEP_SEVERITIES", "main", "trust_scenario"]

SWEEP_CORRUPTIONS = ("gaussian_noise", "fog", "defocus_blur")
SWEEP_SEVERITIES = (1, 3, 5)
CALIB_IMAGES = 512
SWEEP_IMAGES = 256
TICK_S = 1 / 30


def trust_scenario(sev5: float) -> tuple[list[int], list[float]]:
    """Per-tick statuses and anomalies at 30 Hz: 2 s healthy, 2 s degrading
    at ``max(0.3, sev5)``, 1.5 s corrupted, 5 s recovering."""
    phases = [("VISION_OK", 0.02, 60), ("VISION_OK", max(0.3, sev5), 60),
              ("VISION_CORRUPTED", 0.8, 45), ("VISION_OK", 0.02, 150)]
    statuses, anomalies = [], []
    for status, a, ticks in phases:
        statuses += [STATUS_CODES[status]] * ticks
        anomalies += [a] * ticks
    return statuses, anomalies


def main(argv=None, dataset=None) -> dict:
    """Run the five stages; returns what they printed: ``accuracy``,
    ``temperature``, ``ece``, the sweep's ``grid``, ``sev5_anomaly``, the
    scenario's ``reliability`` and ``policy`` per tick. ``dataset`` stands
    in for ``load_cifar10()``."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. data + model
    ds = load_cifar10() if dataset is None else dataset
    print(f"[1/5] dataset: {ds.source}, device: {dev}")
    model, _ = train_classifier(create_model(ModelParams(widths=(16, 32), dense_width=32)), ds,
                                num_steps=args.steps, batch_size=128, device=dev)
    model.eval()

    # 2. calibrate
    x = torch.from_numpy(ds.test_images[:CALIB_IMAGES]).to(dev)
    y = torch.from_numpy(ds.test_labels[:CALIB_IMAGES]).to(dev)
    out = classifier_eval_step(model, x, y)
    temperature = float(fit_temperature(out["logits"], y))
    conf = torch.softmax(out["logits"] / temperature, dim=-1).amax(dim=-1)
    correct = (out["logits"].argmax(dim=-1) == y).to(torch.float32)
    ece = float(expected_calibration_error(conf, correct))
    print(f"[2/5] accuracy {float(out['accuracy']):.3f}, T={temperature:.3f}, ECE {ece:.4f}")

    # 3. corruption sweep
    grid = corruption_sweep(model, torch.from_numpy(ds.test_images[:SWEEP_IMAGES]).to(dev),
                            torch.from_numpy(ds.test_labels[:SWEEP_IMAGES]).to(dev), seed=0,
                            corruptions=SWEEP_CORRUPTIONS, severities=SWEEP_SEVERITIES, temperature=temperature)
    print("[3/5] corruption sweep (accuracy | mean anomaly):")
    for name, cells in grid.items():
        row = "  ".join(f"s{s}: {c['accuracy']:.2f}|{c['mean_anomaly']:.3f}" for s, c in cells.items())
        print(f"      {name:16s} {row}")

    # 4. confidence -> trust-engine anomaly
    sev5 = grid["gaussian_noise"][5]["mean_anomaly"]
    print(f"[4/5] severity-5 gaussian noise maps to anomaly {sev5:.3f} for the trust engine")

    # 5. trust replay: healthy -> degrading -> corrupted -> recovery
    statuses, anomalies = trust_scenario(sev5)
    n = len(statuses)
    _, outs = simulate_sequence(
        DEFAULT_CONFIG.trust, torch.tensor(statuses, dtype=torch.int32, device=dev),
        torch.tensor(anomalies, dtype=torch.float32, device=dev), torch.ones(n, dtype=torch.bool, device=dev),
        torch.full((n,), TICK_S, dtype=torch.float32, device=dev))
    reliability = outs.reliability.tolist()
    policy = outs.policy.tolist()
    print("[5/5] trust trajectory (1 s samples):")
    for i in range(0, n, 30):
        r = reliability[i]
        print(f"      t={i / 30:5.1f}s  {r:.3f} {policy_name(int(policy[i])):18s} {'#' * int(r * 30)}")
    print("done: fav_tpu_torch/serving runs this loop live")
    return {"accuracy": float(out["accuracy"]), "temperature": temperature, "ece": ece, "grid": grid,
            "sev5_anomaly": sev5, "reliability": reliability, "policy": policy}


if __name__ == "__main__":
    main()
