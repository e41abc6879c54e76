"""Train bagged members of the deployed recipe: extra seeds of the
AugMix-manifold ensemble-KD compact student (``student_compact`` is seed 0).

Counterpart of the repository's ``tools/train_student_members.py``: one
``fav_tpu_torch.models.pretrain`` run per seed, ``--distill-ensemble
--augmix --steps N --megastep K --seed S --out OUTDIR/student_mS``, in one
process. Every member distills from the same 5-member teacher
(``weights/ensemble``), so diversity comes only from the student's
initialisation, the shuffle stream and the per-seed AugMix draws; the
question is whether such members still decorrelate enough to stack
(``fav_tpu_torch.tools.stack_ensemble``).

    python -m fav_tpu_torch.tools.train_student_members [--steps 3000] [--megastep 50]
        [--seeds 1,2,3,4] [--outdir build/torch_checkpoints/members] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

from fav_tpu_torch.models import pretrain

__all__ = ["DEFAULT_OUTDIR", "RECIPE", "main", "train_members"]

RECIPE = ("--distill-ensemble", "--augmix")
DEFAULT_OUTDIR = str(pretrain.DEFAULT_OUT_DIR / "members")


def train_members(argv, recipe, prefix: str, doc: str, dataset=None) -> list[dict]:
    """Parse the member trainers' flags and run ``pretrain.main`` once per
    seed with ``recipe`` and ``--out OUTDIR/<prefix><seed>``."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--megastep", type=int, default=50)
    ap.add_argument("--seeds", type=str, default="1,2,3,4")
    ap.add_argument("--outdir", type=str, default=DEFAULT_OUTDIR)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = ["--device", args.device] if args.device else []
    results = []
    for seed in (int(s) for s in args.seeds.split(",")):
        out = os.path.join(args.outdir, f"{prefix}{seed}")
        print(f"=== member seed {seed} -> {out}", flush=True)
        res = pretrain.main([*recipe, "--steps", str(args.steps), "--megastep", str(args.megastep),
                             "--seed", str(seed), "--out", out, *device], dataset=dataset)
        print(f"seed {seed}: acc={res.get('accuracy')} auroc={res.get('failure_auroc')}", flush=True)
        results.append(res)
    return results


def main(argv=None, dataset=None) -> list[dict]:
    """Train every seed; returns each run's metadata. ``dataset`` stands in
    for ``load_cifar10()``."""
    return train_members(argv, RECIPE, "student_m", __doc__, dataset)


if __name__ == "__main__":
    main()
