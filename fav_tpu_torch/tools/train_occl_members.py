"""Train the bagged-champion ensemble members: extra seeds of the
rectangular-occlusion AugMix recipe (``classifier_occl`` is seed 0).

Counterpart of the repository's ``tools/train_occl_members.py``: one
``fav_tpu_torch.models.pretrain`` run per seed, ``--occlude --steps N
--megastep K --seed S --out OUTDIR/occl_mS``, in one process. The members
never share a consistency term; their diversity comes from the
initialisation seed and an independent shuffle stream per seed. Stack the
prefixes it writes with ``fav_tpu_torch.tools.stack_ensemble`` into a
homogeneous-recipe bagged ensemble.

    python -m fav_tpu_torch.tools.train_occl_members [--steps 3000] [--megastep 50]
        [--seeds 1,2,3,4] [--outdir build/torch_checkpoints/members] [--device cpu]
"""

from __future__ import annotations

from fav_tpu_torch.tools.train_student_members import train_members

__all__ = ["RECIPE", "main"]

RECIPE = ("--occlude",)


def main(argv=None, dataset=None) -> list[dict]:
    """Train every seed; returns each run's metadata. ``dataset`` stands in
    for ``load_cifar10()``."""
    return train_members(argv, RECIPE, "occl_m", __doc__, dataset)


if __name__ == "__main__":
    main()
