"""The parallel paths of the port: the device mesh over a torch.distributed
world (``mesh``, ``dist``), the evaluation grid on one device or sharded
(``sweep``) and the multi-device dry run (``dryrun``); the counterpart of
``fav_tpu/parallel``."""

from fav_tpu_torch.parallel.mesh import (  # noqa: F401
    build_mesh,
    data_sharding,
    ensemble_sharding,
    replicate,
)
from fav_tpu_torch.parallel.sweep import corruption_sweep, sharded_sweep  # noqa: F401
