"""Multi-device execution on torch.distributed (port of
fastlivo_tpu/parallel): the axis object and its collectives, meshes, the
sharded step builders and process-group initialization."""

from fastlivo_tpu_torch.parallel.axis import Axis  # noqa: F401
from fastlivo_tpu_torch.parallel.distributed import (  # noqa: F401
    host_local_slice,
    initialize_distributed,
    make_global_mesh,
)
from fastlivo_tpu_torch.parallel.sharded import (  # noqa: F401
    HOSTS_AXIS,
    POINTS_AXIS,
    Mesh,
    make_mesh,
    make_mesh_2d,
    make_sharded_bootstrap,
    make_sharded_lio_step,
    make_sharded_map,
    make_sharded_reanchor,
    shard_scan,
)
