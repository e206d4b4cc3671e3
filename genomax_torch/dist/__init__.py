"""Multi-device scoring of the port: the mesh (``mesh``), tile-sharded
buckets (``sharded``), ``ShardedEngine`` (``engine``) and the cross-device
SW wavefront (``xsharded``). The exports are those of ``genomax.dist``."""

from genomax_torch.dist.mesh import initialize_distributed, make_mesh  # noqa: F401
from genomax_torch.dist.sharded import (  # noqa: F401
    pairhmm_forward_sharded,
    sw_forward_sharded,
)
