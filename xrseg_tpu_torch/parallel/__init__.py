"""The port's multi-device paths (counterpart of xrseg_tpu/parallel): the
mesh and its sharding rules, data- and tensor-parallel serving, the
multi-stream runner, pipeline and spatial parallelism, and multi-process
execution."""
from xrseg_tpu_torch.parallel import batch, mesh  # noqa: F401
from xrseg_tpu_torch.parallel.mesh import (make_mesh,  # noqa: F401
                                           shard_batch, shard_params)
