"""Multi-device and multi-host training over ``torch.distributed``: process
meshes, the env-axis cut, tensor parallelism and the local launcher."""

from warpdrive_tpu_torch.parallel.mesh import (
    ENV_AXIS,
    MODEL_AXIS,
    Mesh,
    apply_env_sharding,
    initialize_multihost,
    make_mesh,
    make_mesh_2d,
    shard_carry,
    shard_params_tp,
    shard_state,
    to_host,
)
