"""Several GPUs (counterpart of ``mellon_tpu/parallel``): the (chains,
cells) mesh over ``torch.distributed``, the cell-sharded density potential
and predictor, and sampler checkpoints.  The samplers take the shardings:
``run_mcmc(chain_sharding=)``, ``resume_mcmc(chain_sharding=)`` and
``run_smc(mesh=, particle_sharding=)``."""

from .checkpoint import FORMAT_VERSION, load_sampler_state, save_sampler_state
from .mesh import (
    CELL_AXIS,
    CHAIN_AXIS,
    Mesh,
    Sharding,
    cell_sharding,
    chain_sharding,
    create_mesh,
    distributed_initialize,
    replicated,
)
from .sharding import (
    replicate,
    shard_chains,
    shard_density_model,
    shard_predict,
    sharded_loss_from_estimator,
)

__all__ = [
    "CELL_AXIS",
    "CHAIN_AXIS",
    "FORMAT_VERSION",
    "Mesh",
    "Sharding",
    "cell_sharding",
    "chain_sharding",
    "create_mesh",
    "distributed_initialize",
    "load_sampler_state",
    "replicate",
    "replicated",
    "save_sampler_state",
    "shard_chains",
    "shard_density_model",
    "shard_predict",
    "sharded_loss_from_estimator",
]
