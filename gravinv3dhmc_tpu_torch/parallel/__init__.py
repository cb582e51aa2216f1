"""Multi-device distribution on ``torch.distributed``: sharded kernel
matvec + chain parallelism (counterpart of ``gravinv3dhmc_tpu/parallel``)."""
from . import multihost
from .sharded import (carry_shardings, gather, make_mesh,
                      make_sharded_chunk_sampler, make_sharded_potential,
                      shard, welford_metric_switch)

__all__ = ["make_mesh", "make_sharded_potential",
           "make_sharded_chunk_sampler", "carry_shardings",
           "welford_metric_switch", "multihost", "shard", "gather"]
