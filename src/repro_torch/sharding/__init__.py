"""Sharding: the rule engine (``specs``), meshes of ``torch.distributed``
ranks (``mesh``), and shards with autograd-correct collectives
(``shard``). The port of the JAX package's ``sharding/`` and
``launch/mesh.py``."""
from repro_torch.sharding.specs import (P, batch_shardings, batch_spec,
                                        cache_shardings, param_shardings,
                                        spec_for, state_shardings)

__all__ = ["P", "param_shardings", "batch_spec", "batch_shardings",
           "spec_for", "cache_shardings", "state_shardings"]
