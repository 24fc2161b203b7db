"""Fault tolerance and sharding (counterpart of ``repro.distributed``):
elastic re-placement on device failure, straggler mitigation, the weight
migration between two placements, and ``ShardingRules``' partition specs
(with the collectives of the sharded paths in ``collectives``)."""
from .elastic import (Migration, migration, replan_on_failure,
                      replan_with_stragglers)
from .sharding import ShardingRules

__all__ = ["Migration", "migration", "replan_on_failure",
           "replan_with_stragglers", "ShardingRules"]
