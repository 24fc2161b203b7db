"""Fault tolerance (counterpart of ``repro.distributed``): elastic
re-placement on device failure, straggler mitigation and the weight
migration between two placements.  The reference's ``ShardingRules`` is
jax-mesh code and has no counterpart here."""
from .elastic import (Migration, migration, replan_on_failure,
                      replan_with_stragglers)

__all__ = ["Migration", "migration", "replan_on_failure",
           "replan_with_stragglers"]
