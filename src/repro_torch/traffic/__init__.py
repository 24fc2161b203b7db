"""Request-level traffic and queueing: the fleet simulator.

Counterpart of ``repro.traffic`` for the fleet fast path: request traces
(:mod:`.requests`), the ground segment (:mod:`.ground`), the
per-satellite fleet queue and its fused fixed point (:mod:`.queueing`),
continuous decode batching for it (:mod:`.batching`), latency-target
admission control with gateway retry (:mod:`.admission`), serving
metrics (:mod:`.metrics`) and continuous re-placement with the joint
control plane (:mod:`.replan`).  Not ported yet: scenarios and
federation.

Shape conventions: ``P`` plan/schedule rows, ``R`` requests, ``N``
decode tokens, ``M = R + N`` engine tokens, ``L`` layers, ``I`` experts
per layer, ``K`` top-k, ``S = V`` queue stations (one per satellite),
``G`` ground gateways, ``T`` time bins, ``A`` ingress attempts (1 +
retries), ``F`` sweep entries of one fused launch.
"""
from .admission import (AdmissionConfig, admission_queue_scan,
                        control_bin_flags, resolve_admission)
from .batching import (BatchingConfig, batched_effective_work,
                       effective_work_np, windowed_counts)
from .ground import (DEFAULT_STATIONS, GroundSegment, GroundStation,
                     build_ground_segment, ground_delay_table,
                     rank_constellations)
from .metrics import (SLO, PlanTraffic, SaturationResult, TrafficResult,
                      format_table, saturation_sweep)
from .queueing import (FleetSim, QueueConfig, simulate_traffic,
                       station_waiting_times)
from .replan import (ReplanConfig, ReplanDecision, ReplanOutcome,
                     ReplanReport, backlog_penalty_s, build_replan_schedule,
                     replan_base_scores, replan_traffic,
                     replan_traffic_fused)
from .requests import (RequestBatch, diurnal_rate, hotspot_rate,
                       poisson_arrivals, sample_decode_lens,
                       sample_prompt_lens, sample_requests, stream_arrivals,
                       stream_requests, thinned_arrivals)

__all__ = [
    "AdmissionConfig", "admission_queue_scan", "control_bin_flags",
    "resolve_admission",
    "BatchingConfig", "batched_effective_work", "effective_work_np",
    "windowed_counts",
    "DEFAULT_STATIONS", "GroundSegment", "GroundStation",
    "build_ground_segment", "ground_delay_table", "rank_constellations",
    "SLO", "PlanTraffic", "SaturationResult", "TrafficResult",
    "format_table", "saturation_sweep",
    "FleetSim", "QueueConfig", "simulate_traffic", "station_waiting_times",
    "ReplanConfig", "ReplanDecision", "ReplanOutcome", "ReplanReport",
    "backlog_penalty_s", "build_replan_schedule", "replan_base_scores",
    "replan_traffic", "replan_traffic_fused",
    "RequestBatch", "diurnal_rate", "hotspot_rate", "poisson_arrivals",
    "sample_decode_lens", "sample_prompt_lens", "sample_requests",
    "stream_arrivals", "stream_requests", "thinned_arrivals",
]
