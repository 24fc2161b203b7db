"""Request-level traffic and queueing: the fleet simulator.

Counterpart of ``repro.traffic`` for the fleet fast path: request traces
(:mod:`.requests`), the per-satellite fleet queue and its fused fixed
point (:mod:`.queueing`) and serving metrics (:mod:`.metrics`).  Ground
segment, admission, batching, re-placement, scenarios and federation are
later slices of the port.

Shape conventions: ``P`` plan/schedule rows, ``R`` requests, ``N``
decode tokens, ``M = R + N`` engine tokens, ``L`` layers, ``I`` experts
per layer, ``K`` top-k, ``S = V`` queue stations (one per satellite),
``T`` time bins, ``F`` sweep entries of one fused launch.
"""
from .metrics import (SLO, PlanTraffic, SaturationResult, TrafficResult,
                      format_table, saturation_sweep)
from .queueing import (FleetSim, QueueConfig, simulate_traffic,
                       station_waiting_times)
from .requests import (RequestBatch, diurnal_rate, hotspot_rate,
                       poisson_arrivals, sample_decode_lens,
                       sample_prompt_lens, sample_requests, stream_arrivals,
                       stream_requests, thinned_arrivals)

__all__ = [
    "SLO", "PlanTraffic", "SaturationResult", "TrafficResult",
    "format_table", "saturation_sweep",
    "FleetSim", "QueueConfig", "simulate_traffic", "station_waiting_times",
    "RequestBatch", "diurnal_rate", "hotspot_rate", "poisson_arrivals",
    "sample_decode_lens", "sample_prompt_lens", "sample_requests",
    "stream_arrivals", "stream_requests", "thinned_arrivals",
]
