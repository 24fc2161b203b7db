"""Flight recorder and telemetry for the fleet simulator (counterpart of
``repro.obs``).

* :mod:`.probes` — the probe ring buffers of ``FleetSim(probes=...)``
  (taken after the final fixed-point iteration) and their unwrapping
  into a :class:`ProbeRecord`;
* :mod:`.recorder` — the request flight recorder and control-plane
  events (:func:`build_flight_log`), and :func:`summarize_timeseries`
  rows for :func:`repro_torch.traffic.metrics.format_table`;
* :mod:`.export` / :mod:`.schema` — the Chrome trace-event / Perfetto
  JSON exporter and its validator;
* :mod:`.spans` — not of the simulator: spans and counters of the model
  path (prefill, decode and train steps and the layers under them),
  recorded on the profiler's clock while a ``torch.profiler`` records.

Typical use::

    sim = FleetSim(..., probes=ProbeConfig())
    res = sim.run()
    log = build_flight_log(sim, res, scenario="smoke")
    write_trace("out.json", log)          # open in ui.perfetto.dev
"""
from . import spans
from .export import chrome_trace, write_trace
from .probes import DecisionTrace, ProbeConfig, ProbeRecord, ring_bins
from .recorder import (ControlEvent, FlightLog, RequestRecord, aimd_events,
                       build_flight_log, eq43_breakdown,
                       joint_decision_events, replan_events,
                       summarize_timeseries)
from .schema import SCHEMA_VERSION, count_events, validate_trace

__all__ = [
    "DecisionTrace", "ProbeConfig", "ProbeRecord", "ring_bins",
    "ControlEvent", "FlightLog", "RequestRecord",
    "aimd_events", "build_flight_log", "eq43_breakdown",
    "joint_decision_events", "replan_events", "summarize_timeseries",
    "chrome_trace", "write_trace",
    "SCHEMA_VERSION", "count_events", "validate_trace",
]
