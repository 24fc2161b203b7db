"""Chrome trace-event / Perfetto JSON exporter for a :class:`FlightLog`
(counterpart of ``repro.obs.export``; the reference's code).

Produces the Trace Event Format's JSON-object flavor (loadable by
Perfetto's trace viewer and ``chrome://tracing``):

* **request lanes** (pid 1) — one thread per exported request, with
  contiguous ``prefill`` and ``decode`` complete spans; shed/failed
  requests appear as instants at their arrival;
* **satellite lanes** (pid 2) — per-satellite counter tracks sampled
  from the probe ring (backlog seconds, offered utilization, dropped
  seconds), busiest satellites first;
* **control lane** (pid 3) — instants for every control-plane event
  (AIMD admit steps with their qhat, replan decisions with the
  migration byte flow of a switch).

Timestamps are microseconds of simulated wall-clock time.  The
``metadata`` object carries :data:`.schema.SCHEMA_VERSION` plus run
provenance; :func:`.schema.validate_trace` checks both halves.
"""
from __future__ import annotations

import json
import math

import numpy as np

from .recorder import FlightLog
from .schema import SCHEMA_VERSION

#: Process-lane ids of the exported trace.
PID_REQUESTS, PID_FLEET, PID_CONTROL = 1, 2, 3


def _us(t_s: float) -> float:
    """Seconds -> trace microseconds (clamped non-negative)."""
    return max(round(float(t_s) * 1e6, 3), 0.0)


def _meta(pid: int, name: str, tid: int | None = None,
          thread: str | None = None) -> dict:
    """A process/thread-naming metadata event."""
    ev = {"name": "process_name" if tid is None else "thread_name",
          "ph": "M", "pid": pid, "ts": 0,
          "args": {"name": name if tid is None else thread}}
    if tid is not None:
        ev["tid"] = tid
    return ev


def _finite(x: float) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def _request_events(log: FlightLog, max_requests: int) -> list[dict]:
    events: list[dict] = []
    served = [r for r in log.requests if r.served][:max_requests]
    unserved = [r for r in log.requests
                if r.active and not r.served][:max_requests]
    for r in served:
        tid = r.rid + 1
        events.append(_meta(PID_REQUESTS, "", tid=tid,
                            thread=f"req {r.rid} (gw {r.station})"))
        args = {
            "station": r.station, "retries": r.retries,
            "prompt_len": r.prompt_len, "decode_len": r.decode_len,
            "ingress_s": round(r.ingress_s, 6),
            "queue_wait_s": round(r.queue_wait_s, 6),
            "zero_load_s": round(float(r.layer_zero_s.sum()), 6),
        }
        if r.layer_gw_wait_s is not None and r.layer_zero_s.size <= 64:
            # Per-layer Eq. 43 breakdown: zero-load hop+service cost and
            # the final iteration's queue waits, layer by layer.
            args["layer_zero_ms"] = [
                round(float(v) * 1e3, 3) for v in r.layer_zero_s]
            args["layer_gw_wait_ms"] = [
                round(float(v) * 1e3, 3) for v in r.layer_gw_wait_s]
            args["layer_ex_wait_ms"] = [
                round(float(v) * 1e3, 3) for v in r.layer_ex_wait_s]
        if _finite(r.ttft_s):
            events.append({
                "name": "prefill", "cat": "request", "ph": "X",
                "pid": PID_REQUESTS, "tid": tid,
                "ts": _us(r.arrival_s), "dur": _us(r.ttft_s),
                "args": args})
        if _finite(r.ttft_s) and _finite(r.e2e_s):
            dec_args = {"decode_len": r.decode_len,
                        "tpot_s": round(r.tpot_s, 6)
                        if _finite(r.tpot_s) else -1.0}
            if _finite(r.batch_b):
                # Continuous-batching runs: the request's batch span —
                # mean B_eff over its decode window.
                dec_args["batch_b"] = round(r.batch_b, 3)
            events.append({
                "name": "decode", "cat": "request", "ph": "X",
                "pid": PID_REQUESTS, "tid": tid,
                "ts": _us(r.arrival_s + r.ttft_s),
                "dur": _us(max(r.e2e_s - r.ttft_s, 0.0)),
                "args": dec_args})
    for r in unserved:
        events.append({
            "name": "shed" if r.shed else "dropped", "cat": "request",
            "ph": "i", "s": "p", "pid": PID_REQUESTS, "tid": 0,
            "ts": _us(r.arrival_s),
            "args": {"rid": r.rid, "station": r.station,
                     "retries": r.retries}})
    return events


def _satellite_events(log: FlightLog, max_sats: int) -> list[dict]:
    probes = log.probes
    if probes is None or probes.n_recorded == 0:
        return []
    p = log.plan
    backlog = probes.backlog_s[:, 0, p]                    # (B, S)
    util = probes.util_s[:, 0, p] / probes.dt_s
    drops = probes.drops_s[:, 0, p]
    # Busiest satellites only: a constellation-wide counter dump would
    # dwarf the request lanes without adding signal.
    load = backlog.max(axis=0) + util.max(axis=0)
    order = np.argsort(-load)
    sats = [int(v) for v in order[:max_sats] if load[v] > 0.0] \
        or [int(order[0])]
    t_us = [_us(t) for t in probes.t_s]
    events: list[dict] = []
    for v in sats:
        for b, ts in enumerate(t_us):
            events.append({
                "name": f"sat{v}", "cat": "fleet", "ph": "C",
                "pid": PID_FLEET, "tid": 0, "ts": ts,
                "args": {"backlog_s": round(float(backlog[b, v]), 5),
                         "util": round(float(util[b, v]), 5),
                         "dropped_s": round(float(drops[b, v]), 5)}})
    return events


def _control_events(log: FlightLog) -> list[dict]:
    events: list[dict] = []
    tids = {"aimd": 1, "replan": 2, "joint": 3}
    for ev in log.events:
        events.append({
            "name": ev.name, "cat": ev.kind, "ph": "i", "s": "g",
            "pid": PID_CONTROL, "tid": tids.get(ev.kind, 9),
            "ts": _us(ev.t_s),
            "args": {"plan": ev.plan, **ev.args}})
    return events


def chrome_trace(log: FlightLog, max_requests: int = 200,
                 max_sats: int = 16) -> dict:
    """Render a :class:`~repro_torch.obs.recorder.FlightLog` as a Chrome
    trace-event object.

    Args:
        log: The flight log to export.
        max_requests: Cap on exported request lanes (served and
            unserved counted separately; arrival order).
        max_sats: Cap on exported satellite counter lanes (busiest
            first).

    Returns:
        The trace dict (``json.dump``-ready; validates against
        :mod:`repro_torch.obs.schema`).
    """
    plan_name = log.plan_names[log.plan]
    events = [
        _meta(PID_REQUESTS, f"requests · {plan_name}"),
        _meta(PID_FLEET, f"fleet · {plan_name}"),
        _meta(PID_CONTROL, "control plane"),
        _meta(PID_CONTROL, "", tid=1, thread="admission (AIMD)"),
        _meta(PID_CONTROL, "", tid=2, thread="replan"),
        _meta(PID_CONTROL, "", tid=3, thread="joint control"),
    ]
    events += _request_events(log, max_requests)
    events += _satellite_events(log, max_sats)
    events += _control_events(log)
    n_served = sum(1 for r in log.requests if r.served)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {
            "schema_version": SCHEMA_VERSION,
            "generator": "repro_torch.obs",
            "scenario": log.scenario,
            "dt_s": float(log.dt_s),
            "horizon_s": float(log.horizon_s),
            "plans": list(log.plan_names),
            "plan": plan_name,
            "n_requests": len(log.requests),
            "n_served": int(n_served),
            "n_control_events": len(log.events),
            "probed": log.probes is not None,
            "summary": log.summary or {},
        },
    }


def write_trace(path: str, log: FlightLog, **kwargs) -> dict:
    """Export ``log`` to ``path`` as trace JSON; returns the trace dict."""
    trace = chrome_trace(log, **kwargs)
    with open(path, "w") as f:
        json.dump(trace, f)
    return trace
