"""Schema of the exported Chrome/Perfetto trace JSON and its validator.

Counterpart of ``repro.obs.schema`` (the reference's code).  The
exporter (:mod:`.export`) writes the Trace Event Format's JSON-object
flavor: a ``traceEvents`` list plus a ``metadata`` object stamped with
:data:`SCHEMA_VERSION` and run provenance.  Perfetto and
``chrome://tracing`` both load it directly; :func:`validate_trace` is
the structural check, so a drifting exporter cannot ship traces that do
not load.

Event phases used (and accepted) here:

===== ================================================================
``X`` complete span (request prefill/decode, per-layer hops) — needs
      a non-negative ``dur``
``C`` counter sample (per-satellite backlog/util/drops lanes) — needs
      numeric ``args``
``i`` instant (AIMD window change, replan switch, shed burst)
``M`` metadata (process/thread naming of the lanes)
===== ================================================================
"""
from __future__ import annotations

import numbers

#: Version stamped into ``metadata.schema_version`` by the exporter and
#: required (exactly) by the validator — bump on breaking layout changes.
SCHEMA_VERSION = 1

#: Accepted trace-event phases.
PHASES = ("X", "C", "i", "M")

#: Fields every event must carry.
REQUIRED_FIELDS = ("name", "ph", "pid", "ts")

#: ``metadata`` keys the exporter always writes.
REQUIRED_METADATA = ("schema_version", "generator", "dt_s", "plans")


def _problem(out: list[str], i: int, msg: str) -> None:
    out.append(f"traceEvents[{i}]: {msg}")


def validate_trace(obj) -> list[str]:
    """Structural check of one exported trace object.

    Args:
        obj: The parsed trace JSON (dict).

    Returns:
        A list of human-readable problems; empty means the trace
        conforms to this schema version.
    """
    problems: list[str] = []
    if not isinstance(obj, dict):
        return ["trace must be a JSON object (the Trace Event Format's "
                "object flavor)"]
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        problems.append("missing or non-list 'traceEvents'")
        events = []
    meta = obj.get("metadata")
    if not isinstance(meta, dict):
        problems.append("missing or non-object 'metadata'")
    else:
        for key in REQUIRED_METADATA:
            if key not in meta:
                problems.append(f"metadata missing {key!r}")
        ver = meta.get("schema_version")
        if ver is not None and ver != SCHEMA_VERSION:
            problems.append(f"metadata.schema_version {ver!r} != "
                            f"supported {SCHEMA_VERSION}")

    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            _problem(problems, i, "event is not an object")
            continue
        for field in REQUIRED_FIELDS:
            if field not in ev:
                _problem(problems, i, f"missing {field!r}")
        ph = ev.get("ph")
        if ph not in PHASES:
            _problem(problems, i, f"unknown phase {ph!r} (one of {PHASES})")
            continue
        ts = ev.get("ts")
        if not isinstance(ts, numbers.Real) or isinstance(ts, bool) \
                or ts < 0:
            _problem(problems, i, f"ts must be a number >= 0, got {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, numbers.Real) or isinstance(dur, bool) \
                    or dur < 0:
                _problem(problems, i,
                         f"'X' event needs numeric dur >= 0, got {dur!r}")
        if ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args:
                _problem(problems, i, "'C' event needs non-empty args")
            else:
                for k, v in args.items():
                    if not isinstance(v, numbers.Real) \
                            or isinstance(v, bool):
                        _problem(problems, i,
                                 f"counter arg {k!r} is not numeric")
        if ph == "i" and ev.get("s", "t") not in ("g", "p", "t"):
            _problem(problems, i, f"instant scope {ev.get('s')!r} not in "
                                  "('g', 'p', 't')")
    return problems


def count_events(obj, name_prefix: str = "", ph: str | None = None) -> int:
    """Number of events whose name starts with ``name_prefix`` (and
    matches ``ph`` when given) — the acceptance checks' counting helper."""
    n = 0
    for ev in obj.get("traceEvents", []):
        if not isinstance(ev, dict):
            continue
        if ph is not None and ev.get("ph") != ph:
            continue
        if str(ev.get("name", "")).startswith(name_prefix):
            n += 1
    return n
