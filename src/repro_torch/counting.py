"""The hooks through which the port's code reports to a dry-run count.

``launch.op_analysis.analyze`` puts a count in force while it runs a
step.  The hand-written kernels report each call (``kernel``), the
collectives each record (``note_collective``), and the loops over time
and over attention chunks iterate ``steps(n)`` so that a multiplying
count can run one iteration of each kind (``pad`` fills in the skipped
iterations' outputs).  With no count in force every hook does nothing:
``kernel`` and ``paused`` are empty blocks, ``steps(n)`` is
``range(n)`` and ``pad`` returns its list as it is.

The count itself (``op_analysis._Count``) lives with ``analyze``; this
module imports nothing of the port, so that the kernels, the collectives
and the models can report to it without depending on the launchers.
"""
from __future__ import annotations

import contextlib

_ACTIVE: list = []          # the counts in force, innermost last


def current():
    """The innermost count in force, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def active() -> bool:
    """Whether a count is in force (``analyze`` is running)."""
    return bool(_ACTIVE)


@contextlib.contextmanager
def in_force(count):
    """``count`` in force for the block."""
    _ACTIVE.append(count)
    try:
        yield count
    finally:
        _ACTIVE.remove(count)


@contextlib.contextmanager
def kernel(name: str, flops: int, nbytes: int):
    """A hand-written kernel's call: counted once as ``name`` with its
    flops and bytes, and the ops inside the block not counted."""
    count = current()
    if count is None or count.paused:
        yield
        return
    count.add_kernel(name, flops, nbytes)
    count.paused += 1
    try:
        yield
    finally:
        count.paused -= 1


def note_collective(record: dict) -> None:
    """Take one collective record (op, result bytes, group size)."""
    count = current()
    if count is not None and not count.paused:
        count.records.append(dict(record, count=count.weight()))


@contextlib.contextmanager
def paused():
    """Ops in the block are not counted."""
    count = current()
    if count is not None:
        count.paused += 1
    try:
        yield
    finally:
        if count is not None:
            count.paused -= 1


def steps(n: int):
    """The iterations of a loop of ``n``: ``range(n)``, or under a
    multiplying count (n > 3) iterations 0, 1 and n - 1, the middle one
    counted n - 2 times."""
    count = current()
    if count is None or not count.multiply or n <= 3:
        yield from range(n)
        return
    for i, weight in ((0, 1), (1, n - 2), (n - 1, 1)):
        with count.scope(weight):
            yield i


def pad(items: list, n: int) -> list:
    """``items`` up to ``n`` entries with detached copies of its last (the
    outputs of the iterations ``steps`` skipped), uncounted."""
    if len(items) < n:
        with paused():
            items += [items[-1].detach()] * (n - len(items))
    return items


__all__ = ["current", "active", "in_force", "kernel", "note_collective",
           "paused", "steps", "pad"]
