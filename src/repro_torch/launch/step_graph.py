"""The serve step replayed as one CUDA graph.

A decode step is thousands of small kernels, each launched from Python;
at the batch sizes served here the host's launching, not the card,
paces the step.  ``StepGraphs`` captures a whole serve step (the model's
decode step, the logits' gather and the argmax) into one
``torch.cuda.CUDAGraph`` and replays it: the same kernels in the same
order, launched as one graph.

A step engages the graph only where the program can see that a replay
computes what the eager step would:

* every tensor of the step is a CUDA tensor, grad mode is off, nothing
  is capturing already, no op count is in force (``counting``: its
  dispatch mode must see every op), and the step runs without a mesh
  (collectives are not captured);
* the key matches: the (data pointer, shape, stride, dtype, device) of
  every leaf of ``params`` and ``cache``, the inputs' shapes, dtypes and
  devices, and the model's config.  The inputs are copied into the
  graph's own buffers before each replay; every other tensor the graph
  reads is then exactly the caller's;
* an eager step of the same shapes has run in this process (it does the
  lazy set-up a capture must not: kernel loads, cuBLAS handles,
  ``decode_attention``'s merge counters) and left every cache leaf the
  tensor it was (a KV cache written in place; a recurrent state that the
  step replaces runs eager).  The same holds again after the capture.

A key seen for the first time is captured on its first call once its
shapes are warm, else run eager.  One graph is held: a new key's graph
replaces the old one, whose graph and memory pool are released first.
The outputs are copies of the graph's own (a caller keeps each step's
token), and the cache is the caller's dict.

Kept true across replays: the kernels' launch counters
(``kernels.ops.launch_counts``: each replay adds what the capture
counted, and the capture itself counts nothing) and the counters of
``obs.spans``: the MoE's ``moe.copies_routed`` / ``moe.copies_dropped``
(the capture counts nothing; while a profiler records, each replay
counts a copy of the captured plans' kept masks), and one of
``serve.graph_replays`` or ``serve.graph_eager`` a step, plus
``serve.graph_captures``.  A replay runs in a ``serve.graph`` span
(``mode="replay"``), a capture in one with ``mode="capture"``.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import counting
from ..kernels import decode_attn, ops
from ..models import moe
from ..obs import spans
from ..tree import tree_leaves


def describe(tree) -> tuple[tuple, tuple, bool]:
    """(shapes, data pointers, all on CUDA) of ``tree``'s leaves: each
    tensor's (shape, stride, dtype, device) and its ``data_ptr``; any
    other leaf as itself, with no pointer."""
    shapes, ptrs, cuda = [], [], True
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            shapes.append((tuple(t.shape), t.stride(), t.dtype, t.device))
            ptrs.append(t.data_ptr())
            cuda = cuda and t.is_cuda
        else:
            shapes.append(t)
            ptrs.append(None)
    return tuple(shapes), tuple(ptrs), cuda


def step_key(cfg, params, cache, inputs) -> tuple[tuple, tuple, bool]:
    """(shapes, key, all on CUDA) of one serve step's call: ``shapes`` is
    the key without the data pointers, and ``key`` decides a replay."""
    p_shapes, p_ptrs, p_cuda = describe(params)
    c_shapes, c_ptrs, c_cuda = describe(cache)
    ins = tuple(None if x is None else (tuple(x.shape), x.dtype, x.device)
                for x in inputs)
    shapes = (cfg, p_shapes, c_shapes, ins)
    cuda = p_cuda and c_cuda and all(x is None or x.is_cuda for x in inputs)
    return shapes, (shapes, p_ptrs, c_ptrs), cuda


def _containers(tree):
    """The same leaves in new dicts and lists: a step that puts new
    leaves in the copy leaves ``tree`` as it was."""
    if isinstance(tree, dict):
        return {k: _containers(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_containers(v) for v in tree]
    return tree


def _same_leaves(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(x is y for x, y in zip(la, lb))


@dataclasses.dataclass
class _Graph:
    """One captured step: its key, the graph, its input buffers and
    outputs, the kept masks of its MoE plans, the launches it makes, and
    the module-level tensors it reads (held for its life)."""
    key: tuple
    graph: torch.cuda.CUDAGraph
    inputs: tuple
    tok: torch.Tensor
    logits: torch.Tensor
    masks: list
    launches: dict
    held: list


class StepGraphs:
    """The serve step's graph and what it knows of the shapes it has
    run (module docstring).  ``launch.steps`` holds one for the process:
    the harness and ``launch/serve.py`` make a serve step per batch, and
    the graph follows the tensors a step is given, not the closure."""

    def __init__(self):
        # shapes -> whether their eager step kept every cache leaf
        self.warm: dict[tuple, bool] = {}
        self.graph: _Graph | None = None
        self._streams: dict[int, torch.cuda.Stream] = {}

    def __call__(self, step, cfg, par, params, cache, inputs):
        """``step(params, cache, *inputs)`` -> (next token, logits,
        cache), replayed from a graph where that engages, else run."""
        shapes = key = None
        if par.mesh is None and not torch.is_grad_enabled() \
                and not counting.active():
            shapes, key, cuda = step_key(cfg, params, cache, inputs)
            if not cuda or torch.cuda.is_current_stream_capturing():
                shapes = None
        if shapes is not None:
            g = self.graph
            if g is None or g.key != key:
                g = self._capture(step, key, params, cache, inputs) \
                    if self.warm.get(shapes) else None
            if g is not None:
                return self._replay(g, cache, inputs)
        before = tree_leaves(cache)
        out = step(params, cache, *inputs)
        if shapes is not None:
            self.warm.setdefault(shapes, _same_leaves(before, cache))
        spans.count("serve.graph_eager", 1)
        return out

    def _stream(self, device: torch.device) -> torch.cuda.Stream:
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        if index not in self._streams:
            self._streams[index] = torch.cuda.Stream(device=index)
        return self._streams[index]

    def _capture(self, step, key, params, cache, inputs) -> _Graph | None:
        """Capture the step under ``key`` (the old graph released first);
        None where the capture put new leaves in the cache."""
        self.graph = None
        bufs = tuple(None if x is None else x.clone() for x in inputs)
        device = next(x.device for x in inputs if x is not None)
        view = _containers(cache)
        graph = torch.cuda.CUDAGraph()
        before = ops.launch_snapshot()
        masks = moe.captured_masks = []
        stream = self._stream(device)
        torch.cuda.synchronize(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        try:
            with spans.span("serve.graph", mode="capture"), \
                    torch.cuda.stream(stream):
                graph.capture_begin()
                try:
                    tok, logits, _ = step(params, view, *bufs)
                finally:
                    graph.capture_end()
        finally:
            moe.captured_masks = None
            after = ops.launch_snapshot()
            launches = {k: n - before[k] for k, n in after.items()}
            ops.add_launches({k: -n for k, n in launches.items()})
        torch.cuda.current_stream(device).wait_stream(stream)
        spans.count("serve.graph_captures", 1)
        if not _same_leaves(view, cache):
            self.warm[key[0]] = False
            return None
        self.graph = _Graph(key, graph, bufs, tok, logits, masks, launches,
                            list(decode_attn._COUNTERS.values()))
        return self.graph

    @staticmethod
    def _replay(g: _Graph, cache, inputs):
        for buf, x in zip(g.inputs, inputs):
            if buf is not None:
                buf.copy_(x)
        with spans.span("serve.graph", mode="replay"):
            g.graph.replay()
        ops.add_launches(g.launches)
        if spans.recording():
            for kept in g.masks:
                moe._count_copies(kept.clone())
        spans.count("serve.graph_replays", 1)
        return g.tok.clone(), g.logits.clone(), cache


__all__ = ["StepGraphs", "describe", "step_key"]
