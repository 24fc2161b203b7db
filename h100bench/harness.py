"""One run of one benchmark cell: set-up, the measured window, the check
that decides ``correct``, and the result line.

A cell ``<config>.<mix>`` is found by name: ``BENCHMARK.json`` names its
configuration file (``configs/<config>.json``: the model's published
sizes and the port's arch id) and its traffic mix
(``traffic/<mix>.json``: the kind of job and its sizes); ``limits/<cell>.json``
holds the limits of the numbers its check compares, with the readings
they were set from; each per-layer metric is read by
``metrics/<metric>.py`` (or ``metrics/<metric's first part>.py``).

Kinds of job, each a closed loop of whole units:

* ``prefill``: a unit is one ``models.prefill`` of a batch of prompts;
  each request is served its first token (the argmax, as
  ``launch/serve.py`` takes it).
* ``generate``: a unit is that prefill and then ``gen_tokens - 1`` greedy
  steps of ``launch.steps.make_serve_step``'s ``serve_step``.
* ``train``: a unit is one ``launch.steps.make_train_step`` step (AdamW,
  cosine schedule) on f32 master weights.

Serving units follow ``launch/serve.py``'s set-up: the weights, a
calibration forward (``calibrate_router_stats``) and the Theorem-1
placement (``plan_and_apply_placement``), TF32 off.  The window opens
after one warm unit (serving) or the three checked steps (training) and
closes at the end of the first unit to finish after ``seconds``; rates
divide all the window's work by its whole length.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path

import torch

from . import inputs, reference, yardstick
from .yardstick import Sizes

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GIB = 2**30
FAULTS = ("stale_state", "half_batch", "altered_token")


class NoChip(RuntimeError):
    pass


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """A progress line on standard error, with the seconds since import."""
    print(f"[h100bench {time.perf_counter() - _T0:8.2f}s] {msg}",
          file=sys.stderr, flush=True)


# --------------------------------------------------------------------- #
# Finding a cell
# --------------------------------------------------------------------- #


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict           # the configuration file
    traffic: dict          # the traffic file
    limits: dict           # number -> limit
    end_to_end: list       # BENCHMARK.json's metrics this cell reports
    per_layer: list

    @property
    def sizes(self) -> Sizes:
        return yardstick.sizes_of(self.config["model"])


def _reports(metric: dict, cell: str, e2e_names=None) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    list, else every cell (an end-to-end metric) or every cell that
    reports the end-to-end metric it ``moves``."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def find_cell(name: str, root: Path = ROOT) -> Cell:
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no cell {name!r}; cells: {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    here = root / "h100bench"
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((here / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((here / "limits" / f"{name}.json").read_text())
    # A mix may give a configuration its own batch, where memory forces it.
    traffic["batch"] = traffic.pop("batch_for", {}).get(w["config"],
                                                        traffic["batch"])
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, w["chips"], config, traffic,
                {k: v["limit"] for k, v in limits["numbers"].items()},
                e2e, per)


def reader(metric: str, root: Path = ROOT):
    """The ``read(run)`` function of ``metric``'s reader file."""
    for stem in (metric, metric.split(".")[0]):
        path = root / "h100bench" / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"h100bench_metric_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {metric!r}")


# --------------------------------------------------------------------- #
# The program's configuration
# --------------------------------------------------------------------- #

SMOKE = dict(n_layers=2, d_model=64, n_heads=4, head_dim=16, vocab_size=500,
             padded_vocab=512, d_expert=32, first_dense_d_ff=64)


def smoke_sizes(s: Sizes) -> Sizes:
    """The same structure at a size the CPU runs in seconds."""
    kv = max(1, round(4 * s.n_kv_heads / s.n_heads))
    return dataclasses.replace(
        s, **{**SMOKE, "n_layers": 2 + (1 if s.first_dense_d_ff else 0),
              "first_dense_d_ff": SMOKE["first_dense_d_ff"] if s.first_dense_d_ff else 0},
        n_kv_heads=kv, n_experts=min(s.n_experts, 8), top_k=min(s.top_k, 4),
        n_shared=min(s.n_shared, 1))


def program_config(cell: Cell, sizes: Sizes):
    """The port's ``ModelConfig`` for the cell: its registered config,
    checked against the file's sizes (at smoke size, cut to them)."""
    from repro_torch.configs import get_config
    cfg = get_config(cell.config["arch"])
    want = dict(n_layers=sizes.n_layers, d_model=sizes.d_model,
                n_heads=sizes.n_heads, n_kv_heads=sizes.n_kv_heads,
                head_dim=sizes.head_dim, vocab_size=sizes.vocab_size,
                n_experts=sizes.n_experts, top_k=sizes.top_k,
                d_ff_expert=sizes.d_expert, n_shared_experts=sizes.n_shared,
                first_dense_d_ff=sizes.first_dense_d_ff,
                tie_embeddings=sizes.tie_embeddings,
                rope_theta=sizes.rope_theta, norm_eps=sizes.norm_eps,
                capacity_factor=sizes.capacity_factor)
    if sizes != cell.sizes:
        cfg = dataclasses.replace(
            cfg, **want, d_ff=sizes.d_expert,
            vocab_pad_multiple=sizes.padded_vocab,
            attn_q_chunk=16, attn_kv_chunk=16)
    got = {k: getattr(cfg, k) for k in want}
    got["first_dense_d_ff"] = cfg.first_dense_d_ff if cfg.first_layer_dense else 0
    if got != want or cfg.padded_vocab != sizes.padded_vocab \
            or cfg.compute_dtype != "bfloat16" or cfg.moe_slotting:
        raise ValueError(f"{cell.config['arch']}: the port's config "
                         f"{got} differs from the file's {want}")
    return cfg


# --------------------------------------------------------------------- #
# A run's records, read by the metric readers
# --------------------------------------------------------------------- #


@dataclasses.dataclass
class Run:
    cell: Cell
    sizes: Sizes
    traffic: dict
    device: torch.device
    trace: bool
    units: int = 0                       # whole units in the window
    window_s: float = 0.0
    decode_spans: list = dataclasses.field(default_factory=list)
    traced: dict | None = None           # the traced unit's device trace


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _mark(run: Run, label: str | None) -> None:
    """A marker kernel opening the traced unit's next segment (``label``;
    None closes the unit)."""
    tr = run.traced
    if tr is not None and "window" not in tr:
        torch.cuda._sleep(1)
        tr["labels"].append(label)


class _Tracer:
    """The CUDA profiler around one unit of the window: a primer of small
    launches first (the profiler may drop a window's first records), a
    marker kernel at every segment boundary, the device events after.
    A trace that lost a marker is dropped and the next unit traced, up to
    ``TRIES`` units."""

    PRIMER = 1000
    TRIES = 3

    def __init__(self, run: Run):
        self.run = run
        self.tries = 0

    def start(self) -> float:
        """Start; returns the seconds that took."""
        from torch.profiler import ProfilerActivity, profile
        t = time.perf_counter()
        self.tries += 1
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        primer = torch.zeros(1, device=self.run.device)
        for _ in range(self.PRIMER):
            primer.add_(1.0)
        torch.cuda.synchronize()
        self.run.traced = {"labels": []}
        return time.perf_counter() - t

    def stop(self) -> float:
        """Stop and collect; returns the seconds that took.  Leaves
        ``run.traced`` None where the trace lost a marker."""
        t = time.perf_counter()
        torch.cuda.synchronize()
        self.prof.stop()
        from torch.autograd import DeviceType
        events = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1e3
            dur = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1e3
            events.append((e.name(), start / 1e9, (start + dur) / 1e9))
        events.sort(key=lambda e: e[1])
        del self.prof
        labels = self.run.traced["labels"]
        marks = sum(1 for e in events if yardstick.MARKER_KERNEL in e[0])
        if marks != len(labels) or marks < 2:
            log(f"trace dropped: {marks} of {len(labels)} markers recorded")
            self.run.traced = None
            return time.perf_counter() - t
        window, starts, segs = yardstick.segments(events, len(labels))
        kernels = [e for seg in segs for e in seg]
        if not kernels:
            log("trace dropped: no kernel recorded between the markers")
            self.run.traced = None
            return time.perf_counter() - t
        self.run.traced.update(
            window=window, window_s=window[1] - window[0], starts=starts,
            busy_s=yardstick.union_seconds([(a, b) for _, a, b in kernels]),
            segments=list(zip(labels, segs)))
        return time.perf_counter() - t

    def after_unit(self):
        """Stop after a unit; the tracer for the next unit (this one again
        where the trace was dropped and tries are left) or None, and the
        seconds the profiler took, which the window leaves out."""
        spent = self.stop()
        if self.run.traced is None and self.tries < self.TRIES:
            return self, spent + self.start()
        return None, spent


def breakdown(traced: dict) -> dict:
    """The traced unit's ten costliest device ops and its idle time by
    what the host was doing (summed per segment kind, and the longest
    single gap of each)."""
    kernels = [e for _, seg in traced["segments"] for e in seg]
    ops = sorted(yardstick.time_by_name(kernels).items(),
                 key=lambda kv: -kv[1])[:10]
    lo, hi = traced["window"]
    bounds = [(label, start) for (label, _), start
              in zip(traced["segments"], traced["starts"])]
    sums: dict[str, float] = {}
    longest: dict[str, float] = {}
    for start, length in yardstick.idle_gaps(
            [(a, b) for _, a, b in kernels], lo, hi):
        label = bounds[0][0]
        for name, b0 in bounds:
            if start >= b0:
                label = name
        sums[label] = sums.get(label, 0.0) + length
        longest[label] = max(longest.get(label, 0.0), length)
    gaps = [[f"{k} (all gaps)", v] for k, v in sums.items()]
    gaps += [[f"{k} (longest gap)", v] for k, v in longest.items()]
    gaps.sort(key=lambda kv: -kv[1])
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": gaps[:10]}


# --------------------------------------------------------------------- #
# Serving: prefill and generate
# --------------------------------------------------------------------- #


def _serve_setup(run: Run, cfg, seed: int):
    from repro_torch.launch.serve import (calibrate_router_stats,
                                          plan_and_apply_placement)
    s, t, dev = run.sizes, run.traffic, run.device
    params = inputs.draw_weights(s, seed, dev)
    log("weights drawn")
    cb, cs = t["calibration"]
    calib = {"tokens": inputs.tokens(seed, inputs.CALIBRATION, 0, (cb, cs),
                                     s.vocab_size, dev)}
    counts = calibrate_router_stats(cfg, params, calib)
    log("calibration forward done")
    params, _, _ = plan_and_apply_placement(cfg, params, counts)
    log("placement applied")
    return params


def _serve_unit(run: Run, cfg, params, prompts, steps: int, faults):
    """One batch: prefill, then ``steps`` decode steps.  Returns the
    served tokens (B, 1 + steps) and the gap before each decode step's
    token on the host clock."""
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import Parallel, prefill
    par = Parallel(mesh=None)
    b, plen = prompts.shape
    half = "half_batch" in faults
    if half:
        prompts = prompts[:b // 2]
    rows = prompts.shape[0]
    max_len = plen + steps + 1
    dev = run.device
    _mark(run, "prefill")
    logits, cache = prefill(cfg, params, {"tokens": prompts}, max_len, par)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    out = [tok]
    _sync(dev)
    t1 = time.perf_counter()
    serve_step = make_serve_step(cfg, par)
    pos = torch.full((rows,), plen, dtype=torch.int32, device=dev)
    gaps = []
    for _ in range(steps):
        _mark(run, "decode")
        step_cache = cache
        if "stale_state" in faults:
            step_cache = [dict((k, v.clone()) for k, v in c.items())
                          for c in cache["layers"]]
            step_cache = {**cache, "layers": step_cache}
        tok, logits, _ = serve_step(params, step_cache, tok, pos)
        pos = pos + 1
        out.append(tok)
        _sync(dev)
        t2 = time.perf_counter()
        gaps.append(t2 - t1)
        t1 = t2
    _mark(run, None)
    served = torch.cat(out, dim=1)
    if half:
        served = torch.cat([served, served], dim=0)[:b]
    if "altered_token" in faults:
        served[0, -1] = (served[0, -1] + 1) % run.sizes.padded_vocab
    return served, gaps


def _serve(run: Run, cfg, seed: int, seconds: float, faults, t_start: float,
           control: bool):
    s, t, dev = run.sizes, run.traffic, run.device
    b, plen = t["batch"], t["prompt_len"]
    steps = t.get("gen_tokens", 1) - 1
    with torch.no_grad():
        params = _serve_setup(run, cfg, seed)
        warm = inputs.tokens(seed, inputs.CALIBRATION, 1, (b, plen),
                             s.vocab_size, dev)
        _serve_unit(run, cfg, params, warm, min(steps, 2), ())
        _sync(dev)
        log("warm unit done")
        tracer = _Tracer(run) if run.trace else None
        if tracer:
            tracer.start()
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        served, excluded = [], 0.0
        while True:
            prompts = inputs.tokens(seed, inputs.BATCHES, run.units, (b, plen),
                                    s.vocab_size, dev)
            out, gaps = _serve_unit(run, cfg, params, prompts, steps, faults)
            run.decode_spans.extend(gaps)
            served.append(out)
            run.units += 1
            if tracer:
                tracer, spent = tracer.after_unit()
                excluded += spent
            if time.perf_counter() - t0 >= seconds and tracer is None:
                break
        run.window_s = time.perf_counter() - t0 - excluded
    peak = _peak(dev)
    log(f"window closed: {run.units} units in {run.window_s:.3f} s")
    served = torch.stack(served).cpu()
    bad = ((served < 0) | (served >= s.padded_vocab)).any(dim=-1).sum()
    del params
    _free(dev)
    checks = _check_serving(run, seed, served, control)
    return {"setup_s": setup_s, "peak": peak, "served": served,
            "attempted": run.units * b, "failed": int(bad), "checks": checks}


def sample_unit(seed: int, units: int) -> int:
    return inputs.derived_seed(seed, 4) % units


def _gaps(logits: torch.Tensor, tokens: torch.Tensor) -> dict:
    """The widest and the mean gap by which ``tokens``' logits lie below
    the best logit at their positions, and the widest rank of a token
    among its position's logits (the entries above it: 0 for the best).
    Near the top the logits thin out, so the rank grows about
    exponentially with the gap."""
    got = logits.gather(-1, tokens[..., None])
    gaps = logits.max(dim=-1).values - got[..., 0]
    rank = (logits > got).sum(dim=-1)
    return {"max_gap": float(gaps.max()), "mean_gap": float(gaps.mean()),
            "max_rank": float(rank.max())}


def _check_serving(run: Run, seed: int, served: torch.Tensor,
                   control: bool = False) -> dict:
    """The reference over one whole batch of the window, drawn from the
    seed: the gaps of the served tokens (``_gaps``).  With ``control``
    also those of the tokens the reference computed in fp8 puts first at
    the same positions, under "control"."""
    s, t, dev = run.sizes, run.traffic, run.device
    k = sample_unit(seed, run.units)
    prompts = inputs.tokens(seed, inputs.BATCHES, k, (t["batch"], t["prompt_len"]),
                            s.vocab_size, dev)
    got = served[k].to(dev).long()
    params = inputs.draw_weights(s, seed, dev)
    log(f"reference on unit {k}")
    logits = reference.serve_logits(s, params, prompts, got[:, :-1])
    log("reference done")
    out = _gaps(logits, got)
    if control:
        low = reference.serve_logits(s, params, prompts, got[:, :-1], "fp8")
        out["control"] = _gaps(logits, low.argmax(dim=-1))
    del params
    return out


# --------------------------------------------------------------------- #
# Training
# --------------------------------------------------------------------- #

CHECKED_STEPS = 3


def _train_batch(run: Run, seed: int, index: int):
    t, dev = run.traffic, run.device
    toks = inputs.tokens(seed, inputs.BATCHES, index,
                         (t["batch"], t["seq_len"] + 1), run.sizes.vocab_size,
                         dev)
    return toks[:, :-1].contiguous(), toks[:, 1:].contiguous()


def _opt(t: dict) -> dict:
    return dict(lr=t["lr"], b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                grad_clip=1.0)


def _update_norms(s: Sizes, seed: int, params: dict, dev) -> dict:
    """Each leaf's norm of its change from the drawn weights."""
    out = {}
    for i, spec in enumerate(inputs.leaf_specs(s)):
        p0 = inputs.draw_leaf(spec, i, seed, dev, train=True)
        now = inputs.leaf_at(params, spec[0])
        out[spec[0]] = float(torch.linalg.vector_norm(now.float() - p0))
    return {p: out[p] for p, _ in reference.leaf_paths(params)}


def _train(run: Run, cfg, seed: int, seconds: float, faults, t_start: float,
           control: bool):
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Parallel
    from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule
    s, t, dev = run.sizes, run.traffic, run.device
    opt = _opt(t)
    params = inputs.draw_weights(s, seed, dev, train=True)
    state = adamw_init(params)
    step_fn = make_train_step(
        cfg, Parallel(mesh=None),
        AdamWConfig(**{k: opt[k] for k in ("lr", "b1", "b2", "eps",
                                           "weight_decay", "grad_clip")}),
        cosine_schedule(t["warmup"], t["total_steps"]))

    def step(index: int):
        nonlocal params, state
        tokens, labels = _train_batch(run, seed, index)
        if "half_batch" in faults:
            tokens, labels = tokens[:tokens.shape[0] // 2], labels[:labels.shape[0] // 2]
        if "stale_state" in faults:
            metrics = step_fn(*_clone((params, state)),
                              {"tokens": tokens, "labels": labels})[2]
        else:
            params, state, metrics = step_fn(params, state,
                                             {"tokens": tokens, "labels": labels})
        return metrics

    losses, first = [], None
    for i in range(CHECKED_STEPS):
        losses.append(float(step(i)["loss"]))
        if i == 0:
            from repro_torch.tree import tree_leaves
            first = [float(torch.linalg.vector_norm(m)) / (1 - opt["b1"])
                     for m in tree_leaves(state["mu"])]
    updates = _update_norms(s, seed, params, dev)
    _sync(dev)
    log(f"checked steps done, losses {losses}")
    tracer = _Tracer(run) if run.trace else None
    if tracer:
        tracer.start()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    excluded = 0.0
    while True:
        _mark(run, "train_step")
        metrics = step(CHECKED_STEPS + run.units)
        _mark(run, None)
        if not math.isfinite(float(metrics["loss"])):
            raise RuntimeError("non-finite loss in the window")
        run.units += 1
        if tracer:
            tracer, spent = tracer.after_unit()
            excluded += spent
        if time.perf_counter() - t0 >= seconds and tracer is None:
            break
    run.window_s = time.perf_counter() - t0 - excluded
    peak = _peak(dev)
    log(f"window closed: {run.units} steps in {run.window_s:.3f} s")
    del params, state, step_fn
    _free(dev)
    checks = _check_training(run, seed, losses, first, updates, control)
    return {"setup_s": setup_s, "peak": peak, "attempted": run.units,
            "failed": 0, "checks": checks}


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _leaf_gap(prog, ref, skip=()):
    """Worst leaf of |norm_p - norm_r| / max(norm_r, median leaf's norm_r)."""
    med = statistics.median(ref)
    return max(abs(p - r) / max(r, med) for i, (p, r) in enumerate(zip(prog, ref))
               if i not in skip)


def _reference_steps(run: Run, seed: int, prec: str):
    """The reference's checked steps from the drawn weights: its result
    (``reference.train_steps``) and each leaf's update norm."""
    s, t, dev = run.sizes, run.traffic, run.device
    params = inputs.draw_weights(s, seed, dev, train=True)
    batches = [_train_batch(run, seed, i) for i in range(CHECKED_STEPS)]
    ref = reference.train_steps(s, params, batches, _opt(t),
                                reference.cosine(t["warmup"], t["total_steps"]),
                                prec)
    updates = _update_norms(s, seed, params, dev)
    log(f"reference ({prec}) done, losses {ref['loss']}")
    del params
    _free(dev)
    return ref, updates


def _train_gaps(ref, ref_updates, losses, first, updates) -> dict:
    """The three numbers of the training check: the worst step's relative
    loss gap, and the worst leaf's gap of the first clipped gradient's
    norm and of the update's norm after the checked steps (``_leaf_gap``;
    leaves whose reference gradient is under a thousandth of the median
    leaf's are left out of the update's)."""
    paths = list(ref_updates)
    raw = ref["raw_grad_norms"]
    med = statistics.median(raw)
    still = {i for i, g in enumerate(raw) if g < 1e-3 * med}
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref["loss"])),
        "grad_gap": _leaf_gap(first, ref["grad_norms"]),
        "update_gap": _leaf_gap([updates[p] for p in paths],
                                [ref_updates[p] for p in paths], still),
    }


def _check_training(run: Run, seed: int, losses, first, updates,
                    control: bool = False) -> dict:
    ref, ref_updates = _reference_steps(run, seed, "f32")
    out = _train_gaps(ref, ref_updates, losses, first, updates)
    if control:
        low, low_updates = _reference_steps(run, seed, "fp8")
        out["control"] = _train_gaps(ref, ref_updates, low["loss"],
                                     low["grad_norms"], low_updates)
    return out


# --------------------------------------------------------------------- #
# The run
# --------------------------------------------------------------------- #


def _peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             t_start: float | None = None, device: str = "cuda",
             smoke: dict | None = None, faults=(), control: bool = False,
             readings: bool = False, root: Path = ROOT) -> dict:
    """One run of cell ``name``; returns the result line's object.

    ``device="cpu"`` with ``smoke`` (traffic sizes to override) runs the
    same path at ``smoke_sizes`` on the CPU, where the kernels are their
    plain versions: for tests, never for a measurement.  ``faults``
    plants faults in the timed path (``FAULTS``), for the tests that
    show the check fails them.  ``control`` also reads the check's numbers
    of the reference computed in fp8 in the program's place, under
    "control", and ``readings`` every number the check reads, limited or
    not, under "readings" (``calibrate.py``); a benchmark run does
    neither."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = find_cell(name, root)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise NoChip(f"cell {name} needs {cell.chips} CUDA device(s); "
                         f"found {torch.cuda.device_count()}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif smoke is None:
        raise NoChip("a measured run needs the card")
    sizes = cell.sizes if smoke is None else smoke_sizes(cell.sizes)
    traffic = {**cell.traffic, **(smoke or {})}
    cfg = program_config(cell, sizes)
    run = Run(cell, sizes, traffic, dev, bool(trace) and dev.type == "cuda")
    kind = traffic["kind"]
    job = _train if kind == "train" else _serve
    res = job(run, cfg, seed, seconds, tuple(faults), t_start, control)
    low = res["checks"].pop("control", None)
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in res["checks"].items() if k in cell.limits}
    correct = res["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = reader(m["name"], root)(run) if run.traced else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"setup_s": res["setup_s"],
                  "peak_mem_gib": res["peak"] / GIB,
                  _TOKENS[kind]: _rate(run)}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    out = {"correct": bool(correct), "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics,
           "device": _device(dev, cell.chips, res["peak"], run)}
    if trace and run.traced:
        out["breakdown"] = breakdown(run.traced)
    if low is not None:
        out["control"] = low
    if readings:
        out["readings"] = res["checks"]
    out["checks"] = checks
    return out


_TOKENS = {"prefill": "prefill_tok_s", "generate": "gen_tok_s",
           "train": "train_tok_s"}


def unit_tokens(traffic: dict) -> int:
    """Tokens a unit completes: prompt tokens prefilled, tokens generated
    (the first one included) or tokens trained."""
    kind = traffic["kind"]
    if kind == "prefill":
        return traffic["batch"] * traffic["prompt_len"]
    if kind == "generate":
        return traffic["batch"] * traffic["gen_tokens"]
    return traffic["batch"] * traffic["seq_len"]


def _rate(run: Run) -> float:
    return run.units * unit_tokens(run.traffic) / run.window_s


def _device(dev, chips: int, peak: int, run: Run) -> dict:
    if dev.type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
               "count": chips, "memory_peak_bytes": peak}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 0,
               "memory_peak_bytes": 0}
    if run.traced:
        out["busy_s"] = run.traced["busy_s"]
        out["window_s"] = run.traced["window_s"]
    return out
