#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no success line):

  1. the card: ``nvidia-smi`` name and power limit, torch's device name;
  2. build: compile every kernel of the serve path from ``csrc/`` with
     nvcc for sm_90a (one nvcc per source, started together);
  3. kernels: each CUDA kernel against its plain PyTorch version on the
     card at the serve path's shapes (plus an f32, a ragged and a long
     case, decode_attention's S = 2048 both in its own layout and as a
     view of the model's cache, and gmm at a real prefill's C = 2560),
     with its device time
     (CUDA events around calls queued behind a busy card) and wall time
     (CUDA events, host gaps included), the same for the plain version
     and for one PyTorch library call as a yardstick (gmm and
     ``torch.bmm`` timed in turns), and the least time the card could
     take; gmm's lines also give the kernel path taken, the rate
     reached against the bound (TB/s or TFLOP/s) and the host's time to
     enqueue one call (``host_us``, and ``torch.bmm``'s);
  4. small input: the serve path at smoke size on the card (kernels)
     against the same weights on the CPU (plain versions);
  5. full serve: ``repro_torch.launch.serve`` for llama-moe-3.5b at its
     published width and depth (batch 4, prompt 32, 16 decode tokens),
     with every kernel's launch count over that run checked, and every
     gmm launch on the tensor-core (wgmma) path;
  6. profile: where a full-width decode step's time goes (torch.profiler:
     device busy share, kernel time by name, ``decode_attention``'s);
  6b. deepseek-moe-16b kernels: gmm and decode_attention against their
     plain versions at its serve shapes (bf16: decode C = 6, prefill
     C = 15, 64 experts of 2048 x 1408; attention q(4, 16, 1, 128)) and at
     calibration's f32 shapes for both committed tables (gmm over 32
     rows an expert, decode_attention at the table's ctx_len and
     batches), each timed beside ``torch.bmm`` / SDPA and its bound;
  6c. deepseek-moe-16b's smoke model (shared experts, dense first layer)
     on the card against the CPU, as phase 4;
  6d. ``repro_torch.launch.serve --arch deepseek-moe-16b --space-sim`` at
     full width and depth (28 layers, 64 experts top-6, 2 shared, dense
     first layer; batch 4, prompt 32, 16 decode tokens; weights drawn
     cast block by block): tok/s against the 32.3 GB weights bound,
     peak memory, gmm 1,458 launches all on wgmma, decode_attention 448,
     finite logits, tokens in range, the placement cost line;
  6e. the profile of phase 6 for deepseek-moe-16b, then (for phase 17a)
     4 of its decode steps timed without the profiler and one counted by
     ``launch.op_analysis`` with the launch counters reset;
  6f. calibration: ``core.calibrate(impl="cuda")`` for deepseek-moe-16b and
     llama-moe-3.5b at the committed tables' ctx_len and batches (gmm
     and decode_attention launched, ``verify_table`` True), the measured
     seconds beside the committed CPU table's, the unclipped
     efficiencies, each table as one JSON line;
  7. fleet: the request-level fleet simulator (``repro_torch.traffic
     .FleetSim``) on the paper's world (33 x 32 satellites, 200 slots,
     llama-moe-3.5b's 32 MoE layers, 8 experts top-2, 3 plans, ~132
     requests, analytic service, ``QueueConfig()``): built on the card,
     ``run()`` with the launch counts of ``deposit`` and ``backlog_scan``
     checked, the device busy share of one ``run()``, the host's time in
     ``run()`` itemized (``chunk_table``, the iteration-1 ``np.bincount``,
     the upload, the fixed point, ``_finalize``), ``run_many`` over 11
     thinning fractions, and the CPU (plain versions) held to the card
     on ``run()`` and on the two smallest fractions, which must serve
     requests;
  8. fleet kernels: ``deposit`` and ``backlog_scan`` on the inputs that
     ``run()`` and ``run_many`` gave them, each against its plain version
     (bitwise), with device times, the plain version's and the library
     call's time, and the least time the card could take; ``deposit``
     with its table's shape (triples per row, per (row, tile) bucket and
     on one cell, zero-valued share); ``backlog_scan`` also on a plane
     built never to coalesce, each plane with its chunks' coalescence
     statistics;
  9. fleet with ground and admission: phase 7's world behind the 8
     default gateways (``build_ground_segment``, 10 degrees), a 60 s
     Poisson trace at 2 requests/s over them, ``QueueConfig(admission=
     AdmissionConfig())``: ``run()`` under AIMD and under PID on the card
     (deposit 2, backlog_scan 3, admission_window 3, admission_ctrl 3
     launches), wall and device time, total launches beside the earlier
     gather-based controller's (1,203 launches, 47.4 ms of device time
     with copies, on an H100 at 700 W), the host
     itemized (with ``_build_admission_tables`` and the attempt resolve),
     each against the CPU (identical served, shed and retry sets,
     ``assert_parity``), then ``run_many`` over ``ttft_targets`` at 1.5,
     2, 3 and 5 x the zero-load p99 TTFT, card against CPU;
     ``admission_window`` bitwise against its plain version on every wait
     trace those runs gave it, timed beside its byte bound;
     ``admission_ctrl`` bitwise against its plain loop on every window
     tensor they gave it and on two built never to coalesce (AIMD, PID),
     each with its chunks' coalescence statistics, timed beside its byte
     and serial-chain bounds;
 10. fleet with batching and probes: phase 7's world under
     ``BatchingConfig(b_max=8)``: ``run()`` on the card (deposit 6,
     backlog_scan 3 launches), wall and device time, busy share, peak
     device memory, the host itemized, the batching law's device time
     and peak on ``run()``'s planes, ``deposit`` bitwise against its plain
     version on the decode-work and decode-visit tables ``run()`` gave it
     (timed beside its byte bound), the card against the CPU; then
     ``ProbeConfig()`` on that run and on phase 9's AIMD ``run()``:
     ``last_probes`` card against CPU on every channel, a probes-off
     ``run()`` afterwards bitwise as before, the flight log exported by
     ``chrome_trace`` and passed by ``validate_trace``, the record's cost;
     then the reference's batching frontier
     (``benchmarks/bench_batching.py`` at its non-fast setting, rebuilt
     with the port): FIFO and ``b_max=8``, each one ``run_many`` over 4
     thinning fractions, card against CPU, ``b_max=1`` bitwise FIFO, and
     batched goodput above FIFO at p99 TTFT <= 2.5 x the zero-load p99;
 11. re-placement and the joint control plane: (a) phase 7's world
     under ``ReplanConfig(mode="backlog", controller_iterations=2,
     hysteresis=0)`` over cadences 1, 2 and 3 in one
     ``run_many(replan=)`` (deposit 8, backlog_scan 9 launches), wall,
     peak memory, the host's time and each stage's device time
     itemized (``run_replan_grid(stage=)``), ``replan_traffic`` on the
     card at each cadence with decisions equal bit for bit and results
     at the fused-vs-legacy criterion, ``deposit`` bitwise on the gated
     table the grid gave it (its zero share beside its time); (b) the
     reference's ``benchmarks/bench_ctrl.py`` grid at its non-fast
     setting (27 cells: 3 cadences x 3 migration prices x 3 AIMD TTFT
     targets) in one ``run_replan_grid`` (deposit 5, backlog_scan,
     admission_window and admission_ctrl 6 launches each), card against
     CPU on every cell (decisions bit for bit; served, shed and retry
     sets), the host loop cell by cell against it (decisions bit for
     bit; its wall reported beside the grid's), both admission kernels
     bitwise against their plain versions on the per-entry tables the
     grid gave them; (c) that grid's cell 0 flight log with ``replan=``,
     its decisions as trace instants, through ``validate_trace``;
 12. the traffic scenarios and the federation: (a) the reference's
     ``benchmarks/bench_replan.py`` at its non-fast setting rebuilt with
     the port (12 x 16 satellites, 12 slots, the 7 ``baseline_plans``
     candidates, both ``*-replan`` scenarios at 180 s and rate x 9, the
     storm split at 90 s; per phase one ``replan_traffic_fused`` over
     cadences 1, 2, 4 x migration prices 0, 0.01, 0.1 and the periodic
     control point; launches, wall, peak memory, switches and megabytes
     per grid), failing unless backlog re-placement beats the best static
     plan's goodput at matched p99 TTFT in both scenarios; its fast
     regional-hotspot grid on the card and on the CPU (decisions bit for
     bit, identical served sets), printed beside the committed
     ``BENCH_replan.json``; (b) all nine registry scenarios through
     ``run_scenario`` on that world (the re-placement ones with the joint
     control plane, regional-hotspot-replan also with the host loop,
     decisions bit for bit); (c) the reference's
     ``benchmarks/bench_federation.py``: the hotspot stage (K = 3, F = 6
     lanes, overflow off bitwise each member's own run, overflow on at
     least 1.3 x the goodput at p99 TTFT at most 1.05 x, card against
     CPU, one fixed point and its launches per overflow round) and the
     million-user stage at its full setting (1.01e6 users, K = 2: stream,
     build, host prep and device wall, memory; ``deposit``,
     ``backlog_scan``, ``admission_window`` and ``admission_ctrl``
     bitwise against their plain versions on its lane-stacked tables,
     timed beside their bounds); (d) ``python -m
     repro_torch.launch.serve`` for llama-moe-3.5b at full width with
     ``--traffic regional-hotspot-replan --ctrl fused --admission aimd
     --federation 2 --fail-device 3 --trace``: its lines, its trace
     through ``validate_trace``, gmm and decode_attention launch counts
     as phase 5;
 13. every attention-only architecture of the reference and EP slotting
     (run after 6f): (a) gmm (bf16, every case on wgmma) and
     decode_attention against their plain versions at the new shapes,
     each timed beside ``torch.bmm`` / SDPA and its bound:
     granite-moe-3b-a800m's 40 experts of 1536 x 512 at decode C = 8
     and prefill C = 32, slotted granite's 48 buckets (C = 8, 27),
     slotted llama-moe-3.5b's 16 half-experts of 688 (C = 2, 40, both
     projections); decode_attention at granite's and smollm-135m's
     hd 64 G = 3, qwen2.5-3b's hd 128 G = 8, llava-next-mistral-7b's
     G = 4, minicpm-2b's and musicgen-medium's hd 64 G = 1, at S = 49
     and S = 2048; (b) the smoke models of the seven new architectures
     (llava with its patch embeddings, musicgen decoding on frame
     embeddings) and of slotted llama-moe-3.5b and granite on the card
     against the CPU, as phase 4; (c) ``repro_torch.launch.serve`` at
     full width and depth for the six that one card holds (granite with
     ``--space-sim`` on 12 x 128), each as phase 5 (tok/s against its
     weights bound, init and run peaks, launches as the config implies:
     granite's gmm 1,728 all wgmma, none for a dense model,
     decode_attention L x 16; finite logits, tokens in range) and
     profiled as phase 6; (d) EP slotting at full width through the
     model functions: slotted llama-moe-3.5b against unslotted on the
     same canonical weights and tokens (every MoE call replayed on the
     same input within 2^-5 of its largest output; the whole runs'
     logits, differing routing choices and greedy tokens reported),
     slotted granite's launches, paths and finite logits;
     mistral-large-123b runs at smoke size only;
 14. the recurrent mixers (run after 13): (a) ``repro_torch.launch.serve
     --arch xlstm-350m`` at published width and depth (24 layers of
     mLSTM and sLSTM, d_model 1024) as phase 5: tok/s against the bound
     of its weights and the mLSTM memory each step reads and writes,
     peak memory, no gmm and no decode_attention launch; profiled as
     phase 6 with the mLSTM state update as a labelled range (its share
     of the step's kernel time), beside the update timed alone;
     (b) xlstm-350m's and jamba-1.5-large-398b's smoke models on the card
     against the CPU, as phase 4, and ``serve --smoke --arch
     jamba-1.5-large-398b --space-sim`` on the card (gmm 432,
     decode_attention 32 launches); (c) jamba at published width one
     block at a time (its full size needs sharding over more than four
     cards): gmm at its expert stacks (16 x 8192 x 24576, past 2^31
     elements; decode C = 2, prefill C = 20, both projections) and
     decode_attention at q(4, 8, 8, 128), S = 49 and 2048, against their
     plain versions, ``torch.bmm`` / SDPA and their bounds; then its Mamba
     + MoE, Mamba + dense and attention + MoE blocks, each drawn through
     ``_block_init`` and ``cast_for_compute``, prefilled (4 x 32) and
     decoded 16 steps through ``_apply_block`` (ms a step against its
     weights bound, peaks, launches: gmm 102 and decode_attention 16 in
     all, every gmm call replayed against ``gmm_ref`` within 2^-5);
 15. training (run after 14): (a) gmm at granite-moe-3b-a800m's train
     step calls at batch 4 x seq 2048 (C = 2048): the forward products
     and their dx = gmm(dy, w^T) and dw = gmm(x^T, dy), each distinct
     (E, C, K, N) against its plain version, ``torch.bmm`` and its bound,
     on the wgmma path, and ``GmmFunction``'s forward and backward for
     both projections against autograd through the plain version (each
     within 2^-7 of its largest value), with the backward's time;
     (b) three ``make_train_step`` steps of granite-moe-3b-a800m's and
     llama-moe-3.5b's smoke models (f32) on the card against the CPU,
     and ``python -m repro_torch.launch.train --smoke`` on the card: a
     run ended by ``--simulate-failure`` in a subprocess (exit 42), its
     resume from the checkpoint under build/, and an uninterrupted run
     with the same losses; (c) granite-moe-3b-a800m trained at published
     width: f32 master weights drawn on the card, batch 4 x 2048 from
     ``SyntheticTokens``, AdamW on a cosine schedule (warmup 2, 6
     steps): loss, ce, aux and grad norm a step (finite, the last loss
     below the first), seconds a step and tok/s beside the bound worked
     out from the config (the causal attention pairs and routed expert
     rows a step needs), peak memory, gmm 384 launches a step all on
     wgmma (by call shape as the config implies), no decode_attention,
     and a profiled step with its device time split by region (gmm
     forward and backward, attention forward and backward, AdamW, the
     rest) and its busy share; a split that cannot be made fails;
 16. sharding (run after 15): NCCL at world size 1 through
     ``launch.mesh.make_host_mesh("cuda")``, torn down at the end;
     (a) deepseek-moe-16b's MoE block at published width (64 experts of
     2048 x 1408, top-6, 2 shared, bf16, drawn by the model's block
     init): ``moe_apply_ep_replicated`` at decode x(4, 1, 2048) and
     ``moe_apply_ep`` at prefill x(4, 2048, 2048) (gmm at C = 960)
     through ``sharded_moe`` on the 1 x 1 mesh, and ``moe_apply_ep``'s
     backward, with gmm launches (by call shape) and collective calls
     counted over that run and required above 0; each output, aux and
     the grads of w_gate, w_up, w_down, router and x against
     ``moe_apply_local`` on the same inputs (bitwise, or within 2^-7 of
     the largest value, reported); (b) granite-moe-3b-a800m at published
     width: prefill and 4 decode steps through ``make_prefill_step`` and
     ``make_serve_step`` with ``par`` on that mesh (gmm and
     decode_attention launches above 0), the tokens identical to the same
     steps with ``Parallel()``; (c) gmm at every (E, C, K, N) of (a)'s
     run against its plain version, ``torch.bmm`` and its bound, on the
     wgmma path;
 17. the dry run (run after 16): (a) 6e's counted deepseek-moe-16b decode
     step (batch 4, cache 49, on the card) against the same step counted
     on ``meta`` tensors: flops, bytes and kernel counts equal, and the
     card's gmm and decode_attention launch counters equal to the kernel
     counts; (b) ``python -m repro_torch.launch.dryrun --arch
     deepseek-moe-16b --shape decode_32k --mesh pod --out build/dryrun``
     in a subprocess (a fake group of 256 ranks; no CUDA) writes an
     ``ok`` record; (c) the roofline bound of (a)'s step from its counted
     bytes and flops beside its measured ms a step, and
     ``roofline.train_step_bound`` of 15c's granite step beside its
     measured seconds a step;
 18. tensor and data parallelism (run after 17): (a) values: 4
     processes on the one card (each on ``cuda:0``, a gloo group through
     ``file://build/tp``; gloo stages CUDA tensors through the host)
     run deepseek-moe-16b at published width with 3 layers (the dense
     first layer and 2 MoE layers; capacity 8, so that the EP bodies
     drop no copy, and the single-shard run takes their per-shard aux)
     on a (2, 2) mesh and qwen2.5-3b at
     published width with 2 layers on a (1, 4) mesh, f32, each rank on
     its blocks (``init_params(par=...)``): a prefill of 32 tokens, 8
     decode steps fed the single-shard run's tokens, one train step; its
     logits, cache blocks, loss, grad norm and updated param blocks are
     held against the single-shard step this process ran on the card
     first (shared with the ranks as CUDA tensors), within
     ``TP_TOL`` of the largest single-shard value; gmm and
     decode_attention launch on every rank; (b) memory and time: rank 0
     of the 16 x 16 pod mesh in a fake group of 256 ranks (as phase 17's
     dry run builds it), with real tensors on the card, for
     mistral-large-123b and jamba-1.5-large-398b at published width and
     depth (and granite-moe-3b-a800m and llama-moe-3.5b, whose "local"
     MoE mode runs gmm on d_ff shards of 32 and 86): its blocks drawn
     leaf by leaf and cast for compute, a global batch of 64 (4 rows a
     data rank), a cache of 2,048, a prefill of 32 tokens, 8 decode
     steps (granite and llama 4): held bytes against
     ``memory_per_rank``'s planned for the same cast tree (within 1 %),
     the draw's peak memory and seconds, the ms a step, the device busy
     share (2 more steps under the profiler; mistral and jamba), the
     launches; values are not checked (the other ranks are stand-ins;
     run in a process of its own);
     (c) gmm and decode_attention at (b)'s shapes against their plain
     versions, ``torch.bmm`` / SDPA and their bounds;
 19. ZeRO-1 and context parallelism (run after 18): (a) 4 gloo ranks on
     the card (as 18a) run granite-moe-3b-a800m at published width with
     2 layers (f32, capacity 8) for 3 train steps of 4 x 32 tokens on
     (2, 2) and (4, 1) meshes, with and without ``zero_opt``, side by
     side: the ZeRO state after each step held to the non-ZeRO run's and
     to the single-shard state after the same step started from the
     single-shard state before it (which this process ran first, with the
     EP bodies' aux on (2, 2)), losses and grad norms to both runs', each
     rank's moment bytes 1/n_data of the non-ZeRO blocks' wherever the
     dim divides, the reduce-scatters and all-gathers a step; (b) in the
     same ranks, qwen2.5-3b's and jamba's smoke models at batch 1 on a
     64-row cache split over (4, 1) and (2, 2) data ranks (decode at
     rows 5, 16, 32 and 63), logits and cache blocks against the
     single-shard run, ``decode_attention`` in its partial mode launched
     on every rank and never in its normal mode; all within ``TP_TOL``;
     (c) in 18b's process: jamba-1.5-large-398b at ``long_500k`` (batch
     1, a 524,288-row cache, blocks of 32,768 rows) as rank 0 of the pod
     mesh: held against planned bytes to the byte, the draw's peak, and
     4 decode steps from the last rows (every block visible) and from row
     100 (rank 0's block alone): ms a step, busy share (2 steps under the
     profiler), launches and collectives a step; (d) the partial mode at
     (c)'s shape, q(1, 1, 4, 128) over a view of one KV head of the
     rank's (1, 32768, 8, 128) block, against its plain version, SDPA and
     its bound, and an empty window (out 0, lse -inf);
 20. the ``kernels`` JSON line (all six kernels, and gmm and
     decode_attention again at deepseek-moe-16b's decode shape with
     phase 6d's launches, at phase 13's decode shapes with that
     phase's launches, at phase 14c's shapes with their launches
     there and gmm at phase 15a's shapes with their launches over
     15c's run, gmm at phase 16c's shapes with their launches over
     16a's run, gmm and decode_attention at phase 18c's shapes with
     their launches over 18b's runs, and decode_attention's partial mode
     at 19d's shape with its launches over 19c's steps; launches counted
     over
     the serve run for gmm/decode_attention, over the fleet ``run()``
     for deposit/backlog_scan and over the AIMD ``run()`` for
     admission_window/admission_ctrl), the card line, then the result
     line.  Each phase's seconds are printed as it ends.

Every ``torch.profiler`` window opens with PROFILE_PRIMER throwaway spin
launches (``primed_profile``), which the profiler may drop in place of
the first kernels of the work it measures.

Imports nothing of JAX and nothing of the ``repro`` package.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ARCH = "llama-moe-3.5b"
DEEPSEEK = "deepseek-moe-16b"
BATCH, PROMPT, DECODE = 4, 32, 16
# The models whose service tables are committed, and calibration's rows
# per expert (measure_components' rows_per_expert).
CALIBRATED = ("deepseek-moe-16b", "llama-moe-3.5b")
CAL_ROWS = 32
# The H100's rates (the data sheet's) and the step bounds are
# repro_torch.launch.roofline's: HBM_BW, PEAK_FLOPS_BY_DTYPE,
# serve_weight_bytes, train_step_bound.
# Thinning fractions of the fleet sweep (benchmarks/bench_fleet.py).
FLEET_FRACTIONS = (0.1, 0.15, 0.2, 0.25, 0.3, 0.35, 0.4, 0.5, 0.6, 0.8, 1.0)
# Latency targets of the admission sweep, times the zero-load p99 TTFT
# (benchmarks/bench_admission.py TARGET_SCALES).
ADM_TARGET_SCALES = (1.5, 2.0, 3.0, 5.0)
# The batching frontier of benchmarks/bench_batching.py: decode batch cap,
# nested thinning fractions, and the matched bound on p99 TTFT as a
# multiple of the zero-load p99.
BATCH_B_MAX = 8
BATCH_FRACTIONS = (0.25, 0.5, 0.75, 1.0)
BATCH_TTFT_BOUND_SCALE = 2.5
# The CUDA kernels each fleet wrapper call launches, by profiler name.
FLEET_KERNELS = {"deposit": ("deposit_bucket_kernel",
                             "deposit_accumulate_kernel"),
                 "backlog_scan": ("backlog_scan_kernel",)}


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


# Throwaway launches that open every profiled window (``primed_profile``).
PROFILE_PRIMER = 1000
PRIMER_KERNEL = "spin_kernel"        # torch.cuda._sleep's kernel


@contextlib.contextmanager
def primed_profile(torch, cpu: bool = True):
    """``torch.profiler.profile`` over CPU (unless ``cpu`` is off: device
    time only, far fewer records to sum) and CUDA whose window opens with
    PROFILE_PRIMER one-cycle spin launches and a synchronize, before the
    caller's work.  Late in this script the profiler has dropped the
    first few kernel records of a window (5 to 11 in repeated windows on
    the H100 with torch 2.11, among them the first ``backlog_scan`` launch
    of phase 7's profiled ``run()``, which failed its check); the spins
    take that loss, and ``device_times`` leaves them out."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        for _ in range(PROFILE_PRIMER):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        yield prof


def device_times(prof, n_calls: int,
                 ranges: tuple = ()) -> list[tuple[float, float, str]]:
    """(ms per call, launches per call, name) of every device-side event
    the profiler recorded, summed by name; the device-side spans of the
    ``record_function`` labels in ``ranges`` are not kernels, and
    ``primed_profile``'s spins not the caller's: both are left out."""
    from torch.autograd import DeviceType
    return [(evt.self_device_time_total / 1e3 / n_calls, evt.count / n_calls,
             evt.key)
            for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA and evt.key not in ranges
            and PRIMER_KERNEL not in evt.key]


def primer_launches(prof) -> int:
    """The primer's launches the profiler recorded (of PROFILE_PRIMER)."""
    from torch.autograd import DeviceType
    return sum(evt.count for evt in prof.key_averages()
               if evt.device_type == DeviceType.CUDA
               and PRIMER_KERNEL in evt.key)


def _events(torch, n: int):
    return [torch.cuda.Event(enable_timing=True) for _ in range(n)]


_SPIN_CYCLES_PER_MS: list[float] = []
# Measurements ``time_ms`` takes of a function whose queueing a host
# stall overran (on the H100's host, one of the script's ~90 kernel
# timings has come back voided by a stall).
HIDDEN_TRIES = 3


def spin_cycles_per_ms(torch) -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond on the card."""
    if not _SPIN_CYCLES_PER_MS:
        start, end = _events(torch, 2)
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        end.synchronize()
        _SPIN_CYCLES_PER_MS.append(20_000_000 / start.elapsed_time(end))
    return _SPIN_CYCLES_PER_MS[0]


def time_ms(torch, fn, iters: int, warmup: int = 3) -> tuple[float, float, bool]:
    """(device ms, wall ms, hidden) per call of ``fn()``.

    Wall ms: CUDA events around ``iters`` back-to-back calls, host gaps
    included.  Device ms: the same calls queued behind a spin kernel
    that keeps the card busy for twice their wall time, so that the
    events bracket the card's own work.  ``hidden`` says the host had
    queued every call before the spin ended, which makes device ms the
    card's time alone; a function that waits on the card inside (or
    whose calls take over a second) is not hidden, and its device ms
    includes host gaps.  A host stall while queueing (the host's time
    past 0.9 of the spin) voids that measurement, which is taken again, up
    to HIDDEN_TRIES times.  (Per-window ``torch.profiler`` sums are not
    used here: late in this script short windows have come back with part
    or none of their kernels.)
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end, spin = _events(torch, 3)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    wall = start.elapsed_time(end) / iters
    if wall * iters > 1000.0:
        return wall, wall, False
    for _ in range(HIDDEN_TRIES):
        spin.record()
        torch.cuda._sleep(int(2.0 * wall * iters * spin_cycles_per_ms(torch)))
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        t_host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        hidden = t_host_ms < 0.9 * spin.elapsed_time(start)
        if hidden:
            break
    return start.elapsed_time(end) / iters, wall, hidden


def host_us(torch, fn, n: int = 200) -> float:
    """Host time to enqueue one call of ``fn()``, microseconds: ``n``
    calls queued behind a spin long enough (0.5 ms a call) that the card's
    queue never makes the host wait."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(n * 0.5 * spin_cycles_per_ms(torch)))
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def event_ms(torch, fn, iters: int = 1, warm: bool = True) -> float:
    """Wall ms per call of ``fn()`` from CUDA events around ``iters``
    back-to-back calls (after one warm call if ``warm``), host gaps
    included."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start, end = _events(torch, 2)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    from repro_torch.launch import roofline as rl
    t_mem = nbytes / rl.HBM_BW
    t_ops = flops / rl.PEAK_FLOPS_BY_DTYPE[dtype]
    return (max(t_mem, t_ops) * 1e3, "bytes" if t_mem >= t_ops else "operations")


# --------------------------------------------------------------------- #
# Phase 3: kernels against their plain versions
# --------------------------------------------------------------------- #


def check_gmm(torch, e, c, k, n, dtype_name, iters):
    from repro_torch.kernels import moe_gmm
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(c * 7 + n)
    x = torch.randn(e, c, k, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(e, k, n, generator=gen, device="cuda") / k ** 0.5).to(dtype)
    before = dict(moe_gmm.path_launches)
    got = moe_gmm.gmm(x, w)
    torch.cuda.synchronize()
    path = [p for p in before if moe_gmm.path_launches[p] != before[p]]
    want = moe_gmm.gmm_plain(x, w)
    tol = 2e-2 if dtype_name == "bfloat16" else 2e-5
    err = float((got.float() - want.float()).abs().max())
    ok = bool(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol))
    esize = x.element_size()
    nbytes = (x.numel() + w.numel() + e * c * n) * esize
    flops = 2.0 * e * c * k * n
    b_ms, b_by = bound(nbytes, flops, dtype_name)
    rec = timed_record(
        torch, {"name": "gmm",
                "shape": f"x({e},{c},{k}) w({e},{k},{n}) {dtype_name}",
                "path": path[0] if len(path) == 1 else path,
                "max_abs_err": err, "tol": tol, "ok": ok and len(path) == 1,
                "bound_ms": b_ms, "bound_by": b_by},
        kernel=lambda: moe_gmm.gmm(x, w),
        plain=lambda: moe_gmm.gmm_plain(x, w),
        library=lambda: torch.bmm(x, w), iters=iters, turns=2)
    if b_by == "bytes":
        rec["rate"] = f"{nbytes / rec['ms'] / 1e9:.3f} TB/s"
    else:
        rec["rate"] = f"{flops / rec['ms'] / 1e9:.1f} TFLOP/s"
    rec["host_us"] = host_us(torch, lambda: moe_gmm.gmm(x, w))
    rec["library_host_us"] = host_us(torch, lambda: torch.bmm(x, w))
    return rec


def timed_record(torch, rec, kernel, plain, library, iters, turns=1) -> dict:
    """``rec`` with device and wall times of the kernel, its plain version
    and the library call.  With ``turns`` > 1 the kernel and the library
    call are timed in turns (kernel, library, kernel, ...) and each time
    is the mean of its turns, also listed under ``turns``."""
    runs: dict[str, list] = {"": [], "library_": []}
    for _ in range(turns):
        for key, fn in (("", kernel), ("library_", library)):
            runs[key].append(time_ms(torch, fn, iters))
    runs["plain_"] = [time_ms(torch, plain, iters)]
    for key, got in runs.items():
        rec[key + "ms"] = sum(r[0] for r in got) / len(got)
        rec[key + "wall_ms"] = sum(r[1] for r in got) / len(got)
        rec[key + "hidden"] = all(r[2] for r in got)
    if turns > 1:
        rec["turns"] = {"ms": [r[0] for r in runs[""]],
                        "library_ms": [r[0] for r in runs["library_"]]}
    return rec


def check_decode(torch, b, hkv, g, s, hd, dtype_name, pos_list, iters,
                 layout="bhsd", cache_heads=None):
    """``layout`` "bshd": k and v are transposed views of the model's
    (B, S, Hkv, hd) cache, as ``models/attention.py`` passes them; with
    ``cache_heads`` the cache holds that many heads and k and v are views
    of its first ``hkv`` (a rank's heads of a cache every rank holds
    whole)."""
    import torch.nn.functional as F

    from repro_torch.kernels import build, decode_attn
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(s + g)
    kv_shape = (b, hkv, s, hd) if layout == "bhsd" \
        else (b, s, cache_heads or hkv, hd)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for shape in ((b, hkv, g, hd), kv_shape, kv_shape))
    if layout == "bshd":
        k, v = (t.narrow(2, 0, hkv).transpose(1, 2) for t in (k, v))
    pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
    got = decode_attn.decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    want = decode_attn.decode_attention_plain(q, k, v, pos)
    tol = 2e-2 if dtype_name == "bfloat16" else 2e-5
    err = float((got.float() - want.float()).abs().max())
    ok = bool(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol))
    rows = sum(min(p, s - 1) + 1 for p in pos_list)     # rows this data needs
    esize = q.element_size()
    nbytes = 2 * q.numel() * esize + 2 * hkv * rows * hd * esize + 4 * b
    b_ms, b_by = bound(nbytes, 4.0 * hkv * g * hd * rows, dtype_name)
    q_lib = q.reshape(b, hkv * g, 1, hd)
    mask = (torch.arange(s, device="cuda")[None, :] <= pos[:, None])[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(q_lib, k, v, attn_mask=mask,
                                              enable_gqa=g > 1)
    return timed_record(
        torch, {"name": "decode_attention",
                "shape": f"q({b},{hkv},{g},{hd}) kv S={s} {layout} "
                         f"pos={pos_list} {dtype_name}",
                "splits": list(decode_attn.decode_splits(b, hkv, s,
                                                         build.sm_count(0))),
                "max_abs_err": err, "tol": tol, "ok": ok,
                "bound_ms": b_ms, "bound_by": b_by},
        kernel=lambda: decode_attn.decode_attention(q, k, v, pos),
        plain=lambda: decode_attn.decode_attention_plain(q, k, v, pos),
        library=library, iters=iters)


def phase_kernels(torch) -> dict[str, dict]:
    """Every case printed; returns each kernel's serve-path decode case."""
    d, f, e = 4096, 1376, 8
    cap_decode, cap_prefill = 2, 40      # capacity() at T = 4 and T = 128
    # C = 2560: capacity() at a real prefill, batch 4 x 2048 tokens.
    gmm_cases = [(e, c, kk, nn, "bfloat16")
                 for c in (cap_decode, cap_prefill, 2560)
                 for kk, nn in ((d, f), (f, d))]
    gmm_cases += [(e, cap_decode, d, f, "float32"), (e, cap_prefill, d, f, "float32"),
                  (3, 130, 100, 36, "bfloat16"), (3, 3, 100, 36, "float32")]
    last_pos = PROMPT + DECODE - 1       # the last decode step's positions
    s_serve = PROMPT + DECODE + 1
    long_pos = [2047, 1500, 1024, 17]
    attn_cases = [
        (BATCH, 32, 1, 128, s_serve, "bfloat16", [last_pos] * BATCH, "bhsd"),
        (BATCH, 32, 1, 128, 2048, "bfloat16", long_pos, "bhsd"),
        (BATCH, 32, 1, 128, 2048, "bfloat16", long_pos, "bshd"),
        (BATCH, 32, 1, 128, 2048, "bfloat16", [2047] * BATCH, "bhsd"),
        (2, 4, 3, 64, 333, "float32", [332, 100], "bhsd"),
    ]
    main = {}
    failed = []
    for case in gmm_cases:
        rec = check_gmm(torch, *case, iters=20)
        log("kernel " + json.dumps(rec))
        failed += [] if rec["ok"] else [rec["shape"]]
        if case == (e, cap_decode, d, f, "bfloat16"):
            main["gmm"] = rec
    for b, hkv, g, hd, s, dt, pos, layout in attn_cases:
        rec = check_decode(torch, b, hkv, g, s, hd, dt, pos, iters=50,
                           layout=layout)
        log("kernel " + json.dumps(rec))
        failed += [] if rec["ok"] else [rec["shape"]]
        if s == s_serve:
            main["decode_attention"] = rec
    if failed:
        raise SmokeFailure(f"kernel disagrees with its plain version: {failed}")
    return main


# --------------------------------------------------------------------- #
# Phase 4: small input, card (kernels) against CPU (plain versions)
# --------------------------------------------------------------------- #


def phase_small(torch, arch: str = ARCH, slotted: bool = False) -> None:
    """The smoke model of ``arch`` (EP-slotted with ``slotted``) on the
    card against the CPU: router counts, prefill and four decode steps
    (on frame embeddings for an audio model), greedy tokens."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.models import (decode_step, forward, init_params,
                                    prefill, random_batch)
    cfg = dataclasses.replace(smoke_config(arch),     # f32 compute
                              moe_slotting=slotted)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def to_cuda(node):
        if isinstance(node, dict):
            return {k: to_cuda(v) for k, v in node.items()}
        if isinstance(node, list):
            return [to_cuda(v) for v in node]
        return node.to("cuda")

    results = {}
    for dev, p in (("cpu", params), ("cuda", to_cuda(params))):
        calib = random_batch(cfg, BATCH, 8, seed=7, device=dev)
        _, _, counts = forward(cfg, p, calib, return_router_stats=True)
        batch = random_batch(cfg, BATCH, 8, seed=0, device=dev)
        prompt = {k: v for k, v in batch.items() if k != "labels"}
        logits, cache = prefill(cfg, p, prompt, max_len=13)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        pos = torch.full((BATCH,), 8, dtype=torch.int32, device=dev)
        emb = (torch.ones((BATCH, 1, cfg.d_model), device=dev)
               if cfg.frontend == "audio" else None)
        steps, toks = [logits], [tok]
        for _ in range(4):
            logits, cache = decode_step(cfg, p, cache, tok, pos, embeds=emb)
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
            pos = pos + 1
            steps.append(logits)
            toks.append(tok)
        results[dev] = (counts.cpu(), torch.stack(steps).cpu(),
                        torch.cat(toks, 1).cpu())
    (c0, l0, t0), (c1, l1, t1) = results["cpu"], results["cuda"]
    err = float((l0 - l1).abs().max())
    log(f"small input ({cfg.name}{', slotted' if slotted else ''}, f32, "
        f"inputs {sorted(prompt)}): card vs CPU logits max_abs_err="
        f"{err:.3g} (tol 2e-4), router counts equal={torch.equal(c0, c1)}, "
        f"greedy tokens equal={torch.equal(t0, t1)}")
    if not (err <= 2e-4 and torch.equal(c0, c1) and torch.equal(t0, t1)):
        raise SmokeFailure("serve path on the card disagrees with the CPU")


# --------------------------------------------------------------------- #
# Phase 5: full serve, launch counts
# --------------------------------------------------------------------- #


def serve_launches(cfg, passes: int = 2 + DECODE,
                   decode_steps: int = DECODE) -> dict[str, int]:
    """gmm: 3 per MoE layer per pass (serve's: calibrate, prefill, each
    decode step; none without MoE); decode_attention: one per attention
    block per decode step (none for the recurrent mixers)."""
    from repro_torch.launch.roofline import block_specs, n_ffn_layers
    n_moe, _ = n_ffn_layers(cfg)
    n_attn = sum(spec.mixer == "attn" for spec in block_specs(cfg))
    return {"gmm": 3 * n_moe * passes,
            "decode_attention": n_attn * decode_steps}


def phase_serve(torch, card: str, arch: str = ARCH, extra: tuple = (),
                smoke: bool = False) -> dict[str, int]:
    """``serve`` at full width and depth (``smoke``: the smoke model, f32,
    so every gmm launch takes the fma path) with the checks of phase 5."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.kernels import moe_gmm, ops
    from repro_torch.launch import roofline as rl
    from repro_torch.launch import serve
    cfg = smoke_config(arch) if smoke else get_config(arch)
    argv = ["--arch", arch, "--batch", str(BATCH), "--prompt-len",
            str(PROMPT), "--decode-tokens", str(DECODE), *extra]
    if smoke:
        argv.append("--smoke")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out, state = serve.run(argv)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    log(f"serve {cfg.name} (d_model {cfg.d_model}, {cfg.n_layers} layers, "
        f"{cfg.n_experts} experts top-{cfg.top_k}, d_ff_expert "
        f"{cfg.d_ff_expert}, {cfg.n_shared_experts} shared, first dense "
        f"{cfg.first_layer_dense}): {out['tokens_per_s']:.2f} tok/s on {card}")
    log(f"placement cost: {json.dumps(out.get('dispatch_cost'))}")
    if "space_latency_s" in out:
        log(f"space-sim s/token: {json.dumps(out['space_latency_s'])}")
    parts = rl.serve_weight_bytes(cfg, BATCH)
    total = sum(parts.values())
    step_ms = total / rl.HBM_BW * 1e3
    log(f"decode-step bound: {total / 1e9:.3f} GB of weights and state ("
        + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in parts.items() if v)
        + f") -> {step_ms:.3f} ms at 3.35 TB/s -> "
        f"{BATCH / step_ms * 1e3:.0f} tok/s at batch {BATCH}; measured "
        f"{BATCH * 1e3 / out['tokens_per_s']:.3f} ms/step, "
        f"{out['tokens_per_s']:.2f} tok/s")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    logits, tokens = state["logits"], state["tokens"]
    finite = bool(torch.isfinite(logits).all())
    log(f"logits {tuple(logits.shape)} finite={finite}; tokens "
        f"{tuple(tokens.shape)}")
    if not finite or logits.shape != (BATCH, cfg.padded_vocab) \
            or tokens.shape != (BATCH, DECODE + 1) \
            or int(tokens.min()) < 0 or int(tokens.max()) >= cfg.padded_vocab:
        raise SmokeFailure("serve output has the wrong shape or values")
    want = serve_launches(cfg)
    log(f"launch counts {json.dumps(counts)} (expected {json.dumps(want)})")
    if {k: counts[k] for k in want} != want:
        raise SmokeFailure(f"launch counts {counts} != expected {want}")
    paths = dict(moe_gmm.path_launches)
    path = "fma" if smoke else "wgmma"
    log(f"gmm launches by path {json.dumps(paths)} (expected all "
        f"{want['gmm']} on {path})")
    if paths != {"wgmma": 0, "fma": 0, path: want["gmm"]}:
        raise SmokeFailure(f"gmm paths {paths}: not every serve launch ran "
                           f"on the {path} path")
    return counts


# --------------------------------------------------------------------- #
# Phase 6: where a decode step's time goes (torch.profiler)
# --------------------------------------------------------------------- #


def phase_profile(torch, n_steps: int = 4, arch: str = ARCH,
                  ranges: dict | None = None, count: bool = False) -> dict:
    """Profile ``n_steps`` decode steps.  ``ranges`` maps a label to
    (module, function name): during the profile that function runs inside
    ``record_function(label)``, and each label's kernel time a step is
    reported.  Returns the step's wall and kernel ms, launches and each
    label's kernel ms a step.  With ``count`` (phase 17a, on these
    weights) it then times ``n_steps`` steps without the profiler (CUDA
    events) and counts one more under ``op_analysis.analyze`` with the
    launch counters reset: under "count" the ``OpCost``, the launches, the
    ms a step and the step's inputs' shapes."""
    from torch.profiler import record_function

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import op_analysis
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import Parallel, init_params, prefill, random_batch
    cfg = get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, "cuda")
    batch = random_batch(cfg, BATCH, PROMPT, seed=0, device="cuda")
    logits, cache = prefill(cfg, params,
                            {k: v for k, v in batch.items() if k != "labels"},
                            max_len=PROMPT + DECODE + 1)
    step = make_serve_step(cfg, Parallel())
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    pos = torch.full((BATCH,), PROMPT, dtype=torch.int32, device="cuda")
    emb = (torch.ones((BATCH, 1, cfg.d_model), device="cuda")
           if cfg.frontend == "audio" else None)
    for _ in range(2):                                     # warm
        tok, logits, cache = step(params, cache, tok, pos, emb)
        pos = pos + 1
    torch.cuda.synchronize()
    ranges = ranges or {}
    real = {label: getattr(mod, name) for label, (mod, name) in ranges.items()}

    def labelled(label):
        def fn(*args):
            with record_function(label):
                return real[label](*args)
        return fn
    for label, (mod, name) in ranges.items():
        setattr(mod, name, labelled(label))
    try:
        with primed_profile(torch) as prof:
            t0 = time.perf_counter()
            for _ in range(n_steps):
                tok, logits, cache = step(params, cache, tok, pos, emb)
                pos = pos + 1
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    finally:
        for label, (mod, name) in ranges.items():
            setattr(mod, name, real[label])
    kernels = device_times(prof, n_steps, tuple(ranges))
    busy_ms = sum(k[0] for k in kernels)
    # A label's CPU-side event sums the kernels launched inside it.
    from torch.autograd import DeviceType
    in_range = {evt.key: evt.device_time_total / 1e3 / n_steps
                for evt in prof.key_averages()
                if evt.key in ranges and evt.device_type == DeviceType.CPU}
    log(f"profile {cfg.name}: decode step {wall_ms:.3f} ms wall under the "
        f"profiler, "
        f"device kernels {busy_ms:.3f} ms -> device busy "
        f"{busy_ms / wall_ms:.1%}, idle {1 - busy_ms / wall_ms:.1%} "
        f"({sum(k[1] for k in kernels):.0f} kernel launches per step)")
    for ms, calls, name in sorted(kernels, reverse=True)[:12]:
        log(f"profile:   {ms:8.3f} ms/step {calls:6.0f} calls/step  {name[:90]}")
    attn = [(ms, calls) for ms, calls, name in kernels
            if "decode_attn_kernel" in name]
    log(f"profile: decode_attention {sum(a[0] for a in attn):.4f} ms/step in "
        f"{sum(a[1] for a in attn):.0f} calls/step")
    for label, ms in in_range.items():
        log(f"profile: {label} {ms:.4f} ms/step of kernels, "
            f"{ms / busy_ms:.1%} of the step's kernel time")
    out = {"wall_ms": wall_ms, "kernel_ms": busy_ms,
           "launches": sum(k[1] for k in kernels), "ranges": in_range}
    if count:
        state = {"tok": tok, "pos": pos, "cache": cache}

        def one():
            state["tok"], _, state["cache"] = step(
                params, state["cache"], state["tok"], state["pos"], emb)
            state["pos"] = state["pos"] + 1
        step_ms = event_ms(torch, one, iters=n_steps, warm=False)
        ops.reset_launch_counts()
        cost, _ = op_analysis.analyze(step, params, state["cache"],
                                      state["tok"], state["pos"], emb)
        torch.cuda.synchronize()
        out["count"] = {"cost": cost, "launches": ops.launch_counts(),
                        "step_ms": step_ms,
                        "cache_len": state["cache"]["layers"][0]["k"].shape[1]}
    return out


# --------------------------------------------------------------------- #
# Phase 6b-f: deepseek-moe-16b (shared experts, a dense first layer) and
# calibration on the kernels
# --------------------------------------------------------------------- #


def phase_kernels_deepseek(torch) -> dict[str, dict]:
    """(b) gmm and decode_attention against their plain versions at
    deepseek-moe-16b's serve shapes (decode: C floors at top_k; prefill at
    T = BATCH x PROMPT) and at calibration's f32 shapes for both committed
    tables (gmm over 32 rows an expert, decode_attention at the table's
    ctx_len and batches).  Returns the decode cases."""
    from repro_torch.configs import get_config
    from repro_torch.core import calibration as cal
    from repro_torch.models.moe import capacity
    cfg = get_config(DEEPSEEK)
    d, f, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    cap_decode = capacity(cfg, BATCH, e)
    cap_prefill = capacity(cfg, BATCH * PROMPT, e)
    gmm_cases = [(e, c, kk, nn, "bfloat16")
                 for c in (cap_decode, cap_prefill)
                 for kk, nn in ((d, f), (f, d))]
    last_pos = PROMPT + DECODE - 1
    attn_cases = [(BATCH, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                   cfg.head_dim, PROMPT + DECODE + 1, "bfloat16",
                   [last_pos] * BATCH)]
    for name in CALIBRATED:
        table = cal.load_table(name)
        wl = table.workload_obj()
        gmm_cases += [(wl.n_experts, CAL_ROWS, kk, nn, "float32")
                      for kk, nn in ((wl.d_model, wl.d_ff_expert),
                                     (wl.d_ff_expert, wl.d_model))]
        attn_cases += [(b, wl.n_kv_heads, wl.n_heads // wl.n_kv_heads,
                        wl.head_dim, table.ctx_len, "float32",
                        [table.ctx_len - 1] * b) for b in table.batches]
    main, failed = {}, []
    for case in gmm_cases:
        rec = check_gmm(torch, *case, iters=20)
        log("kernel " + json.dumps(rec))
        failed += [] if rec["ok"] else [rec["shape"]]
        if case == (e, cap_decode, d, f, "bfloat16"):
            main["gmm"] = rec
    for b, hkv, g, hd, s, dt, pos in attn_cases:
        rec = check_decode(torch, b, hkv, g, s, hd, dt, pos, iters=50)
        log("kernel " + json.dumps(rec))
        failed += [] if rec["ok"] else [rec["shape"]]
        if dt == "bfloat16":
            main["decode_attention"] = rec
    if failed:
        raise SmokeFailure(f"kernel disagrees with its plain version at "
                           f"deepseek's or calibration's shapes: {failed}")
    return main


def unclipped_efficiencies(table) -> dict:
    """ideal / measured of each component before derive_table clips it to
    [MIN_EFFICIENCY, 1]: how far the clip hides the probe's rates."""
    from repro_torch.core.calibration import _ideal_host
    host = (table.host["flops_per_s"], table.host["bw_bytes_per_s"])
    ms, ke = table.measured_s, table.meta["kernel_energy"]

    def ratio(energy, t):
        return _ideal_host(energy["flops"], energy["bytes"], host) / t
    return {"expert": ratio(ke["expert_visit"], ms["expert_visit"]),
            "gateway_by_batch": {b: ratio(ke["gateway_by_batch"][b], t)
                                 for b, t in ms["gateway_by_batch"].items()},
            "head": ratio(ke["head_token"], ms["head_token"])}


def phase_calibration(torch) -> None:
    """(d) ``calibrate(impl="cuda")`` for both committed tables at their
    ctx_len and batches: the kernels launched, ``verify_table`` True, the
    measured seconds beside the committed (CPU) ones, the unclipped
    efficiencies, and each table as one JSON line."""
    from repro_torch.core import calibration as cal
    from repro_torch.kernels import ops
    for name in CALIBRATED:
        committed = cal.load_table(name)
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        table = cal.calibrate(name, committed.workload_obj(),
                              committed.ctx_len, committed.batches,
                              impl="cuda", device="cuda")
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        verified = cal.verify_table(table)
        log(f"calibration {name}: {wall:.2f}s wall, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
            f"gmm {counts['gmm']} decode_attention "
            f"{counts['decode_attention']}, impl {table.impl}, backend "
            f"{table.backend}, torch {table.jax_version}, verify_table "
            f"{verified}, hash {table.table_hash}")
        log(f"calibration {name}: host probe flops/s "
            f"{table.host['flops_per_s']:.6g}, bytes/s "
            f"{table.host['bw_bytes_per_s']:.6g}")
        for key in ("expert_visit", "head_token"):
            log(f"calibration {name}: measured_s {key} "
                f"{table.measured_s[key]:.6g} (committed CPU table "
                f"{committed.measured_s[key]:.6g})")
        for b, t in table.measured_s["gateway_by_batch"].items():
            log(f"calibration {name}: measured_s gateway B={b} {t:.6g} "
                f"(committed CPU table "
                f"{committed.measured_s['gateway_by_batch'][b]:.6g})")
        log(f"calibration {name}: efficiency {json.dumps(table.efficiency)}")
        log(f"calibration {name}: unclipped "
            f"{json.dumps(unclipped_efficiencies(table))}")
        log(f"calibration table {json.dumps(table.to_dict(), sort_keys=True)}")
        if not verified or counts["gmm"] == 0 \
                or counts["decode_attention"] == 0:
            raise SmokeFailure(f"calibration {name}: verify_table "
                               f"{verified}, launches {counts}")


# --------------------------------------------------------------------- #
# Phase 13: every attention-only architecture of the reference, EP slotting
# --------------------------------------------------------------------- #

GRANITE = "granite-moe-3b-a800m"
# The attention-only architectures one card holds whole in bf16, and the
# one it does not (smoke size only: the port has no sharding).
ONE_CARD_ARCHS = (GRANITE, "qwen2.5-3b", "smollm-135m", "minicpm-2b",
                  "llava-next-mistral-7b", "musicgen-medium")
SMOKE_ONLY_ARCHS = ("mistral-large-123b",)
SLOT_STEPS = 4        # decode steps of the slotted runs (13d)


def slotted_config(arch: str):
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), moe_slotting=True)


def phase_kernels_archs(torch) -> dict[str, dict]:
    """(13a) gmm and decode_attention against their plain versions at the
    new serve shapes: granite-moe-3b-a800m's 40 experts (decode: C floors
    at top_k; prefill at T = BATCH x PROMPT), slotted granite's 48 buckets
    and slotted llama-moe-3.5b's 16 half-experts of 688 (bf16, every one
    on the wgmma path); decode_attention at each one-card architecture's
    heads, S = 49 (serve) and S = 2048.  Returns the decode-shape records
    keyed "<kernel>/<arch>" ("gmm/<arch>/slotted" for a slotted stack)."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import capacity, slotting_for
    gmm_cases = []                         # (key of a decode shape, case)
    for cfg, tag in ((get_config(GRANITE), GRANITE),
                     (slotted_config(GRANITE), GRANITE + "/slotted"),
                     (slotted_config(ARCH), ARCH + "/slotted")):
        sl = slotting_for(cfg)
        n_b, e_cap, frag = ((sl.n_virtual, sl.e_pad, sl.frag) if sl
                            else (cfg.n_experts, cfg.n_experts, 1))
        d, f = cfg.d_model, cfg.d_ff_expert // frag
        for t, key in ((BATCH, "gmm/" + tag), (BATCH * PROMPT, None)):
            c = capacity(cfg, t, e_cap)
            gmm_cases += [(key, (n_b, c, d, f, "bfloat16")),
                          (None, (n_b, c, f, d, "bfloat16"))]
    last_pos = PROMPT + DECODE - 1
    attn_cases = []
    for arch in ONE_CARD_ARCHS:
        cfg = get_config(arch)
        heads = (BATCH, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads)
        attn_cases += [("decode_attention/" + arch,
                        (*heads, PROMPT + DECODE + 1, cfg.head_dim,
                         "bfloat16", [last_pos] * BATCH)),
                       (None, (*heads, 2048, cfg.head_dim, "bfloat16",
                               [2047, 1500, 1024, 17]))]
    main, failed = {}, []
    for key, case in gmm_cases:
        rec = check_gmm(torch, *case, iters=20)
        log("kernel " + json.dumps(rec))
        failed += [] if rec["ok"] and rec["path"] == "wgmma" \
            else [rec["shape"]]
        if key:
            main[key] = rec
    for key, (b, hkv, g, s, hd, dt, pos) in attn_cases:
        rec = check_decode(torch, b, hkv, g, s, hd, dt, pos, iters=50)
        log("kernel " + json.dumps(rec))
        failed += [] if rec["ok"] else [rec["shape"]]
        if key:
            main[key] = rec
    if failed:
        raise SmokeFailure(f"kernel disagrees with its plain version (or "
                           f"left the wgmma path) at the new shapes: {failed}")
    return main


def phase_serve_archs(torch, card: str) -> dict[str, dict]:
    """(13c) ``repro_torch.launch.serve`` for each one-card architecture at
    full width and depth (``--space-sim`` for granite-moe-3b-a800m), with
    phase 5's checks and launch counts, then phase 6's profile.  Returns
    each run's launch counts."""
    counts = {}
    for arch in ONE_CARD_ARCHS:
        t = time.perf_counter()
        extra = ("--space-sim",) if arch == GRANITE else ()
        counts[arch] = phase_serve(torch, card, arch, extra)
        phase_profile(torch, 4, arch)
        torch.cuda.empty_cache()
        log(f"phase serve_archs {arch}: {time.perf_counter() - t:.1f}s")
    return counts


def decode_run(torch, cfg, params, prompt, feed=None):
    """Prefill and SLOT_STEPS greedy decode steps on the model functions;
    with ``feed`` (B, 1 + SLOT_STEPS) the steps take those tokens instead
    of the model's own.  Returns (logits (1 + SLOT_STEPS, B, V) f32,
    greedy tokens (B, 1 + SLOT_STEPS), ms a decode step)."""
    from repro_torch.models import decode_step, prefill
    logits, cache = prefill(cfg, params, prompt,
                            max_len=PROMPT + SLOT_STEPS + 1)
    steps = [logits.float()]
    toks = [torch.argmax(logits, -1).to(torch.int32)[:, None]]
    pos = torch.full((BATCH,), PROMPT, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(SLOT_STEPS):
        tok = toks[-1] if feed is None else feed[:, i:i + 1]
        logits, cache = decode_step(cfg, params, cache, tok, pos)
        steps.append(logits.float())
        toks.append(torch.argmax(logits, -1).to(torch.int32)[:, None])
        pos = pos + 1
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / SLOT_STEPS
    return torch.stack(steps), torch.cat(toks, dim=1), ms


def slotted_launches(torch, cfg, what: str) -> dict[str, int]:
    """Launches since the last reset, checked against a prefill and
    SLOT_STEPS decode steps with every gmm launch on wgmma."""
    from repro_torch.kernels import moe_gmm, ops
    torch.cuda.synchronize()
    counts, paths = ops.launch_counts(), dict(moe_gmm.path_launches)
    want = serve_launches(cfg, passes=1 + SLOT_STEPS, decode_steps=SLOT_STEPS)
    log(f"slotting {what}: launches {json.dumps(counts)}, gmm by path "
        f"{json.dumps(paths)} (expected {json.dumps(want)}, all wgmma)")
    if {k: counts[k] for k in want} != want \
            or paths != {"wgmma": want["gmm"], "fma": 0}:
        raise SmokeFailure(f"slotting {what}: launches {counts}, paths "
                           f"{paths}, expected {want} all on wgmma")
    return counts


def recorded_run(torch, cfg, params, prompt, feed=None):
    """``decode_run`` that also records every MoE call: (layer, input,
    output) in call order, the layer found by its ``ffn`` dict."""
    from repro_torch.models import moe as moe_mod
    layer_of = {id(lp["ffn"]): i for i, lp in enumerate(params["layers"])}
    calls, real = [], moe_mod.moe_apply_local

    def recording(c, p, h, cdt):
        y, aux = real(c, p, h, cdt)
        calls.append((layer_of[id(p)], h, y))
        return y, aux
    moe_mod.moe_apply_local = recording
    try:
        return (*decode_run(torch, cfg, params, prompt, feed), calls)
    finally:
        moe_mod.moe_apply_local = real


def phase_slotting(torch) -> dict[str, dict]:
    """(13d) EP slotting at full width through the model functions (no
    placement, which a slotted stack refuses).  llama-moe-3.5b slotted
    (16 half-experts) against unslotted on the same canonical weights and
    the same tokens.  Gate: every MoE call of the unslotted run replayed
    through the slotted layer on the same input (so the same routing and
    the same dropped copies, both at capacity C(E' = 8)), within 2^-5 of
    that call's largest output: each half-expert's output, their sum
    and the combined output are bf16 roundings (each at most 2^-7
    relative), with room for halves larger than their sum.  Reported
    beside it: the two whole runs' logits (their error against
    n_layers x 2^-8 of the largest logit, one rounding of the residual
    stream a layer) and the routing choices that differ between them,
    which no rounding bound covers: near-tied router scores flip on the
    last bit of their input.  Slotted granite-moe-3b-a800m (48 buckets;
    its padded capacity differs from the unslotted model's, so the two
    drop different copies): launches, paths, finite logits and tokens
    in range.  Returns each slotted run's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params, random_batch
    from repro_torch.models.moe import (moe_apply_local, route,
                                        slotted_weights, slotting_for)
    out = {}
    cfg, scfg = get_config(ARCH), slotted_config(ARCH)
    sl = slotting_for(scfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, "cuda")
    names = ("w_gate", "w_up", "w_down")
    slotted = dict(params, layers=[
        dict(lp, ffn=dict(lp["ffn"], **dict(zip(names, slotted_weights(
            *(lp["ffn"][n] for n in names), sl)))))
        for lp in params["layers"]])
    prompt = {"tokens": random_batch(cfg, BATCH, PROMPT, seed=0,
                                     device="cuda")["tokens"]}
    ops.reset_launch_counts()
    want_l, want_t, ms0, calls0 = recorded_run(torch, cfg, params, prompt)
    slotted_launches(torch, cfg, f"{cfg.name} unslotted")
    ops.reset_launch_counts()
    got_l, got_t, ms1, calls1 = recorded_run(torch, scfg, slotted, prompt,
                                             feed=want_t)
    out[ARCH + "/slotted"] = slotted_launches(
        torch, scfg, f"{cfg.name} slotted ({sl.n_virtual} buckets)")

    cdt = torch.bfloat16
    worst, flips, choices = 0.0, 0, 0
    for (layer, h0, y0), (_, h1, _) in zip(calls0, calls1, strict=True):
        router = params["layers"][layer]["ffn"]["router"]
        idx0 = route(cfg, router, h0.reshape(-1, cfg.d_model).to(cdt))[1]
        idx1 = route(cfg, router, h1.reshape(-1, cfg.d_model).to(cdt))[1]
        flips += int((idx0.sort(-1)[0] != idx1.sort(-1)[0]).any(-1).sum())
        choices += idx0.shape[0]
        y, _ = moe_apply_local(scfg, slotted["layers"][layer]["ffn"], h0, cdt)
        worst = max(worst, float((y.float() - y0.float()).abs().max())
                    / float(y0.float().abs().max()))
    err = float((got_l - want_l).abs().max())
    scale = float(want_l.abs().max())
    tol = cfg.n_layers * 2.0 ** -8 * scale
    agree = float((got_t == want_t).float().mean())
    log(f"slotting {cfg.name}: {sl.n_virtual} buckets of d_ff "
        f"{cfg.d_ff_expert // sl.frag}; {len(calls0)} MoE calls replayed "
        f"on the unslotted run's inputs: worst max_abs_err / max|out| = "
        f"{worst:.6g} (tol 2^-5 = {2.0 ** -5:.6g}); whole runs: logits "
        f"max_abs_err={err:.6g} against {tol:.6g} = {cfg.n_layers} x 2^-8 "
        f"x max|logit| {scale:.6g} (within={err <= tol}), routing choices "
        f"that differ {flips} of {choices} token-layers, greedy tokens "
        f"agree {agree:.1%}; decode {ms1:.3f} ms a step slotted, "
        f"{ms0:.3f} unslotted; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not (bool(torch.isfinite(got_l).all()) and worst <= 2.0 ** -5):
        raise SmokeFailure(f"slotted {cfg.name} disagrees with unslotted on "
                           f"the same inputs: {worst} > 2^-5")
    del params, slotted, want_l, got_l, calls0, calls1
    torch.cuda.empty_cache()

    scfg = slotted_config(GRANITE)
    sl = slotting_for(scfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(scfg, gen, "cuda")
    prompt = {"tokens": random_batch(scfg, BATCH, PROMPT, seed=0,
                                     device="cuda")["tokens"]}
    ops.reset_launch_counts()
    logits, toks, ms = decode_run(torch, scfg, params, prompt)
    out[GRANITE + "/slotted"] = slotted_launches(
        torch, scfg, f"{scfg.name} slotted ({sl.n_virtual} buckets)")
    finite = bool(torch.isfinite(logits).all())
    in_range = 0 <= int(toks.min()) and int(toks.max()) < scfg.padded_vocab
    dummies = sl.e_pad - scfg.n_experts
    log(f"slotting {scfg.name}: {sl.n_virtual} buckets ({dummies} "
        f"dummies); logits {tuple(logits.shape)} finite="
        f"{finite}; tokens in range={in_range}; decode {ms:.3f} ms a step")
    if not (finite and in_range):
        raise SmokeFailure(f"slotted {scfg.name}: non-finite logits or "
                           "tokens out of range")
    del params
    torch.cuda.empty_cache()
    return out


def phase_archs(torch, card: str) -> tuple[dict, dict]:
    """Phase 13 (a-d): kernels at the new shapes, the smoke models card
    against CPU, the full-width serves, EP slotting.  Returns the 13a
    records and the launch counts by run ("<arch>", "<arch>/slotted")."""
    seconds = {}

    def step(name, fn, *args):
        t = time.perf_counter()
        got = fn(*args)
        seconds[name] = round(time.perf_counter() - t, 1)
        return got

    cases = step("13a", phase_kernels_archs, torch)
    for arch in (*ONE_CARD_ARCHS, *SMOKE_ONLY_ARCHS):
        step("13b " + arch, phase_small, torch, arch)
    for arch in (ARCH, GRANITE):
        step(f"13b {arch} slotted", phase_small, torch, arch, True)
    counts = step("13c", phase_serve_archs, torch, card)
    counts.update(step("13d", phase_slotting, torch))
    log(f"phase 13 seconds {json.dumps(seconds)}")
    return cases, counts


# --------------------------------------------------------------------- #
# Phase 14: the recurrent mixers (xlstm-350m, jamba-1.5-large-398b)
# --------------------------------------------------------------------- #

XLSTM = "xlstm-350m"
JAMBA = "jamba-1.5-large-398b"
# jamba's three block kinds, each one block at published width (14c): a
# unit's positions 0 (Mamba + MoE), 1 (Mamba + dense) and 4 (attention +
# MoE).
JAMBA_BLOCKS = {"mamba+moe": 0, "mamba+dense": 1, "attn+moe": 4}


def mlstm_update_ms(torch) -> tuple[float, float]:
    """(device ms, bound ms) of one mLSTM state update
    (``ssm._mlstm_memory``) at xlstm-350m's decode shape: C (B, NH, dh, dh)
    f32 read and written, n, k and v beside it."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    cfg = get_config(XLSTM)
    nh, dh = cfg.n_heads, cfg.d_inner // cfg.n_heads
    gen = torch.Generator(device="cuda").manual_seed(3)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device="cuda")
    c, n = rand(BATCH, nh, dh, dh), rand(BATCH, nh, dh)
    f_g, i_g, k, v = rand(BATCH, nh), rand(BATCH, nh), rand(BATCH, nh, dh), \
        rand(BATCH, nh, dh)
    ms, _, _ = time_ms(torch, lambda: ssm._mlstm_memory(c, n, f_g, i_g, k, v),
                       iters=50)
    nbytes = 4 * (2 * c.numel() + 2 * n.numel() + 2 * k.numel()
                  + 2 * f_g.numel())
    return ms, bound(nbytes, 3.0 * c.numel(), "float32")[0]


def phase_xlstm(torch, card: str) -> dict[str, int]:
    """(14a) ``serve --arch xlstm-350m`` at published width and depth with
    phase 5's checks (no gmm, no decode_attention: the model has no MoE
    and no attention), its bound counting the mLSTM memory each step reads
    and writes; then a profiled step with the mLSTM state update
    (``ssm._mlstm_memory``) as a labelled range, beside the update timed
    alone.  Returns the serve run's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.launch.roofline import block_specs
    from repro_torch.models import ssm
    counts = phase_serve(torch, card, XLSTM)
    label = "mlstm_state_update"
    prof = phase_profile(torch, 4, XLSTM, ranges={label: (ssm, "_mlstm_memory")})
    cfg = get_config(XLSTM)
    n_mlstm = sum(spec.mixer == "mlstm" for spec in block_specs(cfg))
    alone, upd_bound = mlstm_update_ms(torch)
    in_prof = prof["ranges"].get(label, 0.0)
    log(f"xlstm mLSTM state update: {in_prof:.4f} ms a step in the profile "
        f"({in_prof / prof['kernel_ms']:.1%} of {prof['kernel_ms']:.3f} ms of "
        f"kernels, {prof['launches']:.0f} launches a step, busy "
        f"{prof['kernel_ms'] / prof['wall_ms']:.1%}); timed alone "
        f"{alone:.5f} ms a call x {n_mlstm} layers = {alone * n_mlstm:.4f} "
        f"ms a step ({alone * n_mlstm / prof['kernel_ms']:.1%} of the "
        f"profiled kernels), bound {upd_bound:.5f} ms a call (C read and "
        f"written)")
    if in_prof <= 0.0:
        raise SmokeFailure("the profile shows no kernel time in the mLSTM "
                           "state update")
    return counts


def jamba_kernel_cases(torch) -> list[tuple[dict, str]]:
    """(14c) gmm at jamba's full-width expert stacks, x(16, C, 8192) .
    w(16, 8192, 24576) and x(16, C, 24576) . w(16, 24576, 8192) bf16 (3.2e9
    elements of w, past 2^31) at decode C = 2 and prefill C = 20, against
    ``torch.bmm``; decode_attention at q(4, 8, 8, 128), S = 49 and 2048,
    against SDPA.  Returns (name, record, key): a gmm case's key is its
    "(x shape)x(w shape)", decode_attention's "serve" at serve's S."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import capacity
    cfg = get_config(JAMBA)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    out, failed = [], []
    for t in (BATCH, BATCH * PROMPT):
        c = capacity(cfg, t, e)
        for k, n in ((d, f), (f, d)):
            rec = check_gmm(torch, e, c, k, n, "bfloat16", iters=20)
            log("kernel " + json.dumps(rec))
            failed += [] if rec["ok"] and rec["path"] == "wgmma" \
                else [rec["shape"]]
            out.append(("gmm", rec, f"{(e, c, k)}x{(e, k, n)}"))
            torch.cuda.empty_cache()
    heads = (BATCH, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads)
    for s, pos in ((PROMPT + DECODE + 1, [PROMPT + DECODE - 1] * BATCH),
                   (2048, [2047, 1500, 1024, 17])):
        rec = check_decode(torch, *heads, s, cfg.head_dim, "bfloat16", pos,
                           iters=50)
        log("kernel " + json.dumps(rec))
        failed += [] if rec["ok"] else [rec["shape"]]
        out.append(("decode_attention", rec,
                    "serve" if s == PROMPT + DECODE + 1 else "long"))
    if failed:
        raise SmokeFailure(f"kernel disagrees with its plain version (or "
                           f"left the wgmma path) at jamba's shapes: {failed}")
    return out


def jamba_block(torch, card: str, kind: str) -> dict:
    """One jamba block at published width on the card: drawn through
    ``_block_init`` and ``cast_for_compute``, prefill of BATCH x PROMPT
    random bf16 inputs and DECODE decode steps through ``_apply_block``,
    every gmm call recorded and replayed against ``kernels/ref.py``'s
    plain version on the same inputs (2^-5 of the call's largest output).
    Returns its launch counts and gmm launches by (x, w) shape."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import moe_gmm, ops
    from repro_torch.kernels.ref import gmm_ref
    from repro_torch.launch import roofline as rl
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.model import (Parallel, _apply_block,
                                          _block_cache, _block_init,
                                          cast_for_compute)
    cfg = get_config(JAMBA)
    spec = cfg.pattern[JAMBA_BLOCKS[kind]]
    cdt = dtype_of(cfg.compute_dtype)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t = time.perf_counter()
    bp = cast_for_compute(cfg, _block_init(gen, cfg, spec,
                                           dtype_of(cfg.param_dtype), "cuda"))
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t
    draw_peak = torch.cuda.max_memory_allocated() / 2**30

    def leaves(node):
        if isinstance(node, dict):
            return [x for v in node.values() for x in leaves(v)]
        return [node]
    nbytes = sum(w.numel() * w.element_size() for w in leaves(bp))
    _, state_bytes = rl.mixer_bytes(cfg, spec.mixer, BATCH)
    x = torch.randn(BATCH, PROMPT, cfg.d_model, generator=gen,
                    device="cuda").to(cdt)
    xs = torch.randn(DECODE, BATCH, 1, cfg.d_model, generator=gen,
                     device="cuda").to(cdt)
    positions = torch.arange(PROMPT, dtype=torch.int32,
                             device="cuda")[None].expand(BATCH, PROMPT)
    cache = _block_cache(cfg, spec, BATCH, PROMPT + DECODE + 1, cdt,
                         torch.device("cuda"))
    calls, real = [], ops.gmm

    def recording(a, w):
        out = real(a, w)
        calls.append((a, w, out))
        return out
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    ops.gmm = recording
    try:
        y, cache, _ = _apply_block(cfg, spec, bp, x, positions, Parallel(),
                                   cdt, cache, "prefill")
        outs = [y]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(DECODE):
            pos = torch.full((BATCH,), PROMPT + i, dtype=torch.int32,
                             device="cuda")
            y, cache, _ = _apply_block(cfg, spec, bp, xs[i], pos, Parallel(),
                                       cdt, cache, "decode")
            outs.append(y)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / DECODE
    finally:
        ops.gmm = real
    counts, paths = ops.launch_counts(), dict(moe_gmm.path_launches)
    run_peak = torch.cuda.max_memory_allocated() / 2**30
    n_gmm = 3 * (1 + DECODE) if spec.ffn == "moe" else 0
    want = {"gmm": n_gmm,
            "decode_attention": DECODE if spec.mixer == "attn" else 0}
    worst = 0.0
    by_shape: dict[str, int] = {}
    for a, w, out in calls:
        ref = gmm_ref(a, w).float()
        worst = max(worst, float((out.float() - ref).abs().max())
                    / float(ref.abs().max()))
        key = f"{tuple(a.shape)}x{tuple(w.shape)}"
        by_shape[key] = by_shape.get(key, 0) + 1
        del ref
    finite = all(bool(torch.isfinite(o).all()) for o in outs)
    step_bound = (nbytes + state_bytes) / rl.HBM_BW * 1e3
    ffn = (f"{cfg.n_experts} experts of {cfg.d_ff_expert}"
           if spec.ffn == "moe" else f"d_ff {cfg.d_ff}")
    log(f"jamba block {kind} ({spec.mixer} + {spec.ffn}, d_model "
        f"{cfg.d_model}, {ffn}) on {card}: {nbytes / 1e9:.3f} GB of weights drawn in {draw_s:.1f}s "
        f"(draw peak {draw_peak:.2f} GiB, run peak {run_peak:.2f} GiB); "
        f"decode {ms:.3f} ms a step against a {step_bound:.3f} ms bound "
        f"(weights{' and state' if state_bytes else ''} at 3.35 TB/s); "
        f"launches {json.dumps({k: counts[k] for k in want})} (expected "
        f"{json.dumps(want)}), gmm by path {json.dumps(paths)}; "
        f"{len(calls)} gmm calls replayed against gmm_ref: worst "
        f"max_abs_err / max|out| = {worst:.6g} (tol 2^-5); outputs finite "
        f"{finite}")
    if {k: counts[k] for k in want} != want \
            or paths != {"wgmma": n_gmm, "fma": 0}:
        raise SmokeFailure(f"jamba block {kind}: launches {counts}, paths "
                           f"{paths}, expected {want} all on wgmma")
    if not finite or worst > 2.0 ** -5:
        raise SmokeFailure(f"jamba block {kind}: non-finite outputs or a gmm "
                           f"call off its plain version ({worst} > 2^-5)")
    del bp, cache, calls, outs, x, xs
    torch.cuda.empty_cache()
    return {"counts": {k: counts[k] for k in want}, "by_shape": by_shape}


def phase_recurrent(torch, card: str) -> tuple[list, dict]:
    """Phase 14 (a-c): xlstm-350m served at full width, both architectures'
    smoke models card against CPU and jamba's smoke serve with step 4,
    jamba's kernel shapes and its three block kinds at published width.
    Returns the jamba kernel rows (name, record, launches in 14c) and the
    launch counts by run ("xlstm-350m", "jamba-1.5-large-398b/smoke",
    "jamba-1.5-large-398b/blocks")."""
    seconds, counts = {}, {}

    def step(name, fn, *args, **kw):
        t = time.perf_counter()
        got = fn(*args, **kw)
        seconds[name] = round(time.perf_counter() - t, 1)
        return got

    counts[XLSTM] = step("14a", phase_xlstm, torch, card)
    torch.cuda.empty_cache()
    for arch in (XLSTM, JAMBA):
        step("14b " + arch, phase_small, torch, arch)
    counts[JAMBA + "/smoke"] = step("14b serve " + JAMBA, phase_serve, torch,
                                    card, JAMBA, ("--space-sim",), smoke=True)
    cases = step("14c kernels", jamba_kernel_cases, torch)
    blocks = {kind: step("14c " + kind, jamba_block, torch, card, kind)
              for kind in JAMBA_BLOCKS}
    total = {k: sum(b["counts"][k] for b in blocks.values())
             for k in ("gmm", "decode_attention")}
    shapes: dict[str, int] = {}
    for b in blocks.values():
        for key, n in b["by_shape"].items():
            shapes[key] = shapes.get(key, 0) + n
    log(f"jamba blocks: launches {json.dumps(total)} (expected gmm 102, "
        f"decode_attention 16); gmm launches by shape {json.dumps(shapes)}")
    if total != {"gmm": 3 * 2 * (1 + DECODE), "decode_attention": DECODE}:
        raise SmokeFailure(f"jamba blocks: launches {total}")
    counts[JAMBA + "/blocks"] = total
    rows = [(name, rec, shapes.get(key, 0) if name == "gmm"
             else total["decode_attention"] * (key == "serve"))
            for name, rec, key in cases]
    log(f"phase 14 seconds {json.dumps(seconds)}")
    return rows, counts


# --------------------------------------------------------------------- #
# Phase 15: training (granite-moe-3b-a800m at published width)
# --------------------------------------------------------------------- #

# The full-width train run (15c): batch x sequence from SyntheticTokens,
# a cosine schedule with TRAIN_WARMUP warmup steps over TRAIN_STEPS.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_WARMUP = 4, 2048, 6, 2
TRAIN_LR = 3e-4               # AdamWConfig's default peak rate
# The MoE FFN's products a layer, by the kernel's (E, C, K, N) call as a
# function of the config's (E, C, d, f): forward gate/up (2 a layer) and
# down (1), each run twice under unit remat; dx and dw of each.
TRAIN_PRODUCTS = {
    "forward gate/up": (lambda e, c, d, f: (e, c, d, f), 2 * 2),
    "forward down": (lambda e, c, d, f: (e, c, f, d), 2 * 1),
    "dx gate/up": (lambda e, c, d, f: (e, c, f, d), 2),
    "dw gate/up": (lambda e, c, d, f: (e, d, c, f), 2),
    "dx down": (lambda e, c, d, f: (e, c, d, f), 1),
    "dw down": (lambda e, c, d, f: (e, f, c, d), 1),
}


def train_shapes(cfg) -> tuple[int, dict[tuple, int]]:
    """(C, {kernel call (E, C, K, N): launches a MoE layer}) of a train step
    at TRAIN_BATCH x TRAIN_SEQ tokens."""
    from repro_torch.models.moe import capacity
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    c = capacity(cfg, TRAIN_BATCH * TRAIN_SEQ, e)
    shapes: dict[tuple, int] = {}
    for shape_of, n in TRAIN_PRODUCTS.values():
        key = shape_of(e, c, d, f)
        shapes[key] = shapes.get(key, 0) + n
    return c, shapes


def train_gmm_autograd(torch, e, c, d, f, which: str) -> dict:
    """One ``gmm`` of the MoE FFN with its backward through the kernel
    (``GmmFunction``) against autograd through ``gmm_plain`` on the card,
    out, dx and dw each within 2^-7 of its largest value; the backward's
    time (two operand copies and two products) by CUDA events."""
    from repro_torch.kernels import moe_gmm
    k, n = (d, f) if which == "gate/up" else (f, d)
    gen = torch.Generator(device="cuda").manual_seed(k)
    x = torch.randn(e, c, k, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(e, k, n, generator=gen, device="cuda") / k ** 0.5) \
        .to(torch.bfloat16)
    dy = torch.randn(e, c, n, generator=gen, device="cuda").to(torch.bfloat16)
    got = {}
    for name, fn in (("kernel", moe_gmm.gmm), ("plain", moe_gmm.gmm_plain)):
        xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        before = dict(moe_gmm.path_launches)
        y = fn(xr, wr)
        dx, dw = torch.autograd.grad(y, (xr, wr), dy, retain_graph=True)
        torch.cuda.synchronize()
        paths = {p: moe_gmm.path_launches[p] - before[p] for p in before}
        got[name] = (y, dx, dw, paths, xr, wr)
    errs = {}
    for i, part in enumerate(("out", "dx", "dw")):
        a, b = got["kernel"][i].detach().float(), got["plain"][i].detach().float()
        errs[part] = float((a - b).abs().max()) / float(b.abs().max())
    y, xr, wr = got["kernel"][0], got["kernel"][4], got["kernel"][5]
    bwd_ms, _, _ = time_ms(torch, lambda: torch.autograd.grad(
        y, (xr, wr), dy, retain_graph=True), iters=10)
    rec = {"product": which, "x": [e, c, k], "w": [e, k, n],
           "paths": got["kernel"][3], "rel_err": errs, "tol": 2.0 ** -7,
           "backward_ms": bwd_ms}
    rec["ok"] = max(errs.values()) <= 2.0 ** -7 \
        and rec["paths"] == {"wgmma": 3, "fma": 0}
    return rec


def train_kernel_cases(torch, cfg) -> dict[tuple, dict]:
    """(15a) gmm at the train step's calls (each distinct (E, C, K, N)
    once: forward gate/up and dx down share one, forward down and dx
    gate/up another), timed beside ``torch.bmm`` and the bound, and the
    Function's forward and backward against the plain version's autograd
    for both projections."""
    c, shapes = train_shapes(cfg)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    recs, failed = {}, []
    for key in shapes:
        rec = check_gmm(torch, *key, "bfloat16", iters=10)
        log("kernel " + json.dumps(rec))
        failed += [] if rec["ok"] and rec["path"] == "wgmma" \
            else [rec["shape"]]
        recs[key] = rec
        torch.cuda.empty_cache()
    for name, (shape_of, _) in TRAIN_PRODUCTS.items():
        rec = recs[shape_of(e, c, d, f)]
        log(f"train gmm {name}: x{tuple(shape_of(e, c, d, f)[:3])} "
            f"path {rec['path']}, {rec['ms']:.4f} ms (bmm "
            f"{rec['library_ms']:.4f}, plain {rec['plain_ms']:.4f}, bound "
            f"{rec['bound_ms']:.4f} {rec['bound_by']})")
    for which in ("gate/up", "down"):
        rec = train_gmm_autograd(torch, e, c, d, f, which)
        log("train gmm autograd " + json.dumps(rec))
        failed += [] if rec["ok"] else [f"autograd {which}"]
        torch.cuda.empty_cache()
    if failed:
        raise SmokeFailure(f"gmm's training products disagree with the "
                           f"plain version or left wgmma: {failed}")
    return recs


def train_smoke_card_vs_cpu(torch, arch: str) -> None:
    """(15b) three train steps of ``arch``'s smoke model (f32 compute:
    gmm's fma path) on the card against the CPU, the same master weights
    and batches: losses within rtol 1e-5, params within atol 1e-4 (TF32
    off; index-put backwards sum with atomics on the card)."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.roofline import block_specs
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Parallel, init_params
    from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule
    from repro_torch.tree import tree_leaves, tree_map
    cfg = smoke_config(arch)
    master = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                         cast=False)
    gen = torch.Generator().manual_seed(1)
    batches = [torch.randint(0, cfg.vocab_size, (BATCH, 16), generator=gen,
                             dtype=torch.int32) for _ in range(3)]
    out = {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda p: p.clone().to(dev), master)
        state = adamw_init(params)
        step = make_train_step(cfg, Parallel(), AdamWConfig(lr=1e-2),
                               cosine_schedule(1, 3))
        ops.reset_launch_counts()
        losses = []
        for toks in batches:
            toks = toks.to(dev)
            params, state, met = step(params, state,
                                      {"tokens": toks, "labels": toks})
            losses.append(float(met["loss"]))
        out[dev] = (losses, tree_leaves(params), ops.launch_counts()["gmm"])
    n_moe = sum(s.ffn == "moe" for s in block_specs(cfg))
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(out["cuda"][0],
                                                      out["cpu"][0]))
    p_err = max(float((a.cpu() - b).abs().max())
                for a, b in zip(out["cuda"][1], out["cpu"][1]))
    log(f"train smoke {cfg.name} (f32): losses card {out['cuda'][0]} vs CPU "
        f"{out['cpu'][0]}, rel err {loss_err:.3g} (tol 1e-5); params max "
        f"abs err {p_err:.3g} (tol 1e-4); gmm launches {out['cuda'][2]} "
        f"(expected {3 * 12 * n_moe})")
    if loss_err > 1e-5 or p_err > 1e-4 or out["cuda"][2] != 3 * 12 * n_moe:
        raise SmokeFailure(f"train smoke {arch}: card disagrees with the CPU")


def train_resume(torch) -> None:
    """(15b) ``python -m repro_torch.launch.train --smoke`` on the card with
    a checkpoint directory under build/: a run that ``--simulate-failure``
    ends (exit 42) in a subprocess, the re-launch that resumes from its
    checkpoint, and an uninterrupted run; the resumed losses within rtol
    1e-5 of the uninterrupted run's (bitwise on the CPU, the tests)."""
    import os
    import shutil

    from repro_torch.launch import train
    ckpt = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = ["--smoke", "--arch", GRANITE, "--device", "cuda", "--steps", "6",
            "--batch", "2", "--seq", "32", "--ckpt-every", "2",
            "--log-every", "1", "--ckpt-dir", str(ckpt)]
    t = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *argv, "--simulate-failure", "3"], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=300)
    sub_s = time.perf_counter() - t
    for line in res.stdout.splitlines():
        log(f"train (killed run): {line}")
    if res.returncode != train.FAILURE_EXIT_CODE \
            or "[failure-sim] hard exit at step 3" not in res.stdout:
        raise SmokeFailure(f"launch.train --simulate-failure exited "
                           f"{res.returncode}: {res.stderr[-2000:]}")
    resumed = train.main(argv)
    full = train.main(argv[:-2])
    shutil.rmtree(ckpt, ignore_errors=True)
    err = max(abs(a - b) / abs(b) for a, b in zip(resumed["losses"],
                                                 full["losses"][2:]))
    log(f"train resume ({GRANITE} smoke on the card): killed run exit "
        f"{res.returncode} in {sub_s:.1f}s; resumed losses "
        f"{resumed['losses']} vs uninterrupted {full['losses'][2:]}: rel err "
        f"{err:.3g} (tol 1e-5); uninterrupted loss {full['losses'][0]:.4f} "
        f"-> {full['final_loss']:.4f}")
    if len(resumed["losses"]) != 4 or err > 1e-5:
        raise SmokeFailure("launch.train's resume does not repeat the "
                           "uninterrupted run")


def profiled_train_step(torch, step_fn, params, state, batch) -> dict:
    """One train step under the profiler, its device time split by region:
    marker launches (one-cycle spins, in stream order) open and close the
    forward, backward and AdamW phases, every ``GmmFunction`` forward and
    backward (operand copies included) and every attention call (forward
    and remat recompute by a wrapper of ``flash_attention``, backward by
    hooks on its output and inputs); each kernel goes to the innermost
    open region."""
    from torch.autograd import DeviceType

    from repro_torch.kernels import moe_gmm
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import attention as attn
    marks: list[str] = []

    def mark(label):
        torch.cuda._sleep(1)
        marks.append(label)

    real_fwd, real_bwd = moe_gmm.GmmFunction.forward, moe_gmm.GmmFunction.backward
    real_attn, real_loss = attn.flash_attention, steps_mod.loss_fn
    real_adam = steps_mod.adamw_update

    def gmm_fwd(ctx, x, w):
        mark("+gmm forward")
        out = real_fwd(ctx, x, w)
        mark("-")
        return out

    def gmm_bwd(ctx, dy):
        mark("+gmm backward")
        out = real_bwd(ctx, dy)
        mark("-")
        return out

    def flash(cfg, q, k, v, qpos, kpos):
        mark("+attention forward")
        out = real_attn(cfg, q, k, v, qpos, kpos)
        mark("-")
        if out.requires_grad:
            left = [sum(t.requires_grad for t in (q, k, v))]

            def closed(grad):
                left[0] -= 1
                if left[0] == 0:
                    mark("-")
            out.register_hook(lambda g: mark("+attention backward"))
            for t in (q, k, v):
                if t.requires_grad:
                    t.register_hook(closed)
        return out

    def loss(*args, **kw):
        mark("+forward")
        out = real_loss(*args, **kw)
        mark("-")
        mark("+backward")
        return out

    def adam(*args, **kw):
        mark("-")
        mark("+adamw")
        out = real_adam(*args, **kw)
        mark("-")
        return out
    moe_gmm.GmmFunction.forward = staticmethod(gmm_fwd)
    moe_gmm.GmmFunction.backward = staticmethod(gmm_bwd)
    attn.flash_attention = flash
    steps_mod.loss_fn, steps_mod.adamw_update = loss, adam
    try:
        with primed_profile(torch) as prof:
            t0 = time.perf_counter()
            params, state, met = step_fn(params, state, batch)
            float(met["loss"])
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        moe_gmm.GmmFunction.forward = staticmethod(real_fwd)
        moe_gmm.GmmFunction.backward = staticmethod(real_bwd)
        attn.flash_attention = real_attn
        steps_mod.loss_fn, steps_mod.adamw_update = real_loss, real_adam
    kernels = sorted((evt for evt in prof.events()
                      if evt.device_type == DeviceType.CUDA),
                     key=lambda evt: evt.time_range.start)
    spins = [i for i, evt in enumerate(kernels) if PRIMER_KERNEL in evt.name]
    split: dict[str, float] | None = None
    if len(spins) >= len(marks):
        marker_at = dict(zip(spins[len(spins) - len(marks):], marks))
        first = min(marker_at)
        split, stack, launches = {}, [], 0
        for i, evt in enumerate(kernels[first:], start=first):
            if i in marker_at:
                if marker_at[i] != "-":
                    stack.append(marker_at[i][1:])
                elif stack:
                    stack.pop()
                else:
                    split = None         # markers out of order
                    break
            elif PRIMER_KERNEL not in evt.name:
                region = stack[-1] if stack else "outside"
                split[region] = split.get(region, 0.0) \
                    + evt.device_time_total / 1e3
                launches += 1
    if split is None:
        raise SmokeFailure(f"train profile: {len(spins)} spin records for "
                           f"{len(marks)} markers, or markers out of order: "
                           f"the step's device time cannot be split")
    busy = sum(split.values())
    log(f"train profile ({len(marks)} markers): step {wall_ms:.1f} ms wall "
        f"under the profiler, kernels {busy:.1f} ms ({launches} launches) -> "
        f"busy {busy / wall_ms:.1%}")
    for region, ms in sorted(split.items(), key=lambda kv: -kv[1]):
        log(f"train profile:   {ms:9.2f} ms {ms / busy:6.1%}  {region}")
    top = {}
    for evt in kernels[first:]:
        if PRIMER_KERNEL not in evt.name:
            top[evt.name] = top.get(evt.name, 0.0) + evt.device_time_total / 1e3
    for name, ms in sorted(top.items(), key=lambda kv: -kv[1])[:10]:
        log(f"train profile kernel: {ms:9.2f} ms  {name[:90]}")
    return {"wall_ms": wall_ms, "kernel_ms": busy, "launches": launches,
            "split": split}


def train_full_width(torch, card: str) -> dict:
    """(15c) granite-moe-3b-a800m trained at published width: f32 master
    weights drawn on the card, TRAIN_BATCH x TRAIN_SEQ tokens a step from
    ``SyntheticTokens``, ``make_train_step`` with AdamW on a cosine
    schedule.  Gates: every loss, ce, aux and grad norm finite, the last
    loss below the first, gmm TRAIN_STEPS x 384 launches all on wgmma and
    no decode_attention.  Prints seconds a step, tok/s, the bound, peak
    memory and a profiled step.  Returns gmm launches by call shape over
    the TRAIN_STEPS steps."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokens, make_batch
    from repro_torch.kernels import moe_gmm, ops
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.roofline import block_specs
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Parallel, init_params
    from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule
    from repro_torch.tree import tree_leaves
    cfg = get_config(GRANITE)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda", cast=False)
    state = adamw_init(params)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(params))
    static_gib = torch.cuda.memory_allocated() / 2**30
    draw_s = time.perf_counter() - t
    bnd = rl.train_step_bound(cfg, n_params, TRAIN_BATCH, TRAIN_SEQ)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH, seed=0))
    step_fn = make_train_step(cfg, Parallel(), AdamWConfig(lr=TRAIN_LR),
                              cosine_schedule(TRAIN_WARMUP, TRAIN_STEPS))
    batches = [{k: torch.as_tensor(v, device="cuda")
                for k, v in make_batch(cfg, data, s).items()}
               for s in range(TRAIN_STEPS + 1)]
    c, shapes = train_shapes(cfg)
    n_moe = sum(s.ffn == "moe" for s in block_specs(cfg))
    per_step = sum(shapes.values()) * n_moe
    calls: dict[tuple, int] = {}
    real = moe_gmm._product

    def counted(x, w):
        key = (*x.shape, w.shape[2])
        calls[key] = calls.get(key, 0) + 1
        return real(x, w)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    moe_gmm._product = counted
    rows, secs = [], []
    try:
        for s in range(TRAIN_STEPS):
            t = time.perf_counter()
            params, state, met = step_fn(params, state, batches[s])
            m = {k: float(v) for k, v in met.items()}
            secs.append(time.perf_counter() - t)
            rows.append(m)
            log(f"train {cfg.name} step {s}: loss {m['loss']:.4f} ce "
                f"{m['ce']:.4f} aux {m['aux']:.4f} gnorm {m['grad_norm']:.4f} "
                f"{secs[-1]:.3f}s ({TRAIN_BATCH * TRAIN_SEQ / secs[-1]:,.0f} "
                f"tok/s)")
    finally:
        moe_gmm._product = real
    counts, paths = ops.launch_counts(), dict(moe_gmm.path_launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    steady = sorted(secs[1:])[len(secs[1:]) // 2]
    log(f"train {cfg.name} at published width on {card}: {n_params / 1e9:.3f}"
        f" B params, {n_params * 16 / 2**30:.2f} GiB of f32 params, grads and "
        f"moments (params + moments {static_gib:.2f} GiB drawn in "
        f"{draw_s:.1f}s); {TRAIN_BATCH}x{TRAIN_SEQ} tokens a step, C = {c}; "
        f"median step (1-{TRAIN_STEPS - 1}) {steady:.3f}s = "
        f"{TRAIN_BATCH * TRAIN_SEQ / steady:,.0f} tok/s, step 0 "
        f"{secs[0]:.3f}s; bound {bnd['bound_ms']:.1f} ms = "
        f"{bnd['step_tflop']:.2f} TFLOP at 989 TFLOP/s ({bnd['ops_ms']:.1f} "
        f"ms: forward {bnd['forward_tflop']:.2f} TFLOP = {cfg.n_layers} x "
        f"(gmm over T*K routed rows {bnd['gmm_gflop_layer']:.1f} + q/k/v/o "
        f"{bnd['proj_gflop_layer']:.1f} + causal attention "
        f"{bnd['attn_gflop_layer']:.1f} GFLOP + router) + head "
        f"{bnd['head_gflop']:.0f} GFLOP; x3 for forward and backward, + one "
        f"remat forward of the layers) + AdamW {bnd['adamw_gb']:.1f} GB at "
        f"3.35 TB/s ({bnd['bytes_ms']:.1f} ms) -> "
        f"{TRAIN_BATCH * TRAIN_SEQ / bnd['bound_ms'] * 1e3:,.0f} tok/s; "
        f"step at {bnd['bound_ms'] / 1e3 / steady:.1%} of the bound; peak "
        f"memory {peak_gib:.2f} GiB")
    want_calls = {k: n * n_moe * TRAIN_STEPS for k, n in shapes.items()}
    log(f"train launches over {TRAIN_STEPS} steps: {json.dumps(counts)}; gmm "
        f"by path {json.dumps(paths)}; gmm by call (E, C, K, N) "
        f"{json.dumps({str(k): v for k, v in calls.items()})}; expected "
        f"{per_step} gmm a step")
    finite = all(math.isfinite(v) for row in rows for v in row.values())
    if not finite or rows[-1]["loss"] >= rows[0]["loss"]:
        raise SmokeFailure(f"train {cfg.name}: losses not finite or not "
                           f"falling: {[r['loss'] for r in rows]}")
    if counts["gmm"] != per_step * TRAIN_STEPS \
            or paths != {"wgmma": per_step * TRAIN_STEPS, "fma": 0} \
            or counts["decode_attention"] != 0 or calls != want_calls:
        raise SmokeFailure(f"train {cfg.name}: launches {counts}, paths "
                           f"{paths}, calls {calls}; expected {want_calls}")
    prof = profiled_train_step(torch, step_fn, params, state,
                               batches[TRAIN_STEPS])
    del params, state, batches
    torch.cuda.empty_cache()
    return {"calls": calls, "counts": counts, "secs": secs, "peak": peak_gib,
            "profile": prof, "n_params": n_params, "step_s": steady}


def phase_train(torch, card: str) -> tuple[list[tuple[str, dict, int]], dict]:
    """Phase 15 (a-c).  Returns the kernel rows (name, record, launches over
    15c's run) of 15a's shapes, and 15c's parameter count and median
    seconds a step."""
    from repro_torch.configs import get_config
    seconds = {}

    def step(name, fn, *args):
        t = time.perf_counter()
        got = fn(*args)
        seconds[name] = round(time.perf_counter() - t, 1)
        return got

    cfg = get_config(GRANITE)
    recs = step("15a", train_kernel_cases, torch, cfg)
    for arch in (GRANITE, ARCH):
        step("15b " + arch, train_smoke_card_vs_cpu, torch, arch)
    step("15b resume", train_resume, torch)
    run = step("15c", train_full_width, torch, card)
    log(f"phase 15 seconds {json.dumps(seconds)}")
    return [("gmm", rec, run["calls"].get(key, 0)) for key, rec in recs.items()], \
        {"n_params": run["n_params"], "step_s": run["step_s"]}


# --------------------------------------------------------------------- #
# Phase 17: the dry run (launch/dryrun.py, op_analysis, roofline)
# --------------------------------------------------------------------- #


def phase_dryrun(torch, card: str, counted: dict, train_run: dict) -> None:
    """(a) phase 6e's deepseek-moe-16b decode step as counted on the card
    (``phase_profile(count=True)``) against the same step counted on
    ``meta`` tensors: flops, bytes and kernel counts equal, and the
    card's launch counters equal to the kernel counts; (b) ``python -m
    repro_torch.launch.dryrun`` for deepseek-moe-16b at decode_32k on the
    pod mesh in a subprocess (the fake group of 256 ranks on this
    machine's torch) writes an ``ok`` record; (c) the roofline bound of
    (a)'s step from its counted flops and bytes beside its ms a step,
    and ``roofline.train_step_bound`` of phase 15c's step beside its
    seconds a step."""
    import os

    from repro_torch.configs import get_config
    from repro_torch.launch import op_analysis
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import Parallel, init_cache, init_params
    cfg = get_config(DEEPSEEK)
    on_card, launches = counted["cost"], counted["launches"]
    params = init_params(cfg, torch.Generator(), "meta")
    cache = init_cache(cfg, BATCH, counted["cache_len"], "meta")
    tok = torch.empty((BATCH, 1), dtype=torch.int32, device="meta")
    pos = torch.empty((BATCH,), dtype=torch.int32, device="meta")
    t = time.perf_counter()
    on_meta, _ = op_analysis.analyze(make_serve_step(cfg, Parallel()), params,
                                     cache, tok, pos, None)
    meta_s = time.perf_counter() - t
    same = {"flops": on_card.flops == on_meta.flops,
            "bytes": on_card.bytes_accessed == on_meta.bytes_accessed,
            "kernels": on_card.kernel_counts == on_meta.kernel_counts,
            "ops": on_card.op_counts == on_meta.op_counts}
    log(f"dryrun (a) {cfg.name} decode step at batch {BATCH}, cache "
        f"{counted['cache_len']}: card {on_card.flops} flops, "
        f"{on_card.bytes_accessed} bytes, kernels "
        f"{json.dumps(on_card.kernel_counts)}, "
        f"{sum(on_card.op_counts.values())} ops; meta {on_meta.flops} flops, "
        f"{on_meta.bytes_accessed} bytes, kernels "
        f"{json.dumps(on_meta.kernel_counts)}, "
        f"{sum(on_meta.op_counts.values())} ops ({meta_s:.2f}s); equal "
        f"{json.dumps(same)}; card launches {json.dumps(launches)}")
    if not same["ops"]:
        diff = {k: (on_card.op_counts.get(k), on_meta.op_counts.get(k))
                for k in set(on_card.op_counts) | set(on_meta.op_counts)
                if on_card.op_counts.get(k) != on_meta.op_counts.get(k)}
        log(f"dryrun (a) ops that differ (card, meta): {json.dumps(diff)}")
    kernels = on_card.kernel_counts
    if not (same["flops"] and same["bytes"] and same["kernels"]) \
            or kernels.get("gmm", 0) != launches["gmm"] \
            or kernels.get("decode_attention", 0) != launches["decode_attention"] \
            or not launches["gmm"] or not launches["decode_attention"]:
        raise SmokeFailure(f"dryrun (a): counts on the card and on meta "
                           f"differ ({same}) or disagree with the launch "
                           f"counters {launches} / {kernels}")

    out_dir = ROOT / "build" / "dryrun"
    t = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", DEEPSEEK,
         "--shape", "decode_32k", "--mesh", "pod", "--out", str(out_dir),
         "--force"], cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t
    for line in res.stdout.splitlines():
        log(f"dryrun (b) | {line}")
    path = out_dir / f"{DEEPSEEK}__decode_32k__pod_16x16.json"
    if res.returncode != 0 or not path.exists():
        raise SmokeFailure(f"dryrun (b): exit {res.returncode}: "
                           f"{res.stderr[-2000:]}")
    rec = json.loads(path.read_text())
    if rec["status"] != "ok":
        raise SmokeFailure(f"dryrun (b): record {rec['status']}: "
                           f"{rec.get('error')}")
    mem, roof = rec["memory"], rec["roofline"]
    log(f"dryrun (b) record: {wall:.1f}s wall, trace {rec['trace_s']}s; "
        f"rank 0 {roof['flops_per_chip'] / 1e12:.4f} TFLOP, "
        f"{roof['bytes_per_chip'] / 1e9:.3f} GB, collective "
        f"{roof['coll_bytes_per_chip'] / 1e6:.3f} MB; useful "
        f"{roof['useful_flops_ratio']:.6f}; dominant {roof['dominant']}; "
        f"planned {mem['planned']['total'] / 2**30:.2f} GiB, held "
        f"{mem['held']['total'] / 2**30:.2f} GiB, fits {mem['fits']}")

    step = rl.derive_from_op_cost(on_card, 1, 0.0)
    log(f"dryrun (c) {cfg.name} decode step (batch {BATCH}) bound from the "
        f"counted step: {step.bound_time_s * 1e3:.4f} ms ({step.dominant}: "
        f"{on_card.bytes_accessed / 1e9:.4f} GB at {rl.HBM_BW / 1e12} TB/s, "
        f"{on_card.flops / 1e9:.3f} GFLOP at {rl.PEAK_FLOPS / 1e12:.0f} "
        f"TFLOP/s); weights bound {sum(rl.serve_weight_bytes(cfg, BATCH).values()) / rl.HBM_BW * 1e3:.4f} ms; "
        f"measured {counted['step_ms']:.3f} ms a step on {card}")
    granite = get_config(GRANITE)
    bnd = rl.train_step_bound(granite, train_run["n_params"], TRAIN_BATCH,
                              TRAIN_SEQ)
    log(f"dryrun (c) {granite.name} train step ({TRAIN_BATCH} x {TRAIN_SEQ}) "
        f"bound {bnd['bound_ms']:.4f} ms ({bnd['step_tflop']:.4f} TFLOP, "
        f"AdamW {bnd['adamw_gb']:.3f} GB); measured "
        f"{train_run['step_s']:.3f} s a step on {card}")


# --------------------------------------------------------------------- #
# Phase 16: the EP bodies over NCCL at world size 1
# --------------------------------------------------------------------- #

SHARD_PREFILL = 2048       # prefill tokens a row: capacity() gives C = 960
SHARD_DECODE = 4           # granite's decode steps under a mesh
EP_GRADS = ("w_gate", "w_up", "w_down", "router")


def ep_grads(torch, fn, ffn, x, cot) -> tuple[dict, object]:
    """(grads of sum(y * cot) for EP_GRADS and x, y) of ``fn(params, x)``,
    the sum in f32."""
    live = {k: v.detach().requires_grad_() if k in EP_GRADS else v
            for k, v in ffn.items()}
    x = x.detach().requires_grad_()
    y, _ = fn(live, x)
    grads = torch.autograd.grad((y.float() * cot.float()).sum(),
                                [live[k] for k in EP_GRADS] + [x])
    return dict(zip((*EP_GRADS, "x"), grads)), y.detach()


def same(torch, got, want) -> dict:
    """Bitwise flag and largest difference relative to ``want``'s largest."""
    scale = float(want.float().abs().max()) or 1.0
    return {"bitwise": bool(torch.equal(got, want)),
            "rel_err": float((got.float() - want.float()).abs().max()) / scale}


def sharding_ep_bodies(torch, mesh) -> tuple[dict, dict]:
    """(16a) deepseek-moe-16b's MoE block at published width (64 experts of
    2048 x 1408, top-6, 2 shared; drawn by the model's block init, cast to
    bf16 as serve casts it): ``moe_apply_ep_replicated`` at decode (4, 1)
    and ``moe_apply_ep`` at prefill (4, 2048) through ``sharded_moe`` on
    the 1 x 1 NCCL mesh, forward and ``moe_apply_ep``'s backward (grads of
    EP_GRADS and x), with the launch and collective counts of that run
    (every gmm call counted by its (E, C, K, N)); then
    ``moe_apply_local`` on the same inputs, each
    output and grad bitwise or within 2^-7 of its largest value.  Returns
    (the counts by gmm shape, the record)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives
    from repro_torch.kernels import moe_gmm, ops
    from repro_torch.models import Parallel
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.model import (_block_init, apply_ep,
                                          cast_for_compute)
    from repro_torch.models.moe import capacity, moe_apply_local
    cfg = get_config(DEEPSEEK)
    cdt = dtype_of(cfg.compute_dtype)
    gen = torch.Generator(device="cuda").manual_seed(16)
    ffn = cast_for_compute(cfg, _block_init(
        gen, cfg, cfg.pattern[0], dtype_of(cfg.param_dtype), "cuda"))["ffn"]
    x_dec = torch.randn(BATCH, 1, cfg.d_model, generator=gen,
                        device="cuda").to(cdt)
    x_pre, cot = (torch.randn(BATCH, SHARD_PREFILL, cfg.d_model, generator=gen,
                              device="cuda").to(cdt) for _ in range(2))
    par = Parallel(mesh=mesh)
    calls: dict[tuple, int] = {}
    real = moe_gmm._product

    def counted(x, w):
        key = (*x.shape, w.shape[2])
        calls[key] = calls.get(key, 0) + 1
        return real(x, w)

    def ep(mode):
        return lambda p, x: apply_ep(cfg, p, x, par, cdt, mode)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    collectives.reset_counts()
    moe_gmm._product = counted
    try:
        with torch.no_grad():
            y_rep, aux_rep = ep("ep_rep")(ffn, x_dec)
            y_ep, aux_ep = ep("ep")(ffn, x_pre)
        g_ep, y_ep_g = ep_grads(torch, ep("ep"), ffn, x_pre, cot)
        torch.cuda.synchronize()
    finally:
        moe_gmm._product = real
    launches, coll = ops.launch_counts(), dict(collectives.calls)
    paths = dict(moe_gmm.path_launches)
    with torch.no_grad():
        y_loc_dec, aux_loc_dec = moe_apply_local(cfg, ffn, x_dec, cdt)
        y_loc, aux_loc = moe_apply_local(cfg, ffn, x_pre, cdt)
    g_loc, _ = ep_grads(torch, lambda p, x: moe_apply_local(cfg, p, x, cdt),
                        ffn, x_pre, cot)
    checks = {"ep_rep decode y": same(torch, y_rep, y_loc_dec),
              "ep prefill y": same(torch, y_ep, y_loc),
              "ep prefill y (grad run)": same(torch, y_ep_g, y_loc)}
    for k in aux_loc:
        checks[f"ep_rep aux {k}"] = same(torch, aux_rep[k], aux_loc_dec[k])
        checks[f"ep aux {k}"] = same(torch, aux_ep[k], aux_loc[k])
    for k in g_loc:
        checks[f"ep grad {k}"] = same(torch, g_ep[k], g_loc[k])
    times = {
        "ep_rep_decode_ms": event_ms(torch, lambda: ep("ep_rep")(ffn, x_dec),
                                     iters=10),
        "local_decode_ms": event_ms(torch, lambda: moe_apply_local(
            cfg, ffn, x_dec, cdt), iters=10),
        "ep_prefill_ms": event_ms(torch, lambda: ep("ep")(ffn, x_pre),
                                  iters=5),
        "local_prefill_ms": event_ms(torch, lambda: moe_apply_local(
            cfg, ffn, x_pre, cdt), iters=5)}
    rec = {"capacity_prefill": capacity(cfg, BATCH * SHARD_PREFILL,
                                        cfg.n_experts),
           "launches": launches, "collectives": coll,
           "gmm_calls": {"x".join(map(str, k)): n for k, n in calls.items()},
           "paths": paths, "checks": checks,
           **times}
    log("sharding 16a " + json.dumps(rec))
    bad = [k for k, c in checks.items()
           if not c["bitwise"] and c["rel_err"] > 2.0 ** -7]
    if bad:
        raise SmokeFailure(f"EP bodies differ from moe_apply_local: {bad}")
    if launches["gmm"] == 0 or coll["all_to_all"] == 0 \
            or coll["all_reduce"] == 0:
        raise SmokeFailure(f"EP run reached no gmm or no collective: "
                           f"{launches} {coll}")
    return calls, rec


def sharding_serve(torch, mesh) -> dict:
    """(16b) granite-moe-3b-a800m at published width: prefill and
    SHARD_DECODE decode steps through ``make_prefill_step`` and
    ``make_serve_step`` with ``par`` on the 1 x 1 mesh (launches counted
    over that run), then the same with ``Parallel()``: the tokens must be
    identical."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import Parallel, init_params, random_batch
    cfg = get_config(GRANITE)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    batch = random_batch(cfg, BATCH, PROMPT, seed=0, device="cuda")
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    tokens, counts = {}, {}
    for name, par in (("mesh", Parallel(mesh=mesh)), ("plain", Parallel())):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        logits, cache = make_prefill_step(cfg, par, PROMPT + SHARD_DECODE + 1)(
            params, prompt)
        step = make_serve_step(cfg, par)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        pos = torch.full((BATCH,), PROMPT, dtype=torch.int32, device="cuda")
        out = [tok]
        for _ in range(SHARD_DECODE):
            tok, logits, cache = step(params, cache, tok, pos, None)
            pos = pos + 1
            out.append(tok)
        torch.cuda.synchronize()
        counts[name] = ops.launch_counts()
        tokens[name] = torch.cat(out, dim=1)
    rec = {"tokens_equal": bool(torch.equal(tokens["mesh"], tokens["plain"])),
           "launches": counts["mesh"],
           "finite": bool(torch.isfinite(logits.float()).all())}
    log("sharding 16b " + json.dumps(rec))
    if not rec["tokens_equal"] or not rec["finite"] \
            or counts["mesh"]["gmm"] == 0 \
            or counts["mesh"]["decode_attention"] == 0:
        raise SmokeFailure(f"granite's serve steps under the 1 x 1 mesh: {rec}")
    return rec


def phase_sharding(torch, card: str) -> list[tuple[str, dict, int]]:
    """Phase 16 (a-c): NCCL at world size 1 through ``make_host_mesh``,
    torn down at the end.  Returns the kernel rows (name, record,
    launches over 16a's run) of 16c's gmm shapes."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    seconds = {}

    def step(name, fn, *args):
        t = time.perf_counter()
        got = fn(*args)
        seconds[name] = round(time.perf_counter() - t, 1)
        return got

    mesh = make_host_mesh("cuda")
    try:
        if (mesh.shape, mesh.size) != ({"data": 1, "model": 1}, 1):
            raise SmokeFailure(f"host mesh {mesh.shape}, {mesh.size} ranks")
        calls, _ = step("16a", sharding_ep_bodies, torch, mesh)
        torch.cuda.empty_cache()
        step("16b", sharding_serve, torch, mesh)
        torch.cuda.empty_cache()
        recs = {}
        t = time.perf_counter()
        for key in calls:                        # (16c) gmm at 16a's calls
            rec = check_gmm(torch, *key, "bfloat16", iters=10)
            log("kernel " + json.dumps(rec))
            if not rec["ok"] or rec["path"] != "wgmma":
                raise SmokeFailure(f"gmm at {rec['shape']}: {rec}")
            recs[key] = rec
        seconds["16c"] = round(time.perf_counter() - t, 1)
    finally:
        dist.destroy_process_group()
    log(f"phase 16 seconds {json.dumps(seconds)} ({card})")
    return [("gmm", rec, calls[key]) for key, rec in recs.items()]


# --------------------------------------------------------------------- #
# Phase 18: tensor and data parallelism, each rank on its blocks
# --------------------------------------------------------------------- #

QWEN = "qwen2.5-3b"
TP_RANKS = 4
# (arch, layers, mesh) of 18a: deepseek's dense first layer and 2 MoE
# layers (data split, heads, KV cache and vocab over "model", EP), and
# qwen's k/v that cut a head and its tied vocab of 151,936 four ways.
TP_CASES = ((DEEPSEEK, 3, (2, 2)), (QWEN, 2, (1, 4)))
# The EP bodies keep the reference's per-shard semantics: each shard sizes
# its capacity from its own tokens, and the aux is the first shard's value
# with the mean of the shards' grads.  So deepseek runs at capacity 8 (no
# copy dropped, on either side) and its single-shard run takes the same
# aux (``ep_aux``).
TP_DECODE, TP_LR = 8, 1e-2
# 18a's tolerance, over the largest single-shard value of each tensor:
# both runs are f32 on the card, and a rank's narrower blocks make cuBLAS
# pick other tilings and split-K, so sums over K of up to 10,944 terms
# (and the ranks' partial sums) are taken in another order.
TP_TOL = 1e-4
# 18b: rank 0 of the pod mesh; the last two archs (their gmm shapes only)
# take POD_SHORT decode steps and no profile.
POD_BATCH, POD_PROMPT, POD_CACHE, POD_DECODE = 64, 32, 2048, 8
POD_ARCHS = ("mistral-large-123b", "jamba-1.5-large-398b", GRANITE, ARCH)
POD_SHORT, POD_PROFILED = 4, 2


def tp_cfg(arch: str, layers: int):
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch)
    extra = {"capacity_factor": 8.0} if cfg.has_moe else {}
    return dataclasses.replace(cfg, n_layers=layers, compute_dtype="float32",
                               **extra)


@contextlib.contextmanager
def ep_aux(torch, mesh_shape: tuple):
    """``moe_apply_local`` with the aux of the EP bodies on ``mesh_shape``
    (``sharded_moe``): the value the first shard's, the grad the mean of
    the shards' (by data rows and, where the sequence splits over the
    model axis as "ep" splits it, by sequence blocks)."""
    from repro_torch.models import moe
    real = moe.moe_apply_local

    def local(cfg, p, x, cdt):
        y, _ = real(cfg, p, x, cdt)
        n_d, n_m = mesh_shape
        b, s, d = x.shape
        n_s = n_m if s % n_m == 0 else 1
        auxes = []
        for i in range(n_d):
            for j in range(n_m):
                xs = x[i * b // n_d:(i + 1) * b // n_d,
                       (j % n_s) * s // n_s:(j % n_s + 1) * s // n_s]
                auxes.append(moe.route(cfg, p["router"],
                                       xs.reshape(-1, d).to(cdt))[2])
        aux = {}
        for k in auxes[0]:
            mean = torch.stack([a[k] for a in auxes]).mean(0)
            aux[k] = mean + (auxes[0][k] - mean).detach()
        return y, aux
    moe.moe_apply_local = local
    try:
        yield
    finally:
        moe.moe_apply_local = real


def tp_single(torch, arch: str, layers: int, seed: int,
              mesh_shape: tuple) -> dict:
    """(18a) The single-shard run of one case on the card (the EP bodies'
    aux on ``mesh_shape``, ``ep_aux``): its inputs and every result the
    ranks are held to, as CUDA tensors."""
    with ep_aux(torch, mesh_shape):
        return _tp_single(torch, arch, layers, seed)


def _tp_single(torch, arch: str, layers: int, seed: int) -> dict:
    from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                          make_train_step)
    from repro_torch.models import Parallel, init_params, random_batch
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = tp_cfg(arch, layers)
    par = Parallel()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed),
                         "cuda", cast=False)
    batch = random_batch(cfg, BATCH, PROMPT, seed=seed, device="cuda")
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    out = {"batch": batch}
    with torch.no_grad():
        logits, cache = make_prefill_step(cfg, par, PROMPT + TP_DECODE + 1)(
            params, prompt)
        out["prefill"] = logits
        step = make_serve_step(cfg, par)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        pos = torch.full((BATCH,), PROMPT, dtype=torch.int32, device="cuda")
        out["tokens"], out["decode"] = [tok], []
        for _ in range(TP_DECODE):
            tok, lg, cache = step(params, cache, tok, pos)
            out["tokens"].append(tok)
            out["decode"].append(lg)
            pos = pos + 1
        out["cache"] = cache
    state = adamw_init(params)
    params, state, met = make_train_step(cfg, par, AdamWConfig(lr=TP_LR))(
        params, state, batch)
    out.update(params=params, loss=met["loss"], grad_norm=met["grad_norm"])
    del state
    torch.cuda.synchronize()
    return out


def _abs_max(x) -> float:
    lo, hi = x.aminmax()              # no temporary of x's size
    return max(-float(lo), float(hi))


def _tp_err(torch, got, want, scale=None, mask=None) -> float:
    """max |got - want| (over ``mask``) over ``scale`` (max |want| by
    default); one f32 temporary of the tensor's size."""
    if got.shape != want.shape:
        return float("inf")
    if want.numel() == 0:
        return 0.0
    diff = (got.float() - want.float()).abs_()
    if mask is not None:
        diff.mul_(mask)
    scale = scale or _abs_max(want) or 1.0
    return float(diff.max()) / scale


def _tp_worst(torch, got, whole, specs, mesh, masks=None) -> float:
    """Largest ``_tp_err`` of the rank's blocks ``got`` against its blocks
    of ``whole``, each over its whole leaf's largest value."""
    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.tree import tree_leaves
    wants = tree_leaves(shard_tree(whole, specs, mesh))
    masks = masks or [None] * len(wants)
    return max((_tp_err(torch, g, w, _abs_max(x), m)
                for g, w, m, x in zip(tree_leaves(got), wants, masks,
                                      tree_leaves(whole))), default=0.0)


def tp_rank(rank: int, world: int, folder: str, case: int,
            single: dict) -> None:
    """(18a) One rank: join the gloo group, run case ``case`` on its
    blocks, write ``rank{rank}.json`` (errors against the single-shard
    results, launches, collective calls, memory, seconds)."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                          make_train_step)
    from repro_torch.models import Parallel, init_params
    from repro_torch.models.model import gather_logits
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.tree import tree_leaves
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{folder}/rendezvous",
                            rank=rank, world_size=world)
    out = {}
    try:
        for arch, layers, shape in TP_CASES[case:case + 1]:
            t0 = time.perf_counter()
            cfg = tp_cfg(arch, layers)
            mesh = make_mesh(shape, ("data", "model"), "cpu")
            par = Parallel(mesh=mesh)
            rules = par.rules(cfg)
            ops.reset_launch_counts()
            collectives.reset_counts()
            params = init_params(
                cfg, torch.Generator(device="cuda").manual_seed(
                    single["seed"]), "cuda", cast=False, par=par)
            batch = {k: par.rows(v) for k, v in single["batch"].items()}
            prompt = {k: v for k, v in batch.items() if k != "labels"}
            err = {}
            memory = {"drawn_gib": torch.cuda.memory_allocated() / 2**30}
            with torch.no_grad():
                logits, cache = make_prefill_step(
                    cfg, par, PROMPT + TP_DECODE + 1)(params, prompt)
                err["prefill"] = _tp_err(torch, gather_logits(cfg, logits, par),
                                         single["prefill"])
                step = make_serve_step(cfg, par)
                pos = torch.full((BATCH,), PROMPT, dtype=torch.int32,
                                 device="cuda")
                worst = 0.0
                for i in range(TP_DECODE):
                    _, lg, cache = step(params, cache, single["tokens"][i], pos)
                    worst = max(worst, _tp_err(torch, lg, single["decode"][i]))
                    pos = pos + 1
                err["decode"] = worst
                err["cache"] = _tp_worst(
                    torch, cache, single["cache"],
                    rules.cache_specs(single["cache"]), mesh)
            del cache, logits
            torch.cuda.empty_cache()
            state = adamw_init(params)
            params, state, met = make_train_step(cfg, par, AdamWConfig(
                lr=TP_LR))(params, state, batch)
            err["loss"] = _tp_err(torch, met["loss"], single["loss"])
            err["grad_norm"] = _tp_err(torch, met["grad_norm"],
                                       single["grad_norm"])
            specs = rules.param_specs(single["params"])
            # AdamW's first step moves a weight by lr * g / (|g| + eps):
            # where |g| nears eps a rounding of g moves it far more than
            # it moves g, so params are held where the rank's mu (0.1 g)
            # is at least 1e-2 of its block's largest.
            masks = [m.abs() >= 1e-2 * _abs_max(m)
                     for m in tree_leaves(state["mu"])]
            del state
            err["params"] = _tp_worst(torch, params, single["params"], specs,
                                      mesh, masks)
            torch.cuda.synchronize()
            memory["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            held = sum(t.numel() * t.element_size()
                       for t in tree_leaves(params))
            out[f"{arch} {shape}"] = {
                "err": err, "launches": ops.launch_counts(),
                "collectives": dict(collectives.calls), "memory": memory,
                "param_bytes": held, "seconds": time.perf_counter() - t0}
            del params, masks
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    finally:
        dist.destroy_process_group()
    Path(folder, f"rank{rank}.json").write_text(json.dumps(out))


def phase_tp_values(torch, card: str) -> dict:
    """(18a) Each case's single-shard run here, then TP_RANKS ranks in
    processes of their own on the card, handed the single-shard results
    as CUDA tensors (``torch.multiprocessing``)."""
    import os
    import shutil

    import torch.multiprocessing as mp
    single_s = ranks_s = 0.0
    res = [{} for _ in range(TP_RANKS)]
    for i, (arch, layers, shape) in enumerate(TP_CASES):
        folder = ROOT / "build" / "tp" / str(i)
        shutil.rmtree(folder, ignore_errors=True)
        folder.mkdir(parents=True)
        t0 = time.perf_counter()
        single = tp_single(torch, arch, layers, 18 + i, shape)
        single["seed"] = 18 + i
        torch.cuda.empty_cache()     # the ranks need what this run freed
        single_s += time.perf_counter() - t0
        log(f"tp 18a {arch}: single-shard results held for the ranks "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        t0 = time.perf_counter()
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=tp_rank, args=(r, TP_RANKS, str(folder),
                                                   i, single))
                 for r in range(TP_RANKS)]
        # Five processes share the card: segments that grow in place
        # waste less of it than each process's split cached blocks.
        alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        try:
            for p in procs:
                p.start()
        finally:
            if alloc is None:
                os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
        run_cpu_ref(("fleet", "batched")[i])
        for p in procs:
            p.join(timeout=600)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        ranks_s += time.perf_counter() - t0
        del single
        torch.cuda.ipc_collect()      # what the ranks' handles kept alive
        torch.cuda.empty_cache()
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise SmokeFailure(f"18a {arch}: rank exit codes {codes}")
        for r in range(TP_RANKS):
            res[r].update(json.loads((folder / f"rank{r}.json").read_text()))
    bad = []
    for r, got in enumerate(res):
        for name, rec in got.items():
            log(f"tp 18a rank {r} {name}: " + json.dumps(rec))
            bad += [(r, name, k, v) for k, v in rec["err"].items()
                    if not v <= TP_TOL]
            if not rec["launches"]["decode_attention"]:
                bad.append((r, name, "decode_attention launches", 0))
            if name.startswith(DEEPSEEK) and not rec["launches"]["gmm"]:
                bad.append((r, name, "gmm launches", 0))
    log(f"tp 18a: single-shard runs {single_s:.1f}s, {TP_RANKS} ranks "
        f"{ranks_s:.1f}s; tolerance {TP_TOL} ({card})")
    if bad:
        raise SmokeFailure(f"18a: ranks differ from the single-shard step: "
                           f"{bad}")
    return {"single_s": single_s, "ranks_s": ranks_s}


def pod_rank0(torch, card: str, arch: str, mesh, gmm_calls: dict,
              attn_calls: dict, n_decode: int = POD_DECODE,
              profiled: int = POD_PROFILED, keep: dict | None = None) -> dict:
    """(18b) One model at published width and depth as rank 0 of the pod
    mesh (module docstring): ``n_decode`` steps timed, then ``profiled``
    more under the profiler (none: no busy share).  ``keep`` (a dict)
    takes the drawn blocks, for 19c."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives
    from repro_torch.kernels import decode_attn, moe_gmm, ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import (cache_structs, make_prefill_step,
                                          make_serve_step)
    from repro_torch.models import Parallel, init_params
    from repro_torch.models.model import gather_logits
    start = time.perf_counter()
    cfg = get_config(arch)
    par = Parallel(mesh=mesh)
    rules = par.rules(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda", cast=True, par=par)
    if keep is not None:
        keep["params"] = params
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    draw_peak = torch.cuda.max_memory_allocated() - base
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (POD_BATCH, POD_PROMPT),
                           generator=gen, device="cuda", dtype=torch.int32)
    real_gmm, real_attn = moe_gmm._product, decode_attn._launch

    def gmm_counted(x, w):
        key = (arch, *x.shape, w.shape[2])
        gmm_calls[key] = gmm_calls.get(key, 0) + 1
        return real_gmm(x, w)

    def attn_counted(q, k, v, pos):
        key = (arch, *q.shape, k.shape[2], k.stride(2) // q.shape[-1])
        attn_calls[key] = attn_calls.get(key, 0) + 1
        return real_attn(q, k, v, pos)
    ops.reset_launch_counts()
    collectives.reset_counts()
    moe_gmm._product, decode_attn._launch = gmm_counted, attn_counted
    try:
        t0 = time.perf_counter()
        logits, cache = make_prefill_step(cfg, par, POD_CACHE)(
            params, {"tokens": par.rows(tokens)})
        tok = torch.argmax(gather_logits(cfg, logits, par), -1) \
            .to(torch.int32)[:, None]
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        step = make_serve_step(cfg, par)
        pos = torch.full((POD_BATCH,), POD_PROMPT, dtype=torch.int32,
                         device="cuda")
        given = {"params": params, "cache": cache, "tokens": par.rows(tok),
                 "pos": pos}
        t0 = time.perf_counter()
        for _ in range(n_decode):
            tok, logits, cache = step(params, cache, tok, pos)
            pos = pos + 1
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / n_decode
        launches = ops.launch_counts()
        coll = dict(collectives.calls)
        prof_ms = busy_ms = profile_s = None
        if profiled:
            with primed_profile(torch, cpu=False) as prof:
                t0 = time.perf_counter()
                for _ in range(profiled):
                    tok, logits, cache = step(params, cache, tok, pos)
                    pos = pos + 1
                torch.cuda.synchronize()
                prof_ms = (time.perf_counter() - t0) * 1e3 / profiled
    finally:
        moe_gmm._product, decode_attn._launch = real_gmm, real_attn
    if profiled:
        t0 = time.perf_counter()
        busy_ms = sum(k[0] for k in device_times(prof, profiled))
        profile_s = time.perf_counter() - t0
    meta = {"params": init_params(cfg, torch.Generator(), "meta", cast=True),
            "cache": cache_structs(cfg, POD_BATCH, POD_CACHE),
            "tokens": torch.empty((POD_BATCH, 1), dtype=torch.int32,
                                  device="meta"),
            "pos": torch.empty((POD_BATCH,), dtype=torch.int32, device="meta")}
    mem = dryrun.memory_per_rank(rules, meta, mesh.shape, given)
    held, planned = mem["held"]["total"], mem["planned"]["total"]
    rec = {"arch": arch, "layers": cfg.n_layers, "draw_s": draw_s,
           "draw_peak_gib": draw_peak / 2**30,
           "held_gib": {k: v / 2**30 for k, v in mem["held"].items()},
           "planned_gib": {k: v / 2**30 for k, v in mem["planned"].items()},
           "held_over_planned": held / planned,
           "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30,
           "prefill_s": prefill_s, "decode_steps": n_decode,
           "step_ms": step_ms, "profiled_step_ms": prof_ms,
           "busy_ms": busy_ms,
           "busy_share": busy_ms / prof_ms if profiled else None,
           "profile_sum_s": profile_s,
           "launches": launches, "collectives": coll,
           "finite": bool(torch.isfinite(logits.float()).all()),
           "seconds": time.perf_counter() - start}
    log(f"tp 18b {arch} ({card}): " + json.dumps(rec))
    total = torch.cuda.get_device_properties(0).total_memory
    if abs(held - planned) > 0.01 * planned or rec["peak_gib"] * 2**30 \
            >= total or not launches["decode_attention"] \
            or (cfg.has_moe and not launches["gmm"]):
        raise SmokeFailure(f"18b {arch}: held {held} against planned "
                           f"{planned}, peak {rec['peak_gib']:.2f} GiB, "
                           f"launches {launches}")
    return rec


POD_RESULT = ROOT / "build" / "tp" / "pod.json"


def pod_main() -> None:
    """(18b, 19c) in a process of its own (``phase_tp`` starts it): the
    fake group of 256 ranks and every model of POD_ARCHS as rank 0, then
    jamba at long_500k (``long_rank0``); writes the records and the
    kernels' call shapes to POD_RESULT, and 19c's record to LONG_RESULT."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import build
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()                 # built already: loads the libraries
    card = card_line()
    gmm_calls: dict = {}
    attn_calls: dict = {}
    records = []
    dryrun.fake_group(256)
    try:
        mesh = make_production_mesh(device="cpu")
        kept: dict = {}
        for i, arch in enumerate(POD_ARCHS):
            short = i >= 2
            records.append(pod_rank0(
                torch, card, arch, mesh, gmm_calls, attn_calls,
                POD_SHORT if short else POD_DECODE,
                0 if short else POD_PROFILED,
                keep=kept if arch == JAMBA else None))
            torch.cuda.empty_cache()
        # 19c on jamba's blocks as 18b drew them (the params' specs do not
        # depend on the batch), then freed.
        draw = next(r for r in records if r["arch"] == JAMBA)
        LONG_RESULT.write_text(json.dumps(long_rank0(
            torch, card, mesh, kept.pop("params"), draw)))
    finally:
        dist.destroy_process_group()
    POD_RESULT.write_text(json.dumps({
        "records": records,
        "gmm": [[*k, n] for k, n in gmm_calls.items()],
        "attn": [[*k, n] for k, n in attn_calls.items()]}))


def phase_tp(torch, card: str) -> list[tuple[str, dict, int]]:
    """Phase 18 (a-c).  Returns the kernel rows (name, record, launches
    over 18b's runs) of 18c's shapes.  18b runs in a process of its own,
    with ``expandable_segments`` (a whole f32 weight of jamba's, 12 GiB,
    is drawn between blocks of other sizes: without it the allocator's
    cached segments split and the draw runs out of memory), and so that
    its fake process group stays out of this one."""
    import os
    seconds = {}
    t = time.perf_counter()
    phase_tp_values(torch, card)
    seconds["18a"] = round(time.perf_counter() - t, 1)
    t = time.perf_counter()
    POD_RESULT.unlink(missing_ok=True)
    LONG_RESULT.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    res = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.pod_main()"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    for line in res.stdout.splitlines():
        print(line, flush=True)
    if res.returncode != 0 or not POD_RESULT.exists():
        raise SmokeFailure(f"18b: exit {res.returncode}: "
                           f"{res.stderr[-3000:]}")
    pod = json.loads(POD_RESULT.read_text())
    gmm_calls = {tuple(k[:-1]): k[-1] for k in pod["gmm"]}
    attn_calls = {tuple(k[:-1]): k[-1] for k in pod["attn"]}
    seconds["18b"] = round(time.perf_counter() - t, 1)
    t = time.perf_counter()
    log("tp 18b gmm calls " + json.dumps(
        {" ".join(map(str, k)): n for k, n in gmm_calls.items()}))
    log("tp 18b decode_attention calls " + json.dumps(
        {" ".join(map(str, k)): n for k, n in attn_calls.items()}))
    rows = []
    # Each model's most launched gmm shape, and every shape whose N or K
    # is a d_ff shard (the "local" mode's), each with its launches.
    picked = set()
    for arch in POD_ARCHS:
        mine = {k: n for k, n in gmm_calls.items() if k[0] == arch}
        if mine:
            picked.add(max(mine, key=mine.get))
    picked |= {k for k in gmm_calls if min(k[3], k[4]) in (32, 86)}
    for key in sorted(picked):
        _, e, c, k, n = key
        rec = check_gmm(torch, e, c, k, n, "bfloat16", iters=10)
        rec["shape"] = f"{rec['shape']} ({key[0]} rank 0 of 16 x 16)"
        log("kernel " + json.dumps(rec))
        if not rec["ok"]:
            raise SmokeFailure(f"gmm at {rec['shape']}: {rec}")
        rows.append(("gmm", rec, gmm_calls[key]))
    for key, n_calls in sorted(attn_calls.items()):
        arch, b, hkv, g, hd, s, heads = key
        last = POD_PROMPT + POD_DECODE + POD_PROFILED - 1   # the last step
        rec = check_decode(torch, b, hkv, g, s, hd, "bfloat16", [last] * b,
                           iters=20, layout="bshd", cache_heads=heads)
        rec["shape"] = f"{rec['shape']} ({arch} rank 0 of 16 x 16)"
        log("kernel " + json.dumps(rec))
        if not rec["ok"]:
            raise SmokeFailure(f"decode_attention at {rec['shape']}: {rec}")
        rows.append(("decode_attention", rec, n_calls))
    seconds["18c"] = round(time.perf_counter() - t, 1)
    log(f"phase 18 seconds {json.dumps(seconds)} ({card})")
    return rows


# --------------------------------------------------------------------- #
# Phase 19: ZeRO-1 and context-parallel batch-1 decode
# --------------------------------------------------------------------- #

# 19a: granite at published width with 2 layers (f32, capacity 8),
# ZERO_STEPS train steps of 4 x 32 tokens on each mesh under ZeRO-1, held
# to the same mesh without it and to the single-shard steps this process
# runs first (with the EP bodies' aux where the mesh runs them: 40
# experts divide a model axis of 2, ``ep_aux``).
ZERO_LAYERS, ZERO_STEPS = 2, 3
ZERO_MESHES = ((2, 2), (4, 1))
# 19b: batch-1 decode on a cache of CP_LEN rows split over the data ranks
# (blocks of 16 and 32 rows), the smoke models (qwen's 2 layers, jamba's
# one unit of 8), a prompt of CP_PROMPT tokens, then decode at CP_POS: in
# the first block, on a block's first row, and in the last block.
CP_SMOKE = ((QWEN, 2), (JAMBA, 8))
CP_MESHES = ((4, 1), (2, 2))
CP_LEN, CP_PROMPT = 64, 5
CP_POS = (5, 16, 32, 63)
# 19c: jamba at long_500k as rank 0 of the pod (its block: rows 0 to
# 32,767): LONG_STEPS decode steps from each start (the last rows, where
# every block is visible; row 100, where only rank 0's is), then
# LONG_PROFILED more under the profiler.
LONG_STARTS = {"every block visible": 524_284, "rank 0's block only": 100}
LONG_STEPS, LONG_PROFILED = 4, 2
LONG_RESULT = ROOT / "build" / "tp" / "long.json"


def zero_single(torch, mesh_shape: tuple) -> dict:
    """(19a) The single-shard steps on the card for the ranks of
    ``mesh_shape`` (the EP bodies' aux where its model axis runs them):
    the batches, each step's metrics, and the state (params, moments,
    count) before each step and after the last, as CUDA tensors."""
    if mesh_shape[1] == 1:
        return _zero_single(torch)
    with ep_aux(torch, mesh_shape):
        return _zero_single(torch)


def _zero_single(torch) -> dict:
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Parallel, init_params, random_batch
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.tree import tree_map
    cfg = tp_cfg(GRANITE, ZERO_LAYERS)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(19),
                         "cuda", cast=False)
    state = adamw_init(params)
    step = make_train_step(cfg, Parallel(), AdamWConfig(lr=TP_LR))
    out = {"batches": [random_batch(cfg, BATCH, PROMPT, seed=190 + i,
                                    device="cuda")
                       for i in range(ZERO_STEPS)],
           "states": [], "metrics": []}
    for batch in out["batches"]:
        out["states"].append(tree_map(torch.clone, (params, state)))
        params, state, met = step(params, state, batch)
        out["metrics"].append({k: float(v) for k, v in met.items()})
    out["states"].append((params, state))
    torch.cuda.synchronize()
    return out


def zero_slices(torch, tree, split, rank: int):
    """This data rank's ZeRO-1 slices (in the moments' shapes) of a tree of
    blocks, new tensors; a leaf without a cut cloned whole."""
    from repro_torch.launch.steps import _slice
    from repro_torch.tree import tree_leaves, tree_unflatten
    out = []
    for t, cut in zip(tree_leaves(tree),
                      tree_leaves(split, tuple_leaves=True)):
        if cut is None:
            out.append(t.clone())
            continue
        shape = list(t.shape)
        shape[cut[0]] //= cut[1]
        out.append(_slice(t, cut, rank).clone(
            memory_format=torch.contiguous_format).reshape(shape))
    return tree_unflatten(tree, out)


def _zero_rank(torch, singles: dict) -> dict:
    """(19a) One rank, on each mesh: the ZeRO-1 run and the run without
    it side by side (metrics, collectives and ms a step, moment bytes),
    the ZeRO state held after each step to the other run's (the rank's
    blocks and slices of it, cut locally), and to the single-shard state
    after the same step started from the single-shard state before it
    (free, AdamW turns roundings of grads near its eps into moves of lr,
    which later steps carry)."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_train_step, zero_split
    from repro_torch.models import Parallel, init_params
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.tree import tree_leaves, tree_map
    cfg = tp_cfg(GRANITE, ZERO_LAYERS)
    out = {}
    for shape in ZERO_MESHES:
        t0 = time.perf_counter()
        single = singles[str(shape)]
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        plain_par = Parallel(mesh=mesh)
        zero_par = Parallel(mesh=mesh, zero_opt=True)
        whole = init_params(cfg, torch.Generator(), "meta", cast=False)
        p_specs = zero_par.rules(cfg).param_specs(whole)
        split = zero_split(cfg, zero_par)
        rank = zero_par.data_rank()
        batches = [{k: plain_par.rows(v) for k, v in b.items()}
                   for b in single["batches"]]
        plain_step = make_train_step(cfg, plain_par, AdamWConfig(lr=TP_LR))
        zero_step = make_train_step(cfg, zero_par, AdamWConfig(lr=TP_LR))

        def held(got_p, got_s, p_blocks, m_blocks, v_blocks) -> float:
            """Largest error of the rank's params and moment slices
            against a state's blocks (each over its block's largest),
            params where mu is at least 1e-2 of its block's largest (as
            18a)."""
            masks = [m.abs() >= 1e-2 * _abs_max(m)
                     for m in tree_leaves(m_blocks)]
            errs = [_tp_err(torch, g, w, _abs_max(w), m) for g, w, m in zip(
                tree_leaves(got_p), tree_leaves(p_blocks), masks)]
            for k, blocks in (("mu", m_blocks), ("nu", v_blocks)):
                errs += [_tp_err(torch, g, w, _abs_max(b)) for g, w, b in zip(
                    tree_leaves(got_s[k]), tree_leaves(
                        zero_slices(torch, blocks, split, rank)),
                    tree_leaves(blocks))]
            return max(errs)

        def single_blocks(i):
            p, st = single["states"][i]
            return [shard_tree(t, p_specs, mesh)
                    for t in (p, st["mu"], st["nu"])] + [st["count"]]
        err = {"vs plain": 0.0, "vs single": 0.0}
        seed = torch.Generator(device="cuda").manual_seed
        plain_p = init_params(cfg, seed(19), "cuda", cast=False,
                              par=plain_par)
        plain_s = adamw_init(plain_p)
        params = init_params(cfg, seed(19), "cuda", cast=False, par=zero_par)
        state = adamw_init(params, split)
        plain_metrics, zero_metrics, calls, step_s = [], [], [], 0.0
        for i in range(ZERO_STEPS):
            plain_p, plain_s, met = plain_step(plain_p, plain_s, batches[i])
            plain_metrics.append({k: float(v) for k, v in met.items()})
            collectives.reset_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            params, state, met = zero_step(params, state, batches[i])
            zero_metrics.append({k: float(v) for k, v in met.items()})
            torch.cuda.synchronize()
            step_s += (time.perf_counter() - t1) / ZERO_STEPS
            calls.append(dict(collectives.calls))
            err["vs plain"] = max(err["vs plain"], held(
                params, state, plain_p, plain_s["mu"], plain_s["nu"]))
            if i == 0:           # both from the same state: no extra step
                got_p, got_s = params, state
            else:                # a ZeRO step from the single-shard state
                p0, m0, v0, c0 = single_blocks(i)
                got_p, got_s, _ = zero_step(
                    tree_map(torch.clone, p0),
                    {"mu": zero_slices(torch, m0, split, rank),
                     "nu": zero_slices(torch, v0, split, rank),
                     "count": c0.clone()}, batches[i])
                del p0, m0, v0
            err["vs single"] = max(err["vs single"], held(
                got_p, got_s, *single_blocks(i + 1)[:3]))
            del got_p, got_s
        plain_bytes = sum(t.numel() * 4 for t in tree_leaves(plain_s["mu"]))
        for name, want in (("single", single["metrics"]),
                           ("plain", plain_metrics)):
            for k in ("loss", "grad_norm"):
                err[f"{k} vs {name}"] = max(
                    abs(z[k] - w[k]) / abs(w[k])
                    for z, w in zip(zero_metrics, want))
        cut = [c is not None for c in tree_leaves(split, tuple_leaves=True)]
        zero_leaf = [t.numel() * 4 for t in tree_leaves(state["mu"])]
        whole_leaf = [t.numel() * 4 for t in tree_leaves(
            shard_tree(whole, p_specs, mesh))]     # the param blocks (meta)
        out[str(shape)] = {
            "err": err, "losses": [m["loss"] for m in zero_metrics],
            "grad_norms": [m["grad_norm"] for m in zero_metrics],
            "plain_losses": [m["loss"] for m in plain_metrics],
            "single_losses": [m["loss"] for m in single["metrics"]],
            "collectives_a_step": calls[-1],
            "moment_bytes": 2 * sum(zero_leaf),
            "plain_moment_bytes": 2 * plain_bytes,
            "bytes_exact": all(z * zero_par.n_data == w if c else z == w
                               for z, w, c in zip(zero_leaf, whole_leaf, cut)),
            "cut_leaves": sum(cut), "leaves": len(cut),
            "zero_step_s": step_s, "seconds": time.perf_counter() - t0}
        del params, state, plain_p, plain_s
        torch.cuda.empty_cache()
    return out


def _cp_rank(torch) -> dict:
    """(19b) One rank: each smoke model at batch 1, single-shard and with
    the cache's sequence split over each mesh's data ranks; logits and
    the cache's blocks against the single-shard run's, and the partial
    mode's launches."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.kernels import decode_attn, ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import (Parallel, init_params, prefill,
                                    random_batch)
    from repro_torch.models.model import gather_logits
    out = {}
    for arch, layers in CP_SMOKE:
        cfg = dataclasses.replace(smoke_config(arch), n_layers=layers)
        prompt = {"tokens": random_batch(cfg, 1, CP_PROMPT, seed=191,
                                         device="cuda")["tokens"]}
        runs = {}
        for shape in (None, *CP_MESHES):
            par = Parallel() if shape is None else Parallel(
                mesh=make_mesh(shape, ("data", "model"), "cpu"),
                batch_split=False, context=True)
            params = init_params(cfg, torch.Generator(
                device="cuda").manual_seed(191), "cuda", cast=False, par=par)
            ops.reset_launch_counts()
            with torch.no_grad():
                last, cache = prefill(cfg, params, prompt, CP_LEN, par)
                logits = [gather_logits(cfg, last, par)]
                step = make_serve_step(cfg, par)
                tok = logits[0].argmax(-1).to(torch.int32)[:, None]
                for p in CP_POS:
                    tok, lg, cache = step(params, cache, tok, torch.full(
                        (1,), p, dtype=torch.int32, device="cuda"))
                    logits.append(lg)
            torch.cuda.synchronize()
            runs[shape] = (logits, cache, dict(decode_attn.mode_launches),
                           par)
        single = runs[None]
        for shape in CP_MESHES:
            logits, cache, modes, par = runs[shape]
            specs = par.rules(cfg).cache_specs(single[1])
            out[f"{arch} {shape}"] = {
                "err": {"logits": max(_tp_err(torch, a, b) for a, b in zip(
                    logits, single[0])),
                        "cache": _tp_worst(torch, cache, single[1], specs,
                                           par.mesh)},
                "partial_launches": modes["partial"],
                "full_launches": modes["full"],
                "block_rows": [t.shape[1] for t in _kv_leaves(cache)][:1]}
    return out


def _kv_leaves(cache) -> list:
    from repro_torch.tree import tree_leaves
    return [t for t in tree_leaves(cache) if t.dim() == 4]


def zero_cp_rank(rank: int, world: int, folder: str, singles: dict) -> None:
    """(19a-b) One rank: join the gloo group, run 19a and 19b, write
    ``rank{rank}.json``."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{folder}/rendezvous",
                            rank=rank, world_size=world)
    try:
        t0 = time.perf_counter()
        out = {"zero": _zero_rank(torch, singles)}
        t1 = time.perf_counter()
        out["cp"] = _cp_rank(torch)
        out["seconds"] = {"19a": t1 - t0, "19b": time.perf_counter() - t1}
    finally:
        dist.destroy_process_group()
    Path(folder, f"rank{rank}.json").write_text(json.dumps(out))


def phase_zero_cp_values(torch, card: str) -> dict:
    """(19a-b) The single-shard steps here, then TP_RANKS ranks in
    processes of their own on the card (as 18a), handed them as CUDA
    tensors."""
    import os
    import shutil

    import torch.multiprocessing as mp
    folder = ROOT / "build" / "tp" / "19"
    shutil.rmtree(folder, ignore_errors=True)
    folder.mkdir(parents=True)
    t0 = time.perf_counter()
    singles = {str(shape): zero_single(torch, shape) for shape in ZERO_MESHES}
    single_s = time.perf_counter() - t0
    log("19a single-shard losses " + json.dumps(
        {k: [m["loss"] for m in v["metrics"]] for k, v in singles.items()})
        + f", {single_s:.1f}s, held for the ranks "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=zero_cp_rank, args=(r, TP_RANKS, str(folder),
                                                    singles))
             for r in range(TP_RANKS)]
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        for p in procs:
            p.start()
    finally:
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    run_cpu_ref("ctrl", "aimd")
    for p in procs:
        p.join(timeout=600)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    del singles
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise SmokeFailure(f"19a-b: rank exit codes {codes}")
    ranks = [json.loads((folder / f"rank{r}.json").read_text())
             for r in range(TP_RANKS)]
    bad = []
    for r, got in enumerate(ranks):
        log(f"19a rank {r} ({card}): " + json.dumps(got["zero"]))
        log(f"19b rank {r} ({card}): " + json.dumps(got["cp"]))
        for name, rec in got["zero"].items():
            bad += [(r, name, k, v) for k, v in rec["err"].items()
                    if not v <= TP_TOL]
            if not rec["bytes_exact"] or not rec["cut_leaves"]:
                bad.append((r, name, "moment bytes", rec["moment_bytes"]))
            calls = rec["collectives_a_step"]
            if not (calls["reduce_scatter"] and calls["all_gather"]):
                bad.append((r, name, "collectives", calls))
        for name, rec in got["cp"].items():
            bad += [(r, name, k, v) for k, v in rec["err"].items()
                    if not v <= TP_TOL]
            if not rec["partial_launches"] or rec["full_launches"]:
                bad.append((r, name, "launches", rec["partial_launches"],
                            rec["full_launches"]))
    worst = {k: max(rec["err"][k] for got in ranks
                    for rec in got["zero"].values())
             for k in ranks[0]["zero"][str(ZERO_MESHES[0])]["err"]}
    worst_cp = {k: max(rec["err"][k] for got in ranks
                       for rec in got["cp"].values())
                for k in ("logits", "cache")}
    log(f"19a largest errors over ranks and meshes {json.dumps(worst)}; "
        f"19b {json.dumps(worst_cp)}; tolerance {TP_TOL}; rank seconds "
        f"{json.dumps(ranks[0]['seconds'])} ({card})")
    if bad:
        raise SmokeFailure(f"19a-b: ranks differ: {bad}")
    return {"single_s": single_s}


def long_rank0(torch, card: str, mesh, params, draw: dict) -> dict:
    """(19c) jamba-1.5-large-398b at long_500k as rank 0 of the pod mesh
    in the fake group (``pod_main``): its blocks ``params`` (cast, as
    18b drew them: ``draw`` is that record), its block of the
    sequence-split cache (random rows), held against planned bytes, then
    decode from each of LONG_STARTS: ms a step, launches and collectives
    a step, busy share under the profiler."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed import collectives
    from repro_torch.kernels import decode_attn, ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import init_cache, init_params
    start = time.perf_counter()
    shape = SHAPES["long_500k"]
    cfg = get_config(JAMBA)
    par = dryrun.parallel(mesh, shape)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cache = init_cache(cfg, shape.global_batch, shape.seq_len, "cuda", par)
    gen = torch.Generator(device="cuda").manual_seed(2)
    for t in _kv_leaves(cache):        # as a long prompt would leave them
        t.normal_(generator=gen)
    tok = torch.randint(0, cfg.vocab_size, (1, 1), generator=gen,
                        device="cuda", dtype=torch.int32)
    pos = torch.zeros((1,), dtype=torch.int32, device="cuda")
    meta = {"params": init_params(cfg, torch.Generator(), "meta", cast=True),
            "cache": init_cache(cfg, 1, shape.seq_len, "meta"),
            "tokens": torch.empty((1, 1), dtype=torch.int32, device="meta"),
            "pos": torch.empty((1,), dtype=torch.int32, device="meta")}
    mem = dryrun.memory_per_rank(par.rules(cfg), meta, mesh.shape,
                                 {"params": params, "cache": cache,
                                  "tokens": tok, "pos": pos})
    step = make_serve_step(cfg, par)
    runs = {}
    for label, first in LONG_STARTS.items():
        def at(i):
            return torch.full((1,), first + i, dtype=torch.int32,
                              device="cuda")
        tok, logits, cache = step(params, cache, tok, at(-1))    # warm
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        collectives.reset_counts()
        t0 = time.perf_counter()
        for i in range(LONG_STEPS):
            tok, logits, cache = step(params, cache, tok, at(i))
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / LONG_STEPS
        launches = ops.launch_counts()
        modes = dict(decode_attn.mode_launches)
        coll = dict(collectives.calls)
        with primed_profile(torch, cpu=False) as prof:
            t0 = time.perf_counter()
            for i in range(LONG_PROFILED):
                tok, logits, cache = step(params, cache, tok, at(i))
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3 / LONG_PROFILED
        busy_ms = sum(k[0] for k in device_times(prof, LONG_PROFILED))
        runs[label] = {
            "positions": [first, first + LONG_STEPS - 1], "step_ms": step_ms,
            "profiled_step_ms": prof_ms, "busy_ms": busy_ms,
            "busy_share": busy_ms / prof_ms,
            "launches_a_step": {k: v / LONG_STEPS for k, v in launches.items()
                                if v},
            "partial_launches": modes["partial"],
            "full_launches": modes["full"],
            "collectives_a_step": {k: v / LONG_STEPS for k, v in coll.items()
                                   if v},
            "finite": bool(torch.isfinite(logits.float()).all())}
    rec = {"arch": JAMBA, "shape": "long_500k", "layers": cfg.n_layers,
           "draw_s": draw["draw_s"], "draw_peak_gib": draw["draw_peak_gib"],
           "held": mem["held"], "planned": mem["planned"],
           "held_gib": {k: v / 2**30 for k, v in mem["held"].items()},
           "kv_block_rows": [t.shape[1] for t in _kv_leaves(cache)][:1],
           "decode_peak_gib": (torch.cuda.max_memory_allocated() - base
                               + _tree_bytes(params)) / 2**30,
           "runs": runs, "seconds": time.perf_counter() - start}
    log(f"19c {JAMBA} long_500k ({card}): " + json.dumps(rec))
    if mem["held"] != mem["planned"] or not all(
            r["finite"] and r["partial_launches"] and not r["full_launches"]
            for r in runs.values()):
        raise SmokeFailure(f"19c: held {mem['held']} against planned "
                           f"{mem['planned']}, runs {runs}")
    return rec


def _tree_bytes(tree) -> int:
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def check_decode_partial(torch, s: int, pos_list, iters: int = 20,
                         heads: int = 8) -> dict:
    """(19d) ``decode_attention``'s partial mode at 19c's rank-0 shape:
    q (1, 1, 4, 128) over a view of one KV head of a (1, s, heads, 128)
    bf16 cache block, against its plain version, SDPA and its bound;
    and an empty window (pos = -1): out 0, lse -inf."""
    import torch.nn.functional as F

    from repro_torch.kernels import build, decode_attn
    b, hkv, g, hd = 1, 1, 4, 128
    gen = torch.Generator(device="cuda").manual_seed(s)
    q = torch.randn((b, hkv, g, hd), generator=gen, device="cuda") \
        .to(torch.bfloat16)
    k, v = (torch.randn((b, s, heads, hd), generator=gen, device="cuda")
            .to(torch.bfloat16).narrow(2, 0, hkv).transpose(1, 2)
            for _ in range(2))
    pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
    out, lse = decode_attn.decode_attention_partial(q, k, v, pos)
    want, want_lse = decode_attn.decode_attention_partial_plain(q, k, v, pos)
    err = max(float((out - want).abs().max()),
              float((lse - want_lse).abs().max()))
    tol = 2e-4                   # f32 math on the same bf16 rows, S-long sums
    empty_o, empty_l = decode_attn.decode_attention_partial(
        q, k, v, torch.full((b,), -1, dtype=torch.int32, device="cuda"))
    empty = bool((empty_o == 0).all() and torch.isneginf(empty_l).all())
    rows = sum(min(p, s - 1) + 1 for p in pos_list)
    nbytes = q.numel() * 2 + 2 * hkv * rows * hd * 2 + q.numel() * 4 \
        + 4 * b * hkv * g + 4 * b
    b_ms, b_by = bound(nbytes, 4.0 * hkv * g * hd * rows, "bfloat16")
    q_lib = q.reshape(b, hkv * g, 1, hd)
    mask = (torch.arange(s, device="cuda")[None, :] <= pos[:, None])[
        :, None, None, :]

    def library():
        return F.scaled_dot_product_attention(q_lib, k, v, attn_mask=mask,
                                              enable_gqa=g > 1)
    # The normal mode at the same shape and splits, beside the partial one.
    normal_ms = time_ms(torch, lambda: decode_attn.decode_attention(
        q, k, v, pos), iters)[0]
    return timed_record(
        torch, {"name": "decode_attention", "normal_mode_ms": normal_ms,
                "shape": f"partial mode, q({b},{hkv},{g},{hd}) S_loc={s} "
                         f"view of one head of ({b},{s},{heads},{hd}) "
                         f"pos={pos_list} bf16 (jamba long_500k rank 0)",
                "splits": list(decode_attn.decode_splits(b, hkv, s,
                                                         build.sm_count(0))),
                "max_abs_err": err, "tol": tol,
                "ok": err <= tol and empty, "empty_window_ok": empty,
                "bound_ms": b_ms, "bound_by": b_by},
        kernel=lambda: decode_attn.decode_attention_partial(q, k, v, pos),
        plain=lambda: decode_attn.decode_attention_partial_plain(q, k, v,
                                                                 pos),
        library=library, iters=iters)


def phase_zero_cp(torch, card: str) -> list[tuple[str, dict, int]]:
    """Phase 19 (a-d).  19c ran in 18b's process (``pod_main``), whose
    record it reads.  Returns the kernel row of 19d with 19c's partial
    launches."""
    seconds = {}
    t = time.perf_counter()
    phase_zero_cp_values(torch, card)
    seconds["19a-b"] = round(time.perf_counter() - t, 1)
    if not LONG_RESULT.exists():
        raise SmokeFailure("19c: no record from 18b's process")
    long = json.loads(LONG_RESULT.read_text())
    seconds["19c"] = round(long["seconds"], 1)
    t = time.perf_counter()
    s_loc = long["kv_block_rows"][0]
    rec = check_decode_partial(torch, s_loc, [s_loc - 1])
    log("kernel " + json.dumps(rec))
    if not rec["ok"]:
        raise SmokeFailure(f"decode_attention partial at {rec['shape']}: "
                           f"{rec}")
    seconds["19d"] = round(time.perf_counter() - t, 1)
    log(f"phase 19 seconds {json.dumps(seconds)} ({card})")
    launches = sum(r["partial_launches"] for r in long["runs"].values())
    return [("decode_attention", rec, launches)]


# --------------------------------------------------------------------- #
# The CPU sides of phases 7, 10 and 11's card-vs-CPU checks
# --------------------------------------------------------------------- #

# Each job is the CPU half of a later phase's check: the same calls on
# the same seeded world, on the CPU's plain versions.  ``run_cpu_ref``
# runs one while the gloo ranks of 18a and 19a-b work on the card (this
# process waits on them otherwise); ``cpu_ref`` hands its result to the
# phase, or computes it there when no job ran it.
_CPU_REFS: dict = {}


def _fleet_cpu():
    """Phase 7's: the paper world's ``run()`` and the two smallest
    fractions of its sweep on the CPU."""
    import numpy as np
    cpu_sim, t_build = build_fleet(fleet_world(), "cpu")
    t0 = time.perf_counter()
    res = cpu_sim.run()
    t_run = time.perf_counter() - t0
    u = np.random.default_rng(1).random(cpu_sim.n_requests)
    masks = u[None, :] < np.asarray(FLEET_FRACTIONS)[:, None]
    return t_build, res, t_run, [cpu_sim.run(active=masks[i]) for i in (0, 1)]


def _batched_cpu():
    """Phase 10's: the batched ``run()`` on the CPU, then probed (its
    simulator too, for the phase's flight log)."""
    from repro_torch.traffic import BatchingConfig
    cpu_sim, t_build = build_fleet(fleet_world(), "cpu",
                                   batching=BatchingConfig(b_max=BATCH_B_MAX))
    t0 = time.perf_counter()
    res = cpu_sim.run()
    t_run = time.perf_counter() - t0
    return cpu_sim, t_build, res, t_run, probed_cpu_run(cpu_sim)


def admission_world(world):
    """Phase 9's ground segment (the 8 default gateways, 10 degrees) and
    its 60 s trace at 2 requests/s over them."""
    import numpy as np

    from repro_torch import core
    from repro_torch.traffic import build_ground_segment, sample_requests
    ground = build_ground_segment(world[4], core.LinkConfig(),
                                  min_elevation_deg=10.0)
    req = sample_requests(np.random.default_rng(8), rate_rps=2.0,
                          horizon_s=60.0, n_stations=ground.n_stations)
    return ground, req


def _aimd_cpu():
    """Phase 9's AIMD ``run_many`` over its latency targets (from this
    simulator's zero-load p99 TTFT; phase 9 takes it where its card's
    targets are the same bit for bit) and phase 10's probed AIMD
    ``run()``, on the CPU."""
    import numpy as np

    from repro_torch.traffic import AdmissionConfig, QueueConfig
    world = fleet_world()
    ground, req = admission_world(world)
    cpu_sim, _ = build_fleet(world, "cpu", qcfg=QueueConfig(
        admission=AdmissionConfig(policy="aimd")), ground=ground, req=req)
    base = cpu_sim.run(zero_load=True)
    p99 = max(p.quantile("ttft", 0.99) for p in base.plans)
    targets = np.asarray(ADM_TARGET_SCALES) * p99
    masks = np.ones((len(targets), cpu_sim.n_requests), dtype=bool)
    t0 = time.perf_counter()
    many = cpu_sim.run_many(masks, ttft_targets=targets)
    return {"targets": targets, "many": many,
            "t_many": time.perf_counter() - t0,
            "probed": probed_cpu_run(cpu_sim)}


def _ctrl_cpu():
    """Phase 11 (b)'s: the bench_ctrl grid in one ``run_replan_grid`` on
    the CPU."""
    cpu_sim, scores, rcfg, _ = ctrl_world("cpu")
    t0 = time.perf_counter()
    grid = cpu_sim.run_replan_grid(
        rcfg, base_scores=scores, cadences=list(CTRL_CADENCES),
        mig_weights=list(CTRL_MIG_WEIGHTS),
        ttft_targets=list(CTRL_TTFT_TARGETS))
    return scores, grid, time.perf_counter() - t0


CPU_JOBS = {"fleet": _fleet_cpu, "batched": _batched_cpu, "ctrl": _ctrl_cpu,
            "aimd": _aimd_cpu}


def run_cpu_ref(*keys: str) -> None:
    for key in keys:
        t0 = time.perf_counter()
        _CPU_REFS[key] = CPU_JOBS[key]()
        log(f"CPU reference {key!r} computed while the ranks ran: "
            f"{time.perf_counter() - t0:.1f}s")


def cpu_ref(key: str):
    return _CPU_REFS.pop(key) if key in _CPU_REFS else CPU_JOBS[key]()


# --------------------------------------------------------------------- #
# Phase 7: the fleet simulator on the paper's world
# --------------------------------------------------------------------- #


def fleet_world():
    """The paper's constellation, llama-moe-3.5b's MoE shape, 3 plans and
    a 60 s trace at 2 requests/s (seeded); the constellation last."""
    import numpy as np

    from repro_torch import core
    from repro_torch.traffic import sample_requests
    t0 = time.perf_counter()
    con = core.Constellation(core.ConstellationConfig())
    topo = core.sample_topology(con, core.LinkConfig(),
                                np.random.default_rng(0))
    t_topo = time.perf_counter() - t0
    act = core.ActivationModel.zipf(32, 8, 2, seed=0)
    rng = np.random.default_rng(3)
    plans = [core.spacemoe_plan(con, topo, act),
             core.rand_intra_cg_plan(con.cfg, 32, 8, rng),
             core.rand_place_plan(con.cfg, 32, 8, rng)]
    req = sample_requests(np.random.default_rng(8), rate_rps=2.0,
                          horizon_s=60.0, n_stations=1)
    log(f"fleet world: {con.cfg.n_sats} satellites, {topo.n_slots} slots, "
        f"topology {t_topo:.1f}s, plans {time.perf_counter() - t0 - t_topo:.1f}s; "
        f"R={req.n_requests} requests, N={req.total_decode_tokens} decode "
        f"tokens")
    return topo, act, plans, req, con


def build_fleet(world, device, seed=5, qcfg=None, ground=None, req=None,
                **kw):
    """``FleetSim`` over ``world``; ``seed`` seeds the engine's expert
    draws, which set the unloaded horizon and so T.  ``qcfg``, ``ground``
    and ``req`` replace ``QueueConfig()``, no ground segment and the
    world's trace; ``kw`` (``batching``, ``probes``) go to ``FleetSim``."""
    import numpy as np

    from repro_torch import core
    from repro_torch.traffic import FleetSim, QueueConfig
    topo, act, plans, world_req = world[:4]
    t0 = time.perf_counter()
    sim = FleetSim(plans, topo, act, core.MoEWorkload.llama_moe_3p5b(),
                   core.ComputeConfig(), world_req if req is None else req,
                   np.random.default_rng(seed),
                   qcfg=QueueConfig() if qcfg is None else qcfg,
                   ground=ground, device=device, **kw)
    if device == "cuda":
        torch_sync()
    return sim, time.perf_counter() - t0


def torch_sync():
    import torch
    torch.cuda.synchronize()


def assert_parity(res_a, res_b, what, rtol=1e-5) -> int:
    """The reference's fused-vs-legacy criterion: identical served sets,
    goodput to 1e-9, TTFT/E2E per request and as quantiles to rtol; and
    each token's latency (queueing included, finite whether or not its
    request was served) to rtol.  Returns the requests served, summed
    over the plans."""
    import numpy as np
    for pa, pb in zip(res_a.plans, res_b.plans, strict=True):
        ok = np.array_equal(pa.served, pb.served) and np.isclose(
            pa.goodput_tok_s, pb.goodput_tok_s, rtol=1e-9, atol=0.0)
        for arr in ("ttft_s", "e2e_s", "token_total_s"):
            ok = ok and np.allclose(getattr(pa, arr), getattr(pb, arr),
                                    rtol=rtol, atol=0.0, equal_nan=True)
        for which in ("ttft", "e2e", "tpot"):
            for q in (0.5, 0.99):
                a, b = pa.quantile(which, q), pb.quantile(which, q)
                ok = ok and ((np.isnan(a) and np.isnan(b))
                             or bool(np.isclose(a, b, rtol=rtol)))
        if not ok:
            raise SmokeFailure(f"{what}: plan {pa.plan_name} differs")
    return sum(int(p.served.sum()) for p in res_a.plans)


def fleet_host_steps(torch, sim, res) -> dict[str, float]:
    """``FleetSim.run()`` (all requests active) step by step, as its
    ``_launch`` and ``run`` take them, each step timed on the host clock
    and ended in a synchronize (ms): ``chunk_table``, the iteration-1
    plane (``np.bincount``, per-row sums), the upload (f32 cast and
    host-to-device copies), the fused fixed point on the card, and the
    device-to-host copies with ``_finalize``.  The result must equal
    ``res``, a ``run()`` of ``sim``, bit for bit.  Under admission the
    targets' upload joins the upload; under batching the bincount step
    takes the three planes and ``law0`` is iteration 1's law on the
    host."""
    import numpy as np

    from repro_torch.traffic import batching, queueing
    t_bins, n_rows, dev = sim.n_bins, sim.n_rows, sim.device
    adm_on = sim.admission_on
    active = np.ones(sim.n_requests, dtype=bool)
    times: dict[str, float] = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        return out

    t_all = time.perf_counter()
    ct = step("chunk_table", lambda: sim.chunk_table(active[None, :]))

    def planes():
        out = [np.bincount(ct["flat0"], weights=ct[k],
                           minlength=n_rows * t_bins).reshape(
            1, n_rows, t_bins).astype(np.float64, copy=False)
            for k in ("work0", "wdec0", "cnt0") if k in ct]
        if sim._mig_rm is not None:
            out[0] += sim._mig_rm[None]
        return out, out[0].sum(axis=2)
    planes0, work0_sum = step("bincount", planes)
    plane0 = planes0[0]
    if sim.batching is not None:
        plane0 = step("law0", lambda: batching.effective_work_np(
            *planes0, sim._batch_table, sim._batch_cap,
            sim._batch_window)[0])

    def upload():
        chunks = {k: torch.from_numpy(ct[k]).to(dev)
                  for k in ("src", "offs", "work", "fprow", "row_ptr", "fpr",
                            "wdec", "cntw")
                  if k in ct}
        targets = sim._targets(1, None, None) if adm_on else ()
        batch = None if sim.batching is None else dict(
            table=torch.from_numpy(sim._batch_table).to(dev),
            bcap=sim._batch_cap, window=sim._batch_window)
        return (chunks, torch.from_numpy(plane0.astype(np.float32)).to(dev),
                torch.from_numpy(work0_sum).to(dev), targets, batch)
    chunks, work0, work0_sum, targets, batch = step("upload", upload)
    out = step("fixed_point", lambda: queueing._fleet_fixed_point(
        sim._device_tables(), chunks, work0, work0_sum,
        max(1, sim.qcfg.iterations), t_bins, n_rows, True, *targets,
        batch=batch))

    def finalize():
        host = {k: v.cpu().numpy()[0] for k, v in out.items() if k != "wait"}
        host["work_sum"] = sim._expand_rows(host["work_sum"])
        return sim._finalize(active, host, adm_on, None)
    again = step("finalize", finalize)
    times["total"] = (time.perf_counter() - t_all) * 1e3
    assert_parity(res, again, "run() itemized vs run()", rtol=0.0)
    if adm_on:
        same_admission(res, again, "run() itemized vs run()")
    return times


def phase_fleet(torch) -> tuple[dict, dict, dict, tuple]:
    """Returns (launch counts of run(), the kernels' captured inputs, their
    device ms per launch in the profiled run(), the world)."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.traffic import queueing
    world = fleet_world()
    sim, t_build = build_fleet(world, "cuda")
    n_real = sim._f_req.size
    log(f"fleet FleetSim on the card: T={sim.n_bins} bins, "
        f"{sim.n_rows} compact rows, {n_real} chunks, built in "
        f"{t_build:.1f}s")
    for seed in (0, 13):               # T moves with the draws' seed
        other, _ = build_fleet(world, "cuda", seed=seed)
        log(f"fleet FleetSim with draw seed {seed}: T={other.n_bins} bins, "
            f"{other.n_rows} compact rows, {other._f_req.size} chunks")
        del other

    # Capture the inputs run() gives each kernel (the wrappers still count).
    captured: dict = {}
    real_deposit, real_scan = queueing.deposit, queueing.backlog_scan

    def deposit_rec(rows, cols, vals, n_rows, n_cols, row_ptr,
                    key="deposit"):
        captured.setdefault(key, (
            rows.clone(), cols.clone(), vals.clone(), n_rows, n_cols,
            row_ptr.clone()))
        return real_deposit(rows, cols, vals, n_rows, n_cols,
                            row_ptr=row_ptr)

    def scan_rec(work, cap, dt, key="backlog_scan"):
        captured.setdefault(key, (work.clone(), cap, dt))
        return real_scan(work, cap, dt)

    queueing.deposit, queueing.backlog_scan = deposit_rec, scan_rec
    try:
        ops.reset_launch_counts()
        res = sim.run()
        torch_sync()
        counts = ops.launch_counts()
    finally:
        queueing.deposit, queueing.backlog_scan = real_deposit, real_scan
    want = {"deposit": 2, "backlog_scan": 3}       # iterations=3: 2 + 3
    log(f"fleet run() launch counts {json.dumps(counts)} (expected "
        f"{json.dumps(want)} for iterations={sim.qcfg.iterations})")
    if {k: counts[k] for k in want} != want:
        raise SmokeFailure(f"fleet launch counts {counts} != {want}")

    walls = []
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    for _ in range(2):
        t0 = time.perf_counter()
        again = sim.run()
        torch_sync()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - mem0
    log(f"fleet run(): peak device memory {peak / 2**20:.1f} MiB above what "
        "it held before")
    assert_parity(res, again, "card run() vs card run()", rtol=0.0)
    with primed_profile(torch) as prof:
        t0 = time.perf_counter()
        sim.run()
        torch_sync()
        prof_wall = time.perf_counter() - t0
    kernels = device_times(prof, 1)
    in_run, seen = {}, {}
    for name, cuda_names in FLEET_KERNELS.items():
        hits = [(ms, calls) for ms, calls, key in kernels
                if any(k in key for k in cuda_names)]
        seen[name] = sorted(calls for _, calls in hits)
        in_run[name] = sum(ms for ms, _ in hits) / want[name]
    log(f"fleet run() profile: {primer_launches(prof)} of the "
        f"{PROFILE_PRIMER} primer launches recorded")
    if any(seen[n] != [want[n]] * len(FLEET_KERNELS[n]) for n in want):
        raise SmokeFailure(f"the profiled fleet run() recorded launches "
                           f"{seen} of {FLEET_KERNELS}, not {want} of each: "
                           "its busy share would be short")
    busy = sum(k[0] for k in kernels) / 1e3
    log(f"fleet run(): {min(walls) * 1e3:.1f} ms wall (best of 2, "
        f"synchronized); under the profiler {prof_wall * 1e3:.1f} ms wall, "
        f"device kernels {busy * 1e3:.1f} ms -> device busy "
        f"{busy / prof_wall:.1%}, idle {1 - busy / prof_wall:.1%} "
        f"({sum(k[1] for k in kernels):.0f} kernel launches)")
    for ms, calls, name in sorted(kernels, reverse=True)[:10]:
        log(f"fleet profile: {ms:9.3f} ms {calls:6.0f} calls  {name[:80]}")
    for _ in range(2):
        steps = fleet_host_steps(torch, sim, res)
        log(f"fleet run() itemized (host clock, each step ends in a "
            f"synchronize; ms): {json.dumps(steps)}")
    for p in res.plans:
        log(f"fleet plan {p.plan_name}: served {int(p.served.sum())}/"
            f"{int(p.active.sum())}, goodput {p.goodput_tok_s:.3f} tok/s, "
            f"TTFT p50 {p.quantile('ttft', 0.5):.3f} s p99 "
            f"{p.quantile('ttft', 0.99):.3f} s, E2E p99 "
            f"{p.quantile('e2e', 0.99):.3f} s")
        r = sim.n_requests
        ok = (p.served.shape == p.ttft_s.shape == p.e2e_s.shape == (r,)
              and np.isfinite(p.ttft_s[p.served]).all()
              and np.isnan(p.ttft_s[~p.served]).all()
              and (p.e2e_s[p.served] >= p.ttft_s[p.served]).all()
              and np.isfinite(p.token_total_s).all())
        if not ok:
            raise SmokeFailure(f"fleet plan {p.plan_name}: outputs of the "
                               "wrong shape or non-finite where served")

    # run_many over the bench_fleet thinning fractions.
    u = np.random.default_rng(1).random(sim.n_requests)
    masks = u[None, :] < np.asarray(FLEET_FRACTIONS)[:, None]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    many = sim.run_many(masks)
    torch_sync()
    t_many = time.perf_counter() - t0
    many_counts = ops.launch_counts()
    # One more, untimed call keeps run_many's first deposit and scan
    # inputs for phase 8.
    queueing.backlog_scan = lambda *a: scan_rec(*a, key="backlog_scan_many")
    queueing.deposit = lambda *a, row_ptr: deposit_rec(
        *a, row_ptr, key="deposit_many")
    try:
        sim.run_many(masks)
    finally:
        queueing.deposit, queueing.backlog_scan = real_deposit, real_scan
    log(f"fleet run_many over {len(FLEET_FRACTIONS)} fractions: "
        f"{t_many * 1e3:.1f} ms wall (synchronized), launch counts "
        f"{json.dumps(many_counts)}")
    if {k: many_counts[k] for k in want} != want:
        raise SmokeFailure(f"run_many launch counts {many_counts} != {want}")
    for frac, r in zip(FLEET_FRACTIONS, many):
        p = r.plans[0]
        log(f"fleet sweep {frac:.2f}: offered {p.offered_rps:.3f} rps, "
            f"served {sum(int(q.served.sum()) for q in r.plans)} over the "
            f"plans, {p.plan_name} goodput {p.goodput_tok_s:.3f} tok/s, "
            f"TTFT p99 {p.quantile('ttft', 0.99):.3f} s")
    assert_parity(many[-1], res, "run_many(fraction 1.0) vs run()",
                  rtol=1e-12)

    # The card against the CPU's plain versions: the full run() (in this
    # world every request overflows at the full rate, so there only the
    # per-token latencies carry numbers) and the two smallest fractions,
    # which must serve some.
    t_cpu_build, res_cpu, t_cpu, rows_cpu = cpu_ref("fleet")
    for what, got, want_res in [("run()", res, res_cpu)] + [
            (f"run_many row {FLEET_FRACTIONS[i]:.2f}", many[i], rows_cpu[i])
            for i in (0, 1)]:
        served = assert_parity(want_res, got, f"card {what} vs CPU")
        exact = all(
            np.array_equal(getattr(a, k), getattr(b, k), equal_nan=True)
            for a, b in zip(want_res.plans, got.plans)
            for k in ("ttft_s", "e2e_s", "token_total_s"))
        log(f"fleet card vs CPU {what}: parity holds, {served} requests "
            f"served over the plans on both, bitwise equal: {exact}")
        if what != "run()" and served == 0:
            raise SmokeFailure(f"fleet card vs CPU {what}: no request "
                               "served, the comparison would be empty")
    log(f"fleet CPU construction {t_cpu_build:.1f}s, CPU run() {t_cpu:.1f}s")
    return counts, captured, in_run, world


# --------------------------------------------------------------------- #
# Phase 8: the fleet kernels on the inputs run() gave them
# --------------------------------------------------------------------- #


def deposit_table_stats(torch, rows, cols, vals, n_rows, n_cols,
                        row_ptr) -> dict:
    """The shape of a deposit table that the kernel's time rests on:
    triples per row (median, max), per (row, tile) bucket (max; tiles of
    ``deposit.TILE`` bins), the most triples on one cell (the longest
    chain of dependent adds, also counting only the non-zero values the
    kernel adds), and the shares of zero-valued triples and of triples
    on the last bin (T - 1, where the fleet clamps times past its
    horizon)."""
    from repro_torch.kernels import deposit
    n = int(row_ptr[-1])
    r, c, v = rows[:n], cols[:n], vals[:n]
    per_row = (row_ptr[1:] - row_ptr[:-1]).float()
    tiles = deposit.deposit_tiles(n_cols)
    buckets = torch.bincount(r * tiles + c // deposit.TILE)
    flat = r * n_cols + c
    cells = torch.unique(flat, return_counts=True)[1]
    nonzero = torch.unique(flat[v != 0], return_counts=True)[1]
    return {"triples": n, "per_row_median": float(per_row.median()),
            "per_row_max": int(per_row.max()),
            "per_bucket_max": int(buckets.max()) if n else 0,
            "per_cell_max": int(cells.max()) if n else 0,
            "per_cell_max_nonzero": (int(nonzero.max())
                                     if nonzero.numel() else 0),
            "zero_share": float((v == 0).float().mean()) if n else 0.0,
            "last_bin_share": (float((c == n_cols - 1).float().mean())
                               if n else 0.0)}


def deposit_bound(n_real: int, n_rows: int, n_cols: int) -> tuple[float, str]:
    """What deposit must move: each real triple's bin and value (int64 +
    f64; rows are implied by row_ptr, the padding is not read), row_ptr,
    and the f64 plane written once; one add a triple."""
    nbytes = 16 * n_real + 8 * (n_rows + 1) + 8 * n_rows * n_cols
    return bound(nbytes, n_real, "float64")


def check_deposit(torch, table, what: str) -> dict:
    """deposit on a table the fleet passed it, against its plain version
    (bitwise), with its table's shape, its device time and the plain
    version's and the library call's, and the least time the card
    could take."""
    from repro_torch.kernels import deposit
    rows, cols, vals, n_rows, n_cols, row_ptr = table
    got = deposit.deposit(rows, cols, vals, n_rows, n_cols, row_ptr=row_ptr)
    torch.cuda.synchronize()
    want = deposit.deposit_plain(rows, cols, vals, n_rows, n_cols)
    same = bool(torch.equal(got, want))
    err = float((got - want).abs().max())
    del got, want
    n_real = int(row_ptr[-1])
    b_ms, b_by = deposit_bound(n_real, n_rows, n_cols)
    flat = rows * n_cols + cols

    def library():
        return torch.zeros(n_rows * n_cols, dtype=torch.float64,
                           device="cuda").index_put_((flat,), vals,
                                                     accumulate=True)
    return timed_record(
        torch, {"name": "deposit",
                "shape": f"{n_real} triples (+{rows.numel() - n_real} "
                         f"padding) into {n_rows} x {n_cols} f64, {what}",
                **deposit_table_stats(torch, rows, cols, vals, n_rows,
                                      n_cols, row_ptr),
                "scratch_bytes": deposit.scratch_bytes(rows.numel(), n_rows,
                                                       n_cols),
                "max_abs_err": err, "tol": 0.0, "ok": same,
                "bound_ms": b_ms, "bound_by": b_by},
        kernel=lambda: deposit.deposit(rows, cols, vals, n_rows, n_cols,
                                       row_ptr=row_ptr),
        plain=lambda: deposit.deposit_plain(rows, cols, vals, n_rows, n_cols),
        library=library, iters=5)


def phase_fleet_kernels(torch, captured, in_run) -> dict[str, dict]:
    """Each fleet kernel against its plain version on the inputs run()
    and run_many gave it.  ``in_run``: device ms per call inside the
    profiled run() (printed beside the kernel's own time)."""
    deps = [check_deposit(torch, captured.pop("deposit"), "run()"),
            check_deposit(torch, captured.pop("deposit_many"),
                          f"run_many over {len(FLEET_FRACTIONS)} fractions")]
    deps[0]["in_run_ms"] = in_run["deposit"]
    for dep in deps:
        log("kernel " + json.dumps(dep))

    work, cap, dt = captured["backlog_scan"]
    scans = [check_scan(torch, work, cap, dt, "run()")]
    scans[0]["in_run_ms"] = in_run["backlog_scan"]
    scans.append(check_scan(torch, *captured.pop("backlog_scan_many"),
                            f"run_many over {len(FLEET_FRACTIONS)} fractions"))
    scans.append(check_scan(torch, never_coalescing_plane(torch, work.shape,
                                                          cap, dt),
                            cap, dt, "built never to coalesce"))
    for rec in scans:
        log("kernel " + json.dumps(rec))
    bad = [rec["shape"] for rec in deps + scans if not rec["ok"]]
    if bad:
        raise SmokeFailure(f"fleet kernels disagree with their plain "
                           f"versions on {bad}")
    return {"deposit": deps[0], "backlog_scan": scans[0]}


def never_coalescing_plane(torch, shape, cap, dt, time_major=False):
    """A (T, C) work plane on which no chunk's two bracketing runs ever
    meet: half the cap in bin 0, then dt a bin, so every backlog sits at
    cap / 2 - dt, strictly inside (0, cap - dt); the run from 0 stays at
    0 and the run from cap - dt stays near it.  Laid out as the fleet
    passes its planes (a transposed view, bins contiguous), or
    ``time_major``."""
    t, c = shape
    work = torch.full((t, c) if time_major else (c, t), float(dt),
                      dtype=torch.float32, device="cuda")
    work = work if time_major else work.T
    work[0] = float(cap) / 2
    return work


def coalescence_stats(torch, coal, chunk: int, n_bins: int) -> dict:
    """From backlog_scan's coalescence report (chunks x columns): over the
    (column, chunk) pairs after the first chunk (which starts exactly),
    the share whose runs met, the mean bins to meeting over those, and
    the share of the plane's cells the fix-up re-reads (a warp re-runs
    the most bins any of its 32 columns needs), and the longest stretch
    of consecutive chunks in which one column never met (the fix-up runs
    those chunks one after another)."""
    from repro_torch.kernels.backlog_scan import TILE_COLS
    later = coal[1:].long()
    n_cols = coal.shape[1]
    if later.numel() == 0:
        return {"coalesced_share": None, "longest_serial_chunks": 0,
                "mean_bins_to_coalesce": None, "rerun_share": 0.0}
    met = later >= 0
    lengths = torch.full((later.shape[0], 1), chunk, device=coal.device)
    lengths[-1] = n_bins - chunk * later.shape[0]
    todo = torch.where(met, later, lengths)
    pad = -n_cols % TILE_COLS
    todo = torch.nn.functional.pad(todo, (0, pad)).reshape(
        later.shape[0], -1, TILE_COLS).amax(dim=2)
    live = torch.full((todo.shape[1],), TILE_COLS, device=coal.device)
    live[-1] -= pad                                    # columns a tile holds
    run = longest = torch.zeros(n_cols, dtype=torch.long, device=coal.device)
    for row in ~met:                  # consecutive chunks a column never met
        run = torch.where(row, run + 1, 0)
        longest = torch.maximum(longest, run)
    return {"coalesced_share": float(met.float().mean()),
            "longest_serial_chunks": int(longest.max()),
            "mean_bins_to_coalesce": (float(later[met].float().mean())
                                      if bool(met.any()) else None),
            "rerun_share": float((todo * live).sum()) / (n_bins * n_cols)}


def check_scan(torch, work, cap, dt, what: str) -> dict:
    """backlog_scan on ``work``, laid out as the fleet passed it (a
    transposed view of its (F, rows, T) plane), against its plain loop
    (bitwise), with its device time on that same tensor, the plain loop's
    wall time, its coalescence statistics and the least time the card
    could take."""
    from repro_torch.kernels import backlog_scan, build
    t_bins, n_cols = work.shape
    chunk = backlog_scan.scan_chunk(t_bins, n_cols, build.sm_count(0))
    coal = torch.empty((-(-t_bins // chunk), n_cols), dtype=torch.int32,
                       device="cuda")
    got = backlog_scan.backlog_scan(work, cap, dt, coalescence=coal)
    torch.cuda.synchronize()
    ms, wall_ms, hidden = time_ms(torch, lambda: backlog_scan.backlog_scan(
        work, cap, dt), iters=5)
    want = None

    def plain():
        nonlocal want
        want = backlog_scan.backlog_scan_plain(work.contiguous(), cap, dt)
    plain_ms = event_ms(torch, plain, iters=1, warm=False)
    b_ms, b_by = bound(8 * work.numel(), 4 * work.numel(), "float32")
    return {"name": "backlog_scan",
            "shape": f"({t_bins}, {n_cols}) f32, strides "
                     f"{tuple(work.stride())}, {what}",
            "chunk": chunk, **coalescence_stats(torch, coal, chunk, t_bins),
            "max_abs_err": float((got - want).abs().max()), "tol": 0.0,
            "ok": bool(torch.equal(got, want)), "bound_ms": b_ms,
            "bound_by": b_by, "ms": ms, "wall_ms": wall_ms, "hidden": hidden,
            "plain_ms": plain_ms, "plain_wall_ms": plain_ms,
            "plain_hidden": False, "library_ms": None,
            "library_wall_ms": None}


# --------------------------------------------------------------------- #
# Phase 9: the fleet with a ground segment and the admission controller
# --------------------------------------------------------------------- #


def same_admission(res_a, res_b, what) -> None:
    """Identical shed and retry sets, plan by plan."""
    import numpy as np
    for pa, pb in zip(res_a.plans, res_b.plans, strict=True):
        if not (np.array_equal(pa.shed, pb.shed)
                and np.array_equal(pa.retries, pb.retries)):
            raise SmokeFailure(f"{what}: plan {pa.plan_name} sheds or "
                               "retries differently")


def sm_clock_mhz() -> float:
    """The card's highest SM clock, MHz (nvidia-smi)."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {res.stderr.strip()}")
    return float(res.stdout.strip().splitlines()[0])


def ctrl_coalescence_stats(torch, coal, n_ctrl: int) -> dict:
    """From admission_ctrl's coalescence report (cells x chunks): over the
    (cell, chunk) pairs after the first chunk (which starts exactly), the
    share whose bracket runs met and the mean bins to meeting; the share
    of all (cell, control bin) steps run again after pass 1 (the bins
    before the meeting; a chunk that never met is run twice more, by the
    walk and by pass 2); and the longest stretch of consecutive chunks in
    one cell that never met (the walk runs those one after another)."""
    from repro_torch.kernels.admission_ctrl import ctrl_chunk
    chunk = ctrl_chunk(n_ctrl)
    live = -(-n_ctrl // chunk)
    later = coal[:, 1:live].long()
    lengths = [min(chunk, n_ctrl - j * chunk) for j in range(live)]
    if later.numel() == 0:
        return {"chunk": chunk, "coalesced_share": None,
                "mean_bins_to_coalesce": None, "rerun_share": 0.0,
                "longest_serial_chunks": 0}
    met = later >= 0
    n = torch.tensor(lengths[1:], device=coal.device)[None, :]
    redo = torch.where(met, later, 2 * n)
    run = longest = torch.zeros(coal.shape[0], dtype=torch.long,
                                device=coal.device)
    for col in (~met).T:
        run = torch.where(col, run + 1, 0)
        longest = torch.maximum(longest, run)
    return {"chunk": chunk, "coalesced_share": float(met.float().mean()),
            "mean_bins_to_coalesce": (float(later[met].float().mean())
                                      if bool(met.any()) else None),
            "rerun_share": float(redo.sum()) / (coal.shape[0] * n_ctrl),
            "longest_serial_chunks": int(longest.max())}


def check_ctrl(torch, win, args, kw, what: str) -> dict:
    """admission_ctrl on a window-maximum tensor, against its plain loop
    (bitwise), with its device time, the plain loop's wall time, its
    chunks' coalescence statistics, the byte/operation bound and the
    serial chain's bound."""
    from repro_torch.kernels import admission_ctrl
    n_ctrl, n_f, n_p = win.shape
    n_g = args[0].shape[-1]
    cells = n_f * n_p * n_g
    coal = torch.empty((cells, admission_ctrl.LANES), dtype=torch.int32,
                       device="cuda")
    got = admission_ctrl.admission_ctrl(win, *args, coalescence=coal, **kw)
    torch.cuda.synchronize()
    ms, wall_ms, hidden = time_ms(
        torch, lambda: admission_ctrl.admission_ctrl(win, *args, **kw),
        iters=20)
    want = None

    def plain():
        nonlocal want
        want = admission_ctrl.admission_ctrl_plain(win, *args, **kw)
    plain_ms = event_ms(torch, plain, iters=1, warm=False)
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    same = bool(torch.equal(nan_g, nan_w)) and bool(torch.equal(
        got[~nan_g].view(torch.int32), want[~nan_w].view(torch.int32)))
    nbytes = 4 * (win.numel() + got.numel() + sum(a.numel() for a in args)
                  + (n_p if kw["pid"] is not None else 0))
    # f32 operations a (cell, control bin) of this data needs: AIMD two
    # adds, two compares, one multiply or add and one max or min; PID the
    # two headrooms (add, subtract, divide each, where a target is
    # finite), their min, the clamped integral (3), delta (5) and the
    # clamped update (4).
    if kw["pid"] is None:
        per_step = 6
    else:
        finite = int(bool(torch.isfinite(args[3]).all())) \
            + int(bool(torch.isfinite(args[4]).all()))
        per_step = 3 * finite + 1 + 3 + 5 + 4
    b_ms, b_by = bound(nbytes, per_step * cells * n_ctrl, "float32")
    # The loop-carried chain of the plain loop's order: three dependent f32
    # operations a control bin (AIMD: multiply or add, max or min, select;
    # PID: add, max, min on both admit and the integral), about 4 cycles
    # each, over every control bin; a chunk of the kernel runs it over
    # ctrl_chunk(n_ctrl) bins.
    clock = sm_clock_mhz() * 1e3
    serial_ms = n_ctrl * 3 * 4 / clock
    return {"name": "admission_ctrl",
            "shape": f"win ({n_ctrl}, {n_f}, {n_p}) -> ({n_ctrl}, {n_f}, "
                     f"{n_p}, {n_g}) f32, "
                     f"{'AIMD' if kw['pid'] is None else 'PID'}, {what}",
            **ctrl_coalescence_stats(torch, coal, n_ctrl),
            "max_abs_err": float((got - want).abs().nan_to_num().max()),
            "tol": 0.0, "ok": same, "bound_ms": b_ms, "bound_by": b_by,
            "serial_bound_ms": serial_ms,
            "chunk_chain_ms": admission_ctrl.ctrl_chunk(n_ctrl) * 3 * 4
            / clock, "ms": ms, "wall_ms": wall_ms,
            "hidden": hidden, "plain_ms": plain_ms,
            "plain_wall_ms": plain_ms, "plain_hidden": False,
            "library_ms": None, "library_wall_ms": None}


def never_coalescing_windows(torch, n_ctrl, n_f, n_p, n_g, policy):
    """Window maxima and a cell on which no chunk's bracket runs ever meet.
    AIMD: admit0 = +inf and every window over the target, so the upper
    run stays at +inf (the true trajectory) while the lower one falls to
    admit_min.  PID: every window on the TTFT target (TPOT off), so err =
    0, the integral runs from -W and W never meet, and admit, which
    needs the integral, never starts.  The windows are k-contiguous, as
    admission_window returns them."""
    def full(shape, v):
        return torch.full(shape, v, dtype=torch.float32, device="cuda")
    kw = dict(increase=0.1, decrease=0.6, admit_min=0.05, pid=None)
    win = full((n_f, n_p, n_ctrl), 5.0 if policy == "aimd" else 3.0)
    win = win.permute(2, 0, 1)
    if policy == "aimd":
        admit0 = full((n_f, n_p, n_g), float("inf"))
    else:
        admit0 = full((n_f, n_p, n_g), 0.5)
        kw["pid"] = dict(kp=0.4, ki=0.05, kd=0.0, gain=full((n_p,), 1.0))
    return win, (full((n_p, n_g), 1.0), full((n_p,), 0.0), admit0,
                 full((n_f,), 4.0), full((n_f,), float("inf"))), kw


def window_bound(wait, work_last, tables, n_ctrl: int, seg) -> tuple:
    """The least time the card could take for admission_window: the wait
    plane, the last bin's work, the int32 station tables and the bins'
    slot and window read once, the maxima written once; f32 operations
    over the bins that belong to a window (the gateway sum, the expert
    maxima and their sum, and gateway + expert a (bin, f, p))."""
    n_bins, n_f, _ = wait.shape
    gw, ex = tables
    n_p, n_l = gw.shape[-2:]
    n_i = ex.shape[-1] // n_l
    nbytes = 4 * (wait.numel() + work_last.numel() + gw.numel() + ex.numel()
                  + 2 * n_bins + n_ctrl * n_f * n_p)
    bins = int((seg < n_ctrl).sum())
    ops = bins * n_f * n_p * ((n_l - 1) + n_l * (n_i - 1) + (n_l - 1) + 1)
    return bound(nbytes, ops, "float32")


def check_window(torch, args, what: str) -> dict:
    """admission_window on a wait trace the fleet gave it, against its
    plain version (bitwise), with its device time, the plain version's
    wall time and the least time the card could take."""
    from repro_torch.kernels import admission_window
    wait, work_last = args[0], args[1]
    seg, n_ctrl = args[7], args[8]
    got = admission_window.admission_window(*args)
    torch.cuda.synchronize()
    ms, wall_ms, hidden = time_ms(
        torch, lambda: admission_window.admission_window(*args), iters=20)
    want = None

    def plain():
        nonlocal want
        want = admission_window.admission_window_plain(*args)
    plain_ms = event_ms(torch, plain, iters=1, warm=False)
    b_ms, b_by = window_bound(wait, work_last, args[4:6], n_ctrl, seg)
    t, f, c = wait.shape
    n_p, n_l = args[4].shape[-2:]
    return {"name": "admission_window",
            "shape": f"wait ({t}, {f}, {c}) f32, stations "
                     f"{tuple(args[5].shape)} -> win ({n_ctrl}, {f}, "
                     f"{n_p}), {what}",
            "tile": admission_window.window_tile(
                f, c, n_p, n_l, args[5].shape[-1] // n_l,
                f if args[4].dim() == 4 else 1)[0],
            "max_abs_err": float((got - want).abs().max()), "tol": 0.0,
            "ok": bool(torch.equal(got, want)), "bound_ms": b_ms,
            "bound_by": b_by, "ms": ms, "wall_ms": wall_ms, "hidden": hidden,
            "plain_ms": plain_ms, "plain_wall_ms": plain_ms,
            "plain_hidden": False, "library_ms": None,
            "library_wall_ms": None}


def fleet_plan_lines(res, what: str) -> int:
    """Served, shed and retried requests per plan; returns the served
    total."""
    import numpy as np
    for p in res.plans:
        log(f"{what} plan {p.plan_name}: served {int(p.served.sum())}/"
            f"{int(p.active.sum())}, shed {int(p.shed.sum())}, admitted on "
            f"a retry {int((p.retries > 0).sum())}, goodput "
            f"{p.goodput_tok_s:.3f} tok/s, TTFT p50 "
            f"{p.quantile('ttft', 0.5):.3f} s p99 "
            f"{p.quantile('ttft', 0.99):.3f} s")
        ok = (p.served.shape == p.shed.shape == (p.active.size,)
              and not (p.served & p.shed).any()
              and np.isfinite(p.ttft_s[p.served]).all()
              and (p.e2e_s[p.served] >= p.ttft_s[p.served]).all()
              and np.isfinite(p.token_total_s).all())
        if not ok:
            raise SmokeFailure(f"{what} plan {p.plan_name}: outputs of the "
                               "wrong shape, served and shed, or non-finite")
    return sum(int(p.served.sum()) for p in res.plans)


def phase_fleet_admission(torch, world) -> tuple[dict, dict, dict, tuple]:
    """Returns (admission_window's and admission_ctrl's records on the AIMD
    run()'s last iteration, the launch counts of that run(), the AIMD
    simulators on the card and on the CPU)."""
    import copy

    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.traffic import (AdmissionConfig, QueueConfig, admission,
                                     queueing)
    t0 = time.perf_counter()
    ground, req = admission_world(world)
    log(f"admission world: {ground.n_stations} gateways (coverage "
        f"{ground.coverage():.3f}, ranked {ground.n_ranked} deep), built "
        f"{time.perf_counter() - t0:.1f}s; R={req.n_requests} requests, "
        f"N={req.total_decode_tokens} decode tokens")
    want = {"deposit": 2, "backlog_scan": 3, "admission_window": 3,
            "admission_ctrl": 3}
    captured: dict[str, list] = {}
    windows: dict[str, list] = {}
    tag = [None]
    real_ctrl, real_states = admission.admission_ctrl, queueing.controller_states
    real_window = admission.admission_window
    last_admit = []

    def ctrl_rec(win, *args, **kw):
        if tag[0] is not None:
            captured.setdefault(tag[0], []).append((win.clone(), args, kw))
        return real_ctrl(win, *args, **kw)

    def window_rec(*args):
        if tag[0] is not None:
            windows.setdefault(tag[0], []).append(
                tuple(a.clone() if torch.is_tensor(a) else a for a in args))
        return real_window(*args)

    def states_rec(*args, **kw):
        out = real_states(*args, **kw)
        last_admit[:] = [out[args[7]]]        # the trace: states[seg]
        return out
    admission.admission_ctrl, queueing.controller_states = ctrl_rec, states_rec
    admission.admission_window = window_rec
    sims, served = {}, 0
    try:
        for policy in ("aimd", "pid"):
            qcfg = QueueConfig(admission=AdmissionConfig(policy=policy))
            sim, t_build = build_fleet(world, "cuda", qcfg=qcfg,
                                       ground=ground, req=req)
            n_ctrl = int(sim._device_tables()["ctrl"].sum())
            twin = copy.copy(sim)
            t0 = time.perf_counter()
            twin._build_admission_tables(qcfg.admission, ground,
                                         sim.slots[:sim.n_requests],
                                         np.random.default_rng(0))
            t_tables = (time.perf_counter() - t0) * 1e3
            del twin
            log(f"{policy}: FleetSim on the card: T={sim.n_bins} bins, "
                f"SR={sim.n_rows} compact rows, n_ctrl={n_ctrl} control "
                f"bins, {sim._f_req.size} chunks, built in {t_build:.1f}s "
                f"(_build_admission_tables {t_tables:.1f} ms)")
            tag[0] = f"{policy} run()"
            ops.reset_launch_counts()
            res = sim.run()
            torch_sync()
            counts = ops.launch_counts()
            tag[0] = None
            log(f"{policy} run() launch counts {json.dumps(counts)} "
                f"(expected {json.dumps(want)})")
            if {k: counts[k] for k in want} != want:
                raise SmokeFailure(f"{policy} run() launch counts {counts} "
                                   f"!= {want}")
            if policy == "aimd":
                aimd_counts = counts
            walls = []
            for _ in range(2):
                t0 = time.perf_counter()
                again = sim.run()
                torch_sync()
                walls.append(time.perf_counter() - t0)
            assert_parity(res, again, f"{policy} card run() vs run()",
                          rtol=0.0)
            same_admission(res, again, f"{policy} card run() vs run()")
            with primed_profile(torch) as prof:
                t0 = time.perf_counter()
                sim.run()
                torch_sync()
                prof_wall = time.perf_counter() - t0
            kernels = device_times(prof, 1)
            busy = sum(k[0] for k in kernels) / 1e3
            adm_k = {name: [(ms, calls) for ms, calls, key in kernels
                            if f"{name}_kernel" in key]
                     for name in ("admission_window", "admission_ctrl")}
            log(f"{policy} run(): {min(walls) * 1e3:.1f} ms wall (best of 2, "
                f"synchronized); under the profiler {prof_wall * 1e3:.1f} ms "
                f"wall, device kernels {busy * 1e3:.1f} ms -> device busy "
                f"{busy / prof_wall:.1%}, idle {1 - busy / prof_wall:.1%} "
                f"({sum(k[1] for k in kernels):.0f} kernel launches, against "
                f"the earlier gather-based controller's 1,203 launches and "
                f"47.4 ms with copies under AIMD; "
                + "; ".join(f"{name} {sum(c for _, c in v):.0f} launches, "
                            f"{sum(m for m, _ in v):.4f} ms"
                            for name, v in adm_k.items()) + ")")
            for ms, calls, name in sorted(kernels, reverse=True)[:10]:
                log(f"{policy} profile: {ms:9.3f} ms {calls:6.0f} calls  "
                    f"{name[:80]}")
            steps = fleet_host_steps(torch, sim, res)
            q = sim._device_tables()
            resolve_ms = event_ms(
                torch, lambda: queueing._resolve_attempts(q, last_admit[0]),
                iters=5)
            log(f"{policy} run() itemized (host clock, each step ends in a "
                f"synchronize; ms): {json.dumps(steps)}; "
                f"_build_admission_tables {t_tables:.1f} (construction); "
                f"attempt resolve {resolve_ms:.3f} a fixed-point iteration "
                f"(CUDA events)")
            served += fleet_plan_lines(res, f"{policy} run()")
            cpu_sim, t_cpu_build = build_fleet(world, "cpu", qcfg=qcfg,
                                               ground=ground, req=req)
            t0 = time.perf_counter()
            res_cpu = cpu_sim.run()
            t_cpu = time.perf_counter() - t0
            n = assert_parity(res_cpu, res, f"{policy} card run() vs CPU")
            same_admission(res_cpu, res, f"{policy} card run() vs CPU")
            log(f"{policy} card vs CPU run(): parity holds, identical shed "
                f"and retries, {n} requests served over the plans on both "
                f"(CPU construction {t_cpu_build:.1f}s, run() {t_cpu:.1f}s)")
            sims[policy] = (sim, cpu_sim)

        # A latency-target sweep under AIMD, as bench_admission runs it.
        sim, cpu_sim = sims["aimd"]
        base = sim.run(zero_load=True)
        p99 = max(p.quantile("ttft", 0.99) for p in base.plans)
        targets = np.asarray(ADM_TARGET_SCALES) * p99
        masks = np.ones((len(targets), sim.n_requests), dtype=bool)
        tag[0] = "aimd run_many"
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        many = sim.run_many(masks, ttft_targets=targets)
        torch_sync()
        t_many = time.perf_counter() - t0
        many_counts = ops.launch_counts()
        tag[0] = None
        log(f"aimd run_many over ttft_targets {np.round(targets, 3).tolist()}"
            f" s ({list(ADM_TARGET_SCALES)} x the zero-load p99 TTFT "
            f"{p99:.3f} s): {t_many * 1e3:.1f} ms wall (synchronized), "
            f"launch counts {json.dumps(many_counts)}")
        if {k: many_counts[k] for k in want} != want:
            raise SmokeFailure(f"run_many launch counts {many_counts} != "
                               f"{want}")
        ref = _CPU_REFS.pop("aimd", None)
        if ref is not None and np.array_equal(ref["targets"], targets):
            many_cpu, t_cpu = ref["many"], ref["t_many"]
            _CPU_REFS["aimd probed"] = ref["probed"]
        else:          # no job ran it, or its zero-load p99 was not ours
            t0 = time.perf_counter()
            many_cpu = cpu_sim.run_many(masks, ttft_targets=targets)
            t_cpu = time.perf_counter() - t0
        for target, r, r_cpu in zip(targets, many, many_cpu):
            served += fleet_plan_lines(r, f"aimd target {target:.3f} s")
            assert_parity(r_cpu, r, f"aimd run_many target {target:.3f} vs "
                          "CPU")
            same_admission(r_cpu, r, f"aimd run_many target {target:.3f} vs "
                           "CPU")
        log(f"aimd card vs CPU run_many: parity holds at every target, "
            f"identical shed and retries (CPU run_many {t_cpu:.1f}s)")
    finally:
        admission.admission_ctrl = real_ctrl
        admission.admission_window = real_window
        queueing.controller_states = real_states
    if served == 0:
        raise SmokeFailure("no request served under admission: the card vs "
                           "CPU comparisons would hold only failures")

    wins = []
    for what, calls in windows.items():
        for i, args in enumerate(calls):
            rec = check_window(torch, args, f"{what} iteration {i + 1}")
            log("kernel " + json.dumps(rec))
            wins.append(rec)
    windows.clear()
    recs = []
    for what, calls in captured.items():
        for i, (win, args, kw) in enumerate(calls):
            rec = check_ctrl(torch, win, args, kw,
                             f"{what} iteration {i + 1}")
            log("kernel " + json.dumps(rec))
            recs.append(rec)
    win, args, _ = captured["aimd run()"][0]
    for policy in ("aimd", "pid"):
        never = never_coalescing_windows(torch, *win.shape,
                                         args[0].shape[1], policy)
        rec = check_ctrl(torch, *never, f"{policy.upper()} built never to "
                         "coalesce")
        log("kernel " + json.dumps(rec))
        if rec["coalesced_share"] != 0.0:
            raise SmokeFailure(f"the {policy} window tensor built never to "
                               f"coalesce coalesced: {rec}")
        recs.append(rec)
    bad = [r["shape"] for r in wins + recs if not r["ok"]]
    if bad or len(recs) != 11 or len(wins) != 9:
        raise SmokeFailure(f"admission kernels disagree with their plain "
                           f"versions on {bad} (or missed a call: "
                           f"{len(wins)} of 9 windows, {len(recs)} of 11 "
                           "cells)")
    return wins[2], recs[2], aimd_counts, sims["aimd"]


# --------------------------------------------------------------------- #
# Phase 10: the fleet with continuous batching and the flight recorder
# --------------------------------------------------------------------- #

#: The probe channels ``ProbeRecord`` carries (None where not recorded).
PROBE_CHANNELS = ("bins", "backlog_s", "util_s", "drops_s", "batch_b",
                  "qhat_s", "win_s", "admit", "gw_wait_s", "ex_wait_s")


def same_results(res_a, res_b, what) -> None:
    """Bit for bit: served sets and every latency array, NaNs included."""
    import numpy as np
    for pa, pb in zip(res_a.plans, res_b.plans, strict=True):
        for k in ("served", "ttft_s", "e2e_s", "token_total_s"):
            if not np.array_equal(getattr(pa, k), getattr(pb, k),
                                  equal_nan=k != "served"):
                raise SmokeFailure(f"{what}: plan {pa.plan_name} {k} differs")


def best_wall_ms(fn, n: int = 2) -> tuple[float, object]:
    """(best host-clock ms of ``n`` synchronized calls, the last result)."""
    walls, out = [], None
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        torch_sync()
        walls.append((time.perf_counter() - t0) * 1e3)
    return min(walls), out


def probed_cpu_run(cpu_sim):
    """(result, ``last_probes``, seconds) of a probed ``run()`` of a CPU
    simulator, its probes off again after."""
    from repro_torch.obs import ProbeConfig
    cpu_sim.probes = ProbeConfig()
    try:
        t0 = time.perf_counter()
        res = cpu_sim.run()
        return res, cpu_sim.last_probes, time.perf_counter() - t0
    finally:
        cpu_sim.probes = None


def check_probes(torch, sim, cpu_sim, what: str, cpu_probed=None) -> dict:
    """``FleetSim(probes=)`` on a card simulator and its CPU twin: a
    probes-off ``run()``, then probed ones, whose ``last_probes`` must be
    the CPU's on every channel, then probes off again, which must give the
    first result bit for bit; the flight log of the probed run exported
    and validated.  Returns the probe record's cost, measured in one more
    probed ``run()`` around its two steps, each ended in a synchronize:
    the channels' gathers on the card (``_probe_channels``) and the
    host's copies and unwrapping (``FleetSim._record_probes``); the
    probed and unprobed ``run()`` walls (best of 2 each, host clock), and
    the trace's event counts.  ``cpu_probed``: the CPU twin's probed
    ``run()`` (``probed_cpu_run``), where a CPU job ran it already."""
    import numpy as np

    from repro_torch.obs import (ProbeConfig, build_flight_log, chrome_trace,
                                 count_events, validate_trace)
    from repro_torch.traffic import queueing
    off_ms, before = best_wall_ms(sim.run)
    sim.probes = ProbeConfig()
    steps = {"gather_ms": 0.0, "record_ms": 0.0}
    real_channels, real_record = queueing._probe_channels, sim._record_probes

    def timed_step(key, fn):
        def call(*args, **kw):
            torch_sync()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch_sync()
            steps[key] += (time.perf_counter() - t0) * 1e3
            return out
        return call
    try:
        on_ms, probed = best_wall_ms(sim.run)
        queueing._probe_channels = timed_step("gather_ms", real_channels)
        sim._record_probes = timed_step("record_ms", real_record)
        try:
            sim.run()
        finally:
            queueing._probe_channels = real_channels
            del sim._record_probes
        rec = sim.last_probes
    finally:
        sim.probes = None
    cpu_res, cpu_rec, t_cpu = cpu_probed or probed_cpu_run(cpu_sim)
    for name in PROBE_CHANNELS:
        a, b = getattr(rec, name), getattr(cpu_rec, name)
        if (a is None) != (b is None) or (a is not None
                                          and not np.array_equal(a, b)):
            raise SmokeFailure(f"{what}: probe channel {name} differs "
                               "between the card and the CPU")
    assert_parity(cpu_res, probed, f"{what} probed, card vs CPU")
    same_results(before, probed, f"{what}: probed vs unprobed run()")
    same_results(before, sim.run(), f"{what}: probes-off run() after a "
                 "probed one")
    log_ = build_flight_log(sim, probed, scenario=what)
    trace = chrome_trace(log_)
    problems = validate_trace(json.loads(json.dumps(trace)))
    if problems:
        raise SmokeFailure(f"{what}: the flight-log trace fails its "
                           f"schema: {problems[:5]}")
    events = {ph: count_events(trace, "", ph) for ph in ("X", "C", "i", "M")}
    out = {**steps, "run_ms": off_ms,
           "probed_run_ms": on_ms, "recorded_bins": rec.n_recorded,
           "stride": rec.stride, "channels": [n for n in PROBE_CHANNELS
                                              if getattr(rec, n) is not None],
           "trace_events": events, "served": len(log_.served()),
           "control_events": len(log_.events), "cpu_probed_run_s": t_cpu}
    if rec.batch_b is not None:
        out["batch_b_max"] = float(rec.batch_b.max())
        out["batch_b_mean_where_decode"] = float(
            rec.batch_b[rec.batch_b > 1.0].mean()) \
            if (rec.batch_b > 1.0).any() else 1.0
    log(f"{what} probes: " + json.dumps(out))
    return out


def batching_bench_world():
    """The world of the reference's ``benchmarks/bench_batching.py`` at its
    non-fast setting (``bench_traffic._world(False)``): 17 x 16
    satellites, 20 slots, 16 MoE layers, Zipf 8 experts top-2, the 8
    default gateways at 10 degrees, SpaceMoE and RandIntra-CG plans, 180 s
    at 4 requests/s of short prompts; the constellation and the ground
    segment last."""
    import numpy as np

    from repro_torch import core
    from repro_torch.traffic import build_ground_segment, sample_requests
    con = core.Constellation(core.ConstellationConfig.scaled(17, 16,
                                                             n_slots=20))
    link = core.LinkConfig()
    topo = core.sample_topology(con, link, np.random.default_rng(0))
    act = core.ActivationModel.zipf(16, 8, 2, seed=0)
    ground = build_ground_segment(con, link, min_elevation_deg=10.0)
    plans = [core.spacemoe_plan(con, topo, act),
             core.rand_intra_cg_plan(con.cfg, 16, 8, np.random.default_rng(3))]
    req = sample_requests(np.random.default_rng(29), rate_rps=4.0,
                          horizon_s=180.0, n_stations=ground.n_stations,
                          prompt_median=4, prompt_max=16, decode_mean=8,
                          decode_max=16)
    return topo, act, plans, req, con, ground


def frontier_row(regime: str, fraction: float, plan) -> dict:
    """One frontier point, as ``bench_batching._frontier_row`` reports it."""
    import numpy as np

    def rnd(x, d):
        return round(float(x), d) if np.isfinite(x) else None
    return {"regime": regime, "fraction": fraction, "plan": plan.plan_name,
            "offered_rps": rnd(plan.offered_rps, 4),
            "goodput_tok_s": rnd(plan.goodput_tok_s, 3),
            "ttft_p99_s": rnd(plan.quantile("ttft", 0.99), 3),
            "drop_rate": round(plan.drop_rate, 4)}


def phase_batching_bench(torch) -> dict:
    """The reference's batching frontier rebuilt with the port: FIFO and
    ``BatchingConfig(b_max=8)``, each one ``run_many`` over the thinning
    fractions on the card against the CPU; ``b_max=1`` bitwise FIFO; the
    best goodput of each regime at p99 TTFT <= 2.5 x the zero-load p99,
    batched above FIFO (the benchmark's own gate)."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.traffic import BatchingConfig, QueueConfig
    t0 = time.perf_counter()
    world = batching_bench_world()
    ground = world[5]
    qcfg = QueueConfig(dt_s=0.05, tail_s=60.0)
    req = world[3]
    log(f"batching bench world: {world[4].cfg.n_sats} satellites, "
        f"{world[0].n_slots} slots, R={req.n_requests} requests, "
        f"N={req.total_decode_tokens} decode tokens, built "
        f"{time.perf_counter() - t0:.1f}s")
    regimes = {"fifo": None, "batched": BatchingConfig(b_max=BATCH_B_MAX),
               "b_max=1": BatchingConfig(b_max=1)}
    sims = {name: build_fleet(world, "cuda", seed=23, qcfg=qcfg,
                              ground=ground, req=req, batching=cfg)[0]
            for name, cfg in regimes.items()}
    sim = sims["fifo"]
    log(f"batching bench FleetSim: T={sim.n_bins} bins, SR={sim.n_rows} "
        f"compact rows, {sim._f_req.size} chunks")
    base = sim.run(zero_load=True)
    ttft0_p99 = max(p.quantile("ttft", 0.99) for p in base.plans)
    ttft_bound = BATCH_TTFT_BOUND_SCALE * ttft0_p99
    u = np.random.default_rng(31).random(req.n_requests)
    fractions = np.asarray(BATCH_FRACTIONS)
    masks = u[None, :] < fractions[:, None]
    rows, many, out = [], {}, {}
    for name, sim in sims.items():
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        many[name] = sim.run_many(masks)
        torch_sync()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        want = {"deposit": 2 if regimes[name] is None else 6,
                "backlog_scan": 3}
        log(f"batching bench {name} run_many over {list(BATCH_FRACTIONS)}: "
            f"{wall * 1e3:.1f} ms wall (synchronized, first call), launch "
            f"counts {json.dumps(counts)}")
        if {k: counts[k] for k in want} != want:
            raise SmokeFailure(f"batching bench {name} launch counts "
                               f"{counts} != {want}")
        out[f"{name}_run_many_ms"] = wall * 1e3
    same = [same_results(a, b, f"b_max=1 vs FIFO fraction {f}")
            for f, a, b in zip(BATCH_FRACTIONS, many["fifo"], many["b_max=1"])]
    log(f"batching bench: b_max=1 bitwise FIFO at all {len(same)} fractions")
    for name in ("fifo", "batched"):
        cpu_sim, _ = build_fleet(world, "cpu", seed=23, qcfg=qcfg,
                                 ground=ground, req=req,
                                 batching=regimes[name])
        t0 = time.perf_counter()
        cpu_many = cpu_sim.run_many(masks)
        t_cpu = time.perf_counter() - t0
        exact = True
        for frac, r, r_cpu in zip(BATCH_FRACTIONS, many[name], cpu_many):
            assert_parity(r_cpu, r, f"batching bench {name} fraction {frac} "
                          "card vs CPU")
            try:
                same_results(r_cpu, r, "")
            except SmokeFailure:
                exact = False
            rows += [frontier_row(name, float(frac), p) for p in r.plans]
        log(f"batching bench {name}: card vs CPU parity holds at every "
            f"fraction, bitwise equal: {exact} (CPU run_many {t_cpu:.1f}s)")
        del cpu_sim
    for r in rows:
        log("batching frontier " + json.dumps(r))
    for name in ("fifo", "batched"):
        ok = [r for r in rows if r["regime"] == name
              and r["ttft_p99_s"] is not None and r["ttft_p99_s"] <= ttft_bound]
        out[f"best_goodput_{name}"] = max(
            (r["goodput_tok_s"] or 0.0 for r in ok), default=0.0)
    out.update(zero_load_ttft_p99_s=ttft0_p99, ttft_bound_s=ttft_bound,
               capacity_gain=(out["best_goodput_batched"]
                              / out["best_goodput_fifo"]
                              if out["best_goodput_fifo"] > 0 else None))
    log(f"batching bench: zero-load p99 TTFT {ttft0_p99:.3f} s, bound "
        f"{ttft_bound:.3f} s; best goodput within it: FIFO "
        f"{out['best_goodput_fifo']:.3f}, batched "
        f"{out['best_goodput_batched']:.3f} tok/s (gain "
        f"{out['capacity_gain']})")
    if not out["best_goodput_batched"] > out["best_goodput_fifo"]:
        raise SmokeFailure("batching bench: batched goodput does not beat "
                           "FIFO at the matched p99 TTFT bound")
    return out


def phase_fleet_batching(torch, world, adm_sims) -> None:
    """Phase 7's world under ``BatchingConfig(b_max=8)``: ``run()`` on the
    card (deposit 6, backlog_scan 3 launches), its wall and device time,
    busy share, peak memory, host steps and the law's device time; the
    deposit kernel bitwise on the decode-work and decode-visit tables the
    run gave it; the card against the CPU; then the flight recorder on it
    and on phase 9's AIMD ``run()``, and the reference's batching
    frontier (:func:`phase_batching_bench`)."""
    import numpy as np

    from repro_torch.kernels import deposit as dep
    from repro_torch.kernels import ops
    from repro_torch.traffic import BatchingConfig, queueing
    cfg = BatchingConfig(b_max=BATCH_B_MAX)
    sim, t_build = build_fleet(world, "cuda", batching=cfg)
    log(f"batched FleetSim on the card: T={sim.n_bins} bins, {sim.n_rows} "
        f"compact rows, {sim._f_req.size} chunks, speedup table "
        f"{np.round(sim._batch_table, 4).tolist()}, built in {t_build:.1f}s")
    captured = []
    real_deposit = queueing.deposit

    def deposit_rec(rows, cols, vals, n_rows, n_cols, row_ptr):
        if len(captured) < 3:
            captured.append((rows.clone(), cols.clone(), vals.clone(), n_rows,
                             n_cols, row_ptr.clone()))
        return real_deposit(rows, cols, vals, n_rows, n_cols,
                            row_ptr=row_ptr)
    queueing.deposit = deposit_rec
    try:
        ops.reset_launch_counts()
        res = sim.run()
        torch_sync()
        counts = ops.launch_counts()
    finally:
        queueing.deposit = real_deposit
    want = {"deposit": 6, "backlog_scan": 3}
    log(f"batched run() launch counts {json.dumps(counts)} (expected "
        f"{json.dumps(want)})")
    if {k: counts[k] for k in want} != want:
        raise SmokeFailure(f"batched run() launch counts {counts} != {want}")
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    wall_ms, again = best_wall_ms(sim.run)
    peak = torch.cuda.max_memory_allocated() - mem0
    log(f"batched run(): peak device memory {peak / 2**20:.1f} MiB above what "
        "it held before")
    same_results(res, again, "batched card run() vs run()")
    with primed_profile(torch) as prof:
        t0 = time.perf_counter()
        sim.run()
        torch_sync()
        prof_wall = time.perf_counter() - t0
    kernels = device_times(prof, 1)
    busy = sum(k[0] for k in kernels) / 1e3
    per = {name: sum(ms for ms, _, key in kernels
                     if any(k in key for k in cuda_names))
           for name, cuda_names in FLEET_KERNELS.items()}
    log(f"batched run(): {wall_ms:.1f} ms wall (best of 2, synchronized); "
        f"under the profiler {prof_wall * 1e3:.1f} ms wall, device kernels "
        f"{busy * 1e3:.1f} ms -> device busy {busy / prof_wall:.1%}, idle "
        f"{1 - busy / prof_wall:.1%} ({sum(k[1] for k in kernels):.0f} "
        f"kernel launches); deposit {per['deposit']:.3f} ms over 6 calls, "
        f"backlog_scan {per['backlog_scan']:.3f} ms over 3")
    for ms, calls, name in sorted(kernels, reverse=True)[:10]:
        log(f"batched profile: {ms:9.3f} ms {calls:6.0f} calls  {name[:80]}")
    for _ in range(2):
        steps = fleet_host_steps(torch, sim, res)
        log(f"batched run() itemized (host clock, each step ends in a "
            f"synchronize; ms): {json.dumps(steps)}")

    # The law on iteration 2's three planes, as run() deposited them.
    planes = [dep.deposit(*t[:5], row_ptr=t[5]) for t in captured]
    batch = dict(table=torch.from_numpy(sim._batch_table).cuda(),
                 bcap=sim._batch_cap, window=sim._batch_window)
    law_ms, law_wall_ms, _ = time_ms(
        torch, lambda: queueing._effective_plane(*planes, batch), iters=3)
    torch_sync()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    queueing._effective_plane(*planes, batch)
    torch_sync()
    law_peak = torch.cuda.max_memory_allocated() - mem0
    cells = planes[0].numel()
    log(f"batching law: {law_ms:.3f} ms device ({law_wall_ms:.3f} wall) per "
        f"iteration on {tuple(planes[0].shape)} f64 planes, "
        f"{-(-cells // queueing.LAW_BLOCK_CELLS)} row blocks; peak "
        f"{law_peak / 2**20:.1f} MiB above its three input planes "
        f"({3 * cells * 8 / 2**20:.1f} MiB); bound (3 f64 reads, one f32 "
        f"write) {bound(28 * cells, 0, 'float64')[0]:.4f} ms")
    del planes
    deps = [check_deposit(torch, captured[i], f"batched run() {what}")
            for i, what in ((1, "wdec"), (2, "cnt"))]
    del captured
    for d in deps:
        log("kernel " + json.dumps(d))
    if not all(d["ok"] for d in deps):
        raise SmokeFailure("deposit disagrees with its plain version on the "
                           "batching tables")

    cpu_sim, t_cpu_build, res_cpu, t_cpu, cpu_probed = cpu_ref("batched")
    served = assert_parity(res_cpu, res, "batched card run() vs CPU")
    try:
        same_results(res_cpu, res, "")
        exact = True
    except SmokeFailure:
        exact = False
    log(f"batched card vs CPU run(): parity holds, {served} requests served "
        f"over the plans on both, bitwise equal: {exact} (CPU construction "
        f"{t_cpu_build:.1f}s, run() {t_cpu:.1f}s)")
    for p in res.plans:
        log(f"batched plan {p.plan_name}: served {int(p.served.sum())}/"
            f"{int(p.active.sum())}, TTFT p50 {p.quantile('ttft', 0.5):.3f} s"
            f" p99 {p.quantile('ttft', 0.99):.3f} s")
    check_probes(torch, sim, cpu_sim, "batched run()", cpu_probed)
    del sim, cpu_sim
    check_probes(torch, *adm_sims, "AIMD run()",
                 _CPU_REFS.pop("aimd probed", None))
    phase_batching_bench(torch)


# --------------------------------------------------------------------- #
# Phase 11: re-placement and the joint control plane
# --------------------------------------------------------------------- #

#: Phase 11 (a): the paper's world under backlog re-placement.
REPLAN_CADENCES = (1, 2, 3)
#: Phase 11 (b): the reference's benchmarks/bench_ctrl.py grid, cadence-major.
CTRL_CADENCES = (1, 2, 3)
CTRL_MIG_WEIGHTS = (0.0, 0.01, 0.1)
CTRL_TTFT_TARGETS = (30.0, 60.0, 90.0)


def same_decisions(a, b, what) -> None:
    """Identical decision trajectories of two ``ReplanOutcome``s (the
    reference bench's ``_compare_cell``): slot plans, boundaries, slots,
    chosen, switched, scores and migration bytes, bit for bit."""
    import numpy as np
    ra, rb = a.report, b.report
    problems = []
    if not np.array_equal(ra.schedule.slot_plan, rb.schedule.slot_plan):
        problems.append(f"slot plans {ra.schedule.slot_plan.tolist()} vs "
                        f"{rb.schedule.slot_plan.tolist()}")
    if len(ra.decisions) != len(rb.decisions):
        problems.append(f"{len(ra.decisions)} vs {len(rb.decisions)} "
                        "decisions")
    for da, db in zip(ra.decisions, rb.decisions):
        if (da.boundary, da.slot, da.chosen, da.switched) != \
                (db.boundary, db.slot, db.chosen, db.switched) \
                or not np.array_equal(da.scores, db.scores) \
                or da.migration_bytes != db.migration_bytes:
            problems.append(f"k={da.boundary}: {(da.chosen, da.switched)} "
                            f"vs {(db.chosen, db.switched)}, scores "
                            f"{da.scores.tolist()} vs {db.scores.tolist()}")
    if problems:
        raise SmokeFailure(f"{what}: decisions differ: {problems[:3]}")


def grid_stages(torch, call, profiled=False) -> tuple[dict, list, object]:
    """One controller-grid call through ``run_replan_grid``'s stage hook:
    per stage, host-clock ms with a synchronize at each boundary; or with
    ``profiled``, under ``torch.profiler`` with each stage a
    ``record_function`` range, the device time of the kernels each stage
    launched and the copies it made (ms; ``busy`` their sum, ``wall`` the
    call's, ``launches`` the device events).  Returns (ms per stage, summed over rounds; the
    profiled kernels as ``device_times`` gives them, or []; the
    outcomes)."""
    from torch.profiler import record_function
    times: dict[str, float] = {}
    if not profiled:
        last = [0.0]

        def stage(name):
            torch.cuda.synchronize()
            now = time.perf_counter()
            times[name] = times.get(name, 0.0) + (now - last[0]) * 1e3
            last[0] = now
        torch.cuda.synchronize()
        last[0] = time.perf_counter()
        return times, [], call(stage)
    names: list[str] = []
    rng: list = []

    def stage(name):
        rng[0].__exit__(None, None, None)
        names.append(name)
        rng[0] = record_function(f"replan_stage_{len(names)}")
        rng[0].__enter__()
    torch.cuda.synchronize()
    with primed_profile(torch) as prof:
        t0 = time.perf_counter()
        rng.append(record_function("replan_stage_0"))
        rng[0].__enter__()
        out = call(stage)
        rng[0].__exit__(None, None, None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # The profiler puts each range on the device's timeline too (from its
    # first kernel to its last): a device event inside a stage's span is
    # that stage's.
    from torch.autograd import DeviceType
    spans, device = [], []
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        if evt.name.startswith("replan_stage_"):
            k = int(evt.name.rsplit("_", 1)[1])
            spans.append((evt.time_range.start, evt.time_range.end,
                          names[k] if k < len(names) else "after"))
        else:
            device.append(evt)
    for evt in device:
        t = evt.time_range.start
        name = next((n for lo, hi, n in spans if lo <= t <= hi), "between")
        times[name] = times.get(name, 0.0) \
            + evt.time_range.elapsed_us() / 1e3
    kernels = [k for k in device_times(prof, 1)
               if not k[2].startswith("replan_stage_")]
    times["busy"] = sum(k[0] for k in kernels)
    times["wall"] = wall * 1e3
    times["launches"] = sum(k[1] for k in kernels)
    return times, kernels, out


def replan_paper(torch, world) -> dict:
    """Phase 11 (a): phase 7's world, FIFO, backlog re-placement over
    cadences 1, 2 and 3 in one ``run_many(replan=)``."""
    import dataclasses

    import numpy as np

    from repro_torch import core
    from repro_torch.kernels import ops
    from repro_torch.traffic import (QueueConfig, ReplanConfig, queueing,
                                     replan_base_scores, replan_traffic)
    topo, act, plans, req, _ = world
    wl, comp = core.MoEWorkload.llama_moe_3p5b(), core.ComputeConfig()
    qcfg = QueueConfig()
    rcfg = ReplanConfig(mode="backlog", controller_iterations=2,
                        hysteresis=0.0)
    # replan_traffic's seed discipline: one draw seeds the fleet, the
    # next integer seeds the base scores' draws.
    seed = int(np.random.default_rng(4).integers(0, 2**31 - 1))
    sim, t_build = build_fleet(world, "cuda", seed=seed, qcfg=qcfg)
    t0 = time.perf_counter()
    scores = replan_base_scores(plans, topo, act, wl, comp,
                                np.random.default_rng(seed + 1), rcfg,
                                device="cuda")
    t_scores = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim._ctrl_tables()
    t_tables = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim._ctrl_device()
    torch_sync()
    t_upload = time.perf_counter() - t0
    ct = sim._ctrl_tables()
    F = len(REPLAN_CADENCES)
    log(f"replan (a) paper world: T={sim.n_bins} bins, {sim.n_rows} probe "
        f"rows, {ct['n_rows_sched']} schedule rows, {ct['n_bounds'] + 1} "
        f"decision boundaries, {ct['ch_work'].size} gated chunks an entry "
        f"(F={F}: {F * ct['ch_work'].size} triples), built {t_build:.1f}s; "
        f"replan_base_scores ({topo.n_slots} slots of evaluate_plans) "
        f"{t_scores:.2f}s, _ctrl_tables {t_tables:.2f}s, upload "
        f"{t_upload:.2f}s")

    def grid(stage=None):
        return sim.run_many(replan=rcfg, base_scores=scores,
                            cadences=REPLAN_CADENCES) if stage is None \
            else sim.run_replan_grid(rcfg, base_scores=scores,
                                     cadences=REPLAN_CADENCES, stage=stage)
    captured = []
    real_deposit = queueing.deposit

    def deposit_rec(rows, cols, vals, n_rows, n_cols, row_ptr):
        if n_rows == F * ct["n_rows_sched"] and not captured:
            captured.append((rows.clone(), cols.clone(), vals.clone(),
                             n_rows, n_cols, row_ptr.clone()))
        return real_deposit(rows, cols, vals, n_rows, n_cols,
                            row_ptr=row_ptr)
    queueing.deposit = deposit_rec
    try:
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        fused = grid()
        torch_sync()
        t_first = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() - base_mem
    finally:
        queueing.deposit = real_deposit
    n, rounds = qcfg.iterations, rcfg.controller_iterations
    want = {"deposit": (n - 1) + rounds * n, "backlog_scan": n + rounds * n,
            "admission_window": 0, "admission_ctrl": 0}
    log(f"replan (a) run_many(replan=) over cadences {REPLAN_CADENCES}: "
        f"{t_first:.2f}s wall (first call), launch counts "
        f"{json.dumps(counts)} (expected {json.dumps(want)}: the probe's "
        f"{n} iterations, then per round an iteration-1 deposit on the "
        f"card and {n} iterations); peak device memory above the "
        f"simulator's {peak / 2**30:.2f} GiB")
    if {k: counts[k] for k in want} != want:
        raise SmokeFailure(f"replan (a) launch counts {counts} != {want}")
    host_ms, _, again = grid_stages(torch, grid)
    dev_ms, kernels, _ = grid_stages(torch, grid, profiled=True)
    for a, b in zip(fused, again):
        same_decisions(a, b, "replan (a) grid vs grid")
        assert_parity(a.result, b.result, "replan (a) grid vs grid",
                      rtol=0.0)
    log(f"replan (a) itemized, host clock with a synchronize at each "
        f"stage (ms): {json.dumps({k: round(v, 2) for k, v in host_ms.items()})}"
        f"; under the profiler, device time of each stage's kernels (ms): "
        f"{json.dumps({k: round(v, 3) for k, v in dev_ms.items()})} -> "
        f"device busy {dev_ms['busy'] / dev_ms['wall']:.1%} of the wall")
    for ms, calls, name in sorted(kernels, reverse=True)[:8]:
        log(f"replan (a) profile: {ms:9.3f} ms {calls:6.0f} calls  "
            f"{name[:80]}")

    # The host loop on the card, cadence by cadence: its decisions must be
    # the grid's bit for bit, its results the grid's at the fused-vs-
    # legacy criterion.
    t_host = 0.0
    for cad, out in zip(REPLAN_CADENCES, fused):
        t0 = time.perf_counter()
        host = replan_traffic(plans, topo, act, wl, comp, req,
                              np.random.default_rng(4),
                              dataclasses.replace(rcfg, period_slots=cad),
                              qcfg, device="cuda")
        torch_sync()
        t_host += time.perf_counter() - t0
        same_decisions(host, out, f"replan (a) cadence {cad}: host loop vs "
                       "grid")
        n_served = assert_parity(host.result, out.result,
                                 f"replan (a) cadence {cad}: host loop vs "
                                 "grid")
        rep = out.report
        log(f"replan (a) cadence {cad}: slot plan "
            f"{np.bincount(rep.schedule.slot_plan, minlength=len(plans)).tolist()}"
            f" slots per plan, {len(rep.decisions)} decisions, "
            f"{rep.n_switches} switches, {rep.total_migration_bytes:.0f} "
            f"bytes moved; host loop equal bit for bit; {n_served} requests "
            f"served over the {len(out.result.plans)} rows")
    log(f"replan (a) host loop over the 3 cadences {t_host:.1f}s vs the "
        f"grid's {t_first:.2f}s (first call)")
    dep = check_deposit(torch, captured.pop(), f"the schedule row's gated "
                        f"table (F={F}), iteration 1")
    log("kernel " + json.dumps(dep))
    if not dep["ok"]:
        raise SmokeFailure("deposit disagrees with its plain version on the "
                           "gated table")
    return dict(deposit=dep, host_ms=host_ms, dev_ms=dev_ms)


def ctrl_world(device):
    """``benchmarks/bench_ctrl.py``'s world at its non-fast setting: 8 x 12
    satellites, 10 slots, Zipf 4 experts top-2 over 4 layers, 3 plans,
    40 requests/s for 120 s over 2 gateways, AIMD at a 60 s TTFT target,
    6 s buffers, 10 s slots; the simulator seeded as replan_traffic seeds
    it, and the base scores."""
    import numpy as np

    from repro_torch import core
    from repro_torch.traffic import (AdmissionConfig, FleetSim, QueueConfig,
                                     ReplanConfig, replan_base_scores,
                                     sample_requests)
    con = core.Constellation(core.ConstellationConfig.scaled(
        8, 12, n_slots=10, survival_prob=1.0))
    topo = core.sample_topology(con, core.LinkConfig(),
                                np.random.default_rng(0))
    act = core.ActivationModel.zipf(4, 4, 2, seed=1)
    plans = [core.rand_intra_cg_plan(con.cfg, 4, 4, np.random.default_rng(7)),
             core.spacemoe_plan(con, topo, act),
             core.rand_intra_cg_plan(con.cfg, 4, 4,
                                     np.random.default_rng(11))]
    req = sample_requests(np.random.default_rng(2), rate_rps=40.0,
                          horizon_s=120.0, n_stations=2, prompt_median=8,
                          prompt_max=32, decode_mean=8, decode_max=16)
    qcfg = QueueConfig(dt_s=0.05, tail_s=30.0, slot_period_s=10.0,
                       buffer_s=6.0,
                       admission=AdmissionConfig(policy="aimd",
                                                 ttft_target_s=60.0))
    rcfg = ReplanConfig(mode="backlog", controller_iterations=1,
                        bytes_per_expert=qcfg.migration_bytes_per_expert)
    seed = int(np.random.default_rng(4).integers(0, 2**31 - 1))
    wl, comp = core.MoEWorkload.llama_moe_3p5b(), core.ComputeConfig()
    sim = FleetSim(plans, topo, act, wl, comp, req,
                   np.random.default_rng(seed), qcfg=qcfg, device=device)
    scores = replan_base_scores(plans, topo, act, wl, comp,
                                np.random.default_rng(seed + 1), rcfg,
                                device=device)
    return sim, scores, rcfg, (plans, topo, act, wl, comp, req, qcfg)


def replan_bench_grid(torch) -> dict:
    """Phase 11 (b): the reference bench's 27-cell grid in one
    ``run_replan_grid`` on the card, against the CPU and against the host
    loop cell by cell; the admission kernels on the per-entry tables it
    gave them.  (c): one cell's flight log with ``replan=``."""
    import dataclasses

    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.obs import (build_flight_log, chrome_trace,
                                 count_events, validate_trace)
    from repro_torch.traffic import admission, replan_traffic
    t0 = time.perf_counter()
    sim, scores, rcfg, (plans, topo, act, wl, comp, req, qcfg) = \
        ctrl_world("cuda")
    torch_sync()
    grid = dict(base_scores=scores, cadences=list(CTRL_CADENCES),
                mig_weights=list(CTRL_MIG_WEIGHTS),
                ttft_targets=list(CTRL_TTFT_TARGETS))
    F = len(CTRL_CADENCES) * len(CTRL_MIG_WEIGHTS) * len(CTRL_TTFT_TARGETS)
    log(f"replan (b) bench_ctrl world: R={sim.n_requests} requests, "
        f"T={sim.n_bins} bins, {sim.n_rows} probe rows, built with its base "
        f"scores in {time.perf_counter() - t0:.1f}s; {F} cells")
    windows, cells = [], []
    real_window, real_ctrl = admission.admission_window, admission.admission_ctrl

    def window_rec(*args):
        if args[4].dim() == 4:                       # per-entry tables
            windows.append(tuple(a.clone() if torch.is_tensor(a) else a
                                 for a in args))
        return real_window(*args)

    def ctrl_rec(win, *args, **kw):
        if args[0].dim() == 3:                       # per-entry anchors
            cells.append((win.clone(), args, kw))
        return real_ctrl(win, *args, **kw)
    admission.admission_window, admission.admission_ctrl = window_rec, ctrl_rec
    try:
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        fused = sim.run_replan_grid(rcfg, **grid)
        torch_sync()
        t_first = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() - base_mem
    finally:
        admission.admission_window, admission.admission_ctrl = \
            real_window, real_ctrl
    n = qcfg.iterations
    want = {"deposit": (n - 1) + n, "backlog_scan": 2 * n,
            "admission_window": 2 * n, "admission_ctrl": 2 * n}
    t0 = time.perf_counter()
    again = sim.run_replan_grid(rcfg, **grid)
    torch_sync()
    t_steady = time.perf_counter() - t0
    log(f"replan (b) run_replan_grid: {t_first:.2f}s wall (first call), "
        f"{t_steady:.2f}s (second); launch counts {json.dumps(counts)} "
        f"(expected {json.dumps(want)}); peak device memory above the "
        f"simulator's {peak / 2**30:.2f} GiB")
    if {k: counts[k] for k in want} != want:
        raise SmokeFailure(f"replan (b) launch counts {counts} != {want}")
    if len(windows) != n or len(cells) != n:
        raise SmokeFailure(f"replan (b): {len(windows)} admission_window and "
                           f"{len(cells)} admission_ctrl calls on per-entry "
                           f"tables, expected {n} each")
    for a, b in zip(fused, again):
        same_decisions(a, b, "replan (b) grid vs grid")

    cpu_scores, cpu, t_cpu = cpu_ref("ctrl")
    if not np.array_equal(cpu_scores, scores):
        raise SmokeFailure("replan (b): base scores differ card vs CPU")
    served = 0
    for f, (a, b) in enumerate(zip(cpu, fused)):
        same_decisions(a, b, f"replan (b) cell {f}: card vs CPU")
        served += assert_parity(a.result, b.result,
                                f"replan (b) cell {f}: card vs CPU")
        same_admission(a.result, b.result, f"replan (b) cell {f}: card vs CPU")
    log(f"replan (b) card vs CPU: decisions bit for bit, identical served, "
        f"shed and retry sets, latencies at the fused-vs-legacy criterion "
        f"on all {F} cells ({served} requests served over the cells' rows; "
        f"CPU grid {t_cpu:.1f}s)")

    t0 = time.perf_counter()
    cells_cfg = [(c, w, tt) for c in CTRL_CADENCES for w in CTRL_MIG_WEIGHTS
                 for tt in CTRL_TTFT_TARGETS]
    switches = 0
    for f, ((cad, w, tt), out) in enumerate(zip(cells_cfg, fused)):
        qc = dataclasses.replace(qcfg, admission=dataclasses.replace(
            qcfg.admission, ttft_target_s=tt))
        rc = dataclasses.replace(rcfg, period_slots=cad,
                                 migration_weight_s_per_mb=w,
                                 bytes_per_expert=None)
        host = replan_traffic(plans, topo, act, wl, comp, req,
                              np.random.default_rng(4), rc, qc,
                              device="cuda")
        same_decisions(host, out, f"replan (b) cell {f} {(cad, w, tt)}: "
                       "host loop vs grid")
        switches += out.report.n_switches
    torch_sync()
    t_host = time.perf_counter() - t0
    log(f"replan (b) host loop, cell by cell on the card: {t_host:.1f}s for "
        f"{F} cells, decisions equal to the grid's bit for bit on all; the "
        f"one-call grid {t_steady:.2f}s: {t_host / t_steady:.1f}x "
        f"(reported, not gated); {switches} switches over the cells")
    if switches == 0:
        raise SmokeFailure("replan (b): no cell switched plans")

    wins = [check_window(torch, args, f"bench_ctrl grid's schedule row "
                         f"(F={F}, per-entry station maps), iteration "
                         f"{i + 1}") for i, args in enumerate(windows)]
    recs = [check_ctrl(torch, win, args, kw, f"bench_ctrl grid's schedule "
                       f"row (F={F}, per-entry anchors), iteration {i + 1}")
            for i, (win, args, kw) in enumerate(cells)]
    for rec in wins + recs:
        log("kernel " + json.dumps(rec))
    bad = [r["shape"] for r in wins + recs if not r["ok"]]
    if bad:
        raise SmokeFailure(f"admission kernels disagree with their plain "
                           f"versions on the per-entry tables: {bad}")

    # (c) one cell's flight log, its decisions as trace instants.
    out = fused[0]
    flight = build_flight_log(out.sim, out.result, replan=out.report,
                              scenario="bench_ctrl cell 0")
    trace = chrome_trace(flight)
    problems = validate_trace(json.loads(json.dumps(trace)))
    n_dec = len(out.report.decisions)
    got = {k: count_events(trace, k, "i") for k in ("replan", "joint")}
    log(f"replan (c) flight log of cell 0 with replan=: "
        f"{len(flight.requests)} request records, "
        f"{count_events(trace, '', 'X')} spans, instants {json.dumps(got)} "
        f"for {n_dec} decisions; validate_trace: "
        f"{problems[:3] if problems else 'no problems'}")
    if problems or got != {"replan": n_dec, "joint": n_dec}:
        raise SmokeFailure(f"replan (c): flight-log trace {problems[:3]}, "
                           f"instants {got} for {n_dec} decisions")
    return dict(window=wins[-1], ctrl=recs[-1])


def phase_replan(torch, world) -> dict:
    """Phase 11: re-placement and the joint control plane, (a) on the
    paper's world at full width, (b) on the reference bench's controller
    grid, (c) the flight log."""
    out = replan_paper(torch, world)
    out.update(replan_bench_grid(torch))
    return out


# --------------------------------------------------------------------- #
# Phase 12: the traffic scenarios and the planet-scale federation
# --------------------------------------------------------------------- #

#: Phase 12 (a): benchmarks/bench_replan.py, non-fast grid and fast grid.
BENCH_REPLAN_CADENCES = (1, 2, 4)
BENCH_REPLAN_WEIGHTS = (0.0, 0.01, 0.1)
BENCH_REPLAN_FAST_CADENCES = (1, 2)
BENCH_REPLAN_FAST_WEIGHTS = (0.0, 0.05)
BENCH_REPLAN_RATE_SCALE = 9.0
BENCH_REPLAN_SCENARIOS = ("regional-hotspot-replan", "failure-storm-replan")
#: Phase 12 (c): benchmarks/bench_federation.py's gates and budget.
FED_GAIN_MIN = 1.3
FED_P99_FACTOR = 1.05
FED_RSS_BUDGET_MB = 8192
FED_MILLION_USERS = 1.01e6


def replan_bench_world():
    """``benchmarks/bench_replan.py``'s world: 12 x 16 satellites, 12
    slots, Zipf 8 experts top-2 over 4 layers, the 8 default gateways and
    the 7 ``baseline_plans`` candidates (two random draws, rng 3)."""
    import numpy as np

    from repro_torch import core
    from repro_torch.traffic import build_ground_segment
    con = core.Constellation(core.ConstellationConfig.scaled(12, 16,
                                                             n_slots=12))
    link = core.LinkConfig()
    topo = core.sample_topology(con, link, np.random.default_rng(0))
    act = core.ActivationModel.zipf(4, 8, 2, seed=0)
    ground = build_ground_segment(con, link, min_elevation_deg=10.0)
    plans = core.baseline_plans(con, topo, act, np.random.default_rng(3),
                                n_random_draws=2)
    return dict(con=con, topo=topo, act=act, ground=ground, plans=plans,
                wl=core.MoEWorkload.llama_moe_3p5b(),
                comp=core.ComputeConfig())


def replan_bench_phases(w, name: str, fast: bool):
    """(queue config, [(phase tag, candidate pool, requests)], rng) of one
    bench_replan scenario: the scenario cut as the bench cuts it, its
    trace at rate x 9 from rng 11, split at the storm as run_scenario
    splits it (requests first, then the storm, on one rng)."""
    import dataclasses

    import numpy as np

    from repro_torch.traffic import apply_failure_storm, get_scenario
    base = get_scenario(name)
    horizon = 90.0 if fast else 180.0
    sc = dataclasses.replace(
        base, horizon_s=horizon, tail_s=60.0, slot_period_s=15.0,
        buffer_s=3.0, decode_mean=8, decode_max=16, prompt_median=4,
        prompt_max=16,
        failure_at_s=horizon / 2.0 if base.failure_at_s is not None
        else None)
    slot_period = w["con"].cfg.orbital_period_s / w["topo"].n_slots
    qcfg = dataclasses.replace(sc.queue_config(slot_period),
                               migration_bytes_per_expert=1e6)
    rng = np.random.default_rng(11)
    req = sc.requests(rng, w["ground"].n_stations,
                      rate_scale=BENCH_REPLAN_RATE_SCALE)
    if sc.failure_at_s is None:
        return qcfg, [("main", w["plans"], req)], rng
    pre = req.subset(req.arrival_s < sc.failure_at_s)
    post = req.subset(req.arrival_s >= sc.failure_at_s)
    storm = apply_failure_storm(w["plans"], w["act"], rng,
                                failure_frac=sc.failure_frac,
                                bytes_per_expert=1e6)
    phases = [("main", w["plans"], pre)]
    if post.n_requests:
        phases.append(("post", storm.degraded_plans, post))
    return qcfg, phases, rng


def replan_bench_rows(tag, res, rep, policy, knobs) -> list[dict]:
    """The bench's frontier rows of one cell: the schedule's row and every
    static candidate's."""
    rows = []
    for p in res.plans:
        is_replan = p.plan_name.startswith("replan/")
        rows.append({
            "policy": policy if is_replan else "static",
            **(knobs if is_replan else {k: None for k in knobs}),
            "phase": tag, "plan": p.plan_name,
            "goodput_tok_s": p.goodput_tok_s,
            "ttft_p99_s": p.quantile("ttft", 0.99),
            "span_s": p.span_s,
            "switches": rep.n_switches if is_replan else 0})
    return rows


def replan_bench_headline(rows) -> dict:
    """bench_replan's acceptance: the best backlog point's goodput over
    the phases (token-weighted) against the best static candidate's, at
    p99 TTFT (the worst phase's) no worse than that candidate's."""
    import numpy as np

    def combined(sel):
        tok = sum(r["goodput_tok_s"] * r["span_s"] for r in sel)
        span = sum(r["span_s"] for r in sel)
        p99s = [r["ttft_p99_s"] for r in sel
                if np.isfinite(r["ttft_p99_s"])]
        return (tok / span if span else 0.0,
                max(p99s) if p99s else float("nan"))

    def by_knob(policy):
        out: dict = {}
        for r in rows:
            if r["policy"] == policy:
                out.setdefault((r["plan"], r["cadence"], r["mig_weight"]),
                               []).append(r)
        return {k: combined(v) for k, v in out.items()}
    static: dict = {}
    for (plan, _c, _w), gp in by_knob("static").items():
        static.setdefault(plan, gp)
    best_plan, (best_g, best_p99) = max(static.items(),
                                        key=lambda kv: kv[1][0])
    matched = {k: v for k, v in by_knob("backlog").items()
               if not np.isfinite(best_p99)
               or (np.isfinite(v[1]) and v[1] <= best_p99)}
    best_key, best_replan = max(matched.items(), key=lambda kv: kv[1][0],
                                default=(None, (0.0, float("nan"))))
    return {"best_static_plan": best_plan, "best_static_goodput": best_g,
            "best_static_ttft_p99_s": best_p99,
            "best_replan": best_key,
            "best_replan_goodput_at_matched_p99": best_replan[0],
            "best_replan_ttft_p99_s": best_replan[1],
            "replan_beats_static": bool(best_replan[0] > best_g)}


def replan_bench_grid_calls(w, qcfg, phases, rng, device, cadences,
                            weights, tag_log=None) -> tuple[list, list]:
    """Each phase's backlog grid (one ``replan_traffic_fused`` over
    cadences x weights) and its periodic control point, as the bench
    calls them on one rng.  Returns (frontier rows, per-phase records:
    outcomes, wall, launches, peak device memory)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.traffic import ReplanConfig, replan_traffic_fused
    cuda = device == "cuda"
    rows, recs = [], []
    for tag, plans, req in phases:
        for policy in ("backlog", "periodic"):
            grid = policy == "backlog"
            if cuda:
                ops.reset_launch_counts()
                torch.cuda.reset_peak_memory_stats()
                base_mem = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            out = replan_traffic_fused(
                plans, w["topo"], w["act"], w["wl"], w["comp"], req, rng,
                ReplanConfig(mode=policy), qcfg, ground=w["ground"],
                device=device,
                **(dict(cadences=list(cadences), mig_weights=list(weights))
                   if grid else {}))
            if cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            cells = out if grid else [out]
            knobs = ([(c, wt) for c in cadences for wt in weights] if grid
                     else [(1, 0.01)])
            for (c, wt), cell in zip(knobs, cells):
                rows += replan_bench_rows(tag, cell.result, cell.report,
                                          policy,
                                          {"cadence": c, "mig_weight": wt})
            sim = cells[0].sim
            rec = dict(phase=tag, policy=policy, cells=cells, wall_s=wall,
                       R=req.n_requests, T=sim.n_bins, rows=sim.n_rows,
                       C=len(plans), chunks=sim._f_src.size)
            if cuda:
                rec["launches"] = ops.launch_counts()
                rec["peak_gib"] = (torch.cuda.max_memory_allocated()
                                   - base_mem) / 2**30
            recs.append(rec)
            if tag_log is not None:
                sw = [c.report.n_switches for c in cells]
                mb = [c.report.total_migration_bytes / 1e6 for c in cells]
                tag_log(f"{tag} {policy}: R={rec['R']} requests, T={rec['T']}"
                        f" bins, {rec['rows']} probe rows, C={rec['C']}, "
                        f"{rec['chunks']} probe chunks, "
                        f"{len(cells)} cell(s) in {wall:.2f}s wall"
                        + (f", launches {json.dumps(rec['launches'])}, peak "
                           f"{rec['peak_gib']:.2f} GiB" if cuda else "")
                        + f"; switches {sw}, migrated MB "
                        f"{[round(x, 1) for x in mb]}")
    return rows, recs


def scenario_replan_bench(torch) -> dict:
    """Phase 12 (a): the reference's bench_replan at its non-fast setting,
    rebuilt with the port, both scenarios on the card, the bench's gate;
    then its fast regional-hotspot grid on the card and on the CPU
    (decisions bit for bit, identical served, shed and retry sets), the
    card's fast rows printed beside the committed baseline's.  Returns
    the world."""
    from repro_torch.traffic import ReplanConfig
    t0 = time.perf_counter()
    w = replan_bench_world()
    log(f"scenarios (a) bench_replan world: {w['con'].cfg.n_sats} "
        f"satellites, {w['topo'].n_slots} slots, {len(w['plans'])} "
        f"candidates {[p.name for p in w['plans']]}, built in "
        f"{time.perf_counter() - t0:.1f}s")
    heads = {}
    for name in BENCH_REPLAN_SCENARIOS:
        qcfg, phases, rng = replan_bench_phases(w, name, fast=False)
        rows, recs = replan_bench_grid_calls(
            w, qcfg, phases, rng, "cuda", BENCH_REPLAN_CADENCES,
            BENCH_REPLAN_WEIGHTS,
            tag_log=lambda m, n=name: log(f"scenarios (a) {n} {m}"))
        for rec in recs:
            n = qcfg.iterations
            r = ReplanConfig().controller_iterations \
                if rec["policy"] == "backlog" else 1
            want = {"deposit": (n - 1) + r * n, "backlog_scan": n + r * n}
            if {k: rec["launches"][k] for k in want} != want:
                raise SmokeFailure(f"scenarios (a) {name} {rec['phase']} "
                                   f"{rec['policy']}: launches "
                                   f"{rec['launches']} != {want}")
        h = replan_bench_headline(rows)
        heads[name] = h
        log(f"scenarios (a) {name}: best static {h['best_static_plan']} "
            f"{h['best_static_goodput']:.3f} tok/s at p99 "
            f"{h['best_static_ttft_p99_s']:.3f}s; best backlog point "
            f"(cadence, weight) {h['best_replan'][1:] if h['best_replan'] else None}"
            f" {h['best_replan_goodput_at_matched_p99']:.3f} tok/s at p99 "
            f"{h['best_replan_ttft_p99_s']:.3f}s -> "
            f"{'BEATS' if h['replan_beats_static'] else 'does not beat'}")
    bad = [n for n, h in heads.items() if not h["replan_beats_static"]]
    if bad:
        raise SmokeFailure(f"scenarios (a): backlog re-placement does not "
                           f"beat the best static plan at matched p99 in "
                           f"{bad}")

    # The fast setting's regional-hotspot grid: card against CPU.
    name = BENCH_REPLAN_SCENARIOS[0]
    got = {}
    for device in ("cuda", "cpu"):
        qcfg, phases, rng = replan_bench_phases(w, name, fast=True)
        t0 = time.perf_counter()
        got[device] = replan_bench_grid_calls(
            w, qcfg, phases, rng, device, BENCH_REPLAN_FAST_CADENCES,
            BENCH_REPLAN_FAST_WEIGHTS)
        got[device + "_s"] = time.perf_counter() - t0
    n_cells = 0
    for rc, rp in zip(got["cuda"][1], got["cpu"][1]):
        for a, b in zip(rc["cells"], rp["cells"]):
            what = f"scenarios (a) fast {name} {rc['policy']} cell {n_cells}"
            same_decisions(a, b, what + ": card vs CPU")
            assert_parity(b.result, a.result, what + ": card vs CPU")
            n_cells += 1
    log(f"scenarios (a) fast {name} grid: card {got['cuda_s']:.1f}s, CPU "
        f"{got['cpu_s']:.1f}s; card vs CPU on {n_cells} cells: decisions "
        f"bit for bit, identical served sets, latencies at the "
        f"fused-vs-legacy criterion")
    base = ROOT / "benchmarks" / "baselines" / "BENCH_replan.json"
    ref_rows = {}
    if base.exists():
        for r in json.loads(base.read_text())["replan"]["frontier"]:
            if r["scenario"] == name:
                ref_rows.setdefault((r["policy"], r["plan"], r["cadence"],
                                     r["mig_weight"]), r)
    seen = set()
    for r in got["cuda"][0]:
        key = (r["policy"], r["plan"], r["cadence"], r["mig_weight"])
        if key in seen:
            continue
        seen.add(key)
        ref = ref_rows.get(key)
        log(f"scenarios (a) fast {name} {key}: card goodput "
            f"{r['goodput_tok_s']:.3f} tok/s, p99 TTFT "
            f"{r['ttft_p99_s']:.3f}s, {r['switches']} switches; "
            f"BENCH_replan.json (jax 0.4.37, CPU; information only): "
            + (f"{ref['goodput_tok_s']} tok/s, p99 {ref['ttft_p99_s']}s, "
               f"{ref['switches']} switches" if ref else "no row"))
    return w


def scenario_registry(torch, w) -> None:
    """Phase 12 (b): every registry scenario through ``run_scenario`` on
    (a)'s world at its own horizon and rate, on the card; the re-placement
    ones with the joint control plane, regional-hotspot-replan also with
    the host loop (decisions bit for bit, results at the fused-vs-legacy
    criterion)."""
    from types import SimpleNamespace

    import numpy as np

    from repro_torch.traffic import SCENARIOS, run_scenario

    def run(name, ctrl):
        t0 = time.perf_counter()
        out = run_scenario(name, w["plans"], w["topo"], w["act"], w["wl"],
                           w["comp"], np.random.default_rng(4),
                           ground=w["ground"], constellation=w["con"],
                           ctrl=ctrl, device="cuda")
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for name, sc in SCENARIOS.items():
        ctrl = "fused" if sc.replan is not None else "host"
        out, wall = run(name, ctrl)
        parts = [("main", out.result)]
        if out.post_failure is not None:
            parts.append(("post", out.post_failure))
        for tag, res in parts:
            best = max(res.plans, key=lambda p: p.goodput_tok_s)
            for p in res.plans:
                ok = (not (p.served & ~p.active).any()
                      and np.isfinite(p.ttft_s[p.served]).all()
                      and (p.e2e_s[p.served] >= p.ttft_s[p.served]).all())
                if not ok:
                    raise SmokeFailure(f"scenarios (b) {name} {tag} "
                                       f"{p.plan_name}: served outside the "
                                       f"trace or non-finite latencies")
            log(f"scenarios (b) {name} ({ctrl}) {tag}: R="
                f"{int(res.plans[0].active.sum())}, T={res.n_bins}, "
                f"{len(res.plans)} plan rows; served "
                f"{[int(p.served.sum()) for p in res.plans]}, shed "
                f"{[int(p.shed.sum()) if p.shed is not None else 0 for p in res.plans]}"
                f"; best goodput {best.plan_name} {best.goodput_tok_s:.3f} "
                f"tok/s; {wall:.2f}s wall")
        for rep in (out.replan, out.post_replan):
            if rep is not None:
                log(f"scenarios (b) {name}: {rep.schedule.name} "
                    f"{rep.n_switches} switches, "
                    f"{rep.total_migration_bytes / 1e6:.1f} MB over "
                    f"{len(rep.decisions)} decisions")
        if out.storm is not None:
            log(f"scenarios (b) {name}: storm moved "
                f"{json.dumps(out.storm.moved_experts)} experts")
        if name == "regional-hotspot-replan":
            host, host_wall = run(name, "host")
            same_decisions(SimpleNamespace(report=host.replan),
                           SimpleNamespace(report=out.replan),
                           f"scenarios (b) {name}: host loop vs fused")
            assert_parity(host.result, out.result,
                          f"scenarios (b) {name}: host loop vs fused")
            log(f"scenarios (b) {name} (host): decisions equal to the "
                f"joint control plane's bit for bit; {host_wall:.2f}s wall "
                f"against {wall:.2f}s")


def fed_member_factory(seed, cfg, req, qcfg, n_layers, n_experts, top_k,
                       device):
    """``benchmarks/bench_federation.py``'s deterministic member factory,
    on ``device``."""
    import numpy as np

    from repro_torch import core
    from repro_torch.traffic import FleetSim, build_ground_segment

    def build(min_bins=0):
        con = core.Constellation(cfg)
        topo = core.sample_topology(con, core.LinkConfig(),
                                    np.random.default_rng(seed))
        act = core.ActivationModel.zipf(n_layers, n_experts, top_k, seed=1)
        ground = build_ground_segment(con, core.LinkConfig(),
                                      min_elevation_deg=10.0)
        return FleetSim([core.spacemoe_plan(con, topo, act)], topo, act,
                        core.MoEWorkload.llama_moe_3p5b(),
                        core.ComputeConfig(), req,
                        np.random.default_rng(5), qcfg=qcfg, ground=ground,
                        min_bins=min_bins, device=device)
    return build


def same_federation(a, b, what) -> None:
    """Card against CPU on one FederationResult: identical served, shed,
    retry, hop and assignment sets and round counts; TTFT/E2E to rtol
    1e-5; goodput to 1e-9; each member's rows at the fused-vs-legacy
    criterion with identical shed and retry sets."""
    import numpy as np
    fa, fb = a.federated, b.federated
    ok = (a.n_rounds == b.n_rounds and np.array_equal(a.hops, b.hops)
          and np.array_equal(a.assigned, b.assigned)
          and np.array_equal(a.offered, b.offered)
          and np.array_equal(fa.served, fb.served)
          and np.array_equal(fa.shed, fb.shed)
          and np.array_equal(fa.retries, fb.retries)
          and np.isclose(fa.goodput_tok_s, fb.goodput_tok_s, rtol=1e-9,
                         atol=0.0))
    for arr in ("ttft_s", "e2e_s"):
        ok = ok and np.allclose(getattr(fa, arr), getattr(fb, arr),
                                rtol=1e-5, atol=0.0, equal_nan=True)
    if not ok:
        raise SmokeFailure(f"{what}: the federated rows differ")
    for k, (ma, mb) in enumerate(zip(a.members, b.members)):
        assert_parity(ma, mb, f"{what} member {k}")
        same_admission(ma, mb, f"{what} member {k}")


def fed_hotspot(torch) -> None:
    """Phase 12 (c), the hotspot stage: K = 3 on 8 x 12, every request
    homed on member 0, AIMD at 10 s, a 2-entry nested sweep (F = 6 lanes);
    overflow off bitwise each member's own run, overflow on at least 1.3x
    the goodput at p99 TTFT at most 1.05x, card against CPU, one fixed
    point and its kernel launches per overflow round."""
    import numpy as np

    from repro_torch import core
    from repro_torch.kernels import ops
    from repro_torch.traffic import (AdmissionConfig, FederationConfig,
                                     QueueConfig, RequestBatch,
                                     build_federation, federation,
                                     poisson_arrivals, sample_decode_lens,
                                     sample_prompt_lens)
    rng = np.random.default_rng(8)
    t = poisson_arrivals(5.0, 60.0, rng)
    n = t.size
    req = RequestBatch(
        arrival_s=t,
        prompt_len=sample_prompt_lens(n, rng, median=4, sigma=0.4,
                                      max_len=16),
        decode_len=sample_decode_lens(n, rng, mean=4, max_len=8),
        station=rng.integers(0, 8, n))
    cfg = core.ConstellationConfig.scaled(8, 12, n_slots=10,
                                          survival_prob=1.0)
    qcfg = QueueConfig(dt_s=0.05, tail_s=60.0,
                       admission=AdmissionConfig(ttft_target_s=10.0))
    home = np.zeros(req.n_requests, dtype=np.int64)
    masks = np.stack([np.ones(req.n_requests, dtype=bool),
                      np.random.default_rng(1).random(req.n_requests) < 0.7])
    calls = [0]
    real = federation._fleet_fixed_point

    def counted(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)
    res = {}
    federation._fleet_fixed_point = counted
    try:
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            fed = build_federation(
                [fed_member_factory(s, cfg, req, qcfg, 4, 4, 2, device)
                 for s in (0, 1, 2)], FederationConfig(overflow=True),
                home=home)
            t_build = time.perf_counter() - t0
            for route in (False, True):
                calls[0] = 0
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                out = fed.run_many(masks, overflow=route)
                if device == "cuda":
                    torch.cuda.synchronize()
                res[device, route] = dict(out=out, calls=calls[0],
                                          wall=time.perf_counter() - t0,
                                          launches=ops.launch_counts())
            res[device] = fed
            log(f"scenarios (c) hotspot federation on {device}: K=3, R="
                f"{req.n_requests}, T={fed.n_bins}, rows_max {fed._sr_max},"
                f" F={masks.shape[0] * 3} lanes, member chunks "
                f"{[sim._f_src.size for sim in fed.sims]}, built in "
                f"{t_build:.1f}s; "
                f"overflow off {res[device, False]['wall']:.2f}s, on "
                f"{res[device, True]['wall']:.2f}s")
    finally:
        federation._fleet_fixed_point = real
    fed = res["cuda"]
    n_it = qcfg.iterations
    for route in (False, True):
        r = res["cuda", route]
        rounds = r["out"][0].n_rounds
        want = {"deposit": rounds * (n_it - 1), "backlog_scan": rounds * n_it,
                "admission_window": rounds * n_it,
                "admission_ctrl": rounds * n_it}
        log(f"scenarios (c) hotspot overflow {route}: {rounds} rounds, "
            f"{r['calls']} fixed points, launches {json.dumps(r['launches'])}"
            f" (expected {json.dumps(want)})")
        if r["calls"] != rounds or {k: r["launches"][k] for k in want} \
                != want:
            raise SmokeFailure(f"scenarios (c) hotspot overflow {route}: "
                               f"{r['calls']} fixed points and launches "
                               f"{r['launches']} for {rounds} rounds")
        for s, (a, b) in enumerate(zip(r["out"], res["cpu", route]["out"])):
            same_federation(a, b, f"scenarios (c) hotspot overflow {route} "
                            f"entry {s}: card vs CPU")
    # Overflow off: each member bitwise its own FleetSim.run on its home
    # slice (bench_federation._parity_problems).
    fields = ("served", "shed", "retries", "ttft_s", "e2e_s", "tpot_s",
              "station_util", "token_total_s")
    for s, out in enumerate(res["cuda", False]["out"]):
        for k, sim in enumerate(fed.sims):
            alone = sim.run(masks[s] & (fed.home == k))
            for pf, pa in zip(out.members[k].plans, alone.plans):
                for f in fields:
                    if not np.array_equal(getattr(pf, f), getattr(pa, f),
                                          equal_nan=f.endswith("_s")):
                        raise SmokeFailure(
                            f"scenarios (c) hotspot entry {s} member {k}: "
                            f"{f} differs from its standalone run")
    gi = res["cuda", False]["out"][0].federated
    gf = res["cuda", True]["out"][0].federated
    gain = gf.goodput_tok_s / gi.goodput_tok_s if gi.goodput_tok_s else \
        float("inf")
    p99_i, p99_f = gi.quantile("ttft", 0.99), gf.quantile("ttft", 0.99)
    on = res["cuda", True]["out"][0]
    log(f"scenarios (c) hotspot: independent {gi.goodput_tok_s:.3f} tok/s "
        f"(shed {int(gi.shed.sum())}), federated {gf.goodput_tok_s:.3f} "
        f"tok/s (shed {int(gf.shed.sum())}, {int((on.hops > 0).sum())} "
        f"re-routed in {on.n_rounds} rounds): {gain:.3f}x (gate >= "
        f"{FED_GAIN_MIN}); p99 TTFT {p99_i:.3f} -> {p99_f:.3f}s (gate <= "
        f"{FED_P99_FACTOR}x); overflow off bitwise each member's own run")
    if not (gain >= FED_GAIN_MIN and p99_f <= FED_P99_FACTOR * p99_i):
        raise SmokeFailure(f"scenarios (c) hotspot: goodput gain {gain:.3f}"
                           f", p99 {p99_i:.3f} -> {p99_f:.3f}s")


def rss_mb() -> float:
    """This process's resident memory now (``VmRSS``), MB."""
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) / 1024.0
    raise SmokeFailure("/proc/self/status has no VmRSS")


def fed_million(torch) -> None:
    """Phase 12 (c), the million-user stage at its full setting: 1.01e6
    users streamed (``stream_requests``), K = 2 on 6 x 8, one launch;
    stream, build, prep and device wall, peak device memory, resident
    memory sampled after each step against the reference's peak-RSS
    budget (the process's own peak includes the phases before), shed; the
    four fleet kernels bitwise against their plain versions on the tables
    this launch gave them, timed beside their bounds."""
    import resource

    import numpy as np

    from repro_torch import core
    from repro_torch.traffic import (AdmissionConfig, QueueConfig,
                                     admission, build_federation, queueing,
                                     stream_requests)
    rss = [rss_mb()]
    rate_max = 2500.0
    t0 = time.perf_counter()
    req, n_env = stream_requests(
        np.random.default_rng(0), lambda t: np.full_like(t, 0.96 * rate_max),
        rate_max, FED_MILLION_USERS / (0.96 * rate_max), n_stations=8,
        shard_s=60.0, prompt_median=2, prompt_sigma=0.3, prompt_max=4,
        decode_mean=1, decode_max=2)
    t_stream = time.perf_counter() - t0
    rss.append(rss_mb())
    cfg = core.ConstellationConfig.scaled(6, 8, n_slots=8, survival_prob=1.0)
    qcfg = QueueConfig(dt_s=0.5, tail_s=60.0,
                       admission=AdmissionConfig(ttft_target_s=20.0))
    t0 = time.perf_counter()
    fed = build_federation([fed_member_factory(s, cfg, req, qcfg, 2, 2, 1,
                                               "cuda") for s in (0, 1)])
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    rss.append(rss_mb())
    K = len(fed.sims)
    offered = np.stack([fed.home == k for k in range(K)])[None]
    t0 = time.perf_counter()
    prep = fed._prepare(offered)
    t_prep = time.perf_counter() - t0
    rss.append(rss_mb())

    captured: dict = {}
    real = (queueing.deposit, queueing.backlog_scan,
            admission.admission_window, admission.admission_ctrl)

    def dep(rows, cols, vals, n_rows, n_cols, row_ptr):
        captured["deposit"] = (rows, cols, vals, n_rows, n_cols, row_ptr)
        return real[0](rows, cols, vals, n_rows, n_cols, row_ptr=row_ptr)

    def scan(work, cap, dt):
        captured["backlog_scan"] = (work, cap, dt)
        return real[1](work, cap, dt)

    def window(*args):
        captured["admission_window"] = args
        return real[2](*args)

    def ctrl(win, *args, **kw):
        captured["admission_ctrl"] = (win, args, kw)
        return real[3](win, *args, **kw)
    queueing.deposit, queueing.backlog_scan = dep, scan
    admission.admission_window, admission.admission_ctrl = window, ctrl
    try:
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        fed._execute(prep)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
    finally:
        (queueing.deposit, queueing.backlog_scan, admission.admission_window,
         admission.admission_ctrl) = real
    t0 = time.perf_counter()
    out = fed._execute(prep)
    torch.cuda.synchronize()
    t_device = time.perf_counter() - t0
    rss.append(rss_mb())
    n_shed = int(sum((out["shed"][k, 0] & offered[0, k]).sum()
                     for k in range(K)))
    n_chunks = int(prep["chunks"]["row_ptr"][-1])
    log(f"scenarios (c) million: {req.n_requests} users "
        f"({n_env} envelope draws), K={K} on 6 x 8, T={fed.n_bins}, "
        f"rows_max {fed._sr_max}, F={K} lanes, {n_chunks} chunks "
        f"(+{prep['chunks']['src'].size - n_chunks} padding); stream "
        f"{t_stream:.2f}s, build {t_build:.2f}s, host prep {t_prep:.2f}s, "
        f"device call {t_device:.3f}s (first {t_first:.3f}s): host prep + "
        f"stream {t_stream + t_prep:.2f}s vs device {t_device:.3f}s "
        f"(reported, not gated); peak device memory {peak:.2f} GiB above "
        f"the simulators; resident memory after start, stream, build, prep "
        f"and launch {[round(x) for x in rss]} MB (process peak "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024:.0f} MB"
        f" with the phases before; the reference's "
        f"peak-RSS budget {FED_RSS_BUDGET_MB} MB); {n_shed} shed")

    what = f"the million-user federation's lane-stacked tables (F={K})"
    recs = [check_deposit(torch, captured["deposit"], what),
            check_scan(torch, *captured["backlog_scan"], what),
            check_window(torch, captured["admission_window"], what),
            check_ctrl(torch, *captured["admission_ctrl"], what)]
    for rec in recs:
        log("kernel " + json.dumps(rec))
    bad = [r["shape"] for r in recs if not r["ok"]]
    if bad:
        raise SmokeFailure(f"fleet kernels disagree with their plain "
                           f"versions on the federation's tables: {bad}")


def scenario_serve(torch) -> None:
    """Phase 12 (d): ``python -m repro_torch.launch.serve`` for
    llama-moe-3.5b at full width with the traffic, replan, federation,
    elastic and trace flags, in a process that then prints the kernels'
    launch counts (step 4 on a 12 x 32 constellation, one satellite a
    layer in each plane); its lines, its trace through ``validate_trace``
    and the gmm/decode_attention launch counts of phase 5."""
    import os
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.obs import validate_trace
    cfg = get_config(ARCH)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        trace = Path(tmp) / "serve_trace.json"
        argv = ["--arch", ARCH, "--batch", str(BATCH), "--prompt-len",
                str(PROMPT), "--decode-tokens", str(DECODE), "--traffic",
                "regional-hotspot-replan", "--ctrl", "fused",
                "--admission", "aimd", "--federation", "2",
                "--fail-device", "3", "--trace", str(trace)]
        code = ("import json, runpy, sys; sys.argv = ['serve'] + "
                "sys.argv[1:]; from repro_torch.kernels import ops; "
                "ops.reset_launch_counts(); "
                "runpy.run_module('repro_torch.launch.serve', "
                "run_name='__main__', alter_sys=True); "
                "print('launch counts ' + json.dumps(ops.launch_counts()))")
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-c", code, *argv], cwd=ROOT,
                             env=dict(os.environ,
                                      PYTHONPATH=str(ROOT / "src")),
                             capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        lines = res.stdout.splitlines()
        for line in lines:
            if not line.startswith("launch counts"):
                log(f"scenarios (d) serve | {line}")
        if res.returncode != 0:
            raise SmokeFailure(f"scenarios (d): serve exited "
                               f"{res.returncode}: {res.stderr[-2000:]}")
        for tag in ("[traffic]", "[replan]", "[federation]", "[elastic]",
                    "[trace]"):
            if not any(line.startswith(tag) for line in lines):
                raise SmokeFailure(f"scenarios (d): serve printed no {tag} "
                                   "line")
        problems = validate_trace(json.loads(trace.read_text()))
        counts = json.loads(next(line for line in lines
                                 if line.startswith("launch counts"))
                            .split(" ", 2)[2])
    want = {"gmm": 3 * cfg.n_layers * (2 + DECODE),
            "decode_attention": cfg.n_layers * DECODE}
    log(f"scenarios (d) serve at full width: {wall:.1f}s wall (process "
        f"start included); validate_trace: "
        f"{problems[:3] if problems else 'no problems'}; launch counts "
        f"{json.dumps(counts)} (expected gmm and decode_attention "
        f"{json.dumps(want)})")
    if problems or {k: counts[k] for k in want} != want:
        raise SmokeFailure(f"scenarios (d): trace {problems[:3]}, launch "
                           f"counts {counts} != {want}")


def phase_scenarios(torch) -> None:
    """Phase 12: (a) bench_replan, (b) the scenario registry, (c)
    bench_federation's two stages, (d) the serve entry point."""
    scenario_registry(torch, scenario_replan_bench(torch))
    fed_hotspot(torch)
    fed_million(torch)
    scenario_serve(torch)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: this smoke "
                           "run needs a CUDA card")
    try:
        from repro_torch.kernels import build
    except ImportError as exc:
        raise SmokeFailure(f"cannot import the port from {ROOT / 'src'}: "
                           f"{exc}") from exc
    torch.backends.cuda.matmul.allow_tf32 = False    # plain f32 is exact f32
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__} (CUDA {torch.version.cuda}) "
        f"sees {kind} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"built {', '.join(logs)} in {time.perf_counter() - t0:.1f}s")
    for name, text in logs.items():          # ptxas: registers, spills, smem
        for line in text.splitlines():
            if "Used" in line or ("spill" in line and " 0 bytes spill" not in line):
                log(f"ptxas {name}: {line.strip()}")

    seconds = {"build": time.perf_counter() - t0}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        log(f"phase {name}: {seconds[name]:.1f}s")
        return out

    main_cases = timed("kernels", phase_kernels, torch)
    deep_cases = timed("kernels_deepseek", phase_kernels_deepseek, torch)
    timed("small", phase_small, torch)
    timed("small_deepseek", phase_small, torch, DEEPSEEK)
    counts = timed("serve", phase_serve, torch, card)
    timed("profile", phase_profile, torch)
    deep_counts = timed("serve_deepseek", phase_serve, torch, card, DEEPSEEK,
                        ("--space-sim",))
    deep_prof = timed("profile_deepseek", phase_profile, torch, 4, DEEPSEEK,
                      None, True)
    torch.cuda.empty_cache()           # the 16B model's blocks go back
    timed("calibration", phase_calibration, torch)
    arch_cases, arch_counts = timed("archs", phase_archs, torch, card)
    torch.cuda.empty_cache()
    rec_rows, rec_counts = timed("recurrent", phase_recurrent, torch, card)
    torch.cuda.empty_cache()
    train_rows, train_run = timed("train", phase_train, torch, card)
    torch.cuda.empty_cache()
    shard_rows = timed("sharding", phase_sharding, torch, card)
    timed("dryrun", phase_dryrun, torch, card, deep_prof["count"], train_run)
    torch.cuda.empty_cache()
    tp_rows = timed("tp", phase_tp, torch, card)
    torch.cuda.empty_cache()
    cp_rows = timed("zero_cp", phase_zero_cp, torch, card)
    fleet_counts, captured, in_run, world = timed("fleet", phase_fleet, torch)
    main_cases.update(timed("fleet_kernels", phase_fleet_kernels, torch,
                            captured, in_run))
    del captured
    win_rec, ctrl_rec, adm_counts, adm_sims = timed(
        "fleet_admission", phase_fleet_admission, torch, world)
    timed("fleet_batching", phase_fleet_batching, torch, world, adm_sims)
    del adm_sims
    timed("replan", phase_replan, torch, world)
    del world
    timed("scenarios", phase_scenarios, torch)
    main_cases["admission_window"] = win_rec
    main_cases["admission_ctrl"] = ctrl_rec
    mixed = [name for name, rec in (*main_cases.items(), *deep_cases.items(),
                                    *arch_cases.items(),
                                    *((n, r) for n, r, _ in rec_rows),
                                    *((n, r) for n, r, _ in train_rows),
                                    *((n, r) for n, r, _ in shard_rows),
                                    *((n, r) for n, r, _ in tp_rows),
                                    *((n, r) for n, r, _ in cp_rows))
             if not rec["hidden"]]
    if mixed:
        raise SmokeFailure(f"kernel device time not separable from the "
                           f"host's: {mixed}")
    counts = dict(counts, deposit=fleet_counts["deposit"],
                  backlog_scan=fleet_counts["backlog_scan"],
                  admission_window=adm_counts["admission_window"],
                  admission_ctrl=adm_counts["admission_ctrl"])
    log(f"phase seconds {json.dumps({k: round(v, 1) for k, v in seconds.items()})}"
        f", total {time.perf_counter() - t0:.1f}s")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    sources = {
        "gmm": ("src/repro_torch/kernels/csrc/moe_gmm.cu",
                "src/repro/kernels/moe_gmm.py:54"),
        "decode_attention": ("src/repro_torch/kernels/csrc/decode_attn.cu",
                             "src/repro/kernels/decode_attn.py:83"),
        "deposit": ("src/repro_torch/kernels/csrc/deposit.cu",
                    "src/repro/kernels/deposit.py:147"),
        "backlog_scan": ("src/repro_torch/kernels/csrc/backlog_scan.cu",
                         "src/repro/traffic/queueing.py:553"),
        "admission_window": ("src/repro_torch/kernels/csrc/admission_window.cu",
                             "src/repro/traffic/queueing.py:589"),
        "admission_ctrl": ("src/repro_torch/kernels/csrc/admission_ctrl.cu",
                           "src/repro/traffic/queueing.py:589"),
    }
    # Each kernel at its main path's shape; gmm and decode_attention also
    # at deepseek-moe-16b's decode shape, with that serve run's launches,
    # and at phase 13's decode shapes, each with its own run's launches.
    runs = [(main_cases, counts), (deep_cases, deep_counts)]
    runs += [({key.split("/")[0]: rec}, arch_counts[key.split("/", 1)[1]])
             for key, rec in arch_cases.items()]
    # jamba's shapes (phase 14c), each with its launches in the block runs.
    runs += [({name: rec}, {name: n}) for name, rec, n in rec_rows]
    # The train step's gmm calls (phase 15a), each with its launches over
    # phase 15c's run.
    runs += [({name: rec}, {name: n}) for name, rec, n in train_rows]
    # The EP bodies' gmm calls (phase 16c), each with its launches over
    # phase 16a's run.
    runs += [({name: rec}, {name: n}) for name, rec, n in shard_rows]
    # gmm and decode_attention at rank 0's shapes on the pod mesh (18c),
    # each with its launches over 18b's runs.
    runs += [({name: rec}, {name: n}) for name, rec, n in tp_rows]
    # decode_attention's partial mode at 19c's shape (19d), with its
    # launches over 19c's decode steps.
    runs += [({name: rec}, {name: n}) for name, rec, n in cp_rows]
    kernels = []
    for cases, launches in runs:
        for name, rec in cases.items():
            rec = dict(rec, route="cuda", source=sources[name][0],
                       replaces=sources[name][1], launches=launches[name])
            kernels.append({k: rec[k] for k in keys})
    log(f"recurrent runs' launch counts {json.dumps(rec_counts)}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"[chip_smoke] FAILED: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)
