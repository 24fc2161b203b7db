"""Trainer: data pipeline -> train step -> checkpoints
(counterpart of ``repro.launch.train``, the same flags and lines, plus
``--device``).

One device runs the whole step, as the reference's trainer runs without
a mesh; a sharded step is ``launch.steps.make_train_step`` with a
``models.Parallel`` (ZeRO-1 with ``zero_opt``), and the checkpoints of
its blocks go through ``checkpoint.CheckpointManager`` with their specs.
The model is drawn uncast (f32 master weights, ``init_params(cast=
False)``) and trained with the reference's AdamW and schedules; on a
CUDA device the MoE FFN's forward and backward products run through the
hand-written ``gmm`` kernel.  Fault tolerance: ``--simulate-failure N``
hard-exits (code 42) after N steps of this launch; re-launching with the
same ``--ckpt-dir`` resumes exactly (the data pipeline is a pure
function of the step, so no batch is skipped or repeated).

    python -m repro_torch.launch.train --smoke --device cpu --steps 8 \
        --batch 2 --seq 32
    python -m repro_torch.launch.train --arch granite-moe-3b-a800m \
        --steps 6 --batch 4 --seq 2048 --warmup 2
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from .. import resolve_device
from ..checkpoint import CheckpointManager
from ..configs import get_config, smoke_config
from ..data import DataConfig, SyntheticTokens, make_batch
from ..models import Parallel, init_params
from ..optim import AdamWConfig, adamw_init, cosine_schedule, wsd_schedule
from ..tree import tree_leaves
from .steps import make_train_step

FAILURE_EXIT_CODE = 42


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", default="cosine", choices=["cosine", "wsd"])
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--simulate-failure", type=int, default=0,
                    help="hard-exit after N steps (fault-tolerance demo)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    sched = (cosine_schedule if args.schedule == "cosine" else wsd_schedule)(
        args.warmup, args.steps)
    opt_cfg = AdamWConfig(lr=args.lr)
    par = Parallel(mesh=None)           # host run: single-shard math
    step_fn = make_train_step(cfg, par, opt_cfg, sched)

    data = SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed))

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device, cast=False)
    opt_state = adamw_init(params)
    n_params = sum(x.numel() for x in tree_leaves(params))
    start_step = 0

    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3)
        restored = mgr.restore_latest({"params": params, "opt": opt_state})
        if restored is not None:
            start_step, tree = restored
            params, opt_state = tree["params"], tree["opt"]
            print(f"[resume] from step {start_step}")

    print(f"[train] {cfg.name}: {n_params/1e6:.1f}M params, "
          f"{args.batch}x{args.seq} tokens/step, device={device}")
    losses = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in make_batch(cfg, data, step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            tok_s = (step - start_step + 1) * args.batch * args.seq / max(dt, 1e-9)
            print(f"step {step:5d}  loss {losses[-1]:.4f}  "
                  f"ce {float(metrics['ce']):.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  tok/s {tok_s:,.0f}")
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, {"params": params, "opt": opt_state})
        if args.simulate_failure and step + 1 - start_step >= args.simulate_failure:
            print(f"[failure-sim] hard exit at step {step + 1}", flush=True)
            os._exit(FAILURE_EXIT_CODE)
    if mgr:
        mgr.save(args.steps, {"params": params, "opt": opt_state})
    return {"final_loss": losses[-1] if losses else float("nan"),
            "losses": losses, "n_params": n_params}


if __name__ == "__main__":
    out = main()
    print(f"[done] final loss {out['final_loss']:.4f}")
