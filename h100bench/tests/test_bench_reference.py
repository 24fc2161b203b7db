"""The plain reference agrees with ``repro_torch`` at smoke size on the
CPU, the check fails each fault planted in the timed path, and nothing
the harness loads is JAX or the JAX package."""
import dataclasses
import json
import subprocess
import sys

import pytest
import torch

from h100bench import harness, inputs, reference

SERVE_SMOKE = {"batch": 4, "prompt_len": 16, "gen_tokens": 12,
               "calibration": [2, 16]}
TRAIN_SMOKE = {"batch": 2, "seq_len": 32}
CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


def _smoke(name):
    cell = harness.find_cell(name)
    return cell, harness.smoke_sizes(cell.sizes)


def _f32(cell, s):
    return dataclasses.replace(harness.program_config(cell, s),
                               compute_dtype="float32")


@pytest.mark.parametrize("name", ["deepseek-moe-16b.prefill-256",
                                  "granite-moe-3b-a800m.rag-2k"])
def test_reference_serves_as_the_program_does(name):
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import Parallel, prefill
    cell, s = _smoke(name)
    cfg = _f32(cell, s)
    params = inputs.draw_weights(s, 5, "cpu", train=True)
    prompts = inputs.tokens(5, inputs.BATCHES, 0, (6, 16), s.vocab_size, "cpu")
    fed = inputs.tokens(5, inputs.BATCHES, 1, (6, 5), s.padded_vocab, "cpu")
    par = Parallel(mesh=None)
    with torch.no_grad():
        logits, cache = prefill(cfg, params, {"tokens": prompts}, 22, par)
        got = [logits]
        step = make_serve_step(cfg, par)
        pos = torch.full((6,), 16, dtype=torch.int32)
        for j in range(5):
            _, logits, cache = step(params, cache, fed[:, j:j + 1], pos + j)
            got.append(logits)
    got = torch.stack(got, dim=1)
    want = reference.serve_logits(s, params, prompts, fed)
    assert want.shape == got.shape
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


def test_reference_trains_as_the_program_does():
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Parallel
    from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule
    from repro_torch.tree import tree_leaves
    cell, s = _smoke("granite-moe-3b-a800m.train-2k")
    cfg = _f32(cell, s)
    batches = [(t[:, :-1], t[:, 1:]) for t in
               (inputs.tokens(3, inputs.BATCHES, i, (2, 33), s.vocab_size, "cpu")
                for i in range(3))]
    opt = dict(lr=3e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
               grad_clip=1.0)
    params = inputs.draw_weights(s, 3, "cpu", train=True)
    state = adamw_init(params)
    step = make_train_step(cfg, Parallel(mesh=None), AdamWConfig(**opt),
                           cosine_schedule(2, 100))
    losses = []
    for tokens, labels in batches:
        params, state, m = step(params, state, {"tokens": tokens,
                                                "labels": labels})
        losses.append(float(m["loss"]))
    mine = inputs.draw_weights(s, 3, "cpu", train=True)
    ref = reference.train_steps(s, mine, batches, opt,
                                reference.cosine(2, 100))
    assert losses == pytest.approx(ref["loss"], rel=1e-5)
    for a, b in zip(tree_leaves(params), (t for _, t in reference.leaf_paths(mine))):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def _run(name, faults=()):
    kind = harness.find_cell(name).traffic["kind"]
    smoke = TRAIN_SMOKE if kind == "train" else SERVE_SMOKE
    return harness.run_cell(name, 2**32 + 9, 0.0, False, device="cpu",
                            smoke=smoke, faults=faults)


def _faults(name):
    kind = harness.find_cell(name).traffic["kind"]
    if kind == "prefill":             # no state carried from step to step
        return ("half_batch", "altered_token")
    if kind == "train":
        return ("stale_state", "half_batch")
    return harness.FAULTS


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    out = _run(name)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("name,fault", [(n, f) for n in CELLS
                                        for f in _faults(n)])
def test_the_check_fails_a_planted_fault(name, fault):
    out = _run(name, (fault,))
    assert not out["correct"], out["checks"]


def test_nothing_loaded_is_jax_or_the_jax_package():
    code = (
        "import sys; sys.path[:0] = ['.', 'src']\n"
        "import h100bench.reference, h100bench.yardstick, h100bench.inputs\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'repro', 'repro_torch')]\n"
        "assert not bad, bad\n"
        "from h100bench import harness\n"
        "for m in harness.benchmark()['per_layer']:\n"
        "    harness.reader(m['name'])\n"
        "cell = harness.find_cell('granite-moe-3b-a800m.rag-2k')\n"
        "harness.program_config(cell, cell.sizes)\n"
        "import repro_torch.launch.serve, repro_torch.launch.steps\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')) == []
