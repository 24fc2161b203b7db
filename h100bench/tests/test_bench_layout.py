"""The harness finds every cell, mix, configuration and metric by name,
and a new one is added by new files and entries alone."""
import json
import shutil
import types

import pytest

from h100bench import harness, inputs, yardstick


def test_every_cell_mix_and_metric_is_found():
    bench = harness.benchmark()
    for w in bench["workloads"]:
        cell = harness.find_cell(w["name"])
        assert cell.traffic["kind"] in ("prefill", "generate", "train")
        assert set(cell.limits) and cell.end_to_end and cell.per_layer
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
    for m in bench["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_configuration_files_match_the_port():
    bench = harness.benchmark()
    for w in bench["workloads"]:
        cell = harness.find_cell(w["name"])
        cfg = harness.program_config(cell, cell.sizes)
        assert cfg.name == cell.config["arch"]


def test_new_cell_mix_and_metric_need_only_new_files(tmp_path):
    root = harness.ROOT
    shutil.copy(root / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(root / "h100bench", tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "h100bench").rglob("*")
              if p.is_file()}
    here = tmp_path / "h100bench"
    (here / "configs" / "granite-copy.json").write_text(
        (here / "configs" / "granite-moe-3b-a800m.json").read_text())
    mix = json.loads((here / "traffic" / "rag-2k.json").read_text())
    mix.update(prompt_len=1024, gen_tokens=8)
    (here / "traffic" / "rag-1k.json").write_text(json.dumps(mix))
    (here / "limits" / "granite-copy.rag-1k.json").write_text(
        (here / "limits" / "granite-moe-3b-a800m.rag-2k.json").read_text())
    (here / "metrics" / "tokens_per_unit.py").write_text(
        "def read(run):\n    return 1.0\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({**bench["configs"][1], "name": "granite-copy",
                             "file": "h100bench/configs/granite-copy.json"})
    bench["workloads"].append({"name": "granite-copy.rag-1k",
                               "config": "granite-copy", "traffic": "rag-1k",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "tokens_per_unit.gen", "unit": "tokens",
                               "better": "higher", "source": "host_clock",
                               "layer": "Serve step", "moves": "gen_tok_s",
                               "workloads": ["granite-copy.rag-1k"]})
    for m in bench["end_to_end"]:
        if m["name"] == "gen_tok_s":
            m["workloads"].append("granite-copy.rag-1k")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.find_cell("granite-copy.rag-1k", tmp_path)
    assert cell.traffic["prompt_len"] == 1024
    assert "tokens_per_unit.gen" in {m["name"] for m in cell.per_layer}
    assert "gen_tok_s" in {m["name"] for m in cell.end_to_end}
    assert harness.reader("tokens_per_unit.gen", tmp_path)(None) == 1.0
    assert all(p.read_bytes() == b for p, b in before.items())


ALT_FAMILY = '''"""attn_moe with one more model key, ``logit_bias`` (added to the
reference's logit of token 0), the final norm drawn at std 0.2, and
twice the routed experts' flops and one more multiply-add a token."""
import dataclasses

from h100bench.families import attn_moe as base, sizes_from
from h100bench.families.attn_moe import (decode_attn_row_bytes, head_flops,
                                         loss, pair_flops, smoke,
                                         smoke_config, want)


@dataclasses.dataclass(frozen=True)
class Sizes(base.Sizes):
    logit_bias: float


def sizes_of(model):
    return sizes_from(Sizes, model, "attn_moe_alt")


def leaf_specs(s):
    return [(p, shape, 0.2 if p == ("final_norm", "scale") else std, kind)
            for p, shape, std, kind in base.leaf_specs(s)]


def serve_logits(s, params, prompts, fed, prec="f32"):
    out = base.serve_logits(s, params, prompts, fed, prec)
    out[..., 0] += s.logit_bias
    return out


def token_matmul_params(s):
    return base.token_matmul_params(s) + 1


def gmm_need(s, n_tokens, backward=False):
    flops, nbytes = base.gmm_need(s, n_tokens, backward)
    return 2 * flops, nbytes
'''


def test_new_family_needs_only_new_files(tmp_path, monkeypatch):
    """A family module, two configurations that name it (its extra key at
    0 and at 1e4) and their cells, all new files: the harness finds the
    module, draws the weights by its specs, checks serving against its
    reference and counts by its counts."""
    root = harness.ROOT
    shutil.copy(root / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(root / "h100bench", tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "h100bench").rglob("*")
              if p.is_file()}
    here = tmp_path / "h100bench"
    (here / "families" / "attn_moe_alt.py").write_text(ALT_FAMILY)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    base = json.loads((here / "configs" / "granite-moe-3b-a800m.json")
                      .read_text())
    limits = (here / "limits" / "granite-moe-3b-a800m.rag-2k.json").read_text()
    for name, bias in (("granite-alt", 0.0), ("granite-alt-bias", 1e4)):
        conf = {**base, "family": "attn_moe_alt",
                "model": {**base["model"], "logit_bias": bias}}
        (here / "configs" / f"{name}.json").write_text(json.dumps(conf))
        (here / "limits" / f"{name}.rag-2k.json").write_text(limits)
        bench["configs"].append({**bench["configs"][1], "name": name,
                                 "file": f"h100bench/configs/{name}.json"})
        bench["workloads"].append({"name": f"{name}.rag-2k", "config": name,
                                   "traffic": "rag-2k", "chips": 1,
                                   "why": "a test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "granite-moe-3b-a800m.rag-2k" in m.get("workloads", ()):
                m["workloads"].append(f"{name}.rag-2k")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.find_cell("granite-alt.rag-2k", tmp_path)
    fam = cell.family
    assert fam.__file__ == str(here / "families" / "attn_moe_alt.py")
    assert cell.sizes.logit_bias == 0.0 and cell.sizes.d_model == 1536

    drawn = []
    real_draw = inputs.draw_weights

    def draw(specs, *args, **kw):
        drawn.append(specs)
        return real_draw(specs, *args, **kw)

    monkeypatch.setattr(inputs, "draw_weights", draw)
    smoke = {"batch": 4, "prompt_len": 16, "gen_tokens": 6,
             "calibration": [2, 16]}
    runs = {name: harness.run_cell(f"{name}.rag-2k", 5, 0.0, False,
                                   device="cpu", smoke=smoke, readings=True,
                                   root=tmp_path)
            for name in ("granite-alt", "granite-alt-bias")}
    assert drawn and all(
        dict((p, std) for p, _, std, _ in specs)[("final_norm", "scale")]
        == 0.2 for specs in drawn)
    assert runs["granite-alt"]["correct"], runs["granite-alt"]["checks"]
    assert not runs["granite-alt-bias"]["correct"]
    assert runs["granite-alt-bias"]["readings"]["max_gap"] > 1e3

    old = harness.find_cell("granite-moe-3b-a800m.rag-2k")
    traffic = {**cell.traffic, "kind": "prefill", "gen_tokens": 1}
    tokens = traffic["batch"] * traffic["prompt_len"]
    read = {}
    for c in (cell, old):
        run = types.SimpleNamespace(
            cell=c, sizes=c.sizes, traffic=traffic, units=1, window_s=1.0,
            traced={"segments": [("prefill", [("gmm_k", 0.0, 1.0)])]})
        read[c.family] = [harness.reader(m, tmp_path)(run)
                          for m in ("mfu.prefill", "gmm_roofline.prefill")]
    (mfu, gmm), (mfu0, gmm0) = read[fam], read[old.family]
    assert mfu - mfu0 == pytest.approx(
        100.0 * 2 * tokens / yardstick.PEAK_BF16_FLOPS, rel=1e-6)
    assert gmm == pytest.approx(2 * gmm0, rel=1e-12)   # flops-bound here
    assert all(p.read_bytes() == b for p, b in before.items())
