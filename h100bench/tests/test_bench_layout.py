"""The harness finds every cell, mix, configuration and metric by name,
and a new one is added by new files and entries alone."""
import json
import shutil

from h100bench import harness


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
