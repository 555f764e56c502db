"""``BENCHMARK.json`` keeps to the naming rules and names only files that
exist, and a cell, a traffic mix and a per-layer metric are added by new
files and entries alone: a throwaway cell added so in a temporary copy
runs end to end on the CPU (smoke models) and reports its new metric."""
import json
import time


from aisqlbench import _testcell, harness, spec


def test_benchmark_json_rules():
    doc = spec.load_json(spec.ROOT / "BENCHMARK.json")
    assert spec.problems(doc) == []
    assert set(doc) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert doc["paths"] == ["aisqlbench"]
    assert {m["name"] for m in doc["end_to_end"]} == {"rows_per_s",
                                                      "setup_s"}
    for m in doc["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_every_name_finds_its_file():
    b = spec.Bench()
    for w in b.workloads.values():
        conf = b.config_file(w["config"])
        assert conf["name"] == w["config"]
        assert b.traffic_file(w["traffic"])["operator"] == "filter"
        assert "check_rows" in b.cell_file(w["name"])
        for kind in ("end_to_end", "per_layer"):
            for m in b.metrics_of(w["name"], kind):
                assert callable(b.reader(m["name"]))
    for c in b.configs.values():
        assert c["file"].startswith("aisqlbench/configs/")


def test_metric_lists_per_cell():
    b = spec.Bench()
    for w in b.workloads:
        e2e = {m["name"] for m in b.metrics_of(w, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) == 2
        layer = b.metrics_of(w, "per_layer")
        assert layer and all(m["moves"] in e2e for m in layer)


def test_a_cell_added_by_files_runs(tmp_path):
    _testcell.copy_bench(tmp_path)
    name = _testcell.add_cell(tmp_path, "qwen3-32b", "tiny-filter")
    (tmp_path / "aisqlbench" / "metrics" / "prefill_tokens.tiny.py"
     ).write_text("def read(run):\n"
                  "    n = [s[3] for s in run.steps if s[0] == 'prefill']\n"
                  "    return float(sum(n)) if n else None\n")
    doc = json.loads((tmp_path / "BENCHMARK.json").read_text())
    doc["per_layer"].append({
        "name": "prefill_tokens.tiny", "unit": "tokens", "better": "higher",
        "source": "program_counter", "layer": "batcher prefill: "
        "inference/continuous, paged_kv", "moves": "rows_per_s",
        "workloads": [name]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    b = _testcell.bench(tmp_path)
    assert spec.problems(b.doc) == []
    for trace in (False, True):
        out = harness.run_cell(name, 7, 1.0, trace, bench=b, device="cpu",
                               smoke=True, t_start=time.perf_counter())
        assert out["failed"] == 0 and out["attempted"] >= 2
        assert list(out)[-1] == "checks"
        if trace:
            assert set(out["metrics"]) == {"prefill_tokens.tiny"}
            assert out["metrics"]["prefill_tokens.tiny"]["value"] > 0
        else:
            assert set(out["metrics"]) == {"rows_per_s", "setup_s"}
