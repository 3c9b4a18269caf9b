"""The harness finds cells, configurations, traffic mixes, load shapes,
limits and metrics by name, and a new one is new files plus new entries."""

import json
import os
import shutil
import time

import pytest
from conftest import ROOT, spec_path, tiny

from benchmark import harness, registry

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in SPEC["workloads"]]
WITH_SHELVED = json.load(open(spec_path()))  # BENCHMARK.json and the shelved cells


@pytest.mark.parametrize("name", [w["name"] for w in WITH_SHELVED["workloads"]])
def test_every_cell_finds_its_pieces(name):
    cell = registry.find_cell(name, spec_path=spec_path())
    w = next(w for w in WITH_SHELVED["workloads"] if w["name"] == name)
    assert cell.config["name"] == w["config"]
    assert cell.chips == w["chips"] == 1
    assert callable(registry.load_shape(cell.traffic["kind"]))
    assert cell.limits["missing"]["limit"] == 0
    for m in cell.end_to_end + cell.per_layer:
        assert callable(registry.metric_reader(m["name"]))
    names = {m["name"] for m in cell.end_to_end}
    assert {"qps", "latency_p50_ms", "setup_s"} <= names
    assert ("latency_p95_ms" in names) == (name != "b1m.rerank32")


@pytest.mark.parametrize("spec", [SPEC, WITH_SHELVED], ids=["benchmark", "with_shelved"])
def test_every_metric_has_a_reader_and_moves_a_reported_metric(spec):
    cells = [w["name"] for w in spec["workloads"]]
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py"))
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in moved.get("workloads", cells)
    used = {w["config"] for w in spec["workloads"]}
    for c in spec["configs"]:
        assert c["name"] in used
        assert json.load(open(os.path.join(ROOT, c["file"])))["reduced"] == c["reduced"]


NEW_LOOP = '''
from benchmark.loops import closed


async def drive(submit, queries, traffic, seconds, hooks):
    """The closed loop over the pool read backwards."""
    return await closed.drive(submit, queries[::-1], traffic, seconds, hooks)
'''

NEW_METRIC = '''
def read(run):
    return float(len(run.requests))
'''


def _new_cell_tree(tmp_path):
    """A checkout with one more cell, configuration, traffic mix, load
    shape and metric, all new files and entries: no file that is there
    changes."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads(json.dumps(SPEC))
    b = root / "benchmark"
    cfg = json.load(open(b / "configs" / "collection-1m-bf16-minilm-ce.json"))
    cfg["name"] = "collection-1m-int8-minilm"
    cfg["storage_dtype"] = "int8"
    (b / "configs" / "collection-1m-int8-minilm.json").write_text(json.dumps(cfg))
    traffic = json.load(open(b / "traffic" / "rerank32.json"))
    traffic.update(kind="closed_backwards", rerank=False, clients=256)
    (b / "traffic" / "search64_backwards.json").write_text(json.dumps(traffic))
    (b / "loops" / "closed_backwards.py").write_text(NEW_LOOP)
    (b / "metrics" / "requests_total.py").write_text(NEW_METRIC)
    limits = json.load(open(b / "limits" / "b1m.rerank32.json"))
    for name in ("ce_err", "rerank_gap"):
        del limits[name]
    (b / "limits" / "b1m8.backwards.json").write_text(json.dumps(limits))
    spec["configs"].append({"name": cfg["name"], "source": cfg["source"],
                            "file": "benchmark/configs/collection-1m-int8-minilm.json",
                            "reduced": cfg["reduced"], "why": "an int8 default collection"})
    spec["workloads"].append({"name": "b1m8.backwards", "config": cfg["name"],
                              "traffic": "search64_backwards", "chips": 1, "why": "a test cell"})
    spec["end_to_end"].append({"name": "requests_total", "unit": "requests", "better": "higher",
                               "bound": 0.25, "source": "host_clock",
                               "workloads": ["b1m8.backwards"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def test_a_new_cell_is_new_files_and_entries(tmp_path, small_chunks):
    root = _new_cell_tree(tmp_path)
    bench = str(root / "benchmark")
    before = {p: open(os.path.join(ROOT, "benchmark", p)).read()
              for p in ("registry.py", "harness.py", "run.py", "loops/closed.py")}
    cell = registry.find_cell("b1m8.backwards", bench)
    assert cell.config["storage_dtype"] == "int8"
    assert "requests_total" in {m["name"] for m in cell.end_to_end}
    over = tiny("b1m8.backwards")
    over["config"]["storage_dtype"] = "int8"
    result, lines = harness.run("b1m8.backwards", 7, 1.0, False, time.perf_counter(),
                                device="cpu", bench_dir=bench, overrides=over,
                                log=lambda m: None)
    assert result["correct"], lines
    assert result["metrics"]["requests_total"]["value"] >= result["attempted"] > 0
    for p, text in before.items():
        assert open(os.path.join(ROOT, "benchmark", p)).read() == text


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        registry.find_cell("no.such.cell")
