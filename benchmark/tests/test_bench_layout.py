"""Every cell and metric of BENCHMARK.json resolves to its files by name,
and a new mix or metric is picked up from new files alone."""

import json
import shutil
from pathlib import Path

import pytest

from benchmark.harness import cell as cells

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_resolves(name):
    c = cells.resolve(name, ROOT)
    assert c.config["name"] == c.config_name
    assert c.driver().run
    ref = c.reference()
    assert ref.param_spec(c.settings)
    assert c.limits, "each cell states the limits of its comparison"
    for m in c.per_layer:
        assert hasattr(cells.metric_reader(m["name"], ROOT), "read")
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert {m["moves"] for m in c.per_layer} <= e2e


@pytest.mark.parametrize("metric", MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_exists(metric):
    assert (ROOT / "benchmark" / "metrics" / f"{metric['name']}.py").is_file()
    assert metric["moves"] in {m["name"] for m in MANIFEST["end_to_end"]}


def test_config_files_under_paths():
    for c in MANIFEST["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in MANIFEST["paths"]))
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["reduced"] == c["reduced"]


def test_new_files_are_picked_up(tmp_path):
    copy = tmp_path / "checkout"
    copy.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", copy / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    (copy / "benchmark" / "traffic" / "serve-small.json").write_text(json.dumps(
        dict(json.loads((copy / "benchmark" / "traffic" / "serve.json").read_text()),
             batch_size=64)))
    (copy / "benchmark" / "metrics" / "throwaway_ms.serve.py").write_text(
        "def read(record):\n    return 42.0 if record.get('mode') == 'serve' else None\n")
    (copy / "benchmark" / "limits" / "c8-resnet50.serve-small.json").write_text(
        (copy / "benchmark" / "limits" / "c8-resnet50.serve.json").read_text())
    manifest = json.loads((copy / "BENCHMARK.json").read_text())
    manifest["workloads"].append({"name": "c8-resnet50.serve-small", "config": "c8-resnet50",
                                  "traffic": "serve-small", "chips": 1, "why": "test"})
    manifest["per_layer"].append({"name": "throwaway_ms.serve", "unit": "ms", "better": "lower",
                                  "source": "program_span", "layer": "canonicalizer",
                                  "moves": "serve_img_per_s",
                                  "workloads": ["c8-resnet50.serve-small"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(manifest))
    c = cells.resolve("c8-resnet50.serve-small", copy)
    assert c.traffic["batch_size"] == 64
    assert "throwaway_ms.serve" in {m["name"] for m in c.per_layer}
    got = cells.read_metrics(c, {"mode": "serve"}, copy)
    assert got["throwaway_ms.serve"] == {"value": 42.0, "unit": "ms"}
    for p, body in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == body, f"{p} changed"
