"""The harness finds cells, configurations, mixes and metrics by name, and
a cell made of new files alone runs with no edit of the harness."""

import json
from pathlib import Path

from conftest import REPO, run_cell

from gpu_bench import run


def test_every_name_in_the_benchmark_has_its_file():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        assert (REPO / c["file"]).exists()
        assert json.loads((REPO / c["file"]).read_text())["name"] == c["name"]
    names = {c["name"] for c in spec["configs"]}
    for w in spec["workloads"]:
        assert w["config"] in names
        mix = run.load(REPO, "traffic", w["traffic"])
        assert mix["kind"] in ("serve", "train")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert hasattr(run.reader(REPO, m["name"]), "read"), m["name"]


def test_every_cell_reports_setup_an_end_to_end_metric_and_a_layer():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        e2e = [m["name"] for m in run.cell_metrics(spec, w["name"], False)]
        layer = run.cell_metrics(spec, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer, w["name"]
        for m in layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_a_cell_of_new_files_runs_unedited(tiny_root: Path):
    """The temporary checkout's cells, configurations and mixes are all new
    files; a new per-layer metric is one more file and appears in the
    traced line."""
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    (tiny_root / "gpu_bench" / "metrics" / "steps_in_window.serve.py"
     ).write_text('def read(rec):\n    return float(len(rec["steps"]))\n')
    spec["per_layer"].append({
        "name": "steps_in_window.serve", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "engine",
        "moves": "serve_tokens_per_s", "workloads": ["tiny-murs"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    try:
        out = run_cell(tiny_root, "tiny-murs", trace=True)
    finally:
        spec["per_layer"].pop()
        (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert out["metrics"]["steps_in_window.serve"]["value"] > 0
    assert {"tick_ms.serve", "decode_batch.serve",
            "suspensions_per_s.serve"} <= set(out["metrics"])
    assert list(out)[-1] == "compared"
