"""The result line: its keys, the metrics each cell reports, and the
checks last."""

import json

import pytest

from benchmark import harness

from conftest import CELLS

E2E = {"queries_per_s", "request_p95_s", "setup_s"}
LAYER = {"engine_host_ms_per_query", "rank_ms_per_kq", "device_idle_share"}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_line_keys(run_tiny, cell, trace):
    out = run_tiny(cell, trace=trace)
    res = out["result"]
    line = json.loads(json.dumps(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    assert set(line["metrics"]) == (LAYER if trace else E2E)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] >= 0
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        b = line["breakdown"]
        assert set(b) == {"device_ops", "idle_gaps"}
        assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    else:
        assert "breakdown" not in line
    assert set(line["checks"]) == {"rows_vs_paths_wrong", "rank_lists_wrong",
                                   "rows_wrong"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_cell_spec_joins_benchmark_json():
    spec = harness.cell_spec("gg99_v4.novel")
    assert spec["config"]["name"] == "gg99_v4"
    assert spec["config"]["command"] == "usearch_global"
    assert spec["traffic"]["query"] == {"generator": "subs",
                                        "subs": [20, 30]}
    assert {m["name"] for m in spec["end_to_end"]} == E2E
    assert {m["name"] for m in spec["per_layer"]} == LAYER


def test_blocked_modules_compares_top_level_names_whole(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "usearch12_tpu_torchx",
                        types.ModuleType("usearch12_tpu_torchx"))
    assert harness.blocked_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla",
                        types.ModuleType("jaxlib.xla"))
    assert harness.blocked_modules() == ["jaxlib"]
