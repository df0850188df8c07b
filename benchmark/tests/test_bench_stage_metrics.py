"""The per-layer metrics that read the program's own spans and counters:
each cell's traced run on the CPU reads every one, and the parts never
exceed the wholes the harness measures around them."""

import pytest

from conftest import CELLS

STAGE_METRICS = ("rank_host_ms_per_kq", "rank_device_ms_per_kq",
                 "chain_ms_per_query", "replay_ms_per_query",
                 "emit_ms_per_query", "pairs_per_query")
# the per-layer metrics a traced line carries: the harness's own three and
# the six above, no more and no fewer
LAYER = {"engine_host_ms_per_query", "rank_ms_per_kq",
         "device_idle_share", *STAGE_METRICS}


@pytest.mark.parametrize("cell", CELLS)
def test_stage_metrics_read_and_fit_their_wholes(run_tiny, cell):
    m = {k: v["value"] for k, v in
         run_tiny(cell, trace=True)["result"]["metrics"].items()}
    assert set(m) == LAYER
    for k in STAGE_METRICS:
        assert m[k] > 0, k
    # the ranker's host and device halves lie inside the override's wall
    # time; chain, replay and emit inside a request's time outside it
    assert m["rank_host_ms_per_kq"] + m["rank_device_ms_per_kq"] \
        <= m["rank_ms_per_kq"]
    assert m["chain_ms_per_query"] + m["replay_ms_per_query"] \
        + m["emit_ms_per_query"] <= m["engine_host_ms_per_query"]
    # every query is chained against at least its first candidate
    assert m["pairs_per_query"] >= 1


def test_stage_metrics_are_absent_without_the_counters():
    """A program without the spans (an older one) gives no number and no
    error."""
    from benchmark import gen, harness
    spec = harness.cell_spec(CELLS[0])
    run = {"counters": {"dispatches": 0, "rank_device_jobs": 512}}
    for k in STAGE_METRICS:
        assert gen.plugin(spec["bench_dir"], "metrics", k).read(run) is None


def test_benchmark_json_lists_the_stage_metrics_on_both_cells():
    from benchmark import harness
    for cell in CELLS:
        spec = harness.cell_spec(cell)
        assert {m["name"] for m in spec["per_layer"]} == LAYER
