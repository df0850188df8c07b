"""What a later cell brings as new files, with BENCHMARK.json entries,
runs without an edit to any file the harness has: a configuration, a
traffic mix and a metric of the existing command, and a command of its
own (commands/<command>.py)."""

import json
import os
import shutil

from benchmark import harness

from conftest import ROOT, tiny_spec


def _copy(bench, kind, *names):
    (bench / kind).mkdir(parents=True, exist_ok=True)
    for n in names:
        shutil.copy(os.path.join(ROOT, "benchmark", kind, n + ".py"),
                    bench / kind)


def _write(path, obj):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj) if not isinstance(obj, str) else obj)


def test_new_config_mix_and_metric_are_found_by_name(tmp_path):
    bench = tmp_path / "benchmark"
    _copy(bench, "commands", "usearch_global")
    _copy(bench, "generators", "otus", "subs")
    _copy(bench, "metrics", "queries_per_s", "setup_s")
    base = tiny_spec("gg99_v4.reads")
    _write(bench / "configs" / "tinydb.json",
           dict(base["config"], name="tinydb"))
    tr = dict(base["traffic"], query={"generator": "subs", "subs": [1, 2]})
    _write(bench / "traffic" / "closereads.json", tr)
    _write(bench / "metrics" / "rows_per_request.py",
           "def read(run):\n"
           "    reqs = [r for r in run['requests'] if r['keep']]\n"
           "    n = sum(r['rows'].count('\\n') for r in reqs)\n"
           "    return n / len(reqs)\n")
    entry = {"name": "tinydb.closereads", "config": "tinydb",
             "traffic": "closereads", "chips": 1, "why": "a test"}
    _write(tmp_path / "BENCHMARK.json", {
        "workloads": [entry],
        "end_to_end": [{"name": "queries_per_s", "unit": "queries/s"},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "rows_per_request", "unit": "rows",
                       "workloads": ["tinydb.closereads"]}]})
    spec = harness.cell_spec("tinydb.closereads", root=str(tmp_path))
    assert spec["config"]["name"] == "tinydb"
    out = harness.run_cell(spec, 12345, 0.5, True, device="cpu")
    res = out["result"]
    assert res["correct"] is True, res["checks"]
    # every read is within 2 substitutions of its target: one row each
    assert res["metrics"]["rows_per_request"]["value"] == \
        tr["per_request"]
    out = harness.run_cell(spec, 12345, 0.5, False, device="cpu")
    assert set(out["result"]["metrics"]) == {"queries_per_s", "setup_s"}


SORT_COMMAND = '''
import numpy as np
from benchmark.gen import rng_for


def make_data(spec, seed):
    t = spec["traffic"]
    return rng_for(seed, 1).integers(0, 1000, (t["pool"], t["per_request"]))


class Session:
    def __init__(self, spec, data, seed, work, device, trace, mark):
        import torch
        self.rows = torch.from_numpy(data).to(device)
        self.pool = len(data)
        mark("rows on the device")

    def request(self, r, rec):
        import torch
        out = torch.sort(self.rows[r]).values.cpu().numpy()
        rec["queries"] = len(out)
        if rec["keep"]:
            rec["out"] = out

    def counters(self):
        return {}

    def notes(self):
        return []

    def control(self):
        raise SystemExit("no control")


def judge(spec, data, records, seed, device):
    kept = [r for r in records if r["keep"]]
    wrong = sum(not np.array_equal(r["out"], np.sort(data[r["req"]]))
                for r in kept)
    return [("sorted_wrong", wrong, 0)]
'''


def test_new_command_is_found_by_name(tmp_path):
    bench = tmp_path / "benchmark"
    _copy(bench, "metrics", "queries_per_s", "setup_s")
    _write(bench / "commands" / "sort_rows.py", SORT_COMMAND)
    _write(bench / "configs" / "ints.json",
           {"name": "ints", "command": "sort_rows"})
    _write(bench / "traffic" / "rows.json",
           {"per_request": 100, "pool": 3, "warmup": 1,
            "check": {"requests": 2, "within": 2}})
    _write(tmp_path / "BENCHMARK.json", {
        "workloads": [{"name": "ints.rows", "config": "ints",
                       "traffic": "rows", "chips": 1, "why": "a test"}],
        "end_to_end": [{"name": "queries_per_s", "unit": "rows/s"},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": []})
    spec = harness.cell_spec("ints.rows", root=str(tmp_path))
    res = harness.run_cell(spec, 7, 0.3, False, device="cpu")["result"]
    assert res["correct"] is True
    assert res["checks"] == {"sorted_wrong": {"value": 0, "limit": 0}}
    assert set(res["metrics"]) == {"queries_per_s", "setup_s"}
