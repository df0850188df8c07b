"""One run of one cell: set-up, the measured window, the traced window's
reading, and the check against the plain reference.

A cell is an entry of BENCHMARK.json's "workloads": a configuration
(configs/<config>.json) under a traffic mix (traffic/<mix>.json).  The
configuration's "command" names its module, commands/<command>.py, which
knows the program's command and its reference:

- make_data(spec, seed): the inputs, made from the seed (gen.py);
- Session(spec, data, seed, work, device, trace, mark): set-up; its
  `pool` requests, request(r, rec) running request r (rec gets its
  "queries" and what the check and the metrics read), counters() (the
  program's), notes() (lines for standard error) and control() (puts the
  control of `correct` in the program's place);
- judge(spec, data, records, seed, device): [(name, value, limit)].

The cell's metrics are BENCHMARK.json's entries whose "workloads" name it
(or that have none), each read by metrics/<name>.py's read(run).  Nothing
here names a command, a configuration, a mix or a metric.

The window sends one request after another, one client, closed loop, for
the given seconds.  What a run writes besides the command's cache goes to
a directory under $TMPDIR that it empties first and removes at the end;
tempfile points there, so that the program's learned gate file is fresh
each run.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

from . import gen, trace

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# top-level module names that no run may load
BLOCKED = ("jax", "jaxlib", "flax", "usearch12_tpu")


class NoCard(RuntimeError):
    """The run's device is missing."""


class Blocked(RuntimeError):
    """A module that no run may load was loaded."""


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def cell_spec(name: str, root: str = ROOT) -> dict:
    """The cell's entry, configuration, traffic and metric entries, found
    by name from root/BENCHMARK.json."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    base = os.path.join(root, "benchmark")
    return {
        "name": name, "chips": w["chips"], "bench_dir": base,
        "config": load_json(os.path.join(base, "configs",
                                         w["config"] + ".json")),
        "traffic": load_json(os.path.join(base, "traffic",
                                          w["traffic"] + ".json")),
        "end_to_end": [m for m in bench["end_to_end"]
                       if name in m.get("workloads", [name])],
        "per_layer": [m for m in bench["per_layer"]
                      if name in m.get("workloads", [name])],
    }


def blocked_modules():
    """Loaded modules whose top-level name is blocked, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BLOCKED))


def prepare_dirs() -> str:
    """Point the build caches at fixed directories inside the checkout and
    tempfile at an emptied work directory under $TMPDIR; returns it."""
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    base = os.environ.get("TMPDIR") or tempfile.gettempdir()
    work = os.path.join(base, "usearch12_tpu_torch_bench")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "tmp"))
    tempfile.tempdir = os.path.join(work, "tmp")
    return work


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(spec: dict, seed: int, seconds: float, trace_on: bool,
             device=None, t0=None, control: bool = False) -> dict:
    """One run; returns {"result": the result line's object, "checks":
    [(name, value, limit)], "log": [lines for standard error]}.

    device: None for the CUDA card (raises NoCard without one), or a
    torch device.  control: put the command's control in the program's
    place after the warm-up."""
    t0 = time.perf_counter() if t0 is None else t0
    saved = tempfile.tempdir
    work = prepare_dirs()
    try:
        return _run(spec, seed, seconds, trace_on, device, t0, control,
                    work)
    finally:
        tempfile.tempdir = saved
        shutil.rmtree(work, ignore_errors=True)


def _run(spec, seed, seconds, trace_on, device, t0, control, work):
    import torch

    import usearch12_tpu_torch  # noqa: F401 - the system under test
    chips = spec["chips"]
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            raise NoCard(f"the cell needs {chips} CUDA card(s); "
                         f"{torch.cuda.device_count()} present")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"
    drv = gen.plugin(spec["bench_dir"], "commands",
                     spec["config"]["command"])
    data = drv.make_data(spec, seed)
    if on_card:
        # the CUDA context, which a resident server has, before the load
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
    run = _window(drv, spec, data, seed, seconds, trace_on, device, t0,
                  control, work)
    # the program's state is gone with _window's frame; the reference
    # runs after it
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    found = blocked_modules()
    if found:
        raise Blocked("modules loaded that no run may load: "
                      + ", ".join(found))
    metrics = {}
    for m in spec["per_layer"] if trace_on else spec["end_to_end"]:
        v = gen.plugin(spec["bench_dir"], "metrics", m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    records = run["requests"]
    lat = sorted(r["latency_s"] for r in records)
    log = [f"window: {len(records)} requests, {queries_of(run)} queries, "
           f"{run['window_s']:.3f} s; request latency samples "
           f"{len(records)}, min {lat[0]:.4f} median "
           f"{statistics.median(lat):.4f} max {lat[-1]:.4f} s",
           f"card: {power_limit() if on_card else device}",
           "set-up, seconds from the process's start: " + ", ".join(
               f"{k} {t}" for k, t in run["setup_marks"])] + run["notes"]
    failed = sum("error" in r for r in records)
    log += [r["error"] for r in records if "error" in r]
    checks = drv.judge(spec, data, records, seed, device)
    correct = failed == 0 and all(v <= lim for _, v, lim in checks)
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card
           else device.type, "count": chips,
           "memory_peak_bytes": run["memory_peak_bytes"]}
    result = {"correct": bool(correct), "attempted": len(records),
              "failed": failed, "metrics": metrics, "device": dev}
    tr = run["trace"]
    if tr is not None:
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return {"result": result, "checks": checks, "log": log}


def _window(drv, spec, data, seed, seconds, trace_on, device, t0, control,
            work) -> dict:
    """Set-up and the window; returns plain data, none of the program's
    objects."""
    import torch

    on_card = device.type == "cuda"
    traffic = spec["traffic"]
    marks = [("start", time.perf_counter())]

    def mark(name):
        marks.append((name, time.perf_counter()))
    sess = drv.Session(spec, data, seed, work, device, trace_on, mark)

    def one(r: int, keep: bool) -> dict:
        rec = {"req": r, "keep": keep}
        t = time.perf_counter()
        try:
            with trace.span(trace_on, trace.REQUEST):
                sess.request(r, rec)
        except Exception:  # noqa: BLE001 - a failed request is counted
            rec["error"] = traceback.format_exc()
        rec["latency_s"] = time.perf_counter() - t
        return rec

    pool = sess.pool
    # the window's requests whose answers are judged, drawn from the seed
    # before the window; the others keep only their timings
    chk = traffic["check"]
    kept = {int(i) for i in gen.rng_for(seed, 7).choice(
        chk["within"], chk["requests"], replace=False)}
    for r in range(min(traffic["warmup"], pool)):
        rec = one(r, False)
        if "error" in rec:
            raise RuntimeError("a warm-up request failed:\n" + rec["error"])
    if control:
        sess.control()
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    mark("warm-up done")
    gc.collect()
    stats0 = sess.counters()
    setup_s = time.perf_counter() - t0
    prof = None
    if trace_on:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else []))
        prof.start()
    records = []
    with trace.span(trace_on, trace.WINDOW):
        t_start = time.perf_counter()
        deadline = t_start + seconds
        while time.perf_counter() < deadline:
            n = len(records)
            records.append(one(n % pool, n in kept))
        if on_card:
            torch.cuda.synchronize(device)
        t_end = time.perf_counter()
    if prof is not None:
        prof.stop()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    return {"cell": spec["name"], "window_s": t_end - t_start,
            "setup_s": setup_s, "requests": records,
            "trace": None if prof is None else trace.summarize(prof),
            "config": spec["config"], "traffic": traffic,
            "memory_peak_bytes": int(peak), "notes": sess.notes(),
            "setup_marks": [(k, round(t - t0, 3)) for k, t in marks],
            "counters": {k: v - stats0.get(k, 0)
                         for k, v in sess.counters().items()}}


def queries_of(run) -> int:
    return sum(r["queries"] for r in run["requests"])
