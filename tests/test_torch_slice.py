"""usearch_global end to end through usearch12_tpu_torch on the CPU (the
kernels' plain PyTorch versions) against the JAX package's host C path,
on a scaled-down copy of the long-contig device workload (bench.py's
_gen_longseq: conserved blocks between divergent segments, so every
query chains with every target and the holes go to the device path)."""

import json
import os

import numpy as np
import pytest

import usearch12_tpu.cli as jax_cli
import usearch12_tpu_torch.cli as port_cli

COMMON = ["-id", "0.5", "-strand", "plus", "-band", "120",
          "-maxaccepts", "64", "-maxrejects", "64", "-quiet"]


def gen_contigs(qf, tf, n=5, n_var=4, var=260, blk=150, seed=21):
    rng = np.random.default_rng(seed)
    conv = np.frombuffer(b"ACGT", np.uint8)
    blocks = [conv[rng.integers(0, 4, blk)] for _ in range(n_var + 1)]

    def assemble(segs):
        parts = []
        for k in range(n_var):
            parts += [blocks[k], segs[k]]
        parts.append(blocks[n_var])
        return np.concatenate(parts).tobytes().decode()

    targets = [[conv[rng.integers(0, 4, var)] for _ in range(n_var)]
               for _ in range(n)]
    with open(tf, "w") as f:
        for i, segs in enumerate(targets):
            f.write(f">lt{i}\n{assemble(segs)}\n")
    with open(qf, "w") as f:
        for i in range(n):
            segs = []
            for s in targets[i]:
                t = s.copy()
                flip = rng.random(var) < 0.5
                t[flip] = conv[rng.integers(0, 4, int(flip.sum()))]
                # an indel shifts the hole off the main diagonal
                cut = int(rng.integers(0, var))
                segs.append(np.delete(t, cut) if i % 2 else t)
            f.write(f">lq{i}\n{assemble(segs)}\n")


@pytest.fixture(scope="module")
def contigs(tmp_path_factory):
    d = tmp_path_factory.mktemp("contigs")
    qf, tf = str(d / "q.fa"), str(d / "t.fa")
    gen_contigs(qf, tf)
    outs = ["-blast6out", "-uc", "-matched", "-notmatched"]
    ref = [str(d / f"ref{k}") for k in range(len(outs))]
    assert jax_cli.main(["-usearch_global", qf, "-db", tf] + COMMON
                        + ["-no_engine_device"]
                        + [x for pair in zip(outs, ref) for x in pair]) == 0
    return d, qf, tf, [open(r, "rb").read() for r in ref]


def _run_port(d, qf, tf, outs, monkeypatch):
    stats = d / "stats.jsonl"
    monkeypatch.setenv("USEARCH_DEVICE_STATS", str(stats))
    assert port_cli.main(["-usearch_global", qf, "-db", tf] + COMMON
                         + ["-dev_batch_cells", "1"] + outs,
                         device="cpu") == 0
    return json.loads(stats.read_text().splitlines()[-1])


def test_blast6_equals_host_path(contigs, monkeypatch):
    d, qf, tf, ref = contigs
    out = d / "port.b6"
    ds = _run_port(d, qf, tf, ["-blast6out", str(out)], monkeypatch)
    assert ref[0].count(b"\n") == 25
    assert out.read_bytes() == ref[0]
    assert ds["device"] and ds["device_cells"] > 0
    assert ds["host_cells"] == 0 and ds["dispatches"] > 0


def test_all_outputs_equal_host_path(contigs, monkeypatch):
    """-blast6out, -uc, -matched and -notmatched together (the per-query
    emit path rather than the packed blast6 emitter)."""
    d, qf, tf, ref = contigs
    outs = ["-blast6out", "-uc", "-matched", "-notmatched"]
    mine = [d / f"port{k}" for k in range(len(outs))]
    ds = _run_port(d, qf, tf,
                   [str(x) for pair in zip(outs, mine) for x in pair],
                   monkeypatch)
    assert [m.read_bytes() for m in mine] == ref
    assert ds["device_cells"] > 0


def test_cli_needs_a_card_unless_cpu_is_passed(contigs, monkeypatch):
    _, qf, tf, _ = contigs
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_cli.main(["-usearch_global", qf, "-db", tf] + COMMON
                      + ["-blast6out", "/dev/null"])


@pytest.mark.parametrize("cmd", ["usearch_global", "cluster_fast"])
def test_xprof_writes_a_trace(contigs, monkeypatch, cmd):
    """-xprof DIR writes a Chrome trace of the command (torch.profiler)
    into DIR, and every output byte is that of the run without it: the
    engine path (the kernels' plain versions) and a host command."""
    import json
    d, qf, tf, ref = contigs
    if cmd == "usearch_global":
        args = ["-usearch_global", qf, "-db", tf] + COMMON + [
            "-dev_batch_cells", "1", "-blast6out"]
    else:
        args = ["-cluster_fast", tf, "-id", "0.5", "-quiet", "-uc"]
    outs = {}
    for tag, extra in (("plain", []), ("xprof", ["-xprof", str(d / cmd)])):
        out = d / f"{cmd}_{tag}.out"
        assert port_cli.main(args + [str(out)] + extra, device="cpu") == 0
        outs[tag] = out.read_bytes()
    assert outs["xprof"] == outs["plain"] and outs["plain"]
    if cmd == "usearch_global":
        assert outs["plain"] == ref[0]
    traces = list((d / cmd).iterdir())
    assert len(traces) == 1 and traces[0].name.endswith(".trace.json")
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)


def test_holes_wider_than_the_kernel_run_on_host(contigs, monkeypatch):
    """Holes whose band exceeds BW_DEV_MAX take the host C kernel within
    the same round; the queries with an indel have bands of 242 here."""
    from usearch12_tpu_torch.engine import BatchEngine
    monkeypatch.setattr(BatchEngine, "BW_DEV_MAX", 241)
    d, qf, tf, ref = contigs
    out = d / "port_split.b6"
    ds = _run_port(d, qf, tf, ["-blast6out", str(out)], monkeypatch)
    assert out.read_bytes() == ref[0]
    assert ds["device_cells"] > 0 and ds["host_cells"] > 0


def test_no_engine_device_keeps_every_hole_on_host(contigs, monkeypatch):
    """-no_engine_device: every hole runs in the host C kernel, as in the
    JAX package, and neither kernel is launched."""
    from usearch12_tpu_torch.ops import wavefront_nw as wnw
    from usearch12_tpu_torch.ops import wavefront_trace as wtr
    d, qf, tf, ref = contigs
    out = d / "port_host.b6"
    n_fwd, n_trace = wnw.wavefront_fwd.launches, wtr.wavefront_trace.launches
    ds = _run_port(d, qf, tf, ["-blast6out", str(out), "-no_engine_device"],
                   monkeypatch)
    assert out.read_bytes() == ref[0]
    assert ds["device_cells"] == 0 and ds["host_cells"] > 0
    assert ds["dispatches"] == 0
    assert (wnw.wavefront_fwd.launches, wtr.wavefront_trace.launches) == \
        (n_fwd, n_trace)


def test_perf_model_keeps_its_own_file(tmp_path, monkeypatch):
    """The port's cost model starts from its card constants and never
    reads the JAX package's cache file, whatever that file holds."""
    from usearch12_tpu.engine import batch as jax_batch
    from usearch12_tpu_torch.engine import batch as port_batch
    assert port_batch.DevicePerfModel.CACHE != jax_batch.DevicePerfModel.CACHE
    assert os.path.basename(port_batch.DevicePerfModel.CACHE) != \
        os.path.basename(jax_batch.DevicePerfModel.CACHE)
    monkeypatch.setattr(jax_batch.DevicePerfModel, "CACHE",
                        str(tmp_path / "jax.json"))
    monkeypatch.setattr(port_batch.DevicePerfModel, "CACHE",
                        str(tmp_path / "port.json"))
    for platform in ("cuda", "tpu", "auto"):
        jm = jax_batch.DevicePerfModel(platform)
        jm.rtt, jm.up_bw, jm.warm_tax, jm.n_obs = 9.0, 1.0, 99.0, 5
        jm.save()
    pm = port_batch.DevicePerfModel("cuda")
    assert (pm.rtt, pm.up_bw, pm.dn_bw, pm.dev_rate, pm.warm_tax,
            pm.n_obs) == (port_batch.COLD_RTT, port_batch.COLD_UP_BW,
                          port_batch.COLD_DN_BW, port_batch.COLD_DEV_RATE,
                          port_batch.COLD_WARM_TAX, 0)
    pm.rtt, pm.n_obs = 0.5, 3
    pm.save()
    again = port_batch.DevicePerfModel("cuda")
    assert (again.rtt, again.n_obs) == (0.5, 3)
    assert json.loads((tmp_path / "port.json").read_text()).keys() == \
        {"cuda/v2"}


def test_engine_band_limit_is_the_kernels():
    from usearch12_tpu_torch.engine import BatchEngine
    from usearch12_tpu_torch.ops.wavefront_nw import BW_MAX
    assert BatchEngine.BW_DEV_MAX == BW_MAX
