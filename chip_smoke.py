#!/usr/bin/env python3
"""Smoke run of usearch12_tpu_torch on one CUDA card.

    python3 chip_smoke.py          # from the root of a checkout
    python3 chip_smoke.py --against DIR   # also time DIR's kernels

Phases, each printing a line, any failure exits non-zero:
  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: the CUDA kernels of usearch12_tpu_torch/csrc with nvcc;
  3. kernels: the hole DP kernels (wavefront_fwd, wavefront_trace, the
     latter with both its kernels, one warp a pair and one thread a pair)
     against their plain PyTorch versions on the card, bit for bit, at
     (a) 65,536 pairs of 250 nt (band radius 16), (b) 512 pairs of 3 kb
     (band radius 120, non-dyadic gap penalties), (c) 64 pairs of 1.5 kb
     (radius 300, band 601) and (d) 16 pairs of about 4 kb at radius 1015
     with la - lb = 16 in turns (band 2047, the widest the kernels take),
     each with a subsample of up to 256 pairs against the host C kernel
     nw_band; then (e) and (f), launches of 600-nt pairs (radius 60) at
     half and twice the load where the wrapper changes from the warp
     kernel to the thread kernel (WARP_MAX_LOAD), each kernel timed;
  4. oracle: the row-sweep kernels of the device oracle BandedNWDevice
     (banded_nw_fwd, banded_nw_chase) bit for bit against their plain
     versions at the 65,536 pairs of 250 nt (radius 16) and at 2,048
     pairs of 1 kb (radius 62, band 125, non-dyadic gap penalties), each
     timed through its wrapper and alone (the chase beside the floor of
     sweeping its pairs' traceback rows by 32-byte sectors); then
     BandedNWDevice.align_device on all
     65,536 pairs of 250 nt and on the 2,048 pairs of 1 kb, whose scores
     and paths must equal those of TorchWaveAligner.align (the hole DP
     kernels of phase 3) on every pair;
  5. slice: usearch_global through the port's command line
     (usearch12_tpu_torch.cli.main, in this process so that the kernels'
     launch counts can be read) on the long-contig workload (32 queries x
     32 targets of 24,150 nt), whose blast6 bytes must equal those of
     the same command line with -no_engine_device (the host C path, a
     process of its own), with 5,532,965,001 device cells; then the
     run's launches replayed (their inputs as recorded) to time
     wavefront_fwd and wavefront_trace on them, each beside its bound,
     and to hold both wavefront_trace kernels bit-equal to the plain
     version on every launch;
  6. sintax kernels: sintax_pick_hist and sintax_boot_count_select (the
     boot counts and the winner in one fused kernel) bit for bit against
     their plain versions on one full chunk of the SINTAX workload (128
     jobs x 100 boots x 256 word slots against the 60,000-target
     incidence), at m = 32, at m = 200 (> 127, float16) and at m = 0
     (every target ties); the histogram timed through its wrapper and
     alone beside torch.bincount over the same picks (whose counts must
     equal it), the fused kernel beside the route it replaced (the
     gather, mask and cast of the incidence rows, and the bmm);
  7. sintax: the JAX package's SINTAX device workload (bench.py's
     _gen_sintax_big, seed 17, not cut: 60,000 targets of 248 nt, 1,500
     queries, -strand both -randseed 1) through the port's command line
     with -sintax_device, in this process, whose -tabbedout bytes must
     equal those of the same command line with -no_sintax_device (the
     host path, a process of its own); then the auto gate's measurement
     (the port's command line as a fresh process, host and card, at
     60,000 and 90,000 targets, with the start-up costs of such a
     process) and one profiled card run;
  8. perf model: the engine cost model's cold-start constants on this
     card (dispatch cost, copy rates, the slice's DP rate, the first
     dispatch's excess in a fresh process);
  9. rank: the JAX package's rank_device workload (bench.py's _gen_bigdb,
     seed 13, not cut: 220,000 targets of 250 nt from 2,000 templates,
     2,000 queries, -id 0.9 -strand plus), indexed once into a .udb with
     the port's -makeudb_usearch; usearch_global through the port's
     command line with -device_rank (the CSR ranker, ops/csr_rank.py, in
     this process) against -no_device_rank (the host ranker, a process of
     its own) and both in this process, at the default -big
     (UDBSearchBig) and at -big 300000 (SetTopBump): blast6 bytes equal
     and rank_device_jobs 2,000, or the run fails; the ranker's stages on
     one chunk (hit stream, counts, ranking and top-K), each beside its
     bound, torch.bincount alone, and the window's wall and device time
     (torch.profiler); both rankers as fresh processes in turns host,
     card, card, host, for the automatic gate;
 10. mesh: (a) cluster_mt -mesh 1 (parallel/cluster_batch.py, the U
     counts on the card) through the port's command line in this process
     on bench.py's amplicon reads cut to 30,000 (400 templates of 250 nt,
     seed 11), -id 0.97, against the host cluster_mt: -uc and -centroids
     bytes equal, or the run fails; the centroids, the incidence's
     capacity and bytes, windows, flushes and the count's device time; the
     counter at the final centroid set, its product alone in the
     target-major (TN) layout and on a row-major (NN) copy; (b)
     usearch_global -mesh 1 (parallel/mesh_search.py) on phase 9's
     workload at -big 300000 (the sharded product) and at the default
     -big (UDBSearchBig on the CSR ranker): blast6 equal to phase 9's
     host ranker's; MeshRanker on a 1x4 mesh whose shards all live on the
     card against the 1x1 mesh, equal on every job; the stages of one
     chunk of rows beside their bounds and the window's profile; (c) two
     processes on the card through multihost_search (gloo), the spliced
     blast6 equal to (b)'s at -big 300000; (d) -xprof on 200 queries,
     whose trace must hold CUDA kernel events.
Every kernel's time comes with its bound: the larger of the bytes it
must move over 3.35 TB/s and its operations over the card's peak for
their type (float32 67 TFLOP/s; the tensor cores' int8 1,979 TOP/s and
float16 989 TFLOP/s).

With --against DIR, DIR being another checkout of the repository (for
example a parent commit unpacked with git archive), its csrc/
wavefront_fwd.cu, wavefront_trace.cu, banded_nw.cu and sintax_boot.cu
are built with this tree's nvcc flags, each into a library of its own.
Its wavefront_fwd is timed against this tree's at (a), (b), (c), (d) and
on the slice's launches, bit-equal, in turns other, this, this, other
(this tree's kernel also with the pairs in launch order instead of
longest first); its wavefront_trace the same way; its banded_nw_fwd and
banded_nw_chase, kernels alone, at phase 4's two shapes (its traceback
mapped onto this tree's layout where they differ); and its
sintax_pick_hist, alone, on phase 6's chunks.  DIR's
wavefront_fwd_launch must take this tree's arguments (with the pair
order), and its wavefront_trace_launch those of the interface version its
wavefront_trace_interface() returns, or those of the one-thread-a-pair
entry point where it exports none; its banded_nw_fwd_launch takes this
tree's arguments, and writes the traceback in the layout of the version
its banded_nw_interface() returns (1, pair-minor, where it exports none);
its banded_nw_chase_launch takes this tree's arguments, its ops filled
with OP_PAD beforehand.
Each phase prints its seconds.  The line before the last is the kernel
summary as JSON, the last line {"ok": true, "device": {...}}.  In the
summary `ms` is each kernel's time through its wrapper; `kernel_ms` the
kernel alone, its outputs allocated beforehand, where this run times it
(banded_nw_fwd, banded_nw_chase and sintax_pick_hist), else null.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
COMMON = ["-id", "0.5", "-strand", "plus", "-band", "120",
          "-maxaccepts", "64", "-maxrejects", "64", "-quiet"]


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def gen_longseq(qf, tf, n=32, seed=21):
    """The long-sequence device workload (recipe of bench.py's
    _gen_longseq): 24,150-nt contigs of 13 conserved 150-nt blocks and 12
    divergent 1,850-nt segments; queries re-roll 50% of each segment."""
    import numpy as np
    rng = np.random.default_rng(seed)
    conv = np.frombuffer(b"ACGT", np.uint8)
    n_block, blk, n_var, var = 13, 150, 12, 1850
    blocks = [conv[rng.integers(0, 4, blk)] for _ in range(n_block)]

    def assemble(segs):
        parts = []
        for k in range(n_var):
            parts += [blocks[k], segs[k]]
        parts.append(blocks[n_var])
        return np.concatenate(parts)

    targets = []
    with open(tf, "w") as f:
        for i in range(n):
            segs = [conv[rng.integers(0, 4, var)] for _ in range(n_var)]
            targets.append(segs)
            f.write(f">lt{i}\n{assemble(segs).tobytes().decode()}\n")
    with open(qf, "w") as f:
        for i in range(n):
            segs = []
            for s in targets[i % len(targets)]:
                t = s.copy()
                flip = rng.random(var) < 0.5
                t[flip] = conv[rng.integers(0, 4, int(flip.sum()))]
                segs.append(t)
            f.write(f">lq{i}\n{assemble(segs).tobytes().decode()}\n")


def gen_sintax(dbf, qf, n_targets=60000, n_queries=1500, seed=17):
    """The SINTAX device workload (recipe of bench.py's _gen_sintax_big):
    248-nt targets with taxonomy d:D{i%5},p:P{i%40},g:G{i%400}; each query
    is target (13 i) % n_targets with 8 substitutions."""
    import numpy as np
    rng = np.random.default_rng(seed)
    conv = np.frombuffer(b"ACGT", np.uint8)
    seqs = []
    with open(dbf, "w") as f:
        for i in range(n_targets):
            s = conv[rng.integers(0, 4, 248)]
            seqs.append(s)
            f.write(f">r{i};tax=d:D{i % 5},p:P{i % 40},g:G{i % 400};\n"
                    f"{s.tobytes().decode()}\n")
    with open(qf, "w") as f:
        for i in range(n_queries):
            s = seqs[(i * 13) % len(seqs)].copy()
            pos = rng.integers(0, len(s), 8)
            s[pos] = conv[rng.integers(0, 4, 8)]
            f.write(f">q{i}\n{s.tobytes().decode()}\n")


def gen_bigdb(dbf, qf, n_targets=220000, n_queries=2000, seed=13):
    """The ranking workload (recipe of bench.py's _gen_bigdb): 250-nt
    targets, each one of 2,000 templates with 8 substitutions; each query
    the template q % 2000 with 12."""
    import numpy as np
    rng = np.random.default_rng(seed)
    conv = np.frombuffer(b"ACGT", np.uint8)
    tpls = [conv[rng.integers(0, 4, 250)] for _ in range(2000)]
    with open(dbf, "w") as f:
        for t in range(n_targets):
            s = tpls[t % 2000].copy()
            s[rng.integers(0, 250, 8)] = conv[rng.integers(0, 4, 8)]
            f.write(f">t{t}\n{s.tobytes().decode()}\n")
    with open(qf, "w") as f:
        for q in range(n_queries):
            s = tpls[q % 2000].copy()
            s[rng.integers(0, 250, 12)] = conv[rng.integers(0, 4, 12)]
            f.write(f">q{q}\n{s.tobytes().decode()}\n")


def kernel_pairs(rng, n, length, sub_rate=0.1, indel=8):
    """n (a, b) pairs: b is a with ~sub_rate substitutions and a few
    indels, so lengths differ by up to `indel`."""
    import numpy as np
    conv = np.frombuffer(b"ACGT", np.uint8)
    a = rng.integers(0, 4, (n, length))
    b = a.copy()
    flip = rng.random((n, length)) < sub_rate
    b[flip] = rng.integers(0, 4, int(flip.sum()))
    pairs = []
    for k in range(n):
        d = int(rng.integers(-indel, indel + 1))
        bk = b[k]
        if d > 0:
            pos = np.sort(rng.integers(0, length, d))
            bk = np.insert(bk, pos, rng.integers(0, 4, d))
        elif d < 0:
            bk = np.delete(bk, rng.choice(length, -d, replace=False))
        pairs.append((conv[a[k]], conv[bk]))
    return pairs


def bit_equal(x, y):
    import torch
    if x.dtype == torch.float32:
        x, y = x.view(torch.int32), y.view(torch.int32)
    return x.shape == y.shape and bool(torch.equal(x, y))


def balanced_indel_pairs(rng, n, length, max_indel=40, sub_rate=0.1):
    """n (a, b) pairs of equal length: b is a with ~sub_rate
    substitutions, k single-letter deletions and k single-letter
    insertions, 2k <= max_indel."""
    import numpy as np
    conv = np.frombuffer(b"ACGT", np.uint8)
    a = rng.integers(0, 4, (n, length))
    b = a.copy()
    flip = rng.random((n, length)) < sub_rate
    b[flip] = rng.integers(0, 4, int(flip.sum()))
    pairs = []
    for k in range(n):
        m = int(rng.integers(0, max_indel // 2 + 1))
        bk = np.delete(b[k], rng.choice(length, m, replace=False))
        bk = np.insert(bk, np.sort(rng.integers(0, length - m + 1, m)),
                       rng.integers(0, 4, m))
        pairs.append((conv[a[k]], conv[bk]))
    return pairs


def widest_band_pairs(rng, n, length):
    """n (a, b) pairs of about `length`: b is a with 10% substitutions,
    16 letters longer or shorter in turns, so that radius 1015 gives the
    widest band the kernels take (2047 = BW_MAX) with la != lb."""
    import numpy as np
    conv = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for k in range(n):
        la = length + int(rng.integers(-200, 201))
        a = rng.integers(0, 4, la)
        b = np.resize(a, la + (16 if k % 2 else -16))
        flip = rng.random(len(b)) < 0.1
        b[flip] = rng.integers(0, 4, int(flip.sum()))
        pairs.append((conv[a], conv[b]))
    return pairs


def cuda_ms(fn, reps, warm=True):
    """Mean device time of fn() over reps runs, after one warm-up unless
    warm is False."""
    import torch
    if warm:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


# published peaks of one H100 SXM (NVIDIA's H100 data sheet, dense rates
# without sparsity): HBM bytes/s, float32 operations/s outside the tensor
# cores, and the tensor cores' int8 and float16 operations/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_INT8 = 1979e12
PEAK_F16 = 989e12


def bound(nbytes, ops, peak_ops=PEAK_F32):
    """(bound_ms, bound_by): the least time for `nbytes` moved and `ops`
    operations at the published peaks (float32 unless peak_ops says)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def clocks():
    """The card's SM clock and power draw now, from nvidia-smi."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip()


def nbytes_of(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


def band_cells(la, lb, dlo, bw):
    """Cells of each pair inside its band and the la x lb rectangle."""
    import numpy as np
    la, lb, dlo, bw = (np.asarray(x, np.int64)[:, None]
                       for x in (la, lb, dlo, bw))
    k = dlo + np.arange(int(bw.max()))[None, :] - la    # j - i of a diagonal
    n = np.minimum(la, lb - k) - np.maximum(0, -k)
    return (np.where(np.arange(n.shape[1])[None, :] < bw, n, 0)
            .clip(min=0).sum(1))


# float32 operations of one DP cell: 5 adds and 4 compares
DP_OPS = 9


def fwd_bound(w, out):
    """bound_ms, bound_by of wavefront_fwd on launch inputs w."""
    cells = int(band_cells(*(x.cpu().numpy() for x in w[2:6])).sum())
    return bound(nbytes_of(*w[:7], *out), DP_OPS * cells)


def trace_bound(args, out):
    """bound_ms, bound_by of wavefront_trace: the traceback bytes its
    paths touch (one per step), the last M rows and the small inputs and
    outputs; 3 operations per final-row column, 4 per path step."""
    tb, tb_off, mlast, dlb, la, lb, dlo, bw, gp = args
    steps = int(out[2].sum())
    nbytes = steps + nbytes_of(tb_off, mlast, dlb, la, lb, dlo, bw, gp, *out)
    return bound(nbytes, 3 * int(lb.sum()) + 4 * steps)


def check_kernels(tag, pairs, radius, ap, dev, reps, other=None):
    """Kernels against plain versions on `pairs`, and wavefront_fwd
    against `other`'s (compare_fwd) where given; returns a dict of times,
    bounds and errors."""
    import numpy as np
    from usearch12_tpu_torch.ops import wavefront_nw as wnw
    from usearch12_tpu_torch.ops import wavefront_trace as wtr
    geo = wnw.pair_geometry(pairs, radius)
    w = wnw.pack_launch(pairs, *geo, dev)
    gp = wnw.gap_params(ap).to(dev)
    match, mismatch = wnw.match_mismatch(ap)
    fwd_ms, fwd = cuda_ms(lambda: wnw.wavefront_fwd(*w, gp, match, mismatch),
                          reps)
    fwd_plain_ms, fwd_plain = cuda_ms(
        lambda: wnw.wavefront_fwd_plain(*w, gp, match, mismatch), 1)
    for name, x, y in zip(("tb", "mlast", "dlb"), fwd, fwd_plain):
        if not bit_equal(x, y):
            fail(f"{tag}: wavefront_fwd {name} differs from its plain "
                 "version")
    if other is not None:
        compare_fwd(tag, [tuple(w) + (gp, match, mismatch)], other["fwd"])
    fwd_bound_ms, fwd_bound_by = fwd_bound(w, fwd)
    tb, mlast, dlb = fwd
    targs = (tb, w.tb_off, mlast, dlb, w.la, w.lb, w.dlo, w.bw, gp)
    tr_ms, tr = cuda_ms(lambda: wtr.wavefront_trace(*targs), reps)
    stride = tr[1].shape[1]
    tr_plain_ms, tr_plain = cuda_ms(
        lambda: wtr.wavefront_trace_plain(*targs, stride), 1)
    # both kernels, whichever the wrapper takes at this shape
    variant_ms = {}
    for name, warp in (("warp", True), ("thread", False)):
        variant_ms[name], out = cuda_ms(
            lambda: wtr.wavefront_trace(*targs, warp=warp), reps)
        for field, x, y in zip(("scores", "ops", "lens"), out, tr_plain):
            if not bit_equal(x, y):
                fail(f"{tag}: wavefront_trace's {name} kernel {field} "
                     "differs from the plain version")
    for name, x, y in zip(("scores", "ops", "lens"), tr, tr_plain):
        if not bit_equal(x, y):
            fail(f"{tag}: wavefront_trace {name} differs from its plain "
                 "version")
    if other is not None:
        compare_trace(tag, [targs], other["trace"])
    scores = tr[0].cpu().numpy()
    paths = wtr.decode_ops(tr[1].cpu().numpy(), tr[2].cpu().numpy())
    if not np.isfinite(scores).all():
        fail(f"{tag}: non-finite scores")
    sub = np.random.default_rng(0).choice(len(pairs), min(256, len(pairs)),
                                          replace=False)
    s_nat, p_nat = wnw.native_nw_band([pairs[k] for k in sub], radius, ap)
    if not (np.array_equal(s_nat, scores[sub])
            and p_nat == [paths[k] for k in sub]):
        fail(f"{tag}: kernels differ from the host C nw_band")
    cells = int((np.minimum(geo[0], geo[1]) * (2 * radius + 1)).sum())
    err = max(float((fwd[1] - fwd_plain[1]).abs().max()),
              float((fwd[2] - fwd_plain[2]).abs().max()))
    tr_bound_ms, tr_bound_by = trace_bound(targs, tr)
    steps = geo[0].astype(np.int64) + geo[1]
    load = int(steps.sum()) / int(steps.max())
    pick = ("warp" if wtr.takes_warp_kernel(int(steps.sum()),
                                            int(steps.max())) else "thread")
    print(f"kernels {tag}: {len(pairs)} pairs, {cells} cells, widest band "
          f"{int(geo[3].max())}; wavefront_fwd {fwd_ms:.3f} ms "
          f"({cells / fwd_ms / 1e6:.2f} Gcells/s, bound {fwd_bound_ms:.4f} "
          f"ms by {fwd_bound_by}), plain {fwd_plain_ms:.1f} ms; "
          f"wavefront_trace "
          f"{tr_ms:.3f} ms ({cells / tr_ms / 1e6:.2f} Gcells/s, bound "
          f"{tr_bound_ms:.4f} ms by {tr_bound_by}; load {load:.0f}, the "
          f"wrapper takes the {pick} kernel; warp kernel "
          f"{variant_ms['warp']:.3f} ms, thread kernel "
          f"{variant_ms['thread']:.3f} ms), plain {tr_plain_ms:.1f} ms; "
          f"bit-equal to plain, {len(sub)} pairs equal to nw_band; clocks "
          f"{clocks()}", flush=True)
    return {"fwd_ms": fwd_ms, "fwd_plain_ms": fwd_plain_ms,
            "fwd_err": err, "fwd_bound": (fwd_bound_ms, fwd_bound_by),
            "trace_ms": tr_ms,
            "trace_plain_ms": tr_plain_ms,
            "trace_bound": (tr_bound_ms, tr_bound_by),
            "trace_err": float((tr[0] - tr_plain[0]).abs().max())}


def raw_banded_fwd(lib, ins, outs):
    """One launch of a banded_nw_fwd_launch entry point on `ins` (a_let,
    b_let, la, lb, dlo, bw, gp, match, mismatch, W) into `outs` (tb,
    mlast, dlb, allocated beforehand, tb in the entry point's layout)."""
    import torch
    a_let, b_let, la, lb, dlo, bw, gp, match, mismatch, W = ins
    tb, mlast, dlb = outs
    err = lib.banded_nw_fwd_launch(
        a_let.data_ptr(), b_let.data_ptr(), a_let.shape[1], b_let.shape[1],
        la.data_ptr(), lb.data_ptr(), dlo.data_ptr(), bw.data_ptr(),
        gp.data_ptr(), match, mismatch, la.numel(), W, tb.data_ptr(),
        mlast.data_ptr(), dlb.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        fail(f"banded_nw_fwd_launch returned CUDA error {err}")
    return outs


def banded_outs(version, ins):
    """Outputs of banded_nw_fwd for an entry point of interface
    `version`: tb pair-major (2, written whole by the kernel) or
    pair-minor and cleared (1)."""
    import torch
    a_let, la, W = ins[0], ins[2], ins[9]
    (P, amax), dev = a_let.shape, a_let.device
    tb = (torch.empty((P, amax, W + 1), dtype=torch.uint8, device=dev)
          if version == 2 else
          torch.zeros((amax, W + 1, P), dtype=torch.uint8, device=dev))
    return (tb, torch.empty((P, W), dtype=torch.float32, device=dev),
            torch.empty(P, dtype=torch.float32, device=dev))


def chase_outs(mlast, stride):
    """Outputs of banded_nw_chase (scores, states, tblast, ops), ops every
    byte OP_PAD as the entry points before the redesign needed them."""
    import torch
    P, W = mlast.shape
    dev = mlast.device
    return (torch.empty(P, dtype=torch.float32, device=dev),
            torch.empty(P, dtype=torch.uint8, device=dev),
            torch.empty((P, W), dtype=torch.uint8, device=dev),
            torch.full((P, stride), 0xFF, dtype=torch.uint8, device=dev))


def raw_banded_chase(lib, outs, ins, stride, res=None):
    """One launch of a banded_nw_chase_launch entry point on forward
    outputs `outs` (tb in that entry point's layout), into `res`
    (chase_outs', allocated beforehand) or new outputs."""
    import torch
    tb, mlast, dlb = outs
    la, lb, dlo, bw, gp = ins[2:7]
    P, W = mlast.shape
    res = chase_outs(mlast, stride) if res is None else res
    err = lib.banded_nw_chase_launch(
        tb.data_ptr(), ins[0].shape[1], mlast.data_ptr(), W, dlb.data_ptr(),
        la.data_ptr(), lb.data_ptr(), dlo.data_ptr(), bw.data_ptr(),
        gp.data_ptr(), P, *(x.data_ptr() for x in res), stride,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        fail(f"banded_nw_chase_launch returned CUDA error {err}")
    return res


def chase_geometry(lib, n_pairs, width, stride):
    """banded_nw_chase's launch geometry as text: pairs a warp, rows a
    window, bytes a slot, shared memory a block."""
    import ctypes
    geo = (ctypes.c_int * 3)()
    smem = lib.banded_nw_chase_geometry(n_pairs, width, stride, 1, geo)
    return (f"{geo[0]} pairs a warp, {geo[1]} rows a window, {geo[2]} "
            f"bytes a slot, {smem} bytes of shared memory a block")


def in_turns(runs, reps, order=("other", "this", "this", "other")):
    """Each of runs ({name: fn}) timed over `reps` calls in the turns
    `order`; returns {name: [ms, ...]}."""
    times = {name: [] for name in runs}
    for name in order:
        times[name].append(cuda_ms(runs[name], reps)[0])
    return times


def compare_banded(tag, ins, other, reps):
    """banded_nw_fwd and banded_nw_chase of another checkout (`other`:
    (library, interface)) against this tree's, kernels alone, bit-equal
    (the other's tb mapped onto this layout where they differ), each
    timed in turns other, this, this, other; returns the times."""
    import torch
    from usearch12_tpu_torch import _build
    lib, version = other
    this = _build.load_library()
    o_out, t_out = banded_outs(version, ins), banded_outs(2, ins)
    raw_banded_fwd(lib, ins, o_out)
    raw_banded_fwd(this, ins, t_out)
    o_tb = o_out[0] if version == 2 else o_out[0].permute(2, 0, 1)
    for name, x, y in zip(("tb", "mlast", "dlb"), t_out,
                          (o_tb,) + o_out[1:]):
        if not bit_equal(x, y.contiguous()):
            fail(f"against oracle {tag}: banded_nw_fwd {name} differs from "
                 "the other checkout's")
    fwd = in_turns({"other": lambda: raw_banded_fwd(lib, ins, o_out),
                    "this": lambda: raw_banded_fwd(this, ins, t_out)}, reps)
    la, lb = ins[2], ins[3]
    stride = (int((la + lb).max()) + 3) // 4
    o_ch = raw_banded_chase(lib, o_out, ins, stride)
    t_ch = raw_banded_chase(this, t_out, ins, stride)
    for name, x, y in zip(("scores", "states", "tblast", "ops"), t_ch, o_ch):
        if not bit_equal(x, y):
            fail(f"against oracle {tag}: banded_nw_chase {name} differs "
                 "from the other checkout's")
    # outputs allocated beforehand: each launch writes the same bytes
    chase = in_turns({"other": lambda: raw_banded_chase(lib, o_out, ins,
                                                          stride, o_ch),
                      "this": lambda: raw_banded_chase(this, t_out, ins,
                                                         stride, t_ch)},
                     reps)
    print(f"against oracle {tag}: kernels alone, ms, banded_nw_fwd "
          f"{json.dumps(fwd)}, banded_nw_chase (each on its own tb layout) "
          f"{json.dumps(chase)}; bit-equal; clocks {clocks()}", flush=True)
    del o_out, o_ch
    torch.cuda.empty_cache()
    return fwd, chase


def check_banded(tag, pairs, radius, ap, dev, reps, other=None):
    """The device oracle's kernels against their plain versions on
    `pairs`: banded_nw_fwd through its wrapper and alone, banded_nw_chase;
    with `other` (load_other's) both against that checkout's.  Returns a
    dict of times and errors."""
    import numpy as np
    import torch
    from usearch12_tpu_torch import _build
    from usearch12_tpu_torch.ops import banded_nw as bn
    from usearch12_tpu_torch.ops import wavefront_nw as wnw
    batch = bn.pack_pairs(pairs, True, radius)
    geo = tuple(torch.from_numpy(x).to(dev) for x in (
        batch.la, batch.lb, batch.dlo, batch.bw))
    a_let, b_let = (torch.from_numpy(x).to(dev)
                    for x in (batch.a_let, batch.b_let))
    gp = wnw.gap_params(ap).to(dev)
    match, mismatch = wnw.match_mismatch(ap)
    fwd_ms, fwd = cuda_ms(lambda: bn.banded_nw_fwd(
        a_let, b_let, *geo, gp, match, mismatch), reps)
    width = fwd[1].shape[1]
    fwd_plain_ms, fwd_plain = cuda_ms(lambda: bn.banded_nw_fwd_plain(
        a_let, b_let, *geo, gp, match, mismatch, width), 1, warm=False)
    for name, x, y in zip(("tb", "mlast", "dlb"), fwd, fwd_plain):
        if not bit_equal(x, y):
            fail(f"oracle {tag}: banded_nw_fwd {name} differs from its "
                 "plain version")
    fwd_err = max(float((fwd[1] - fwd_plain[1]).abs().max()),
                  float((fwd[2] - fwd_plain[2]).abs().max()))
    del fwd_plain
    # the kernel alone, outputs allocated beforehand
    ins = (a_let, b_let, *geo, gp, match, mismatch, width)
    lib = _build.load_library()
    cells_a_part = int(lib.banded_nw_fwd_cells(width))
    outs = banded_outs(2, ins)
    alone, _ = cuda_ms(lambda: raw_banded_fwd(lib, ins, outs), reps)
    for name, x, y in zip(("tb", "mlast", "dlb"), outs, fwd):
        if not bit_equal(x, y):
            fail(f"oracle {tag}: banded_nw_fwd alone differs in {name}")
    del outs
    tb, mlast, dlb = fwd
    ch_ms, ch = cuda_ms(lambda: bn.banded_nw_chase(tb, mlast, dlb, *geo,
                                                   gp), reps)
    stride = ch[3].shape[1]
    ch_plain_ms, ch_plain = cuda_ms(lambda: bn.banded_nw_chase_plain(
        tb, mlast, dlb, *geo, gp, stride), 1, warm=False)
    # the kernel alone, outputs allocated beforehand
    ch_res = chase_outs(mlast, stride)
    ch_alone, _ = cuda_ms(lambda: raw_banded_chase(lib, fwd, ins, stride,
                                                   ch_res), reps)
    for name, x, y, z in zip(("scores", "states", "tblast", "ops"), ch,
                             ch_plain, ch_res):
        if not (bit_equal(x, y) and bit_equal(z, y)):
            fail(f"oracle {tag}: banded_nw_chase {name} differs from its "
                 "plain version")
    if not torch.isfinite(ch[0]).all():
        fail(f"oracle {tag}: non-finite scores")
    cells = int((np.minimum(batch.la, batch.lb).astype(np.int64)
                 * (2 * radius + 1)).sum())
    fwd_b = bound(nbytes_of(a_let, b_let, *geo, gp, *fwd),
                  DP_OPS * int(band_cells(batch.la, batch.lb, batch.dlo,
                                          batch.bw).sum()))
    # the path's steps: the non-pad 2-bit codes of the packed ops
    ops = ch[3]
    steps = int(sum(((ops >> (2 * k)) & 3 != bn.OP_PAD).sum()
                    for k in range(4)))
    ch_b = bound(steps + nbytes_of(mlast, dlb, *geo, gp, *ch),
                 3 * int(batch.lb.sum()) + 4 * steps)
    # the floor of a sweep: every 32-byte sector of each pair's traceback
    # rows 0 .. la - 1, which the path visits one after another
    row_bytes = tb.shape[2]
    first = (torch.arange(len(pairs), device=dev, dtype=torch.int64)
             * tb.shape[1] * row_bytes)
    last = first + geo[0].to(torch.int64) * row_bytes - 1
    sectors = int(((last >> 5) - (first >> 5) + 1).sum())
    sweep_ms = bound(32 * sectors + nbytes_of(mlast, dlb, *geo, gp, *ch),
                     0)[0]
    print(f"oracle {tag}: {len(pairs)} pairs, {cells} cells, band "
          f"{width}; banded_nw_fwd {fwd_ms:.3f} ms through the wrapper, "
          f"{alone:.3f} ms alone ({cells / alone / 1e6:.2f} Gcells/s, "
          f"bound {fwd_b[0]:.4f} ms by {fwd_b[1]}; {cells_a_part} cells a "
          f"part), plain {fwd_plain_ms:.1f} ms; banded_nw_chase "
          f"{ch_ms:.3f} ms through the wrapper, {ch_alone:.3f} ms alone "
          f"(bound {ch_b[0]:.4f} ms by {ch_b[1]}, the sectors of a sweep "
          f"{sweep_ms:.4f} ms; {chase_geometry(lib, len(pairs), width, stride)}"
          f"), plain {ch_plain_ms:.1f} ms; bit-equal to plain; "
          f"clocks {clocks()}", flush=True)
    out = {"fwd_ms": fwd_ms, "fwd_kernel_ms": alone,
           "fwd_plain_ms": fwd_plain_ms, "fwd_err": fwd_err,
           "fwd_bound": fwd_b, "chase_ms": ch_ms, "chase_kernel_ms": ch_alone,
           "chase_sweep_ms": sweep_ms,
           "chase_plain_ms": ch_plain_ms, "chase_bound": ch_b,
           "chase_err": float((ch[0] - ch_plain[0]).abs().max())}
    del fwd, tb, ch, ch_plain, ch_res
    if other is not None:
        compare_banded(tag, ins, other, reps)
    return out


def time_slice_launches(seen, other=None):
    """The slice's launches (inputs as recorded on the main path)
    replayed: wavefront_fwd and wavefront_trace timed on them (one run
    each after a warm-up), each with its bound summed over the launches;
    on every launch both wavefront_trace kernels (the wrapper's choice and
    the other) held bit-equal to wavefront_trace_plain; and with `other`
    (load_other's) the trace against that checkout's.  Returns the
    times, the bounds and the launches' sizes."""
    import torch
    from usearch12_tpu_torch.ops import wavefront_nw as wnw
    from usearch12_tpu_torch.ops import wavefront_trace as wtr
    fwd_ms, outs = cuda_ms(lambda: [wnw.wavefront_fwd(*a) for a in seen], 1)
    bound_ms = sum(fwd_bound(a[:7], o)[0] for a, o in zip(seen, outs))
    targs = [(o[0], a[6], o[1], o[2], *a[2:6], a[8])
             for a, o in zip(seen, outs)]
    trace_ms, _ = cuda_ms(lambda: [wtr.wavefront_trace(*t) for t in targs],
                          1)
    t0 = time.perf_counter()
    trace_bound_ms, picks = 0.0, [None] * len(targs)
    for ks, merged in merged_by_gap_penalties(targs):
        plain = wtr.wavefront_trace_plain(*merged, wtr.ops_stride(
            int((merged[4] + merged[5]).max())))
        row = 0
        for k in ks:
            t = targs[k]
            steps = (t[4] + t[5]).to(torch.int64)
            warp = wtr.takes_warp_kernel(int(steps.sum()), int(steps.max()))
            picks[k] = "warp" if warp else "thread"
            got = wtr.wavefront_trace(*t)
            rows = slice(row, row + t[4].numel())
            row = rows.stop
            stride = got[1].shape[1]
            if plain[1][rows, stride:].any():
                fail(f"slice launch {k}: plain paths longer than the launch")
            want = (plain[0][rows], plain[1][rows, :stride].contiguous(),
                    plain[2][rows])
            for name, out in (("the wrapper's", got), ("the other",
                              wtr.wavefront_trace(*t, warp=not warp))):
                for field, x, y in zip(("scores", "ops", "lens"), out, want):
                    if not bit_equal(x, y):
                        fail(f"slice launch {k}: {name} wavefront_trace "
                             f"kernel {field} differs from the plain "
                             "version")
            trace_bound_ms += trace_bound(t, got)[0]
        del plain
    t_check = time.perf_counter() - t0
    if other is not None:
        compare_trace("slice launches", targs, other["trace"])
    del outs, targs
    pairs = [int(a[2].numel()) for a in seen]
    print(f"slice launches replayed: {len(seen)} launches of {pairs} "
          f"pairs; wavefront_fwd {fwd_ms:.3f} ms, bound {bound_ms:.4f} ms; "
          f"wavefront_trace {trace_ms:.3f} ms, bound {trace_bound_ms:.4f} "
          f"ms, the wrapper's kernels {picks}; both trace kernels bit-equal "
          f"to the plain version on every launch (checked in "
          f"{t_check:.1f} s); clocks {clocks()}", flush=True)
    return {"fwd_ms": fwd_ms, "bound_ms": bound_ms, "pairs": pairs,
            "trace_ms": trace_ms, "trace_bound_ms": trace_bound_ms}


def merged_by_gap_penalties(targs):
    """The wrapper's arguments of several launches merged into one launch
    for each vector of gap penalties (tracebacks concatenated with their
    offsets shifted, mlast padded to the widest), so that the plain
    version, whose cost is its longest pair's steps, runs once a vector.
    Returns [(indices of the launches in order, merged arguments)]."""
    import torch
    groups = {}
    for k, t in enumerate(targs):
        groups.setdefault(tuple(t[8].tolist()), []).append(k)
    out = []
    for ks in groups.values():
        ts = [targs[k] for k in ks]
        base, offs = 0, []
        for t in ts:
            offs.append(t[1] + base)
            base += t[0].numel()
        width = max(t[2].shape[1] for t in ts)
        mlast = torch.cat([torch.nn.functional.pad(
            t[2], (0, width - t[2].shape[1])) for t in ts])
        out.append((ks, (torch.cat([t[0] for t in ts]), torch.cat(offs),
                         mlast, *(torch.cat([t[i] for t in ts])
                                  for i in range(3, 8)), ts[0][8])))
    return out


def load_other(src_dir):
    """Another checkout's csrc/wavefront_fwd.cu, wavefront_trace.cu,
    banded_nw.cu and sintax_boot.cu, each built with this tree's nvcc
    flags into a library of its own (one nvcc per source, started
    together).  Returns {"fwd": library, "trace": (library, whether its
    wavefront_trace_launch takes this tree's arguments: it does if the
    library exports wavefront_trace_interface() == 2, and takes the
    one-thread-a-pair entry point's if it exports no version), "banded":
    (library, its banded_nw_interface(), 1 where it exports none: tb
    pair-minor), "hist": library (its
    sintax_pick_hist_launch, whose arguments have not changed)}.  Its
    wavefront_fwd_launch must take this tree's arguments (with the pair
    order)."""
    import ctypes
    from usearch12_tpu_torch import _build
    csrc = os.path.join(os.path.abspath(src_dir), "usearch12_tpu_torch",
                        "csrc")
    out_dir = _build.BUILD_DIR / "against" / os.path.basename(
        os.path.abspath(src_dir))
    out_dir.mkdir(parents=True, exist_ok=True)
    names = ("wavefront_fwd", "wavefront_trace", "banded_nw", "sintax_boot")
    t0 = time.perf_counter()
    procs = {n: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
         str(out_dir / f"lib{n}_other.so"), os.path.join(csrc, n + ".cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n in names}
    for n, proc in procs.items():
        log = proc.communicate(timeout=600)[0]
        if proc.returncode != 0:
            fail(f"nvcc of {csrc}/{n}.cu failed: {log[-2000:]}")
    libs = {n: ctypes.CDLL(str(out_dir / f"lib{n}_other.so")) for n in names}
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    this = _build.load_library()
    fwd = libs["wavefront_fwd"].wavefront_fwd_launch
    fwd.restype = i32
    fwd.argtypes = this.wavefront_fwd_launch.argtypes
    trace = libs["wavefront_trace"].wavefront_trace_launch
    trace.restype = i32
    version = 1
    if hasattr(libs["wavefront_trace"], "wavefront_trace_interface"):
        libs["wavefront_trace"].wavefront_trace_interface.restype = i32
        version = libs["wavefront_trace"].wavefront_trace_interface()
    if version not in (1, 2):
        fail(f"{csrc}/wavefront_trace.cu: unknown interface {version}")
    trace_new = version == 2
    if trace_new:
        trace.argtypes = this.wavefront_trace_launch.argtypes
    else:
        trace.argtypes = [vp, vp, vp, i32, vp, vp, vp, vp, vp, vp, i32, vp,
                          vp, i32, vp, vp]
    bnw = libs["banded_nw"]
    b_version = 1
    if hasattr(bnw, "banded_nw_interface"):
        bnw.banded_nw_interface.restype = i32
        b_version = bnw.banded_nw_interface()
    if b_version not in (1, 2):
        fail(f"{csrc}/banded_nw.cu: unknown interface {b_version}")
    bnw.banded_nw_fwd_launch.restype = i32
    bnw.banded_nw_fwd_launch.argtypes = this.banded_nw_fwd_launch.argtypes
    bnw.banded_nw_chase_launch.restype = i32
    bnw.banded_nw_chase_launch.argtypes = \
        this.banded_nw_chase_launch.argtypes
    hist = libs["sintax_boot"]
    hist.sintax_pick_hist_launch.restype = i32
    hist.sintax_pick_hist_launch.argtypes = \
        this.sintax_pick_hist_launch.argtypes
    print(f"against: {csrc} built in {time.perf_counter() - t0:.1f} s; "
          f"wavefront_trace interface {version}, banded_nw interface "
          f"{b_version}", flush=True)
    return {"fwd": libs["wavefront_fwd"],
            "trace": (libs["wavefront_trace"], trace_new),
            "banded": (bnw, b_version), "hist": hist}


def raw_trace(lib, new, args, stride, plan):
    """One launch of a wavefront_trace_launch entry point on `args` (the
    wrapper's), outputs allocated as the wrapper allocates them; `plan`
    is (order, nb_max, warp) for an entry point with this tree's
    arguments."""
    import torch
    tb, tb_off, mlast, dlb, la, lb, dlo, bw, gp = args
    P, dev = la.numel(), tb.device
    scores = torch.empty(P, dtype=torch.float32, device=dev)
    ops = torch.zeros((P, stride), dtype=torch.uint8, device=dev)
    lens = torch.empty(P, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    geo = [x.data_ptr() for x in (dlb, la, lb, dlo, bw, gp)]
    if new:
        order, nb_max, warp = plan
        err = lib.wavefront_trace_launch(
            tb.data_ptr(), tb.numel(), tb_off.data_ptr(), order.data_ptr(),
            mlast.data_ptr(), mlast.shape[1], *geo, P, nb_max, int(warp),
            scores.data_ptr(), ops.data_ptr(), stride, lens.data_ptr(),
            stream)
    else:
        err = lib.wavefront_trace_launch(
            tb.data_ptr(), tb_off.data_ptr(), mlast.data_ptr(),
            mlast.shape[1], *geo, P, scores.data_ptr(), ops.data_ptr(),
            stride, lens.data_ptr(), stream)
    if err != 0:
        fail(f"wavefront_trace_launch returned CUDA error {err}")
    return scores, ops, lens


def compare_trace(tag, launches, other):
    """wavefront_trace of another checkout (`other`, load_other's entry)
    and of this tree (the kernel its wrapper picks) on `launches` (the
    wrapper's arguments), entry points called directly with their inputs
    made beforehand, bit-equal, each timed over all launches in turns
    other, this, this, other; returns {name: [ms, ms]}."""
    import torch
    from usearch12_tpu_torch import _build
    from usearch12_tpu_torch.ops import wavefront_trace as wtr
    lib = _build.load_library()
    plans, strides = [], []
    for a in launches:
        la, lb, bw = a[4], a[5], a[7]
        steps = (la + lb).to(torch.int64)
        longest = int(steps.max())
        strides.append(wtr.ops_stride(longest))
        order = torch.argsort(la + lb, descending=True, stable=True).to(
            torch.int32)
        plans.append((order, ((int(bw.max()) + 1) // 2 + 1) // 2,
                      wtr.takes_warp_kernel(int(steps.sum()), longest)))
    runs = {"other": lambda: [raw_trace(*other, a, s, p) for a, s, p in
                              zip(launches, strides, plans)][-1],
            "this": lambda: [raw_trace(lib, True, a, s, p) for a, s, p in
                             zip(launches, strides, plans)][-1]}
    for a, s, p in zip(launches, strides, plans):
        want = raw_trace(*other, a, s, p)
        got = raw_trace(lib, True, a, s, p)
        for name, x, y in zip(("scores", "ops", "lens"), got, want):
            if not bit_equal(x, y):
                fail(f"against {tag}: wavefront_trace {name} differs from "
                     "the other checkout's")
    times = in_turns(runs, 1)
    print(f"against {tag}: wavefront_trace over {len(launches)} launches, "
          f"ms {json.dumps(times)}; bit-equal; clocks {clocks()}", flush=True)
    return times


def raw_fwd(lib, a, lanes, order):
    """One launch of a wavefront_fwd_launch entry point on `a` (the
    wrapper's arguments: WaveLaunch fields, gp, match, mismatch), pairs in
    the order `order`."""
    import torch
    a_let, b_let, la, lb, dlo, bw, tb_off, tb_bytes, gp, match, mismatch = a
    (P, amax), bmax = a_let.shape, b_let.shape[1]
    tb = torch.empty(tb_bytes, dtype=torch.uint8, device=a_let.device)
    mlast = torch.empty((P, bmax), dtype=torch.float32, device=a_let.device)
    dlb = torch.empty(P, dtype=torch.float32, device=a_let.device)
    err = lib.wavefront_fwd_launch(
        a_let.data_ptr(), b_let.data_ptr(), amax, bmax, la.data_ptr(),
        lb.data_ptr(), dlo.data_ptr(), bw.data_ptr(), tb_off.data_ptr(),
        order.data_ptr(), gp.data_ptr(), match, mismatch, P, lanes,
        tb.data_ptr(), mlast.data_ptr(), dlb.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        fail(f"wavefront_fwd_launch returned CUDA error {err}")
    return tb, mlast, dlb


def compare_fwd(tag, launches, other):
    """wavefront_fwd of another checkout (`other`, load_other's library;
    it gets the pair order this tree's wrapper makes) and of this tree
    (pairs longest first, as the wrapper launches them, and in launch
    order) on `launches`, bit-equal, each timed over all launches in turns
    other, this, this in launch order (twice), this, other; returns
    {name: [ms, ms]}."""
    import torch
    from usearch12_tpu_torch import _build
    lib = _build.load_library()
    lanes = [((int(a[5].max()) + 1) // 2 + 31) // 32 * 32 for a in launches]
    longest = [torch.argsort(a[2] + a[3], descending=True, stable=True).to(
        torch.int32) for a in launches]
    given = [torch.arange(a[2].numel(), dtype=torch.int32,
                          device=a[2].device) for a in launches]
    runs = {
        "other": lambda: [raw_fwd(other, a, n, o)
                          for a, n, o in zip(launches, lanes, longest)][-1],
        "this": lambda: [raw_fwd(lib, a, n, o)
                         for a, n, o in zip(launches, lanes, longest)][-1],
        "this, launch order": lambda: [
            raw_fwd(lib, a, n, o)
            for a, n, o in zip(launches, lanes, given)][-1]}
    for k, a in enumerate(launches):
        want = raw_fwd(other, a, lanes[k], longest[k])
        for got in (raw_fwd(lib, a, lanes[k], longest[k]),
                    raw_fwd(lib, a, lanes[k], given[k])):
            for name, x, y in zip(("tb", "mlast", "dlb"), got, want):
                if not bit_equal(x, y):
                    fail(f"against {tag}: wavefront_fwd {name} differs from "
                         "the other checkout's")
        del want, got
    times = in_turns(runs, 1, ("other", "this", "this, launch order",
                               "this, launch order", "this", "other"))
    print(f"against {tag}: wavefront_fwd over {len(launches)} launches, ms "
          f"{json.dumps(times)}; bit-equal; clocks {clocks()}", flush=True)
    return times


def perf_constants(dev, ap, dev_rate):
    """DevicePerfModel's cold-start constants measured on this card: the
    fixed cost of one TorchWaveAligner dispatch of one short pair (rtt),
    pageable host-to-card and card-to-host copies of 64 MB, the hole DP
    rate of the slice (its cells over TorchWaveAligner.align's seconds),
    and the first dispatch's excess over the second in a fresh process
    (warm_tax; the kernel library already built)."""
    import numpy as np
    import torch
    from usearch12_tpu_torch.ops import wavefront_nw as wnw
    one = kernel_pairs(np.random.default_rng(3), 1, 100)
    aligner = wnw.TorchWaveAligner(ap, dev)
    aligner.align(one, 16)
    rtts = []
    for _ in range(20):
        t0 = time.perf_counter()
        aligner.align(one, 16)
        rtts.append(time.perf_counter() - t0)
    host = np.ones(64 << 20, np.uint8)
    card = torch.ones(64 << 20, dtype=torch.uint8, device=dev)
    ups, dns = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.from_numpy(host).to(dev)
        torch.cuda.synchronize()
        ups.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        card.cpu()
        dns.append(time.perf_counter() - t0)
    code = ("import sys, time; sys.path.insert(0, sys.argv[1])\n"
            "import numpy as np\n"
            "import chip_smoke as cs\n"
            "from usearch12_tpu_torch.device import resolve_device\n"
            "from usearch12_tpu_torch.ops import wavefront_nw as wnw\n"
            "dev = resolve_device()\n"
            "pairs = cs.kernel_pairs(np.random.default_rng(4), 256, 2000)\n"
            "al = wnw.TorchWaveAligner(wnw.nucleo_params(-10.0, -1.0, -0.5,"
            " -0.5), dev)\n"
            "ts = []\n"
            "for _ in range(2):\n"
            "    t0 = time.perf_counter(); al.align(pairs, 120)\n"
            "    ts.append(time.perf_counter() - t0)\n"
            "print(ts[0], ts[1])\n")
    r = subprocess.run([sys.executable, "-c", code, HERE], cwd=HERE,
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        fail(f"first-dispatch probe exited {r.returncode}: "
             f"{r.stderr[-2000:]}")
    first, second = (float(x) for x in r.stdout.split()[-2:])
    rtt = float(np.median(rtts))
    print(f"perf model: rtt {rtt:.6f} s (median of 20, one 100-nt pair); "
          f"up {host.nbytes / min(ups):.4g} B/s, down "
          f"{host.nbytes / min(dns):.4g} B/s (best of 5, 64 MB pageable); "
          f"dev_rate {dev_rate:.4g} cells/s (the slice); first dispatch "
          f"{first:.4f} s, second {second:.4f} s, warm_tax "
          f"{max(0.0, first - second):.4f} s (256 pairs of 2 kb, radius 120,"
          " fresh process)", flush=True)


def lcg_stream(n, seed=1):
    """The first n draws of SINTAX's per-query boot LCG
    (src/sintaxsearcher.cpp:77-82), seeded at -randseed."""
    import numpy as np
    out, r = np.empty(n, np.uint32), seed
    for k in range(n):
        r = (1664525 * r + 1013904223) & 0xFFFFFFFF
        out[k] = r
    return out


def sintax_chunks(dbf, qf, d):
    """One full chunk of real jobs, as the port's classifier hands it to
    TorchBootEngine.run_chunk on the first 64 queries (128 jobs, both
    strands), with the engine that holds the DB's incidence; then the
    same chunk at m = 200 and at m = 0."""
    import numpy as np
    from usearch12_tpu_torch import cli
    from usearch12_tpu_torch.amplicon import sintax_device as sd
    q64 = os.path.join(d, "q64.fa")
    with open(qf) as f, open(q64, "w") as out:
        out.writelines(f.readlines()[:128])
    seen = []
    orig = sd.TorchBootEngine.run_chunk

    def grab(engine, *args):
        seen.append((engine, args))
        return orig(engine, *args)

    sd.TorchBootEngine.run_chunk = grab
    try:
        rc = cli.main(["-sintax", q64, "-db", dbf, "-strand", "both",
                       "-randseed", "1", "-quiet", "-sintax_device"])
    finally:
        sd.TorchBootEngine.run_chunk = orig
    if rc != 0 or len(seen) != 1:
        fail(f"sintax chunk capture: exit {rc}, {len(seen)} chunks")
    engine, (words, nuw, m, stream, rr) = seen[0]
    if words.shape[0] != 128 or int(m.min()) != 32:
        fail(f"sintax chunk capture: {words.shape} jobs, m {set(m)}")
    chunks = [(32, words, nuw, m, stream, rr)]
    for m_val, mmax in ((200, 256), (0, 8)):
        chunks.append((m_val, words, nuw, np.full_like(m, m_val),
                       lcg_stream(engine.B * mmax), rr))
    return engine, chunks


def raw_pick_hist(lib, args, P):
    """One launch of a sintax_pick_hist_launch entry point on pick_hist's
    arguments into P, allocated beforehand."""
    import torch
    from usearch12_tpu_torch.ops import sintax_boot as sb
    nuw, m, stream, boots, uwmax, dtype = args
    err = lib.sintax_pick_hist_launch(
        nuw.data_ptr(), m.data_ptr(), stream.data_ptr(), stream.numel(),
        boots, nuw.numel(), uwmax, sb._DTYPE_CODE[dtype], P.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        fail(f"sintax_pick_hist_launch returned CUDA error {err}")
    return P


def flat_picks(nuw, m, stream, boots, uwmax):
    """The chunk's picks as flat indices (j * boots + b) * uwmax + slot of
    P, one for each pick k < m of each boot (pick_hist_plain's
    positions), for torch.bincount."""
    import torch
    from usearch12_tpu_torch.ops import sintax_boot as sb
    dev, n = nuw.device, stream.numel()
    m64 = m.to(torch.int64)[:, None, None]
    b = torch.arange(boots, device=dev)[None, :, None]
    k = torch.arange(n // boots, device=dev)[None, None, :]
    slot = sb._u32(stream)[(b * m64 + k).clamp(0, n - 1)] % \
        nuw.to(torch.int64).clamp(min=1)[:, None, None]
    j = torch.arange(nuw.numel(), device=dev)[:, None, None]
    flat = (j * boots + b) * uwmax + slot
    return flat[(k < m64).expand(flat.shape)]


def check_sintax_kernels(engine, chunks, dev, other_hist=None):
    """sintax_pick_hist (through its wrapper and alone) and the fused
    count-and-select kernel (sintax_boot_count_select) bit for bit against
    their plain versions on full chunks, torch.bincount over the picks
    timed beside the histogram and the route the fused kernel replaced
    (gather, mask and cast; bmm) beside that kernel; with `other_hist`
    (another checkout's library) its sintax_pick_hist against this tree's,
    kernels alone, in turns other, this, this, other.  Returns times,
    bounds and errors of the m = 32 chunk and the worst errors."""
    import torch
    from usearch12_tpu_torch import _build
    from usearch12_tpu_torch.ops import sintax_boot as sb
    lib = _build.load_library()
    out = {"hist_err": 0.0, "select_err": 0.0}
    for m_val, words, nuw, m, stream, rr in chunks:
        words_d, nuw_d, m_d, stream_d, rr_d = (
            torch.from_numpy(x.view("int32")).to(dev)
            for x in (words, nuw, m, stream, rr))
        dtype = sb.product_dtype(dev, m_val, engine.inc_absmax)
        args = (nuw_d, m_d, stream_d, engine.B, words.shape[1], dtype)
        hist_ms, P = cuda_ms(lambda: sb.pick_hist(*args), 5)
        P_alone = torch.empty_like(P)
        alone_ms, _ = cuda_ms(lambda: raw_pick_hist(lib, args, P_alone), 20)
        # 2 operations per pick (the fold and the add), B x m picks a job
        hist_b = bound(nbytes_of(nuw_d, m_d, stream_d, P),
                       2 * engine.B * int(m.astype("int64").sum()))
        hist_plain_ms, P_plain = cuda_ms(lambda: sb.pick_hist_plain(*args), 1)
        if not (bit_equal(P, P_plain) and bit_equal(P_alone, P_plain)):
            fail(f"sintax m={m_val}: sintax_pick_hist differs from its "
                 "plain version")
        # the library's histogram: one bincount over the flat picks
        flat = flat_picks(nuw_d, m_d, stream_d, engine.B, words.shape[1])
        lib_ms, counts = cuda_ms(lambda: torch.bincount(
            flat, minlength=P.numel()), 20)
        if not torch.equal(counts, P.to(torch.int64).flatten()):
            fail(f"sintax m={m_val}: torch.bincount's counts differ from "
                 "sintax_pick_hist's")
        del flat, counts
        hist_turns = ""
        if other_hist is not None:
            P_other = raw_pick_hist(other_hist, args, torch.empty_like(P))
            if not bit_equal(P_other, P):
                fail(f"against sintax m={m_val}: sintax_pick_hist differs "
                     "from the other checkout's")
            times = in_turns({
                "other": lambda: raw_pick_hist(other_hist, args, P_other),
                "this": lambda: raw_pick_hist(lib, args, P_alone)}, 20)
            hist_turns = (f"; against: sintax_pick_hist alone, ms "
                          f"{json.dumps(times)}")
        cargs = (P, words_d, nuw_d, engine.w_mat, rr_d)
        sel_ms, sel = cuda_ms(lambda: sb.boot_count_select(*cargs), 5)
        # the live incidence rows (nuw x T bytes a job), P, the words, rr
        # and the outputs; 2 operations per term of U, at the tensor
        # cores' rate for P's type
        T = engine.w_mat.shape[1]
        live = int(nuw.astype("int64").sum())
        sel_b = bound(live * T + nbytes_of(P, words_d, nuw_d, rr_d, *sel),
                      2 * engine.B * live * T,
                      PEAK_INT8 if dtype == torch.int8 else PEAK_F16)
        # the plain version and the old route: float16 where the whole
        # sum is exact in it, as that route took it
        rdt = (torch.float16 if m_val * max(engine.inc_absmax, 1)
               <= sb.FP16_EXACT else torch.float32)
        sel_plain_ms, sel_plain = cuda_ms(
            lambda: sb.boot_count_select_plain(*cargs, dtype=rdt), 1,
            warm=False)
        for name, x, y in zip(("winner", "top"), sel, sel_plain):
            if not bit_equal(x, y):
                fail(f"sintax m={m_val}: sintax_boot_count_select {name} "
                     "differs from its plain version")
        P_r = P.to(rdt)
        gather_ms, mq = cuda_ms(lambda: sb.gather_rows(
            engine.w_mat, words_d, nuw_d, rdt), 3)
        prod_ms, U = cuda_ms(lambda: sb.boot_product(P_r, mq), 3)
        del mq
        for name, x, y in zip(("winner", "top"), sel,
                              sb.boot_select_plain(U, rr_d)):
            if not bit_equal(x, y):
                fail(f"sintax m={m_val}: sintax_boot_count_select {name} "
                     "differs from the select over U")
        del U
        top = int(sel[1].max())
        if m_val == 0 and top != 0:
            fail("sintax m=0: non-zero top")
        out["hist_err"] = max(out["hist_err"],
                              float((P - P_plain).abs().max()))
        out["select_err"] = max(out["select_err"], float(max(
            (x - y).abs().max() for x, y in zip(sel, sel_plain))))
        print(f"sintax kernels m={m_val}: {tuple(P.shape)} P of {dtype}, "
              f"{T} targets, {live} live word rows; sintax_pick_hist "
              f"{hist_ms:.3f} ms through the wrapper, {alone_ms:.4f} ms "
              f"alone, torch.bincount {lib_ms:.4f} ms, plain "
              f"{hist_plain_ms:.3f} ms, bound {hist_b[0]:.4f} ms by "
              f"{hist_b[1]}{hist_turns}; sintax_boot_count_select "
              f"{sel_ms:.3f} ms, bound {sel_b[0]:.4f} ms by {sel_b[1]}, "
              f"plain {sel_plain_ms:.3f} ms; the route it replaced "
              f"({rdt}): gather {gather_ms:.3f} ms, product "
              f"{prod_ms:.3f} ms; top max {top}; bit-equal to plain; "
              f"clocks {clocks()}", flush=True)
        if m_val == 32:
            out.update(hist_ms=hist_ms, hist_kernel_ms=alone_ms,
                       hist_plain_ms=hist_plain_ms, hist_lib_ms=lib_ms,
                       sel_ms=sel_ms, sel_plain_ms=sel_plain_ms,
                       hist_bound=hist_b, sel_bound=sel_b)
        del P, P_r, P_plain, P_alone, sel_plain
        torch.cuda.empty_cache()
    return out


def sintax_run(args, stats=None, profile=False):
    """Wall seconds of one in-process sintax run through the port's
    command line, with host-side stage times (classify_window and the
    chunks' run_chunk, synchronised) and, if asked, the device time by
    kernel from torch.profiler."""
    import torch
    from usearch12_tpu_torch import cli
    from usearch12_tpu_torch.amplicon import sintax_device as sd
    stage = {"classify_window": 0.0, "run_chunk": 0.0}
    orig = {"classify_window": sd.SintaxTorchClassifier.classify_window,
            "run_chunk": sd.TorchBootEngine.run_chunk}

    def timed(name):
        def f(*a, **k):
            t0 = time.perf_counter()
            r = orig[name](*a, **k)
            stage[name] += time.perf_counter() - t0
            return r
        return f

    sd.SintaxTorchClassifier.classify_window = timed("classify_window")
    sd.TorchBootEngine.run_chunk = timed("run_chunk")
    if stats:
        os.environ["USEARCH_DEVICE_STATS"] = stats
    prof = None
    try:
        if profile:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        rc = cli.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        sd.SintaxTorchClassifier.classify_window = orig["classify_window"]
        sd.TorchBootEngine.run_chunk = orig["run_chunk"]
        os.environ.pop("USEARCH_DEVICE_STATS", None)
    if rc != 0:
        fail(f"usearch12_tpu_torch.cli -sintax exited {rc}")
    kernels = None
    if prof is not None:
        def dev_us(e):
            return getattr(e, "device_time_total",
                           getattr(e, "cuda_time_total", 0.0))
        evs = sorted((e for e in prof.key_averages() if dev_us(e) > 0
                      and not e.key.startswith("aten::")),
                     key=dev_us, reverse=True)
        kernels = {"device_ms": round(sum(map(dev_us, evs)) / 1000, 3),
                   "top": [(e.key[:50], round(dev_us(e) / 1000, 3), e.count)
                           for e in evs[:8]]}
    return wall, stage, kernels


def gate_crossover(gate):
    """The target count at which host and card take equal time: host -
    card interpolated linearly between measured sizes (n, host s, card s),
    or extrapolated from the two nearest sizes when one side wins at
    every size; nan when the data give none."""
    pts = [(n, h - c) for n, h, c in gate]
    pairs = list(zip(pts, pts[1:]))
    for (n0, d0), (n1, d1) in pairs:
        if d0 <= 0 < d1:
            return n0 - d0 * (n1 - n0) / (d1 - d0)
    (n0, d0), (n1, d1) = pairs[0] if pts[0][1] > 0 else pairs[-1]
    if d1 > d0:
        return n0 - d0 * (n1 - n0) / (d1 - d0)
    return float("nan")


def phase_sintax(d, dev, phase_done, other_hist=None):
    """Phases 6 and 7 in directory d; returns the kernel check's numbers
    and the launch counts of the main run."""
    import torch
    from usearch12_tpu_torch.ops import sintax_boot as sb

    # 6. the SINTAX kernels on full chunks of the workload
    t_phase = time.perf_counter()
    sizes_of = {}
    for n in (60000, 90000):
        dbf, qf = (os.path.join(d, f"sx{n}_{x}.fa") for x in ("db", "q"))
        gen_sintax(dbf, qf, n)
        sizes_of[n] = (dbf, qf)
    dbf, qf = sizes_of[60000]
    t0 = time.perf_counter()
    engine, chunks = sintax_chunks(dbf, qf, d)
    # the incidence build's index_put_ (accumulate) reads two int64
    # indices a posting and reads and writes its byte
    posts = int(engine.w_mat.sum(dtype=torch.int64))
    build_b = bound(18 * posts, posts)
    print(f"sintax chunk: 128 jobs x 256 slots from the port's run on 64 "
          f"queries in {time.perf_counter() - t0:.2f} s; incidence "
          f"{tuple(engine.w_mat.shape)} int8, max {engine.inc_absmax}, "
          f"{posts} postings, the build's index_put_ bound "
          f"{build_b[0]:.4f} ms by {build_b[1]}", flush=True)
    sx = check_sintax_kernels(engine, chunks, dev, other_hist)
    del engine, chunks
    torch.cuda.empty_cache()
    phase_done(6, t_phase)

    # 7. the workload through the port's command line on the card against
    # its host path, then the gate's measurement
    t_phase = time.perf_counter()
    base = ["-sintax", qf, "-db", dbf, "-strand", "both", "-randseed", "1",
            "-quiet"]
    ref, port = os.path.join(d, "ref.tab"), os.path.join(d, "port.tab")
    stats = os.path.join(d, "sintax_stats.jsonl")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "usearch12_tpu_torch.cli"]
                       + base + ["-no_sintax_device", "-tabbedout", ref],
                       cwd=HERE, capture_output=True, text=True, timeout=900)
    t_host = time.perf_counter() - t0
    if r.returncode != 0:
        fail(f"sintax host judge exited {r.returncode}: {r.stderr[-2000:]}")
    sb.pick_hist.launches = 0
    sb.boot_count_select.launches = 0
    t_port, stage, _ = sintax_run(base + ["-sintax_device", "-tabbedout",
                                          port], stats)
    launches = {"sintax_pick_hist": sb.pick_hist.launches,
                "sintax_boot_count_select": sb.boot_count_select.launches}
    with open(ref, "rb") as f:
        ref_b = f.read()
    with open(port, "rb") as f:
        port_b = f.read()
    with open(stats) as f:
        rec = json.loads(f.read().splitlines()[-1])
    n_rows = ref_b.count(b"\n")
    with open(qf) as f:
        n_queries = f.read().count(">")
    print(f"sintax: 60,000 targets x 1,500 queries, -strand both; host "
          f"path (subprocess) {t_host:.2f} s, card "
          f"{t_port:.2f} s (classify_window {stage['classify_window']:.2f} "
          f"s, run_chunk {stage['run_chunk']:.2f} s); stats {rec}; "
          f"launches {launches}; {n_rows} rows, tabbedout "
          f"{'equal' if ref_b == port_b else 'DIFFERENT'}", flush=True)
    if ref_b != port_b or n_rows != n_queries:
        fail("sintax -tabbedout of the port differs from the host path")
    if not rec["device"]:
        fail("sintax did not run on the card")
    if min(launches.values()) <= 0:
        fail(f"a SINTAX kernel was not launched on the main path: "
             f"{launches}")

    # the auto gate: host and card as fresh processes of the port's
    # command line, as a user runs it, at two DB sizes around
    # AUTO_MIN_TARGETS, in the order host, card
    for code in ("import usearch12_tpu_torch.cli", "import torch",
                 "import torch; torch.zeros(1, device='cuda')"):
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c", code], cwd=HERE, check=True,
                       timeout=300)
        print(f"sintax gate: python -c \"{code}\" "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    gate = []
    for n in sorted(sizes_of):
        g_db, g_q = sizes_of[n]
        secs = {"-no_sintax_device": [], "-sintax_device": []}
        outs = []
        for flag in ("-no_sintax_device", "-sintax_device"):
            outs.append(os.path.join(d, f"gate{n}_{len(outs)}.tab"))
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "usearch12_tpu_torch.cli", "-sintax",
                 g_q, "-db", g_db, "-strand", "both", "-randseed", "1",
                 "-quiet", flag, "-tabbedout", outs[-1]],
                cwd=HERE, capture_output=True, text=True, timeout=600)
            secs[flag].append(time.perf_counter() - t0)
            if r.returncode != 0:
                fail(f"sintax gate {n} {flag} exited {r.returncode}: "
                     f"{r.stderr[-2000:]}")
        tabs = set()
        for out in outs:
            with open(out, "rb") as f:
                tabs.add(f.read())
        if len(tabs) != 1:
            fail(f"sintax gate {n}: host and card -tabbedout differ")
        host_s, card_s = (secs[k] for k in ("-no_sintax_device",
                                           "-sintax_device"))
        gate.append((n, host_s[0], card_s[0]))
        print(f"sintax gate: {n} targets; host {host_s[0]:.2f} s, card "
              f"{card_s[0]:.2f} s; tabbedout equal", flush=True)
    print(f"sintax gate: crossover at {gate_crossover(gate):.0f} targets",
          flush=True)
    wall, stage, prof = sintax_run(base + ["-sintax_device", "-tabbedout",
                                           port], profile=True)
    print(f"sintax profile: wall {wall:.2f} s, classify_window "
          f"{stage['classify_window']:.2f} s, run_chunk "
          f"{stage['run_chunk']:.2f} s; {json.dumps(prof)}", flush=True)
    phase_done(7, t_phase)
    return sx, launches


def rank_stages(udb, qf, big_opts, dev):
    """The ranker's stages (ops/csr_rank.py) on the first chunk of the
    workload's queries, each timed with CUDA events beside its bound, and
    the whole ranking of the 2,000 queries profiled.  Returns the stage
    times and bounds."""
    import numpy as np
    import torch
    from usearch12_tpu_torch import cli
    from usearch12_tpu_torch.commands import load_db
    from usearch12_tpu_torch.io.fastx import read_fastx
    from usearch12_tpu_torch.ops.csr_rank import CSRDeviceRanker
    cli.parse_argv(["-usearch_global", qf, "-db", udb, "-id", "0.9",
                    "-strand", "plus", "-quiet"] + big_opts)
    _db, index = load_db(udb)
    seqs = [s for _l, s, _q in read_fastx(qf, stream=True)]
    jbuf = np.ascontiguousarray(np.concatenate(seqs))
    j_off = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(x) for x in seqs], out=j_off[1:])
    ranker = CSRDeviceRanker(index, dev)
    _n, chunks, _over = ranker.prepare_chunks(jbuf, j_off)
    _lo, _hi, qw, cap = chunks[0]
    q = torch.from_numpy(qw).to(dev)
    hits_ms, hits = cuda_ms(lambda: ranker.hits(q, cap), 10)
    count_ms, count = cuda_ms(lambda: ranker.counts(hits), 10)
    if ranker.big:
        rank_ms, _ = cuda_ms(lambda: ranker.rank_big(count, hits), 10)
    else:
        rank_ms, _ = cuda_ms(lambda: ranker.rank_sorted(count), 10)
    TP = count.shape[1]
    rows = torch.arange(q.shape[0], device=dev)[:, None] * TP
    lib_ms, _ = cuda_ms(lambda: torch.bincount((rows + hits).reshape(-1),
                                               minlength=count.numel()), 10)
    # bytes: the postings each stream position gathers (int32) and the
    # stream written; the stream read and the count rows written; the
    # count rows read (and, in big mode, the stream and a first-touch row
    # written and read)
    n_pos = int((hits < ranker.t).sum())
    b_hits = bound(4 * n_pos + nbytes_of(q, hits), 0)
    b_count = bound(nbytes_of(hits, count), 0)
    b_rank = bound(nbytes_of(count) * (3 if ranker.big else 1)
                   + (nbytes_of(hits) if ranker.big else 0), 0)
    # the window's wall time with the ranker warm, then its device time
    # (a profiler's first session in a process takes seconds to start)
    t0 = time.perf_counter()
    ranker.rank_window(jbuf, j_off)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    with prof:
        ranker.rank_window(jbuf, j_off)
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0.0))
    evs = sorted((e for e in prof.key_averages() if dev_us(e) > 0
                  and not e.key.startswith("aten::")), key=dev_us,
                 reverse=True)
    device_ms = sum(map(dev_us, evs)) / 1000
    top = [(e.key[:40], round(dev_us(e) / 1000, 3), e.count) for e in evs[:6]]
    mode = "big (UDBSearchBig)" if ranker.big else "SetTopBump"
    print(f"rank stages, {mode}: one chunk of {q.shape[0]} queries, "
          f"{n_pos} hits (cap {cap}), {TP} count columns; hits "
          f"{hits_ms:.4f} ms (bound {b_hits[0]:.4f}), counts {count_ms:.4f} "
          f"ms (bound {b_count[0]:.4f}; torch.bincount alone {lib_ms:.4f}), "
          f"rank and top-K {rank_ms:.4f} ms (bound {b_rank[0]:.4f}); the "
          f"window of {len(seqs)} queries in {len(chunks)} chunks: "
          f"{wall:.3f} s wall, {device_ms:.3f} ms device, top {top}",
          flush=True)
    return {"hits_ms": hits_ms, "count_ms": count_ms, "rank_ms": rank_ms,
            "bincount_ms": lib_ms, "bounds": (b_hits[0], b_count[0],
                                              b_rank[0]),
            "chunks": len(chunks), "device_ms": device_ms, "wall_s": wall}


def phase_rank(d, dev, phase_done):
    """Phase 9 in directory d: the ranking workload through the port's
    command line, -device_rank against -no_device_rank (a process of its
    own, the judge, and in this process), at the default -big (big mode)
    and at -big 300000 (SetTopBump); the ranker's stages; both rankers as
    fresh processes in turns, for the automatic gate.  Returns the
    numbers."""
    import torch
    from usearch12_tpu_torch import cli
    t_phase = time.perf_counter()
    dbf, qf, udb = (os.path.join(d, x) for x in ("bigdb.fa", "bigq.fa",
                                                 "bigdb.udb"))
    t0 = time.perf_counter()
    gen_bigdb(dbf, qf)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    if cli.main(["-makeudb_usearch", dbf, "-output", udb, "-quiet"]) != 0:
        fail("makeudb_usearch of the ranking workload failed")
    print(f"rank: 220,000 targets x 2,000 queries of 250 nt written in "
          f"{t_gen:.1f} s, indexed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    base = ["-usearch_global", qf, "-db", udb, "-id", "0.9", "-strand",
            "plus", "-quiet"]
    stats = os.path.join(d, "rank_stats.jsonl")
    out = {}
    for tag, big_opts in (("big", []), ("sorted", ["-big", "300000"])):
        ref, port, port_host = (os.path.join(d, f"rank_{tag}_{x}.b6")
                                for x in ("host", "card", "card_host"))
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "usearch12_tpu_torch.cli"]
                           + base + big_opts + ["-no_device_rank",
                                                "-blast6out", ref],
                           cwd=HERE, capture_output=True, text=True,
                           timeout=600)
        t_host = time.perf_counter() - t0
        if r.returncode != 0:
            fail(f"rank host judge exited {r.returncode}: "
                 f"{r.stderr[-2000:]}")
        # both rankers in this process (torch loaded, the card warm):
        # the host's, then the card's, whose launches are counted
        t0 = time.perf_counter()
        rc = cli.main(base + big_opts + ["-no_device_rank", "-blast6out",
                                         port_host])
        t_host_in = time.perf_counter() - t0
        os.environ["USEARCH_DEVICE_STATS"] = stats
        try:
            t0 = time.perf_counter()
            rc |= cli.main(base + big_opts + ["-device_rank", "-blast6out",
                                              port])
            torch.cuda.synchronize()
            t_card = time.perf_counter() - t0
        finally:
            os.environ.pop("USEARCH_DEVICE_STATS", None)
        with open(ref, "rb") as f:
            ref_b = f.read()
        with open(port, "rb") as f:
            port_b = f.read()
        with open(port_host, "rb") as f:
            port_b = port_b if f.read() == port_b else b""
        with open(stats) as f:
            ds = json.loads(f.read().splitlines()[-1])
        n_hits = ref_b.count(b"\n")
        print(f"rank {tag}: host ranker (a process) {t_host:.2f} s; in "
              f"process, host ranker {t_host_in:.2f} s, card ranker "
              f"{t_card:.2f} s; rank_device_jobs "
              f"{ds['rank_device_jobs']}, rank_host_rerank_jobs "
              f"{ds['rank_host_rerank_jobs']}; {n_hits} hits, "
              f"blast6 {'equal' if ref_b == port_b else 'DIFFERENT'}",
              flush=True)
        if rc != 0 or ref_b != port_b or not ref_b:
            fail(f"rank {tag}: -device_rank's blast6 differs from the host "
                 "ranker's")
        if ds["rank_device_jobs"] != 2000:
            fail(f"rank {tag}: rank_device_jobs {ds['rank_device_jobs']}, "
                 "not the 2,000 jobs")
        out[tag] = {"host_s": t_host, "host_in_s": t_host_in,
                    "card_s": t_card, **rank_stages(udb, qf, big_opts, dev)}
        if tag == "big":
            # the automatic gate: both rankers as fresh processes, in the
            # turns host (the judge above), card, card, host
            gate = {"-no_device_rank": [t_host], "-device_rank": []}
            for flag in ("-device_rank", "-device_rank", "-no_device_rank"):
                t0 = time.perf_counter()
                r = subprocess.run(
                    [sys.executable, "-m", "usearch12_tpu_torch.cli"] + base
                    + [flag, "-blast6out", port], cwd=HERE,
                    capture_output=True, text=True, timeout=600)
                gate[flag].append(time.perf_counter() - t0)
                with open(port, "rb") as f:
                    same = f.read() == ref_b
                if r.returncode != 0 or not same:
                    fail(f"rank gate: {flag} exited {r.returncode} or its "
                         f"blast6 differs: {r.stderr[-2000:]}")
            out["gate"] = gate
            print(f"rank gate: 220,000 targets as fresh processes, in turns "
                  f"host, card, card, host; host ranker "
                  f"{[round(x, 2) for x in gate['-no_device_rank']]} s, card "
                  f"ranker {[round(x, 2) for x in gate['-device_rank']]} s; "
                  f"blast6 equal", flush=True)
    phase_done(9, t_phase)
    return out


# reads of the cluster_mt phase: bench.py's amplicon reads (400 templates of
# 250 nt, seed 11, 250 reads each: 100,400 records) cut to 74 reads a
# template, 30,000 records
MESH_READS = 30000


def gen_reads(path, n_records, seed=11):
    """bench.py's _gen_workloads reads (tests/genseqs.py:make_amplicons, 400
    templates of 250 nt) with n_records // 400 - 1 reads a template."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from genseqs import make_amplicons, write_fasta
    write_fasta(path, make_amplicons(n_templates=400,
                                     reads_per_template=n_records // 400 - 1,
                                     length=250, seed=seed))


def read_stats(path):
    with open(path) as f:
        return json.loads(f.read().splitlines()[-1])


def u_count_stages(reads, cent_fa, dev):
    """DeviceUCounter at the final centroid set of the cluster_mt run: one
    window of 128 reads through count() and its product alone (the
    target-major incidence's transposed view, cuBLASLt's TN layout), each
    beside its bound, and the same product on a (V, T) row-major copy (NN)
    for the layout torch._int_mm wants."""
    import numpy as np
    import torch
    from usearch12_tpu_torch import cli
    from usearch12_tpu_torch.index.udb import UDBIndex, UDBParams
    from usearch12_tpu_torch.io.fastx import read_fastx
    from usearch12_tpu_torch.parallel import incidence as inc
    from usearch12_tpu_torch.parallel.cluster_batch import DeviceUCounter
    from usearch12_tpu_torch.parallel.mesh import single_mesh
    cli.parse_argv(["-cluster_mt", reads, "-id", "0.97", "-quiet"])
    index = UDBIndex(UDBParams.global_usearch(True))
    for k, (_l, s, _q) in enumerate(read_fastx(cent_fa, stream=True)):
        index.add_seq(k, s)
        index.seq_count = k + 1
    t = index.seq_count
    window = [s for _l, s, _q in read_fastx(reads, stream=True)][:128]
    counter = DeviceUCounter(single_mesh(dev))
    counter.refresh(index)
    count_ms, u = cuda_ms(lambda: counter.count(index, window), 5)
    v_pad = inc.pad8(index.params.slot_count)
    q = inc.onehot([index.params.unique_words(s) for s in window],
                   inc.query_rows(len(window)), v_pad, dev)
    w = counter._shard_of(0, 0)[:inc.pad8(t)]
    tn_ms, prod = cuda_ms(lambda: inc.int8_mm(q, w), 10)
    if not np.array_equal(prod[:len(window), :t].cpu().numpy(), u):
        fail("the U counter's product differs from count()")
    w_nn = w.t().contiguous()
    try:
        nn_ms, prod_nn = cuda_ms(lambda: torch._int_mm(q, w_nn), 10)
        if not torch.equal(prod_nn, prod):
            fail("the NN layout's product differs")
    except RuntimeError as e:
        nn_ms = f"refused ({str(e).splitlines()[0][:80]})"
    del w_nn
    n = w.shape[0]
    b_prod = bound(nbytes_of(q, w) + 4 * q.shape[0] * n,
                   2 * q.shape[0] * v_pad * n, PEAK_INT8)
    out = {"t": t, "cap": counter.cap, "count_ms": count_ms,
           "product_ms": tn_ms, "nn_ms": nn_ms, "bound": b_prod}
    print(f"mesh (a) U counter at {t} centroids (capacity {counter.cap}, "
          f"{counter.nbytes} incidence bytes), a window of {len(window)} "
          f"reads: count() {count_ms:.4f} ms (one-hot, product, copy back), "
          f"torch._int_mm alone {tn_ms:.4f} ms on the target-major rows "
          f"(TN), {nn_ms if isinstance(nn_ms, str) else f'{nn_ms:.4f} ms'} "
          f"on a (V, T) row-major copy (NN); bound {b_prod[0]:.4f} ms by "
          f"{b_prod[1]}", flush=True)
    del counter, q, w, prod
    torch.cuda.empty_cache()
    return out


def mesh_stages(udb, qf, dev):
    """MeshRanker at -big 300000 on the ranking workload: the 1x1 mesh of
    the card against a 1x4 mesh whose four shards all live on the card
    (equal lists on every job, or the run fails), the stages of one chunk
    of rows (product, prefix maxima and the SetTopBump mask, top K and the
    merge with NextValue, copies back) each beside its bound, and the
    window's device time with its eight largest entries (torch.profiler).
    Returns the numbers."""
    import numpy as np
    import torch
    from usearch12_tpu_torch import cli
    from usearch12_tpu_torch.commands import load_db
    from usearch12_tpu_torch.io.fastx import read_fastx
    from usearch12_tpu_torch.parallel import incidence as inc
    from usearch12_tpu_torch.parallel.mesh import single_mesh
    from usearch12_tpu_torch.parallel.mesh_search import MeshRanker
    cli.parse_argv(["-usearch_global", qf, "-db", udb, "-id", "0.9",
                    "-strand", "plus", "-quiet", "-big", "300000"])
    _db, index = load_db(udb)
    seqs = [s for _l, s, _q in read_fastx(qf, stream=True)]
    jbuf = np.ascontiguousarray(np.concatenate(seqs))
    j_off = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(x) for x in seqs], out=j_off[1:])
    outs, walls = {}, {}
    for n_db in (1, 4):
        t0 = time.perf_counter()
        ranker = MeshRanker(single_mesh(dev, n_db), index)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        ranker.rank_window(jbuf, j_off)       # warm-up
        t0 = time.perf_counter()
        outs[n_db] = ranker.rank_window(jbuf, j_off)
        walls[n_db] = (t_build, time.perf_counter() - t0)
        if n_db == 1:
            st = ranker_stages(ranker, seqs, jbuf, j_off, dev)
        del ranker
        torch.cuda.empty_cache()
    same = all(np.array_equal(x, y) for x, y in zip(outs[1], outs[4]))
    print(f"mesh (b) MeshRanker, {len(seqs)} queries x {index.seq_count} "
          f"targets: 1x1 incidence built in {walls[1][0]:.2f} s, window "
          f"{walls[1][1]:.3f} s; 1x4 on one card {walls[4][0]:.2f} s, "
          f"{walls[4][1]:.3f} s; lists {'equal' if same else 'DIFFERENT'} "
          f"on every job", flush=True)
    if not same:
        fail("the 1x4 mesh's candidate lists differ from the 1x1 mesh's")
    if outs[1][2].min() <= 0:
        fail("a job of the ranking workload has no candidate on the mesh")
    return {"walls": walls, **st}


def ranker_stages(ranker, seqs, jbuf, j_off, dev):
    import torch
    from usearch12_tpu_torch.parallel import incidence as inc
    rows = min(ranker.chunk_rows, inc.query_rows(len(seqs)))
    words = [ranker.index.params.unique_words(s) for s in seqs[:rows]]
    q = {dev: inc.onehot(words, rows, ranker.v_pad, dev)}
    count_ms, us = cuda_ms(lambda: ranker.count(q, 0), 5)
    pm_ms, _ = cuda_ms(lambda: ranker.keep(us, ranker.prefix_max(us)), 5)
    pms = ranker.prefix_max(us)
    kept = ranker.keep(us, pms)

    def top():
        keys = ranker.top(kept, 0)
        return keys, ranker.next_value(keys, pms)
    top_ms, (keys, nv) = cuda_ms(top, 5)
    copy_ms, _ = cuda_ms(lambda: (keys.cpu(), nv.cpu()), 5)
    T, V = ranker.t_pad, ranker.v_pad
    ub = 4 * rows * T
    b_count = bound(rows * V + T * V + ub, 2 * rows * V * T, PEAK_INT8)
    b_pm = bound(3 * ub, 0)          # U read, the prefix maxima and kept out
    b_top = bound(ub + nbytes_of(keys, nv), 0)
    b_copy = bound(2 * nbytes_of(keys, nv), 0)
    # the window's span on the card's stream (CUDA events), then its
    # kernels by name (torch.profiler)
    span_ms, _ = cuda_ms(lambda: ranker.rank_window(jbuf, j_off), 1,
                         warm=False)
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    with prof:
        ranker.rank_window(jbuf, j_off)
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0.0))
    evs = sorted((e for e in prof.key_averages() if dev_us(e) > 0
                  and not e.key.startswith("aten::")), key=dev_us,
                 reverse=True)
    device_ms = sum(map(dev_us, evs)) / 1000
    top8 = [(e.key[:48], round(dev_us(e) / 1000, 3), e.count)
            for e in evs[:8]]
    chunks = -(-len(seqs) // ranker.chunk_rows)
    print(f"mesh (b) stages, one chunk of {rows} rows x {T} targets: product "
          f"{count_ms:.4f} ms (bound {b_count[0]:.4f} by {b_count[1]}), "
          f"prefix maxima and mask {pm_ms:.4f} ms (bound {b_pm[0]:.4f}), "
          f"top K, merge, NextValue {top_ms:.4f} ms (bound {b_top[0]:.4f}), "
          f"copies back {copy_ms:.4f} ms (bound {b_copy[0]:.6f}); the window "
          f"of {len(seqs)} queries in {chunks} chunks: {span_ms:.3f} ms on "
          f"the card's stream, {device_ms:.3f} ms of kernels in the profile, "
          f"top 8 {top8}", flush=True)
    return {"count_ms": count_ms, "pm_ms": pm_ms, "top_ms": top_ms,
            "copy_ms": copy_ms, "bounds": (b_count, b_pm, b_top, b_copy),
            "span_ms": span_ms, "device_ms": device_ms, "chunks": chunks}


# one process of phase 10's two-process search: its rank, the gloo port,
# the query file, the DB, the spliced output, the -big value
MH_WORKER = """
import sys
import torch.distributed as dist
from usearch12_tpu_torch.cli import parse_argv
from usearch12_tpu_torch.parallel.multihost import (init_multihost,
                                                    multihost_search)
rank, port, qf, db, out, big = sys.argv[1:7]
init_multihost(f"tcp://127.0.0.1:{port}", 2, int(rank))
parse_argv(["-usearch_global", qf, "-db", db, "-id", "0.9", "-strand",
            "plus", "-quiet", "-big", big])
print(multihost_search(qf, db, out), flush=True)
dist.destroy_process_group()
"""


def phase_mesh(d, dev, phase_done):
    """Phase 10 in directory d, after phase 9 (whose workload and host
    blast6 it reuses): (a) cluster_mt -mesh 1 against the host cluster_mt;
    (b) usearch_global -mesh 1 on both sides of -big against the host
    ranker's blast6, and MeshRanker 1x1 against 1x4 on the card; (c) two
    processes on the card through multihost_search; (d) -xprof."""
    import socket
    import torch
    from usearch12_tpu_torch import cli
    from usearch12_tpu_torch.parallel import incidence as inc
    t_phase = time.perf_counter()
    out = {}

    # (a) cluster_mt -mesh 1
    reads = os.path.join(d, "mt_reads.fa")
    t0 = time.perf_counter()
    gen_reads(reads, MESH_READS)
    t_gen = time.perf_counter() - t0
    base = ["-cluster_mt", reads, "-id", "0.97", "-quiet"]
    res = {}
    for tag, extra in (("host", []), ("mesh", ["-mesh", "1"])):
        uc, fa = (os.path.join(d, f"mt_{tag}.{x}") for x in ("uc", "fa"))
        stats = os.path.join(d, "mt_stats.jsonl")
        os.environ["USEARCH_DEVICE_STATS"] = stats
        inc.int8_mm.launches = 0
        try:
            t0 = time.perf_counter()
            rc = cli.main(base + extra + ["-uc", uc, "-centroids", fa])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            os.environ.pop("USEARCH_DEVICE_STATS", None)
        if rc != 0:
            fail(f"cluster_mt {extra} exited {rc}")
        with open(uc, "rb") as f, open(fa, "rb") as g:
            res[tag] = (f.read(), g.read(), wall, inc.int8_mm.launches)
    ds = read_stats(stats)
    same = res["host"][:2] == res["mesh"][:2]
    print(f"mesh (a) cluster_mt, {MESH_READS} reads (bench.py's 100,400 "
          f"cut to {MESH_READS}; written in {t_gen:.1f} s), -id 0.97: host "
          f"{res['host'][2]:.2f} s, -mesh 1 {res['mesh'][2]:.2f} s; "
          f"{ds['centroids']} centroids, capacity {ds['cap']}, "
          f"{ds['incidence_bytes']} incidence bytes, {ds['windows']} "
          f"windows, {ds['flushes']} flushes, {ds['allocs']} allocations, "
          f"count {ds['count_ms'] / max(ds['windows'], 1):.4f} ms of device "
          f"time a window ({ds['count_ms']:.1f} ms in all), int8_mm "
          f"launches {res['mesh'][3]}, host_ranked {ds['host_ranked']}; -uc "
          f"and -centroids {'equal' if same else 'DIFFERENT'}", flush=True)
    if not same or not res["host"][0]:
        fail("cluster_mt -mesh 1 differs from the host cluster_mt")
    if res["mesh"][3] != ds["windows"] or ds["incidence_bytes"] < 1 << 29:
        fail(f"cluster_mt -mesh 1: {res['mesh'][3]} products for "
             f"{ds['windows']} windows, {ds['incidence_bytes']} bytes")
    out["a"] = {"host_s": res["host"][2], "mesh_s": res["mesh"][2], **ds,
                **u_count_stages(reads, os.path.join(d, "mt_mesh.fa"), dev)}
    del res

    # (b) usearch_global -mesh 1 on phase 9's workload
    udb, qf = os.path.join(d, "bigdb.udb"), os.path.join(d, "bigq.fa")
    ub = ["-usearch_global", qf, "-db", udb, "-id", "0.9", "-strand", "plus",
          "-quiet"]
    with open(qf) as f:
        n_q = sum(1 for line in f if line.startswith(">"))
    refs = {}
    for tag, big_opts in (("sorted", ["-big", "300000"]), ("big", [])):
        with open(os.path.join(d, f"rank_{tag}_host.b6"), "rb") as f:
            refs[tag] = f.read()
        b6 = os.path.join(d, f"mesh_{tag}.b6")
        stats = os.path.join(d, "mesh_stats.jsonl")
        os.environ["USEARCH_DEVICE_STATS"] = stats
        inc.int8_mm.launches = 0
        try:
            t0 = time.perf_counter()
            rc = cli.main(ub + big_opts + ["-mesh", "1", "-blast6out", b6])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            os.environ.pop("USEARCH_DEVICE_STATS", None)
        ds = read_stats(stats)
        with open(b6, "rb") as f:
            same = f.read() == refs[tag]
        n = inc.int8_mm.launches
        print(f"mesh (b) usearch_global -mesh 1 {' '.join(big_opts) or ''}"
              f"{'' if big_opts else '(default -big: UDBSearchBig)'}: "
              f"{wall:.2f} s; rank_device_jobs {ds['rank_device_jobs']}, "
              f"rank_host_rerank_jobs {ds['rank_host_rerank_jobs']}, "
              f"int8_mm launches {n}; blast6 "
              f"{'equal' if same else 'DIFFERENT'} to the host ranker's",
              flush=True)
        if rc != 0 or not same or ds["rank_device_jobs"] != n_q:
            fail(f"usearch_global -mesh 1 {big_opts}: blast6 differs or "
                 f"{ds['rank_device_jobs']} jobs on the mesh")
        if (n > 0) != (tag == "sorted"):
            fail(f"usearch_global -mesh 1 {big_opts}: {n} int8 products")
        out[f"b_{tag}_s"] = wall
        torch.cuda.empty_cache()
    out["b"] = mesh_stages(udb, qf, dev)

    # (c) two processes on the card, gloo between them
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    mh = os.path.join(d, "mh.b6")
    t0 = time.perf_counter()
    workers = [subprocess.Popen(
        [sys.executable, "-c", MH_WORKER, str(r), port, qf, udb, mh,
         "300000"], cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        res = [w.communicate(timeout=400) for w in workers]
    finally:
        for w in workers:
            w.kill()
    t_mh = time.perf_counter() - t0
    for w, (so, se) in zip(workers, res):
        if w.returncode != 0:
            fail(f"multihost worker exited {w.returncode}: {se[-2000:]}")
    with open(mh, "rb") as f:
        same = f.read() == refs["sorted"]
    print(f"mesh (c) multihost_search, 2 processes on one card over gloo, "
          f"-big 300000, 220,000 targets: {t_mh:.2f} s; "
          f"{[so.strip().splitlines()[-1] for so, _se in res]}; spliced "
          f"blast6 {'equal' if same else 'DIFFERENT'}", flush=True)
    if not same:
        fail("the two-process spliced blast6 differs from one process's")
    out["c_s"] = t_mh

    # (d) -xprof on the first 200 queries
    q200 = os.path.join(d, "bigq200.fa")
    with open(qf) as f, open(q200, "w") as g:
        g.writelines(f.readlines()[:400])
    xdir = os.path.join(d, "xprof")
    t0 = time.perf_counter()
    rc = cli.main(["-usearch_global", q200, "-db", udb, "-id", "0.9",
                   "-strand", "plus", "-quiet", "-mesh", "1", "-blast6out",
                   os.path.join(d, "x.b6"), "-xprof", xdir])
    t_x = time.perf_counter() - t0
    traces = os.listdir(xdir) if os.path.isdir(xdir) else []
    n_kernels = 0
    if rc == 0 and len(traces) == 1:
        with open(os.path.join(xdir, traces[0])) as f:
            ev = json.load(f)["traceEvents"]
        n_kernels = sum(1 for e in ev if e.get("cat") == "kernel")
    print(f"mesh (d) -xprof: 200 queries, {t_x:.2f} s, trace {traces}, "
          f"{n_kernels} CUDA kernel events", flush=True)
    if rc != 0 or n_kernels == 0:
        fail("-xprof wrote no trace with CUDA kernel events")
    phase_done(10, t_phase)
    return out


def main():
    if not os.path.isdir(os.path.join(HERE, "usearch12_tpu_torch")):
        fail("run from a checkout of the repository (no "
             "usearch12_tpu_torch/ beside this script)")
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    import numpy as np
    from usearch12_tpu_torch import _build, cli
    against = None
    if "--against" in sys.argv[1:]:
        k = sys.argv.index("--against")
        if k + 1 >= len(sys.argv):
            fail("--against needs a directory")
        against = sys.argv[k + 1]
    from usearch12_tpu_torch.device import card_info, resolve_device
    from usearch12_tpu_torch.ops import banded_nw as bn
    from usearch12_tpu_torch.ops import wavefront_nw as wnw
    from usearch12_tpu_torch.ops import wavefront_trace as wtr

    t_start = time.perf_counter()

    def phase_done(n, t0):
        print(f"phase {n}: {time.perf_counter() - t0:.1f} s (run "
              f"{time.perf_counter() - t_start:.1f} s)", flush=True)

    # 1. device
    dev = resolve_device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = card_info(0)
    print(f"device: {kind}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(smi, flush=True)
    phase_done(1, t_start)

    # 2. build
    cached = _build.library_path().exists()
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {_build.library_path().name} "
          f"{'reused' if cached else 'built'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    other = None if against is None else load_other(against)
    phase_done(2, t0)

    # 3. kernels against their plain versions
    t_phase = time.perf_counter()
    ap = wnw.nucleo_params(-10.0, -1.0, -0.5, -0.5)     # the defaults
    ap_nd = wnw.nucleo_params(-10.3, -1.1, -0.7, -0.4)  # non-dyadic
    rng = np.random.default_rng(7)
    pairs_a = kernel_pairs(rng, 65536, 250)
    shape_a = check_kernels("(a) 250nt", pairs_a, 16, ap, dev, 5, other)
    big = check_kernels("(b) 3kb", kernel_pairs(rng, 512, 3000, indel=40),
                        120, ap_nd, dev, 3, other)
    check_kernels("(c) 1.5kb band 601", kernel_pairs(rng, 64, 1500), 300,
                  ap_nd, dev, 3, other)
    check_kernels("(d) 4kb band 2047", widest_band_pairs(rng, 16, 4000),
                  1015, ap_nd, dev, 3, other)
    # one launch of 600-nt pairs on each side of the trace kernels' crossing
    for tag, n in (("(e) 600nt warp side", wtr.WARP_MAX_LOAD // 2),
                   ("(f) 600nt thread side", 2 * wtr.WARP_MAX_LOAD)):
        check_kernels(tag, kernel_pairs(rng, n, 600), 60, ap, dev, 3)
    phase_done(3, t_phase)

    # 4. the device oracle: its kernels against their plain versions, then
    # BandedNWDevice judging the hole DP kernels on every pair of shape (a)
    t_phase = time.perf_counter()
    other_bnw = None if other is None else other["banded"]
    orc = check_banded("250nt", pairs_a, 16, ap, dev, 5, other_bnw)
    pairs_kb = balanced_indel_pairs(np.random.default_rng(8), 2048, 1000)
    orc_wide = check_banded("1kb", pairs_kb, 62, ap_nd, dev, 3, other_bnw)
    bn.banded_nw_fwd.launches = 0
    bn.banded_nw_chase.launches = 0
    t0 = time.perf_counter()
    s_orc, p_orc = bn.BandedNWDevice(ap, dev).align_device(pairs_a, 16)
    torch.cuda.synchronize()
    t_orc = time.perf_counter() - t0
    orc_launches = {"banded_nw_fwd": bn.banded_nw_fwd.launches,
                    "banded_nw_chase": bn.banded_nw_chase.launches}
    t0 = time.perf_counter()
    s_wave, p_wave = wnw.TorchWaveAligner(ap, dev).align(pairs_a, 16)
    t_wave = time.perf_counter() - t0
    n_diff = int(sum(1 for k in range(len(pairs_a))
                     if s_orc[k] != s_wave[k] or p_orc[k] != p_wave[k]))
    print(f"oracle judge: {len(pairs_a)} pairs of 250 nt; "
          f"BandedNWDevice.align_device {t_orc:.2f} s, "
          f"TorchWaveAligner.align {t_wave:.2f} s; launches {orc_launches}; "
          f"{n_diff} pairs differ; phase {time.perf_counter() - t_phase:.1f}"
          " s", flush=True)
    if n_diff:
        fail(f"BandedNWDevice and TorchWaveAligner differ on {n_diff} pairs")
    if min(orc_launches.values()) <= 0:
        fail(f"a kernel was not launched on the oracle path: {orc_launches}")
    del pairs_a, s_orc, p_orc, s_wave, p_wave
    # a second judge: the 2,048 pairs of 1 kb, radius 62, non-dyadic
    t0 = time.perf_counter()
    s_orc, p_orc = bn.BandedNWDevice(ap_nd, dev).align_device(pairs_kb, 62)
    torch.cuda.synchronize()
    t_orc = time.perf_counter() - t0
    t0 = time.perf_counter()
    s_wave, p_wave = wnw.TorchWaveAligner(ap_nd, dev).align(pairs_kb, 62)
    t_wave = time.perf_counter() - t0
    n_diff = int(sum(1 for k in range(len(pairs_kb))
                     if s_orc[k] != s_wave[k] or p_orc[k] != p_wave[k]))
    print(f"oracle judge: {len(pairs_kb)} pairs of 1 kb, radius 62, "
          f"non-dyadic penalties; BandedNWDevice.align_device {t_orc:.2f} s, "
          f"TorchWaveAligner.align {t_wave:.2f} s; {n_diff} pairs differ; "
          f"phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    if n_diff:
        fail(f"BandedNWDevice and TorchWaveAligner differ on {n_diff} pairs "
             "of 1 kb")
    del pairs_kb, s_orc, p_orc, s_wave, p_wave
    phase_done(4, t_phase)

    # 5. the slice: usearch_global on the long-contig workload, on the
    # card against the port's host C path
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        qf, tf = os.path.join(d, "lq.fa"), os.path.join(d, "lt.fa")
        gen_longseq(qf, tf)
        ref_b6, port_b6 = os.path.join(d, "ref.b6"), os.path.join(d,
                                                                 "port.b6")
        stats = os.path.join(d, "stats.jsonl")
        args = ["-usearch_global", qf, "-db", tf] + COMMON
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "usearch12_tpu_torch.cli"]
                           + args + ["-no_engine_device", "-blast6out",
                                     ref_b6],
                           cwd=HERE, capture_output=True, text=True,
                           timeout=900)
        t_host = time.perf_counter() - t0
        if r.returncode != 0:
            fail(f"host judge exited {r.returncode}: {r.stderr[-2000:]}")
        with open(ref_b6, "rb") as f:
            ref = f.read()
        # the defaults (the cost model's gate, from its cold-start
        # constants: a cache file of its own in this directory)
        from usearch12_tpu_torch.engine import batch as engine_batch
        auto_b6, auto_stats = (os.path.join(d, x) for x in ("auto.b6",
                                                             "auto.jsonl"))
        cache = engine_batch.DevicePerfModel.CACHE
        engine_batch.DevicePerfModel.CACHE = os.path.join(d, "perf.json")
        os.environ["USEARCH_DEVICE_STATS"] = auto_stats
        try:
            t0 = time.perf_counter()
            rc = cli.main(args + ["-blast6out", auto_b6])
            torch.cuda.synchronize()
            t_auto = time.perf_counter() - t0
        finally:
            engine_batch.DevicePerfModel.CACHE = cache
        with open(auto_b6, "rb") as f:
            auto = f.read()
        with open(auto_stats) as f:
            ds_auto = json.loads(f.read().splitlines()[-1])
        print(f"slice, default gate (cold constants): {t_auto:.2f} s; "
              f"device_cells {ds_auto['device_cells']}, host_cells "
              f"{ds_auto['host_cells']}, dispatches {ds_auto['dispatches']}; "
              f"blast6 {'equal' if auto == ref else 'DIFFERENT'}",
              flush=True)
        if rc != 0 or auto != ref:
            fail("the slice with the default gate differs from the host path")
        os.environ["USEARCH_DEVICE_STATS"] = stats
        # record each launch's inputs (as pack_launch makes them, with the
        # aligner's gap penalties) and the aligner's host time, without a
        # launch of their own
        pack, align = wnw.pack_launch, wnw.TorchWaveAligner.align
        seen, align_s, cur = [], [0.0], []

        def capture(*a, **k):
            w = pack(*a, **k)
            seen.append(tuple(w) + (cur[-1].gp, cur[-1].match,
                                    cur[-1].mismatch))
            return w

        def timed_align(self, *a, **k):
            cur.append(self)
            t = time.perf_counter()
            out = align(self, *a, **k)
            align_s[0] += time.perf_counter() - t
            return out

        wnw.pack_launch, wnw.TorchWaveAligner.align = capture, timed_align
        wnw.wavefront_fwd.launches = 0
        wtr.wavefront_trace.launches = 0
        try:
            t0 = time.perf_counter()
            rc = cli.main(args + ["-dev_batch_cells", "1", "-blast6out",
                                  port_b6])
            torch.cuda.synchronize()
            t_port = time.perf_counter() - t0
        finally:
            wnw.pack_launch, wnw.TorchWaveAligner.align = pack, align
        launches = {"wavefront_fwd": wnw.wavefront_fwd.launches,
                    "wavefront_trace": wtr.wavefront_trace.launches}
        del os.environ["USEARCH_DEVICE_STATS"]
        if rc != 0:
            fail(f"usearch12_tpu_torch.cli exited {rc}")
        with open(port_b6, "rb") as f:
            port = f.read()
        with open(stats) as f:
            ds = json.loads(f.read().splitlines()[-1])
        n_hits = ref.count(b"\n")
        print(f"slice: 32 x 32 contigs of 24,150 nt; host C path "
              f"{t_host:.2f} s, card {t_port:.2f} s (TorchWaveAligner.align "
              f"{align_s[0]:.2f} s); device_cells "
              f"{ds['device_cells']}, host_cells {ds['host_cells']}, "
              f"dispatches {ds['dispatches']}; launches {launches}; pairs "
              f"per launch {[int(a[2].numel()) for a in seen]}; "
              f"{n_hits} hits, blast6 "
              f"{'equal' if ref == port else 'DIFFERENT'}", flush=True)
        if ref != port or n_hits == 0:
            fail("blast6 on the card differs from the host C path")
        if ds["device_cells"] != 5532965001:
            fail(f"device_cells {ds['device_cells']}, not 5,532,965,001")
        if min(launches.values()) <= 0:
            fail(f"a kernel was not launched on the main path: {launches}")
    time_slice_launches(seen, other)
    if other is not None:
        compare_fwd("slice launches", seen, other["fwd"])
    dev_rate = ds["device_cells"] / align_s[0]
    del seen
    torch.cuda.empty_cache()
    phase_done(5, t_phase)

    with tempfile.TemporaryDirectory() as d:
        sx, sx_launches = phase_sintax(
            d, dev, phase_done, None if other is None else other["hist"])

    # 8. the cost model's cold-start constants on this card
    t_phase = time.perf_counter()
    perf_constants(dev, ap, dev_rate)
    phase_done(8, t_phase)

    # 9. usearch_global's ranking on the card
    with tempfile.TemporaryDirectory() as d:
        phase_rank(d, dev, phase_done)
        # 10. the mesh paths, on phase 9's files
        phase_mesh(d, dev, phase_done)

    def row(name, source, replaces, n, err, ms, plain_ms, bnd,
            library_ms=None, kernel_ms=None):
        return {"name": name, "route": "cuda",
                "source": f"usearch12_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": n, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": library_ms,
                "kernel_ms": kernel_ms}

    print(json.dumps({"kernels": [
        row("wavefront_fwd", "wavefront_fwd.cu",
            "usearch12_tpu/ops/wavefront_nw.py:257",
            launches["wavefront_fwd"], max(big["fwd_err"],
                                           shape_a["fwd_err"]),
            big["fwd_ms"], big["fwd_plain_ms"], big["fwd_bound"]),
        row("wavefront_trace", "wavefront_trace.cu",
            "usearch12_tpu/ops/wavefront_trace.py:54",
            launches["wavefront_trace"], big["trace_err"], big["trace_ms"],
            big["trace_plain_ms"], big["trace_bound"]),
        row("banded_nw_fwd", "banded_nw.cu",
            "usearch12_tpu/ops/banded_nw.py:122",
            orc_launches["banded_nw_fwd"],
            max(orc["fwd_err"], orc_wide["fwd_err"]), orc["fwd_ms"],
            orc["fwd_plain_ms"], orc["fwd_bound"],
            kernel_ms=orc["fwd_kernel_ms"]),
        row("banded_nw_chase", "banded_nw.cu",
            "usearch12_tpu/ops/banded_nw.py:569",
            orc_launches["banded_nw_chase"],
            max(orc["chase_err"], orc_wide["chase_err"]), orc["chase_ms"],
            orc["chase_plain_ms"], orc["chase_bound"],
            kernel_ms=orc["chase_kernel_ms"]),
        row("sintax_pick_hist", "sintax_boot.cu",
            "usearch12_tpu/amplicon/sintax_device.py:132",
            sx_launches["sintax_pick_hist"], sx["hist_err"], sx["hist_ms"],
            sx["hist_plain_ms"], sx["hist_bound"], sx["hist_lib_ms"],
            sx["hist_kernel_ms"]),
        row("sintax_boot_count_select", "sintax_boot.cu",
            "usearch12_tpu/amplicon/sintax_device.py:143",
            sx_launches["sintax_boot_count_select"], sx["select_err"],
            sx["sel_ms"], sx["sel_plain_ms"], sx["sel_bound"])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
