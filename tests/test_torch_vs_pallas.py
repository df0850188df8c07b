"""usearch12_tpu_torch's kernels against the JAX package's Pallas kernels
on the same pairs: the forward kernel (ops/wavefront_nw.py:_make_kernel,
through WavefrontNWDevice.run_batch) and the traceback kernel
(ops/wavefront_trace.py:_make_chase_kernel, through trace_batch_chase),
both in interpret mode on the CPU.  The port runs its plain PyTorch
versions.  One tiny case: interpreting the Pallas kernels is slow."""

import numpy as np
import torch

from usearch12_tpu.align.oracle import band_diag_range
from usearch12_tpu.ops.wavefront_nw import WavefrontNWDevice, pack_wave
from usearch12_tpu.ops.wavefront_trace import trace_batch_chase
from usearch12_tpu_torch.ops import wavefront_nw as wnw
from usearch12_tpu_torch.ops import wavefront_trace as wtr

RADIUS = 16


def test_port_matches_pallas_kernels():
    ap = wnw.nucleo_params(-10.0, -1.0, -0.5, -0.5)
    rng = np.random.default_rng(9)
    conv = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for _ in range(6):
        la = int(rng.integers(16, 44))
        lb = int(np.clip(la + rng.integers(-12, 13), 16, 56))
        a, b = rng.integers(0, 4, la), rng.integers(0, 4, lb)
        m = min(la, lb)
        b[:m] = a[:m]
        b[rng.integers(0, m, m // 10)] = rng.integers(0, 4, m // 10)
        pairs.append((conv[a], conv[b]))
    dev = WavefrontNWDevice(ap, pb=8, chunk=32)
    gp = wnw.gap_params(ap)
    cpu = torch.device("cpu")
    for rho0 in (0, 1):
        grp = [p for p in pairs if (len(p[0]) - band_diag_range(
            len(p[0]), len(p[1]), RADIUS)[0]) % 2 == rho0]
        if not grp:
            continue
        # JAX: Pallas forward kernel, then the Pallas chase kernel
        batch = pack_wave(grp, True, RADIUS, dev.chunk, rho0)
        tb_j, mle, mlo, dlb_j = dev.run_batch(batch)
        s_jax, p_jax = trace_batch_chase(dev, batch, tb_j, mle, mlo, dlb_j)
        # port: the same pairs through wavefront_fwd and wavefront_trace
        w = wnw.pack_launch(grp, *wnw.pair_geometry(grp, RADIUS), cpu)
        tb, mlast, dlb = wnw.wavefront_fwd(*w, gp, dev.match, dev.mismatch)
        tb = tb.numpy()
        SW = batch.sw
        for p in range(len(grp)):
            la, lb = int(batch.la[p]), int(batch.lb[p])
            q, g = divmod(p, batch.gpv)
            assert np.array_equal(mlast[p, :lb].numpy(),
                                  dev._mlast_row(batch, mle[q], mlo[q], p))
            t_fin = la - 1 + lb
            u_f = (lb + 1 - int(batch.dlo[p]) - (rho0 + t_fin) % 2) // 2
            fin_d = dlb_j[q, g * SW + u_f] if u_f < SW else np.float32(
                wnw.NEG)
            assert dlb[p].item() == fin_d
            nlane = (int(batch.bw[p]) + 1) // 2
            nb = (nlane + 1) // 2
            for t in range(la + lb):
                for u in range(nlane):
                    mine = (tb[int(w.tb_off[p]) + t * nb + u // 2]
                            >> (4 * (u % 2))) & 15
                    theirs = (int(tb_j[q, t // 8, g * SW + u])
                              >> (4 * (t % 8))) & 15
                    assert mine == theirs, (p, t, u)
        scores, ops, lens = wtr.wavefront_trace(
            torch.from_numpy(tb), w.tb_off, mlast, dlb, w.la, w.lb, w.dlo,
            w.bw, gp)
        assert np.array_equal(scores.numpy(), s_jax)
        assert wtr.decode_ops(ops.numpy(), lens.numpy()) == p_jax
        s_al, p_al = wnw.TorchWaveAligner(ap, cpu).align(grp, RADIUS)
        assert np.array_equal(s_al, s_jax) and p_al == p_jax
