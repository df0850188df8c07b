"""SINTAX's bootstraps on the card.

TorchBootEngine holds the (V, T) int8 word-incidence matrix on the
device and runs one chunk of jobs at a time through
ops/sintax_boot.py:boot_step.  SintaxTorchClassifier is the JAX
package's SintaxDeviceClassifier with that engine in place of the jax
BootEngine: the host side (jobs and unique words per strand, pow2
buckets, the tie-break draws from the global RNG in job order, chunks of
128 jobs, tally and strand vote) is the reference's own code, so its
classify_window equals SintaxClassifier.classify_window tuple for tuple.
The resident-server branch and the jax cache setup of the JAX class are
not used (use_server=False).
"""

from __future__ import annotations

import numpy as np
import torch

from usearch12_tpu.amplicon.sintax import SintaxClassifier
from usearch12_tpu.amplicon.sintax_device import SintaxDeviceClassifier

from ..device import DeviceLike
from ..ops.sintax_boot import boot_step


class TorchBootEngine:
    """The word-incidence matrix of a DB on `device` and the boot step.

    v word slots, t targets, the CSR postings (sizes (v,), postings
    (nnz,) target indices) and the number of boots.  The matrix is built
    on the device by an accumulating scatter, so a target posted twice
    under one word counts twice (int8, as the JAX package's build at
    sintax_device.py:69-74)."""

    def __init__(self, v: int, t: int, sizes: np.ndarray,
                 postings: np.ndarray, boots: int,
                 device: torch.device) -> None:
        self.t = t
        self.B = boots
        self.device = device
        nnz = int(sizes.sum())
        self.w_mat = torch.zeros((v, max(t, 1)), dtype=torch.int8,
                                 device=device)
        if t and nnz:
            sizes_d = torch.from_numpy(sizes.astype(np.int64)).to(device)
            words = torch.repeat_interleave(
                torch.arange(v, device=device), sizes_d, output_size=nnz)
            posts = torch.from_numpy(postings.astype(np.int64)).to(device)
            self.w_mat.index_put_(
                (words, posts),
                torch.ones(1, dtype=torch.int8, device=device).expand(nnz),
                accumulate=True)
        self.inc_absmax = max(int(self.w_mat.max()), -int(self.w_mat.min()))

    def run_chunk(self, words, nuw, m, stream, rr):
        """(cq, uwmax) words -> (winners, tops) numpy (cq, B) int32, the
        contract of the JAX package's BootEngine.run_chunk.  stream and rr
        are uint32 numpy arrays."""
        def up(x):
            return torch.from_numpy(
                np.ascontiguousarray(x).view(np.int32)).to(self.device)

        winner, top = boot_step(
            up(np.asarray(words, np.int32)), up(np.asarray(nuw, np.int32)),
            up(np.asarray(m, np.int32)), up(np.asarray(stream, np.uint32)),
            up(np.asarray(rr, np.uint32)), self.w_mat, self.B,
            self.inc_absmax)
        return winner.cpu().numpy(), top.cpu().numpy()


class SintaxTorchClassifier(SintaxDeviceClassifier):
    """classify_window with the boots on `device` (the CPU runs the
    kernels' plain versions)."""

    def __init__(self, cls: SintaxClassifier, device: DeviceLike,
                 chunk_q: int = 128) -> None:
        self.device = torch.device(device)
        super().__init__(cls, chunk_q=chunk_q, use_server=False)

    def _make_local_engine(self) -> None:
        index = self.index
        self._engine = TorchBootEngine(self._v, self.t,
                                       np.asarray(index.sizes),
                                       np.asarray(index.postings),
                                       int(self.cls.boots), self.device)
