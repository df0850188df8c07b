"""Batch search engine on the card.

TorchBatchEngine is the JAX package's BatchEngine (host C parse, rank,
HSP chaining, accept/terminate replay, emit) with its device layer
replaced: the holes between chained HSPs are aligned by TorchWaveAligner
(ops/wavefront_nw.py) on the torch.device given to the constructor.

The device is passed eagerly and is never dropped.  The JAX engine's
deferred device factory (whose failures it swallows), its resident
device server and its per-window device-loss fallback have no
counterpart here.  Holes whose band is wider than BW_DEV_MAX, and
batches the dispatch gate keeps on the host, run in the host C kernel
as in the JAX engine, and the cells of each are counted in dev_stats.
With -no_engine_device every hole runs in the host C kernel, as the JAX
package does when its device factory returns no device.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from usearch12_tpu.config import options
from usearch12_tpu.engine.batch import BatchEngine, DevicePerfModel

from ..ops.wavefront_nw import BW_MAX, TorchWaveAligner


class CudaPerfModel(DevicePerfModel):
    """The JAX engine's host-versus-device cost model, keyed "cuda" and
    kept in its own file, so that it never reads or writes the TPU's
    learned constants."""

    CACHE = os.path.join(tempfile.gettempdir(),
                         "usearch12_tpu_torch_perf.json")


class TorchBatchEngine(BatchEngine):
    """Window-batched global search whose hole DP runs on `device`."""

    # widest hole band the forward kernel takes (one thread per lane)
    BW_DEV_MAX = BW_MAX

    def __init__(self, cmd: str, db, index=None, *, device: torch.device):
        super().__init__(cmd, db, index=index)
        o = options()
        self.device = device
        self.holes_on_host = o.flag("no_engine_device")
        self._factory_tried = True
        self.dev_min_cells = int(o.str("dev_min_cells")) \
            if o.filled("dev_min_cells") else 2048
        self.perf = CudaPerfModel(device.type) \
            if device.type == "cuda" else None
        self._class_aps: Dict[int, object] = {}

    def _ensure_device_async(self) -> None:
        raise RuntimeError("TorchBatchEngine takes its device in the "
                           "constructor; it has no deferred device factory")

    def _class_device(self, cls_bits: int):
        """AlnParams of a hole's terminal-penalty class."""
        ap = self._class_aps.get(cls_bits)
        if ap is None:
            ap = self.ap.hole_params(bool(cls_bits & 1), bool(cls_bits & 2),
                                     bool(cls_bits & 4), bool(cls_bits & 8))
            self._class_aps[cls_bits] = ap
        return ap

    def _class_fused_aligner(self, cls_bits: int) -> TorchWaveAligner:
        fa = self._class_fused.get(cls_bits)
        if fa is None:
            fa = TorchWaveAligner(self._class_device(cls_bits), self.device)
            self._class_fused[cls_bits] = fa
        return fa

    def _align_holes(self, sc, jbuf, n_hole: int):
        """Align the round's holes: device per terminal class, host C for
        bands wider than BW_DEV_MAX or when the gate says host.  Returns
        (hole_paths bytes, hole_off int64) like BatchEngine's."""
        if n_hole == 0:
            return np.zeros(1, np.uint8), np.zeros(1, np.int64)
        cls = sc.hole_cls[:n_hole]
        aoff = sc.hole_aoff[:n_hole]
        boff = sc.hole_boff[:n_hole]
        alen = sc.hole_alen[:n_hole]
        blen = sc.hole_blen[:n_hole]
        r = self.ah.band_radius
        cells = np.minimum(alen, blen).astype(np.int64) * (2 * r + 1)
        total_cells = int(cells.sum())
        # the cost model's transfer estimate, as in BatchEngine
        seq_len = alen.astype(np.int64) + blen
        up_bytes = int(seq_len.sum()) * 2
        dn_bytes = int(seq_len.sum()) // 4 + 4 * n_hole
        dev_ok = np.abs(alen.astype(np.int64) - blen) + 2 * r + 1 \
            <= self.BW_DEV_MAX
        use_device = False
        if self.ap.nucleo and dev_ok.any() and not self.holes_on_host:
            if self.dev_batch_min_cells is not None:
                use_device = total_cells >= self.dev_batch_min_cells
            elif self.perf is not None:
                use_device = self.perf.device_wins(
                    total_cells, up_bytes, dn_bytes,
                    max(1, 2 * self._windows_left)) \
                    or self.perf.should_probe(total_cells)
        host = np.nonzero(~dev_ok if use_device else
                          np.ones(n_hole, bool))[0]
        paths: List[Optional[bytes]] = [None] * n_hole
        if len(host):
            t0 = time.perf_counter()
            out, off = self._align_holes_host(
                sc, jbuf, len(host), aoff[host], boff[host], alen[host],
                blen[host], cls[host])
            dt = time.perf_counter() - t0
            ob = out.tobytes()
            for k, h in enumerate(host):
                paths[h] = ob[off[k]:off[k + 1]]
            host_cells = int(cells[host].sum())
            with self._lock:
                if self.perf is not None:
                    self.perf.observe_host(host_cells, dt)
                self.dev_stats["host_cells"] += host_cells
        if use_device:
            db = self._db_concat
            dev_cells = int(cells[dev_ok].sum())
            with self._lock:
                t0 = time.perf_counter()
                for c in np.unique(cls[dev_ok]):
                    idx = np.nonzero((cls == c) & dev_ok)[0]
                    pairs = [(jbuf[aoff[h]:aoff[h] + alen[h]],
                              db[boff[h]:boff[h] + blen[h]]) for h in idx]
                    _scores, ps = self._class_fused_aligner(int(c)).align(
                        pairs, r, nucleo=True)
                    for k, h in enumerate(idx):
                        paths[h] = ps[k].encode("ascii")
                if self.perf is not None:
                    dev_seq = int(seq_len[dev_ok].sum())
                    self.perf.observe_dev(
                        dev_cells, 2 * dev_seq,
                        dev_seq // 4 + 4 * int(dev_ok.sum()),
                        time.perf_counter() - t0)
                self.dev_stats["dispatches"] += 1
                self.dev_stats["device_cells"] += dev_cells
        hole_off = np.zeros(n_hole + 1, np.int64)
        np.cumsum([len(p) for p in paths], out=hole_off[1:])
        return np.frombuffer(b"".join(paths), dtype=np.uint8), hole_off
