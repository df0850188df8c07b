"""The -mesh option: a grid of torch devices with the axes "data" (query
rows) and "db" (target shards), the counterpart of the JAX package's
jax.sharding.Mesh.

On the card every entry is a CUDA device of this process, and a shape
needs that many cards.  When the caller passes the CPU, any shape is
accepted and every entry is the CPU: the shards and the row blocks are
then CPU tensors, as the tests run them, and "auto" means 1.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

AXES = ("data", "db")


class Mesh:
    """(n_data, n_db) torch devices; `shape` maps each axis name to its
    size, as jax's Mesh.shape does."""

    def __init__(self, devices: Sequence[Sequence[torch.device]],
                 axis_names=AXES) -> None:
        grid = np.empty((len(devices), len(devices[0])), dtype=object)
        for i, row in enumerate(devices):
            for j, dev in enumerate(row):
                grid[i, j] = torch.device(dev)
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, grid.shape))

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"{[[str(d) for d in row] for row in self.devices]})")


def make_mesh(spec: str, device: DeviceLike = None) -> Mesh:
    """Mesh from a -mesh value: "DATAxDB" (e.g. "2x4"), a device count
    (factored db-major), or "auto" (every device: every card, or 1 on the
    CPU).  The parsing and its SystemExit texts are those of the JAX
    package's commands._mesh (usearch12_tpu/commands.py:195-248)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        devs = None
        n_avail = 1
    else:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        n_avail = len(devs)
    if "x" in spec:
        try:
            n_data, n_db = (int(x) for x in spec.split("x"))
        except ValueError:
            raise SystemExit(f"-mesh {spec}: expected DATAxDB, a device "
                             "count, or auto")
    else:
        if spec == "auto":
            n = n_avail
        else:
            try:
                n = int(spec)
            except ValueError:
                raise SystemExit(f"-mesh {spec}: expected DATAxDB, a "
                                 "device count, or auto")
        n_db = 1
        for cand in (2, 4, 8):
            if n % cand == 0:
                n_db = cand
        if n // n_db == 1 and n_db >= 4:
            n_db //= 2
        n_data = max(1, n // n_db)
    need = n_data * n_db
    if devs is None:
        return Mesh([[dev] * n_db for _ in range(n_data)])
    if len(devs) < need:
        raise SystemExit(f"-mesh {spec}: needs {need} devices, have "
                         f"{len(devs)}")
    return Mesh([devs[i * n_db:(i + 1) * n_db] for i in range(n_data)])


def single_mesh(device: torch.device, n_db: int = 1,
                n_data: int = 1) -> Mesh:
    """An (n_data, n_db) mesh whose entries are all `device` (one card
    holding every shard, or the CPU)."""
    return Mesh([[device] * n_db for _ in range(n_data)])

