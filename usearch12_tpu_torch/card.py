"""Where the card's work runs: a LocalCard (a torch.device in this
process) or a ServerCard (the resident server, device_server.py).  Both
have `type` ("cuda" or "cpu"), `warm` (the first dispatch's tax is paid
already), `remote` (the USEARCH_DEVICE_STATS line's "server") and three
factories, which return the engine that the in-process route builds or a
proxy of the server's copy of it, so that no consumer learns the route:

- aligner(ap, cls_bits): ops/wavefront_nw.py's TorchWaveAligner of one
  terminal-penalty class, align(pairs, band_radius, nucleo);
- csr_chunks(index, arrays, topk, bump, big): the CSR ranker's device
  half, ops/csr_rank.py's CSRChunks, run_chunk(qw, cap, stats=, trace=,
  seq=);
- boot_engine(index, incidence, boots): amplicon/sintax_device.py's
  TorchBootEngine, run_chunk(words, nuw, m, stream, rr, timer), timer(on)
  and launches.

arrays() and incidence() give the engine's arrays; the server route calls
them only where the server holds no engine of the DB's signature yet.
Through the server an engine's spans and counters stay in its process.
open_card() takes a command's routing decision, warm_server() the
automatic gates'.  This module imports no torch: a LocalCard does.
"""

from __future__ import annotations

import hashlib
import pickle
import sys

from . import device_server as ds
from .config import options


class _Card:
    """The three factories; a route makes each engine in _engine."""

    def aligner(self, ap, cls_bits: int):
        return self._engine(
            "aligner",
            lambda: (hashlib.sha1(pickle.dumps(ap)).hexdigest(), cls_bits),
            lambda: (ap, cls_bits))

    def csr_chunks(self, index, arrays, topk: int, bump: int, big: bool):
        return self._engine(
            "csr_chunks",
            lambda: ds.db_signature(index, "csr", topk, bump, big),
            lambda: (index.seq_count, *arrays(), topk, bump, big))

    def boot_engine(self, index, incidence, boots: int):
        return self._engine(
            "boot_engine", lambda: ds.db_signature(index, "sintax", boots),
            lambda: (*incidence(), boots))


class LocalCard(_Card):
    """The card of this process: a torch.device (the CPU runs the kernels'
    plain versions)."""

    remote = False
    warm = False

    def __init__(self, device) -> None:
        import torch
        self.device = torch.device(device)
        self.type = self.device.type

    def _engine(self, kind: str, sig, load):
        return self.build(kind, *load())

    def build(self, kind: str, *args):
        """The engine of `kind` on this card from its load's values (the
        server's loads come here too)."""
        if kind == "aligner":
            from .ops.wavefront_nw import TorchWaveAligner
            ap, cls_bits = args
            return TorchWaveAligner(ap.hole_params(
                *(bool(cls_bits & b) for b in (1, 2, 4, 8))), self.device)
        if kind == "csr_chunks":
            from .ops.csr_rank import CSRChunks
            return CSRChunks(*args, self.device)
        from .amplicon.sintax_device import TorchBootEngine
        return TorchBootEngine(*args, self.device)


class ServerCard(_Card):
    """The resident server's card: each engine is a proxy of the one the
    server holds for its signature, loaded there from this process when
    the server answers need_load.  A failure of the server raises."""

    remote = True

    def __init__(self, client: ds.DeviceServerClient) -> None:
        self.client = client
        self.type = client.info["device"].split(":")[0]

    @property
    def warm(self) -> bool:
        """The server has aligned before: its kernels are loaded, so this
        process pays no first dispatch's tax (DevicePerfModel.warm_tax is
        a server's cost, not a process's)."""
        return bool(self.client.info["served"]["align"])

    def _engine(self, kind: str, sig, load):
        return _Held(self.client, kind, sig(), load)


class _Held:
    """An engine the server holds under (kind, sig): each of the
    engines' calls runs the kind's method there (device_server.KINDS)."""

    # the CSR ranker's chunks: chunk_b's, whatever the server's route
    whole_windows = False
    launches = 0

    def __init__(self, client, kind: str, sig, load) -> None:
        self.client, self.kind, self.sig, self.load = client, kind, sig, load

    def _run(self, *args):
        return self.client.run(self.kind, self.sig, args, self.load)

    def align(self, pairs, band_radius: int, nucleo: bool = True):
        return self._run(pairs, band_radius, nucleo)

    def run_chunk(self, *args, stats=None, trace=False, seq=None):
        return self._run(*args)

    def timer(self, on: bool):
        return None


def as_card(device):
    """A card as it is; a torch.device (or its name) as its LocalCard."""
    return device if isinstance(device, _Card) else LocalCard(device)


def open_card(device=None):
    """The card of a command's work: `device` in this process when the
    caller passed one; else the resident server, live or spawned, so that
    this process imports no torch; else the card in this process
    (resolve_device, which raises where there is none), after one line on
    stderr saying why the server is not used.  -xprof traces this process,
    so its work stays here."""
    from .device import resolve_device
    if device is not None:
        return LocalCard(resolve_device(device))
    if options().filled("xprof"):
        why = "-xprof traces this process"
    else:
        client, why = ds.connect(spawn=True)
        if client is not None:
            return ServerCard(client)
    print(f"usearch12_tpu_torch: not using the device server ({why}); "
          "the card's work runs in this process", file=sys.stderr)
    return LocalCard(resolve_device(None))


def warm_server():
    """The ServerCard of a live server of this code, asked with a ping
    before anything imports torch (none is spawned), or None."""
    client = ds.get_client(spawn=False)
    return None if client is None else ServerCard(client)
