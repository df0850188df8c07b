"""usearch_global across processes: torch.distributed and queries striped
over the processes.

Port of usearch12_tpu/parallel/multihost.py.  In the JAX package's
host-major mesh the "data" axis spans the processes and carries no
collective inside the ranking step, so here each process ranks and aligns
its own stripe of the queries on its own device (the counterpart of
MeshRanker.rank_window_spmd), writes its blast6 records to OUT.partRANK,
and the processes meet at a barrier (gloo) before process 0 splices the
stripes in order: the bytes equal a single-process run over the whole
query file.  Gloo runs on the CPU and when several processes share one
card (NCCL takes one rank a card).

    init_multihost()    # MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK
    parse_argv([...]); multihost_search(q_fa, db, out)
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..device import DeviceLike, resolve_device
from .mesh import Mesh, single_mesh


def _rank_size():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_multihost(init_method: Optional[str] = None,
                   world_size: Optional[int] = None,
                   rank: Optional[int] = None) -> None:
    """Join the gloo process group.  The arguments default to torch's
    environment names: init_method tcp://MASTER_ADDR:MASTER_PORT,
    WORLD_SIZE and RANK; a no-op for one process or with no address."""
    import torch.distributed as dist
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if init_method is None and "MASTER_ADDR" in os.environ:
        init_method = (f"tcp://{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    if init_method is None or world_size <= 1:
        return
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world_size, rank=rank)


def host_major_mesh(device: DeviceLike = None, db_per_host: int = 1) -> Mesh:
    """This process's (1, db_per_host) mesh: the "db" axis inside the
    process, on cuda:(rank % device_count), or on the CPU when the caller
    passes it; the "data" axis is the processes."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", _rank_size()[0] % torch.cuda.device_count())
    return single_mesh(dev, n_db=db_per_host)


def multihost_search(query_path: str, db_path: str, out_path: str,
                     topk: int = 64, window: int = 512,
                     device: DeviceLike = None, db_per_host: int = 1) -> dict:
    """usearch_global of this process's stripe of the queries against the
    whole DB (FASTA or .udb), ranked on this process's mesh
    (parallel/mesh_search.py) and aligned in the batch engine; its blast6
    records go to out_path.partRANK, and process 0 splices the stripes into
    out_path after every process has written its own."""
    import torch.distributed as dist
    from ..config import options
    from ..engine.batch import BatchEngine, _FastaWindows
    from ..engine.emit import Blast6Emitter
    from ..index.udbfile import load_db
    from ..ops.csr_rank import make_engine_override
    from .mesh_search import MeshRanker

    o = options()
    pid, n_proc = _rank_size()
    db, index = load_db(db_path)
    mesh = host_major_mesh(device, db_per_host)
    eng = BatchEngine("usearch_global", db, index=index)
    ranker = MeshRanker(mesh, eng.index, topk=topk)
    n = _FastaWindows(query_path).n
    per = (n + n_proc - 1) // n_proc
    lo, hi = min(n, pid * per), min(n, (pid + 1) * per)
    with open(f"{out_path}.part{pid}", "w") as fpart:
        if lo < hi:
            eng.run_file(query_path, None, window=window,
                         fast_emit=Blast6Emitter(fpart, db,
                                                 o.flag("output_no_hits")),
                         rank_override=make_engine_override(ranker, eng),
                         records=(lo, hi))
    if n_proc > 1:
        dist.barrier()
    if pid == 0:
        with open(out_path, "wb") as out:
            for p in range(n_proc):
                with open(f"{out_path}.part{p}", "rb") as f:
                    out.write(f.read())
    if n_proc > 1:
        dist.barrier()
    return {"queries": hi - lo,
            "fallbacks": eng.dev_stats["rank_host_rerank_jobs"],
            "windows": (hi - lo + window - 1) // window}
