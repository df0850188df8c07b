"""Early-termination policy (src/terminator.cpp)."""

from __future__ import annotations

from ..config import options

_DEFAULTS = {
    "cluster_fast": (1, 8),
    "cluster_mt": (1, 8),
    "otutab": (4, 16),
    "closed_ref": (4, 16),
    "cluster_smallmem": (1, 32),
    "usearch_global": (1, 32),
    "usearch_local": (1, 32),
    "cluster_otus": (1, 32),
    "unoise3": (1, 32),
    "sintax": (0, 0),
}


class Terminator:
    def __init__(self, cmd: str) -> None:
        if cmd not in _DEFAULTS:
            raise ValueError(f"Terminator: cmd={cmd}")
        self.max_accepts, self.max_rejects = _DEFAULTS[cmd]
        o = options()
        if o.filled("maxaccepts"):
            self.max_accepts = o.uns("maxaccepts")
        if o.filled("maxrejects"):
            self.max_rejects = o.uns("maxrejects")
        self.accept_count = 0
        self.reject_count = 0

    def on_new_query(self) -> None:
        self.accept_count = 0
        self.reject_count = 0

    def terminate(self, hitmgr, accept: bool) -> bool:
        o = options()
        if o.filled("termid") and hitmgr is not None:
            if hitmgr.hit_count > 0 and hitmgr.min_fract_id() <= o.flt("termid"):
                return True
        if o.filled("termidd") and hitmgr is not None:
            if hitmgr.hit_count > 0:
                if (hitmgr.max_fract_id() - hitmgr.min_fract_id()
                        > o.flt("termidd")):
                    return True
        if accept:
            self.accept_count += 1
        else:
            self.reject_count += 1
        if self.max_accepts > 0 and self.accept_count == self.max_accepts:
            return True
        if self.max_rejects > 0 and self.reject_count == self.max_rejects:
            return True
        return False
