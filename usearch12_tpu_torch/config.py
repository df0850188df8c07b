"""Typed global option registry with per-command dynamic defaults.

Equivalent of the reference's X-macro option system (opts.h, o_*.h,
o_defaults.inc): every option has a type (str/float/uns/flag), a global
default, and may be overridden per command at runtime ("oset_*d" semantics:
set a default only if the user did not supply the flag).  Reads anywhere via
`opt(name)` / `filled(name)`.

Reference: src/opts.h:17-37, src/o_defaults.inc:1-58, src/opts.cpp:206
(unused-option warning).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional

_FLT = "flt"
_UNS = "uns"
_STR = "str"
_FLAG = "flag"


@dataclass
class _Opt:
    name: str
    kind: str
    default: Any = None       # compile-time default (o_defaults.inc)
    value: Any = None         # current value (default or user)
    filled: bool = False      # opt_filled: set by o_defaults.inc (compile-
                              # time defaults), oset_*d AND the command line
                              # (src/opts.cpp:120-190) — NOT only user-set
    cmdline: bool = False     # opt_cmdline: user typed it (src/opts.cpp:222)
    used: bool = False


# Defaults mirror src/o_defaults.inc exactly.  Options with no entry there
# default to None (flt/uns/str) or False (flag) and are "unfilled".
_FLT_DEFAULTS = {
    "dn": 1.4, "ka_dbsize": 1e9, "lext": 1.0, "lopen": 10.0, "maj": 0.51,
    "match": 1.0, "maxid": 1.0, "mindiv": 1.0, "minh": 0.35, "mismatch": -2.0,
    "orient_strandx": 4.0, "orient_wordx": 8.0, "sintax_cutoff": 0.8,
    "unoise_alpha": 2.0, "uparse_annot_maxdivqm": 1.0, "uparse_break": -3.0,
    "uparse_match": 0.0, "uparse_mismatch": -1.0, "xa": 1.0, "xdrop_g": 32.0,
    "xdrop_nw": 8.0, "xdrop_u": 16.0, "xn": 8.0,
}
_UNS_DEFAULTS = {
    "band": 16, "big": 100000, "boots": 100, "bump": 50, "chunks": 4,
    "fasta_cols": 80, "fastq_ascii": 33, "fastq_maxdiffs": 5,
    "fastq_minovlen": 16, "fastq_pctid": 90, "fastq_qmax": 42,
    "fastq_qmaxout": 42, "fastq_qmin": 0, "fastq_tail": 4,
    "fastq_trunctail": 2, "flank": 8, "long_target": 50000,
    "max_gene_length": 2000, "maxenddiffs": 4, "maxseqlength": 50000,
    "maxstartdiffs": 4, "min_gene_length": 1200, "minchunk": 64,
    "mincodons": 20, "chimera_mindiffs": 3, "mindqt": 1, "minhsp": 16,
    "minseqlength": 8, "randseed": 1, "rowlen": 80, "self_words_drop": 4,
    "stepwords": 8, "uparse_maxdball": 100, "uparse_maxdrop": 8,
    "uparse_maxhot": 32,
}

# Options without a compile-time default, declared so `filled()` works.
_FLT_OPTS = [
    "id", "evalue", "query_cov", "max_query_cov", "target_cov",
    "max_target_cov", "abskew", "termid", "termidd", "min_sizeratio",
    "minqt", "maxqt", "minsl", "maxsl", "fastq_maxee", "fastq_maxee_rate",
    "ka_gapped_k", "ka_gapped_lambda", "ka_ungapped_k", "ka_ungapped_lambda",
]
_UNS_OPTS = [
    "maxaccepts", "maxrejects", "wordlength", "slots", "threads", "hspw",
    "mincols", "maxgaps", "maxdiffs", "mindiffs", "fastq_trunclen",
    "fastq_minlen", "fastq_maxns", "fastq_stripleft", "fastq_stripright",
    "minuniquesize", "topn",
    "maxhits", "dbaccel", "minsize",
    "fastq_maxmergelen", "fastq_minmergelen",
    "maxpending", "stripleft", "stripright", "trunclen",
    "padlen", "fastq_truncqual", "fastq_minqual",
    "mincount", "orfstyle", "maxdiffsa", "maxdqm",
]
_STR_OPTS = [
    "output", "blast6out", "uc", "userout", "userfields", "alnout",
    "matched", "notmatched", "matchedfq", "notmatchedfq", "fastaout",
    "fastqout", "fastaout_notmerged_fwd", "fastaout_notmerged_rev",
    "fastqout_notmerged_fwd", "fastqout_notmerged_rev", "centroids",
    "clusters", "db", "reverse", "uchimeout",
    "chimeras", "nonchimeras", "zotus", "otus", "otutabout", "biomout",
    "uparseout", "uparsealnout", "tabbedout",
    "log", "dbmask", "strand", "sort",
    "ampout", "uchimealnout", "query", "output2", "db2", "boot_subset",
    "fastaout_discarded", "fastqout_discarded", "mapout", "join_padgap",
    "join_padgapq", "fastqout_overlap_fwd", "fastqout_overlap_rev",
    "fastaout_overlap_fwd", "fastaout_overlap_rev", "padq", "rank",
    "otutabin",
    "sortedby", "relabel", "sample",
    "matrix", "tsegout", "qsegout", "fastapairs", "eetabbedout",
    "report", "label_suffix",
    "sample_delim", "constax_report",
    "bitvec", "hitsout", "fragout", "start_motif", "end_motif",
    "truncstr", "checkpoint", "xprof", "dev_batch_cells", "mesh",
    "dbmatched", "dbnotmatched", "dbcutout", "trimout", "fqdir",
    "input", "alpha", "dataotus", "dbotus", "uparse_ref", "xdrop_save",
]
_FLAG_OPTS = [
    "quiet", "self", "notself", "selfid", "gaforce", "fulldp", "quicksort",
    "top_hit_only", "top_hits_only", "output_no_hits", "show_termgaps",
    "hardmask", "sizein",
    "sizeout", "fastq_eeout", "fastq_nostagger",
    "interleaved", "uc_hitsonly", "trunclabels",
    "maxskew", "tov", "log_objmgr_stats", "log_touched_opts",
    "no_progress", "use_cpu_oracle",
    "engine_device", "no_engine_device", "use_serial_driver", "device_rank",
    "no_device_rank",
    "sintax_device", "no_sintax_device",
    "orf_plusonly",
    "ignore_label_mismatches", "notrunclabels", "fastq_forceq",
    "fastq_noguess", "keepgaps",
]


class Options:
    """One registry instance per run (thread-local current)."""

    def __init__(self) -> None:
        import numpy as _np
        self._opts: Dict[str, _Opt] = {}
        # oset_*_default (src/opts.cpp:180-193) sets opt_filled=true, so
        # ofilled() is TRUE for every option in o_defaults.inc; flt values
        # are stored as float (f32 cast).
        for n, v in _FLT_DEFAULTS.items():
            v32 = float(_np.float32(v))
            self._opts[n] = _Opt(n, _FLT, default=v32, value=v32, filled=True)
        for n, v in _UNS_DEFAULTS.items():
            self._opts[n] = _Opt(n, _UNS, default=v, value=v, filled=True)
        for n in _FLT_OPTS:
            self._opts.setdefault(n, _Opt(n, _FLT))
        for n in _UNS_OPTS:
            self._opts.setdefault(n, _Opt(n, _UNS))
        for n in _STR_OPTS:
            self._opts.setdefault(n, _Opt(n, _STR))
        for n in _FLAG_OPTS:
            self._opts.setdefault(n, _Opt(n, _FLAG, default=False))

    def known(self, name: str) -> bool:
        return name in self._opts

    # -- declaration ------------------------------------------------------
    def declare(self, name: str, kind: str, default: Any = None) -> None:
        if name not in self._opts:
            self._opts[name] = _Opt(name, kind, default=default)

    def _get(self, name: str) -> _Opt:
        o = self._opts.get(name)
        if o is None:
            raise KeyError(f"unknown option '{name}'")
        return o

    # -- user-set (command line) ------------------------------------------
    def set(self, name: str, value: Any) -> None:
        import numpy as _np
        o = self._get(name)
        if o.kind == _FLT:
            # flt_opts is a float array in the reference: user values are
            # f32-rounded (e.g. -id 0.97 -> 0.97000003) (src/opts.cpp).
            value = float(_np.float32(float(value)))
        elif o.kind == _UNS:
            value = int(value)
        elif o.kind == _FLAG:
            value = bool(value) if not isinstance(value, str) else True
        o.value = value
        o.filled = True
        o.cmdline = True

    # -- dynamic per-command defaults (oset_*d) ----------------------------
    def set_default(self, name: str, value: Any) -> None:
        """oset_fltd/unsd/strd (src/opts.cpp:127-155): applies ONLY if not
        already filled — a no-op for options with o_defaults.inc defaults —
        and sets opt_filled=true."""
        import numpy as _np
        o = self._get(name)
        if not o.filled:
            if o.kind == _FLT:
                value = float(_np.float32(float(value)))
            o.value = value
            o.filled = True

    # -- reads --------------------------------------------------------------
    def filled(self, name: str) -> bool:
        o = self._opts.get(name)
        return o.filled if o is not None else False

    def get(self, name: str, default: Any = None) -> Any:
        """oget_* semantics: filled value (defaults fill at startup), else
        `default` arg (oget_fltd/oget_unsd)."""
        o = self._get(name)
        o.used = True
        if o.filled:
            return o.value
        if default is not None:
            return default
        if o.kind == _FLAG:
            return False
        raise ValueError(f"option '{name}' not set and has no default")

    def flt(self, name: str, default: Optional[float] = None) -> float:
        return float(self.get(name, default))

    def uns(self, name: str, default: Optional[int] = None) -> int:
        return int(self.get(name, default))

    def str(self, name: str, default: Optional[str] = None) -> str:
        v = self.get(name, default if default is not None else "")
        return "" if v is None else str(v)

    def flag(self, name: str) -> bool:
        return bool(self.get(name, False))

    def unused_filled(self):
        """CheckUsedOpts (src/opts.cpp:222): warn only for options the user
        actually typed (opt_cmdline), not for filled defaults."""
        return [o.name for o in self._opts.values()
                if o.cmdline and not o.used]


_tls = threading.local()


def options() -> Options:
    cur = getattr(_tls, "cur", None)
    if cur is None:
        cur = Options()
        _tls.cur = cur
    return cur


def reset_options() -> Options:
    _tls.cur = Options()
    return _tls.cur


def set_options(opts: Options) -> None:
    _tls.cur = opts


# convenience module-level accessors (mirror oget_* / ofilled)
def oget_flt(name: str, default: Optional[float] = None) -> float:
    return options().flt(name, default)


def oget_uns(name: str, default: Optional[int] = None) -> int:
    return options().uns(name, default)


def oget_str(name: str, default: Optional[str] = None) -> str:
    return options().str(name, default)


def oget_flag(name: str) -> bool:
    return options().flag(name)


def ofilled(name: str) -> bool:
    return options().filled(name)


def oset(name: str, value: Any) -> None:
    options().set(name, value)


def oset_default(name: str, value: Any) -> None:
    options().set_default(name, value)
