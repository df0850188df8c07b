"""Substitution matrices and alignment parameters.

Matrices are 256x256 float32 indexed by raw ASCII character (case-symmetric,
unknown chars score 0) like the reference (src/setnucmx.cpp, src/blosum62.cpp).
AlnParams carries the 12-penalty global gap model (src/alnparams.h:8-60);
AlnHeuristics the banding / HSP heuristics (src/alnheuristics.cpp:26-69).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np

from .alpha import _AA  # 20-letter amino alphabet in letter order
from .config import options

MINUS_INFINITY = np.float32(-9e9)

# Standard NCBI BLOSUM62 (half-bit units), row/col order ARNDCQEGHILKMFPSTWYVBZX*
_B62_ORDER = "ARNDCQEGHILKMFPSTWYVBZX*"
_B62 = """
 4 -1 -2 -2  0 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -3 -2  0 -2 -1  0 -4
-1  5  0 -2 -3  1  0 -2  0 -3 -2  2 -1 -3 -2 -1 -1 -3 -2 -3 -1  0 -1 -4
-2  0  6  1 -3  0  0  0  1 -3 -3  0 -2 -3 -2  1  0 -4 -2 -3  3  0 -1 -4
-2 -2  1  6 -3  0  2 -1 -1 -3 -4 -1 -3 -3 -1  0 -1 -4 -3 -3  4  1 -1 -4
 0 -3 -3 -3  9 -3 -4 -3 -3 -1 -1 -3 -1 -2 -3 -1 -1 -2 -2 -1 -3 -3 -2 -4
-1  1  0  0 -3  5  2 -2  0 -3 -2  1  0 -3 -1  0 -1 -2 -1 -2  0  3 -1 -4
-1  0  0  2 -4  2  5 -2  0 -3 -3  1 -2 -3 -1  0 -1 -3 -2 -2  1  4 -1 -4
 0 -2  0 -1 -3 -2 -2  6 -2 -4 -4 -2 -3 -3 -2  0 -2 -2 -3 -3 -1 -2 -1 -4
-2  0  1 -1 -3  0  0 -2  8 -3 -3 -1 -2 -1 -2 -1 -2 -2  2 -3  0  0 -1 -4
-1 -3 -3 -3 -1 -3 -3 -4 -3  4  2 -3  1  0 -3 -2 -1 -3 -1  3 -3 -3 -1 -4
-1 -2 -3 -4 -1 -2 -3 -4 -3  2  4 -2  2  0 -3 -2 -1 -2 -1  1 -4 -3 -1 -4
-1  2  0 -1 -3  1  1 -2 -1 -3 -2  5 -1 -3 -1  0 -1 -3 -2 -2  0  1 -1 -4
-1 -1 -2 -3 -1  0 -2 -3 -2  1  2 -1  5  0 -2 -1 -1 -1 -1  1 -3 -1 -1 -4
-2 -3 -3 -3 -2 -3 -3 -3 -1  0  0 -3  0  6 -4 -2 -2  1  3 -1 -3 -3 -1 -4
-1 -2 -2 -1 -3 -1 -1 -2 -2 -3 -3 -1 -2 -4  7 -1 -1 -4 -3 -2 -2 -1 -2 -4
 1 -1  1  0 -1  0  0  0 -1 -2 -2  0 -1 -2 -1  4  1 -3 -2 -2  0  0  0 -4
 0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  1  5 -2 -2  0 -1 -1  0 -4
-3 -3 -4 -4 -2 -2 -3 -2 -2 -3 -2 -3 -1  1 -4 -3 -2 11  2 -3 -4 -3 -2 -4
-2 -2 -2 -3 -2 -1 -2 -3  2 -1 -1 -2 -1  3 -3 -2 -2  2  7 -1 -3 -2 -1 -4
 0 -3 -3 -3 -1 -2 -2 -3 -3  3  1 -2  1 -1 -2 -2  0 -3 -1  4 -3 -2 -1 -4
-2 -1  3  4 -3  0  1 -1  0 -3 -4  0 -3 -3 -2  0 -1 -4 -3 -3  4  1 -1 -4
-1  0  0  1 -3  3  4 -2  0 -3 -3  1 -1 -3 -1  0 -1 -3 -2 -2  1  4 -1 -4
 0 -1 -1 -1 -2 -1 -1 -1 -1 -1 -1 -1 -1 -1 -2  0  0 -2 -1 -1 -1 -1 -1 -4
-4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4  1
"""


def _fill_case_sym(mx: np.ndarray, ci: str, cj: str, v: float) -> None:
    ui, uj = ord(ci.upper()), ord(cj.upper())
    li, lj = ord(ci.lower()), ord(cj.lower())
    for a in (ui, li):
        for b in (uj, lj):
            mx[a, b] = v
            mx[b, a] = v


@functools.lru_cache(maxsize=None)
def blosum62_mx() -> np.ndarray:
    mx = np.zeros((256, 256), dtype=np.float32)
    rows = [r.split() for r in _B62.strip().splitlines()]
    for i, ci in enumerate(_B62_ORDER):
        for j, cj in enumerate(_B62_ORDER):
            _fill_case_sym(mx, ci, cj, float(rows[i][j]))
    mx.setflags(write=False)
    return mx


@functools.lru_cache(maxsize=None)
def nuc_mx(match: float, mismatch: float) -> np.ndarray:
    """+match/-mismatch over ACGTU (U==T identity); N scores 0 vs bases
    (src/setnucmx.cpp:36-87)."""
    assert match > 0 and mismatch < 0
    mx = np.zeros((256, 256), dtype=np.float32)
    bases = "ACGTU"
    letter = {"A": 0, "C": 1, "G": 2, "T": 3, "U": 3}
    for ci in bases:
        for cj in bases:
            v = match if letter[ci] == letter[cj] else mismatch
            _fill_case_sym(mx, ci, cj, v)
    for cj in bases:
        _fill_case_sym(mx, "N", cj, 0.0)
    mx.setflags(write=False)
    return mx


@dataclass
class AlnParams:
    """Gap values are negative scores (src/alnparams.h)."""
    subst_mx: np.ndarray = None
    nucleo: bool = False
    local_open: float = -10.0
    local_ext: float = -1.0
    open_a: float = 0.0
    open_b: float = 0.0
    ext_a: float = 0.0
    ext_b: float = 0.0
    l_open_a: float = 0.0
    l_open_b: float = 0.0
    r_open_a: float = 0.0
    r_open_b: float = 0.0
    l_ext_a: float = 0.0
    l_ext_b: float = 0.0
    r_ext_a: float = 0.0
    r_ext_b: float = 0.0

    @classmethod
    def from_cmdline(cls, nucleo: bool) -> "AlnParams":
        """src/alnparams.cpp:353-385: nt Init4(mx,-10,-1,-.5,-.5) with
        +match/-mismatch matrix; aa Init4(B62,-17,-1,-.5,-.5)."""
        o = options()
        ap = cls(nucleo=nucleo)
        if nucleo:
            ap.subst_mx = nuc_mx(o.flt("match"), o.flt("mismatch"))
            ap.init4(-10.0, -1.0, -0.5, -0.5)
            ap.local_open, ap.local_ext = -10.0, -1.0
        else:
            ap.subst_mx = blosum62_mx()
            ap.init4(-17.0, -1.0, -0.5, -0.5)
            ap.local_open, ap.local_ext = -5.0, -1.0
        if o.filled("lopen") or o.filled("lext"):
            ap.local_open = -o.flt("lopen")
            ap.local_ext = -o.flt("lext")
        return ap

    def init4(self, open_, ext, term_open, term_ext) -> None:
        self.open_a = self.open_b = open_
        self.ext_a = self.ext_b = ext
        self.l_open_a = self.l_open_b = self.r_open_a = self.r_open_b = term_open
        self.l_ext_a = self.l_ext_b = self.r_ext_a = self.r_ext_b = term_ext

    def hole_params(self, left_a: bool, left_b: bool, right_a: bool,
                    right_b: bool) -> "AlnParams":
        """AlnParams::Init for a hole HSP: terminal penalties apply only on
        sides that touch the sequence ends (src/alnparams.cpp:100-152)."""
        ap = AlnParams(subst_mx=self.subst_mx, nucleo=self.nucleo,
                       open_a=self.open_a, open_b=self.open_b,
                       ext_a=self.ext_a, ext_b=self.ext_b)
        ap.l_open_a = self.l_open_a if left_a else self.open_a
        ap.l_ext_a = self.l_ext_a if left_a else self.ext_a
        ap.l_open_b = self.l_open_b if left_b else self.open_b
        ap.l_ext_b = self.l_ext_b if left_b else self.ext_b
        ap.r_open_a = self.r_open_a if right_a else self.open_a
        ap.r_ext_a = self.r_ext_a if right_a else self.ext_a
        ap.r_open_b = self.r_open_b if right_b else self.open_b
        ap.r_ext_b = self.r_ext_b if right_b else self.ext_b
        return ap


@dataclass
class AlnHeuristics:
    """src/alnheuristics.cpp:26-69."""
    band_radius: int = 16
    hsp_word_length: int = 3
    xdrop_u: float = 16.0
    xdrop_g: float = 32.0
    xdrop_global_hsp: float = 8.0
    min_global_hsp_length: int = 16
    min_global_hsp_fract_id: float = 0.5
    min_global_hsp_score: float = 0.0
    full_dp_always: bool = False

    @classmethod
    def from_cmdline(cls, ap: AlnParams) -> "AlnHeuristics":
        o = options()
        ah = cls()
        ah.full_dp_always = o.flag("fulldp")
        ah.xdrop_u = o.flt("xdrop_u")
        ah.xdrop_g = o.flt("xdrop_g")
        ah.xdrop_global_hsp = o.flt("xdrop_nw")
        ah.band_radius = o.uns("band")
        ah.min_global_hsp_length = o.uns("minhsp")
        if ap.nucleo:
            ah.hsp_word_length = 5
            ah.min_global_hsp_fract_id = max(o.flt("id", 0.5), 0.75)
            ah.min_global_hsp_score = (ah.min_global_hsp_fract_id *
                                       ah.min_global_hsp_length *
                                       o.flt("match", 1.0))
        else:
            ah.hsp_word_length = 3
            # min BLOSUM62 diagonal score over the 20 standard AAs
            mx = ap.subst_mx
            min_diag = min(float(mx[ord(c), ord(c)]) for c in _AA)
            ah.min_global_hsp_fract_id = max(o.flt("id", 0.5), 0.5)
            ah.min_global_hsp_score = (ah.min_global_hsp_fract_id * min_diag *
                                       ah.min_global_hsp_length)
        if o.filled("hspw"):
            ah.hsp_word_length = o.uns("hspw")
        if ah.full_dp_always:
            ah.min_global_hsp_length = 0
            ah.hsp_word_length = 0
            ah.band_radius = 0
        return ah
