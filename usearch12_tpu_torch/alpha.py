"""Alphabet tables: char<->letter maps, IUPAC match matrices, complement.

NumPy uint8/bool tables built programmatically from the standard biological
alphabets (reference: src/alpha.cpp tables, src/alpha2.cpp Init_MatchMxs /
Init_IUPAC).

Conventions (same as reference):
  - nucleotide letters: A=0 C=1 G=2 T=U=3; lowercase maps to same letter.
  - amino letters: 20 standard AAs in alphabetical order A,C,D,E,F,G,H,I,K,
    L,M,N,P,Q,R,S,T,V,W,Y = 0..19; lowercase same letter.
  - INVALID_LETTER = 0xff for anything else.
  - identity ("match") matrices are char-indexed 256x256 bool:
      amino: case-insensitive equality, or either is X, plus B~{N,D}, Z~{Q,E}
      nucleo: IUPAC-bit overlap where one operand is a concrete base
              (A/C/G/T/U), case-insensitive
"""

from __future__ import annotations


import numpy as np

INVALID_LETTER = 0xFF
BAD_WORD = 0xFFFFFFFF

_AA = "ACDEFGHIKLMNPQRSTVWY"
_NT = "ACGT"

# IUPAC wildcard -> set of concrete bases
_IUPAC = {
    "A": "A", "C": "C", "G": "G", "T": "T", "U": "T",
    "R": "AG", "Y": "CT", "S": "CG", "W": "AT", "K": "GT", "M": "AC",
    "B": "CGT", "D": "AGT", "H": "ACT", "V": "ACG", "N": "ACGT",
}
_COMP = {
    "A": "T", "C": "G", "G": "C", "T": "A", "U": "A",
    "R": "Y", "Y": "R", "S": "S", "W": "W", "K": "M", "M": "K",
    "B": "V", "V": "B", "D": "H", "H": "D", "N": "N", "X": "X",
}


def _build_char_to_letter(alphabet: str) -> np.ndarray:
    t = np.full(256, INVALID_LETTER, dtype=np.uint8)
    for i, c in enumerate(alphabet):
        t[ord(c)] = i
        t[ord(c.lower())] = i
    return t


CHAR_TO_LETTER_AMINO = _build_char_to_letter(_AA)
CHAR_TO_LETTER_NUCLEO = _build_char_to_letter(_NT)
# U/u are nucleotide T (src/alpha.cpp g_CharToLetterNucleo)
CHAR_TO_LETTER_NUCLEO[ord("U")] = 3
CHAR_TO_LETTER_NUCLEO[ord("u")] = 3

LETTER_TO_CHAR_AMINO = np.frombuffer((_AA + "*").encode(), dtype=np.uint8).copy()
LETTER_TO_CHAR_NUCLEO = np.frombuffer(_NT.encode(), dtype=np.uint8).copy()

# single-base bit per char (0 unless concrete A/C/G/T/U)
_NUCLEO_CHAR_TO_BIT = np.zeros(256, dtype=np.uint8)
# full IUPAC bits per char
_IUPAC_CHAR_TO_BITS = np.zeros(256, dtype=np.uint8)
_BIT = {"A": 1, "C": 2, "G": 4, "T": 8}
for _c in "ACGTU":
    _b = _BIT["T" if _c == "U" else _c]
    _NUCLEO_CHAR_TO_BIT[ord(_c)] = _b
    _NUCLEO_CHAR_TO_BIT[ord(_c.lower())] = _b
for _c, _bases in _IUPAC.items():
    _bits = 0
    for _x in _bases:
        _bits |= _BIT[_x]
    _IUPAC_CHAR_TO_BITS[ord(_c)] = _bits
    _IUPAC_CHAR_TO_BITS[ord(_c.lower())] = _bits


def _is_alpha_ascii(i: int) -> bool:
    return (ord("A") <= i <= ord("Z")) or (ord("a") <= i <= ord("z"))


def _is_gap(i: int) -> bool:
    return i in (ord("-"), ord("."))


def _build_match_mxs():
    """256x256 char-indexed identity matrices (src/alpha2.cpp:220-280),
    vectorized (import-time hot: runs on every process start)."""
    idx = np.arange(256)
    is_alpha = ((idx >= ord("A")) & (idx <= ord("Z"))) | \
               ((idx >= ord("a")) & (idx <= ord("z")))
    is_gap = (idx == ord("-")) | (idx == ord("."))
    up = np.where((idx >= ord("a")) & (idx <= ord("z")), idx - 32, idx)

    both_alpha = is_alpha[:, None] & is_alpha[None, :]
    gap_eq = is_gap[:, None] & is_gap[None, :]
    same_up = up[:, None] == up[None, :]

    amino = np.where(both_alpha,
                     same_up | (up[:, None] == ord("X"))
                     | (up[None, :] == ord("X")),
                     gap_eq)
    # IUPAC_Eq(i,j) = bit(i) & bits(j); symmetric OR
    bit = _NUCLEO_CHAR_TO_BIT.astype(np.int64)
    bits = _IUPAC_CHAR_TO_BITS.astype(np.int64)
    iupac = ((bit[:, None] & bits[None, :]) != 0) | \
            ((bit[None, :] & bits[:, None]) != 0)
    nucleo = np.where(both_alpha, same_up | iupac, gap_eq)
    # B = N or D, Z = Q or E (uppercase only, matching reference)
    for a, b in (("B", "N"), ("B", "D"), ("Z", "Q"), ("Z", "E")):
        amino[ord(a), ord(b)] = True
        amino[ord(b), ord(a)] = True
    return amino, nucleo


MATCH_MX_AMINO, MATCH_MX_NUCLEO = _build_match_mxs()

# char -> complement char ('?' for non-IUPAC), preserving case
CHAR_TO_COMP_CHAR = np.full(256, ord("?"), dtype=np.uint8)
CHAR_TO_COMP_CHAR[0] = 0
for _c, _k in _COMP.items():
    CHAR_TO_COMP_CHAR[ord(_c)] = ord(_k)
    CHAR_TO_COMP_CHAR[ord(_c.lower())] = ord(_k.lower())
# reference quirk: lowercase 'u' complements to '?' is NOT the case; u->a
CHAR_TO_COMP_CHAR[ord("u")] = ord("a")

TO_UPPER = np.arange(256, dtype=np.uint8)
for _i in range(ord("a"), ord("z") + 1):
    TO_UPPER[_i] = _i - 32
IS_LOWER = np.zeros(256, dtype=bool)
IS_LOWER[ord("a"):ord("z") + 1] = True

# ACGTU per char (used for nt/aa sniffing, loaddb.cpp:10-53)
IS_ACGTU = np.zeros(256, dtype=bool)
for _c in "ACGTUacgtu":
    IS_ACGTU[ord(_c)] = True

# valid sequence char (letters plus gap chars)
IS_SEQ_CHAR = np.zeros(256, dtype=bool)
for _i in range(256):
    IS_SEQ_CHAR[_i] = _is_alpha_ascii(_i) or _is_gap(_i)

# Codon translation (standard genetic code), word = 16*l1 + 4*l2 + l3
_CODON_TABLE = (
    "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLL"
    "EDEDAAAAGGGGVVVV*Y*YSSSS*CWCLFLF"
)
# Build: letters in order A,C,G,T -> index; the string above is ordered by
# (l1,l2,l3) with A=0,C=1,G=2,T=3 using the standard code table layout.


def _build_codon_words() -> np.ndarray:
    # standard genetic code from first principles
    code = {}
    bases = "TCAG"
    aas = ("FFLLSSSSYY**CC*W" "LLLLPPPPHHQQRRRR"
           "IIIMTTTTNNKKSSRR" "VVVVAAAADDEEGGGG")
    k = 0
    for b1 in bases:
        for b2 in bases:
            for b3 in bases:
                code[b1 + b2 + b3] = aas[k]
                k += 1
    out = np.zeros(64, dtype=np.uint8)
    order = "ACGT"
    for i1, c1 in enumerate(order):
        for i2, c2 in enumerate(order):
            for i3, c3 in enumerate(order):
                out[16 * i1 + 4 * i2 + i3] = ord(code[c1 + c2 + c3])
    return out


CODON_WORD_TO_AMINO_CHAR = _build_codon_words()


def revcomp(seq: np.ndarray) -> np.ndarray:
    """Reverse-complement of an ASCII uint8 sequence array."""
    return CHAR_TO_COMP_CHAR[seq[::-1]]


def seq_upper(seq: np.ndarray) -> np.ndarray:
    return TO_UPPER[seq]


def to_bytes(s) -> np.ndarray:
    if isinstance(s, np.ndarray):
        return s.astype(np.uint8, copy=False)
    if isinstance(s, str):
        s = s.encode()
    return np.frombuffer(s, dtype=np.uint8).copy()


def to_str(seq: np.ndarray) -> str:
    return seq.tobytes().decode("latin1")
