"""UC format records (src/outputuc.cpp:10-90).

Record types: H (hit), S (new seed/centroid), C (cluster summary),
N (no hit).  Tab-separated 10 fields:
  type, cluster#, size/length, pctid, strand, *, *, compressed path (or =),
  query label, target label.
"""

from __future__ import annotations


def _strand(ar) -> str:
    if not ar.nucleo:
        return "."
    return "-" if ar.query_revcomp else "+"


def compressed_or_eq(ar) -> str:
    """'=' when the alignment is an identity (all M and 100% id), else the
    run-length compressed path."""
    path = ar.path
    if ar.get_fract_id() >= 1.0 and path == "M" * len(path):
        return "="
    return ar.compressed_path()


def uc_hit_record(ar, cluster_index: int = -1) -> str:
    """OutputUC (src/outputuc.cpp:45-70): H, target index, IQL, pctid,
    strand, IQLo, ITLo, compressed path, labels."""
    from .userout import _iq_lo_hi, _iql, _hsp
    iq_lo = _iq_lo_hi(ar)[0]
    it_lo = _hsp(ar)[2]
    return "\t".join([
        "H", str(ar.target_index), str(_iql(ar)),
        f"{ar.get_pct_id():.1f}", _strand(ar), str(iq_lo), str(it_lo),
        ar.compressed_path(), ar.query_label, ar.target_label]) + "\n"


def uc_no_hit_record(query_label: str, seq_len: int,
                     cluster_index: int = -1) -> str:
    ci = "*" if cluster_index < 0 else str(cluster_index)
    return "\t".join([
        "N", ci, str(seq_len), "*", ".", "*", "*", "*",
        query_label, "*"]) + "\n"


def uc_seed_record(cluster_index: int, seq_len: int, label: str) -> str:
    return "\t".join([
        "S", str(cluster_index), str(seq_len), "*", "*", "*", "*", "*",
        label, "*"]) + "\n"


def uc_cluster_record(cluster_index: int, size: int, label: str) -> str:
    return "\t".join([
        "C", str(cluster_index), str(size), "*", "*", "*", "*", "*",
        label, "*"]) + "\n"
