"""blast6 (-outfmt 6) tabbed output (src/blast6out.cpp:27-103)."""

from __future__ import annotations


def blast6_line(ar) -> str:
    qlo, qhi = ar.q_coords_1()
    tlo, thi = ar.t_coords_1()
    fields = [
        ar.query_label,
        ar.target_label,
        f"{ar.get_pct_id():.1f}",
        str(ar.get_aln_length()),
        str(ar.get_mismatch_count()),
        str(ar.get_gap_open_count()),
        str(qlo),
        str(qhi),
        str(tlo),
        str(thi),
    ]
    if ar.local:
        fields.append(f"{ar.evalue:.2g}")
        fields.append(f"{ar.bit_score:.1f}")
    else:
        fields.append("*")
        fields.append("*")
    return "\t".join(fields) + "\n"


def blast6_no_hits_line(query_label: str) -> str:
    return (f"{query_label}\t*\t0\t0\t0\t0\t0\t0\t0\t0\t*\t0\n")
