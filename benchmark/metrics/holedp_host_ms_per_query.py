"""Milliseconds a query of the hole DP's host work on the card's route:
TorchWaveAligner.align's spans holedp_pack (the pairs' geometry, the
letters packed and uploaded) and holedp_collect (the copies back and the
paths decoded), over the window."""


def read(run):
    c = run["counters"]
    if not c.get("queries") or "holedp_pack_ns" not in c \
            or "holedp_collect_ns" not in c:
        return None
    return 1e-6 * (c["holedp_pack_ns"] + c["holedp_collect_ns"]) \
        / c["queries"]
