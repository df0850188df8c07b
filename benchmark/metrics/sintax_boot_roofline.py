"""The SINTAX boot step's kernels' share of their bound, in %: the least
time the bytes they must move take at 3.35 TB/s (the H100's HBM; NVIDIA's
data sheet) over their time in the traced window.

Bytes: each traced request's boot_bytes, counted by the benchmark from its
reads and the reference's posting lists (reference/sintax.py:boot_bytes),
never from the program's counters.  Time: the summed device time of the
trace's busiest operations that are the port's SINTAX kernels, whose names
start with "sintax_" (a template kernel's name with its return type,
"void ", in front).  None where the trace holds none of them."""

HBM_BYTES_PER_S = 3.35e12


def _sintax_kernel(name: str) -> bool:
    return name.removeprefix("void ").startswith("sintax_")


def read(run):
    tr = run["trace"]
    if tr is None:
        return None
    t = sum(s for name, s in tr["device_ops"] if _sintax_kernel(name))
    nbytes = sum(r.get("boot_bytes", 0) for r in run["requests"]
                 if "error" not in r)
    if t <= 0 or not nbytes:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / t
