"""Build the CUDA kernels of csrc/ and bind them with ctypes.

The sources are compiled at first use with nvcc for Hopper (sm_90a), one
nvcc process per source, all started together, and linked into one
shared library with a plain C interface, under
build/usearch12_tpu_torch/ at the root of the checkout.  The library's
name carries a hash of the sources and flags, so an edited source
builds anew and an unchanged one is reused.  A failed build raises:
there is no other implementation to fall back to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / \
    "usearch12_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "usearch12_tpu_torch need the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libusearch12_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into library_path(); returns the path."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, f.stem + ".o") for f in cu]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, str(f)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for f, o in zip(cu, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [f"{f.name}:\n{log}" for f, p, log in zip(cu, procs, logs)
                  if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        out = os.path.join(tmp, so.name)
        r = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", out, *objs],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + r.stdout + r.stderr)
        os.replace(out, so)
    return so


def load_library():
    """The kernels' ctypes library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            i64 = ctypes.c_longlong
            lib.wavefront_fwd_launch.restype = i32
            lib.wavefront_fwd_launch.argtypes = [
                vp, vp, i32, i32,              # a_let, b_let, amax, bmax
                vp, vp, vp, vp,                # la, lb, dlo, bw
                vp, vp, vp, f32, f32,          # tb_off, order, gp, match,
                                               # mismatch
                i32, i32,                      # n_pairs, lanes
                vp, vp, vp,                    # tb, mlast, dlb
                vp]                            # stream
            lib.wavefront_trace_launch.restype = i32
            lib.wavefront_trace_launch.argtypes = [
                vp, i64, vp, vp,               # tb, tb_bytes, tb_off, order
                vp, i32,                       # mlast, bmax
                vp, vp, vp, vp, vp,            # dlb, la, lb, dlo, bw
                vp, i32, i32, i32,             # gp, n_pairs, nb_max, warp
                vp, vp, i32, vp,               # scores, ops, stride, lens
                vp]                            # stream
            lib.wavefront_trace_smem.restype = i32
            lib.wavefront_trace_smem.argtypes = [i32]
            lib.banded_nw_fwd_launch.restype = i32
            lib.banded_nw_fwd_launch.argtypes = [
                vp, vp, i32, i32,              # a_let, b_let, amax, bmax
                vp, vp, vp, vp,                # la, lb, dlo, bw
                vp, f32, f32,                  # gp, match, mismatch
                i32, i32,                      # n_pairs, width
                vp, vp, vp,                    # tb, mlast, dlb
                vp]                            # stream
            lib.banded_nw_fwd_cells.restype = i32
            lib.banded_nw_fwd_cells.argtypes = [i32]
            lib.banded_nw_chase_launch.restype = i32
            lib.banded_nw_chase_launch.argtypes = [
                vp, i32, vp, i32, vp,          # tb, amax, mlast, width, dlb
                vp, vp, vp, vp,                # la, lb, dlo, bw
                vp, i32,                       # gp, n_pairs
                vp, vp, vp, vp, i32,           # scores, states, tblast, ops,
                vp]                            # stride, stream
            lib.banded_nw_chase_geometry.restype = i32
            lib.banded_nw_chase_geometry.argtypes = [i32, i32, i32, i32, vp]
            lib.sintax_pick_hist_launch.restype = i32
            lib.sintax_pick_hist_launch.argtypes = [
                vp, vp, vp, i32,               # nuw, m, stream, stream_len
                i32, i32, i32, i32,            # boots, cq, uwmax, dtype
                vp, vp]                        # P, stream
            lib.sintax_pick_hist_tiles.restype = i32
            lib.sintax_pick_hist_tiles.argtypes = [i32, i32, i32, i32]
            lib.sintax_boot_count_select_launch.restype = i32
            lib.sintax_boot_count_select_launch.argtypes = [
                vp, i32, i32, i32, i32,        # P, dtype, cq, boots, uwmax
                vp, vp, vp, i64, i32, i32,     # words, nuw, w_mat, ld, V, T
                vp, vp, vp, vp,                # rr, part, winner, top
                vp]                            # stream
            lib.sintax_boot_partial_bytes.restype = i64
            lib.sintax_boot_partial_bytes.argtypes = [i32, i32, i32]
            lib.csr_rank_big_launch.restype = i32
            lib.csr_rank_big_launch.argtypes = [
                vp, vp, vp,                    # starts, sizes, postings
                vp, i32, i32, i32, i32, i32,   # meta, B, wmax, cap, T, K
                vp, i64,                       # spill, spill_total
                vp, vp, vp,                    # cand_key, cand_tgt, out
                vp]                            # stream
            lib.wavefront_cuda_error_string.restype = ctypes.c_char_p
            lib.wavefront_cuda_error_string.argtypes = [i32]
            _lib = lib
    return _lib


def check_launch(name: str, err: int) -> None:
    """Raise if a launch entry point returned a CUDA error."""
    if err != 0:
        msg = load_library().wavefront_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
