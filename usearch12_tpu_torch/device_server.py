"""The resident device server: one process holds the card, its kernels
and a DB's device arrays, and every command run of the port that finds it
sends its device work there over a unix socket, so that the command's own
process never imports torch nor starts CUDA.

Port of usearch12_tpu/device_server.py.  There the server hid the 150-280
s a fresh process paid before its first TPU dispatch; on the H100 a fresh
process of the port pays torch's import and the CUDA start (6.5-13.2 s,
PERF.md section 5), which the card's work of a ranking or SINTAX run
cannot win back.  A warm server also keeps what a run would upload: the
CSR postings of -device_rank (csr_load) and the SINTAX incidence
(sintax_load), by DB signature, at most two of each, and the hole DP's
aligners (align_load), one a class of gap penalties.

Protocol: one request per connection, an 8-byte big-endian length and a
pickle each way.  Requests (op, then the fields):
  ping                          -> pid, device, digest, served, busy,
                                   engines, launches, start
  <load op>  sig args           (KINDS: align_load, csr_load, sintax_load)
  <run op>  sig args            -> out, or need_load
                                (KINDS: align, csr_rank, sintax_boots)
  shutdown
A load builds an engine of its kind with card.py's LocalCard from args
and keeps it under sig; a run calls the method of the engine held under
sig with args, the call that the in-process route makes (card.py), and
answers need_load where the server holds none.
Every reply has "ok"; a failed request gets {"ok": False, "error"} and the
server goes on serving.  One thread serves each connection, so a ping
answers while the card works; one lock makes the card's work one request
at a time.

The socket lives in a 0700 directory under tempfile.gettempdir() named
by the uid and a digest of this package's files (path, size and mtime of
each), so a server of other code, another checkout's or an edited one's,
is never asked; ping returns the digest and the client checks it.  The
directory also holds the server's log (server.log) and the spawn lock.
The server exits after --idle seconds without a request (default 900,
or USEARCH_DEV_SERVER_IDLE).  USEARCH_DEV_SERVER=0 turns the route off.

Nothing here falls back.  A request the server does not answer, or
answers with an error, raises DeviceServerError, naming the log, and the
command fails.  The only other route is taken before any device work:
no server could be reached or spawned (connect() says why), and the
caller runs on the card in its own process (card.py:open_card).
"""

from __future__ import annotations

import hashlib
import os
import pickle
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
IDLE_S = 900.0
# a spawned server's start: torch's import, the CUDA start and the
# kernels' build (nvcc, when the checkout has not built them yet)
SPAWN_TIMEOUT = 600.0
SUN_PATH_MAX = 107
# engines kept a kind: one DB switch keeps the previous DB's
MAX_ENGINES = 2
# the engines a server holds, by card.py's factory that makes them: the
# op that loads one, the op that runs its method, that method, and the
# most kept (oldest evicted first; None: all, an aligner is 16 floats)
KINDS = {"aligner": ("align_load", "align", "align", None),
         "csr_chunks": ("csr_load", "csr_rank", "run_chunk", MAX_ENGINES),
         "boot_engine": ("sintax_load", "sintax_boots", "run_chunk",
                         MAX_ENGINES)}
OPS = ("ping",) + tuple(op for k in KINDS.values() for op in k[:2]) + (
    "shutdown",)


class DeviceServerError(RuntimeError):
    """The server did not answer a request, or answered with an error."""


def code_digest() -> str:
    """Digest of the path, size and mtime of every file of the package."""
    h = hashlib.sha1()
    for d, dirs, files in os.walk(PKG):
        dirs[:] = sorted(x for x in dirs if x != "__pycache__")
        for f in sorted(files):
            p = os.path.join(d, f)
            st = os.stat(p)
            h.update(f"{p}\0{st.st_size}\0{st.st_mtime_ns}\n".encode())
    return h.hexdigest()[:16]


class ServerPaths(NamedTuple):
    dir: str
    sock: str
    log: str
    lock: str


def server_paths(tmp: Optional[str] = None) -> ServerPaths:
    """The socket directory of this code's server under `tmp` (default
    tempfile.gettempdir())."""
    d = os.path.join(tmp or tempfile.gettempdir(),
                     f"usearch12_tpu_torch-{os.getuid()}-{code_digest()}")
    return ServerPaths(d, os.path.join(d, "sock"),
                       os.path.join(d, "server.log"),
                       os.path.join(d, "spawn.lock"))


def db_signature(index, *extra) -> tuple:
    """Identity of a run's DB for the server's resident engines (the JAX
    package's SintaxDeviceClassifier._db_sig): the -db file's path, mtime
    and size where there is one, else a digest of the postings, with the
    index's shape and a digest of its row sizes (options such as
    -wordlength change the index of one file), then `extra`."""
    from .config import options
    o = options()
    sizes = np.ascontiguousarray(index.sizes)
    shape = (int(index.params.slot_count), int(index.seq_count),
             int(sizes.sum()), hashlib.sha1(sizes).hexdigest()[:16])
    path = o.str("db") if o.filled("db") else None
    if path and os.path.exists(path):
        st = os.stat(path)
        head = ("path", os.path.abspath(path), int(st.st_mtime_ns),
                st.st_size)
    else:
        h = hashlib.sha1(sizes)
        h.update(np.ascontiguousarray(index.postings))
        head = ("hash", h.hexdigest())
    return head + shape + tuple(extra)


# ---------------------------------------------------------------- frames

def _send_frame(sock: socket.socket, obj) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(struct.pack(">Q", len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:])
        if not k:
            raise EOFError(f"peer closed after {got} of {n} bytes")
        got += k
    return buf


def _recv_frame(sock: socket.socket):
    (n,) = struct.unpack(">Q", _recv_exact(sock, 8))
    if n > (1 << 36):
        raise ValueError(f"oversized frame: {n} bytes")
    return pickle.loads(_recv_exact(sock, n))


# ---------------------------------------------------------------- client

class DeviceServerClient:
    """A connection a request to the server at `paths`."""

    def __init__(self, paths: ServerPaths, timeout: float = 3600.0):
        self.paths = paths
        self.timeout = timeout
        self.info: dict = {}   # the last ping's reply

    def _request(self, obj, timeout: Optional[float] = None) -> dict:
        op = obj.get("op")
        try:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                s.settimeout(self.timeout if timeout is None else timeout)
                s.connect(self.paths.sock)
                _send_frame(s, obj)
                rep = _recv_frame(s)
            finally:
                s.close()
        except (OSError, EOFError, ValueError, pickle.UnpicklingError,
                struct.error) as e:
            raise DeviceServerError(
                f"device server {self.paths.sock}: {op}: {e!r} (its log: "
                f"{self.paths.log})") from e
        if not isinstance(rep, dict) or not rep.get("ok"):
            err = rep.get("error", "?") if isinstance(rep, dict) else "?"
            raise DeviceServerError(
                f"device server: {op} failed: {err} (its log: "
                f"{self.paths.log})")
        return rep

    def ping(self, timeout: float = 5.0) -> dict:
        self.info = self._request({"op": "ping"}, timeout=timeout)
        return self.info

    def shutdown(self) -> None:
        self._request({"op": "shutdown"}, timeout=30.0)

    def run(self, kind: str, sig, args: tuple, load):
        """The method of the engine of `kind` that the server holds under
        `sig`, called there with args; when the server answers need_load
        (it holds no such engine), load() gives its load's args."""
        load_op, run_op = KINDS[kind][:2]
        req = {"op": run_op, "sig": sig, "args": args}
        rep = self._request(req)
        for _ in range(2):
            if not rep.get("need_load"):
                return rep["out"]
            self._request({"op": load_op, "sig": sig, "args": load()})
            rep = self._request(req)
        raise DeviceServerError(
            f"device server: {run_op} still needs {load_op} after two "
            f"loads (its log: {self.paths.log})")


def _live(cli: DeviceServerClient, digest: str) -> Optional[str]:
    """None when a server of this code answers at cli's socket, else why
    not."""
    try:
        try:
            rep = cli.ping()
        except DeviceServerError as e:
            if not isinstance(e.__cause__, socket.timeout):
                raise
            rep = cli.ping(timeout=30.0)
    except DeviceServerError:
        return "none"
    if rep.get("digest") != digest:
        return (f"the server at {cli.paths.sock} runs other code (digest "
                f"{rep.get('digest')}, this code's {digest})")
    return None


def connect(spawn: bool = True, paths: Optional[ServerPaths] = None
            ) -> Tuple[Optional[DeviceServerClient], str]:
    """(client, how) of a live server of this code, spawning one on the
    card when none answers and `spawn`; (None, why) where there is
    none."""
    if os.environ.get("USEARCH_DEV_SERVER", "1") == "0":
        return None, "USEARCH_DEV_SERVER=0"
    paths = paths or server_paths()
    if len(os.fsencode(paths.sock)) > SUN_PATH_MAX:
        return None, (f"the socket path {paths.sock} is longer than "
                      f"{SUN_PATH_MAX} bytes")
    cli = DeviceServerClient(paths)
    digest = code_digest()
    why = _live(cli, digest)
    if why is None:
        return cli, "live"
    if why != "none":
        return None, why
    if not spawn:
        return None, f"no device server at {paths.sock}"
    return _spawn(cli, digest)


def _tail(path: str) -> str:
    try:
        with open(path, "rb") as f:
            lines = f.read().decode(errors="replace").strip().splitlines()
        return lines[-1] if lines else ""
    except OSError:
        return ""


def _spawn(cli: DeviceServerClient, digest: str):
    """Start a server on the card (one process starts it, under the
    spawn lock; others wait for it) and wait until it answers."""
    paths = cli.paths
    os.makedirs(paths.dir, mode=0o700, exist_ok=True)
    if _stale(paths.lock):
        try:
            os.unlink(paths.lock)
        except FileNotFoundError:
            pass
    proc = None
    try:
        fd = os.open(paths.lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o600)
        os.write(fd, str(os.getpid()).encode())
        os.close(fd)
    except FileExistsError:
        pass
    else:
        try:
            try:
                os.unlink(paths.sock)
            except FileNotFoundError:
                pass
            pp = os.environ.get("PYTHONPATH")
            env = dict(os.environ, PYTHONPATH=ROOT + (os.pathsep + pp
                                                      if pp else ""))
            idle = os.environ.get("USEARCH_DEV_SERVER_IDLE", str(IDLE_S))
            with open(paths.log, "ab") as log:
                proc = subprocess.Popen(
                    [sys.executable, "-m", "usearch12_tpu_torch.device_server",
                     "--sock", paths.sock, "--idle", idle, "--device",
                     "cuda"], stdin=subprocess.DEVNULL, stdout=log,
                    stderr=log, env=env, cwd=ROOT, start_new_session=True)
        except BaseException:
            os.unlink(paths.lock)
            raise
    try:
        deadline = time.monotonic() + SPAWN_TIMEOUT
        while time.monotonic() < deadline:
            if proc is not None and proc.poll() is not None:
                return None, (f"the device server exited at its start with "
                              f"code {proc.returncode}: {_tail(paths.log)} "
                              f"(its log: {paths.log})")
            spawning = proc is not None or not _stale(paths.lock)
            why = _live(cli, digest)
            if why is None:
                return cli, "spawned" if proc is not None else "live"
            if why != "none":
                return None, why
            if not spawning:
                return None, (f"another process's server did not start: "
                              f"{_tail(paths.log)} (its log: {paths.log})")
            time.sleep(0.1)
        if proc is not None:
            proc.kill()
            proc.wait()
        return None, (f"no device server answered within "
                      f"{SPAWN_TIMEOUT:.0f} s (its log: {paths.log})")
    finally:
        if proc is not None:
            os.unlink(paths.lock)


def get_client(spawn: bool = True) -> Optional[DeviceServerClient]:
    """A client of a live server of this code (spawned if `spawn`), or
    None."""
    return connect(spawn)[0]


def _stale(lock: str) -> bool:
    """The spawn lock is absent, or was left by a spawner that has ended
    or by one older than a spawn may take (a lock whose pid is not
    written yet is a spawner's that has just begun)."""
    try:
        with open(lock) as f:
            pid = int(f.read() or 0)
        young = time.time() - os.path.getmtime(lock) < SPAWN_TIMEOUT
    except (OSError, ValueError):
        return True
    return not young or (pid != 0 and not _pid_alive(pid))


def _pid_alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def shutdown_server(paths: Optional[ServerPaths] = None) -> Optional[int]:
    """Stop this code's server, if one answers, and wait up to 10 s for
    its process to end; its pid, or None when none answered."""
    cli = DeviceServerClient(paths or server_paths())
    try:
        pid = cli.ping()["pid"]
        cli.shutdown()
    except DeviceServerError:
        return None
    deadline = time.monotonic() + 10.0
    while _pid_alive(pid) and time.monotonic() < deadline:
        time.sleep(0.05)
    return pid


# ---------------------------------------------------------------- server

def _serve(sock_path: str, idle_s: float, device: str) -> int:
    t0 = time.perf_counter()
    import contextlib

    import torch
    start = {"torch_import_s": time.perf_counter() - t0}
    if device == "cuda":
        if not torch.cuda.is_available():
            print("device_server: no CUDA device; not serving (--device "
                  "cpu runs the kernels' plain versions)", flush=True)
            return 1
        t0 = time.perf_counter()
        dev = torch.device("cuda", 0)
        torch.cuda.init()
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
        start["cuda_start_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        from . import _build
        _build.load_library()
        start["kernel_load_s"] = time.perf_counter() - t0
        on_dev = lambda: torch.cuda.device(dev)  # noqa: E731
    else:
        dev = torch.device("cpu")
        on_dev = contextlib.nullcontext
    from .card import LocalCard
    from .ops import sintax_boot, wavefront_nw, wavefront_trace
    print(f"device_server: {dev}, torch {torch.__version__}; start "
          + ", ".join(f"{k} {v:.3f}" for k, v in start.items()), flush=True)
    digest = code_digest()
    card = LocalCard(dev)
    engines = {kind: {} for kind in KINDS}
    by_op = {op: (kind, op == ops[1])
             for kind, ops in KINDS.items() for op in ops[:2]}

    def work(req: dict) -> dict:
        kind, runs = by_op[req["op"]]
        held, sig = engines[kind], req["sig"]
        if runs:
            eng = held.get(sig)
            if eng is None:
                return {"need_load": True}
            return {"out": getattr(eng, KINDS[kind][2])(*req["args"])}
        if sig not in held:
            most = KINDS[kind][3]
            while most is not None and len(held) >= most:
                held.pop(next(iter(held)))
            held[sig] = card.build(kind, *req["args"])
        return {}

    os.makedirs(os.path.dirname(sock_path), mode=0o700, exist_ok=True)
    try:
        os.unlink(sock_path)
    except FileNotFoundError:
        pass
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(sock_path)
    os.chmod(sock_path, 0o600)
    srv.listen(16)
    srv.settimeout(min(1.0, idle_s / 2))
    # exit-time cleanup removes this server's socket, not a successor's
    my_ino = os.stat(sock_path).st_ino
    print(f"device_server: serving on {sock_path} (pid {os.getpid()})",
          flush=True)
    state = {"last": time.monotonic(), "busy": 0,
             "served": {op: 0 for op in OPS}}
    state_lock = threading.Lock()
    card_lock = threading.Lock()   # one request's work on the card at a time
    stop = threading.Event()

    def ping() -> dict:
        with state_lock:
            served, busy = dict(state["served"]), state["busy"]
        return {"pid": os.getpid(), "device": str(dev), "digest": digest,
                "served": served, "busy": busy, "start": start,
                "engines": {k: len(v) for k, v in engines.items()},
                "launches": {
                    "wavefront_fwd": wavefront_nw.wavefront_fwd.launches,
                    "wavefront_trace":
                        wavefront_trace.wavefront_trace.launches,
                    "sintax_pick_hist": sintax_boot.pick_hist.launches,
                    "sintax_boot_count_select":
                        sintax_boot.boot_count_select.launches}}

    def handle(conn: socket.socket) -> None:
        op = None
        try:
            conn.settimeout(60.0)
            req = _recv_frame(conn)
            op = req.get("op") if isinstance(req, dict) else None
            if op == "ping":
                rep = ping()
            elif op == "shutdown":
                rep = {}
                stop.set()
            elif op in OPS:
                conn.settimeout(None)
                t_op = time.perf_counter()
                with state_lock:
                    state["busy"] += 1
                try:
                    with card_lock, on_dev():
                        rep = work(req)
                finally:
                    with state_lock:
                        state["busy"] -= 1
                print(f"device_server: {op} {time.perf_counter() - t_op:.3f}"
                      " s", flush=True)
            else:
                raise ValueError(f"unknown op {op!r}")
            with state_lock:
                state["served"][op] += 1
            _send_frame(conn, {"ok": True, **rep})
        except Exception as e:  # noqa: BLE001 - reply, log and serve on
            import traceback
            print(f"device_server: {op} failed:\n{traceback.format_exc()}",
                  flush=True)
            try:
                _send_frame(conn, {"ok": False, "error": repr(e)[:2000]})
            except OSError:
                pass
        finally:
            with state_lock:
                state["last"] = time.monotonic()
            conn.close()

    try:
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                with state_lock:
                    idle = (state["busy"] == 0
                            and time.monotonic() - state["last"] > idle_s)
                if idle:
                    print("device_server: idle, exiting", flush=True)
                    return 0
                continue
            with state_lock:
                state["last"] = time.monotonic()
            threading.Thread(target=handle, args=(conn,), daemon=True).start()
        print("device_server: shut down", flush=True)
        return 0
    finally:
        srv.close()
        try:
            if os.stat(sock_path).st_ino == my_ino:
                os.unlink(sock_path)
        except OSError:
            pass


def main(argv=None) -> int:
    import argparse
    pa = argparse.ArgumentParser(
        prog="python -m usearch12_tpu_torch.device_server",
        description="Serve the port's card work to its command runs.")
    pa.add_argument("--sock", default=None,
                    help="socket path (default: this code's, under the "
                         "temporary directory)")
    pa.add_argument("--idle", type=float, default=float(
        os.environ.get("USEARCH_DEV_SERVER_IDLE", IDLE_S)),
        help="exit after this many seconds without a request")
    pa.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the card; no card: exit 1) or cpu (the "
                         "kernels' plain versions)")
    args = pa.parse_args(argv)
    return _serve(args.sock or server_paths().sock, args.idle, args.device)


if __name__ == "__main__":
    sys.exit(main())
