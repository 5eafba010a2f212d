"""Build a CUDA source for sm_90a with nvcc and load it with ctypes.

Every hand-written kernel of the port is a shared library with a plain C
interface. ``start`` writes the source into ``kernels/build/`` and starts
nvcc on it (so several sources build at once); ``finish`` waits for it,
keeps nvcc's log on that build and returns the library's path. A build is
keyed on the source, the shared headers of ``csrc/``, the nvcc command and
``nvcc --version``, so a changed source, flag or toolkit builds anew and
anything else reuses the library already on disk. A missing nvcc, a failed
build (with nvcc's log) and a library that does not load raise
``DaftKernelError``, which the device path never catches.

Builds may be asked for from several threads at once (the query's worker
pool launches kernels): ``start`` looks up and registers a running build
under one module lock, so one source makes one nvcc run, and ``finish`` is
safe to call from every thread that holds the same ``Pending``: one thread
waits on nvcc and moves the library into place, the others wait for it.
Temporary and log names carry the process and thread ids.

All kernels build with ``-fmad=false``: nvcc would otherwise contract
``a * b + c`` into one fused multiply-add, which eager torch never does (each
op is its own rounded kernel). ``--use_fast_math`` is never used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

from ..errors import DaftKernelError

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_VERSION: Dict[str, str] = {}
# builds started and not yet finished, by library stem: two programs with the
# same source share one nvcc run
_RUNNING: Dict[str, "Pending"] = {}
# guards _RUNNING and _VERSION
_LOCK = threading.Lock()


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise DaftKernelError("nvcc not found (set CUDA_HOME): the port's kernels build "
                           "from daft_tpu_torch/csrc/ on first use")
    return path


def _version(path: str) -> str:
    with _LOCK:
        v = _VERSION.get(path)
    if v is None:
        v = subprocess.run([path, "--version"], capture_output=True, text=True,
                           check=True).stdout
        with _LOCK:
            v = _VERSION.setdefault(path, v)
    return v


class Pending:
    """One build: the library it makes, nvcc's process while it runs, and
    its log once it has run (None when the library was already on disk).
    The first thread to ``finish`` it claims the wait; ``ended`` is set once
    that thread has moved the library into place or recorded the failure."""

    __slots__ = ("name", "so", "proc", "tmp", "log_path", "log", "error", "claimed", "ended")

    def __init__(self, name: str, so: Path, proc=None, tmp=None, log_path=None):
        self.name = name
        self.so = so
        self.proc = proc
        self.tmp = tmp
        self.log_path = log_path
        self.log: Optional[str] = None
        self.error: Optional[str] = None
        self.claimed = proc is None
        self.ended = threading.Event()
        if proc is None:
            self.ended.set()

    def done(self) -> bool:
        """True once nvcc has exited (or there was nothing to build)."""
        proc = self.proc
        return proc is None or proc.poll() is not None


def start(source: str, name: str) -> Pending:
    """Start nvcc on ``source`` unless its library is already built; does
    not wait. ``name`` prefixes the library's file name."""
    path = nvcc()
    key = hashlib.sha256(source.encode())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.read_bytes())
    key.update("\0".join([path, *FLAGS, _version(path)]).encode())
    stem = f"{name}_{key.hexdigest()[:16]}"
    so = BUILD_DIR / f"{stem}.so"
    with _LOCK:
        running = _RUNNING.get(stem)
        if running is not None:
            return running
        if so.exists():
            return Pending(name, so)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu = BUILD_DIR / f"{stem}.cu"
        tag = f"{os.getpid()}.{threading.get_ident()}"
        tmp_cu = cu.with_suffix(f".{tag}.cu")
        tmp_cu.write_text(source)
        os.replace(tmp_cu, cu)
        tmp = so.with_suffix(f".{tag}.tmp")
        log_path = so.with_suffix(f".{tag}.log")
        with open(log_path, "w") as log:
            proc = subprocess.Popen([path, *FLAGS, "-I", str(CSRC), "-o", str(tmp), str(cu)],
                                    stdout=log, stderr=subprocess.STDOUT)
        p = _RUNNING[stem] = Pending(name, so, proc, tmp, log_path)
        return p


def finish(p: Pending) -> Path:
    """Wait for a build started by ``start``; raise with nvcc's log if it
    failed. Returns the library's path. Every thread holding ``p`` may call
    it: the first waits on nvcc, the others on that first thread."""
    with _LOCK:
        claim = not p.claimed
        p.claimed = True
    if not claim:
        p.ended.wait()
        if p.error is not None or not p.so.exists():
            raise DaftKernelError(f"nvcc failed on {p.name}:\n{p.error or p.log}")
        return p.so
    try:
        rc = p.proc.wait()
        log = p.log_path.read_text()
        p.log_path.unlink(missing_ok=True)
        p.log = log
        if rc != 0:
            p.tmp.unlink(missing_ok=True)
            p.error = log
            raise DaftKernelError(f"nvcc failed on {p.name}:\n{log}")
        os.replace(p.tmp, p.so)
        return p.so
    finally:
        p.proc = None
        with _LOCK:
            if _RUNNING.get(p.so.stem) is p:
                del _RUNNING[p.so.stem]
        p.ended.set()


def load(so: Path) -> ctypes.CDLL:
    """Load a built kernel library."""
    try:
        return ctypes.CDLL(str(so))
    except OSError as e:
        raise DaftKernelError(f"cannot load {so.name}: {e}") from e
