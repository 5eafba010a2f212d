"""Build a CUDA source for sm_90a with nvcc and load it with ctypes.

Every hand-written kernel of the port is a shared library with a plain C
interface. ``start`` writes the source into ``kernels/build/`` and starts
nvcc on it (so several sources build at once); ``finish`` waits for it,
keeps nvcc's log on that build and returns the library's path. A build is
keyed on the source, the shared headers of ``csrc/``, the nvcc command and
``nvcc --version``, so a changed source, flag or toolkit builds anew and
anything else reuses the library already on disk. A failed build raises
with nvcc's log.

All kernels build with ``-fmad=false``: nvcc would otherwise contract
``a * b + c`` into one fused multiply-add, which eager torch never does (each
op is its own rounded kernel). ``--use_fast_math`` is never used.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_VERSION: Dict[str, str] = {}
# builds started and not yet finished, by library stem: two programs with the
# same source share one nvcc run
_RUNNING: Dict[str, "Pending"] = {}


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's kernels build "
                           "from daft_tpu_torch/csrc/ on first use")
    return path


def _version(path: str) -> str:
    if path not in _VERSION:
        _VERSION[path] = subprocess.run([path, "--version"], capture_output=True, text=True,
                                        check=True).stdout
    return _VERSION[path]


class Pending:
    """One build: the library it makes, nvcc's process while it runs, and
    its log once it has run (None when the library was already on disk)."""

    __slots__ = ("name", "so", "proc", "tmp", "log_path", "log")

    def __init__(self, name: str, so: Path, proc=None, tmp=None, log_path=None):
        self.name = name
        self.so = so
        self.proc = proc
        self.tmp = tmp
        self.log_path = log_path
        self.log: Optional[str] = None

    def done(self) -> bool:
        """True once nvcc has exited (or there was nothing to build)."""
        return self.proc is None or self.proc.poll() is not None


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
    if stem in _RUNNING:
        return _RUNNING[stem]
    if so.exists():
        return Pending(name, so)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = BUILD_DIR / f"{stem}.cu"
    tmp_cu = cu.with_suffix(f".{os.getpid()}.cu")
    tmp_cu.write_text(source)
    os.replace(tmp_cu, cu)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    log_path = so.with_suffix(f".{os.getpid()}.log")
    with open(log_path, "w") as log:
        proc = subprocess.Popen([path, *FLAGS, "-I", str(CSRC), "-o", str(tmp), str(cu)],
                                stdout=log, stderr=subprocess.STDOUT)
    _RUNNING[stem] = Pending(name, so, proc, tmp, log_path)
    return _RUNNING[stem]


def finish(p: Pending) -> Path:
    """Wait for a build started by ``start``; raise with nvcc's log if it
    failed. Returns the library's path."""
    if p.proc is None:
        if not p.so.exists():  # a shared build that failed
            raise RuntimeError(f"nvcc failed on {p.name}:\n{p.log}")
        return p.so
    rc = p.proc.wait()
    log = p.log_path.read_text()
    p.log_path.unlink(missing_ok=True)
    p.log = log
    p.proc = None
    _RUNNING.pop(p.so.stem, None)
    if rc != 0:
        p.tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {p.name}:\n{log}")
    os.replace(p.tmp, p.so)
    return p.so
