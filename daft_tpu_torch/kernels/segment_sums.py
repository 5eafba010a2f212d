"""Masked segment sums: the K float-sum columns of a fused grouped aggregation
in one pass (the port of daft_tpu/kernels/pallas_ops.py's
``_masked_segment_sums_padded`` and ``masked_segment_sums``).

For group codes ``codes`` (n,1) int32, a 0/1 row mask (n,1) float32 and
values (n,K) float32, ``masked_segment_sums_padded`` returns the (G,K)
float32 sums of the selected rows of each group, Kahan-compensated across
1024-row blocks (naive float32 block accumulation drifts past 1e-6 relative on
TPC-H-scale money sums). Counts come from an exact host bincount in
``masked_segment_sums``: float32 accumulation stalls at 2^24 rows per group.

On a CUDA tensor the wrapper launches the hand-written kernel
csrc/masked_segment_sums.cu (built with nvcc for sm_90a on first use, loaded
with ctypes) or raises. On a CPU tensor it runs ``masked_segment_sums_plain``,
the same function in plain PyTorch. A row contributes only to its own group
and only when its mask is nonzero, so a NaN behind the mask or in another
group's row never leaks into a sum (the Pallas kernel's one-hot product lets
0 * NaN through; the host paths and the callers never rely on that).

Left out of this slice: ``build_fused_expr_sums``, the deep-fused variant that
evaluates the filter and the derived columns inside the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from .device import _kahan_combine

BLOCK_ROWS = 1024
MAX_GROUPS = 4096
_MAX_K = 32            # csrc MAX_K: wider K launches in column chunks
_OUTS_PER_THREAD = 4   # csrc OUTS_PER_THREAD
_CTAS_TARGET = 132 * 8  # ~8 CTAs on each of the H100's 132 SMs
_PLAIN_BATCH_ELEMS = 1 << 26  # rows x groups of one-hot per plain-version batch

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "masked_segment_sums.cu"
_BUILD_DIR = Path(__file__).resolve().parent / "build"

# kernel launches (CUDA only) and wrapper entries (any device): plain ints a
# run resets and reads to show which path it took
LAUNCHES = 0
ENTRIES = 0
BUILD_LOG = ""
_LIB: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (set CUDA_HOME): the segment-sums kernel "
                           "builds from csrc/masked_segment_sums.cu on first use")
    return nvcc


def build() -> ctypes.CDLL:
    """Compile csrc/masked_segment_sums.cu for sm_90a (once per source,
    command and nvcc version, into kernels/build/) and load it. Raises if
    nvcc fails."""
    global _LIB, BUILD_LOG
    if _LIB is not None:
        return _LIB
    nvcc = _nvcc()
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
    version = subprocess.run([nvcc, "--version"], capture_output=True, text=True, check=True).stdout
    key = hashlib.sha256(_SRC.read_bytes())
    key.update("\0".join([nvcc, *flags, version]).encode())
    so = _BUILD_DIR / f"masked_segment_sums_{key.hexdigest()[:16]}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *flags, "-o", str(tmp), str(_SRC)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        BUILD_LOG = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {_SRC.name}:\n{BUILD_LOG}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.masked_segment_sums_f32.argtypes = (
        [ctypes.c_void_p] * 5
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
           ctypes.c_longlong, ctypes.c_void_p])
    lib.masked_segment_sums_f32.restype = ctypes.c_int
    lib.masked_segment_sums_error_string.argtypes = [ctypes.c_int]
    lib.masked_segment_sums_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def launch_shape(n: int, num_groups: int, k: int) -> Tuple[int, int, int]:
    """(threads, grid_x, blocks_per_cta) of pass 1 for these shapes. It
    depends on the shapes only, so the summation order, and with it every
    bit of the result, is the same from run to run."""
    gk = num_groups * k
    threads = min(256, -(-gk // 32) * 32)
    tiles_y = -(-gk // (threads * _OUTS_PER_THREAD))
    nblocks = n // BLOCK_ROWS
    target = max(1, min(_CTAS_TARGET // tiles_y, (1 << 24) // gk))
    blocks_per_cta = -(-nblocks // target)
    return threads, -(-nblocks // blocks_per_cta), blocks_per_cta


def _check(codes, mask, vals, num_groups: int) -> None:
    n = vals.shape[0] if vals.dim() == 2 else -1
    if vals.dim() != 2 or codes.shape != (n, 1) or mask.shape != (n, 1):
        raise ValueError(f"expected codes (n,1), mask (n,1), vals (n,K); got "
                         f"{tuple(codes.shape)}, {tuple(mask.shape)}, {tuple(vals.shape)}")
    if (codes.dtype, mask.dtype, vals.dtype) != (torch.int32, torch.float32, torch.float32):
        raise ValueError(f"expected int32/float32/float32, got {codes.dtype}/{mask.dtype}/{vals.dtype}")
    if n % BLOCK_ROWS or not 1 <= num_groups <= MAX_GROUPS:
        raise ValueError(f"rows ({n}) must be a multiple of {BLOCK_ROWS} and groups "
                         f"({num_groups}) in [1, {MAX_GROUPS}]")
    if not (codes.device == mask.device == vals.device):
        raise ValueError("codes, mask and vals must be on one device")


def masked_segment_sums_padded(codes, mask, vals, num_groups: int):
    """(G,K) float32 sums of the selected rows of each group (see the module
    docstring). Launches the CUDA kernel on a CUDA tensor, runs the plain
    version on a CPU tensor."""
    global ENTRIES
    _check(codes, mask, vals, num_groups)
    ENTRIES += 1
    if vals.device.type == "cpu":
        return masked_segment_sums_plain(codes, mask, vals, num_groups)
    if vals.device.type != "cuda":
        raise ValueError(f"no masked segment-sums kernel for device {vals.device}")
    return _launch(codes.contiguous(), mask.contiguous(), vals, num_groups)


def _launch(codes, mask, vals, num_groups: int):
    global LAUNCHES
    lib = build()
    n, k = vals.shape
    out = torch.empty((num_groups, k), dtype=torch.float32, device=vals.device)
    if n == 0:
        return out.zero_()
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        for c0 in range(0, k, _MAX_K):
            kc = min(_MAX_K, k - c0)
            part = vals[:, c0:c0 + kc].contiguous()
            part_out = out if kc == k else torch.empty((num_groups, kc), dtype=torch.float32,
                                                       device=vals.device)
            threads, grid_x, bpc = launch_shape(n, num_groups, kc)
            # scratch (and a column chunk's copy) return to the caching
            # allocator when this function ends, while the kernel may still
            # run: safe, because the launch is on the stream they were
            # allocated on, so any reuse is ordered after it
            scratch = torch.empty(grid_x * num_groups * kc, dtype=torch.float32,
                                  device=vals.device)
            rc = lib.masked_segment_sums_f32(
                codes.data_ptr(), mask.data_ptr(), part.data_ptr(), part_out.data_ptr(),
                scratch.data_ptr(), n, kc, num_groups, threads, grid_x, bpc, stream)
            if rc != 0:
                raise RuntimeError("masked_segment_sums kernel launch failed: "
                                   + lib.masked_segment_sums_error_string(rc).decode())
            LAUNCHES += 1
            if part_out is not out:
                out[:, c0:c0 + kc] = part_out
    return out


def masked_segment_sums_plain(codes, mask, vals, num_groups: int):
    """The plain PyTorch version: per 1024-row block, the masked one-hot
    (rows x G) selects each row's values into its group and the block sums
    them in float32; then a sequential Kahan loop over the blocks in order.
    No matmul (so TF32 cannot enter); batches of blocks bound the one-hot's
    memory."""
    n, k = vals.shape
    nblk = n // BLOCK_ROWS
    groups = torch.arange(num_groups, dtype=torch.int32, device=vals.device)
    blocks = torch.empty((nblk, num_groups, k), dtype=torch.float32, device=vals.device)
    step = max(1, _PLAIN_BATCH_ELEMS // (BLOCK_ROWS * num_groups))
    for b0 in range(0, nblk, step):
        b1 = min(b0 + step, nblk)
        rows = slice(b0 * BLOCK_ROWS, b1 * BLOCK_ROWS)
        sel = ((codes[rows].view(b1 - b0, BLOCK_ROWS, 1) == groups)
               & (mask[rows].view(b1 - b0, BLOCK_ROWS, 1) != 0))
        v = vals[rows].view(b1 - b0, BLOCK_ROWS, k)
        for j in range(k):
            blocks[b0:b1, :, j] = torch.where(sel, v[:, :, j:j + 1], 0.0).sum(dim=1)
    if nblk == 0:
        return torch.zeros((num_groups, k), dtype=torch.float32, device=vals.device)
    return _kahan_combine(blocks)


def masked_segment_sums(codes: np.ndarray, mask: Optional[np.ndarray],
                        values: np.ndarray, num_groups: int,
                        device: str = "cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Fused sums + counts for K value columns grouped by ``codes``.

    codes: (n,) int group ids in [0, num_groups); mask: (n,) bool or None;
    values: (n, K) float64/float32 (NaNs allowed where masked out).
    Returns (sums (num_groups, K) float64, counts (num_groups,) int64).
    Sums accumulate in float32 with compensation across blocks."""
    n = len(codes)
    k = values.shape[1]
    if n == 0:
        return np.zeros((num_groups, k)), np.zeros(num_groups, np.int64)
    m = np.ones(n, np.float32) if mask is None else mask.astype(np.float32)
    if mask is None:
        counts = np.bincount(codes, minlength=num_groups).astype(np.int64)
    else:
        counts = np.bincount(codes[mask], minlength=num_groups).astype(np.int64)
    vk = np.where(m[:, None] > 0, values, 0.0).astype(np.float32)
    pad = (-n) % BLOCK_ROWS
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, codes.dtype)])
        m = np.concatenate([m, np.zeros(pad, np.float32)])
        vk = np.concatenate([vk, np.zeros((pad, k), np.float32)])
    dev = torch.device(device)
    out = masked_segment_sums_padded(
        torch.from_numpy(codes.astype(np.int32)[:, None]).to(dev),
        torch.from_numpy(m[:, None]).to(dev),
        torch.from_numpy(vk).to(dev), num_groups)
    return out.cpu().numpy().astype(np.float64), counts
