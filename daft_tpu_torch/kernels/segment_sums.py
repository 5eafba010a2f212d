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

The kernel's two passes are shared with the deep-fused kernel K2
(fused_expr_sums.py), which evaluates the filter and the derived columns
itself: csrc/segment_sums_common.cuh. Pass 1 has two loops that add in the
same order (so the plain version below equals both): one thread per
(block, column) chain with code-indexed sums in shared memory where G such
sums per chain fit (``pass1_loop``; the main path's G = 16), and one thread
per output above that.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from ..errors import DaftKernelError
from . import nvcc

BLOCK_ROWS = 1024
MAX_GROUPS = 4096
_MAX_K = 32            # csrc MAX_K: wider K launches in column chunks
_OUTS_PER_THREAD = 4   # csrc OUTS_PER_THREAD
_CTAS_TARGET = 132 * 8  # ~8 CTAs on each of the H100's 132 SMs

# pass 1's two loops (csrc SS_LOOP_*), which add in one order and so give the
# same bits; pass1_loop picks one
LOOP_OUTPUTS = 0  # each thread owns (g, k) outputs and walks every row: O(n G K)
LOOP_ROWS = 1     # one thread per (block, column) chain, code-indexed sums: O(n K)
LOOP_NAMES = {LOOP_OUTPUTS: "outputs", LOOP_ROWS: "rows"}
_ROW_THREADS = 128             # threads of a rows-loop CTA: at most this many chains
_ROW_STEP_BYTES = 20 * 1024    # one step's tiles of codes, mask and K values
_ROW_SMEM_BYTES = 48 * 1024    # csrc SS_ROW_SMEM_MAX: no opt-in attribute needed
_PLAIN_BATCH_ELEMS = 1 << 22  # blocks x groups x columns per plain-version batch

_SRC = nvcc.CSRC / "masked_segment_sums.cu"

# kernel launches (CUDA only) and wrapper entries (any device): plain ints a
# run resets and reads to show which path it took. Pool threads launch at
# once, so every increment holds COUNT_LOCK
LAUNCHES = 0
ENTRIES = 0
COUNT_LOCK = threading.Lock()
BUILD_LOG = ""
_LIB: Optional[ctypes.CDLL] = None
# one build and load of the library, whichever thread asks first
_BUILD_LOCK = threading.Lock()


def build() -> ctypes.CDLL:
    """Compile csrc/masked_segment_sums.cu for sm_90a (once per source,
    command and nvcc version, into kernels/build/) and load it. Raises if
    nvcc fails."""
    lib = _LIB
    if lib is None:
        with _BUILD_LOCK:
            lib = _LIB if _LIB is not None else finish_build(start_build())
    return lib


def start_build():
    """Start nvcc on K1's source without waiting (see nvcc.start), so a
    caller can build several kernels at once."""
    return nvcc.start(_SRC.read_text(), "masked_segment_sums")


def finish_build(pending) -> ctypes.CDLL:
    global _LIB, BUILD_LOG
    so = nvcc.finish(pending)
    if pending.log is not None:
        BUILD_LOG = pending.log
    _LIB = _bind(nvcc.load(so))
    return _LIB


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.masked_segment_sums_f32.argtypes = (
        [ctypes.c_void_p] * 5
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
           ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.masked_segment_sums_f32.restype = ctypes.c_int
    lib.masked_segment_sums_error_string.argtypes = [ctypes.c_int]
    lib.masked_segment_sums_error_string.restype = ctypes.c_char_p
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


def _row_step_rows(k: int) -> int:
    """Rows one step of the rows loop stages, over all of its blocks: the
    largest power of two up to 1024 whose codes, mask and k values fit in
    _ROW_STEP_BYTES (at least 32)."""
    rows = BLOCK_ROWS
    while rows > 32 and rows * (k + 2) * 4 > _ROW_STEP_BYTES:
        rows //= 2
    return rows


def row_tile(k: int, blocks_per_cta: int) -> Tuple[int, int]:
    """(nb, t) of the rows loop: the CTA walks its span nb blocks at a time
    (at most one chain per thread, and t >= 32) and stages t rows of each of
    them per step."""
    rows = min(_row_step_rows(k), 4 * _ROW_THREADS)  # codes: one vector a thread
    nb = max(1, min(blocks_per_cta, _ROW_THREADS // k, rows // 32))
    return nb, rows // (1 << (nb - 1).bit_length())


def _row_smem_bytes(num_groups: int, k: int, nb: int, t: int) -> int:
    """Dynamic shared memory of the rows loop (csrc ss_rows_smem_floats):
    codes and mask tiles, value tiles, the block sums [G][nb * k rounded up
    to 32], and the span's Kahan sum and compensation."""
    astride = -(-nb * k // 32) * 32
    return 4 * (nb * (t + 1) * (2 + k) + num_groups * astride + 2 * num_groups * k)


def pass1_loop(num_groups: int, k: int) -> int:
    """Pass 1's loop for G groups and k (<= 32) columns, from the shapes
    alone: LOOP_ROWS where the G accumulators of every chain fit in the CTA's
    shared memory at the largest tile (num_groups = 16 does, for every k),
    LOOP_OUTPUTS above that. Both loops add in one order, so the choice
    changes no bit of the result; a failure never selects a loop."""
    nb, t = row_tile(k, BLOCK_ROWS)
    return LOOP_ROWS if _row_smem_bytes(num_groups, k, nb, t) <= _ROW_SMEM_BYTES else LOOP_OUTPUTS


def pass1_args(n: int, num_groups: int, k: int) -> Tuple[int, int, int, int, int, int]:
    """(threads, grid_x, blocks_per_cta, loop, nb, t) of one launch: the span
    partition of ``launch_shape``, the loop of ``pass1_loop`` and, for the
    rows loop, its _ROW_THREADS threads and ``row_tile``."""
    threads, grid_x, bpc = launch_shape(n, num_groups, k)
    loop = pass1_loop(num_groups, k)
    if loop == LOOP_ROWS:
        return (_ROW_THREADS, grid_x, bpc, loop) + row_tile(k, bpc)
    return threads, grid_x, bpc, loop, 0, 0


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
    with COUNT_LOCK:
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
            threads, grid_x, bpc, loop, nb, t = pass1_args(n, num_groups, kc)
            # scratch (and a column chunk's copy) return to the caching
            # allocator when this function ends, while the kernel may still
            # run: safe, because the launch is on the stream they were
            # allocated on, so any reuse is ordered after it
            scratch = torch.empty(grid_x * num_groups * kc, dtype=torch.float32,
                                  device=vals.device)
            rc = lib.masked_segment_sums_f32(
                codes.data_ptr(), mask.data_ptr(), part.data_ptr(), part_out.data_ptr(),
                scratch.data_ptr(), n, kc, num_groups, threads, grid_x, bpc, loop, nb, t,
                stream)
            if rc != 0:
                raise DaftKernelError("masked_segment_sums kernel launch failed: "
                                   + lib.masked_segment_sums_error_string(rc).decode())
            with COUNT_LOCK:
                LAUNCHES += 1
            if part_out is not out:
                out[:, c0:c0 + kc] = part_out
    return out


def masked_segment_sums_plain(codes, mask, vals, num_groups: int):
    """The plain PyTorch version, in the kernel's own order of operations, so
    the two agree bit for bit: column chunks of at most 32 as launched; in
    each 1024-row block the rows are added in row order (a row adds only to
    its own group, only when its mask is set); each CTA's span of blocks
    (``launch_shape``) is Kahan-added in block order; then the spans' partials
    are Kahan-added in span order. No matmul (so TF32 cannot enter)."""
    n, k = vals.shape
    out = torch.empty((num_groups, k), dtype=torch.float32, device=vals.device)
    for c0 in range(0, k, _MAX_K):
        kc = min(_MAX_K, k - c0)
        out[:, c0:c0 + kc] = _plain_chunk(codes.view(n), mask.view(n), vals[:, c0:c0 + kc],
                                          num_groups)
    return out


def _kahan_step(acc, comp, x):
    y = x - comp
    t = acc + y
    return t, (t - acc) - y


def _plain_chunk(codes, mask, vals, num_groups: int):
    n, k = vals.shape
    dev = vals.device
    nblk = n // BLOCK_ROWS
    if nblk == 0:
        return torch.zeros((num_groups, k), dtype=torch.float32, device=dev)
    _threads, grid_x, bpc = launch_shape(n, num_groups, k)
    groups = torch.arange(num_groups, dtype=torch.int32, device=dev)
    # pass 1a: block sums, the rows of each block added in row order
    blocks = torch.zeros((grid_x * bpc, num_groups, k), dtype=torch.float32, device=dev)
    step = max(1, _PLAIN_BATCH_ELEMS // (num_groups * k))
    for b0 in range(0, nblk, step):
        b1 = min(b0 + step, nblk)
        rows = slice(b0 * BLOCK_ROWS, b1 * BLOCK_ROWS)
        cb = codes[rows].view(b1 - b0, BLOCK_ROWS)
        on = mask[rows].view(b1 - b0, BLOCK_ROWS) != 0
        vb = vals[rows].view(b1 - b0, BLOCK_ROWS, k)
        acc = blocks[b0:b1]
        for r in range(BLOCK_ROWS):
            hit = (cb[:, r, None] == groups) & on[:, r, None]
            acc += torch.where(hit[:, :, None], vb[:, r, None, :], 0.0)
    # pass 1b: each CTA Kahan-adds its span of blocks in block order
    spans = blocks.view(grid_x, bpc, num_groups, k)
    acc = torch.zeros((grid_x, num_groups, k), dtype=torch.float32, device=dev)
    comp = torch.zeros_like(acc)
    first = torch.arange(grid_x, device=dev) * bpc
    for j in range(bpc):
        live = (first + j < nblk)[:, None, None]  # the last span may be short
        t, c = _kahan_step(acc, comp, spans[:, j])
        acc, comp = torch.where(live, t, acc), torch.where(live, c, comp)
    partials = acc - comp
    # pass 2: Kahan over the spans' partials in span order
    acc = torch.zeros((num_groups, k), dtype=torch.float32, device=dev)
    comp = torch.zeros_like(acc)
    for x in range(grid_x):
        acc, comp = _kahan_step(acc, comp, partials[x])
    return acc


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
