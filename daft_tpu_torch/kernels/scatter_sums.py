"""Deterministic scatter sums: the float-sum branch of the masked segment
reductions above 4096 segments (the port of daft_tpu/kernels/device.py's
``_scatter_sum_kahan``, an XLA scatter in the reference, not a Pallas kernel).

For values (b,) float32 with the masked rows already 0.0, codes (b,) int32
and G segments, ``scatter_sum_kahan`` returns the (G,) float32 sums: the b
rows split into chunks of min(8192, b) rows; each chunk's sum of segment g
adds the chunk's rows with code g in row order, starting at +0.0; then the
chunk partials of each segment are Kahan-added in chunk order with the
operations of ``device._kahan_combine``. Rows whose code lies outside
[0, G) add nowhere.

On a CUDA tensor the wrapper launches the hand-written kernel
csrc/segment_scatter_sums.cu (built with nvcc for sm_90a on first use, loaded
with ctypes) or raises; torch's CUDA ``index_add_`` on float32 adds with
atomics in an order that changes from run to run, and the kernel uses none.
Pass 1 gives each segment of a chunk to one warp: the chunk's rows are
bucketed by owning warp, stably, in shared memory, and each warp adds only
its own bucket, each segment's rows in row order (see the source); pass 2 is
the Kahan walk, one thread a segment.

On a CPU tensor it runs ``scatter_sum_kahan_plain``, the same function on the
host: ``np.add.at`` in float32 (unbuffered, in index order) for the chunk
partials, then the Kahan loop in torch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import nvcc

CHUNK_ROWS = 8192  # device._REDUCE_CHUNK
_SMS = 132  # the H100's SMs: pass 1 spreads small chunk counts over them

_SRC = nvcc.CSRC / "segment_scatter_sums.cu"

# kernel launches (CUDA only) and wrapper entries (any device): plain ints a
# run resets and reads to show which path it took
LAUNCHES = 0
ENTRIES = 0
BUILD_LOG = ""
_LIB: Optional[ctypes.CDLL] = None


def build() -> ctypes.CDLL:
    """Compile csrc/segment_scatter_sums.cu for sm_90a (once per source,
    command and nvcc version, into kernels/build/) and load it. Raises if
    nvcc fails."""
    if _LIB is None:
        finish_build(start_build())
    return _LIB


def start_build():
    """Start nvcc on the kernel's source without waiting (see nvcc.start)."""
    return nvcc.start(_SRC.read_text(), "segment_scatter_sums")


def finish_build(pending) -> ctypes.CDLL:
    global _LIB, BUILD_LOG
    so = nvcc.finish(pending)
    if pending.log is not None:
        BUILD_LOG = pending.log
    lib = ctypes.CDLL(str(so))
    lib.segment_scatter_sums_f32.argtypes = (
        [ctypes.c_void_p] * 4
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.segment_scatter_sums_f32.restype = ctypes.c_int
    lib.segment_scatter_sums_error_string.argtypes = [ctypes.c_int]
    lib.segment_scatter_sums_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return _LIB


def chunk_rows(b: int) -> int:
    """Rows per chunk for b padded rows (b is a power-of-two bucket)."""
    return min(CHUNK_ROWS, b)


def ctas_per_chunk_log2(nch: int) -> int:
    """log2 of the CTAs pass 1 spreads each chunk over: the largest power of
    two (at most 32) that keeps the grid within one CTA per SM of the H100
    (132). It changes who adds, not the order of the additions."""
    s = 0
    while s < 5 and nch << (s + 1) <= _SMS:
        s += 1
    return s


def _check(values, codes, num_segments: int) -> None:
    if values.dim() != 1 or codes.shape != values.shape:
        raise ValueError(f"expected values (b,) and codes (b,); got {tuple(values.shape)}, "
                         f"{tuple(codes.shape)}")
    if (values.dtype, codes.dtype) != (torch.float32, torch.int32):
        raise ValueError(f"expected float32/int32, got {values.dtype}/{codes.dtype}")
    b = values.shape[0]
    if b == 0 or b % chunk_rows(b) or b % 128 or num_segments < 1:
        raise ValueError(f"rows ({b}) must be a positive multiple of {chunk_rows(b)} and of "
                         f"128, segments ({num_segments}) at least 1")
    if values.device != codes.device:
        raise ValueError("values and codes must be on one device")


def scatter_sum_kahan(values, codes, num_segments: int):
    """(G,) float32 segment sums (see the module docstring). Launches the CUDA
    kernel on a CUDA tensor, runs the plain version on a CPU tensor."""
    global ENTRIES
    _check(values, codes, num_segments)
    ENTRIES += 1
    if values.device.type == "cpu":
        return scatter_sum_kahan_plain(values, codes, num_segments)
    if values.device.type != "cuda":
        raise ValueError(f"no scatter-sums kernel for device {values.device}")
    return _launch(_aligned(values), _aligned(codes), num_segments)


def _aligned(x):
    """x contiguous and 16-byte aligned (the kernel loads four lanes at once)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(values, codes, num_segments: int):
    global LAUNCHES
    lib = build()
    b = values.shape[0]
    chunk = chunk_rows(b)
    out = torch.empty(num_segments, dtype=torch.float32, device=values.device)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        # scratch returns to the caching allocator when this function ends,
        # while the kernel may still run: safe, because the launch is on the
        # stream it was allocated on, so any reuse is ordered after it
        partials = torch.empty((b // chunk) * num_segments, dtype=torch.float32,
                               device=values.device)
        rc = lib.segment_scatter_sums_f32(values.data_ptr(), codes.data_ptr(),
                                          partials.data_ptr(), out.data_ptr(), b, chunk,
                                          num_segments, ctas_per_chunk_log2(b // chunk), stream)
    if rc != 0:
        raise RuntimeError("segment_scatter_sums kernel launch failed: "
                           + lib.segment_scatter_sums_error_string(rc).decode())
    LAUNCHES += 1
    return out


def scatter_sum_kahan_plain(values, codes, num_segments: int):
    """The plain version, in the kernel's order of operations, so the two
    agree bit for bit: per chunk, ``np.add.at`` adds the rows into float32
    partials starting at +0.0, unbuffered and in row order; then the
    partials are Kahan-added in chunk order in torch. Runs on the host and
    returns a tensor on ``values``' device."""
    b = values.shape[0]
    chunk = chunk_rows(b)
    nch = b // chunk
    v = values.detach().cpu().numpy().astype(np.float32, copy=False)
    c = codes.detach().cpu().numpy().astype(np.int64)
    keep = (c >= 0) & (c < num_segments)
    flat = np.arange(b, dtype=np.int64) // chunk * num_segments + c
    partials = np.zeros(nch * num_segments, dtype=np.float32)
    np.add.at(partials, flat[keep], v[keep])
    p = torch.from_numpy(partials).view(nch, num_segments)
    s = torch.zeros(num_segments, dtype=torch.float32)
    comp = torch.zeros(num_segments, dtype=torch.float32)
    for x in p:
        y = x - comp
        t = s + y
        comp = (t - s) - y
        s = t
    return s.to(values.device)
