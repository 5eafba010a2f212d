"""Deep-fused segment sums (K2): the port of daft_tpu/kernels/pallas_ops.py
``build_fused_expr_sums``.

The same reduction as K1 (segment_sums.py), but the filter predicate and the
K derived float columns are evaluated inside the kernel, per row, from the
raw staged (values, valid) columns. The (n, K) pre-masked matrix that the
composed route stacks in device memory for K1 is never written.

The kernel's per-row body is generated from the expression nodes:

- ``_Emitter`` translates every node that ``device._compile_node`` compiles
  (Column, Literal, Alias, Cast, Not, Between and every BinaryOp op) into
  C++ that computes the same (value, valid) lanes as the torch closures, bit
  for bit: the same type promotion (``torch.promote_types``), the same casts
  (a float-to-int cast is torch's CUDA cast: saturate to int32 with NaN to 0,
  then wrap to a narrower type), Kleene ``&``/``|``, floor-based ``//`` and ``%``, and integer
  division by zero giving null. ``**`` goes through ``powf``, which may
  differ from torch's CPU ``pow`` by 1 ulp.
- The generated row function is ``__host__ __device__``, so the CPU tests
  build it with g++ and hold it against the closures.
- The generated kernel's tile-fill step evaluates the row function into the
  same shared-memory tile that K1's step copies its operands into; the
  accumulation and the second pass are K1's (csrc/segment_sums_common.cuh).
  So K2's sums equal the composed route's (torch derive, stack, K1) bit for
  bit.
- Every distinct expression set is one nvcc build (kernels/nvcc.py), cached
  on disk by source. A build or launch failure raises; nothing falls back to
  K1.

On a CUDA tensor ``fused_expr_sums`` launches the kernel or raises; on a CPU
tensor it runs ``FusedExprSums.plain``: the same closures in torch, masked,
through ``segment_sums.masked_segment_sums_plain``.

Bound on an H100: the kernel reads the codes of every padded block once
(4 B per padded row) and each staged column's values and validity once for
the real rows only. TPC-H Q1 at SF1 (6,000,000 rows padded to 8,388,608;
four float32 columns and one int32 date, each with a 1-byte validity) is
34 MB of codes plus 25 B per real row, 184 MB, about 55 us at 3.35 TB/s;
Q6 (four columns) 154 MB, about 46 us. Pass 1 still walks the all-padding
blocks past n; skipping them would change the span layout that keeps K2
bit-identical to K1. A simple kernel that is right comes first: TMA-fed
tiles are later work.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

from . import nvcc
from .device import _jdt, _literal_to_physical
from .segment_sums import _MAX_K, BLOCK_ROWS, MAX_GROUPS, masked_segment_sums_plain, pass1_args

# engagement counters, plain ints a run resets and reads:
#   BUILDS   - compiled aggregation programs that took the deep route (one per
#              program and padded row count, the counterpart of the
#              reference's DEEP_FUSED_TRACES)
#   ENTRIES  - wrapper calls, on any device
#   LAUNCHES - CUDA kernel launches (one per column chunk of <= 32)
BUILDS = 0
ENTRIES = 0
LAUNCHES = 0

_CTYPES = {torch.bool: "bool", torch.int8: "int8_t", torch.int16: "int16_t",
           torch.int32: "int32_t", torch.float32: "float"}
# pointer type of a staged lane in device memory (torch.bool is one byte)
_PTR_TYPES = {torch.bool: "unsigned char", torch.int8: "int8_t", torch.int16: "int16_t",
              torch.int32: "int32_t", torch.float32: "float"}

_PRELUDE = r"""#include <math.h>
#include <stdint.h>
#include <string.h>

__host__ __device__ inline float fes_f32(uint32_t u) {
  float f;
  memcpy(&f, &u, sizeof f);
  return f;
}
// float -> int32 as torch's CUDA cast does it (cvt.rzi.s32.f32): truncate
// toward zero, saturate to the int32 range, NaN -> 0. torch's CUDA cast to
// int8 or int16 is this, then wrapped to the narrow type (300.0 -> 44).
__host__ __device__ inline int32_t fes_f2i(float x) {
  if (x != x) return 0;
  if (x >= 2147483648.0f) return 2147483647;
  if (x <= -2147483648.0f) return -2147483647 - 1;
  return static_cast<int32_t>(x);
}
// torch.floor_divide / torch.remainder on integers (b != 0); a / -1 wraps
__host__ __device__ inline int32_t fes_floordiv(int32_t a, int32_t b) {
  if (b == -1) return static_cast<int32_t>(0u - static_cast<uint32_t>(a));
  const int32_t q = a / b;
  const int32_t r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}
__host__ __device__ inline int32_t fes_floormod(int32_t a, int32_t b) {
  if (b == -1) return 0;
  const int32_t r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}
// torch.remainder on floats: fmod, then shifted into the divisor's sign
__host__ __device__ inline float fes_fremainder(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m += b;
  return m;
}
"""

_CMP_OPS = ("==", "!=", "<", "<=", ">", ">=")


def _literal_lane(value, dtype: torch.dtype) -> str:
    """C++ for the lane value torch.full((n,), value, dtype=dtype) holds.
    torch itself converts the python value, so the rounding is torch's."""
    t = torch.full((1,), value, dtype=dtype)
    if dtype == torch.float32:
        return f"fes_f32(0x{t.view(torch.int32).item() & 0xFFFFFFFF:08x}u)"
    if dtype == torch.bool:
        return "true" if bool(t.item()) else "false"
    v = int(t.item())
    text = "(-2147483647 - 1)" if v == -2 ** 31 else str(v)
    return f"static_cast<{_CTYPES[dtype]}>({text})"


def _cast(v: str, src: torch.dtype, dst: torch.dtype) -> str:
    """C++ for ``tensor.to(dst)`` of one element."""
    if src == dst:
        return v
    if dst == torch.bool:
        return f"({v} != 0)"
    if src == torch.bool:
        one, zero = ("1.0f", "0.0f") if dst == torch.float32 else ("1", "0")
        return f"static_cast<{_CTYPES[dst]}>({v} ? {one} : {zero})"
    if dst == torch.float32:
        return f"static_cast<float>({v})"
    if src == torch.float32:
        v = f"fes_f2i({v})"
        if dst == torch.int32:
            return v
    return f"static_cast<{_CTYPES[dst]}>({v})"  # int -> narrower int wraps, as torch does


def _int_arith(op: str, a: str, b: str, dt: torch.dtype) -> str:
    """Wrapping integer + - * in ``dt`` (signed overflow is undefined in C++:
    int32 goes through uint32; narrower types widen, then truncate)."""
    if dt == torch.int32:
        return (f"static_cast<int32_t>(static_cast<uint32_t>({a}) {op} "
                f"static_cast<uint32_t>({b}))")
    return f"static_cast<{_CTYPES[dt]}>(static_cast<int32_t>({a}) {op} static_cast<int32_t>({b}))"


class _Emitter:
    """Translate normalized expression nodes into the body of one row
    function. ``node`` returns (value, valid, torch dtype) of a node's lanes
    as ``device._compile_node``'s closure computes them; shared subtrees
    (by ``_key()``) are computed once. Columns read ``c.v<i>[r]`` and
    ``c.m<i>[r]``, where i is the column's index in ``names``."""

    def __init__(self, schema, dtypes: Dict[str, torch.dtype]):
        self.schema = schema
        self.dtypes = dtypes
        self.names = sorted(dtypes)
        self.lines: List[str] = []
        self._memo: Dict = {}

    def _let(self, dtype: torch.dtype, expr: str) -> str:
        name = f"t{len(self.lines)}"
        self.lines.append(f"const {_CTYPES[dtype]} {name} = {expr};")
        return name

    def node(self, nd) -> Tuple[str, str, torch.dtype]:
        key = _memo_key(nd)
        if key not in self._memo:
            self._memo[key] = self._emit(nd)
        return self._memo[key]

    def _emit(self, nd) -> Tuple[str, str, torch.dtype]:
        from ..expressions import Alias, Between, BinaryOp, Cast, Column, Literal, Not

        if isinstance(nd, Column):
            if nd.cname not in self.dtypes:
                raise ValueError(f"column {nd.cname!r} is not staged for the deep kernel")
            i = self.names.index(nd.cname)
            dt = self.dtypes[nd.cname]
            raw = f"c.v{i}[r]"
            v = self._let(dt, f"({raw} != 0)" if dt == torch.bool else raw)
            return v, self._let(torch.bool, f"(c.m{i}[r] != 0)"), dt
        if isinstance(nd, Literal):
            if nd.value is None:
                return self._let(torch.int32, "0"), "false", torch.int32
            jd = _jdt(nd.dtype)
            return (self._let(jd, _literal_lane(_literal_to_physical(nd.value, nd.dtype), jd)),
                    "true", jd)
        if isinstance(nd, Alias):
            return self.node(nd.child)
        if isinstance(nd, Cast):
            v, m, dt = self.node(nd.child)
            jd = _jdt(nd.dtype)
            return self._let(jd, _cast(v, dt, jd)), m, jd
        if isinstance(nd, Not):
            v, m, dt = self.node(nd.child)
            return self._let(dt, f"!{v}" if dt == torch.bool else f"~{v}"), m, dt
        if isinstance(nd, Between):
            xv, xm, xd = self.node(nd.child)
            lv, lm, ld = self.node(nd.lower)
            hv, hm, hd = self.node(nd.upper)
            ge = self._compare(">=", xv, xd, lv, ld)
            le = self._compare("<=", xv, xd, hv, hd)
            ge_m = self._let(torch.bool, f"{xm} && {lm}")
            le_m = self._let(torch.bool, f"{xm} && {hm}")
            # Kleene AND: valid when both valid, or either side is a valid False
            valid = self._let(torch.bool,
                              f"({ge_m} && {le_m}) || ({ge_m} && !{ge}) || ({le_m} && !{le})")
            return self._let(torch.bool, f"{ge} && {le}"), valid, torch.bool
        if isinstance(nd, BinaryOp):
            return self._binary(nd)
        raise ValueError(f"{type(nd).__name__} not device-compilable")

    def _compare(self, op: str, a: str, ad, b: str, bd) -> str:
        p = torch.promote_types(ad, bd)
        return self._let(torch.bool, f"{_cast(a, ad, p)} {op} {_cast(b, bd, p)}")

    def _binary(self, nd):
        lv, lm, ld = self.node(nd.left)
        rv, rm, rd = self.node(nd.right)
        op = nd.op
        both = f"{lm} && {rm}"
        if op in ("&", "|", "^"):
            p = torch.promote_types(ld, rd)
            a, b = _cast(lv, ld, p), _cast(rv, rd, p)
            if op == "^":
                expr = f"{a} != {b}" if p == torch.bool else f"static_cast<{_CTYPES[p]}>({a} ^ {b})"
                return self._let(p, expr), self._let(torch.bool, both), p
            if p == torch.bool:
                value = f"{a} && {b}" if op == "&" else f"{a} || {b}"
                lt, rt = (f"!{lv}", f"!{rv}") if op == "&" else (lv, rv)
            else:
                # bitwise on ints; the closure's Kleene lanes then read bit 0
                value = f"static_cast<{_CTYPES[p]}>({a} {op} {b})"
                lt, rt = ((f"((~{lv}) & 1)", f"((~{rv}) & 1)") if op == "&"
                          else (f"({lv} & 1)", f"({rv} & 1)"))
            # Kleene: valid if both valid, or either side decides the result
            valid = f"({both}) || ({lm} && {lt}) || ({rm} && {rt})"
            return self._let(p, value), self._let(torch.bool, valid), p
        if op in _CMP_OPS:
            return self._compare(op, lv, ld, rv, rd), self._let(torch.bool, both), torch.bool
        if op == "<=>":
            eq = self._compare("==", lv, ld, rv, rd)
            value = f"({eq} && {lm} && {rm}) || (!{lm} && !{rm})"
            return self._let(torch.bool, value), "true", torch.bool

        jd = _jdt(nd.to_field(self.schema).dtype)
        f32 = torch.float32
        valid = self._let(torch.bool, both)
        if op in ("+", "-", "*"):
            a, b = _cast(lv, ld, jd), _cast(rv, rd, jd)
            expr = f"{a} {op} {b}" if jd == f32 else _int_arith(op, a, b, jd)
            return self._let(jd, expr), valid, jd
        if op == "/":
            return self._let(f32, f"{_cast(lv, ld, f32)} / {_cast(rv, rd, f32)}"), valid, f32
        if op == "**":
            return self._let(f32, f"powf({_cast(lv, ld, f32)}, {_cast(rv, rd, f32)})"), valid, f32
        if op not in ("//", "%"):
            raise AssertionError(op)
        p = torch.promote_types(ld, rd)
        if p == f32:
            a, b = _cast(lv, ld, f32), _cast(rv, rd, f32)
            r = f"floorf({a} / {b})" if op == "//" else f"fes_fremainder({a}, {b})"
            return self._let(jd, _cast(self._let(f32, r), f32, jd)), valid, jd
        # integer // and % by zero: null (the divisor 0 is replaced by 1)
        safe = self._let(rd, f"({rv} == 0) ? {_cast('1', torch.int32, rd)} : {rv}")
        fn = "fes_floordiv" if op == "//" else "fes_floormod"
        q = self._let(p, _cast(f"{fn}({_cast(lv, ld, torch.int32)}, "
                                f"{_cast(safe, rd, torch.int32)})", torch.int32, p))
        valid = self._let(torch.bool, f"{both} && ({rv} != 0)")
        return self._let(jd, _cast(q, p, jd)), valid, jd


def _memo_key(nd):
    """``_key()`` plus the repr of every literal: ``_key()`` compares values
    with ==, which would merge lit(0.0) and lit(-0.0)."""
    from ..expressions import Literal

    lits = []

    def walk(n):
        if isinstance(n, Literal):
            lits.append(repr(n.value))
        for c in n.children():
            walk(c)

    walk(nd)
    return nd._key(), tuple(lits)


def lane_dtype(node, schema, dtypes: Dict[str, torch.dtype]) -> torch.dtype:
    """The torch dtype of ``node``'s value lane as ``device._compile_node``'s
    closure computes it over columns staged with ``dtypes``."""
    return _Emitter(schema, dtypes).node(node)[2]


def _cols_struct(names, dtypes) -> str:
    fields = "".join(f"  const {_PTR_TYPES[dtypes[nm]]}* v{i};\n  const unsigned char* m{i};\n"
                     for i, nm in enumerate(names))
    return f"struct FesCols {{\n{fields}}};\n"


def _bind_cols(names, dtypes, target: str) -> str:
    return "".join(
        f"  {target}.v{i} = static_cast<const {_PTR_TYPES[dtypes[nm]]}*>(cols[{2 * i}]);\n"
        f"  {target}.m{i} = static_cast<const unsigned char*>(cols[{2 * i + 1}]);\n"
        for i, nm in enumerate(names))


def probe_source(nodes, schema, dtypes: Dict[str, torch.dtype]) -> Tuple[str, List[torch.dtype]]:
    """C++ (host or device) of ``fes_probe_rows(cols, n, outs)``, which writes
    the (value, valid) lanes of each node for rows [0, n): outs[2j] gets node
    j's values, outs[2j+1] its validity as bytes. Returns the source and each
    node's lane dtype. Lets the emitter be checked node by node on the CPU."""
    em = _Emitter(schema, dtypes)
    roots = [em.node(nd) for nd in nodes]
    stores = "".join(
        f"  static_cast<{_PTR_TYPES[dt]}*>(outs[{2 * j}])[r] = {v};\n"
        f"  static_cast<unsigned char*>(outs[{2 * j + 1}])[r] = {m};\n"
        for j, (v, m, dt) in enumerate(roots))
    body = "".join(f"  {ln}\n" for ln in em.lines)
    src = (_PRELUDE + _cols_struct(em.names, dtypes)
           + "__host__ __device__ inline void fes_probe(const FesCols& c, long long r, "
             "void* const* outs) {\n" + body + stores + "}\n"
           + 'extern "C" void fes_probe_rows(void* const* cols, long long n, void* const* outs) {\n'
             "  FesCols c;\n" + _bind_cols(em.names, dtypes, "c")
           + "  for (long long r = 0; r < n; ++r) fes_probe(c, r, outs);\n}\n")
    return src, [dt for _, _, dt in roots]


class FusedExprSums:
    """One deep-fused kernel: a predicate (or None) and K float-valued child
    nodes over columns staged with ``dtypes`` (name -> value lane dtype).
    Holds the generated source, its build and its plain version."""

    def __init__(self, pred_node, child_nodes, schema, dtypes: Dict[str, torch.dtype]):
        from ..expressions import required_columns
        from .device import _compile_node

        need = set()
        for nd in ([pred_node] if pred_node is not None else []) + list(child_nodes):
            need.update(required_columns(nd))
        for name in need:
            if dtypes.get(name) not in _CTYPES:
                raise ValueError(f"column {name!r} has no deep-kernel lane "
                                 f"(staged as {dtypes.get(name)})")
        self.names = sorted(need)
        self.dtypes = {nm: dtypes[nm] for nm in self.names}
        self.k = len(child_nodes)
        if self.k < 1:
            raise ValueError("the deep kernel needs at least one sum column")
        em = _Emitter(schema, self.dtypes)
        sel = "true"
        if pred_node is not None:
            pv, pm, pd = em.node(pred_node)
            sel = f"{_cast(pv, pd, torch.bool)} && {pm}"
        outs = []
        for nd in child_nodes:
            v, m, dt = em.node(nd)
            if not dt.is_floating_point:
                raise ValueError(f"deep-kernel column {nd.display()} computes as {dt}, not float")
            outs.append((_cast(v, dt, torch.float32), m))
        body = "".join(f"  {ln}\n" for ln in em.lines)
        # operations per row beyond the loads, for the kernel's bound
        self.row_ops = sum(1 for ln in em.lines if "c.v" not in ln and "c.m" not in ln)
        stores = "".join(f"  out[{j}] = ({m} && s) ? {v} : 0.0f;\n"
                         for j, (v, m) in enumerate(outs))
        # the row function: sel, then each column masked by its validity and sel
        self.row_source = (
            _PRELUDE + _cols_struct(self.names, self.dtypes)
            + "__host__ __device__ inline void fes_row(const FesCols& c, long long r, "
              "bool* sel, float* out) {\n" + body + f"  const bool s = {sel};\n  *sel = s;\n"
            + stores + "}\n")
        self.source = _KERNEL_TEMPLATE.format(
            row=self.row_source, k=self.k, bind=_bind_cols(self.names, self.dtypes, "fill.c"))
        self._pred_fn = _compile_node(pred_node, schema)[0] if pred_node is not None else None
        self._child_fns = [_compile_node(nd, schema)[0] for nd in child_nodes]
        self._lib: Optional[ctypes.CDLL] = None
        self._pending = None
        self.build_log: Optional[str] = None

    def host_source(self) -> str:
        """The row function plus a host loop ``fes_rows(cols, n, sel, out)``
        over rows [0, n) (out is (n, K) row major): the CPU tests build this
        with g++ and hold it against the torch closures."""
        return (self.row_source
                + 'extern "C" void fes_rows(void* const* cols, long long n, unsigned char* sel, '
                  "float* out) {\n  FesCols c;\n" + _bind_cols(self.names, self.dtypes, "c")
                + "  for (long long r = 0; r < n; ++r) {\n    bool s;\n"
                  f"    fes_row(c, r, &s, out + r * {self.k});\n    sel[r] = s;\n  }}\n}}\n")

    # ---------------------------------------------------------------- build
    def start_build(self) -> Optional[nvcc.Pending]:
        """Start nvcc on the generated source without waiting (``build``
        then waits for it). Returns the pending build, None once loaded."""
        if self._lib is None and self._pending is None:
            self._pending = nvcc.start(self.source, "fused_expr_sums")
        return self._pending

    def build(self) -> ctypes.CDLL:
        """Build (once, cached on disk by source) and load the kernel."""
        if self._lib is None:
            self.start_build()
            lib = ctypes.CDLL(str(nvcc.finish(self._pending)))
            self.build_log = self._pending.log
            self._pending = None
            lib.fused_expr_sums_f32.argtypes = (
                [ctypes.c_void_p] * 4
                + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p])
            lib.fused_expr_sums_f32.restype = ctypes.c_int
            lib.fused_expr_sums_error_string.argtypes = [ctypes.c_int]
            lib.fused_expr_sums_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    # ----------------------------------------------------------------- runs
    def check(self, codes, env, n: int, num_groups: int) -> None:
        b = codes.shape[0]
        if codes.dtype != torch.int32 or codes.dim() not in (1, 2) or codes.numel() != b:
            raise ValueError(f"expected codes (n,) or (n,1) int32, got "
                             f"{tuple(codes.shape)} {codes.dtype}")
        if b % BLOCK_ROWS or not 1 <= num_groups <= MAX_GROUPS or not 0 <= n <= b:
            raise ValueError(f"padded rows ({b}) must be a multiple of {BLOCK_ROWS}, groups "
                             f"({num_groups}) in [1, {MAX_GROUPS}] and rows ({n}) in [0, {b}]")
        for name in self.names:
            if name not in env:
                raise ValueError(f"column {name!r} is missing")
            v, m = env[name]
            if v.shape != (b,) or m.shape != (b,):
                raise ValueError(f"column {name!r}: expected ({b},) lanes, got "
                                 f"{tuple(v.shape)} and {tuple(m.shape)}")
            if v.dtype != self.dtypes[name] or m.dtype != torch.bool:
                raise ValueError(f"column {name!r}: expected {self.dtypes[name]}/bool lanes, "
                                 f"got {v.dtype}/{m.dtype}")
            if v.device != codes.device or m.device != codes.device:
                raise ValueError(f"column {name!r} is not on {codes.device}")

    def operands(self, codes, env, n: int):
        """K1's operands for the same sums: (codes (b,1), the predicate as a
        0/1 float mask (b,1), the K columns each masked by its validity and
        the predicate (b,K)), from the torch closures. This is what the
        composed route builds in device memory and K2 never writes."""
        b = codes.shape[0]
        env = {name: env[name] for name in self.names}
        sel = torch.arange(b, dtype=torch.int32, device=codes.device) < n
        if self._pred_fn is not None:
            pv, pm = self._pred_fn(env)
            sel = pv & pm & sel
        cols = []
        for fn in self._child_fns:
            v, m = fn(env)
            cols.append(torch.where(m & sel, v.to(torch.float32), 0.0))
        return codes.view(b, 1), sel.to(torch.float32)[:, None], torch.stack(cols, dim=1)

    def plain(self, codes, env, n: int, num_groups: int):
        """The plain PyTorch version: ``operands`` through K1's plain version,
        which adds in the kernels' order, so it equals K2 bit for bit."""
        return masked_segment_sums_plain(*self.operands(codes, env, n), num_groups)

    def launch(self, codes, env, n: int, num_groups: int):
        global LAUNCHES
        lib = self.build()
        b = codes.shape[0]
        dev = codes.device
        lanes = [t.contiguous() for name in self.names for t in env[name]]
        ptrs = (ctypes.c_void_p * len(lanes))(*[t.data_ptr() for t in lanes])
        codes = codes.contiguous()
        out = torch.empty((num_groups, self.k), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            for c0 in range(0, self.k, _MAX_K):
                kc = min(_MAX_K, self.k - c0)
                part = out if kc == self.k else torch.empty((num_groups, kc), dtype=torch.float32,
                                                            device=dev)
                threads, grid_x, bpc, loop, nb, t = pass1_args(b, num_groups, kc)
                # scratch and the lanes go back to the caching allocator when
                # this returns, while the kernel may still run: safe, because
                # the launch is on their stream, so any reuse is ordered after it
                scratch = torch.empty(grid_x * num_groups * kc, dtype=torch.float32, device=dev)
                rc = lib.fused_expr_sums_f32(codes.data_ptr(), ptrs, part.data_ptr(),
                                             scratch.data_ptr(), b, n, c0, kc, num_groups,
                                             threads, grid_x, bpc, loop, nb, t, stream)
                if rc != 0:
                    raise RuntimeError("fused_expr_sums kernel launch failed: "
                                       + lib.fused_expr_sums_error_string(rc).decode())
                LAUNCHES += 1
                if part is not out:
                    out[:, c0:c0 + kc] = part
        return out


_KERNEL_TEMPLATE = r"""// Generated by daft_tpu_torch/kernels/fused_expr_sums.py: K2, the deep-fused
// segment sums, for one expression set. Replaces the Pallas TPU kernel
// daft_tpu/kernels/pallas_ops.py build_fused_expr_sums.
#include "segment_sums_common.cuh"

{row}
#define FES_K {k}

// K2's tile-fill step: evaluate the predicate and the K columns of each row
// of the tiles (t rows of each of nb blocks) into the shared-memory tiles K1
// would copy its operands into, one row per thread at a time. Rows at or
// past n (the bucket's padding) are not selected.
struct FesFill {{
  FesCols c;
  long long n;
  int c0;
  int kc;

  __device__ __forceinline__ void operator()(long long r0, int nb, int t, float* s_mask,
                                             int mask_stride, float* s_vals,
                                             int vals_stride) const {{
    for (int e = threadIdx.x; e < nb * t; e += blockDim.x) {{
      const int b = e / t;
      const int r = e - b * t;
      const long long row = r0 + static_cast<long long>(b) * ROWS_PER_BLOCK + r;
      bool sel = false;
      float v[FES_K];
      if (row < n) {{
        fes_row(c, row, &sel, v);
      }} else {{
        for (int j = 0; j < FES_K; ++j) v[j] = 0.0f;
      }}
      s_mask[b * mask_stride + r] = sel ? 1.0f : 0.0f;
      float* dst = s_vals + b * vals_stride + r * kc;
      for (int j = 0; j < kc; ++j) dst[j] = v[c0 + j];
    }}
  }}
}};

extern "C" {{

// codes [n_pad] int32; cols: values and validity pointer of each column, in
// the generator's column order; out [g, kc] float32 gets columns
// [c0, c0 + kc); partials [grid_x, g, kc] float32 scratch. Rows [n, n_pad)
// are padding. threads, grid_x, blocks_per_cta, loop, nb and t as
// segment_sums.pass1_args gives them. Launches on `stream`, does not
// synchronise, returns cudaGetLastError().
int fused_expr_sums_f32(const void* codes, void* const* cols, void* out, void* partials,
                        long long n_pad, long long n, int c0, int kc, int g, int threads,
                        int grid_x, long long blocks_per_cta, int loop, int nb, int t,
                        void* stream) {{
  if (c0 < 0 || c0 + kc > FES_K) return static_cast<int>(cudaErrorInvalidValue);
  FesFill fill;
{bind}  fill.n = n;
  fill.c0 = c0;
  fill.kc = kc;
  return ss_launch(codes, fill, out, partials, n_pad, kc, g, threads, grid_x, blocks_per_cta,
                   loop, nb, t, stream);
}}

const char* fused_expr_sums_error_string(int code) {{
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}}

}}  // extern "C"
"""

_PROGRAMS: Dict = {}


def program(pred_node, child_nodes, schema, dtypes: Dict[str, torch.dtype]) -> FusedExprSums:
    """The deep kernel of this expression set, generated once per process."""
    key = (pred_node._key() if pred_node is not None else None,
           tuple(nd._key() for nd in child_nodes),
           tuple((f.name, f.dtype) for f in schema),
           tuple(sorted((k, str(v)) for k, v in dtypes.items())))
    prog = _PROGRAMS.get(key)
    if prog is None:
        prog = _PROGRAMS[key] = FusedExprSums(pred_node, child_nodes, schema, dtypes)
    return prog


def programs() -> List[FusedExprSums]:
    """Every deep kernel generated in this process so far."""
    return list(_PROGRAMS.values())


def fused_expr_sums(prog: FusedExprSums, codes, env, n: int, num_groups: int):
    """(G, K) float32 sums of the K columns of ``prog`` over the selected rows
    of each group. ``env`` maps column names to (values, valid) lanes of the
    padded length of ``codes``; rows at or past ``n`` are padding. Launches
    the CUDA kernel on a CUDA tensor, runs the plain version on a CPU
    tensor."""
    global ENTRIES
    prog.check(codes, env, n, num_groups)
    ENTRIES += 1
    if codes.device.type == "cpu":
        return prog.plain(codes, env, n, num_groups)
    if codes.device.type != "cuda":
        raise ValueError(f"no deep-fused segment-sums kernel for device {codes.device}")
    return prog.launch(codes, env, n, num_groups)
