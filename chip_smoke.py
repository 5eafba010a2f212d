"""Chip smoke test of the PyTorch/CUDA port (daft_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card (an H100; the
kernels build for sm_90a):

    python3 chip_smoke.py                # every phase, TPC-H SF1 and SF10
    python3 chip_smoke.py --scales 1     # a shorter run: SF1 only
    python3 chip_smoke.py --profile      # also trace warm Q1/Q6 and deep Q1 at the first scale
    python3 chip_smoke.py --kernels-only # phases 1 and 2 only, for iterating on a kernel

Phases, each of which fails the run:
  1. build every kernel of the main path from the sources in the checkout,
     all nvcc runs at once: K1 (csrc/masked_segment_sums.cu) and the K2
     sources (generated by kernels/fused_expr_sums.py) of every deep plan the
     script drives and of the phase-2 edge cases. The deep plans' K2 programs
     are found by running those plans once on a 4096-row frame on the CPU,
     where K2 takes its plain version and builds nothing;
  2. hold each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it, at edge cases and on both sides of the
     crossover between pass 1's two loops (segment_sums.pass1_loop: the
     largest G that takes the row-parallel loop and the smallest that takes
     the output-parallel one), and time it (CUDA events) beside its bound,
     the plain version and one library call; K1 also with sorted codes, each
     block one group, the longest dependent chain through shared memory.
     K2's operands are the ones the engine hands it for SF1 Q1 and Q6,
     captured from a run through the engine; K2 must equal its plain version
     and the composed route (torch derive, stack, K1) bit for bit;
  3. drive TPC-H Q1 and Q6 through daft_tpu_torch.from_arrow(...).collect()
     on the card in the 32-bit device mode, through K1 (the composed route)
     and through K2 (use_deep_fusion_kernel), and Q1 written with
     with_column through a device-resident plan segment (DeviceSegmentOp),
     with K2 and with K1; hold every result against the pyarrow oracle of
     benchmarks/tpch.py at rtol 1e-6; check that each path ran on the card
     through its kernel (its launch count, set to 0 just before the path and
     read just after), and time deep against composed back to back.

The last line of standard output is {"ok": true, "device": {...}} when every
phase passed; the exit code is 0 only then. The line before it is the card's
name and power limit as nvidia-smi reports them, and the line before that is
the kernel table as one JSON object: each kernel's pass-1 loop at the main
path's shape (`loop`), its time over its bound (`x_bound`) and its launches
on the main path (null with --kernels-only, which skips phase 3). Every
check line names the loop it ran. Imports nothing of jax or daft_tpu.
"""

from __future__ import annotations

import argparse
import datetime
import json
import statistics
import subprocess
import sys
import time
import traceback

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12      # fp32 outside the tensor cores, H100 SXM data sheet
RTOL = 1e-6
SF1_BUCKET = 8_388_608       # size_bucket of SF1's 6,000,000 lineitem rows


def q1(lineitem):
    """TPC-H Q1 (pricing summary report) over a daft_tpu_torch DataFrame."""
    from daft_tpu_torch import col

    disc_price = col("l_extendedprice") * (1 - col("l_discount"))
    charge = disc_price * (1 + col("l_tax"))
    return (
        lineitem
        .where(col("l_shipdate") <= datetime.date(1998, 9, 2))
        .groupby("l_returnflag", "l_linestatus")
        .agg(
            col("l_quantity").sum().alias("sum_qty"),
            col("l_extendedprice").sum().alias("sum_base_price"),
            disc_price.sum().alias("sum_disc_price"),
            charge.sum().alias("sum_charge"),
            col("l_quantity").mean().alias("avg_qty"),
            col("l_extendedprice").mean().alias("avg_price"),
            col("l_discount").mean().alias("avg_disc"),
            col("l_quantity").count().alias("count_order"),
        )
        .sort(["l_returnflag", "l_linestatus"])
    )


def q1_with_columns(lineitem):
    """TPC-H Q1 with its derived columns written as with_column steps, as
    DataFrame users write them: it plans as one DeviceSegmentOp."""
    from daft_tpu_torch import col

    return (
        lineitem
        .with_column("disc_price", col("l_extendedprice") * (1 - col("l_discount")))
        .with_column("charge", col("disc_price") * (1 + col("l_tax")))
        .where(col("l_shipdate") <= datetime.date(1998, 9, 2))
        .groupby("l_returnflag", "l_linestatus")
        .agg(
            col("l_quantity").sum().alias("sum_qty"),
            col("l_extendedprice").sum().alias("sum_base_price"),
            col("disc_price").sum().alias("sum_disc_price"),
            col("charge").sum().alias("sum_charge"),
            col("l_quantity").mean().alias("avg_qty"),
            col("l_extendedprice").mean().alias("avg_price"),
            col("l_discount").mean().alias("avg_disc"),
            col("l_quantity").count().alias("count_order"),
        )
        .sort(["l_returnflag", "l_linestatus"])
    )


def q6(lineitem):
    """TPC-H Q6 (forecasting revenue change) over a daft_tpu_torch DataFrame."""
    from daft_tpu_torch import col

    return (
        lineitem
        .where((col("l_shipdate") >= datetime.date(1994, 1, 1))
               & (col("l_shipdate") < datetime.date(1995, 1, 1))
               & (col("l_discount") >= 0.05)
               & (col("l_discount") <= 0.07)
               & (col("l_quantity") < 24))
        .agg((col("l_extendedprice") * col("l_discount")).sum().alias("revenue"))
    )


def parity(got: dict, want: dict, rtol: float) -> bool:
    """bench.py's _parity rule: same keys and lengths, floats within
    max(rtol * |want|, 1e-6), everything else equal."""
    if set(got) != set(want):
        return False
    for k in want:
        if len(got[k]) != len(want[k]):
            return False
        for a, b in zip(got[k], want[k]):
            if isinstance(b, float):
                if abs(a - b) > max(rtol * abs(b), 1e-6):
                    return False
            elif a != b:
                return False
    return True


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and fp32 operations over the fp32 rate."""
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_FP32_FLOPS * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def loop_name(g: int, k: int) -> str:
    """Pass 1's loop for G groups and K columns (one launch's chunk)."""
    from daft_tpu_torch.kernels import segment_sums as ss

    return ss.LOOP_NAMES[ss.pass1_loop(g, min(k, 32))]


def crossover(k: int) -> tuple:
    """(largest G that takes the rows loop, smallest G that takes the
    outputs loop) for K columns."""
    from daft_tpu_torch.kernels import segment_sums as ss

    rows = [g for g in range(1, ss.MAX_GROUPS + 1) if ss.pass1_loop(g, k) == ss.LOOP_ROWS]
    return max(rows), max(rows) + 1


def same_bits(a, b) -> bool:
    """Bit-for-bit equality of two float32 tensors (NaN payloads included)."""
    import torch

    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


class Phases:
    def __init__(self):
        self.failures = []

    def check(self, ok: bool, what: str) -> bool:
        print(("PASS " if ok else "FAIL ") + what, flush=True)
        if not ok:
            self.failures.append(what)
        return ok


# ---------------------------------------------------------------------------
# phase 1: builds
# ---------------------------------------------------------------------------

DEEP_PLANS = {"q1": q1, "q6": q6, "q1_with_columns": q1_with_columns}


def edge_specs():
    """Phase-2 edge cases of K2 over a synthetic schema: name -> (predicate
    or None, child expressions)."""
    from daft_tpu_torch import DataType, col

    derived = [col("x") * col("y"), col("x") - col("y") * 2.5, col("x") / col("y")]
    return {
        "nan_nulls_ragged": (col("d") < 50, derived),
        "k33": (col("d") < 80, [col("x") * (j + 1) + col("y") for j in range(33)]),
        "rejects_all": (col("d") > 1000, derived),
        "casts": (None, [col("f").cast(DataType.int8()).cast(DataType.float64()),
                         col("f").cast(DataType.int16()).cast(DataType.float64()),
                         col("f").cast(DataType.int32()).cast(DataType.float64()),
                         col("f") // col("y"), col("f") % col("y"),
                         (col("d") // 7).cast(DataType.float64()),
                         ((col("d") % 7) * 3 - 2).cast(DataType.float64())]),
    }


def edge_schema():
    from daft_tpu_torch import DataType, Field, Schema

    return Schema([Field("x", DataType.float64()), Field("y", DataType.float64()),
                   Field("d", DataType.int64()), Field("f", DataType.float64())])


def edge_programs() -> dict:
    import torch

    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels.device import normalize_and_check

    schema = edge_schema()
    dtypes = {"x": torch.float32, "y": torch.float32, "d": torch.int32, "f": torch.float32}
    progs = {}
    for name, (pred, kids) in edge_specs().items():
        pnode = normalize_and_check([pred], schema)[0] if pred is not None else None
        progs[name] = fes.program(pnode, normalize_and_check(kids, schema), schema, dtypes)
    return progs


def enumerate_deep_programs() -> list:
    """The K2 programs of every deep plan the main path drives: the engine
    plans each one on a 4096-row frame on the CPU (K2's plain version there),
    which generates the same programs the card runs at every scale."""
    import daft_tpu_torch as dtt
    from benchmarks import tpch
    from daft_tpu_torch.kernels import fused_expr_sums as fes

    dtt.set_execution_config(dtt.ExecutionConfig(device="cpu", device_min_rows=1,
                                                 use_deep_fusion_kernel=True))
    small = dtt.from_arrow(tpch.generate_lineitem_only(
        scale=4096 / tpch.LINEITEM_ROWS_PER_SF, seed=1)).collect()
    for plan in DEEP_PLANS.values():
        plan(small).collect()
    return fes.programs()


def phase_build(ph: Phases) -> dict:
    """Start nvcc on K1 and every K2 program at once, wait for all, and
    print each build's time. Returns the edge-case programs."""
    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels import segment_sums as ss

    edges = edge_programs()
    progs = enumerate_deep_programs()
    t0 = time.perf_counter()
    k1_job = ss.start_build()
    jobs = {"K1 masked_segment_sums": k1_job}
    for i, prog in enumerate(progs):
        jobs[f"K2 program {i} (K={prog.k}, columns {','.join(prog.names)})"] = prog.start_build()
    done = {}
    while len(done) < len(jobs):
        for name, job in jobs.items():
            if name not in done and (job is None or job.done()):
                done[name] = time.perf_counter() - t0
        time.sleep(0.05)
    ss.finish_build(k1_job)
    for prog in progs:
        prog.build()
    for name, secs in done.items():
        print(f"built {name} in {secs:.2f}s (all builds started together)", flush=True)
    ph.check(len(progs) >= len(DEEP_PLANS) + len(edges),
             f"phase 1: {len(progs)} K2 programs and K1 built for sm_90a")
    logs = [("K1", ss.BUILD_LOG)] + [(f"K2 program {i}", p.build_log) for i, p in enumerate(progs)]
    for label, log in logs:
        for line in (log or "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"ptxas {label}: " + line.strip(), flush=True)
    fes.LAUNCHES = fes.ENTRIES = 0
    return edges


# ---------------------------------------------------------------------------
# phase 2: K1
# ---------------------------------------------------------------------------

def k1_operands(n: int, g: int, k: int, seed: int, used_groups: int = 6):
    """Main-path-shaped K1 operands on the card: codes over `used_groups` of
    the g slots, a mask keeping ~98% of rows (Q1's filter), money-like values."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    codes = torch.randint(0, used_groups, (n, 1), generator=gen, device="cuda", dtype=torch.int32)
    mask = (torch.rand((n, 1), generator=gen, device="cuda") < 0.98).to(torch.float32)
    vals = torch.rand((n, k), generator=gen, device="cuda") * 104100.0 + 900.0
    return codes, mask, vals


def exact64(codes, mask, vals, g):
    """float64 sums and summed magnitudes per group (the oracle)."""
    import torch

    v = torch.where(mask != 0, vals.double(), 0.0)
    idx = codes.view(-1).long()
    sums = torch.zeros((g, vals.shape[1]), dtype=torch.float64, device=vals.device).index_add_(0, idx, v)
    mags = torch.zeros_like(sums).index_add_(0, idx, v.abs())
    return sums, mags


def check_k1(ph: Phases, name: str, codes, mask, vals, g: int) -> float:
    """Kernel vs plain version (bit for bit: the plain version adds in the
    kernel's order) and vs float64 at rtol 1e-6 of the summed magnitudes, and
    two launches bit for bit. Returns max |kernel - plain|."""
    import torch

    from daft_tpu_torch.kernels import segment_sums as ss

    a = ss.masked_segment_sums_padded(codes, mask, vals, g)
    b = ss.masked_segment_sums_padded(codes, mask, vals, g)
    torch.cuda.synchronize()
    plain = ss.masked_segment_sums_plain(codes, mask, vals, g)
    sums, mags = exact64(codes, mask, vals, g)
    bnd = RTOL * mags + 1e-30
    name = f"{name} [{loop_name(g, vals.shape[1])} loop]"
    ph.check(torch.equal(a, b), f"K1 {name}: two launches agree bit for bit")
    ph.check(same_bits(a, plain), f"K1 {name}: equals its plain version bit for bit")
    ok_exact = bool(((a.double() - sums).abs() <= bnd).all())
    err = float((a - plain).abs().max())
    ph.check(ok_exact and bool(torch.isfinite(a).all()),
             f"K1 {name}: matches float64 at rtol {RTOL} (max |kernel-plain| {err:.6g})")
    return err


def phase_k1(ph: Phases) -> dict:
    """Phase 2, K1 against its plain version; returns its kernel-table entry."""
    import numpy as np
    import torch

    from daft_tpu_torch.kernels import segment_sums as ss

    n = SF1_BUCKET
    entry = {"name": "masked_segment_sums", "route": "cuda",
             "source": "daft_tpu_torch/csrc/masked_segment_sums.cu",
             "replaces": "daft_tpu/kernels/pallas_ops.py:66"}
    shapes = {}
    for k in (7, 1):  # Q1 and Q6 at SF1
        codes, mask, vals = k1_operands(n, 16, k, seed=k)
        err = check_k1(ph, f"main path n={n} G=16 K={k}", codes, mask, vals, 16)
        vk = torch.where(mask != 0, vals, 0.0)
        idx = codes.view(-1)
        ms = cuda_ms(lambda: ss.masked_segment_sums_padded(codes, mask, vals, 16), iters=20)
        plain_ms = cuda_ms(lambda: ss.masked_segment_sums_plain(codes, mask, vals, 16),
                           iters=2, warmup=1)
        library_ms = cuda_ms(lambda: torch.zeros((16, k), device="cuda").index_add_(0, idx, vk),
                             iters=20)
        shapes[k] = {"loop": loop_name(16, k), "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms,
                     **bound(n * (4 + 4 + 4 * k) + 16 * k * 4, 2 * n * k),
                     "library_ms": library_ms}
        shapes[k]["x_bound"] = ms / shapes[k]["bound_ms"]
        if k == 7:  # each block one group: every row of a chain hits one sum
            codes_sorted = torch.sort(codes.view(-1)).values.view(n, 1)
            check_k1(ph, f"sorted codes n={n} G=16 K={k}", codes_sorted, mask, vals, 16)
            shapes[k]["sorted_codes_ms"] = cuda_ms(
                lambda: ss.masked_segment_sums_padded(codes_sorted, mask, vals, 16), iters=20)
            del codes_sorted
        print("K1 timing " + json.dumps({"n": n, "G": 16, "K": k, **shapes[k]}), flush=True)
        del codes, mask, vals, vk
    entry.update(shapes[7])

    # edge cases: the widest group bucket, an all-masked block, NaN behind the
    # mask, more columns than one launch takes, and a padded ragged tail
    codes, mask, vals = k1_operands(1 << 20, 4096, 2, seed=11, used_groups=4096)
    check_k1(ph, "G=4096", codes, mask, vals, 4096)
    for g in crossover(7):  # both sides of the loops' crossover at Q1's K
        codes, mask, vals = k1_operands(1 << 20, g, 7, seed=g, used_groups=g)
        check_k1(ph, f"crossover G={g} K=7", codes, mask, vals, g)
    codes, mask, vals = k1_operands(1 << 16, 16, 3, seed=12)
    mask[3 * 1024:4 * 1024] = 0  # one whole block masked out
    vals[mask.view(-1) == 0, 1] = float("nan")  # NaN behind the mask
    check_k1(ph, "all-masked block + NaN behind the mask", codes, mask, vals, 16)
    codes, mask, vals = k1_operands(1 << 14, 16, 40, seed=13)
    check_k1(ph, "K=40 (two launches)", codes, mask, vals, 16)
    rng = np.random.RandomState(14)
    nr = 1_000_003
    c = rng.randint(0, 7, nr)
    m = rng.rand(nr) < 0.9
    v = rng.rand(nr, 3) * 68000 + 900
    got, cnt = ss.masked_segment_sums(c, m, v, 16, device="cuda")
    want = np.zeros((16, 3))
    for j in range(3):
        np.add.at(want[:, j], c[m], v[m, j])
    ph.check(bool(np.all(np.abs(got - want) <= RTOL * np.abs(want)))
             and (cnt == np.bincount(c[m], minlength=16)).all(),
             f"K1 ragged tail n={nr}: numpy-level wrapper matches float64, counts exact")
    return entry


# ---------------------------------------------------------------------------
# phase 2: K2
# ---------------------------------------------------------------------------

def capture_k2_operands(frame, plan) -> tuple:
    """Run ``plan`` through the engine on the card with deep fusion and
    return the (program, codes, env, n, groups) it handed K2."""
    import daft_tpu_torch as dtt
    from daft_tpu_torch.kernels import fused_expr_sums as fes

    seen = []
    wrapped = fes.fused_expr_sums

    def record(prog, codes, env, n, num_groups):
        seen.append((prog, codes, {k: env[k] for k in prog.names}, n, num_groups))
        return wrapped(prog, codes, env, n, num_groups)

    dtt.set_execution_config(dtt.ExecutionConfig(use_deep_fusion_kernel=True))
    fes.fused_expr_sums = record
    try:
        plan(frame).collect()
    finally:
        fes.fused_expr_sums = wrapped
    if len(seen) != 1:
        raise RuntimeError(f"expected one K2 call, the engine made {len(seen)}")
    return seen[0]


def check_k2(ph: Phases, name: str, prog, codes, env, n: int, g: int) -> dict:
    """K2 against its plain version and the composed route (the same
    operands through K1), both bit for bit, and two launches bit for bit."""
    import torch

    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels import segment_sums as ss

    a = fes.fused_expr_sums(prog, codes, env, n, g)
    b = fes.fused_expr_sums(prog, codes, env, n, g)
    torch.cuda.synchronize()
    plain = prog.plain(codes, env, n, g)
    composed = ss.masked_segment_sums_padded(*prog.operands(codes, env, n), g)
    name = f"{name} [{loop_name(g, prog.k)} loop]"
    ph.check(same_bits(a, b), f"K2 {name}: two launches agree bit for bit")
    ph.check(same_bits(a, plain), f"K2 {name}: equals its plain version bit for bit")
    ph.check(same_bits(a, composed), f"K2 {name}: equals the composed route (torch derive, "
                                     f"stack, K1) bit for bit")
    diff = (a - plain).abs()
    return {"max_abs_err": float(torch.nan_to_num(diff, nan=float("inf")).max())}


def time_k2(prog, codes, env, n: int, g: int) -> dict:
    import torch

    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels import segment_sums as ss

    b = codes.shape[0]
    _c, _m, vk = prog.operands(codes, env, n)
    idx = codes.view(-1)
    out = {
        "ms": cuda_ms(lambda: fes.fused_expr_sums(prog, codes, env, n, g), iters=20),
        "composed_ms": cuda_ms(
            lambda: ss.masked_segment_sums_padded(*prog.operands(codes, env, n), g), iters=20),
        "plain_ms": cuda_ms(lambda: prog.plain(codes, env, n, g), iters=2, warmup=1),
        # the library call for the reduction part: no single torch call
        # evaluates K2's expressions and sums them
        "library_ms": cuda_ms(
            lambda: torch.zeros((g, prog.k), device="cuda").index_add_(0, idx, vk), iters=20),
    }
    # pass 1 reads the codes of every padded block, and a column's values and
    # validity only for the n real rows; the row body runs on those rows alone
    row_bytes = sum(env[nm][0].element_size() + 1 for nm in prog.names)
    nbytes = b * 4 + n * row_bytes + g * prog.k * 4
    out.update(bound(nbytes, n * (2 * prog.k + prog.row_ops)))
    out["x_bound"] = out["ms"] / out["bound_ms"]
    return out


def edge_env(n_pad: int, seed: int):
    """Synthetic columns of edge_schema() on the card: NaN in x wherever
    d >= 50 (behind Q-shaped predicates), about 10% nulls, f with NaN, +-inf
    and values outside every int range, and garbage in the padding rows."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    d = torch.randint(0, 100, (n_pad,), generator=gen, device="cuda", dtype=torch.int32)
    x = torch.rand(n_pad, generator=gen, device="cuda") * 1000 + 1
    x = torch.where(d >= 50, float("nan"), x)
    y = torch.rand(n_pad, generator=gen, device="cuda") * 9 - 4.5
    f = (torch.rand(n_pad, generator=gen, device="cuda") - 0.5) * 2e5
    specials = torch.tensor([float("nan"), float("inf"), float("-inf"), 1e10, -1e10, 127.9,
                             -128.9, 128.0, -129.0, 32767.5, -32769.0, 2147483648.0,
                             -2147483904.0, -0.0, 0.0], device="cuda")
    f[:len(specials)] = specials
    valid = {k: torch.rand(n_pad, generator=gen, device="cuda") > 0.1 for k in "xydf"}
    return {"x": (x, valid["x"]), "y": (y, valid["y"]), "d": (d, valid["d"]),
            "f": (f, valid["f"])}


def phase_k2(ph: Phases, lineitem, edges: dict) -> dict:
    """Phase 2, K2: the SF1 Q1 and Q6 operands the engine gives it, then the
    edge cases; returns its kernel-table entry."""
    import torch

    import daft_tpu_torch as dtt

    entry = {"name": "fused_expr_sums", "route": "cuda",
             "source": "daft_tpu_torch/kernels/fused_expr_sums.py",
             "replaces": "daft_tpu/kernels/pallas_ops.py:86"}
    frame = dtt.from_arrow(lineitem).collect()
    shapes = {}
    for qname, plan in (("q1", q1), ("q6", q6)):
        prog, codes, env, n, g = capture_k2_operands(frame, plan)
        print(f"K2 {qname} operands: n={n} padded to {codes.shape[0]}, G={g}, K={prog.k}, "
              "columns " + ", ".join(f"{nm} {env[nm][0].dtype}" for nm in prog.names),
              flush=True)
        shapes[qname] = check_k2(ph, f"main path {qname} n={codes.shape[0]} G={g} K={prog.k}",
                                 prog, codes, env, n, g)
        shapes[qname].update(loop=loop_name(g, prog.k), **time_k2(prog, codes, env, n, g))
        print(f"K2 timing {qname} " + json.dumps(shapes[qname]), flush=True)
    entry.update(shapes["q1"])
    del frame
    torch.cuda.empty_cache()

    n_pad = 1 << 20
    below, above = crossover(edges["nan_nulls_ragged"].k)
    for name, n, g in (("nan_nulls_ragged", n_pad - 77, 16), ("nan_nulls_ragged", n_pad, 4096),
                       ("nan_nulls_ragged", n_pad - 77, below),
                       ("nan_nulls_ragged", n_pad - 77, above),
                       ("k33", n_pad, 16), ("rejects_all", n_pad, 16), ("casts", n_pad, 16)):
        env = edge_env(n_pad, seed=len(name) + g)
        gen = torch.Generator(device="cuda").manual_seed(g)
        codes = torch.randint(0, g, (n_pad,), generator=gen, device="cuda", dtype=torch.int32)
        prog = edges[name]
        check_k2(ph, f"edge {name} n={n} of {n_pad} G={g} K={prog.k}", prog, codes, env, n, g)
        if name == "rejects_all":
            out = prog.plain(codes, env, n, g)
            ph.check(bool((out == 0).all()), "K2 edge rejects_all: every sum is 0")
    return entry


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def profile_queries(queries: dict, frame, rows: int, card: str, reps: int = 5) -> None:
    """torch.profiler over `reps` warm runs of each query: wall and device-busy
    time per query, the device's idle share, and the top kernels by device
    time. Prints one JSON line per query."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for name, query in queries.items():
        query(frame).collect().to_pydict()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                query(frame).collect().to_pydict()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        # device-side events only (kernels, memcpys): the aten:: host ops
        # also carry the device time of the kernels they launched
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
        print(f"profile {name} " + json.dumps({
            "rows": rows, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device_events": sum(e.count for e in kernels) // reps, "card": card,
            "top": [[e.key[:80], e.count // reps, e.self_device_time_total / 1e3 / reps]
                    for e in top]}), flush=True)


def warm_median(query, frame, runs: int = 5) -> dict:
    import torch

    warm = []
    for _ in range(runs):
        t0 = time.perf_counter()
        query(frame).collect().to_pydict()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    return {"warm_median_s": statistics.median(warm), "warm_min_s": min(warm),
            "warm_max_s": max(warm), "warm_runs": len(warm)}


def drive(ph: Phases, label: str, query, frame, want: dict, deep: bool, segment: bool,
          group_codes: bool = False) -> dict:
    """Drive one path once through the engine (cold), with the kernels'
    launch counts set to 0 just before and read just after; check the result
    and that the path ran on the card through its kernel."""
    import daft_tpu_torch as dtt
    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels import segment_sums as ss

    dtt.set_execution_config(dtt.ExecutionConfig(use_deep_fusion_kernel=deep))
    ss.LAUNCHES = fes.LAUNCHES = 0
    t0 = time.perf_counter()
    df = query(frame).collect()
    got = df.to_pydict()
    cold = time.perf_counter() - t0
    k1, k2 = ss.LAUNCHES, fes.LAUNCHES
    c = df.stats.snapshot()["counters"]
    ph.check(parity(got, want, RTOL), f"{label}: matches the pyarrow oracle at rtol {RTOL}")
    on_card = (c.get("device_aggregations", 0) >= 1 and c.get("device_agg_fallbacks", 0) == 0
               and (k2, k1) == ((1, 0) if deep else (0, 1)))
    if segment:
        on_card = on_card and c.get("device_resident_segments") == 1 \
            and c.get("segment_fallbacks", 0) == 0
    if group_codes:  # the first grouped query on a frame computes its codes on the card
        on_card = on_card and c.get("device_group_codes", 0) >= 1
    ph.check(on_card, f"{label}: ran on the card through {'K2' if deep else 'K1'} "
                      f"(K1 launches {k1}, K2 launches {k2}, counters {c})")
    return {"cold_s": cold, "k1_launches": k1, "k2_launches": k2}


def phase_main_path(ph: Phases, scale: float, lineitem, card: str, profile: bool) -> dict:
    """Phase 3 at one scale factor: Q1/Q6 composed (K1) and deep (K2), then
    the with_column Q1 through a DeviceSegmentOp with K2 and with K1."""
    import torch

    import daft_tpu_torch as dtt
    from benchmarks import tpch

    rows = lineitem.num_rows
    want = {"q1": tpch.oracle_q1(lineitem), "q6": {"revenue": [tpch.oracle_q6(lineitem)]}}
    queries = {"q1": q1, "q6": q6}
    out = {"rows": rows, "k1_launches": 0, "k2_launches": 0}

    def record(key, res):
        res.update(rows=rows, card=card)
        if "warm_median_s" in res:
            res["warm_rows_per_s"] = rows / res["warm_median_s"]
        out[key] = res
        out["k1_launches"] += res.get("k1_launches", 0)
        out["k2_launches"] += res.get("k2_launches", 0)
        print(f"SF{scale:g} {key} " + json.dumps(res), flush=True)

    frame = dtt.from_arrow(lineitem).collect()
    for name, query in queries.items():  # the composed route through K1
        res = drive(ph, f"SF{scale:g} {name}", query, frame, want[name], deep=False,
                    segment=False, group_codes=name == "q1")
        record(name, {**res, **warm_median(query, frame)})
    for name, query in queries.items():  # the deep route through K2
        res = drive(ph, f"SF{scale:g} {name} deep", query, frame, want[name], deep=True,
                    segment=False)
        # deep against composed, back to back (bench.py's q1_deep_pallas_vs_composed)
        res.update({f"deep_{k}": v for k, v in warm_median(query, frame).items()})
        dtt.set_execution_config(dtt.ExecutionConfig(use_deep_fusion_kernel=False))
        res.update({f"composed_{k}": v for k, v in warm_median(query, frame).items()})
        res["composed_over_deep"] = res["composed_warm_median_s"] / res["deep_warm_median_s"]
        record(f"{name}_deep", res)
    if profile:
        profile_queries(queries, frame, rows, card)
        dtt.set_execution_config(dtt.ExecutionConfig(use_deep_fusion_kernel=True))
        profile_queries({"q1_deep": q1}, frame, rows, card)
    del frame
    torch.cuda.empty_cache()

    # the map chain: a fresh frame, so the first run stages its columns
    frame = dtt.from_arrow(lineitem).collect()
    for deep in (True, False):
        key = "q1_with_columns_" + ("deep" if deep else "composed")
        res = drive(ph, f"SF{scale:g} {key}", q1_with_columns, frame, want["q1"], deep=deep,
                    segment=True, group_codes=deep)
        record(key, {**res, **warm_median(q1_with_columns, frame)})
    del frame
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scales", default="1,10",
                    help="comma-separated TPC-H scale factors for the main path")
    ap.add_argument("--profile", action="store_true",
                    help="trace warm Q1/Q6 and deep Q1 at the first scale with torch.profiler")
    ap.add_argument("--kernels-only", action="store_true",
                    help="run phases 1 and 2 only (builds and kernel checks); launches print "
                         "as null")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    ph = Phases()
    try:
        from benchmarks import tpch

        torch.backends.cuda.matmul.allow_tf32 = False  # no float sum may round through TF32
        torch.backends.cudnn.allow_tf32 = False
        card = card_line()
        print(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)
        edges = phase_build(ph)
        k1_entry = phase_k1(ph)
        scales = [] if args.kernels_only else [float(s) for s in args.scales.split(",")]
        tables = {}
        t0 = time.perf_counter()
        tables[1.0] = tpch.generate_lineitem_only(scale=1.0, seed=42)
        print(f"SF1: {tables[1.0].num_rows} rows generated in {time.perf_counter() - t0:.1f}s",
              flush=True)
        k2_entry = phase_k2(ph, tables[1.0], edges)
        k1_entry["launches"] = k2_entry["launches"] = None  # until phase 3 counts them
        for i, scale in enumerate(scales):
            if scale not in tables:
                t0 = time.perf_counter()
                tables = {scale: tpch.generate_lineitem_only(scale=scale, seed=42)}
                print(f"SF{scale:g}: {tables[scale].num_rows} rows generated in "
                      f"{time.perf_counter() - t0:.1f}s", flush=True)
            res = phase_main_path(ph, scale, tables[scale], card, args.profile and i == 0)
            if i == 0:
                k1_entry["launches"] = res["k1_launches"]
                k2_entry["launches"] = res["k2_launches"]
        print(json.dumps({"kernels": [k1_entry, k2_entry]}), flush=True)
    except Exception:
        traceback.print_exc()
        ph.failures.append("uncaught exception")
    if ph.failures:
        print("chip_smoke FAILED: " + "; ".join(ph.failures), file=sys.stderr)
        return 1
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
