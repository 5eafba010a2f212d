"""Chip smoke test of the PyTorch/CUDA port (daft_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card (an H100; the
kernels build for sm_90a):

    python3 chip_smoke.py                # every phase, TPC-H SF1 and SF10
    python3 chip_smoke.py --scales 1     # a shorter run: SF1 only
    python3 chip_smoke.py --profile      # also trace warm Q1/Q6 at the first scale

Phases, each of which fails the run:
  1. build every kernel of the main path from the sources in the checkout;
  2. hold each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it and at edge cases, and time it (CUDA
     events) beside its bound, the plain version and one library call;
  3. drive TPC-H Q1 and Q6 through daft_tpu_torch.from_arrow(...).collect()
     on the card, in the 32-bit device mode, and hold the results against the
     pyarrow oracle of benchmarks/tpch.py at rtol 1e-6; check that the
     aggregation ran on the card through the kernel.

The last line of standard output is {"ok": true, "device": {...}} when every
phase passed; the exit code is 0 only then. The line before it is the card's
name and power limit as nvidia-smi reports them, and the line before that is
the kernel table as one JSON object. Imports nothing of jax or daft_tpu.
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


class Phases:
    def __init__(self):
        self.failures = []

    def check(self, ok: bool, what: str) -> bool:
        print(("PASS " if ok else "FAIL ") + what, flush=True)
        if not ok:
            self.failures.append(what)
        return ok


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
    """Kernel vs plain version vs float64 at rtol 1e-6 of the summed
    magnitudes, and two launches bit for bit. Returns max |kernel - plain|."""
    import torch

    from daft_tpu_torch.kernels import segment_sums as ss

    a = ss.masked_segment_sums_padded(codes, mask, vals, g)
    b = ss.masked_segment_sums_padded(codes, mask, vals, g)
    torch.cuda.synchronize()
    plain = ss.masked_segment_sums_plain(codes, mask, vals, g)
    sums, mags = exact64(codes, mask, vals, g)
    bound = RTOL * mags + 1e-30
    ph.check(torch.equal(a, b), f"K1 {name}: two launches agree bit for bit")
    ok_plain = bool(((a.double() - plain.double()).abs() <= bound).all())
    ok_exact = bool(((a.double() - sums).abs() <= bound).all())
    err = float((a - plain).abs().max())
    ph.check(ok_plain and ok_exact and bool(torch.isfinite(a).all()),
             f"K1 {name}: matches plain and float64 at rtol {RTOL} "
             f"(max |kernel-plain| {err:.6g})")
    return err


def phase_kernels(ph: Phases) -> dict:
    """Phase 2: K1 against its plain version; returns its kernel-table entry."""
    import numpy as np
    import torch

    from daft_tpu_torch.kernels import segment_sums as ss

    torch.backends.cuda.matmul.allow_tf32 = False  # no float sum may round through TF32
    torch.backends.cudnn.allow_tf32 = False
    n = 8_388_608  # size_bucket of SF1's 6,000,000 rows
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
        nbytes = n * (4 + 4 + 4 * k) + 16 * k * 4
        flops = 2 * n * k
        bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
        ops_ms = flops / H100_FP32_FLOPS * 1e3
        shapes[k] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                     "library_ms": library_ms}
        print("K1 timing " + json.dumps({"n": n, "G": 16, "K": k, **shapes[k]}), flush=True)
        del codes, mask, vals, vk
    entry.update(shapes[7])

    # edge cases: the widest group bucket, an all-masked block, NaN behind the
    # mask, more columns than one launch takes, and a padded ragged tail
    codes, mask, vals = k1_operands(1 << 20, 4096, 2, seed=11, used_groups=4096)
    check_k1(ph, "G=4096", codes, mask, vals, 4096)
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


def phase_main_path(ph: Phases, scale: float, card: str, record_launches: bool,
                    profile: bool = False) -> dict:
    """Phase 3: Q1 and Q6 through the port on the card at one scale factor."""
    import torch

    import daft_tpu_torch as dtt
    from benchmarks import tpch
    from daft_tpu_torch.kernels import segment_sums as ss

    dtt.set_execution_config(dtt.ExecutionConfig())  # the defaults: device="cuda"
    t0 = time.perf_counter()
    lineitem = tpch.generate_lineitem_only(scale=scale, seed=42)
    rows = lineitem.num_rows
    want = {"q1": tpch.oracle_q1(lineitem), "q6": {"revenue": [tpch.oracle_q6(lineitem)]}}
    frame = dtt.from_arrow(lineitem).collect()
    print(f"SF{scale:g}: {rows} rows generated in {time.perf_counter() - t0:.1f}s", flush=True)
    queries = {"q1": q1, "q6": q6}
    out = {"rows": rows}
    launches = 0
    if record_launches:
        ss.LAUNCHES = 0  # the main path's own count starts here
    for name, query in queries.items():
        before = ss.LAUNCHES
        t0 = time.perf_counter()
        df = query(frame).collect()
        got = df.to_pydict()
        cold = time.perf_counter() - t0
        counters = df.stats.snapshot()["counters"]
        used = ss.LAUNCHES - before
        launches += used
        ph.check(parity(got, want[name], RTOL), f"SF{scale:g} {name}: matches the pyarrow oracle at rtol {RTOL}")
        ph.check(counters.get("device_aggregations", 0) >= 1
                 and counters.get("device_agg_fallbacks", 0) == 0
                 and (name == "q6" or counters.get("device_group_codes", 0) >= 1)
                 and used >= 1,
                 f"SF{scale:g} {name}: aggregated on the card through K1 "
                 f"(counters {counters}, K1 launches {used})")
        warm = []
        for _ in range(5):
            t0 = time.perf_counter()
            query(frame).collect().to_pydict()
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t0)
        med = statistics.median(warm)
        out[name] = {"cold_s": cold, "warm_median_s": med, "warm_min_s": min(warm),
                     "warm_max_s": max(warm), "warm_runs": len(warm),
                     "warm_rows_per_s": rows / med, "k1_launches": used, "card": card}
        print(f"SF{scale:g} {name} " + json.dumps(out[name]), flush=True)
    out["launches"] = launches
    if profile:
        profile_queries(queries, frame, rows, card)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scales", default="1,10",
                    help="comma-separated TPC-H scale factors for the main path")
    ap.add_argument("--profile", action="store_true",
                    help="trace warm Q1/Q6 at the first scale with torch.profiler")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    ph = Phases()
    try:
        from daft_tpu_torch.kernels import segment_sums as ss

        card = card_line()
        print(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)
        t0 = time.perf_counter()
        ss.build()
        print(f"K1 built in {time.perf_counter() - t0:.1f}s", flush=True)
        for line in ss.BUILD_LOG.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print("ptxas: " + line.strip(), flush=True)
        entry = phase_kernels(ph)
        launches = None
        for i, scale in enumerate(float(s) for s in args.scales.split(",")):
            res = phase_main_path(ph, scale, card, record_launches=i == 0,
                                  profile=args.profile and i == 0)
            if i == 0:
                launches = res["launches"]
            torch.cuda.empty_cache()
        entry["launches"] = launches
        print(json.dumps({"kernels": [entry]}), flush=True)
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
