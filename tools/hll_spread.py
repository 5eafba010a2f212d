"""hll-spread: how far daft_tpu_torch's HyperLogLog estimate of a TPC-H key's
distinct count lands from the exact count, beside the spread of the same
estimator over independently hashed copies of the same keys.

For each of lineitem's ``l_orderkey``, ``l_partkey`` and ``l_suppkey``
(``benchmarks/tpch.generate_tables(scale, seed=42)``): the exact distinct
count, the estimate through the port's own hash (``kernels/host_hash``, a
splitmix64 finalizer of the key plus one golden-ratio step, as the
reference's), and the estimates after 20 other splitmix64 mixes of the
distinct keys, the key plus 2 to 21 steps, with their mean, standard
deviation and largest gap (relative to the exact count). It shows why
chip_smoke.py's phase 20 holds its estimates to three standard errors
rather than two.

Run on the CPU: ``python tools/hll_spread.py [--scale 1]``; prints one JSON
object a column.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402

from benchmarks import tpch  # noqa: E402
from daft_tpu_torch.kernels.host_hash import hash_array  # noqa: E402
from daft_tpu_torch.kernels.sketches import HLL_M, HllSketch  # noqa: E402

SEEDS = range(2, 22)  # 1 step is the engine's own hash


def splitmix64(x: np.ndarray, seed: int) -> np.ndarray:
    """Sebastiano Vigna's splitmix64 finalizer of ``x`` offset by ``seed``
    golden-ratio steps: an independent 64-bit hash a seed."""
    with np.errstate(over="ignore"):
        x = x.astype(np.uint64) + np.uint64(seed) * np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0)
    args = ap.parse_args()
    li = tpch.generate_tables(args.scale, seed=42)["lineitem"]
    for name in ("l_orderkey", "l_partkey", "l_suppkey"):
        keys = np.unique(li.column(name).to_numpy())
        exact = len(keys)
        est = HllSketch().add_hashes(hash_array(pa.array(keys))).estimate()
        mixed = np.array([HllSketch().add_hashes(splitmix64(keys, s)).estimate()
                          for s in SEEDS])
        rel = (mixed - exact) / exact
        print(json.dumps({
            "column": name, "scale": args.scale, "exact": exact, "estimate": est,
            "rel_gap": (est - exact) / exact, "standard_error": 1.04 / np.sqrt(HLL_M),
            "mixes": {"seeds": [SEEDS.start, SEEDS.stop - 1], "rel_mean": float(rel.mean()),
                      "rel_sd": float(rel.std()), "rel_max_abs": float(np.abs(rel).max())},
        }), flush=True)


if __name__ == "__main__":
    main()
