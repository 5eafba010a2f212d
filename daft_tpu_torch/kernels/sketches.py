"""MinHash signatures of text on the host (the port's copy of the MinHash
part of daft_tpu/kernels/sketches.py).

Only ``minhash_strings`` and its permutation family are here. The
HyperLogLog and quantile sketches behind the approximate aggregations come
with the ``sketch/`` subsystem (ROADMAP.md, Queue 1, item 10).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import pyarrow as pa

from .host_hash import hash_array

_MERSENNE = np.uint64((1 << 61) - 1)


def _perm_params(num_hashes: int, seed: int):
    """The (a, b) of the permutations a*x + b mod 2^61-1, a odd."""
    rng = np.random.RandomState(seed)
    a = rng.randint(1, 1 << 31, size=num_hashes).astype(np.uint64) * np.uint64(2) + np.uint64(1)
    b = rng.randint(0, 1 << 31, size=num_hashes).astype(np.uint64)
    return a, b


def minhash_strings(arr: pa.Array, num_hashes: int = 64, ngram_size: int = 1,
                    seed: int = 1) -> pa.Array:
    """Per-row MinHash signatures of space-separated text (word ngrams; a
    row with fewer words than ``ngram_size`` hashes as one gram)."""
    a, b = _perm_params(num_hashes, seed)
    out_sigs: List[Optional[List[int]]] = []
    for v in arr.to_pylist():
        if v is None:
            out_sigs.append(None)
            continue
        words = v.split(" ")
        if len(words) >= ngram_size:
            grams = [" ".join(words[i:i + ngram_size]) for i in range(len(words) - ngram_size + 1)]
        else:
            grams = [v]
        gh = hash_array(pa.array(grams, type=pa.large_string())).astype(np.uint64)
        with np.errstate(over="ignore"):
            sig = (gh[:, None] * a[None, :] + b[None, :]) % _MERSENNE
        out_sigs.append((sig.min(axis=0) & np.uint64(0xFFFFFFFF)).astype(np.uint32).tolist())
    return pa.array(out_sigs, type=pa.list_(pa.uint32(), num_hashes))
