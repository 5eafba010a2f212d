"""The port's masked segment sums (daft_tpu_torch/kernels/segment_sums.py)
held against daft_tpu's Pallas kernel in interpret mode, on the CPU.

The CUDA kernel itself runs only on the card; chip_smoke.py holds it against
the plain version there. Here the wrapper takes the plain version because the
tensors lie on the CPU.

Tolerance: sums agree at rtol 1e-6 relative to the magnitudes summed
(sum over the group of |value|). Both sides accumulate in float32 within a
block in different orders, so a group whose values cancel (the randn case)
differs by float32 rounding of its terms, not of its total; for the
all-positive cases the bound is exactly rtol 1e-6 of the sum. Counts are
exact.
"""

import numpy as np
import pytest
import torch

from daft_tpu.kernels.pallas_ops import masked_segment_sums as pallas_sums
from daft_tpu_torch.kernels import nvcc, segment_sums


def _case_matches_numpy():
    rng = np.random.RandomState(0)
    n, g, k = 5000, 16, 3
    return rng.randint(0, g, n), rng.rand(n) < 0.8, rng.randn(n, k), g


def _case_no_mask_and_padding_row_isolation():
    # n deliberately not a multiple of the block size: padded rows must not leak
    return np.zeros(1030, np.int64), None, np.ones((1030, 1)), 4


def _case_nan_behind_mask():
    return (np.array([0, 0, 1]), np.array([True, False, True]),
            np.array([[1.0], [np.nan], [2.0]]), 2)


def _case_empty_group_zero():
    return np.array([2, 2]), None, np.array([[5.0], [7.0]]), 4


def _case_kahan_large_magnitude():
    # TPC-H-scale money sums: group sums ~1.8e9 where float32 ulp is 128;
    # a naive float32 running sum drifts past 1e-6 relative
    rng = np.random.RandomState(1)
    n, g = 200_000, 4
    return rng.randint(0, g, n), None, (rng.rand(n) * 68000 + 900)[:, None], g


CASES = {
    "matches_numpy": (_case_matches_numpy, 1e-5),
    "padding_isolation": (_case_no_mask_and_padding_row_isolation, 1e-6),
    "nan_behind_mask": (_case_nan_behind_mask, 1e-6),
    "empty_group_zero": (_case_empty_group_zero, 1e-6),
    "kahan_large_magnitude": (_case_kahan_large_magnitude, 1e-6),
}


def _exact(codes, mask, vals, g):
    sel = np.ones(len(codes), bool) if mask is None else mask
    sums = np.zeros((g, vals.shape[1]))
    mags = np.zeros((g, vals.shape[1]))
    for j in range(vals.shape[1]):
        np.add.at(sums[:, j], codes[sel], vals[sel, j])
        np.add.at(mags[:, j], codes[sel], np.abs(vals[sel, j]))
    return sums, mags, np.bincount(codes[sel], minlength=g)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_pallas_interpret(case):
    make, oracle_rtol = CASES[case]
    codes, mask, vals, g = make()
    want, want_counts = pallas_sums(codes, mask, vals, g, interpret=True)
    got, got_counts = segment_sums.masked_segment_sums(codes, mask, vals, g, device="cpu")
    exact, mags, exact_counts = _exact(codes, mask, vals, g)
    assert np.all(np.abs(got - want) <= 1e-6 * mags)
    np.testing.assert_array_equal(got_counts, want_counts)
    np.testing.assert_array_equal(got_counts, exact_counts)
    # the original test's own tolerance against the float64 oracle
    np.testing.assert_allclose(got, exact, rtol=oracle_rtol, atol=oracle_rtol)


def test_kahan_beats_naive_float32():
    # the case still shows the drift the compensation removes: a naive
    # float32 running sum of each group misses the bound the kernel holds
    codes, mask, vals, g = _case_kahan_large_magnitude()
    got, _ = segment_sums.masked_segment_sums(codes, mask, vals, g, device="cpu")
    exact, _, _ = _exact(codes, mask, vals, g)
    naive = np.array([np.cumsum(vals[codes == j, 0].astype(np.float32), dtype=np.float32)[-1]
                      for j in range(g)])
    assert np.max(np.abs(naive - exact[:, 0]) / exact[:, 0]) > 1e-6
    np.testing.assert_allclose(got, exact, rtol=1e-6)


def test_row_counts_only_in_own_group():
    # a NaN in a selected row poisons only its own group's sum, and a row
    # behind the mask contributes nothing even at the tensor level
    codes = torch.zeros((2048, 1), dtype=torch.int32)
    codes[1024:] = 1
    mask = torch.ones((2048, 1), dtype=torch.float32)
    mask[5] = 0
    vals = torch.ones((2048, 2), dtype=torch.float32)
    vals[5, 0] = float("nan")
    vals[2000, 1] = float("nan")
    out = segment_sums.masked_segment_sums_padded(codes, mask, vals, 16)
    assert out[0, 0].item() == 1023.0 and out[0, 1].item() == 1023.0
    assert out[1, 0].item() == 1024.0 and torch.isnan(out[1, 1])
    assert torch.all(out[2:] == 0)


def test_wrapper_checks_shapes_and_types():
    codes = torch.zeros((1024, 1), dtype=torch.int32)
    mask = torch.ones((1024, 1), dtype=torch.float32)
    vals = torch.ones((1024, 3), dtype=torch.float32)
    with pytest.raises(ValueError):
        segment_sums.masked_segment_sums_padded(codes.long(), mask, vals, 16)
    with pytest.raises(ValueError):
        segment_sums.masked_segment_sums_padded(codes[:1000], mask[:1000], vals[:1000], 16)
    with pytest.raises(ValueError):
        segment_sums.masked_segment_sums_padded(codes, mask, vals, 8192)
    before = (segment_sums.ENTRIES, segment_sums.LAUNCHES)
    segment_sums.masked_segment_sums_padded(codes, mask, vals, 16)
    # the CPU tensor took the plain version: an entry, no kernel launch
    assert (segment_sums.ENTRIES, segment_sums.LAUNCHES) == (before[0] + 1, before[1])


@pytest.mark.parametrize("n,g,k", [(8_388_608, 16, 7), (8_388_608, 16, 1),
                                   (1_048_576, 4096, 1), (1024, 16, 32), (67_108_864, 16, 7)])
def test_launch_shape_covers_every_block(n, g, k):
    threads, grid_x, bpc = segment_sums.launch_shape(n, g, k)
    nblocks = n // segment_sums.BLOCK_ROWS
    assert threads % 32 == 0 and 32 <= threads <= 256
    assert grid_x * bpc >= nblocks > (grid_x - 1) * bpc  # no CTA without a block
    assert grid_x * g * k <= 1 << 24  # scratch partials stay bounded


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    # no toolchain, no kernel: the build raises instead of falling back
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda")
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(segment_sums, "_LIB", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        segment_sums.build()


def test_builds_keep_their_own_logs(monkeypatch, tmp_path):
    # a stand-in nvcc that logs the source it compiles: each build reports its
    # own log, one source shares one run, and a library on disk is reused
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    fake = bindir / "nvcc"
    fake.write_text('#!/bin/bash\n[ "$1" = --version ] && { echo stand-in; exit 0; }\n'
                    'out=""; src=""\nwhile [ $# -gt 0 ]; do case "$1" in\n'
                    '  -o) out="$2"; shift 2;;\n  *.cu) src="$1"; shift;;\n  *) shift;;\n'
                    'esac; done\nread -r first < "$src"; echo "ptxas info: $first"\n: > "$out"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    a, b, a2 = (nvcc.start("// source a\n", "k"), nvcc.start("// source b\n", "k"),
                nvcc.start("// source a\n", "k"))
    assert a2 is a and a.so != b.so
    assert nvcc.finish(b) == b.so and b.so.exists()
    assert nvcc.finish(a) == a.so and nvcc.finish(a2) == a.so
    assert "source a" in a.log and "source b" not in a.log
    assert "source b" in b.log
    again = nvcc.start("// source a\n", "k")
    assert again is not a and again.done() and nvcc.finish(again) == a.so
    assert again.log is None  # nothing was built, so no log to report
