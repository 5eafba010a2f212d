"""The deterministic scatter-sums kernel's plain version
(daft_tpu_torch/kernels/scatter_sums.py), held against the reference's
``_scatter_sum_kahan`` (daft_tpu/kernels/device.py) on the CPU.

The CUDA kernel (csrc/segment_scatter_sums.cu) runs only on the card; it is
held against this plain version bit for bit by chip_smoke.py. Here the
plain version must equal the reference bit for bit: jax's CPU scatter
(``jax.ops.segment_sum`` under ``vmap``) adds each chunk's rows in row order,
as the plain version's ``np.add.at`` does, and both Kahan-add the chunk
partials in chunk order with the same operations. An order test shows that
the contract is not vacuous: with these values a reversed row order or a
reversed chunk order gives other bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daft_tpu.kernels import device as ref_device
from daft_tpu_torch.kernels import device as port_device
from daft_tpu_torch.kernels import scatter_sums


def _operands(g: int, b: int, seed: int):
    """Codes over g segments and money-like values, about a fifth of the rows
    masked (their values 0.0, as segment_reduce hands them over)."""
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, g, b).astype(np.int32)
    vals = (rng.rand(b) * 104100.0 + 900.0).astype(np.float32)
    vals[rng.rand(b) < 0.2] = 0.0
    return codes, vals


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("g,b", [(4097, 16_384), (20_000, 65_536), (5000, 4096)])
def test_plain_equals_reference_bit_for_bit(g, b):
    codes, vals = _operands(g, b, seed=g)
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        ref = np.asarray(ref_device._scatter_sum_kahan(jnp.asarray(vals), jnp.asarray(codes), g))
    finally:
        jax.config.update("jax_enable_x64", was)
    got = scatter_sums.scatter_sum_kahan(torch.from_numpy(vals), torch.from_numpy(codes), g)
    assert got.dtype == torch.float32 and got.shape == (g,)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))


def _spec(codes, vals, g, chunk, reverse_rows=False, reverse_chunks=False, skip_zeros=False):
    """The contract in plain Python float32 scalars, one addition at a time.
    ``skip_zeros`` leaves out the rows of value +-0.0, as the kernel does."""
    f = np.float32
    nch = len(vals) // chunk
    parts = []
    for c in range(nch):
        p = [f(0.0)] * g
        rows = range(c * chunk, (c + 1) * chunk)
        for r in (reversed(rows) if reverse_rows else rows):
            if skip_zeros and vals[r] == 0.0:
                continue
            p[codes[r]] = f(p[codes[r]] + vals[r])
        parts.append(p)
    out = []
    for s in range(g):
        acc, comp = f(0.0), f(0.0)
        for p in (reversed(parts) if reverse_chunks else parts):
            y = f(p[s] - comp)
            t = f(acc + y)
            comp = f(f(t - acc) - y)
            acc = t
        out.append(acc)
    return np.array(out, dtype=np.float32)


def test_order_of_additions():
    """Row order within a chunk and chunk order across chunks are both part
    of the contract: the values below give other bits in either reversed
    order, and the plain version follows the forward one."""
    g, b, chunk = 4100, 32_768, scatter_sums.chunk_rows(32_768)
    codes = np.zeros(b, dtype=np.int32)
    vals = np.zeros(b, dtype=np.float32)
    # segment 1: row order matters ((1 + 1e8) - 1e8 != (-1e8 + 1e8) + 1)
    codes[:3] = 1
    vals[:3] = [1.0, 1e8, -1e8]
    # segment 2: four chunk partials whose compensated sum depends on their
    # order (1.4 forward, 0.0 reversed)
    for c, v in enumerate([1e8, -1e8, 0.7, 0.7]):
        codes[c * chunk + 10] = 2
        vals[c * chunk + 10] = v
    got = scatter_sums.scatter_sum_kahan_plain(torch.from_numpy(vals), torch.from_numpy(codes),
                                               g).numpy()
    want = _spec(codes, vals, g, chunk)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert _bits(got)[1] != _bits(_spec(codes, vals, g, chunk, reverse_rows=True))[1]
    assert _bits(got)[2] != _bits(_spec(codes, vals, g, chunk, reverse_chunks=True))[2]


def test_rows_of_value_zero_change_no_bit():
    """The kernel leaves the rows of value +-0.0 out of every chain (masked
    rows and padding): a chain starts at +0.0, round-to-nearest gives -0.0
    only as (-0.0) + (-0.0), so no chain is ever -0.0 and adding +-0.0 to it
    is exact. Chains here pass through exact zeros (x then -x) and meet -0.0
    rows at the start, in the middle and after a zero."""
    g, b = 4099, 8192
    rng = np.random.RandomState(17)
    codes = rng.randint(0, 6, b).astype(np.int32)
    vals = (rng.rand(b) * 200 - 100).astype(np.float32)
    vals[rng.rand(b) < 0.3] = 0.0
    vals[rng.rand(b) < 0.3] = -0.0
    codes[:6] = 5
    vals[:6] = [-0.0, 3.5, -3.5, -0.0, -0.0, 0.0]  # segment 5 hits exact zero, then -0.0
    want = _spec(codes, vals, g, b)
    np.testing.assert_array_equal(_bits(_spec(codes, vals, g, b, skip_zeros=True)), _bits(want))
    got = scatter_sums.scatter_sum_kahan_plain(torch.from_numpy(vals), torch.from_numpy(codes), g)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert not (np.signbit(want) & (want == 0)).any()  # no sum is -0.0


def test_segment_reduce_routes_float_sums_above_4096_through_the_wrapper():
    g = 6000
    codes, vals = _operands(g, 16_384, seed=3)
    valid = torch.from_numpy(vals != 0)
    before = scatter_sums.ENTRIES, scatter_sums.LAUNCHES
    out, ok = port_device.segment_reduce(torch.from_numpy(vals), valid,
                                         torch.from_numpy(codes), g, "sum")
    assert scatter_sums.ENTRIES - before[0] == 1
    assert scatter_sums.LAUNCHES == before[1]  # a CPU tensor never launches
    want = np.zeros(g)
    np.add.at(want, codes[vals != 0], vals[vals != 0].astype(np.float64))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-6)
    assert (ok.numpy() == (np.bincount(codes[vals != 0], minlength=g) > 0)).all()


def test_codes_outside_the_segments_add_nowhere():
    codes = np.array([0, 5, -1, 3, 4, 1 << 20] * 1024, dtype=np.int32)
    vals = np.arange(len(codes), dtype=np.float32)
    got = scatter_sums.scatter_sum_kahan(torch.from_numpy(vals), torch.from_numpy(codes), 5)
    keep = (codes >= 0) & (codes < 5)
    np.testing.assert_array_equal(_bits(got.numpy()),
                                  _bits(_spec(np.where(keep, codes, 0),
                                              np.where(keep, vals, 0).astype(np.float32),
                                              5, len(codes))))


@pytest.mark.parametrize("bad", ["dtype", "shape", "rows"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    n = 12_000 if bad == "rows" else 8192  # 12,000 rows are no whole chunks
    vals = torch.zeros(n, dtype=torch.float32)
    codes = torch.zeros(n, dtype=torch.int32)
    if bad == "dtype":  # float32 and float64 are the kernel's; float16 is not
        vals = vals.half()
    elif bad == "shape":
        codes = codes[:4096]
    with pytest.raises(ValueError):
        scatter_sums.scatter_sum_kahan(vals, codes, 5000)
