"""The image half of the port's multimodal.py (decode, encode, crop, to_mode,
the Image and FixedShapeImage casts, and K11, the bilinear resize), the
tensor layouts of Series.to_numpy, the 2-D device lanes and
embedding.cosine_distance, held against daft_tpu on the CPU after
tests/test_multimodal.py's image classes and TestHighBitModes.

The same seeded numpy images go through both packages. Decode, encode, crop
and to_mode give equal arrays (and equal bytes); the resize holds within one
count in the integer modes (the port contracts in float64, the reference in
float32) and within rtol 1e-5 in RGB32F; the casts raise the reference's
errors; cosine distances agree within rtol 1e-12. The port runs K11 on
device="cpu", its plain version.
"""

import io

import numpy as np
import pyarrow as pa
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu import multimodal as ref_mm
from daft_tpu_torch import multimodal as mm
from torch_parity import restore_port_config  # noqa: F401

PKGS = ((daft_tpu, ref_mm), (daft_tpu_torch, mm))


@pytest.fixture(autouse=True)
def _cpu():
    daft_tpu_torch.set_execution_config(device="cpu")


def _png_bytes(arr: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


@pytest.fixture
def rgb_pngs():
    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 255, (h, w, 3), dtype=np.uint8) for h, w in [(4, 6), (8, 3)]]
    return imgs, [_png_bytes(a) for a in imgs]


def _collect_images(pkg, module, blobs, expr):
    df = pkg.from_pydict({"b": pkg.Series.from_pylist(blobs, "b", pkg.DataType.binary())})
    out = df.select(expr(pkg.col("b")).alias("i")).collect()
    s = out.to_table().get_column("i")
    return s.dtype, module.image_series_to_arrays(s)


def _both_images(blobs, expr):
    """(reference arrays, port arrays, port dtype) of ``expr`` over blobs."""
    (rdt, ref), (gdt, got) = [_collect_images(p, m, blobs, expr) for p, m in PKGS]
    assert repr(gdt) == repr(rdt)
    return ref, got, gdt


def _assert_arrays_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        if r is None:
            assert g is None
        else:
            assert g.dtype == r.dtype and g.shape == r.shape
            np.testing.assert_array_equal(g, r)


def _images(mode, n, h, w, seed, nulls=()):
    rng = np.random.RandomState(seed)
    c = mm._mode_channels(mode)
    dt = mm._mode_np_dtype(mode)
    if dt == np.float32:
        imgs = [rng.rand(h, w, c).astype(np.float32) for _ in range(n)]
    else:
        imgs = [rng.randint(0, int(np.iinfo(dt).max) + 1, (h, w, c)).astype(dt)
                for _ in range(n)]
    for i in nulls:
        imgs[i] = None
    return imgs


def _fixed(module, pkg, imgs, mode, h, w):
    s = module.image_series_from_arrays(imgs, "i", [mode if a is not None else None
                                                    for a in imgs])
    return s.cast(pkg.DataType.image(mode, h, w))


class TestImageDecodeEncode:
    def test_decode_roundtrip(self, rgb_pngs):
        imgs, blobs = rgb_pngs
        ref, got, dt = _both_images(blobs, lambda c: c.image.decode())
        assert dt.kind == daft_tpu_torch.datatypes.TypeKind.IMAGE
        _assert_arrays_equal(got, ref)
        _assert_arrays_equal(got, imgs)

    def test_decode_null_and_on_error(self, rgb_pngs):
        _, blobs = rgb_pngs
        bad = [blobs[0], None, b"not an image"]
        for pkg, _ in PKGS:
            df = pkg.from_pydict({"b": pkg.Series.from_pylist(bad, "b", pkg.DataType.binary())})
            with pytest.raises(Exception):
                df.select(pkg.col("b").image.decode().alias("i")).collect().to_pydict()
        ref, got, _ = _both_images(bad, lambda c: c.image.decode(on_error="null"))
        _assert_arrays_equal(got, ref)
        assert got[1] is None and got[2] is None and got[0] is not None

    def test_encode_decode_identity(self, rgb_pngs):
        imgs, blobs = rgb_pngs
        outs = []
        for pkg, _ in PKGS:
            df = pkg.from_pydict({"b": pkg.Series.from_pylist(blobs, "b", pkg.DataType.binary())})
            outs.append(df.select(pkg.col("b").image.decode().image.encode("png")
                                  .alias("b2")).collect().to_pydict()["b2"])
        assert outs[1] == outs[0]  # the same PIL encoder: equal bytes
        from PIL import Image

        for b2, want in zip(outs[1], imgs):
            np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(b2))), want)

    def test_encode_jpeg_and_mode_decode(self, rgb_pngs):
        _, blobs = rgb_pngs
        ref, got, _ = _both_images(blobs, lambda c: c.image.decode(mode="RGBA")
                                   .image.encode("jpg").image.decode(mode="L"))
        _assert_arrays_equal(got, ref)


class TestImageOps:
    def test_resize_variable(self, rgb_pngs):
        _, blobs = rgb_pngs
        ref, got, _ = _both_images(blobs, lambda c: c.image.decode().image.resize(5, 7))
        assert all(a.shape == (7, 5, 3) for a in got)
        _assert_arrays_equal(got, ref)  # PIL's bilinear in both

    def test_resize_fixed_shape_device_path(self):
        rng = np.random.RandomState(1)
        imgs = [rng.randint(0, 255, (4, 4, 3), dtype=np.uint8) for _ in range(3)]
        outs = []
        for pkg, module in PKGS:
            fixed = _fixed(module, pkg, imgs, "RGB", 4, 4)
            out = module.image_resize(fixed, 2, 2)
            assert out.dtype == pkg.DataType.image("RGB", 2, 2)
            outs.append(module.image_series_to_arrays(out))
            const = _fixed(module, pkg, [np.full((4, 4, 3), 77, np.uint8)], "RGB", 4, 4)
            np.testing.assert_array_equal(
                module.image_series_to_arrays(module.image_resize(const, 2, 2))[0],
                np.full((2, 2, 3), 77, np.uint8))
        for g, r in zip(outs[1], outs[0]):
            assert np.abs(g.astype(int) - r.astype(int)).max() <= 1

    def test_crop(self, rgb_pngs):
        imgs, blobs = rgb_pngs
        ref, got, _ = _both_images(blobs, lambda c: c.image.decode().image.crop((1, 1, 3, 2)))
        _assert_arrays_equal(got, ref)
        np.testing.assert_array_equal(got[0], imgs[0][1:3, 1:4])

    def test_crop_per_row_boxes(self, rgb_pngs):
        _, blobs = rgb_pngs
        outs = []
        for pkg, module in PKGS:
            df = pkg.from_pydict({"b": pkg.Series.from_pylist(blobs, "b", pkg.DataType.binary()),
                                  "box": [[0, 1, 2, 2], [1, 0, 5, 5]]})
            s = df.select(pkg.col("b").image.decode().image.crop(pkg.col("box")).alias("i")) \
                .collect().to_table().get_column("i")
            outs.append(module.image_series_to_arrays(s))
        _assert_arrays_equal(outs[1], outs[0])

    def test_to_mode(self, rgb_pngs):
        _, blobs = rgb_pngs
        for mode in ("L", "LA", "RGBA", "L16", "RGB16", "RGBA32F"):
            ref, got, _ = _both_images(blobs, lambda c: c.image.decode().image.to_mode(mode))
            _assert_arrays_equal(got, ref)
        assert got[0].shape == (4, 6, 4)


class TestHighBitModes:
    def test_resize_rgb16(self):
        a = np.full((4, 4, 3), 30000, np.uint16)
        outs = [module.image_series_to_arrays(module.image_resize(
            module.image_series_from_arrays([a], "i"), 2, 2))[0] for _, module in PKGS]
        assert outs[1].dtype == np.uint16 and outs[1].shape == (2, 2, 3)
        np.testing.assert_array_equal(outs[1], np.full((2, 2, 3), 30000, np.uint16))
        np.testing.assert_array_equal(outs[1], outs[0])

    def test_to_mode_rgb16_to_rgb(self):
        a = np.full((2, 2, 3), 65535, np.uint16)
        outs = [module.image_series_to_arrays(module.image_to_mode(
            module.image_series_from_arrays([a], "i"), "RGB"))[0] for _, module in PKGS]
        np.testing.assert_array_equal(outs[1], np.full((2, 2, 3), 255, np.uint8))
        np.testing.assert_array_equal(outs[1], outs[0])

    def test_to_mode_rgb32f_to_l(self):
        a = np.ones((2, 2, 3), np.float32)
        outs = [module.image_series_to_arrays(module.image_to_mode(
            module.image_series_from_arrays([a], "i"), "L"))[0] for _, module in PKGS]
        np.testing.assert_array_equal(outs[1], np.full((2, 2, 1), 255, np.uint8))
        np.testing.assert_array_equal(outs[1], outs[0])

    def test_encode_rgb16_clear_error(self):
        msgs = []
        for _, module in PKGS:
            s = module.image_series_from_arrays([np.zeros((2, 2, 3), np.uint16)], "i")
            with pytest.raises(ValueError, match="to_mode") as e:
                module.image_encode(s, "png")
            msgs.append(str(e.value))
        assert msgs[1] == msgs[0]

    def test_fixed_resize_with_nulls_fast(self):
        imgs = [np.full((4, 4, 3), 9, np.uint8), None, np.full((4, 4, 3), 5, np.uint8)]
        outs = []
        for pkg, module in PKGS:
            outs.append(module.image_series_to_arrays(
                module.image_resize(_fixed(module, pkg, imgs, "RGB", 4, 4), 2, 2)))
        _assert_arrays_equal(outs[1], outs[0])
        assert outs[1][1] is None
        np.testing.assert_array_equal(outs[1][0], np.full((2, 2, 3), 9, np.uint8))
        np.testing.assert_array_equal(outs[1][2], np.full((2, 2, 3), 5, np.uint8))


@pytest.mark.parametrize("mode,n,src,dst,nulls", [
    ("RGB", 40, (32, 24), (20, 30), (3,)),     # down in height, up in width
    ("RGBA", 9, (16, 16), (40, 7), ()),
    ("L", 12, (9, 13), (18, 5), (0, 11)),
    ("RGB16", 8, (20, 20), (7, 9), (2,)),
    ("LA16", 5, (6, 10), (12, 20), ()),
    ("RGB32F", 10, (24, 24), (12, 12), (4,)),
    ("RGBA32F", 4, (8, 8), (3, 11), ()),
])
def test_resize_fixed_matches_reference(mode, n, src, dst, nulls):
    """K11 over seeded fixed-shape batches against the reference's resize:
    within one count in the integer modes, rtol 1e-5 in the float modes;
    null rows stay null."""
    imgs = _images(mode, n, src[0], src[1], seed=n, nulls=nulls)
    outs = []
    for pkg, module in PKGS:
        out = module.image_resize(_fixed(module, pkg, imgs, mode, *src), dst[1], dst[0])
        assert out.dtype == pkg.DataType.image(mode, *dst)
        outs.append(module.image_series_to_arrays(out))
    before = mm.LAUNCHES
    for g, r in zip(*outs[::-1]):
        if r is None:
            assert g is None
            continue
        assert g.dtype == r.dtype and g.shape == r.shape
        if g.dtype == np.float32:
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6)
        else:
            assert np.abs(g.astype(np.int64) - r.astype(np.int64)).max() <= 1
    assert mm.LAUNCHES == before == 0  # the CPU runs the plain version: no launch


@pytest.mark.parametrize("mode", ["RGB16", "RGBA32F", "LA16"])
def test_resize_variable_high_bit_row_by_row(mode):
    """Variable-shape images in the 16-bit and float modes resize one row at
    a time through K11, as the reference's do through its batched path."""
    rng = np.random.RandomState(4)
    c = mm._mode_channels(mode)
    dt = mm._mode_np_dtype(mode)
    imgs = []
    for h, w in [(5, 7), (9, 4), (12, 12)]:
        a = rng.rand(h, w, c) if dt == np.float32 else rng.randint(0, 65536, (h, w, c))
        imgs.append(a.astype(dt))
    imgs.append(None)
    outs = [module.image_series_to_arrays(module.image_resize(
        module.image_series_from_arrays(imgs, "i"), 6, 8)) for _, module in PKGS]
    for g, r in zip(outs[1], outs[0]):
        if r is None:
            assert g is None
        elif dt == np.float32:
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6)
        else:
            assert g.shape == r.shape == (8, 6, c)
            assert np.abs(g.astype(np.int64) - r.astype(np.int64)).max() <= 1


def test_resize_weights_equal_reference():
    for src, dst in [(256, 224), (224, 256), (7, 3), (3, 7), (1, 5), (5, 1), (16, 16)]:
        np.testing.assert_array_equal(mm._resize_weight_mat(src, dst),
                                      ref_mm._resize_weight_mat(src, dst))


class TestCasts:
    def test_image_to_fixed_and_back(self):
        imgs = _images("RGB", 4, 6, 5, seed=2, nulls=(1,))
        outs = []
        for pkg, module in PKGS:
            s = module.image_series_from_arrays(imgs, "i", ["RGB", None, "RGB", "RGB"])
            fixed = s.cast(pkg.DataType.image("RGB", 6, 5))
            back = fixed.cast(pkg.DataType.image("RGB"))
            outs.append((fixed.to_arrow(), repr(back.dtype),
                         module.image_series_to_arrays(back)))
        assert outs[1][0].equals(outs[0][0])
        assert outs[1][1] == outs[0][1]
        _assert_arrays_equal(outs[1][2], outs[0][2])

    @pytest.mark.parametrize("case", ["shape", "channels", "pixels"])
    def test_fixed_cast_errors(self, case):
        a = np.zeros((4, 4, 3), np.uint8)
        target = {"shape": ("RGB", 5, 4), "channels": ("RGBA", 4, 4),
                  "pixels": ("RGB16", 4, 4)}[case]
        msgs = []
        for pkg, module in PKGS:
            s = module.image_series_from_arrays([a], "i")
            with pytest.raises(ValueError) as e:
                s.cast(pkg.DataType.image(*target))
            msgs.append(str(e.value))
        assert msgs[1] == msgs[0]

    def test_fixed_image_to_tensor_to_numpy(self):
        imgs = _images("RGB", 3, 4, 4, seed=6)
        outs = []
        for pkg, module in PKGS:
            t = _fixed(module, pkg, imgs, "RGB", 4, 4).cast(
                pkg.DataType.tensor(pkg.DataType.uint8(), (4, 4, 3)))
            outs.append((repr(t.dtype), t.to_numpy()))
        assert outs[1][0] == outs[0][0]
        assert outs[1][1].shape == (3, 4, 4, 3)
        np.testing.assert_array_equal(outs[1][1], outs[0][1])
        np.testing.assert_array_equal(outs[1][1], np.stack(imgs))

    @pytest.mark.parametrize("kind", ["embedding", "tensor", "image"])
    def test_to_numpy_layouts_with_nulls(self, kind):
        vals = np.arange(24, dtype=np.float32)
        outs = []
        for pkg, _ in PKGS:
            dt = {"embedding": pkg.DataType.embedding(pkg.DataType.float32(), 4),
                  "tensor": pkg.DataType.tensor(pkg.DataType.float32(), (2, 2)),
                  "image": pkg.DataType.image("RGB32F", 1, 1)}[kind]
            size = {"embedding": 4, "tensor": 4, "image": 3}[kind]
            n = 24 // size
            arr = pa.FixedSizeListArray.from_arrays(pa.array(vals), size)
            mask = np.zeros(n, bool)
            mask[1] = True
            arr = pa.Array.from_buffers(arr.type, n, [pa.py_buffer(
                np.packbits(~mask, bitorder="little").tobytes())], children=[pa.array(vals)])
            s = pkg.Series.from_arrow(arr, "e", dt).slice(1, n)
            outs.append(s.to_numpy())
        assert outs[1].dtype == outs[0].dtype == object
        assert [None if x is None else x.tolist() for x in outs[1]] == \
            [None if x is None else x.tolist() for x in outs[0]]


class TestEmbeddings:
    def test_cosine_distance_fixed(self):
        rng = np.random.RandomState(8)
        a = rng.randn(50, 16).astype(np.float32)
        b = rng.randn(50, 16).astype(np.float32)
        outs = []
        for pkg, _ in PKGS:
            dt = pkg.DataType.embedding(pkg.DataType.float32(), 16)
            df = pkg.from_pydict({"a": pkg.Series.from_numpy(a, "a", dt),
                                  "b": pkg.Series.from_numpy(b, "b", dt)})
            outs.append(df.select(pkg.col("a").embedding.cosine_distance(pkg.col("b"))
                                  .alias("d")).collect().to_pydict()["d"])
        np.testing.assert_allclose(outs[1], outs[0], rtol=1e-12)
        want = 1 - (a.astype(np.float64) * b).sum(1) / (
            np.linalg.norm(a.astype(np.float64), axis=1) * np.linalg.norm(b.astype(np.float64), axis=1))
        np.testing.assert_allclose(outs[1], want, rtol=1e-12)

    def test_cosine_distance_lists_nulls_and_one_row(self):
        rows = [[1.0, 0.0, 2.0], None, [0.5, 0.5, 0.5], [3.0, -1.0, 0.0]]
        outs = []
        for pkg, _ in PKGS:
            df = pkg.from_pydict({"a": rows})
            outs.append(df.select(pkg.col("a").embedding.cosine_distance(
                pkg.lit([1.0, 2.0, 3.0])).alias("d")).collect().to_pydict()["d"])
        assert outs[1][1] is None
        np.testing.assert_allclose([x for x in outs[1] if x is not None],
                                   [x for x in outs[0] if x is not None], rtol=1e-12)


@pytest.mark.parametrize("x64", [False, True])
def test_embedding_staging(x64):
    """tests/test_device_kernels.py::test_embedding_staging's case: a 2-D
    lane ([n, 4]) stages and unstages to the same rows."""
    from daft_tpu_torch.kernels import device as dev

    daft_tpu_torch.set_execution_config(device="cpu", device_x64=x64)
    s = daft_tpu_torch.Series.from_numpy(
        np.arange(12, dtype=np.float32).reshape(3, 4), "e",
        daft_tpu_torch.DataType.embedding(daft_tpu_torch.DataType.float32(), 4))
    dc = dev.stage_series(s, None, "cpu")
    assert dc.values.shape[1] == 4
    back = dev.unstage(dc)
    assert back.to_numpy().tolist() == s.to_numpy().tolist()
    # a uint16 inner type widens on the device and comes back as uint16
    u = daft_tpu_torch.Series.from_numpy(
        np.arange(8, dtype=np.uint16).reshape(2, 4) * 9000, "u",
        daft_tpu_torch.DataType.embedding(daft_tpu_torch.DataType.uint16(), 4))
    assert dev.unstage(dev.stage_series(u, 8, "cpu")).to_pylist() == u.to_pylist()


def test_laion_pipeline_matches_reference(tmp_path):
    """url.download -> image.decode(mode="RGB") -> cast to a fixed shape ->
    resize(24, 24) -> tensor, over local JPEG files, in both packages."""
    from benchmarks.laion import make_jpegs

    paths = []
    for i, blob in enumerate(make_jpegs(12, 30, seed=0)):
        p = tmp_path / f"{i}.jpg"
        p.write_bytes(blob)
        paths.append(str(p))
    outs = []
    for pkg, _ in PKGS:
        q = (pkg.from_pydict({"url": paths}).into_partitions(3)
             .select(pkg.col("url").url.download().alias("data"))
             .select(pkg.col("data").image.decode(mode="RGB").alias("img"))
             .select(pkg.col("img").cast(pkg.DataType.image("RGB", 30, 30)).alias("f"))
             .select(pkg.col("f").image.resize(24, 24).alias("r"))
             .select(pkg.col("r").cast(pkg.DataType.tensor(pkg.DataType.uint8(), (24, 24, 3)))
                     .alias("t")))
        outs.append(np.stack(q.collect().to_table().get_column("t").to_numpy()))
    assert outs[1].shape == (12, 24, 24, 3)
    assert np.abs(outs[1].astype(int) - outs[0].astype(int)).max() <= 1
