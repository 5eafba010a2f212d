"""Multimodal kernels and their expression namespaces: images and urls (the
port's copy of daft_tpu/multimodal.py).

Images. The storage is DataType.to_physical()'s:
  Image            -> struct{data: list<u8>, channel: u16, height: u32,
                            width: u32, mode: u8}
  FixedShapeImage  -> fixed_size_list<u8|u16|f32>[h*w*c]
The codecs run on the host through PIL (``image.decode``, ``image.encode``),
as do ``image.crop`` and ``image.to_mode`` (PIL for the 8-bit modes and L16,
numpy for the 16-bit multichannel and float modes).

``image.resize`` of a FixedShapeImage column is K11: a bilinear resize as
two separable contractions, ``"os,nshc->nohc"`` with the row weights and
``"ow,nhwc->nhoc"`` with the column weights (``_resize_weight_mat``: the
reference's weights, numpy float64 cast to float32), run by
``torch.einsum`` on the config's device in chunks of ``_RESIZE_CHUNK``
images. Each chunk stages in its own pixel type (uint8, uint16 as its
int16 bits, float32) and converts on the device, so the host never holds a
float copy of the batch; null rows' lanes are zeroed there, and the
rounding (``round``, half to even as numpy's ``rint``) and the clamp to the
mode's range run there, so only the result comes back. The contractions
run in float64, never through TF32 whatever the process has set: a float64
product has no reduced-precision mode, and the H100's float64 tensor-core
rate equals its float32 rate. On a CUDA device a chunk runs on the card or
raises; on the CPU the same torch code is the plain version. A
variable-shape image resizes one row at a time, through PIL in the 8-bit
modes and L16 and through K11 in the others, as in the reference.

``LAUNCHES`` counts K11's chunks run on a CUDA device.

Urls. ``url.download`` fetches each row's url (``s3://``, ``gs://``,
``az://``, ``hf://``, ``http(s)://``, ``file://`` or a local path) through
the object-store client (io/object_store.py): one client a batch,
``max_connections`` fetches in flight, retries under its policy, results
in row order, ``on_error`` ``raise`` or ``null``. ``url.upload`` writes each
row's bytes as a new object under a location (local or remote, one for all
rows or one a row) and returns the written paths. Both run on the host:
their work is IO.
"""

from __future__ import annotations

import concurrent.futures
import io
import threading
import uuid
from typing import List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import torch

from .datatypes import _IMAGE_MODE_CHANNELS, IMAGE_MODES, DataType, TypeKind
from .expressions import _Namespace
from .functions import register
from .series import Series

# ---------------------------------------------------------------------------
# mode helpers
# ---------------------------------------------------------------------------

MODE_TO_ID = {m: i for i, m in enumerate(IMAGE_MODES)}
ID_TO_MODE = {i: m for i, m in enumerate(IMAGE_MODES)}

# PIL modes with a faithful equivalent in IMAGE_MODES; anything else (e.g. the
# single-channel float mode "F", palettes, CMYK) converts to RGB on decode.
_PIL_TO_MODE = {"L": "L", "LA": "LA", "RGB": "RGB", "RGBA": "RGBA", "I;16": "L16"}
_MODE_TO_PIL = {"L": "L", "LA": "LA", "RGB": "RGB", "RGBA": "RGBA", "L16": "I;16"}
# modes PIL can round-trip through Image.fromarray; the rest take the numpy
# conversion and the K11 resize
_PIL_SAFE_MODES = frozenset(["L", "LA", "RGB", "RGBA", "L16"])


def _mode_np_dtype(mode: str):
    if mode.endswith("32F"):
        return np.float32
    if mode.endswith("16"):
        return np.uint16
    return np.uint8


def _mode_channels(mode: str) -> int:
    return _IMAGE_MODE_CHANNELS[mode]


# ---------------------------------------------------------------------------
# Image series <-> numpy
# ---------------------------------------------------------------------------

def image_series_from_arrays(arrays: Sequence[Optional[np.ndarray]], name: str = "image",
                             modes: Optional[Sequence[Optional[str]]] = None,
                             dtype_mode: Optional[str] = None) -> Series:
    """Build a variable-shape Image Series from HxWxC (or HxW) numpy arrays."""
    data_chunks: List[np.ndarray] = []
    offsets = [0]
    channel, height, width, mode_ids, valid = [], [], [], [], []
    total = 0
    for i, a in enumerate(arrays):
        if a is None:
            valid.append(False)
            channel.append(0); height.append(0); width.append(0); mode_ids.append(0)
            offsets.append(total)
            continue
        if a.ndim == 2:
            a = a[:, :, None]
        m = modes[i] if modes is not None and modes[i] is not None else _default_mode(a)
        a = a.astype(_mode_np_dtype(m), copy=False)
        valid.append(True)
        h, w, c = a.shape
        flat = a.reshape(-1).view(np.uint8)
        data_chunks.append(flat)
        total += flat.size
        offsets.append(total)
        channel.append(c); height.append(h); width.append(w); mode_ids.append(MODE_TO_ID[m])
    data = np.concatenate(data_chunks) if data_chunks else np.empty(0, np.uint8)
    dt = DataType.image(dtype_mode)
    storage_t = dt.to_arrow()
    fields = {f.name: f.type for f in storage_t}
    lst = pa.LargeListArray.from_arrays(pa.array(offsets, pa.int64()), pa.array(data, pa.uint8()))
    if not pa.types.is_large_list(fields["data"]):
        lst = lst.cast(fields["data"])
    mask = pa.array([not v for v in valid], pa.bool_())
    struct = pa.StructArray.from_arrays(
        [lst,
         pa.array(channel, fields["channel"]),
         pa.array(height, fields["height"]),
         pa.array(width, fields["width"]),
         pa.array(mode_ids, fields["mode"])],
        names=["data", "channel", "height", "width", "mode"],
        mask=mask)
    if struct.type != storage_t:
        struct = struct.cast(storage_t)
    return Series(name, dt, struct)


def _default_mode(a: np.ndarray) -> str:
    c = a.shape[2] if a.ndim == 3 else 1
    base = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[c]
    if a.dtype == np.uint16:
        return base + "16"
    if a.dtype in (np.float32, np.float64):
        if base in ("RGB", "RGBA"):
            return base + "32F"
        raise ValueError(f"no float image mode for {base}")
    return base


def image_series_to_arrays(s: Series) -> List[Optional[np.ndarray]]:
    """Image/FixedShapeImage Series -> list of HxWxC numpy arrays (None = null)."""
    dt = s.dtype
    if dt.kind == TypeKind.FIXED_SHAPE_IMAGE:
        mode, h, w = dt.params
        c = _mode_channels(mode)
        npdt = _mode_np_dtype(mode)
        arr = s.to_arrow()
        per = h * w * c
        # .values spans the whole child buffer; honor a sliced parent's offset
        flat = np.asarray(arr.values.to_numpy(zero_copy_only=False))
        flat = flat[arr.offset * per:(arr.offset + len(arr)) * per]
        out: List[Optional[np.ndarray]] = []
        valid = np.asarray(arr.is_valid())
        for i in range(len(arr)):
            if not valid[i]:
                out.append(None)
            else:
                out.append(flat[i * per:(i + 1) * per].astype(npdt, copy=False).reshape(h, w, c))
        return out
    if dt.kind != TypeKind.IMAGE:
        raise ValueError(f"expected an image series, got {dt}")
    arr = s.to_arrow()
    data = arr.field("data")
    ch = arr.field("channel").to_numpy(zero_copy_only=False)
    hh = arr.field("height").to_numpy(zero_copy_only=False)
    ww = arr.field("width").to_numpy(zero_copy_only=False)
    mm = arr.field("mode").to_numpy(zero_copy_only=False)
    offs = np.asarray(data.offsets)
    raw = np.asarray(data.values)
    valid = np.asarray(arr.is_valid())
    out = []
    for i in range(len(arr)):
        if not valid[i]:
            out.append(None)
            continue
        m = ID_TO_MODE[int(mm[i])]
        npdt = _mode_np_dtype(m)
        seg = raw[offs[i]:offs[i + 1]].view(npdt)
        out.append(seg.reshape(int(hh[i]), int(ww[i]), int(ch[i])))
    return out


def _to_pil(a: np.ndarray):
    from PIL import Image as PILImage

    if a.shape[2] == 1:
        a = a[:, :, 0]
    return PILImage.fromarray(a)


def _pil_to_np(img) -> Tuple[np.ndarray, str]:
    a = np.asarray(img)
    if a.ndim == 2:
        a = a[:, :, None]
    mode = _PIL_TO_MODE.get(img.mode)
    if mode is None:
        img = img.convert("RGB")
        a = np.asarray(img)
        mode = "RGB"
    return a, mode


# ---------------------------------------------------------------------------
# image kernels
# ---------------------------------------------------------------------------

def image_decode(s: Series, mode: Optional[str] = None, on_error: str = "raise") -> Series:
    """binary -> Image. Reference: image.rs decode + ImageMode conversion."""
    from PIL import Image as PILImage

    if mode is not None and mode not in IMAGE_MODES:
        raise ValueError(f"unknown image mode {mode!r}")
    vals = s.to_pylist()
    arrays: List[Optional[np.ndarray]] = []
    modes: List[Optional[str]] = []
    for v in vals:
        if v is None:
            arrays.append(None); modes.append(None)
            continue
        try:
            img = PILImage.open(io.BytesIO(v))
            if mode is not None:
                img = img.convert(_MODE_TO_PIL.get(mode, mode))
            a, m = _pil_to_np(img)
            arrays.append(a); modes.append(mode or m)
        except Exception:
            if on_error == "null":
                arrays.append(None); modes.append(None)
            else:
                raise
    return image_series_from_arrays(arrays, s.name, modes, dtype_mode=mode)


def image_encode(s: Series, image_format: str) -> Series:
    """Image -> binary in the requested codec (PNG/JPEG/TIFF/BMP/GIF)."""
    fmt = image_format.upper()
    if fmt == "JPG":
        fmt = "JPEG"
    arrays = image_series_to_arrays(s)
    out: List[Optional[bytes]] = []
    for a in arrays:
        if a is None:
            out.append(None)
            continue
        m = _default_mode(a)
        if m not in _PIL_SAFE_MODES:
            raise ValueError(
                f"cannot encode a {m} image to {fmt}; convert with "
                "image.to_mode to an 8-bit mode (or L16) first")
        img = _to_pil(a)
        if fmt == "JPEG" and img.mode in ("RGBA", "LA"):
            img = img.convert("RGB")
        buf = io.BytesIO()
        img.save(buf, format=fmt)
        out.append(buf.getvalue())
    return Series.from_pylist(out, s.name, DataType.binary())


def image_resize(s: Series, w: int, h: int) -> Series:
    """Resize to w x h. A FixedShapeImage column runs K11 over the whole
    batch on the config's device; a variable-shape image resizes one row at
    a time (PIL's bilinear in the 8-bit modes and L16, K11 in the others)."""
    dt = s.dtype
    if dt.kind == TypeKind.FIXED_SHAPE_IMAGE:
        return _resize_fixed_device(s, w, h)
    arrays = image_series_to_arrays(s)
    modes: List[Optional[str]] = []
    out: List[Optional[np.ndarray]] = []
    for a in arrays:
        if a is None:
            out.append(None); modes.append(None)
            continue
        m = _default_mode(a)
        if m in _PIL_SAFE_MODES:
            img = _to_pil(a).resize((w, h), resample=_BILINEAR())
            b = np.asarray(img)
            if b.ndim == 2:
                b = b[:, :, None]
        else:  # 16-bit multichannel and float modes: PIL cannot, K11 can
            b = _resize_batch(a[None], h, w, _resize_device())[0]
        out.append(b); modes.append(m)
    return image_series_from_arrays(out, s.name, modes,
                                    dtype_mode=dt.params[0] if dt.kind == TypeKind.IMAGE else None)


def _BILINEAR():
    from PIL import Image as PILImage

    return PILImage.BILINEAR


_RESIZE_W_CACHE: dict = {}


def _resize_weight_mat(src: int, dst: int) -> np.ndarray:
    """(dst, src) row-resize weights of a bilinear resize: half-pixel
    sample centers, a triangle kernel widened by the inverse scale when
    minifying (anti-aliasing), each output normalized over its in-range
    taps, outputs outside the domain zeroed. numpy float64, then float32,
    exactly as the reference computes them."""
    key = (src, dst)
    got = _RESIZE_W_CACHE.get(key)
    if got is not None:
        return got
    scale = src / dst
    kscale = max(scale, 1.0)
    centers = (np.arange(dst) + 0.5) * scale - 0.5
    x = np.abs(centers[:, None] - np.arange(src)[None, :]) / kscale
    wt = np.maximum(0.0, 1.0 - x)
    tot = wt.sum(axis=1, keepdims=True)
    wt = np.where(np.abs(tot) > 1000 * np.finfo(np.float32).eps, wt / tot, 0.0)
    dom = (centers >= -0.5) & (centers <= src - 0.5)
    wt = np.where(dom[:, None], wt, 0.0).astype(np.float32)
    _RESIZE_W_CACHE[key] = wt
    return wt


_RESIZE_CHUNK = 2048

LAUNCHES = 0
COUNT_LOCK = threading.Lock()


def _resize_device() -> torch.device:
    from .context import get_context
    from .kernels.device import resolve_device

    return resolve_device(get_context().execution_config)


def resize_chunk(x: torch.Tensor, wh: torch.Tensor, ww: torch.Tensor,
                 valid: Optional[torch.Tensor] = None, lo: Optional[int] = None,
                 hi: Optional[int] = None) -> torch.Tensor:
    """K11 on one chunk: ``x`` [n, H, W, C] (float32, uint8, or uint16 as its
    int16 bits), ``wh`` [h, H] and ``ww`` [w, W] float64 weights, all on one
    device -> float64 [n, h, w, C]. Null rows (``valid`` False) are zeroed
    first; with ``lo``/``hi`` the result is rounded half to even and clamped
    to [lo, hi]."""
    global LAUNCHES
    if x.dtype == torch.int16:  # uint16 pixels travel as their int16 bits
        x = x.to(torch.int32) & 0xFFFF
    x = x.to(torch.float64)
    if valid is not None:
        x = torch.where(valid[:, None, None, None], x, 0.0)
    t = torch.einsum("os,nshc->nohc", wh, x)
    out = torch.einsum("ow,nhwc->nhoc", ww, t)
    if lo is not None:
        out = out.round().clamp_(lo, hi)
    if x.device.type == "cuda":
        with COUNT_LOCK:
            LAUNCHES += 1
    return out


def _resize_batch(batch: np.ndarray, h: int, w: int, device,
                  valid: Optional[np.ndarray] = None) -> np.ndarray:
    """(n, H, W, C) pixels of one mode (uint8, uint16 or float32) resized to
    (n, h, w, C) in the same type, chunk by chunk through K11 on ``device``."""
    n, oh, ow, c = batch.shape
    npdt = batch.dtype
    wh = torch.from_numpy(_resize_weight_mat(oh, h)).to(device, torch.float64)
    ww = torch.from_numpy(_resize_weight_mat(ow, w)).to(device, torch.float64)
    lo = hi = None
    if npdt != np.float32:
        info = np.iinfo(npdt)
        lo, hi = int(info.min), int(info.max)
    stage = batch.view(np.int16) if npdt == np.uint16 else batch
    back = {np.dtype(np.uint8): torch.uint8, np.dtype(np.uint16): torch.int16,
            np.dtype(np.float32): torch.float32}[np.dtype(npdt)]
    out = np.empty((n, h, w, c), dtype=npdt)
    view = out.view(np.int16) if npdt == np.uint16 else out
    for i in range(0, n, _RESIZE_CHUNK):
        # arrow's buffers are read-only: torch takes a writable copy of the chunk
        piece = torch.from_numpy(np.require(stage[i:i + _RESIZE_CHUNK],
                                            requirements=["C", "W"])).to(device)
        ok = None
        if valid is not None:
            ok = torch.from_numpy(valid[i:i + _RESIZE_CHUNK]).to(device)
        r = resize_chunk(piece, wh, ww, ok, lo, hi)
        if back == torch.int16:
            r = r.to(torch.int32).to(torch.int16)  # the low 16 bits: the uint16 value
        view[i:i + len(piece)] = r.to(back).cpu().numpy()
    return out


def _resize_fixed_device(s: Series, w: int, h: int) -> Series:
    """K11 over a FixedShapeImage column; the validity comes back as it
    went in."""
    mode, oh, ow = s.dtype.params
    c = _mode_channels(mode)
    npdt = _mode_np_dtype(mode)
    arr = s.to_arrow()
    n = len(arr)
    per = oh * ow * c
    child = arr.values.slice(arr.offset * per, n * per)
    if child.null_count:
        child = child.fill_null(0)
    flat = np.asarray(child.to_numpy(zero_copy_only=False)).astype(npdt, copy=False)
    valid = np.asarray(arr.is_valid()) if arr.null_count else None
    resized = _resize_batch(flat.reshape(n, oh, ow, c), h, w, _resize_device(), valid)
    out_dt = DataType.image(mode, h, w)
    storage_t = out_dt.to_arrow()
    values = pa.array(resized.reshape(-1), storage_t.value_type)
    fsl = pa.FixedSizeListArray.from_arrays(values, h * w * c)
    if arr.null_count:
        # reattach the null bitmap over the flat buffer
        bits = np.packbits(valid, bitorder="little")
        fsl = pa.Array.from_buffers(storage_t, n, [pa.py_buffer(bits.tobytes())],
                                    children=[values])
    return Series(s.name, out_dt, fsl)


def image_crop(s: Series, bbox) -> Series:
    """Crop to (x, y, w, h). bbox is a python tuple or a per-row Series of
    4-element lists. Always returns variable-shape Image (reference parity)."""
    arrays = image_series_to_arrays(s)
    n = len(arrays)
    if isinstance(bbox, Series):
        boxes = bbox.to_pylist()
        if len(boxes) == 1:
            boxes = boxes * n
    else:
        boxes = [tuple(bbox)] * n
    out: List[Optional[np.ndarray]] = []
    modes: List[Optional[str]] = []
    for a, b in zip(arrays, boxes):
        if a is None or b is None:
            out.append(None); modes.append(None)
            continue
        x, y, w, h = (int(v) for v in b)
        ih, iw = a.shape[0], a.shape[1]
        crop = a[max(y, 0):min(y + h, ih), max(x, 0):min(x + w, iw)]
        out.append(crop.copy())
        modes.append(_default_mode(a))
    return image_series_from_arrays(out, s.name, modes)


def image_to_mode(s: Series, mode: str) -> Series:
    if mode not in IMAGE_MODES:
        raise ValueError(f"unknown image mode {mode!r}")
    arrays = image_series_to_arrays(s)
    out: List[Optional[np.ndarray]] = []
    for a in arrays:
        if a is None:
            out.append(None)
            continue
        src_mode = _default_mode(a)
        if src_mode in _PIL_SAFE_MODES and mode in _PIL_SAFE_MODES:
            img = _to_pil(a).convert(_MODE_TO_PIL.get(mode, mode))
            b = np.asarray(img)
            if b.ndim == 2:
                b = b[:, :, None]
            out.append(b.astype(_mode_np_dtype(mode), copy=False))
        else:
            out.append(_convert_mode_np(a, mode))
    dt = s.dtype
    if dt.kind == TypeKind.FIXED_SHAPE_IMAGE:
        _, h, w = dt.params
        return _fixed_image_series(out, s.name, mode, h, w)
    return image_series_from_arrays(out, s.name, [mode] * len(out), dtype_mode=mode)


def _convert_mode_np(a: np.ndarray, mode: str) -> np.ndarray:
    """Mode conversion through a normalized [0,1] float representation — covers
    the 16-bit/float modes PIL's fromarray rejects. Luma uses ITU-R 601
    (0.299/0.587/0.114), matching PIL's RGB->L."""
    if np.issubdtype(a.dtype, np.floating):
        f = np.clip(a.astype(np.float32), 0.0, 1.0)
    else:
        f = a.astype(np.float32) / float(np.iinfo(a.dtype).max)
    c = f.shape[2]
    # split into color + alpha in float
    if c == 1:
        rgb, alpha = np.repeat(f, 3, axis=2), None
    elif c == 2:
        rgb, alpha = np.repeat(f[:, :, :1], 3, axis=2), f[:, :, 1:2]
    elif c == 3:
        rgb, alpha = f, None
    else:
        rgb, alpha = f[:, :, :3], f[:, :, 3:4]
    base = mode.rstrip("0123456789F") or mode  # L/LA/RGB/RGBA
    if base in ("L", "LA"):
        gray = (rgb @ np.array([0.299, 0.587, 0.114], np.float32))[:, :, None]
        colors = gray
    else:
        colors = rgb
    want_c = _mode_channels(mode)
    if base in ("LA", "RGBA"):
        if alpha is None:
            alpha = np.ones(colors.shape[:2] + (1,), np.float32)
        outf = np.concatenate([colors, alpha], axis=2)
    else:
        outf = colors
    assert outf.shape[2] == want_c, (outf.shape, mode)
    npdt = _mode_np_dtype(mode)
    if np.issubdtype(npdt, np.floating):
        return outf.astype(npdt)
    mx = float(np.iinfo(npdt).max)
    return np.clip(np.rint(outf * mx), 0, mx).astype(npdt)


def _fixed_image_series(arrays: List[Optional[np.ndarray]], name: str, mode: str,
                        h: int, w: int) -> Series:
    """Pack HxWxC arrays into the fixed_size_list storage through ONE flat
    numpy buffer (pa.array over per-row .tolist() would make h*w*c python
    ints a row, 27 M objects for 1,000 96-pixel images)."""
    dt = DataType.image(mode, h, w)
    c = _mode_channels(mode)
    npdt = _mode_np_dtype(mode)
    per = h * w * c
    n = len(arrays)
    t = dt.to_arrow()
    flat = np.zeros(n * per, dtype=npdt)
    validity = np.ones(n, dtype=bool)
    for i, a in enumerate(arrays):
        if a is None:
            validity[i] = False
        else:
            flat[i * per:(i + 1) * per] = a.reshape(-1)
    values = pa.array(flat, t.value_type)
    fsl = pa.FixedSizeListArray.from_arrays(values, per)
    if not validity.all():
        bits = np.packbits(validity, bitorder="little")
        fsl = pa.Array.from_buffers(t, n, [pa.py_buffer(bits.tobytes())],
                                    children=[values])
    return Series(name, dt, fsl)


# ---------------------------------------------------------------------------
# url kernels
# ---------------------------------------------------------------------------

def _fetch_one(client, url: str, timeout: float) -> bytes:
    # every scheme (s3/http/file) rides the IOClient: retry with backoff,
    # connection budget, IO counters
    return client.get(url, timeout=timeout)


def url_download(s: Series, max_connections: int = 32, on_error: str = "raise",
                 timeout: float = 30.0) -> Series:
    """String urls -> binary contents, fetched ``max_connections`` at a
    time through one client for the batch, in row order; a null url gives a
    null. ``on_error="null"`` turns a failed fetch into a null, else the
    first failure raises."""
    from .io.object_store import default_io_client

    urls = s.to_pylist()
    out: List[Optional[bytes]] = [None] * len(urls)
    errs: List[Optional[Exception]] = [None] * len(urls)
    workers = max(1, min(int(max_connections), 64))
    # resolve the client ONCE per batch: default_io_client() re-reads the
    # store configs from env under a lock, and per-url resolution serializes
    # a 10k-wide download on that lock
    client = default_io_client()
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="daft-mm-download") as ex:
        futs = {}
        for i, u in enumerate(urls):
            if u is None:
                continue
            futs[ex.submit(_fetch_one, client, u, timeout)] = i
        for f in concurrent.futures.as_completed(futs):
            i = futs[f]
            try:
                out[i] = f.result()
            except Exception as e:  # noqa: BLE001
                errs[i] = e
    first_err = next((e for e in errs if e is not None), None)
    if first_err is not None and on_error != "null":
        raise first_err
    return Series.from_pylist(out, s.name, DataType.binary())


def url_upload(s: Series, location, on_error: str = "raise",
               max_connections: int = 32) -> Series:
    """binary contents -> written file paths under `location`.

    Remote targets (s3://, any scheme the object-store client routes) and
    local paths alike; the writes run ``max_connections`` at a time, each
    through the client's connection budget, as url_download's reads do."""
    from .io.object_store import STORAGE

    if isinstance(location, Series):
        locs = location.to_pylist()
        if len(locs) == 1:
            locs = locs * len(s)
    else:
        locs = [location] * len(s)
    vals = s.to_pylist()
    n = len(vals)
    out: List[Optional[str]] = [None] * n
    errs: List[Optional[Exception]] = [None] * n

    def _upload_one(i: int, v, loc: str) -> str:
        data = v if isinstance(v, (bytes, bytearray)) else str(v).encode()
        if loc.startswith("file://"):
            loc = loc[len("file://"):]  # return plain fs paths, as before
        path = STORAGE.join(loc, f"{i}-{uuid.uuid4().hex}.bin")
        if not STORAGE.is_remote(loc):
            STORAGE.makedirs(loc)
        STORAGE.put(path, bytes(data))
        return path

    workers = max(1, min(int(max_connections), 64))
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="daft-mm-upload") as ex:
        futs = {}
        for i, (v, loc) in enumerate(zip(vals, locs)):
            if v is None or loc is None:
                continue
            futs[ex.submit(_upload_one, i, v, loc)] = i
        for f in concurrent.futures.as_completed(futs):
            i = futs[f]
            try:
                out[i] = f.result()
            except Exception as e:  # noqa: BLE001
                errs[i] = e
    first_err = next((e for e in errs if e is not None), None)
    if first_err is not None and on_error != "null":
        raise first_err
    return Series.from_pylist(out, s.name, DataType.string())


# ---------------------------------------------------------------------------
# function registry entries
# ---------------------------------------------------------------------------

def _req_image(dt: DataType, what: str) -> None:
    if dt.kind not in (TypeKind.IMAGE, TypeKind.FIXED_SHAPE_IMAGE):
        raise ValueError(f"{what} expects an image column, got {dt}")


def _res_decode(*dts, mode=None, on_error="raise"):
    if not (dts[0].kind == TypeKind.BINARY or dts[0].is_null()):
        raise ValueError(f"image.decode expects binary, got {dts[0]}")
    return DataType.image(mode)


def _res_encode(*dts, image_format="png"):
    _req_image(dts[0], "image.encode")
    return DataType.binary()


def _res_resize(*dts, w=None, h=None):
    _req_image(dts[0], "image.resize")
    d = dts[0]
    if d.kind == TypeKind.FIXED_SHAPE_IMAGE:
        return DataType.image(d.params[0], h, w)
    return d


def _res_crop(*dts, bbox=None):
    _req_image(dts[0], "image.crop")
    d = dts[0]
    mode = d.params[0] if d.kind != TypeKind.FIXED_SHAPE_IMAGE else None
    return DataType.image(mode)


def _res_to_mode(*dts, mode=None):
    _req_image(dts[0], "image.to_mode")
    d = dts[0]
    if d.kind == TypeKind.FIXED_SHAPE_IMAGE:
        return DataType.image(mode, d.params[1], d.params[2])
    return DataType.image(mode)


def _res_download(*dts, **_kw):
    if not (dts[0].is_string() or dts[0].is_null()):
        raise ValueError(f"url.download expects string urls, got {dts[0]}")
    return DataType.binary()


def _res_upload(*dts, **_kw):
    return DataType.string()


register("image.decode", _res_decode, image_decode)
register("image.encode", _res_encode,
         lambda s, image_format="png": image_encode(s, image_format))
register("image.resize", _res_resize, lambda s, w=None, h=None: image_resize(s, w, h))
register("image.crop", _res_crop,
         lambda s, *args, bbox=None: image_crop(s, args[0] if args else bbox))
register("image.to_mode", _res_to_mode, lambda s, mode=None: image_to_mode(s, mode))
register("url.download", _res_download, url_download)
register("url.upload", _res_upload,
         lambda s, *args, location=None, **kw: url_upload(s, args[0] if args else location, **kw))


# ---------------------------------------------------------------------------
# the expression namespaces (``Expression.image``, ``Expression.url``)
# ---------------------------------------------------------------------------

class ExprImageNamespace(_Namespace):
    def decode(self, on_error: str = "raise", mode: Optional[str] = None):
        return self._fn("image.decode", mode=mode, on_error=on_error)

    def encode(self, image_format: str):
        return self._fn("image.encode", image_format=image_format)

    def resize(self, w: int, h: int):
        return self._fn("image.resize", w=w, h=h)

    def crop(self, bbox):
        from .expressions import Expression

        if isinstance(bbox, Expression):
            return self._fn("image.crop", bbox)
        return self._fn("image.crop", bbox=tuple(bbox))

    def to_mode(self, mode: str):
        return self._fn("image.to_mode", mode=mode)


class ExprUrlNamespace(_Namespace):
    def download(self, max_connections: int = 32, on_error: str = "raise",
                 io_config=None, use_native_downloader: bool = True):
        return self._fn("url.download", max_connections=max_connections, on_error=on_error)

    def upload(self, location, on_error: str = "raise", max_connections: int = 32,
               io_config=None):
        from .expressions import Expression

        if isinstance(location, Expression):
            return self._fn("url.upload", location, on_error=on_error)
        return self._fn("url.upload", location=location, on_error=on_error)
