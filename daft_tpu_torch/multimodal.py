"""Multimodal kernels and their expression namespace: the url half (the
port's copy of part of daft_tpu/multimodal.py).

``url.download`` fetches each row's url (``s3://``, ``gs://``, ``az://``,
``hf://``, ``http(s)://``, ``file://`` or a local path) through the
object-store client (io/object_store.py): one client a batch,
``max_connections`` fetches in flight, retries under its policy, results
in row order, ``on_error`` ``raise`` or ``null``. ``url.upload`` writes each
row's bytes as a new object under a location (local or remote, one for
all rows or one a row) and returns the written paths. Both run on the
host: their work is IO. The image half (decode, encode, resize, crop,
to_mode and the Image types) comes with ROADMAP, Queue 1, item 10.
"""

from __future__ import annotations

import concurrent.futures
import uuid
from typing import List, Optional

from .datatypes import DataType
from .expressions import _Namespace
from .functions import register
from .series import Series

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

def _res_download(*dts, **_kw):
    if not (dts[0].is_string() or dts[0].is_null()):
        raise ValueError(f"url.download expects string urls, got {dts[0]}")
    return DataType.binary()


def _res_upload(*dts, **_kw):
    return DataType.string()


register("url.download", _res_download, url_download)
register("url.upload", _res_upload,
         lambda s, *args, location=None, **kw: url_upload(s, args[0] if args else location, **kw))


# ---------------------------------------------------------------------------
# the expression namespace (``Expression.url``)
# ---------------------------------------------------------------------------

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
