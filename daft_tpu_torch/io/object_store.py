"""Object-store IO (the port's copy of daft_tpu/io/object_store.py): the
sources, the client, ranged reads, retries and store-aware glob.

Every read and write of a remote object funnels through ``IOClient``: a
connection budget (a semaphore across threads, ``max_connections``), the
retry policy (exponential backoff with jitter on transient failures: 5xx,
429, timeouts, connection resets), the ``io.get`` fault site inside the
retry loop, and the ``IO_STATS`` counters (``bytes_read``,
``bytes_written``, ``retries``). The standard library carries the wire
protocols (``http.client``, ``hashlib``/``hmac`` for the signatures), so no
SDK is needed and the compute path never touches this layer; scans, the
lake formats and ``url.download``/``url.upload`` do.

Schemes: ``s3://bucket/key`` (``AWS_ENDPOINT_URL`` points S3-compatible
stores and tests anywhere; SigV4 signing with ``AWS_ACCESS_KEY_ID`` and
``AWS_SECRET_ACCESS_KEY``), ``gs://`` (the GCS XML API in the S3 dialect,
bearer tokens), ``az://`` and ``abfs(s)://`` (the Blob REST API, shared key
or SAS), ``hf://`` (the Hugging Face Hub), ``http(s)://`` (redirects
followed) and ``file://`` or bare local paths. ``default_io_client()``
rebuilds its stores' settings from the environment whenever they change;
``STORAGE`` is the file surface the writers and the lake formats use over
local and remote paths alike.
"""

from __future__ import annotations

import hashlib
import hmac
import http.client
import io
import os
import random
import threading
import time
import urllib.parse
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..errors import DaftIOError, DaftNotFoundError, DaftTransientError, DaftValueError
from ..obs.log import get_logger
from .scan import IO_STATS

logger = get_logger("object_store")

REMOTE_SCHEMES = ("s3://", "http://", "https://", "gs://", "az://", "abfs://",
                  "abfss://", "hf://")


def is_remote_path(path: str) -> bool:
    return str(path).startswith(REMOTE_SCHEMES)


@dataclass
class ObjectMeta:
    path: str
    size: Optional[int] = None


class TransientIOError(DaftTransientError):
    """A retryable failure (5xx, 429, a timeout, a connection reset). A
    DaftTransientError, so one retry discipline covers real and injected
    transient failures."""


class NotFoundIOError(DaftNotFoundError):
    """The object, container or prefix does not exist (HTTP 404). Distinct
    from transient and auth failures, so ``Storage.list_names`` reads only
    a genuine absence as an empty directory: an outage or an expired
    credential propagates. A DaftNotFoundError, so a FileNotFoundError."""


@dataclass
class RetryPolicy:
    """Attempts with exponential backoff and jitter (jitter keeps retrying
    readers from retrying in step): the one retry discipline of the object
    store, the scan tasks and the scheduler. ``permanent`` exceptions,
    checked first, propagate at once; ``retryable`` ones retry, each counted
    in ``IO_STATS.retries``; the last one raises after ``attempts``."""

    attempts: int = 4
    backoff_s: float = 0.1
    max_backoff_s: float = 4.0
    retryable: tuple = (DaftTransientError,)
    permanent: tuple = ()

    def run(self, fn):
        last = None
        for attempt in range(max(1, self.attempts)):
            try:
                return fn()
            except self.permanent:
                raise
            except self.retryable as e:
                last = e
                IO_STATS.bump(retries=1)
                if attempt + 1 >= self.attempts:
                    break
                delay = min(self.backoff_s * (2 ** attempt), self.max_backoff_s)
                time.sleep(delay * (0.5 + random.random() / 2))
        raise last


class ObjectSource:
    """get (whole or ranged), get_size, put, delete, ls and glob over one
    scheme."""

    def get(self, path: str, range: Optional[Tuple[int, int]] = None,
            timeout: Optional[float] = None) -> bytes:
        raise NotImplementedError

    def get_size(self, path: str) -> int:
        raise NotImplementedError

    def put(self, path: str, data: bytes, if_none_match: bool = False) -> None:
        """Write an object. `if_none_match` requests put-if-absent semantics
        (HTTP `If-None-Match: *` / local O_EXCL); raises FileExistsError when
        the object already exists — the atomic-commit primitive the Delta/
        Iceberg writers build on."""
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError

    def ls(self, prefix: str) -> List[ObjectMeta]:
        raise NotImplementedError

    def glob(self, pattern: str) -> List[ObjectMeta]:
        raise NotImplementedError


class LocalSource(ObjectSource):
    def _p(self, path: str) -> str:
        return path[len("file://"):] if path.startswith("file://") else path

    def get(self, path, range=None, timeout=None):
        with open(self._p(path), "rb") as f:
            if range is None:
                return f.read()
            f.seek(range[0])
            return f.read(range[1] - range[0])

    def get_size(self, path):
        return os.path.getsize(self._p(path))

    def ls(self, prefix):
        p = self._p(prefix)
        if os.path.isfile(p):
            return [ObjectMeta(p, os.path.getsize(p))]
        out = []
        for root, _dirs, files in os.walk(p):
            for f in sorted(files):
                fp = os.path.join(root, f)
                out.append(ObjectMeta(fp, os.path.getsize(fp)))
        return out

    def put(self, path, data, if_none_match=False):
        p = self._p(path)
        os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
        if if_none_match:
            fd = os.open(p, os.O_WRONLY | os.O_CREAT | os.O_EXCL)
            try:
                os.write(fd, data)
            finally:
                os.close(fd)
        else:
            with open(p, "wb") as f:
                f.write(data)

    def delete(self, path):
        os.unlink(self._p(path))

    def glob(self, pattern):
        import glob as _glob

        return [ObjectMeta(p, os.path.getsize(p))
                for p in sorted(_glob.glob(self._p(pattern), recursive=True))
                if os.path.isfile(p)]


def _http_request(url: str, method: str = "GET",
                  headers: Optional[Dict[str, str]] = None,
                  body: Optional[bytes] = None,
                  timeout: float = 30.0) -> Tuple[int, Dict[str, str], bytes]:
    """One HTTP exchange; maps transport failures and 5xx/429 to
    TransientIOError so the retry policy can act."""
    u = urllib.parse.urlsplit(url)
    conn_cls = http.client.HTTPSConnection if u.scheme == "https" else http.client.HTTPConnection
    conn = conn_cls(u.hostname, u.port, timeout=timeout)
    target = (u.path or "/") + (f"?{u.query}" if u.query else "")
    try:
        conn.request(method, target, body=body, headers=headers or {})
        resp = conn.getresponse()
        data = resp.read()
        status = resp.status
        rheaders = {k.lower(): v for k, v in resp.getheaders()}
    except (OSError, http.client.HTTPException) as e:
        raise TransientIOError(f"{method} {url}: {e}") from e
    finally:
        conn.close()
    if status >= 500 or status == 429:
        raise TransientIOError(f"{method} {url}: HTTP {status}")
    return status, rheaders, data


def _raise_http(op: str, path: str, status: int):
    """Map a terminal HTTP status to the typed error discipline: 404 is the
    distinguishable not-found (so exists() can answer False without
    swallowing auth/transient failures); everything else stays IOError."""
    if status == 404:
        raise NotFoundIOError(f"{op} {path}: HTTP 404")
    raise DaftIOError(f"{op} {path}: HTTP {status}")


class HttpSource(ObjectSource):
    """http(s) objects with Range reads and redirect following."""

    MAX_REDIRECTS = 5

    def __init__(self, timeout: float = 30.0):
        self.timeout = timeout

    def _request(self, url, method="GET", headers=None, timeout=None,
                 body=None):
        """Follow up to MAX_REDIRECTS 3xx hops (presigned urls, CDNs, and
        http->https upgrades all redirect; urllib used to do this for us)."""
        t = timeout if timeout is not None else self.timeout
        for _ in range(self.MAX_REDIRECTS + 1):
            status, h, data = _http_request(url, method=method,
                                            headers=headers, body=body,
                                            timeout=t)
            if status in (301, 302, 303, 307, 308) and "location" in h:
                url = urllib.parse.urljoin(url, h["location"])
                continue
            return status, h, data
        raise DaftIOError(f"{method} {url}: too many redirects")

    def get(self, path, range=None, timeout=None):
        headers = {}
        if range is not None:
            headers["Range"] = f"bytes={range[0]}-{range[1] - 1}"
        status, _h, data = self._request(path, headers=headers, timeout=timeout)
        if status not in (200, 206):
            _raise_http("GET", path, status)
        if range is not None and status == 200:
            return data[range[0]:range[1]]  # server ignored Range
        return data

    def get_size(self, path):
        status, h, _ = self._request(path, method="HEAD")
        if status != 200:
            _raise_http("HEAD", path, status)
        if "content-length" not in h:
            # 200 without Content-Length (chunked/dynamic HEAD): the object
            # exists but its size is only learnable by reading it
            return len(self.get(path))
        return int(h["content-length"])

    def put(self, path, data, if_none_match=False):
        headers = {"If-None-Match": "*"} if if_none_match else {}
        status, _h, _b = self._request(path, method="PUT", headers=headers,
                                       body=data)
        if status in (409, 412):
            raise FileExistsError(f"PUT {path}: exists (HTTP {status})")
        if status not in (200, 201, 204):
            raise DaftIOError(f"PUT {path}: HTTP {status}")

    def ls(self, prefix):
        raise DaftIOError("http source cannot list; pass explicit urls")

    def glob(self, pattern):
        if any(ch in pattern for ch in "*?["):
            raise DaftIOError("http source cannot glob; pass explicit urls")
        return [ObjectMeta(pattern)]


@dataclass
class S3Config:
    """S3 settings, from the environment by default (``AWS_*``);
    ``endpoint_url`` points S3-compatible stores (and tests) anywhere."""

    endpoint_url: Optional[str] = None
    region: str = "us-east-1"
    key_id: Optional[str] = None
    secret_key: Optional[str] = None
    session_token: Optional[str] = None
    anonymous: bool = False
    timeout: float = 30.0

    @staticmethod
    def from_env() -> "S3Config":
        return S3Config(
            endpoint_url=os.environ.get("AWS_ENDPOINT_URL"),
            region=os.environ.get("AWS_REGION", "us-east-1"),
            key_id=os.environ.get("AWS_ACCESS_KEY_ID"),
            secret_key=os.environ.get("AWS_SECRET_ACCESS_KEY"),
            session_token=os.environ.get("AWS_SESSION_TOKEN"),
        )


def _sigv4_headers(cfg: S3Config, method: str, url: str,
                   payload_hash: str = "UNSIGNED-PAYLOAD",
                   extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """AWS Signature V4 (pure stdlib). Skipped for anonymous access.
    `extra` headers (e.g. If-None-Match on conditional writes) are folded
    into the signed set."""
    u = urllib.parse.urlsplit(url)
    now = time.gmtime()
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", now)
    datestamp = time.strftime("%Y%m%d", now)
    host = u.hostname + (f":{u.port}" if u.port else "")
    headers = {"host": host, "x-amz-date": amz_date,
               "x-amz-content-sha256": payload_hash}
    for k, v in (extra or {}).items():
        headers[k.lower()] = v
    if cfg.session_token:
        headers["x-amz-security-token"] = cfg.session_token
    signed = ";".join(sorted(headers))
    canonical_q = "&".join(sorted(u.query.split("&"))) if u.query else ""
    # u.path is already percent-encoded by the caller (_url quotes the key);
    # re-quoting would double-encode and break the signature for keys with
    # spaces/'+'/'=' (SignatureDoesNotMatch)
    canonical = "\n".join([
        method, u.path or "/", canonical_q,
        "".join(f"{k}:{headers[k]}\n" for k in sorted(headers)), signed,
        payload_hash])
    scope = f"{datestamp}/{cfg.region}/s3/aws4_request"
    to_sign = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                         hashlib.sha256(canonical.encode()).hexdigest()])

    def _hmac(key, msg):
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    k = _hmac(("AWS4" + cfg.secret_key).encode(), datestamp)
    k = _hmac(_hmac(_hmac(k, cfg.region), "s3"), "aws4_request")
    sig = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()
    out = dict(headers)
    out["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={cfg.key_id}/{scope}, "
        f"SignedHeaders={signed}, Signature={sig}")
    out.pop("host")  # http.client sets it
    return out


class S3Source(ObjectSource):
    """Minimal S3 REST dialect: GET object (+Range), HEAD, ListObjectsV2 with
    pagination, PUT (put-if-absent, multipart), DELETE. Path-style addressing against
    endpoint_url; virtual-host style against AWS proper."""

    scheme = "s3"

    def __init__(self, cfg: Optional[S3Config] = None):
        self.cfg = cfg or S3Config.from_env()

    def _url(self, bucket: str, key: str = "", query: str = "") -> str:
        if self.cfg.endpoint_url:
            base = self.cfg.endpoint_url.rstrip("/")
            url = f"{base}/{bucket}"
        else:
            url = f"https://{bucket}.s3.{self.cfg.region}.amazonaws.com"
        if key:
            url += "/" + urllib.parse.quote(key)
        if query:
            url += "?" + query
        return url

    def _will_sign(self) -> bool:
        return not self.cfg.anonymous and bool(
            self.cfg.key_id and self.cfg.secret_key)

    def _payload_hash(self, data) -> str:
        """sha256 of the body, but only when a signature will carry it —
        hashing a 512 MB part is seconds of pure waste for anonymous or
        bearer-auth uploads."""
        if not self._will_sign():
            return "UNSIGNED-PAYLOAD"
        return hashlib.sha256(data).hexdigest()

    def _headers(self, method: str, url: str,
                 payload_hash: str = "UNSIGNED-PAYLOAD",
                 extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
        if not self._will_sign():
            return dict(extra or {})
        return _sigv4_headers(self.cfg, method, url, payload_hash, extra)

    @classmethod
    def _split(cls, path: str) -> Tuple[str, str]:
        rest = path[len(cls.scheme) + 3:]
        bucket, _, key = rest.partition("/")
        return bucket, key

    def get(self, path, range=None, timeout=None):
        bucket, key = self._split(path)
        url = self._url(bucket, key)
        headers = self._headers("GET", url)
        if range is not None:
            headers["Range"] = f"bytes={range[0]}-{range[1] - 1}"
        status, _h, data = _http_request(
            url, headers=headers,
            timeout=timeout if timeout is not None else self.cfg.timeout)
        if status not in (200, 206):
            _raise_http("GET", path, status)
        if range is not None and status == 200:
            return data[range[0]:range[1]]  # endpoint ignored Range
        return data

    def get_size(self, path):
        bucket, key = self._split(path)
        url = self._url(bucket, key)
        status, h, _ = _http_request(url, method="HEAD",
                                     headers=self._headers("HEAD", url),
                                     timeout=self.cfg.timeout)
        if status != 200 or "content-length" not in h:
            _raise_http("HEAD", path, status)
        return int(h["content-length"])

    # Multipart kicks in above this size (instance attrs so tests can force
    # the multipart path with small objects); S3's own floor is 5 MiB parts.
    multipart_threshold = 64 * 1024 * 1024
    part_size = 32 * 1024 * 1024

    def put(self, path, data, if_none_match=False):
        """PUT object; conditional via `If-None-Match: *` (S3 put-if-absent,
        2024 API — the atomic-commit primitive).
        Objects past multipart_threshold go through CreateMultipartUpload/
        UploadPart/CompleteMultipartUpload."""
        bucket, key = self._split(path)
        if len(data) > self.multipart_threshold:
            return self._put_multipart(bucket, key, path, data, if_none_match)
        url = self._url(bucket, key)
        extra = {"If-None-Match": "*"} if if_none_match else None
        headers = self._headers("PUT", url,
                                payload_hash=self._payload_hash(data),
                                extra=extra)
        status, _h, body = _http_request(url, method="PUT", headers=headers,
                                         body=data, timeout=self.cfg.timeout)
        if status in (409, 412):
            raise FileExistsError(f"PUT {path}: object exists (HTTP {status})")
        if status not in (200, 201):
            raise DaftIOError(f"PUT {path}: HTTP {status}")

    def _put_multipart(self, bucket, key, path, data, if_none_match):
        import xml.etree.ElementTree as ET

        url = self._url(bucket, key, query="uploads=")
        status, _h, body = _http_request(
            url, method="POST", headers=self._headers("POST", url,
            payload_hash=self._payload_hash(b"")),
            timeout=self.cfg.timeout)
        if status != 200:
            raise DaftIOError(f"CreateMultipartUpload {path}: HTTP {status}")
        root = ET.fromstring(body)
        ns = root.tag[:root.tag.index("}") + 1] if root.tag.startswith("{") else ""
        uid_el = root.find(f"{ns}UploadId")
        if uid_el is None or not uid_el.text:
            raise DaftIOError(f"CreateMultipartUpload {path}: no UploadId")
        uid = urllib.parse.quote(uid_el.text, safe="")
        try:
            etags: List[str] = []
            for n, start in enumerate(range(0, len(data), self.part_size), 1):
                part = data[start:start + self.part_size]
                purl = self._url(bucket, key,
                                 query=f"partNumber={n}&uploadId={uid}")
                status, h, _b = _http_request(
                    purl, method="PUT",
                    headers=self._headers("PUT", purl,
                    payload_hash=self._payload_hash(part)),
                    body=part, timeout=self.cfg.timeout)
                if status != 200:
                    raise DaftIOError(f"UploadPart {n} {path}: HTTP {status}")
                etags.append(h.get("etag", ""))
            manifest = ("<CompleteMultipartUpload>" + "".join(
                f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag></Part>"
                for n, e in enumerate(etags, 1)) +
                "</CompleteMultipartUpload>").encode()
            curl = self._url(bucket, key, query=f"uploadId={uid}")
            extra = {"If-None-Match": "*"} if if_none_match else None
            status, _h, _b = _http_request(
                curl, method="POST", headers=self._headers("POST", curl,
                payload_hash=self._payload_hash(manifest), extra=extra),
                body=manifest, timeout=self.cfg.timeout)
            if status in (409, 412):
                raise FileExistsError(f"PUT {path}: object exists (HTTP {status})")
            if status != 200:
                raise DaftIOError(f"CompleteMultipartUpload {path}: HTTP {status}")
        except BaseException:
            try:  # abort so the store reclaims staged parts; best-effort
                aurl = self._url(bucket, key, query=f"uploadId={uid}")
                _http_request(aurl, method="DELETE",
                              headers=self._headers("DELETE", aurl),
                              timeout=self.cfg.timeout)
            except Exception as abort_err:
                # the original upload failure is what propagates; a failed
                # abort only leaves staged parts for the store's GC
                logger.warning("multipart_abort_failed", path=path,
                               error=repr(abort_err),
                               note="staged parts await bucket lifecycle GC")
            raise

    def delete(self, path):
        bucket, key = self._split(path)
        url = self._url(bucket, key)
        status, _h, _b = _http_request(url, method="DELETE",
                                       headers=self._headers("DELETE", url),
                                       timeout=self.cfg.timeout)
        if status not in (200, 204):
            raise DaftIOError(f"DELETE {path}: HTTP {status}")

    def ls(self, prefix):
        bucket, key = self._split(prefix)
        out: List[ObjectMeta] = []
        token = None
        while True:
            q = "list-type=2&prefix=" + urllib.parse.quote(key, safe="")
            if token:
                q += "&continuation-token=" + urllib.parse.quote(token, safe="")
            url = self._url(bucket, query=q)
            status, _h, data = _http_request(url, headers=self._headers("GET", url),
                                             timeout=self.cfg.timeout)
            if status == 404:
                raise NotFoundIOError(f"LIST {prefix}: HTTP 404")
            if status != 200:
                raise DaftIOError(f"LIST {prefix}: HTTP {status}")
            keys, token = _parse_list_objects(data)
            out.extend(ObjectMeta(f"{self.scheme}://{bucket}/{k}", sz)
                       for k, sz in keys)
            if not token:
                return out

    def glob(self, pattern):
        bucket, key = self._split(pattern)
        return _glob_via_ls(f"{self.scheme}://{bucket}", key, self.ls)


def _glob_via_ls(base: str, key: str, ls_fn) -> List[ObjectMeta]:
    """Shared store-glob: list from the longest wildcard-free prefix, then
    match with path-aware glob semantics — '*'/'?' stay within one path
    segment, '**' crosses segments, as local glob does (fnmatch would let
    '*' swallow '/'). A wildcard-free
    key returns the exact object, else a directory-style listing."""
    cut = len(key)
    for i, ch in enumerate(key):
        if ch in "*?[":
            cut = i
            break
    listed = ls_fn(f"{base}/{key[:cut]}")
    if cut == len(key):
        exact = [m for m in listed if m.path == f"{base}/{key}"]
        if exact:
            return exact
        dirp = f"{base}/{key.rstrip('/')}/"
        return [m for m in listed if m.path.startswith(dirp)]
    rx = _glob_to_regex(key)
    return [m for m in listed if rx.fullmatch(m.path[len(base) + 1:])]


def _glob_to_regex(pattern: str):
    """Translate a path glob to a regex where '*'/'?' do not cross '/' and
    '**' does (local-filesystem glob semantics)."""
    import re

    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "*":
            if pattern[i:i + 2] == "**":
                out.append(".*")
                i += 2
                if i < len(pattern) and pattern[i] == "/":
                    i += 1  # '**/' also matches zero directories
                continue
            out.append("[^/]*")
        elif c == "?":
            out.append("[^/]")
        elif c == "[":
            j = pattern.find("]", i + 1)
            if j == -1:
                out.append(re.escape(c))
            else:
                out.append(pattern[i:j + 1])
                i = j
        else:
            out.append(re.escape(c))
        i += 1
    return re.compile("".join(out))


def _parse_list_objects(xml: bytes) -> Tuple[List[Tuple[str, Optional[int]]], Optional[str]]:
    import xml.etree.ElementTree as ET

    root = ET.fromstring(xml)
    ns = ""
    if root.tag.startswith("{"):
        ns = root.tag[:root.tag.index("}") + 1]
    keys = []
    for c in root.iter(f"{ns}Contents"):
        k = c.find(f"{ns}Key")
        s = c.find(f"{ns}Size")
        if k is not None:
            keys.append((k.text, int(s.text) if s is not None and s.text else None))
    trunc = root.find(f"{ns}IsTruncated")
    token = None
    if trunc is not None and (trunc.text or "").lower() == "true":
        t = root.find(f"{ns}NextContinuationToken")
        token = t.text if t is not None else None
    return keys, token


# ---------------------------------------------------------------------------
# GCS / Azure / HuggingFace sources
# ---------------------------------------------------------------------------

@dataclass
class GCSConfig:
    """GCS settings (``GCS_ENDPOINT_URL``, ``GCS_TOKEN`` or
    ``GOOGLE_OAUTH_TOKEN``). Auth is an OAuth2 bearer token (service-account
    JWT flows need RS256 signing, which the standard library cannot do) or
    anonymous; the endpoint override serves tests and fake-gcs servers."""

    endpoint_url: str = "https://storage.googleapis.com"
    token: Optional[str] = None
    anonymous: bool = False
    timeout: float = 30.0

    @staticmethod
    def from_env() -> "GCSConfig":
        return GCSConfig(
            endpoint_url=os.environ.get("GCS_ENDPOINT_URL",
                                        "https://storage.googleapis.com"),
            token=os.environ.get("GCS_TOKEN")
            or os.environ.get("GOOGLE_OAUTH_TOKEN"),
        )


class GCSSource(S3Source):
    """gs:// objects over the GCS XML API — which is S3-wire-compatible
    (path-style addressing, Range gets, list-type=2 listings), so the whole
    S3Source machinery (ranged reads, pagination, glob, multipart) is reused
    with bearer-token auth swapped in."""

    scheme = "gs"

    def __init__(self, cfg: Optional[GCSConfig] = None):
        self.gcs = cfg or GCSConfig.from_env()
        # S3Source internals read endpoint/timeout off self.cfg
        super().__init__(S3Config(endpoint_url=self.gcs.endpoint_url,
                                  anonymous=True, timeout=self.gcs.timeout))

    def _will_sign(self):
        return False  # bearer token, never SigV4 -> skip payload hashing

    def _headers(self, method, url, payload_hash="UNSIGNED-PAYLOAD",
                 extra=None):
        out = dict(extra or {})
        # GCS does not honor S3's `If-None-Match: *` on uploads; its
        # put-if-absent is `x-goog-if-generation-match: 0` (docs: XML API
        # request headers). Translate so Delta commits on gs:// keep the
        # atomic contract instead of silently overwriting.
        if out.pop("If-None-Match", None) == "*":
            out["x-goog-if-generation-match"] = "0"
        if self.gcs.token and not self.gcs.anonymous:
            out["Authorization"] = f"Bearer {self.gcs.token}"
        return out


@dataclass
class AzureConfig:
    """Azure settings (``AZURE_STORAGE_ACCOUNT``, ``AZURE_STORAGE_KEY``,
    ``AZURE_STORAGE_SAS_TOKEN``, ``AZURE_ENDPOINT_URL``): shared-key auth
    (the HMAC the azure SDKs compute), a SAS token query suffix, or
    anonymous."""

    account: Optional[str] = None
    key: Optional[str] = None          # base64 shared key
    sas_token: Optional[str] = None    # pre-signed query string
    endpoint_url: Optional[str] = None  # override: http://host:port for tests
    anonymous: bool = False
    timeout: float = 30.0

    @staticmethod
    def from_env() -> "AzureConfig":
        return AzureConfig(
            account=os.environ.get("AZURE_STORAGE_ACCOUNT"),
            key=os.environ.get("AZURE_STORAGE_KEY"),
            sas_token=os.environ.get("AZURE_STORAGE_SAS_TOKEN"),
            endpoint_url=os.environ.get("AZURE_ENDPOINT_URL"),
        )


class AzureSource(ObjectSource):
    """az:// (and abfs[s]://) blobs over the Blob REST API: GET (+Range),
    HEAD, PUT, List Blobs with marker pagination, shared-key signing."""

    def __init__(self, cfg: Optional[AzureConfig] = None):
        self.cfg = cfg or AzureConfig.from_env()

    def _split(self, path: str) -> Tuple[str, str]:
        p = str(path)
        for pre in ("az://", "abfs://", "abfss://"):
            if p.startswith(pre):
                rest = p[len(pre):]
                break
        else:
            raise DaftValueError(f"not an azure path: {path}")
        container, _, key = rest.partition("/")
        # abfs://container@account.dfs.core.windows.net/key names the
        # account in the authority: honor it, never silently target a
        # DIFFERENT configured account (cross-account data corruption)
        if "@" in container:
            container, authority = container.split("@", 1)
            account = authority.split(".", 1)[0]
            if self.cfg.account and account != self.cfg.account:
                raise DaftIOError(
                    f"azure path names account {account!r} but the client "
                    f"is configured for {self.cfg.account!r}: {path}")
            if not self.cfg.account:
                self.cfg.account = account
        return container, key

    def _base(self) -> str:
        if self.cfg.endpoint_url:
            base = self.cfg.endpoint_url.rstrip("/")
            # test endpoints (azurite-style) scope urls by account
            if self.cfg.account and not base.endswith(self.cfg.account):
                base = f"{base}/{self.cfg.account}"
            return base
        if not self.cfg.account:
            raise DaftIOError("azure: AZURE_STORAGE_ACCOUNT is not set")
        return f"https://{self.cfg.account}.blob.core.windows.net"

    def _url(self, container: str, key: str = "", query: str = "") -> str:
        url = f"{self._base()}/{container}"
        if key:
            url += "/" + urllib.parse.quote(key)
        q = query
        if self.cfg.sas_token:
            sas = self.cfg.sas_token.lstrip("?")
            q = f"{q}&{sas}" if q else sas
        if q:
            url += "?" + q
        return url

    def _headers(self, method: str, url: str, content_length: int = 0,
                 extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
        headers = dict(extra or {})
        headers["x-ms-version"] = "2021-08-06"
        headers["x-ms-date"] = time.strftime("%a, %d %b %Y %H:%M:%S GMT",
                                             time.gmtime())
        if self.cfg.anonymous or not (self.cfg.account and self.cfg.key):
            return headers
        import base64

        u = urllib.parse.urlsplit(url)
        # canonicalized x-ms-* headers, sorted, lowercase
        canon_headers = "".join(
            f"{k.lower()}:{v}\n" for k, v in sorted(headers.items())
            if k.lower().startswith("x-ms-"))
        # canonicalized resource: /account/path plus sorted query params
        path = u.path or "/"
        # canonical resource = "/" + account + url-path. Against azurite-style
        # test endpoints the url path itself already starts with /account (the
        # emulator scopes urls by account), so the canonical string legitimately
        # names the account twice — once from this prefix, once inside `path`.
        # That matches what azurite canonicalizes server-side; do NOT "fix" it
        # by stripping the duplicate or signing breaks.
        resource = f"/{self.cfg.account}{path}"
        if u.query:
            params = sorted(p.split("=", 1) for p in u.query.split("&"))
            resource += "".join(
                f"\n{k}:{urllib.parse.unquote(v[0] if isinstance(v, list) else v)}"
                for k, *v in [(p[0], p[1] if len(p) > 1 else "")
                              for p in params])
        cl = str(content_length) if content_length else ""
        to_sign = "\n".join([
            method, "", "", cl, "", "", "", "", "",
            headers.get("If-None-Match", ""), "", "",
            canon_headers + resource])
        # shared-key-lite is simpler but shared key proper is what SDKs send;
        # the string-to-sign layout above is the Blob shared-key order:
        # VERB, Content-Encoding, Content-Language, Content-Length, MD5,
        # Content-Type, Date, If-Mod, If-Match, If-None-Match, If-Unmod,
        # Range, then canonicalized headers + resource
        sig = base64.b64encode(
            hmac.new(base64.b64decode(self.cfg.key), to_sign.encode(),
                     hashlib.sha256).digest()).decode()
        headers["Authorization"] = f"SharedKey {self.cfg.account}:{sig}"
        return headers

    def get(self, path, range=None, timeout=None):
        container, key = self._split(path)
        url = self._url(container, key)
        extra = {}
        if range is not None:
            extra["x-ms-range"] = f"bytes={range[0]}-{range[1] - 1}"
        headers = self._headers("GET", url, extra=extra)
        status, _h, data = _http_request(
            url, headers=headers,
            timeout=timeout if timeout is not None else self.cfg.timeout)
        if status not in (200, 206):
            _raise_http("GET", path, status)
        if range is not None and status == 200:
            return data[range[0]:range[1]]
        return data

    def get_size(self, path):
        container, key = self._split(path)
        url = self._url(container, key)
        status, h, _ = _http_request(url, method="HEAD",
                                     headers=self._headers("HEAD", url),
                                     timeout=self.cfg.timeout)
        if status != 200 or "content-length" not in h:
            _raise_http("HEAD", path, status)
        return int(h["content-length"])

    def put(self, path, data, if_none_match=False):
        container, key = self._split(path)
        url = self._url(container, key)
        extra = {"x-ms-blob-type": "BlockBlob"}
        if if_none_match:
            extra["If-None-Match"] = "*"
        headers = self._headers("PUT", url, content_length=len(data),
                                extra=extra)
        status, _h, _b = _http_request(url, method="PUT", headers=headers,
                                       body=data, timeout=self.cfg.timeout)
        if status in (409, 412):
            raise FileExistsError(f"PUT {path}: blob exists (HTTP {status})")
        if status not in (200, 201):
            raise DaftIOError(f"PUT {path}: HTTP {status}")

    def delete(self, path):
        container, key = self._split(path)
        url = self._url(container, key)
        status, _h, _b = _http_request(url, method="DELETE",
                                       headers=self._headers("DELETE", url),
                                       timeout=self.cfg.timeout)
        if status not in (200, 202, 204):
            raise DaftIOError(f"DELETE {path}: HTTP {status}")

    def ls(self, prefix):
        container, key = self._split(prefix)
        scheme = str(prefix).split("://", 1)[0]
        out: List[ObjectMeta] = []
        marker = None
        while True:
            q = ("restype=container&comp=list&prefix="
                 + urllib.parse.quote(key, safe=""))
            if marker:
                q += "&marker=" + urllib.parse.quote(marker, safe="")
            url = self._url(container, query=q)
            status, _h, data = _http_request(
                url, headers=self._headers("GET", url),
                timeout=self.cfg.timeout)
            if status == 404:
                raise NotFoundIOError(f"LIST {prefix}: HTTP 404")
            if status != 200:
                raise DaftIOError(f"LIST {prefix}: HTTP {status}")
            blobs, marker = _parse_azure_list(data)
            out.extend(ObjectMeta(f"{scheme}://{container}/{name}", size)
                       for name, size in blobs)
            if not marker:
                return out

    def glob(self, pattern):
        container, key = self._split(pattern)
        scheme = str(pattern).split("://", 1)[0]
        return _glob_via_ls(f"{scheme}://{container}", key, self.ls)


def _parse_azure_list(xml: bytes) -> Tuple[List[Tuple[str, Optional[int]]], Optional[str]]:
    import xml.etree.ElementTree as ET

    root = ET.fromstring(xml)
    blobs: List[Tuple[str, Optional[int]]] = []
    for b in root.iter("Blob"):
        name = b.find("Name")
        size = None
        props = b.find("Properties")
        if props is not None:
            cl = props.find("Content-Length")
            if cl is not None and cl.text:
                size = int(cl.text)
        if name is not None and name.text:
            blobs.append((name.text, size))
    nm = root.find("NextMarker")
    marker = nm.text if nm is not None and nm.text else None
    return blobs, marker


@dataclass
class HFConfig:
    """Hugging Face Hub settings (``HF_ENDPOINT``, ``HF_TOKEN``)."""

    endpoint_url: str = "https://huggingface.co"
    token: Optional[str] = None
    revision: str = "main"
    timeout: float = 30.0

    @staticmethod
    def from_env() -> "HFConfig":
        return HFConfig(
            endpoint_url=os.environ.get("HF_ENDPOINT",
                                        "https://huggingface.co"),
            token=os.environ.get("HF_TOKEN"),
        )


class HuggingFaceSource(ObjectSource):
    """hf:// paths resolved through the Hub's HTTP surface. Layout:
        hf://datasets/{repo_id}/{path}  (also hf://{user}/{model}/{path})
    get  -> {endpoint}/{repo}/resolve/{revision}/{path}  (302s to a CDN)
    ls   -> {endpoint}/api/{kind}/{repo_id}/tree/{revision}/{dir}?recursive=true
    """

    def __init__(self, cfg: Optional[HFConfig] = None):
        self.cfg = cfg or HFConfig.from_env()
        self._http = HttpSource(timeout=self.cfg.timeout)

    def _auth(self) -> Dict[str, str]:
        if self.cfg.token:
            return {"Authorization": f"Bearer {self.cfg.token}"}
        return {}

    def _split(self, path: str) -> Tuple[str, str, str]:
        """-> (api_kind, repo_id, inner_path)"""
        rest = str(path)[len("hf://"):]
        parts = rest.split("/")
        if parts[0] in ("datasets", "spaces"):
            kind, repo, inner = parts[0], "/".join(parts[1:3]), "/".join(parts[3:])
        else:  # models live at the url root
            kind, repo, inner = "models", "/".join(parts[0:2]), "/".join(parts[2:])
        if not repo or "/" not in repo:
            raise DaftValueError(f"hf path needs user/repo: {path}")
        return kind, repo, inner

    def _resolve_url(self, path: str) -> str:
        kind, repo, inner = self._split(path)
        prefix = "" if kind == "models" else f"{kind}/"
        return (f"{self.cfg.endpoint_url}/{prefix}{repo}/resolve/"
                f"{self.cfg.revision}/{urllib.parse.quote(inner)}")

    def get(self, path, range=None, timeout=None):
        url = self._resolve_url(path)
        headers = self._auth()
        if range is not None:
            headers["Range"] = f"bytes={range[0]}-{range[1] - 1}"
        status, _h, data = self._http._request(url, headers=headers,
                                               timeout=timeout)
        if status not in (200, 206):
            _raise_http("GET", path, status)
        if range is not None and status == 200:
            return data[range[0]:range[1]]
        return data

    def get_size(self, path):
        url = self._resolve_url(path)
        status, h, _ = self._http._request(url, method="HEAD",
                                           headers=self._auth())
        # the Hub reports the LFS object size in x-linked-size on redirects
        size = h.get("x-linked-size") or h.get("content-length")
        if status != 200 or not size:
            _raise_http("HEAD", path, status)
        return int(size)

    def ls(self, prefix):
        kind, repo, inner = self._split(prefix)
        url = (f"{self.cfg.endpoint_url}/api/{kind}/{repo}/tree/"
               f"{self.cfg.revision}/{urllib.parse.quote(inner)}"
               f"?recursive=true")
        status, _h, data = self._http._request(url, headers=self._auth())
        if status == 404:
            raise NotFoundIOError(f"LIST {prefix}: HTTP 404")
        if status != 200:
            raise DaftIOError(f"LIST {prefix}: HTTP {status}")
        import json as _json

        base = f"hf://{kind}/{repo}" if kind != "models" else f"hf://{repo}"
        out = []
        for entry in _json.loads(data):
            if entry.get("type") == "file":
                out.append(ObjectMeta(f"{base}/{entry['path']}",
                                      entry.get("size")))
        return out

    def glob(self, pattern):
        kind, repo, inner = self._split(pattern)
        base = f"hf://{kind}/{repo}" if kind != "models" else f"hf://{repo}"
        # the tree API wants a directory, not a partial-filename prefix:
        # trim the listing path back to its parent dir (recursive listing
        # covers everything below it)
        return _glob_via_ls(base, inner,
                            lambda p: self.ls(p.rsplit("/", 1)[0]))


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

@dataclass
class IOClient:
    """Scheme-routing facade with a connection budget (``max_connections``
    requests in flight at once, across threads) and the retry policy; every
    read counts ``bytes_read`` and every write ``bytes_written`` in
    ``IO_STATS``."""

    s3_config: Optional[S3Config] = None
    gcs_config: Optional[GCSConfig] = None
    azure_config: Optional[AzureConfig] = None
    hf_config: Optional[HFConfig] = None
    retry: RetryPolicy = field(default_factory=RetryPolicy)
    max_connections: int = 64

    def __post_init__(self):
        self._sem = threading.BoundedSemaphore(max(1, self.max_connections))
        self._sources: Dict[str, ObjectSource] = {}
        self._lock = threading.Lock()

    def source_for(self, path: str) -> ObjectSource:
        scheme = path.split("://", 1)[0] if "://" in path else "file"
        if scheme in ("http", "https"):
            scheme = "http"
        if scheme in ("abfs", "abfss"):
            scheme = "az"
        with self._lock:
            src = self._sources.get(scheme)
            if src is None:
                if scheme == "s3":
                    src = S3Source(self.s3_config)
                elif scheme == "gs":
                    src = GCSSource(self.gcs_config)
                elif scheme == "az":
                    src = AzureSource(self.azure_config)
                elif scheme == "hf":
                    src = HuggingFaceSource(self.hf_config)
                elif scheme == "http":
                    src = HttpSource()
                elif scheme == "file":
                    src = LocalSource()
                else:
                    raise DaftValueError(f"unsupported scheme {scheme}:// in {path}")
                self._sources[scheme] = src
        return src

    def get(self, path: str, range: Optional[Tuple[int, int]] = None,
            timeout: Optional[float] = None) -> bytes:
        from .. import faults

        src = self.source_for(path)

        def attempt() -> bytes:
            # fault site inside the retry loop: each ATTEMPT checks, so an
            # armed first_n plan exercises retry-then-heal deterministically
            faults.check("io.get")
            return src.get(path, range, timeout)

        with self._sem:
            data = self.retry.run(attempt)
        IO_STATS.bump(bytes_read=len(data))
        return data

    def get_size(self, path: str) -> int:
        src = self.source_for(path)
        with self._sem:
            return self.retry.run(lambda: src.get_size(path))

    def put(self, path: str, data: bytes, if_none_match: bool = False) -> None:
        """Write an object through the same budget/retry funnel as reads.
        A retried conditional put can observe its own first (timed-out but
        landed) attempt as FileExistsError — the standard conditional-write
        caveat; callers that need exactly-once embed a unique key instead."""
        src = self.source_for(path)
        with self._sem:
            self.retry.run(lambda: src.put(path, data, if_none_match))
        IO_STATS.bump(bytes_written=len(data))

    def delete(self, path: str) -> None:
        src = self.source_for(path)
        with self._sem:
            self.retry.run(lambda: src.delete(path))

    def exists(self, path: str) -> bool:
        """True/False only for genuine presence/absence. Auth failures and
        exhausted-retry 5xx propagate — an outage must never read as
        'object absent' (same discipline as Storage.list_names)."""
        try:
            self.get_size(path)
            return True
        except (NotFoundIOError, FileNotFoundError, NotADirectoryError):
            return False

    def ls(self, prefix: str) -> List[ObjectMeta]:
        src = self.source_for(prefix)
        with self._sem:
            return self.retry.run(lambda: src.ls(prefix))

    def glob(self, pattern: str) -> List[ObjectMeta]:
        src = self.source_for(pattern)
        with self._sem:
            return self.retry.run(lambda: src.glob(pattern))

    def open(self, path: str, size: Optional[int] = None) -> "ObjectFile":
        return ObjectFile(self, path, size)


class ObjectFile(io.RawIOBase):
    """Seekable read-only file over get_range — hands remote parquet to
    pyarrow without downloading whole objects (the footer and the selected
    row groups only).

    A small readahead coalesces the footer's many tiny reads. One reader
    holds one position and one buffer, so it is never shared across
    threads: each read of a file opens its own."""

    READAHEAD = 256 * 1024

    def __init__(self, client: IOClient, path: str, size: Optional[int] = None):
        super().__init__()
        self.client = client
        self.path = path
        self._size = size if size is not None else client.get_size(path)
        # small objects don't benefit from deep readahead — cap it so range
        # reads stay well under a full download
        self._readahead = min(self.READAHEAD, max(self._size // 16, 8 * 1024))
        self._pos = 0
        self._buf = b""
        self._buf_start = 0

    def readable(self):
        return True

    def seekable(self):
        return True

    def size(self):
        return self._size

    def seek(self, offset, whence=0):
        if whence == 0:
            self._pos = offset
        elif whence == 1:
            self._pos += offset
        else:
            self._pos = self._size + offset
        return self._pos

    def tell(self):
        return self._pos

    def read(self, n=-1):
        if n is None or n < 0:
            n = self._size - self._pos
        n = max(0, min(n, self._size - self._pos))
        if n == 0:
            return b""
        start, end = self._pos, self._pos + n
        bs, be = self._buf_start, self._buf_start + len(self._buf)
        if not (bs <= start and end <= be):
            fetch_end = min(self._size, max(end, start + self._readahead))
            self._buf = self.client.get(self.path, (start, fetch_end))
            self._buf_start = start
            bs, be = start, start + len(self._buf)
        out = self._buf[start - bs:end - bs]
        self._pos = end
        return out


_DEFAULT_CLIENT: Optional[IOClient] = None
_CLIENT_LOCK = threading.Lock()


def default_io_client() -> IOClient:
    """Process-wide client; per-store settings re-read from the environment
    when they change (tests point them at mock servers)."""
    global _DEFAULT_CLIENT
    with _CLIENT_LOCK:
        # compare the WHOLE config set: rotated credentials or a region
        # change must rebuild the client, not just an endpoint change
        s3 = S3Config.from_env()
        gcs = GCSConfig.from_env()
        az = AzureConfig.from_env()
        hf = HFConfig.from_env()
        c = _DEFAULT_CLIENT
        if (c is None or c.s3_config != s3 or c.gcs_config != gcs
                or c.azure_config != az or c.hf_config != hf):
            _DEFAULT_CLIENT = IOClient(s3_config=s3, gcs_config=gcs,
                                       azure_config=az, hf_config=hf)
        return _DEFAULT_CLIENT


class Storage:
    """Unified file ops over local paths AND object-store urls, so the
    tabular writers and the Delta/Iceberg commit protocols target file://
    and s3:// identically (the IOClient plays the role of a filesystem).
    put_if_absent is the atomic-commit primitive: O_EXCL locally,
    `If-None-Match: *` on object stores."""

    def __init__(self, client: Optional[IOClient] = None):
        self._client = client

    @property
    def client(self) -> IOClient:
        return self._client or default_io_client()

    @staticmethod
    def is_remote(path: str) -> bool:
        return is_remote_path(path)

    def join(self, base: str, *parts: str) -> str:
        if self.is_remote(base):
            return "/".join([str(base).rstrip("/")]
                            + [p.strip("/") for p in parts])
        return os.path.join(str(base), *parts)

    def makedirs(self, path: str) -> None:
        if not self.is_remote(path):
            os.makedirs(self._local(path), exist_ok=True)

    @staticmethod
    def _local(path: str) -> str:
        p = str(path)
        return p[len("file://"):] if p.startswith("file://") else p

    def put(self, path: str, data: bytes) -> None:
        if self.is_remote(path):
            self.client.put(path, data)
        else:
            LocalSource().put(path, data)

    def put_if_absent(self, path: str, data: bytes) -> None:
        if self.is_remote(path):
            self.client.put(path, data, if_none_match=True)
        else:
            LocalSource().put(path, data, if_none_match=True)

    def get(self, path: str) -> bytes:
        if self.is_remote(path):
            return self.client.get(path)
        with open(self._local(path), "rb") as f:
            return f.read()

    def exists(self, path: str) -> bool:
        if self.is_remote(path):
            return self.client.exists(path)
        return os.path.exists(self._local(path))

    def size(self, path: str) -> int:
        if self.is_remote(path):
            return self.client.get_size(path)
        return os.path.getsize(self._local(path))

    def list_names(self, dir_path: str) -> List[str]:
        """Immediate child names under a directory-like path (os.listdir
        semantics; remote listings are recursive, so grandchildren are
        collapsed out)."""
        if not self.is_remote(dir_path):
            p = self._local(dir_path)
            return os.listdir(p) if os.path.isdir(p) else []
        prefix = str(dir_path).rstrip("/") + "/"
        names = set()
        try:
            metas = self.client.ls(prefix)
        except NotFoundIOError:
            return []  # the container/prefix genuinely does not exist
        for m in metas:
            rest = m.path[len(prefix):]
            if rest:
                names.add(rest.split("/", 1)[0])
        return sorted(names)

    def open_input(self, path: str, size: Optional[int] = None):
        """Seekable binary reader: ObjectFile for remote (range reads), a
        plain file handle locally — both satisfy pyarrow's file protocol."""
        if self.is_remote(path):
            return self.client.open(path, size)
        return open(self._local(path), "rb")


STORAGE = Storage()
