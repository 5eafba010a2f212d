"""The lake formats and SQL scans (the port's copy of
daft_tpu/io/catalogs.py). No client library is needed: each format's
metadata is parsed here, and its data files become parquet ScanTasks, so
pushdowns and pruning ride the normal scan layer.

- ``read_deltalake_scan``: the ``_delta_log`` add/remove actions fold into
  the live file set (seeded from a checkpoint where ``_last_checkpoint``
  names one), with each file's size and partition values.
- ``read_iceberg_scan``: manifest list, manifests, live data files (v1
  inline manifests and v2 lists), the avro decoded by io/avro.py, paths
  remapped when a table moved; copy-on-write only (merge-on-read delete
  files raise).
- ``read_hudi_scan``: the ``.hoodie`` commit timeline, the latest file
  slice of each file group; copy-on-write only.
- ``write_iceberg_table`` and ``write_deltalake_table``: parquet data files,
  then one atomic commit of the next version through put-if-absent (O_EXCL
  locally, ``If-None-Match: *`` on object stores), in append, overwrite or
  error mode. A concurrent writer that takes the version first makes this
  one raise ``FileExistsError``, with nothing of it committed.
- ``read_sql_arrow``: a query through a DB-API connection, a connection
  factory, or a sqlite path, read in one shot.
- ``read_lance_scan`` and ``write_lance_table`` need the optional ``lance``
  package and raise an ImportError naming it where it is missing.

Every byte goes through ``STORAGE`` (io/object_store.py), so ``s3://`` and
the other object-store uris read and write like local paths.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, List, Optional, Union

import pyarrow as pa

from ..datatypes import DataType
from ..errors import DaftNotFoundError
from ..schema import Field, Schema
from .object_store import STORAGE
from .writer import write_parquet_any
from .scan import FileFormat, Pushdowns, ScanTask


def _schema_from_parquet(path: str) -> Schema:
    """Engine Schema from a parquet footer (shared by the catalog readers).
    Remote paths read the footer through ranged gets, not a full download."""
    import pyarrow.parquet as papq

    src = STORAGE.open_input(path) if STORAGE.is_remote(path) else path
    arrow_schema = papq.read_schema(src)
    return Schema([Field(n, DataType.from_arrow(arrow_schema.field(n).type))
                   for n in arrow_schema.names])


def _delta_live_files(table_uri: str) -> List[dict]:
    """Fold the Delta transaction log into the set of live data files.

    Honors checkpoints: when _delta_log/_last_checkpoint exists, the add/remove
    state is seeded from the checkpoint parquet (single or multi-part) and only
    commits AFTER the checkpoint version are replayed — required for tables
    whose older JSON commits were vacuumed by log retention.

    All log IO goes through Storage, so s3:// table uris read exactly like
    local ones."""
    log_dir = STORAGE.join(table_uri, "_delta_log")
    log_names = set(STORAGE.list_names(log_dir))
    if not log_names:
        raise DaftNotFoundError(f"not a Delta table (no _delta_log): {table_uri}")
    live: dict = {}
    start_after = -1
    if "_last_checkpoint" in log_names:
        lc = json.loads(STORAGE.get(STORAGE.join(log_dir, "_last_checkpoint")))
        version = int(lc["version"])
        parts = int(lc.get("parts", 0) or 0)
        if parts:
            cp_names = [f"{version:020d}.checkpoint.{i:010d}.{parts:010d}.parquet"
                        for i in range(1, parts + 1)]
        else:
            cp_names = [f"{version:020d}.checkpoint.parquet"]
        missing = [n for n in cp_names if n not in log_names]
        if missing:
            raise FileNotFoundError(
                f"Delta checkpoint v{version} referenced by _last_checkpoint is "
                f"missing files: {missing}")
        import pyarrow.parquet as papq

        for cp in cp_names:
            t = papq.read_table(STORAGE.open_input(STORAGE.join(log_dir, cp)),
                                columns=["add", "remove"])
            for row in t.to_pylist():
                a, r = row.get("add"), row.get("remove")
                if a and a.get("path"):
                    live[a["path"]] = a
                elif r and r.get("path"):
                    live.pop(r["path"], None)
        start_after = version
    commits = sorted(f for f in log_names if f.endswith(".json"))
    commits = [c for c in commits if int(c.split(".")[0]) > start_after]
    if not commits and start_after < 0:
        raise DaftNotFoundError(f"Delta table has no commits: {table_uri}")
    for name in commits:
        for line in STORAGE.get(STORAGE.join(log_dir, name)).decode().splitlines():
            line = line.strip()
            if not line:
                continue
            action = json.loads(line)
            if "add" in action:
                a = action["add"]
                live[a["path"]] = a
            elif "remove" in action:
                live.pop(action["remove"]["path"], None)
    return [dict(v, path=STORAGE.join(table_uri, k)) for k, v in live.items()]


def read_deltalake_scan(table_uri: str):
    """-> (Schema, [ScanTask]) for a Delta Lake table."""
    import pyarrow.parquet as papq

    files = _delta_live_files(table_uri)
    if not files:
        raise ValueError(f"Delta table {table_uri} has no live files")
    fields = list(_schema_from_parquet(files[0]["path"]))
    # hive-style partition columns live in the log's partitionValues, not the files
    part_cols: List[str] = []
    for f in files:
        for k in (f.get("partitionValues") or {}):
            if k not in part_cols:
                part_cols.append(k)
    for k in part_cols:
        fields.append(Field(k, DataType.string()))
    schema = Schema(fields)
    tasks = []
    for f in files:
        tasks.append(ScanTask(
            f["path"], FileFormat.PARQUET, schema, Pushdowns(),
            size_bytes=f.get("size"),
            partition_values={k: (f.get("partitionValues") or {}).get(k)
                              for k in part_cols} or None,
        ))
    return schema, tasks


# ---------------------------------------------------------------------------
# Iceberg (native manifest replay via io/avro.py)
# ---------------------------------------------------------------------------

_ICEBERG_PRIMITIVES = {
    "boolean": "bool", "int": "int32", "long": "int64", "float": "float32",
    "double": "float64", "string": "string", "date": "date",
    "binary": "binary", "uuid": "string",
}


def _metadata_version_of(name: str) -> int:
    """Version number of a vN.metadata.json / N-uuid.metadata.json name
    (shared by the metadata resolver and the writer's next-version pick)."""
    stem = name.split(".metadata.json")[0].lstrip("v")
    for tok in (stem, stem.split("-")[0]):
        try:
            return int(tok)
        except ValueError:
            continue
    return -1


def _iceberg_metadata_path(table_uri: str) -> str:
    """Resolve the current metadata json (hadoop-catalog layout): honor
    version-hint.text, else the highest-versioned *.metadata.json. Works
    over local paths and object-store uris alike (Storage)."""
    mdir = STORAGE.join(table_uri, "metadata")
    names = STORAGE.list_names(mdir)
    if not names:
        raise DaftNotFoundError(f"not an Iceberg table (no metadata/): {table_uri}")
    if "version-hint.text" in names:
        v = STORAGE.get(STORAGE.join(mdir, "version-hint.text")).decode().strip()
        for cand in (f"v{v}.metadata.json", f"{v}.metadata.json"):
            if cand in names:
                return STORAGE.join(mdir, cand)
    metas = [f for f in names if f.endswith(".metadata.json")]
    if not metas:
        raise DaftNotFoundError(f"Iceberg table has no metadata json: {table_uri}")
    return STORAGE.join(mdir, max(metas, key=_metadata_version_of))


def _iceberg_resolve(table_uri: str, uri: str) -> str:
    """Manifest/data paths are absolute URIs written at table-creation time;
    resolve them against the CURRENT table location so vendored/moved
    fixtures still read."""
    p = uri
    if p.startswith("file://"):
        p = p[len("file://"):]
    # in-place tables (the common case): manifest paths already live under
    # the current location — skip the per-file existence probe, which on
    # object stores would cost one HEAD round-trip per manifest/data file
    if p.startswith(str(table_uri).rstrip("/") + "/"):
        return p
    if STORAGE.is_remote(p):
        # external data paths are spec-legal (write.data.path / add_files
        # imports): probe with ONE non-retried HEAD — honoring them without
        # paying a backoff loop per file against an unreachable store. A
        # store root that times out is remembered DEAD for this process so a
        # relocated table with thousands of files pays one timeout, not one
        # per file.
        root = "/".join(p.split("/", 3)[:3])
        condemned_at = _DEAD_EXTERNAL_ROOTS.get(root)
        if condemned_at is not None and \
                time.monotonic() - condemned_at > _DEAD_ROOT_TTL_S:
            # a blip must not remap paths for the process lifetime: after the
            # TTL the next file re-probes the root and can resurrect it
            # (pop: two threads may expire the same root concurrently)
            _DEAD_EXTERNAL_ROOTS.pop(root, None)
            condemned_at = None
        if condemned_at is None:
            from .object_store import TransientIOError

            try:
                STORAGE.client.source_for(p).get_size(p)
                return p
            except TransientIOError as e:
                # only CONNECTION-level failures (timeout, refused, reset —
                # surfaced as an OSError cause) condemn the root; a 429/5xx
                # is the store talking to us, and must not silently remap
                # 999 remaining files after one throttle
                if isinstance(e.__cause__, OSError):
                    _DEAD_EXTERNAL_ROOTS[root] = time.monotonic()
            except Exception:
                pass  # absent (404 etc.): remap this file, keep probing root
    elif STORAGE.exists(p):
        return p
    # remap by the stable tail: .../metadata/<x> or .../data/<x>
    for anchor in ("/metadata/", "/data/"):
        if anchor in p:
            # rsplit: the table's ORIGINAL location may itself contain
            # /data/ or /metadata/ segments
            return STORAGE.join(table_uri, anchor.strip("/"),
                                p.rsplit(anchor, 1)[1])
    return STORAGE.join(table_uri, p.rsplit("/", 1)[-1])


# store root -> monotonic time it was condemned; entries expire after
# _DEAD_ROOT_TTL_S so one network blip cannot permanently redirect every
# subsequent external path to the table location
_DEAD_EXTERNAL_ROOTS: dict = {}
_DEAD_ROOT_TTL_S = 60.0


def _read_avro_any(path: str):
    """Avro OCF over local paths AND object-store uris (Storage.get
    handles both)."""
    from .avro import read_avro_bytes

    return read_avro_bytes(STORAGE.get(path))


def read_iceberg_scan(table_uri: str, snapshot_id: Optional[int] = None):
    """-> (Schema, [ScanTask]) for an Iceberg v1/v2 table by replaying
    manifest list -> manifests -> live data files (the avro decoded by
    io/avro.py). Merge-on-read delete files are rejected (copy-on-write
    tables only)."""
    meta_path = _iceberg_metadata_path(table_uri)
    meta = json.loads(STORAGE.get(meta_path))
    snaps = meta.get("snapshots") or []
    sid = snapshot_id if snapshot_id is not None else meta.get("current-snapshot-id")
    snap = next((s for s in snaps if s.get("snapshot-id") == sid), None)
    if snap is None:
        if snapshot_id is not None:
            raise ValueError(f"Iceberg snapshot {snapshot_id} not found in "
                             f"{table_uri} (has {[s.get('snapshot-id') for s in snaps]})")
        if sid is not None and sid != -1 and snaps:
            raise ValueError(f"Iceberg current-snapshot-id {sid} missing from "
                             f"the snapshot log of {table_uri}")
    data_files: List[dict] = []
    if snap is not None:
        if snap.get("manifest-list"):
            _, mlist = _read_avro_any(_iceberg_resolve(table_uri, snap["manifest-list"]))
            manifest_paths = [m["manifest_path"] for m in mlist]
        else:  # v1 inline manifests
            manifest_paths = list(snap.get("manifests") or [])
        for mp in manifest_paths:
            _, entries = _read_avro_any(_iceberg_resolve(table_uri, mp))
            for e in entries:
                if e.get("status") == 2:  # deleted
                    continue
                df = e.get("data_file") or {}
                content = df.get("content") or 0
                if content != 0:
                    raise ValueError(
                        "Iceberg merge-on-read delete files are not supported "
                        "(copy-on-write tables only)")
                if (df.get("file_format") or "PARQUET").upper() != "PARQUET":
                    raise ValueError(f"unsupported Iceberg file format "
                                     f"{df.get('file_format')!r}")
                data_files.append(df)
    # schema: prefer a real data file footer (exact physical types); fall
    # back to the metadata schema for empty tables
    if data_files:
        first = _iceberg_resolve(table_uri, data_files[0]["file_path"])
        fields = list(_schema_from_parquet(first))
    else:
        schemas = meta.get("schemas")
        if schemas:
            cur = meta.get("current-schema-id", 0)
            sch = next((s for s in schemas if s.get("schema-id") == cur), schemas[-1])
        else:
            sch = meta.get("schema") or {"fields": []}
        fields = []
        for fld in sch.get("fields", []):
            t = fld.get("type")
            if not isinstance(t, str):
                raise ValueError("nested Iceberg schemas require data files "
                                 "to infer from (empty table)")
            if t.startswith("timestamp"):
                dt = DataType.timestamp("us")
            elif t.startswith("decimal"):
                dt = DataType.float64()
            elif t.startswith("fixed"):
                dt = DataType.binary()
            else:
                key = _ICEBERG_PRIMITIVES.get(t)
                if key is None:
                    raise ValueError(f"unsupported Iceberg type {t!r}")
                dt = getattr(DataType, key)()
            fields.append(Field(fld["name"], dt))
    schema = Schema(fields)
    tasks = [ScanTask(_iceberg_resolve(table_uri, df["file_path"]),
                      FileFormat.PARQUET, schema, Pushdowns(),
                      size_bytes=df.get("file_size_in_bytes"),
                      num_rows=df.get("record_count"))
             for df in data_files]
    return schema, tasks


# ---------------------------------------------------------------------------
# Hudi copy-on-write (native timeline replay)
# ---------------------------------------------------------------------------

def read_hudi_scan(table_uri: str):
    """-> (Schema, [ScanTask]) for a local Hudi copy-on-write table: replay
    the .hoodie commit timeline and keep the LATEST file slice per file
    group. Merge-on-read tables (log files) are rejected."""
    hoodie = os.path.join(table_uri, ".hoodie")
    if not os.path.isdir(hoodie):
        raise DaftNotFoundError(f"not a Hudi table (no .hoodie): {table_uri}")
    timeline = os.listdir(hoodie)
    if any(f.endswith(".deltacommit") or f.endswith(".deltacommit.requested")
           or f.endswith(".deltacommit.inflight") for f in timeline):
        raise ValueError("Hudi merge-on-read tables are not supported "
                         "(deltacommits present; copy-on-write only)")
    commits = sorted(f for f in timeline
                     if f.endswith(".commit") or f.endswith(".replacecommit"))
    if not commits:
        raise DaftNotFoundError(f"Hudi table has no completed commits: {table_uri}")
    # latest slice per file group: walk data files, parse hudi names
    # <fileId>_<writeToken>_<instantTime>.parquet
    latest: dict = {}
    replaced: set = set()
    for name in commits:
        with open(os.path.join(hoodie, name)) as f:
            try:
                commit = json.load(f)
            except json.JSONDecodeError:
                continue
        for pstats in (commit.get("partitionToWriteStats") or {}).values():
            for ws in pstats:
                path = ws.get("path")
                fid = ws.get("fileId")
                if path:
                    latest[fid or path] = path
        for part, groups in (commit.get("partitionToReplaceFileIds") or {}).items():
            for fid in groups:
                replaced.add(fid)
    files = [os.path.join(table_uri, p) for fid, p in latest.items()
             if fid not in replaced]
    files = [p for p in files if os.path.exists(p)]
    if not files:
        raise ValueError(f"Hudi table {table_uri} has no live files")
    schema = _schema_from_parquet(files[0])
    tasks = [ScanTask(p, FileFormat.PARQUET, schema, Pushdowns()) for p in files]
    return schema, tasks


# ---------------------------------------------------------------------------
# Iceberg writer (native manifests via io/avro.py)
# ---------------------------------------------------------------------------

_ARROW_TO_ICEBERG = [
    (pa.types.is_int64, "long"), (pa.types.is_int32, "int"),
    (pa.types.is_float64, "double"), (pa.types.is_float32, "float"),
    (pa.types.is_boolean, "boolean"), (pa.types.is_date, "date"),
    (pa.types.is_binary, "binary"), (pa.types.is_large_binary, "binary"),
    (pa.types.is_string, "string"), (pa.types.is_large_string, "string"),
]

_MANIFEST_ENTRY_SCHEMA = {
    "type": "record", "name": "manifest_entry", "fields": [
        {"name": "status", "type": "int"},
        {"name": "snapshot_id", "type": ["null", "long"]},
        {"name": "data_file", "type": {"type": "record", "name": "r2", "fields": [
            {"name": "content", "type": "int"},
            {"name": "file_path", "type": "string"},
            {"name": "file_format", "type": "string"},
            {"name": "partition", "type": {"type": "record", "name": "r102",
                                           "fields": []}},
            {"name": "record_count", "type": "long"},
            {"name": "file_size_in_bytes", "type": "long"},
        ]}},
    ]}

_MANIFEST_LIST_SCHEMA = {
    "type": "record", "name": "manifest_file", "fields": [
        {"name": "manifest_path", "type": "string"},
        {"name": "manifest_length", "type": "long"},
        {"name": "partition_spec_id", "type": "int"},
        {"name": "content", "type": "int"},
        {"name": "added_snapshot_id", "type": "long"},
    ]}


def _iceberg_type(t: pa.DataType) -> str:
    if pa.types.is_timestamp(t):
        return "timestamp"
    for pred, name in _ARROW_TO_ICEBERG:
        if pred(t):
            return name
    raise ValueError(f"no Iceberg type for arrow {t}")


def write_iceberg_table(table_uri: str, arrow_tables: List[pa.Table],
                        mode: str = "append") -> List[str]:
    """Native Iceberg v2 commit: data parquet files, a manifest for the new
    files, a manifest list (append keeps prior manifests), and a new
    metadata json published put-if-absent (O_EXCL) with version-hint update —
    the hadoop-catalog commit protocol. mode: append | overwrite | error.
    The manifests are encoded by io/avro.py."""
    import time as _time
    import uuid as _uuid

    from .avro import encode_avro_bytes

    if mode not in ("append", "overwrite", "error"):
        raise ValueError(f"invalid mode {mode!r}")
    if not arrow_tables:
        raise ValueError("write_iceberg needs at least one partition")
    mdir = STORAGE.join(table_uri, "metadata")
    ddir = STORAGE.join(table_uri, "data")
    mdir_names = STORAGE.list_names(mdir)
    exists = any(f.endswith(".metadata.json") for f in mdir_names)
    if exists and mode == "error":
        raise FileExistsError(f"Iceberg table already exists: {table_uri}")
    STORAGE.makedirs(mdir)
    STORAGE.makedirs(ddir)

    prev_meta = None
    prev_version = 0
    prior_manifests: List[dict] = []
    if exists:
        prev_meta = json.loads(STORAGE.get(_iceberg_metadata_path(table_uri)))
        prev_version = max(
            (v for v in (_metadata_version_of(n) for n in mdir_names
                         if n.endswith(".metadata.json")) if v >= 0),
            default=0)
        if mode == "append":
            sid = prev_meta.get("current-snapshot-id")
            snap = next((s for s in (prev_meta.get("snapshots") or [])
                         if s.get("snapshot-id") == sid), None)
            if snap is not None and snap.get("manifest-list"):
                _, raw = _read_avro_any(
                    _iceberg_resolve(table_uri, snap["manifest-list"]))
                # v1 manifest_file records predate the 'content' field (and
                # may omit others): normalize so re-encoding under the v2
                # schema never sees None ints
                prior_manifests = [{
                    "manifest_path": r["manifest_path"],
                    "manifest_length": r.get("manifest_length") or 0,
                    "partition_spec_id": r.get("partition_spec_id") or 0,
                    "content": r.get("content") or 0,
                    "added_snapshot_id": r.get("added_snapshot_id") or 0,
                } for r in raw]
            elif snap is not None and snap.get("manifests"):
                # v1 inline manifest paths: lift into manifest_file records
                # so the appended table's view keeps the existing data
                for mp in snap["manifests"]:
                    resolved = _iceberg_resolve(table_uri, mp)
                    prior_manifests.append({
                        "manifest_path": mp,
                        "manifest_length": STORAGE.size(resolved),
                        "partition_spec_id": 0, "content": 0,
                        "added_snapshot_id": sid or 0})

    # random 63-bit id (the spec's convention): same-millisecond commits and
    # concurrent writers must never collide on snap-<id>.avro
    snapshot_id = int.from_bytes(os.urandom(8), "big") >> 1
    commit_ts = int(_time.time() * 1000)
    added: List[str] = []
    entries: List[dict] = []
    remote = STORAGE.is_remote(table_uri)
    # written URIs carry the table's real scheme; local keeps the file://
    # prefix the resolver strips (spec: absolute URIs in manifests)
    uri_base = str(table_uri).rstrip("/") if remote else f"file://{table_uri}"
    for t in arrow_tables:
        if t.num_rows == 0:
            continue
        rel = f"data/{_uuid.uuid4()}.parquet"
        full = STORAGE.join(table_uri, rel)
        size = write_parquet_any(full, t)
        added.append(full)
        entries.append({"status": 1, "snapshot_id": snapshot_id,
                        "data_file": {"content": 0,
                                      "file_path": f"{uri_base}/{rel}",
                                      "file_format": "PARQUET", "partition": {},
                                      "record_count": t.num_rows,
                                      "file_size_in_bytes": size}})
    manifest_rel = f"metadata/{_uuid.uuid4()}-m0.avro"
    manifest_bytes = encode_avro_bytes(_MANIFEST_ENTRY_SCHEMA, entries)
    STORAGE.put(STORAGE.join(table_uri, manifest_rel), manifest_bytes)
    mlist_records = list(prior_manifests) if mode == "append" else []
    mlist_records.append({
        "manifest_path": f"{uri_base}/{manifest_rel}",
        "manifest_length": len(manifest_bytes),
        "partition_spec_id": 0, "content": 0,
        "added_snapshot_id": snapshot_id})
    mlist_rel = f"metadata/snap-{snapshot_id}.avro"
    STORAGE.put(STORAGE.join(table_uri, mlist_rel),
                encode_avro_bytes(_MANIFEST_LIST_SCHEMA, mlist_records))

    schema_src = next((t for t in arrow_tables if t.num_rows), arrow_tables[0])
    fields = [{"id": i + 1, "name": f.name, "type": _iceberg_type(f.type),
               "required": False} for i, f in enumerate(schema_src.schema)]
    version = prev_version + 1
    meta = {
        "format-version": 2,
        "table-uuid": (prev_meta or {}).get("table-uuid", str(_uuid.uuid4())),
        "location": table_uri,
        "current-snapshot-id": snapshot_id,
        "snapshots": ((prev_meta or {}).get("snapshots") or []) + [{
            "snapshot-id": snapshot_id,
            "timestamp-ms": commit_ts,
            "manifest-list": f"{uri_base}/{mlist_rel}"}],
        "schemas": [{"schema-id": 0, "type": "struct", "fields": fields}],
        "current-schema-id": 0,
        "partition-specs": [{"spec-id": 0, "fields": []}],
    }
    meta_path = STORAGE.join(mdir, f"v{version}.metadata.json")
    # put-if-absent commit: a concurrent writer racing to the same version
    # loses (O_EXCL locally, conditional put on object stores)
    STORAGE.put_if_absent(meta_path, json.dumps(meta).encode())
    STORAGE.put(STORAGE.join(mdir, "version-hint.text"), str(version).encode())
    return added


# ---------------------------------------------------------------------------
# Delta Lake writer (native transactional commit)
# ---------------------------------------------------------------------------

_ARROW_TO_DELTA = [
    (pa.types.is_int64, "long"), (pa.types.is_int32, "integer"),
    (pa.types.is_int16, "short"), (pa.types.is_int8, "byte"),
    (pa.types.is_float64, "double"), (pa.types.is_float32, "float"),
    (pa.types.is_boolean, "boolean"), (pa.types.is_date, "date"),
    (pa.types.is_binary, "binary"), (pa.types.is_large_binary, "binary"),
    (pa.types.is_string, "string"), (pa.types.is_large_string, "string"),
]


def _delta_type(t: pa.DataType) -> str:
    if pa.types.is_timestamp(t):
        return "timestamp"
    if pa.types.is_decimal(t):
        return f"decimal({t.precision},{t.scale})"
    for pred, name in _ARROW_TO_DELTA:
        if pred(t):
            return name
    raise ValueError(f"no Delta Lake type for arrow {t}")


def _delta_schema_string(arrow_schema: pa.Schema) -> str:
    fields = [{"name": f.name, "type": _delta_type(f.type),
               "nullable": True, "metadata": {}} for f in arrow_schema]
    return json.dumps({"type": "struct", "fields": fields})


def write_deltalake_table(table_uri: str, arrow_tables: List[pa.Table],
                          mode: str = "append") -> List[str]:
    """Transactional Delta Lake write: data files + an atomic JSON commit.

    The commit uses the Delta protocol's put-if-absent contract on the next
    version file (O_EXCL locally, `If-None-Match: *` on object stores — a
    concurrent writer loses and raises). Works against local paths and
    s3:// uris alike; all
    bytes ride Storage/IOClient. mode: append | overwrite | error. Returns
    the added file paths."""
    import time as _time
    import uuid as _uuid

    if mode not in ("append", "overwrite", "error"):
        raise ValueError(f"invalid mode {mode!r}")
    if not arrow_tables:
        raise ValueError("write_deltalake needs at least one (possibly "
                         "empty) partition to derive the table schema")
    log_dir = STORAGE.join(table_uri, "_delta_log")
    log_names = STORAGE.list_names(log_dir)
    versions: List[int] = [int(f.split(".")[0]) for f in log_names
                           if f.endswith(".json")]
    # a checkpointed table whose older JSON commits were vacuumed is
    # still an existing table: the checkpoint carries its version
    if "_last_checkpoint" in log_names:
        lc = json.loads(STORAGE.get(STORAGE.join(log_dir, "_last_checkpoint")))
        versions.append(int(lc["version"]))
    exists = bool(versions)
    if exists and mode == "error":
        raise FileExistsError(f"Delta table already exists: {table_uri}")
    STORAGE.makedirs(log_dir)
    schema_src = next((t for t in arrow_tables if t.num_rows), arrow_tables[0])
    now_ms = int(_time.time() * 1000)
    actions: List[dict] = []
    version = 0
    if exists:
        version = max(versions) + 1
        if mode == "overwrite":
            base = str(table_uri).rstrip("/") + "/"
            for f in _delta_live_files(table_uri):
                p = f["path"]
                rel = (p[len(base):] if str(p).startswith(base)
                       else os.path.relpath(p, table_uri))
                actions.append({"remove": {
                    "path": rel, "deletionTimestamp": now_ms,
                    "dataChange": True}})
    else:
        actions.append({"protocol": {"minReaderVersion": 1,
                                     "minWriterVersion": 2}})
        actions.append({"metaData": {
            "id": str(_uuid.uuid4()),
            "format": {"provider": "parquet", "options": {}},
            "schemaString": _delta_schema_string(schema_src.schema),
            "partitionColumns": [],
            "configuration": {},
            "createdTime": now_ms,
        }})
    added = []
    for t in arrow_tables:
        if t.num_rows == 0:
            continue
        rel = f"part-{len(added):05d}-{_uuid.uuid4()}.parquet"
        full = STORAGE.join(table_uri, rel)
        size = write_parquet_any(full, t)
        actions.append({"add": {
            "path": rel, "partitionValues": {},
            "size": size, "modificationTime": now_ms,
            "dataChange": True,
        }})
        added.append(full)
    actions.append({"commitInfo": {"timestamp": now_ms,
                                   "operation": "WRITE",
                                   "operationParameters": {"mode": mode.upper()}}})
    commit_path = STORAGE.join(log_dir, f"{version:020d}.json")
    payload = "\n".join(json.dumps(a) for a in actions) + "\n"
    STORAGE.put_if_absent(commit_path, payload.encode())
    return added


def read_sql_arrow(sql: str, conn: Union[str, Callable[[], Any]],
                   params: Optional[tuple] = None) -> pa.Table:
    """Run `sql` through a DB-API connection and return an arrow table.

    `conn` is a sqlite URL/path ("sqlite:///path/db.sqlite" or a .db path) or
    a zero-arg callable returning a DB-API connection (a connection
    factory), or a live DB-API connection, which is borrowed, not closed."""
    close_after = False
    if hasattr(conn, "cursor"):  # a live DB-API connection: borrow, don't close
        connection = conn
    elif callable(conn):
        connection = conn()
        close_after = True
    else:
        import sqlite3

        path = conn
        if path.startswith("sqlite://"):
            path = path[len("sqlite://"):]
            while path.startswith("/") and not os.path.exists(path) and os.path.exists(path.lstrip("/")):
                path = path.lstrip("/")
        connection = sqlite3.connect(path)
        close_after = True
    try:
        cur = connection.cursor()
        cur.execute(sql, params or ())
        names = [d[0] for d in cur.description]
        descr = list(cur.description)
        rows = cur.fetchall()
    finally:
        if close_after:
            connection.close()
    cols = {n: [r[i] for r in rows] for i, n in enumerate(names)}
    if rows:
        return pa.table(cols)
    # zero rows: recover column types from the DB-API description for drivers
    # that expose type codes (psycopg, mysql connectors, ...). sqlite3 never
    # fills description[1:] (only the name is set), so empty sqlite results
    # are unavoidably null-typed — documented limitation.
    return pa.table({d[0]: pa.array([], _dbapi_arrow_type(d)) for d in descr})


# longest-match-first: DATETIME/TIMESTAMP must win over the DATE substring
_SQL_TYPENAME_TO_ARROW = [
    ("DATETIME", pa.timestamp("us")), ("TIMESTAMP", pa.timestamp("us")),
    ("SMALLINT", pa.int64()), ("TINYINT", pa.int64()), ("BIGINT", pa.int64()),
    ("INTEGER", pa.int64()), ("INT", pa.int64()),
    ("VARBINARY", pa.binary()), ("BINARY", pa.binary()), ("BLOB", pa.binary()),
    ("VARCHAR", pa.string()), ("CHAR", pa.string()), ("TEXT", pa.string()),
    ("CLOB", pa.string()), ("STRING", pa.string()),
    ("DOUBLE", pa.float64()), ("FLOAT", pa.float64()), ("REAL", pa.float64()),
    ("NUMERIC", pa.float64()), ("DECIMAL", pa.float64()),
    ("BOOLEAN", pa.bool_()), ("BOOL", pa.bool_()),
    ("DATE", pa.date32()),
]


def _dbapi_arrow_type(descr_entry) -> pa.DataType:
    """Best-effort arrow type from a DB-API cursor.description entry's type
    code. Returns null for drivers that report no code (sqlite3)."""
    code = descr_entry[1] if len(descr_entry) > 1 else None
    if code is None:
        return pa.null()
    name = str(code).upper()
    for decl, at in _SQL_TYPENAME_TO_ARROW:
        if decl in name:
            return at
    return pa.null()


# ---------------------------------------------------------------------------
# Lance, through the optional `lance` package (the data format is lance's own)
# ---------------------------------------------------------------------------

def _import_lance():
    try:
        import lance
    except ImportError as e:
        raise ImportError(
            "read_lance/write_lance require the optional `lance` package "
            "(the reference ships it as the getdaft[lance] extra); it is not "
            "installed in this environment") from e
    return lance


def read_lance_scan(url: str, storage_options=None):
    """DataFrame over a LanceDB dataset: one FactoryScanTask per lance
    fragment, batches pulled through the fragment reader."""
    lance = _import_lance()

    from ..schema import Schema
    from .pyscan import FactoryScanTask, ScanOperator, from_scan_operator

    ds = lance.dataset(url, storage_options=storage_options)
    schema = Schema.from_arrow(ds.schema)

    class _LanceScanOperator(ScanOperator):
        def display_name(self):
            return f"LanceScanOperator({url})"

        def schema(self):
            return schema

        def can_absorb_select(self):
            return True  # fragment.to_batches honors a column projection

        def to_scan_tasks(self, pushdowns):
            for frag in ds.get_fragments():
                def factory(pd, _frag=frag):
                    cols = pd.columns if pd.columns is not None else None
                    return _frag.to_batches(columns=cols)

                yield FactoryScanTask(
                    factory, schema, pushdowns,
                    label=f"{url}#fragment-{frag.fragment_id}",
                    absorbs=("columns",))

    return from_scan_operator(_LanceScanOperator())


def write_lance_table(table_uri: str, arrow_tables, mode: str = "append"):
    """Write arrow tables as a lance dataset (`lance.write_dataset`).
    mode: append | overwrite | error."""
    import pyarrow as pa

    lance = _import_lance()
    if mode not in ("append", "overwrite", "error"):
        raise ValueError(f"unknown write_lance mode {mode!r}")
    tbl = pa.concat_tables([t for t in arrow_tables if t.num_rows]) \
        if any(t.num_rows for t in arrow_tables) else arrow_tables[0]
    import os
    exists = os.path.exists(table_uri)
    if mode == "error" and exists:
        raise FileExistsError(f"lance dataset already exists at {table_uri!r}")
    # lance rejects append when no dataset exists yet; first write creates
    lance_mode = {"append": "append" if exists else "create",
                  "overwrite": "overwrite", "error": "create"}[mode]
    ds = lance.write_dataset(tbl, table_uri, mode=lance_mode)
    paths = []
    for frag in ds.get_fragments():
        for df_ in frag.data_files():
            p = df_.path() if callable(getattr(df_, "path", None)) else df_.path
            paths.append(str(p))
    return paths
