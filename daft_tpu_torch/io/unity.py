"""A Unity Catalog client (the port's copy of daft_tpu/io/unity.py).

Unity tables are Delta Lake tables behind a REST catalog: the client
resolves a three-part name to the table's storage location, and
``read_deltalake`` reads it through the Delta log replay (io/catalogs.py).
The HTTP calls go through ``urllib`` against the
``/api/2.1/unity-catalog/`` endpoints (Databricks-hosted or the OSS
server), so no client package is needed.
"""

from __future__ import annotations

import dataclasses
import json
import urllib.parse
import urllib.request
from typing import List, Optional


@dataclasses.dataclass(frozen=True)
class UnityCatalogTable:
    """A resolved Unity table: its storage location, which
    ``read_deltalake`` accepts."""

    table_uri: str


class UnityCatalog:
    """Client for a Unity Catalog server (Databricks-hosted or the OSS
    `unitycatalog` server). `load_table` resolves a `catalog.schema.table`
    name to a UnityCatalogTable, which `read_deltalake` accepts."""

    def __init__(self, endpoint: str, token: Optional[str] = None):
        self._base = endpoint.rstrip("/") + "/api/2.1/unity-catalog/"
        self._token = token

    def _get(self, path: str, params: Optional[dict] = None) -> dict:
        url = self._base + path
        if params:
            url += "?" + urllib.parse.urlencode(
                {k: v for k, v in params.items() if v is not None})
        req = urllib.request.Request(url)
        if self._token:
            req.add_header("Authorization", f"Bearer {self._token}")
        with urllib.request.urlopen(req, timeout=30) as resp:
            return json.loads(resp.read().decode("utf-8"))

    def _paginate(self, path: str, key: str, params: Optional[dict] = None) -> List[str]:
        params = dict(params or {})
        out: List[str] = []
        token = None
        while True:
            if token:
                params["page_token"] = token
            body = self._get(path, params)
            for item in body.get(key) or []:
                out.append(item["name"])
            token = body.get("next_page_token")
            if not token:
                return out

    def list_catalogs(self) -> List[str]:
        return self._paginate("catalogs", "catalogs")

    def list_schemas(self, catalog_name: str) -> List[str]:
        return [f"{catalog_name}.{s}" for s in self._paginate(
            "schemas", "schemas", {"catalog_name": catalog_name})]

    def list_tables(self, schema_name: str) -> List[str]:
        catalog, schema = schema_name.split(".", 1)
        return [f"{schema_name}.{t}" for t in self._paginate(
            "tables", "tables",
            {"catalog_name": catalog, "schema_name": schema})]

    def load_table(self, table_name: str) -> UnityCatalogTable:
        body = self._get(f"tables/{urllib.parse.quote(table_name)}")
        loc = body.get("storage_location")
        if not loc:
            raise ValueError(
                f"Unity table {table_name!r} has no storage_location "
                f"(only external/managed tables with a location are readable)")
        return UnityCatalogTable(table_uri=loc)
