"""The retry discipline of scan reads and the remote-path test (the port's
copy of the part of daft_tpu/io/object_store.py the scan layer reads).

The port reads local files only: a remote path (``s3://``, ``gs://``,
``http(s)://``, ``az://``, ``abfs(s)://``, ``hf://``) raises a
``ValueError`` until the object-store client is ported (ROADMAP, Queue 1,
item 9).
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass

from ..errors import DaftTransientError, DaftValueError
from .scan import IO_STATS

REMOTE_SCHEMES = ("s3://", "http://", "https://", "gs://", "az://", "abfs://",
                  "abfss://", "hf://")


@dataclass
class RetryPolicy:
    """Attempts with exponential backoff and jitter (jitter keeps retrying
    readers from retrying in step). ``permanent`` exceptions, checked
    first, propagate at once; ``retryable`` ones retry, each counted in
    ``IO_STATS.retries``; the last one raises after ``attempts``."""

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


def is_remote_path(path: str) -> bool:
    return str(path).startswith(REMOTE_SCHEMES)


def check_local_path(path: str) -> None:
    """Raise for a remote path: the port reads local files only."""
    if is_remote_path(path):
        raise DaftValueError(
            f"{path!r} is a remote path; the port reads local files only until "
            "the object-store client is ported (ROADMAP, Queue 1, item 9)")
