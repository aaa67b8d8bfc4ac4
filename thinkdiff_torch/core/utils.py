"""Small host-side helpers of the jobs (the part of
thinkdiff_tpu/core/utils.py that the port's CLIs and runners use)."""

from __future__ import annotations

import datetime
import json
from typing import Any


def now() -> str:
    """Job-id timestamp: YYYYmmddHHM (minutes cut to tens)."""
    return datetime.datetime.now().strftime("%Y%m%d%H%M")[:-1]


def append_json_line(obj: Any, path: str) -> None:
    """One JSON object a line, appended (the runners' ``log.txt``)."""
    with open(path, "a") as f:
        f.write(json.dumps(obj, default=str) + "\n")
