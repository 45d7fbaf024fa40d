"""The `metrics_<tag>.jsonl` record envelope (port of
`telemetry/records.py`: `make_record`, `read_records`).

Every record is one envelope::

    {"step": int, "wall": float, "role": str, "payload": {name: float}}

``role`` defaults to ``trainer``: the port has no process-role tracer
yet. `read_records` returns records flat, the payload's scalars at the
top level beside step, wall and role.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

DEFAULT_ROLE = "trainer"


def make_record(step: int, payload: Dict[str, float],
                role: Optional[str] = None,
                wall: Optional[float] = None) -> Dict[str, Any]:
  """Builds one envelope record."""
  return {
      "step": int(step),
      "wall": float(time.time() if wall is None else wall),
      "role": str(role if role is not None else DEFAULT_ROLE),
      "payload": dict(payload),
  }


def read_records(path: str) -> List[Dict[str, Any]]:
  """All envelope records of one `metrics_<tag>.jsonl`, flattened."""
  records = []
  with open(path) as f:
    for line in f:
      if line.strip():
        record = json.loads(line)
        records.append({"step": record["step"], "wall": record["wall"],
                        "role": record["role"], **record["payload"]})
  return records
