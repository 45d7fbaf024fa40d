"""Trace merge tool (port of `telemetry/merge.py`): per-process JSONL
traces → one Chrome/Perfetto timeline.

    python -m tensor2robot_tpu_torch.telemetry.merge --trace-dir DIR \
        [--out merged_trace.json]

Reads every ``trace_<role>.jsonl`` a run's processes wrote
(`telemetry.core`), reconciles clocks via the per-file
``clock_offset`` meta lines (learned from the fleet RPC handshake —
every process's spans land on the HOST's monotonic clock), and emits
one Chrome-trace JSON (the `chrome://tracing` / Perfetto `traceEvents`
array format, `ts`/`dur` in microseconds relative to the earliest
span). Each process appears as its role (`process_name` metadata
events), so the merged view answers the fleet-scale bottleneck
question — learner input-starved vs host coalescing poorly vs an
actor wedged — from one screen.

A standalone post-mortem tool: it imports neither torch nor JAX, and
gives the JAX tool's output for the same files.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

TRACE_GLOB = "trace_*.jsonl"


def load_trace_file(path: str) -> Tuple[Dict[str, Any],
                                        List[Dict[str, Any]]]:
  """(meta, spans) of one per-process trace file.

  Multiple meta lines may exist (reconfigures, restarts of the same
  role appending to one file, a late clock-offset stamp): the LAST
  clock_offset before each span applies — offsets are applied per
  span, not per file, so a restarted actor's second incarnation keeps
  its own offset.
  """
  meta: Dict[str, Any] = {}
  spans: List[Dict[str, Any]] = []
  offset = 0.0
  with open(path) as f:
    for line in f:
      line = line.strip()
      if not line:
        continue
      try:
        record = json.loads(line)
      except ValueError:
        continue  # a torn line from a crashed writer
      if record.get("ph") == "M":
        meta = record
        offset = float(record.get("clock_offset", 0.0))
        continue
      record["_offset"] = offset
      spans.append(record)
  return meta, spans


def merge_traces(trace_dir: str,
                 out_path: Optional[str] = None) -> Dict[str, Any]:
  """Merges every trace file under ``trace_dir``; returns (and
  optionally writes) the Chrome-trace dict."""
  paths = sorted(glob.glob(os.path.join(trace_dir, TRACE_GLOB)))
  raw: List[Dict[str, Any]] = []
  roles: Dict[int, str] = {}
  role_names = set()
  for path in paths:
    meta, spans = load_trace_file(path)
    if meta.get("role"):
      role_names.add(meta["role"])
    for span in spans:
      if span.get("role"):
        role_names.add(span["role"])
        roles[int(span.get("pid", 0))] = span["role"]
      raw.append(span)
  corrected = [
      (float(span["ts"]) - span.pop("_offset", 0.0), span)
      for span in raw]
  t0 = min((ts for ts, _ in corrected), default=0.0)
  events: List[Dict[str, Any]] = []
  for pid, role in sorted(roles.items()):
    events.append({"name": "process_name", "ph": "M", "pid": pid,
                   "tid": 0, "args": {"name": role}})
  timed = []
  for ts, span in corrected:
    event = {
        "name": span.get("name", "?"),
        "ph": "X",
        "ts": (ts - t0) * 1e6,
        "dur": float(span.get("dur", 0.0)) * 1e6,
        "pid": int(span.get("pid", 0)),
        "tid": int(span.get("tid", 0)),
        "cat": span.get("role", "?"),
    }
    if span.get("args"):
      event["args"] = span["args"]
    timed.append(event)
  # MERGED ORDER: one timeline, host-clock sorted — the property the
  # cross-process ordering test pins.
  timed.sort(key=lambda e: e["ts"])
  # RPC flow synthesis: an rpc_call.<m> span and the
  # rpc.<m> handler span sharing a client-stamped `req` id become one
  # Perfetto flow — the arrow from the caller's wait to the host's
  # handler work. Offsets were already applied per meta-line above, so
  # flows inherit the same per-file-offset awareness.
  flows = _rpc_flow_events(timed)
  events.extend(timed)
  events.extend(flows)
  span_counts: Dict[str, int] = {}
  for event in timed:
    span_counts[event["cat"]] = span_counts.get(event["cat"], 0) + 1
  trace = {
      "traceEvents": events,
      "displayTimeUnit": "ms",
      "metadata": {
          "rpc_flows": len(flows) // 2,
          # `roles` = every role SEEN (a meta line counts: the process
          # configured tracing); `span_counts_by_role` is the stronger
          # fact — a role that configured but never recorded shows 0,
          # which is what coverage gates must check.
          "roles": sorted(role_names),
          "span_counts_by_role": span_counts,
          "trace_files": [os.path.basename(p) for p in paths],
          "span_count": len(timed),
      },
  }
  if out_path:
    if out_path.endswith(".gz"):
      # Perfetto / chrome://tracing load gzipped traces natively; the
      # committed-artifact path uses this (a full fleet timeline is
      # ~2 MB raw, ~10× smaller gzipped).
      import gzip
      with gzip.open(out_path, "wt") as f:
        json.dump(trace, f)
    else:
      with open(out_path, "w") as f:
        json.dump(trace, f)
  return trace


def _rpc_flow_events(timed: List[Dict[str, Any]]
                     ) -> List[Dict[str, Any]]:
  """Chrome-trace flow event pairs linking rpc_call.<m> (client span,
  flow start) to rpc.<m> (server handler span, flow end) by the
  client-stamped ``args.req`` id (fleet/rpc.py). A retried call whose
  first send was dropped has a client span with no handler twin (or
  vice versa after a crash) — unpaired ids emit nothing."""
  starts: Dict[str, Dict[str, Any]] = {}
  ends: Dict[str, Dict[str, Any]] = {}
  for event in timed:
    req = (event.get("args") or {}).get("req")
    if not req:
      continue
    name = event.get("name", "")
    if name.startswith("rpc_call.") and req not in starts:
      starts[req] = event
    elif name.startswith("rpc.") and req not in ends:
      ends[req] = event
  flows: List[Dict[str, Any]] = []
  for index, (req, start) in enumerate(sorted(starts.items())):
    end = ends.get(req)
    if end is None:
      continue
    method = start["name"][len("rpc_call."):]
    base = {"name": f"rpc:{method}", "cat": "rpc_flow",
            "id": index + 1}
    flows.append({**base, "ph": "s", "ts": start["ts"],
                  "pid": start["pid"], "tid": start["tid"]})
    flows.append({**base, "ph": "f", "bp": "e", "ts": end["ts"],
                  "pid": end["pid"], "tid": end["tid"]})
  return flows


def roles_in(trace: Dict[str, Any]) -> List[str]:
  """Every role seen in the merge (meta lines included)."""
  return list(trace.get("metadata", {}).get("roles", []))


def roles_with_spans(trace: Dict[str, Any]) -> List[str]:
  """Roles that contributed at least one actual span — the set
  coverage assertions ("the timeline contains spans from every role")
  must check; `roles_in` also counts a process that merely configured
  tracing and then wedged before recording."""
  counts = trace.get("metadata", {}).get("span_counts_by_role", {})
  return sorted(role for role, n in counts.items() if n > 0)


def main(argv: Optional[List[str]] = None) -> int:
  parser = argparse.ArgumentParser(
      description="Merge per-process telemetry traces into one "
      "Chrome-trace timeline.")
  parser.add_argument("--trace-dir", required=True,
                      help="directory holding trace_<role>.jsonl files")
  parser.add_argument("--out", default=None,
                      help="merged Chrome-trace JSON output path "
                      "(default: <trace-dir>/merged_trace.json)")
  args = parser.parse_args(argv)
  out = args.out or os.path.join(args.trace_dir, "merged_trace.json")
  trace = merge_traces(args.trace_dir, out_path=out)
  summary = {
      "out": out,
      "roles": roles_in(trace),
      "span_count": trace["metadata"]["span_count"],
  }
  print(json.dumps(summary))
  return 0 if trace["metadata"]["span_count"] else 1


if __name__ == "__main__":
  sys.exit(main())
