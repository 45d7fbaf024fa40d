"""The port's cold-start probes (`startup/coldstart.py`) on the CPU at
`--tiny`: the JAX probes' topology (setup, then a cold and a warm probe
against one cache directory, each its own process), marker and fields;
the warm probe reports `cache_misses == 0`. (In processes of their own
also because a probe points the process's kernel build directory at its
cache directory.) Plus the kernel build
cache's `cache_entry_count` and `CompileWatch.counts`, the JAX names.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from tensor2robot_tpu_torch.ops import build as build_lib  # noqa: E402
from tensor2robot_tpu_torch.startup import coldstart  # noqa: E402
from tensor2robot_tpu_torch.startup.compile_cache import (  # noqa: E402
    CompileWatch,
    cache_entry_count,
)
from tensor2robot_tpu_torch.utils import checkpoints as ckpt_lib  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_MARKER = "COLDSTART_JSON "
# The JAX probes' fields (tensor2robot_tpu/startup/coldstart.py:151-160,
# :205-217).
_TRAINER_FIELDS = {"probe", "tiny", "device_kind", "time_to_first_step_secs",
                   "startup_timings", "compile_watch", "cache_entries_after"}
_SERVING_FIELDS = {"probe", "tiny", "device_kind", "restored",
                   "time_to_first_prediction_secs",
                   "restore_and_warmup_secs", "engine_warmup_secs",
                   "compiled_buckets", "compile_watch",
                   "cache_entries_after"}
_WATCH_FIELDS = {"cache_hits", "cache_misses", "cache_requests",
                 "backend_compiles"}


def _probe(*args):
  """One probe in a process of its own; its marker's JSON."""
  env = dict(os.environ, PYTHONPATH=_REPO)
  out = subprocess.run(
      [sys.executable, "-m", "tensor2robot_tpu_torch.startup.coldstart",
       *args, "--tiny", "--device", "cpu"],
      cwd=_REPO, env=env, capture_output=True, text=True, timeout=240,
      check=True).stdout
  lines = [l for l in out.splitlines() if l.startswith(_MARKER)]
  assert len(lines) == 1, out
  return json.loads(lines[0][len(_MARKER):])


def test_trainer_probe_cold_then_warm(tmp_path):
  """As `bench.py --coldstart` runs them: one seeded model_dir, copied
  for each probe, and one cache directory for both."""
  seed_dir, cache = str(tmp_path / "seed"), str(tmp_path / "cache")
  assert _probe("trainer", "--model-dir", seed_dir, "--setup") == {
      "setup": "ok", "steps": coldstart.SETUP_STEPS}
  results = []
  for tag in ("cold", "warm"):
    run_dir = str(tmp_path / tag)
    shutil.copytree(seed_dir, run_dir)
    results.append(_probe("trainer", "--model-dir", run_dir,
                          "--cache-dir", cache))
    # The probe resumed the run and took its steps.
    assert ckpt_lib.latest_step(run_dir) == (coldstart.SETUP_STEPS
                                             + coldstart.PROBE_STEPS)
  for result in results:
    assert set(result) == _TRAINER_FIELDS
    assert set(result["compile_watch"]) == _WATCH_FIELDS
    assert result["probe"] == "trainer" and result["tiny"] is True
    assert result["device_kind"] == "cpu"
    assert result["time_to_first_step_secs"] > 0
    assert result["startup_timings"]["mode"] == "overlapped"
  assert results[1]["compile_watch"]["cache_misses"] == 0


def test_serving_probe(tmp_path):
  ckpt_dir, cache = str(tmp_path / "ckpt"), str(tmp_path / "cache")
  assert _probe("serving", "--model-dir", ckpt_dir, "--setup") == {
      "setup": "ok", "step": 1}
  result = _probe("serving", "--model-dir", ckpt_dir, "--cache-dir", cache)
  assert set(result) == _SERVING_FIELDS
  assert set(result["compile_watch"]) == _WATCH_FIELDS
  assert result["restored"] is True
  assert result["compiled_buckets"] == [1, 2]
  assert result["compile_watch"]["cache_misses"] == 0
  assert result["time_to_first_prediction_secs"] >= result[
      "restore_and_warmup_secs"] > 0


def test_a_probe_needs_a_cache_dir_unless_it_sets_up(tmp_path, capsys):
  with pytest.raises(SystemExit):
    coldstart.main(["trainer", "--model-dir", str(tmp_path)])
  assert "--cache-dir" in capsys.readouterr().err


def test_cache_entry_count_counts_kernel_libraries(tmp_path):
  assert cache_entry_count(str(tmp_path / "absent")) == 0
  for name in ("libflash_attention-0123.so", "libcem_select-4567.so",
               "libflash_attention-0123.so.tmp", "lock", "notes.txt"):
    (tmp_path / name).write_text("")
  assert cache_entry_count(str(tmp_path)) == 2


def test_compile_watch_counts_as_jax():
  with CompileWatch() as watch:
    build_lib._notify("cem_select", True)  # noqa: SLF001
    build_lib._notify("flash_attention", False)  # noqa: SLF001
    build_lib._notify("flash_attention_bwd", False)  # noqa: SLF001
  assert watch.counts() == {"cache_hits": 2, "cache_misses": 1,
                            "cache_requests": 3, "backend_compiles": 1}
