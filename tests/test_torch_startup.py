"""The port's overlapped startup and stall accounting (`startup/
orchestrator.py`, `train_eval.train_eval_model`), mirroring
`tests/test_startup.py`'s overlapped-startup cases, on the CPU.

  * A resume with the phases overlapped (restore ∥ input spin-up ∥ the
    kernel libraries) equals the serial resume bit for bit, and so does a
    fresh start; `overlap_startup` defaults to True, as in JAX.
  * `startup_timings.json`: mode "overlapped" and the phases JAX writes
    (compile and input on a fresh start, all three on a resume); a
    serial start writes none.
  * `run_overlapped` raises a phase's error only after every phase has
    joined, and a failed phase closes the input phase's prefetcher.
  * `stall_fraction` and the pure `steps_per_sec`, as JAX computes them.
"""

import json
import os
import shutil
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from tensor2robot_tpu import train_eval as jax_train_eval  # noqa: E402
from tensor2robot_tpu.data import (  # noqa: E402
    RandomInputGenerator as JaxRandomInputGenerator,
)
from tensor2robot_tpu.telemetry.records import (  # noqa: E402
    read_records as jax_read_records,
)
from tensor2robot_tpu.utils.mocks import (  # noqa: E402
    MockT2RModel as JaxMockT2RModel,
)
from tensor2robot_tpu_torch import train_eval  # noqa: E402
from tensor2robot_tpu_torch.data import RandomInputGenerator  # noqa: E402
from tensor2robot_tpu_torch.startup import orchestrator  # noqa: E402
from tensor2robot_tpu_torch.telemetry.records import read_records  # noqa: E402
from tensor2robot_tpu_torch.utils import checkpoints as ckpt_lib  # noqa: E402
from tensor2robot_tpu_torch.utils.mocks import MockT2RModel  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
  """One intra-op thread: the tensors are small, and the test workers
  share the host's cores."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _run(model_dir, max_steps, overlap=None, **kwargs):
  if overlap is not None:
    kwargs["overlap_startup"] = overlap
  kwargs.setdefault("input_generator_eval",
                    RandomInputGenerator(batch_size=8, seed=6))
  return train_eval.train_eval_model(
      model=MockT2RModel(hidden_sizes=(8,)), model_dir=model_dir,
      input_generator_train=RandomInputGenerator(batch_size=8, seed=5),
      max_train_steps=max_steps, eval_steps=2, save_checkpoints_steps=3,
      log_every_steps=3, device="cpu", **kwargs)


def _same(a, b):
  for name in ("params", "batch_stats"):
    x, y = getattr(a, name), getattr(b, name)
    assert set(x) == set(y)
    for key in x:
      assert torch.equal(x[key], y[key]), key
  adam_a, adam_b = a.opt_state[0], b.opt_state[0]
  assert int(adam_a.count) == int(adam_b.count)
  for key in adam_a.mu:
    assert torch.equal(adam_a.mu[key], adam_b.mu[key])
    assert torch.equal(adam_a.nu[key], adam_b.nu[key])


@pytest.mark.parametrize("graphs", [True, False], ids=["graphed", "eager"])
def test_resume_overlap_matches_serial_bitwise(tmp_path, graphs):
  base = str(tmp_path / "base")
  _run(base, max_steps=3, overlap=False, graphs=graphs)
  fork = str(tmp_path / "fork")
  shutil.copytree(base, fork)
  serial = _run(base, max_steps=6, overlap=False, graphs=graphs)
  overlapped = _run(fork, max_steps=6, overlap=True, graphs=graphs)
  assert serial.step == overlapped.step == 6
  _same(serial, overlapped)


def test_fresh_start_overlap_matches_serial_bitwise(tmp_path):
  serial = _run(str(tmp_path / "s"), max_steps=6, overlap=False)
  overlapped = _run(str(tmp_path / "o"), max_steps=6)  # the default
  _same(serial, overlapped)


def _timings(model_dir):
  with open(os.path.join(model_dir, orchestrator.STARTUP_TIMINGS_FILE)) as f:
    return json.load(f)


def test_startup_timings_written_with_the_jax_phases(tmp_path):
  model_dir = str(tmp_path / "m")
  _run(model_dir, max_steps=3)
  timings = _timings(model_dir)
  assert timings["mode"] == "overlapped"
  assert set(timings["phase_seconds"]) == {"compile", "input"}
  _run(model_dir, max_steps=6)  # resume
  timings = _timings(model_dir)
  assert set(timings["phase_seconds"]) == {"compile", "restore", "input"}
  assert set(timings) == {"mode", "phase_seconds", "total_seconds",
                          "serial_seconds", "overlap_saved_seconds"}
  assert timings["total_seconds"] > 0
  serial_dir = str(tmp_path / "serial")
  _run(serial_dir, max_steps=3, overlap=False)
  assert not os.path.exists(os.path.join(
      serial_dir, orchestrator.STARTUP_TIMINGS_FILE))


def test_startup_timings_have_the_jax_layout(tmp_path):
  """The JAX trainer's file for the same run: the same keys and phases."""
  model_dir = str(tmp_path / "jax")
  jax_train_eval.train_eval_model(
      model=JaxMockT2RModel(), model_dir=model_dir,
      input_generator_train=JaxRandomInputGenerator(batch_size=8),
      max_train_steps=3, save_checkpoints_steps=3, log_every_steps=3)
  want = _timings(model_dir)
  _run(str(tmp_path / "port"), max_steps=3, input_generator_eval=None)
  got = _timings(str(tmp_path / "port"))
  assert set(got) == set(want)
  assert got["mode"] == want["mode"] == "overlapped"
  assert set(got["phase_seconds"]) == set(want["phase_seconds"])


def test_run_overlapped_surfaces_errors_after_join():
  finished = threading.Event()

  def slow():
    time.sleep(0.2)
    finished.set()
    return 42

  def boom():
    raise RuntimeError("phase failed")

  report = orchestrator.run_overlapped({"a": slow, "b": boom})
  assert finished.is_set()  # joined before anything was reported
  assert report.results["a"] == 42 and "b" in report.errors
  assert report.mode == "overlapped"
  assert set(report.seconds) == {"a", "b"}
  with pytest.raises(RuntimeError, match="phase failed"):
    report.raise_first()
  serial = orchestrator.run_overlapped({"a": lambda: 1}, overlap=False)
  assert serial.mode == "serial" and serial.results == {"a": 1}


def test_close_quietly():
  closed = []

  class Closing:
    def close(self):
      closed.append(True)
      raise OSError("already gone")

  orchestrator.close_quietly(None)
  orchestrator.close_quietly(object())
  orchestrator.close_quietly(Closing())  # logged, not raised
  assert closed == [True]


def test_a_failed_phase_closes_the_input_prefetcher(tmp_path, monkeypatch):
  model_dir = str(tmp_path / "m")
  _run(model_dir, max_steps=3)
  made = []
  real = train_eval._device_batches

  def recording(*args, **kwargs):
    prefetcher = real(*args, **kwargs)
    made.append(prefetcher)
    return prefetcher

  def broken_restore(*args, **kwargs):
    raise OSError("unreadable checkpoint")

  monkeypatch.setattr(train_eval, "_device_batches", recording)
  monkeypatch.setattr(ckpt_lib, "restore_state", broken_restore)
  with pytest.raises(OSError, match="unreadable checkpoint"):
    _run(model_dir, max_steps=6)
  assert len(made) == 1
  assert made[0]._stop.is_set()  # closed
  made[0]._thread.join(timeout=5)
  assert not made[0]._thread.is_alive()


def test_stall_fraction_and_pure_steps_per_sec(tmp_path):
  """The port's records against the JAX trainer's for the same schedule:
  both carry `steps_per_sec` > 0 and `stall_fraction` in [0, 1], and the
  intervals holding a checkpoint save and an evaluation stall (the JAX
  test's pin)."""
  kwargs = dict(max_train_steps=20, eval_steps=2, eval_every_steps=10,
                save_checkpoints_steps=10, log_every_steps=5)
  port_dir = str(tmp_path / "port")
  train_eval.train_eval_model(
      model=MockT2RModel(), model_dir=port_dir,
      input_generator_train=RandomInputGenerator(batch_size=8, seed=1),
      input_generator_eval=RandomInputGenerator(batch_size=8, seed=2),
      device="cpu", **kwargs)
  jax_dir = str(tmp_path / "jax")
  jax_train_eval.train_eval_model(
      model=JaxMockT2RModel(), model_dir=jax_dir,
      input_generator_train=JaxRandomInputGenerator(batch_size=8, seed=1),
      input_generator_eval=JaxRandomInputGenerator(batch_size=8, seed=2),
      **kwargs)
  for records in (read_records(os.path.join(port_dir, "metrics_train.jsonl")),
                  jax_read_records(os.path.join(jax_dir,
                                                "metrics_train.jsonl"))):
    assert [r["step"] for r in records] == [5, 10, 15, 20]
    for record in records:
      assert record["steps_per_sec"] > 0
      assert 0.0 <= record["stall_fraction"] <= 1.0
      assert 0.0 <= record["input_wait_fraction"] <= 1.0
    assert any(r["stall_fraction"] > 0 for r in records
               if r["step"] in (15, 20))


def test_stall_arithmetic_is_the_jax_arithmetic(tmp_path, monkeypatch):
  """Under an injected clock: an interval of 10 s wall holding 4 s of
  stalls gives steps_per_sec = steps / (10 − 4) and stall_fraction 0.4,
  the JAX formulas (`train_eval.py`), not steps / 10."""
  clock = {"wall": 1000.0, "perf": 0.0}

  def wall():
    return clock["wall"]

  def perf():
    return clock["perf"]

  saves = []
  real_save = ckpt_lib.CheckpointWriter.save

  def slow_save(self, step, state):
    clock["perf"] += 4.0  # a 4 s checkpoint save
    clock["wall"] += 4.0
    saves.append(step)
    return real_save(self, step, state)

  class Ticking(train_eval.Hook):
    def after_step(self, step, metrics):
      clock["wall"] += 1.0  # each step takes 1 s of wall

  monkeypatch.setattr(train_eval.time, "time", wall)
  monkeypatch.setattr(train_eval.time, "perf_counter", perf)
  monkeypatch.setattr(ckpt_lib.CheckpointWriter, "save", slow_save)
  model_dir = str(tmp_path / "m")
  train_eval.train_eval_model(
      model=MockT2RModel(), model_dir=model_dir,
      input_generator_train=RandomInputGenerator(batch_size=8, seed=1),
      max_train_steps=12, save_checkpoints_steps=6, log_every_steps=6,
      hooks=[Ticking()], device="cpu")
  records = read_records(os.path.join(model_dir, "metrics_train.jsonl"))
  assert saves == [6, 12]
  first, second = records
  # Interval 1: 6 steps, 6 s, no stall yet (the save follows the log).
  assert first["steps_per_sec"] == pytest.approx(1.0)
  assert first["stall_fraction"] == 0.0
  # Interval 2: the step-6 save's 4 s, then 6 steps of 1 s: 10 s wall.
  assert second["steps_per_sec"] == pytest.approx(6 / (10 - 4))
  assert second["stall_fraction"] == pytest.approx(0.4)


def test_overlap_startup_defaults_to_true_as_in_jax():
  import inspect
  port = inspect.signature(train_eval.train_eval_model.__wrapped__
                           if hasattr(train_eval.train_eval_model,
                                      "__wrapped__")
                           else train_eval.train_eval_model)
  jax_sig = inspect.signature(jax_train_eval.train_eval_model.__wrapped__
                              if hasattr(jax_train_eval.train_eval_model,
                                         "__wrapped__")
                              else jax_train_eval.train_eval_model)
  assert port.parameters["overlap_startup"].default is True
  assert jax_sig.parameters["overlap_startup"].default is True
