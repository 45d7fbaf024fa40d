"""The port's profiler traces on the CPU: `utils.profiling.trace`,
`step_annotation` and `ProfilerHook` (the JAX hook's `>=`-and-opened
trigger over K-step dispatches), and `utils.xplane` reading the chrome
traces they write. The device events a card's trace holds cannot occur
here: `xplane` is held against a trace file in the same format whose
events are known.
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")

from tensor2robot_tpu.utils import xplane as jax_xplane  # noqa: E402
from tensor2robot_tpu_torch import config as gin  # noqa: E402
from tensor2robot_tpu_torch import train_eval  # noqa: E402
from tensor2robot_tpu_torch.data import RandomInputGenerator  # noqa: E402
from tensor2robot_tpu_torch.utils import profiling, xplane  # noqa: E402
from tensor2robot_tpu_torch.utils.mocks import MockT2RModel  # noqa: E402


def _trace_files(logdir):
  return sorted(f for f in os.listdir(logdir) if f.endswith(".pt.trace.json"))


def _events(logdir):
  (name,) = _trace_files(logdir)
  with open(os.path.join(logdir, name)) as f:
    return json.load(f)["traceEvents"]


def test_trace_writes_a_chrome_trace_with_step_annotations(tmp_path):
  logdir = str(tmp_path / "trace")
  with profiling.trace(logdir):
    for step in range(2):
      with profiling.step_annotation(step):
        torch.ones(8, 8) @ torch.ones(8, 8)
  events = _events(logdir)
  steps = [e for e in events if e.get("name") == "train"
           and e.get("cat") == "user_annotation"]
  assert len(steps) == 2
  assert any(e.get("cat") == "cpu_op" and "mm" in e.get("name", "")
             for e in events)


def test_a_device_only_trace_needs_a_card(tmp_path):
  with pytest.raises(ValueError, match="no card"):
    with profiling.trace(str(tmp_path), host_tracer_level=0):
      pass


class _Trace:
  """A torch chrome trace of known device events (µs), the categories
  a card's trace carries."""

  EVENTS = [
      # cat, name, ts, dur
      ("kernel", "void flash_fwd_bf16<64>(...)", 0.0, 10.0),
      ("kernel", "void flash_fwd_bf16<64>(...)", 40.0, 10.0),
      ("kernel", "void flash_bwd_dq_bf16<64>(...)", 12.0, 6.0),
      ("kernel", "ampere_sgemm", 15.0, 10.0),  # overlaps the dq kernel
      ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 60.0, 5.0),
      ("gpu_memset", "Memset (Device)", 70.0, 1.0),
      ("gpu_user_annotation", "train", 0.0, 80.0),
      ("cpu_op", "aten::mm", 0.0, 100.0),
      ("cuda_runtime", "cudaLaunchKernel", 0.0, 2.0),
  ]

  @classmethod
  def write(cls, logdir):
    os.makedirs(os.path.join(logdir, "nested"))
    events = [{"ph": "X", "cat": c, "name": n, "ts": ts, "dur": d,
               "pid": 0, "tid": 7} for c, n, ts, d in cls.EVENTS]
    events.append({"ph": "i", "cat": "kernel", "name": "instant", "ts": 1.0,
                   "pid": 0})
    with open(os.path.join(logdir, "nested", "host_1.2.pt.trace.json"),
              "w") as f:
      json.dump({"traceEvents": events}, f)
    with open(os.path.join(logdir, "ignored.json"), "w") as f:
      json.dump({"traceEvents": events}, f)


def test_op_times_sum_device_events_by_name(tmp_path):
  _Trace.write(str(tmp_path))
  times = xplane.op_times_ms(str(tmp_path))
  assert times == {
      "void flash_fwd_bf16<64>(...)": pytest.approx(0.020),
      "void flash_bwd_dq_bf16<64>(...)": pytest.approx(0.006),
      "ampere_sgemm": pytest.approx(0.010),
      "Memcpy HtoD (Pageable -> Device)": pytest.approx(0.005),
      "Memset (Device)": pytest.approx(0.001),
      "train": pytest.approx(0.080)}
  assert set(xplane.op_times_ms(str(tmp_path), "memcpy")) == {
      "Memcpy HtoD (Pageable -> Device)"}


@pytest.mark.parametrize("name,window", [
    ("Memcpy HtoD (Pageable -> Device)", True), ("Memset (Device)", True),
    ("void flash_fwd_bf16<64>(...)", False), ("ampere_sgemm", False)])
def test_is_async_window(name, window):
  assert xplane.is_async_window(name) is window


def test_top_ops_compute_only_keeps_the_kernels(tmp_path):
  _Trace.write(str(tmp_path))
  top = xplane.top_ops(str(tmp_path), compute_only=True)
  assert [n for n, _ in top] == ["void flash_fwd_bf16<64>(...)",
                                 "ampere_sgemm",
                                 "void flash_bwd_dq_bf16<64>(...)"]
  assert xplane.top_ops(str(tmp_path), k=1)[0][0] == "train"
  # The kernels' sum may exceed the busy time only by their overlap.
  compute = sum(ms for _, ms in top)
  assert xplane.device_busy_ms(str(tmp_path)) == pytest.approx(0.039)
  assert compute == pytest.approx(0.036)


def test_the_function_names_are_the_jax_modules():
  for name in ("op_times_ms", "is_async_window", "top_ops"):
    assert callable(getattr(jax_xplane, name))
    assert callable(getattr(xplane, name))


class _Recorder:
  """Stands in for `trace`: records the steps at which windows open and
  close."""

  def __init__(self, log):
    self.log = log

  def __call__(self, logdir):
    log = self.log

    class Window:

      def __enter__(self):
        log.append(("open", logdir))

      def __exit__(self, *exc):
        log.append(("close", logdir))

    return Window()


@pytest.mark.parametrize("k,start,opened,closed", [
    (1, 3, 3, 8), (4, 10, 12, 16), (4, 8, 8, 16)])
def test_profiler_hook_window_over_k_step_dispatches(monkeypatch, k, start,
                                                     opened, closed):
  """Hooks see every K-th step: the window opens at the first step ≥
  start_step and closes at the first ≥ start_step + num_steps."""
  log = []
  monkeypatch.setattr(profiling, "trace", _Recorder(log))
  hook = profiling.ProfilerHook(start_step=start, num_steps=5)
  hook.begin(None, "/model")
  events = []
  for step in range(k, 25, k):
    before = len(log)
    hook.after_step(step, {})
    events += [(kind, step) for kind, _ in log[before:]]
  assert events == [("open", opened), ("close", closed)]
  assert log[0][1] == os.path.join("/model", "profile")


def test_profiler_hook_closes_a_window_the_run_ends_in(monkeypatch):
  log = []
  monkeypatch.setattr(profiling, "trace", _Recorder(log))
  hook = profiling.ProfilerHook(start_step=2, num_steps=50, logdir="/t")
  hook.begin(None, "/model")
  for step in range(1, 5):
    hook.after_step(step, {})
  hook.end(4, None, "/model")
  assert log == [("open", "/t"), ("close", "/t")]


def test_profiler_hook_traces_a_training_window(tmp_path):
  model_dir = str(tmp_path / "m")
  hook = profiling.ProfilerHook(start_step=2, num_steps=2)
  train_eval.train_eval_model(
      MockT2RModel(), model_dir,
      input_generator_train=RandomInputGenerator(batch_size=8),
      max_train_steps=6, hooks=[hook], device="cpu")
  logdir = os.path.join(model_dir, "profile")
  assert len(_trace_files(logdir)) == 1
  names = {e.get("name") for e in _events(logdir)}
  assert {"aten::mul", "aten::add", "aten::copy_"} <= names


def test_profiler_hook_is_in_the_ports_registry():
  try:
    gin.parse_config("ProfilerHook.start_step = 7\n"
                     "ProfilerHook.num_steps = 3")
    hook = profiling.ProfilerHook()
  finally:
    gin.clear_config()
  assert (hook._start, hook._num) == (7, 3)  # noqa: SLF001
