"""The port's perf plane (`telemetry/perf.py`, `utils/profiling.py`)
against the JAX package's, mirroring `tests/test_perf_plane.py` (the
sentinel's half is `tests/test_torch_sentinel.py`), on the CPU.

  * `mfu_value` equals JAX's for the same inputs, the unknowables
    included; `PerfMeter.publish` sets the gauges, publishes no mfu
    without a peak and nothing while the plane is off.
  * The resource sampler: RSS and watched-gauge peaks are monotone, a
    broken source is skipped, the process sampler honours the switch.
  * `analytic_flops("attention", ...)` and `qtopt_step_flops` equal
    JAX's exactly (pure arithmetic: integer-equal floats).
  * The peak table: H100 SXM5 and PCIe by name, none for a CPU or an
    unknown card, `T2R_PEAK_FLOPS_OVERRIDE` over all.
  * The generic trainer's step count (`train_step_flops`): attention
    counted analytically whatever backend runs it, a dense layer's
    products counted as 2·M·N·K, and every other op as `FlopCounterMode`
    counts it.
  * `train_qtopt`, `train_anakin` and `train_eval_model` records carry
    `perf.device_time_fraction` and `rsrc.*` (and `train_eval_model`'s
    its `stall_fraction`); with an injected peak, `perf.mfu` by the
    shared formula.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from tensor2robot_tpu.research.qtopt import (  # noqa: E402
    GraspingQModel as JaxGraspingQModel,
    QTOptLearner as JaxQTOptLearner,
)
from tensor2robot_tpu.telemetry import perf as jax_perf  # noqa: E402
from tensor2robot_tpu.utils import profiling as jax_profiling  # noqa: E402
from tensor2robot_tpu_torch import envs, train_eval  # noqa: E402
from tensor2robot_tpu_torch.data import RandomInputGenerator  # noqa: E402
from tensor2robot_tpu_torch.research.qtopt import (  # noqa: E402
    GraspingQModel,
    QTOptLearner,
)
from tensor2robot_tpu_torch.research.qtopt.train_qtopt import (  # noqa: E402
    train_qtopt,
)
from tensor2robot_tpu_torch.telemetry import core as tcore  # noqa: E402
from tensor2robot_tpu_torch.telemetry import metrics as tmetrics  # noqa: E402
from tensor2robot_tpu_torch.telemetry import perf as perf_lib  # noqa: E402
from tensor2robot_tpu_torch.telemetry.records import read_records  # noqa: E402
from tensor2robot_tpu_torch.utils import profiling  # noqa: E402
from tensor2robot_tpu_torch.utils.mocks import MockT2RModel  # noqa: E402

PEAK = 1.0e12  # the test roofline (a CPU has no table entry)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
  """One intra-op thread: the tensors are small, and the test workers
  share the host's cores."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _isolated_telemetry(monkeypatch):
  monkeypatch.delenv("T2R_PEAK_FLOPS_OVERRIDE", raising=False)
  tcore.reset_for_tests()
  tmetrics.reset_for_tests()
  perf_lib.stop_resource_sampler()
  perf_lib.set_plane_enabled(None)
  yield
  perf_lib.stop_resource_sampler()
  perf_lib.set_plane_enabled(None)
  tcore.reset_for_tests()
  tmetrics.reset_for_tests()


@pytest.mark.parametrize("rate,flops,peak,devices", [
    (10.0, 1e9, 1e12, 1), (10.0, 4e9, 1e12, 4), (12.5, 3.1e9, 989.4e12, 1),
    (700.0, 1.0e8, 756e12, 0), (10.0, None, 1e12, 1), (10.0, 1e9, None, 1),
    (10.0, 0.0, 1e12, 1)])
def test_mfu_value_matches_jax(rate, flops, peak, devices):
  assert perf_lib.mfu_value(rate, flops, peak, devices) == (
      jax_perf.mfu_value(rate, flops, peak, devices))


def test_publish_sets_gauges_and_busy_fraction():
  import time
  meter = perf_lib.PerfMeter(flops_per_step=100.0, peak_flops=1e3,
                             devices=2, enabled=True)
  with meter.dispatch("x.dispatch"):
    time.sleep(0.01)
  out = meter.publish(steps_per_sec=5.0, interval_secs=0.1)
  assert out["perf.flops_per_sec"] == pytest.approx(500.0)
  assert out["perf.mfu"] == pytest.approx(5.0 * 100.0 / (1e3 * 2))
  assert 0.0 < out["perf.device_time_fraction"] <= 1.0
  gauges = tmetrics.registry().snapshot()["gauges"]
  assert gauges["perf.mfu"] == pytest.approx(out["perf.mfu"])
  assert gauges["perf.flops_per_sec"] == pytest.approx(500.0)
  # The accumulator resets per interval.
  assert meter.publish(5.0, 0.1)["perf.device_time_fraction"] == 0.0


def test_unknown_peak_publishes_no_mfu():
  out = perf_lib.PerfMeter(flops_per_step=100.0, peak_flops=None,
                           enabled=True).publish(5.0, 0.1)
  assert "perf.mfu" not in out
  assert {"perf.flops_per_sec", "perf.device_time_fraction"} <= set(out)
  no_flops = perf_lib.PerfMeter(peak_flops=1e3, enabled=True).publish(5.0,
                                                                      0.1)
  assert set(no_flops) == {"perf.device_time_fraction"}


def test_disabled_plane_publishes_nothing(monkeypatch):
  meter = perf_lib.PerfMeter(flops_per_step=100.0, peak_flops=1e3,
                             enabled=False)
  assert meter.publish(5.0, 0.1) == {}
  assert tmetrics.registry().snapshot()["gauges"] == {}
  monkeypatch.setenv("T2R_PERF_PLANE", "0")
  perf_lib.set_plane_enabled(None)
  assert not perf_lib.plane_enabled()
  assert perf_lib.PerfMeter(flops_per_step=1.0).publish(1.0, 1.0) == {}
  assert perf_lib.start_resource_sampler() is None


def test_rss_and_peak_watermarks():
  sampler = perf_lib.ResourceSampler(watched_gauges=())
  sampler.sample_once()
  gauges = tmetrics.registry().snapshot()["gauges"]
  assert gauges["rsrc.host_rss_bytes"] > 0
  assert gauges["rsrc.host_rss_bytes_peak"] >= gauges["rsrc.host_rss_bytes"]


def test_watched_gauge_and_source_peaks_are_monotone():
  fill = tmetrics.gauge("replay.fill")
  values = iter((3.0, 7.0, 5.0))
  sampler = perf_lib.ResourceSampler(
      sources=[lambda: {"x": next(values)}], watched_gauges=("replay.fill",))
  for value in (0.2, 0.9, 0.4):
    fill.set(value)
    sampler.sample_once()
  gauges = tmetrics.registry().snapshot()["gauges"]
  assert gauges["rsrc.replay.fill_peak"] == pytest.approx(0.9)
  assert gauges["rsrc.x"] == 5.0 and gauges["rsrc.x_peak"] == 7.0
  assert sampler.samples == 3


def test_broken_source_is_skipped_not_raised():
  def broken():
    raise RuntimeError("boom")

  sampler = perf_lib.ResourceSampler(
      sources=[broken, lambda: {"ok": 1.0}], watched_gauges=())
  sampler.sample_once()  # must not raise
  assert tmetrics.registry().snapshot()["gauges"]["rsrc.ok"] == 1.0


def test_process_sampler_respects_the_plane_switch():
  perf_lib.set_plane_enabled(False)
  assert perf_lib.start_resource_sampler() is None
  perf_lib.set_plane_enabled(True)
  sampler = perf_lib.start_resource_sampler()
  assert sampler is not None
  assert perf_lib.start_resource_sampler() is sampler  # idempotent
  # The first pass ran before start returned.
  assert "rsrc.host_rss_bytes" in tmetrics.registry().snapshot()["gauges"]
  perf_lib.stop_resource_sampler()


def test_device_memory_source_yields_nothing_without_a_card():
  assert profiling.device_memory_source()() == {}


@pytest.mark.parametrize("b,heads,d,t,causal", [
    (1, 4, 32, 512, True), (16, 4, 32, 32, True), (3, 2, 16, 17, False),
    (16, 8, 128, 4096, True)])
def test_attention_flops_equal_jax(b, heads, d, t, causal):
  kw = dict(b=b, heads=heads, d=d, t=t, causal=causal)
  got = profiling.analytic_flops("attention", **kw)
  assert got == jax_profiling.analytic_flops("attention", **kw)
  assert got == int(got)


_QT_CONFIGS = [
    dict(),
    dict(image_size=16, torso_filters=(8,), head_filters=(8,),
         dense_sizes=(16,), action_dim=2),
    dict(head_filters=(), space_to_depth=2),
    dict(image_size=48, torso_filters=(16, 32, 32), head_filters=(32, 16),
         dense_sizes=(32,), extra_state_features={"goal_embedding": (8,)}),
]


@pytest.mark.parametrize("config", range(len(_QT_CONFIGS)))
@pytest.mark.parametrize("batch", [16, 256])
def test_qtopt_step_flops_equal_jax(config, batch):
  kw = _QT_CONFIGS[config]
  jax_learner = JaxQTOptLearner(JaxGraspingQModel(**kw), cem_population=16,
                                cem_iterations=2, cem_elites=4)
  learner = QTOptLearner(GraspingQModel(**kw), cem_population=16,
                         cem_iterations=2, cem_elites=4, device="cpu")
  jax_params = jax.eval_shape(
      lambda rng: jax_learner.create_state(rng, batch_size=2),
      jax.random.PRNGKey(0)).train_state.params
  params = learner.create_state(0).train_state.params
  want = jax_profiling.qtopt_step_flops(jax_learner, batch,
                                        params=jax_params)
  got = profiling.qtopt_step_flops(learner, batch, params=params)
  assert got == want and got == int(got)
  assert profiling.qtopt_step_flops(learner, batch) == (
      jax_profiling.qtopt_step_flops(jax_learner, batch))


def test_qtopt_step_flops_is_none_for_another_network():
  class Other:
    model = MockT2RModel()
    cem_population = cem_iterations = 1

  assert profiling.qtopt_step_flops(Other(), 8) is None


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989.4e12), ("NVIDIA H100 PCIe", 756e12),
    ("NVIDIA A100-SXM4-80GB", None)])
def test_peak_table_reads_the_card_name(monkeypatch, name, peak):
  monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
  assert profiling.device_peak_flops(torch.device("cuda", 0)) == peak
  assert profiling.device_peak_flops("cpu") is None
  monkeypatch.setenv("T2R_PEAK_FLOPS_OVERRIDE", "123.0")
  assert profiling.device_peak_flops(torch.device("cuda", 0)) == 123.0
  assert profiling.device_peak_flops("cpu") == 123.0
  assert profiling.mfu(2.0, 10.0, "cpu") == perf_lib.mfu_value(2.0, 10.0,
                                                               123.0)


def test_the_jax_table_has_no_cuda_entry():
  """The port's table is the card's alone: no TPU row, and no row of the
  JAX table names an NVIDIA card."""
  assert not set(profiling.PEAK_BF16_FLOPS) & set(
      jax_profiling.PEAK_BF16_FLOPS)
  assert all("h100" in key for key in profiling.PEAK_BF16_FLOPS)


def test_train_step_flops_counts_a_dense_layer():
  linear = torch.nn.Linear(32, 16)

  def step(weight, x):
    return x @ weight.t()

  assert profiling.train_step_flops(step, linear.weight, torch.ones(8, 32)) \
      == 2 * 8 * 32 * 16

  def broken(x):
    raise RuntimeError("no such op")

  # A step that cannot run has no count (and publishes no perf.mfu).
  assert profiling.train_step_flops(broken, torch.ones(())) is None


@pytest.mark.parametrize("name", ["mock", "pose", "transformer", "moe"])
def test_train_step_flops_equal_flop_counter_mode(name):
  """The light counting mode gives `FlopCounterMode`'s count (on a model
  without attention, where nothing is counted analytically; with
  attention, FlopCounterMode over the reference backend's products plus
  the difference the analytic count makes)."""
  from torch.utils.flop_counter import FlopCounterMode

  from tensor2robot_tpu_torch.research.pose_env.pose_env_models import (
      PoseEnvRegressionModel,
  )
  from tensor2robot_tpu_torch.research.vrgripper import (
      VRGripperTransformerModel,
  )
  small = dict(image_size=16, filters=(8,), embedding_size=16, width=32,
               depth=2, num_heads=2, max_context_length=8,
               attention_impl="reference")
  model = {"mock": MockT2RModel(),
           "pose": PoseEnvRegressionModel(image_size=32),
           "transformer": VRGripperTransformerModel(**small),
           "moe": VRGripperTransformerModel(moe_experts=4, moe_every=1,
                                            **small)}[name]
  gen = RandomInputGenerator(batch_size=4)
  gen.set_specification_from_model(model, train_eval.Mode.TRAIN)
  features, labels = next(gen.create_dataset(train_eval.Mode.TRAIN))
  flat = lambda s: {k: torch.as_tensor(np.asarray(v))  # noqa: E731
                    for k, v in s.to_flat_dict().items()}
  batch = {"features": flat(features), "labels": flat(labels)}
  state = model.create_train_state(0, device="cpu")
  step = train_eval.train_step_fn(model)
  got = profiling.train_step_flops(step, state, batch, ())
  with FlopCounterMode(display=False) as counter:
    step(state, batch, ())
  want = counter.get_total_flops()
  if name in ("transformer", "moe"):
    # The reference attention's products, forward and backward, out;
    # the analytic causal count in.
    b, t = features.to_flat_dict()["gripper_pose"].shape[:2]
    fwd = profiling.analytic_flops("attention", b=b, heads=2, d=16, t=t)
    full = 2 * fwd  # QKᵀ and PV over every (q, k) pair
    want = want - 2 * (full + 2 * full) + 2 * 3.5 * fwd
  assert got == want


def test_attention_is_counted_analytically_whatever_the_backend():
  """The causal forward at analytic_flops("attention") and the backward
  at 2.5× it, the same under the reference and the flash backends; the
  rest of the step is FlopCounterMode's count."""
  from tensor2robot_tpu_torch.research.vrgripper import (
      VRGripperTransformerModel,
  )
  small = dict(image_size=16, filters=(8,), embedding_size=16, width=32,
               depth=2, num_heads=2, max_context_length=8)
  features = {"image": torch.zeros((4, 8, 16, 16, 3), dtype=torch.uint8),
              "gripper_pose": torch.zeros((4, 8, 3))}
  labels = {"action": torch.zeros((4, 8, 3))}
  counts = {}
  for impl in ("reference", "flash"):
    model = VRGripperTransformerModel(attention_impl=impl, **small)
    state = model.create_train_state(0, device="cpu")
    train = profiling.train_step_flops(
        train_eval.train_step_fn(model), state,
        {"features": features, "labels": labels}, ())
    evaluate = profiling.train_step_flops(
        train_eval.eval_step_fn(model), state,
        {"features": features, "labels": labels}, ())
    counts[impl] = (train, evaluate)
  assert counts["reference"] == counts["flash"]
  train, evaluate = counts["reference"]
  attention = profiling.analytic_flops("attention", b=4, heads=2, d=16, t=8)
  assert train > evaluate > 2 * attention
  # Two blocks: a forward counts each block's attention once, a train
  # step 1 + 2.5 times.
  model = VRGripperTransformerModel(attention_impl="reference", **small)
  state = model.create_train_state(0, device="cpu")
  with profiling.counting_attention() as count:
    model.eval_step(state, features, labels)
  assert count.flops == 2 * attention
  with profiling.counting_attention() as count:
    model.train_step(state, features, labels)
  assert count.flops == 2 * 3.5 * attention


def _record(model_dir):
  records = read_records(os.path.join(model_dir, "metrics_train.jsonl"))
  assert records
  record = records[-1]
  assert 0.0 <= record["perf.device_time_fraction"] <= 1.0
  assert record["rsrc.host_rss_bytes"] > 0
  assert record["rsrc.host_rss_bytes_peak"] >= record["rsrc.host_rss_bytes"]
  return record


def _tiny_learner():
  return QTOptLearner(
      GraspingQModel(image_size=16, torso_filters=(8,), head_filters=(8,),
                     dense_sizes=(16,), action_dim=2),
      cem_population=8, cem_iterations=1, cem_elites=2, device="cpu")


@pytest.mark.parametrize("peak", [None, PEAK])
def test_train_qtopt_publishes_the_plane(tmp_path, monkeypatch, peak):
  if peak:
    monkeypatch.setenv("T2R_PEAK_FLOPS_OVERRIDE", str(peak))
  learner = _tiny_learner()
  batch = 16
  state = train_qtopt(learner=learner, model_dir=str(tmp_path),
                      prefill_random=True, max_train_steps=8,
                      batch_size=batch, log_every_steps=4,
                      save_checkpoints_steps=8, seed=0)
  record = _record(str(tmp_path))
  flops = profiling.analytic_flops("qtopt_step", learner=learner,
                                   batch_size=batch,
                                   params=state.train_state.params)
  assert record["perf.flops_per_sec"] == pytest.approx(
      record["grad_steps_per_sec"] * flops, rel=1e-6)
  if peak:
    assert record["perf.mfu"] == pytest.approx(
        perf_lib.mfu_value(record["grad_steps_per_sec"], flops, PEAK),
        rel=1e-6)
  else:
    assert "perf.mfu" not in record  # no peak for a CPU


@pytest.mark.parametrize("pod", [False, True], ids=["single", "pod"])
def test_train_anakin_publishes_the_plane(tmp_path, monkeypatch, pod):
  monkeypatch.setenv("T2R_PEAK_FLOPS_OVERRIDE", str(PEAK))
  learner = _tiny_learner()
  batch = 16
  kwargs = dict(env_family="pose", num_envs=16, rollout_length=2,
                train_batches_per_iter=4, batch_size=batch,
                replay_capacity=128, max_train_steps=16, log_every_steps=8,
                save_checkpoints_steps=16, seed=0)
  if pod:
    kwargs.update(num_devices=1, pod_program="shard_map",
                  sharding_rules="qtopt")
  state = envs.train_anakin(learner=learner, model_dir=str(tmp_path),
                            **kwargs)
  record = _record(str(tmp_path))
  # Per-device count × D over peak × D, D = 1 here.
  flops = profiling.analytic_flops("qtopt_step", learner=learner,
                                   batch_size=batch,
                                   params=state.train_state.params)
  assert record["perf.mfu"] == pytest.approx(
      perf_lib.mfu_value(record["grad_steps_per_sec"], flops, PEAK, 1),
      rel=1e-6)


def test_train_eval_publishes_the_plane(tmp_path, monkeypatch):
  monkeypatch.setenv("T2R_PEAK_FLOPS_OVERRIDE", str(PEAK))
  model = MockT2RModel()
  train_eval.train_eval_model(
      model=model, model_dir=str(tmp_path),
      input_generator_train=RandomInputGenerator(batch_size=16),
      max_train_steps=20, log_every_steps=10, save_checkpoints_steps=20,
      eval_steps=0, device="cpu")
  record = _record(str(tmp_path))
  assert 0.0 <= record["stall_fraction"] <= 1.0
  assert 0.0 <= record["input_wait_fraction"] <= 1.0
  # The step's count on a batch of the generator's shapes.
  gen = RandomInputGenerator(batch_size=16)
  gen.set_specification_from_model(model, train_eval.Mode.TRAIN)
  features, labels = next(gen.create_dataset(train_eval.Mode.TRAIN))
  flat = lambda s: {k: torch.as_tensor(np.asarray(v))  # noqa: E731
                    for k, v in s.to_flat_dict().items()}
  flops = profiling.train_step_flops(
      train_eval.train_step_fn(model), model.create_train_state(
          0, device="cpu"),
      {"features": flat(features), "labels": flat(labels)}, ())
  assert flops > 0
  assert record["perf.flops_per_sec"] == pytest.approx(
      record["steps_per_sec"] * flops, rel=1e-6)
  assert record["perf.mfu"] == pytest.approx(
      record["perf.flops_per_sec"] / PEAK, rel=1e-6)


def test_registry_gauges_track_the_trainer(tmp_path):
  train_eval.train_eval_model(
      model=MockT2RModel(), model_dir=str(tmp_path),
      input_generator_train=RandomInputGenerator(batch_size=16),
      max_train_steps=10, log_every_steps=10, save_checkpoints_steps=10,
      device="cpu")
  gauges = tmetrics.registry().snapshot()["gauges"]
  record = _record(str(tmp_path))
  assert gauges["train.steps_per_sec"] == record["steps_per_sec"]
  assert gauges["train.stall_fraction"] == record["stall_fraction"]
  assert gauges["perf.device_time_fraction"] == (
      record["perf.device_time_fraction"])
