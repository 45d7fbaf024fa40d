"""The port's multi-tenant serving plane against the JAX package's.

Counterparts of `tests/test_serving_front.py` (`TestArena`,
`TestAdmission`, `TestFront`, `TestMultiTenantHotSwap`) and of
`tests/test_serving_router.py` (`TestObservationDedupCache`,
`TestSpeculativeCEM`), with port tenants on the CPU: tiny matmul models
(`x @ (scale · I)`: outputs name the tenant and its params generation)
for scheduling, budgeting and accounting, and QT-Opt CEM tenants at
test width for the answers themselves.

Where both packages can run one scripted sequence they must decide
alike (`TestDecisionsMatchJax`): admission verdicts and counters under
one injected clock, LRU eviction order and `stats()`, `observation_key`
digests (numpy and torch leaves), and `slo_report` numbers.

Time: the admission gates read `time.monotonic` and wait with
`time.sleep`; the `clock` fixture replaces both (for the JAX module too),
so no test waits on the wall clock for a token or a deadline.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tensor2robot_tpu.serving import admission as jax_admission  # noqa: E402
from tensor2robot_tpu.serving import arena as jax_arena  # noqa: E402
from tensor2robot_tpu.serving import dedup as jax_dedup  # noqa: E402
from tensor2robot_tpu.startup import compile_cache as jax_cache  # noqa: E402
from tensor2robot_tpu.telemetry import metrics as jax_tmetrics  # noqa: E402
from tensor2robot_tpu_torch.models.abstract_model import TrainState  # noqa: E402
from tensor2robot_tpu_torch.research.qtopt import (  # noqa: E402
    GraspingQModel,
    QTOptLearner,
)
from tensor2robot_tpu_torch.serving import (  # noqa: E402
    AdmissionController,
    BucketedServingEngine,
    MicroBatcher,
    ModelArena,
    ObservationDedupCache,
    RequestRejected,
    ServingFront,
    SpeculativeCEM,
    TenantPolicy,
    coalesce,
    observation_key,
)
from tensor2robot_tpu_torch.serving import arena as arena_lib  # noqa: E402
from tensor2robot_tpu_torch.serving.microbatcher import (  # noqa: E402
    dispatch_seed,
)
from tensor2robot_tpu_torch.specs import make_random_tensors  # noqa: E402
from tensor2robot_tpu_torch.startup import compile_cache  # noqa: E402
from tensor2robot_tpu_torch.telemetry import metrics as tmetrics  # noqa: E402

_REAL_SLEEP = time.sleep


@pytest.fixture(autouse=True)
def _isolate():
  tmetrics.reset_for_tests()
  jax_tmetrics.reset_for_tests()
  yield
  jax_cache.reset_compilation_cache_config()
  tmetrics.reset_for_tests()
  jax_tmetrics.reset_for_tests()


class _Clock:
  """`time.monotonic` that moves only when `time.sleep` is called."""

  def __init__(self):
    self.now = 1000.0
    self.slept = 0.0

  def monotonic(self):
    return self.now

  def sleep(self, seconds):
    self.now += max(float(seconds), 0.0)
    self.slept += max(float(seconds), 0.0)
    _REAL_SLEEP(0)  # yield the interpreter to other threads


@pytest.fixture
def clock(monkeypatch):
  c = _Clock()
  monkeypatch.setattr(time, "monotonic", c.monotonic)
  monkeypatch.setattr(time, "sleep", c.sleep)
  return c


def make_loader(scale, side=8, calls=None):
  """A tenant whose output is `x @ (scale · I)`."""
  def loader():
    if calls is not None:
      calls.append(scale)
    state = TrainState(step=0, params={"w": torch.eye(side) * scale},
                       batch_stats={})

    def fn(st, feats):
      return {"y": feats["x"] @ st.params["w"]}

    return fn, state, {"x": np.zeros((1, side), np.float32)}
  return loader


def jax_loader(scale, side=8):
  def loader():
    params = {"w": np.eye(side, dtype=np.float32) * scale}
    return (lambda st, feats: {"y": feats["x"] @ st["w"]}), params, {
        "x": np.zeros((1, side), np.float32)}
  return loader


def ones(n, side=8):
  return {"x": np.ones((n, side), np.float32)}


def make_front(admission=None, **kwargs):
  return ServingFront(ModelArena(budget_bytes=None, device="cpu"), admission,
                      **kwargs)


def park_dispatcher(front, tenant="slow"):
  """Parks the front's dispatcher inside `tenant`'s predict until the
  returned event is set (the tenant must be preloaded)."""
  engine = front.arena.engine(tenant)
  release = threading.Event()
  entered = threading.Event()
  orig_predict = engine.predict

  def blocking_predict(*args, **kwargs):
    entered.set()
    release.wait(timeout=30.0)
    return orig_predict(*args, **kwargs)

  engine.predict = blocking_predict
  parked = front.submit(tenant, ones(1))
  assert entered.wait(timeout=10.0)
  return release, parked


_TINY = dict(image_size=16, torso_filters=(8, 8), head_filters=(8, 8),
             dense_sizes=(16,), action_dim=3)
_CEM = dict(cem_population=16, cem_iterations=2, cem_elites=4)


def _cem_learner(cem_inference="bf16"):
  return QTOptLearner(GraspingQModel(device_dtype=torch.float32, **_TINY),
                      cem_inference=cem_inference, cem_select="fused",
                      device="cpu", **_CEM)


def cem_loader(learner, seed, cem_iterations=None):
  def loader():
    state = learner.create_state(seed=seed).train_state
    learner.ensure_calibrated(state)
    example = make_random_tensors(learner.observation_specification(),
                                  batch_size=1, seed=0)
    return (learner.build_policy(cem_iterations=cem_iterations), state,
            example)
  return loader


def _obs(learner, n, seed):
  return make_random_tensors(learner.observation_specification(),
                             batch_size=n, seed=seed).to_flat_dict()


class TestArena:

  def test_lru_eviction_at_budget(self):
    arena = ModelArena(budget_bytes=2 * 8 * 8 * 4, device="cpu")
    for tenant, scale in (("a", 1.0), ("b", 2.0), ("c", 3.0)):
      arena.register(tenant, make_loader(scale), max_batch=1)
    arena.engine("a")
    arena.engine("b")
    arena.engine("a")  # LRU touch: b is now least recent
    assert arena.resident_tenants() == ("b", "a")
    arena.engine("c")  # over budget: evicts b, not a
    assert set(arena.stats()["resident"]) == {"a", "c"}
    assert arena.evictions == 1
    assert arena.resident_bytes() <= arena.budget_bytes
    snap = tmetrics.registry().snapshot()
    assert snap["counters"]["serving.arena.evictions"] == 1.0
    assert snap["gauges"]["serving.arena.resident_models"] == 2.0

  def test_eviction_reload_builds_no_kernel(self):
    """The reload contract: an evicted tenant's reload captures its
    buckets again and builds no kernel (`cache_misses == 0`)."""
    arena = ModelArena(budget_bytes=None, device="cpu")
    arena.register("a", make_loader(5.0), max_batch=2)
    engine = arena.engine("a")
    np.testing.assert_allclose(engine.predict(ones(1))["y"], 5.0)
    assert arena.evict("a")
    reloaded = arena.engine("a")
    assert reloaded is not engine
    stats = arena.stats()
    assert stats["reloads"] == 1
    assert stats["reload_cache_misses"] == 0, stats
    assert stats["last_load"]["cache_misses"] == 0
    assert stats["last_load"]["captures"] == reloaded.compile_count == 2
    np.testing.assert_allclose(reloaded.predict(ones(2))["y"], 5.0)

  def test_compile_watch_counts_builds_and_hits(self):
    from tensor2robot_tpu_torch.ops import build as build_lib
    with compile_cache.CompileWatch() as outer:
      with compile_cache.CompileWatch() as inner:
        build_lib._notify("cem_select", True)
      build_lib._notify("cem_select", False)
    build_lib._notify("cem_select", True)  # no watch open: not counted
    assert (inner.cache_misses, inner.cache_hits) == (1, 0)
    assert (outer.cache_misses, outer.cache_hits) == (1, 1)
    snap = tmetrics.registry().snapshot()["counters"]
    assert snap["compile_cache.misses"] == 2.0
    assert snap["compile_cache.hits"] == 1.0
    assert compile_cache.cache_dir() == str(build_lib.BUILD_DIR)

  def test_cache_dir_other_than_the_build_dir_raises(self, tmp_path,
                                                     monkeypatch):
    """Another directory no longer raises: `ModelArena(cache_dir=...)`
    makes it the kernel build directory (`configure_compilation_cache`),
    and a later arena without one keeps it."""
    from tensor2robot_tpu_torch.ops import build as build_lib
    monkeypatch.setattr(build_lib, "BUILD_DIR", build_lib.BUILD_DIR)
    monkeypatch.setattr(compile_cache, "_configured_dir", None)
    ModelArena(cache_dir=compile_cache.cache_dir(), device="cpu")
    cache = tmp_path / "xla_cache"
    ModelArena(cache_dir=str(cache), device="cpu")
    assert cache.is_dir()
    assert compile_cache.cache_dir() == str(cache)
    assert build_lib.library_path("cem_select").parent == cache
    ModelArena(device="cpu")
    assert compile_cache.cache_dir() == str(cache)

  def test_arena_cache_dir_configures_the_build_dir_and_reloads_warm(
      self, tmp_path, monkeypatch):
    """The shipped `ModelArena.cache_dir` binding: the arena's build
    directory becomes that directory, a first load there may build, a
    reload records `cache_misses == 0`."""
    from tensor2robot_tpu_torch.ops import build as build_lib
    monkeypatch.setattr(build_lib, "BUILD_DIR", build_lib.BUILD_DIR)
    monkeypatch.setattr(compile_cache, "_configured_dir", None)
    monkeypatch.delenv(compile_cache.ENV_CACHE_DIR, raising=False)
    cache = str(tmp_path / "serving_cache")
    arena = ModelArena(budget_bytes=8 * 8 * 4, cache_dir=cache,
                       device="cpu")
    assert compile_cache.cache_dir() == cache
    for name, scale in (("a", 1.0), ("b", 2.0)):
      arena.register(name, make_loader(scale), max_batch=1)
    arena.engine("a").predict(ones(1))
    arena.engine("b").predict(ones(1))  # evicts a
    out = arena.engine("a").predict(ones(1))  # reloads a
    np.testing.assert_allclose(out["y"], 1.0)
    stats = arena.stats()
    assert stats["reloads"] >= 1 and stats["reload_cache_misses"] == 0

  def test_compilation_cache_env_var_is_a_default(self, tmp_path,
                                                  monkeypatch):
    from tensor2robot_tpu_torch.ops import build as build_lib
    monkeypatch.setattr(build_lib, "BUILD_DIR", build_lib.BUILD_DIR)
    monkeypatch.setattr(compile_cache, "_configured_dir", None)
    monkeypatch.delenv(compile_cache.ENV_CACHE_DIR, raising=False)
    before = compile_cache.cache_dir()
    assert compile_cache.configure_compilation_cache() is None
    assert compile_cache.cache_dir() == before
    monkeypatch.setenv(compile_cache.ENV_CACHE_DIR, str(tmp_path / "env"))
    assert compile_cache.configure_compilation_cache() == str(
        tmp_path / "env")
    explicit = str(tmp_path / "explicit")
    compile_cache.configure_compilation_cache(cache_dir=explicit)
    assert compile_cache.configure_compilation_cache() == explicit
    assert compile_cache.cache_dir() == explicit

  def test_single_tenant_over_budget_raises(self):
    arena = ModelArena(budget_bytes=16, device="cpu")
    arena.register("big", make_loader(1.0), max_batch=1)
    with pytest.raises(ValueError, match="budget"):
      arena.engine("big")

  def test_tenant_id_validation(self):
    arena = ModelArena(device="cpu")
    with pytest.raises(ValueError, match="reserved"):
      arena.register("arena", make_loader(1.0))
    with pytest.raises(ValueError, match="must match"):
      arena.register("bad.tenant", make_loader(1.0))
    with pytest.raises(KeyError):
      arena.engine("never_registered")
    arena.register("ok-tenant_1", make_loader(1.0))
    with pytest.raises(ValueError, match="already registered"):
      arena.register("ok-tenant_1", make_loader(1.0))
    assert arena_lib.RESERVED_TENANT_IDS == jax_arena.RESERVED_TENANT_IDS

  def test_swap_state_resident_vs_evicted(self):
    arena = ModelArena(device="cpu")
    arena.register("a", make_loader(1.0), max_batch=1)
    new_state = make_loader(9.0)()[1]
    assert not arena.swap_state("a", new_state)  # not resident yet
    engine = arena.engine("a")
    assert arena.swap_state("a", new_state, learner_step=7)
    np.testing.assert_allclose(engine.predict(ones(1))["y"], 9.0)
    assert engine.params_learner_step == 7
    with pytest.raises(KeyError):
      arena.swap_state("ghost", new_state)

  def test_released_engine_fails_fast_not_corrupt(self):
    arena = ModelArena(device="cpu")
    arena.register("a", make_loader(2.0), max_batch=1)
    stale = arena.engine("a")
    arena.evict("a")
    assert stale.released
    with pytest.raises(RuntimeError, match="released"):
      stale.predict(ones(1))
    with pytest.raises(RuntimeError, match="released"):
      stale.swap_state(make_loader(1.0)()[1])
    np.testing.assert_allclose(arena.engine("a").predict(ones(1))["y"], 2.0)

  def test_release_during_a_dispatch_keeps_its_buffers(self):
    """An eviction while a dispatch runs on another thread: the dispatch
    completes on the params it started with; later dispatches raise."""
    entered, proceed = threading.Event(), threading.Event()

    def loader():
      fn, state, example = make_loader(4.0)()

      def slow(st, feats):
        entered.set()
        assert proceed.wait(timeout=30.0)
        return fn(st, feats)

      return slow, state, example

    arena = ModelArena(device="cpu")
    arena.register("a", loader, max_batch=1, warmup=False)
    engine = arena.engine("a")
    result = {}
    worker = threading.Thread(
        target=lambda: result.update(out=engine.predict(ones(1))))
    worker.start()
    assert entered.wait(timeout=30.0)
    assert arena.evict("a") and engine.released
    proceed.set()
    worker.join(timeout=30.0)
    np.testing.assert_allclose(result["out"]["y"], 4.0)
    with pytest.raises(RuntimeError, match="released"):
      engine.predict(ones(1))

  def test_reload_uses_loader_fresh_state(self):
    calls = []
    arena = ModelArena(device="cpu")
    arena.register("a", make_loader(4.0, calls=calls), max_batch=1)
    arena.engine("a")
    arena.evict("a")
    arena.engine("a")
    assert calls == [4.0, 4.0]

  def test_async_cold_load_counts_one_miss_no_pickup_hit(self):
    arena = ModelArena(device="cpu")
    arena.register("a", make_loader(2.0), max_batch=1)
    engine, future = arena.engine_async("a")
    assert engine is None
    future.result(timeout=30.0)
    engine, future = arena.engine_async("a")  # the pickup re-touch
    assert engine is not None and future is None
    mid = tmetrics.registry().snapshot()["counters"]
    assert mid.get("serving.arena.misses", 0.0) == 1.0
    assert mid.get("serving.arena.hits", 0.0) == 0.0
    arena.engine_async("a")  # a real warm hit counts
    after = tmetrics.registry().snapshot()["counters"]
    assert after.get("serving.arena.hits", 0.0) == 1.0


class TestAdmission:

  def test_token_bucket_sheds_over_burst(self, clock):
    policy = TenantPolicy(rate_rps=0.01, burst=2, overflow="drop",
                          slo_ms=1000.0)
    with make_front() as front:
      front.register_tenant("a", make_loader(1.0), policy=policy,
                            max_batch=2, preload=True)
      futures = [front.submit("a", ones(1)) for _ in range(2)]
      with pytest.raises(RequestRejected) as exc:
        front.submit("a", ones(1))
      assert exc.value.reason == "rate" and exc.value.tenant == "a"
      for future in futures:
        np.testing.assert_allclose(future.result()["y"], 1.0)
    snap = tmetrics.registry().snapshot()
    assert snap["counters"]["serving.a.admission.dropped"] == 1.0
    assert snap["counters"]["serving.a.admission.shed_rate"] == 1.0
    assert snap["counters"]["serving.a.admission.admitted"] == 2.0

  def test_token_bucket_refills(self, clock):
    policy = TenantPolicy(rate_rps=200.0, burst=1, overflow="drop",
                          slo_ms=1000.0)
    with make_front() as front:
      front.register_tenant("a", make_loader(1.0), policy=policy,
                            max_batch=1, preload=True)
      front.predict("a", ones(1))
      with pytest.raises(RequestRejected):
        front.predict("a", ones(1))  # no time passed: no token
      time.sleep(0.05)  # the injected clock: ~10 tokens refill
      np.testing.assert_allclose(front.predict("a", ones(1))["y"], 1.0)

  def test_block_policy_waits_for_tokens(self, clock):
    policy = TenantPolicy(rate_rps=50.0, burst=1, overflow="block",
                          block_timeout_secs=5.0, slo_ms=1000.0)
    with make_front() as front:
      front.register_tenant("a", make_loader(1.0), policy=policy,
                            max_batch=1, preload=True)
      front.predict("a", ones(1))  # spends the burst
      slept = clock.slept
      np.testing.assert_allclose(front.predict("a", ones(1))["y"], 1.0)
      # One token at 50 rps: ~0.02 s of the injected clock (the gate
      # sleeps at least 1 ms a slice, so it may overshoot by one).
      assert 0.02 <= clock.slept - slept <= 0.0215

  def _front_with_stuck_dispatcher(self, policy):
    front = make_front()
    front.register_tenant("slow", make_loader(3.0),
                          policy=TenantPolicy(slo_ms=1000.0), preload=True)
    front.register_tenant("x", make_loader(1.0), policy=policy,
                          preload=True)
    release, slow_future = park_dispatcher(front)
    return front, release, slow_future

  def test_bounded_queue_drop_counts_and_rejects(self):
    policy = TenantPolicy(max_queue=2, overflow="drop", slo_ms=1000.0)
    front, release, slow_future = self._front_with_stuck_dispatcher(policy)
    try:
      queued = [front.submit("x", ones(1)) for _ in range(2)]
      with pytest.raises(RequestRejected) as exc:
        front.submit("x", ones(1))
      assert exc.value.reason == "queue_full"
    finally:
      release.set()
    for future in queued:
      np.testing.assert_allclose(future.result(timeout=30)["y"], 1.0)
    np.testing.assert_allclose(slow_future.result(timeout=30)["y"], 3.0)
    front.close()
    snap = tmetrics.registry().snapshot()
    assert snap["counters"]["serving.x.admission.shed_queue"] == 1.0
    assert snap["counters"]["serving.x.admission.dropped"] == 1.0

  def test_bounded_queue_block_deadline_drops(self, clock):
    policy = TenantPolicy(max_queue=1, overflow="block",
                          block_timeout_secs=0.3, slo_ms=1000.0)
    front, release, slow_future = self._front_with_stuck_dispatcher(policy)
    try:
      first = front.submit("x", ones(1))
      t0 = time.monotonic()
      with pytest.raises(RequestRejected) as exc:
        front.submit("x", ones(1))
      assert exc.value.reason == "queue_full"
      assert time.monotonic() - t0 == pytest.approx(0.3, abs=1e-9)
    finally:
      release.set()
    np.testing.assert_allclose(first.result(timeout=30)["y"], 1.0)
    slow_future.result(timeout=30)
    front.close()

  def test_burst_below_max_batch_rejected_at_registration(self):
    with make_front() as front:
      with pytest.raises(ValueError, match="burst"):
        front.register_tenant(
            "a", make_loader(1.0), max_batch=8,
            policy=TenantPolicy(rate_rps=100.0, burst=4))
      front.register_tenant(
          "b", make_loader(1.0), max_batch=8,
          policy=TenantPolicy(rate_rps=None, burst=1, slo_ms=1000.0))
    front = make_front(AdmissionController(rate_rps=100.0, burst=4,
                                           slo_ms=1000.0))
    try:
      with pytest.raises(ValueError, match="burst"):
        front.register_tenant("c", make_loader(1.0), max_batch=8)
      front.register_tenant("d", make_loader(1.0), max_batch=4)
    finally:
      front.close()

  def test_queue_shed_refunds_rate_tokens(self, clock):
    controller = AdmissionController()
    controller.register("t", TenantPolicy(rate_rps=0.001, burst=2,
                                          slo_ms=100.0))
    assert controller.admit("t", 2)
    assert not controller.admit("t", 2)
    controller.queue_full("t", 2)
    assert controller.admit("t", 2)
    assert ("serving.t.admission.admitted"
            not in tmetrics.registry().snapshot()["counters"])
    controller.count_admitted("t", 2)
    snap = tmetrics.registry().snapshot()["counters"]
    assert snap["serving.t.admission.admitted"] == 2.0
    assert snap["serving.t.admission.shed_rate"] == 2.0
    assert snap["serving.t.admission.shed_queue"] == 2.0
    assert snap["serving.t.admission.dropped"] == 4.0

  def test_close_during_block_wait_counts_shed(self, clock):
    """A close() racing a queue-full block wait still accounts the
    request (refund + shed counters) before failing fast."""
    policy = TenantPolicy(max_queue=1, overflow="block",
                          block_timeout_secs=None, slo_ms=1000.0)
    front, release, slow_future = self._front_with_stuck_dispatcher(policy)
    first = front.submit("x", ones(1))  # fills the queue
    outcome = {}
    waiting = threading.Event()
    sleep = clock.sleep

    def noting_sleep(seconds):
      waiting.set()
      sleep(seconds)

    clock.sleep = noting_sleep
    time.sleep = noting_sleep

    def blocked_submit():
      try:
        front.submit("x", ones(1))
        outcome["kind"] = "enqueued"
      except RequestRejected:
        outcome["kind"] = "rejected"
      except RuntimeError:
        outcome["kind"] = "closed"

    submitter = threading.Thread(target=blocked_submit)
    submitter.start()
    assert waiting.wait(timeout=30)  # parked in the deadline_slices wait
    closer = threading.Thread(target=front.close)
    closer.start()
    while not front._stop.is_set():
      _REAL_SLEEP(0)
    release.set()
    closer.join(timeout=30)
    submitter.join(timeout=30)
    assert outcome["kind"] == "closed", outcome
    snap = tmetrics.registry().snapshot()["counters"]
    assert snap["serving.x.admission.shed_queue"] == 1.0
    assert snap["serving.x.admission.dropped"] == 1.0
    np.testing.assert_allclose(first.result(timeout=30)["y"], 1.0)
    slow_future.result(timeout=30)

  def test_slo_report_keys_on_bucket_histograms(self):
    controller = AdmissionController(slo_ms=10.0)
    controller.register("a")
    controller.register("b", TenantPolicy(slo_ms=1.0))
    bounds = (1.0, 10.0, 100.0)
    hist_a1 = tmetrics.histogram("serving.a.bucket_1_ms", bounds=bounds)
    hist_a2 = tmetrics.histogram("serving.a.bucket_2_ms", bounds=bounds)
    for value in (0.5, 5.0):
      hist_a1.observe(value)
    hist_a2.observe(50.0)
    tmetrics.histogram("serving.b.bucket_1_ms", bounds=bounds)
    e2e = tmetrics.histogram("serving.a.request_ms", bounds=bounds)
    for value in (0.5, 50.0, 50.0, 50.0):
      e2e.observe(value)
    report = controller.slo_report()
    assert report["a"]["count"] == 3 and report["a"]["slo_ms"] == 10.0
    assert report["a"]["in_slo_fraction"] == pytest.approx(2 / 3, abs=1e-3)
    assert report["a"]["p50_ms"] <= 10.0 < report["a"]["p99_ms"]
    assert report["a"]["e2e_count"] == 4
    assert report["a"]["e2e_in_slo_fraction"] == pytest.approx(0.25,
                                                               abs=1e-3)
    assert report["a"]["e2e_p95_ms"] > report["a"]["p95_ms"]
    assert report["b"]["count"] == 0 and "e2e_count" not in report["b"]

  def test_slo_report_overflow_bucket_is_honest(self):
    controller = AdmissionController()
    controller.register("t", TenantPolicy(slo_ms=200.0))
    hist = tmetrics.histogram("serving.t.bucket_1_ms",
                              bounds=(1.0, 10.0, 100.0))
    hist.observe(0.5)
    hist.observe(50_000.0)
    report = controller.slo_report()
    assert report["t"]["in_slo_fraction"] == pytest.approx(0.5)
    assert report["t"]["p99_ms"] == pytest.approx(50_000.0)
    controller2 = AdmissionController()
    controller2.register("u", TenantPolicy(slo_ms=1e9))
    tmetrics.histogram("serving.u.bucket_1_ms",
                       bounds=(1.0, 10.0)).observe(500.0)
    assert (controller2.slo_report()["u"]["in_slo_fraction"]
            == pytest.approx(1.0))

  def test_claim_batch_tolerates_finished_futures(self):
    from concurrent.futures import Future

    class Req:
      def __init__(self):
        self.future = Future()
        self.n = 1
        self.features = {"x": np.zeros((1, 2), np.float32)}

    live, cancelled, failed = Req(), Req(), Req()
    cancelled.future.cancel()
    failed.future.set_exception(RuntimeError("closed before dispatch"))
    assert coalesce.claim_batch([live, cancelled, failed]) == [live]

  def test_retune_rebuilds_the_bucket(self, clock):
    controller = AdmissionController()
    controller.register("t", TenantPolicy(rate_rps=10.0, burst=4))
    assert controller.admit("t", 4)
    policy = controller.retune("t", factor=0.5)
    assert policy.rate_rps == 5.0 and policy.burst == 4
    assert controller.admit("t", 4)  # a fresh bucket holds a full burst
    assert controller.retune("t", rate_rps=None).rate_rps is None
    assert controller.admit("t", 1000)
    with pytest.raises(KeyError):
      controller.retune("ghost", factor=2.0)


class TestFront:

  def test_cross_tenant_results_are_exact(self):
    with make_front() as front:
      front.register_tenant("a", make_loader(2.0), max_batch=4, preload=True)
      front.register_tenant("b", make_loader(10.0), max_batch=4,
                            preload=True)
      barrier = threading.Barrier(8)
      results = {}

      def caller(index, tenant, scale):
        feats = {"x": np.full((1, 8), float(index), np.float32)}
        barrier.wait()
        results[index] = (front.predict(tenant, feats), scale, index)

      threads = [threading.Thread(
          target=caller, args=(i, "a" if i % 2 else "b",
                               2.0 if i % 2 else 10.0)) for i in range(8)]
      for thread in threads:
        thread.start()
      for thread in threads:
        thread.join(timeout=60)
      assert len(results) == 8
      for out, scale, index in results.values():
        np.testing.assert_allclose(out["y"], scale * index)
      assert set(front.dispatches_per_tenant) == {"a", "b"}
      assert front._work.qsize() <= 1

  def test_cold_tenant_load_never_blocks_other_tenants(self):
    gate, entered = threading.Event(), threading.Event()
    base_loader = make_loader(3.0)

    def cold_loader():
      entered.set()
      gate.wait(timeout=30.0)
      return base_loader()

    front = make_front()
    front.register_tenant("cold", cold_loader,
                          policy=TenantPolicy(slo_ms=1000.0))
    front.register_tenant("b", make_loader(1.0), preload=True)
    try:
      cold_future = front.submit("cold", ones(1))
      assert entered.wait(timeout=10.0)
      for _ in range(10):
        np.testing.assert_allclose(front.predict("b", ones(1))["y"], 1.0)
      assert not cold_future.done()
    finally:
      gate.set()
    np.testing.assert_allclose(cold_future.result(timeout=30)["y"], 3.0)
    front.close()

  def test_cold_cem_load_races_dispatches(self):
    """A CEM tenant's engine builds and warms up on the arena's thread
    while the dispatcher serves another CEM tenant; both answer."""
    learner = _cem_learner()
    front = make_front(seed=3)
    front.register_tenant("warm", cem_loader(learner, 0), takes_rng=True,
                          max_batch=2, preload=True)
    front.register_tenant("cold", cem_loader(learner, 1), takes_rng=True,
                          max_batch=2)
    try:
      cold = front.submit("cold", _obs(learner, 1, 5))
      warm = [front.predict("warm", _obs(learner, 1, 6 + i))
              for i in range(4)]
      for action in warm + [cold.result(timeout=120)]:
        assert action.shape == (1, 3) and np.all(np.abs(action) <= 1.0)
    finally:
      front.close()

  def test_failed_load_fails_queued_requests_and_submit_retries(self):
    calls = []

    def flaky_loader():
      calls.append(1)
      if len(calls) == 1:
        raise RuntimeError("flaky loader boom")
      return make_loader(2.0)()

    front = make_front()
    front.register_tenant("f", flaky_loader,
                          policy=TenantPolicy(slo_ms=1000.0))
    doomed = front.submit("f", ones(1))
    with pytest.raises(RuntimeError, match="flaky loader boom"):
      doomed.result(timeout=30)
    np.testing.assert_allclose(front.predict("f", ones(1))["y"], 2.0)
    front.close()

  def test_round_robin_fair_share(self):
    front = make_front()
    front.register_tenant("slow", make_loader(1.0),
                          policy=TenantPolicy(slo_ms=1000.0), preload=True)
    front.register_tenant("a", make_loader(1.0), max_batch=2, preload=True)
    front.register_tenant("b", make_loader(2.0), max_batch=2, preload=True)
    order = []

    def track(tenant):
      return lambda _: order.append(tenant)

    release, stuck = park_dispatcher(front)
    try:
      futures = []
      for tenant, count in (("a", 6), ("b", 2)):
        for _ in range(count):
          future = front.submit(tenant, ones(1))
          future.add_done_callback(track(tenant))
          futures.append(future)
    finally:
      release.set()
    for future in futures:
      future.result(timeout=30)
    stuck.result(timeout=30)
    front.close()
    last_a = len(order) - 1 - order[::-1].index("a")
    assert order.index("b") < last_a, order

  def test_cancelled_request_never_poisons_co_batched_callers(self):
    front = make_front()
    front.register_tenant("slow", make_loader(1.0),
                          policy=TenantPolicy(slo_ms=1000.0), preload=True)
    front.register_tenant("x", make_loader(5.0), max_batch=4, preload=True)
    release, stuck = park_dispatcher(front)
    try:
      before = front.submit("x", ones(1))
      doomed = front.submit("x", ones(1))
      after = front.submit("x", ones(1))
      assert doomed.cancel()
    finally:
      release.set()
    np.testing.assert_allclose(before.result(timeout=30)["y"], 5.0)
    np.testing.assert_allclose(after.result(timeout=30)["y"], 5.0)
    assert doomed.cancelled()
    stuck.result(timeout=30)
    front.close()

  def test_microbatcher_tolerates_cancelled_requests(self):
    fn, state, example = make_loader(3.0, side=4)()
    engine = BucketedServingEngine(fn, state, example, max_batch=4,
                                   device="cpu")
    engine.warmup()
    with MicroBatcher(engine, max_wait_us=100_000) as batcher:
      first = batcher.submit(ones(1, side=4))
      second = batcher.submit(ones(1, side=4))
      won = second.cancel()
      np.testing.assert_allclose(first.result(timeout=30)["y"], 3.0)
      if won:
        assert second.cancelled()
      else:
        np.testing.assert_allclose(second.result(timeout=30)["y"], 3.0)

  def test_submit_after_close_fails_fast(self):
    front = make_front()
    front.register_tenant("a", make_loader(1.0), preload=True)
    front.predict("a", ones(1))
    front.close()
    with pytest.raises(RuntimeError, match="closed"):
      front.submit("a", ones(1))

  def test_unknown_tenant_and_oversized_request(self):
    with make_front() as front:
      front.register_tenant("a", make_loader(1.0), max_batch=2, preload=True)
      with pytest.raises(KeyError):
        front.submit("ghost", ones(1))
      with pytest.raises(ValueError, match="max_batch"):
        front.submit("a", ones(3))

  def test_single_request_dispatch_equals_the_engine_bit_for_bit(self):
    """Tenant i's dispatch d draws from `dispatch_seed(seed + i, d)`: a
    single-request dispatch's action equals `engine.predict` with that
    generator, bit for bit; distinct dispatches draw distinct noise."""
    learner = _cem_learner()
    seed = 11
    with make_front(seed=seed) as front:
      front.register_tenant("first", cem_loader(learner, 0), takes_rng=True,
                            max_batch=2, preload=True)
      front.register_tenant("cem", cem_loader(learner, 1), takes_rng=True,
                            max_batch=2, preload=True)
      obs = _obs(learner, 1, 9)
      answers = [front.predict("cem", obs) for _ in range(3)]
      engine = front.arena.engine("cem")
      for d, answer in enumerate(answers):
        generator = torch.Generator().manual_seed(dispatch_seed(seed + 1, d))
        np.testing.assert_array_equal(answer,
                                      engine.predict(obs, generator=generator))
      assert not np.array_equal(answers[0], answers[1])

  def test_int8_tenant_serves(self):
    learner = _cem_learner(cem_inference="int8")
    with make_front(seed=0) as front:
      front.register_tenant("i8", cem_loader(learner, 0), takes_rng=True,
                            max_batch=2, preload=True)
      action = front.predict("i8", _obs(learner, 2, 4))
    assert not learner.needs_calibration
    assert action.shape == (2, 3) and np.all(np.abs(action) <= 1.0)

  def test_completion_metrics_published(self):
    with make_front() as front:
      front.register_tenant("a", make_loader(1.0),
                            policy=TenantPolicy(slo_ms=60_000.0),
                            preload=True)
      for _ in range(3):
        front.predict("a", ones(1))
    snap = tmetrics.registry().snapshot()
    assert snap["counters"]["serving.a.completions"] == 3.0
    assert snap["counters"]["serving.a.slo_ok"] == 3.0
    assert snap["histograms"]["serving.a.request_ms"]["count"] == 3
    assert snap["counters"]["serving.a.dispatches"] == 3.0
    assert any(name.startswith("serving.a.bucket_")
               for name in snap["histograms"])


class TestMultiTenantHotSwap:

  def test_swap_a_never_stalls_or_recaptures_b(self):
    with make_front() as front:
      front.register_tenant("a", make_loader(1.0), max_batch=2, preload=True)
      front.register_tenant("b", make_loader(100.0), max_batch=2,
                            preload=True)
      front.predict("b", ones(1))
      engines = {t: front.arena.engine(t) for t in ("a", "b")}
      captures = {t: e.compile_count for t, e in engines.items()}
      stop = threading.Event()
      b_outputs, b_errors = [], []

      def b_traffic():
        while not stop.is_set():
          try:
            b_outputs.append(float(front.predict("b", ones(1))["y"][0, 0]))
          except Exception as exc:  # noqa: BLE001 — the pin IS no-error
            b_errors.append(exc)
            return

      threads = [threading.Thread(target=b_traffic) for _ in range(2)]
      for thread in threads:
        thread.start()
      while len(b_outputs) < 3 and not b_errors:
        _REAL_SLEEP(0)
      served_before = len(b_outputs)
      for generation in range(2, 7):
        assert front.arena.swap_state("a", make_loader(float(generation))()[1],
                                      learner_step=generation)
        np.testing.assert_allclose(front.predict("a", ones(1))["y"],
                                   float(generation))
      while len(b_outputs) < served_before + 6 and not b_errors:
        _REAL_SLEEP(0)
      stop.set()
      for thread in threads:
        thread.join(timeout=30)
      assert not b_errors, b_errors[:1]
      assert all(value == 100.0 for value in b_outputs)
      assert {t: e.compile_count for t, e in engines.items()} == captures


class TestObservationDedupCache:

  def _obs(self, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"img": rng.random((4, 4)).astype(dtype),
            "pose": rng.random(3).astype(dtype)}

  def test_hit_is_bitwise_equal_to_uncached_path(self):
    calls = []

    def engine(obs):
      calls.append(1)
      return np.asarray([obs["pose"].sum()], np.float64)

    cache = ObservationDedupCache(capacity=8)
    obs = self._obs(0)
    key = cache.key(obs)
    uncached = engine(obs)
    cache.put(key, 0, uncached)
    hit = cache.get(key, 0)
    assert hit is uncached
    assert hit.tobytes() == engine(obs).tobytes()
    assert len(calls) == 2

  def test_get_is_version_keyed(self):
    cache = ObservationDedupCache(capacity=8)
    cache.put("k", 3, "action-v3")
    assert cache.get("k", 3) == "action-v3"
    assert cache.get("k", 4) is None
    assert cache.stats()["misses"] == 1

  def test_invalidate_on_publish(self):
    cache = ObservationDedupCache(capacity=8)
    cache.put("old", 1, "a")
    cache.put("new", 2, "b")
    assert cache.invalidate(2) == 1
    assert cache.get("new", 2) == "b"
    assert cache.get("old", 1) is None
    assert cache.invalidate(None) == 1
    assert cache.stats()["size"] == 0

  def test_lru_bound_and_eviction(self):
    cache = ObservationDedupCache(capacity=3)
    for i in range(5):
      cache.put(f"k{i}", 0, i)
    stats = cache.stats()
    assert stats["size"] == 3 and stats["evictions"] == 2
    assert cache.get("k0", 0) is None
    assert cache.get("k4", 0) == 4

  def test_quantization_absorbs_float_jitter(self):
    obs = self._obs(1)
    jittered = {k: v + 1e-4 for k, v in obs.items()}
    moved = {k: v + 0.5 for k, v in obs.items()}
    assert observation_key(obs) == observation_key(jittered)
    assert observation_key(obs) != observation_key(moved)

  def test_key_covers_names_dtypes_shapes(self):
    a = {"x": np.zeros(4, np.float32)}
    assert observation_key(a) != observation_key(
        {"y": np.zeros(4, np.float32)})
    assert observation_key(a) != observation_key(
        {"x": np.zeros(4, np.int32)})
    assert observation_key(a) != observation_key(
        {"x": np.zeros((2, 2), np.float32)})
    assert observation_key(a) == observation_key(dict(a))


class _Gate:
  """A full_predict fake whose dispatch blocks until released."""

  def __init__(self, result):
    self.release = threading.Event()
    self.dispatched = threading.Event()
    self.result = result

  def __call__(self, obs):
    self.dispatched.set()
    assert self.release.wait(10.0)
    return self.result


class TestSpeculativeCEM:

  OBS = {"img": np.ones((2, 2), np.float32)}
  FAST = np.array([1.0])
  FULL = np.array([2.0])

  def test_fast_then_refined(self):
    spec = SpeculativeCEM(fast_predict=lambda obs: self.FAST,
                          full_predict=lambda obs: self.FULL,
                          version_fn=lambda: 0)
    try:
      assert spec.predict(self.OBS) is self.FAST
      assert spec.flush(timeout_secs=30)
      assert spec.predict(self.OBS) is self.FULL
      stats = spec.stats()
      assert stats["fast_served"] == 1 and stats["refined_served"] == 1
    finally:
      spec.close()

  def test_refinement_never_crosses_version_swap(self):
    version = {"v": 0}
    gate = _Gate(self.FULL)
    spec = SpeculativeCEM(fast_predict=lambda obs: self.FAST,
                          full_predict=gate, version_fn=lambda: version["v"])
    try:
      assert spec.predict(self.OBS) is self.FAST
      assert gate.dispatched.wait(10.0)
      version["v"] = 1
      gate.release.set()
      assert spec.flush(timeout_secs=30)
      assert spec.stats()["refine_discarded"] == 1
      assert spec.predict(self.OBS) is self.FAST
      assert spec.stats()["refined_served"] == 0
      assert spec.stats()["refines"] == 0
    finally:
      gate.release.set()
      spec.close()

  def test_queued_refinement_discarded_on_version_swap(self):
    version = {"v": 0}
    gate = _Gate(self.FULL)
    spec = SpeculativeCEM(fast_predict=lambda obs: self.FAST,
                          full_predict=gate, version_fn=lambda: version["v"])
    try:
      spec.predict(self.OBS)
      assert gate.dispatched.wait(10.0)
      spec.predict({"img": np.zeros((2, 2), np.float32)})
      version["v"] = 1
      gate.release.set()
      assert spec.flush(timeout_secs=30)
      assert spec.stats()["refine_discarded"] == 2
      assert spec.stats()["refines"] == 0
    finally:
      gate.release.set()
      spec.close()

  def test_on_publish_clears_refined_cache(self):
    version = {"v": 0}
    spec = SpeculativeCEM(fast_predict=lambda obs: self.FAST,
                          full_predict=lambda obs: self.FULL,
                          version_fn=lambda: version["v"])
    try:
      spec.predict(self.OBS)
      assert spec.flush(timeout_secs=30)
      assert spec.predict(self.OBS) is self.FULL
      version["v"] = 1
      spec.on_publish(1)
      assert spec.predict(self.OBS) is self.FAST
    finally:
      spec.close()

  def test_refine_overflow_drops_without_blocking(self):
    gate = _Gate(self.FULL)
    spec = SpeculativeCEM(fast_predict=lambda obs: self.FAST,
                          full_predict=gate, version_fn=lambda: 0,
                          refine_queue=1)
    try:
      for i in range(4):
        obs = {"img": np.full((2, 2), float(i), np.float32)}
        assert spec.predict(obs) is self.FAST
      assert spec.stats()["refine_dropped"] >= 1
    finally:
      gate.release.set()
      spec.close()

  def test_over_cem_engines(self):
    """Over two port engines (the 1-iteration and the full CEM over the
    same params): a repeated observation gets the refined answer, equal
    to the full engine's answer under that version; after a swap of
    both engines no refined answer from before is served."""
    learner = _cem_learner()
    states = [learner.create_state(seed=s).train_state for s in (0, 1)]
    example = make_random_tensors(learner.observation_specification(),
                                  batch_size=1, seed=0)
    fast = BucketedServingEngine(learner.build_policy(cem_iterations=1),
                                 states[0], example, max_batch=1,
                                 takes_rng=True, device="cpu")
    full = BucketedServingEngine(learner.build_policy(), states[0], example,
                                 max_batch=1, takes_rng=True, device="cpu")
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    spec = SpeculativeCEM(
        fast_predict=lambda obs: fast.predict(obs, generator=gen()),
        full_predict=lambda obs: full.predict(obs, generator=gen()),
        version_fn=lambda: full.params_version)
    obs = _obs(learner, 1, 3)
    try:
      first = spec.predict(obs)
      np.testing.assert_array_equal(first, fast.predict(obs,
                                                        generator=gen()))
      assert spec.flush(timeout_secs=60)
      refined = spec.predict(obs)
      np.testing.assert_array_equal(refined,
                                    full.predict(obs, generator=gen()))
      assert spec.stats()["refined_served"] == 1
      for engine in (fast, full):
        engine.swap_state(states[1])
      spec.on_publish(full.params_version)
      after = spec.predict(obs)
      np.testing.assert_array_equal(after, fast.predict(obs,
                                                        generator=gen()))
      assert spec.stats()["refined_served"] == 1
    finally:
      spec.close()


class TestDecisionsMatchJax:
  """One scripted sequence through both packages: the same decisions."""

  def test_admission_verdicts_match_jax(self, clock):
    policies = {
        "a": dict(rate_rps=20.0, burst=4, overflow="drop"),
        "b": dict(rate_rps=5.0, burst=2, overflow="block",
                  block_timeout_secs=0.1),
        "c": dict(rate_rps=None, burst=1),
    }
    controllers = {}
    for name, mod in (("port", None), ("jax", jax_admission)):
      ctrl = (AdmissionController() if mod is None
              else mod.AdmissionController())
      policy_cls = TenantPolicy if mod is None else mod.TenantPolicy
      for tenant, kwargs in policies.items():
        ctrl.register(tenant, policy_cls(slo_ms=50.0, **kwargs))
      controllers[name] = ctrl
    rng = np.random.default_rng(0)
    script = [(float(rng.choice([0.0, 0.01, 0.05, 0.2])),
               str(rng.choice(["a", "b", "c"])), int(rng.integers(1, 4)),
               bool(rng.random() < 0.2)) for _ in range(200)]
    verdicts = {}
    for name, ctrl in controllers.items():
      clock.now, out = 1000.0, []
      # Each controller starts its buckets full at the same clock.
      for tenant in policies:
        ctrl._buckets.pop(tenant, None)
      for dt, tenant, rows, queue_full in script:
        time.sleep(dt)
        admitted = ctrl.admit(tenant, rows)
        if admitted and queue_full:
          ctrl.queue_full(tenant, rows)
        elif admitted:
          ctrl.count_admitted(tenant, rows)
        out.append((admitted, round(clock.now, 9)))
      verdicts[name] = out
    assert verdicts["port"] == verdicts["jax"]
    assert 0 < sum(v for v, _ in verdicts["port"]) < len(script)
    port = tmetrics.registry().snapshot()["counters"]
    ref = jax_tmetrics.registry().snapshot()["counters"]
    assert port == ref

  def test_arena_lru_and_stats_match_jax(self, tmp_path):
    arenas = {
        "port": (ModelArena(budget_bytes=2 * 8 * 8 * 4, device="cpu"),
                 make_loader),
        "jax": (jax_arena.ModelArena(budget_bytes=2 * 8 * 8 * 4,
                                     cache_dir=str(tmp_path / "cache")),
                jax_loader),
    }
    script = ["a", "b", "a", "c", "b", "b", ("evict", "c"), "a", "c",
              ("swap", "b"), ("swap", "a")]
    trace = {}
    for name, (arena, loader) in arenas.items():
      for tenant, scale in (("a", 1.0), ("b", 2.0), ("c", 3.0)):
        arena.register(tenant, loader(scale), max_batch=1)
      steps = []
      for item in script:
        if isinstance(item, tuple) and item[0] == "evict":
          steps.append(("evict", arena.evict(item[1])))
        elif isinstance(item, tuple):
          state = loader(7.0)()[1]
          steps.append(("swap", arena.swap_state(item[1], state)))
        else:
          out = arena.engine(item).predict(ones(1))
          steps.append((item, float(out["y"][0, 0])))
        steps.append(arena.resident_tenants())
      stats = arena.stats()
      last = stats.pop("last_load")
      trace[name] = (steps, stats, last["tenant"], last["reload"],
                     last["cache_misses"])
    assert trace["port"] == trace["jax"]
    assert trace["port"][1]["evictions"] >= 2

  def test_observation_key_matches_jax(self):
    rng = np.random.default_rng(2)
    observations = [
        {"image": rng.integers(0, 256, (1, 16, 16, 3), dtype=np.uint8),
         "height": rng.random((1, 1)).astype(np.float32)},
        {"x": np.zeros(4, np.float32)},
        {"x": np.arange(6, dtype=np.int32).reshape(2, 3),
         "flag": np.array([True, False])},
        {"pose": rng.standard_normal(3)},
    ]
    for obs in observations:
      for scale in (256.0, 1.0):
        want = jax_dedup.observation_key(obs, scale)
        assert observation_key(obs, scale) == want
        as_torch = {k: torch.from_numpy(np.array(v)) for k, v in obs.items()}
        assert observation_key(as_torch, scale) == want
    # Pinned digest: one fixed observation, the JAX package's sha256.
    pinned = {"image": np.zeros((1, 2, 2, 3), np.uint8),
              "height": np.full((1, 1), 0.5, np.float32)}
    assert observation_key(pinned) == jax_dedup.observation_key(pinned)
    assert observation_key(pinned) == (
        "e4e4b16230f2cd00bcc87a5781b9e1c82fb30fcbccdc2e7b34e7ed5ec48a2640")

  def test_slo_report_matches_jax(self):
    rng = np.random.default_rng(4)
    reports = {}
    for name, ctrl, tm in (
        ("port", AdmissionController(slo_ms=5.0), tmetrics),
        ("jax", jax_admission.AdmissionController(slo_ms=5.0),
         jax_tmetrics)):
      ctrl.register("a")
      ctrl.register("b")
      rng = np.random.default_rng(4)
      for tenant in ("a", "b"):
        for bucket in (1, 2, 4, 8):
          hist = tm.histogram(f"serving.{tenant}.bucket_{bucket}_ms")
          for value in np.exp(rng.uniform(-3, 6, 50)):
            hist.observe(float(value))
        e2e = tm.histogram(f"serving.{tenant}.request_ms")
        for value in np.exp(rng.uniform(-2, 8, 80)):
          e2e.observe(float(value))
      reports[name] = ctrl.slo_report()
    assert reports["port"] == reports["jax"]
    assert reports["port"]["a"]["count"] == 200
