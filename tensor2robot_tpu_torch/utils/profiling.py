"""FLOPs, peak rates and device memory for the live MFU gauges (port of
`utils/profiling.py`'s analytic half).

  * `PEAK_BF16_FLOPS` / `device_peak_flops`: the card's dense bf16 peak,
    matched by a substring of `torch.cuda.get_device_name`;
    ``T2R_PEAK_FLOPS_OVERRIDE`` overrides it (the JAX package's meaning);
    an unknown device, the CPU among them, has none, so no ``perf.mfu``
    is published there.
  * `analytic_flops`: the JAX package's analytic model-FLOPs count,
    arithmetic for arithmetic ("attention"; "qtopt_step" over the port's
    learner), and `qtopt_step_flops`, the trainers' entry point.
  * `train_step_flops`: the generic trainer's count. The JAX trainer
    divides XLA's cost analysis of its compiled K-step program by K; the
    port has no compiler to ask, so it runs one eager step on the first
    batch under a dispatch mode that adds `torch.utils.flop_counter`'s
    formulas (what `FlopCounterMode` counts), with each causal attention
    call counted analytically instead, its backward at 2.5× its forward,
    whatever backend `attention_impl` picks on whichever device.
  * `device_memory_source`: a `telemetry.perf.ResourceSampler` source
    of the caching allocator's bytes in use per card.
  * `trace`, `step_annotation` and `ProfilerHook`: `torch.profiler`
    traces (CPU and CUDA activities) written as chrome traces,
    `<logdir>/<host>_<pid>.<ns>.pt.trace.json`, which `utils/xplane.py`
    reads (the JAX package's `jax.profiler` traces and XPlane protos).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import threading
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.hooks.hook import Hook
from tensor2robot_tpu_torch.telemetry import perf as perf_lib

log = logging.getLogger(__name__)

# Dense (no sparsity) bf16 tensor-core peak per card, FLOP/s, from
# NVIDIA's H100 datasheet, keyed by lower-case substrings of the CUDA
# device name, most specific first: the PCIe card's name carries "pcie";
# the SXM5 card's is "NVIDIA H100 80GB HBM3".
PEAK_BF16_FLOPS = {
    "h100 pcie": 756e12,
    "h100": 989.4e12,
}

# The backward of attention is five products against the forward's two.
ATTENTION_BACKWARD_FACTOR = 2.5


def device_peak_flops(device: Any = None) -> Optional[float]:
  """The dense bf16 peak FLOP/s of `device` (None = the current CUDA
  card, if any); None when unknown. ``T2R_PEAK_FLOPS_OVERRIDE``
  overrides the table."""
  override = os.environ.get("T2R_PEAK_FLOPS_OVERRIDE")
  if override:
    try:
      return float(override)
    except ValueError:
      log.warning("ignoring unparseable T2R_PEAK_FLOPS_OVERRIDE=%r",
                  override)
  if device is None:
    if not torch.cuda.is_available():
      return None
    device = torch.device("cuda", torch.cuda.current_device())
  device = torch.device(device)
  if device.type != "cuda":
    return None
  name = torch.cuda.get_device_name(device).lower()
  for key, peak in PEAK_BF16_FLOPS.items():
    if key in name:
      return peak
  return None


def mfu(steps_per_sec: float, flops_per_step: Optional[float],
        device: Any = None) -> Optional[float]:
  """Model FLOPs utilization of `device`; None when unknowable. The
  arithmetic is `telemetry.perf.mfu_value`'s, the live gauges' own."""
  return perf_lib.mfu_value(steps_per_sec, flops_per_step,
                            device_peak_flops(device))


def _same_conv_taps(h: int, k: int, s: int):
  """(out_size, valid_taps) of one spatial dim of a SAME conv: border
  outputs whose window overlaps the padding count fewer taps, as XLA's
  cost analysis counts them."""
  pad_total = max(k - (s if h % s == 0 else h % s), 0)
  pad_low = pad_total // 2
  out = -(-h // s)
  taps = sum(min(i * s - pad_low + k, h) - max(i * s - pad_low, 0)
             for i in range(out))
  return out, taps


def analytic_flops(kind: str, **kw):
  """The analytic model-FLOPs count: model FLOPs from shapes, the same
  whatever dtype, tower or kernel computes them.

  kinds:
    "attention": the attention forward, kw b, heads, d, t, causal
      (4·B·H·D·T², halved when causal).
    "qtopt_step": one Bellman step, kw learner, batch_size and
      optionally params (the optimizer's and Polyak's elementwise tail):
      the CEM target (encode once, then per iteration the population
      through the linearity-split head), the critic forward and its
      backward (2× the forward), and 14 FLOPs a parameter.
  """
  if kind == "attention":
    flops = 4 * kw["b"] * kw["heads"] * kw["d"] * kw["t"] * kw["t"]
    return flops / 2 if kw.get("causal", True) else flops

  if kind != "qtopt_step":
    raise ValueError(f"unknown analytic_flops kind {kind!r}")
  learner = kw["learner"]
  batch = kw["batch_size"]
  model = learner.model
  with torch.device("meta"):
    net = model.create_network()
  s2d = net.space_to_depth
  h = model.image_size // max(s2d, 1)
  cin = 3 * max(s2d, 1) ** 2

  def conv_flops(n, h_in, k, s, ci, co):
    out, taps = _same_conv_taps(h_in, k, s)
    return out, 2 * n * taps * taps * ci * co

  def seq_convs(n, h_in, ci, filters, first_stride):
    """Conv stack FLOPs + BN/relu elementwise; returns (flops, h, c)."""
    total = 0.0
    for i, co in enumerate(filters):
      s = first_stride if i == 0 else 2
      h_in, f = conv_flops(n, h_in, 3, s, ci, co)
      total += f + 3 * n * h_in * h_in * co  # BN affine + relu
      ci = co
    return total, h_in, ci

  torso_first_stride = 1 if s2d > 1 else 2
  encode_n1, he, ce = seq_convs(1, h, cin, net.torso_filters,
                                torso_first_stride)

  from tensor2robot_tpu_torch.data.abstract_input_generator import Mode
  extras_dim = sum(
      int(np.prod(spec.shape))
      for key, spec in model.get_feature_specification(
          Mode.TRAIN).to_flat_dict().items()
      if key not in ("image", "action"))
  emb_in = model.action_dim + extras_dim
  emb = net.action_embed_0.out_features
  merge_c = net.torso_filters[-1] if net.torso_filters else 3
  embed_row = 2 * (emb_in * emb + emb * merge_c)

  layers = net.q_head.layers()
  widths = [layer.in_features for layer in layers] + [layers[-1].out_features]
  qhead_row = 2 * sum(a * b for a, b in zip(widths[:-1], widths[1:]))

  p = learner.cem_population
  iters = learner.cem_iterations
  rows = batch * p
  per_iter = rows * (embed_row + qhead_row)
  if net.head_filters:
    h2, conv0_row = conv_flops(1, he, 3, 2, ce, net.head_filters[0])
    c1 = net.head_filters[0]
    # The linearity split: per-sample action contribution is a GEMM
    # against the [C, h2·w2·C'] tap-sum tensor, then merge + tail.
    per_iter += rows * 2 * ce * h2 * h2 * c1        # act GEMM
    per_iter += rows * 2 * h2 * h2 * c1             # merge add + relu
    tail, ht, ct = seq_convs(rows, h2, c1, net.head_filters[1:], 2)
    per_iter += tail + rows * ht * ht * ct          # + mean pool
    base = (batch * encode_n1
            + batch * conv0_row                      # enc0, once
            + ce * conv0_row)                        # basis tap-sums
  else:
    per_iter += rows * he * he * ce                  # pool fallback
    base = batch * encode_n1
  cem = base + iters * per_iter

  # Critic fwd: full encode + head at batch rows; bwd = 2× fwd.
  head_f, hh, hc = ((seq_convs(1, he, ce, net.head_filters, 2))
                    if net.head_filters else (0.0, he, ce))
  critic_fwd = batch * (encode_n1 + head_f + hh * hh * hc
                        + embed_row + qhead_row)
  # Optimizer/Polyak/grad-norm elementwise tail over the param count.
  n_params = sum(int(np.prod(x.shape))
                 for x in kw["params"].values()) if "params" in kw else 0
  return cem + 3 * critic_fwd + 14 * n_params


def qtopt_step_flops(learner: Any, batch_size: int,
                     params: Any = None) -> Optional[float]:
  """`analytic_flops("qtopt_step", ...)`, or None (logged) for a learner
  whose network lacks the Q-network's shape surface: such a run
  publishes no MFU rather than failing."""
  try:
    kw: Dict[str, Any] = dict(learner=learner, batch_size=batch_size)
    if params is not None:
      kw["params"] = params
    return float(analytic_flops("qtopt_step", **kw))
  except Exception:  # noqa: BLE001 — the model surface is duck-typed
    log.warning("analytic FLOPs unavailable for %r; live MFU gauges "
                "will not be published", type(learner).__name__,
                exc_info=True)
    return None


@dataclasses.dataclass
class AttentionCount:
  """The analytic FLOPs of the attention calls made while counting."""

  flops: float = 0.0


_ATTENTION = threading.local()  # the count open on each thread


@contextlib.contextmanager
def counting_attention():
  """While open on this thread, `layers.transformer` counts each
  attention call here analytically (its backward at
  `ATTENTION_BACKWARD_FACTOR` × its forward, when one runs) and computes
  a stand-in without products."""
  count, outer = AttentionCount(), attention_count()
  _ATTENTION.count = count
  try:
    yield count
  finally:
    _ATTENTION.count = outer


def attention_count() -> Optional[AttentionCount]:
  """The `counting_attention` count open on this thread, or None."""
  return getattr(_ATTENTION, "count", None)


class _CountingMode(TorchDispatchMode):
  """Adds up `torch.utils.flop_counter`'s FLOPs of the ops run under it
  (its formula registry: products, convolutions, attention ops)."""

  def __init__(self, registry):
    super().__init__()
    self.registry = registry
    self.flops = 0


def _count_dispatch(self, func, types, args=(), kwargs=None):
  kwargs = kwargs or {}
  out = func(*args, **kwargs)
  formula = self.registry.get(func._overloadpacket)
  if formula is not None:
    self.flops += formula(*args, **kwargs, out_val=out)
  return out


# Assigned after the class statement: TorchDispatchMode wraps a
# subclass's own `__torch_dispatch__` in a dynamo guard whose first call
# imports torch._dynamo (as running ops on the meta device does too),
# seconds of a trainer's first step in a new process, where a counted
# eager step costs a fraction of a second.
_CountingMode.__torch_dispatch__ = _count_dispatch


def train_step_flops(step_fn: Callable, *args) -> Optional[float]:
  """The FLOPs of one call of `step_fn(*args)`: the call runs once,
  eagerly, on the arguments' own device (its results are dropped), with
  every op's FLOPs from `torch.utils.flop_counter`'s formulas (what
  `FlopCounterMode` counts) and every attention call's analytic count in
  place of its products. None (logged) where the step cannot run so."""
  from torch.utils.flop_counter import flop_registry
  try:
    with counting_attention() as attention, _CountingMode(
        flop_registry) as counter:
      step_fn(*args)
    return float(counter.flops + attention.flops)
  except Exception:  # noqa: BLE001 — any model, any op
    log.warning("the train step's FLOPs could not be counted; perf.mfu "
                "will not be published", exc_info=True)
    return None


def device_memory_source() -> Callable[[], Dict[str, float]]:
  """A `telemetry.perf.ResourceSampler` source: per visible card i,
  ``device<i>_mem_bytes`` (the caching allocator's bytes in use) and
  ``device<i>_mem_fraction`` (of the card's memory). It reads host-side
  allocator statistics only, so it makes no CUDA call that could touch
  another thread's graph capture; it yields nothing until the process
  has initialized CUDA, and nothing on a host without a card."""
  totals = {}
  if torch.cuda.is_available():
    totals = {i: torch.cuda.get_device_properties(i).total_memory
              for i in range(torch.cuda.device_count())}

  def sample() -> Dict[str, float]:
    out: Dict[str, float] = {}
    if not totals or not torch.cuda.is_initialized():
      return out
    for index, total in totals.items():
      in_use = torch.cuda.memory_stats(index).get(
          "allocated_bytes.all.current")
      if in_use is None:
        continue
      out[f"device{index}_mem_bytes"] = float(in_use)
      out[f"device{index}_mem_fraction"] = float(in_use) / float(total)
    return out

  return sample


@contextlib.contextmanager
def trace(logdir: str, host_tracer_level: int = 2):
  """Captures a `torch.profiler` trace into `logdir` (a chrome trace,
  `*.pt.trace.json`; Perfetto or chrome://tracing open it).

  CUDA activity where the process has a card; `host_tracer_level` > 0
  adds the host's operators (the CPU activity), 0 traces the device
  only. Wrap the steps of interest; pair with `step_annotation` so
  per-step spans are visible.
  """
  os.makedirs(logdir, exist_ok=True)
  activities = []
  if host_tracer_level > 0:
    activities.append(torch.profiler.ProfilerActivity.CPU)
  if torch.cuda.is_available():
    activities.append(torch.profiler.ProfilerActivity.CUDA)
  if not activities:
    raise ValueError("trace(host_tracer_level=0) traces the device only, "
                     "and this process has no card")
  with torch.profiler.profile(
      activities=activities,
      on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
    yield
  log.info("Profiler trace written to %s", logdir)


def step_annotation(step: int):
  """Names one training step inside an active trace."""
  return torch.profiler.record_function("train", f"step_num={step}")


@gin.configurable
class ProfilerHook(Hook):
  """Captures a `torch.profiler` trace for a window of training steps.

  The trace lands in `<model_dir>/profile` (or `logdir`).

  Args:
    start_step: first profiled step (absolute step count, so resumed
      runs profile at the same point in training).
    num_steps: window length.
    logdir: override output dir; defaults to `<model_dir>/profile`.
  """

  def __init__(self, start_step: int = 10, num_steps: int = 5,
               logdir: Optional[str] = None):
    self._start = start_step
    self._num = num_steps
    self._logdir = logdir
    self._cm: Optional[Any] = None
    self._opened = False

  def begin(self, model, model_dir: str) -> None:
    if self._logdir is None:
      self._logdir = os.path.join(model_dir, "profile")
    self._opened = False

  def after_step(self, step: int, metrics: dict) -> None:
    # `>=` + the opened flag, not `==`: under steps_per_dispatch > 1
    # hooks only observe every K-th step, so an exact-match trigger
    # would never fire when start_step isn't a multiple of K.
    if self._cm is None and not self._opened and step >= self._start:
      self._opened = True
      self._cm = trace(self._logdir)
      self._cm.__enter__()
    elif self._cm is not None and step >= self._start + self._num:
      self._close()

  def _close(self) -> None:
    # Drain the card's queue so the trace covers whole steps.
    if torch.cuda.is_available() and torch.cuda.is_initialized():
      torch.cuda.synchronize()
    self._cm.__exit__(None, None, None)
    self._cm = None

  def end(self, step: int, state, model_dir: str) -> None:
    if self._cm is not None:  # run ended inside the window
      self._close()
