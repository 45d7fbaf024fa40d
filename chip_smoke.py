#!/usr/bin/env python3
"""Builds and drives the PyTorch port (`tensor2robot_tpu_torch`) on one
CUDA card: the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
  1. device: torch's name for card 0, and nvidia-smi's name + power limit;
  2. build: nvcc of every kernel source in tensor2robot_tpu_torch/csrc
     (cem_select.cu, flash_attention.cu), all started together;
  3. kernels against their plain versions on the card. cem_select at
     the main path's shapes (P=64, C=H=64, A=4, E=6) in bf16 with
     sigmoid on and off, at P=50, on exactly-tied scores, and in f32.
     flash_attention (out and lse) causal and not, T = 512, 100, 1,
     D = 32, 64, B = 1, 16, bf16 and f32, H = 4, plus the main path's
     strided q/k/v views of one qkv tensor;
  4. QT-Opt serving end to end at `GraspingQModel()`'s full width (64×64
     images, torso (32, 64), head (64, 64), dense (64, 64), bf16, random
     weights from seed 0): `CEMPolicyServer(max_batch=8)` over
     `QTOptLearner(cem_iterations=2, cem_population=64, cem_elites=6,
     cem_select="fused")` answers requests of 1, 3 and 8 rows and 4
     concurrent robots, with cem_select's launch count read around that
     run; then fused-vs-lax actions at B=256 on shared noise (value
     regret), and the card against the CPU on an f32 model at B=8;
  5. the VRGripper transformer policy end to end at the width of
     `train_vrgripper_transformer.gin` (48×48 images, filters (16, 32),
     embedding 64, width 128, depth 4, 4 heads, context 512, bf16,
     attention "auto", random weights from seed 0):
     `evaluate_gripper_policy` drives its `EpisodeContextPolicy` for 3
     episodes, with flash_attention's launch count read around that run
     (4 per policy step); then the card against the CPU on an f32 model;
  6. timings with CUDA events (medians): each kernel and its plain
     version (and for flash, SDPA as the library yardstick) as device
     time per call (CUDA-graph replay, no host launch cost), the CEM
     policy per dispatch and the context policy per step; then the
     `kernels` JSON line, the card line, and the result line last.

Exits 2 without a result when CUDA is unavailable.
"""

import itertools
import json
import os
import statistics
import subprocess
import sys
import threading
import time

def _log(*args):
  print(*args, flush=True)


def _median_ms(fn, iters=50, repeats=5):
  """Median over `repeats` of the mean CUDA-event time of `iters` calls."""
  import torch
  for _ in range(5):
    fn()
  torch.cuda.synchronize()
  times = []
  for _ in range(repeats):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
      fn()
    end.record()
    torch.cuda.synchronize()
    times.append(start.elapsed_time(end) / iters)
  return statistics.median(times)


def _graph_ms(fn, iters=20, repeats=5):
  """Median device time per call, without the host's launch cost:
  `iters` calls captured in one CUDA graph, replayed between events."""
  import torch
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    for _ in range(3):
      fn()
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    for _ in range(iters):
      fn()
  graph.replay()
  torch.cuda.synchronize()
  times = []
  for _ in range(repeats):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    times.append(start.elapsed_time(end) / iters)
  return statistics.median(times)


def _select_inputs(b, p, c, hidden, a_dim, dtype, seed):
  """Random pooled features / samples / q-head at the kernel's shapes."""
  import torch
  g = torch.Generator(device="cuda").manual_seed(seed)
  dev = dict(device="cuda")
  pooled = torch.relu(torch.randn((p, b, c), generator=g, **dev)).to(dtype)
  samples = torch.rand((b, p, a_dim), generator=g, **dev) * 2 - 1
  widths = (c,) + tuple(hidden) + (1,)
  dense = tuple(
      ((torch.randn((i, o), generator=g, **dev) / i ** 0.5).to(dtype),
       (torch.randn((o,), generator=g, **dev) * 0.1).to(dtype))
      for i, o in zip(widths[:-1], widths[1:]))
  return pooled, samples, dense


def _bound(pooled, samples, dense):
  """Least time (ms) for the select's work on this card, and its limit
  (peaks of one H100 SXM at 700 W, `bin/kernel_bounds.py`)."""
  from tensor2robot_tpu_torch.bin import kernel_bounds
  p, _, c = pooled.shape
  widths = (c,) + tuple(w.shape[1] for w, _ in dense)
  return kernel_bounds.cem_select(p, samples.shape[0], widths,
                                  samples.shape[-1], pooled.element_size())


def check_select(name, pooled, samples, dense, num_elites, sigmoid,
                 score_tol, exact=False):
  """Kernel vs plain version on the same CUDA inputs.

  Scores may differ by summation order (f32) or by a hidden activation
  rounding to the other bf16 neighbour, so the elite set is compared
  only on rows where the plain version's E-th and (E+1)-th scores are
  further apart than max(1e-6, the largest best-score difference × 4),
  the best action where its top two are; `exact` (integer-valued
  scores, exact in any order) compares every row exactly.
  """
  import torch
  from tensor2robot_tpu_torch.ops import cem_select as ops
  got = ops.fused_cem_select(pooled, samples, dense, num_elites,
                             sigmoid=sigmoid)
  torch.cuda.synchronize()
  want = ops.cem_select_reference(pooled, samples, dense, num_elites,
                                  sigmoid=sigmoid)
  p, b, c = pooled.shape
  scores = ops._mlp_f32(pooled.reshape(p * b, c), dense).reshape(p, b).t()
  if sigmoid:
    scores = torch.sigmoid(scores)
  ranked = scores.sort(dim=1, descending=True).values
  score_err = (got[3] - want[3]).abs().max().item()
  scale = want[3].abs().clamp_min(1.0)
  if not bool(((got[3] - want[3]).abs() <= score_tol * scale).all()):
    raise AssertionError(f"{name}: best_score differs by {score_err}")
  gap_thr = 0.0 if exact else max(1e-6, 4 * score_err)
  set_rows = (ranked[:, num_elites - 1] - ranked[:, num_elites]) > gap_thr \
      if num_elites < p else torch.ones(b, dtype=torch.bool, device="cuda")
  top_rows = (ranked[:, 0] - ranked[:, 1]) > gap_thr
  if exact:
    set_rows[:] = True
    top_rows[:] = True
  errs = {"best_score": score_err}
  for i, key, rows, tol in ((0, "mean", set_rows, 1e-5),
                            (1, "std", set_rows, 1e-5),
                            (2, "best_action", top_rows, 0.0)):
    diff = (got[i] - want[i]).abs()[rows]
    errs[key] = diff.max().item() if diff.numel() else 0.0
    if errs[key] > tol:
      raise AssertionError(f"{name}: {key} differs by {errs[key]} > {tol}")
  decided = set_rows.float().mean().item()
  if decided < 0.25:
    raise AssertionError(f"{name}: only {decided} of rows decided")
  _log(f"kernel check {name}: B={b} P={p} C={c} dtype={pooled.dtype} "
       f"sigmoid={sigmoid} rows_compared={decided} "
       f"max_abs_err={json.dumps(errs)}")
  return max(errs.values())


def phase_kernels():
  import torch
  bf16, f32 = torch.bfloat16, torch.float32
  hidden = (64, 64)
  errs = {}
  for sigmoid in (False, True):
    errs[f"bf16_sigmoid_{sigmoid}"] = check_select(
        f"bf16 sigmoid={sigmoid}",
        *_select_inputs(256, 64, 64, hidden, 4, bf16, seed=1 + sigmoid),
        num_elites=6, sigmoid=sigmoid, score_tol=1e-2)
  check_select("bf16 P=50", *_select_inputs(256, 50, 64, hidden, 4, bf16,
                                            seed=3),
               num_elites=6, sigmoid=True, score_tol=1e-2)
  check_select("f32", *_select_inputs(256, 64, 64, hidden, 4, f32, seed=4),
               num_elites=6, sigmoid=True, score_tol=1e-5)
  # Integer pooled features and weights give integer scores, exact in
  # any summation order: many exact ties, all broken by the lower index.
  g = torch.Generator(device="cuda").manual_seed(5)
  pooled = torch.randint(0, 8, (64, 256, 64), generator=g,
                         device="cuda").to(bf16)
  samples = torch.rand((256, 64, 4), generator=g, device="cuda") * 2 - 1
  dense = ((torch.randint(-2, 3, (64, 1), generator=g,
                          device="cuda").to(bf16),
            torch.full((1,), 0.5, device="cuda").to(bf16)),)
  check_select("exact ties", pooled, samples, dense, num_elites=5,
               sigmoid=False, score_tol=0.0, exact=True)
  return max(errs.values())


def _value_regret(scorer, ts, obs, a_ref, a_new):
  """Largest Q(a_ref) − Q(a_new) over the batch under `scorer`'s score
  path, and the batch spread of Q(a_ref) (tests/test_mfu_levers.py's
  end-metric judge: robust to ties, unlike comparing actions)."""
  import torch
  with torch.inference_mode():
    score_fn, _ = scorer._cem_fns(scorer.model.bind(ts), obs)
    q_ref = score_fn(a_ref[:, None])[:, 0]
    q_new = score_fn(a_new[:, None])[:, 0]
  return ((q_ref - q_new).max().item(),
          (q_ref.max() - q_ref.min()).item() + 1e-6)


def phase_slice():
  import numpy as np
  import torch
  from tensor2robot_tpu_torch.ops import cem_select as ops
  from tensor2robot_tpu_torch.research.qtopt import (
      GraspingQModel,
      QTOptLearner,
  )
  from tensor2robot_tpu_torch.serving import CEMPolicyServer
  from tensor2robot_tpu_torch.specs import make_random_tensors

  cem_kwargs = dict(cem_iterations=2, cem_population=64, cem_elites=6)
  model = GraspingQModel()
  learner = QTOptLearner(model, cem_select="fused", **cem_kwargs)
  state = learner.create_state(seed=0)
  spec = learner.observation_specification()
  server = CEMPolicyServer(learner, state.train_state, max_batch=8, seed=0)
  _log(f"server warmup_seconds={server.warmup_seconds} "
       f"per_bucket={json.dumps(server.engine.bucket_warmup_seconds)}")

  # ---- the main path, with the kernel's launch count read around it ----
  engine = server.engine
  ops.fused_cem_select.launches = 0
  d0 = engine.dispatch_count
  answers = [server.select_actions(
      make_random_tensors(spec, batch_size=n, seed=10 + n).to_flat_dict())
      for n in (1, 3, 8)]
  barrier = threading.Barrier(4)
  robots = {}

  def robot(i):
    obs = make_random_tensors(spec, batch_size=1, seed=20 + i)
    barrier.wait()
    robots[i] = server.select_actions(obs.to_flat_dict())

  threads = [threading.Thread(target=robot, args=(i,)) for i in range(4)]
  for t in threads:
    t.start()
  for t in threads:
    t.join(timeout=300)
  launches = ops.fused_cem_select.launches
  dispatches = engine.dispatch_count - d0
  server.close()
  if any(t.is_alive() for t in threads) or len(robots) != 4:
    raise AssertionError("concurrent robots did not all get answers")
  answers += [robots[i] for i in range(4)]
  for n, a in zip((1, 3, 8, 1, 1, 1, 1), answers):
    if a.shape != (n, 4) or not np.all(np.isfinite(a)):
      raise AssertionError(f"bad actions {a.shape}: {a}")
    if np.any(a < -1.0) or np.any(a > 1.0):
      raise AssertionError(f"actions out of bounds: {a}")
  if dispatches < 4 or launches != 2 * dispatches:
    raise AssertionError(f"launches {launches} != 2 x dispatches "
                         f"{dispatches}")
  _log(f"main path: requests=7 dispatches={dispatches} "
       f"batch_sizes={server.batcher.batch_sizes} "
       f"cem_select_launches={launches}")

  # ---- fused vs lax at B=256 on shared noise, judged by value regret ----
  # f32 is the gate: there the two paths score with the same f32 math up
  # to summation order, so they may only part on near-ties. In bf16 the
  # lax path rounds every q-head layer to bf16 (as the JAX package's
  # does) while the kernel accumulates in f32, so they part on more
  # states by design: printed, not gated.
  torch.backends.cudnn.allow_tf32 = False
  model32 = GraspingQModel(device_dtype=torch.float32)
  ts32 = QTOptLearner(model32, **cem_kwargs).create_state(seed=0).train_state
  obs256 = {k: torch.from_numpy(v).cuda() for k, v in make_random_tensors(
      spec, batch_size=256, seed=2).to_flat_dict().items()}
  g = torch.Generator(device="cuda").manual_seed(6)
  noise = torch.randn((2, 256, 64, 4), generator=g, device="cuda")
  for m, ts in ((model32, ts32), (model, state.train_state)):
    fused = QTOptLearner(m, cem_select="fused", **cem_kwargs)
    lax = QTOptLearner(m, cem_select="lax", **cem_kwargs)
    a_fused = fused.build_policy()(ts, obs256, noise=noise)
    a_lax = lax.build_policy()(ts, obs256, noise=noise)
    regret, spread = _value_regret(lax, ts, obs256, a_lax, a_fused)
    same = ((a_fused - a_lax).abs().max(dim=1).values < 1e-6).float().mean()
    _log(f"fused vs lax B=256 {m.device_dtype}: same_action_fraction="
         f"{same.item()} max_value_regret={regret} q_spread={spread}")
    if m is model32 and regret / spread >= 0.05:
      raise AssertionError("fused CEM picks worse actions than lax (f32)")

  # ---- the card against the CPU: f32 model, same weights and noise ----
  gpu32 = QTOptLearner(model32, cem_select="fused", **cem_kwargs)
  cpu32 = QTOptLearner(model32, cem_select="fused", device="cpu",
                       **cem_kwargs)
  obs8 = make_random_tensors(spec, batch_size=8, seed=3).to_flat_dict()
  noise8 = torch.randn((2, 8, 64, 4), generator=g, device="cuda")
  a_gpu = gpu32.build_policy()(ts32, obs8, noise=noise8).cpu()
  ts32_cpu = ts32.to("cpu")
  a_cpu = cpu32.build_policy()(ts32_cpu, obs8, noise=noise8.cpu())
  obs8_cpu = {k: torch.from_numpy(v) for k, v in obs8.items()}
  regret, spread = _value_regret(
      QTOptLearner(model32, device="cpu", **cem_kwargs), ts32_cpu,
      obs8_cpu, a_cpu, a_gpu)
  _log(f"card vs CPU f32 B=8: max_action_diff="
       f"{(a_gpu - a_cpu).abs().max().item()} max_value_regret={regret} "
       f"q_spread={spread}")
  if regret / spread >= 0.05:
    raise AssertionError("card and CPU choose actions of different value")
  torch.backends.cudnn.allow_tf32 = True
  return launches, learner, state


def phase_timings(learner, state):
  import torch
  from tensor2robot_tpu_torch.ops import cem_select as ops
  from tensor2robot_tpu_torch.specs import make_random_tensors

  spec = learner.observation_specification()
  policy = learner.build_policy()
  rows = {}
  for b in (8, 256):
    args = _select_inputs(b, 64, 64, (64, 64), 4, torch.bfloat16,
                          seed=7 + b)
    run_k = lambda: ops.fused_cem_select(*args, 6, sigmoid=True)  # noqa: E731
    run_p = lambda: ops.cem_select_reference(*args, 6,  # noqa: E731
                                             sigmoid=True)
    # Device time (graph replay) in turns plain, kernel, kernel, plain;
    # then the eager per-call time a Python caller sees.
    plain_a, kern_a = _graph_ms(run_p), _graph_ms(run_k)
    kern_b, plain_b = _graph_ms(run_k), _graph_ms(run_p)
    kern_eager, plain_eager = _median_ms(run_k), _median_ms(run_p)
    bound_ms, bound_by = _bound(*args)
    obs = {k: torch.from_numpy(v).cuda() for k, v in make_random_tensors(
        spec, batch_size=b, seed=b).to_flat_dict().items()}
    g = torch.Generator(device="cuda").manual_seed(b)
    policy_ms = _median_ms(lambda: policy(state, obs, generator=g),
                           iters=10)
    rows[b] = dict(ms=statistics.median([kern_a, kern_b]),
                   plain_ms=statistics.median([plain_a, plain_b]),
                   bound_ms=bound_ms, bound_by=bound_by, policy_ms=policy_ms)
    _log(f"timing B={b}: cem_select device kernel_ms={kern_a},{kern_b} "
         f"plain_ms={plain_a},{plain_b} | eager per call kernel_ms="
         f"{kern_eager} plain_ms={plain_eager} | bound_ms={bound_ms} "
         f"({bound_by}) | policy_ms_per_dispatch={policy_ms}")
  return rows

# ---- flash attention (the VRGripper transformer's attention) ----

# The VRGripper transformer at train_vrgripper_transformer.gin's width.
_GRIPPER_WIDTH = dict(image_size=48, state_dim=3, action_dim=3,
                      filters=(16, 32), embedding_size=64, width=128,
                      depth=4, num_heads=4, max_context_length=512,
                      attention_impl="auto")

# Kernel vs plain version (out, lse). f32: the same arithmetic in
# another order. bf16: the kernel rounds p to bf16 against each 64-key
# tile's running max, the plain version against the row max, and out
# is bf16 (one step is 2^-8 relative below 1); lse has no bf16 rounding.
_FLASH_TOL = {"torch.float32": (1e-5, 1e-5), "torch.bfloat16": (2e-2, 1e-3)}


def _flash_inputs(b, t, h, d, dtype, seed):
  import torch
  g = torch.Generator(device="cuda").manual_seed(seed)
  return tuple(torch.randn((b, t, h, d), generator=g,
                           device="cuda").to(dtype) for _ in range(3))


def _flash_bound(q, causal):
  """Least time (ms) for one forward on this card, and its limit: q, k,
  v read once, out and lse written once; 4·B·H·T²·D operations, half
  of them when causal (`bin/kernel_bounds.py`)."""
  from tensor2robot_tpu_torch.bin import kernel_bounds
  return kernel_bounds.flash_forward(*q.shape, q.element_size(), causal)


def check_flash(name, q, k, v, causal):
  import torch
  from tensor2robot_tpu_torch.ops.flash_attention import (
      flash_attention_reference,
      flash_attention_with_lse,
  )
  out, lse = flash_attention_with_lse(q, k, v, causal=causal)
  torch.cuda.synchronize()
  want_out, want_lse = flash_attention_reference(q, k, v, causal=causal)
  b, t, h, _ = q.shape
  if (out.shape != want_out.shape or out.dtype != q.dtype
      or lse.shape != (b, h, t) or lse.dtype != torch.float32):
    raise AssertionError(f"flash {name}: out {out.shape} {out.dtype}, "
                         f"lse {lse.shape} {lse.dtype}")
  if not (bool(torch.isfinite(out).all()) and bool(torch.isfinite(lse).all())):
    raise AssertionError(f"flash {name}: non-finite output")
  err_out = (out.float() - want_out.float()).abs().max().item()
  err_lse = (lse - want_lse).abs().max().item()
  tol_out, tol_lse = _FLASH_TOL[str(q.dtype)]
  if err_out > tol_out or err_lse > tol_lse:
    raise AssertionError(f"flash {name}: out differs by {err_out} (tol "
                         f"{tol_out}), lse by {err_lse} (tol {tol_lse})")
  return err_out, err_lse


def phase_flash_kernels():
  import torch
  worst = {}
  cases = itertools.product((False, True), (512, 100, 1), (32, 64), (1, 16),
                            (torch.bfloat16, torch.float32))
  for i, (causal, t, d, b, dtype) in enumerate(cases):
    name = f"causal={causal} T={t} D={d} B={b} {dtype}"
    errs = check_flash(name, *_flash_inputs(b, t, 4, d, dtype, seed=100 + i),
                       causal=causal)
    key = str(dtype)
    worst[key] = tuple(max(x, y) for x, y in zip(worst.get(key, (0, 0)),
                                                 errs))
  # The main path's layout: q, k, v are strided views of one qkv tensor.
  g = torch.Generator(device="cuda").manual_seed(99)
  qkv = torch.randn((1, 512, 12, 32), generator=g, device="cuda")
  q, k, v = qkv.to(torch.bfloat16).split(4, dim=2)
  errs = check_flash("strided qkv views", q, k, v, causal=True)
  _log(f"kernel check flash_attention: 48 cases + strided views, max_abs_err "
       f"(out, lse) = {json.dumps(worst)}; strided {errs}; tolerances "
       f"{json.dumps(_FLASH_TOL)}")
  return max(e for pair in worst.values() for e in pair[:1])


class _Recorder:
  """Passes a policy through, keeping every action it served."""

  def __init__(self, policy):
    self.policy = policy
    self.actions = []

  def reset(self):
    self.policy.reset()

  def __call__(self, batch):
    out = self.policy(batch)
    self.actions.append(out["action"])
    return out


def phase_gripper_slice():
  import numpy as np
  import torch
  from tensor2robot_tpu_torch.ops.flash_attention import flash_attention
  from tensor2robot_tpu_torch.research.vrgripper import (
      ACTION,
      VRGripperEnv,
      VRGripperTransformerModel,
      evaluate_gripper_policy,
  )

  model = VRGripperTransformerModel(**_GRIPPER_WIDTH)
  state = model.create_inference_state(seed=0)
  policy = model.make_context_policy(state)
  recorder = _Recorder(policy)

  # ---- the main path, with the kernel's launch count read around it ----
  flash_attention.launches = 0
  t0 = time.perf_counter()
  metrics = evaluate_gripper_policy(recorder, num_episodes=3,
                                    image_size=48, seed=1)
  wall_s = time.perf_counter() - t0
  launches = flash_attention.launches
  steps = policy.steps
  for a in recorder.actions:
    if a.shape != (1, 3) or not np.all(np.isfinite(a)):
      raise AssertionError(f"bad action {a.shape}: {a}")
  if policy.resets != 3 or len(recorder.actions) != steps or steps < 3:
    raise AssertionError(f"resets {policy.resets}, steps {steps}, "
                         f"actions {len(recorder.actions)}")
  if launches != model.depth * steps:
    raise AssertionError(f"flash launches {launches} != depth "
                         f"{model.depth} x policy steps {steps}")
  _log(f"main path (vrgripper transformer): episodes=3 steps={steps} "
       f"resets={policy.resets} flash_attention_launches={launches} "
       f"wall_s={wall_s} (first step builds cuDNN/cuBLAS plans) "
       f"metrics={json.dumps(metrics)}")

  # ---- the card against the CPU: f32 model, same weights and frames ----
  torch.backends.cudnn.allow_tf32 = False
  model32 = VRGripperTransformerModel(device_dtype=torch.float32,
                                      **_GRIPPER_WIDTH)
  state32 = model32.create_inference_state(seed=0)
  on_card = model32.make_context_policy(state32)
  on_cpu = model32.make_context_policy(state32.to("cpu"), device="cpu")
  env = VRGripperEnv(image_size=48, seed=2)
  obs = env.reset()
  diffs = []
  for _ in range(4):
    batch = {k: v[None] for k, v in obs.items()}
    a_card, a_cpu = on_card(batch)[ACTION], on_cpu(batch)[ACTION]
    diffs.append(float(np.abs(a_card - a_cpu).max()))
    obs, _, _ = env.step(a_cpu[0])
  torch.backends.cudnn.allow_tf32 = True
  _log(f"card vs CPU f32 context policy, 4 steps at T=512: "
       f"max_action_diff per step={diffs} (tol 1e-4)")
  if max(diffs) > 1e-4:
    raise AssertionError("card and CPU context policies differ")
  return launches, policy


def phase_flash_timings(policy):
  import numpy as np
  import torch
  import torch.nn.functional as F
  from tensor2robot_tpu_torch.ops.flash_attention import (
      flash_attention_reference,
      flash_attention_with_lse,
  )
  from tensor2robot_tpu_torch.research.vrgripper import VRGripperEnv

  rows = {}
  for b in (1, 16):
    q, k, v = _flash_inputs(b, 512, 4, 32, torch.bfloat16, seed=200 + b)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    run_k = lambda: flash_attention_with_lse(q, k, v, causal=True)  # noqa: E731
    run_p = lambda: flash_attention_reference(q, k, v,  # noqa: E731
                                              causal=True)
    run_l = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True)
    # Device time (graph replay) in turns plain, kernel, library,
    # library, kernel, plain.
    plain_a, kern_a, lib_a = _graph_ms(run_p), _graph_ms(run_k), \
        _graph_ms(run_l)
    lib_b, kern_b, plain_b = _graph_ms(run_l), _graph_ms(run_k), \
        _graph_ms(run_p)
    bound_ms, bound_by = _flash_bound(q, causal=True)
    rows[b] = dict(ms=statistics.median([kern_a, kern_b]),
                   plain_ms=statistics.median([plain_a, plain_b]),
                   library_ms=statistics.median([lib_a, lib_b]),
                   bound_ms=bound_ms, bound_by=bound_by)
    _log(f"timing flash_attention B={b} T=512 H=4 D=32 bf16 causal: device "
         f"kernel_ms={kern_a},{kern_b} plain_ms={plain_a},{plain_b} "
         f"sdpa_ms={lib_a},{lib_b} | bound_ms={bound_ms} ({bound_by})")

  # The context policy's wall time per step (host clock; each call ends
  # in the action's copy to the host), over one long episode.
  env = VRGripperEnv(image_size=48, seed=3)
  obs = env.reset()
  policy.reset()
  times = []
  for i in range(40):
    batch = {k: v[None] for k, v in obs.items()}
    t0 = time.perf_counter()
    action = policy(batch)["action"]
    times.append((time.perf_counter() - t0) * 1e3)
    obs, _, done = env.step(action[0])
    if done:
      obs = env.reset()
  steady = times[5:]
  step_ms = statistics.median(steady)
  _log(f"timing context policy step (T=512, bf16, depth 4): median_ms="
       f"{step_ms} p90_ms={float(np.percentile(steady, 90))} over "
       f"{len(steady)} steps")
  return rows, step_ms


def main():
  import torch
  if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
    return 2
  sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
  from tensor2robot_tpu_torch.ops import build

  t_start = time.perf_counter()
  kind = torch.cuda.get_device_name(0)
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True,
      timeout=60, check=True).stdout.strip().splitlines()[0]
  _log(f"device: {kind} x{torch.cuda.device_count()} torch "
       f"{torch.__version__} cuda {torch.version.cuda}")

  sources = sorted(f[:-3] for f in os.listdir(build.CSRC_DIR)
                   if f.endswith(".cu"))
  t0 = time.perf_counter()
  per_kernel = build.build(sources, ptxas_verbose=True)
  _log(f"build: {json.dumps(per_kernel)} wall_s={time.perf_counter() - t0}")

  max_err = phase_kernels()
  flash_err = phase_flash_kernels()
  launches, learner, state = phase_slice()
  flash_launches, context_policy = phase_gripper_slice()
  rows = phase_timings(learner, state)
  flash_rows, _ = phase_flash_timings(context_policy)
  main_row = rows[8]  # the serving path's largest bucket
  flash_row = flash_rows[1]  # the context policy serves one robot
  kernels = [{
      "name": "cem_select",
      "route": "cuda",
      "source": "tensor2robot_tpu_torch/csrc/cem_select.cu",
      "replaces": "tensor2robot_tpu/ops/cem_select.py:181",
      "launches": launches,
      "max_abs_err": max_err,
      "ms": main_row["ms"],
      "plain_ms": main_row["plain_ms"],
      "bound_ms": main_row["bound_ms"],
      "bound_by": main_row["bound_by"],
      "library_ms": None,
  }, {
      "name": "flash_attention_fwd",
      "route": "cuda",
      "source": "tensor2robot_tpu_torch/csrc/flash_attention.cu",
      "replaces": "tensor2robot_tpu/ops/flash_attention.py:211",
      "launches": flash_launches,
      "max_abs_err": flash_err,
      "ms": flash_row["ms"],
      "plain_ms": flash_row["plain_ms"],
      "bound_ms": flash_row["bound_ms"],
      "bound_by": flash_row["bound_by"],
      "library_ms": flash_row["library_ms"],
  }]
  _log(f"total_s={time.perf_counter() - t_start}")
  _log(json.dumps({"kernels": kernels}))
  _log(smi)
  _log(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": kind,
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
