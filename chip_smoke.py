#!/usr/bin/env python3
"""Builds and drives the PyTorch port (`tensor2robot_tpu_torch`) on one
CUDA card: the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
  1. device: torch's name for card 0, and nvidia-smi's name + power limit;
  2. build: nvcc of every kernel source in tensor2robot_tpu_torch/csrc
     (cem_head.cu, cem_select.cu, flash_attention.cu,
     flash_attention_bwd.cu), all started together; ptxas registers,
     spills and dynamic shared memory of each CEM wgmma instantiation;
  3. kernels against their plain versions on the card. cem_select at
     the main path's shapes (P=64, C=H=64, A=4, E=6) in bf16 with
     sigmoid on and off, at P=50, on exactly-tied scores, and in f32;
     then the serving buckets B = 1, 3, 8, P=200 (four 64-row tiles,
     the last ragged) and exact ties through a hidden layer at P = 64
     and 200, every bf16 case rerun for identical bits, each case's
     path (wgmma or CUDA cores) printed.
     flash_attention (out and lse) causal and not, T = 512, 100, 65, 32,
     17, 1, D = 16, 32, 64, 128, B = 1, 16, bf16 (tensor cores) and f32
     (CUDA cores), H = 4, plus the policy's and the training path's
     strided q/k/v views of one qkv tensor (B=1, T=512 and B=16, T=32;
     D = 32 and 16);
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
  6. the flash backward kernels (flash_attention_bwd.cu: dK/dV and dQ)
     against their plain versions on the forward kernel's out and lse
     (themselves held against the plain forward), and the plain
     versions against torch.autograd of the plain forward: causal and
     not, T = 32, 512, 100, 1, D = 16, 32, 64, 128, B = 1, 16, bf16 (the
     bf16 kernels run twice, identical bits) and f32, H = 4, the lse
     cotangent zero and random, each gradient's error over its own
     largest value; plus the training path's strided q/k/v views of one
     qkv tensor under autograd (D = 32 and 16) with non-contiguous dO
     views, two of them outside TMA's rule (copied dense first);
  7. VRGripper transformer behaviour-cloning training at the gin width
     (bf16, Adam at lr 3e-4): `train_eval_model` takes 60 steps over an
     `EpisodeInputGenerator` of 64 seeded expert episodes (batch 16,
     sequence_length 32), with the forward, dK/dV and dQ launch counts
     read around that run (4 each per step); the mse must fall and
     `metrics_train.jsonl` carry the envelope; the trained state then
     serves one episode through `make_context_policy`; then one f32
     train step on the card against the CPU (loss, grad_norm, every
     gradient and every parameter after the Adam update);
  8. timings with CUDA events (medians): the launch floor (a one-element
     add by graph replay), each kernel and its plain
     version (and for flash, SDPA as the library yardstick: its forward
     at all three forward shapes, and its backward as fwd+bwd minus fwd;
     the backward pair, δ and SDPA's backward at B=16, H=4 and T=32 with
     D = 32 and 16, and T = 64 and 512 with D=32) as device time per call
     (CUDA-graph replay, no host launch cost), the CEM policy per
     dispatch, the context policy per step and the train step (graph
     replay and eager); then `VRGripperTransformerModel()` at its own
     defaults (width 64, depth 2, 4 heads: head dim 16, context 512,
     bf16) serves one episode and trains 10 steps (flash launches =
     depth per policy step; forward, dK/dV and dQ launches = depth per
     train step), and one f32 train step of it runs on the card against
     the CPU;
  9. fused_cem_head_tail (cem_head.cu) against its plain version: the
     --verify gate's case (B=4, P=64, 8×8×64 → 64, bf16), B = 1, 3, 256,
     P = 50, f32, C1 = C2 = 128, a ragged shape, 32 → 32 and 4×16×64 →
     32, the Q-network's P-major tensor as a transposed view and a bf16
     view outside TMA's rule (copied dense), each case rerun for
     identical bits and its path printed;
 10. QT-Opt Bellman training at `GraspingQModel()` width: `train_qtopt`
     takes 60 steps of batch 256 over a replay buffer of synthetic-bandit
     transitions (research/qtopt/synthetic_bandit.py), with cem_select's
     launch count read around the run (2 per step); the loss must fall
     and Q(a*) beat Q(−a*); a second call resumes at step 60 for 10;
 11. the head tail on the Bellman target's own tensors (the trained
     target network's merge parts, B=256): a 2-iteration CEM through it,
     its launch count read around that run; Q against the plain version
     and the unfused `score_population`;
 12. one f32 Bellman step on the card against the CPU (bench.py's
     --verify config); timings of the head tail, its plain version and
     the unfused torch tail at B=4 and 256, and of the Bellman step
     (graph replay, eager, profiler); then the `kernels` JSON line, the
     card line, and the result line last.

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


def launch_floor_ms():
  """Device time of the least kernel, a one-element add, per call by
  graph replay: what any launch costs beside its work."""
  import torch
  x = torch.zeros(1, device="cuda")
  return _graph_ms(lambda: x.add_(1))


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


def _select_path(pooled, samples, dense, num_elites):
  """The path `fused_cem_select` takes for these inputs, and its bytes of
  dynamic shared memory (ops/cem_select.py `_plan`)."""
  from tensor2robot_tpu_torch.ops import cem_select as ops
  p, _, c = pooled.shape
  plan = ops._plan(p, [c] + [w.shape[1] for w, _ in dense], pooled.dtype,
                   num_elites, samples.shape[-1])
  return f"{plan['path']} smem={plan['smem']}"


def _same_bits(name, fn):
  """Runs `fn` twice on the same inputs; every output must be identical
  bit for bit (no atomics, sums in a fixed order)."""
  import torch
  first, second = fn(), fn()
  torch.cuda.synchronize()
  first = first if isinstance(first, tuple) else (first,)
  second = second if isinstance(second, tuple) else (second,)
  for a, b in zip(first, second):
    if not torch.equal(a, b):
      raise AssertionError(f"{name}: a rerun gave other bits")


def _tied_select_inputs(p, b, seed):
  """Integer features and weights with a hidden layer: every score is an
  integer, exact in any summation order, and many tie."""
  import torch
  bf16 = torch.bfloat16
  g = torch.Generator(device="cuda").manual_seed(seed)
  ints = lambda lo, hi, shape: torch.randint(  # noqa: E731
      lo, hi, shape, generator=g, device="cuda").to(bf16)
  pooled = ints(0, 4, (p, b, 64))
  samples = torch.rand((b, p, 4), generator=g, device="cuda") * 2 - 1
  dense = ((ints(-1, 2, (64, 64)), ints(-2, 3, (64,))),
           (ints(-1, 2, (64, 1)), torch.full((1,), 0.5, device="cuda",
                                             dtype=bf16)))
  return pooled, samples, dense


def phase_kernels():
  import torch
  from tensor2robot_tpu_torch.ops import cem_select as ops
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
  # The serving buckets, a population of four 64-row tiles (the last
  # ragged), and exact ties through the tensor-core path (a hidden
  # layer), one tile and four.
  cases = [(f"bf16 B={b}", _select_inputs(b, 64, 64, hidden, 4, bf16,
                                          seed=20 + b), 6, True, 1e-2, False)
           for b in (1, 3, 8)]
  cases.append(("bf16 P=200", _select_inputs(64, 200, 64, hidden, 4, bf16,
                                             seed=24), 6, False, 1e-2, False))
  cases += [(f"exact ties hidden P={p}", _tied_select_inputs(p, 64, 25 + p),
             5, False, 0.0, True) for p in (64, 200)]
  for name, args, elites, sigmoid, tol, exact in cases:
    errs[name] = check_select(name, *args, num_elites=elites,
                              sigmoid=sigmoid, score_tol=tol, exact=exact)
  # Identical bits on a rerun, and the path of every bf16 case.
  reruns = [("bf16 B=256", _select_inputs(256, 64, 64, hidden, 4, bf16,
                                          seed=1), 6)]
  reruns += [(name, args, elites) for name, args, elites, *_ in cases]
  reruns.append(("exact ties", (pooled, samples, dense), 5))
  for name, args, elites in reruns:
    _same_bits(f"cem_select {name}", lambda: ops.fused_cem_select(
        *args, elites, sigmoid=True))
    _log(f"cem_select {name}: path {_select_path(*args, elites)}, "
         f"identical bits on a rerun")
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
  _log(f"timing launch floor: one-element torch add, device ms per call "
       f"(graph replay) {launch_floor_ms()}")
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
  # T = 65 and 17 are ragged past a 64-row tile and a 16-row fragment;
  # D=16 is the default VRGripper transformer's head dim.
  cases = list(itertools.product((False, True), (512, 100, 65, 32, 17, 1),
                                 (16, 32, 64, 128), (1, 16),
                                 (torch.bfloat16, torch.float32)))
  for i, (causal, t, d, b, dtype) in enumerate(cases):
    name = f"causal={causal} T={t} D={d} B={b} {dtype}"
    errs = check_flash(name, *_flash_inputs(b, t, 4, d, dtype, seed=100 + i),
                       causal=causal)
    key = str(dtype)
    worst[key] = tuple(max(x, y) for x, y in zip(worst.get(key, (0, 0)),
                                                 errs))
  # The main paths' layout: q, k, v are strided views of one qkv tensor,
  # at the policy's shape and at the training step's.
  strided = {}
  for b, t, d, seed in ((1, 512, 32, 100), (16, 32, 32, 115),
                        (1, 512, 16, 1100), (16, 32, 16, 1115)):
    _, (q, k, v) = _strided_qkv(b, t, 4, d, torch.bfloat16, seed=seed)
    strided[f"B={b} T={t} D={d}"] = check_flash(
        f"strided qkv views B={b} T={t} D={d}", q, k, v, causal=True)
  _log(f"kernel check flash_attention: {len(cases)} cases + strided views, "
       f"max_abs_err (out, lse) = {json.dumps(worst)}; strided "
       f"{json.dumps(strided)}; tolerances {json.dumps(_FLASH_TOL)}")
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
      evaluate_gripper_policy,
  )
  from tensor2robot_tpu_torch.research.vrgripper.gin_config import gin_model

  model = gin_model()
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
  model32 = gin_model(torch.float32)
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


# ---- flash attention backward (the VRGripper transformer's training) ----

# Backward checks, as the largest |error| over the largest |value| of
# the gradient itself (dq, dk and dv peak at ~0.05 to ~5 across the
# cases). Where a gradient is zero in exact arithmetic (dq and dk at T=1
# with the lse cotangent zero: a softmax over one key has no slope), both
# sides hold only the f32 summation noise of dO·vᵀ − δ, and the error is
# held to _ZERO_GRAD_TOL absolute instead.
# Kernel vs plain version — f32: the same arithmetic in another order
# (sums over up to 512 rows); bf16: both round p and ds to bf16 from the
# same f32 scores, so a rounding may tip to the other neighbour, and the
# gradients are stored in bf16 (one step is 2^-8 to 2^-7 of the largest
# value).
# Plain version vs autograd of the plain forward — f32: another formula
# for the same derivative; bf16: autograd rounds the cotangent of p to
# bf16 where the flash backward rounds exp(s - lse) and ds.
# Worst readings on an H100 (700 W) over these cases: kernel vs plain
# 2.6e-6 (f32) and 2.5e-3 (bf16), plain vs autograd 1.7e-6 and 8.2e-3.
_FLASH_BWD_TOL = {"torch.float32": 1e-5, "torch.bfloat16": 1e-2}
_FLASH_AUTOGRAD_TOL = {"torch.float32": 1e-5, "torch.bfloat16": 2e-2}
_ZERO_GRAD_TOL = 1e-5


def _grad_err(got, want, zero=False):
  """The error the tolerances read: max |got - want| over max |want|, or
  for a gradient that is zero in exact arithmetic, max |got - want|."""
  err = (got.float() - want.float()).abs().max().item()
  return err if zero else err / want.float().abs().max().item()


def check_flash_bwd(name, q, k, v, do, dlse, causal):
  """The forward kernel's out and lse against the plain forward, the two
  backward kernels against their plain versions on the kernel's out and
  lse, and the plain backward against torch.autograd of the plain
  forward. Returns the raw max abs errors (dk/dv, dq), the worst scaled
  errors (kernel vs plain, plain vs autograd) and the worst absolute
  error of a gradient that is zero in exact arithmetic."""
  import torch
  from tensor2robot_tpu_torch.ops.flash_attention import (
      flash_attention_backward,
      flash_attention_backward_reference,
      flash_attention_reference,
      flash_attention_with_lse,
  )
  out, lse = flash_attention_with_lse(q, k, v, causal=causal)
  got = flash_attention_backward(q, k, v, out, lse, do, dlse, causal=causal)
  torch.cuda.synchronize()
  if q.dtype == torch.bfloat16:  # no atomics: a second run, the same bits
    again = flash_attention_backward(q, k, v, out, lse, do, dlse,
                                     causal=causal)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
      raise AssertionError(f"flash bwd {name}: two runs differ")
  leaves = [x.detach().requires_grad_() for x in (q, k, v)]
  ref_out, ref_lse = flash_attention_reference(*leaves, causal=causal)
  tol_out, tol_lse = _FLASH_TOL[str(q.dtype)]
  err_out = (out.float() - ref_out.detach().float()).abs().max().item()
  err_lse = (lse - ref_lse.detach()).abs().max().item()
  if err_out > tol_out or err_lse > tol_lse:
    raise AssertionError(f"flash bwd {name}: forward out differs by "
                         f"{err_out} (tol {tol_out}), lse by {err_lse} "
                         f"(tol {tol_lse})")
  want = flash_attention_backward_reference(q, k, v, out, lse, do, dlse,
                                            causal=causal)
  plain = flash_attention_backward_reference(
      q, k, v, ref_out.detach(), ref_lse.detach(), do, dlse, causal=causal)
  auto = torch.autograd.grad(
      (ref_out, ref_lse), leaves,
      (do, torch.zeros_like(ref_lse) if dlse is None else dlse))
  raw, scaled, at_zero = [], [0.0, 0.0], 0.0
  for grad, g, w, p, a in zip(("dq", "dk", "dv"), got, want, plain, auto):
    if g.shape != q.shape or g.dtype != q.dtype:
      raise AssertionError(f"flash bwd {name}: {grad} {g.shape} {g.dtype}")
    if not bool(torch.isfinite(g).all()):
      raise AssertionError(f"flash bwd {name}: non-finite {grad}")
    zero = q.shape[1] == 1 and dlse is None and grad != "dv"
    tol, auto_tol = ((_ZERO_GRAD_TOL, _ZERO_GRAD_TOL) if zero else
                     (_FLASH_BWD_TOL[str(q.dtype)],
                      _FLASH_AUTOGRAD_TOL[str(q.dtype)]))
    err, err_auto = _grad_err(g, w, zero), _grad_err(p, a, zero)
    if err > tol or err_auto > auto_tol:
      raise AssertionError(
          f"flash bwd {name}: {grad} kernel vs plain {err} (tol {tol}), "
          f"plain vs autograd {err_auto} (tol {auto_tol})"
          + (" absolute: zero in exact arithmetic" if zero else " scaled"))
    if zero:
      at_zero = max(at_zero, err, err_auto)
    else:
      scaled = [max(scaled[0], err), max(scaled[1], err_auto)]
    raw.append((g.float() - w.float()).abs().max().item())
  return (max(raw[1:]), raw[0]), tuple(scaled), at_zero


def _strided_qkv(b, t, h, d, dtype, seed, requires_grad=False):
  """The training path's layout: q, k, v are views of one qkv tensor."""
  import torch
  g = torch.Generator(device="cuda").manual_seed(seed)
  qkv = torch.randn((b, t, 3 * h, d), generator=g, device="cuda").to(dtype)
  qkv.requires_grad_(requires_grad)
  return qkv, qkv.split(h, dim=2)


def phase_flash_bwd_kernels():
  import torch
  from tensor2robot_tpu_torch.ops.flash_attention import (
      _meets_tma_rule,
      flash_attention,
      flash_attention_bwd_dkdv,
      flash_attention_bwd_dq,
      flash_attention_reference,
  )
  worst, worst_scaled, worst_zero = {}, {}, 0.0
  grid = lambda dims: itertools.product(  # noqa: E731
      (False, True), (32, 512, 100, 1), dims, (1, 16),
      (torch.bfloat16, torch.float32), (False, True))
  # D = 32, 64 (seeds as before), then D = 16 (the default model's head
  # dim) and 128.
  cases = itertools.chain(grid((32, 64)), grid((16, 128)))
  n = 0
  for i, (causal, t, d, b, dtype, with_dlse) in enumerate(cases):
    q, k, v, do = (_flash_inputs(b, t, 4, d, dtype, seed=300 + i)
                   + _flash_inputs(b, t, 4, d, dtype, seed=700 + i)[:1])
    g = torch.Generator(device="cuda").manual_seed(900 + i)
    dlse = (torch.randn((b, 4, t), generator=g, device="cuda")
            if with_dlse else None)
    name = (f"causal={causal} T={t} D={d} B={b} {dtype} "
            f"dlse={'random' if with_dlse else 'zero'}")
    errs, scaled, at_zero = check_flash_bwd(name, q, k, v, do, dlse, causal)
    worst_zero = max(worst_zero, at_zero)
    key = str(dtype)
    worst[key] = tuple(max(x, y) for x, y in zip(worst.get(key, (0, 0)),
                                                 errs))
    worst_scaled[key] = tuple(max(x, y) for x, y in zip(
        worst_scaled.get(key, (0, 0)), scaled))
    n += 1
  # The training path: strided q/k/v views of one qkv tensor under
  # autograd at D = 32 and 16. dO non-contiguous: a transposed view that
  # TMA reads in place, and (D=16) views TMA cannot read (head dim not
  # dense; base 2 bytes off 16), which the wrapper copies dense first.
  g = torch.Generator(device="cuda").manual_seed(97)
  strided = {}
  for d, layout, seed in ((32, "transposed", 98), (16, "transposed", 96),
                          (16, "head dim strided", 95),
                          (16, "base off 16 B", 94)):
    qkv, (q, k, v) = _strided_qkv(16, 32, 4, d, torch.bfloat16, seed=seed,
                                  requires_grad=True)
    do = torch.randn((16, 4, 32, d), generator=g, device="cuda").to(
        torch.bfloat16).transpose(1, 2)
    if layout == "head dim strided":
      do = do.transpose(-1, -2).contiguous().transpose(-1, -2)
    elif layout == "base off 16 B":
      do = torch.cat([do.new_zeros(1), do.flatten()])[1:].view(do.shape)
    tma_ok = _meets_tma_rule(do)
    if tma_ok != (layout == "transposed"):
      raise AssertionError(f"strided views: dO {layout} meets TMA's rule: "
                           f"{tma_ok}")
    before = (flash_attention_bwd_dkdv.launches,
              flash_attention_bwd_dq.launches)
    got = torch.autograd.grad(flash_attention(q, k, v, causal=True), qkv,
                              do)[0]
    torch.cuda.synchronize()
    after = (flash_attention_bwd_dkdv.launches,
             flash_attention_bwd_dq.launches)
    want = torch.autograd.grad(
        flash_attention_reference(q, k, v, causal=True)[0], qkv, do)[0]
    err = _grad_err(got, want)
    if (after[0] - before[0], after[1] - before[1]) != (1, 1):
      raise AssertionError(f"strided views D={d} dO {layout}: backward "
                           f"launches {before} -> {after}, expected one each")
    if err > _FLASH_AUTOGRAD_TOL["torch.bfloat16"]:
      raise AssertionError(f"strided views D={d} dO {layout}: d(qkv) "
                           f"differs by {err} scaled")
    strided[f"D={d} dO {layout}"] = err
  _log(f"kernel check flash_attention backward: {n} cases + strided views, "
       f"max_abs_err (dk/dv, dq) = {json.dumps(worst)}; worst scaled error "
       f"(kernel vs plain, plain vs autograd) = {json.dumps(worst_scaled)}; "
       f"zero gradients {worst_zero} absolute; strided d(qkv) vs autograd "
       f"of the plain forward (scaled) {json.dumps(strided)}; bf16 kernels "
       f"run twice per case, identical bits; "
       f"tolerances (scaled) kernel {json.dumps(_FLASH_BWD_TOL)} autograd "
       f"{json.dumps(_FLASH_AUTOGRAD_TOL)}, zero gradients {_ZERO_GRAD_TOL} "
       f"absolute")
  return (max(pair[0] for pair in worst.values()),
          max(pair[1] for pair in worst.values()))


_TRAIN_STEPS = 60


def train_step_card_vs_cpu(label, model32, gen, lr):
  """One f32 train step of `model32` on the card and on the CPU from the
  same seeded weights and the same first batch of `gen`: loss,
  grad_norm, every gradient and every parameter after the Adam update."""
  import torch
  from tensor2robot_tpu_torch.data import Mode
  torch.backends.cudnn.allow_tf32 = False
  features, labels = next(iter(gen.create_dataset(Mode.TRAIN)))
  results = {}
  for device in ("cuda", "cpu"):
    st = model32.create_train_state(seed=0, device=device)
    f = {k: torch.as_tensor(v).to(device)
         for k, v in features.to_flat_dict().items()}
    lab = {k: torch.as_tensor(v).to(device)
           for k, v in labels.to_flat_dict().items()}
    grads, stats, m = model32.train_grads(st, f, lab)
    new = model32.apply_gradients(st, grads, stats)
    results[device] = ({k: v.item() for k, v in m.items()},
                       {k: g.cpu() for k, g in grads.items()},
                       {k: p.cpu() for k, p in new.params.items()})
  torch.backends.cudnn.allow_tf32 = True
  (m_card, g_card, p_card), (m_cpu, g_cpu, p_cpu) = (results["cuda"],
                                                     results["cpu"])
  # Tolerances. loss and grad_norm: 1e-4 relative (f32 sums over the
  # batch in other orders). Each gradient: 1e-3 of its leaf's largest
  # |value|. Parameters after Adam's first step, p - lr·g/(|g| + 1e-8):
  # 1e-6 where |g| >= 1e-6 (there the step is ±lr to f32 rounding); up to
  # 2·lr where |g| < 1e-6, since there summation order can flip g's sign.
  metric_err = max(abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-12)
                   for k in ("loss", "grad_norm"))
  grad_err = max((g_card[k] - g_cpu[k]).abs().max().item()
                 / max(g_cpu[k].abs().max().item(), 1e-12) for k in g_cpu)
  far, near, n_near = 0.0, 0.0, 0
  for k in p_cpu:
    diff = (p_card[k] - p_cpu[k]).abs()
    small = g_cpu[k].abs() < 1e-6
    n_near += int(small.sum())
    if bool((~small).any()):
      far = max(far, diff[~small].max().item())
    if bool(small.any()):
      near = max(near, diff[small].max().item())
  _log(f"card vs CPU f32 train step ({label}, B=16, T=32): loss "
       f"{m_card['loss']} vs {m_cpu['loss']}, grad_norm "
       f"{m_card['grad_norm']} vs {m_cpu['grad_norm']}; max rel metric err "
       f"{metric_err} (tol 1e-4), max per-leaf rel grad err {grad_err} over "
       f"{len(g_cpu)} leaves (tol 1e-3), param err {far} where |g|>=1e-6 "
       f"(tol 1e-6), {near} over {n_near} elements where |g|<1e-6 (tol "
       f"{2 * lr})")
  if (metric_err > 1e-4 or grad_err > 1e-3 or far > 1e-6
      or near > 2 * lr):
    raise AssertionError(f"card and CPU train steps differ ({label})")


_DEFAULT_STEPS = 10


def phase_default_model():
  """`VRGripperTransformerModel()` at its own defaults: width 64, depth 2,
  4 heads (head dim 16), context 512, attention "auto", bf16, Adam at
  1e-4, random weights from seed 0. It serves one episode through
  `evaluate_gripper_policy` (flash launches = depth per policy step) and
  trains 10 steps through `train_eval_model` at the gin's training shape
  (batch 16, sequence_length 32) over 16 seeded expert episodes (the
  forward, dK/dV and dQ launches each = depth per step); then one f32
  train step of that model on the card against the CPU."""
  import tempfile
  import numpy as np
  import torch
  from tensor2robot_tpu_torch.data import EpisodeInputGenerator
  from tensor2robot_tpu_torch.ops.flash_attention import (
      flash_attention,
      flash_attention_bwd_dkdv,
      flash_attention_bwd_dq,
  )
  from tensor2robot_tpu_torch.research.vrgripper import (
      VRGripperTransformerModel,
      evaluate_gripper_policy,
      gin_config,
  )
  from tensor2robot_tpu_torch.telemetry.records import read_records
  from tensor2robot_tpu_torch.train_eval import train_eval_model

  model = VRGripperTransformerModel()
  head_dim = model.create_network().trunk.block0.attn.head_dim
  if head_dim != 16:
    raise AssertionError(f"the default model's head dim is {head_dim}")

  # ---- serving: one episode, the forward's count read around it ----
  policy = model.make_context_policy(model.create_inference_state(seed=0))
  flash_attention.launches = 0
  metrics = evaluate_gripper_policy(policy, num_episodes=1, image_size=48,
                                    seed=12)
  serve_launches = flash_attention.launches
  if (policy.steps < 1 or serve_launches != model.depth * policy.steps
      or not np.isfinite(metrics["mean_final_distance"])):
    raise AssertionError(f"default model served {policy.steps} steps with "
                         f"{serve_launches} flash launches: {metrics}")

  # ---- training: 10 steps, the three kernels' counts read around it ----
  episodes = gin_config.expert_episodes(16, seed=13)
  gen = EpisodeInputGenerator(episodes,
                              sequence_length=gin_config.GIN_SEQUENCE_LENGTH,
                              batch_size=gin_config.GIN_BATCH_SIZE, seed=0)
  counters = (flash_attention, flash_attention_bwd_dkdv,
              flash_attention_bwd_dq)
  with tempfile.TemporaryDirectory() as model_dir:
    for fn in counters:
      fn.launches = 0
    state = train_eval_model(model, model_dir, gen,
                             max_train_steps=_DEFAULT_STEPS,
                             batch_size=gin_config.GIN_BATCH_SIZE,
                             log_every_steps=1, seed=0)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    records = read_records(os.path.join(model_dir, "metrics_train.jsonl"))
  want = model.depth * _DEFAULT_STEPS
  losses = [r["loss"] for r in records]
  if state.step != _DEFAULT_STEPS or any(n != want
                                         for n in launches.values()):
    raise AssertionError(f"default model: step {state.step}, launches "
                         f"{launches}: each should be depth x steps = {want}")
  if len(losses) != _DEFAULT_STEPS or not all(np.isfinite(
      losses + [r["grad_norm"] for r in records])):
    raise AssertionError(f"default model: training metrics {records}")
  _log(f"main path (default VRGripperTransformerModel(): width 64, depth 2, "
       f"4 heads, head dim 16, context 512, bf16): served {policy.steps} "
       f"steps (flash_attention launches {serve_launches}) "
       f"{json.dumps(metrics)}; trained {_DEFAULT_STEPS} steps (batch 16, "
       f"sequence_length 32) launches={json.dumps(launches)} loss[0]="
       f"{losses[0]} loss[-1]={losses[-1]}")
  train_step_card_vs_cpu(
      "default model, head dim 16",
      VRGripperTransformerModel(device_dtype=torch.float32), gen, 1e-4)
  return serve_launches, launches


def phase_train_slice():
  import tempfile
  import numpy as np
  import torch
  from tensor2robot_tpu_torch.data import EpisodeInputGenerator
  from tensor2robot_tpu_torch.ops.flash_attention import (
      flash_attention,
      flash_attention_bwd_dkdv,
      flash_attention_bwd_dq,
  )
  from tensor2robot_tpu_torch.research.vrgripper import (
      evaluate_gripper_policy,
      gin_config,
  )
  from tensor2robot_tpu_torch.telemetry.records import read_records
  from tensor2robot_tpu_torch.train_eval import train_eval_model

  # The gin's model and training shape (batch 16, sequence_length 32) over
  # 64 seeded expert episodes of 24 to 40 steps.
  model = gin_config.gin_model()
  episodes = gin_config.expert_episodes(64, seed=11)
  gen = EpisodeInputGenerator(episodes,
                              sequence_length=gin_config.GIN_SEQUENCE_LENGTH,
                              batch_size=gin_config.GIN_BATCH_SIZE, seed=0)
  lengths = sorted(len(ep["action"]) for ep in episodes)

  # ---- the main path, with the kernels' launch counts read around it ----
  with tempfile.TemporaryDirectory() as model_dir:
    counters = (flash_attention, flash_attention_bwd_dkdv,
                flash_attention_bwd_dq)
    for fn in counters:
      fn.launches = 0
    t0 = time.perf_counter()
    state = train_eval_model(model, model_dir, gen,
                             max_train_steps=_TRAIN_STEPS,
                             batch_size=gin_config.GIN_BATCH_SIZE,
                             log_every_steps=1, seed=0)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    with open(os.path.join(model_dir, "metrics_train.jsonl")) as f:
      raw = [json.loads(line) for line in f]
    records = read_records(os.path.join(model_dir, "metrics_train.jsonl"))
  want = model.depth * _TRAIN_STEPS
  if state.step != _TRAIN_STEPS or any(n != want for n in launches.values()):
    raise AssertionError(f"step {state.step}, launches {launches}: each "
                         f"should be depth x steps = {want}")
  if (len(raw) != _TRAIN_STEPS
      or any(set(r) != {"step", "wall", "role", "payload"} for r in raw)
      or [r["step"] for r in raw] != list(range(1, _TRAIN_STEPS + 1))):
    raise AssertionError(f"metrics_train.jsonl lacks the envelope: {raw[:2]}")
  mse = [r["mse"] for r in records]
  losses = [r["loss"] for r in records]
  if not all(np.isfinite(losses + mse + [r["grad_norm"] for r in records])):
    raise AssertionError(f"non-finite training metrics: {losses}")
  first, last = float(np.mean(mse[:10])), float(np.mean(mse[-10:]))
  if not last < first:
    raise AssertionError(f"mse did not fall: first 10 {first}, last 10 {last}")
  _log(f"main path (vrgripper transformer training): steps={_TRAIN_STEPS} "
       f"batch=16 sequence_length=32 episodes=64 (lengths {lengths[0]}-"
       f"{lengths[-1]}) launches={json.dumps(launches)} wall_s={wall_s} "
       f"(first step builds cuDNN/cuBLAS plans) mse first10={first} "
       f"last10={last} loss[0]={losses[0]} loss[-1]={losses[-1]}")

  # ---- the trained state serves one episode ----
  policy = model.make_context_policy(state)
  metrics = evaluate_gripper_policy(policy, num_episodes=1, image_size=48,
                                    seed=5)
  if policy.steps < 1 or not np.isfinite(metrics["mean_final_distance"]):
    raise AssertionError(f"trained policy: {policy.steps} steps, {metrics}")
  _log(f"trained policy served {policy.steps} steps: {json.dumps(metrics)}")

  # ---- the card against the CPU: one f32 train step, same weights/batch ----
  train_step_card_vs_cpu("gin width", gin_config.gin_model(torch.float32),
                         gen, gin_config.GIN_LEARNING_RATE)
  return launches, model, state, gen


def phase_train_timings(model, state, gen):
  import torch
  import torch.nn.functional as F
  from tensor2robot_tpu_torch.data import Mode
  from tensor2robot_tpu_torch.ops.flash_attention import (
      _delta,
      flash_attention_bwd_dkdv,
      flash_attention_bwd_dkdv_reference,
      flash_attention_bwd_dq,
      flash_attention_bwd_dq_reference,
      flash_attention_reference,
      flash_attention_with_lse,
  )
  from tensor2robot_tpu_torch.bin import kernel_bounds

  # The backward kernels at the training shape, on its layout.
  b, t, h, d = 16, 32, 4, 32
  _, (q, k, v) = _strided_qkv(b, t, h, d, torch.bfloat16, seed=400)
  do = _flash_inputs(b, t, h, d, torch.bfloat16, seed=401)[0]
  out, lse = flash_attention_with_lse(q, k, v, causal=True)
  delta = _delta(out, do, None)
  qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
  run_fk = lambda: flash_attention_with_lse(q, k, v, causal=True)  # noqa: E731
  run_fl = lambda: F.scaled_dot_product_attention(  # noqa: E731
      qt, kt, vt, is_causal=True)
  # In turns kernel, library, library, kernel; then the plain version.
  fwd_a, sdpa_a, sdpa_b, fwd_b = (_graph_ms(run_fk), _graph_ms(run_fl),
                                  _graph_ms(run_fl), _graph_ms(run_fk))
  fwd_plain = _graph_ms(lambda: flash_attention_reference(q, k, v,
                                                          causal=True))
  _log(f"timing flash_attention_fwd B={b} T={t} H={h} D={d} bf16 causal "
       f"(training shape): device kernel_ms={fwd_a},{fwd_b} plain_ms="
       f"{fwd_plain} sdpa_ms={sdpa_a},{sdpa_b} | bound_ms="
       f"{kernel_bounds.flash_forward(b, t, h, d, 2, True)[0]}")
  # The backward pair at the gin's training shape (D=32), at the default
  # model's head dim (D=16), at T=64 (the tile that T=32 fills half of,
  # full) and at T=512, where a CTA walks 8 tiles: each
  # kernel and its plain version in turns (plain, kernel, kernel, plain),
  # SDPA's backward (fwd+bwd minus fwd, in turns) and δ, the row term the
  # wrapper computes before the pair (SDPA's backward computes its own, so
  # pair + δ is the like-for-like sum).
  by_shape = {}
  for b, t, h, d in ((16, 32, 4, 32), (16, 32, 4, 16), (16, 64, 4, 32),
                     (16, 512, 4, 32)):
    shape = f"B={b} T={t} H={h} D={d}"
    _, (q, k, v) = _strided_qkv(b, t, h, d, torch.bfloat16,
                                seed=400 + (d != 32) + 2 * (t != 32)
                                + 4 * (t == 64))
    do = _flash_inputs(b, t, h, d, torch.bfloat16, seed=401)[0]
    out, lse = flash_attention_with_lse(q, k, v, causal=True)
    delta = _delta(out, do, None)
    rows = {}
    for name, kern, plain, bound in (
        ("flash_attention_bwd_dkdv", flash_attention_bwd_dkdv,
         flash_attention_bwd_dkdv_reference,
         kernel_bounds.flash_backward_dkdv),
        ("flash_attention_bwd_dq", flash_attention_bwd_dq,
         flash_attention_bwd_dq_reference, kernel_bounds.flash_backward_dq)):
      run_k = lambda: kern(q, k, v, do, lse, delta, True)  # noqa: E731
      run_p = lambda: plain(q, k, v, do, lse, delta, True)  # noqa: E731
      plain_a, kern_a = _graph_ms(run_p), _graph_ms(run_k)
      kern_b, plain_b = _graph_ms(run_k), _graph_ms(run_p)
      bound_ms, bound_by = bound(b, t, h, d, 2, True)
      rows[name] = dict(ms=statistics.median([kern_a, kern_b]),
                        plain_ms=statistics.median([plain_a, plain_b]),
                        bound_ms=bound_ms, bound_by=bound_by)
      _log(f"timing {name} {shape} bf16 causal: device kernel_ms="
           f"{kern_a},{kern_b} plain_ms={plain_a},{plain_b} | bound_ms="
           f"{bound_ms} ({bound_by})")
    delta_ms = _graph_ms(lambda: _delta(out, do, None))
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)
    run_f = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True)
    run_fb = lambda: torch.autograd.grad(  # noqa: E731
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
        (qt, kt, vt), dot)
    f_a, fb_a, fb_b, f_b = (_graph_ms(run_f), _graph_ms(run_fb),
                            _graph_ms(run_fb), _graph_ms(run_f))
    sdpa_bwd = (statistics.median([fb_a, fb_b])
                - statistics.median([f_a, f_b]))
    for row in rows.values():
      row["library_ms"] = sdpa_bwd
    pair = sum(r["ms"] for r in rows.values())
    _log(f"timing SDPA {shape}: fwd_ms={f_a},{f_b} fwd+bwd_ms={fb_a},{fb_b} "
         f"-> bwd_ms={sdpa_bwd}; dK/dV + dQ kernels {pair} ms, delta_ms="
         f"{delta_ms}, pair + delta {pair + delta_ms} ms, pair / SDPA "
         f"{pair / sdpa_bwd}, (pair + delta) / SDPA "
         f"{(pair + delta_ms) / sdpa_bwd}")
    by_shape[shape] = rows
  rows = by_shape["B=16 T=32 H=4 D=32"]  # the gin's training shape

  # The whole train step at the gin shape (B=16, T=32, bf16, depth 4).
  features, labels = next(iter(gen.create_dataset(Mode.TRAIN)))
  f = {k: torch.as_tensor(x).cuda() for k, x in features.to_flat_dict().items()}
  lab = {k: torch.as_tensor(x).cuda() for k, x in labels.to_flat_dict().items()}
  step = lambda: model.train_step(state, f, lab)  # noqa: E731
  step_graph = _graph_ms(step, iters=5)
  step_eager = _median_ms(step, iters=10)
  _log(f"timing train step (B=16, T=32, bf16, depth 4, Adam): device "
       f"(graph replay) ms={step_graph}; eager per step ms={step_eager}")
  return rows, step_graph, step_eager


# ---- the fused CEM head tail (the QT-Opt Q-network's population tail) ----

# Kernel vs plain version, max |ΔQ|. f32: the same arithmetic in another
# order (9·C1 products per conv output, then the positions' sum). bf16:
# both round the merged activation, the pooled features and each hidden
# layer to bf16 from f32 values summed in other orders, so a rounding may
# tip to the other neighbour (2^-8 of a value); Q itself is not rounded.
_HEAD_TOL = {"torch.float32": 1e-5, "torch.bfloat16": 2e-2}


def _head_inputs(b, p, h, w, c1, c2, hidden, dtype, seed, c=64,
                 verify=False):
  """Head-tail inputs on the card, values rounded to `dtype`, act from a
  merge GEMM a1 [B·P, C] @ v [C, h·w·C1]. `verify`: tests/test_cem_head.py's
  construction, 0.3·N(0, 1) everywhere. Otherwise the conv taps are
  0.3·√(64/C1)·N(0, 1), so wider convs sum to the same size, and the
  dense head N(0, 1/fan_in) with 0.1·N(0, 1) biases, so it does not
  amplify a rounding of its inputs."""
  import torch
  g = torch.Generator(device="cuda").manual_seed(seed)

  def f(*shape, scale=0.3):
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)

  a1, enc0, v = f(b * p, c), f(b, h, w, c1), f(c, h * w * c1)
  ck = f(3, 3, c1, c2, scale=0.3 * (64 / c1) ** 0.5)
  scale, shift = f(c2).float(), f(c2).float()
  widths = (c2,) + tuple(hidden) + (1,)
  dense = tuple((f(i, o, scale=0.3 if verify else i ** -0.5),
                 f(o, scale=0.3 if verify else 0.1))
                for i, o in zip(widths[:-1], widths[1:]))
  act = (a1 @ v).reshape(b, p, h, w, c1)
  return act, enc0, ck, scale, shift, dense


def check_head(name, act, enc0, ck, scale, shift, dense):
  import torch
  from tensor2robot_tpu_torch.ops import cem_head
  got = cem_head.fused_cem_head_tail(act, enc0, ck, scale, shift, dense)
  torch.cuda.synchronize()
  want = cem_head.fused_cem_head_tail_reference(act, enc0, ck, scale, shift,
                                                dense)
  if got.shape != want.shape or got.dtype != torch.float32:
    raise AssertionError(f"cem_head {name}: {got.shape} {got.dtype}")
  if not bool(torch.isfinite(got).all()):
    raise AssertionError(f"cem_head {name}: non-finite Q")
  err = (got - want).abs().max().item()
  tol = _HEAD_TOL[str(act.dtype)]
  if err > tol:
    raise AssertionError(f"cem_head {name}: Q differs by {err} > {tol}")
  plan = cem_head.launch_plan(
      tuple(act.shape), ck.shape[-1],
      [ck.shape[-1]] + [w.shape[1] for w, _ in dense], act.dtype)
  _same_bits(f"cem_head {name}", lambda: cem_head.fused_cem_head_tail(
      act, enc0, ck, scale, shift, dense))
  copy = ", act copied dense" if cem_head.needs_dense_copy(act, plan) else ""
  return err, want.abs().max().item(), (
      f"{plan['path']} smem={plan['smem']}{copy}, identical bits on a rerun")


def phase_head_kernels():
  """fused_cem_head_tail against its plain version: the --verify gate's
  case (B=4, P=64, 8×8×64 → 64, dense 64-64-1, bf16), then B = 1, 3,
  256, P = 50, f32, C1 = C2 = 128, a ragged shape (6×10×6 → 10, dense
  10-8-1: channels not a multiple of 4, h1 ≠ w1), two more wgmma shapes
  (32 → 32; 4×16×64 → 32 with dense 32-48-16-1), act as the Q-network's
  P-major tensor seen through a transposed view, and a bf16 view
  outside TMA's rule (copied dense). Every case runs twice for identical
  bits and prints its path."""
  import torch
  bf16, f32 = torch.bfloat16, torch.float32
  cases = [("verify gate B=4 P=64", (4, 64, 8, 8, 64, 64, (64, 64), bf16),
            True)]
  cases += [(f"B={b}", (b, 64, 8, 8, 64, 64, (64, 64), bf16), False)
            for b in (1, 3, 256)]
  cases += [(name, shape, False) for name, shape in (
      ("P=50", (4, 50, 8, 8, 64, 64, (64, 64), bf16)),
      ("f32 B=4", (4, 64, 8, 8, 64, 64, (64, 64), f32)),
      ("f32 B=256", (256, 64, 8, 8, 64, 64, (64, 64), f32)),
      ("C=128 bf16", (4, 64, 8, 8, 128, 128, (64, 64), bf16)),
      ("C=128 f32", (4, 64, 8, 8, 128, 128, (64, 64), f32)),
      ("ragged f32", (3, 5, 6, 10, 6, 10, (8,), f32)),
      ("ragged bf16", (3, 5, 6, 10, 6, 10, (8,), bf16)),
      ("32 -> 32 bf16", (4, 64, 8, 8, 32, 32, (64,), bf16)),
      ("4x16x64 -> 32 bf16", (3, 30, 4, 16, 64, 32, (48, 16), bf16)))]
  worst, lines = {}, []
  for i, (name, shape, verify) in enumerate(cases):
    err, q_max, path = check_head(name, *_head_inputs(
        *shape, seed=500 + i, verify=verify))
    key = str(shape[-1])
    worst[key] = max(worst.get(key, 0.0), err)
    lines.append(f"{name}: {err} (max |Q| {q_max}, {path})")
  for b in (4, 256):
    act, *rest = _head_inputs(b, 64, 8, 8, 64, 64, (64, 64), bf16, seed=600)
    view = act.transpose(0, 1).contiguous().transpose(0, 1)
    err, _, path = check_head(f"P-major view B={b}", view, *rest)
    worst["torch.bfloat16"] = max(worst["torch.bfloat16"], err)
    lines.append(f"P-major view B={b}: {err} ({path})")
  # A bf16 view outside TMA's rule (rows of 65 channels, the base 2 bytes
  # past a 16-byte boundary): the wrapper copies it dense first.
  act, *rest = _head_inputs(4, 64, 8, 8, 64, 64, (64, 64), bf16, seed=601)
  wide = torch.zeros(act.shape[:-1] + (65,), dtype=bf16, device="cuda")
  wide[..., 1:] = act
  err, _, path = check_head("view outside TMA's rule", wide[..., 1:], *rest)
  if "copied dense" not in path:
    raise AssertionError(f"view outside TMA's rule not copied: {path}")
  worst["torch.bfloat16"] = max(worst["torch.bfloat16"], err)
  lines.append(f"view outside TMA's rule B=4: {err} ({path})")
  _log(f"kernel check cem_head_tail: {len(cases) + 3} cases, max_abs_err "
       f"{json.dumps(worst)} (tolerances {json.dumps(_HEAD_TOL)}); "
       + "; ".join(lines))
  return max(worst.values())


def _merge_parts(network, encoded, actions):
  """The Q-network's merge parts for a population: (act as a [B, P, ...]
  view of the P-major GEMM output, enc0)."""
  act_pm, enc0 = network._population_merge_parts(
      encoded, network._population_action_embed({}, actions))
  return act_pm.transpose(0, 1), enc0


def phase_head_bellman(learner, state, replay):
  """fused_cem_head_tail on the Bellman target's own tensors: the trained
  target network (target params, online batch statistics) at
  `GraspingQModel()` width, B=256 next states from the replay buffer,
  P=64. Its path: a 2-iteration CEM whose scores come from the kernel on
  the network's merge parts (the count is read around that run). Then
  its Q against its plain version and against the port's unfused
  `score_population` on the same actions, max |ΔQ| against the Q spread:
  they round at other places (enc0 added in bf16, the conv output rounded
  before batch norm), one bf16 step on the pooled features, so the bound
  is 2e-2 of max(1, max |Q|)."""
  import torch
  from tensor2robot_tpu_torch.models import TrainState
  from tensor2robot_tpu_torch.ops import cem_head
  from tensor2robot_tpu_torch.research.qtopt import cem, networks
  ts = state.train_state
  network = learner.model.bind(TrainState(
      step=0, params=state.target_params, batch_stats=ts.batch_stats))
  image = torch.from_numpy(replay.sample(256).to_flat_dict()["next_image"])
  g = torch.Generator(device="cuda").manual_seed(8)
  noise = torch.randn((2, 256, 64, 4), generator=g, device="cuda")
  with torch.inference_mode():
    encoded = network.encode(image.cuda())
    params = networks.head_tail_params(network)

    def score(actions):
      return cem_head.fused_cem_head_tail(
          *_merge_parts(network, encoded, actions), *params)

    cem_head.fused_cem_head_tail.launches = 0
    result = cem.cem_maximize(score, 256, 4, iterations=2, population=64,
                              num_elites=6, noise=noise)
    torch.cuda.synchronize()
    launches = cem_head.fused_cem_head_tail.launches
    lax = cem.cem_maximize(
        lambda a: network.score_population(encoded, {}, a), 256, 4,
        iterations=2, population=64, num_elites=6, noise=noise)
    actions = (torch.rand((256, 64, 4), generator=g, device="cuda") * 2 - 1)
    parts = _merge_parts(network, encoded, actions)
    q_kernel = cem_head.fused_cem_head_tail(*parts, *params)
    q_plain = cem_head.fused_cem_head_tail_reference(*parts, *params)
    q_unfused = network.score_population(encoded, {}, actions)
  if launches != 2 or not bool(torch.isfinite(result.best_score).all()):
    raise AssertionError(f"head-tail CEM: {launches} launches, best score "
                         f"{result.best_score[:4]}")
  err_plain = (q_kernel - q_plain).abs().max().item()
  err_unfused = (q_kernel - q_unfused).abs().max().item()
  spread = (q_unfused.max() - q_unfused.min()).item()
  bound = 2e-2 * max(1.0, q_unfused.abs().max().item())
  _log(f"cem_head_tail on the Bellman target's tensors (B=256, P=64, "
       f"8x8x64 -> 64, bf16, trained target network): CEM launches="
       f"{launches}, best score max |kernel CEM - score_population CEM| "
       f"{(result.best_score - lax.best_score).abs().max().item()}; Q vs "
       f"plain {err_plain} (tol 2e-2), vs score_population {err_unfused} "
       f"(bound {bound}), Q spread {spread}, max |Q| "
       f"{q_unfused.abs().max().item()}")
  if err_plain > _HEAD_TOL["torch.bfloat16"] or err_unfused > bound:
    raise AssertionError("head tail disagrees on the Bellman tensors")
  return launches, err_plain, network, encoded


_QT_STEPS = 60


def phase_qtopt_train():
  """QT-Opt Bellman training at `GraspingQModel()` width (bf16, batch
  norm, Adam 1e-4; CEM 2 × 64, 6 elites, fused select, γ 0.9, τ 0.05):
  `train_qtopt` takes 60 steps of batch 256 from a replay buffer of 4,096
  synthetic-bandit transitions, with cem_select's count read around the
  run (2 per step); then a second call resumes at step 60 and takes 10."""
  import tempfile
  import numpy as np
  import torch
  from tensor2robot_tpu_torch.data import Mode
  from tensor2robot_tpu_torch.hooks import Hook
  from tensor2robot_tpu_torch.ops import cem_select as select_ops
  from tensor2robot_tpu_torch.research.qtopt import ReplayBuffer
  from tensor2robot_tpu_torch.research.qtopt import synthetic_bandit as bandit
  from tensor2robot_tpu_torch.research.qtopt.train_qtopt import train_qtopt
  from tensor2robot_tpu_torch.telemetry.records import read_records
  from tensor2robot_tpu_torch.utils import checkpoints

  class LossLog(Hook):
    """Keeps every step's loss (device tensors)."""

    def __init__(self):
      self.steps, self.losses = [], []

    def after_step(self, step, metrics):
      self.steps.append(step)
      self.losses.append(metrics["loss"])

  learner = bandit.bellman_learner()
  replay = ReplayBuffer(learner.transition_specification(), capacity=4096,
                        seed=0)
  fill = bandit.bandit_transitions(learner, 4096, seed=1)
  replay.add(fill)
  kwargs = dict(replay_buffer=replay, batch_size=bandit.BATCH_SIZE,
                save_checkpoints_steps=30, log_every_steps=10)
  with tempfile.TemporaryDirectory() as model_dir:
    # ---- the main path, with the kernel's launch count read around it ----
    log = LossLog()
    torch.cuda.reset_peak_memory_stats()
    select_ops.fused_cem_select.launches = 0
    t0 = time.perf_counter()
    state = train_qtopt(learner, model_dir, max_train_steps=_QT_STEPS,
                        hooks=[log], **kwargs)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = select_ops.fused_cem_select.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    path = os.path.join(model_dir, "metrics_train.jsonl")
    with open(path) as f:
      raw = [json.loads(line) for line in f]
    records = read_records(path)
    saved = checkpoints.list_steps(model_dir)
    resumed = LossLog()
    select_ops.fused_cem_select.launches = 0
    state2 = train_qtopt(learner, model_dir, max_train_steps=_QT_STEPS + 10,
                         hooks=[resumed], **kwargs)
    resume_launches = select_ops.fused_cem_select.launches
  losses = [x.item() for x in log.losses]
  if (state.step != _QT_STEPS or log.steps != list(range(1, _QT_STEPS + 1))
      or launches != 2 * _QT_STEPS):
    raise AssertionError(f"step {state.step}, hook steps {log.steps[:3]}.., "
                         f"cem_select launches {launches} != 2 x steps")
  if (len(raw) != _QT_STEPS // 10
      or any(set(r) != {"step", "wall", "role", "payload"} for r in raw)
      or [r["step"] for r in raw] != list(range(10, _QT_STEPS + 1, 10))
      or any(not {"loss", "grad_norm", "q_next_mean", "grad_steps_per_sec",
                  "input_wait_fraction", "replay_fill"} <= set(r)
             for r in records)):
    raise AssertionError(f"metrics_train.jsonl lacks the envelope: {raw[:1]}")
  if not all(np.isfinite(losses)):
    raise AssertionError(f"non-finite losses: {losses}")
  first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
  if not last < first:
    raise AssertionError(f"loss did not fall: first 10 {first}, last 10 "
                         f"{last}")
  if (state2.step != _QT_STEPS + 10
      or resumed.steps != list(range(_QT_STEPS + 1, _QT_STEPS + 11))
      or resume_launches != 20 or saved != [30, 60]):
    raise AssertionError(f"resume: step {state2.step}, steps "
                         f"{resumed.steps}, launches {resume_launches}, "
                         f"saved {saved}")
  # Q(a*) against Q(−a*) (outside the rewarded ball) on fresh states.
  feats = make_random_tensors_flat(learner.model.get_feature_specification(
      Mode.PREDICT), 64, seed=7)
  q = {}
  for name, a in (("a*", bandit.A_STAR), ("-a*", -bandit.A_STAR)):
    f = {k: torch.from_numpy(v).cuda() for k, v in feats.items()}
    f["action"] = torch.from_numpy(np.tile(a, (64, 1))).cuda()
    q[name] = learner.model.predict_step(state2.train_state,
                                         f)["q_value"].float().mean().item()
  _log(f"main path (QT-Opt Bellman training): steps={_QT_STEPS} batch=256 "
       f"replay=4096 (rewarded {float(fill['reward'].mean())}) "
       f"cem_select_launches={launches} wall_s={wall_s} (first step builds "
       f"cuDNN/cuBLAS plans) peak_device_memory_gb={peak_gb} loss first10="
       f"{first} last10={last} loss[0]={losses[0]} loss[-1]={losses[-1]} "
       f"q_next_mean[-1]={records[-1]['q_next_mean']} "
       f"grad_steps_per_sec(last log)={records[-1]['grad_steps_per_sec']} "
       f"input_wait_fraction={records[-1]['input_wait_fraction']}; resumed "
       f"at {_QT_STEPS}, took 10 steps ({resume_launches} launches); mean "
       f"Q(a*)={q['a*']} Q(-a*)={q['-a*']}")
  if not q["a*"] > q["-a*"]:
    raise AssertionError("the learner ranks -a* above a*")
  return launches, learner, state, replay


def make_random_tensors_flat(spec, n, seed):
  from tensor2robot_tpu_torch.specs import make_random_tensors
  return make_random_tensors(spec, batch_size=n, seed=seed).to_flat_dict()


def phase_qtopt_card_vs_cpu():
  """One f32 Bellman step on the card against the CPU at
  `bench.py`'s `_verify_qtopt_metrics` configuration (16×16 images, torso
  (8,), head (8,), dense (16,), action 2, CEM 1 × 8, 2 elites, fused
  select, batch 8): the same seeded params, batch and CEM noise (drawn on
  the CPU) on both."""
  import torch
  from tensor2robot_tpu_torch.research.qtopt import (
      GraspingQModel,
      QTOptLearner,
  )
  torch.backends.cudnn.allow_tf32 = False
  if torch.backends.cuda.matmul.allow_tf32:
    raise AssertionError("f32 matmuls must not run in TF32 here")
  model = GraspingQModel(image_size=16, torso_filters=(8,), head_filters=(8,),
                         dense_sizes=(16,), action_dim=2,
                         device_dtype=torch.float32)
  batch = make_random_tensors_flat(
      QTOptLearner(model, device="cpu").transition_specification(), 8, seed=0)
  noise = torch.randn((1, 8, 8, 2), generator=torch.Generator().manual_seed(1))
  results = {}
  for device in ("cuda", "cpu"):
    learner = QTOptLearner(model, cem_population=8, cem_iterations=1,
                           cem_elites=2, cem_select="fused", device=device)
    st = learner.create_state(seed=0)
    grads, stats, m = learner.train_grads(
        st, {k: torch.from_numpy(v).to(device) for k, v in batch.items()},
        noise=noise.to(device))
    new = learner.apply_gradients(st, grads, stats)
    cpu = lambda d: {k: v.cpu() for k, v in d.items()}  # noqa: E731
    results[device] = ({k: v.item() for k, v in m.items()}, cpu(grads),
                       cpu(new.train_state.params),
                       cpu(new.train_state.batch_stats),
                       cpu(new.target_params))
  torch.backends.cudnn.allow_tf32 = True
  (m_card, g_card, p_card, s_card, t_card), (m_cpu, g_cpu, p_cpu, s_cpu,
                                             t_cpu) = (results["cuda"],
                                                       results["cpu"])
  # Tolerances. loss, grad_norm, q_next_mean: 1e-4 relative. Each
  # gradient and each new batch statistic: 1e-4 / 1e-5 of its leaf's
  # largest |value|. Parameters after Adam's first step (±lr to f32
  # rounding where |g| ≥ 1e-6): 1e-6 there, 2·lr where |g| < 1e-6
  # (summation order can flip g's sign).
  lr, tau = 1e-4, 0.05
  tols = {"params": (1e-6, 2 * lr),
          "target": (tau * 1e-6 + 1.2e-7, tau * 2 * lr + 1.2e-7)}
  metric_err = max(abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-12)
                   for k in ("loss", "grad_norm", "q_next_mean"))
  grad_err = max((g_card[k] - g_cpu[k]).abs().max().item()
                 / max(g_cpu[k].abs().max().item(), 1e-12) for k in g_cpu)
  stat_err = max((s_card[k] - s_cpu[k]).abs().max().item()
                 / s_cpu[k].abs().max().item() for k in s_cpu)
  # Parameters (scale 1) and the Polyak target old + τ·(new − old), held
  # to τ times the parameters' limits plus one f32 step of a weight
  # below 1 (1.2e-7) for the rounding of the add.
  far, near = {}, {}
  for k in p_cpu:
    small = g_cpu[k].abs() < 1e-6
    for name, got, want in (("params", p_card[k], p_cpu[k]),
                            ("target", t_card[k], t_cpu[k])):
      diff = (got - want).abs()
      if bool((~small).any()):
        far[name] = max(far.get(name, 0.0), diff[~small].max().item())
      if bool(small.any()):
        near[name] = max(near.get(name, 0.0), diff[small].max().item())
  _log(f"card vs CPU f32 Bellman step (bench verify config, B=8): loss "
       f"{m_card['loss']} vs {m_cpu['loss']}, grad_norm "
       f"{m_card['grad_norm']} vs {m_cpu['grad_norm']}, q_next_mean "
       f"{m_card['q_next_mean']} vs {m_cpu['q_next_mean']}; max rel metric "
       f"err {metric_err} (tol 1e-4), max per-leaf rel grad err {grad_err} "
       f"over {len(g_cpu)} leaves (tol 1e-4), batch stats {stat_err} (tol "
       f"1e-5 of the leaf's largest), where |g|>=1e-6 {json.dumps(far)}, "
       f"where |g|<1e-6 {json.dumps(near)} (tolerances "
       f"{json.dumps(tols)})")
  if (metric_err > 1e-4 or grad_err > 1e-4 or stat_err > 1e-5
      or any(far.get(k, 0.0) > t[0] or near.get(k, 0.0) > t[1]
             for k, t in tols.items())):
    raise AssertionError("card and CPU Bellman steps differ")


def phase_qtopt_timings(learner, state, replay, network, encoded):
  """The head tail, its plain version and the unfused torch tail
  (`_population_tail` + q-head: cuDNN conv and elementwise passes) on the
  target network's merge parts at B=4 and B=256; then the Bellman train
  step at B=256."""
  import torch
  from tensor2robot_tpu_torch.bin import kernel_bounds
  from tensor2robot_tpu_torch.bin.profile_policy import profile_calls
  from tensor2robot_tpu_torch.ops import cem_head
  from tensor2robot_tpu_torch.research.qtopt import networks
  params = networks.head_tail_params(network)
  rows = {}
  g = torch.Generator(device="cuda").manual_seed(9)
  _log(f"timing launch floor: one-element torch add, device ms per call "
       f"(graph replay) {launch_floor_ms()}")
  for b in (4, 256):
    actions = torch.rand((b, 64, 4), generator=g, device="cuda") * 2 - 1
    with torch.inference_mode():
      act, enc0 = _merge_parts(network, encoded[:b], actions)
    run_k = lambda: cem_head.fused_cem_head_tail(act, enc0,  # noqa: E731
                                                 *params)
    run_p = lambda: cem_head.fused_cem_head_tail_reference(  # noqa: E731
        act, enc0, *params)

    def run_u():
      with torch.inference_mode():
        merged = torch.relu(act.transpose(0, 1) + enc0)
        pooled = network._population_tail(merged.reshape((-1,) + act.shape[2:]))
        return network.q_head(pooled)

    plain_a, kern_a, unf_a = _graph_ms(run_p), _graph_ms(run_k), \
        _graph_ms(run_u)
    unf_b, kern_b, plain_b = _graph_ms(run_u), _graph_ms(run_k), \
        _graph_ms(run_p)
    bound_ms, bound_by = kernel_bounds.cem_head_tail(
        b, 64, 8, 8, 64, 64, (64, 64, 64, 1), 2)
    rows[b] = dict(ms=statistics.median([kern_a, kern_b]),
                   plain_ms=statistics.median([plain_a, plain_b]),
                   unfused_ms=statistics.median([unf_a, unf_b]),
                   bound_ms=bound_ms, bound_by=bound_by)
    _log(f"timing cem_head_tail B={b} P=64 8x8x64 -> 64 bf16: device "
         f"kernel_ms={kern_a},{kern_b} plain_ms={plain_a},{plain_b} "
         f"unfused_torch_tail_ms={unf_a},{unf_b} | bound_ms={bound_ms} "
         f"({bound_by}) | library_ms=null (no single PyTorch call)")

  # The Bellman train step at B=256: CEM noise given whole, so one CUDA
  # graph can capture the step.
  batch = next(replay.as_stream(256)).to_flat_dict()
  batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
  noise = torch.randn((2, 256, 64, 4), generator=g, device="cuda")
  step = lambda: learner.train_step(state, batch, noise=noise)  # noqa: E731
  step_graph = _graph_ms(step, iters=3, repeats=3)
  step_eager = _median_ms(step, iters=10, repeats=3)

  def logged_step():  # the loss's copy to the host synchronizes
    learner.train_step(state, batch, noise=noise)[1]["loss"].item()

  prof = profile_calls(logged_step, calls=10)
  _log(f"timing QT-Opt Bellman train step (B=256, bf16, CEM 2x64 fused): "
       f"device (graph replay) ms={step_graph}; eager per step ms="
       f"{step_eager}; profiler over 10 logged steps: "
       f"{json.dumps(prof)}")
  return rows, step_graph, step_eager, prof


def log_wgmma_kernels(logs):
  """One line per instantiation of the two CEM kernels' wgmma paths:
  ptxas's registers and spill bytes, and the dynamic shared memory a
  launch of it asks for at its smallest shape (P=64, one hidden layer of
  its widest width)."""
  import re
  import torch
  from tensor2robot_tpu_torch.ops import cem_head, cem_select
  bf16 = torch.bfloat16
  for name, log in sorted(logs.items()):
    entry = None
    for line in log.splitlines():
      m = re.search(r"Function properties for (\S+)", line)
      if m:
        entry = m.group(1) if "wgmma" in m.group(1) else None
        continue
      m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                    line)
      if entry and m:
        spill = (int(m.group(1)), int(m.group(2)))
        continue
      m = re.search(r"Used (\d+) registers", line)
      if entry and m:
        args = [int(x) for x in re.findall(r"Li(\d+)E", entry)]
        if "cem_select" in entry:
          kernel = f"cem_select_wgmma<C={args[0]}, H<={args[1]}>"
          smem = cem_select._plan(64, [args[0], args[1], 1], bf16)["smem"]
        else:
          kernel = (f"cem_head_wgmma<C1={args[0]}, C2={args[1]}, "
                    f"H<={args[2]}>")
          smem = cem_head.launch_plan((1, 64, 8, 8, args[0]), args[1],
                                      [args[1], args[2], 1], bf16)["smem"]
        _log(f"ptxas {name}.cu {kernel}: registers={m.group(1)} "
             f"spill_stores={spill[0]} spill_loads={spill[1]} "
             f"dynamic_smem={smem}")
        entry = None


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
  logs = {}
  per_kernel = build.build(sources, ptxas_verbose=True, logs=logs)
  _log(f"build: {json.dumps(per_kernel)} wall_s={time.perf_counter() - t0}")
  log_wgmma_kernels(logs)

  max_err = phase_kernels()
  flash_err = phase_flash_kernels()
  launches, learner, state = phase_slice()
  flash_launches, context_policy = phase_gripper_slice()
  rows = phase_timings(learner, state)
  flash_rows, _ = phase_flash_timings(context_policy)
  bwd_errs = phase_flash_bwd_kernels()
  train_launches, train_model, train_state, gen = phase_train_slice()
  bwd_rows, _, _ = phase_train_timings(train_model, train_state, gen)
  phase_default_model()
  head_err = phase_head_kernels()
  _, qt_learner, qt_state, replay = phase_qtopt_train()
  head_launches, _, target_net, encoded = phase_head_bellman(
      qt_learner, qt_state, replay)
  phase_qtopt_card_vs_cpu()
  head_rows, _, _, _ = phase_qtopt_timings(qt_learner, qt_state, replay,
                                           target_net, encoded)
  main_row = rows[8]  # the serving path's largest bucket
  head_row = head_rows[256]  # the Bellman target's shape
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
  }] + [{
      "name": name,
      "route": "cuda",
      "source": "tensor2robot_tpu_torch/csrc/flash_attention_bwd.cu",
      "replaces": replaces,
      "launches": train_launches[name],
      "max_abs_err": err,
      **{key: bwd_rows[name][key] for key in ("ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms")},
  } for name, replaces, err in (
      ("flash_attention_bwd_dkdv",
       "tensor2robot_tpu/ops/flash_attention.py:404", bwd_errs[0]),
      ("flash_attention_bwd_dq",
       "tensor2robot_tpu/ops/flash_attention.py:434", bwd_errs[1]))] + [{
      "name": "cem_head_tail",
      "route": "cuda",
      "source": "tensor2robot_tpu_torch/csrc/cem_head.cu",
      "replaces": "tensor2robot_tpu/ops/cem_head.py:161",
      "launches": head_launches,
      "max_abs_err": head_err,
      **{key: head_row[key] for key in ("ms", "plain_ms", "bound_ms",
                                        "bound_by")},
      "library_ms": None,
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
