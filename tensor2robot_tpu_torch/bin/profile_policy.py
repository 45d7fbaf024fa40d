"""Where a CEM policy dispatch spends its time on the card.

    python -m tensor2robot_tpu_torch.bin.profile_policy [--batches 8 256]

Runs `QTOptLearner.build_policy()` at `GraspingQModel()`'s full width
(bf16, random weights from seed 0, CEM 2 × 64 samples, 6 elites,
cem_select="fused") under `torch.profiler` and prints, per batch size:
the wall time per dispatch (host clock around synchronized calls), the
device-busy time per dispatch (sum of kernel times), the device's idle
share, the number of kernel launches per dispatch, and the kernels
that take the most device time. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from tensor2robot_tpu_torch.research.qtopt import GraspingQModel, QTOptLearner
from tensor2robot_tpu_torch.specs import make_random_tensors


def _device_time_us(event) -> float:
  for attr in ("device_time_total", "cuda_time_total"):
    value = getattr(event, attr, None)
    if value is not None:
      return float(value)
  return 0.0


def profile(batch: int, dispatches: int = 20, top: int = 8) -> dict:
  learner = QTOptLearner(GraspingQModel(), cem_iterations=2,
                         cem_population=64, cem_elites=6,
                         cem_select="fused")
  state = learner.create_state(seed=0)
  obs = {k: torch.from_numpy(v).cuda() for k, v in make_random_tensors(
      learner.observation_specification(), batch_size=batch,
      seed=1).to_flat_dict().items()}
  policy = learner.build_policy()
  gen = torch.Generator(device="cuda").manual_seed(0)
  for _ in range(5):
    policy(state, obs, generator=gen)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(dispatches):
    policy(state, obs, generator=gen)
  torch.cuda.synchronize()
  wall_ms = (time.perf_counter() - t0) / dispatches * 1e3

  acts = [torch.profiler.ProfilerActivity.CPU,
          torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=acts) as prof:
    for _ in range(dispatches):
      policy(state, obs, generator=gen)
    torch.cuda.synchronize()
  kernels = [e for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
  busy_us = sum(_device_time_us(e) for e in kernels)
  launches = sum(e.count for e in kernels)
  ranked = sorted(kernels, key=_device_time_us, reverse=True)[:top]
  busy_ms = busy_us / dispatches / 1e3
  return {
      "batch": batch,
      "wall_ms_per_dispatch": wall_ms,
      "device_busy_ms_per_dispatch": busy_ms,
      "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
      "kernel_launches_per_dispatch": launches / dispatches,
      "top_kernels": [{"name": e.key[:80],
                       "ms_per_dispatch": _device_time_us(e)
                       / dispatches / 1e3,
                       "calls_per_dispatch": e.count / dispatches}
                      for e in ranked],
  }


def main():
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--batches", type=int, nargs="+", default=[8, 256])
  args = parser.parse_args()
  if not torch.cuda.is_available():
    raise SystemExit("profile_policy needs a CUDA card")
  print(f"device: {torch.cuda.get_device_name(0)}")
  for batch in args.batches:
    print(json.dumps(profile(batch)), flush=True)


if __name__ == "__main__":
  main()
