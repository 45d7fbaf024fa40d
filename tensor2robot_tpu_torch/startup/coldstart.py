"""Cold-start probes: time to first step / time to first prediction (port
of `startup/coldstart.py`).

Each probe is ONE process lifetime: run them as subprocesses, so that
nothing loaded in a process can fake a warm start; only the kernel build
cache (`compile_cache`) and the checkpoint survive between the cold and
the warm run. A probe prints one `COLDSTART_JSON {...}` marker line:

  * `time_to_first_*_secs`: wall from probe entry (imports done) to the
    first train step's metrics on the host / the first prediction's
    outputs on the host. Imports are left out of the headline, as in
    JAX: they are the same cold and warm.
  * `compile_watch`: `CompileWatch` counts. In the port "compile" is a
    kernel library's `nvcc` build into the cache directory; a warm probe
    must report `cache_misses == 0`.
  * trainer probes embed the trainer's own `startup_timings.json`.

Probe topology (the same for `--tiny`, with smaller nets):

  setup  seeds a checkpoint (trainer: 2 train steps + save; serving: one
         checkpoint of a fresh state), untimed.
  probe  resumes/restores from that checkpoint with the given cache dir
         and reports the marker. Run it twice with the same cache dir:
         run 1 is the cold measurement (and fills the cache), run 2 the
         warm one.

    python -m tensor2robot_tpu_torch.startup.coldstart trainer \
        --model-dir DIR --setup
    python -m tensor2robot_tpu_torch.startup.coldstart trainer \
        --model-dir DIR --cache-dir CACHE          # cold, then warm

The probes run on the card; `--device cpu` runs them on the CPU (the
tests' tiny probes).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

SETUP_STEPS = 2
PROBE_STEPS = 2  # the resumed run trains SETUP_STEPS → SETUP_STEPS+2


def _build_trainer_model(tiny: bool):
  if tiny:
    from tensor2robot_tpu_torch.utils.mocks import MockT2RModel
    return MockT2RModel(), 8
  # The QT-Opt grasping critic with a deepened torso, f32 and batch 8,
  # as in JAX: the measured quantity is startup, not throughput.
  import torch

  from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
      GraspingQModel,
  )
  return GraspingQModel(torso_filters=(64, 96, 96),
                        head_filters=(96, 96),
                        dense_sizes=(96, 96),
                        device_dtype=torch.float32), 8


def _build_serving_model(tiny: bool):
  if tiny:
    from tensor2robot_tpu_torch.utils.mocks import MockT2RModel
    return MockT2RModel()
  from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
      GraspingQModel,
  )
  return GraspingQModel()


def _device_kind(device) -> str:
  import torch
  if device.type == "cuda":
    return torch.cuda.get_device_name(device)
  return "cpu"


def trainer_setup(model_dir: str, tiny: bool, device=None) -> dict:
  """Seeds `model_dir` with a checkpoint at SETUP_STEPS."""
  from tensor2robot_tpu_torch import train_eval
  from tensor2robot_tpu_torch.data import RandomInputGenerator

  model, batch_size = _build_trainer_model(tiny)
  train_eval.train_eval_model(
      model=model,
      model_dir=model_dir,
      input_generator_train=RandomInputGenerator(batch_size=batch_size,
                                                 seed=3),
      max_train_steps=SETUP_STEPS,
      save_checkpoints_steps=SETUP_STEPS,
      log_every_steps=SETUP_STEPS,
      device=device,
  )
  return {"setup": "ok", "steps": SETUP_STEPS}


def trainer_probe(model_dir: str, cache_dir: str, tiny: bool,
                  device=None) -> dict:
  """Restart: resume from the seeded checkpoint, time the first step."""
  from tensor2robot_tpu_torch import train_eval
  from tensor2robot_tpu_torch.data import RandomInputGenerator
  from tensor2robot_tpu_torch.device import resolve_device
  from tensor2robot_tpu_torch.hooks import Hook
  from tensor2robot_tpu_torch.startup.compile_cache import (
      CompileWatch,
      cache_entry_count,
      configure_compilation_cache,
  )
  from tensor2robot_tpu_torch.startup.orchestrator import (
      STARTUP_TIMINGS_FILE,
  )

  configure_compilation_cache(cache_dir=cache_dir)
  device = resolve_device(device)
  t0 = time.perf_counter()

  class FirstStepTimer(Hook):
    ttfs = None

    def after_step(self, step, metrics):
      if self.ttfs is None:
        # A host read of a metric: the step has finished on the device.
        float(next(iter(metrics.values())))
        self.ttfs = time.perf_counter() - t0

  timer = FirstStepTimer()
  model, batch_size = _build_trainer_model(tiny)
  with CompileWatch() as watch:
    train_eval.train_eval_model(
        model=model,
        model_dir=model_dir,
        input_generator_train=RandomInputGenerator(batch_size=batch_size,
                                                   seed=3),
        max_train_steps=SETUP_STEPS + PROBE_STEPS,
        save_checkpoints_steps=SETUP_STEPS + PROBE_STEPS,
        log_every_steps=SETUP_STEPS + PROBE_STEPS,
        hooks=[timer],
        device=device,
    )
  try:
    with open(os.path.join(model_dir, STARTUP_TIMINGS_FILE)) as f:
      startup_timings = json.load(f)
  except (OSError, ValueError):
    startup_timings = None
  return {
      "probe": "trainer",
      "tiny": tiny,
      "device_kind": _device_kind(device),
      "time_to_first_step_secs": round(timer.ttfs, 3),
      "startup_timings": startup_timings,
      "compile_watch": watch.counts(),
      "cache_entries_after": cache_entry_count(cache_dir),
  }


def serving_setup(ckpt_dir: str, tiny: bool, device=None) -> dict:
  """Seeds one checkpoint a predictor can restore."""
  from tensor2robot_tpu_torch.utils import checkpoints as ckpt_lib

  model = _build_serving_model(tiny)
  state = model.create_inference_state(seed=0, device=device)
  writer = ckpt_lib.CheckpointWriter(ckpt_dir, max_to_keep=None)
  writer.save(1, state)
  return {"setup": "ok", "step": 1}


def serving_probe(ckpt_dir: str, cache_dir: str, tiny: bool,
                  device=None) -> dict:
  """Restart: restore ∥ capture-ahead, then time the first prediction."""
  import numpy as np

  from tensor2robot_tpu_torch.device import resolve_device
  from tensor2robot_tpu_torch.predictors import CheckpointPredictor
  from tensor2robot_tpu_torch.specs import make_random_tensors
  from tensor2robot_tpu_torch.startup.compile_cache import (
      CompileWatch,
      cache_entry_count,
      configure_compilation_cache,
  )

  configure_compilation_cache(cache_dir=cache_dir)
  device = resolve_device(device)
  t0 = time.perf_counter()
  model = _build_serving_model(tiny)
  max_batch = 2 if tiny else 4
  with CompileWatch() as watch:
    predictor = CheckpointPredictor(
        model, checkpoint_dir=ckpt_dir, max_batch=max_batch,
        warmup=True, overlap_startup=True, device=device)
    restored = predictor.restore(timeout_secs=0)
    restore_done = time.perf_counter() - t0
    batch = make_random_tensors(
        predictor.feature_specification, batch_size=1, seed=0)
    outputs = predictor.predict(
        {k: np.asarray(v) for k, v in batch.to_flat_dict().items()})
    float(np.asarray(next(iter(outputs.values()))).ravel()[0])
    ttfp = time.perf_counter() - t0
  result = {
      "probe": "serving",
      "tiny": tiny,
      "device_kind": _device_kind(device),
      "restored": bool(restored),
      "time_to_first_prediction_secs": round(ttfp, 3),
      "restore_and_warmup_secs": round(restore_done, 3),
      "engine_warmup_secs": round(predictor.warmup_seconds, 3),
      "compiled_buckets": list(predictor.serving_engine.compiled_buckets),
      "compile_watch": watch.counts(),
      "cache_entries_after": cache_entry_count(cache_dir),
  }
  predictor.close()
  return result


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument("probe", choices=("trainer", "serving"))
  parser.add_argument("--model-dir", required=True,
                      help="trainer model_dir / serving checkpoint dir")
  parser.add_argument("--cache-dir", default=None,
                      help="kernel build cache dir (required unless "
                           "--setup)")
  parser.add_argument("--tiny", action="store_true",
                      help="mock-model variant (the tests' smoke)")
  parser.add_argument("--setup", action="store_true",
                      help="seed the checkpoint instead of probing")
  parser.add_argument("--device", default=None,
                      help="cpu, or the card (default)")
  args = parser.parse_args(argv)
  if not args.setup and not args.cache_dir:
    parser.error("--cache-dir is required unless --setup")

  if args.probe == "trainer":
    if args.setup:
      result = trainer_setup(args.model_dir, args.tiny, args.device)
    else:
      result = trainer_probe(args.model_dir, args.cache_dir, args.tiny,
                             args.device)
  else:
    if args.setup:
      result = serving_setup(args.model_dir, args.tiny, args.device)
    else:
      result = serving_probe(args.model_dir, args.cache_dir, args.tiny,
                             args.device)
  print("COLDSTART_JSON " + json.dumps(result))
  return 0


if __name__ == "__main__":
  sys.exit(main())
