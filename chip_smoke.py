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
     (graph replay, eager, profiler);
 13. the flash wrapper's head-dim padding (D = 24 and 48, forward,
     backward and autograd, bf16 and f32) and batch chunking (B·H =
     65,540: two launches) against the plain versions;
 14. the compiled dispatch as CUDA graphs (utils/step_graph.py): Bellman
     training 8 steps eager against K=1 and K=4 graphed and a resume at
     K=4 (f32 and bf16: every state leaf and loss bit for bit; cuDNN's
     deterministic algorithms, after two eager runs under its default
     are compared and printed), with cem_select's launches 2 a step past
     each graph's warm-up; its rate (steps after the first dispatch over
     their wall time, gated at 100 grad steps/s, and input_wait_fraction)
     over 200 steps graphed at K=1 and 8 and eager, and its idle share;
 15. BC training (`train_eval_model`) of the gin-width and the default
     model in f32 and bf16: eager against K=1 and K=4 graphed, with
     evaluations and a resume (the gin width's in bf16 only), every
     state leaf and logged metric bit for bit; steps_per_sec graphed and
     eager;
 16. CEM serving: every bucket graphed against eager (actions, scores),
     compile_count, warmup_async, swap_state under four robots' traffic
     (each answer that of its params version), p50/p95 wall per dispatch;
 17. the context policy graphed against eager over one episode (the
     same actions), p50/p95 wall per step;
 18. not run here (the time limit): each path's profile graphed and
     eager is `python -m tensor2robot_tpu_torch.bin.profile_policy
     [--graphs]`'s;
 19. cem_select against its plain version at the online path's shapes:
     the serving buckets 2, 4, 16 and 32, the evaluation's B=512, and
     the seedcheck's test-size widths (C=8: CUDA cores), rerun for
     identical bits;
 20. the offline→online grasp protocol at `GraspingQModel()` width
     through `bin/run_success_protocol.py` (fused select, K=50): 2000
     offline steps on 16384 random grasps, then 2000 online steps with a
     server-wired `GraspActor`, a `ReplayWriteService` and the refresh
     hook, scored at every 500-step checkpoint on 512 episodes (CEM 64 ×
     3); gated at success ≥ 0.50 at step 2000, online final ≥ offline
     final − 0.10, episodes collected, no actor crash, no writer error;
     each phase's rate is its steps past the first log interval over
     their wall time; then a traced window of the online loop (20 more
     steps at K=10, checkpoints every 10, the actor running) whose CUPTI
     launches must equal the counters, with cem_select's launches
     measured per path (learner, evaluation, the server's warm-up,
     serving dispatches) and held to what each path should launch;
 21. the offline phase again with cem_select="lax", 100 of its 2000
     steps (the cut; printed, not gated);
 22. the native row gather (`utils/native.py`) built, loaded and equal to
     numpy on the protocol replay's dtypes, and one B=256 gather of the
     Bellman transition timed native against numpy;
 23. the protocol's seedcheck on the card: two synchronous collect →
     flush → sample passes with the same digests, two procedural sweeps
     and two Anakin runs (cuDNN deterministic) with the same digests;
 24. an actor batch's split (env, CEM dispatch of 32, commit);
 25. cem_select against its plain version on the int8 CEM tower's pooled
     features (`quantized_pool_population`, `GraspingQModel()` width,
     bf16) at B = 8 and 256, rerun for identical bits;
 26. the int8 tower on the card against the CPU (f32, B=16): int8
     weights, each quantizer on the same input, the codes along each
     device's own forward, the quantized scores;
 27. int8 Bellman training (the JAX bench's flagship config, B=256, CEM
     2 × 64) with the lax and the fused select: `train_qtopt` calibrates
     and takes 60 graphed steps (traced; the loss must fall), graphed
     equals eager bit for bit (f32), and the int8 actions against the
     bf16 tower's under the exact scorer (value regret < 5% of spread);
 28. the four tower × select Bellman steps' rates (200 graphed steps),
     device ms and idle share, and the population path's device ms in
     int8 against bf16;
 29. the multi-tenant serving plane: a `ServingFront` over a budgeted
     `ModelArena` (four tenants, three fit) with an
     `AdmissionController`, six caller threads for ~10 s (one tenant
     offered 10× its rate), evictions and reloads that build no kernel,
     a single-request dispatch equal to the engine's answer,
     `SpeculativeCEM` (refined answers never cross a swap), and traced
     windows whose launches are held per thread;
 30. the shipped `qtopt_int8.gin` as written through
     `python -m tensor2robot_tpu_torch.bin.run_t2r_trainer --trainer=qtopt`
     (1000 steps, B=256, int8 tower, lax select, `shard_weight_update =
     True`): exit 0, a valid record envelope every 100 steps, the loss
     falling, checkpoints at 500 and 1000, grad_steps_per_sec printed;
 31. the same file in-process through the port's gin registry with
     `QTOptLearner.cem_select = "fused"` and 200 steps bound on top:
     cem_select launched from a gin-configured learner, 2 a step + the
     warm-up's, traced;
 32. the shipped `train_pose_env.gin` as written through the trainer
     binary (200 steps, B=64, a 500-episode success hook at each
     checkpoint): exit 0, success records at steps 100 and 200, every
     record a valid envelope;
 33. the shipped `serving_multitenant.gin` parsed into the registry:
     `ModelArena()` and `ServingFront(arena)` from its bindings, with
     `ModelArena.cache_dir` checked as shipped and then bound on top to
     a temporary directory (the shipped path is shared by every run on
     the host), the admission envelope checked, two fused tenants
     serving 2 × 64 requests in a traced window, a forced eviction and
     reload;
 34. the same stack's cache contract in two new processes over one
     temporary directory: the first builds cem_select into it at its
     first load and nothing at its reload (cache_misses == 0), the
     second finds the library (cache_misses == 0 at both loads);
 35. the data plane: `collect_demo_episodes` writes 100 seeded episodes
     as TFRecords (SequenceExample, PNG frames) and the port's
     `TFRecordEpisodeInputGenerator` in EVAL mode yields exactly the
     batches `EpisodeInputGenerator` builds from the same episodes in
     memory; then the gin's TRAIN-mode parse rate alone (batches/s, ms
     per batch) at `num_workers` 0 over that file and over the same
     episodes in 4 files, and at `num_workers` 2 (worker processes over
     the shm ring) over the 4 files for 20 batches, each batch laid out
     as the serial stream's;
 36. the shipped `train_vrgripper_transformer.gin` as written through
     the trainer binary in a new process, with the header's two
     bindings and one cut (400 of its 2000 steps: exit 0, a record
     every 100 steps, the loss falling, a checkpoint at 400, steps/s per
     interval, the wall time), then in-process
     with 20 steps bound on top, traced (4 + 4 + 4 flash launches a
     step);
 37. a capture during which the cyclic garbage collector would reclaim
     a dead object that releases a CUDA graph (the collector's threshold
     at 1, such garbage made as the step is captured): a bare
     `torch.cuda.graph` capture of the step is the control (the graph's
     destructor must invalidate it at least once), and `StepGraph`, which
     holds the collector off, must capture every time and replay the
     eager step;
 38. JPEG on the card's host, which has no TensorFlow: the SHA-256 of
     the port's bytes for two seeded images (64×64×3 and 37×53×3) and of
     the pixels it decodes from them equal constants that
     `tests/test_torch_jpeg.py` pins against `tf.io.encode_jpeg` /
     `tf.io.decode_image`; a grasp2vec batch's 192 frames decoded;
 39. the shipped `train_grasp2vec.gin` from JPEG TFRecords:
     `collect_grasp_triplets` writes 1024 seeded triplets (and 640 to
     evaluate), the trainer binary runs the gin as written in a new
     process with the model dir, the two file patterns and
     max_train_steps 400 bound (the gin's 10000, cut for the time
     limit): resnet-18 at 64 filters, embedding 128, bf16, batch 64,
     Adam 1e-4; exit 0, the loss falling, a checkpoint at 400, eval
     records; `CheckpointPredictor` restores it and `evaluate_retrieval`
     over 50 held-out queries gives top-1 ≥ 0.5 (chance 1/6); then the
     stream's parse rate alone, the graphed step's device ms, and the f32
     model on the card against the CPU (outputs, one train step);
 40. goal-conditioned QT-Opt from those labels: `make_grasp2vec_reward_fn`
     over the trained checkpoint labels 256 fresh triplets,
     `relabel_transitions` fills a `ReplayBuffer`, and `train_qtopt`
     takes 50 graphed Bellman steps at B=256 over `GraspingQModel(
     extra_state_features={"goal_embedding": (128,)})` (CEM 2 × 64, 6
     elites, fused select): the loss falls, cem_select's launches equal
     CUPTI's, 2 a step + 2 in the warm-up step;
 41. the shipped `train_vrgripper_bc.gin` from PNG TFRecords through the
     trainer binary (100 seeded demos; MDN BC at batch 64 of
     transitions), bound: the model dir, the demos, and the cuts
     max_train_steps 2000 → 400 and the
     SuccessEvalHook's 500 episodes → 100; exit 0, a record every 100
     steps, the loss falling, a checkpoint at 400,
     `evaluate_gripper_policy`'s success_rate at each; then the train
     step's device ms graphed and
     eager, and the f32 model card against CPU;
 42. `train_vrgripper_meta.gin` (SNAIL, 8 tasks of 4 demo + 4 query
     steps) the same way (the loss held below the untrained model's),
     then the same file with `@VRGripperMAMLModel()` bound, 20 graphed
     second-order steps in this process; step times and card vs CPU of
     both (MAML adapting on the demos);
 43. `train_vrgripper_wtl.gin` (the retrial policy on random batches
     from its specs) the same way (the loss held below the untrained
     model's), then step times and card vs CPU of both policy types on
     scripted WTL batches; the family launches no hand-written kernel;
 44. the functional envs (envs/) on the card against the CPU: 1024 pose
     and procgen envs at 64×64 (noisy and at noise 0) reset on the CPU
     and copied over, their frames and one step's poses, frames, rewards
     and dones bit for bit; the noisy table from the same normals; the
     env steps/s of render + auto-reset step alone, graphed and eager;
 45. cem_select against its plain version at the Anakin path's shapes
     (B = 1024 with A = 2 and C = 64; B = 256 with C = 32; C = 8 at B = 64
     and 8), rerun for identical bits, the B = 1024 case timed;
 46. the shipped `qtopt_anakin.gin` as written through the trainer binary
     (`--trainer=anakin`, lax select, 500 of its 1000 steps: the cut),
     then in this process
     with `QTOptLearner.cem_select = "fused"` (500 steps, the cut, steps 401-412
     traced: cem_select's launches = CUPTI's = 16 an iteration, and no
     host-to-device copy above 1 KiB); every record's
     `param_refresh_lag_steps` 0.0 and finite loss and rates;
 47. the shipped `qtopt_anakin_pod.gin` on this one card (the pod
     program at D = 1; 500 of its 1000 steps, the one cut: phase 51 runs
     the same program to 1000), with `ScenarioSuccessEvalHook`'s line at
     the checkpoint;
 48. the success protocol's `envs` mode at full size (success per bucket
     above the random baseline), `gripper --small`, and the new envs and
     Anakin halves of phase 23's seedcheck;
 49. the MoE layer at `train_vrgripper_transformer_moe.gin`'s shape (512
     tokens, 8 experts, top-2, C = 256, width 128 → 512) on the card
     against the CPU: the same dispatch tensor, the output within 1e-5
     (f32) and 2e-2 (bf16) of its scale; its device ms beside the dense
     MLP's;
 50. the shipped `train_vrgripper_transformer_moe.gin` as written through
     the trainer binary from the demos (500 of its 2000 steps, the cut;
     the overlapped
     startup, the aux loss in every record, the perf plane's `perf.mfu`,
     `perf.flops_per_sec`, `perf.device_time_fraction`, `stall_fraction`,
     `input_wait_fraction` and `rsrc.device0_mem_bytes` in every record),
     then 20 steps in this process traced (flash launches = CUPTI), then
     the trained checkpoint serving 32 graphed context-policy steps;
 51. the shipped `qtopt_anakin_shardmap.gin` as written through the
     trainer binary (the shard_map pod program at D = 1, the qtopt rules
     table, 1000 steps): the pod records, two sweeps on one scenario
     digest, `perf.mfu` from the analytic count;
 52. the pod gin and the shardmap gin 16 steps each under cuDNN's
     deterministic algorithms, equal bit for bit; the shardmap gin with
     the fused select traced (cem_select = CUPTI);
 53. `train_vrgripper_bc.gin` resumed 20 → 40 steps overlapped and
     serial, equal bit for bit, with each start's phase seconds and wall
     to the first step; (phase 30 also gates `qtopt_int8.gin`'s
     `perf.mfu`);
 54. the flash forward through the operator `torch.ops.t2r.
     flash_attention_fwd` at the gin's shapes (B = 1, T = 512 and B =
     16, T = 32; H = 4, D = 32, bf16) against the plain version; its
     fake implementation's shapes, dtypes and strides = the kernel's;
 55. the model handoff at the gin's width: 20 graphed steps with
     `create_exporters_fn = @create_default_exporters` and an async
     `AsyncExportHook`, each export traced for the card and the CPU;
     `SavedModelPredictor()` polls and loads the newest on the card and
     serves B = 1, 8 × T = 32, 512, equal to `CheckpointPredictor` on
     the same checkpoint (2e-2 of scale), the CPU's program within 6e-2
     of the card's, the flash launches inside the loaded program =
     CUPTI, `parse_tf_sequence_example` over serialized episodes =
     `serving_default`; export, load, first-prediction seconds and the
     graphed p50;
 56. three async exports of the card's program (up to six, until a
     capture has ended inside one) while the training thread captures
     eval graphs: no capture invalidated;
 57. `GraspingQModel()` warm-started from a checkpoint: params and BN
     statistics equal bit for bit on the card before the first step;
 58. the cold-start probes (`startup/coldstart.py` trainer and serving,
     full size; cold and warm probes in processes of their own): the
     warm ones build no kernel (`cache_misses == 0`); time to the first
     step and prediction (the seeds are made here; the probes run
     beside phases 60–62, contended);
 59. `ProfilerHook` over 5 of the gin's graphed training steps:
     `utils.xplane.top_ops(compute_only=True)` names the three flash
     kernels, their sum within 1.05 × the device's busy time;
 60. the in-process `train_qtopt` at `qtopt_fleet.gin`'s widths (B =
     64, 500 steps) as the yardstick, then the shipped `qtopt_fleet.gin`
     through `run_t2r_trainer --trainer=fleet` with `FleetConfig.env =
     "pose"` bound (the gin's `mujoco_pose` is not ported): a host, two
     actors and a learner
     process, 200 steps (the gin's 500 cut); exit 0 and no child alive
     after; the processes holding the card, sampled every second (each
     child's open `/dev/nvidia<N>`) and self-reported
     (`proc.cuda_initialized`), exactly the host and the learner; the
     served params' digests equal the learner's final checkpoint's;
     4 publications; the `FleetResult`'s rates, lag and staleness
     (mean, p50, p99);
 61. `qtopt_fleet_elastic.gin` (the same binding, 200 steps) with one
     actor crashing mid-episode after 3 batches and the learner after
     125 steps (a fault plan's `learner_crash`, bound through
     `--import_modules`): one actor restart and one learner resume, each in
     `recoveries` with its MTTR, the resume from the step-100
     checkpoint, no partial episode rows, a clean shutdown;
 62. `qtopt_serving_replicated.gin` (`qtopt_fleet_tcp.gin`: TCP, 2
     serving hosts, 2 replay shards, 4 actors; plus 2 fronts with
     speculative CEM and the routers' dedup; 200 steps) run by `python
     -m tensor2robot_tpu_torch.fleet.traffic` (the binary's parse and
     `Fleet.run`) with 4 robots on "policy" (one per actor, 10 Hz, a
     router each, one frame sequence 25 ms apart) and the "policy"
     home front crashing at its 40th serve (a non-recurring fault
     plan): the card held by exactly the two hosts, the learner and
     the two fronts, both hosts serving the last publication (the same
     version and digests as the final checkpoint), every request
     answered with finite actions, a failover inside a call, the front
     respawned and re-admitted, both fronts at the final checkpoint by
     digest, at least one refined speculative answer, a clean shutdown;
 63. `qtopt_fleet_autopilot.gin` (400 steps, 1 s polls) under a ramp
     on "policy" calibrated as `bench.py --control` calibrates its
     (0.3, 0.8, 1.6 × a front's measured capacity, open-loop) and 2
     robots on "batch": every decision record valid, the actor rules
     decided where the polled `replay.adds` rates held their condition,
     a latency rule actuated, each actuation's effect in the fleet, at
     most 4 actuations, no control page, every request answered or
     refused by a live front's admission, the card held by the hosts,
     the learner and the fronts only, a clean shutdown;
 64. `qtopt_fleet_hybrid.gin` (200 steps; `qtopt_fleet_tcp.gin`'s 2
     serving and 2 shard hosts with a 2-process learner group, each
     rank 32 of the 64 rows, and one Anakin pod of 32 pose envs × 4
     steps beside one process actor): the card held by exactly the two
     serving hosts, both learner ranks and the pod (not the actor nor
     the shards); only rank 0 publishes (`publishes ==
     params_version`); both ranks end at the final checkpoint's params
     by digest, which the root host serves; the pod's rows whole
     128-row segments; `param_refresh_lag` rows from the actor and the
     pod; the group's learner steps/s and the pod's env steps/s;
 65. the learner group's step on the card: two gloo ranks on `cuda:0`,
     each on 32 of 64 seeded rows with the CEM noise injected, against
     one process's step on the 64 rows (f32 within the CPU tests'
     tolerances, bf16 by gradient cosine ≥ 0.99, the ranks equal bit
     for bit);
     60–64 run side by side, five fleets on the card at once, after
     the yardstick ran alone, so their printed rates are contended
     (65, 58's probes and 34's cache contract run beside them);
     then the cem_select launches per path (each traced in its own run),
     the wall seconds of each phase, the `kernels` JSON line
     (cem_select's count: the CEM serving path of phase 4), the card
     line, and the result line last.

Phases 38–40 are paid for by the tracing, not by depth: every traced
run records CUDA activity only (the counts read device kernel events;
recording the host's ops as well cost seconds of event processing per
traced run, most of the BC and Bellman graph phases' time).

Every run whose launches are checked (the main paths of phases 4, 5, 7,
8, 10 and 11, the chunked forward of 13, each run of 14 and 15, the
online window of 20, the int8 training runs of 27, the windows of 29,
the gin-configured runs of 31, 33, 36 and 50, the Bellman run of 40, the
Anakin window of 46, the fused shardmap run of 52, the operator's calls
of 54 and the loaded program's of 55) runs
under the profiler's CUDA kernel tracing: each kernel wrapper's count,
replays included, must equal the launches of that kernel's symbols that
the card ran (`traced_launches`), and the `kernels` line reports the
traced launches.

Exits 2 without a result when CUDA is unavailable.
"""

import contextlib
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time

def _log(*args):
  print(*args, flush=True)


def _reset_counts():
  """Every kernel's launch count, and the graph warm-up tally, to 0."""
  from tensor2robot_tpu_torch.ops import reset_launch_counts
  reset_launch_counts()


def _warm(name):
  """Launches of `name` made by graph warm-ups since `_reset_counts()`:
  a graphed path runs its step once before capturing it."""
  from tensor2robot_tpu_torch.ops import warmup_launch_counts
  return warmup_launch_counts()[name]


# Each kernel's CUDA symbols (csrc/*.cu), as the profiler's kernel events
# name them: demangled, after their namespace, before a template's
# arguments or the parameters ("void (anonymous
# namespace)::cem_select_wgmma<64, 64>(CUtensorMap_st, ...").
_SYMBOLS = {
    "cem_select": ("cem_select_kernel", "cem_select_wgmma"),
    "cem_head_tail": ("cem_head_mma_kernel", "cem_head_core_kernel",
                      "cem_head_wgmma"),
    "flash_attention_fwd": ("flash_fwd_f32", "flash_fwd_bf16"),
    "flash_attention_bwd_dkdv": ("flash_bwd_dkdv_f32", "flash_bwd_dkdv_bf16"),
    "flash_attention_bwd_dq": ("flash_bwd_dq_f32", "flash_bwd_dq_bf16"),
}


_TRACE_LEAD_S = 1.0
_TRACE_MARKERS = 256
_TRACE_MARGIN_S = 0.1
_FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dkdv",
                  "flash_attention_bwd_dq")


@contextlib.contextmanager
def traced_launches(label, trace_path=None):
  """Sets every launch count to 0, runs the block under the profiler's
  CUDA kernel tracing (CUPTI, which also traces each kernel that a graph
  replay launches), and fills the dict it yields with the launches the
  card ran per kernel, matched by symbol. Fails unless every wrapper's
  count equals its kernel's traced launches: a replay adds the counts
  its capture recorded, so this holds that tally to what ran. With
  `trace_path` the trace is also written there (chrome format)."""
  import torch
  from tensor2robot_tpu_torch.ops import launch_counts
  patterns = {name: re.compile(r"(?<!\w)(?:%s)(?=[<(])" % "|".join(syms))
              for name, syms in _SYMBOLS.items()}
  traced = {}
  _reset_counts()
  torch.cuda.synchronize()
  # CUDA activity only: the counts read device kernel events, and the
  # host ops a CPU trace adds (several per kernel of an eager step) cost
  # seconds of event processing per traced run.
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    # A trace can lack the device events of its session's first moments:
    # on an H100 a session lost the kernels it ran 0.1 s after its start,
    # and another all 256 markers it ran at once. So the block starts
    # after a margin, behind marker kernels (spin loops) whose count in
    # the trace shows how close the loss came to it.
    time.sleep(_TRACE_LEAD_S)
    for _ in range(_TRACE_MARKERS):
      torch.cuda._sleep(1000)
    yield traced
    torch.cuda.synchronize()
    time.sleep(_TRACE_MARGIN_S)
  if trace_path is not None:
    prof.export_chrome_trace(trace_path)
  counted = launch_counts()
  traced.update({name: 0 for name in patterns})
  device_events = {}
  for event in prof.key_averages():
    if event.device_type != torch.autograd.DeviceType.CUDA:
      continue
    device_events[event.key] = event.count
    for name, pattern in patterns.items():
      if pattern.search(event.key):
        traced[name] += event.count
  markers = sum(n for key, n in device_events.items() if "spin_kernel" in key)
  _log(f"traced launches, {label}: {json.dumps(traced)} (markers traced "
       f"{markers} of {_TRACE_MARKERS})")
  if traced != counted:
    raise AssertionError(f"{label}: the wrappers counted {counted}, the "
                         f"card ran {traced}; the trace's device events "
                         f"{sum(device_events.values())}: "
                         f"{sorted(device_events.items())[:20]}")


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
  from tensor2robot_tpu_torch.utils.step_graph import collector_held
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    for _ in range(3):
      fn()
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with collector_held(), torch.cuda.graph(graph):
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
  d0 = engine.dispatch_count
  barrier = threading.Barrier(4)
  robots = {}

  def robot(i):
    obs = make_random_tensors(spec, batch_size=1, seed=20 + i)
    barrier.wait()
    robots[i] = server.select_actions(obs.to_flat_dict())

  with traced_launches("CEM serving") as traced:
    answers = [server.select_actions(
        make_random_tensors(spec, batch_size=n, seed=10 + n).to_flat_dict())
        for n in (1, 3, 8)]
    threads = [threading.Thread(target=robot, args=(i,)) for i in range(4)]
    for t in threads:
      t.start()
    for t in threads:
      t.join(timeout=300)
  launches = traced["cem_select"]
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
  t0 = time.perf_counter()
  with traced_launches("context policy") as traced:
    metrics = evaluate_gripper_policy(recorder, num_episodes=3,
                                      image_size=48, seed=1)
  wall_s = time.perf_counter() - t0
  launches = traced["flash_attention_fwd"]
  warm = _warm("flash_attention_fwd")
  steps = policy.steps
  for a in recorder.actions:
    if a.shape != (1, 3) or not np.all(np.isfinite(a)):
      raise AssertionError(f"bad action {a.shape}: {a}")
  if policy.resets != 3 or len(recorder.actions) != steps or steps < 3:
    raise AssertionError(f"resets {policy.resets}, steps {steps}, "
                         f"actions {len(recorder.actions)}")
  if launches != model.depth * steps + warm or warm != model.depth:
    raise AssertionError(f"flash launches {launches} != depth "
                         f"{model.depth} x policy steps {steps} + the "
                         f"graph's warm-up {warm}")
  _log(f"main path (vrgripper transformer, one CUDA-graph replay per "
       f"step): episodes=3 steps={steps} resets={policy.resets} "
       f"flash_attention_launches={launches} (warm-up {warm}) "
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


def train_step_card_vs_cpu(label, model32, gen, lr, shape="B=16, T=32"):
  """One f32 train step of `model32` on the card and on the CPU from the
  same seeded weights and the same first batch of `gen` (`shape`, for
  the log): loss, grad_norm, every gradient and every parameter after
  the Adam update."""
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
  _log(f"card vs CPU f32 train step ({label}, {shape}): loss "
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
  with traced_launches("default model serving") as traced:
    metrics = evaluate_gripper_policy(policy, num_episodes=1, image_size=48,
                                      seed=12)
  serve_launches = traced["flash_attention_fwd"]
  if (policy.steps < 1 or serve_launches != model.depth * (policy.steps + 1)
      or not np.isfinite(metrics["mean_final_distance"])):
    raise AssertionError(f"default model served {policy.steps} steps with "
                         f"{serve_launches} flash launches: {metrics}")

  # ---- training: 10 steps, the three kernels' counts read around it ----
  episodes = gin_config.expert_episodes(16, seed=13)
  gen = EpisodeInputGenerator(episodes,
                              sequence_length=gin_config.GIN_SEQUENCE_LENGTH,
                              batch_size=gin_config.GIN_BATCH_SIZE, seed=0)
  with tempfile.TemporaryDirectory() as model_dir:
    with traced_launches("default model training") as traced:
      state = train_eval_model(model, model_dir, gen,
                               max_train_steps=_DEFAULT_STEPS,
                               batch_size=gin_config.GIN_BATCH_SIZE,
                               log_every_steps=1, seed=0)
    launches = {name: traced[name] for name in _FLASH_KERNELS}
    records = read_records(os.path.join(model_dir, "metrics_train.jsonl"))
  # One graph replay per step, and the graph's one warm-up step.
  want = model.depth * (_DEFAULT_STEPS + 1)
  losses = [r["loss"] for r in records]
  if state.step != _DEFAULT_STEPS or any(n != want
                                         for n in launches.values()):
    raise AssertionError(f"default model: step {state.step}, launches "
                         f"{launches}: each should be depth x (steps + the "
                         f"warm-up step) = {want}")
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
    t0 = time.perf_counter()
    with traced_launches("BC training") as traced:
      state = train_eval_model(model, model_dir, gen,
                               max_train_steps=_TRAIN_STEPS,
                               batch_size=gin_config.GIN_BATCH_SIZE,
                               log_every_steps=1, seed=0)
    wall_s = time.perf_counter() - t0
    launches = {name: traced[name] for name in _FLASH_KERNELS}
    warm = {name: _warm(name) for name in _FLASH_KERNELS}
    with open(os.path.join(model_dir, "metrics_train.jsonl")) as f:
      raw = [json.loads(line) for line in f]
    records = read_records(os.path.join(model_dir, "metrics_train.jsonl"))
  want = model.depth * _TRAIN_STEPS
  if state.step != _TRAIN_STEPS or any(
      n != want + warm[k] or warm[k] != model.depth
      for k, n in launches.items()):
    raise AssertionError(f"step {state.step}, launches {launches}: each "
                         f"should be depth x steps = {want} + the graph's "
                         f"warm-up {warm}")
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
  _log(f"main path (vrgripper transformer training, one CUDA-graph replay "
       f"per step): steps={_TRAIN_STEPS} "
       f"batch=16 sequence_length=32 episodes=64 (lengths {lengths[0]}-"
       f"{lengths[-1]}) launches={json.dumps(launches)} (warm-up "
       f"{json.dumps(warm)}) wall_s={wall_s} "
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

    with traced_launches("head-tail CEM") as traced:
      result = cem.cem_maximize(score, 256, 4, iterations=2, population=64,
                                num_elites=6, noise=noise)
    launches = traced["cem_head_tail"]
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
    t0 = time.perf_counter()
    with traced_launches("Bellman training") as traced:
      state = train_qtopt(learner, model_dir, max_train_steps=_QT_STEPS,
                          hooks=[log], **kwargs)
    wall_s = time.perf_counter() - t0
    launches = traced["cem_select"]
    warm = _warm("cem_select")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    path = os.path.join(model_dir, "metrics_train.jsonl")
    with open(path) as f:
      raw = [json.loads(line) for line in f]
    records = read_records(path)
    saved = checkpoints.list_steps(model_dir)
    resumed = LossLog()
    with traced_launches("Bellman training, resumed") as traced:
      state2 = train_qtopt(learner, model_dir,
                           max_train_steps=_QT_STEPS + 10, hooks=[resumed],
                           **kwargs)
    resume_launches = traced["cem_select"]
    resume_warm = _warm("cem_select")
  losses = [x.item() for x in log.losses]
  if (state.step != _QT_STEPS or log.steps != list(range(1, _QT_STEPS + 1))
      or warm != 2 or launches != 2 * _QT_STEPS + warm):
    raise AssertionError(f"step {state.step}, hook steps {log.steps[:3]}.., "
                         f"cem_select launches {launches} != 2 x steps + "
                         f"the graph's warm-up {warm}")
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
      or resume_launches != 20 + resume_warm or resume_warm != 2
      or saved != [30, 60]):
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
  _log(f"main path (QT-Opt Bellman training, one CUDA-graph replay per "
       f"step): steps={_QT_STEPS} batch=256 "
       f"replay=4096 (rewarded {float(fill['reward'].mean())}) "
       f"cem_select_launches={launches} (warm-up {warm}) wall_s={wall_s} "
       f"(first step builds "
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


# ---- the compiled dispatch: CUDA graphs on every hot path ----


def phase_flash_padded():
  """The flash wrapper's head-dim padding and batch chunking: D = 24 and
  48 (padded to 32 and 64, scale 1/√D of the true D) forward and
  backward against the plain versions, bf16 and f32, causal and not,
  through autograd too; and one forward with B·H = 65,540 (two launches
  of at most 65,535 (b, h) pairs) against the plain version."""
  import torch
  from tensor2robot_tpu_torch.ops.flash_attention import (
      flash_attention_reference,
      flash_attention_with_lse,
  )
  worst = {}
  for dtype in (torch.bfloat16, torch.float32):
    for d in (24, 48):
      for t, causal in ((32, True), (100, False)):
        name = f"D={d} T={t} {dtype} causal={causal}"
        q, k, v = _flash_inputs(2, t, 4, d, dtype, seed=500 + d + t)
        err_out, _ = check_flash(name, q, k, v, causal)
        do = _flash_inputs(2, t, 4, d, dtype, seed=600 + d + t)[0]
        raw, scaled, _ = check_flash_bwd(name, q, k, v, do, None, causal)
        # Autograd through the padded forward and the Function's backward.
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out, _ = flash_attention_with_lse(*leaves, causal=causal)
        grads = torch.autograd.grad(out, leaves, do)
        ref = [x.detach().requires_grad_() for x in (q, k, v)]
        ref_grads = torch.autograd.grad(
            flash_attention_reference(*ref, causal=causal)[0], ref, do)
        auto = max(_grad_err(g, w) for g, w in zip(grads, ref_grads))
        if auto > _FLASH_AUTOGRAD_TOL[str(dtype)]:
          raise AssertionError(f"flash padded {name}: autograd grads differ "
                               f"by {auto} (tol "
                               f"{_FLASH_AUTOGRAD_TOL[str(dtype)]})")
        key = str(dtype)
        worst[key] = max(worst.get(key, 0.0), err_out, scaled[0], auto)
  b, t, h, d = 16385, 16, 4, 16
  q, k, v = _flash_inputs(b, t, h, d, torch.bfloat16, seed=700)
  with traced_launches(f"flash B*H={b * h}") as traced:
    err_out, err_lse = check_flash(f"B*H={b * h}", q, k, v, True)
  chunks = traced["flash_attention_fwd"]
  if chunks != 2:
    raise AssertionError(f"B*H={b * h}: {chunks} launches, want 2 chunks")
  _log(f"flash padded head dims D=24, 48 (fwd, bwd, autograd) worst scaled "
       f"errors {json.dumps(worst)}; B*H={b * h} forward in {chunks} "
       f"launches: out err {err_out}, lse err {err_lse}")


class _FixedReplay:
  """Stands in for a replay buffer: streams fixed transition batches from
  `start`, so a step sees the same batch in every run, a resumed one
  too (a real buffer's sampler starts anew on resume)."""

  def __init__(self, batches, start=0):
    self._batches = batches
    self._start = start

  def wait_until_size(self, *args, **kwargs):
    pass

  def as_stream(self, batch_size):
    return iter([dict(b) for b in self._batches[self._start:]])

  def set_learner_step(self, step):
    pass

  def metrics_scalars(self, prefix="replay_"):
    return {}


def _state_diff(a, b):
  """(largest |a - b| over every tensor leaf, whether all are equal)."""
  import torch
  from tensor2robot_tpu_torch.utils.step_graph import tensors
  ta, tb = tensors(a), tensors(b)
  if len(ta) != len(tb):
    raise AssertionError(f"states of {len(ta)} and {len(tb)} tensors")
  diff = max((x.double() - y.double()).abs().max().item()
             for x, y in zip(ta, tb))
  return diff, all(torch.equal(x, y) for x, y in zip(ta, tb))


def _hooks():
  """(Losses, FirstDispatch): hooks keeping each step's loss (device
  tensors) by step, and the step and time (device work done) at the end
  of the first dispatch, which holds the warm-up and the capture."""
  import torch
  from tensor2robot_tpu_torch.hooks import Hook

  class Losses(Hook):
    def __init__(self):
      self.by_step = {}

    def after_step(self, step, metrics):
      self.by_step[step] = metrics["loss"]

  class FirstDispatch(Hook):
    def __init__(self):
      self.step = self.time = None

    def after_step(self, step, metrics):
      if self.step is None:
        torch.cuda.synchronize()
        self.step, self.time = step, time.perf_counter()

  return Losses, FirstDispatch


_GRAPH_STEPS = 8


def phase_bellman_graphs():
  """`train_qtopt` at `GraspingQModel()` width, B=256 (CEM 2 × 64, fused
  select), 8 steps from seed 0 over the same fixed synthetic-bandit
  batches: eager (one `train_step` call per step, the reference), K=1
  graphed and K=4 graphed; then 4 steps at K=4, stopped, resumed at K=4
  to 8. In f32 and in bf16 (the main path) every state leaf (params,
  Adam moments and count, batch statistics, target) and every logged
  loss must be equal bit for bit: a replay runs the eager step's kernels
  on the same inputs in the same order. cuDNN runs its deterministic
  algorithms here: by default its convolution backward may sum in
  another order from run to run, and two eager runs then differ too (by
  ~1e-6 after 8 f32 steps on this card)."""
  import tempfile
  import torch
  from tensor2robot_tpu_torch.research.qtopt import (
      GraspingQModel,
      QTOptLearner,
  )
  from tensor2robot_tpu_torch.research.qtopt import synthetic_bandit as bandit
  from tensor2robot_tpu_torch.research.qtopt.train_qtopt import train_qtopt
  Losses, FirstDispatch = _hooks()

  results = {}
  for dtype in (torch.float32, torch.bfloat16):
    torch.backends.cudnn.allow_tf32 = dtype != torch.float32
    learner = QTOptLearner(GraspingQModel(device_dtype=dtype), gamma=0.9,
                           target_update_tau=0.05, cem_iterations=2,
                           cem_population=64, cem_elites=6,
                           cem_select="fused")
    batches = [bandit.bandit_transitions(learner, bandit.BATCH_SIZE,
                                         seed=100 + i)
               for i in range(_GRAPH_STEPS)]
    runs = {}
    with tempfile.TemporaryDirectory() as root:
      def run(name, k, graphs, steps=_GRAPH_STEPS, start=0, model_dir=None):
        hook = Losses()
        with traced_launches(f"Bellman {dtype} {name}") as traced:
          state = train_qtopt(
              learner, model_dir or os.path.join(root, name),
              replay_buffer=_FixedReplay(batches, start),
              max_train_steps=steps, batch_size=bandit.BATCH_SIZE,
              save_checkpoints_steps=4, log_every_steps=4, hooks=[hook],
              steps_per_dispatch=k, graphs=graphs)
        warm = _warm("cem_select")
        launched = traced["cem_select"] - warm
        if launched != 2 * (steps - start):
          raise AssertionError(f"Bellman {name}: {launched} cem_select "
                               f"launches past the warm-up ({warm}) in "
                               f"{steps - start} steps, want 2 a step")
        runs[name] = (state, {s: l.item() for s, l in hook.by_step.items()},
                      warm)
        return state

      if dtype == torch.float32:  # cuDNN's default: two eager runs
        torch.backends.cudnn.deterministic = False
        default_pair = _state_diff(run("eager a", 1, False),
                                   run("eager b", 1, False))
        _log(f"Bellman f32 two eager runs under cuDNN's default "
             f"algorithms: max state diff {default_pair[0]}, bitwise "
             f"{default_pair[1]}")
      torch.backends.cudnn.deterministic = True
      run("eager", 1, False)
      run("k1", 1, True)
      run("k4", 4, True)
      resume_dir = os.path.join(root, "resume")
      run("first_half", 4, True, steps=4, model_dir=resume_dir)
      run("resumed", 4, True, start=4, model_dir=resume_dir)
    ref_state, ref_losses, _ = runs["eager"]
    lines = {}
    for name in ("k1", "k4", "resumed"):
      state, losses, warm = runs[name]
      diff, equal = _state_diff(ref_state, state)
      loss_diff = max(abs(losses[s] - ref_losses[s]) for s in losses)
      lines[name] = dict(max_state_diff=diff, bitwise=equal,
                         max_loss_diff=loss_diff, logged_steps=sorted(losses),
                         warmup_cem_select=warm)
      if state.step != _GRAPH_STEPS:
        raise AssertionError(f"Bellman {name}: step {state.step}")
      if not equal or loss_diff != 0.0:
        raise AssertionError(f"Bellman {dtype} {name} differs from eager: "
                             f"{lines[name]}")
    results[str(dtype)] = lines
    _log(f"Bellman graphed vs eager ({dtype}, B=256, {_GRAPH_STEPS} steps; "
         f"resumed = 4 steps at K=4, then resumed at K=4 to 8): "
         f"{json.dumps(lines)}")
  torch.backends.cudnn.allow_tf32 = True
  torch.backends.cudnn.deterministic = False
  return results


def phase_bellman_rate(replay):
  """`grad_steps_per_sec` and `input_wait_fraction` from
  `metrics_train.jsonl` over 200 steps of `train_qtopt` at B=256 from the
  real replay buffer (4,096 synthetic-bandit transitions): graphed at
  K=1 and K=8, eager at K=1. The rate is the steps after the first
  dispatch (which holds the warm-up and the capture) over their wall
  time, the final checkpoint included; beside it the median of the
  logged 40-step intervals' rates past the first, and the median of
  their `input_wait_fraction`. Then the Bellman step's device idle share
  by the profiler, graphed and eager."""
  import tempfile
  import torch
  from tensor2robot_tpu_torch.bin.profile_policy import (
      profile_qtopt_train_step,
  )
  from tensor2robot_tpu_torch.research.qtopt import synthetic_bandit as bandit
  from tensor2robot_tpu_torch.research.qtopt.train_qtopt import train_qtopt
  from tensor2robot_tpu_torch.telemetry.records import read_records
  Losses, FirstDispatch = _hooks()

  learner = bandit.bellman_learner()
  rates = {}
  for name, k, graphs in (("graphed K=1", 1, True), ("graphed K=8", 8, True),
                          ("eager K=1", 1, False)):
    first = FirstDispatch()
    with tempfile.TemporaryDirectory() as model_dir:
      t0 = time.perf_counter()
      train_qtopt(learner, model_dir, replay_buffer=replay, max_train_steps=200,
                  batch_size=bandit.BATCH_SIZE, save_checkpoints_steps=200,
                  log_every_steps=40, steps_per_dispatch=k, graphs=graphs,
                  hooks=[first])
      torch.cuda.synchronize()
      t_end = time.perf_counter()
      records = read_records(os.path.join(model_dir, "metrics_train.jsonl"))
    later = records[1:]
    rates[name] = dict(
        grad_steps_per_sec=(200 - first.step) / (t_end - first.time),
        median_interval_grad_steps_per_sec=statistics.median(
            r["grad_steps_per_sec"] for r in later),
        input_wait_fraction=statistics.median(
            r["input_wait_fraction"] for r in later),
        per_interval=[r["grad_steps_per_sec"] for r in records],
        wall_s=t_end - t0)
    _log(f"Bellman rate {name} (B=256, 200 steps): {json.dumps(rates[name])}")
  profiles = {}
  for graphs in (True, False):
    prof = profile_qtopt_train_step(graphs=graphs)
    prof.pop("top_kernels")
    profiles["graphed" if graphs else "eager"] = prof
  _log(f"Bellman step profile (B=256, K=1): {json.dumps(profiles)}")
  if rates["graphed K=1"]["grad_steps_per_sec"] < 100:
    raise AssertionError("graphed Bellman training below 100 grad steps/s")
  return rates, profiles


# Record keys that measure the run (wall time, rates, shares of time,
# resources) rather than compute the step: never equal run to run.
_MEASURED_KEYS = ("wall", "role", "steps_per_sec", "stall_fraction",
                  "input_wait_fraction")
_MEASURED_PREFIXES = ("perf.", "rsrc.", "compile_cache.")


def _bc_models():
  """(label, model of a dtype) of the two BC configurations."""
  from tensor2robot_tpu_torch.research.vrgripper import (
      VRGripperTransformerModel,
      gin_config,
  )
  return (("gin width", lambda dtype: gin_config.gin_model(dtype)),
          ("default model", lambda dtype: VRGripperTransformerModel(
              device_dtype=dtype)))


def phase_bc_graphs():
  """`train_eval_model` for the gin-width model (16 × 32, depth 4, head
  dim 32) and the default model (head dim 16), each in f32 and bf16, 8
  steps over the same seeded episodes: eager K=1 against graphed K=1
  and K=4, with an eval every 4 steps (2 batches); then a resume (4
  steps at K=4, resumed to 8) graphed against the same resume eager, in
  both dtypes for the default model and in bf16 for the gin width.
  In both dtypes every state leaf and every logged train and eval
  metric must equal the eager run's bit for bit, and each run's kernel
  counts the launches traced on the card; and `steps_per_sec` over 40 steps
  graphed and eager (gin width, bf16). cuDNN runs its deterministic
  algorithms for the comparisons, as in `phase_bellman_graphs`."""
  import shutil
  import tempfile
  import torch
  from tensor2robot_tpu_torch.data import EpisodeInputGenerator
  from tensor2robot_tpu_torch.research.vrgripper import gin_config
  from tensor2robot_tpu_torch.telemetry.records import read_records
  from tensor2robot_tpu_torch.train_eval import train_eval_model
  episodes = gin_config.expert_episodes(32, seed=21)
  eval_episodes = gin_config.expert_episodes(16, seed=22)

  def gen(eps):
    return EpisodeInputGenerator(
        eps, sequence_length=gin_config.GIN_SEQUENCE_LENGTH,
        batch_size=gin_config.GIN_BATCH_SIZE, seed=0)

  out = {}
  torch.backends.cudnn.deterministic = True
  with tempfile.TemporaryDirectory() as root:
    for label, make in _bc_models():
      for dtype in (torch.float32, torch.bfloat16):
        torch.backends.cudnn.allow_tf32 = dtype != torch.float32
        model = make(dtype)

        def run(name, k, graphs, steps=_GRAPH_STEPS, model_dir=None):
          d = model_dir or os.path.join(root, f"{label}{dtype}{name}")
          with traced_launches(f"BC {label} {dtype} {name}"):
            state = train_eval_model(
                model, d, gen(episodes), gen(eval_episodes),
                max_train_steps=steps, eval_steps=2, eval_every_steps=4,
                save_checkpoints_steps=4, log_every_steps=4, seed=0,
                steps_per_dispatch=k, graphs=graphs)
          logged = {tag: read_records(os.path.join(d, f"metrics_{tag}.jsonl"))
                    for tag in ("train", "eval")}
          return state, logged

        def metric_diff(got, want):
          """Largest |difference| of the logged metrics (all but the
          record's wall time and the loop's measurements: its rates,
          stall and input-wait fractions and the perf plane's `perf.*`,
          `rsrc.*` and `compile_cache.*`), record by record, train and
          eval."""
          if any(len(got[t]) != len(want[t]) for t in want):
            raise AssertionError(f"BC {label}: {len(got['train'])} train "
                                 f"and {len(got['eval'])} eval records, "
                                 f"want {len(want['train'])} and "
                                 f"{len(want['eval'])}")
          return max(abs(a[m] - b[m]) for t in want
                     for a, b in zip(got[t], want[t])
                     for m in b if m not in _MEASURED_KEYS
                     and not m.startswith(_MEASURED_PREFIXES))

        ref, ref_logged = run("eager", 1, False)
        lines = {}
        for name, k in (("k1", 1), ("k4", 4)):
          state, logged = run(name, k, True)
          diff, equal = _state_diff(ref, state)
          lines[name] = dict(max_state_diff=diff, bitwise=equal,
                             max_metric_diff=metric_diff(logged, ref_logged),
                             evals=len(logged["eval"]))
          if state.step != _GRAPH_STEPS:
            raise AssertionError(f"BC {label} {name}: step {state.step}")
          if not equal or lines[name]["max_metric_diff"] != 0.0:
            raise AssertionError(f"BC {dtype} {label} {name} differs from "
                                 f"eager: {lines[name]}")
        out[f"{label} {dtype}"] = lines
        if label == "gin width" and dtype == torch.float32:
          # The f32 resume runs on the default model only (the time
          # limit): the gin width's is its bf16 resume.
          _log(f"BC graphed vs eager ({label}, {dtype}, {_GRAPH_STEPS} "
               f"steps, eval every 4; no resume): {json.dumps(lines)}")
          continue
        # Resume: 4 steps at K=4, then resumed to 8 at K=4 (graphed) and
        # at K=1 (eager) from copies of the same checkpoint.
        half = os.path.join(root, f"{label}{dtype}half")
        run("half", 4, True, steps=4, model_dir=half)
        eager_dir = half + "-eager"
        shutil.copytree(half, eager_dir)
        resumed, logged = run("resumed", 4, True, model_dir=half)
        resumed_eager, logged_eager = run("resumed eager", 1, False,
                                          model_dir=eager_dir)
        diff, equal = _state_diff(resumed_eager, resumed)
        lines["resumed"] = dict(
            max_state_diff=diff, bitwise=equal, step=resumed.step,
            max_metric_diff=metric_diff(logged, logged_eager))
        if (resumed.step != _GRAPH_STEPS or not equal
            or lines["resumed"]["max_metric_diff"] != 0.0):
          raise AssertionError(f"BC {dtype} {label} resume: "
                               f"{lines['resumed']}")
        out[f"{label} {dtype}"] = lines
        _log(f"BC graphed vs eager ({label}, {dtype}, {_GRAPH_STEPS} steps, "
             f"eval every 4): {json.dumps(lines)}")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = False
    rates = {}
    model = gin_config.gin_model()
    for name, graphs in (("graphed", True), ("eager", False)):
      d = os.path.join(root, f"rate-{name}")
      train_eval_model(model, d, gen(episodes), max_train_steps=40,
                       save_checkpoints_steps=40, log_every_steps=10,
                       seed=0, graphs=graphs)
      records = read_records(os.path.join(d, "metrics_train.jsonl"))
      rates[name] = [r["steps_per_sec"] for r in records]
    _log(f"BC steps_per_sec (gin width, bf16, B=16 T=32, logged every 10 "
         f"steps; the first interval holds the warm-up and capture): "
         f"{json.dumps(rates)}")
  return out, rates


def _pcts(ms):
  ms = sorted(ms)
  return dict(p50=ms[len(ms) // 2], p95=ms[int(len(ms) * 0.95)], n=len(ms))


def phase_serving_graphs():
  """CEM serving at `GraspingQModel()` width: every bucket (1, 2, 4, 8)
  graphed against eager with the same seeded generator (actions and
  scores equal); `compile_count` after warmup and after traffic; a
  `warmup_async` with requests in flight; `swap_state` under four
  robots' traffic (every answer equal to the eager answer of the params
  version it reports); wall ms per dispatch (p50, p95 over 200) graphed
  and eager."""
  import numpy as np
  import torch
  from tensor2robot_tpu_torch.research.qtopt import (
      GraspingQModel,
      QTOptLearner,
  )
  from tensor2robot_tpu_torch.serving import CEMPolicyServer
  from tensor2robot_tpu_torch.serving.engine import BucketedServingEngine
  from tensor2robot_tpu_torch.specs import make_random_tensors

  learner = QTOptLearner(GraspingQModel(), cem_iterations=2,
                         cem_population=64, cem_elites=6, cem_select="fused")
  states = [learner.create_state(seed=s).train_state for s in (0, 1)]
  spec = learner.observation_specification()
  example = make_random_tensors(spec, batch_size=1, seed=0)

  def cem_fn(st, obs, generator):  # best action and its score
    batch = next(iter(obs.values())).shape[0]
    with torch.inference_mode():
      fns = learner._cem_fns(learner.model.bind(st), obs)
      result = learner._cem(*fns, batch, generator, None,
                            next(iter(st.params.values())).device)
    return {"action": result.best_action, "score": result.best_score}

  def engine(graphs, warm=True):
    e = BucketedServingEngine(cem_fn, states[0], example, max_batch=8,
                              takes_rng=True, graphs=graphs)
    if warm:
      e.warmup()
    return e

  graphed, eager = engine(True), engine(False)
  compiles = graphed.compile_count
  if compiles != 4 or graphed.compiled_buckets != (1, 2, 4, 8):
    raise AssertionError(f"compile_count {compiles} after warmup")
  gen = lambda s: torch.Generator(device="cuda").manual_seed(s)  # noqa: E731
  for n in (1, 2, 3, 4, 8):
    obs = make_random_tensors(spec, batch_size=n, seed=40 + n).to_flat_dict()
    a = graphed.predict(obs, gen(n))
    b = eager.predict(obs, gen(n))
    if not all(np.array_equal(a[k], b[k]) for k in ("action", "score")):
      raise AssertionError(f"bucket for {n} rows: graphed and eager differ: "
                           f"{a} {b}")
  # Swap under traffic: version v serves states[v % 2].
  answers, errors = [], []
  stop = threading.Event()

  def robot(i):
    j = 0
    try:
      while not stop.is_set() or j < 10:
        obs = make_random_tensors(spec, batch_size=1 + (i + j) % 3,
                                  seed=1000 * i + j).to_flat_dict()
        out, pub = graphed.predict_versioned(obs, gen(7 * i + j))
        answers.append((obs, 7 * i + j, out, pub.version))
        j += 1
    except Exception as e:  # noqa: BLE001 — raised below
      errors.append(e)

  robots = [threading.Thread(target=robot, args=(i,)) for i in range(4)]
  for t in robots:
    t.start()
  for v in range(1, 11):
    time.sleep(0.01)
    graphed.swap_state(states[v % 2], learner_step=v)
  stop.set()
  for t in robots:
    t.join(timeout=300)
  if errors or any(t.is_alive() for t in robots):
    raise AssertionError(f"robots failed: {errors}")
  checked = {0: 0, 1: 0}
  for parity in (0, 1):
    eager.swap_state(states[parity])
    for obs, seed, out, version in answers:
      if version % 2 != parity:
        continue
      want = eager.predict(obs, gen(seed))
      if not all(np.array_equal(out[k], want[k])
                 for k in ("action", "score")):
        raise AssertionError(f"an answer of params version {version} is "
                             "not that version's eager answer")
      checked[parity] += 1
  if graphed.compile_count != compiles:
    raise AssertionError(f"compile_count moved under traffic: "
                         f"{graphed.compile_count}")
  _log(f"serving graphs: buckets 1, 2, 4, 8 equal to eager (actions, "
       f"scores); compile_count {compiles} after warmup and after "
       f"{len(answers)} dispatches; swap_state x10 under 4 robots: "
       f"{len(answers)} answers each equal to its version's eager answer "
       f"(versions of state 0: {checked[0]}, state 1: {checked[1]})")
  # warmup_async with requests arriving during it.
  late = engine(True, warm=False)
  late.warmup_async()
  obs1 = make_random_tensors(spec, batch_size=1, seed=3).to_flat_dict()
  early = [late.predict(obs1, gen(3)) for _ in range(3)]
  late.wait_warmup()
  late.wait_warmup()
  if late.compile_count != 4 or any(
      not np.array_equal(e["action"], early[0]["action"]) for e in early):
    raise AssertionError(f"warmup_async: compile_count {late.compile_count}")
  # Wall ms per dispatch at B=8 through the server (padding, H2D, D2H).
  walls = {}
  for graphs in (True, False):
    server = CEMPolicyServer(learner, states[0], max_batch=8, seed=0,
                             graphs=graphs)
    obs8 = make_random_tensors(spec, batch_size=8, seed=9).to_flat_dict()
    for n, seeds in ((8, range(200)), (1, range(200))):
      obs = {k: v[:n] for k, v in obs8.items()}
      for s in range(5):
        server.select_actions_direct(obs, generator=gen(s))
      ms = []
      for s in seeds:
        t0 = time.perf_counter()
        server.select_actions_direct(obs, generator=gen(s))
        ms.append((time.perf_counter() - t0) * 1e3)
      walls[f"{'graphed' if graphs else 'eager'} B={n}"] = _pcts(ms)
    server.close()
  _log(f"serving wall ms per dispatch (direct, host clock): "
       f"{json.dumps(walls)}")
  return walls


def phase_context_graphs():
  """One seeded episode of up to 40 steps through
  `evaluate_gripper_policy`, the context policy graphed and eager (the
  gin width, bf16): the same actions; wall ms per step (p50, p95)."""
  import numpy as np
  from tensor2robot_tpu_torch.research.vrgripper import (
      evaluate_gripper_policy,
  )
  from tensor2robot_tpu_torch.research.vrgripper.gin_config import gin_model
  model = gin_model()
  state = model.create_inference_state(seed=0)
  actions, walls, steps = {}, {}, {}
  for graphs in (True, False):
    policy = model.make_context_policy(state, graphs=graphs)
    recorder = _Recorder(policy)
    times = []

    def timed(batch, recorder=recorder, times=times):
      t0 = time.perf_counter()
      out = recorder(batch)
      times.append((time.perf_counter() - t0) * 1e3)
      return out

    timed.reset = recorder.reset
    evaluate_gripper_policy(timed, num_episodes=1, image_size=48, seed=5,
                            max_steps=40)
    name = "graphed" if graphs else "eager"
    actions[name] = np.concatenate(recorder.actions)
    walls[name] = _pcts(times[1:])  # the first step captures the graph
    steps[name] = policy.steps
  if not np.array_equal(actions["graphed"], actions["eager"]):
    raise AssertionError("graphed and eager context policies differ: max "
                         f"{np.abs(actions['graphed'] - actions['eager']).max()}")
  _log(f"context policy graphed vs eager: {steps['graphed']}-step episode, "
       f"the same actions; wall ms per step {json.dumps(walls)}")
  return walls


# ---- the online QT-Opt path (replay plane, actor, success protocol) ----


def phase_online_kernels():
  """cem_select against its plain version at the online path's shapes:
  the actor's serving buckets 2, 4, 16 and 32 (phase 3 holds 1 and 8)
  and the evaluation's B=512 (P=64, the q-head of `GraspingQModel()`,
  bf16, on `wgmma`), and the seedcheck's test-size widths (C=8, dense
  16, P=8, 2 elites: CUDA cores), every case rerun for identical
  bits."""
  import torch
  from tensor2robot_tpu_torch.ops import cem_select as ops
  bf16 = torch.bfloat16
  cases = [(f"bf16 B={b}", _select_inputs(b, 64, 64, (64, 64), 4, bf16,
                                          seed=40 + b), 6)
           for b in (2, 4, 16, 32, 512)]
  cases.append(("bf16 test size B=16", _select_inputs(16, 8, 8, (16,), 2,
                                                      bf16, seed=41), 2))
  errs = {}
  for name, args, elites in cases:
    errs[name] = check_select(name, *args, num_elites=elites, sigmoid=True,
                              score_tol=1e-2)
    _same_bits(f"cem_select {name}", lambda: ops.fused_cem_select(
        *args, elites, sigmoid=True))
    _log(f"cem_select {name}: path {_select_path(*args, elites)}, "
         f"identical bits on a rerun")
  return max(errs.values())


def _protocol_lines(label, summary):
  """Prints a protocol run's success per checkpoint and its phases'
  rates and counters."""
  for r in summary["records"]:
    _log(f"{label} step {r['step']} ({r['phase']}): success_rate="
         f"{r['success_rate']} random_baseline="
         f"{r['random_baseline_success_rate']}")
  for phase in ("offline", "online"):
    _log(f"{label} {phase} phase: {json.dumps(summary[phase])}")


def phase_online_protocol():
  """The offline→online grasp protocol at `GraspingQModel()` width
  through the entry point (`bin/run_success_protocol.py`'s `run_online`,
  fused select): 2000 offline steps (K=50, checkpoints every 500, 512
  evaluation episodes at CEM 64 × 3), then 2000 online steps at lr 3e-4
  with the server-wired actor, the write service and the refresh hook.
  Gates: success ≥ 0.50 at step 2000, online final ≥ offline final −
  0.10, episodes collected, no actor crash (a latched writer error
  raises). Last, a traced window of the online loop
  (`_online_window`). Returns the window's cem_select
  launches per path and the protocol's summary."""
  import tempfile
  from tensor2robot_tpu_torch.bin import run_success_protocol as protocol

  config = protocol.FULL
  with tempfile.TemporaryDirectory() as out_dir:
    t0 = time.perf_counter()
    summary = protocol.run_online(out_dir, device="cuda", cem_select="fused")
    wall_s = time.perf_counter() - t0
    _protocol_lines("online protocol (fused)", summary)
    _log(f"online protocol (fused): wall_s={wall_s} serving dispatches="
         f"{summary['online']['serving_dispatches']} episodes collected="
         f"{summary['online']['episodes_collected']} dropped="
         f"{summary['online']['episodes_dropped']} service="
         f"{json.dumps(summary['online']['ingestion'])} staleness="
         f"{json.dumps(summary['online']['staleness'])}")
    offline_final = summary["offline_only_success_rate"]
    online_final = summary["online_finetuned_success_rate"]
    if offline_final < 0.5:
      raise AssertionError(f"offline success {offline_final} < 0.50 at step "
                           f"{config.offline_steps}")
    if online_final < offline_final - 0.10:
      raise AssertionError(f"online final {online_final} < offline final "
                           f"{offline_final} - 0.10")
    if summary["online"]["episodes_collected"] <= 0:
      raise AssertionError("the actor collected no episodes")
    if summary["online"]["actor_crashed"]:
      raise AssertionError(f"the actor crashed: "
                           f"{summary['online']['actor_crash_error']}")
    model_dir = os.path.join(out_dir, "qtopt_online")
    per_path = _online_window(model_dir, out_dir)
  return per_path, summary


def _online_window(model_dir, out_dir):
  """A traced window of the online loop: resumed from the protocol's
  last checkpoint for 20 steps at K=10, checkpoints every 10, the actor
  running. Every wrapper's count equals CUPTI's, and cem_select's
  launches are measured per path by the thread that made them and the
  hooks' reads around them: the server's warm-up (this thread, before
  the loop), the evaluation (this thread, inside the evaluation hook),
  the learner (the rest of this thread's) and the serving dispatches
  (the server's dispatcher thread). Each is held to what its path
  should launch: 2 a step and 2K for the graph's warm-up; one per CEM
  iteration of each evaluation; 2 a dispatch; 6 a bucket's warm-up (a
  warm-up call for each of its two slots' graphs and a dispatch)."""
  import dataclasses
  import shutil
  from tensor2robot_tpu_torch.bin import run_success_protocol as protocol
  from tensor2robot_tpu_torch.ops import launch_counts_by_thread
  from tensor2robot_tpu_torch.research.qtopt import ReplayBuffer, ToyGraspEnv
  from tensor2robot_tpu_torch.serving import bucketing
  config = dataclasses.replace(protocol.FULL, steps_per_dispatch=10)
  start = 2 * config.offline_steps
  window_dir = os.path.join(out_dir, "window")
  shutil.copytree(model_dir, window_dir)
  learner = protocol.build_learner(config, config.finetune_lr, "cuda",
                                   "fused")
  replay = ReplayBuffer(learner.transition_specification(), capacity=4096,
                        seed=0)
  replay.add(ToyGraspEnv(image_size=learner.model.image_size,
                         action_dim=learner.model.action_dim,
                         seed=1).sample_transitions(1024))
  me = threading.current_thread().name

  def mine():
    return launch_counts_by_thread().get(me, {}).get("cem_select", 0)

  hook = protocol.make_eval_hook(learner, config)
  begin, after_checkpoint = hook.begin, hook.after_checkpoint
  reads = {"before_loop": None, "evaluation": 0, "evaluations": 0}

  def counted_begin(*args):
    reads["before_loop"] = mine()
    begin(*args)

  def counted_after_checkpoint(*args):
    before = mine()
    after_checkpoint(*args)
    reads["evaluation"] += mine() - before
    reads["evaluations"] += 1

  hook.begin, hook.after_checkpoint = counted_begin, counted_after_checkpoint
  # K=10 keeps the trace short (its events are processed on the host):
  # two dispatches, each checkpoint evaluated and handed to the server.
  with traced_launches("online window") as traced:
    window = protocol.online_phase(
        learner, replay, window_dir, config, max_train_steps=start + 20,
        save_checkpoints_steps=10, log_every_steps=10, eval_hook=hook)
  threads = {name: n.get("cem_select", 0)
             for name, n in launch_counts_by_thread().items()}
  per_path = {
      "learner": threads.pop(me, 0) - reads["before_loop"]
                 - reads["evaluation"],
      "evaluation": reads["evaluation"],
      "serving_warmup": reads["before_loop"],
      "serving": threads.pop("microbatcher", 0),
  }
  buckets = len(bucketing.bucket_table(config.server_max_batch))
  iterations = learner.cem_iterations
  expected = {
      "learner": iterations * (20 + config.steps_per_dispatch),
      "evaluation": reads["evaluations"] * config.eval_cem["cem_iterations"],
      "serving_warmup": iterations * 3 * buckets,
      "serving": iterations * window["serving_dispatches"],
  }
  _log(f"online window (steps {start}-{start + 20}, K=10, checkpoints every "
       f"10): cem_select traced={traced['cem_select']}, per path measured "
       f"{json.dumps(per_path)}, expected {json.dumps(expected)}; "
       f"evaluations={reads['evaluations']} episodes="
       f"{window['episodes_collected']} serving dispatches="
       f"{window['serving_dispatches']}")
  if window["episodes_collected"] <= 0 or window["actor_crashed"]:
    raise AssertionError(f"online window: {window}")
  if (threads or per_path != expected
      or sum(per_path.values()) != traced["cem_select"]):
    raise AssertionError(f"online window: cem_select per path {per_path}, "
                         f"expected {expected}, other threads {threads}")
  return per_path


# The lax offline run's steps (the protocol's 2000, cut for the time
# limit).
_LAX_OFFLINE_STEPS = 100


def phase_lax_offline():
  """The offline phase once more with cem_select="lax" (the JAX
  protocol's own configuration), `_LAX_OFFLINE_STEPS` steps: printed,
  not gated. Returns its replay (16384 grasps at `GraspingQModel()`
  width) for the gather timing."""
  import dataclasses
  import tempfile
  from tensor2robot_tpu_torch.bin import run_success_protocol as protocol
  from tensor2robot_tpu_torch.telemetry.records import read_records
  config = dataclasses.replace(protocol.FULL,
                               offline_steps=_LAX_OFFLINE_STEPS)
  learner = protocol.build_learner(config, config.lr, "cuda", "lax")
  replay = protocol.offline_replay(learner, config)
  with tempfile.TemporaryDirectory() as model_dir:
    rates = protocol.offline_phase(learner, replay, model_dir, config)
    records = read_records(os.path.join(model_dir,
                                        "metrics_success_eval.jsonl"))
  for r in records:
    _log(f"offline protocol (lax) step {r['step']}: success_rate="
         f"{r['success_rate']} random_baseline="
         f"{r['random_baseline_success_rate']}")
  _log(f"offline protocol (lax) phase: {json.dumps(rates)}")
  return replay


def phase_native_gather(replay):
  """The native row gather (`utils/native.py`): built and loaded (or the
  run fails with the compiler's message), equal to numpy on the
  transition's dtypes (uint8 images, f32) with and without `out=`, with
  negative indices, at one thread (the default) and one per core; then
  one B=256 gather of the Bellman transition from the protocol's replay
  (2 × 64×64×3 uint8 + action, reward, done), native at both against
  numpy, median host ms of 50."""
  import numpy as np
  from tensor2robot_tpu_torch.utils import native
  if not native.native_available():
    raise AssertionError(f"native gather did not load: {native.load_error()}")
  storage = replay.store._shards[0].storage
  live = len(replay)
  rng = np.random.default_rng(0)
  for key, src in storage.items():
    src = src[:live]
    idx = rng.integers(-live, live, 256)
    for threads in (1, 0):
      out = np.empty((256,) + src.shape[1:], src.dtype)
      got = native.gather_rows(src, idx, num_threads=threads)
      native.gather_rows(src, idx, out=out, num_threads=threads)
      if not (np.array_equal(got, src[idx]) and np.array_equal(out, src[idx])):
        raise AssertionError(f"native gather of {key} != numpy")
      dst, want = src[:512].copy(), src[:512].copy()
      slots = rng.permutation(512)[:256] - 256
      native.scatter_rows(dst, slots, got, num_threads=threads)
      want[slots] = got
      if not np.array_equal(dst, want):
        raise AssertionError(f"native scatter of {key} != numpy")
  times = {}
  for name, fn in (
      ("native", lambda i: {k: native.gather_rows(v, i)
                            for k, v in storage.items()}),
      ("native_thread_per_core", lambda i: {
          k: native.gather_rows(v, i, num_threads=0)
          for k, v in storage.items()}),
      ("numpy", lambda i: {k: v[i] for k, v in storage.items()})):
    ms = []
    for _ in range(50):
      idx = rng.integers(0, live, 256)
      t0 = time.perf_counter()
      fn(idx)
      ms.append((time.perf_counter() - t0) * 1e3)
    times[name] = statistics.median(ms)
  row_bytes = sum(v[0].nbytes for v in storage.values())
  keys = ", ".join(f"{k} {v.dtype}{list(v.shape[1:])}"
                   for k, v in storage.items())
  _log(f"native gather: loaded {native.library_path().name}, equal to numpy "
       f"({keys}); B=256 Bellman transition ({row_bytes} B a row) median "
       f"host ms {json.dumps(times)} (cores {os.cpu_count()})")
  return times


def phase_seedcheck():
  """The protocol's seedcheck on the card (fused select): two
  synchronous collect → flush → sample passes draw the same sample
  schedule and the same action stream; two procedural sweeps give the
  same scenario and action digests, and two `train_anakin` runs (cuDNN
  deterministic) the same final params. Phase 48 reads the halves."""
  from tensor2robot_tpu_torch.bin import run_success_protocol as protocol
  out = protocol.run_seedcheck(device="cuda", cem_select="fused")
  if not out["reproducible"]:
    raise AssertionError(f"seedcheck diverged: {out}")
  return out


def phase_actor_split():
  """Where an actor batch's time goes without the learner beside it:
  env reset and render (32 episodes at 64×64), one CEM dispatch of 32
  rows through `CEMPolicyServer(max_batch=32)` (graphed), and the commit
  through a `ReplayWriteService` session with its writer's store add
  (flushed); median host ms of 30."""
  import numpy as np
  from tensor2robot_tpu_torch.bin import run_success_protocol as protocol
  from tensor2robot_tpu_torch.replay import ReplayStore, ReplayWriteService
  from tensor2robot_tpu_torch.research.qtopt import ToyGraspEnv
  from tensor2robot_tpu_torch.serving import CEMPolicyServer
  config = protocol.FULL
  learner = protocol.build_learner(config, config.finetune_lr, "cuda",
                                   "fused")
  state = learner.create_state(0)
  server = CEMPolicyServer(learner, state.train_state,
                           max_batch=config.server_max_batch,
                           max_wait_us=config.server_max_wait_us, seed=7,
                           device=learner.device)
  store = ReplayStore(learner.transition_specification(), capacity=8192)
  service = ReplayWriteService(store, queue_batches=16)
  session = service.session("timing")
  env = ToyGraspEnv(image_size=learner.model.image_size,
                    action_dim=learner.model.action_dim, seed=3)
  times = {"env_reset_ms": [], "cem_dispatch_ms": [], "commit_ms": []}
  try:
    n = config.actor_batch_episodes
    for _ in range(30):
      t0 = time.perf_counter()
      obs, pos = env.reset_batch(n)
      t1 = time.perf_counter()
      actions = server.select_actions({"image": obs["image"]})
      t2 = time.perf_counter()
      session.add({"image": obs["image"], "action": actions,
                   "reward": env.grade(actions, pos)[:, None],
                   "done": np.ones((n, 1), np.float32),
                   "next_image": obs["image"]})
      service.flush()
      t3 = time.perf_counter()
      for key, a, b in (("env_reset_ms", t0, t1), ("cem_dispatch_ms", t1, t2),
                        ("commit_ms", t2, t3)):
        times[key].append((b - a) * 1e3)
  finally:
    service.close()
    server.close()
  split = {k: statistics.median(v) for k, v in times.items()}
  _log(f"actor batch split (32 episodes, no learner running; median host "
       f"ms of 30): {json.dumps(split)}")
  return split


# ---- the int8 CEM tower and the multi-tenant serving plane ----

_INT8_STEPS = 60
_RATE_STEPS = 200
_CEM_KW = dict(cem_iterations=2, cem_population=64, cem_elites=6)


def _int8_learner(cem_select="fused", device=None, **model_kwargs):
  """The JAX bench's flagship Bellman learner (`bench.py:210`,
  `qtopt_int8.gin`): `GraspingQModel()`, CEM 2 × 64, 6 elites, the int8
  tower."""
  from tensor2robot_tpu_torch.research.qtopt import synthetic_bandit as bandit
  return bandit.bellman_learner(device=device, cem_inference="int8",
                                cem_select=cem_select, **model_kwargs)


def _scale_tensors(learner, device):
  """The learner's calibrated scales as f32 tensors on `device`, made
  before any capture."""
  import torch
  return {k: torch.full((), v, dtype=torch.float32, device=device)
          for k, v in learner.act_scales.items()}


def phase_int8_kernels():
  """cem_select against its plain version on pooled features of the int8
  tower (`quantized_pool_population` at `GraspingQModel()` width, bf16,
  calibrated on a synthetic-bandit batch) at B = 8 and 256, P=64: their
  range and rounding are the int8 tower's, not the bf16 tower's. Same
  tolerance as phase 3's bf16 cases; each rerun for identical bits."""
  import torch
  from tensor2robot_tpu_torch.ops import cem_select as ops
  from tensor2robot_tpu_torch.research.qtopt import networks as net_lib
  from tensor2robot_tpu_torch.research.qtopt import synthetic_bandit as bandit
  learner = _int8_learner()
  state = learner.create_state(seed=0)
  batch = bandit.bandit_transitions(learner, 256, seed=1)
  learner.calibrate(state, batch)
  net = learner.model.bind(state.train_state)
  dense = net_lib.q_head_dense_params(net, dtype=net.dtype)
  image = torch.from_numpy(batch["next_image"]).cuda()
  errs = {}
  with torch.no_grad():
    tower = net_lib.quantize_tower(net, _scale_tensors(learner, "cuda"))
    encoded = net_lib.quantized_encode(net, tower, image)
    for b in (8, 256):
      g = torch.Generator(device="cuda").manual_seed(30 + b)
      samples = torch.rand((b, 64, 4), generator=g, device="cuda") * 2 - 1
      pooled = net_lib.quantized_pool_population(net, tower, encoded[:b], {},
                                                 samples)
      name = f"int8 tower B={b}"
      errs[name] = check_select(name, pooled, samples, dense, 6, True, 1e-2)
      _same_bits(f"cem_select {name}", lambda: ops.fused_cem_select(
          pooled, samples, dense, 6, sigmoid=True))
      _log(f"cem_select {name}: pooled range [{pooled.min().item()}, "
           f"{pooled.max().item()}], path "
           f"{_select_path(pooled, samples, dense, 6)}, identical bits on a "
           f"rerun")
  return max(errs.values())


def phase_int8_card_vs_cpu():
  """The int8 tower on the card against the CPU: `GraspingQModel()` width
  in f32, B=16, P=64, the same weights, CPU-calibrated scales and
  actions, TF32 off. Gates: every int8 kernel bit for bit; each
  quantizer, given the CPU's input at its point, returns the CPU's codes
  bit for bit; along each device's own forward the torso's codes are
  bit-equal (exact inputs, int8 convs summed exactly) and the merged
  tensor's differ only where the CPU's value sits within 1e-3 of a code
  boundary (the merge's f32 conv and GEMM sum in another order), by one
  code; the quantized scores from the same merged tensor (the CPU's)
  within 1e-5 of their spread. The scores along each device's own
  forward are printed: a code that moves at a boundary moves them by more
  than 1e-5 of the spread."""
  import numpy as np
  import torch
  from tensor2robot_tpu_torch.layers.vision_layers import spatial_mean
  from tensor2robot_tpu_torch.research.qtopt import networks as net_lib
  from tensor2robot_tpu_torch.research.qtopt import synthetic_bandit as bandit
  torch.backends.cudnn.allow_tf32 = False
  cpu_learner = _int8_learner(device="cpu", device_dtype=torch.float32)
  ts_cpu = cpu_learner.create_state(seed=0).train_state
  batch = bandit.bandit_transitions(cpu_learner, 16, seed=2)
  scales = cpu_learner.calibrate(ts_cpu, batch)
  actions = np.random.default_rng(3).uniform(-1, 1, (16, 64, 4)).astype(
      np.float32)
  out = {}
  for device in ("cpu", "cuda"):
    ts = ts_cpu if device == "cpu" else ts_cpu.to(device)
    net = cpu_learner.model.bind(ts)
    taps = {}
    with torch.no_grad():
      tower = net_lib.quantize_tower(net, _scale_tensors(cpu_learner, device))
      image = torch.from_numpy(batch["image"]).to(device)
      acts = torch.from_numpy(actions).to(device)
      encoded = net_lib.quantized_encode(net, tower, image, taps=taps)
      net_lib.quantized_pool_population(net, tower, encoded, {}, acts,
                                        taps=taps)
      score = net_lib.quantized_score_population(net, tower, encoded, {},
                                                 acts)
    layers = {f"torso_in_{i}": layer for i, layer
              in enumerate(tower["torso"])}
    layers.update({f"head_in_{i}": layer for i, layer
                   in enumerate(tower["head"], start=1)})
    out[device] = dict(taps=taps, layers=layers, score=score.cpu(), net=net,
                       tower=tower)
  cpu, card = out["cpu"], out["cuda"]
  # The tail after the merge on each device from the CPU's merged tensor:
  # the same codes in, so the int8 convs, the scales, the pool and the
  # q-head must agree to f32 summation order.
  tails = {}
  for device, run in out.items():
    x = cpu["taps"]["head_in_1"].to(device)
    with torch.no_grad():
      for layer in run["tower"]["head"]:
        x = net_lib._int8_conv(x, layer, 2, torch.float32)
      tails[device] = run["net"].q_head(spatial_mean(x))[..., 0].cpu()
  lines = {}
  for point in sorted(cpu["layers"]):
    lc, lg = cpu["layers"][point], card["layers"][point]
    if not torch.equal(lc["w_q"], lg["w_q"].cpu()):
      raise AssertionError(f"int8 {point}: the weights' codes differ")
    q_cpu = net_lib._quantize_act(cpu["taps"][point], lc["act_scale"])
    same_in = net_lib._quantize_act(cpu["taps"][point].cuda(),
                                    lg["act_scale"]).cpu()
    if not torch.equal(same_in, q_cpu):
      raise AssertionError(f"int8 {point}: the card's quantizer gives other "
                           "codes on the CPU's input")
    own = net_lib._quantize_act(card["taps"][point], lg["act_scale"]).cpu()
    diff = own.int() - q_cpu.int()
    ratio = cpu["taps"][point].float() / lc["act_scale"]
    to_edge = ((ratio.abs() - ratio.abs().floor()) - 0.5).abs()
    moved = diff != 0
    lines[point] = dict(codes=q_cpu.numel(), differ=int(moved.sum()),
                        max_code_diff=int(diff.abs().max()),
                        act_scale=scales[point])
    if point.startswith("torso") and bool(moved.any()):
      raise AssertionError(f"int8 {point}: {lines[point]}")
    if bool(moved.any()) and (int(diff.abs().max()) > 1
                              or float(to_edge[moved].max()) >= 1e-3):
      raise AssertionError(f"int8 {point}: codes differ away from a code "
                           f"boundary: {lines[point]}")
  spread = (cpu["score"].max() - cpu["score"].min()).item()
  score_err = (card["score"] - cpu["score"]).abs().max().item()
  tail_spread = (tails["cpu"].max() - tails["cpu"].min()).item()
  tail_err = (tails["cuda"] - tails["cpu"]).abs().max().item()
  torch.backends.cudnn.allow_tf32 = True
  _log(f"int8 card vs CPU (f32, GraspingQModel() width, B=16, P=64): int8 "
       f"weights bit for bit; every quantizer bit for bit on the same input; "
       f"codes along each device's own forward: {json.dumps(lines)}; "
       f"quantized scores from the same merged tensor: max diff {tail_err} "
       f"over spread {tail_spread} (ratio {tail_err / tail_spread}, tol "
       f"1e-5); along each device's own forward (the codes above): max diff "
       f"{score_err} over spread {spread} (ratio {score_err / spread})")
  if tail_err > 1e-5 * tail_spread:
    raise AssertionError("int8 card and CPU scores differ")


def phase_int8_training():
  """int8 Bellman training, the JAX bench's flagship config at
  `GraspingQModel()` width (B=256, CEM 2 × 64, 6 elites), for the lax
  and the fused select: `train_qtopt` over the synthetic-bandit replay
  calibrates on a replay batch, then runs 60 graphed steps under the
  profiler (cem_select 2 a step + the warm-up's with the fused select,
  none with lax); the loss must stay finite and fall. Then 8 f32 steps
  eager against K=1 graphed (cuDNN's deterministic algorithms, TF32 off):
  every state leaf and loss bit for bit. Then, at B=256 on the trained
  state and shared noise, the int8 actions against the other tower's
  under the exact scorer (the same params in f32, lax select), in f32 and
  in bf16: the mean value regret over the 256 states < 0.05 of the
  batch's Q spread (the JAX gate's quotient; its largest-regret form is
  held at the JAX test's B=8 by the CPU tests, and printed here: over 256
  states a few near-tied candidates swap, in bf16 as much between the
  bf16 tower's own two selects). The gap of the two Bellman target means
  is printed."""
  import tempfile
  import numpy as np
  import torch
  from tensor2robot_tpu_torch.research.qtopt import ReplayBuffer
  from tensor2robot_tpu_torch.research.qtopt import synthetic_bandit as bandit
  from tensor2robot_tpu_torch.research.qtopt.train_qtopt import train_qtopt
  Losses, FirstDispatch = _hooks()

  launches, trained = {}, {}
  for select in ("lax", "fused"):
    learner = _int8_learner(cem_select=select)
    replay = ReplayBuffer(learner.transition_specification(), capacity=4096,
                          seed=0)
    replay.add(bandit.bandit_transitions(learner, 4096, seed=1))
    hook = Losses()
    with tempfile.TemporaryDirectory() as model_dir:
      with traced_launches(f"int8 Bellman training ({select})") as traced:
        state = train_qtopt(learner, model_dir, replay_buffer=replay,
                            max_train_steps=_INT8_STEPS,
                            batch_size=bandit.BATCH_SIZE,
                            save_checkpoints_steps=_INT8_STEPS,
                            log_every_steps=20, hooks=[hook])
    warm = _warm("cem_select")
    losses = [hook.by_step[s].item() for s in sorted(hook.by_step)]
    want = 2 * _INT8_STEPS + warm if select == "fused" else 0
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    _log(f"int8 Bellman training ({select}, B=256, {_INT8_STEPS} graphed "
         f"steps): calibrated {learner.act_scales}; cem_select launches "
         f"{traced['cem_select']} (warm-up {warm}); loss first10 {first} "
         f"last10 {last}")
    if learner.needs_calibration or traced["cem_select"] != want:
      raise AssertionError(f"int8 {select}: launches {traced['cem_select']}"
                           f" != {want}")
    if not all(np.isfinite(losses)) or not last < first:
      raise AssertionError(f"int8 {select}: losses {losses[:3]}..")
    launches[select] = traced["cem_select"]
    trained[select] = (learner, state)
  # Graphed against eager, f32, bit for bit.
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cudnn.deterministic = True
  for select in ("lax", "fused"):
    learner = _int8_learner(cem_select=select, device_dtype=torch.float32)
    batches = [bandit.bandit_transitions(learner, bandit.BATCH_SIZE,
                                         seed=100 + i)
               for i in range(_GRAPH_STEPS)]
    learner.calibrate(learner.create_state(seed=0), batches[0])
    runs = {}
    for graphs in (False, True):
      hook = Losses()
      with tempfile.TemporaryDirectory() as model_dir:
        state = train_qtopt(learner, model_dir,
                            replay_buffer=_FixedReplay(batches),
                            max_train_steps=_GRAPH_STEPS,
                            batch_size=bandit.BATCH_SIZE,
                            save_checkpoints_steps=_GRAPH_STEPS,
                            log_every_steps=4, hooks=[hook], graphs=graphs)
      runs[graphs] = (state, {s: v.item() for s, v in hook.by_step.items()})
    diff, equal = _state_diff(runs[False][0], runs[True][0])
    loss_diff = max(abs(runs[True][1][s] - runs[False][1][s])
                    for s in runs[False][1])
    _log(f"int8 Bellman graphed vs eager (f32, {select}, B=256, "
         f"{_GRAPH_STEPS} steps): max state diff {diff}, bitwise {equal}, "
         f"max loss diff {loss_diff}")
    if not equal or loss_diff != 0.0:
      raise AssertionError(f"int8 {select}: graphed differs from eager")
  torch.backends.cudnn.deterministic = False
  torch.backends.cudnn.allow_tf32 = True
  # int8 against the bf16 tower on the trained state, shared noise, under
  # the exact scorer (the same params in f32, lax select).
  i8, state = trained["fused"]
  ts = state.train_state
  exact = bandit.bellman_learner(cem_select="lax", device_dtype=torch.float32)
  obs = {k: torch.from_numpy(v).cuda() for k, v in make_random_tensors_flat(
      exact.observation_specification(), 256, seed=12).items()}
  g = torch.Generator(device="cuda").manual_seed(13)
  noise = torch.randn((2, 256, 64, 4), generator=g, device="cuda")
  batch = {k: torch.from_numpy(v).cuda() for k, v in
           bandit.bandit_transitions(exact, bandit.BATCH_SIZE, seed=14).items()}
  regrets = {}
  for dtype in (torch.float32, torch.bfloat16):
    bf = bandit.bellman_learner(cem_select="fused", device_dtype=dtype)
    if dtype == torch.float32:
      quant = _int8_learner(device_dtype=dtype)
      quant.calibrate(state, batch)
    else:
      quant = i8
    a_bf = bf.build_policy()(ts, obs, noise=noise)
    a_i8 = quant.build_policy()(ts, obs, noise=noise)
    with torch.inference_mode():
      score = exact._cem_fns(exact.model.bind(ts), obs)[0]
      q_bf, q_i8 = score(a_bf[:, None])[:, 0], score(a_i8[:, None])[:, 0]
    regret = q_bf - q_i8
    row = dict(max_value_regret=regret.max().item(),
               mean_value_regret=regret.mean().item(),
               q_spread=(q_bf.max() - q_bf.min()).item() + 1e-6,
               same_action_fraction=((a_bf - a_i8).abs().max(dim=1).values
                                     < 1e-6).float().mean().item())
    if dtype == torch.bfloat16:
      # The bf16 floor: the bf16 tower's own two selects disagree too.
      a_lax = bandit.bellman_learner(cem_select="lax").build_policy()(
          ts, obs, noise=noise)
      with torch.inference_mode():
        q_lax = score(a_lax[:, None])[:, 0]
      row["bf16_fused_vs_lax_max_regret"] = (q_bf - q_lax).abs().max().item()
      means = {}
      for name, learner in (("int8", quant), ("bf16", bf)):
        _, _, metrics = learner.train_grads(state, batch, noise=noise)
        means[name] = metrics["target_mean"].item()
      row["target_mean_int8"], row["target_mean_bf16"] = (means["int8"],
                                                          means["bf16"])
      row["target_mean_gap"] = means["int8"] - means["bf16"]
    regrets[str(dtype)] = row
  _log(f"int8 vs bf16 tower (B=256, trained state, shared noise, exact "
       f"scorer f32 lax): {json.dumps(regrets)}")
  for name, row in regrets.items():
    if row["mean_value_regret"] / row["q_spread"] >= 0.05:
      raise AssertionError(f"int8 CEM loses value ({name}): {row}")
  return launches["fused"]


def phase_int8_timings():
  """The four tower × select paths of the Bellman step at B=256, graphed
  at K=1 over the synthetic-bandit replay: grad steps/s over a whole
  200-step run (steps after the first dispatch over their wall time) and,
  by the profiler, device ms a step and idle share. Then the population
  path's device ms (graph replay) in int8 against bf16 at B=256, P=64:
  `quantized_pool_population` (merge, int8 head conv, pool) against
  `pool_population` (merge, bf16 head conv, BN, relu, pool), and the
  per-step requantization (`quantize_tower`)."""
  import tempfile
  import torch
  from tensor2robot_tpu_torch.bin.profile_policy import (
      profile_qtopt_train_step,
  )
  from tensor2robot_tpu_torch.research.qtopt import ReplayBuffer
  from tensor2robot_tpu_torch.research.qtopt import networks as net_lib
  from tensor2robot_tpu_torch.research.qtopt import synthetic_bandit as bandit
  from tensor2robot_tpu_torch.research.qtopt.train_qtopt import train_qtopt
  Losses, FirstDispatch = _hooks()

  rows = {}
  for tower in ("bf16", "int8"):
    for select in ("lax", "fused"):
      learner = bandit.bellman_learner(cem_inference=tower, cem_select=select)
      replay = ReplayBuffer(learner.transition_specification(),
                            capacity=4096, seed=0)
      replay.add(bandit.bandit_transitions(learner, 4096, seed=1))
      first = FirstDispatch()
      with tempfile.TemporaryDirectory() as model_dir:
        train_qtopt(learner, model_dir, replay_buffer=replay,
                    max_train_steps=_RATE_STEPS, batch_size=bandit.BATCH_SIZE,
                    save_checkpoints_steps=_RATE_STEPS, log_every_steps=40,
                    hooks=[first])
        torch.cuda.synchronize()
        t_end = time.perf_counter()
      prof = profile_qtopt_train_step(graphs=True, cem_inference=tower,
                                      cem_select=select)
      prof.pop("top_kernels")
      rows[f"{tower} {select}"] = dict(
          grad_steps_per_sec=(_RATE_STEPS - first.step) / (t_end - first.time),
          device_ms_per_step=prof["device_busy_ms_per_call"],
          idle_share=prof["device_idle_share"],
          wall_ms_per_step=prof["wall_ms_per_call"],
          kernels_per_step=prof["kernel_launches_per_call"])
      _log(f"Bellman step {tower} tower, {select} select (B=256, K=1 "
           f"graphed): {json.dumps(rows[f'{tower} {select}'])}")
  learner = _int8_learner()
  state = learner.create_state(seed=0)
  batch = bandit.bandit_transitions(learner, 256, seed=1)
  learner.calibrate(state, batch)
  net = learner.model.bind(state.train_state)
  image = torch.from_numpy(batch["next_image"]).cuda()
  g = torch.Generator(device="cuda").manual_seed(5)
  actions = torch.rand((256, 64, 4), generator=g, device="cuda") * 2 - 1
  scales = _scale_tensors(learner, "cuda")
  with torch.no_grad():
    tower = net_lib.quantize_tower(net, scales)
    enc_q = net_lib.quantized_encode(net, tower, image)
    enc = net.encode(image)
    paths = {"bf16": lambda: net.pool_population(enc, {}, actions),
             "int8": lambda: net_lib.quantized_pool_population(
                 net, tower, enc_q, {}, actions)}
    tails = {"bf16": [], "int8": []}
    for name in ("bf16", "int8", "int8", "bf16"):
      tails[name].append(_graph_ms(paths[name], iters=10))
    requant = _graph_ms(lambda: net_lib.quantize_tower(net, scales))
  _log(f"population path device ms (B=256, P=64, bf16 compute; graph "
       f"replay, turns bf16, int8, int8, bf16): bf16 tower {tails['bf16']}, "
       f"int8 tower {tails['int8']}; quantize_tower per call {requant}")
  return rows, tails, requant


def _serving_loader(learner, seed, example, cem_iterations=None):
  def load():
    state = learner.create_state(seed=seed).train_state
    learner.ensure_calibrated(state)
    return learner.build_policy(cem_iterations=cem_iterations), state, example
  return load


def _check_actions(name, actions):
  import numpy as np
  if not np.all(np.isfinite(actions)) or np.any(np.abs(actions) > 1.0):
    raise AssertionError(f"{name}: bad actions {actions}")


_TRAFFIC_S = 10.0


def phase_serving_plane():
  """The multi-tenant serving plane at `GraspingQModel()` width: a
  `ServingFront` over a `ModelArena` whose budget holds three tenants'
  `state_bytes`, four tenants each with its own seed (three bf16 + fused,
  one int8 + fused; buckets 1–8), an `AdmissionController` (the abusive
  tenant at 20 rows/s, burst 8, "drop"; the others unlimited). Six
  caller threads send single-observation requests for ~10 s: two offer
  the abusive tenant 10× its rate open-loop, four cycle the other three
  tenants closed-loop, so round-robin traffic evicts and reloads. Gates:
  every action finite and in bounds; every reload builds no kernel
  (`cache_misses == 0`) and at least one eviction happened; the abusive
  tenant dropped requests while every request of the others completed;
  a single-request dispatch equals the direct engine answer bit for bit
  (bf16 and int8 tenants); `SpeculativeCEM` over the 1-iteration and the
  full CEM engines: a repeated observation gets the refined answer, equal
  to the full engine's under the same params version, and after a
  `swap_state` no refined answer from before it is served; traced
  windows of the front and of the speculative pair whose cem_select
  launches equal CUPTI's and, per thread, what each thread should
  launch."""
  import numpy as np
  import torch
  from tensor2robot_tpu_torch import ops
  from tensor2robot_tpu_torch.research.qtopt import (
      GraspingQModel,
      QTOptLearner,
  )
  from tensor2robot_tpu_torch.serving import (
      AdmissionController,
      BucketedServingEngine,
      ModelArena,
      RequestRejected,
      ServingFront,
      SpeculativeCEM,
      TenantPolicy,
  )
  from tensor2robot_tpu_torch.serving.engine import acting_params
  from tensor2robot_tpu_torch.serving.microbatcher import dispatch_seed
  from tensor2robot_tpu_torch.specs import make_random_tensors
  from tensor2robot_tpu_torch.telemetry import metrics as tmetrics

  learners = {
      "bf16": QTOptLearner(GraspingQModel(), cem_select="fused", **_CEM_KW),
      "int8": QTOptLearner(GraspingQModel(), cem_inference="int8",
                           cem_select="fused", **_CEM_KW)}
  spec = learners["bf16"].observation_specification()
  example = make_random_tensors(spec, batch_size=1, seed=0)
  tenants = {"grasp-a": ("bf16", 0), "grasp-b": ("bf16", 1),
             "grasp-c": ("bf16", 2), "grasp-i8": ("int8", 3)}
  abusive, rate = "grasp-a", 20.0
  one = acting_params(learners["bf16"].create_state(seed=0)).nbytes
  tmetrics.registry().reset()
  arena = ModelArena(budget_bytes=3 * one)
  front = ServingFront(arena, AdmissionController(slo_ms=100.0), seed=0)
  for name, (kind, seed) in tenants.items():
    policy = (TenantPolicy(rate_rps=rate, burst=8, overflow="drop",
                           slo_ms=100.0) if name == abusive
              else TenantPolicy(slo_ms=100.0))
    front.register_tenant(name, _serving_loader(learners[kind], seed, example),
                          policy=policy, max_batch=8, takes_rng=True,
                          preload=name != "grasp-i8")
  observations = [make_random_tensors(spec, batch_size=1,
                                      seed=100 + i).to_flat_dict()
                  for i in range(64)]
  latencies = {name: [] for name in tenants}
  errors, abusive_futures = [], []
  counts = {"abusive_offered": 0, "abusive_rejected": 0, "others_sent": 0,
            "others_done": 0}
  lock = threading.Lock()
  stop = threading.Event()

  def abuser(i):
    period = 2.0 / (10 * rate)  # two threads: 10× the rate together
    j = 0
    while not stop.is_set():
      t0 = time.perf_counter()
      try:
        abusive_futures.append(front.submit(
            abusive, observations[(i + 2 * j) % 64]))
      except RequestRejected:
        with lock:
          counts["abusive_rejected"] += 1
      with lock:
        counts["abusive_offered"] += 1
      j += 1
      time.sleep(max(0.0, period - (time.perf_counter() - t0)))

  others = [t for t in tenants if t != abusive]

  def caller(i):
    j = 0
    while not stop.is_set():
      name = others[(i + j) % len(others)]
      with lock:
        counts["others_sent"] += 1
      t0 = time.perf_counter()
      try:
        action = front.predict(name, observations[(7 * i + j) % 64])
        _check_actions(name, action)
      except Exception as e:  # noqa: BLE001 — raised below
        errors.append((name, repr(e)))
        return
      latencies[name].append((time.perf_counter() - t0) * 1e3)
      with lock:
        counts["others_done"] += 1
      j += 1

  threads = ([threading.Thread(target=abuser, args=(i,)) for i in range(2)]
             + [threading.Thread(target=caller, args=(i,)) for i in range(4)])
  t_start = time.perf_counter()
  for t in threads:
    t.start()
  time.sleep(_TRAFFIC_S)
  stop.set()
  for t in threads:
    t.join(timeout=300)
  traffic_s = time.perf_counter() - t_start
  for future in abusive_futures:
    _check_actions(abusive, future.result(timeout=300))
  abusive_done = len(abusive_futures)
  stats = arena.stats()
  snap = tmetrics.registry().snapshot()
  dropped = snap["counters"].get(f"serving.{abusive}.admission.dropped", 0.0)
  _log(f"serving plane traffic ({traffic_s:.2f} s, 6 threads): "
       f"{json.dumps(counts)}, abusive admitted and answered {abusive_done}, "
       f"dropped rows {dropped}; arena {json.dumps(stats)}")
  if errors or any(t.is_alive() for t in threads):
    raise AssertionError(f"serving plane callers failed: {errors[:3]}")
  if counts["others_done"] != counts["others_sent"]:
    raise AssertionError(f"not every request completed: {counts}")
  if not dropped > 0 or counts["abusive_rejected"] == 0:
    raise AssertionError("the abusive tenant dropped nothing")
  if (stats["evictions"] < 1 or stats["reloads"] < 1
      or stats["reload_cache_misses"] != 0):
    raise AssertionError(f"arena: {stats}")
  # A single-request dispatch against the engine's direct answer.
  order = list(tenants)
  for name in ("grasp-b", "grasp-i8"):
    arena.engine(name)  # resident now (a reload if it was evicted)
    obs = observations[5]
    d = front.dispatches
    answer = front.predict(name, obs)
    engine = arena.engine(name)
    generator = torch.Generator(device="cuda").manual_seed(
        dispatch_seed(order.index(name), d))
    direct = engine.predict(obs, generator=generator)
    if not np.array_equal(answer, direct):
      raise AssertionError(f"{name}: the front's answer {answer} is not the "
                           f"engine's {direct}")
  # A traced window of the front: only its dispatcher launches cem_select,
  # 2 a dispatch (CEM 2 iterations); no load runs (b and c resident).
  arena.engine("grasp-b")
  arena.engine("grasp-c")
  d0 = front.dispatches

  def window_caller(i):
    for j in range(10):
      front.predict(("grasp-b", "grasp-c")[(i + j) % 2], observations[j])

  with traced_launches("serving front window") as traced:
    callers = [threading.Thread(target=window_caller, args=(i,))
               for i in range(2)]
    for t in callers:
      t.start()
    for t in callers:
      t.join(timeout=300)
  window = {thread: {k: n for k, n in counts_.items() if n}
            for thread, counts_ in ops.launch_counts_by_thread().items()}
  window = {k: v for k, v in window.items() if v}
  want = {"serving-front": {"cem_select": 2 * (front.dispatches - d0)}}
  _log(f"serving front window: dispatches {front.dispatches - d0}, launches "
       f"by thread {json.dumps(window)}, CUPTI {traced['cem_select']}")
  if window != want:
    raise AssertionError(f"front window launches {window} != {want}")
  front_window = traced["cem_select"]
  report = front.admission.slo_report()
  per_tenant = {}
  for name in tenants:
    done = snap["counters"].get(f"serving.{name}.completions", 0.0)
    n_disp = front.dispatches_per_tenant.get(name, 0)
    per_tenant[name] = dict(
        wall_ms=_pcts(latencies[name]) if latencies[name] else None,
        e2e_p50_ms=report[name].get("e2e_p50_ms"),
        e2e_p95_ms=report[name].get("e2e_p95_ms"),
        dispatch_p50_ms=report[name].get("p50_ms"),
        dispatch_p95_ms=report[name].get("p95_ms"),
        dispatches=n_disp, rows_per_dispatch=done / max(n_disp, 1))
  load_ms = snap["histograms"].get("serving.arena.load_ms", {})
  _log(f"serving plane per tenant: {json.dumps(per_tenant)}")
  _log(f"serving plane loads: count {load_ms.get('count')} p50 "
       f"{load_ms.get('p50')} ms p95 {load_ms.get('p95')} ms max "
       f"{load_ms.get('max')} ms; last load {json.dumps(stats['last_load'])}")
  front.close()
  # SpeculativeCEM over the 1-iteration and the full CEM engines.
  learner = learners["bf16"]
  states = [learner.create_state(seed=s).train_state for s in (10, 11)]
  fast = BucketedServingEngine(learner.build_policy(cem_iterations=1),
                               states[0], example, max_batch=8,
                               takes_rng=True, metric_prefix="serving.fast.")
  full = BucketedServingEngine(learner.build_policy(), states[0], example,
                               max_batch=8, takes_rng=True,
                               metric_prefix="serving.full.")
  fast.warmup()
  full.warmup()
  gen = lambda: torch.Generator(device="cuda").manual_seed(5)  # noqa: E731
  spec_cem = SpeculativeCEM(
      fast_predict=lambda o: fast.predict(o, generator=gen()),
      full_predict=lambda o: full.predict(o, generator=gen()),
      version_fn=lambda: full.params_version)
  obs = observations[9]
  try:
    first = spec_cem.predict(obs)
    if not np.array_equal(first, fast.predict(obs, generator=gen())):
      raise AssertionError("speculative: the first answer is not the fast "
                           "engine's")
    if not spec_cem.flush(timeout_secs=60):
      raise AssertionError("speculative: the refinement did not land")
    refined = spec_cem.predict(obs)
    full_before = full.predict(obs, generator=gen())
    if (not np.array_equal(refined, full_before)
        or spec_cem.stats()["refined_served"] != 1):
      raise AssertionError("speculative: the repeat is not the full answer")
    for engine in (fast, full):
      engine.swap_state(states[1])
    spec_cem.on_publish(full.params_version)
    after = spec_cem.predict(obs)
    if (not np.array_equal(after, fast.predict(obs, generator=gen()))
        or spec_cem.stats()["refined_served"] != 1):
      raise AssertionError("speculative: a refined answer crossed the swap")
    spec_cem.flush(timeout_secs=60)
    again = spec_cem.predict(obs)
    if not np.array_equal(again, full.predict(obs, generator=gen())):
      raise AssertionError("speculative: the new version's refinement is "
                           "not the full answer")
    # Traced window: the caller's fast dispatches (1 launch each, one CEM
    # iteration) and the refine worker's full ones (2 each).
    stats0 = spec_cem.stats()
    with traced_launches("speculative window") as traced:
      for i in range(10):
        spec_cem.predict(observations[20 + i])
      spec_cem.flush(timeout_secs=60)
    stats1 = spec_cem.stats()
    window = {thread: {k: n for k, n in c.items() if n}
              for thread, c in ops.launch_counts_by_thread().items()}
    window = {k: v for k, v in window.items() if v}
    refines = stats1["refines"] - stats0["refines"]
    want = {threading.current_thread().name: {"cem_select": 10},
            "speculative-refine": {"cem_select": 2 * refines}}
    _log(f"speculative window: 10 fast answers, {refines} refines; launches "
         f"by thread {json.dumps(window)}, CUPTI {traced['cem_select']}")
    if refines != 10 or window != want:
      raise AssertionError(f"speculative window {window} != {want}")
    spec_window = traced["cem_select"]
    walls = {}
    for name, engine in (("fast", fast), ("full", full)):
      ms = []
      for i in range(100):
        t0 = time.perf_counter()
        engine.predict(observations[i % 64], generator=gen())
        ms.append((time.perf_counter() - t0) * 1e3)
      walls[name] = _pcts(ms)
    ms = []
    for i in range(100):
      t0 = time.perf_counter()
      spec_cem.predict(observations[20 + i % 10])  # refined: cache hits
      ms.append((time.perf_counter() - t0) * 1e3)
    walls["speculative repeat"] = _pcts(ms)
    _log(f"speculative CEM wall ms per B=1 request (host clock): "
         f"{json.dumps(walls)}; stats {json.dumps(spec_cem.stats())}")
  finally:
    spec_cem.close()
  scalars = tmetrics.registry().scalars("serving.")
  _log(f"registry serving.* scalars: {json.dumps(scalars, sort_keys=True)}")
  return {"serving front window": front_window,
          "speculative window": spec_window}


_REPO = os.path.dirname(os.path.abspath(__file__))
_GIN_INT8 = "tensor2robot_tpu/research/qtopt/configs/qtopt_int8.gin"
_GIN_POSE = "tensor2robot_tpu/research/pose_env/configs/train_pose_env.gin"
_GIN_SERVING = "tensor2robot_tpu/serving/configs/serving_multitenant.gin"
_GIN_VRGRIPPER = ("tensor2robot_tpu/research/vrgripper/configs/"
                  "train_vrgripper_transformer.gin")


def _run_trainer(label, args, model_dir):
  """`python -m tensor2robot_tpu_torch.bin.run_t2r_trainer` with `args`
  from the checkout's root, its output in `<model_dir>/trainer.log`;
  fails on a non-zero exit. Returns the wall seconds."""
  import torch
  torch.cuda.empty_cache()
  cmd = [sys.executable, "-m", "tensor2robot_tpu_torch.bin.run_t2r_trainer",
         *args]
  env = dict(os.environ, PYTHONPATH=_REPO)
  log_path = os.path.join(model_dir, "trainer.log")
  t0 = time.perf_counter()
  with open(log_path, "w") as log:
    proc = subprocess.run(cmd, cwd=_REPO, env=env, stdout=log,
                          stderr=subprocess.STDOUT, timeout=900)
  wall = time.perf_counter() - t0
  with open(log_path) as f:
    tail = f.read().splitlines()[-12:]
  _log(f"{label}: exit {proc.returncode} in {wall:.2f} s: "
       f"{' '.join(cmd[1:])}")
  if proc.returncode != 0:
    raise AssertionError(f"{label} exited {proc.returncode}:\n"
                         + "\n".join(tail))
  return wall


def _checked_records(path):
  """Every record of a `metrics_<tag>.jsonl`, each a valid envelope."""
  from tensor2robot_tpu_torch.telemetry import records
  with open(path) as f:
    raw = [json.loads(line) for line in f if line.strip()]
  for record in raw:
    problems = records.validate_record(record)
    if problems:
      raise AssertionError(f"{path}: {record}: {problems}")
  return raw


def phase_gin_qtopt_int8():
  """The shipped `qtopt_int8.gin` as written, through the trainer binary
  (`--trainer=qtopt`, only `train_qtopt.model_dir` bound): 1000 steps of
  B=256 over spec-random prefill, int8 tower, lax select,
  `shard_weight_update = True`. Gates: exit 0, a valid envelope at every
  100 steps to 1000, finite losses whose last three fall below the first
  three, checkpoints at 500 and 1000. grad_steps_per_sec printed."""
  import tempfile
  import numpy as np
  with tempfile.TemporaryDirectory() as model_dir:
    wall = _run_trainer("gin qtopt_int8 (as shipped)", [
        "--trainer=qtopt", "--gin_configs", _GIN_INT8,
        "--gin_bindings", f"train_qtopt.model_dir='{model_dir}'"], model_dir)
    raw = _checked_records(os.path.join(model_dir, "metrics_train.jsonl"))
    steps = [r["step"] for r in raw]
    losses = [r["payload"]["loss"] for r in raw]
    rates = [r["payload"]["grad_steps_per_sec"] for r in raw]
    mfu = [r["payload"].get("perf.mfu") for r in raw]
    ckpts = sorted(int(d) for d in os.listdir(os.path.join(model_dir,
                                                           "ckpt")))
  _log(f"gin qtopt_int8: wall {wall:.2f} s; steps {steps}; loss {losses}; "
       f"grad_steps_per_sec {rates} (median after the first interval "
       f"{statistics.median(rates[1:])}); input_wait_fraction "
       f"{[r['payload']['input_wait_fraction'] for r in raw]}; perf.mfu "
       f"{mfu}; perf.device_time_fraction "
       f"{[r['payload'].get('perf.device_time_fraction') for r in raw]}; "
       f"checkpoints {ckpts}")
  if not all(m is not None and 0.0 < m < 1.0 for m in mfu):
    raise AssertionError(f"gin qtopt_int8: perf.mfu {mfu}")
  if steps != list(range(100, 1001, 100)):
    raise AssertionError(f"gin qtopt_int8: record steps {steps}")
  if not all(np.isfinite(losses)) or not (np.mean(losses[-3:])
                                          < np.mean(losses[:3])):
    raise AssertionError(f"gin qtopt_int8: losses {losses}")
  if not {500, 1000} <= set(ckpts):
    raise AssertionError(f"gin qtopt_int8: checkpoints {ckpts}")


def phase_gin_qtopt_fused():
  """The same shipped file in-process through the port's registry, with
  `QTOptLearner.cem_select = "fused"`, 200 steps and checkpoints every
  100 bound on top, then `train_qtopt()`: the fused_cem_select kernel
  from a gin-configured learner, 2 launches a step + the graph's warm-up
  step's, the counter held to CUPTI's in a traced window. Returns the
  traced launches."""
  import tempfile
  from tensor2robot_tpu_torch import config as gin
  from tensor2robot_tpu_torch.bin import run_t2r_trainer
  from tensor2robot_tpu_torch.research.qtopt.train_qtopt import train_qtopt
  run_t2r_trainer.import_configurable_families()
  steps = 200
  try:
    with tempfile.TemporaryDirectory() as model_dir:
      gin.parse_config_files_and_bindings([_GIN_INT8], [
          "QTOptLearner.cem_select = 'fused'",
          f"train_qtopt.max_train_steps = {steps}",
          "train_qtopt.save_checkpoints_steps = 100",
          f"train_qtopt.model_dir = '{model_dir}'"])
      t0 = time.perf_counter()
      with traced_launches("gin qtopt_int8 + fused select") as traced:
        state = train_qtopt()
      wall = time.perf_counter() - t0
      raw = _checked_records(os.path.join(model_dir, "metrics_train.jsonl"))
      ckpts = sorted(int(d) for d in os.listdir(os.path.join(model_dir,
                                                             "ckpt")))
    bound = {b: gin.query_parameter(b) for b in (
        "QTOptLearner.cem_inference", "QTOptLearner.cem_select",
        "train_qtopt.shard_weight_update", "train_qtopt.batch_size")}
  finally:
    gin.clear_config()
  warm = _warm("cem_select")
  want = 2 * steps + warm
  _log(f"gin qtopt_int8 + fused ({json.dumps(bound)}): {state.step} steps "
       f"in {wall:.2f} s (traced); cem_select launches "
       f"{traced['cem_select']} (warm-up {warm}); records at "
       f"{[r['step'] for r in raw]}, loss "
       f"{[r['payload']['loss'] for r in raw]}, grad_steps_per_sec "
       f"{[r['payload']['grad_steps_per_sec'] for r in raw]}; checkpoints "
       f"{ckpts}")
  if state.step != steps or traced["cem_select"] != want:
    raise AssertionError(f"gin fused: step {state.step}, launches "
                         f"{traced['cem_select']} != {want}")
  if [r["step"] for r in raw] != [100, 200] or ckpts != [100, 200]:
    raise AssertionError(f"gin fused: records {raw}, checkpoints {ckpts}")
  return traced["cem_select"]


def phase_gin_pose_env():
  """The shipped `train_pose_env.gin` as written, through the trainer
  binary (only `train_eval_model.model_dir` bound): 200 steps of B=64
  on 64×64 images, filters (32, 64, 128), bf16, a 500-episode
  `SuccessEvalHook` at each checkpoint. Gates: exit 0, success records
  at steps 100 and 200 with success_rate, mean_pose_error and
  num_episodes == 500, every record a valid envelope. The success rate
  is printed, not gated (the config trains on random data); each
  checkpoint's hook seconds are its success record's wall time less the
  train record's of the same step (checkpoint write + hook)."""
  import tempfile
  with tempfile.TemporaryDirectory() as model_dir:
    wall = _run_trainer("gin train_pose_env (as shipped)", [
        "--gin_configs", _GIN_POSE,
        "--gin_bindings", f"train_eval_model.model_dir='{model_dir}'"],
        model_dir)
    success = _checked_records(os.path.join(model_dir,
                                            "metrics_success_eval.jsonl"))
    train = _checked_records(os.path.join(model_dir, "metrics_train.jsonl"))
    evals = _checked_records(os.path.join(model_dir, "metrics_eval.jsonl"))
  train_wall = {r["step"]: r["wall"] for r in train}
  hook_s = {r["step"]: r["wall"] - train_wall[r["step"]] for r in success}
  _log(f"gin train_pose_env: wall {wall:.2f} s; success "
       f"{[dict(step=r['step'], **r['payload']) for r in success]}; hook s "
       f"per checkpoint {json.dumps(hook_s)}; train "
       f"{[(r['step'], r['payload']['loss'], r['payload']['steps_per_sec']) for r in train]}; "
       f"eval {[r['payload'] for r in evals]}")
  if [r["step"] for r in success] != [100, 200]:
    raise AssertionError(f"gin pose_env: success records {success}")
  for r in success:
    payload = r["payload"]
    if (set(payload) != {"success_rate", "mean_pose_error", "num_episodes"}
        or payload["num_episodes"] != 500):
      raise AssertionError(f"gin pose_env: {r}")


def _gin_serving_stack(cache):
  """`ModelArena()` and `ServingFront(arena)` from the shipped
  `serving_multitenant.gin`, parsed strictly into the port's registry,
  plus one binding on top: `ModelArena.cache_dir = cache`. The shipped
  value, a fixed path under /tmp shared by every run on the host, is
  checked to have parsed and is not used, so that no run writes outside
  its own temporary directory. Fails unless the arena's cache is
  `cache`. The caller clears the config."""
  from tensor2robot_tpu_torch import config as gin
  from tensor2robot_tpu_torch.bin import run_t2r_trainer
  from tensor2robot_tpu_torch.serving import ModelArena, ServingFront
  from tensor2robot_tpu_torch.startup import compile_cache
  run_t2r_trainer.import_configurable_families()
  gin.parse_config_file(_GIN_SERVING)
  shipped = gin.query_parameter("ModelArena.cache_dir")
  if shipped != "/tmp/t2r_serving_xla_cache":
    raise AssertionError(f"gin serving: ModelArena.cache_dir {shipped!r}")
  gin.bind_parameter("ModelArena.cache_dir", cache)
  arena = ModelArena()
  front = ServingFront(arena)
  if compile_cache.cache_dir() != cache:
    raise AssertionError(f"gin serving: arena cache "
                         f"{compile_cache.cache_dir()}, not {cache}")
  return arena, front


def _arena_cache_child(cache):
  """Run in a fresh process (nothing built or loaded yet): the gin
  serving stack over `cache`, one fused `GraspingQModel()` tenant loaded
  by a request, evicted, and reloaded by another. Prints the first
  load's and the reload's records and the libraries in `cache` as one
  JSON line."""
  from tensor2robot_tpu_torch import config as gin
  from tensor2robot_tpu_torch.research.qtopt import (
      GraspingQModel,
      QTOptLearner,
  )
  from tensor2robot_tpu_torch.specs import make_random_tensors
  try:
    arena, front = _gin_serving_stack(cache)
    learner = QTOptLearner(GraspingQModel(), cem_select="fused", **_CEM_KW)
    spec = learner.observation_specification()
    example = make_random_tensors(spec, batch_size=1, seed=0)
    front.register_tenant("c4", _serving_loader(learner, 40, example),
                          max_batch=8, takes_rng=True)
    loads = []
    for seed in (300, 301):
      obs = make_random_tensors(spec, batch_size=1, seed=seed).to_flat_dict()
      _check_actions("c4", front.predict("c4", obs))
      loads.append(dict(arena.stats()["last_load"]))
      arena.evict("c4")
    front.close()
  finally:
    gin.clear_config()
  print(json.dumps({"loads": loads, "libraries": sorted(os.listdir(cache))}),
        flush=True)


def _arena_cache_run(cache):
  """`_arena_cache_child(cache)` in a new interpreter from the checkout's
  root; its JSON line."""
  code = ("import sys, chip_smoke; "
          "chip_smoke._arena_cache_child(sys.argv[1])")
  proc = subprocess.run([sys.executable, "-c", code, cache], cwd=_REPO,
                        env=dict(os.environ, PYTHONPATH=_REPO),
                        capture_output=True, text=True, timeout=600)
  if proc.returncode != 0:
    raise AssertionError(f"arena cache child exited {proc.returncode}:\n"
                         + proc.stderr[-4000:])
  return json.loads(proc.stdout.strip().splitlines()[-1])


def phase_gin_cache():
  """The shipped `ModelArena.cache_dir` binding's contract (C4), each
  run in a new process over one fresh temporary directory: the first
  process's first load builds cem_select into that directory
  (cache_misses >= 1, the library there); its reload after an eviction
  builds nothing (cache_misses == 0). A second process over the same
  directory finds the library at its first load (cache_misses == 0,
  cache_hits >= 1) and builds nothing at its reload either."""
  import shutil
  import tempfile
  cache = tempfile.mkdtemp(prefix="t2r_arena_cache_")
  try:
    cold = _arena_cache_run(cache)
    warm = _arena_cache_run(cache)
  finally:
    shutil.rmtree(cache, ignore_errors=True)
  _log(f"gin serving cache: cold process {json.dumps(cold)}; warm process "
       f"{json.dumps(warm)}")
  first, reload_ = cold["loads"]
  if (first["reload"] or first["cache_misses"] < 1
      or not any(f.startswith("libcem_select-") for f in cold["libraries"])):
    raise AssertionError(f"gin serving cache: cold first load {cold}")
  if not reload_["reload"] or reload_["cache_misses"] != 0:
    raise AssertionError(f"gin serving cache: cold reload {cold}")
  first, reload_ = warm["loads"]
  if (first["cache_misses"] != 0 or first["cache_hits"] < 1
      or reload_["cache_misses"] != 0):
    raise AssertionError(f"gin serving cache: warm process {warm}")


def phase_gin_serving():
  """The shipped `serving_multitenant.gin`, parsed strictly into the
  port's registry; `ModelArena()` and `ServingFront(arena)` built from
  its bindings, with `ModelArena.cache_dir` bound on top to a temporary
  directory (`_gin_serving_stack`). Two `GraspingQModel()` tenants
  (fused select) take 64 single-observation requests each from two
  threads, in a traced window (cem_select 2 a dispatch, counter =
  CUPTI's). Gates: the gin's envelope reached the `AdmissionController`
  (200 rows/s, burst 64, queue 256, "drop", SLO 50 ms), every request
  completes with a finite in-bounds action, a forced eviction reloads.
  This process has cem_select loaded already, so its reload cannot
  build: the cache contract is `phase_gin_cache`'s, in new processes.
  The build directory is restored and the temporary one removed
  afterwards. Returns the traced launches."""
  import shutil
  import tempfile
  from tensor2robot_tpu_torch import config as gin
  from tensor2robot_tpu_torch.research.qtopt import (
      GraspingQModel,
      QTOptLearner,
  )
  from tensor2robot_tpu_torch.specs import make_random_tensors
  from tensor2robot_tpu_torch.startup import compile_cache
  from tensor2robot_tpu_torch.telemetry import metrics as tmetrics
  build_dir = compile_cache.cache_dir()
  cache = tempfile.mkdtemp(prefix="t2r_arena_cache_")
  tmetrics.registry().reset()
  try:
    arena, front = _gin_serving_stack(cache)
    policy = front.admission.default_policy
    envelope = dict(rate_rps=policy.rate_rps, burst=policy.burst,
                    max_queue=policy.max_queue, overflow=policy.overflow,
                    slo_ms=policy.slo_ms)
    _log(f"gin serving: admission {json.dumps(envelope)}, arena cache "
         f"{cache}, budget {arena.stats().get('budget_bytes')}")
    if envelope != dict(rate_rps=200.0, burst=64, max_queue=256,
                        overflow="drop", slo_ms=50.0):
      raise AssertionError(f"gin serving: envelope {envelope}")
    learner = QTOptLearner(GraspingQModel(), cem_select="fused", **_CEM_KW)
    example = make_random_tensors(learner.observation_specification(),
                                  batch_size=1, seed=0)
    tenants = ("gin-a", "gin-b")
    for i, name in enumerate(tenants):
      front.register_tenant(name, _serving_loader(learner, 40 + i, example),
                            max_batch=8, takes_rng=True)
    observations = [make_random_tensors(
        learner.observation_specification(), batch_size=1,
        seed=200 + i).to_flat_dict() for i in range(64)]
    for name in tenants:  # loads (graph captures) before the window
      _check_actions(name, front.predict(name, observations[0]))
    answers = {name: [] for name in tenants}
    errors = []

    def caller(name):
      try:
        for obs in observations:
          answers[name].append(front.predict(name, obs))
      except Exception as e:  # noqa: BLE001 — raised below
        errors.append((name, repr(e)))

    d0 = front.dispatches
    t0 = time.perf_counter()
    with traced_launches("gin serving window") as traced:
      threads = [threading.Thread(target=caller, args=(name,))
                 for name in tenants]
      for t in threads:
        t.start()
      for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    dispatches = front.dispatches - d0
    if errors or any(len(a) != 64 for a in answers.values()):
      raise AssertionError(f"gin serving: {errors[:3]} "
                           f"{[len(a) for a in answers.values()]}")
    for name, actions in answers.items():
      for action in actions:
        _check_actions(name, action)
    if traced["cem_select"] != 2 * dispatches:
      raise AssertionError(f"gin serving: launches {traced['cem_select']} "
                           f"!= 2 x {dispatches} dispatches")
    report = front.admission.slo_report()
    arena.evict("gin-a")
    _check_actions("gin-a", front.predict("gin-a", observations[1]))
    stats = arena.stats()
    _log(f"gin serving: 2 x 64 requests in {wall:.2f} s (traced), "
         f"{dispatches} dispatches, cem_select launches "
         f"{traced['cem_select']}; dispatch ms "
         f"{json.dumps({n: dict(p50=report[n].get('p50_ms'), p95=report[n].get('p95_ms'), e2e_p50=report[n].get('e2e_p50_ms'), e2e_p95=report[n].get('e2e_p95_ms')) for n in tenants})}; "
         f"arena {json.dumps(stats)}")
    if stats["reloads"] < 1:
      raise AssertionError(f"gin serving: arena {stats}")
    front.close()
  finally:
    gin.clear_config()
    compile_cache.configure_compilation_cache(cache_dir=build_dir)
    shutil.rmtree(cache, ignore_errors=True)
  return traced["cem_select"]


# SHA-256 of the port's JPEG bytes and of the pixels it decodes from
# them, for two seeded images (an odd size: partial MCUs). The card's
# host has no TensorFlow; tests/test_torch_jpeg.py pins these constants
# against tf.io.encode_jpeg / tf.io.decode_image on a host that has it.
JPEG_DIGESTS = {
    (64, 64, 3): (
        "493582f8c988fbac901b054882259098171371181e675cfecce015872a9debbc",
        "83a07b4cbccd88646595512861f8dc01f229a7d06cf0399b236d15ed335a6351"),
    (37, 53, 3): (
        "1033f540836c1083c0c20567224228f3ae119a72d86fe29586caf73bb45d7f04",
        "ae5237b130241e1e40385d11621588c8481c92c7da62da68439c8c0172744f02"),
}


def jpeg_digest_images():
  """The seeded images of `JPEG_DIGESTS`, by shape."""
  import numpy as np
  rng = np.random.default_rng(13)
  return {shape: rng.integers(0, 256, shape, dtype=np.uint8)
          for shape in JPEG_DIGESTS}


def _demo_episodes(num_episodes, seed):
  """The episodes `collect_demo_episodes(num_episodes=..., seed=...)`
  writes, rolled again in memory (its env, rng and defaults)."""
  import numpy as np
  from tensor2robot_tpu_torch.research.vrgripper import (
      VRGripperEnv,
      collect_expert_episode,
  )
  env = VRGripperEnv(image_size=48, seed=seed)
  rng = np.random.default_rng(seed + 1)
  return [collect_expert_episode(env, action_noise=0.05, min_steps=8, rng=rng)
          for _ in range(num_episodes)]


def _stream_rate(gen, model, num_workers, batches=100, on_first=None):
  """Batches/s of `gen`'s TRAIN stream over `batches` batches after the
  first (which fills the shuffle buffer and, with workers, starts them),
  parse alone: no device. `on_first` is called on the first batch while
  the stream is open (with workers, a batch lives in the shm ring: it
  is not read after the stream moves on or closes). Returns (the first
  batch, the rates)."""
  from tensor2robot_tpu_torch.data import Mode
  gen.set_specification_from_model(model, Mode.TRAIN)
  stream = gen.create_dataset(Mode.TRAIN)
  try:
    t0 = time.perf_counter()
    first = next(stream)
    first_s = time.perf_counter() - t0
    if on_first is not None:
      on_first(first)
    t0 = time.perf_counter()
    for _ in range(batches):
      next(stream)
    wall = time.perf_counter() - t0
  finally:
    getattr(stream, "close", lambda: None)()
  return first, {"num_workers": num_workers, "batches_per_s": batches / wall,
                 "ms_per_batch": wall / batches * 1e3,
                 "first_batch_s": first_s}


def _parse_rate(model, path, num_workers, batches=100):
  """`_stream_rate` of the gin's `TFRecordEpisodeInputGenerator` (TRAIN:
  shuffle buffer 1024, repeat, batch 16, sequence_length 32)."""
  from tensor2robot_tpu_torch.data import TFRecordEpisodeInputGenerator
  gen = TFRecordEpisodeInputGenerator(file_patterns=path, sequence_length=32,
                                      batch_size=16, num_workers=num_workers,
                                      seed=0)
  return _stream_rate(gen, model, num_workers, batches)[1]


# Batches of the two-worker read (phase 35), after the first.
_WORKER_BATCHES = 20


def phase_tfrecord_round_trip():
  """The data plane on the card's host: `collect_demo_episodes` writes
  100 seeded episodes as TFRecords (SequenceExample, PNG frames); the
  port's `TFRecordEpisodeInputGenerator` in EVAL mode yields exactly the
  batches `EpisodeInputGenerator` builds from the same episodes in
  memory (pixels, poses, actions and lengths bit for bit: PNG is
  lossless), through the native CRC-32C and PNG unfilter; then the
  gin's TRAIN-mode parse rate alone at `num_workers` 0, over that
  one file and over the same episodes in 4 files (the plane shards by
  file: over one file a second worker has nothing to read), and at
  `num_workers` 2 (worker processes over the shm ring) over the 4 files
  for `_WORKER_BATCHES` batches, whose batches must have the serial
  stream's keys, shapes and dtypes. Returns the rates."""
  import tempfile
  import numpy as np
  from tensor2robot_tpu_torch.data import (
      EpisodeInputGenerator,
      Mode,
      TFRecordEpisodeInputGenerator,
      write_episode_tfrecord,
  )
  from tensor2robot_tpu_torch.research.vrgripper import (
      collect_demo_episodes,
      gin_config,
  )
  from tensor2robot_tpu_torch.utils import native
  model = gin_config.gin_model()
  with tempfile.TemporaryDirectory() as tmp:
    t0 = time.perf_counter()
    path = collect_demo_episodes(os.path.join(tmp, "demos.tfrecord"),
                                 num_episodes=100, seed=0)
    write_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    records = TFRecordEpisodeInputGenerator(
        file_patterns=path, sequence_length=32, batch_size=16)
    episodes = _demo_episodes(100, seed=0)
    memory = EpisodeInputGenerator(episodes, sequence_length=32,
                                   batch_size=16, shuffle=False, repeat=False)
    for gen in (records, memory):
      gen.set_specification_from_model(model, Mode.EVAL)
    got = list(records.create_dataset(Mode.EVAL))
    want = list(memory.create_dataset(Mode.EVAL))
    if len(got) != len(want) or len(got) != 6:
      raise AssertionError(f"round trip: {len(got)} vs {len(want)} batches")
    for (gf, gl), (wf, wl) in zip(got, want):
      for g, w in ((gf, wf), (gl, wl)):
        g, w = g.to_flat_dict(), w.to_flat_dict()
        if sorted(g) != sorted(w) or any(
            g[k].dtype != w[k].dtype or not np.array_equal(g[k], w[k])
            for k in w):
          raise AssertionError(f"round trip: a batch differs in "
                               f"{[k for k in w if not np.array_equal(g[k], w[k])]}")
    lengths = np.concatenate([f["sequence_length"] for f, _ in got])
    rates = [dict(files=1, **_parse_rate(model, path, 0))]
    for i in range(4):
      write_episode_tfrecord(
          os.path.join(tmp, f"shard-{i}.tfrecord"), episodes[i::4],
          model.get_feature_specification(Mode.TRAIN),
          model.get_label_specification(Mode.TRAIN))
    shards = os.path.join(tmp, "shard-*.tfrecord")
    serial_first, serial_rate = _stream_rate(TFRecordEpisodeInputGenerator(
        file_patterns=shards, sequence_length=32, batch_size=16, seed=0),
        model, 0)
    rates += [dict(files=4, **serial_rate)]
    # The multi-process plane: two workers over the shm ring, short.

    def check_workers_batch(batch):
      for got, want in zip(batch, serial_first):
        got, want = got.to_flat_dict(), want.to_flat_dict()
        layout = {k: (tuple(v.shape), v.dtype) for k, v in want.items()}
        if {k: (tuple(v.shape), v.dtype) for k, v in got.items()} != layout:
          raise AssertionError(f"2 workers: a batch of {sorted(got)} "
                               f"unlike the serial stream's {layout}")
      lengths = np.array(batch[0]["sequence_length"])
      if not (np.all(lengths >= 1) and np.all(lengths <= 32)):
        raise AssertionError(f"2 workers: sequence lengths {lengths}")

    _, workers_rate = _stream_rate(TFRecordEpisodeInputGenerator(
        file_patterns=shards, sequence_length=32, batch_size=16,
        num_workers=2, seed=0), model, 2, batches=_WORKER_BATCHES,
        on_first=check_workers_batch)
    rates += [dict(files=4, **workers_rate)]
  _log(f"tfrecord round trip: 100 episodes written in {write_s:.3f} s "
       f"({size} bytes), 6 EVAL batches of 16 x 32 equal to the in-memory "
       f"generator's (image, gripper_pose, action, sequence_length; lengths "
       f"{int(lengths.min())}-{int(lengths.max())}); CRC-32C by "
       f"{'SSE4.2' if native.crc32c_uses_hardware() else 'slice-by-8'}; "
       f"codec {native.codec_library_path().name}")
  for rate in rates:
    _log(f"tfrecord parse rate (gin TRAIN stream, parse alone, host "
         f"{os.cpu_count()} cores): {json.dumps(rate)}")
  return rates


# The transformer gin's cut (chip_smoke's time limit): max_train_steps
# 2000 → 400.
_VRGRIPPER_STEPS = 400


def phase_gin_vrgripper_transformer():
  """The shipped `train_vrgripper_transformer.gin` as written, through
  the trainer binary in a new process, with the header's two bindings
  (`train_eval_model.model_dir`, the demos' file pattern) and the cut
  (`_VRGRIPPER_STEPS` of its 2000 steps) over 100 episodes
  `collect_demo_episodes` wrote: B=16 x 32 at width 128, depth 4, bf16,
  flash attention. Gates: exit 0, a valid envelope every 100 steps,
  finite losses whose last three fall below the first three,
  checkpoints every 500 steps and at the last. Then
  the same file in this process through the port's registry with 20
  steps bound on top, traced: each flash kernel 4 launches a step + the
  graph's warm-up step's, equal to CUPTI's. Returns the traced
  launches."""
  import tempfile
  import numpy as np
  from tensor2robot_tpu_torch import config as gin
  from tensor2robot_tpu_torch import train_eval
  from tensor2robot_tpu_torch.bin import run_t2r_trainer
  from tensor2robot_tpu_torch.research.vrgripper import collect_demo_episodes
  with tempfile.TemporaryDirectory() as tmp:
    demos = collect_demo_episodes(os.path.join(tmp, "demos.tfrecord"))
    model_dir = os.path.join(tmp, "run")
    os.makedirs(model_dir)
    wall = _run_trainer(
        f"gin train_vrgripper_transformer (as shipped, cut to "
        f"{_VRGRIPPER_STEPS} steps)", [
            "--gin_configs", _GIN_VRGRIPPER,
            "--gin_bindings", f"train_eval_model.model_dir='{model_dir}'",
            "--gin_bindings",
            f"train/TFRecordEpisodeInputGenerator.file_patterns='{demos}'",
            "--gin_bindings",
            f"train_eval_model.max_train_steps={_VRGRIPPER_STEPS}"],
        model_dir)
    raw = _checked_records(os.path.join(model_dir, "metrics_train.jsonl"))
    ckpts = sorted(int(d) for d in os.listdir(os.path.join(model_dir,
                                                           "ckpt")))
    steps = [r["step"] for r in raw]
    losses = [r["payload"]["loss"] for r in raw]
    rates = [r["payload"]["steps_per_sec"] for r in raw]
    _RATES["train_vrgripper_transformer.gin"] = statistics.median(
        rates[1:])
    _log(f"gin train_vrgripper_transformer: wall {wall:.2f} s; steps "
         f"{steps}; loss {losses}; mse "
         f"{[r['payload']['mse'] for r in raw]}; steps_per_sec {rates} "
         f"(median after the first interval {statistics.median(rates[1:])}); "
         f"checkpoints {ckpts}")
    if steps != list(range(100, _VRGRIPPER_STEPS + 1, 100)):
      raise AssertionError(f"gin vrgripper: record steps {steps}")
    if not all(np.isfinite(losses)) or not (np.mean(losses[-3:])
                                            < np.mean(losses[:3])):
      raise AssertionError(f"gin vrgripper: losses {losses}")
    if ckpts != sorted(set(range(500, _VRGRIPPER_STEPS + 1, 500))
                       | {_VRGRIPPER_STEPS}):
      raise AssertionError(f"gin vrgripper: checkpoints {ckpts}")

    run_t2r_trainer.import_configurable_families()
    steps = 20
    traced_dir = os.path.join(tmp, "traced")
    try:
      gin.parse_config_files_and_bindings([_GIN_VRGRIPPER], [
          f"train_eval_model.model_dir = '{traced_dir}'",
          f"train/TFRecordEpisodeInputGenerator.file_patterns = '{demos}'",
          f"train_eval_model.max_train_steps = {steps}"])
      t0 = time.perf_counter()
      with traced_launches("gin train_vrgripper_transformer") as traced:
        state = train_eval.train_eval_model()
      traced_wall = time.perf_counter() - t0
    finally:
      gin.clear_config()
  launches = {name: traced[name] for name in _FLASH_KERNELS}
  warm = {name: _warm(name) for name in _FLASH_KERNELS}
  _log(f"gin train_vrgripper_transformer in-process: {state.step} steps in "
       f"{traced_wall:.2f} s (traced); launches {json.dumps(launches)} "
       f"(warm-up {json.dumps(warm)}; CUPTI = counters)")
  if state.step != steps or any(n != 4 * steps + warm[k] or warm[k] != 4
                                for k, n in launches.items()):
    raise AssertionError(f"gin vrgripper: step {state.step}, launches "
                         f"{launches}: each should be 4 x {steps} + warm-up "
                         f"{warm}")
  return launches


_GIN_GRASP2VEC = ("tensor2robot_tpu/research/grasp2vec/configs/"
                  "train_grasp2vec.gin")
# The one cut of the shipped grasp2vec gin: max_train_steps 10000 → 400
# (chip_smoke's time limit).
_G2V_STEPS = 400
_G2V_BATCH = 64  # the gin's batch_size
_GOAL_QT_STEPS = 50


def phase_jpeg_digests():
  """The JPEG codec on the card's host (no TensorFlow there): the port's
  bytes for two seeded images and the pixels it decodes from them must
  have the SHA-256 digests that `tests/test_torch_jpeg.py` pins against
  `tf.io.encode_jpeg` / `tf.io.decode_image`; then decode alone, 192
  frames of 64×64×3 (one grasp2vec batch) in one `decode_many` call."""
  import hashlib
  import numpy as np
  from tensor2robot_tpu_torch.data import jpeg
  for shape, image in jpeg_digest_images().items():
    data = jpeg.encode(image)
    pixels = jpeg.decode(data)
    got = (hashlib.sha256(data).hexdigest(),
           hashlib.sha256(pixels.tobytes()).hexdigest())
    _log(f"jpeg digests {shape}: bytes {got[0]}, pixels {got[1]} "
         f"({len(data)} bytes)")
    if got != JPEG_DIGESTS[shape] or pixels.shape != shape:
      raise AssertionError(f"jpeg {shape}: digests {got}, want "
                           f"{JPEG_DIGESTS[shape]}")
  rng = np.random.default_rng(0)
  frames = [jpeg.encode(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
            for _ in range(192)]
  t0 = time.perf_counter()
  for _ in range(10):
    jpeg.decode_many(frames)
  ms = (time.perf_counter() - t0) / 10 * 1e3
  _log(f"jpeg decode_many: 192 frames of 64x64x3 (noise, "
       f"{sum(map(len, frames)) // 192} bytes each) in {ms:.3f} ms")


def phase_gin_grasp2vec():
  """The shipped `train_grasp2vec.gin` from JPEG TFRecords:
  `collect_grasp_triplets` writes 1024 seeded triplets (6 object types,
  2 distractors, 64×64, the port's JPEG) to train on and 640 more to
  evaluate, then the gin runs as written through the trainer binary in a
  new process (resnet-18 at 64 filters, embedding 128, bf16, batch 64,
  Adam 1e-4), its bindings only the model dir, the two file patterns
  and max_train_steps `_G2V_STEPS` (the gin's 10000 cut for the time
  limit). Gates: exit 0, a valid record every 100 steps whose loss
  falls (the last three below the first three), a checkpoint at the
  last step, eval records; `CheckpointPredictor` restores that step and
  `evaluate_retrieval` over 50 held-out queries gives retrieval top-1
  ≥ 0.5 (chance 1/6). Then the stream's parse rate alone, the graphed
  train step's device ms, and the f32 model on the card against the CPU
  (outputs at 1e-5 of their scale; one train step). Returns the model
  and the restored state (for the QT-Opt phase)."""
  import dataclasses
  import tempfile
  import numpy as np
  import torch
  from tensor2robot_tpu_torch.data import Mode, TFRecordInputGenerator
  from tensor2robot_tpu_torch.predictors import CheckpointPredictor
  from tensor2robot_tpu_torch.research import grasp2vec as g2v
  from tensor2robot_tpu_torch.utils import checkpoints as ckpt_lib
  with tempfile.TemporaryDirectory() as tmp:
    t0 = time.perf_counter()
    train = g2v.collect_grasp_triplets(
        os.path.join(tmp, "train.tfrecord"), num_episodes=1024,
        image_size=64, num_object_types=6, num_distractors=2, seed=0)
    evaluation = g2v.collect_grasp_triplets(
        os.path.join(tmp, "eval.tfrecord"), num_episodes=640, image_size=64,
        num_object_types=6, num_distractors=2, seed=2)
    collect_s = time.perf_counter() - t0
    model_dir = os.path.join(tmp, "run")
    os.makedirs(model_dir)
    wall = _run_trainer(f"gin train_grasp2vec (as shipped, {_G2V_STEPS} "
                        "steps)", [
        "--gin_configs", _GIN_GRASP2VEC,
        "--gin_bindings", f"train_eval_model.model_dir='{model_dir}'",
        "--gin_bindings",
        f"train/TFRecordInputGenerator.file_patterns='{train}'",
        "--gin_bindings",
        f"eval/TFRecordInputGenerator.file_patterns='{evaluation}'",
        "--gin_bindings", f"train_eval_model.max_train_steps={_G2V_STEPS}"],
        model_dir)
    raw = _checked_records(os.path.join(model_dir, "metrics_train.jsonl"))
    evals = _checked_records(os.path.join(model_dir, "metrics_eval.jsonl"))
    ckpts = ckpt_lib.list_steps(model_dir)
    steps = [r["step"] for r in raw]
    losses = [r["payload"]["loss"] for r in raw]
    rates = [r["payload"]["steps_per_sec"] for r in raw]
    _log(f"gin train_grasp2vec: collect {collect_s:.2f} s (1664 triplets); "
         f"trainer wall {wall:.2f} s; steps {steps}; loss {losses}; "
         f"retrieval_top1 {[r['payload']['retrieval_top1'] for r in raw]}; "
         f"steps_per_sec {rates} (median after the first interval "
         f"{statistics.median(rates[1:])}); checkpoints {ckpts}; eval "
         f"{json.dumps([r['payload'] for r in evals])}")
    if steps != list(range(100, _G2V_STEPS + 1, 100)):
      raise AssertionError(f"gin grasp2vec: record steps {steps}")
    if not all(np.isfinite(losses)) or not (np.mean(losses[-3:])
                                            < np.mean(losses[:3])):
      raise AssertionError(f"gin grasp2vec: losses {losses}")
    if ckpts != [_G2V_STEPS]:
      raise AssertionError(f"gin grasp2vec: checkpoints {ckpts}")
    if [r["step"] for r in evals] != [_G2V_STEPS] or not np.isfinite(
        evals[0]["payload"]["loss"]):
      raise AssertionError(f"gin grasp2vec: eval records {evals}")

    model = g2v.Grasp2VecModel()  # the gin's widths are its defaults
    predictor = CheckpointPredictor(model, checkpoint_dir=model_dir)
    if not predictor.restore(timeout_secs=0) or (
        predictor.model_version != _G2V_STEPS):
      raise AssertionError(f"predictor restored {predictor.model_version}")
    t0 = time.perf_counter()
    retrieval = g2v.evaluate_retrieval(
        predictor.predict, num_queries=50, image_size=64, num_object_types=6,
        num_distractors=2, seed=1)
    _log(f"grasp2vec retrieval through CheckpointPredictor (step "
         f"{predictor.model_version}, 50 held-out queries, "
         f"{time.perf_counter() - t0:.2f} s): {json.dumps(retrieval)}")
    if retrieval["retrieval_top1"] < 0.5:
      raise AssertionError(f"grasp2vec retrieval {retrieval}")
    like = model.create_inference_state()
    variables = ckpt_lib.restore_variables(
        model_dir, like={"params": like.params,
                         "batch_stats": like.batch_stats})
    state = dataclasses.replace(like, step=_G2V_STEPS, **variables)

    # The gin's TRAIN stream (batch 64, shuffle buffer 2048, repeat; 192
    # JPEG frames of 64×64 a batch) in this thread, as the gin runs it.
    batch, parse = _stream_rate(TFRecordInputGenerator(
        file_patterns=train, batch_size=_G2V_BATCH, shuffle_buffer_size=2048,
        seed=0), model, num_workers=0)
    _log(f"grasp2vec parse rate (gin TRAIN stream, parse alone, host "
         f"{os.cpu_count()} cores): {json.dumps(parse)}")
    step_ms = _g2v_step_ms(model, batch)
    _log(f"grasp2vec train step (B=64: 128 scene + 64 goal images of "
         f"64x64, bf16) device ms by graph replay: {step_ms}; parse "
         f"{parse['ms_per_batch']:.3f} ms a batch")

    model32 = g2v.Grasp2VecModel(device_dtype=torch.float32)
    gen = TFRecordInputGenerator(file_patterns=evaluation, batch_size=8,
                                 shuffle=False)
    gen.set_specification_from_model(model32, Mode.TRAIN)
    _g2v_outputs_card_vs_cpu(model32, gen)
    train_step_card_vs_cpu("grasp2vec", model32, gen, 1e-4,
                           shape="B=8 of 64x64")
  return model, state


def _g2v_step_ms(model, batch):
  """Device ms of one bf16 train step at the gin's batch (graph replay
  of 10 steps from one state, no host launch cost)."""
  import torch
  features, labels = batch
  f = {k: torch.as_tensor(v).cuda() for k, v in features.to_flat_dict().items()}
  lab = {k: torch.as_tensor(v).cuda() for k, v in labels.to_flat_dict().items()}
  state = model.create_train_state(seed=0)
  return _graph_ms(lambda: model.train_step(state, f, lab), iters=10)


def _g2v_outputs_card_vs_cpu(model32, gen):
  """The f32 model's five outputs on the card and on the CPU from the
  same seeded weights and one batch: each within 1e-5 of its largest
  |value| (the CPU tests' f32 tolerance), cuDNN without TF32."""
  import torch
  from tensor2robot_tpu_torch.data import Mode
  torch.backends.cudnn.allow_tf32 = False
  features, _ = next(iter(gen.create_dataset(Mode.TRAIN)))
  out = {}
  for device in ("cuda", "cpu"):
    state = model32.create_inference_state(seed=0, device=device)
    f = {k: torch.as_tensor(v).to(device)
         for k, v in features.to_flat_dict().items()}
    out[device] = {k: v.float().cpu()
                   for k, v in model32.predict_step(state, f).items()}
  torch.backends.cudnn.allow_tf32 = True
  errs = {k: (out["cuda"][k] - v).abs().max().item()
          / max(v.abs().max().item(), 1e-12) for k, v in out["cpu"].items()}
  _log(f"card vs CPU f32 grasp2vec outputs (B=8): max error over each "
       f"output's scale {json.dumps(errs)} (tol 1e-5)")
  if max(errs.values()) > 1e-5:
    raise AssertionError(f"grasp2vec outputs differ card vs CPU: {errs}")


def phase_goal_qtopt(g2v_model, g2v_state):
  """Goal-conditioned QT-Opt from grasp2vec labels: the trained
  embedding model (`make_grasp2vec_reward_fn`, on the card) labels 256
  fresh triplets, `relabel_transitions` turns them into transitions that
  fill a `ReplayBuffer`, and `train_qtopt` takes 50 graphed Bellman
  steps at B=256 over `GraspingQModel(image_size=64,
  extra_state_features={"goal_embedding": (128,)})`, otherwise at the
  bench's width (CEM 2 × 64, 6 elites, fused select: the cem_select
  kernel). Gates: finite losses whose last ten fall below the first ten;
  cem_select's launches traced by CUPTI equal the wrapper's count, 2 a
  step + 2 in the graph's warm-up step. Returns the launches."""
  import tempfile
  import numpy as np
  from tensor2robot_tpu_torch.research import grasp2vec as g2v
  from tensor2robot_tpu_torch.research.qtopt import ReplayBuffer
  from tensor2robot_tpu_torch.research.qtopt import synthetic_bandit as bandit
  from tensor2robot_tpu_torch.research.qtopt.train_qtopt import train_qtopt
  Losses, _ = _hooks()

  scenes = g2v.GraspSceneGenerator(image_size=64, num_object_types=6,
                                   num_distractors=2, seed=3)
  triplets = [scenes.sample() for _ in range(256)]
  images = {k: np.stack([t[k] for t in triplets])
            for k in ("pregrasp_image", "postgrasp_image", "goal_image")}
  actions = np.random.default_rng(4).uniform(-1, 1, (256, 4)).astype(
      np.float32)
  t0 = time.perf_counter()
  reward_fn = g2v.make_grasp2vec_reward_fn(g2v_model, g2v_state)
  transitions = g2v.relabel_transitions(
      reward_fn, images["pregrasp_image"], images["postgrasp_image"],
      images["goal_image"], actions)
  label_s = time.perf_counter() - t0
  learner = bandit.bellman_learner(extra_state_features={
      g2v.GOAL_EMBEDDING_FEATURE: (g2v_model.embedding_size,)})
  spec = learner.transition_specification().to_flat_dict()
  if set(transitions) != set(spec):
    raise AssertionError(f"relabel keys {sorted(transitions)} != the "
                         f"learner's transition spec {sorted(spec)}")
  replay = ReplayBuffer(learner.transition_specification(), capacity=256,
                        seed=0)
  replay.add(transitions)
  log = Losses()
  with tempfile.TemporaryDirectory() as model_dir:
    t0 = time.perf_counter()
    with traced_launches("goal-conditioned Bellman training") as traced:
      state = train_qtopt(learner, model_dir, replay_buffer=replay,
                          max_train_steps=_GOAL_QT_STEPS, batch_size=256,
                          save_checkpoints_steps=_GOAL_QT_STEPS,
                          log_every_steps=10, hooks=[log])
    wall_s = time.perf_counter() - t0
  launches, warm = traced["cem_select"], _warm("cem_select")
  losses = [log.by_step[s].item() for s in sorted(log.by_step)]
  first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
  _log(f"goal-conditioned QT-Opt (grasp2vec labels, B=256, "
       f"{_GOAL_QT_STEPS} graphed steps): labelled 256 triplets in "
       f"{label_s:.2f} s, reward mean {float(transitions['reward'].mean())}; "
       f"wall {wall_s:.2f} s (traced); loss first10 {first} last10 {last}; "
       f"cem_select launches {launches} (warm-up {warm}; CUPTI = counter)")
  if (state.step != _GOAL_QT_STEPS or warm != 2
      or launches != 2 * _GOAL_QT_STEPS + warm):
    raise AssertionError(f"goal QT-Opt: step {state.step}, cem_select "
                         f"launches {launches} (warm-up {warm})")
  if not all(np.isfinite(losses)) or not last < first:
    raise AssertionError(f"goal QT-Opt: losses {losses}")
  return launches


# The VRGripper BC / meta / WTL family (phases 41-43): the three shipped
# gins as written, with these cuts for the time limit, each bound on top
# of the file: max_train_steps 2000 -> 1000 in all three (checkpoints at
# 500 and 1000), and the BC gin's SuccessEvalHook at 100 episodes a
# checkpoint instead of 500 (same seed, image size and task offsets).
_GIN_BC = "tensor2robot_tpu/research/vrgripper/configs/train_vrgripper_bc.gin"
_GIN_META = ("tensor2robot_tpu/research/vrgripper/configs/"
             "train_vrgripper_meta.gin")
_GIN_WTL = ("tensor2robot_tpu/research/vrgripper/configs/"
            "train_vrgripper_wtl.gin")
# The family gins' cut (chip_smoke's time limit): max_train_steps → 400.
_FAMILY_STEPS = 400
_BC_EVAL_EPISODES = 100
_MAML_STEPS = 20


def _family_checkpoints():
  """The gins' save_checkpoints_steps (500) and the last step."""
  return sorted(set(range(500, _FAMILY_STEPS + 1, 500)) | {_FAMILY_STEPS})


def _gin_family_run(label, gin_file, bindings, model_dir,
                    initial_loss=None):
  """The shipped `gin_file` through the trainer binary in a new process
  with `bindings` on top (the header's, and the cuts). Gates: exit 0, a
  valid record every 100 steps to `_FAMILY_STEPS`, finite losses whose
  last three fall below the first three (below `initial_loss`, the
  untrained model's, where that is given), checkpoints every 500 steps
  and at the last. Returns (records, trainer wall s)."""
  import numpy as np
  from tensor2robot_tpu_torch.utils import checkpoints as ckpt_lib
  args = ["--gin_configs", gin_file,
          "--gin_bindings", f"train_eval_model.model_dir='{model_dir}'",
          "--gin_bindings",
          f"train_eval_model.max_train_steps={_FAMILY_STEPS}"]
  for binding in bindings:
    args += ["--gin_bindings", binding]
  wall = _run_trainer(f"gin {label} ({_FAMILY_STEPS} steps)", args,
                      model_dir)
  raw = _checked_records(os.path.join(model_dir, "metrics_train.jsonl"))
  steps = [r["step"] for r in raw]
  losses = [r["payload"]["loss"] for r in raw]
  rates = [r["payload"]["steps_per_sec"] for r in raw]
  ckpts = ckpt_lib.list_steps(model_dir)
  _log(f"gin {label}: trainer wall {wall:.2f} s; steps {steps}; loss "
       f"{losses}; grad steps/s {rates} (median after the first interval "
       f"{statistics.median(rates[1:])}); checkpoints {ckpts}")
  if steps != list(range(100, _FAMILY_STEPS + 1, 100)):
    raise AssertionError(f"gin {label}: record steps {steps}")
  first = np.mean(losses[:3]) if initial_loss is None else initial_loss
  if not all(np.isfinite(losses)) or not np.mean(losses[-3:]) < first:
    raise AssertionError(f"gin {label}: losses {losses} (from {first})")
  if ckpts != _family_checkpoints():
    raise AssertionError(f"gin {label}: checkpoints {ckpts}")
  return raw, wall


def _on(device, flat):
  import torch
  return {k: torch.as_tensor(v).to(device) for k, v in flat.items()}


def _family_step_ms(label, model, features, labels, shape, eager_iters=10):
  """The bf16 train step's device ms at the gin's batch: graphed (10
  steps in one graph, replayed) and eager (CUDA events around
  `eager_iters` eager calls, the host's launch gaps included)."""
  f, lab = _on("cuda", features), _on("cuda", labels)
  state = model.create_train_state(seed=0)
  graphed = _graph_ms(lambda: model.train_step(state, f, lab), iters=10)
  eager = _median_ms(lambda: model.train_step(state, f, lab),
                     iters=eager_iters, repeats=3)
  _log(f"{label} train step ({shape}, bf16) device ms: graphed {graphed}, "
       f"eager {eager}")
  return graphed, eager


def _family_card_vs_cpu(label, model32, features, labels):
  """The f32 model's outputs on the card and on the CPU from the same
  seeded weights and batch, each within 1e-5 of its largest |value|
  (cuDNN and matmuls without TF32), and the loss of one train step
  within 1e-4 relative."""
  import torch
  torch.backends.cudnn.allow_tf32 = False
  out, loss = {}, {}
  try:
    for device in ("cuda", "cpu"):
      state = model32.create_train_state(seed=0, device=device)
      f, lab = _on(device, features), _on(device, labels)
      predicted = model32.predict_step(state, f)
      out[device] = {k: v.float().cpu() for k, v in predicted.items()}
      loss[device] = model32.train_grads(state, f, lab)[2]["loss"].item()
  finally:
    torch.backends.cudnn.allow_tf32 = True
  errs = {k: (out["cuda"][k] - v).abs().max().item()
          / max(v.abs().max().item(), 1e-12) for k, v in out["cpu"].items()}
  loss_err = abs(loss["cuda"] - loss["cpu"]) / max(abs(loss["cpu"]), 1e-12)
  _log(f"card vs CPU f32 {label}: max error over each output's scale "
       f"{json.dumps(errs)} (tol 1e-5); train loss {loss['cuda']} vs "
       f"{loss['cpu']} (rel {loss_err}, tol 1e-4)")
  if max(errs.values()) > 1e-5 or loss_err > 1e-4:
    raise AssertionError(f"{label} differs card vs CPU: {errs}, {loss_err}")


def _first_batch(gen, model):
  from tensor2robot_tpu_torch.data import Mode
  gen.set_specification_from_model(model, Mode.TRAIN)
  stream = gen.create_dataset(Mode.TRAIN)
  try:
    features, labels = next(stream)
  finally:
    getattr(stream, "close", lambda: None)()
  return features.to_flat_dict(), labels.to_flat_dict()


def phase_gin_vrgripper_bc():
  """The shipped `train_vrgripper_bc.gin` from PNG TFRecords:
  `collect_demo_episodes` writes 100 seeded demos; the trainer binary
  runs the gin in a new process (`VRGripperRegressionModel`, 48×48,
  filters (32, 64), an MDN head of 5 components over 3 action dims,
  bf16; `TransitionInputGenerator` at batch 64 over
  `TFRecordEpisodeInputGenerator(sequence_length=12)`), bound: the
  model dir, the demos, and the cuts (`_FAMILY_STEPS`; `SuccessEvalHook` at
  100 episodes). Gates: those of `_gin_family_run`, and a success
  record at each checkpoint whose `success_rate` is in [0, 1] (printed,
  not gated: the hook evaluates under task offsets the demos lack).
  Then the train step's device ms at batch 64 and the f32 model card
  against CPU at B=8."""
  import tempfile
  import torch
  from tensor2robot_tpu_torch.data import TFRecordEpisodeInputGenerator
  from tensor2robot_tpu_torch.research import vrgripper as vr
  with tempfile.TemporaryDirectory() as tmp:
    demos = vr.collect_demo_episodes(os.path.join(tmp, "demos.tfrecord"))
    model_dir = os.path.join(tmp, "run")
    os.makedirs(model_dir)
    _gin_family_run("train_vrgripper_bc", _GIN_BC, [
        f"train/TFRecordEpisodeInputGenerator.file_patterns='{demos}'",
        'SuccessEvalHook.eval_kwargs={"num_episodes": '
        f'{_BC_EVAL_EPISODES}, "image_size": 48, "seed": 1009, '
        '"task_offset_scale": 0.2}'], model_dir)
    success = _checked_records(os.path.join(model_dir,
                                            "metrics_success_eval.jsonl"))
    rates = {r["step"]: r["payload"]["success_rate"] for r in success}
    _log(f"gin train_vrgripper_bc SuccessEvalHook (evaluate_gripper_policy "
         f"on the card, {_BC_EVAL_EPISODES} episodes, seed 1009, task "
         f"offsets 0.2): success_rate by step {json.dumps(rates)}; "
         f"{json.dumps([r['payload'] for r in success])}")
    if sorted(rates) != _family_checkpoints() or not all(
        0.0 <= v <= 1.0 for v in rates.values()) or any(
            r["payload"]["num_episodes"] != _BC_EVAL_EPISODES
            for r in success):
      raise AssertionError(f"gin bc: success records {success}")

    def transitions(batch_size):
      return vr.TransitionInputGenerator(
          TFRecordEpisodeInputGenerator(file_patterns=demos,
                                        sequence_length=12),
          batch_size=batch_size, seed=0)

    model = vr.VRGripperRegressionModel(num_mixture_components=5)
    _family_step_ms("train_vrgripper_bc", model,
                    *_first_batch(transitions(64), model), "B=64")
    model32 = vr.VRGripperRegressionModel(num_mixture_components=5,
                                          device_dtype=torch.float32)
    _family_card_vs_cpu("train_vrgripper_bc (B=8)", model32,
                        *_first_batch(transitions(8), model32))


def phase_gin_vrgripper_meta():
  """The shipped `train_vrgripper_meta.gin` from PNG TFRecords
  (`VRGripperSNAILModel`: 48×48, filters (16, 32), embedding 64, SNAIL
  at 32 filters over 4 demo + 4 query steps, bf16;
  `EpisodeMetaInputGenerator` at 8 tasks over
  `TFRecordEpisodeInputGenerator(sequence_length=12)`), bound: the model
  dir, the demos, the cut to `_FAMILY_STEPS`; gates of `_gin_family_run`,
  except that the loss is held below the untrained model's on a batch of
  the gin's stream rather than below the first three records: one record
  is one batch of 32 queries, and from step 100 on they scatter over
  0.003–0.19 in a 1000-step run on an H100, around a mean that no
  longer falls much.
  Then the same file with `train_eval_model.model = @VRGripperMAMLModel()`
  bound on top, in this process through the port's registry: 20 graphed
  steps of second-order MAML (one inner step, lr 0.05), a record every 5
  steps with finite pre-outer-step `loss` and `post_adaptation_loss`, a
  checkpoint at 20. Then each model's train step device ms at 8 tasks and
  its f32 outputs card against CPU (MAML adapting on the demos)."""
  import tempfile
  import numpy as np
  import torch
  from tensor2robot_tpu_torch import config as gin
  from tensor2robot_tpu_torch import train_eval
  from tensor2robot_tpu_torch.bin import run_t2r_trainer
  from tensor2robot_tpu_torch.data import TFRecordEpisodeInputGenerator
  from tensor2robot_tpu_torch.meta_learning import (
      EpisodeMetaInputGenerator,
      MAMLModel,
  )
  from tensor2robot_tpu_torch.research import vrgripper as vr
  from tensor2robot_tpu_torch.utils import checkpoints as ckpt_lib
  with tempfile.TemporaryDirectory() as tmp:
    demos = vr.collect_demo_episodes(os.path.join(tmp, "demos.tfrecord"))
    pattern = f"train/TFRecordEpisodeInputGenerator.file_patterns='{demos}'"

    def meta_batches(model):
      gen = EpisodeMetaInputGenerator(
          TFRecordEpisodeInputGenerator(file_patterns=demos,
                                        sequence_length=12), batch_size=8)
      return _first_batch(gen, model)

    snail = vr.VRGripperSNAILModel()
    batch = meta_batches(snail)
    initial = snail.eval_step(snail.create_train_state(seed=0),
                              *(_on("cuda", b) for b in batch))
    initial = initial["loss"].item()
    _log(f"train_vrgripper_meta untrained SNAIL loss on a batch of the "
         f"gin's stream: {initial}")
    model_dir = os.path.join(tmp, "run")
    os.makedirs(model_dir)
    _gin_family_run("train_vrgripper_meta", _GIN_META, [pattern], model_dir,
                    initial_loss=initial)

    run_t2r_trainer.import_configurable_families()
    maml_dir = os.path.join(tmp, "maml")
    try:
      gin.parse_config_files_and_bindings([_GIN_META], [
          f"train_eval_model.model_dir = '{maml_dir}'",
          pattern.replace("=", " = ", 1),
          "train_eval_model.model = @VRGripperMAMLModel()",
          f"train_eval_model.max_train_steps = {_MAML_STEPS}",
          "train_eval_model.log_every_steps = 5"])
      t0 = time.perf_counter()
      state = train_eval.train_eval_model()
      maml_wall = time.perf_counter() - t0
    finally:
      gin.clear_config()
    raw = _checked_records(os.path.join(maml_dir, "metrics_train.jsonl"))
    losses = [r["payload"]["loss"] for r in raw]
    post = [r["payload"]["post_adaptation_loss"] for r in raw]
    ckpts = ckpt_lib.list_steps(maml_dir)
    _log(f"gin train_vrgripper_meta + @VRGripperMAMLModel() (second order, "
         f"in-process, graphed): {state.step} steps in {maml_wall:.2f} s "
         f"(capture included); steps {[r['step'] for r in raw]}; loss "
         f"{losses}; post_adaptation_loss {post}; grad steps/s "
         f"{[r['payload']['steps_per_sec'] for r in raw]}; checkpoints "
         f"{ckpts}")
    if (state.step != _MAML_STEPS or [r["step"] for r in raw]
        != list(range(5, _MAML_STEPS + 1, 5)) or ckpts != [_MAML_STEPS]
        or not all(np.isfinite(losses + post))):
      raise AssertionError(f"gin meta MAML: step {state.step}, {raw}")

    _family_step_ms("train_vrgripper_meta (SNAIL)", snail, *batch,
                    "8 tasks of 4 + 4 steps")
    _family_step_ms("train_vrgripper_meta + MAML (second order)",
                    vr.VRGripperMAMLModel(), *batch,
                    "8 tasks of 4 + 4 steps", eager_iters=3)
    snail32 = vr.VRGripperSNAILModel()
    snail32._base._device_dtype = torch.float32  # the trunk's dtype
    _family_card_vs_cpu("train_vrgripper_meta SNAIL (8 tasks)", snail32,
                        *batch)
    maml32 = MAMLModel(vr.VRGripperRegressionModel(
        filters=(16, 32), device_dtype=torch.float32), inner_lr=0.05)
    features, labels = batch
    features = dict(features, **{"condition_labels/action":
                                 labels["condition/action"]})
    _family_card_vs_cpu("MAML over the gin's base (8 tasks, adapted on "
                        "the demos)", maml32, features, labels)


def phase_gin_vrgripper_wtl():
  """The shipped `train_vrgripper_wtl.gin` (`VRGripperWTLModel`, retrial
  policy: demo + trial conditioned, 48×48, filters (16, 32), embedding
  64, MDN of 5 components, bf16; `RandomInputGenerator` at 8 tasks from
  the model's specs), bound: the model dir and the cut to `_FAMILY_STEPS`;
  gates of `_gin_family_run`, except that the loss is held below the
  untrained model's on the gin's first batch (same seeds) rather than
  below the first three records: its random targets carry nothing to
  learn past their marginal, which the model fits before step 100 (the
  records then scatter over 3.98–4.56 on an H100). Then
  the train step's device ms at 8 tasks, and the f32 model card against
  CPU on a `sample_wtl_meta_batch` of scripted demos, trials and
  queries, both policy types."""
  import tempfile
  import torch
  from tensor2robot_tpu_torch.data import Mode, RandomInputGenerator
  from tensor2robot_tpu_torch.research import vrgripper as vr
  model = vr.VRGripperWTLModel(num_mixture_components=5)
  batch = _first_batch(RandomInputGenerator(batch_size=8), model)
  state = model.create_train_state(seed=0)
  initial = model.eval_step(state, *(_on("cuda", b) for b in batch))
  initial = initial["loss"].item()
  _log(f"train_vrgripper_wtl untrained loss on the gin's first batch: "
       f"{initial}")
  with tempfile.TemporaryDirectory() as tmp:
    _gin_family_run("train_vrgripper_wtl", _GIN_WTL, [], tmp,
                    initial_loss=initial)
  _family_step_ms("train_vrgripper_wtl", model, *batch,
                  "8 tasks of 4 + 4 + 4 steps")
  features, labels = vr.sample_wtl_meta_batch(num_tasks=8, seed=0)
  for policy in ("retrial", "trial"):
    model32 = vr.VRGripperWTLModel(policy_type=policy,
                                   num_mixture_components=5,
                                   device_dtype=torch.float32)
    keys = model32.get_feature_specification(Mode.TRAIN).to_flat_dict()
    _family_card_vs_cpu(f"train_vrgripper_wtl {policy} (8 tasks)", model32,
                        {k: v for k, v in features.items() if k in keys},
                        labels)

_ENVS_N = 1024
_GIN_ANAKIN = "tensor2robot_tpu/research/qtopt/configs/qtopt_anakin.gin"
_GIN_ANAKIN_POD = "tensor2robot_tpu/research/qtopt/configs/qtopt_anakin_pod.gin"
_ANAKIN_STEPS = 1000
# The binary's lax run of the same gin, cut (chip_smoke's time limit):
# 1000 → 500 steps.
_ANAKIN_LAX_STEPS = 500
# The in-process fused run's cut (chip_smoke's time limit): 1000 →
# 500 steps; the window stays inside it.
_ANAKIN_FUSED_STEPS = 500
# The fused run's traced window: the replays of steps 401-412 (three
# iterations of K = 4), well after the capture.
_ANAKIN_WINDOW = (400, 412)
_HTOD_LIMIT = 1024  # bytes: no transition may cross from the host


def phase_envs_card_vs_cpu():
  """44. The envs on the card against the CPU on the same states: 1024
  envs at 64×64 of the pose bandit and of the procgen scenarios (each
  with its sensor noise and at noise 0, two-step episodes) reset on the
  CPU and copied over; their frames, and after one step (half the
  actions exact grasps, the procgen drift direction given) the next
  poses, frames, rewards and dones must be equal bit for bit. The noisy
  table from the same normals on both devices (the f64 multiply-add).
  Then a reset on the card, and the env steps/s of render + auto-reset
  step alone at 1024 envs, graphed and eager (CUDA events). Returns the
  rates."""
  import torch
  from tensor2robot_tpu_torch import envs
  from tensor2robot_tpu_torch.envs.pose import sensor_table
  from tensor2robot_tpu_torch.utils import tree
  to_card = lambda state: tree.map_structure(  # noqa: E731
      lambda t: t.to("cuda"), state)
  cases = (
      ("pose", envs.PoseBanditEnv(max_episode_steps=2)),
      ("pose noise 0", envs.PoseBanditEnv(noise=0.0, max_episode_steps=2)),
      ("procgen", envs.ProcGenGraspEnv(max_episode_steps=2)),
      ("procgen noise 0", envs.ProcGenGraspEnv(noise_range=(0.0, 0.0),
                                               max_episode_steps=2)))
  for name, env in cases:
    g = torch.Generator().manual_seed(44)
    cpu = env.reset(g, _ENVS_N)
    actions = torch.rand((_ENVS_N, 2), generator=g) * 2 - 1
    actions[::2] = cpu.pose[::2] / 0.4
    angle = torch.rand((_ENVS_N,), generator=g) * 6.283185307179586
    extra = ({} if name.startswith("pose") else
             {"direction": torch.stack([torch.cos(angle), torch.sin(angle)],
                                       dim=-1)})
    card = to_card(cpu)
    want = (env.observe(cpu)["image"],) + env.step(cpu, actions, **extra)
    got = (env.observe(card)["image"],) + env.step(
        card, actions.cuda(), **{k: v.cuda() for k, v in extra.items()})
    torch.cuda.synchronize()
    checks = {
        "frames": torch.equal(want[0], got[0].cpu()),
        "next_pose": torch.equal(want[1].pose, got[1].pose.cpu()),
        "next_frames": torch.equal(want[2]["image"], got[2]["image"].cpu()),
        "reward": torch.equal(want[3], got[3].cpu()),
        "done": torch.equal(want[4], got[4].cpu()),
    }
    _log(f"envs card vs CPU, {name} ({_ENVS_N} envs, 64x64): "
         f"{json.dumps(checks)}; reward mean {want[3].mean().item()}, done "
         f"{want[4].float().mean().item()}")
    if not all(checks.values()):
      raise AssertionError(f"envs card vs CPU, {name}: {checks}")
  g = torch.Generator().manual_seed(45)
  normal = torch.randn((256, 64, 64, 3), generator=g)
  sigma = torch.rand((256,), generator=g) * 0.05
  if not torch.equal(sensor_table(normal, sigma),
                     sensor_table(normal.cuda(), sigma.cuda()).cpu()):
    raise AssertionError("sensor table: card and CPU differ")
  rates = {}
  for name, env in (("procgen", envs.ProcGenGraspEnv()),
                    ("pose", envs.PoseBanditEnv())):
    wrapped = envs.AutoResetEnv(env)
    gen = torch.cuda.default_generators[0]
    state = wrapped.reset(gen, _ENVS_N)
    frames = env.observe(state)["image"]
    if (frames.shape != (_ENVS_N, 64, 64, 3) or frames.dtype != torch.uint8
        or not bool((frames == 40).any())):
      raise AssertionError(f"{name}: card reset frames {frames.shape}")
    actions = torch.zeros((_ENVS_N, 2), device="cuda")

    def one_step(env=env, wrapped=wrapped, state=state, actions=actions):
      env.observe(state)
      wrapped.step(state, actions, gen)

    graphed = _graph_ms(one_step)
    eager = _median_ms(one_step, iters=20)
    rates[name] = {"graphed_ms": graphed, "eager_ms": eager,
                   "env_steps_per_sec": _ENVS_N / (graphed / 1e3),
                   "eager_env_steps_per_sec": _ENVS_N / (eager / 1e3)}
  _log(f"envs render + auto-reset step alone, {_ENVS_N} envs at 64x64: "
       f"{json.dumps(rates)}")
  return rates


def phase_anakin_select_kernels():
  """45. cem_select against its plain version at the Anakin path's
  shapes: `qtopt_anakin.gin`'s acting CEM (B = 1024 envs, P = 64, C = 64,
  dense 64-64-1, A = 2, 6 elites, bf16: wgmma), the envs protocol's (B =
  256, C = 32, dense 32-32-1), and the seedcheck's (C = 8, dense 16, P =
  8, 2 elites at B = 64 and 8: CUDA cores), each rerun for identical
  bits; the B = 1024 case timed against the plain version (graph
  replays) beside its bound. Returns (max error, the timing row)."""
  import torch
  from tensor2robot_tpu_torch.ops import cem_select as ops
  bf16 = torch.bfloat16
  cases = [
      ("qtopt_anakin acting B=1024", _select_inputs(1024, 64, 64, (64, 64),
                                                    2, bf16, seed=45), 6),
      ("envs protocol B=256 C=32", _select_inputs(256, 64, 32, (32, 32), 2,
                                                  bf16, seed=46), 6),
      ("seedcheck B=64 C=8", _select_inputs(64, 8, 8, (16,), 2, bf16,
                                            seed=47), 2),
      ("seedcheck B=8 C=8", _select_inputs(8, 8, 8, (16,), 2, bf16,
                                           seed=48), 2),
  ]
  errs = {}
  for name, args, elites in cases:
    errs[name] = check_select(name, *args, num_elites=elites, sigmoid=True,
                              score_tol=1e-2)
    _same_bits(f"cem_select {name}", lambda: ops.fused_cem_select(
        *args, elites, sigmoid=True))
    _log(f"cem_select {name}: path {_select_path(*args, elites)}, "
         f"identical bits on a rerun")
  pooled, samples, dense = cases[0][1]
  bound_ms, bound_by = _bound(pooled, samples, dense)
  row = {
      "ms": _graph_ms(lambda: ops.fused_cem_select(pooled, samples, dense, 6,
                                                   sigmoid=True)),
      "plain_ms": _graph_ms(lambda: ops.cem_select_reference(
          pooled, samples, dense, 6, sigmoid=True)),
      "bound_ms": bound_ms, "bound_by": bound_by}
  _log(f"cem_select at B=1024, P=64, C=64, A=2 (bf16): {json.dumps(row)}")
  return max(errs.values()), row


def _anakin_records(label, model_dir, pod, steps_to=_ANAKIN_STEPS):
  """The run's train records, each a valid envelope: a record every 100
  steps to `steps_to`, `param_refresh_lag_steps` 0.0, finite loss,
  collect_reward_mean, env_steps_per_sec and grad_steps_per_sec (and the
  pod records' devices 1, global_batch_size, bellman_batches_per_sec
  where `pod`); checkpoints every 500 steps to `steps_to`. Logs the
  rates."""
  import math
  from tensor2robot_tpu_torch.utils import checkpoints as ckpt_lib
  raw = _checked_records(os.path.join(model_dir, "metrics_train.jsonl"))
  steps = [r["step"] for r in raw]
  payloads = [r["payload"] for r in raw]
  ckpts = ckpt_lib.list_steps(model_dir)
  grad = [p["grad_steps_per_sec"] for p in payloads]
  env = [p["env_steps_per_sec"] for p in payloads]
  _log(f"{label}: steps {steps}; loss {[p['loss'] for p in payloads]}; "
       f"collect_reward_mean {[p['collect_reward_mean'] for p in payloads]}; "
       f"grad_steps_per_sec {grad} (median after the first "
       f"{statistics.median(grad[1:])}); env_steps_per_sec {env} (median "
       f"after the first {statistics.median(env[1:])}); replay_fill "
       f"{payloads[-1]['replay_fill']}; checkpoints {ckpts}")
  if steps != list(range(100, steps_to + 1, 100)):
    raise AssertionError(f"{label}: record steps {steps}")
  for p in payloads:
    finite = all(math.isfinite(p[k]) for k in (
        "loss", "collect_reward_mean", "env_steps_per_sec",
        "grad_steps_per_sec"))
    if p["param_refresh_lag_steps"] != 0.0 or not finite:
      raise AssertionError(f"{label}: record {p}")
    if pod and (p["devices"] != 1 or p["global_batch_size"] != 64
                or p["bellman_batches_per_sec"] != p["grad_steps_per_sec"]):
      raise AssertionError(f"{label}: pod record {p}")
  if ckpts != list(range(500, steps_to + 1, 500)):
    raise AssertionError(f"{label}: checkpoints {ckpts}")
  return raw


class _TracedWindow:
  """A trainer hook that runs `traced_launches` over the replays between
  two steps (`_ANAKIN_WINDOW`), writing the trace to `trace_path`."""

  def __init__(self, label, trace_path):
    self._label = label
    self._trace_path = trace_path
    self._cm = None
    self.traced = None
    self.seconds = None

  def begin(self, model, model_dir):
    pass

  def after_step(self, step, metrics):
    if step == _ANAKIN_WINDOW[0]:
      self._cm = traced_launches(self._label, self._trace_path)
      self.traced = self._cm.__enter__()
      self._t0 = time.perf_counter()
    elif step == _ANAKIN_WINDOW[1]:
      self._cm.__exit__(None, None, None)
      self.seconds = time.perf_counter() - self._t0

  def after_checkpoint(self, step, state, model_dir):
    pass

  def end(self, step, state, model_dir):
    pass


def _trace_window(trace_path):
  """What a chrome trace of graph replays shows: the bytes of each
  host-to-device copy (fails where a copy's size is not recorded), the
  copies by name, and the device timeline of the kernels (the marker
  spins excluded): span from the first start to the last end, busy time,
  count, and the five largest by total time."""
  with open(trace_path) as f:
    events = json.load(f)["traceEvents"]
  htod, copies = [], {}
  kernels = []
  for e in events:
    if e.get("cat") == "gpu_memcpy":
      copies[e["name"]] = copies.get(e["name"], 0) + 1
      if "HtoD" in e["name"]:
        if "bytes" not in e.get("args", {}):
          raise AssertionError(f"a copy without its size: {e}")
        htod.append(int(e["args"]["bytes"]))
    elif e.get("cat") == "kernel" and "spin_kernel" not in e.get("name", ""):
      kernels.append(e)
  by_name = {}
  for e in kernels:
    by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
  top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
  start = min(e["ts"] for e in kernels)
  end = max(e["ts"] + e["dur"] for e in kernels)
  return htod, copies, {
      "span_ms": (end - start) / 1e3,
      "busy_ms": sum(by_name.values()),
      "kernels": len(kernels),
      "top_ms": [(name[:60], round(ms, 3)) for name, ms in top]}


def phase_gin_qtopt_anakin():
  """46. The shipped `qtopt_anakin.gin` as written through
  `python -m tensor2robot_tpu_torch.bin.run_t2r_trainer --trainer=anakin`
  (`train_anakin.model_dir` and the cut to `_ANAKIN_LAX_STEPS` bound):
  procgen collection (1024 envs, rollout 4, ε 0.1) into a 16384-row ring on the
  card, 4 Bellman steps of B = 256 an iteration, `GraspingQModel` at 64×64
  with action 2, CEM 2 × 64, lax select. Then the same file in this
  process through the port's registry with `QTOptLearner.cem_select =
  "fused"` bound on top, 500 steps (the cut), its replays of steps
  401-412 traced:
  cem_select's launches must equal CUPTI's and the wrapper's counter and
  (rollout 4 × CEM 2 + K 4 × 2) per iteration, and no host-to-device copy
  in the window may exceed 1 KiB (no transition crosses from the host).
  Gates on both runs' records (`_anakin_records`). Returns the window's
  cem_select launches."""
  import tempfile
  from tensor2robot_tpu_torch import config as gin
  from tensor2robot_tpu_torch.bin import run_t2r_trainer
  from tensor2robot_tpu_torch.envs import train_anakin
  with tempfile.TemporaryDirectory() as model_dir:
    wall = _run_trainer("gin qtopt_anakin (as shipped, lax select, cut to "
                        f"{_ANAKIN_LAX_STEPS} steps)", [
        "--trainer=anakin", "--gin_configs", _GIN_ANAKIN,
        "--gin_bindings", f"train_anakin.model_dir='{model_dir}'",
        "--gin_bindings",
        f"train_anakin.max_train_steps={_ANAKIN_LAX_STEPS}"], model_dir)
    _anakin_records(f"gin qtopt_anakin lax (wall {wall:.2f} s)", model_dir,
                    pod=False, steps_to=_ANAKIN_LAX_STEPS)
  run_t2r_trainer.import_configurable_families()
  try:
    with tempfile.TemporaryDirectory() as model_dir:
      gin.parse_config_files_and_bindings([_GIN_ANAKIN], [
          "QTOptLearner.cem_select = 'fused'",
          f"train_anakin.model_dir = '{model_dir}'",
          f"train_anakin.max_train_steps = {_ANAKIN_FUSED_STEPS}"])
      per_iter = (gin.query_parameter("train_anakin.rollout_length")
                  * gin.query_parameter("QTOptLearner.cem_iterations")
                  + gin.query_parameter("train_anakin.train_batches_per_iter")
                  * gin.query_parameter("QTOptLearner.cem_iterations"))
      k = gin.query_parameter("train_anakin.train_batches_per_iter")
      trace_path = os.path.join(model_dir, "window.json")
      window = _TracedWindow("gin qtopt_anakin + fused select, steps "
                             f"{_ANAKIN_WINDOW[0] + 1}-{_ANAKIN_WINDOW[1]}",
                             trace_path)
      t0 = time.perf_counter()
      state = train_anakin(hooks=[window])
      wall = time.perf_counter() - t0
      _anakin_records(f"gin qtopt_anakin fused (in-process {wall:.2f} s, "
                      "one interval traced)", model_dir, pod=False,
                      steps_to=_ANAKIN_FUSED_STEPS)
      sizes, copies, timeline = _trace_window(trace_path)
  finally:
    gin.clear_config()
  iters = (_ANAKIN_WINDOW[1] - _ANAKIN_WINDOW[0]) // k
  want = iters * per_iter
  traced = window.traced
  _log(f"gin qtopt_anakin fused window: {iters} iterations in "
       f"{window.seconds:.3f} s with the trace's lead; cem_select launches "
       f"{traced['cem_select']} (want {want}: {per_iter} an iteration); "
       f"copies {json.dumps(copies)}, host-to-device bytes {sizes}; device "
       f"per iteration: span {timeline['span_ms'] / iters:.3f} ms, busy "
       f"{timeline['busy_ms'] / iters:.3f} ms, "
       f"{timeline['kernels'] / iters:.1f} kernels; top kernels over the "
       f"window (ms) {timeline['top_ms']}; final step {state.step}")
  if traced["cem_select"] != want or state.step != _ANAKIN_FUSED_STEPS:
    raise AssertionError(f"anakin fused: launches {traced}, step "
                         f"{state.step}")
  if any(n > _HTOD_LIMIT for n in sizes):
    raise AssertionError(f"anakin fused: host-to-device copies {sizes}")
  return traced["cem_select"]


# The one cut of the pod gin: max_train_steps 1000 → 500 (chip_smoke's
# time limit); phase 51 runs the same program, the shardmap gin's, to
# 1000 with a sweep at each checkpoint.
_POD_STEPS = 500


def phase_gin_qtopt_anakin_pod():
  """47. The shipped `qtopt_anakin_pod.gin` through the trainer binary on
  this one card (`num_devices = 0` resolves to 1: the single program;
  batch 64, lax select), `_POD_STEPS` steps bound on top: the pod
  records (`_anakin_records`), and `ScenarioSuccessEvalHook`'s
  256-scenario sweep at the checkpoint: a metrics line and one appended
  success-protocol line."""
  import tempfile
  with tempfile.TemporaryDirectory() as model_dir:
    wall = _run_trainer("gin qtopt_anakin_pod (one card)", [
        "--trainer=anakin", "--gin_configs", _GIN_ANAKIN_POD,
        "--gin_bindings", f"train_anakin.model_dir='{model_dir}'",
        "--gin_bindings", f"train_anakin.max_train_steps={_POD_STEPS}"],
        model_dir)
    _anakin_records(f"gin qtopt_anakin_pod (wall {wall:.2f} s)", model_dir,
                    pod=True, steps_to=_POD_STEPS)
    evals = _checked_records(os.path.join(model_dir,
                                          "metrics_scenario_eval.jsonl"))
    with open(os.path.join(model_dir, "success_protocol",
                           "scenarios_by_checkpoint.jsonl")) as f:
      sweeps = [json.loads(line) for line in f if line.strip()]
  _log(f"gin qtopt_anakin_pod sweeps: "
       f"{[dict(step=r['step'], **r['payload']) for r in evals]}; "
       f"per bucket {[s['per_bucket'] for s in sweeps]}")
  if ([r["step"] for r in evals] != [_POD_STEPS]
      or [s["step"] for s in sweeps] != [_POD_STEPS]
      or any(s["num_scenarios"] != 256 for s in sweeps)):
    raise AssertionError(f"anakin pod sweeps: {evals} {sweeps}")


def phase_success_protocol(seedcheck):
  """48. The success protocol's new modes on the card: `envs` at its full
  size (2000 Anakin steps of 256 procgen envs at 32×32, fused select,
  then the 512-scenario sweep): success per bucket and the random
  baseline on the same scenarios, the success gated above the baseline;
  `gripper --small`; and the seedcheck of phase 23, whose envs and
  Anakin halves must be there and reproducible (one card: count 2
  skipped)."""
  import tempfile
  from tensor2robot_tpu_torch.bin import run_success_protocol as protocol
  with tempfile.TemporaryDirectory() as out:
    t0 = time.perf_counter()
    envs_row = protocol.run_envs(out, device="cuda", cem_select="fused")
    envs_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gripper = protocol.run_gripper(out, device="cuda",
                                   config=protocol.GRIPPER_SMALL)
    gripper_s = time.perf_counter() - t0
  _log(f"success protocol envs ({envs_s:.2f} s): "
       f"{json.dumps({k: v for k, v in envs_row.items() if k != 'records'})}"
       f"; per bucket {json.dumps(envs_row['records'])}")
  _log(f"success protocol gripper --small ({gripper_s:.2f} s): "
       f"{json.dumps(gripper)}")
  if not envs_row["success_rate"] > envs_row["random_baseline_success_rate"]:
    raise AssertionError(f"envs protocol: {envs_row}")
  if set(gripper) != {"vrgripper_bc_success_eval.jsonl",
                      "vrgripper_transformer_success_eval.jsonl"}:
    raise AssertionError(f"gripper protocol: {gripper}")
  halves = ("scenario_sweep_action_sha256", "scenario_sweep_scenario_sha256",
            "pod_params_sha256_devices_1", "pod_params_sha256_devices_2")
  run_a = seedcheck["run_a"]
  _log(f"seedcheck halves: {json.dumps({k: run_a.get(k) for k in halves})}")
  if not seedcheck["reproducible"] or not all(k in run_a for k in halves):
    raise AssertionError(f"seedcheck: {seedcheck}")
  return envs_row


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


class _GraphReleaser:
  """Garbage in a reference cycle whose destructor drops the last
  references to CUDA graphs, as a dead learner or engine does when the
  collector reclaims it."""

  def __init__(self, graphs):
    self.graphs = graphs
    self.cycle = self

  def __del__(self):
    self.graphs.clear()


def phase_capture_under_collection(rounds=3):
  """Phase 37: a capture survives a garbage collection that falls inside
  it. A `CUDAGraph`'s destructor makes a CUDA call that a capture does
  not permit: when the collector reclaims a dead object holding graphs
  on the capturing thread, the capture is invalidated, and the error
  shows at its end (cudaErrorStreamCaptureInvalidated). Here the step
  makes such garbage while it is captured, with the collector's
  threshold at 1. The control, a bare `torch.cuda.graph` capture on a
  thread of its own, must be invalidated at least once (else the check
  shows nothing); `StepGraph` must capture every round and replay the
  eager step within 1e-5."""
  import gc
  import torch
  from tensor2robot_tpu_torch.utils.step_graph import (
      StepGraph,
      collector_held,
  )
  dev = torch.device("cuda")
  gen = torch.Generator(device=dev).manual_seed(0)
  carry = {"w": torch.randn(256, 256, device=dev, generator=gen) / 16}
  inputs = {"a": torch.randn(64, 256, device=dev, generator=gen)}
  spare = []

  def fn(carry, inputs, generators):
    y = inputs["a"]
    for _ in range(8):
      if torch.cuda.is_current_stream_capturing():
        _GraphReleaser(spare)
        [[] for _ in range(8)]  # allocations: the collector runs
      y = torch.tanh(y @ carry["w"])
    return carry, {"y": y}

  def refill():
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    for _ in range(4):
      graph = torch.cuda.CUDAGraph()
      with collector_held(), torch.cuda.graph(graph, stream=side):
        inputs["a"].mul(2)
      spare.append(graph)
    torch.cuda.synchronize()

  def bare(result):
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
      fn(carry, inputs, [])
    torch.cuda.current_stream(dev).wait_stream(side)
    try:
      with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=side,
                            capture_error_mode="thread_local"):
        fn(carry, inputs, [])
      result.append(None)
    except RuntimeError as e:
      result.append(str(e).splitlines()[0])

  eager = fn(carry, inputs, [])[1]["y"]
  threshold = gc.get_threshold()
  control, errs = [], []
  try:
    for _ in range(rounds):
      refill()
      gc.set_threshold(1, 1, 1)
      result = []
      thread = threading.Thread(target=bare, args=(result,))
      thread.start()
      thread.join()
      gc.set_threshold(*threshold)
      control.append(result[0] if result else "no result")
    torch.cuda.synchronize()
    for _ in range(rounds):
      refill()
      gc.set_threshold(1, 1, 1)
      graph = StepGraph(fn, carry, inputs, dev)
      gc.set_threshold(*threshold)
      errs.append(float((graph.replay(inputs)["y"] - eager).abs().max()))
  finally:
    gc.set_threshold(*threshold)
    spare.clear()
  invalidated = sum(e is not None for e in control)
  _log(f"capture under collection: bare torch.cuda.graph invalidated "
       f"{invalidated} of {rounds} ({next((e for e in control if e), None)}); "
       f"StepGraph captured {len(errs)} of {rounds}, replay vs eager max "
       f"abs err {max(errs)} (tol 1e-5)")
  if not invalidated:
    raise AssertionError("capture under collection: the bare capture was "
                         "never invalidated, so the check shows nothing")
  if max(errs) > 1e-5:
    raise AssertionError(f"capture under collection: replay vs eager {errs}")


_GIN_MOE = ("tensor2robot_tpu/research/vrgripper/configs/"
            "train_vrgripper_transformer_moe.gin")
_GIN_SHARDMAP = ("tensor2robot_tpu/research/qtopt/configs/"
                 "qtopt_anakin_shardmap.gin")
# The MoE gin's layer: 16 episodes × 32 steps of width 128, 8 experts of
# hidden width 512, top-2, capacity factor 2.0 (C = 256).
_MOE_SHAPE = dict(tokens=16 * 32, model_dim=128, experts=8, hidden=512, k=2,
                  capacity_factor=2.0)
# The MoE gin's cut (chip_smoke's time limit): max_train_steps
# 2000 → 500.
_MOE_STEPS = 500
_MOE_SERVE_STEPS = 32
# The perf plane's scalars every record of a train_eval gin carries.
_PLANE_KEYS = ("perf.mfu", "perf.flops_per_sec", "perf.device_time_fraction",
               "stall_fraction", "input_wait_fraction",
               "rsrc.device0_mem_bytes")
_RATES = {}  # grad steps/s medians by gin, printed beside each other


def _moe_params(dtype, device, seed=1):
  import torch
  from tensor2robot_tpu_torch.models.abstract_model import init_parameters
  from tensor2robot_tpu_torch.parallel import moe
  s = _MOE_SHAPE
  module = moe.MoEMLP(s["model_dim"], s["experts"], s["hidden"], k=s["k"],
                      capacity_factor=s["capacity_factor"], dtype=dtype)
  init_parameters(module, torch.Generator().manual_seed(seed))
  return module.to(device)


def phase_moe_card_vs_cpu():
  """49. The MoE layer at `train_vrgripper_transformer_moe.gin`'s shape
  (N = 512 tokens, E = 8, k = 2, capacity factor 2.0: C = 256, M = 128,
  H = 512) on the card against the CPU: `top_k_routing` on the same f32
  logits gives the same dispatch tensor exactly and the combine weights
  and aux loss within 1e-6; `moe_mlp` in f32 within 1e-5 of the output's
  largest |value| (matmuls without TF32), in bf16 within 2e-2 of it.
  Then the layer's device ms (graph replay, bf16) beside the dense MLP's
  of the same widths (M → 4M → M). Returns the timing row."""
  import torch
  import torch.nn.functional as F
  from tensor2robot_tpu_torch.parallel import moe
  s = _MOE_SHAPE
  capacity = moe.expert_capacity(s["tokens"], s["experts"], s["k"],
                                 s["capacity_factor"])
  gen = torch.Generator().manual_seed(0)
  x = torch.randn(s["tokens"], s["model_dim"], generator=gen)
  logits = torch.randn(s["tokens"], s["experts"], generator=gen)
  routed = {d: moe.top_k_routing(logits.to(d), capacity, s["k"])
            for d in ("cpu", "cuda")}
  dispatch_equal = torch.equal(routed["cuda"][0].cpu(), routed["cpu"][0])
  route_err = max((routed["cuda"][i].cpu() - routed["cpu"][i]).abs().max()
                  .item() for i in (1, 2))
  errs = {}
  for name, dtype, tol in (("f32", torch.float32, 1e-5),
                           ("bf16", torch.bfloat16, 2e-2)):
    out = {}
    for device in ("cpu", "cuda"):
      layer = _moe_params(dtype, device)
      with torch.no_grad():
        y, aux = layer(x.to(device)[None])
      out[device] = (y.float().cpu(), aux.cpu())
    scale = out["cpu"][0].abs().max().item()
    errs[name] = ((out["cuda"][0] - out["cpu"][0]).abs().max().item()
                  / scale, abs(out["cuda"][1] - out["cpu"][1]).item(), tol)
  _log(f"MoE card vs CPU (N={s['tokens']}, E={s['experts']}, k={s['k']}, "
       f"C={capacity}, M={s['model_dim']}, H={s['hidden']}): dispatch "
       f"equal {dispatch_equal}, combine/aux max error {route_err} (tol "
       f"1e-6); output error over its scale, aux error, tol "
       f"{json.dumps(errs)}")
  if not dispatch_equal or route_err > 1e-6:
    raise AssertionError(f"MoE routing differs card vs CPU: {route_err}")
  if any(err > tol for err, _, tol in errs.values()) or errs["f32"][1] > 1e-6:
    raise AssertionError(f"MoE layer differs card vs CPU: {errs}")
  layer = _moe_params(torch.bfloat16, "cuda")
  xb = x.to("cuda", torch.bfloat16)[None]
  w1 = torch.randn(s["model_dim"], 4 * s["model_dim"], generator=gen).to(
      "cuda", torch.bfloat16) * 0.05
  w2 = torch.randn(4 * s["model_dim"], s["model_dim"], generator=gen).to(
      "cuda", torch.bfloat16) * 0.05
  b1 = torch.zeros(4 * s["model_dim"], device="cuda", dtype=torch.bfloat16)
  b2 = torch.zeros(s["model_dim"], device="cuda", dtype=torch.bfloat16)
  with torch.no_grad():
    row = {"moe_ms": _graph_ms(lambda: layer(xb)),
           "dense_mlp_ms": _graph_ms(
               lambda: F.gelu(xb @ w1 + b1, approximate="tanh") @ w2 + b2)}
  _log(f"MoE layer device ms (bf16, graph replay, the gin's shape): "
       f"{json.dumps(row)}")
  return row


def _plane_gates(label, raw):
  """Every record carries the perf plane's scalars, finite."""
  import math
  for record in raw:
    p = record["payload"]
    missing = [k for k in _PLANE_KEYS if k not in p
               or not math.isfinite(p[k])]
    if missing:
      raise AssertionError(f"{label}: step {record['step']} lacks "
                           f"{missing}: {sorted(p)}")


def phase_gin_vrgripper_moe():
  """50. The shipped `train_vrgripper_transformer_moe.gin` as written,
  through the trainer binary in a new process with the header's two
  bindings and one cut (`_MOE_STEPS`, 500 of its 2000 steps), from 100
  demos `collect_demo_episodes` wrote: the transformer gin's width with
  8 experts on blocks 1 and 3, B=16 × 32, bf16, flash attention, the
  default overlapped startup. Gates: those of
  `phase_gin_vrgripper_transformer` (a valid record every 100 steps, the
  loss falling, checkpoints every 500 steps), `aux_loss` finite in (0,
  8], `startup_timings.json` in mode
  "overlapped", and the perf plane's scalars (`_PLANE_KEYS`) finite in
  every record. Then the file in this process with 20 steps bound on
  top, traced: each flash kernel 4 launches a step + the graph's
  warm-up step's, equal to CUPTI's; then the trained checkpoint serves
  `_MOE_SERVE_STEPS` steps through `EpisodeContextPolicy`, graphed,
  with finite actions and 4 flash launches a step + the warm-up's."""
  import tempfile
  import numpy as np
  import torch
  from tensor2robot_tpu_torch import config as gin
  from tensor2robot_tpu_torch import train_eval
  from tensor2robot_tpu_torch.bin import run_t2r_trainer
  from tensor2robot_tpu_torch.ops import launch_counts
  from tensor2robot_tpu_torch.research.vrgripper import (
      VRGripperTransformerModel,
      collect_demo_episodes,
  )
  from tensor2robot_tpu_torch.utils import checkpoints as ckpt_lib
  with tempfile.TemporaryDirectory() as tmp:
    demos = collect_demo_episodes(os.path.join(tmp, "demos.tfrecord"))
    model_dir = os.path.join(tmp, "run")
    os.makedirs(model_dir)
    wall = _run_trainer("gin train_vrgripper_transformer_moe (as shipped, "
                        f"cut to {_MOE_STEPS} steps)", [
        "--gin_configs", _GIN_MOE,
        "--gin_bindings", f"train_eval_model.model_dir='{model_dir}'",
        "--gin_bindings",
        f"train/TFRecordEpisodeInputGenerator.file_patterns='{demos}'",
        "--gin_bindings", f"train_eval_model.max_train_steps={_MOE_STEPS}"],
        model_dir)
    raw = _checked_records(os.path.join(model_dir, "metrics_train.jsonl"))
    ckpts = ckpt_lib.list_steps(model_dir)
    with open(os.path.join(model_dir, "startup_timings.json")) as f:
      timings = json.load(f)
    steps = [r["step"] for r in raw]
    payloads = [r["payload"] for r in raw]
    losses = [p["loss"] for p in payloads]
    aux = [p["aux_loss"] for p in payloads]
    rates = [p["steps_per_sec"] for p in payloads]
    _RATES["train_vrgripper_transformer_moe.gin"] = statistics.median(
        rates[1:])
    _log(f"gin train_vrgripper_transformer_moe: wall {wall:.2f} s; steps "
         f"{steps}; loss {losses}; aux_loss {aux}; steps_per_sec {rates} "
         f"(median after the first interval {statistics.median(rates[1:])}); "
         f"checkpoints {ckpts}; startup {json.dumps(timings)}")
    for key in _PLANE_KEYS:
      _log(f"  {key}: {[p[key] for p in payloads]}")
    if steps != list(range(100, _MOE_STEPS + 1, 100)):
      raise AssertionError(f"gin moe: record steps {steps}")
    if not all(np.isfinite(losses)) or not (np.mean(losses[-3:])
                                            < np.mean(losses[:3])):
      raise AssertionError(f"gin moe: losses {losses}")
    if not all(np.isfinite(aux)) or not all(0.0 < a <= 8.0 for a in aux):
      raise AssertionError(f"gin moe: aux_loss {aux}")
    if ckpts != list(range(500, _MOE_STEPS + 1, 500)):
      raise AssertionError(f"gin moe: checkpoints {ckpts}")
    if timings["mode"] != "overlapped" or set(timings["phase_seconds"]) != {
        "compile", "input"}:
      raise AssertionError(f"gin moe: startup {timings}")
    _plane_gates("gin moe", raw)

    run_t2r_trainer.import_configurable_families()
    steps = 20
    traced_dir = os.path.join(tmp, "traced")
    try:
      gin.parse_config_files_and_bindings([_GIN_MOE], [
          f"train_eval_model.model_dir = '{traced_dir}'",
          f"train/TFRecordEpisodeInputGenerator.file_patterns = '{demos}'",
          f"train_eval_model.max_train_steps = {steps}"])
      t0 = time.perf_counter()
      with traced_launches("gin train_vrgripper_transformer_moe") as traced:
        state = train_eval.train_eval_model()
      traced_wall = time.perf_counter() - t0
      model = VRGripperTransformerModel()
      trained = ckpt_lib.restore_state(
          model_dir, like=model.create_train_state(seed=0),
          step=_MOE_STEPS)
    finally:
      gin.clear_config()
    launches = {name: traced[name] for name in _FLASH_KERNELS}
    warm = {name: _warm(name) for name in _FLASH_KERNELS}
    _log(f"gin train_vrgripper_transformer_moe in-process: {state.step} "
         f"steps in {traced_wall:.2f} s (traced); launches "
         f"{json.dumps(launches)} (warm-up {json.dumps(warm)}; CUPTI = "
         "counters)")
    if state.step != steps or any(n != 4 * steps + warm[k] or warm[k] != 4
                                  for k, n in launches.items()):
      raise AssertionError(f"gin moe: step {state.step}, launches "
                           f"{launches}: each should be 4 x {steps} + "
                           f"warm-up {warm}")

  policy = model.make_context_policy(trained)
  rng = np.random.default_rng(0)
  _reset_counts()
  actions = []
  t0 = time.perf_counter()
  for _ in range(_MOE_SERVE_STEPS):
    actions.append(policy({
        "image": rng.integers(0, 256, (1, 48, 48, 3), dtype=np.uint8),
        "gripper_pose": rng.uniform(-1, 1, (1, 3)).astype(np.float32)}
                          )["action"])
  torch.cuda.synchronize()
  serve_s = time.perf_counter() - t0
  served = launch_counts()["flash_attention_fwd"]
  warm = _warm("flash_attention_fwd")
  _log(f"MoE context policy (trained checkpoint, graphed): "
       f"{_MOE_SERVE_STEPS} steps in {serve_s:.3f} s; flash launches "
       f"{served} (warm-up {warm}); last action {actions[-1].tolist()}")
  if not np.isfinite(np.concatenate(actions)).all() or (
      served != 4 * _MOE_SERVE_STEPS + warm):
    raise AssertionError(f"MoE policy: launches {served}, actions finite "
                         f"{np.isfinite(np.concatenate(actions)).all()}")
  _log(f"grad steps/s from records (median after the first interval): "
       f"{json.dumps(_RATES)}")
  return launches


def _shardmap_learner():
  """The shardmap gin's learner, for its analytic FLOPs."""
  from tensor2robot_tpu_torch.research.qtopt import (
      GraspingQModel,
      QTOptLearner,
  )
  return QTOptLearner(GraspingQModel(image_size=64, action_dim=2),
                      cem_iterations=2, cem_population=64, cem_elites=6)


def phase_gin_qtopt_anakin_shardmap():
  """51. The shipped `qtopt_anakin_shardmap.gin` as written through the
  trainer binary (`--trainer=anakin`): the shard_map pod program at D = 1
  on this card, the qtopt rules table on the pod mesh, the weight-update
  sharding, batch 64, 1000 steps: the pod records (`_anakin_records`),
  the scenario sweep at 500 and 1000 on one scenario digest, and in
  every record `perf.mfu` = the analytic count
  (`utils.profiling.qtopt_step_flops`, D = 1) × grad steps/s over the
  card's peak."""
  import tempfile
  from tensor2robot_tpu_torch.utils import profiling
  learner = _shardmap_learner()
  flops = profiling.qtopt_step_flops(
      learner, 64, params=learner.create_state(0).train_state.params)
  peak = profiling.device_peak_flops()
  with tempfile.TemporaryDirectory() as model_dir:
    wall = _run_trainer("gin qtopt_anakin_shardmap (as shipped, one card)", [
        "--trainer=anakin", "--gin_configs", _GIN_SHARDMAP,
        "--gin_bindings", f"train_anakin.model_dir='{model_dir}'"],
        model_dir)
    raw = _anakin_records(f"gin qtopt_anakin_shardmap (wall {wall:.2f} s)",
                          model_dir, pod=True)
    evals = _checked_records(os.path.join(model_dir,
                                          "metrics_scenario_eval.jsonl"))
    with open(os.path.join(model_dir, "success_protocol",
                           "scenarios_by_checkpoint.jsonl")) as f:
      sweeps = [json.loads(line) for line in f if line.strip()]
  payloads = [r["payload"] for r in raw]
  mfu = [p.get("perf.mfu") for p in payloads]
  want = [p["grad_steps_per_sec"] * flops / peak for p in payloads]
  _log(f"gin qtopt_anakin_shardmap: qtopt_step_flops {flops} at B=64, peak "
       f"{peak}; perf.mfu {mfu}; perf.device_time_fraction "
       f"{[p.get('perf.device_time_fraction') for p in payloads]}; "
       f"rsrc.device0_mem_bytes "
       f"{[p.get('rsrc.device0_mem_bytes') for p in payloads]}; sweeps "
       f"{[dict(step=r['step'], **r['payload']) for r in evals]}")
  if any(m is None or abs(m - w) > 1e-9 * w for m, w in zip(mfu, want)):
    raise AssertionError(f"shardmap perf.mfu {mfu}, want {want}")
  if ([r["step"] for r in evals] != [500, 1000]
      or [s["step"] for s in sweeps] != [500, 1000]
      or len({s["scenario_digest"] for s in sweeps}) != 1):
    raise AssertionError(f"shardmap sweeps: {evals} {sweeps}")


def _anakin_in_process(gin_file, bindings, hooks=()):
  """`train_anakin()` of `gin_file` in this process with `bindings` on
  top (and no hooks); returns the final state."""
  import tempfile
  from tensor2robot_tpu_torch import config as gin
  from tensor2robot_tpu_torch.envs import train_anakin
  try:
    with tempfile.TemporaryDirectory() as model_dir:
      gin.parse_config_files_and_bindings([gin_file], [
          f"train_anakin.model_dir = '{model_dir}'",
          "train_anakin.hooks = []", *bindings])
      return train_anakin(hooks=list(hooks))
  finally:
    gin.clear_config()


def phase_shardmap_is_the_single_program():
  """52. On the card, under cuDNN's deterministic algorithms (its default
  convolution backward is not deterministic), `qtopt_anakin_pod.gin`
  and `qtopt_anakin_shardmap.gin` train 16 steps each in this process:
  their final params, Adam state, batch statistics and target params
  are equal bit for bit (the shard_map program at D = 1 is the single
  program). Then the shardmap file with `cem_select = "fused"` bound on
  top trains 12 steps traced: cem_select's launches equal CUPTI's and
  (rollout 4 × CEM 2 + K 4 × 2) an iteration + the warm-up iteration's."""
  import torch
  from tensor2robot_tpu_torch.bin import run_t2r_trainer
  run_t2r_trainer.import_configurable_families()
  torch.backends.cudnn.deterministic = True
  try:
    short = ["train_anakin.max_train_steps = 16"]
    pod = _anakin_in_process(_GIN_ANAKIN_POD, short)
    shardmap = _anakin_in_process(_GIN_SHARDMAP, short)
  finally:
    torch.backends.cudnn.deterministic = False
  diffs = []
  for name in ("params", "batch_stats"):
    a, b = getattr(pod.train_state, name), getattr(shardmap.train_state, name)
    diffs += [f"{name}.{k}" for k in a if not torch.equal(a[k], b[k])]
  adam_a, adam_b = pod.train_state.opt_state[0], shardmap.train_state.opt_state[0]
  diffs += [f"adam.{k}" for k in adam_a.mu
            if not (torch.equal(adam_a.mu[k], adam_b.mu[k])
                    and torch.equal(adam_a.nu[k], adam_b.nu[k]))]
  diffs += [f"target.{k}" for k in pod.target_params
            if not torch.equal(pod.target_params[k],
                               shardmap.target_params[k])]
  _log(f"pod gin vs shardmap gin, 16 steps each (cuDNN deterministic): "
       f"{len(pod.train_state.params)} params, step {pod.train_state.step} "
       f"/ {shardmap.train_state.step}, Adam count "
       f"{int(adam_a.count)} / {int(adam_b.count)}; leaves that differ "
       f"{diffs}")
  if diffs or not int(adam_a.count) == int(adam_b.count) == 16:
    raise AssertionError(f"shardmap != pod program: {diffs}")
  per_iter = 4 * 2 + 4 * 2
  with traced_launches("gin qtopt_anakin_shardmap + fused select") as traced:
    state = _anakin_in_process(_GIN_SHARDMAP, [
        "QTOptLearner.cem_select = 'fused'",
        "train_anakin.max_train_steps = 12"])
  warm = _warm("cem_select")
  want = per_iter * 3 + warm
  _log(f"gin qtopt_anakin_shardmap + fused, 12 steps traced: cem_select "
       f"launches {traced['cem_select']} (want {want}: {per_iter} an "
       f"iteration + warm-up {warm}; CUPTI = counter); step "
       f"{state.train_state.step}")
  if traced["cem_select"] != want or warm != per_iter:
    raise AssertionError(f"shardmap fused launches {traced}")
  return traced["cem_select"]


class _FirstStep:
  """A trainer hook noting the wall clock of the first step's end."""

  def __init__(self):
    self.at = None

  def begin(self, model, model_dir):
    pass

  def after_step(self, step, metrics):
    if self.at is None:
      self.at = time.perf_counter()

  def after_checkpoint(self, step, state, model_dir):
    pass

  def end(self, step, state, model_dir):
    pass


def phase_overlapped_is_serial():
  """53. The overlapped startup against the serial one on the card:
  `train_vrgripper_bc.gin` from 100 demos in this process (its
  SuccessEvalHook left out, checkpoints every 20 steps, its shuffles
  seeded) trains 20 steps,
  then resumes to 40 twice from copies of that directory, overlapped and
  serial, under cuDNN's deterministic algorithms: the final params and
  Adam state equal bit for bit. Prints each start's phase seconds (the
  serial start's restore and input spin-up timed around its calls) and
  its wall from the call to the first step's end."""
  import shutil
  import tempfile
  import torch
  from tensor2robot_tpu_torch import config as gin
  from tensor2robot_tpu_torch import train_eval
  from tensor2robot_tpu_torch.bin import run_t2r_trainer
  from tensor2robot_tpu_torch.research.vrgripper import collect_demo_episodes
  from tensor2robot_tpu_torch.utils import checkpoints as ckpt_lib
  run_t2r_trainer.import_configurable_families()
  timed = {}

  def timing(fn, name):
    def wrapped(*args, **kwargs):
      t0 = time.perf_counter()
      try:
        return fn(*args, **kwargs)
      finally:
        timed[name] = time.perf_counter() - t0
    return wrapped

  def run(model_dir, demos, steps, overlap):
    hook = _FirstStep()
    try:
      gin.parse_config_files_and_bindings([_GIN_BC], [
          f"train_eval_model.model_dir = '{model_dir}'",
          f"train/TFRecordEpisodeInputGenerator.file_patterns = '{demos}'",
          # Seeded shuffles (the gin's are fresh per run), so the two
          # resumes read the same batches.
          "train/TFRecordEpisodeInputGenerator.seed = 0",
          "train/TransitionInputGenerator.seed = 0",
          f"train_eval_model.max_train_steps = {steps}",
          "train_eval_model.save_checkpoints_steps = 20",
          "train_eval_model.log_every_steps = 20",
          f"train_eval_model.overlap_startup = {overlap}"])
      t0 = time.perf_counter()
      state = train_eval.train_eval_model(hooks=[hook])
    finally:
      gin.clear_config()
    return state, hook.at - t0

  torch.backends.cudnn.deterministic = True
  real_restore, real_batches = ckpt_lib.restore_state, train_eval._device_batches
  try:
    with tempfile.TemporaryDirectory() as tmp:
      demos = collect_demo_episodes(os.path.join(tmp, "demos.tfrecord"))
      base = os.path.join(tmp, "overlapped")
      run(base, demos, 20, True)
      serial_dir = os.path.join(tmp, "serial")
      shutil.copytree(base, serial_dir)
      overlapped, overlapped_first = run(base, demos, 40, True)
      with open(os.path.join(base, "startup_timings.json")) as f:
        timings = json.load(f)
      ckpt_lib.restore_state = timing(real_restore, "restore")
      train_eval._device_batches = timing(real_batches, "input")
      serial, serial_first = run(serial_dir, demos, 40, False)
  finally:
    ckpt_lib.restore_state, train_eval._device_batches = (real_restore,
                                                          real_batches)
    torch.backends.cudnn.deterministic = False
  diffs = [k for k, v in serial.params.items()
           if not torch.equal(v, overlapped.params[k])]
  adam_s, adam_o = serial.opt_state[0], overlapped.opt_state[0]
  diffs += [f"adam.{k}" for k in adam_s.mu
            if not (torch.equal(adam_s.mu[k], adam_o.mu[k])
                    and torch.equal(adam_s.nu[k], adam_o.nu[k]))]
  _log(f"overlapped vs serial resume of train_vrgripper_bc.gin (20 → 40 "
       f"steps, cuDNN deterministic): steps {overlapped.step} / "
       f"{serial.step}; leaves that differ {diffs}; overlapped startup "
       f"{json.dumps(timings)}, wall to the first step "
       f"{overlapped_first:.3f} s; serial restore {timed.get('restore')} s, "
       f"input spin-up {timed.get('input')} s, wall to the first step "
       f"{serial_first:.3f} s")
  if diffs or not serial.step == overlapped.step == 40:
    raise AssertionError(f"overlapped != serial: {diffs}")
  if timings["mode"] != "overlapped" or set(timings["phase_seconds"]) != {
      "compile", "restore", "input"}:
    raise AssertionError(f"overlapped startup timings: {timings}")


# ---- phases 54-59: the model handoff (export, predictor, warm start,
# cold start, traces) ----

_HANDOFF_STEPS = 20
_HANDOFF_SEQUENCE_LENGTH = 32
# bf16 outputs, as a share of their largest |value|: one program against
# the eager step it was traced from, both on the card (the same kernels
# in the same order), and the CPU's program against the card's (other
# bf16 GEMM and convolution roundings through four layers).
_HANDOFF_TOL_CARD = 2e-2
_HANDOFF_TOL_CPU = 6e-2
_CAPTURE_ROUNDS = 3
# Phase 56 runs more rounds, up to this many, until a capture has ended
# inside an export: which of the two threads finishes first is a race
# for the interpreter (three rounds with none inside an export failed a
# run on the card; other runs found 0-2 in a round).
_CAPTURE_ROUNDS_MAX = 6
# Eval metrics of a graph replay against the eager step, over their
# scale: cuDNN may pick another algorithm for a capture than for an
# eager call (bf16; phase 15 compares bit for bit under its
# deterministic algorithms).
_CAPTURE_TOL = 1e-3
_CAPTURES_PER_ROUND = 8
_TRACE_WINDOW = (3, 5)  # ProfilerHook start_step, num_steps
_BUSY_SLACK = 1.05


def phase_flash_operator():
  """Phase 54: the flash forward through `torch.ops.t2r.
  flash_attention_fwd` at the gin's shapes (B = 1, T = 512 and B = 16,
  T = 32; H = 4, D = 32, bf16) against the plain version; the fake
  implementation's shapes, dtypes and strides equal the kernel's; the
  operator's launches = CUPTI's."""
  import torch
  from torch._subclasses.fake_tensor import FakeTensorMode
  from tensor2robot_tpu_torch.ops.flash_attention import (
      flash_attention_reference,
  )
  errs = {}
  with traced_launches("flash operator") as traced:
    for b, t in ((1, 512), (16, 32)):
      q, k, v = _flash_inputs(b, t, 4, 32, torch.bfloat16, seed=5400 + t)
      out, lse = torch.ops.t2r.flash_attention_fwd(q, k, v, True)
      torch.cuda.synchronize()
      want_out, want_lse = flash_attention_reference(q, k, v, causal=True)
      errs[f"B={b} T={t}"] = (
          (out.float() - want_out.float()).abs().max().item(),
          (lse - want_lse).abs().max().item())
      with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = torch.ops.t2r.flash_attention_fwd(
            *(mode.from_tensor(x) for x in (q, k, v)), True)
      for real, f in zip((out, lse), fake):
        if (real.shape, real.dtype, real.stride()) != (
            f.shape, f.dtype, f.stride()):
          raise AssertionError(
              f"flash operator B={b} T={t}: the kernel gives "
              f"{tuple(real.shape)} {real.dtype} {real.stride()}, the fake "
              f"implementation {tuple(f.shape)} {f.dtype} {f.stride()}")
  tol_out, tol_lse = _FLASH_TOL["torch.bfloat16"]
  if any(o > tol_out or l > tol_lse for o, l in errs.values()):
    raise AssertionError(f"flash operator against its plain version: "
                         f"{errs} (tol {tol_out}, {tol_lse})")
  if traced["flash_attention_fwd"] != 2:
    raise AssertionError(f"flash operator: {traced} launches, want 2")
  _log(f"flash operator torch.ops.t2r.flash_attention_fwd: max_abs_err "
       f"(out, lse) {json.dumps(errs)} (tol {tol_out}, {tol_lse}); fake "
       f"shapes, dtypes and strides = the kernel's; launches "
       f"{traced['flash_attention_fwd']} = CUPTI")


def _handoff_episodes(b, t, seed):
  import numpy as np
  rng = np.random.default_rng(seed)
  return {"image": rng.integers(0, 256, (b, t, 48, 48, 3), dtype=np.uint8),
          "gripper_pose": rng.normal(size=(b, t, 3)).astype(np.float32)}


def _rel_err(got, want):
  import numpy as np
  got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
  if got.shape != want.shape or not np.isfinite(got).all():
    raise AssertionError(f"outputs {got.shape} against {want.shape}, "
                         f"finite {bool(np.isfinite(got).all())}")
  return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def phase_export_handoff():
  """Phase 55: the gin's model (width 128, depth 4, 4 heads, context
  512, bf16, attention "auto") trains 20 graphed steps with
  `create_exporters_fn = @create_default_exporters` bound and an async
  `AsyncExportHook` on top; `SavedModelPredictor()` polls, loads the
  newest export on the card and serves `serving_default` at B = 1, 8
  and T = 32, 512 against `CheckpointPredictor` on the step-20
  checkpoint; the CPU's program against the card's; the flash launches
  inside the loaded program = CUPTI's; `parse_tf_sequence_example` over
  serialized episodes = `serving_default` on the same episodes."""
  import tempfile
  import numpy as np
  import torch
  from tensor2robot_tpu_torch import config as gin
  from tensor2robot_tpu_torch.data import EpisodeInputGenerator, tfexample
  from tensor2robot_tpu_torch.export import (
      SavedModelExportGenerator,
      create_default_exporters,
      load_signatures,
  )
  from tensor2robot_tpu_torch.hooks import AsyncExportHook
  from tensor2robot_tpu_torch.predictors import (
      CheckpointPredictor,
      SavedModelPredictor,
  )
  from tensor2robot_tpu_torch.research.vrgripper import gin_config
  from tensor2robot_tpu_torch.train_eval import train_eval_model

  model = gin_config.gin_model()
  gen = EpisodeInputGenerator(gin_config.expert_episodes(32, seed=55),
                              sequence_length=gin_config.GIN_SEQUENCE_LENGTH,
                              batch_size=gin_config.GIN_BATCH_SIZE, seed=0)
  model_dir = tempfile.mkdtemp(prefix="handoff_")
  hook_generator = SavedModelExportGenerator(
      sequence_example_length=_HANDOFF_SEQUENCE_LENGTH)
  hook = AsyncExportHook(hook_generator)
  final = []

  def exporters(m):
    final.extend(create_default_exporters(m))
    return final

  gin.parse_config("create_default_exporters.sequence_example_length = "
                   f"{_HANDOFF_SEQUENCE_LENGTH}")
  try:
    t0 = time.perf_counter()
    state = train_eval_model(model, model_dir, gen,
                             max_train_steps=_HANDOFF_STEPS,
                             save_checkpoints_steps=_HANDOFF_STEPS,
                             batch_size=gin_config.GIN_BATCH_SIZE,
                             log_every_steps=_HANDOFF_STEPS, seed=0,
                             hooks=[hook], create_exporters_fn=exporters)
    train_s = time.perf_counter() - t0
  finally:
    gin.clear_config()
  if state.step != _HANDOFF_STEPS or not hook.export_paths or not final:
    raise AssertionError(f"handoff: step {state.step}, hook exports "
                         f"{hook.export_paths}, final {final}")
  export_base = os.path.join(model_dir, "export")

  # ---- the robot side: poll, load the newest export on the card ----
  t0 = time.perf_counter()
  predictor = SavedModelPredictor(export_base)
  if not predictor.restore(timeout_secs=0):
    raise AssertionError("handoff: the predictor restored nothing")
  if predictor.device.type != "cuda":
    raise AssertionError(f"handoff: the predictor serves on "
                         f"{predictor.device}, not the card")
  first = predictor.predict(_handoff_episodes(1, 32, seed=0))
  first_s = time.perf_counter() - t0
  manifest = load_signatures(os.path.join(export_base,
                                          str(predictor.model_version)))
  if (predictor.global_step != _HANDOFF_STEPS
      or set(manifest["platforms"]) != {"cuda", "cpu"}
      or "parse_tf_sequence_example" not in manifest["signatures"]):
    raise AssertionError(f"handoff: export at step {predictor.global_step}, "
                         f"manifest {manifest}")
  checkpoint = CheckpointPredictor(model, checkpoint_dir=model_dir)
  if not checkpoint.restore(timeout_secs=0):
    raise AssertionError("handoff: no checkpoint to compare with")
  shapes = [(1, 32), (8, 32), (1, 512), (8, 512)]
  batches = {s: _handoff_episodes(*s, seed=550 + s[0] + s[1])
             for s in shapes}
  errs = {}
  with traced_launches("exported program on the card") as traced:
    served = {s: predictor.predict(batches[s]) for s in shapes}
  warm = _warm("flash_attention_fwd")
  for s in shapes:
    want = checkpoint.predict(batches[s])["action"]
    errs[f"B={s[0]} T={s[1]}"] = _rel_err(served[s]["action"], want)
  if max(errs.values()) > _HANDOFF_TOL_CARD:
    raise AssertionError(f"exported program against CheckpointPredictor: "
                         f"{errs} (tol {_HANDOFF_TOL_CARD} of max |action|)")
  if traced["flash_attention_fwd"] == 0:
    raise AssertionError("the loaded program launched no flash forward")

  # ---- the CPU's program against the card's ----
  cpu = SavedModelPredictor(export_base, device="cpu")
  cpu.restore(timeout_secs=0)
  cpu_errs = {f"B={b} T={t}": _rel_err(
      cpu.predict(batches[(b, t)])["action"], served[(b, t)]["action"])
              for b, t in ((1, 32), (8, 32))}
  if max(cpu_errs.values()) > _HANDOFF_TOL_CPU:
    raise AssertionError(f"program.cpu.pt2 against program.cuda.pt2: "
                         f"{cpu_errs} (tol {_HANDOFF_TOL_CPU})")

  # ---- the proto signature over serialized episodes ----
  proto = SavedModelPredictor(export_base,
                              signature="parse_tf_sequence_example")
  proto.restore(timeout_secs=0)
  episodes = batches[(8, 32)]
  serialized = [tfexample.encode_sequence_example(
      {k: v[i] for k, v in episodes.items()}, proto.feature_specification)
                for i in range(8)]
  proto_err = _rel_err(proto.predict({"examples": serialized})["action"],
                       served[(8, 32)]["action"])
  if proto_err > 0.0:
    raise AssertionError(f"parse_tf_sequence_example against "
                         f"serving_default: {proto_err} (want equal)")

  # ---- p50 per call, graphed (B = 1, T = 32: one robot's step) ----
  one = batches[(1, 32)]
  walls = []
  for _ in range(50):
    t0 = time.perf_counter()
    predictor.predict(one)
    walls.append((time.perf_counter() - t0) * 1e3)
  _log(f"handoff (train_vrgripper_transformer.gin's model, {_HANDOFF_STEPS} "
       f"graphed steps in {train_s:.2f} s, async hook exports "
       f"{len(hook.export_paths)} + final {len(final)}): export seconds "
       f"per platform (hook) {json.dumps(hook_generator.export_seconds)}, "
       f"(final) {json.dumps(final[0].export_seconds)}; load "
       f"{predictor.load_seconds:.3f} s; time to the first prediction "
       f"{first_s:.3f} s (poll + load + first graph capture); p50 "
       f"{statistics.median(walls):.3f} ms per call graphed (B=1, T=32, "
       f"host wall incl. copies); exported vs CheckpointPredictor "
       f"{json.dumps(errs)} (tol {_HANDOFF_TOL_CARD}); cpu program vs card "
       f"{json.dumps(cpu_errs)} (tol {_HANDOFF_TOL_CPU}); "
       f"parse_tf_sequence_example = serving_default (err {proto_err}); "
       f"flash launches in the loaded program {traced['flash_attention_fwd']}"
       f" = CUPTI (warm-up {warm}); accepted dims "
       f"{json.dumps(manifest['dims']['cuda'])}; first action "
       f"{np.asarray(first['action'])[0, 0].tolist()}")
  return model, state, traced["flash_attention_fwd"]


def phase_export_under_capture(model, state):
  """Phase 56: the async hook exports the card's program while the
  training thread captures eval graphs (`StepGraph`, thread_local, the
  collector held), 3 rounds (more, up to `_CAPTURE_ROUNDS_MAX`, until
  one capture has ended inside an export): each round's captures begin
  while the worker exports (up to 8 a round, each counted if the worker
  is still exporting when it ends, at least one in all), no capture is
  invalidated, and each graph replays its eager step (within 1e-3 of its
  scale)."""
  import tempfile
  import torch
  from tensor2robot_tpu_torch.data import EpisodeInputGenerator, Mode
  from tensor2robot_tpu_torch.export import SavedModelExportGenerator
  from tensor2robot_tpu_torch.hooks import AsyncExportHook
  from tensor2robot_tpu_torch.research.vrgripper import gin_config
  from tensor2robot_tpu_torch.train_eval import eval_step_fn
  from tensor2robot_tpu_torch.utils.step_graph import StepGraph

  dev = torch.device("cuda")
  gen = EpisodeInputGenerator(gin_config.expert_episodes(8, seed=56),
                              sequence_length=32, batch_size=4, seed=0)
  gen.set_specification_from_model(model, Mode.EVAL)
  features, labels = next(gen.create_dataset(Mode.EVAL))
  batch = {"features": {k: torch.as_tensor(v, device=dev)
                        for k, v in features.items()},
           "labels": {k: torch.as_tensor(v, device=dev)
                      for k, v in labels.items()}}
  fn = eval_step_fn(model)
  eager = fn(state, batch, ())[1]
  model_dir = tempfile.mkdtemp(prefix="capture_export_")
  hook = AsyncExportHook(SavedModelExportGenerator(platforms=("cuda",)))
  hook.begin(model, model_dir)
  overlapped, errs, export_s, began = [], [], [], []
  rounds = 0
  while rounds < _CAPTURE_ROUNDS or (sum(overlapped) < 1
                                     and rounds < _CAPTURE_ROUNDS_MAX):
    rounds += 1
    t0 = time.perf_counter()
    hook.after_checkpoint(rounds, state, model_dir)
    worker = hook._worker  # noqa: SLF001
    began.append(worker is not None and worker.is_alive())
    captures = 0
    while (worker is not None and worker.is_alive()
           and captures < _CAPTURES_PER_ROUND):
      graph = StepGraph(fn, state, batch, dev, carries=False)
      if worker.is_alive():
        captures += 1
      out = graph.replay(batch)
      errs.append(max(float((out[k] - eager[k]).abs().max())
                      / max(float(eager[k].abs().max()), 1e-12)
                      for k in eager))
    if worker is not None:
      worker.join()
    export_s.append(round(time.perf_counter() - t0, 2))
    overlapped.append(captures)
  hook.end(rounds, state, model_dir)
  if len(hook.export_paths) != rounds:
    raise AssertionError(f"export under capture: {hook.export_paths}")
  if not all(began) or sum(overlapped) < 1:
    raise AssertionError(f"export under capture: captures begun while the "
                         f"worker exported {began}, ended before it "
                         f"{overlapped}")
  if max(errs) > _CAPTURE_TOL:
    raise AssertionError(f"export under capture: replay vs eager {errs} "
                         f"(tol {_CAPTURE_TOL} of scale)")
  _log(f"export under capture: {rounds} async exports of the "
       f"card's program, eval graphs captured during each "
       f"{overlapped} (none invalidated; seconds a round {export_s}); "
       f"replay vs eager max {max(errs)} of scale (tol {_CAPTURE_TOL})")


def phase_warm_start():
  """Phase 57: `GraspingQModel()` with batch statistics warm-starts from
  a checkpoint (`init_from_checkpoint_path`): before the first step its
  params and BN statistics equal the checkpoint's bit for bit on the
  card; then 2 graphed steps train from there."""
  import dataclasses
  import tempfile
  import torch
  from tensor2robot_tpu_torch.data import RandomInputGenerator
  from tensor2robot_tpu_torch.research.qtopt import GraspingQModel
  from tensor2robot_tpu_torch.train_eval import train_eval_model
  from tensor2robot_tpu_torch.utils import checkpoints as ckpt_lib

  source = GraspingQModel().create_train_state(seed=3)
  g = torch.Generator(device="cuda").manual_seed(57)
  source = dataclasses.replace(source, step=7, batch_stats={
      k: v + torch.rand(v.shape, device=v.device, generator=g).to(v.dtype)
      for k, v in source.batch_stats.items()})
  ckpt_dir = tempfile.mkdtemp(prefix="warm_source_")
  ckpt_lib.CheckpointWriter(ckpt_dir).save(7, source)
  warm = GraspingQModel(init_from_checkpoint_path=ckpt_dir)
  state = warm.create_train_state(seed=0)
  for name, got, want in (("params", state.params, source.params),
                          ("batch_stats", state.batch_stats,
                           source.batch_stats)):
    if set(got) != set(want) or not all(
        got[k].device.type == "cuda" and torch.equal(got[k], want[k])
        for k in want):
      raise AssertionError(f"warm start: {name} differ from the checkpoint")
  trained = train_eval_model(
      warm, tempfile.mkdtemp(prefix="warm_"),
      RandomInputGenerator(batch_size=8, seed=1), max_train_steps=2,
      save_checkpoints_steps=2, log_every_steps=2)
  if trained.step != 2 or not all(bool(torch.isfinite(v).all())
                                  for v in trained.params.values()):
    raise AssertionError(f"warm-started training: step {trained.step}")
  _log(f"warm start (GraspingQModel(), {len(source.params)} params, "
       f"{len(source.batch_stats)} BN statistics): equal to the checkpoint "
       f"bit for bit on the card before the first step; 2 graphed steps "
       f"from there")


def _coldstart(args):
  out = subprocess.run(
      [sys.executable, "-m", "tensor2robot_tpu_torch.startup.coldstart",
       *args], cwd=_REPO, capture_output=True, text=True, timeout=300)
  if out.returncode != 0:
    raise AssertionError(f"coldstart {args}: exit {out.returncode}\n"
                         f"{out.stderr[-3000:]}")
  marker = [l for l in out.stdout.splitlines()
            if l.startswith("COLDSTART_JSON ")]
  return json.loads(marker[-1][len("COLDSTART_JSON "):])


def phase_cold_start_seeds():
  """Phase 58's seeds, made in this process (untimed by the probes): a
  checkpoint for each cold-start probe at full size (`trainer`,
  `serving`). Returns their work dir."""
  import tempfile
  from tensor2robot_tpu_torch.startup import coldstart
  work = tempfile.mkdtemp(prefix="coldstart_")
  coldstart.trainer_setup(os.path.join(work, "trainer_seed"), tiny=False)
  coldstart.serving_setup(os.path.join(work, "serving_seed"), tiny=False)
  return work


def phase_cold_start(work):
  """Phase 58: the cold-start probes on `work`'s seeds: for `trainer`
  and `serving`, a cold probe against a fresh cache dir and a warm one,
  each a process of its own; the warm probes report `cache_misses ==
  0`. It runs beside the fleets of phases 60-62 (no CUDA in this
  process while it runs), so its times are contended."""
  import shutil
  results = {}
  for probe in ("trainer", "serving"):
    seed_dir = os.path.join(work, f"{probe}_seed")
    cache = os.path.join(work, f"{probe}_cache")
    for tag in ("cold", "warm"):
      run_dir = seed_dir
      if probe == "trainer":  # each probe resumes its own copy
        run_dir = os.path.join(work, f"{probe}_{tag}")
        shutil.copytree(seed_dir, run_dir)
      results[f"{probe}_{tag}"] = _coldstart(
          [probe, "--model-dir", run_dir, "--cache-dir", cache])
  for tag in ("trainer_warm", "serving_warm"):
    if results[tag]["compile_watch"]["cache_misses"] != 0:
      raise AssertionError(f"coldstart {tag}: {results[tag]}")
  keys = {"trainer": "time_to_first_step_secs",
          "serving": "time_to_first_prediction_secs"}
  _log("cold start (beside the fleets): " + "; ".join(
      f"{tag} {keys[tag.split('_')[0]]}={r[keys[tag.split('_')[0]]]} "
      f"compile_watch={json.dumps(r['compile_watch'])} "
      f"cache_entries_after={r['cache_entries_after']}"
      for tag, r in results.items()))
  _log(f"cold start results: {json.dumps(results)}")
  shutil.rmtree(work, ignore_errors=True)


def phase_profiler_trace():
  """Phase 59: `ProfilerHook` over 5 of the gin's graphed training steps;
  `utils.xplane.top_ops(compute_only=True)` over its trace names the
  three flash kernels, and the compute ops' sum lies within the window's
  device busy time (at most 1.05×)."""
  import tempfile
  from tensor2robot_tpu_torch.data import EpisodeInputGenerator
  from tensor2robot_tpu_torch.research.vrgripper import gin_config
  from tensor2robot_tpu_torch.train_eval import train_eval_model
  from tensor2robot_tpu_torch.utils import profiling, xplane

  model = gin_config.gin_model()
  gen = EpisodeInputGenerator(gin_config.expert_episodes(16, seed=59),
                              sequence_length=gin_config.GIN_SEQUENCE_LENGTH,
                              batch_size=gin_config.GIN_BATCH_SIZE, seed=0)
  start, num = _TRACE_WINDOW
  logdir = tempfile.mkdtemp(prefix="profile_")
  train_eval_model(model, tempfile.mkdtemp(prefix="traced_"), gen,
                   max_train_steps=start + num + 2,
                   batch_size=gin_config.GIN_BATCH_SIZE,
                   hooks=[profiling.ProfilerHook(start_step=start,
                                                 num_steps=num,
                                                 logdir=logdir)])
  top = xplane.top_ops(logdir, k=1000, compute_only=True)
  found = {}
  for name in _FLASH_KERNELS:
    pattern = re.compile(r"(?<!\w)(?:%s)(?=[<(])" % "|".join(_SYMBOLS[name]))
    found[name] = sum(ms for op, ms in top if pattern.search(op))
  compute = sum(ms for _, ms in top)
  busy = xplane.device_busy_ms(logdir)
  if not all(found.values()):
    raise AssertionError(f"traced window: flash kernels {found} among "
                         f"{top[:10]}")
  if not 0 < compute <= _BUSY_SLACK * busy:
    raise AssertionError(f"traced window: compute {compute} ms against "
                         f"device busy {busy} ms")
  _log(f"profiler trace ({num} graphed steps of the gin's model): compute "
       f"ops {compute:.3f} ms within device busy {busy:.3f} ms "
       f"({compute / busy:.3f}x, limit {_BUSY_SLACK}); flash kernels ms "
       f"{json.dumps(found)}; top 5 {json.dumps(top[:5])}")


_GIN_FLEET = "tensor2robot_tpu/research/qtopt/configs/qtopt_fleet.gin"
_GIN_FLEET_ELASTIC = ("tensor2robot_tpu/research/qtopt/configs/"
                      "qtopt_fleet_elastic.gin")
_GIN_SERVING_REPLICATED = ("tensor2robot_tpu/research/qtopt/configs/"
                           "qtopt_serving_replicated.gin")
_GIN_FLEET_AUTOPILOT = ("tensor2robot_tpu/research/qtopt/configs/"
                        "qtopt_fleet_autopilot.gin")
# The shipped fleet gins bind the physics env, which is ROADMAP A10a.
_FLEET_POSE = 'FleetConfig.env = "pose"'
_FLEET_CUT_STEPS = 200  # phases 60-62 and 64: the gins' 500 steps cut
# Phase 63: the gin's 500 steps cut to 400 and its 10 s poll to 1 s, so
# the rules' warmup and sustain polls fit in the run (a poll under the
# ramp's overload takes ~3.5 s).
_AUTOPILOT_STEPS = 400
_FLEET_POLL_S = 1.0
_FRONT_CRASH_AT = 40  # phase 62: the home front of "policy" dies at serve 40
_CUDA_SAMPLE_S = 1.0


def _fleet_metas(model_dir):
  """The meta lines of a fleet run's trace files (each child writes one
  when it configures its trace, at start), oldest first."""
  metas = []
  telemetry_dir = os.path.join(model_dir, "telemetry")
  if not os.path.isdir(telemetry_dir):
    return metas
  for name in os.listdir(telemetry_dir):
    if not (name.startswith("trace_") and name.endswith(".jsonl")):
      continue
    with open(os.path.join(telemetry_dir, name)) as f:
      for line in f:
        if '"ph": "M"' not in line:
          continue
        try:
          metas.append(json.loads(line))
        except ValueError:
          continue  # a line still being written
  return sorted(metas, key=lambda m: m["mono0"])


def _fleet_pids(model_dir):
  """{pid: role} of every process of a fleet run."""
  return {int(m["pid"]): m["role"] for m in _fleet_metas(model_dir)}


def _fleet_timeline(model_dir, t_start, result):
  """Seconds from the binary's start (`t_start`, monotonic) to: the
  orchestrator's launch (after the gin parse and the launch gate), each
  role's first trace line (its process up, imports done), the learner's
  first and last step, and the end of the run."""
  out = {}
  for meta in _fleet_metas(model_dir):
    out.setdefault(f"{meta['role']} up", round(meta["mono0"] - t_start, 2))
  window = result["metrics"]["learner_window"]
  out["first step"] = round(window["first_time"] - t_start, 2)
  out["last step"] = round(window["last_time"] - t_start, 2)
  return out


def _holds_card(pid):
  """Whether process `pid` has a GPU device file (`/dev/nvidia<N>`)
  open: what a CUDA context keeps open."""
  try:
    fds = os.listdir(f"/proc/{pid}/fd")
  except OSError:
    return False
  for fd in fds:
    try:
      target = os.readlink(f"/proc/{pid}/fd/{fd}")
    except OSError:
      continue
    if re.fullmatch(r"/dev/nvidia\d+", target):
      return True
  return False


def _cpu_seconds(pid):
  """User + system CPU seconds of process `pid` so far (None once it is
  gone)."""
  try:
    with open(f"/proc/{pid}/stat") as f:
      fields = f.read().rsplit(")", 1)[1].split()
  except OSError:
    return None
  return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def _run_fleet_gin(label, gin_file, model_dir, bindings=(), flags=(),
                   python_path=(), timeout_s=600, traffic=()):
  """`run_t2r_trainer --trainer=fleet` on `gin_file` with the pose env
  and `bindings` bound (and `flags`, with `python_path` on the path), as
  a subprocess writing to `model_dir`; with `traffic` (flags such as
  `("--robots", "policy")`), the fleet runs under `python -m
  tensor2robot_tpu_torch.fleet.traffic` instead (the binary's parse,
  `Fleet.run` and the result file, with those router callers on the
  fronts, `traffic.json` beside the result). While it runs, every
  second: the fleet's pids by role (trace meta lines), which of them
  hold the card (an open `/dev/nvidia<N>`) and their CPU time (logged by
  role: the whole run's cores and the busiest second's; a process near
  one core is bound by its interpreter). Fails on a non-zero exit or
  a child alive after it. Returns (the run's `fleet_result.json`,
  {role: held the card}, the roles seen, wall s, model_dir)."""
  os.makedirs(model_dir)
  if traffic:
    cmd = [sys.executable, "-m", "tensor2robot_tpu_torch.fleet.traffic",
           "--model_dir", model_dir, *traffic]
  else:
    cmd = [sys.executable, "-m",
           "tensor2robot_tpu_torch.bin.run_t2r_trainer", "--trainer=fleet",
           "--gin_bindings", f"run_fleet.model_dir = '{model_dir}'"]
  cmd += ["--gin_configs", gin_file, *flags, "--gin_bindings", _FLEET_POSE]
  for binding in bindings:
    cmd += ["--gin_bindings", binding]
  env = dict(os.environ, PYTHONPATH=os.pathsep.join((_REPO, *python_path)))
  log_path = os.path.join(model_dir, "fleet.log")
  roles = {}
  held = {}
  cpu = {}  # pid: ((t, cpu s) first seen, (t, cpu s) last seen)
  busiest = {}  # role: the most cores in one sample interval
  samples = 0
  t0 = time.perf_counter()
  t_start = time.monotonic()
  with open(log_path, "w") as log:
    proc = subprocess.Popen(cmd, cwd=_REPO, env=env, stdout=log,
                            stderr=subprocess.STDOUT)
    try:
      while proc.poll() is None:
        if time.perf_counter() - t0 > timeout_s:
          raise AssertionError(f"{label}: no exit in {timeout_s} s")
        pids = _fleet_pids(model_dir)
        roles.update(pids)
        now = time.monotonic()
        for pid, role in pids.items():
          held[role] = held.get(role, False) or _holds_card(pid)
          used = _cpu_seconds(pid)
          if used is None:
            continue
          first, last = cpu.setdefault(pid, ((now, used), (now, used)))
          if now > last[0]:
            busiest[role] = max(busiest.get(role, 0.0),
                                (used - last[1]) / (now - last[0]))
          cpu[pid] = (first, (now, used))
        samples += 1
        time.sleep(_CUDA_SAMPLE_S)
    finally:
      if proc.poll() is None:
        proc.kill()
        proc.wait()
  wall = time.perf_counter() - t0
  roles.update(_fleet_pids(model_dir))
  with open(log_path) as f:
    tail = f.read().splitlines()[-20:]
  _log(f"{label}: exit {proc.returncode} in {wall:.2f} s "
       f"({samples} samples of the card's processes): {' '.join(cmd[1:])}")
  if proc.returncode != 0:
    raise AssertionError(f"{label} exited {proc.returncode}:\n"
                         + "\n".join(tail))
  alive = sorted(role for pid, role in roles.items()
                 if os.path.exists(f"/proc/{pid}"))
  if alive:
    raise AssertionError(f"{label}: children alive after the run: {alive}")
  with open(os.path.join(model_dir, "fleet_result.json")) as f:
    result = json.load(f)
  timeline = _fleet_timeline(model_dir, t_start, result)
  timeline["exit"] = round(wall, 2)
  _log(f"{label}: timeline s {json.dumps(timeline)}")
  cores = {}
  for pid, ((ta, ua), (tb, ub)) in cpu.items():
    role = roles[pid]
    cores[role] = [round((ub - ua) / max(tb - ta, 1e-9), 2),
                   round(busiest.get(role, 0.0), 2)]
  _log(f"{label}: CPU cores by role [over its life, busiest second] "
       f"{json.dumps(cores, sort_keys=True)}")
  return result, held, set(roles.values()), wall, model_dir


def _checkpoint_digests(model_dir):
  """SHA-256 of every param and batch statistic of the latest
  checkpoint, by name (the host's `served_params_sha256` keys): (step,
  digests)."""
  import hashlib

  from tensor2robot_tpu_torch.utils import checkpoints as ckpt_lib
  step = ckpt_lib.latest_step(model_dir)
  leaves = ckpt_lib._load_leaves(model_dir, step)
  digests = {}
  for path, leaf in leaves.items():
    for prefix in ("train_state/params/", "train_state/batch_stats/"):
      if path.startswith(prefix):
        digests[path[len(prefix):]] = hashlib.sha256(
            leaf.contiguous().numpy().tobytes()).hexdigest()
  return step, digests


def _self_reported_cuda(metrics, model_dir):
  """{role: proc.cuda_initialized} of a fleet run: the hosts' and
  shards' own final reads, every snapshot pushed to the root host, and
  the orchestrator's last aggregated poll (`fleet_metrics.jsonl`, which
  holds what actors pushed to the other serving hosts). True if any
  source says so."""
  out = {}

  def report(role, value):
    out[role] = out.get(role, False) or bool(value)

  report("host", metrics["cuda_initialized"])
  for front in metrics.get("front_hosts") or ():
    report(f"front{front['front_index']}", front["cuda_initialized"])
  for i, replica in enumerate(metrics.get("serving_replicas") or ()):
    report(f"host{replica.get('host_index', i + 1)}",
           replica["cuda_initialized"])
  for i, shard in enumerate(metrics.get("replay_shards") or ()):
    report(f"shard{shard.get('shard_index', i)}", shard["cuda_initialized"])
  for role, pushed in (metrics.get("pushed_telemetry") or {}).items():
    gauges = (pushed.get("snapshot") or {}).get("gauges") or {}
    if "proc.cuda_initialized" in gauges:
      report(role, gauges["proc.cuda_initialized"])
  with open(os.path.join(model_dir, "telemetry", "fleet_metrics.jsonl")) as f:
    last = [json.loads(line) for line in f if line.strip()][-1]["payload"]
  for key, value in last.items():
    if key == "proc.cuda_initialized":
      report("host", value)
    elif key.endswith("/proc.cuda_initialized"):
      report(key.rsplit("/", 1)[0], value)
  return out


def _bucket_quantiles(histograms, qs=(0.5, 0.99)):
  """The bucket (`"<=b"` or `">b"`) holding each quantile of the summed
  `{label: count}` histograms (all with one bucket table)."""
  total = {}
  for histogram in histograms:
    for label, n in histogram.items():
      total[label] = total.get(label, 0) + n
  rows = sum(total.values())
  out = []
  for q in qs:
    seen = 0
    for label, n in total.items():
      seen += n
      if seen >= q * rows:
        out.append(label)
        break
  return out


def _check_fleet(label, result, held, seen, model_dir, card_roles, steps):
  """The gates every fleet phase shares; logs the `FleetResult` (its
  rates taken beside the other fleets', under their load)."""
  metrics = result["metrics"]
  if not result["clean_shutdown"]:
    raise AssertionError(f"{label}: no clean shutdown")
  holders = {role for role, h in held.items() if h}
  reported = _self_reported_cuda(metrics, model_dir)
  on_card = {role for role, r in reported.items() if r}
  _log(f"{label}: roles {sorted(seen)}; holding /dev/nvidia<N> "
       f"{sorted(holders)}; self-reported CUDA {json.dumps(reported, sort_keys=True)}")
  if holders != card_roles or on_card != card_roles:
    raise AssertionError(
        f"{label}: the card's processes are {sorted(holders)} (device "
        f"files) / {sorted(on_card)} (self-reported), expected "
        f"{sorted(card_roles)}")
  missing = seen - {"orchestrator"} - set(reported)
  if missing:
    raise AssertionError(f"{label}: no CUDA report from {sorted(missing)}")
  ckpt_step, digests = _checkpoint_digests(model_dir)
  if ckpt_step != steps or metrics["learner_window"]["last_step"] != steps:
    raise AssertionError(f"{label}: final checkpoint {ckpt_step}, learner "
                         f"window {metrics['learner_window']}, expected "
                         f"{steps}")
  if metrics["served_params_sha256"] != digests:
    raise AssertionError(f"{label}: the root host's served params differ "
                         f"from the learner's step-{steps} checkpoint")
  if metrics["params_learner_step"] != steps:
    raise AssertionError(f"{label}: served params are from step "
                         f"{metrics['params_learner_step']}")
  committed = metrics["service"]["replay_committed_transitions"]
  batch_episodes = 16  # the gins' FleetConfig.batch_episodes
  if committed <= 0 or committed % batch_episodes:
    raise AssertionError(f"{label}: {committed} committed transitions (a "
                         f"partial episode, or none)")
  lag, staleness = result["param_refresh_lag"], result["replay_staleness"]
  stale_rows = sum(s.get("rows", 0) for s in staleness.values() if s)
  if not lag.get("rows") or not stale_rows:
    raise AssertionError(f"{label}: no lag ({lag}) or staleness rows")
  stale_p95 = max(s["batch_mean_age_p95_steps"]
                  for s in staleness.values() if s)
  lag_q = _bucket_quantiles([lag["histogram"]])
  stale_q = _bucket_quantiles([s["histogram"] for s in staleness.values()
                               if s])
  stale_mean = (sum(s["mean_age_steps"] * s["rows"]
                    for s in staleness.values() if s) / stale_rows)
  _log(f"{label}: FleetResult (contended: five fleets, the cold-start "
       f"probes, the cache contract and the group parity side by side) "
       f"env_steps_per_sec "
       f"{result['env_steps_per_sec']:.2f}, learner_steps_per_sec "
       f"{result['learner_steps_per_sec']:.2f}, param_refresh_lag mean "
       f"{lag['mean']:.3f} max {lag['max']} p50 {lag_q[0]} p99 {lag_q[1]} "
       f"(rows {lag['rows']}, histogram {json.dumps(lag['histogram'])}), "
       f"replay_staleness mean {stale_mean:.3f} p50 {stale_q[0]} p99 "
       f"{stale_q[1]} batch-mean p95 {stale_p95:.3f} (rows {stale_rows}), "
       f"publishes {result['publishes']}, params_version "
       f"{result['params_version']}, actor_restarts "
       f"{result['actor_restarts']}, learner_restarts "
       f"{result['learner_restarts']}, recoveries "
       f"{json.dumps(result['recoveries'])}, clean_shutdown "
       f"{result['clean_shutdown']}, wall_secs {result['wall_secs']:.2f}; "
       f"served = checkpoint {ckpt_step} ({len(digests)} tensors) bit for "
       f"bit; committed {committed:.0f}; serving dispatches "
       f"{metrics['serving_dispatches']}")
  return metrics


def _fleet_yardstick(steps=500, batch=64, publish_every=50):
  """The in-process `train_qtopt` at `qtopt_fleet.gin`'s widths (64
  transitions a batch from a prefilled in-memory buffer, checkpoints at
  the gin's publish cadence): the rate the fleet's learner is held
  beside. Returns (steps / wall of the call, median grad steps/s of the
  records after the first)."""
  import tempfile

  import torch

  from tensor2robot_tpu_torch.research.qtopt import (
      GraspingQModel,
      QTOptLearner,
      ReplayBuffer,
      train_qtopt,
  )
  torch.cuda.empty_cache()
  learner = QTOptLearner(
      GraspingQModel(image_size=32, action_dim=2, torso_filters=(16, 32),
                     head_filters=(32, 32), dense_sizes=(32, 32)),
      cem_population=64, cem_iterations=2, cem_elites=6)
  replay = ReplayBuffer(learner.transition_specification(), capacity=4096)
  with tempfile.TemporaryDirectory(prefix="fleet_yardstick_") as model_dir:
    t0 = time.perf_counter()
    train_qtopt(learner=learner, model_dir=model_dir, replay_buffer=replay,
                max_train_steps=steps, batch_size=batch,
                save_checkpoints_steps=publish_every,
                log_every_steps=publish_every, prefill_random=True)
    wall = time.perf_counter() - t0
    rates = [r["payload"]["grad_steps_per_sec"] for r in _checked_records(
        os.path.join(model_dir, "metrics_train.jsonl"))][1:]
  return steps / wall, statistics.median(rates)


def _run_fleet(root):
  """Phase 60's run: `qtopt_fleet.gin` as shipped but for the pose env,
  its 500 steps cut to `_FLEET_CUT_STEPS`."""
  return _run_fleet_gin("phase 60 qtopt_fleet.gin", _GIN_FLEET,
                        os.path.join(root, "fleet"),
                        (f"FleetConfig.max_train_steps = {_FLEET_CUT_STEPS}",))


def _check_fleet_main(run):
  """Phase 60's gates: those of every fleet phase, a publication every 50
  steps, the gin's roles."""
  result, held, seen, wall, model_dir = run
  _check_fleet("phase 60", result, held, seen, model_dir,
               {"host", "learner"}, steps=_FLEET_CUT_STEPS)
  publishes = _FLEET_CUT_STEPS // 50  # the gin's publish_every_steps
  if result["publishes"] != publishes or result["params_version"] != (
      publishes):
    raise AssertionError(f"phase 60: {result['publishes']} publishes, "
                         f"version {result['params_version']}; want "
                         f"{publishes}")
  if seen != {"host", "learner", "actor-0", "actor-1", "orchestrator"}:
    raise AssertionError(f"phase 60: roles {sorted(seen)}")


_ELASTIC_CRASH_AT = 125  # the learner's crash (phase 61), steps

# Phase 61's learner crash: a fault plan's `learner_crash` event, which
# fires in the learner's first incarnation only, registered for the gin
# through the binary's `--import_modules`. (`learner_crash_after_steps`
# fires in every incarnation, so under the resume policy it crash-loops
# until the restart budget trips.)
_ELASTIC_FAULTS_MODULE = "fleet_elastic_faults"
_ELASTIC_FAULTS_SOURCE = f"""\
from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.fleet import faults


@gin.configurable
def elastic_learner_crash(at={_ELASTIC_CRASH_AT}):
  return faults.FaultPlan(seed=0, events=(faults.FaultEvent(
      fault=faults.LEARNER_CRASH, target="learner", at=at, mode="raise"),))
"""


def _run_fleet_elastic(root):
  """Phase 61's run: `qtopt_fleet_elastic.gin` with an actor crash (mid
  episode, after 3 batches) and a learner crash (a fault plan's, after
  `_ELASTIC_CRASH_AT` steps)."""
  modules = os.path.join(root, "modules")
  os.makedirs(modules)
  with open(os.path.join(modules, f"{_ELASTIC_FAULTS_MODULE}.py"), "w") as f:
    f.write(_ELASTIC_FAULTS_SOURCE)
  return _run_fleet_gin(
      "phase 61 qtopt_fleet_elastic.gin", _GIN_FLEET_ELASTIC,
      os.path.join(root, "fleet_elastic"), (
          f"FleetConfig.max_train_steps = {_FLEET_CUT_STEPS}",
          "FleetConfig.actor_crash_after_episodes = 3",
          'FleetConfig.actor_crash_mode = "mid_episode"',
          "FleetConfig.fault_plan = @elastic_learner_crash()"),
      flags=("--import_modules", _ELASTIC_FAULTS_MODULE),
      python_path=(modules,))


def _check_fleet_elastic(run):
  """Phase 61's gates: one actor restart and one learner resume, each
  in `recoveries` with its MTTR; the resume from the checkpoint before
  the crash; the staged half-episode aborted."""
  result, held, seen, wall, model_dir = run
  metrics = _check_fleet("phase 61", result, held, seen, model_dir,
                         {"host", "learner"}, steps=_FLEET_CUT_STEPS)
  faults = sorted((r["fault"], r["target"]) for r in result["recoveries"])
  if faults != [("actor_crash", "actor-0"), ("learner_crash", "learner")]:
    raise AssertionError(f"phase 61: recoveries {result['recoveries']}")
  if not all(r["mttr_ms"] > 0 for r in result["recoveries"]):
    raise AssertionError(f"phase 61: recoveries {result['recoveries']}")
  if result["actor_restarts"] != 1 or result["learner_restarts"] != 1:
    raise AssertionError(f"phase 61: {result['actor_restarts']} actor "
                         f"restarts, {result['learner_restarts']} resumes")
  publish_every = 50  # the gin's FleetConfig.publish_every_steps
  restored = _ELASTIC_CRASH_AT // publish_every * publish_every
  resumes = metrics["learner_resumes"]
  if len(resumes) != 1 or resumes[0]["to_step"] != restored:
    raise AssertionError(f"phase 61: resumes {resumes}, expected one to "
                         f"step {restored}")
  if metrics["service"]["replay_aborted_episodes"] < 1:
    raise AssertionError("phase 61: the staged half-episode was not "
                         "aborted")
  _log(f"phase 61: the learner resumed {json.dumps(resumes)}; aborted "
       f"episodes {metrics['service']['replay_aborted_episodes']:.0f}, "
       f"actor restarts seen by the replay service "
       f"{metrics['service']['replay_actor_restarts']:.0f}")


_FRONT_FAULTS_MODULE = "fleet_front_faults"
# Phase 63: the rules that read the fronts' latency, and what each
# actuation changes in the fleet.
_LATENCY_RULES = ("front_p95_scale_up", "front_queue_scale_up",
                  "tenant_slo_retune", "overload_shed")


def _front_faults_source():
  """Phase 62's fault plan: the home front of tenant "policy" (the one
  its requests land on, by rendezvous hashing over fronts 0 and 1) dies
  at its `_FRONT_CRASH_AT`-th serve. The event is not recurring: it
  fires in the front's first incarnation only (the port's orchestrator
  hands a respawned front its incarnation; JAX's front replays the plan
  and crash-loops, ROADMAP Queue C)."""
  from tensor2robot_tpu_torch.replay.sampler import rendezvous_choose
  home = rendezvous_choose("policy", [0, 1])
  return f"""\
from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.fleet import faults


@gin.configurable
def replicated_front_crash(at={_FRONT_CRASH_AT}):
  return faults.FaultPlan(seed=0, events=(faults.FaultEvent(
      fault=faults.SERVING_REPLICA_CRASH, target="front-{home}", at=at,
      mode="hard", recurring=False),))
""", home


def _run_fleet_replicated(root):
  """Phase 62's run: `qtopt_serving_replicated.gin` (`qtopt_fleet_tcp.gin`
  plus two fronts with speculative CEM and the router's dedup cache)
  with robots on "policy" (one per actor of the gin, 10 Hz each, a
  router each), and one front crash from a fault plan."""
  modules = os.path.join(root, "modules")
  os.makedirs(modules)
  source, _ = _front_faults_source()
  with open(os.path.join(modules, f"{_FRONT_FAULTS_MODULE}.py"), "w") as f:
    f.write(source)
  return _run_fleet_gin(
      "phase 62 qtopt_serving_replicated.gin", _GIN_SERVING_REPLICATED,
      os.path.join(root, "fleet_replicated"), (
          f"FleetConfig.max_train_steps = {_FLEET_CUT_STEPS}",
          "FleetConfig.fault_plan = @replicated_front_crash()"),
      flags=("--import_modules", _FRONT_FAULTS_MODULE),
      python_path=(modules,), traffic=("--robots", "policy"))


def _traffic(model_dir):
  with open(os.path.join(model_dir, "traffic.json")) as f:
    return json.load(f)


def _log_traffic(label, seen, result):
  fronts = [r for r in result["recoveries"]
            if r["target"].startswith("front-")]
  _log(f"{label}: router {json.dumps(seen['router'])}; per tenant "
       f"{json.dumps(seen['tenants'])}; robots a tenant "
       f"{seen['robots_per_tenant']} at {seen['robot_tick_hz']} Hz; ramp "
       f"calibration {json.dumps(seen['calibration'])}, phases "
       f"{json.dumps(seen['ramp'])}; failover latency ms "
       f"{json.dumps(seen['failover_latency_ms'])}; fronts' time to ready "
       f"s at launch {json.dumps(seen.get('front_ready_secs_at_launch'))}, "
       f"at the end {json.dumps(seen['front_ready_secs'])}; front MTTR ms "
       f"{json.dumps([r['mttr_ms'] for r in fronts])}; membership "
       f"{json.dumps(seen['membership_events'])}")


def _check_router_traffic(label, seen, tenants, shed_ok=()):
  """Every routed request answered with finite actions, or (for the
  tenants in `shed_ok`) refused by a live replica's admission, or cut
  by the fleet's shutdown; none failed."""
  if seen["errors"]:
    raise AssertionError(f"{label}: traffic {seen['errors']}")
  for tenant in tenants:
    stats = seen["tenants"][tenant]
    if (stats["answered"] < 1 or stats["errors"] or stats["nonfinite"]
        or stats["answered"] + stats["shed"] + stats["cut"]
        != stats["offered"]
        or (stats["shed"] and tenant not in shed_ok)):
      raise AssertionError(f"{label}: tenant {tenant} {stats}")


def _check_fleet_replicated(run):
  """Phase 62's gates: those it had on `qtopt_fleet_tcp.gin` (the card
  held by the two hosts and the learner, and now the two fronts; both
  hosts serve the last publication; both shards served), every routed
  request answered with finite actions, at least one failover inside a
  call, the crashed front respawned (MTTR) and re-admitted by the
  router, each live front at the final version with the final
  checkpoint's params by digest, and at least one refined speculative
  answer (a frame sent again, by the next robot, within one
  publication)."""
  result, held, seen_roles, wall, model_dir = run
  steps = _FLEET_CUT_STEPS
  _, home = _front_faults_source()
  metrics = _check_fleet("phase 62", result, held, seen_roles, model_dir,
                         {"host", "host1", "learner", "front0", "front1"},
                         steps=steps)
  (replica,) = metrics["serving_replicas"]
  if (replica["params_version"] != metrics["params_version"]
      or replica["params_learner_step"] != steps
      or replica["served_params_sha256"] != metrics["served_params_sha256"]):
    raise AssertionError(
        f"phase 62: host1 serves version {replica['params_version']} "
        f"(step {replica['params_learner_step']}), the root "
        f"{metrics['params_version']}")
  shards = {s["shard_index"] for s in metrics["replay_shards"]}
  if shards != {0, 1} or {"shard0", "shard1"} - seen_roles:
    raise AssertionError(f"phase 62: shards {shards}, roles "
                         f"{sorted(seen_roles)}")
  seen = _traffic(model_dir)
  _log_traffic("phase 62", seen, result)
  _check_router_traffic("phase 62", seen, ("policy",))
  if seen["failover_latency_ms"]["n"] < 1 or seen["router"]["failovers"] < 1:
    raise AssertionError(f"phase 62: no failover inside a call: "
                         f"{seen['router']}")
  crashes = [r for r in result["recoveries"]
             if r["fault"] == "serving_replica_crash"]
  if ([r["target"] for r in crashes] != [f"front-{home}"]
      or crashes[0]["mttr_ms"] <= 0
      or {"event": "respawned", "index": home} not in [
          {k: e[k] for k in ("event", "index")}
          for e in seen["membership_events"]]
      or seen["router"]["alive"] != [0, 1]):
    raise AssertionError(f"phase 62: front {home} not respawned and "
                         f"re-admitted: {result['recoveries']}, "
                         f"{seen['membership_events']}, {seen['router']}")
  fronts = {f["front_index"]: f for f in metrics["front_hosts"]}
  for index, front in sorted(fronts.items()):
    if (front["params_version"] != steps
        or any(d != metrics["served_params_sha256"]
               for d in front["served_params_sha256"].values())):
      raise AssertionError(f"phase 62: front {index} serves version "
                           f"{front['params_version']}, not the step-"
                           f"{steps} checkpoint")
  if sorted(fronts) != [0, 1]:
    raise AssertionError(f"phase 62: fronts {sorted(fronts)} at the end")
  speculative = {i: f["speculative"] for i, f in fronts.items()}
  refined = sum(s["refined_served"] for by_tenant in speculative.values()
                for s in by_tenant.values())
  if refined < 1:
    raise AssertionError(f"phase 62: no refined speculative answer: "
                         f"{speculative}")
  _log(f"phase 62: both hosts and both fronts serve version "
       f"{metrics['params_version']} (learner step {steps}; the fronts' "
       f"tenants {sorted(fronts[0]['served_params_sha256'])}); broadcast "
       f"{json.dumps(metrics['broadcast'])} / host1 "
       f"{json.dumps(replica['broadcast'])} / fronts "
       f"{json.dumps({i: f['broadcast'] for i, f in fronts.items()})}; "
       f"speculative ({refined} refined answers) {json.dumps(speculative)}; "
       f"lag by hop {json.dumps(result['param_refresh_lag'].get('by_hop'))}")


def _run_fleet_autopilot(root):
  """Phase 63's run: `qtopt_fleet_autopilot.gin` (`qtopt_fleet_elastic
  .gin` plus TCP, a replay host, two fronts and the control plane over
  `fleet_rules`) with a calibrated ramp past one front's capacity on
  "policy" (the latency rules' tenant) and robots on "batch", the
  `_AUTOPILOT_STEPS` cut and a `_FLEET_POLL_S` poll."""
  return _run_fleet_gin(
      "phase 63 qtopt_fleet_autopilot.gin", _GIN_FLEET_AUTOPILOT,
      os.path.join(root, "fleet_autopilot"), (
          f"FleetConfig.max_train_steps = {_AUTOPILOT_STEPS}",
          f"FleetConfig.telemetry_poll_secs = {_FLEET_POLL_S}"),
      traffic=("--ramp", "policy", "--robots", "batch"))


def _check_fleet_autopilot(run):
  """Phase 63's gates: every decision record validates; the
  `replay.adds` rules saw the shard's counter climb (the replay twins on
  the card) and decided wherever the polled rate held their condition
  long enough; a latency rule actuated under the ramp's overload; each
  actuated decision's effect shows in the fleet (`scale_events`, the
  final actor and front counts, the shed tenant's refusals); at most
  `control_max_actions` (4) actuations in the run (shorter than the
  300 s budget window); no page where a rule remediates; every routed
  request answered or refused by a live front's admission, none failed;
  a clean shutdown, and the card held by the hosts, the learner and the
  fronts only."""
  from tensor2robot_tpu_torch.telemetry import flightrec
  from tensor2robot_tpu_torch.telemetry import sentinel as sentinel_lib
  result, held, seen_roles, wall, model_dir = run
  events = result["scale_events"]
  added = {f"front{e['index']}" for e in events
           if e["action"] == "add_front"}
  metrics = _check_fleet("phase 63", result, held, seen_roles, model_dir,
                         {"host", "learner", "front0", "front1"} | added,
                         steps=_AUTOPILOT_STEPS)
  seen = _traffic(model_dir)
  _log_traffic("phase 63", seen, result)
  _check_router_traffic("phase 63", seen, ("policy", "batch"),
                        shed_ok=("policy", "batch"))
  telemetry_dir = os.path.join(model_dir, "telemetry")
  decisions = _checked_records(  # each a valid envelope, or it raises
      os.path.join(telemetry_dir, "control_decisions.jsonl"))
  rules = [(next(iter(r["payload"])).split(".")[1], r) for r in decisions]
  outcomes = {}
  for rule, record in rules:
    outcome = int(record["payload"][f"control.{rule}.outcome"])
    outcomes.setdefault(rule, []).append(
        ("actuated", "would_act", "cooldown", "budget", "error")[outcome])
  with open(os.path.join(telemetry_dir, "fleet_metrics.jsonl")) as f:
    polls = [json.loads(line) for line in f if line.strip()]
  adds = [(p["wall"], p["payload"]["shard0/replay.adds"]) for p in polls
          if "shard0/replay.adds" in p["payload"]]
  rates = [round((b - a) / max(tb - ta, 1e-9), 2)
           for (ta, a), (tb, b) in zip(adds, adds[1:])]
  def worst(payload, suffix):
    return round(max((v for k, v in payload.items() if k.endswith(suffix)),
                     default=0.0), 2)

  p95s = [worst(p["payload"], "serving.policy.request_ms_p95")
          for p in polls]
  depths = [worst(p["payload"], "serving.policy.queue_depth")
            for p in polls]
  admitted = [(p["wall"], sum(v for k, v in p["payload"].items()
                              if k.endswith("serving.policy.admission."
                                            "admitted"))) for p in polls]
  admit_rates = [round((b - a) / max(tb - ta, 1e-9), 1)
                 for (ta, a), (tb, b) in zip(admitted, admitted[1:])]
  _log(f"phase 63: decisions by rule {json.dumps(outcomes)}; scale events "
       f"{json.dumps(events)}; shard0/replay.adds rows/s between polls "
       f"{json.dumps(rates)} ({len(polls)} polls, s after the first "
       f"{json.dumps([round(p['wall'] - polls[0]['wall'], 1) for p in polls])}); "
       f"the worst front's policy request_ms p95 by poll {json.dumps(p95s)}, "
       f"queue depth {json.dumps(depths)}; the fronts' admitted policy "
       f"rows/s between polls {json.dumps(admit_rates)}; final actors "
       f"{seen['num_actors']}, fronts {seen['num_fronts']}; control "
       f"{json.dumps(metrics.get('control'))}")
  if len(adds) < 3 or not all(r > 0 for r in rates):
    raise AssertionError(f"phase 63: shard0/replay.adds polled {adds}")
  # The actor rules read the same counter between polls (warmup 1, then
  # 3 breaching rates for the scale-down, 2 for the scale-up): where the
  # polled rates clearly held a rule's condition that long, the rule
  # must have decided. A margin of 25% keeps the rules' own clock (the
  # poll's monotonic stamp, not the record's wall) from mattering.
  band = (20.0, 200.0)  # the gin's fleet_rules env-steps band
  for rule, sustain, held in (
      ("actors_scale_down", 3, lambda r: r > 1.25 * band[1]),
      ("actors_scale_up", 2, lambda r: r < 0.8 * band[0])):
    due = any(all(held(r) for r in rates[i:i + sustain])
              for i in range(len(rates) - sustain + 1))
    if due and rule not in outcomes:
      raise AssertionError(f"phase 63: {rule}'s condition held over "
                           f"{sustain} polls (rates {rates}) and it never "
                           f"decided ({outcomes})")
  actuated = [rule for rule, record in rules
              if record["payload"][f"control.{rule}.actuated"] == 1.0]
  if len(actuated) > 4:
    raise AssertionError(f"phase 63: {len(actuated)} actuations > 4")
  if not set(actuated) & set(_LATENCY_RULES):
    raise AssertionError(f"phase 63: no latency rule actuated under the "
                         f"ramp (p95 by poll {p95s}; {outcomes})")
  effects = {
      "actors_scale_up": ("add", 1), "actors_scale_down": ("remove", -1),
      "front_p95_scale_up": ("add_front", 1),
      "front_queue_scale_up": ("add_front", 1)}
  actors, fronts = 2, 2
  for rule in actuated:
    if rule in effects:
      action, delta = effects[rule]
      if not any(e["action"] == action for e in events):
        raise AssertionError(f"phase 63: {rule} actuated, no {action} "
                             f"event in {events}")
      if action in ("add", "remove"):
        actors += delta
      else:
        fronts += delta
  if "overload_shed" in actuated and not seen["tenants"]["batch"]["shed"]:
    # The ladder sheds "batch" (control_shed_priorities) to 1 request/s
    # while its robots send 10 a second each.
    raise AssertionError(f"phase 63: overload_shed actuated and no batch "
                         f"request was refused: {seen['tenants']['batch']}")
  final_fronts = len(metrics.get("front_hosts") or ())
  if (seen["num_actors"], seen["num_fronts"], final_fronts) != (
      actors, fronts, fronts):
    raise AssertionError(
        f"phase 63: {seen['num_actors']} actors and {seen['num_fronts']} "
        f"fronts by the scale events, {final_fronts} fronts' final "
        f"metrics; the actuations make {actors} and {fronts}")
  bound = {"mfu_drop"}  # alerts a standing rule remediates
  for alert in sentinel_lib.read_alerts(
      os.path.join(telemetry_dir, sentinel_lib.ALERTS_FILENAME)):
    if alert.get("escalation") == "page" and alert["rule"] in bound:
      if "slow_host_respawn" not in outcomes:
        raise AssertionError(f"phase 63: paged {alert} without the "
                             f"controller's remediation attempt")
  pages = [d["reason"] for d in flightrec.read_dumps(
      flightrec.flightrec_dir(model_dir))
           if str(d.get("reason", "")).startswith("control page")]
  if pages:
    raise AssertionError(f"phase 63: control pages {pages}")


_GIN_FLEET_HYBRID = ("tensor2robot_tpu/research/qtopt/configs/"
                     "qtopt_fleet_hybrid.gin")
# Phase 64: the processes that hold the card (the serving hosts, both
# learner ranks and the pod); the actor and the shard hosts must not.
_HYBRID_CARD = {"host", "host1", "learner", "learner-r1", "pod-0"}
_HYBRID_SEGMENT = 32 * 4  # the gin's envs_per_pod × pod_rollout_length


def _run_fleet_hybrid(root):
  """Phase 64's run: `qtopt_fleet_hybrid.gin` (`qtopt_fleet_tcp.gin`'s
  hosts with a 2-process learner group and one Anakin pod beside one
  process actor), its 500 steps cut to `_FLEET_CUT_STEPS`."""
  return _run_fleet_gin(
      "phase 64 qtopt_fleet_hybrid.gin", _GIN_FLEET_HYBRID,
      os.path.join(root, "fleet_hybrid"),
      (f"FleetConfig.max_train_steps = {_FLEET_CUT_STEPS}",))


def _check_fleet_hybrid(run):
  """Phase 64's gates: those of every fleet phase with the card held by
  exactly the two serving hosts, both learner ranks and the pod; the
  gin's roles; only rank 0 publishes (`publishes == params_version`);
  both ranks end at the final checkpoint's params by digest (rank 0's
  `learner_group.json`), which the root host serves; the pod's env
  steps > 0 and the rows the shards accepted from it whole 128-row
  segments; `param_refresh_lag` rows from both collectors. Logs the group's learner steps/s, the pod's env steps/s
  and each role's ready time."""
  result, held, seen, wall, model_dir = run
  metrics = _check_fleet("phase 64", result, held, seen, model_dir,
                         _HYBRID_CARD, steps=_FLEET_CUT_STEPS)
  roles = _HYBRID_CARD | {"shard0", "shard1", "actor-0", "orchestrator"}
  if seen != roles:
    raise AssertionError(f"phase 64: roles {sorted(seen)}, want "
                         f"{sorted(roles)}")
  publishes = _FLEET_CUT_STEPS // 50  # the gin's publish_every_steps
  if result["publishes"] != publishes or result["params_version"] != (
      publishes):
    raise AssertionError(f"phase 64: {result['publishes']} publishes, "
                         f"version {result['params_version']}; want "
                         f"{publishes} (rank 0 alone publishes)")
  _, digests = _checkpoint_digests(model_dir)
  with open(os.path.join(model_dir, "learner_group.json")) as f:
    group = json.load(f)
  if group["world_size"] != 2 or group["rank_digests"] != [digests] * 2:
    raise AssertionError(f"phase 64: the ranks' final params differ from "
                         f"each other or from the checkpoint: world "
                         f"{group['world_size']}, equal to it "
                         f"{[d == digests for d in group['rank_digests']]}")
  pod = metrics["pushed_telemetry"]["pod-0"]["snapshot"]["counters"]
  env_steps = pod.get("fleet.pod.env_steps", 0)
  if env_steps <= 0:
    raise AssertionError(f"phase 64: the pod stepped {env_steps} envs")
  with open(os.path.join(model_dir, "telemetry", "fleet_metrics.jsonl")) as f:
    last = [json.loads(line) for line in f if line.strip()][-1]["payload"]
  # The rows the shards accepted, by collector: the replay side's count.
  lag_rows = {c: sum(v for k, v in last.items()
                     if k.endswith(f"fleet.param_refresh_lag_rows.{c}"))
              for c in ("actor-0", "pod-0")}
  if not all(lag_rows.values()):
    raise AssertionError(f"phase 64: param_refresh_lag rows by collector "
                         f"{lag_rows}")
  if lag_rows["pod-0"] % _HYBRID_SEGMENT:
    raise AssertionError(f"phase 64: the shards accepted "
                         f"{lag_rows['pod-0']} rows from the pod, not "
                         f"whole {_HYBRID_SEGMENT}-row segments")
  segments = collect_s = 0.0
  with open(os.path.join(model_dir, "telemetry", "trace_pod-0.jsonl")) as f:
    for line in f:
      span = json.loads(line)
      if span.get("name") == "pod.collect_segment":
        segments += 1
        collect_s += span["dur"]
  from tensor2robot_tpu_torch.telemetry.records import read_records
  # The group's `perf.mfu` over the one card both ranks share.
  mfu = read_records(os.path.join(model_dir, "metrics_train.jsonl"))[-1].get(
      "perf.mfu")
  _log(f"phase 64: learner group (2 ranks, 32 rows each, eager steps, "
       f"gloo through host memory) {result['learner_steps_per_sec']:.2f} "
       f"learner steps/s, perf.mfu {mfu}; pod {env_steps:.0f} env steps in "
       f"{segments:.0f} segments, {env_steps / max(collect_s, 1e-9):.1f} "
       f"env steps/s while collecting ({collect_s:.2f} s); lag rows by "
       f"collector {json.dumps(lag_rows)}; rank digests equal the "
       f"step-{group['step']} checkpoint")


# The group-parity phase: `qtopt_fleet_hybrid.gin`'s model and CEM.
_PARITY_MODEL = dict(image_size=32, action_dim=2, torso_filters=(16, 32),
                     head_filters=(32, 32), dense_sizes=(32, 32))
_PARITY_CEM = dict(cem_population=64, cem_iterations=2, cem_elites=6)
_PARITY_ROWS = 64


def _parity_step(role, address, dtype_names, batch, noise, state, out,
                 go, device="cuda"):
  """One Bellman step per dtype on `cuda:0` in a process of its own:
  `role` "reference" on the whole batch, or rank 0 / 1 of a gloo group
  on its half inside `collectives.data_parallel`. TF32 off. Puts (role,
  {dtype: (grads, params, batch stats, target, metrics)} as numpy, ms a
  step); the reference times its steps once `go` is set (the ranks
  timed theirs), alone on the card."""
  import torch

  from tensor2robot_tpu_torch.parallel import collectives, distributed
  from tensor2robot_tpu_torch.research.qtopt import (
      GraspingQModel,
      QTOptLearner,
  )
  from tensor2robot_tpu_torch.utils import checkpoints as ckpt_lib
  torch.backends.cudnn.allow_tf32 = False
  rows = slice(None)
  if role != "reference":
    if not distributed.maybe_initialize_distributed(address, 2, role):
      raise AssertionError(f"rank {role} joined no group")
    half = _PARITY_ROWS // 2
    rows = slice(role * half, (role + 1) * half)
  results = {}
  for name in dtype_names:
    learner = QTOptLearner(GraspingQModel(
        device_dtype=getattr(torch, name), **_PARITY_MODEL), device=device,
                           **_PARITY_CEM)
    start = ckpt_lib.unflatten_state(learner.create_state(seed=1), state)
    local = {k: torch.from_numpy(v[rows]).to(device)
             for k, v in batch.items()}
    with collectives.data_parallel():
      grads, stats, metrics = learner.train_grads(
          start, local, noise=noise[:, rows].to(device))
    new = learner.apply_gradients(start, grads, stats)
    host = lambda d: {k: v.detach().float().cpu().numpy()  # noqa: E731
                      for k, v in d.items()}
    results[name] = (host(grads), host(new.train_state.params),
                     host(new.train_state.batch_stats),
                     host(new.target_params), host(metrics))
  if role == "reference":
    go.wait(300)
  out.put((role, results, _parity_step_ms(learner, start, local, role,
                                          device)))
  if role != "reference":
    torch.distributed.destroy_process_group()


_PARITY_TIMED_STEPS = 20


def _parity_step_ms(learner, state, batch, role, device):
  """ms per Bellman step over `_PARITY_TIMED_STEPS` steps after one
  warm-up, the noise from a step generator: a rank's eager group step
  (the global draw, its rows), and the reference's eager and graphed
  (`StepGraph`, `train_qtopt`'s K = 1 dispatch) one-process steps."""
  import torch

  from tensor2robot_tpu_torch.parallel import collectives
  from tensor2robot_tpu_torch.research.qtopt.train_qtopt import (
      group_noise,
      k_step_fn,
      step_generator,
  )
  from tensor2robot_tpu_torch.utils.step_graph import StepGraph

  def timed(step):
    step(0)
    torch.cuda.synchronize() if device == "cuda" else None
    t0 = time.perf_counter()
    for i in range(1, _PARITY_TIMED_STEPS + 1):
      step(i)
    torch.cuda.synchronize() if device == "cuda" else None
    return round((time.perf_counter() - t0) * 1e3 / _PARITY_TIMED_STEPS, 3)

  if role != "reference":
    def group_step(i):
      with collectives.data_parallel():
        learner.train_step(state, batch, noise=group_noise(
            learner, step_generator(0, i, learner.device),
            _PARITY_ROWS // 2, role, 2))
    return {"group eager": timed(group_step)}
  graph = StepGraph(k_step_fn(learner, 1), state, batch, learner.device,
                    num_generators=1)

  def graphed(i):
    graph.generators[0].manual_seed(i)
    graph.replay(batch)

  return {"one process eager": timed(lambda i: learner.train_step(
      state, batch, generator=step_generator(0, i, learner.device))),
          "one process graphed": timed(graphed)}


def phase_learner_group_parity(device="cuda"):
  """Phase 65: two gloo ranks on `cuda:0` each take one Bellman step on
  32 of 64 seeded rows (`qtopt_fleet_hybrid.gin`'s model and CEM, the
  CEM noise injected, batch norm over the global batch, gradients
  averaged through host memory), against one process's step on the 64
  rows (each in a process of its own, TF32 off). f32 (the CPU tests'
  limits, `tests/test_torch_distributed.py`): the metrics to 1e-4
  relative, each gradient and new batch statistic to 1e-4 / 1e-5 of its
  leaf's largest |value|, the params 2e-6 (+ 1e-7) where |g| ≥ 1e-4 of
  the leaf's largest (2·lr below), the Polyak target τ times that +
  1e-7.
  bf16: each gradient's direction (cosine ≥ 0.99), the loss to 2e-2.
  The ranks equal each other bit for bit. Then the cost of the group's
  eager step: ms a bf16 step, the group's against one process's eager
  and graphed (`_parity_step_ms`)."""
  import multiprocessing as mp

  import numpy as np
  import torch

  from tensor2robot_tpu_torch.parallel.distributed import (
      ephemeral_coordinator_address,
  )
  from tensor2robot_tpu_torch.research.qtopt import (
      GraspingQModel,
      QTOptLearner,
  )
  from tensor2robot_tpu_torch.utils import checkpoints as ckpt_lib
  learner = QTOptLearner(GraspingQModel(**_PARITY_MODEL), device="cpu",
                         **_PARITY_CEM)
  batch = make_random_tensors_flat(learner.transition_specification(),
                                   _PARITY_ROWS, seed=64)
  noise = torch.randn((2, _PARITY_ROWS, 64, 2),
                      generator=torch.Generator().manual_seed(65))
  state = ckpt_lib.flatten_state(learner.create_state(seed=1))
  dtypes = ("float32", "bfloat16")
  ctx = mp.get_context("spawn")
  out = ctx.Queue()
  go = ctx.Event()
  address = ephemeral_coordinator_address()
  t0 = time.perf_counter()
  procs = [ctx.Process(target=_parity_step,
                       args=(role, address, dtypes, batch, noise, state, out,
                             go, device),
                       daemon=True) for role in ("reference", 0, 1)]
  for p in procs:
    p.start()
  got, step_ms = {}, {}
  try:
    for _ in procs:
      role, results, ms = out.get(timeout=300)
      got[role] = results
      step_ms[role] = ms
      if 0 in got and 1 in got:
        go.set()
  finally:
    for p in procs:
      p.join(timeout=60)
      if p.is_alive():
        p.kill()
        p.join()
  if [p.exitcode for p in procs] != [0, 0, 0]:
    raise AssertionError(f"phase 65: exit codes {[p.exitcode for p in procs]}")
  wall = time.perf_counter() - t0
  lr, tau = 1e-4, 0.05
  report = {}
  for name in dtypes:
    ref, r0, r1 = got["reference"][name], got[0][name], got[1][name]
    for a, b in zip(r0, r1):
      for k in a:
        if not np.array_equal(a[k], b[k]):
          raise AssertionError(f"phase 65 {name}: the ranks differ at {k}")
    grads, params, stats, target, metrics = r0
    w_grads, w_params, w_stats, w_target, w_metrics = ref
    scale = lambda x: max(float(np.abs(x).max()), 1e-12)  # noqa: E731
    if name == "bfloat16":
      cos = min(float(np.dot(grads[k].ravel(), w_grads[k].ravel())
                      / max(np.linalg.norm(grads[k]) * np.linalg.norm(
                          w_grads[k]), 1e-30)) for k in w_grads)
      loss_err = abs(metrics["loss"] - w_metrics["loss"]) / abs(
          w_metrics["loss"])
      report[name] = dict(min_grad_cosine=round(cos, 6),
                          loss_rel_err=float(loss_err))
      if cos < 0.99 or loss_err > 2e-2:
        raise AssertionError(f"phase 65 bf16: {report[name]}")
      continue
    metric_err = max(abs(float(metrics[k]) - float(w_metrics[k]))
                     / max(abs(float(w_metrics[k])), 1e-12)
                     for k in w_metrics)
    grad_err = max(float(np.abs(grads[k] - w_grads[k]).max())
                   / scale(w_grads[k]) for k in w_grads)
    stat_err = max(float(np.abs(stats[k] - w_stats[k]).max())
                   / scale(w_stats[k]) for k in w_stats)
    # (far, near) limits: where |g| ≥ 1e-4 of its leaf's largest, and
    # below it (Adam's first step normalizes each element, so summation
    # noise there can move it by up to 2·lr).
    limits = {"params": (2e-6 + 1e-7, 2 * lr + 1e-7),
              "target": (tau * 2e-6 + 1e-7, tau * 2 * lr + 1e-7)}
    errs = {"params": [0.0, 0.0], "target": [0.0, 0.0]}
    for k in w_params:
      small = np.abs(w_grads[k]) < 1e-4 * scale(w_grads[k])
      for what, got_p, want_p in (("params", params[k], w_params[k]),
                                  ("target", target[k], w_target[k])):
        diff = np.abs(got_p - want_p)
        errs[what][0] = max(errs[what][0],
                            float(diff[~small].max(initial=0.0)))
        errs[what][1] = max(errs[what][1],
                            float(diff[small].max(initial=0.0)))
    report[name] = dict(metric_rel_err=metric_err, grad_err=grad_err,
                        batch_stat_err=stat_err, param_err=errs)
    if (metric_err > 1e-4 or grad_err > 1e-4 or stat_err > 1e-5
        or any(e > lim for what in errs
               for e, lim in zip(errs[what], limits[what]))):
      raise AssertionError(f"phase 65 f32: {report[name]}")
  _log(f"phase 65: a 2-rank gloo group on cuda:0 (32 + 32 rows) against "
       f"one process on the 64 rows, one Bellman step at "
       f"qtopt_fleet_hybrid.gin's width, ranks equal bit for bit: "
       f"{json.dumps(report)} ({wall:.2f} s with the three processes' "
       f"start); bf16 ms a step over {_PARITY_TIMED_STEPS} (each rank "
       f"while the other steps, the reference alone) "
       f"{json.dumps({str(k): v for k, v in step_ms.items()})}")


def phase_gin_qtopt_fleets(beside=()):
  """Phases 60-63: the in-process learner at `qtopt_fleet.gin`'s widths
  alone (the yardstick), then the four fleets at once on the one card
  (each with its own authkey, ports and model dir), each held to its
  own gates, and `beside` ((name, callable) pairs: phase 58's probes and
  phase 34's cache contract) each on a thread of its own. Their rates
  and recovery times are taken side by side, under each other's
  load."""
  whole, median = _fleet_yardstick()
  _log(f"phase 60 yardstick: in-process train_qtopt at the gin's widths "
       f"(B=64, 500 steps, checkpoints every 50) {whole:.2f} steps/s over "
       f"the call, {median:.2f} grad steps/s (records' median past the "
       f"first)")
  import tempfile
  runs, errors = {}, {}

  def run(name, fn, root):
    try:
      runs[name] = fn(root)
    except BaseException as e:  # noqa: BLE001 — re-raised below
      errors[name] = e

  jobs = [("60", _run_fleet), ("61", _run_fleet_elastic),
          ("62", _run_fleet_replicated), ("63", _run_fleet_autopilot),
          ("64", _run_fleet_hybrid)]
  jobs += [(name, lambda root, fn=fn: fn()) for name, fn in beside]
  with tempfile.TemporaryDirectory(prefix="t2r_fleets_") as root:
    threads = [threading.Thread(target=run,
                                args=(name, fn, os.path.join(root, name)))
               for name, fn in jobs]
    for thread in threads:
      thread.start()
    for thread in threads:
      thread.join()
    for name in sorted(errors):
      raise AssertionError(f"phase {name} failed") from errors[name]
    _check_fleet_main(runs["60"])
    _check_fleet_elastic(runs["61"])
    _check_fleet_replicated(runs["62"])
    _check_fleet_autopilot(runs["63"])
    _check_fleet_hybrid(runs["64"])

_PHASE_S = {}


def _timed(phase, *args):
  """`phase(*args)`, its wall seconds kept under its name."""
  t0 = time.perf_counter()
  out = phase(*args)
  _PHASE_S[phase.__name__] = round(time.perf_counter() - t0, 2)
  return out


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

  max_err = _timed(phase_kernels)
  flash_err = _timed(phase_flash_kernels)
  launches, learner, state = _timed(phase_slice)
  flash_launches, context_policy = _timed(phase_gripper_slice)
  rows = _timed(phase_timings, learner, state)
  flash_rows, _ = _timed(phase_flash_timings, context_policy)
  bwd_errs = _timed(phase_flash_bwd_kernels)
  train_launches, train_model, train_state, gen = _timed(phase_train_slice)
  bwd_rows, _, _ = _timed(phase_train_timings, train_model, train_state,
                          gen)
  _timed(phase_default_model)
  head_err = _timed(phase_head_kernels)
  qt_launches, qt_learner, qt_state, replay = _timed(phase_qtopt_train)
  head_launches, _, target_net, encoded = _timed(
      phase_head_bellman, qt_learner, qt_state, replay)
  _timed(phase_qtopt_card_vs_cpu)
  head_rows, _, _, _ = _timed(phase_qtopt_timings, qt_learner, qt_state,
                               replay, target_net, encoded)
  _timed(phase_flash_padded)
  _timed(phase_bellman_graphs)
  _timed(phase_bellman_rate, replay)
  _timed(phase_bc_graphs)
  _timed(phase_serving_graphs)
  _timed(phase_context_graphs)
  online_err = _timed(phase_online_kernels)
  online_per_path, _ = _timed(phase_online_protocol)
  lax_replay = _timed(phase_lax_offline)
  _timed(phase_native_gather, lax_replay)
  del lax_replay
  seedcheck = _timed(phase_seedcheck)
  _timed(phase_actor_split)
  int8_err = _timed(phase_int8_kernels)
  _timed(phase_int8_card_vs_cpu)
  int8_launches = _timed(phase_int8_training)
  _timed(phase_int8_timings)
  plane_launches = _timed(phase_serving_plane)
  _timed(phase_gin_qtopt_int8)
  gin_fused_launches = _timed(phase_gin_qtopt_fused)
  _timed(phase_gin_pose_env)
  gin_serving_launches = _timed(phase_gin_serving)
  t_plane = time.perf_counter()
  _timed(phase_tfrecord_round_trip)
  t_gin = time.perf_counter()
  gin_vrgripper_launches = _timed(phase_gin_vrgripper_transformer)
  _log(f"phases 35-36 s: round trip and parse rates {t_gin - t_plane:.2f}, "
       f"gin vrgripper {time.perf_counter() - t_gin:.2f}; flash launches "
       f"on the gin's traced window {json.dumps(gin_vrgripper_launches)}")
  _timed(phase_capture_under_collection)
  _timed(phase_jpeg_digests)
  g2v_model, g2v_state = _timed(phase_gin_grasp2vec)
  goal_launches = _timed(phase_goal_qtopt, g2v_model, g2v_state)
  del g2v_model, g2v_state
  t_family = time.perf_counter()
  _timed(phase_gin_vrgripper_bc)
  _timed(phase_gin_vrgripper_meta)
  _timed(phase_gin_vrgripper_wtl)
  _log(f"phases 41-43 s (the VRGripper BC / meta / WTL gins): "
       f"{time.perf_counter() - t_family:.2f}")
  t_anakin = time.perf_counter()
  _timed(phase_envs_card_vs_cpu)
  anakin_err, _ = _timed(phase_anakin_select_kernels)
  anakin_launches = _timed(phase_gin_qtopt_anakin)
  _timed(phase_gin_qtopt_anakin_pod)
  _timed(phase_success_protocol, seedcheck)
  _log(f"phases 44-48 s (envs, Anakin, the success protocol): "
       f"{time.perf_counter() - t_anakin:.2f}")
  t_slice = time.perf_counter()
  _timed(phase_moe_card_vs_cpu)
  moe_launches = _timed(phase_gin_vrgripper_moe)
  _timed(phase_gin_qtopt_anakin_shardmap)
  shardmap_launches = _timed(phase_shardmap_is_the_single_program)
  _timed(phase_overlapped_is_serial)
  _log(f"phases 49-53 s (MoE, the shardmap gin, the overlapped startup): "
       f"{time.perf_counter() - t_slice:.2f}; flash launches on the MoE "
       f"gin's traced window {json.dumps(moe_launches)}")
  t_handoff = time.perf_counter()
  _timed(phase_flash_operator)
  handoff_model, handoff_state, handoff_launches = _timed(
      phase_export_handoff)
  _timed(phase_export_under_capture, handoff_model, handoff_state)
  del handoff_model, handoff_state
  _timed(phase_warm_start)
  cold_start_work = _timed(phase_cold_start_seeds)
  _timed(phase_profiler_trace)
  _log(f"phases 54-59 s (the model handoff; phase 58's probes run with "
       f"the fleets): {time.perf_counter() - t_handoff:.2f}; flash "
       f"launches in the loaded program {handoff_launches}")
  t_fleet = time.perf_counter()
  _timed(phase_gin_qtopt_fleets, (
      ("58", lambda: _timed(phase_cold_start, cold_start_work)),
      ("34", lambda: _timed(phase_gin_cache)),
      ("65", lambda: _timed(phase_learner_group_parity))))
  _log(f"phases 60-65 s (the fleet gins, phase 58's probes, phase 34's "
       f"cache contract and phase 65's group parity beside): "
       f"{time.perf_counter() - t_fleet:.2f}")
  _log(f"cem_select launches per path (each traced in its own run): CEM "
       f"serving {launches}, Bellman training {qt_launches}, online window "
       f"{sum(online_per_path.values())} ({json.dumps(online_per_path)}), "
       f"int8 Bellman training (fused) {int8_launches}, serving front window "
       f"{plane_launches['serving front window']}, speculative window "
       f"{plane_launches['speculative window']}, qtopt_int8.gin + fused "
       f"{gin_fused_launches}, serving_multitenant.gin window "
       f"{gin_serving_launches}, goal-conditioned Bellman training "
       f"(grasp2vec labels) {goal_launches}, qtopt_anakin.gin + fused "
       f"(3 iterations) {anakin_launches}, qtopt_anakin_shardmap.gin + "
       f"fused (3 iterations + warm-up) {shardmap_launches}")
  main_row = rows[8]  # the serving path's largest bucket
  head_row = head_rows[256]  # the Bellman target's shape
  flash_row = flash_rows[1]  # the context policy serves one robot
  kernels = [{
      "name": "cem_select",
      "route": "cuda",
      "source": "tensor2robot_tpu_torch/csrc/cem_select.cu",
      "replaces": "tensor2robot_tpu/ops/cem_select.py:181",
      "launches": launches,
      "max_abs_err": max(max_err, online_err, int8_err, anakin_err),
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
  _log(f"seconds per phase: {json.dumps(_PHASE_S)}")
  _log(f"total_s={time.perf_counter() - t_start}")
  _log(json.dumps({"kernels": kernels}))
  _log(smi)
  _log(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": kind,
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
