"""The port's train-step FLOPs count against the JAX package's, on the
CPU, for the same small models.

The JAX generic trainer's `perf.mfu` divides XLA's cost analysis of the
compiled train step (`utils.profiling.compiled_flops_per_call`); the
port counts one eager step with `torch.utils.flop_counter`'s formulas
and each causal attention call analytically
(`tensor2robot_tpu_torch.utils.profiling.train_step_flops`). This
prints, per model, both counts and their ratio (port / JAX): a
cross-check of the port's count, not a gate. XLA also counts the
elementwise work (activations, the optimizer update) and the reference
attention's full T × T products, which the port's count leaves out or
halves.

    JAX_PLATFORMS=cpu python scripts/flops_crosscheck.py

Prints one JSON object on the last line.
"""

from __future__ import annotations

import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from tensor2robot_tpu.data import Mode as JaxMode  # noqa: E402
from tensor2robot_tpu.specs import make_random_tensors  # noqa: E402
from tensor2robot_tpu.utils import profiling as jax_profiling  # noqa: E402
from tensor2robot_tpu_torch import train_eval  # noqa: E402
from tensor2robot_tpu_torch.utils import profiling  # noqa: E402

_SMALL = dict(image_size=24, filters=(8, 16), embedding_size=32, width=48,
              depth=2, num_heads=2, max_context_length=16)


def _models():
  """(name, JAX model, port model, batch size, sequence length)."""
  from tensor2robot_tpu.research.vrgripper import (
      VRGripperTransformerModel as JaxTransformer,
  )
  from tensor2robot_tpu.utils.mocks import MockT2RModel as JaxMock
  from tensor2robot_tpu_torch.research.vrgripper import (
      VRGripperTransformerModel,
  )
  from tensor2robot_tpu_torch.utils.mocks import MockT2RModel
  yield "MockT2RModel", JaxMock(), MockT2RModel(), 16, None
  for name, extra in (("VRGripperTransformerModel", {}),
                      ("VRGripperTransformerModel(moe_experts=8)",
                       dict(moe_experts=8, moe_every=2))):
    yield (name,
           JaxTransformer(attention_impl="reference", **_SMALL, **extra),
           VRGripperTransformerModel(attention_impl="reference", **_SMALL,
                                     **extra), 4, 16)


def _batch(jax_model, batch_size, sequence_length):
  """One JAX batch of the model's specs (numpy leaves)."""
  features = make_random_tensors(
      jax_model.get_feature_specification(JaxMode.TRAIN),
      batch_size=batch_size, seed=0, sequence_length=sequence_length)
  labels = make_random_tensors(
      jax_model.get_label_specification(JaxMode.TRAIN),
      batch_size=batch_size, seed=1, sequence_length=sequence_length)
  return features, labels


def main() -> int:
  rows = {}
  for name, jax_model, port_model, batch_size, seq in _models():
    features, labels = _batch(jax_model, batch_size, seq)
    state = jax.jit(jax_model.create_train_state)(jax.random.PRNGKey(0))
    as_jax = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)  # noqa: E731
    compiled = jax.jit(jax_model.train_step).lower(
        state, as_jax(features), as_jax(labels),
        jax.random.PRNGKey(1)).compile()
    want = jax_profiling.compiled_flops_per_call(compiled)
    flat = lambda s: {k: torch.from_numpy(np.asarray(v))  # noqa: E731
                      for k, v in s.to_flat_dict().items()}
    got = profiling.train_step_flops(
        train_eval.train_step_fn(port_model),
        port_model.create_train_state(0, device="cpu"),
        {"features": flat(features), "labels": flat(labels)}, ())
    rows[name] = {"port_flops": got, "jax_xla_flops": want,
                  "ratio": got / want if got and want else None}
    print(f"{name}: {json.dumps(rows[name])}", flush=True)
  print(json.dumps({"flops_crosscheck": rows}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
