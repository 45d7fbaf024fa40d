"""Port's fused CEM head tail (plain version) against the JAX package.

The plain `fused_cem_head_tail_reference` (what the wrapper runs on a
CPU tensor; on the card `chip_smoke.py` holds the CUDA kernel against
it) is compared with the JAX `fused_cem_head_tail` in Pallas interpret
mode, on the same numpy-made inputs:

- `tests/test_cem_head.py`'s construction (B=4, P=64, 8×8×64 → 64,
  dense 64-64-1, bf16): atol/rtol 2e-3, that test's own bar against the
  XLA tail. Both sides round the same f32 values to bf16 at the same
  three places; only f32 summation order differs, which may tip a
  rounding to the other neighbour.
- a small f32 case (B=3, P=5, 4×4×8 → 16, dense 16-8-1, JAX
  `block_b=1`): 1e-5, the same f32 arithmetic in another order.

Then the plain tail on a real `GraspingQNetwork`'s merge parts against
the port's `score_population` (the unfused path) on the same actions:
f32 1e-5; bf16 2e-2 absolute on logits below ~2: the two round at
other places (the enc0 add in bf16 vs f32, the conv output before batch
norm), one bf16 step (2^-8 relative) on the pooled features.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tensor2robot_tpu.ops import cem_head as jax_cem_head  # noqa: E402
from tensor2robot_tpu_torch.ops import cem_head  # noqa: E402
from tensor2robot_tpu_torch.research.qtopt import networks  # noqa: E402
from tensor2robot_tpu_torch.research.qtopt.t2r_models import (  # noqa: E402
    GraspingQModel,
)


def _inputs(b, p, c, h, w, c1, c2, hidden, dtype, seed):
  """`tests/test_cem_head.py`'s construction as numpy (values exact in
  `dtype`): act from a merge GEMM of a1 [B, P, C] and v [C, h, w, C1]."""
  rng = np.random.default_rng(seed)
  jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32

  def f(*shape):
    return np.asarray(jnp.asarray(rng.standard_normal(shape) * 0.3, jdt)
                      .astype(jnp.float32))

  a1, enc0, v = f(b, p, c), f(b, h, w, c1), f(c, h, w, c1)
  ck = f(3, 3, c1, c2)
  bn_scale, bn_shift = f(c2), f(c2)
  widths = (c2,) + tuple(hidden) + (1,)
  dense = tuple((f(i, o), f(o)) for i, o in zip(widths[:-1], widths[1:]))
  act = np.asarray(jax.lax.dot_general(
      jnp.asarray(a1.reshape(b * p, c), jdt),
      jnp.asarray(v.reshape(c, -1), jdt), (((1,), (0,)), ((), ())),
      preferred_element_type=jdt).astype(jnp.float32)).reshape(
          b, p, h, w, c1)
  return act, enc0, ck, bn_scale, bn_shift, dense


def _jax(inputs, dtype, block_b):
  jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
  act, enc0, ck, scale, shift, dense = inputs
  cast = lambda x: jnp.asarray(x, jdt)  # noqa: E731
  return np.asarray(jax_cem_head.fused_cem_head_tail(
      cast(act), cast(enc0), cast(ck), jnp.asarray(scale),
      jnp.asarray(shift), tuple((cast(w), cast(b)) for w, b in dense),
      interpret=True, block_b=block_b))


def _torch(inputs, dtype):
  tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
  act, enc0, ck, scale, shift, dense = inputs
  cast = lambda x: torch.from_numpy(np.array(x)).to(tdt)  # noqa: E731
  return (cast(act), cast(enc0), cast(ck), torch.from_numpy(np.array(scale)),
          torch.from_numpy(np.array(shift)),
          tuple((cast(w), cast(b)) for w, b in dense))


@pytest.mark.parametrize("case", [
    dict(shape=(4, 64, 64, 8, 8, 64, 64, (64, 64)), dtype="bf16",
         block_b=2, tol=2e-3),
    dict(shape=(3, 5, 6, 4, 4, 8, 16, (8,)), dtype="f32", block_b=1,
         tol=1e-5),
], ids=["bench_verify_bf16", "small_f32"])
def test_plain_tail_matches_the_pallas_kernel(case):
  inputs = _inputs(*case["shape"], dtype=case["dtype"], seed=0)
  want = _jax(inputs, case["dtype"], case["block_b"])
  args = _torch(inputs, case["dtype"])
  got = cem_head.fused_cem_head_tail_reference(*args)
  assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
  np.testing.assert_allclose(got.numpy(), want, atol=case["tol"],
                             rtol=case["tol"])
  # The wrapper runs the plain version on a CPU tensor and counts no
  # launch.
  before = cem_head.fused_cem_head_tail.launches
  np.testing.assert_array_equal(
      cem_head.fused_cem_head_tail(*args).numpy(), got.numpy())
  assert cem_head.fused_cem_head_tail.launches == before


def test_strided_act_gives_the_same_q():
  """The Q-network hands over its P-major tensor as a transposed view."""
  act, *rest = _torch(_inputs(3, 5, 6, 4, 4, 8, 16, (8,), "bf16", seed=1),
                      "bf16")
  act_pm = act.transpose(0, 1).contiguous()
  view = act_pm.transpose(0, 1)
  assert not view.is_contiguous()
  np.testing.assert_array_equal(
      cem_head.fused_cem_head_tail(view, *rest).numpy(),
      cem_head.fused_cem_head_tail(act, *rest).numpy())


def test_odd_spatial_dims_raise_on_both_sides():
  inputs = list(_inputs(2, 3, 4, 4, 4, 8, 8, (8,), "f32", seed=2))
  inputs[0] = inputs[0][:, :, :3]
  inputs[1] = inputs[1][:, :3]
  message = r"head conv input spatial dims must be even; got \(3, 4\)"
  with pytest.raises(ValueError, match=message):
    _jax(inputs, "f32", block_b=1)
  with pytest.raises(ValueError, match=message):
    cem_head.fused_cem_head_tail(*_torch(inputs, "f32"))


def test_shape_mismatches_raise():
  args = list(_torch(_inputs(2, 3, 4, 4, 4, 8, 8, (8,), "f32", seed=3),
                     "f32"))
  with pytest.raises(ValueError, match="enc0"):
    cem_head.fused_cem_head_tail(args[0], args[1][:1], *args[2:])
  dense = ((args[5][0][0], args[5][0][1]),)  # ends at width 8
  with pytest.raises(ValueError, match="width 1"):
    cem_head.fused_cem_head_tail(*args[:5], dense)


# ---- on the Q-network's own merge parts ----

_TINY = dict(image_size=16, torso_filters=(8,), head_filters=(8, 16),
             dense_sizes=(16,), action_dim=3)


def _network(dtype, seed=0):
  """A bound tiny network with batch-norm params and statistics moved
  away from their init, so the BN affine is exercised."""
  model = GraspingQModel(device_dtype=dtype, **_TINY)
  state = model.create_inference_state(seed=seed, device="cpu")
  rng = np.random.default_rng(seed)
  for key, t in {**state.params, **state.batch_stats}.items():
    if "_bn_" in key:
      lo, hi = {"scale": (0.5, 1.5), "bias": (-0.3, 0.3),
                "mean": (-0.3, 0.3), "var": (0.5, 2.0)}[key.split(".")[-1]]
      t.copy_(torch.from_numpy(rng.uniform(lo, hi, t.shape).astype(
          np.float32)))
  return model.bind(state)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
def test_tail_on_merge_parts_matches_score_population(dtype, atol):
  network = _network(dtype)
  rng = np.random.default_rng(4)
  image = torch.from_numpy(rng.integers(0, 256, (3, 16, 16, 3), np.uint8))
  actions = torch.from_numpy(rng.uniform(-1, 1, (3, 6, 3)).astype(
      np.float32))
  with torch.no_grad():
    encoded = network.encode(image)
    want = network.score_population(encoded, {}, actions)
    act_pm, enc0 = network._population_merge_parts(
        encoded, network._population_action_embed({}, actions))
    # The merged tensor is relu(act + enc0) of these parts.
    np.testing.assert_array_equal(
        network._population_merge(
            encoded, network._population_action_embed({}, actions)
        ).float().numpy(),
        torch.relu(act_pm + enc0).reshape((18,) + act_pm.shape[2:])
        .float().numpy())
    got = cem_head.fused_cem_head_tail(
        act_pm.transpose(0, 1), enc0, *networks.head_tail_params(network))
  assert tuple(got.shape) == (3, 6)
  assert float(want.abs().max()) < 2.0
  np.testing.assert_allclose(got.numpy(), want.numpy(), atol=atol, rtol=0)


def test_head_tail_params_need_batch_norm_and_two_head_convs():
  model = GraspingQModel(device_dtype=torch.float32,
                         **dict(_TINY, head_filters=(8,)))
  network = model.bind(model.create_inference_state(device="cpu"))
  with pytest.raises(ValueError, match="exactly two head convs"):
    networks.head_tail_params(network)
