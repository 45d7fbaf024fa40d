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
from tensor2robot_tpu_torch.ops import cem_select  # noqa: E402
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


# ---- the dispatch rule (`launch_plan`) and the TMA rule, without a card ----

_BF16, _F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("shape,c2,widths,dtype,path,rows,channels", [
    ((4, 64, 8, 8, 64), 64, (64, 64, 64, 1), _BF16, "wgmma", 4, 64),
    ((256, 64, 8, 8, 64), 64, (64, 64, 64, 1), _BF16, "wgmma", 4, 64),
    ((4, 64, 8, 8, 32), 32, (32, 64, 1), _BF16, "wgmma", 4, 32),
    ((3, 30, 4, 16, 64), 32, (32, 48, 16, 1), _BF16, "wgmma", 4, 32),
    # mma_sync at 8×8×64 → 64: 2-member chunks, two CTAs to an SM.
    ((4, 64, 8, 8, 64), 64, (64, 1), _BF16, "mma_sync", 2, 64),  # no hidden
    ((4, 64, 8, 8, 64), 64, (64, 40, 1), _BF16, "mma_sync", 2, 64),
    ((4, 64, 6, 6, 64), 64, (64, 64, 1), _BF16, "mma_sync", 2, 64),
    ((3, 5, 6, 10, 6), 10, (10, 8, 1), _BF16, "mma_sync", 4, 10),
    ((4, 64, 8, 8, 128), 128, (128, 64, 64, 1), _BF16, "cuda_cores", 4, 16),
    ((4, 64, 8, 8, 64), 64, (64, 64, 64, 1), _F32, "cuda_cores", 4, 64),
    ((3, 5, 6, 10, 6), 10, (10, 8, 1), _F32, "cuda_cores", 4, 10),
], ids=lambda v: str(v))
def test_launch_plan_paths(shape, c2, widths, dtype, path, rows, channels):
  plan = cem_head.launch_plan(shape, c2, widths, dtype)
  assert (plan["path"], plan["rows"], plan["channels"]) == (path, rows,
                                                           channels)
  assert plan["tensor_cores"] == (path != "cuda_cores")
  assert plan["stages"] == (4 if path == "wgmma" else 0)
  assert plan["smem"] <= 232448


def test_launch_plan_wgmma_bytes():
  """The wgmma layout at the Bellman shape, by hand: taps 73,728 B;
  enc0 8,192; four 4-member stages 131,072 (the q-head's 17,168 laid
  over them); the pooled tile 8,192; BN 512; a zero row 16; five
  mbarriers 40, rounded up to 16; 1,024 of alignment."""
  plan = cem_head.launch_plan((256, 64, 8, 8, 64), 64, (64, 64, 64, 1),
                              _BF16)
  assert plan["stages"] == 4
  assert plan["smem"] == (73728 + 8192 + 131072 + 8192 + 512 + 16 + 48
                          + 1024)
  # A q-head larger than the conv's buffers pushes the pooled tile out.
  wide = cem_head.launch_plan((4, 64, 8, 8, 32), 32, (32, 256, 256, 1),
                              _BF16)
  assert wide["path"] == "wgmma"
  head_end = cem_select.qhead_smem((32, 256, 256, 1), 0)
  assert head_end > 18432 + 4096 + 4 * 16384  # taps, enc0, stages
  assert wide["smem"] == (-(-head_end // 1024) * 1024 + 4096 + 256 + 16
                          + 48 + 1024)


@pytest.mark.parametrize("shape,c2,widths,dtype,match", [
    ((4, 64, 8, 8, 64), 64, (64, 64, 1), torch.float16, "dtype"),
    ((4, 64, 8, 8, 64), 64, (64,) + (8,) * 8 + (1,), _BF16, "layers"),
    ((4, 64, 64, 64, 64), 64, (64, 64, 1), _F32, "227 KB"),
], ids=["fp16", "nine_layers", "no_plan_fits"])
def test_launch_plan_raises_before_building(shape, c2, widths, dtype, match,
                                            monkeypatch):
  monkeypatch.setattr(cem_head.build, "load",
                      lambda *a, **k: pytest.fail("built"))
  with pytest.raises(ValueError, match=match):
    cem_head.launch_plan(shape, c2, widths, dtype)
  b, p, h1, w1, c1 = shape
  dense = tuple((torch.zeros((i, o), dtype=dtype),
                 torch.zeros((o,), dtype=dtype))
                for i, o in zip(widths[:-1], widths[1:]))
  with pytest.raises(ValueError, match=match):
    cem_head._launch(torch.zeros(shape, dtype=dtype),
                     torch.zeros((b, h1, w1, c1), dtype=dtype),
                     torch.zeros((3, 3, c1, c2), dtype=dtype),
                     torch.ones(c2), torch.zeros(c2), dense)


def test_q_network_operands_meet_the_tma_rule():
  """`GraspingQModel()` at full width (bf16, on the CPU): the P-major
  merge GEMM output seen as `[B, P, ...]`, the view the Q-network hands
  over, takes the wgmma path without a copy."""
  model = GraspingQModel()
  network = model.bind(model.create_inference_state(seed=0, device="cpu"))
  rng = np.random.default_rng(5)
  image = torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 3), np.uint8))
  actions = torch.from_numpy(rng.uniform(-1, 1, (2, 64, 4)).astype(
      np.float32))
  with torch.no_grad():
    encoded = network.encode(image)
    pooled = network.pool_population(encoded, {}, actions)
    act_pm, enc0 = network._population_merge_parts(
        encoded, network._population_action_embed({}, actions))
  act = act_pm.transpose(0, 1)
  params = networks.head_tail_params(network)
  widths = [params[0].shape[-1]] + [w.shape[1] for w, _ in params[3]]
  plan = cem_head.launch_plan(tuple(act.shape), widths[0], widths, act.dtype)
  assert plan["path"] == "wgmma" and not act.is_contiguous()
  assert cem_head.meets_tma_rule(act)
  assert not cem_head.needs_dense_copy(act, plan)
  assert enc0.is_contiguous() and enc0.data_ptr() % 16 == 0
  assert tuple(pooled.shape) == (64, 2, widths[-3])


@pytest.mark.parametrize("make,copied", [
    (lambda a: a, False),
    (lambda a: a.transpose(0, 1).contiguous().transpose(0, 1), False),
    (lambda a: torch.cat([a, a[..., :1]], -1)[..., :-1], True),   # row 130 B
    (lambda a: torch.cat([a[..., :1], a], -1)[..., 1:], True),    # base + 2 B
    (lambda a: a.transpose(2, 3), True),                 # h1, w1 swapped
    (lambda a: a[:, :1].expand(a.shape), True),          # stride 0
], ids=["dense", "p_major", "row_stride", "base_offset", "hw_swapped",
        "broadcast"])
def test_bf16_views_outside_the_tma_rule_are_copied_not_refused(make,
                                                                copied):
  act = torch.zeros((2, 8, 8, 8, 64), dtype=_BF16)
  view = make(act)
  plan = cem_head.launch_plan(tuple(view.shape), 64, (64, 64, 1), _BF16)
  assert plan["path"] == "wgmma"
  assert cem_head.needs_dense_copy(view, plan) == copied
  # f32 never copies: its path reads any strides.
  f32 = view.float()
  assert not cem_head.needs_dense_copy(
      f32, cem_head.launch_plan(tuple(f32.shape), 64, (64, 64, 1), _F32))
