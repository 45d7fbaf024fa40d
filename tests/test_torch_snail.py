"""The port's SNAIL blocks (`layers/snail.py`) against the JAX package's.

Small size: 2 sequences of T=12 steps, 8 input channels, 4 filters a
dense block, key 16, value 8; the TC blocks at T=12 run dilations 1, 2,
4 and 8. flax params are converted (`models/convert.py`: the 1D conv
kernel [k, in, out] → [out, in, k]) and the same numpy inputs go through
both packages.

Tolerances. f32: 1e-5 of the largest magnitude of each output, and of
the largest magnitude over all gradient leaves for each leaf (the same
f32 math in other summation orders; the key projection's bias has a
gradient of exactly zero, softmax being blind to a per-query constant,
so both packages give rounding noise there). bf16:
cosine ≥ 0.99 against JAX's bf16 for outputs and gradients, and the
attention's casts are pinned bit for bit against the order they are
specified in (logits in bf16, f32 for the −1e30 mask and the softmax,
weights back to bf16 before `@ V`).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tensor2robot_tpu.layers import snail as jax_snail  # noqa: E402
from tensor2robot_tpu_torch.layers import snail  # noqa: E402
from tensor2robot_tpu_torch.models import convert  # noqa: E402

_B, _T, _C = 2, 12, 8
_SMALL = dict(filters=4, key_size=16, value_size=8, output_size=5)


def _np(x):
  if isinstance(x, torch.Tensor):
    return x.detach().float().numpy()
  return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol=1e-5, what="", scale=None):
  got, want = _np(got), _np(want)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  scale = float(np.abs(want).max()) if scale is None else scale
  np.testing.assert_allclose(got, want, atol=tol * max(1e-12, scale),
                             rtol=0, err_msg=what)


def _cosine(a, b):
  a, b = _np(a).ravel(), _np(b).ravel()
  return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _port(module, params):
  module.load_state_dict(convert.convert_params(params), strict=True)
  return module


@pytest.fixture(scope="module")
def inputs():
  rng = np.random.default_rng(0)
  return (rng.normal(size=(_B, _T, _C)).astype(np.float32),
          rng.normal(size=(_B, _T, 5)).astype(np.float32))


@pytest.fixture(scope="module")
def trunk(inputs):
  """flax params of a SNAIL trunk and its f32 and bf16 outputs and
  gradients (params and input) of sum(out · w)."""
  x, w = inputs
  params = jax.jit(jax_snail.SNAIL(seq_len=_T, **_SMALL).init)(
      jax.random.PRNGKey(1), x)["params"]
  params = jax.tree_util.tree_map(np.asarray, params)
  out = {}
  for name, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
    module = jax_snail.SNAIL(seq_len=_T, dtype=dtype, **_SMALL)

    def loss(p, x, module=module):
      y = module.apply({"params": p}, x)
      return jnp.sum(y * w), y

    (_, y), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                               has_aux=True))(params, x)
    out[name] = (y, convert.convert_params(
        jax.tree_util.tree_map(np.asarray, grads[0])), grads[1])
  return params, out


def _port_trunk(params, dtype):
  return _port(snail.SNAIL(_C, seq_len=_T, dtype=dtype, **_SMALL), params)


def _port_grads(module, x, w):
  x = torch.from_numpy(x).requires_grad_()
  y = module(x)
  torch.sum(y * torch.from_numpy(w)).backward()
  return y, {n: p.grad for n, p in module.named_parameters()}, x.grad


def test_tc_block_at_twelve_steps_runs_dilations_to_eight(trunk):
  params, _ = trunk
  assert sorted(params["tc_0"]) == [f"dense_{i}" for i in range(4)]
  port = _port_trunk(params, torch.float32)
  assert [getattr(port.tc_0, f"dense_{i}").filter.dilation
          for i in range(4)] == [1, 2, 4, 8]


def test_trunk_forward_and_gradients_match_jax_f32(trunk, inputs):
  params, out = trunk
  want_y, want_g, want_x = out["f32"]
  y, grads, gx = _port_grads(_port_trunk(params, torch.float32), *inputs)
  assert y.dtype == torch.float32
  _close(y, want_y, what="output")
  _close(gx, want_x, what="d input")
  assert set(grads) == set(want_g)
  scale = max(float(np.abs(_np(g)).max()) for g in want_g.values())
  for name, g in grads.items():
    _close(g, want_g[name], what=name, scale=scale)


def test_trunk_forward_and_gradients_match_jax_bf16(trunk, inputs):
  params, out = trunk
  want_y, want_g, want_x = out["bf16"]
  y, grads, gx = _port_grads(_port_trunk(params, torch.bfloat16), *inputs)
  assert y.dtype == torch.float32
  assert _cosine(y, want_y) >= 0.99
  assert _cosine(gx, want_x) >= 0.99
  flat = lambda g: np.concatenate([_np(g[n]).ravel()  # noqa: E731
                                   for n in sorted(g)])
  assert _cosine(flat(grads), flat(want_g)) >= 0.99


@pytest.mark.parametrize("dilation", [1, 4])
def test_causal_conv_pads_left_and_transposes_the_kernel(inputs, dilation):
  """[k, in, out] flax kernel → [out, in, k]; the output at step t sees
  only steps ≤ t (the left pad is dilation · (k − 1))."""
  x, _ = inputs
  module = jax_snail.CausalConv1D(6, dilation=dilation)
  params = jax.tree_util.tree_map(
      np.asarray, module.init(jax.random.PRNGKey(2), x)["params"])
  assert params["Conv_0"]["kernel"].shape == (2, _C, 6)
  port = _port(snail.CausalConv1D(_C, 6, dilation=dilation), params)
  assert tuple(port.Conv_0.weight.shape) == (6, _C, 2)
  got = port(torch.from_numpy(x))
  _close(got, module.apply({"params": params}, x))
  changed = x.copy()
  changed[:, 7] += 1.0
  moved = _np(port(torch.from_numpy(changed))) != _np(got)
  assert not moved[:, :7].any() and moved[:, 7].all()
  assert moved[:, 7 + dilation].any()


def test_attention_block_matches_jax_and_is_causal(inputs):
  x, _ = inputs
  module = jax_snail.AttentionBlock(16, 8)
  params = jax.tree_util.tree_map(
      np.asarray, module.init(jax.random.PRNGKey(3), x)["params"])
  port = _port(snail.AttentionBlock(_C, 16, 8), params)
  got = port(torch.from_numpy(x))
  assert got.shape == (_B, _T, _C + 8)
  _close(got, module.apply({"params": params}, x))
  changed = x.copy()
  changed[:, 5] += 1.0
  moved = _np(port(torch.from_numpy(changed))) != _np(got)
  assert not moved[:, :5].any() and moved[:, 5:].any()


def test_attention_casts_and_mask_sit_where_specified(inputs):
  """bf16: the port's block equals, bit for bit, the specified order of
  casts and the −1e30 mask, and JAX's block by cosine."""
  x, _ = inputs
  assert snail._MASK_VALUE == -1e30
  module = jax_snail.AttentionBlock(16, 8, dtype=jnp.bfloat16)
  params = jax.tree_util.tree_map(
      np.asarray, module.init(jax.random.PRNGKey(3), x)["params"])
  port = _port(snail.AttentionBlock(_C, 16, 8, dtype=torch.bfloat16),
               params)
  xt = torch.from_numpy(x)
  got = port(xt)
  assert got.dtype == torch.float32  # the concat promotes to x's f32
  proj = lambda lin: (xt.bfloat16() @ lin.weight.bfloat16().t()  # noqa
                      + lin.bias.bfloat16())
  q, k, v = proj(port.query), proj(port.key), proj(port.value)
  logits = (q @ k.transpose(1, 2)) / math.sqrt(16)
  assert logits.dtype == torch.bfloat16
  mask = torch.ones(_T, _T, dtype=torch.bool).tril()
  weights = torch.softmax(
      logits.float().masked_fill(~mask, -1e30), dim=-1).bfloat16()
  want = torch.cat([xt, (weights @ v).float()], dim=-1)
  np.testing.assert_array_equal(_np(got), _np(want))
  assert _cosine(got, module.apply({"params": params}, x)) >= 0.99
