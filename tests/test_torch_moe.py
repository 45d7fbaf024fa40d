"""The port's single-device MoE layer against the JAX package's
(`parallel/moe.py`), mirroring `tests/test_moe.py`'s single-device
cases.

  * `expert_capacity` equals the JAX function; `top_k_routing` at k = 1
    and 2 gives the same dispatch tensor exactly (0/1 sums), and the
    combine weights and the aux loss within 1e-6 (f32 softmax, means and
    divisions in other summation orders), ties and dropped tokens
    included; the aux loss is 1 at balance.
  * `moe_mlp` and `MoEMLP` on converted params: f32 within 1e-5
    relative; bf16 within 2e-2 of max |y| (both packages round each
    einsum's output to bf16, at different places inside the product).
  * The MoE transformer trunk: MoE on exactly the blocks JAX puts it on;
    the loss and its gradients against `jax.grad` (f32: 1e-4 of each
    gradient's largest element; bf16: cosine ≥ 0.99).
  * Flax's `lecun_normal` on the 3-D expert stack counts the expert axis
    into the fan-in: the port's init std within 5% of JAX's.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tensor2robot_tpu.layers.transformer import (  # noqa: E402
    CausalTransformer as JaxTrunk,
)
from tensor2robot_tpu.parallel import moe as jax_moe  # noqa: E402
from tensor2robot_tpu_torch.layers.transformer import (  # noqa: E402
    CausalTransformer,
)
from tensor2robot_tpu_torch.models import convert  # noqa: E402
from tensor2robot_tpu_torch.models.abstract_model import (  # noqa: E402
    init_parameters,
)
from tensor2robot_tpu_torch.parallel import moe  # noqa: E402
from tensor2robot_tpu_torch.parallel.rules import MeshShape  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
  """One intra-op thread: the tensors are small, and the test workers
  share the host's cores."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _np(x):
  if isinstance(x, torch.Tensor):
    return x.detach().float().numpy()
  return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _params(seed, model_dim, num_experts, hidden):
  r = np.random.default_rng(seed)
  return dict(
      router=r.standard_normal((model_dim, num_experts)).astype(np.float32),
      w_in=(r.standard_normal((num_experts, model_dim, hidden)) * 0.1
            ).astype(np.float32),
      b_in=(r.standard_normal((num_experts, hidden)) * 0.1
            ).astype(np.float32),
      w_out=(r.standard_normal((num_experts, hidden, model_dim)) * 0.1
             ).astype(np.float32),
      b_out=(r.standard_normal((num_experts, model_dim)) * 0.1
             ).astype(np.float32),
  )


@pytest.mark.parametrize("n,e,k,cf", [
    (64, 4, 2, 1.0), (64, 4, 2, 2.0), (2, 8, 1, 1.0), (512, 8, 2, 2.0),
    (37, 5, 2, 1.25), (7, 3, 1, 0.1)])
def test_expert_capacity_matches_jax(n, e, k, cf):
  assert moe.expert_capacity(n, e, k, cf) == jax_moe.expert_capacity(
      n, e, k, cf)


def _routing_cases():
  rng = np.random.default_rng(0)
  return {
      "random": rng.standard_normal((24, 6)).astype(np.float32),
      # Equal logits: every choice is a tie, decided by the lower expert.
      "ties": np.zeros((10, 4), np.float32),
      # Exact ties between two experts on half the tokens.
      "pair_ties": np.tile(np.array([[1.0, 1.0, 0.0, -1.0]], np.float32),
                           (8, 1)),
      # One expert everybody prefers, past its capacity.
      "overflow": np.tile(np.array([[9.0, 1.0, 0.5]], np.float32), (12, 1)),
  }


_jit_routing = functools.lru_cache(maxsize=None)(
    lambda capacity, k: jax.jit(functools.partial(
        jax_moe.top_k_routing, capacity=capacity, k=k)))


@pytest.mark.parametrize("case", sorted(_routing_cases()))
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("capacity", [2, 5])
def test_top_k_routing_matches_jax(case, k, capacity):
  logits = _routing_cases()[case]
  want = _jit_routing(capacity, k)(jnp.asarray(logits))
  got = moe.top_k_routing(torch.from_numpy(logits), capacity, k)
  np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
  np.testing.assert_allclose(_np(got[1]), _np(want[1]), atol=1e-6, rtol=0)
  np.testing.assert_allclose(_np(got[2]), _np(want[2]), atol=1e-6, rtol=0)
  if case == "overflow":  # the preferred expert's slots ran out
    assert _np(got[0])[:, 0].sum() == capacity


def test_routing_ties_go_to_the_lower_expert():
  dispatch, combine, _ = moe.top_k_routing(torch.zeros(3, 4), 8, 2)
  occupied = dispatch.sum(dim=2)
  assert occupied[:, :2].eq(1).all() and occupied[:, 2:].eq(0).all()
  # Token n takes slot n of both experts.
  assert dispatch[2, 0, 2] == 1 and dispatch[2, 1, 2] == 1
  assert torch.allclose(combine.sum(dim=(1, 2)), torch.ones(3))


def test_aux_loss_is_one_at_perfect_balance():
  n, e = 8, 4
  logits = torch.eye(e)[torch.arange(n) % e] * 5.0
  _, _, aux = moe.top_k_routing(logits, 4, 1)
  assert float(aux) == pytest.approx(1.0, abs=1e-5)


def test_dropped_tokens_output_zero():
  p = {k: torch.from_numpy(v) for k, v in _params(0, 4, 1, 8).items()}
  p["b_in"].zero_()
  p["b_out"].zero_()
  out, _ = moe.moe_mlp(torch.ones(4, 4), **p, k=1, capacity_factor=0.25)
  assert out[0].abs().sum() > 0
  assert out[1:].eq(0).all()


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("cf", [0.5, 2.0])
def test_moe_mlp_matches_jax_f32(k, cf):
  p = _params(1, 16, 8, 32)
  x = np.random.default_rng(2).standard_normal((48, 16)).astype(np.float32)
  want_out, want_aux = jax.jit(functools.partial(
      jax_moe.moe_mlp, k=k, capacity_factor=cf))(
          jnp.asarray(x), **{n: jnp.asarray(v) for n, v in p.items()})
  out, aux = moe.moe_mlp(torch.from_numpy(x),
                         **{n: torch.from_numpy(v) for n, v in p.items()},
                         k=k, capacity_factor=cf)
  np.testing.assert_allclose(_np(out), _np(want_out), rtol=1e-5, atol=1e-6)
  np.testing.assert_allclose(_np(aux), _np(want_aux), atol=1e-6, rtol=0)


def _jax_module_variables(module, x):
  variables = jax.jit(module.init)(jax.random.PRNGKey(0), x)
  return jax.tree_util.tree_map(np.asarray, dict(variables))


@pytest.mark.parametrize("dtypes", [(jnp.float32, torch.float32),
                                    (jnp.bfloat16, torch.bfloat16)],
                         ids=["f32", "bf16"])
def test_moe_module_matches_jax(dtypes):
  jdt, tdt = dtypes
  x = np.random.default_rng(3).standard_normal((2, 12, 16)).astype(
      np.float32)
  jax_module = jax_moe.MoEMLP(num_experts=4, hidden_dim=64, k=2,
                              capacity_factor=2.0, dtype=jdt)
  variables = _jax_module_variables(jax_module, jnp.asarray(x))
  want, sown = jax.jit(functools.partial(jax_module.apply,
                                         mutable=["aux_loss"]))(
      {"params": variables["params"]}, jnp.asarray(x))
  module = moe.MoEMLP(16, 4, 64, k=2, capacity_factor=2.0, dtype=tdt)
  module.load_state_dict(convert.convert_params(variables["params"]),
                         strict=True)
  with torch.no_grad():
    got, aux = module(torch.from_numpy(x))
  assert got.dtype == tdt
  scale = float(np.abs(_np(want)).max())
  if tdt == torch.float32:
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                               atol=1e-6 * scale)
  else:
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=2e-2 * scale)
  np.testing.assert_allclose(
      _np(aux), _np(jax_moe.collect_aux_losses(sown)), atol=1e-6, rtol=0)


def test_expert_parallelism_raises_naming_a11():
  with pytest.raises(NotImplementedError, match="A11"):
    moe.MoEMLP(16, 4, 64, mesh=MeshShape({"data": 1, "expert": 2}))
  # A one-wide expert axis is the dense path, as in JAX.
  moe.MoEMLP(16, 4, 64, mesh=MeshShape({"expert": 1}))


def test_collect_aux_losses_of_nothing_is_zero():
  assert float(moe.collect_aux_losses([])) == 0.0
  assert float(moe.collect_aux_losses([None])) == 0.0
  assert float(jax_moe.collect_aux_losses({})) == 0.0
  total = moe.collect_aux_losses([torch.tensor(1.5), None,
                                  torch.tensor(2.0)])
  assert float(total) == 3.5


@pytest.mark.parametrize("depth,every", [(4, 2), (3, 1), (5, 3), (2, 0)])
def test_moe_blocks_sit_where_jax_puts_them(depth, every):
  x = jnp.ones((1, 4, 8), jnp.float32)
  jax_trunk = JaxTrunk(width=16, depth=depth, num_heads=2, max_len=4,
                       dtype=jnp.float32, moe_experts=4, moe_every=every)
  shapes = jax.eval_shape(jax_trunk.init, jax.random.PRNGKey(0), x)
  want = set(convert.convert_params(jax.tree_util.tree_map(
      lambda s: np.zeros(s.shape, np.float32), shapes["params"])))
  trunk = CausalTransformer(8, width=16, depth=depth, num_heads=2,
                            max_len=4, dtype=torch.float32, moe_experts=4,
                            moe_every=every)
  assert set(trunk.state_dict()) == want


def test_dense_trunk_returns_no_aux():
  trunk = CausalTransformer(8, width=16, depth=2, num_heads=2, max_len=4,
                            dtype=torch.float32)
  out, aux = trunk(torch.ones(1, 4, 8), return_aux=True)
  assert out.shape == (1, 4, 16) and aux is None


_TRUNK = dict(width=16, depth=4, num_heads=2, max_len=8, moe_experts=4,
              moe_every=2)


@functools.lru_cache(maxsize=None)
def _jax_trunk_grads(jdt):
  trunk = JaxTrunk(dtype=jdt, attention_impl="reference", **_TRUNK)
  rng = np.random.default_rng(4)
  x = jnp.asarray(rng.standard_normal((2, 8, 8)), jnp.float32)
  # A fixed random readout: the trunk ends in a LayerNorm, whose mean
  # square alone would be a flat loss.
  readout = jnp.asarray(rng.standard_normal((2, 8, 16)), jnp.float32)
  variables = jax.jit(trunk.init)(jax.random.PRNGKey(1), x)

  def loss(params):
    out, sown = trunk.apply({"params": params}, x, mutable=["aux_loss"])
    aux = jax_moe.collect_aux_losses(sown)
    return jnp.mean(out * readout) + 0.01 * aux, aux

  (value, aux), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
      variables["params"])
  to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
  return (np.array(x), np.array(readout), to_np(variables["params"]),
          float(value), float(aux), to_np(grads))


def _port_trunk_grads(tdt, x, readout, params):
  trunk = CausalTransformer(8, dtype=tdt, attention_impl="reference",
                            **_TRUNK)
  trunk.load_state_dict(convert.convert_params(params), strict=True)
  out, aux = trunk(torch.from_numpy(x), return_aux=True)
  loss = (out * torch.from_numpy(readout)).mean() + 0.01 * aux
  names, leaves = zip(*trunk.named_parameters())
  grads = torch.autograd.grad(loss, leaves)
  return float(loss.detach()), float(aux.detach()), dict(zip(names, grads))


def test_moe_trunk_gradients_match_jax_f32():
  x, readout, params, want_loss, want_aux, want_grads = _jax_trunk_grads(
      jnp.float32)
  loss, aux, grads = _port_trunk_grads(torch.float32, x, readout, params)
  assert loss == pytest.approx(want_loss, rel=1e-5)
  assert aux == pytest.approx(want_aux, rel=1e-5)
  want = convert.convert_params(want_grads)
  assert set(grads) == set(want)
  for key, g in grads.items():
    w = _np(want[key])
    np.testing.assert_allclose(_np(g), w, rtol=0,
                               atol=1e-4 * max(1e-12, np.abs(w).max()),
                               err_msg=key)


def test_moe_trunk_gradients_match_jax_bf16():
  x, readout, params, want_loss, want_aux, want_grads = _jax_trunk_grads(
      jnp.bfloat16)
  loss, aux, grads = _port_trunk_grads(torch.bfloat16, x, readout, params)
  assert loss == pytest.approx(want_loss, rel=1e-2)
  assert aux == pytest.approx(want_aux, rel=1e-2)
  want = convert.convert_params(want_grads)
  for key, g in grads.items():
    w = torch.from_numpy(_np(want[key])).flatten()
    if not w.abs().max() > 0:  # zero on both sides (unrouted expert)
      assert g.abs().max() == 0, key
      continue
    cosine = torch.nn.functional.cosine_similarity(g.float().flatten(), w,
                                                   dim=0)
    assert cosine >= 0.99, (key, float(cosine))


def test_expert_init_std_matches_flax():
  """Trap 37: flax's variance scaling counts the expert axis as receptive
  field, so w_in [E, M, H] has fan-in E·M and w_out [E, H, M] E·H; the
  router [M, E] M; biases start at 0."""
  e, m, h = 8, 32, 128
  jax_module = jax_moe.MoEMLP(num_experts=e, hidden_dim=h,
                              dtype=jnp.float32)
  shapes = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0),
                          jnp.ones((1, 2, m)))
  init = jax.jit(jax_module.init)
  want = {name: [] for name in shapes["params"]}
  got = {name: [] for name in want}
  for seed in range(4):
    params = init(jax.random.PRNGKey(seed), jnp.ones((1, 2, m)))["params"]
    module = moe.MoEMLP(m, e, h, dtype=torch.float32)
    init_parameters(module, torch.Generator().manual_seed(seed))
    for name in want:
      want[name].append(np.asarray(params[name]).ravel())
      got[name].append(_np(getattr(module, name)).ravel())
  fan_in = {"router": m, "moe_expert_w_in": e * m, "moe_expert_w_out": e * h}
  for name in want:
    w = np.concatenate(want[name])
    g = np.concatenate(got[name])
    if name not in fan_in:  # the biases
      assert not w.any() and not g.any(), name
      continue
    assert g.std() == pytest.approx(w.std(), rel=0.05), name
    assert g.std() == pytest.approx(1 / np.sqrt(fan_in[name]), rel=0.05)
    # Truncated at two standard deviations of the underlying normal.
    cut = 2 * np.sqrt(1 / fan_in[name]) / 0.87962566103423978
    assert np.abs(g).max() <= cut * (1 + 1e-6), name
