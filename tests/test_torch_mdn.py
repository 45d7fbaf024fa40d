"""The port's mixture-density head (`layers/mdn.py`) against the JAX
package's.

Small size: 6 rows of 16 features, 3 components over 2 action dims. The
flax head's params are converted (`models/convert.py`) and the same
numpy inputs go through both packages.

Tolerances. f32: 1e-5 of the largest magnitude of each output (the same
f32 math in other summation orders), gradients included. bf16 (the
projection in bf16, then f32): cosine ≥ 0.99 against JAX's bf16, as the
BC slice's bound. Sampling draws other numbers than JAX's keys, so it is
held to its distribution: component frequencies within 0.02 of the
softmax over 20000 draws, as JAX's own draws are.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tensor2robot_tpu.layers import mdn as jax_mdn  # noqa: E402
from tensor2robot_tpu_torch.layers import mdn  # noqa: E402
from tensor2robot_tpu_torch.models import convert  # noqa: E402

_K, _D, _IN = 3, 2, 16


def _np(x):
  if isinstance(x, torch.Tensor):
    return x.detach().float().numpy()
  return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol=1e-5, what=""):
  got, want = _np(got), _np(want)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  np.testing.assert_allclose(
      got, want, atol=tol * max(1e-12, float(np.abs(want).max())), rtol=0,
      err_msg=what)


def _cosine(a, b):
  a, b = _np(a).ravel(), _np(b).ravel()
  return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.fixture(scope="module")
def head():
  """flax params of an MDNHead, features scaled so that some log scales
  fall outside [-5, 2] and are clipped, and targets."""
  rng = np.random.default_rng(0)
  features = (4.0 * rng.normal(size=(6, _IN))).astype(np.float32)
  targets = rng.normal(size=(6, _D)).astype(np.float32)
  module = jax_mdn.MDNHead(num_components=_K, output_size=_D)
  params = jax.jit(module.init)(jax.random.PRNGKey(1), features)["params"]
  params = jax.tree_util.tree_map(np.asarray, params)
  return features, targets, params


def _port_head(params, dtype=torch.float32):
  port = mdn.MDNHead(_IN, _K, _D, dtype=dtype)
  port.load_state_dict(convert.convert_params(params), strict=True)
  return port


def _jax_params(params, features, dtype=jnp.float32):
  module = jax_mdn.MDNHead(num_components=_K, output_size=_D, dtype=dtype)
  return module.apply({"params": params}, jnp.asarray(features))


def test_head_matches_jax_and_clips_log_scales(head):
  features, _, params = head
  want = _jax_params(params, features)
  got = _port_head(params)(torch.from_numpy(features))
  for name in ("logits", "means", "log_scales"):
    _close(getattr(got, name), getattr(want, name), what=name)
    assert getattr(got, name).dtype == torch.float32
  scales = _np(got.log_scales)
  assert scales.min() == -5.0 and scales.max() == 2.0  # both clips hit


def test_bf16_head_matches_jax_by_cosine(head):
  features, _, params = head
  want = _jax_params(params, features, jnp.bfloat16)
  got = _port_head(params, torch.bfloat16)(torch.from_numpy(features))
  for name in ("logits", "means", "log_scales"):
    assert getattr(got, name).dtype == torch.float32  # cast after the proj
    assert _cosine(getattr(got, name), getattr(want, name)) >= 0.99, name


@pytest.mark.parametrize("fn", ["mdn_log_prob", "mdn_loss", "mdn_mode",
                                "mdn_mean"])
def test_mixture_functions_match_jax(head, fn):
  features, targets, params = head
  want_p = _jax_params(params, features)
  got_p = _port_head(params)(torch.from_numpy(features))
  if fn in ("mdn_log_prob", "mdn_loss"):
    want = getattr(jax_mdn, fn)(want_p, jnp.asarray(targets))
    got = getattr(mdn, fn)(got_p, torch.from_numpy(targets))
  else:
    want = getattr(jax_mdn, fn)(want_p)
    got = getattr(mdn, fn)(got_p)
  _close(got, want, what=fn)


def test_loss_gradients_match_jax(head):
  """d loss / d (projection weights, features) in both packages."""
  features, targets, params = head

  def jax_loss(p, x):
    return jax_mdn.mdn_loss(_jax_params(p, x), jnp.asarray(targets))

  want_p, want_x = jax.grad(jax_loss, argnums=(0, 1))(params, features)
  port = _port_head(params)
  x = torch.from_numpy(features).requires_grad_()
  loss = mdn.mdn_loss(port(x), torch.from_numpy(targets))
  loss.backward()
  _close(x.grad, want_x, what="features")
  want = convert.convert_params(jax.tree_util.tree_map(np.asarray, want_p))
  for name, p in port.named_parameters():
    _close(p.grad, want[name], what=name)


def test_mode_ties_go_to_the_lower_index():
  """Two components tie on the largest logit: both packages take the
  first (argmax's first maximum), on a row of three and one of four."""
  logits = np.array([[0.5, 2.0, 2.0], [1.0, 1.0, 1.0]], np.float32)
  means = np.arange(2 * 3 * 2, dtype=np.float32).reshape(2, 3, 2)
  scales = np.zeros((2, 3, 2), np.float32)
  want = jax_mdn.mdn_mode(jax_mdn.MDNParams(*map(jnp.asarray,
                                                 (logits, means, scales))))
  got = mdn.mdn_mode(mdn.MDNParams(*map(torch.from_numpy,
                                        (logits, means, scales))))
  np.testing.assert_array_equal(_np(got), _np(want))
  np.testing.assert_array_equal(_np(got), [means[0, 1], means[1, 0]])


def test_sample_draws_the_mixture_from_a_generator():
  n = 20000
  logits = np.tile(np.array([[0.0, 1.0, -1.0]], np.float32), (n, 1))
  means = np.tile(np.array([[[-10.0, 0.0], [0.0, 0.0], [10.0, 0.0]]],
                           np.float32), (n, 1, 1))
  scales = np.full((n, 3, 2), -5.0, np.float32)  # the clip's floor
  params = mdn.MDNParams(*map(torch.from_numpy, (logits, means, scales)))
  draw = lambda seed: mdn.mdn_sample(  # noqa: E731
      params, torch.Generator().manual_seed(seed))
  got = draw(3)
  np.testing.assert_array_equal(_np(got), _np(draw(3)))  # same seed
  assert not np.array_equal(_np(got), _np(draw(4)))
  want = jax_mdn.mdn_sample(
      jax_mdn.MDNParams(*map(jnp.asarray, (logits, means, scales))),
      jax.random.PRNGKey(0))
  probs = np.exp(logits[0]) / np.exp(logits[0]).sum()
  for sample in (_np(got), _np(want)):
    comp = np.rint(sample[:, 0] / 10.0).astype(int) + 1
    freq = np.bincount(comp, minlength=3) / n
    np.testing.assert_allclose(freq, probs, atol=0.02)
    # Each draw sits within 5 scales (e^-5) of its component's mean.
    assert np.abs(sample - means[0][comp]).max() < 5 * np.exp(-5.0)
