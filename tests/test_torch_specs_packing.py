"""The port's spec packing and serialization against the JAX package's
(`specs/packing.py`, `specs/serialization.py`): the same calls on the
same structures give the same specs (compared through each package's
spec dicts) and the same packed leaves, the same errors, and an assets
file written by either package reads back in the other."""

import collections

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from tensor2robot_tpu import specs as jax_specs  # noqa: E402
from tensor2robot_tpu_torch import specs  # noqa: E402
from tensor2robot_tpu_torch.specs import ExtendedTensorSpec as Spec  # noqa: E402,E501


def _both(build):
  """`build(package)` in each package: (port, jax)."""
  return build(specs), build(jax_specs)


def _spec_structure(pkg):
  s = pkg.ExtendedTensorSpec
  point = collections.namedtuple("Point", ["x", "y"])
  return {
      "image": s((4, 4, 3), np.uint8, name="rgb", data_format="png"),
      "arm": {"pose": s((7,), np.float32),
              "brain": s((2,), "bfloat16", is_optional=True)},
      "pair": point(s((1,), np.int32), s((2, 2), np.float32,
                                         is_sequence=True)),
      "list": [s((3,), np.int64, varlen=True),
               s((1,), np.float16, dataset_key="d")],
  }


def _dicts(pkg_struct, pkg):
  return pkg.struct_to_dict(pkg_struct)


@pytest.mark.parametrize("fn,args", [
    ("flatten_spec_structure", ()),
    ("filter_required_flat_tensor_spec_structure", ()),
    ("as_sequence_specs", ()),
    ("add_sequence_length", (5,)),
    ("replace_dtype", (np.float32, "bfloat16")),
    ("replace_dtype", ("bfloat16", np.float16)),
])
def test_spec_transforms_equal_jax(fn, args):
  port, jax = _both(lambda pkg: _dicts(
      getattr(pkg, fn)(_spec_structure(pkg), *args), pkg))
  assert list(port) == list(jax)
  assert port == jax


def test_nested_dict_and_flat_paths():
  port, jax = _both(lambda pkg: pkg.flatten_spec_structure(
      _spec_structure(pkg)))
  assert list(port.to_flat_dict()) == list(jax.to_flat_dict())
  nested = port.to_nested_dict()
  assert set(nested) == set(jax.to_nested_dict()) == {"image", "arm",
                                                       "pair", "list"}
  assert set(nested["pair"]) == {"x", "y"} and set(nested["list"]) == {"0",
                                                                      "1"}
  assert nested["arm"]["pose"] == port["arm/pose"]


def _tensors(with_optional):
  rng = np.random.default_rng(0)
  out = {"image": rng.integers(0, 255, (2, 4, 4, 3), dtype=np.uint8),
         "arm": {"pose": rng.standard_normal((2, 7)).astype(np.float32)},
         "pair": {"x": np.zeros((2, 1), np.int32),
                  "y": np.ones((2, 6, 2, 2), np.float32)},
         "list": {"0": np.zeros((2, 3), np.int64),
                  "1": np.zeros((2, 1), np.float16)},
         "extra": np.zeros((2,), np.float32)}
  if with_optional:
    out["arm"]["brain"] = np.zeros((2, 2), np.float32)
  return out


def _port_tensors(tensors):
  """The port's leaves: a bfloat16 leaf is a torch tensor."""
  out = dict(tensors)
  if "brain" in tensors["arm"]:
    out["arm"] = dict(tensors["arm"], brain=torch.zeros(2, 2).bfloat16())
  return out


def _jax_tensors(tensors):
  import jax.numpy as jnp
  out = dict(tensors)
  if "brain" in tensors["arm"]:
    out["arm"] = dict(tensors["arm"], brain=jnp.zeros((2, 2), jnp.bfloat16))
  return out


@pytest.mark.parametrize("with_optional", [False, True])
def test_validate_and_pack_equals_jax(with_optional):
  tensors = _tensors(with_optional)
  port = specs.validate_and_pack(_spec_structure(specs),
                                 _port_tensors(tensors))
  jax = jax_specs.validate_and_pack(_spec_structure(jax_specs),
                                    _jax_tensors(tensors))
  assert list(port.to_flat_dict()) == list(jax.to_flat_dict())
  assert "extra" not in port.to_flat_dict()
  for key, value in port.to_flat_dict().items():
    if isinstance(value, torch.Tensor):
      assert value.dtype == torch.bfloat16
      continue
    np.testing.assert_array_equal(value, np.asarray(jax[key]))


@pytest.mark.parametrize("break_it,match", [
    (lambda t: t["arm"].pop("pose"), "missing"),
    (lambda t: t["arm"].__setitem__("pose", np.zeros((2, 6), np.float32)),
     "shape mismatch"),
    (lambda t: t["arm"].__setitem__("pose", np.zeros((2, 7), np.float64)),
     "dtype mismatch"),
    (lambda t: t["pair"].__setitem__("y", np.ones((2, 2, 2), np.float32)),
     "rank mismatch"),
])
def test_validation_errors_equal_jax(break_it, match):
  for pkg in (specs, jax_specs):
    tensors = _tensors(False)
    break_it(tensors)
    with pytest.raises(pkg.SpecValidationError, match=match):
      pkg.validate_and_flatten(_spec_structure(pkg), tensors)


def test_the_bfloat16_dtype_check():
  struct = {"b": Spec((2,), "bfloat16")}
  specs.validate_and_pack(struct, {"b": torch.zeros(1, 2).bfloat16()})
  with pytest.raises(specs.SpecValidationError, match="bfloat16"):
    specs.validate_and_pack(struct, {"b": torch.zeros(1, 2)})


def test_pack_flat_sequence_and_leaf_checks():
  for pkg in (specs, jax_specs):
    struct = _spec_structure(pkg)
    n = len(pkg.flatten_spec_structure(struct).to_flat_dict())
    packed = pkg.pack_flat_sequence_to_spec_structure(struct, list(range(n)))
    assert list(packed.to_flat_dict().values()) == list(range(n))
    with pytest.raises(pkg.SpecValidationError, match="Leaf count"):
      pkg.pack_flat_sequence_to_spec_structure(struct, [0])
    with pytest.raises(pkg.SpecValidationError, match="not an"):
      pkg.assert_valid_spec_structure({"a": 1})
    with pytest.raises(pkg.SpecValidationError, match="bare leaf"):
      pkg.flatten_spec_structure(3)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_assets_read_back_in_the_other_package(tmp_path, writer):
  path = str(tmp_path / "t2r_assets.json")
  pkg, other = (specs, jax_specs) if writer == "port" else (jax_specs, specs)
  pkg.write_assets(path, _spec_structure(pkg),
                   label_spec={"a": pkg.ExtendedTensorSpec((3,), np.float32,
                                                           name="act")},
                   global_step=12, extra={"model": "x"})
  got = other.read_assets(path)
  want = pkg.read_assets(path)
  assert got["global_step"] == 12 and got["extra"] == {"model": "x"}
  for key in ("feature_spec", "label_spec"):
    assert other.struct_to_dict(got[key]) == pkg.struct_to_dict(want[key])
  assert specs.ASSET_FILENAME == jax_specs.ASSET_FILENAME
  port_text = specs.serialize_assets(_spec_structure(specs), global_step=3)
  assert port_text == jax_specs.serialize_assets(_spec_structure(jax_specs),
                                                 global_step=3)


def test_bad_asset_version_raises():
  with pytest.raises(ValueError, match="version"):
    specs.deserialize_assets('{"format_version": 2, "feature_spec": {}}')


def test_random_tensors_take_any_structure():
  """`make_random_tensors` flattens through the public function now."""
  port = specs.make_random_tensors(_spec_structure(specs), batch_size=2,
                                   seed=3, include_optional=False)
  jax = jax_specs.make_random_tensors(_spec_structure(jax_specs),
                                      batch_size=2, seed=3,
                                      include_optional=False)
  assert list(port.to_flat_dict()) == list(jax.to_flat_dict())
  for key, value in port.to_flat_dict().items():
    np.testing.assert_array_equal(np.asarray(value), np.asarray(jax[key]))
  with pytest.raises(ValueError):
    specs.make_random_tensors(Spec((1,), np.float32))
