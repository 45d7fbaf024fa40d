"""The port's gin registry against the JAX package's.

Every case of `tests/test_config.py` runs once on each registry (the
`env` fixture's two params), over configurables the fixture defines
anew in that registry and removes afterwards, so nothing registered
here outlives the test in either registry. Then trap 1: the two
registries are apart. A shipped config parsed into one leaves the
other's bindings and bare-name lookups as they were, and each resolves
every name to its own package's class.
"""

import os
import subprocess
import sys
import types

import pytest

pytest.importorskip("torch")

from tensor2robot_tpu import config as jax_gin  # noqa: E402
from tensor2robot_tpu.config import ginlite as jax_ginlite  # noqa: E402
from tensor2robot_tpu_torch import config as port_gin  # noqa: E402
from tensor2robot_tpu_torch.config import ginlite as port_ginlite  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REGISTRIES = {
    "jax": (jax_gin, jax_ginlite, "tensor2robot_tpu"),
    "port": (port_gin, port_ginlite, "tensor2robot_tpu_torch"),
}


def _define(gin):
  """test_config.py's configurables, registered in `gin`'s registry."""

  @gin.configurable
  def make_widget(size=1, color="red", factory=None):
    return {"size": size, "color": color, "factory": factory}

  @gin.configurable
  def make_gadget(widget=None, scale=1.0):
    return {"widget": widget, "scale": scale}

  @gin.configurable
  class Engine:

    def __init__(self, power=10, name="eng"):
      self.power = power
      self.name = name

  @gin.configurable
  def needs_binding(value=gin.REQUIRED):
    return value

  return make_widget, make_gadget, Engine, needs_binding


@pytest.fixture(params=sorted(_REGISTRIES))
def env(request):
  gin, ginlite, package = _REGISTRIES[request.param]
  registry = ginlite._REGISTRY
  saved = dict(registry.configurables), dict(registry.lazy_modules)
  gin.clear_config()
  make_widget, make_gadget, engine, needs_binding = _define(gin)
  yield types.SimpleNamespace(
      gin=gin, package=package, name=request.param,
      make_widget=make_widget, make_gadget=make_gadget, Engine=engine,
      needs_binding=needs_binding)
  gin.clear_config()
  registry.configurables.clear()
  registry.configurables.update(saved[0])
  registry.lazy_modules.clear()
  registry.lazy_modules.update(saved[1])


class TestBindings:

  def test_simple_binding(self, env):
    env.gin.parse_config("make_widget.size = 5")
    assert env.make_widget()["size"] == 5

  def test_explicit_arg_wins(self, env):
    env.gin.parse_config("make_widget.size = 5")
    assert env.make_widget(size=9)["size"] == 9

  def test_module_qualified(self, env):
    env.gin.parse_config("test_torch_config.make_widget.color = 'blue'")
    assert env.make_widget()["color"] == "blue"

  def test_class_configurable(self, env):
    env.gin.parse_config("Engine.power = 99")
    e = env.Engine()
    assert e.power == 99 and e.name == "eng"
    assert isinstance(e, env.Engine)

  def test_required_unbound_raises(self, env):
    with pytest.raises(env.gin.GinError, match="needs_binding.value"):
      env.needs_binding()

  def test_required_bound(self, env):
    env.gin.parse_config("needs_binding.value = [1, 2]")
    assert env.needs_binding() == [1, 2]

  def test_unknown_param_raises(self, env):
    env.gin.parse_config("make_widget.nonexistent = 1")
    with pytest.raises(env.gin.GinError, match="nonexistent"):
      env.make_widget()

  def test_bind_and_query_parameter(self, env):
    env.gin.bind_parameter("make_widget.size", 7)
    assert env.gin.query_parameter("make_widget.size") == 7
    assert env.make_widget()["size"] == 7


class TestValues:

  def test_literals(self, env):
    for text, expected in [
        ("1", 1), ("1.5", 1.5), ("'abc'", "abc"), ("True", True),
        ("None", None), ("[1, 2]", [1, 2]), ("(1, 'a')", (1, "a")),
        ("{'k': 3}", {"k": 3}),
    ]:
      assert env.gin.parse_value(text) == expected

  def test_reference_injects_callable(self, env):
    env.gin.parse_config("""
      make_widget.size = 3
      make_gadget.widget = @make_widget
    """)
    out = env.make_gadget()
    assert callable(out["widget"])
    assert out["widget"]()["size"] == 3

  def test_evaluated_reference(self, env):
    env.gin.parse_config("""
      make_widget.size = 4
      make_gadget.widget = @make_widget()
    """)
    assert env.make_gadget()["widget"]["size"] == 4

  def test_reference_inside_list(self, env):
    env.gin.parse_config("make_gadget.widget = [@make_widget(), 7]")
    out = env.make_gadget()["widget"]
    assert out[1] == 7 and out[0]["size"] == 1

  def test_macro(self, env):
    env.gin.parse_config("""
      SIZE = 12
      make_widget.size = %SIZE
    """)
    assert env.make_widget()["size"] == 12

  def test_string_with_at_sign_not_a_ref(self, env):
    env.gin.parse_config("make_widget.color = 'user@host'")
    assert env.make_widget()["color"] == "user@host"

  def test_multiline_value(self, env):
    env.gin.parse_config("""
      make_widget.factory = [
          1,
          2,
          3,
      ]
    """)
    assert env.make_widget()["factory"] == [1, 2, 3]


class TestScopes:

  def test_scoped_binding(self, env):
    env.gin.parse_config("""
      make_widget.size = 1
      train/make_widget.size = 100
    """)
    assert env.make_widget()["size"] == 1
    with env.gin.config_scope("train"):
      assert env.make_widget()["size"] == 100

  def test_scoped_reference(self, env):
    env.gin.parse_config("""
      train/make_widget.size = 50
      make_gadget.widget = @train/make_widget()
    """)
    assert env.make_gadget()["widget"]["size"] == 50


class TestFilesAndDump:

  def test_parse_file_and_include(self, env, tmp_path):
    base = tmp_path / "base.gin"
    base.write_text("make_widget.size = 2\n")
    top = tmp_path / "top.gin"
    top.write_text(f"include '{base}'\nmake_widget.color = 'green'\n")
    env.gin.parse_config_files_and_bindings([str(top)],
                                            ["make_gadget.scale = 3.0"])
    assert env.make_widget() == {"size": 2, "color": "green",
                                 "factory": None}
    assert env.make_gadget()["scale"] == 3.0

  def test_config_str_roundtrip(self, env):
    env.gin.parse_config("""
      SIZE = 5
      make_widget.size = %SIZE
      train/make_widget.color = 'red'
    """)
    dumped = env.gin.config_str()
    env.gin.clear_config()
    env.gin.parse_config(dumped)
    assert env.make_widget()["size"] == 5

  def test_operative_config(self, env):
    env.gin.parse_config("make_widget.size = 8\nmake_widget.color = 'k'")
    env.make_widget()
    dump = env.gin.operative_config_str()
    assert "make_widget.size = 8" in dump


class TestReviewRegressions:

  def test_unknown_configurable_binding_raises_at_parse(self, env):
    with pytest.raises(env.gin.GinError, match="No configurable matching"):
      env.gin.parse_config("fnn.x = 42")  # typo'd target

  def test_unknown_binding_skipped_with_skip_unknown(self, env):
    env.gin.parse_config("fnn.x = 42", skip_unknown=True)  # no raise

  def test_fully_qualified_binding_applies(self, env):
    env.gin.parse_config("tests.test_torch_config.make_widget.size = 77")
    assert env.make_widget()["size"] == 77

  def test_compound_scope_beats_bare_scope(self, env):
    env.gin.parse_config("""
      a/b/make_widget.size = 1
      b/make_widget.size = 2
    """)
    with env.gin.config_scope("a"):
      with env.gin.config_scope("b"):
        assert env.make_widget()["size"] == 1  # most specific scope wins

  def test_external_configurable_does_not_mutate_original(self, env):
    class Plain:
      def __init__(self, x=1):
        self.x = x

    wrapped = env.gin.external_configurable(Plain, name="PlainThing")
    env.gin.bind_parameter("PlainThing.x", 9)
    assert Plain().x == 1       # original untouched
    assert wrapped().x == 9     # wrapper injects
    assert isinstance(wrapped(), Plain)

  def test_lazy_registration_in_process(self, env, tmp_path, monkeypatch):
    module = f"lazy_reg_target_{env.name}"
    (tmp_path / f"{module}.py").write_text(
        f"from {env.package} import config as gin\n"
        "@gin.configurable\n"
        "def lazy_reg_fn(value=0):\n"
        "  return value\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    env.gin.register_lazy_configurables(module, ("lazy_reg_fn",))
    assert module not in sys.modules
    env.gin.parse_config("lazy_reg_fn.value = 5")  # triggers the import
    assert sys.modules[module].lazy_reg_fn() == 5
    del sys.modules[module]

  def test_lazy_package_registers_data_configurables(self, env):
    """A config binding one of `data`'s configurables parses right after
    the bare package import, which loads no JAX (subprocess: clean
    module state)."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module('{env.package}.data')\n"
        "assert 'jax' not in sys.modules, 'package import dragged jax'\n"
        f"from {env.package} import config as gin\n"
        "gin.parse_config('RandomInputGenerator.batch_size = 4')\n"
        "assert gin.query_parameter(\n"
        "    'RandomInputGenerator.batch_size') == 4\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=_REPO,
                   env=dict(os.environ, PYTHONPATH=_REPO), timeout=120)


# ---- trap 1: the two registries are apart ----

_SHIPPED = "tensor2robot_tpu/research/qtopt/configs/qtopt_int8.gin"
_BINDINGS = ("train_qtopt.max_train_steps", "train_qtopt.learner",
             "QTOptLearner.cem_inference", "QTOptLearner.model",
             "GraspingQModel.image_size", "create_optimizer.learning_rate")
_NAMES = ("train_qtopt", "QTOptLearner", "GraspingQModel",
          "create_optimizer")


@pytest.fixture
def both_registries():
  import tensor2robot_tpu.models  # noqa: F401  (registers the optimizer)
  import tensor2robot_tpu.research.qtopt  # noqa: F401
  from tensor2robot_tpu_torch.bin import run_t2r_trainer
  run_t2r_trainer.import_configurable_families()
  jax_gin.clear_config()
  port_gin.clear_config()
  yield
  jax_gin.clear_config()
  port_gin.clear_config()


def _state(gin, ginlite):
  """Each binding's parsed value (references by repr) and the module of
  each bare name's target."""
  values = {b: repr(gin.query_parameter(b)) for b in _BINDINGS}
  modules = {n: ginlite._lookup_configurable(n).fn.__module__
             for n in _NAMES}
  return values, modules


@pytest.mark.parametrize("first", ["jax", "port"])
def test_a_shipped_file_parsed_in_one_registry_leaves_the_other_as_it_was(
    both_registries, first):
  (gin_a, lite_a, pkg_a), (gin_b, lite_b, pkg_b) = (
      _REGISTRIES[first], _REGISTRIES["port" if first == "jax" else "jax"])
  gin_b.parse_config_file(_SHIPPED)
  before = _state(gin_b, lite_b)
  gin_a.parse_config_file(_SHIPPED)
  gin_a.bind_parameter("GraspingQModel.image_size", 16)
  assert _state(gin_b, lite_b) == before
  assert gin_b.query_parameter("GraspingQModel.image_size") == 64
  for registry, lite, package in ((gin_a, lite_a, pkg_a),
                                  (gin_b, lite_b, pkg_b)):
    for module in _state(registry, lite)[1].values():
      assert module.startswith(package + "."), (package, module)
  assert before[1] == {
      n: m.replace(pkg_a + ".", pkg_b + ".", 1)
      for n, m in _state(gin_a, lite_a)[1].items()}
