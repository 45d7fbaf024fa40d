"""ginlite — the port's gin-config-compatible dependency-injection engine
(its own copy of the JAX package's `config/ginlite.py`).

The shipped experiments are `.gin` files; `bin/run_t2r_trainer` parses
them into this registry and calls the configured entry point. The
engine speaks the subset of gin the framework and its configs use:

  * ``@configurable`` decorator (optional name / module / denylist)
  * ``parse_config_files_and_bindings(config_files, bindings)``
  * binding lines      ``module.fn.param = <value>``
  * macros             ``NAME = <value>`` and ``%NAME`` references
  * configurable refs  ``@fn`` (inject the configured callable) and
                       ``@fn()`` (inject its call result)
  * scopes             ``scope/fn.param = value`` with ``@scope/fn`` refs
                       and the ``config_scope('scope')`` context manager
  * ``include '<file>'`` and ``import a.b.c`` statements
  * ``REQUIRED`` sentinel, ``bind_parameter``, ``query_parameter``,
    ``clear_config``, ``operative_config_str``

Values use Python literal syntax (via ``ast``), with ``@ref`` / ``%macro``
allowed anywhere a literal may appear, including inside containers.

The registry here is the port's alone. `configurable` overwrites the
bare-name key, so a port class registered in the JAX package's registry
would replace the JAX class of that name for every config parsed in the
process; the two packages' configurables therefore never share one.
Include paths resolve as in the JAX package, with the repository root
last, so a shipped config's ``include "tensor2robot_tpu/..."`` reads
the file in place.
"""

from __future__ import annotations

import ast
import contextlib
import functools
import importlib
import inspect
import os
import re
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


class GinError(Exception):
  pass


class _Required:
  """Sentinel: a configurable parameter that MUST be bound via config."""

  def __repr__(self):
    return "REQUIRED"


REQUIRED = _Required()


class _Registry:
  """Global registry of configurables, bindings, and macros."""

  def __init__(self):
    self.configurables: Dict[str, "_Configurable"] = {}
    # bindings[(scope, configurable_name)][param] = raw value (already
    # parsed into python objects / _Reference / _Macro placeholders).
    self.bindings: Dict[Tuple[str, str], Dict[str, Any]] = {}
    self.macros: Dict[str, Any] = {}
    self.imported_modules: List[str] = []
    self.lock = threading.RLock()
    # names actually used at call time, for operative_config_str.
    self.operative: Dict[Tuple[str, str], Dict[str, Any]] = {}
    # configurable name -> module whose import registers it (see
    # register_lazy_configurables).
    self.lazy_modules: Dict[str, str] = {}


_REGISTRY = _Registry()
_SCOPE_STACK = threading.local()


def _scope_stack() -> List[str]:
  if not hasattr(_SCOPE_STACK, "stack"):
    _SCOPE_STACK.stack = []
  return _SCOPE_STACK.stack


@contextlib.contextmanager
def config_scope(name: str):
  """Activates a gin scope for configurable calls within the block."""
  if name:
    _scope_stack().append(name)
  try:
    yield
  finally:
    if name:
      _scope_stack().pop()


class _Reference:
  """A parsed `@name` or `@scope/name` or `@name()` value."""

  __slots__ = ("name", "scope", "evaluate")

  def __init__(self, name: str, scope: str, evaluate: bool):
    self.name = name
    self.scope = scope
    self.evaluate = evaluate

  def resolve(self):
    cfg = _lookup_configurable(self.name)
    if cfg is None:
      raise GinError(f"Unknown configurable reference: @{self.name}")
    if self.scope:
      fn = cfg.scoped_callable(self.scope)
    else:
      fn = cfg.wrapper
    return fn() if self.evaluate else fn

  def __repr__(self):
    scope = f"{self.scope}/" if self.scope else ""
    call = "()" if self.evaluate else ""
    return f"@{scope}{self.name}{call}"


class _Macro:
  """A parsed `%NAME` value."""

  __slots__ = ("name",)

  def __init__(self, name: str):
    self.name = name

  def resolve(self):
    if self.name not in _REGISTRY.macros:
      raise GinError(f"Undefined macro: %{self.name}")
    return _resolve(_REGISTRY.macros[self.name])

  def __repr__(self):
    return f"%{self.name}"


def _resolve(value: Any) -> Any:
  """Recursively resolves references and macros inside parsed values."""
  if isinstance(value, _Reference) or isinstance(value, _Macro):
    return value.resolve()
  if isinstance(value, list):
    return [_resolve(v) for v in value]
  if isinstance(value, tuple):
    return tuple(_resolve(v) for v in value)
  if isinstance(value, dict):
    return {_resolve(k): _resolve(v) for k, v in value.items()}
  return value


class _Configurable:
  """Wraps one configurable function or class."""

  def __init__(self, fn: Callable, name: str, module: str,
               denylist: Sequence[str]):
    self.fn = fn
    self.name = name
    self.module = module
    self.denylist = tuple(denylist or ())
    self.wrapper = self._make_wrapper()

  @property
  def full_name(self) -> str:
    return f"{self.module}.{self.name}" if self.module else self.name

  def _signature_params(self):
    target = self.fn.__init__ if inspect.isclass(self.fn) else self.fn
    try:
      sig = inspect.signature(target)
    except (TypeError, ValueError):
      return {}, False
    params = {}
    has_kwargs = False
    for p in sig.parameters.values():
      if p.kind == inspect.Parameter.VAR_KEYWORD:
        has_kwargs = True
      elif p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                      inspect.Parameter.KEYWORD_ONLY):
        params[p.name] = p
    params.pop("self", None)
    return params, has_kwargs

  def gather_bindings(self, scope_stack: Sequence[str]) -> Dict[str, Any]:
    """Merges bindings in gin specificity order (most specific last).

    Candidates are every contiguous subsequence of the active scope
    stack (plus unscoped), ordered by (innermost end position, match
    length): a binding scoped deeper in the stack beats one scoped
    shallower; at the same depth a longer compound scope (`a/b`) beats
    a shorter one (`b`).
    """
    candidates = [("", 0, 0)]
    for j in range(len(scope_stack)):
      for i in range(j + 1):
        scope = "/".join(scope_stack[i:j + 1])
        candidates.append((scope, j + 1, j + 1 - i))
    candidates.sort(key=lambda t: (t[1], t[2]))
    merged: Dict[str, Any] = {}
    with _REGISTRY.lock:
      for scope, _, _ in candidates:
        for key in [(scope, self.name), (scope, self.full_name)]:
          merged.update(_REGISTRY.bindings.get(key, {}))
    return merged

  def _make_wrapper(self) -> Callable:
    configurable = self

    if inspect.isclass(self.fn):
      # Injection lives in a SUBCLASS so the original class is never
      # mutated: direct instantiation of the original (e.g. after
      # external_configurable) bypasses gin entirely, matching gin.
      orig_init = self.fn.__init__

      @functools.wraps(orig_init)
      def wrapped_init(obj, *args, **kwargs):
        merged = configurable._inject(args, kwargs)
        orig_init(obj, *args, **merged)

      wrapped_cls = type(self.fn.__name__, (self.fn,), {
          "__init__": wrapped_init,
          "__module__": self.fn.__module__,
          "__qualname__": self.fn.__qualname__,
          "__doc__": self.fn.__doc__,
      })
      return wrapped_cls

    @functools.wraps(self.fn)
    def wrapper(*args, **kwargs):
      merged = configurable._inject(args, kwargs)
      return configurable.fn(*args, **merged)

    return wrapper

  def _inject(self, args: tuple, kwargs: dict) -> dict:
    params, has_kwargs = self._signature_params()
    bindings = self.gather_bindings(tuple(_scope_stack()))
    merged = dict(kwargs)
    positional = set(list(params)[:len(args)])
    used: Dict[str, Any] = {}
    for name, raw in bindings.items():
      if name in self.denylist:
        raise GinError(
            f"Parameter {name!r} of {self.full_name} is in the denylist "
            f"and cannot be configured.")
      if name in positional or name in kwargs:
        continue  # explicit caller args win over config
      if name not in params and not has_kwargs:
        raise GinError(
            f"Configurable {self.full_name} has no parameter {name!r}.")
      merged[name] = _resolve(raw)
      used[name] = raw
    # REQUIRED enforcement: any declared-REQUIRED param still unbound?
    for name, p in params.items():
      if p.default is REQUIRED and name not in merged and \
          name not in positional:
        raise GinError(
            f"Required parameter {self.full_name}.{name} was not bound. "
            f"Bind it via '{self.name}.{name} = ...'.")
    if used:
      with _REGISTRY.lock:
        scope = "/".join(_scope_stack())
        _REGISTRY.operative.setdefault((scope, self.name), {}).update(used)
    return merged

  def scoped_callable(self, scope: str) -> Callable:
    wrapper = self.wrapper

    @functools.wraps(self.fn)
    def scoped(*args, **kwargs):
      with contextlib.ExitStack() as stack:
        for part in scope.split("/"):
          stack.enter_context(config_scope(part))
        return wrapper(*args, **kwargs)

    return scoped


def configurable(fn_or_name=None, *, module: Optional[str] = None,
                 denylist: Optional[Sequence[str]] = None,
                 allowlist: Optional[Sequence[str]] = None):
  """Registers a function or class as configurable (gin.configurable API).

  Note: `allowlist` is accepted for API parity; enforcement treats all
  non-allowlisted parameters as denylisted.
  """

  def decorate(fn, name=None):
    reg_name = name or fn.__name__
    deny = list(denylist or [])
    if allowlist is not None:
      params = [p for p in inspect.signature(
          fn.__init__ if inspect.isclass(fn) else fn).parameters
                if p != "self"]
      deny.extend(p for p in params if p not in allowlist)
    cfg = _Configurable(fn, reg_name, module or _infer_module(fn), deny)
    with _REGISTRY.lock:
      _REGISTRY.configurables[reg_name] = cfg
      _REGISTRY.configurables[cfg.full_name] = cfg
    return cfg.wrapper

  if callable(fn_or_name):
    return decorate(fn_or_name)
  return lambda fn: decorate(fn, name=fn_or_name)


def external_configurable(fn, name=None, module=None, **kwargs):
  """Registers an external callable (gin.external_configurable API)."""
  reg_name = name or getattr(fn, "__name__", str(fn))
  cfg = _Configurable(fn, reg_name, module or _infer_module(fn), ())
  with _REGISTRY.lock:
    _REGISTRY.configurables[reg_name] = cfg
    _REGISTRY.configurables[cfg.full_name] = cfg
  return cfg.wrapper


def _infer_module(fn) -> str:
  mod = getattr(fn, "__module__", "") or ""
  return mod.rsplit(".", 1)[-1] if mod else ""


def register_lazy_configurables(module_path: str,
                                names: Sequence[str]) -> None:
  """Declares that importing `module_path` registers `names`.

  For packages whose __init__ resolves exports lazily (PEP 562 — e.g.
  `tensor2robot_tpu_torch.research.qtopt`, whose learner pulls in the
  whole Q-network stack): importing the package no longer runs the
  `@configurable` decorators, so the first *config reference* to one of
  `names` imports `module_path` instead. Registration stays exactly as
  eager as config parsing needs while the import stays light.
  """
  with _REGISTRY.lock:
    for name in names:
      _REGISTRY.lazy_modules[name] = module_path


def _lookup_configurable(name: str) -> Optional[_Configurable]:
  with _REGISTRY.lock:
    if name in _REGISTRY.configurables:
      return _REGISTRY.configurables[name]
    # Partial module qualification, both directions: a registered
    # 'module.fn' matches queries 'fn' and 'pkg.module.fn'. The reverse
    # direction requires the registered key to be module-qualified, so a
    # foreign path like 'torch.xyz.fn' can never silently bind the bare
    # registered 'fn'.
    matches = {id(c): c for n, c in _REGISTRY.configurables.items()
               if n.endswith("." + name) or
               ("." in n and name.endswith("." + n))}
    if len(matches) == 1:
      return next(iter(matches.values()))
    if len(matches) > 1:
      raise GinError(
          f"Ambiguous configurable name {name!r}; candidates: "
          f"{sorted(c.full_name for c in matches.values())}")
    lazy_module = (_REGISTRY.lazy_modules.get(name) or
                   _REGISTRY.lazy_modules.get(name.rsplit(".", 1)[-1]))
  if lazy_module is None:
    return None
  # Import OUTSIDE the registry lock: the module's @configurable
  # decorators re-enter it, and holding it across the interpreter's
  # import lock could deadlock against another importing thread.
  importlib.import_module(lazy_module)
  with _REGISTRY.lock:
    _REGISTRY.lazy_modules = {
        n: m for n, m in _REGISTRY.lazy_modules.items()
        if m != lazy_module}
  return _lookup_configurable(name)


# ---------------------------------------------------------------------------
# Parsing
# ---------------------------------------------------------------------------

_REF_RE = re.compile(r"@([A-Za-z_][\w.]*(?:/[A-Za-z_][\w.]*)*)(\(\))?")
_MACRO_RE = re.compile(r"%([A-Za-z_][\w.]*)")


def _tokenize_value(text: str) -> Tuple[str, Dict[str, Any]]:
  """Replaces @refs and %macros outside string literals with placeholders."""
  out = []
  placeholders: Dict[str, Any] = {}
  i = 0
  counter = 0
  in_string: Optional[str] = None
  while i < len(text):
    ch = text[i]
    if in_string:
      out.append(ch)
      if ch == "\\":
        if i + 1 < len(text):
          out.append(text[i + 1])
          i += 1
      elif ch == in_string:
        in_string = None
      i += 1
      continue
    if ch in "\"'":
      in_string = ch
      out.append(ch)
      i += 1
      continue
    if ch == "@":
      m = _REF_RE.match(text, i)
      if not m:
        raise GinError(f"Malformed reference in value: {text!r}")
      full = m.group(1)
      evaluate = m.group(2) is not None
      scope, _, name = full.rpartition("/")
      key = f"__GINREF_{counter}__"
      counter += 1
      placeholders[key] = _Reference(name, scope, evaluate)
      out.append(f"'{key}'")
      i = m.end()
      continue
    if ch == "%":
      m = _MACRO_RE.match(text, i)
      if not m:
        raise GinError(f"Malformed macro in value: {text!r}")
      key = f"__GINMACRO_{counter}__"
      counter += 1
      placeholders[key] = _Macro(m.group(1))
      out.append(f"'{key}'")
      i = m.end()
      continue
    out.append(ch)
    i += 1
  return "".join(out), placeholders


def _restore_placeholders(value: Any, placeholders: Dict[str, Any]) -> Any:
  if isinstance(value, str) and value in placeholders:
    return placeholders[value]
  if isinstance(value, list):
    return [_restore_placeholders(v, placeholders) for v in value]
  if isinstance(value, tuple):
    return tuple(_restore_placeholders(v, placeholders) for v in value)
  if isinstance(value, dict):
    return {_restore_placeholders(k, placeholders):
            _restore_placeholders(v, placeholders)
            for k, v in value.items()}
  return value


_NAMED_CONSTANTS = {
    "None": None, "True": True, "False": False,
    "inf": float("inf"), "nan": float("nan"),
}


def parse_value(text: str) -> Any:
  """Parses one gin value expression into a python object."""
  text = text.strip()
  if text in _NAMED_CONSTANTS:
    return _NAMED_CONSTANTS[text]
  replaced, placeholders = _tokenize_value(text)
  try:
    value = ast.literal_eval(replaced)
  except (ValueError, SyntaxError) as e:
    # Bare identifiers (gin allows dotted names as strings in some spots).
    if re.fullmatch(r"[A-Za-z_][\w.]*", text):
      return text
    raise GinError(f"Cannot parse value: {text!r} ({e})") from e
  return _restore_placeholders(value, placeholders)


def _canonical_name(name: str, skip_unknown: bool = False) -> Optional[str]:
  """Resolves a binding target to its registered full name, or raises.

  Bindings are keyed by the module-qualified full name — unique per
  configurable — so two same-named configurables in different modules
  never share a binding bucket.
  """
  cfg = _lookup_configurable(name)
  if cfg is None:
    if skip_unknown:
      return None
    raise GinError(
        f"No configurable matching {name!r} is registered. Import the "
        f"defining module first (configs may use 'import a.b.c' lines), "
        f"or parse with skip_unknown=True.")
  return cfg.full_name


def bind_parameter(binding_name: str, value: Any) -> None:
  """Binds `scope/configurable.param` to an (already-python) value."""
  scope, name, param = _split_binding_name(binding_name)
  name = _canonical_name(name)
  with _REGISTRY.lock:
    _REGISTRY.bindings.setdefault((scope, name), {})[param] = value


def query_parameter(binding_name: str) -> Any:
  scope, name, param = _split_binding_name(binding_name)
  name = _canonical_name(name)
  with _REGISTRY.lock:
    try:
      return _REGISTRY.bindings[(scope, name)][param]
    except KeyError:
      raise GinError(f"No binding for {binding_name!r}") from None


def _split_binding_name(binding_name: str) -> Tuple[str, str, str]:
  scope, _, rest = binding_name.rpartition("/")
  if "." not in rest:
    raise GinError(f"Invalid binding name: {binding_name!r}")
  name, _, param = rest.rpartition(".")
  return scope, name, param


_STATEMENT_RE = re.compile(
    r"^(?P<target>[\w./]+(?:\.[\w]+)?)\s*=\s*(?P<value>.+)$", re.DOTALL)


def split_statements(config: str) -> List[Tuple[str, int]]:
  """Gin text → [(statement, first line number)] (comments stripped).

  Continuation joining: a statement continues while brackets are open
  or the line ends with an operator. Public so the static validator
  (`config/validate.py`) can walk statements with real line numbers
  without executing them.
  """
  lines = config.split("\n")
  statements: List[Tuple[str, int]] = []
  buf = ""
  depth = 0
  start = 0
  for lineno, raw in enumerate(lines, start=1):
    line = raw.split("#", 1)[0].rstrip()
    if not line.strip() and depth == 0:
      continue
    if not buf:
      start = lineno
    buf = (buf + "\n" + line) if buf else line
    depth = _bracket_depth(buf)
    if depth == 0 and not buf.rstrip().endswith((",", "=", "\\")):
      statements.append((buf.strip(), start))
      buf = ""
  if buf.strip():
    statements.append((buf.strip(), start))
  return statements


def parse_config(config: str, skip_unknown: bool = False) -> None:
  """Parses gin-format config text into the global registry."""
  for stmt, _ in split_statements(config):
    _parse_statement(stmt, skip_unknown=skip_unknown)


def _bracket_depth(text: str) -> int:
  depth = 0
  in_string = None
  i = 0
  while i < len(text):
    ch = text[i]
    if in_string:
      if ch == "\\":
        i += 1
      elif ch == in_string:
        in_string = None
    elif ch in "\"'":
      in_string = ch
    elif ch in "([{":
      depth += 1
    elif ch in ")]}":
      depth -= 1
    i += 1
  return depth


def _parse_statement(stmt: str, skip_unknown: bool = False) -> None:
  if stmt.startswith("import "):
    module = stmt[len("import "):].strip()
    try:
      importlib.import_module(module)
      _REGISTRY.imported_modules.append(module)
    except ImportError:
      if not skip_unknown:
        raise
    return
  if stmt.startswith("include "):
    path = parse_value(stmt[len("include "):].strip())
    parse_config_file(path, skip_unknown=skip_unknown)
    return
  m = _STATEMENT_RE.match(stmt)
  if not m:
    raise GinError(f"Cannot parse config statement: {stmt!r}")
  target = m.group("target").strip()
  value = parse_value(m.group("value").strip())
  scope, _, rest = target.rpartition("/")
  if "." not in rest:
    # Macro definition: NAME = value
    with _REGISTRY.lock:
      _REGISTRY.macros[target] = value
    return
  name, _, param = rest.rpartition(".")
  canonical = _canonical_name(name, skip_unknown=skip_unknown)
  if canonical is not None:
    with _REGISTRY.lock:
      _REGISTRY.bindings.setdefault((scope, canonical), {})[param] = value


# Search order for config paths: cwd, any user-registered search paths
# (add_config_file_search_path — these outrank sibling-relative
# resolution AND the built-in fallback, so users can shadow shipped
# configs including their sibling includes), then the directory of the
# file being parsed (sibling-relative includes), and LAST the
# repo/package root, so the shipped `tensor2robot_tpu/...`
# repo-relative include paths resolve regardless of the caller's cwd
# (reference gin configs used the same repo-relative convention).
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SEARCH_PATHS: List[str] = [""]
_INCLUDE_DIR_STACK: List[str] = []


def add_config_file_search_path(path: str) -> None:
  _SEARCH_PATHS.append(path)


def resolve_config_path(path: str,
                        including_dir: Optional[str] = None
                        ) -> Optional[str]:
  """Resolves a config path through the documented search order.

  `including_dir` substitutes for the live include stack — the static
  validator resolves includes without parsing into the registry.
  """
  bases = list(_SEARCH_PATHS)
  if including_dir is not None:
    bases.append(including_dir)
  elif _INCLUDE_DIR_STACK:
    bases.append(_INCLUDE_DIR_STACK[-1])
  bases.append(_PACKAGE_ROOT)
  for base in bases:
    candidate = os.path.join(base, path) if base else path
    if os.path.exists(candidate):
      return candidate
  return None


def parse_config_file(path: str, skip_unknown: bool = False) -> None:
  candidate = resolve_config_path(path)
  if candidate is None:
    raise GinError(f"Config file not found: {path!r} "
                   f"(search paths: {list(_SEARCH_PATHS)} + include "
                   f"dir + package root)")
  _INCLUDE_DIR_STACK.append(os.path.dirname(os.path.abspath(candidate)))
  try:
    with open(candidate) as f:
      parse_config(f.read(), skip_unknown=skip_unknown)
  finally:
    _INCLUDE_DIR_STACK.pop()


def parse_config_files_and_bindings(
    config_files: Optional[Sequence[str]] = None,
    bindings: Optional[Sequence[str]] = None,
    skip_unknown: bool = False,
    finalize_config: bool = True,  # accepted for API parity
) -> None:
  for path in config_files or []:
    parse_config_file(path, skip_unknown=skip_unknown)
  for binding in bindings or []:
    parse_config(binding, skip_unknown=skip_unknown)


def clear_config() -> None:
  with _REGISTRY.lock:
    _REGISTRY.bindings.clear()
    _REGISTRY.macros.clear()
    _REGISTRY.operative.clear()


def _format_value(value: Any) -> str:
  if isinstance(value, (_Reference, _Macro)):
    return repr(value)
  if isinstance(value, tuple):
    inner = ", ".join(_format_value(v) for v in value)
    return f"({inner},)" if len(value) == 1 else f"({inner})"
  if isinstance(value, list):
    return "[" + ", ".join(_format_value(v) for v in value) + "]"
  if isinstance(value, dict):
    return "{" + ", ".join(
        f"{_format_value(k)}: {_format_value(v)}"
        for k, v in value.items()) + "}"
  return repr(value)


def config_str() -> str:
  """All current bindings and macros, in parseable gin syntax."""
  out = []
  with _REGISTRY.lock:
    for name, value in sorted(_REGISTRY.macros.items()):
      out.append(f"{name} = {_format_value(value)}")
    for (scope, name), params in sorted(_REGISTRY.bindings.items()):
      prefix = f"{scope}/" if scope else ""
      for param, value in sorted(params.items()):
        out.append(f"{prefix}{name}.{param} = {_format_value(value)}")
  return "\n".join(out) + ("\n" if out else "")


def operative_config_str() -> str:
  """Bindings actually consumed by configurable calls so far."""
  out = []
  with _REGISTRY.lock:
    for (scope, name), params in sorted(_REGISTRY.operative.items()):
      prefix = f"{scope}/" if scope else ""
      for param, value in sorted(params.items()):
        out.append(f"{prefix}{name}.{param} = {_format_value(value)}")
  return "\n".join(out) + ("\n" if out else "")
