"""Validate-only parsing of a `.gin` config against the port's registry.

What `run_t2r_trainer --validate_only` runs. Every statement of a
config and of the files it includes is resolved against the port's
registered configurables without binding anything or running a step:

  * a binding target (`scope/module.fn.param`) must name a registered
    configurable (lazy declarations import their module, as parsing
    would) whose signature has the parameter, or keeps ``**kwargs``
    open all the way up its class chain;
  * an ``@ref`` value, anywhere inside containers, must name a
    registered configurable; a ``%macro`` must be defined somewhere in
    the config's include closure;
  * ``include`` and ``import`` statements must resolve, through the
    search order the parser uses;
  * a parameter the port declares not ported (`unported_parameters`)
    is a finding when a config binds it, as a missing one is.

The rule names are those of the JAX package's static gin rules
(GIN101–GIN107). The JAX flag also runs that package's source lints
(`analysis/`), which cover JAX code only and have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import importlib
import inspect
import os
from typing import Callable, List, Optional, Set, Tuple

from tensor2robot_tpu_torch.config import ginlite


@dataclasses.dataclass(frozen=True)
class Finding:
  """One problem in a config: `name` is the configurable it is about
  ("" when none) and `param` the parameter, for a binding's."""

  rule: str
  path: str
  line: int
  message: str
  name: str = ""
  param: str = ""

  def render(self) -> str:
    return f"{self.path}:{self.line}: {self.rule} {self.message}"


def unported_parameters(**items: str) -> Callable:
  """Declares parameters of a configurable that the port keeps in its
  signature (a call with a value it cannot serve raises, naming the
  ROADMAP item) but does not serve: `--validate_only` reports a binding
  of one as GIN102, naming the item. Apply it under
  `@gin.configurable`."""

  def mark(fn):
    fn.gin_unported_parameters = dict(items)
    return fn

  return mark


def accepted_parameters(fn) -> Tuple[Set[str], bool]:
  """(parameter names, accepts anything) of a configurable's target.

  A class's ``**kwargs`` are followed up the MRO, unioning each
  ``__init__``'s named parameters; it accepts anything only if every
  ``__init__`` in the chain keeps ``**kwargs`` open.
  """

  def params_of(target) -> Tuple[Set[str], bool]:
    try:
      sig = inspect.signature(target)
    except (TypeError, ValueError):
      return set(), True
    names: Set[str] = set()
    has_var = False
    for p in sig.parameters.values():
      if p.kind == inspect.Parameter.VAR_KEYWORD:
        has_var = True
      elif p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                      inspect.Parameter.KEYWORD_ONLY):
        names.add(p.name)
    names.discard("self")
    return names, has_var

  if not inspect.isclass(fn):
    return params_of(fn)
  accepted: Set[str] = set()
  for klass in fn.__mro__:
    if klass is object:
      return accepted, False
    init = klass.__dict__.get("__init__")
    if init is None:
      continue
    names, has_var = params_of(init)
    accepted |= names
    if not has_var:
      return accepted, False
  return accepted, True


def validate_config_file(path: str,
                         root: Optional[str] = None) -> List[Finding]:
  """Every finding of one top-level config and its include closure;
  paths in the findings are relative to `root` (default: the cwd)."""
  root = os.path.abspath(root or os.getcwd())
  findings: List[Finding] = []
  macros_defined: Set[str] = set()
  macro_uses: List[Tuple[str, int, str]] = []
  visited: Set[str] = set()

  def lookup(name: str, rel: str, lineno: int):
    try:
      return ginlite._lookup_configurable(name)
    except ginlite.GinError as e:  # ambiguous name
      findings.append(Finding("GIN101", rel, lineno, str(e), name=name))
      return None

  def collect_refs(rel: str, lineno: int, value) -> None:
    if isinstance(value, ginlite._Reference):
      if lookup(value.name, rel, lineno) is None:
        findings.append(Finding(
            "GIN104", rel, lineno,
            f"@{value.name} does not resolve to any registered "
            "configurable", name=value.name))
    elif isinstance(value, ginlite._Macro):
      macro_uses.append((rel, lineno, value.name))
    elif isinstance(value, (list, tuple)):
      for item in value:
        collect_refs(rel, lineno, item)
    elif isinstance(value, dict):
      for k, v in value.items():
        collect_refs(rel, lineno, k)
        collect_refs(rel, lineno, v)

  def check_binding(rel: str, lineno: int, name: str, param: str) -> None:
    cfg = lookup(name, rel, lineno)
    if cfg is None:
      findings.append(Finding(
          "GIN101", rel, lineno,
          f"binding target {name!r} matches no registered configurable",
          name=name))
    elif param in cfg.denylist:
      findings.append(Finding(
          "GIN105", rel, lineno,
          f"{cfg.full_name}.{param} is denylisted and cannot be configured",
          name=cfg.name, param=param))
    elif param in getattr(cfg.fn, "gin_unported_parameters", {}):
      findings.append(Finding(
          "GIN102", rel, lineno,
          f"{cfg.full_name}.{param} is not ported yet "
          f"({cfg.fn.gin_unported_parameters[param]})",
          name=cfg.name, param=param))
    else:
      params, has_kwargs = accepted_parameters(cfg.fn)
      if param not in params and not has_kwargs:
        known = ", ".join(sorted(params)) or "<none>"
        findings.append(Finding(
            "GIN102", rel, lineno,
            f"{cfg.full_name} has no parameter {param!r} (signature "
            f"accepts: {known})", name=cfg.name, param=param))

  def check_statement(file_path: str, rel: str, stmt: str,
                      lineno: int) -> None:
    if stmt.startswith("import "):
      module = stmt[len("import "):].strip()
      try:
        importlib.import_module(module)
      except ImportError as e:
        findings.append(Finding("GIN106", rel, lineno,
                                f"`import {module}` failed: {e}"))
      return
    if stmt.startswith("include "):
      try:
        target = ginlite.parse_value(stmt[len("include "):].strip())
      except ginlite.GinError as e:
        findings.append(Finding("GIN107", rel, lineno,
                                f"unparseable include: {e}"))
        return
      resolved = ginlite.resolve_config_path(
          str(target), including_dir=os.path.dirname(file_path))
      if resolved is None:
        findings.append(Finding(
            "GIN106", rel, lineno,
            f"include {target!r} not found on the config search path"))
        return
      walk(resolved)
      return
    m = ginlite._STATEMENT_RE.match(stmt)
    if not m:
      findings.append(Finding(
          "GIN107", rel, lineno,
          f"cannot parse config statement: {stmt.splitlines()[0]!r}"))
      return
    target = m.group("target").strip()
    try:
      value = ginlite.parse_value(m.group("value").strip())
    except ginlite.GinError as e:
      findings.append(Finding("GIN107", rel, lineno,
                              f"unparseable value: {e}"))
      return
    collect_refs(rel, lineno, value)
    _, _, rest = target.rpartition("/")
    if "." not in rest:
      macros_defined.add(target)
      return
    name, _, param = rest.rpartition(".")
    check_binding(rel, lineno, name, param)

  def walk(file_path: str) -> None:
    abs_path = os.path.abspath(file_path)
    if abs_path in visited:
      return
    visited.add(abs_path)
    rel = os.path.relpath(abs_path, root)
    try:
      with open(abs_path, encoding="utf-8") as f:
        text = f.read()
    except OSError as e:
      findings.append(Finding("GIN106", rel, 0, f"cannot read config: {e}"))
      return
    for stmt, lineno in ginlite.split_statements(text):
      check_statement(abs_path, rel, stmt, lineno)

  resolved = ginlite.resolve_config_path(path)
  walk(resolved or path)
  for rel, lineno, macro in macro_uses:
    if macro not in macros_defined:
      findings.append(Finding(
          "GIN103", rel, lineno,
          f"%{macro} is referenced but never defined in this config's "
          "include closure"))
  return findings

