"""Determinism/purity source lint, the ``L3xx`` rules (counterpart of
``repro/analysis/lint.py``, its rules retargeted to torch).

A single AST walk per file.  Rule scopes follow the layering of the
package: nondeterminism (L301/L302) and spec hygiene (L305/L306) apply to
ALL of ``src/repro_torch``; host-sync (L303) applies to the engine layers
whose code runs inside a step (optim / kernels / federation / core /
models / sharding); PRNG discipline (L304) applies to the round-loop layers
(optim / federation) where resume bit-exactness demands ``fold_in``-pure
draws.  A finding on a line carrying ``# analysis: ignore[L3xx]`` is
suppressed — the justified escape hatch for driver-side timing, host
decisions and init-time key fans.

What torch adds to the reference's rules: L302 also fires on torch's
global generator (``torch.manual_seed``, ``torch.seed``,
``torch.cuda.manual_seed*``, and the samplers ``torch.rand``/``randn``/
``randint``/``randperm``/``bernoulli``/``normal``/``multinomial`` called
without ``generator=``; a ``manual_seed`` on an explicit
``torch.Generator`` is not global); L303 treats an expression that names
``torch`` as a device value; L304 resolves the names under which a file
imports ``repro_torch.random`` (``from repro_torch import random as jr``
makes ``jr.split`` the key-chain split).
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional

from repro_torch.analysis.rules import Finding

#: layers whose code runs inside a step — host sync here stalls every step
#: (L303)
ENGINE_DIRS = ("optim", "kernels", "federation", "core", "models",
               "sharding")
#: layers holding the round loop — randomness here must be fold_in-pure
#: or resume/rollback replay diverges (L304)
ROUND_DIRS = ("optim", "federation")

_PACKAGE = "repro_torch"
_RANDOM_MODULE = (_PACKAGE, "random")

_IGNORE_RE = re.compile(r"#\s*analysis:\s*ignore\[([A-Z0-9,\s]+)\]")

# dotted-suffix ban lists: the last two components of the called name
_TIME_CALLS = {("time", "time"), ("time", "time_ns"),
               ("time", "perf_counter"), ("time", "perf_counter_ns"),
               ("time", "monotonic"), ("time", "monotonic_ns"),
               ("datetime", "now"), ("datetime", "utcnow"),
               ("date", "today"), ("os", "urandom")}
_NP_NAMES = ("np", "numpy")
_SPEC_SUFFIXES = ("Spec", "Config", "Cfg")
# torch's global generator: seeding it, and sampling from it
_TORCH_SEEDS = {("torch", "manual_seed"), ("torch", "seed"),
                ("torch", "random", "manual_seed"), ("torch", "random", "seed"),
                ("torch", "cuda", "manual_seed"),
                ("torch", "cuda", "manual_seed_all"),
                ("torch", "cuda", "seed"), ("torch", "cuda", "seed_all")}
_TORCH_SAMPLERS = ("rand", "randn", "randint", "randperm", "bernoulli",
                   "normal", "multinomial")


def _dotted(node: ast.AST) -> tuple:
    """("np", "random", "rand") for np.random.rand — () if not a name."""
    parts: list = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return ()


def _contains_torch_value(node: ast.AST) -> bool:
    return any(isinstance(n, ast.Name) and n.id == "torch"
               for n in ast.walk(node))


def _is_seedlike(node: ast.AST) -> bool:
    """PRNGKey arguments that are spec-derived or literal constants —
    the allowed key-creation forms (everything else is ad-hoc)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return True
    if isinstance(node, ast.Attribute) and node.attr.endswith("seed"):
        return True
    if isinstance(node, ast.Name) and node.id.endswith("seed"):
        return True
    return False


def _random_aliases(tree: ast.AST) -> Dict[str, tuple]:
    """Local name → the dotted path it stands for, for every name under
    which the file imports ``repro_torch.random`` or one of its
    functions."""
    out: Dict[str, tuple] = {}
    mod = ".".join(_RANDOM_MODULE)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == mod and a.asname:
                    out[a.asname] = _RANDOM_MODULE
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            for a in node.names:
                local = a.asname or a.name
                if node.module == _PACKAGE and a.name == "random":
                    out[local] = _RANDOM_MODULE
                elif node.module == mod:
                    out[local] = _RANDOM_MODULE + (a.name,)
    return out


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, lines: List[str], engine: bool,
                 round_loop: bool, aliases: Dict[str, tuple]):
        self.path = path
        self.lines = lines
        self.engine = engine
        self.round_loop = round_loop
        self.aliases = aliases
        self.findings: List[Finding] = []

    # -- helpers ------------------------------------------------------------

    def _ignored(self, rule: str, node: ast.AST) -> bool:
        for ln in {getattr(node, "lineno", 0),
                   getattr(node, "end_lineno", 0)}:
            if 1 <= ln <= len(self.lines):
                m = _IGNORE_RE.search(self.lines[ln - 1])
                if m and rule in m.group(1):
                    return True
        return False

    def _flag(self, rule: str, node: ast.AST, message: str) -> None:
        if not self._ignored(rule, node):
            self.findings.append(
                Finding(rule, f"{self.path}:{node.lineno}", message))

    def _resolved(self, d: tuple) -> tuple:
        """``d`` with a leading alias of ``repro_torch.random`` expanded."""
        if d and d[0] in self.aliases:
            return self.aliases[d[0]] + d[1:]
        return d

    # -- imports (L302: stdlib random) --------------------------------------

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            if a.name == "random":
                self._flag("L302", node,
                           "stdlib `random` imported — global-state RNG")
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module == "random" and node.level == 0:
            self._flag("L302", node,
                       "stdlib `random` imported — global-state RNG")
        self.generic_visit(node)

    # -- calls (L301, L302, L303, L304) -------------------------------------

    def _check_random(self, node: ast.Call, d: tuple) -> None:
        name = ".".join(d)
        if len(d) >= 2 and d[0] in _NP_NAMES and d[1] == "random":
            self._flag("L302", node, f"`{name}()` uses NumPy's global RNG")
        elif len(d) >= 2 and d[0] == "random":
            self._flag("L302", node,
                       f"`{name}()` uses the stdlib global RNG")
        elif d in _TORCH_SEEDS:
            self._flag("L302", node,
                       f"`{name}()` seeds torch's global generator")
        elif (len(d) == 2 and d[0] == "torch" and d[1] in _TORCH_SAMPLERS
              and not any(k.arg == "generator" for k in node.keywords)):
            self._flag("L302", node,
                       f"`{name}()` without generator= draws from torch's "
                       f"global generator")

    def visit_Call(self, node: ast.Call) -> None:
        d = _dotted(node.func)
        if d and d[-2:] in _TIME_CALLS:
            self._flag("L301", node,
                       f"`{'.'.join(d)}()` is wall-clock/OS "
                       f"nondeterminism")
        if d and d[0] not in self.aliases:
            self._check_random(node, d)
        if self.engine:
            # on any receiver, a call's result too (``x.sum().item()``,
            # which the reference's dotted-name test does not see)
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "item" and not node.args):
                self._flag("L303", node,
                           "`.item()` synchronizes the device value to "
                           "host")
            if (isinstance(node.func, ast.Name)
                    and node.func.id in ("float", "int") and node.args
                    and _contains_torch_value(node.args[0])):
                self._flag("L303", node,
                           f"`{node.func.id}()` on a torch value blocks on "
                           f"the device")
            if len(d) >= 2 and d[0] in _NP_NAMES and d[1] in ("asarray",
                                                              "array"):
                self._flag("L303", node,
                           f"`{'.'.join(d)}()` in engine code pulls its "
                           f"argument to host memory")
        r = self._resolved(d)
        if self.round_loop and len(r) >= 2 and r[-2] == "random":
            if r[-1] == "split":
                self._flag("L304", node,
                           f"`{'.'.join(d)}` carries a key chain — round "
                           f"randomness must be fold_in-derived")
            elif r[-1] in ("PRNGKey", "key") and node.args and not \
                    _is_seedlike(node.args[0]):
                self._flag("L304", node,
                           f"`{'.'.join(d)}({ast.unparse(node.args[0])})` "
                           f"creates a key from a non-seed value")
        self.generic_visit(node)

    # -- class defs (L305) ---------------------------------------------------

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        if node.name.endswith(_SPEC_SUFFIXES):
            for dec in node.decorator_list:
                d = _dotted(dec.func if isinstance(dec, ast.Call) else dec)
                if not d or d[-1] != "dataclass":
                    continue
                frozen = isinstance(dec, ast.Call) and any(
                    k.arg == "frozen"
                    and isinstance(k.value, ast.Constant)
                    and k.value.value is True for k in dec.keywords)
                if not frozen:
                    self._flag("L305", node,
                               f"spec dataclass `{node.name}` is not "
                               f"frozen=True")
        self.generic_visit(node)

    # -- function defs (L306) ------------------------------------------------

    def _check_defaults(self, node) -> None:
        a = node.args
        for dflt in list(a.defaults) + [d for d in a.kw_defaults if d]:
            bad = isinstance(dflt, (ast.List, ast.Dict, ast.Set))
            if isinstance(dflt, ast.Call):
                d = _dotted(dflt.func)
                bad = bad or (d in (("list",), ("dict",), ("set",))
                              and not dflt.args and not dflt.keywords)
            if bad:
                self._flag("L306", dflt,
                           f"mutable default in `{node.name}()` aliases "
                           f"across calls")

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._check_defaults(node)
        self.generic_visit(node)

    def visit_AsyncFunctionDef(self, node) -> None:
        self._check_defaults(node)
        self.generic_visit(node)


def _layer_of(path: str) -> Optional[str]:
    parts = os.path.normpath(path).split(os.sep)
    if _PACKAGE in parts:
        i = len(parts) - 1 - parts[::-1].index(_PACKAGE)
        if i + 1 < len(parts) - 1:
            return parts[i + 1]
    return None


def lint_source(src: str, path: str, *, engine: Optional[bool] = None,
                round_loop: Optional[bool] = None) -> List[Finding]:
    """Lint one file's source text.  ``engine``/``round_loop`` override the
    path-derived rule scopes (tests use this on temp files)."""
    layer = _layer_of(path)
    if engine is None:
        engine = layer in ENGINE_DIRS
    if round_loop is None:
        round_loop = layer in ROUND_DIRS
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Finding("L306", f"{path}:{e.lineno or 0}",
                        f"file does not parse: {e.msg}")]
    lt = _Linter(path, src.splitlines(), engine, round_loop,
                 _random_aliases(tree))
    lt.visit(tree)
    return lt.findings


def lint_paths(paths: Iterable[str]) -> List[Finding]:
    """Lint every ``.py`` under the given files/directories."""
    findings: List[Finding] = []
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs.sort()
                files.extend(os.path.join(root, n) for n in sorted(names)
                             if n.endswith(".py"))
        else:
            files.append(p)
    for f in files:
        with open(f) as fh:
            findings.extend(lint_source(fh.read(), f))
    return findings
