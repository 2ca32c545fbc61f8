"""AST convention linter of the port: the rules of the JAX package's
``repro.analysis.conventions`` that apply to a PyTorch/CUDA package.

Each rule is a pure source-level (or registry-introspection) check —
nothing here runs protocol code:

* **REP002** — numerics hygiene: no ``np.random.*`` and no ``float64``
  spellings inside ``core/protocol.py`` or ``kernels/*.py`` — the round
  math must stay deterministic-by-schedule and f32 (the host event
  process owns all randomness).
* **REP003** — spec immutability: every registered protocol spec class,
  plus ``ExecSpec`` / ``SweepSpec`` / ``fedsim.EnvSpec``, is a frozen
  dataclass (specs are hashable keys of schedules and checkpoints).
* **REP005** — kernel inventory, the counterpart of the reference's
  ``pallas_call`` alias inventory.  (a) Every ``extern "C"`` entry of
  ``csrc/*.cu`` has a row in ``kernels.backend._SIGNATURES``, and every
  row names an entry.  (b) Every ``LAUNCHES`` key is bumped by exactly
  one kernel wrapper, and every bump names a key; a row-loop wrapper
  ``X_rows``, which launches wrapper ``X``'s kernel once a row from one C
  call, counts under ``X``'s key.  (c) Every wrapper has an
  ``ALIAS_CONTRACTS`` entry in its module (the operands it may write in
  place), and every entry names a wrapper.
* **REP006** — env rng reuse: a built environment (``....build()``)
  feeding more than one ``run_sweep`` call — or more than one
  ``SweepMember`` — in a single scope of the port's source, its
  ``tests/test_torch_*.py`` or ``chip_smoke.py``.  ``Env.draw_rounds``
  raises on the second consume at run time; this flags the hazard at
  review time, on paths tests never execute.

A kernel wrapper is a public function of ``kernels/*.py`` that bumps a
``LAUNCHES`` key where it launches: directly (``LAUNCHES['k'] += 1``) or
through a private helper that takes the key as a parameter, which the
wrapper passes as a string literal.  ``kernel_wrappers`` returns that
inventory; the launch pass (``launch_checks``) counts and audits calls
into the same functions.
"""
from __future__ import annotations

import ast
import dataclasses
import functools
import pathlib
import re

from .report import Report

__all__ = ['check_conventions', 'kernel_wrappers']

#: repo root (…/src/repro_torch/analysis/conventions.py -> three parents up)
_ROOT = pathlib.Path(__file__).resolve().parents[3]
_PKG = pathlib.Path('src') / 'repro_torch'

_FLOAT64_NAMES = frozenset(
    ('torch.float64', 'torch.double', 'np.float64', 'numpy.float64',
     'np.double', 'numpy.double'))

#: ``int name(`` at the start of a line: a C entry's definition
_C_ENTRY = re.compile(r'^(?:int|cudaError_t)\s+(\w+)\s*\(', re.M)


def _parse(path: pathlib.Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _dotted(node) -> str:
    """'a.b.c' for an Attribute/Name chain, '' if not a plain chain."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return ''
    parts.append(node.id)
    return '.'.join(reversed(parts))


def _call_tail(call: ast.Call) -> str:
    """Last component of the called dotted name ('api.SafaSpec' ->
    'SafaSpec')."""
    d = _dotted(call.func)
    return d.rsplit('.', 1)[-1] if d else ''


def _rel(root: pathlib.Path, path: pathlib.Path, lineno: int) -> str:
    return f'{path.relative_to(root)}:{lineno}'


def _dict_keys(tree: ast.Module, name: str):
    """String keys of the module-level dict literal assigned to ``name``
    (None when the module has no such assignment)."""
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name
                for t in node.targets) and isinstance(node.value, ast.Dict):
            return [k.value for k in node.value.keys
                    if isinstance(k, ast.Constant)]
    return None


# ---------------------------------------------------------------------------
# REP002 — numerics hygiene in round math and kernels
# ---------------------------------------------------------------------------

def _rep002(rep: Report, root: pathlib.Path) -> None:
    targets = [root / _PKG / 'core' / 'protocol.py']
    targets += sorted((root / _PKG / 'kernels').glob('*.py'))
    for path in targets:
        tree = _parse(path)
        hits = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Attribute):
                continue
            d = _dotted(node)
            if d.startswith(('np.random.', 'numpy.random.')) \
                    or d in ('np.random', 'numpy.random'):
                hits.append((node.lineno, f'{d} (host rng belongs in the '
                             f'fedsim event process, not round math)'))
            elif d in _FLOAT64_NAMES:
                hits.append((node.lineno, f'{d} (the round state is f32; '
                             f'f64 doubles resident bytes and leaves the '
                             f'kernels\' dtype)'))
        if hits:
            for lineno, why in hits:
                rep.add('REP002', _rel(root, path, lineno), False, why)
        else:
            rep.add('REP002', str(path.relative_to(root)), True,
                    'no np.random.* / float64 spellings')


# ---------------------------------------------------------------------------
# REP003 — specs are frozen dataclasses
# ---------------------------------------------------------------------------

def _rep003(rep: Report) -> None:
    from repro_torch import api, fedsim
    classes = sorted(api.PROTOCOLS, key=lambda c: c.__name__)
    classes += [api.ExecSpec, api.SweepSpec, fedsim.EnvSpec]
    for cls in classes:
        frozen = dataclasses.is_dataclass(cls) \
            and cls.__dataclass_params__.frozen
        rep.add('REP003', cls.__name__, frozen,
                'frozen dataclass' if frozen else
                'not a frozen dataclass — specs are hashable keys of '
                'schedules and checkpoints, so they must be immutable')


# ---------------------------------------------------------------------------
# REP005 — the kernel inventory: C entries, launch counters, in-place writes
# ---------------------------------------------------------------------------

def _launch_key(node):
    """The subscript of ``LAUNCHES[...] += ...`` (an ``ast`` node), or
    None when ``node`` is not such a bump."""
    if isinstance(node, ast.AugAssign) \
            and isinstance(node.target, ast.Subscript) \
            and _dotted(node.target.value).rsplit('.', 1)[-1] == 'LAUNCHES':
        return node.target.slice
    return None


def _literal_arg(call: ast.Call, fn: ast.FunctionDef, param: str):
    """The string literal ``call`` passes for ``fn``'s parameter
    ``param`` (positionally or by keyword), else None."""
    names = [a.arg for a in fn.args.args]
    for kw in call.keywords:
        if kw.arg == param and isinstance(kw.value, ast.Constant):
            return kw.value.value
    i = names.index(param)
    if i < len(call.args) and isinstance(call.args[i], ast.Constant):
        return call.args[i].value
    return None


def _module_bumps(tree: ast.Module):
    """[(function name, LAUNCHES key, lineno)] of one kernel module: the
    public functions' direct bumps, and their calls into private helpers
    that bump a key they take as a parameter."""
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    direct, helpers = [], {}
    for name, fn in fns.items():
        params = {a.arg for a in fn.args.args}
        for node in ast.walk(fn):
            key = _launch_key(node)
            if key is None:
                continue
            if isinstance(key, ast.Constant):
                direct.append((name, key.value, node.lineno))
            elif isinstance(key, ast.Name) and key.id in params:
                helpers[name] = key.id
    out = [b for b in direct if not b[0].startswith('_')]
    for name, fn in fns.items():
        if name.startswith('_'):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                    and node.func.id in helpers:
                key = _literal_arg(node, fns[node.func.id],
                                   helpers[node.func.id])
                out.append((name, key, node.lineno))
    return out


@functools.lru_cache(maxsize=None)
def kernel_wrappers(root=None) -> dict:
    """{wrapper function name: (module name, LAUNCHES key)} over the
    port's kernel modules (see the module docstring)."""
    root = pathlib.Path(root) if root is not None else _ROOT
    out = {}
    for path in sorted((root / _PKG / 'kernels').glob('*.py')):
        for fn, key, _ in _module_bumps(_parse(path)):
            out[fn] = (f'repro_torch.kernels.{path.stem}', key)
    return out


def _extern_blocks(text: str):
    """The bodies of the ``extern "C" { ... }`` blocks of a source,
    found by brace matching."""
    for m in re.finditer(r'extern "C"\s*\{', text):
        depth, i = 1, m.end()
        while depth and i < len(text):
            depth += {'{': 1, '}': -1}.get(text[i], 0)
            i += 1
        yield text[m.end():i - 1]


def _c_entries(root: pathlib.Path) -> dict:
    """{C entry name: file} over the ``extern "C"`` blocks of csrc."""
    out = {}
    for path in sorted((root / _PKG / 'csrc').glob('*.cu')):
        for block in _extern_blocks(path.read_text()):
            for name in _C_ENTRY.findall(block):
                out[name] = path.relative_to(root)
    return out


def _rep005(rep: Report, root: pathlib.Path) -> None:
    kernels = root / _PKG / 'kernels'
    backend_py = kernels / 'backend.py'
    btree = _parse(backend_py)
    subject = str(backend_py.relative_to(root))

    # (a) the C entries against _SIGNATURES
    entries = _c_entries(root)
    signed = set(_dict_keys(btree, '_SIGNATURES') or ())
    for name in sorted(set(entries) - signed):
        rep.add('REP005', f'{entries[name]}:{name}', False,
                f'C entry {name!r} has no row in backend._SIGNATURES (its '
                f'argument types would be guessed by ctypes)')
    for name in sorted(signed - set(entries)):
        rep.add('REP005', f'{subject}:_SIGNATURES[{name!r}]', False,
                f'_SIGNATURES row {name!r} names no extern "C" entry of '
                f'csrc/*.cu')
    if set(entries) == signed:
        rep.add('REP005', f'{subject}:_SIGNATURES', True,
                f'{len(signed)} C entries, each with its signature row')

    # (b) every LAUNCHES key bumped by exactly one wrapper
    keys = _dict_keys(btree, 'LAUNCHES') or []
    by_key: dict = {}
    bad_bumps = 0
    modules = sorted(kernels.glob('*.py'))
    trees = {path: _parse(path) for path in modules}
    for path, tree in trees.items():
        for fn, key, lineno in _module_bumps(tree):
            if key not in keys:
                bad_bumps += 1
                rep.add('REP005', _rel(root, path, lineno), False,
                        f'{fn} bumps LAUNCHES[{key!r}], which backend.py '
                        f'does not declare')
                continue
            by_key.setdefault(key, set()).add(fn)
    bad_keys = 0
    for key in keys:
        fns = by_key.get(key, set())
        ok = len(fns) == 1 or (key in fns
                               and fns <= {key, f'{key}_rows'})
        if not ok:
            bad_keys += 1
            rep.add('REP005', f'{subject}:LAUNCHES[{key!r}]', False,
                    f'bumped by {sorted(fns) or "no wrapper"}: a launch '
                    f'count must name one kernel wrapper (or its row '
                    f'loop, {key}_rows)')
    if not bad_keys and not bad_bumps:
        rep.add('REP005', f'{subject}:LAUNCHES', True,
                f'{len(keys)} launch counters, each bumped by one wrapper '
                f'(or its row loop)')

    # (c) every wrapper in its module's ALIAS_CONTRACTS, and the reverse
    for path, tree in trees.items():
        fns = sorted({fn for fn, _, _ in _module_bumps(tree)})
        if not fns:
            continue
        contracts = _dict_keys(tree, 'ALIAS_CONTRACTS')
        sub = str(path.relative_to(root))
        if contracts is None:
            rep.add('REP005', sub, False,
                    f'{len(fns)} kernel wrapper(s) but no module '
                    f'ALIAS_CONTRACTS inventory')
            continue
        missing = [f for f in fns if f not in contracts]
        extra = [c for c in contracts if c not in fns]
        if missing:
            rep.add('REP005', sub, False,
                    f'wrappers {missing} missing from ALIAS_CONTRACTS')
        if extra:
            rep.add('REP005', sub, False,
                    f'ALIAS_CONTRACTS names {extra}, which are not kernel '
                    f'wrappers of this module')
        if not missing and not extra:
            rep.add('REP005', sub, True,
                    f'{len(fns)} kernel wrapper(s) all in inventory')


# ---------------------------------------------------------------------------
# REP006 — built env reused across run_sweep calls / members
# ---------------------------------------------------------------------------

def _scope_walk(scope):
    """Walk a scope's statements without descending into nested
    function/class scopes (their reuse is judged separately)."""
    stack = list(scope.body)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.ClassDef)):
                stack.append(child)


def _built_env_names(scope) -> dict:
    """var name -> lineno for ``x = <...>.build()`` assignments in this
    scope."""
    out = {}
    for node in _scope_walk(scope):
        if not (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)):
            continue
        fn = node.value.func
        if not (isinstance(fn, ast.Attribute) and fn.attr == 'build'):
            continue
        for t in node.targets:
            if isinstance(t, ast.Name):
                out[t.id] = node.lineno
    return out


def _names_in(node) -> set:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _rep006_scope(rep: Report, root: pathlib.Path,
                  path: pathlib.Path, scope) -> int:
    built = _built_env_names(scope)
    if not built:
        return 0
    uses: dict = {}
    for node in _scope_walk(scope):
        if not isinstance(node, ast.Call):
            continue
        tail = _call_tail(node)
        if tail not in ('run_sweep', 'SweepMember'):
            continue
        args = list(node.args) + [kw.value for kw in node.keywords]
        for name in set().union(*(_names_in(a) for a in args)):
            if name in built:
                uses.setdefault((name, tail), []).append(node.lineno)
    fails = 0
    for (name, tail), lines in sorted(uses.items()):
        if len(lines) > 1:
            fails += 1
            rep.add('REP006', _rel(root, path, min(lines)), False,
                    f'built env {name!r} (line {built[name]}) feeds '
                    f'{len(lines)} {tail} calls (lines {sorted(lines)}); '
                    f'draw_rounds is single-shot per built env — build a '
                    f'fresh env per sweep or pass the EnvSpec')
    return fails


def _rep006(rep: Report, root: pathlib.Path) -> None:
    files = sorted((root / _PKG).rglob('*.py'))
    files += sorted((root / 'tests').glob('test_torch_*.py'))
    files += [p for p in (root / 'chip_smoke.py',) if p.exists()]
    fails = 0
    for path in files:
        tree = _parse(path)
        scopes = [tree] + [n for n in ast.walk(tree)
                           if isinstance(n, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))]
        for scope in scopes:
            fails += _rep006_scope(rep, root, path, scope)
    if not fails:
        rep.add('REP006', 'repro_torch', True,
                f'{len(files)} files scanned, no built env feeds multiple '
                f'run_sweep calls or members')


# ---------------------------------------------------------------------------
# The pass
# ---------------------------------------------------------------------------

def check_conventions(root=None) -> Report:
    """Run REP002, REP003, REP005 and REP006 over the repo tree (or the
    tree at ``root``: REP003 reads the imported registry whatever the
    root)."""
    root = pathlib.Path(root) if root is not None else _ROOT
    rep = Report()
    _rep002(rep, root)
    _rep003(rep)
    _rep005(rep, root)
    _rep006(rep, root)
    return rep
