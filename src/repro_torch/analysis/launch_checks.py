"""Launch contract checker of the port, the counterpart of the JAX
package's ``repro.analysis.jaxpr_checks``: run every admitted engine
cell of the registry and prove the invariants the kernels and a later
CUDA graph capture rely on.

The JAX package traces each cell's segment program and walks the jaxpr;
the port has no program to trace, so it runs the cell instead — two
segments of two rounds at the reference's tiny shapes (the m = 5
regression task), through ``CompiledRunner.run`` (engine ``'scan'``) or
``CompiledRunner.run_sweep`` (engine ``'fleet'``, two members, each its
own freshly built env), with the registry's own segment function wrapped
to watch it.  Inside each segment every aten op is recorded by a
``TorchDispatchMode`` (its name, its outputs' shapes, dtypes and
``data_ptr``s, the arguments it writes), and every call into a kernel
wrapper (``conventions.kernel_wrappers``) is counted and audited:

* **T001** (JAX001) — launch budget: kernel calls per round equal
  ``ProtocolDef.dispatch_budget(ex)``.  On the CPU the calls are the
  entries into the kernel wrappers (each launches its kernel on the
  card); on the card also the change of ``kernels.backend.LAUNCHES``,
  which must equal the entries.  Cells with no declared budget (the
  per-leaf kernel path) report the count measured.
* **T002** (JAX002) — the in-place carry stays in place: every buffer
  the state names in ``in_place`` keeps its ``data_ptr``s across both
  segments (the counterpart of a donation XLA honours).  A cell whose
  state names none reports the rule not applicable.
* **T003** (JAX003) — in-place claims: every wrapper the registration
  claims (``ProtocolDef.alias_claims(ex)``) is called and returns its
  claimed operand in place (an output with the operand's ``data_ptr``),
  and every wrapper call writes in place only what its module's
  ``ALIAS_CONTRACTS`` admits.  A write is an output aliasing an operand,
  an aten op writing an operand's storage, or an operand whose bytes
  changed across the call.  A cell with no claim and no wrapper call
  reports the rule not applicable.
* **T004** (JAX004) — no float64 op output anywhere in the segments.
* **T005** (JAX005) — no host sync inside a segment: no
  ``aten._local_scalar_dense`` (``.item()``, ``bool()`` of a tensor), no
  op that reads a value back to the host, no copy from the card to the
  CPU; on the card the segment also runs under
  ``torch.cuda.set_sync_debug_mode('error')``.
* **T006** (JAX006) — the recorded op sequence (names, output shapes and
  dtypes) of rounds [0, 2) equals that of rounds [2, 4): the
  precondition for capturing a segment once as a CUDA graph and
  replaying it.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import importlib
import inspect
import sys
from typing import NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import api, fedsim
from repro_torch.kernels import backend

from .conventions import kernel_wrappers
from .report import Report

__all__ = ['Cell', 'CellRun', 'check_cells', 'iter_cells', 'precompute_cell',
           'run_cell']

#: tiny-shape cell environment (the JAX package's analysis sizes)
TINY_ENV = dict(m=5, crash_prob=0.3, dataset_size=506, batch_size=5,
                epochs=3, t_lim=830.0)
ROUNDS = 4          # 2 segments of...
SEG = 2             # ...2 rounds each
ENV_SEED = 3
FLEET_SIZE = 2

ENGINES = ('scan', 'fleet')
SCHEDULES = ('dense', 'sparse', 'sparse_delta', 'sparse_tier')
WIRES = ('f32', 'int8')
KERNELS = (False, True, 'packed')

#: aten ops that hand a value back to the host (a sync on the card)
_HOST_READS = frozenset(('_local_scalar_dense', 'equal', 'is_nonzero',
                         'allclose', 'item'))

_TASKS: dict = {}


def _tiny_env_spec(seed: int = ENV_SEED) -> fedsim.EnvSpec:
    return fedsim.EnvSpec(seed=seed, **TINY_ENV)


def _tiny_task(device='cpu'):
    """One m = 5 regression task per device, shared by the cells: the JAX
    package's ``_tiny_task`` (the same data, partition and learning rate)
    with one local epoch instead of three.  The reference traces a cell
    and this pass runs it: a second and a third epoch repeat the first's
    op sequence and would treble the pass's time, most of it training."""
    device = backend.resolve_device(device)
    if device not in _TASKS:
        from repro_torch.data import make_regression, partition
        from repro_torch.data.tasks import regression_task
        env = _tiny_env_spec().build()
        x, y = make_regression()
        data = partition(x, y, env.partition_sizes, env.m, seed=1)
        _TASKS[device] = regression_task(data, lr=1e-3, epochs=1,
                                         device=device)
    return _TASKS[device]


# ---------------------------------------------------------------------------
# Cell enumeration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Cell:
    """One admitted (protocol, engine, wire, schedule, use_kernel)
    configuration; ``label`` is the JAX package's, letter for letter."""
    pdef: api.ProtocolDef
    spec: object
    ex: api.ExecSpec

    @property
    def label(self) -> str:
        ex = self.ex
        return (f'{self.pdef.name}[{ex.engine}/{ex.schedule}/{ex.wire}/'
                f'kernel={ex.use_kernel}]')


def iter_cells(names=None) -> list:
    """Every cell ``check_compat`` admits, for every registered spec (or
    the named subset), in the JAX package's order."""
    cells = []
    for pdef in api.PROTOCOLS.values():
        if names is not None and pdef.name not in names:
            continue
        spec = pdef.spec_cls()
        for engine in ENGINES:
            for schedule in SCHEDULES:
                for wire in WIRES:
                    for kern in KERNELS:
                        ex = api.ExecSpec(engine=engine, wire=wire,
                                          use_kernel=kern, schedule=schedule,
                                          eval_every=SEG)
                        try:
                            api.check_compat(spec, ex)
                        except (ValueError, TypeError):
                            continue
                        cells.append(Cell(pdef, spec, ex))
    return cells


def _members(spec) -> list:
    """The fleet cells' members: each replays ``spec`` (hypers in the
    member columns, the staleness-adaptive family's other fields in
    ``overrides``) on a declarative env of its own seed, which the sweep
    builds fresh."""
    members = []
    for s in range(FLEET_SIZE):
        kw = dict(seed=s)
        for f in ('fraction', 'lag_tolerance', 'alpha', 'staleness_exp'):
            if hasattr(spec, f):
                kw[f] = getattr(spec, f)
        if hasattr(spec, 'staleness_fn'):
            kw['overrides'] = {
                f.name: getattr(spec, f.name)
                for f in dataclasses.fields(spec)
                if f.name not in ('fraction', 'lag_tolerance', 'alpha',
                                  'staleness_exp')}
        members.append(api.SweepMember(env=_tiny_env_spec(ENV_SEED + s),
                                       **kw))
    return members


def precompute_cell(cell: Cell):
    """The cell's host-precomputed schedule, exactly as the runners build
    it (scan: ``Experiment.precompute``; fleet: ``fleet_precompute`` plus
    the sparse or tier form) — the input of the schedule pass.  Host
    work only: no task, no device."""
    from repro_torch.core.api import _resolve_member
    pdef, ex = cell.pdef, cell.ex
    if ex.engine == 'scan':
        exp = api.Experiment(None, _tiny_env_spec(), cell.spec, ex,
                             rounds=ROUNDS, seed=0, device='cpu')
        return exp.precompute()
    members = [_resolve_member(mem, pdef=pdef, task=None, ex=ex)
               for mem in _members(cell.spec)]
    fleet = pdef.fleet_precompute(members, cell.spec, rounds=ROUNDS)
    if ex.schedule == 'sparse_tier':
        return fleet.to_tier()
    if ex.schedule != 'dense':
        return fleet.to_sparse()
    return fleet


# ---------------------------------------------------------------------------
# Recording
# ---------------------------------------------------------------------------

class Op(NamedTuple):
    """One recorded aten op: its name, its tensor outputs' (shape, dtype,
    on the card, data_ptr), the storages of the arguments it writes, and
    whether it copied a value from the card to the host."""
    name: str
    outs: tuple
    writes: tuple
    to_host: bool

    @property
    def signature(self) -> tuple:
        return (self.name, tuple(o[:2] for o in self.outs))


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _tensors(x) -> list:
    """The tensors of an op's arguments or outputs (tensors, possibly in
    lists and tuples)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


@functools.lru_cache(maxsize=None)
def _op_info(func) -> tuple:
    """An aten op's name and the (position, name) of the arguments it
    writes."""
    return func.overloadpacket.__name__, tuple(
        (i, a.name) for i, a in enumerate(func._schema.arguments)
        if a.alias_info is not None and a.alias_info.is_write)


class _Recorder(TorchDispatchMode):
    """Records every aten op run under it (unless paused)."""

    def __init__(self, cuda: bool = False):
        super().__init__()
        self.ops: list = []
        self.paused = 0
        self.cuda = cuda

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.paused:
            return out
        name, written = _op_info(func)
        writes = tuple(_storage(t) for i, arg in written
                       for t in _tensors(kwargs.get(
                           arg, args[i] if i < len(args) else None)))
        outs = tuple((t.shape, t.dtype, t.is_cuda, t.data_ptr())
                     for t in _tensors(out))
        to_host = self.cuda and not all(o[2] for o in outs) and any(
            t.is_cuda
            for t in _tensors(args) + _tensors(list(kwargs.values())))
        self.ops.append(Op(name, outs, writes, to_host))
        return out

    @contextlib.contextmanager
    def pause(self):
        """Run the instrumentation's own ops unrecorded (and, on the card,
        outside the sync debug mode: they read values back)."""
        self.paused += 1
        mode = torch.cuda.get_sync_debug_mode() \
            if torch.cuda.is_available() else 0
        if mode:
            torch.cuda.set_sync_debug_mode(0)
        try:
            yield
        finally:
            if mode:
                torch.cuda.set_sync_debug_mode(mode)
            self.paused -= 1


@dataclasses.dataclass
class Call:
    """One call into a kernel wrapper: the operands it returned in place
    (an output with the operand's ``data_ptr``) and all it wrote."""
    wrapper: str
    returned: frozenset
    written: frozenset


def _same_bytes(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit equality (NaNs included) of two tensors of one shape and
    dtype."""
    if not a.numel():
        return True
    a, b = a.contiguous().reshape(-1), b.contiguous().reshape(-1)
    if a.dtype == torch.bool:
        a, b = a.view(torch.uint8), b.view(torch.uint8)
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


class _Audit:
    """Counts and audits the calls into the kernel wrappers while
    installed: every module of the port that holds a wrapper under its
    name gets a stand-in that records the call and runs the wrapper."""

    def __init__(self, recorder: _Recorder):
        self.recorder = recorder
        self.calls: list = []
        self.depth = 0

    def _stand_in(self, name, fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def audited(*args, **kwargs):
            if self.depth:
                return fn(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            operands = {k: v for k, v in bound.arguments.items()
                        if isinstance(v, torch.Tensor)}
            with self.recorder.pause():
                before = {k: v.detach().clone() for k, v in operands.items()}
            start = len(self.recorder.ops)
            self.depth += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                self.depth -= 1
            with self.recorder.pause():
                ptrs = {t.data_ptr() for t in tree_flatten(out)[0]
                        if isinstance(t, torch.Tensor) and t.data_ptr()}
                returned = {k for k, v in operands.items()
                            if v.data_ptr() and v.data_ptr() in ptrs}
                stores = {s for op in self.recorder.ops[start:]
                          for s in op.writes}
                written = set(returned)
                written |= {k for k, v in operands.items()
                            if _storage(v) in stores}
                written |= {k for k, v in operands.items()
                            if not _same_bytes(before[k], v)}
            self.calls.append(Call(name, frozenset(returned),
                                   frozenset(written)))
            return out
        return audited

    @contextlib.contextmanager
    def installed(self):
        importlib.import_module('repro_torch.kernels.ops')
        originals = {}
        for name, (modname, _) in kernel_wrappers().items():
            fn = getattr(importlib.import_module(modname), name)
            originals[name] = (fn, self._stand_in(name, fn))
        _swap({fn: stand_in for fn, stand_in in originals.values()})
        try:
            yield self
        finally:
            # also modules first imported in the segment, which took the
            # stand-ins in with their imports
            _swap({stand_in: fn for fn, stand_in in originals.values()})


def _swap(table: dict) -> None:
    """In every loaded module of the port, replace each attribute that is
    a key of ``table`` by its value."""
    by_id = {id(k): v for k, v in table.items()}
    for mod in list(sys.modules.values()):
        if not getattr(mod, '__name__', '').startswith('repro_torch'):
            continue
        for name, val in list(vars(mod).items()):
            if id(val) in by_id:
                setattr(mod, name, by_id[id(val)])


@dataclasses.dataclass
class Segment:
    """What one watched segment did."""
    ops: list
    calls: list
    launches: int           # change of backend.LAUNCHES (the card)
    rounds: int             # calls into the train function
    in_place: dict          # state entry -> data_ptrs, before and after
    sync_error: str = ''    # the sync debug mode's error (the card)


@dataclasses.dataclass
class CellRun:
    """The two watched segments of one cell."""
    cell: Cell
    device: torch.device
    segments: list


def _ptrs(entry) -> tuple:
    return tuple(t.data_ptr() for t in tree_flatten(entry)[0]
                 if isinstance(t, torch.Tensor))


def _in_place_ptrs(st) -> dict:
    """{in_place buffer ('cache', or one member of a tuple entry,
    'packed/1'): its data_ptrs}."""
    out = {}
    for name, i in st.in_place:
        entry = getattr(st, name)
        if i is None:
            out[name] = _ptrs(entry)
        else:
            out[f'{name}/{i}'] = _ptrs(entry[i])
    return out


def run_cell(cell: Cell, device='cuda') -> CellRun:
    """Run ``cell`` for two segments of ``SEG`` rounds through
    ``CompiledRunner.run`` or ``run_sweep``, each segment watched, on
    the card unless the caller passes ``device='cpu'``."""
    device = backend.resolve_device(device)
    task = _tiny_task(device)
    pdef, ex = cell.pdef, cell.ex
    segments = []

    def watched(st, seg, weights, train_fn, ex_, ctx):
        rounds = [0]

        def counted_train(*a, **k):
            rounds[0] += 1
            return train_fn(*a, **k)

        cuda = device.type == 'cuda'
        recorder = _Recorder(cuda)
        audit = _Audit(recorder)
        before = _in_place_ptrs(st)
        launches = sum(backend.LAUNCHES.values())
        sync_error = ''
        if cuda:
            torch.cuda.synchronize(device)
        with audit.installed(), recorder:
            if cuda:
                torch.cuda.set_sync_debug_mode('error')
            try:
                pdef.segment(st, seg, weights, counted_train, ex_, ctx)
            except RuntimeError as e:
                if not cuda or 'synchroniz' not in str(e):
                    raise
                sync_error = str(e).splitlines()[0]
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode(0)
        if cuda:
            torch.cuda.synchronize(device)
        after = _in_place_ptrs(st)
        segments.append(Segment(
            recorder.ops, audit.calls,
            sum(backend.LAUNCHES.values()) - launches, rounds[0],
            {k: (v, after[k]) for k, v in before.items()}, sync_error))

    exp = api.Experiment(task, _tiny_env_spec() if ex.engine == 'scan'
                         else None, cell.spec, ex, rounds=ROUNDS, seed=0,
                         device=device)
    runner = exp.compile()
    runner._pdef = dataclasses.replace(pdef, segment=watched)
    if ex.engine == 'scan':
        runner.run()
    else:
        runner.run_sweep(_members(cell.spec))
    return CellRun(cell, device, segments)


# ---------------------------------------------------------------------------
# The rules
# ---------------------------------------------------------------------------

def _contracts() -> dict:
    out = {}
    for name, (modname, _) in kernel_wrappers().items():
        inv = getattr(importlib.import_module(modname), 'ALIAS_CONTRACTS', {})
        out[name] = inv.get(name)
    return out


def _t001(rep, label, run: CellRun, budget) -> None:
    segs = run.segments
    calls = [len(s.calls) for s in segs]
    rounds = [s.rounds for s in segs]
    per_round = [c / r if r else float(c) for c, r in zip(calls, rounds)]
    by = collections.Counter(c.wrapper for s in segs for c in s.calls)
    detail = (f'{per_round[0]:g} kernel calls/round over {sum(rounds)} '
              f'rounds ({dict(sorted(by.items()))})')
    if run.device.type == 'cuda':
        launches = [s.launches for s in segs]
        detail += f'; LAUNCHES +{sum(launches)}'
        if launches != calls:
            rep.add('T001', label, False,
                    f'{detail}: LAUNCHES changed by {launches} for '
                    f'{calls} wrapper calls (a call that did not launch)')
            return
    if rounds != [SEG] * len(segs):
        rep.add('T001', label, False,
                f'{detail}: segments ran {rounds} rounds, want {SEG} each')
        return
    if budget is None:
        rep.add('T001', label, per_round[0] == per_round[-1],
                f'no budget declared ({detail})')
        return
    ok = all(c == budget * r for c, r in zip(calls, rounds))
    rep.add('T001', label, ok, f'{detail} vs budget {budget}')


def _t002(rep, label, run: CellRun) -> None:
    entries = {}
    for s in run.segments:
        for name, (a, b) in s.in_place.items():
            entries.setdefault(name, []).extend([a, b])
    if not entries:
        rep.not_applicable('T002', label, 'no in-place carry in this cell')
        return
    moved = sorted(n for n, ptrs in entries.items()
                   if len(set(ptrs)) != 1 or not ptrs[0])
    if moved:
        rep.add('T002', label, False,
                f'in-place carry {moved} moved to new memory across the '
                f'segments (the rounds copy what they should update)')
    else:
        rep.add('T002', label, True,
                f'in-place carry {sorted(entries)} kept its data_ptrs '
                f'across {len(run.segments)} segments')


def _t003(rep, label, run: CellRun, claims: dict) -> None:
    contracts = _contracts()
    calls = [c for s in run.segments for c in s.calls]
    if not claims and not calls:
        rep.not_applicable('T003', label,
                           'no claim and no kernel wrapper call')
        return
    for wrapper, operands in sorted(claims.items()):
        mine = [c for c in calls if c.wrapper == wrapper]
        if not mine:
            rep.add('T003', label, False,
                    f'claimed wrapper {wrapper} was never called')
            return
        short = [c for c in mine if not set(operands) <= c.returned]
        if short:
            rep.add('T003', label, False,
                    f'{wrapper} returned {sorted(short[0].returned)} in '
                    f'place, claimed {list(operands)}')
            return
    for c in calls:
        forms = contracts.get(c.wrapper)
        if forms is None:
            rep.add('T003', label, False,
                    f'{c.wrapper} has no ALIAS_CONTRACTS entry')
            return
        if not any(c.written == frozenset(f) for f in forms):
            rep.add('T003', label, False,
                    f'{c.wrapper} wrote {sorted(c.written)} in place, not '
                    f'admitted by its ALIAS_CONTRACTS entry {forms}')
            return
    rep.add('T003', label, True,
            f'{len(claims)} claim(s) held, {len(calls)} wrapper call(s) '
            f'all in inventory')


def _t004(rep, label, run: CellRun) -> None:
    for s in run.segments:
        for op in s.ops:
            for shape, dtype, _, _ in op.outs:
                if dtype == torch.float64:
                    rep.add('T004', label, False,
                            f'{op.name} produces float64 {list(shape)}')
                    return
    rep.add('T004', label, True, 'no float64 op outputs')


def _t005(rep, label, run: CellRun) -> None:
    for s in run.segments:
        if s.sync_error:
            rep.add('T005', label, False,
                    f'sync debug mode: {s.sync_error}')
            return
        for op in s.ops:
            if op.name in _HOST_READS or op.to_host:
                rep.add('T005', label, False,
                        f'{op.name} reads a value back to the host inside '
                        f'a segment (a sync every round)')
                return
    rep.add('T005', label, True, 'no host syncs inside the segments')


def _t006(rep, label, run: CellRun) -> None:
    a, b = ([op.signature for op in s.ops] for s in run.segments[:2])
    if a == b:
        rep.add('T006', label, True,
                f'rounds [0, {SEG}) and [{SEG}, {2 * SEG}) run the same '
                f'{len(a)} ops')
        return
    i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
             min(len(a), len(b)))
    rep.add('T006', label, False,
            f'the segments differ at op {i} of {len(a)} / {len(b)}: '
            f'{a[i] if i < len(a) else None} vs '
            f'{b[i] if i < len(b) else None}')


def check_cells(names=None, *, device='cuda', cells=None) -> Report:
    """Run T001-T006 over every admitted cell of the registry (or the
    named protocols, or ``cells``) on ``device``."""
    rep = Report()
    for cell in (cells if cells is not None else iter_cells(names)):
        label = cell.label
        try:
            run = run_cell(cell, device)
        except Exception as e:      # a cell that fails must not end the pass
            rep.add('T001', label, False,
                    f'cell failed to run: {type(e).__name__}: {e}')
            continue
        pdef, ex = cell.pdef, cell.ex
        budget = pdef.dispatch_budget(ex) \
            if pdef.dispatch_budget is not None else None
        claims = pdef.alias_claims(ex) \
            if pdef.alias_claims is not None else {}
        _t001(rep, label, run, budget)
        _t002(rep, label, run)
        _t003(rep, label, run, claims or {})
        _t004(rep, label, run)
        _t005(rep, label, run)
        _t006(rep, label, run)
    return rep
