"""Experiment API of the port: declarative specs -> host precompute ->
the SAFA engines on the device.

    from repro_torch import api

    exp = api.Experiment(task, env,
                         api.SafaSpec(fraction=0.5, lag_tolerance=5),
                         api.ExecSpec(eval_every=15),
                         rounds=60)
    hist = exp.compile().run()
    # S = 4 runs as one fleet, each member with its own env and seed
    hists = exp.compile().run_sweep([api.SweepMember(env=env_spec, seed=s)
                                     for s in range(4)])

The port runs the SAFA cells of ``repro.api`` on the dense schedule:
``engine`` None/'scan'/'loop' for ``run()`` and None/'fleet'/'sequential'
for ``run_sweep()``, ``use_kernel`` False/True/'packed' and ``wire``
'f32'/'int8'; ``ExecSpec(numeric=False)`` gives the timing records
alone.  ``check_compat`` raises ``NotImplementedError``, naming the
ROADMAP queue item, for every cell not ported yet.

``Experiment`` takes ``device=`` (default ``'cuda'``; it raises without a
card) and ``init_params=``: a param dict to start from, or a callable
``seed -> param dict`` (each sweep member then starts from its own seed's
params); ``None`` means the task's own seeded init.  JAX's PRNG cannot be
reproduced in torch, so a run that must match the JAX package passes the
reference's init here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from repro_torch import fedsim
from repro_torch.convert import params_from_jax
from repro_torch.core import federation, protocol
from repro_torch.core.federation import Task
from repro_torch.core.schedules import History, RoundRecord, SweepMember
from repro_torch.kernels.backend import resolve_device

__all__ = [
    'CompiledRunner', 'ExecSpec', 'Experiment', 'History', 'ProtocolSpec',
    'RoundRecord', 'SafaSpec', 'SweepMember', 'SweepSpec', 'Task',
    'check_compat', 'init_fleet_global',
]


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ProtocolSpec:
    """Base class for protocol specs: protocol-semantic fields only —
    execution knobs live in ``ExecSpec``."""


@dataclasses.dataclass(frozen=True)
class SafaSpec(ProtocolSpec):
    """SAFA (the paper's protocol): post-training CFCFM selection at
    quota C*m, Eq. 3 lag-tolerant distribution, Eq. 6-8 three-bypass
    aggregation.  ``quantize_uploads`` (the per-leaf int8 reference of
    ``wire='int8'``) is not ported yet."""
    fraction: float = 0.5
    lag_tolerance: int = 5
    quantize_uploads: bool = False


@dataclasses.dataclass(frozen=True)
class ExecSpec:
    """Execution knobs, orthogonal to protocol semantics.

    ``engine=None`` resolves to ``'scan'`` for ``run()``: the segment
    engine replaying the device-resident schedule; ``'loop'`` is the
    per-round reference and equals it bit for bit.  For ``run_sweep()`` it
    resolves to ``'fleet'``: all S members in one round body, one launch
    of each kernel per round for the whole fleet; ``'sequential'`` runs
    the members one after another through the scan engine.
    ``use_kernel`` routes Eq. 6-8 through the fused CUDA kernel (``True``
    per leaf, ``'packed'`` once per round); ``wire='int8'`` sends the
    uploads over the int8 wire (two kernels per round).  ``numeric=False``
    runs the host event process alone (timing records, no model, no
    task).  Only ``schedule='dense'`` is ported; the field names the JAX
    package's sparse schedules so that they are refused by name."""
    engine: Optional[str] = None
    wire: str = 'f32'
    use_kernel: Any = False
    schedule: str = 'dense'
    eval_every: int = 10
    numeric: bool = True


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """A sweep: S member configurations, optionally with per-member
    ``tasks`` (one per member, padded-stacked so members may hold
    different client partitions)."""
    members: tuple
    tasks: Optional[tuple] = None

    def __post_init__(self):
        object.__setattr__(self, 'members', tuple(self.members))
        if self.tasks is not None:
            object.__setattr__(self, 'tasks', tuple(self.tasks))
            if len(self.tasks) != len(self.members):
                raise ValueError(
                    f'got {len(self.tasks)} tasks for {len(self.members)} '
                    f'members (want one task per member, or tasks=None '
                    f'for a shared task)')


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f'{what} is not ported to repro_torch yet (ROADMAP queue 1, item '
        f'{item})')


def _check_env(env) -> None:
    """Field checks of an ``EnvSpec`` (or of a built ``Env``'s spec)."""
    env_spec = getattr(env, 'spec', env)
    if isinstance(env_spec, fedsim.EnvSpec):
        fedsim.validate_env_spec(env_spec)
        if env_spec.comm == 'wire':
            raise _not_ported("EnvSpec(comm='wire')",
                              '13 (env and API extras)')


def check_compat(protocol_spec: ProtocolSpec,
                 exec_spec: Optional[ExecSpec] = None, env=None) -> None:
    """Validate a (protocol, exec[, env]) spec triple.  Values the JAX
    package rejects raise ``ValueError`` with its messages; cells it runs
    but the port does not yet raise ``NotImplementedError``."""
    if not isinstance(protocol_spec, SafaSpec):
        raise _not_ported(
            f'protocol spec {type(protocol_spec).__name__!r} (only SafaSpec '
            f'is ported)', '9 (baseline protocols) / 10 (aggregation family)')
    ex = exec_spec if exec_spec is not None else ExecSpec()
    if env is not None:
        _check_env(env)
    protocol.check_wire(ex.wire)
    if ex.engine not in (None, 'scan', 'loop', 'fleet', 'sequential'):
        raise ValueError(
            f'unknown engine {ex.engine!r} (want "scan"/"loop" for runs, '
            f'"fleet"/"sequential" for sweeps, or None for the default)')
    if ex.use_kernel not in (False, True, 'packed'):
        raise ValueError(
            f'unknown use_kernel {ex.use_kernel!r} (want False, True, or '
            f'"packed")')
    if protocol_spec.quantize_uploads:
        if ex.wire != 'f32':
            raise ValueError(
                "quantize_uploads=True is the per-leaf reference for the "
                "packed wire='int8' path; pass one or the other, not both")
        raise _not_ported('quantize_uploads=True',
                          '17 (per-leaf int8 reference)')
    if ex.schedule in ('sparse', 'sparse_delta'):
        raise _not_ported(f'schedule={ex.schedule!r}', '11 (sparse schedules)')
    if ex.schedule == 'sparse_tier':
        raise _not_ported("schedule='sparse_tier'", '12 (lag-tier schedule)')
    if ex.schedule != 'dense':
        raise ValueError(
            f'unknown schedule {ex.schedule!r} (want "dense", "sparse", '
            f'"sparse_delta", or "sparse_tier")')


# ---------------------------------------------------------------------------
# Engine plumbing
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _RunState:
    """The model-state carry between segments: global, local and cache."""
    global_w: dict
    local_w: dict
    cache: dict


def _eval_rounds(rounds: int, eval_every: int):
    """Rounds at which the runner evaluates the global model; they are
    also the segment boundaries of the scan engine."""
    stops = sorted(set(range(eval_every, rounds + 1, eval_every)) | {rounds})
    return [t for t in stops if t >= 1]


def _record_eval(hist: History, rec: RoundRecord, task, global_w):
    rec.eval = task.evaluate(global_w)
    if hist.best_eval is None or rec.eval['loss'] < hist.best_eval['loss']:
        hist.best_eval = rec.eval


#: ``Experiment(init_params=)``: a param dict, or ``seed -> param dict``
InitParams = Union[None, dict, Callable[[int], dict]]


def _init_global(task, seed: int, device, init_params: InitParams) -> dict:
    """One run's initial global: the task's own seeded init, or the
    params the caller passed (a callable gets the run's seed)."""
    if init_params is None:
        return task.init_global(seed)
    params = init_params(seed) if callable(init_params) else init_params
    return params_from_jax(params, device)


def _init_state(task, m: int, seed: int, device,
                init_params: InitParams) -> _RunState:
    g = _init_global(task, seed, device, init_params)
    return _RunState(g, protocol.broadcast_global(g, m),
                     protocol.broadcast_global(g, m))


def init_fleet_global(task, seeds, *, init_params: InitParams = None
                      ) -> dict:
    """Per-member initial globals of a shared-task fleet, stacked
    [S, ...]: one init per distinct seed (``task.init_global`` or
    ``init_params``), never a batched init, so every member's row is
    bit for bit its own single run's initial global."""
    init = {}
    for seed in seeds:
        if seed not in init:
            init[seed] = _init_global(task, seed, task.device, init_params)
    return {k: torch.stack([init[seed][k] for seed in seeds])
            for k in init[seeds[0]]}


def _member(tree: dict, s: int) -> dict:
    """Member s of a fleet-stacked model dict (views)."""
    return {k: v[s] for k, v in tree.items()}


def _fresh_records(records: list) -> list:
    """Per-run copies of the cached schedule's RoundRecords, so Histories
    of repeated run() calls never share evals."""
    return [dataclasses.replace(r, eval=None) for r in records]


def _realize_env(env):
    """``EnvSpec`` -> built ``Env``; built envs pass through."""
    if isinstance(env, fedsim.EnvSpec):
        return env.build()
    return env


#: declarative env fields a ``SweepMember.overrides`` dict may set
_ENV_FIELDS = frozenset(f.name for f in dataclasses.fields(fedsim.EnvSpec))


def _resolve_member(mem: SweepMember) -> SweepMember:
    """Apply a member's env-field overrides to its declarative env and
    build the env.  Env-field overrides (``crash_prob``, ``traces``, ...)
    need an ``fedsim.EnvSpec`` member env; SAFA takes no protocol-field
    overrides, so any other key is refused with the JAX package's
    message."""
    env = mem.env
    ov = dict(mem.overrides or {})
    env_ov = {k: ov.pop(k) for k in list(ov) if k in _ENV_FIELDS}
    if env_ov:
        if not isinstance(env, fedsim.EnvSpec):
            raise ValueError(
                f'member override keys {sorted(env_ov)} are EnvSpec fields; '
                f'env overrides need a declarative member env '
                f'(fedsim.EnvSpec), got {type(env).__name__}')
        env = env.replace(**env_ov)
    if ov:
        raise ValueError(
            f"unknown member override keys {sorted(ov)}; protocol 'safa' "
            f'takes env-field overrides only (EnvSpec fields, e.g. '
            f'crash_prob/traces/draw_seed)')
    _check_env(env)
    return dataclasses.replace(mem, env=_realize_env(env), overrides=None)


def _stacked_task(tasks):
    """Memoised ``stack_tasks``: repeated sweeps over the same task tuple
    reuse one stacked task, so the padded data is built once.  Cached on
    the first task; entries hold the member tasks alive, so the id-tuple
    key cannot be reused while it is live."""
    from repro_torch.data.tasks import stack_tasks
    cache = tasks[0].__dict__.setdefault('_fleet_task_stacks', {})
    key = tuple(map(id, tasks))
    if key not in cache:
        cache[key] = stack_tasks(tasks)
    return cache[key]


def _safa_scan_segment(st: _RunState, seg: protocol.RoundSchedule, weights,
                       train_fn, ex: ExecSpec):
    st.global_w, st.local_w, st.cache = protocol.safa_run_scan(
        st.global_w, st.local_w, st.cache, seg, weights,
        local_train_fn=train_fn, use_kernel=ex.use_kernel, wire=ex.wire)


def _safa_fleet_segment(st: _RunState, seg: protocol.RoundSchedule, weights,
                        train_fn, ex: ExecSpec, ctx):
    st.global_w, st.local_w, st.cache = protocol.safa_run_fleet(
        st.global_w, st.local_w, st.cache, seg, weights,
        local_train_fn=train_fn, use_kernel=ex.use_kernel, wire=ex.wire,
        train_ctx=ctx)


def _safa_loop_round(st: _RunState, sched, i: int, weights, train_fn,
                     ex: ExecSpec, device):
    def put(mask):
        return torch.as_tensor(mask, device=device)
    st.global_w, st.local_w, st.cache = protocol.safa_round(
        st.global_w, st.local_w, st.cache,
        sync_mask=put(sched.sync[i]), completed=put(sched.committed[i]),
        picked=put(sched.picked[i]), undrafted=put(sched.undrafted[i]),
        deprecated=put(sched.deprecated[i]), weights=weights,
        local_train_fn=train_fn, train_args=(i + 1,),
        use_kernel=ex.use_kernel, wire=ex.wire)


# ---------------------------------------------------------------------------
# Experiment + CompiledRunner
# ---------------------------------------------------------------------------

class Experiment:
    """One declarative experiment: (task, env, protocol spec, exec spec,
    rounds, seed) on one device.  ``env`` is an ``EnvSpec`` (built here)
    or a built ``Env``; a sweep's members carry their own envs, so
    ``env`` may then be None.  ``task`` may be None for timing-only runs
    (``ExecSpec(numeric=False)``) and for sweeps with per-member tasks."""

    def __init__(self, task, env, protocol: ProtocolSpec,
                 exec: Optional[ExecSpec] = None, *,  # noqa: A002
                 rounds: int, seed: int = 0, device='cuda',
                 init_params: InitParams = None):
        self.task = task
        self.protocol = protocol
        self.exec = exec if exec is not None else ExecSpec()
        self.rounds = int(rounds)
        self.seed = int(seed)
        self.device = resolve_device(device)
        _check_task_device(task, self.device)
        self.init_params = init_params
        check_compat(self.protocol, self.exec, env=env)
        self.env = _realize_env(env)
        self._sched = None

    def precompute(self):
        """Run the host event state machine once and cache the [rounds, m]
        schedule; the env rng is consumed exactly once per Experiment."""
        if self._sched is None:
            self._sched = federation.precompute_safa_schedule(
                self.env, fraction=self.protocol.fraction,
                lag_tolerance=self.protocol.lag_tolerance,
                rounds=self.rounds)
        return self._sched

    def compile(self) -> 'CompiledRunner':
        return CompiledRunner(self)


def _check_task_device(task, device) -> None:
    if task is not None and task.device != device:
        raise ValueError(f'task data lies on {task.device}, the '
                         f'experiment runs on {device}')


class CompiledRunner:
    """Executes an ``Experiment``: ``run()`` the single run,
    ``run_sweep(members)`` S member configurations as one fleet."""

    def __init__(self, exp: Experiment):
        self.exp = exp
        self._dev = None            # cached device-resident schedule

    def _engine(self, *, sweep: bool) -> str:
        e = self.exp.exec.engine
        if sweep:
            e = e if e is not None else 'fleet'
            if e not in ('fleet', 'sequential'):
                raise ValueError(
                    f'unknown engine {e!r} (want "fleet" or "sequential")')
        else:
            e = e if e is not None else 'scan'
            if e not in ('scan', 'loop'):
                raise ValueError(
                    f'unknown engine {e!r} (want "scan" or "loop")')
        return e

    def run(self, *, checkpoint: Optional[str] = None) -> History:
        """Execute the experiment: one segment per eval point, the global
        model evaluated at each."""
        if checkpoint is not None:
            raise _not_ported('checkpoint=', '7 (checkpoint and resume)')
        exp = self.exp
        ex = exp.exec
        engine = self._engine(sweep=False)
        sched = exp.precompute()
        hist = History('safa', records=_fresh_records(sched.records),
                       futility=sched.futility)
        if not ex.numeric:
            return hist
        if exp.task is None:
            raise ValueError('numeric run needs a Task '
                             '(or ExecSpec(numeric=False))')
        st = _init_state(exp.task, exp.env.m, exp.seed, exp.device,
                         exp.init_params)
        weights = torch.as_tensor(exp.env.weights, dtype=torch.float32,
                                  device=exp.device)
        train_fn = exp.task.local_train
        if engine == 'scan' and self._dev is None:
            self._dev = sched.to_device(exp.device)
        start = 0
        for stop in _eval_rounds(exp.rounds, ex.eval_every):
            if engine == 'scan':
                _safa_scan_segment(st, self._dev.segment(start, stop),
                                   weights, train_fn, ex)
            else:
                for i in range(start, stop):
                    _safa_loop_round(st, sched, i, weights, train_fn, ex,
                                     exp.device)
            _record_eval(hist, hist.records[stop - 1], exp.task, st.global_w)
            start = stop
        hist.final_global = st.global_w
        return hist

    # -- sweeps ---------------------------------------------------------------

    def run_sweep(self, members, *, checkpoint: Optional[str] = None
                  ) -> list:
        """Run S = len(members) SAFA simulations as one fleet; returns one
        ``History`` per member, in order.

        ``members`` is a list of ``SweepMember`` or a ``SweepSpec``, whose
        ``tasks`` (one per member) may hold different client partitions
        (padded stacking).  Each member carries its own env and seed; the
        experiment's own are not used.  ``engine='fleet'`` (the default)
        runs every member in one round body: one train call for all S * m
        client replicas and one launch of each server kernel per round.
        ``engine='sequential'`` runs the same precomputed schedules member
        by member through the scan engine."""
        if checkpoint is not None:
            raise _not_ported('run_sweep(checkpoint=)',
                              '7 (checkpoint and resume)')
        exp = self.exp
        ex = exp.exec
        engine = self._engine(sweep=True)
        if isinstance(members, SweepSpec):
            tasks = list(members.tasks) if members.tasks is not None \
                else None
            members = list(members.members)
        else:
            members, tasks = list(members), None
        if not members:
            raise ValueError('empty sweep')
        members = [_resolve_member(mem) for mem in members]
        m = members[0].env.m
        if any(mem.env.m != m for mem in members):
            raise ValueError('fleet members must share the client count m')
        if tasks is not None and all(t is tasks[0] for t in tasks):
            # one shared task object: the cheaper path without padding
            shared_task, tasks = tasks[0], None
        else:
            shared_task = exp.task
        for t in tasks or (shared_task,):
            _check_task_device(t, exp.device)

        fleet = federation.precompute_fleet_schedule(members,
                                                     rounds=exp.rounds)
        hists = [History('safa', records=_fresh_records(fleet.records[s]),
                         futility=float(fleet.futility[s]))
                 for s in range(fleet.size)]
        if not ex.numeric:
            return hists
        if shared_task is None and tasks is None:
            raise ValueError('numeric sweep needs a Task (shared or '
                             'per-member) or ExecSpec(numeric=False)')

        def task_of(s):
            return tasks[s] if tasks is not None else shared_task

        evals = _eval_rounds(exp.rounds, ex.eval_every)
        if engine == 'sequential':
            for s, (mem, hist) in enumerate(zip(members, hists)):
                st = _init_state(task_of(s), m, mem.seed, exp.device,
                                 exp.init_params)
                dev = fleet.member(s).to_device(exp.device)
                w_s = torch.as_tensor(mem.env.weights, dtype=torch.float32,
                                      device=exp.device)
                start = 0
                for stop in evals:
                    _safa_scan_segment(st, dev.segment(start, stop), w_s,
                                       task_of(s).local_train, ex)
                    _record_eval(hist, hist.records[stop - 1], task_of(s),
                                 st.global_w)
                    start = stop
                hist.final_global = st.global_w
            return hists

        # fleet engine: one init per member (per distinct seed for a
        # shared task), stacked, then broadcast into the [S, m, ...] carry
        if tasks is not None:
            stacked = _stacked_task(tasks)
            ctx, train_fn = stacked.fleet_ctx(), stacked.fleet_train
            inits = [_init_global(tasks[s], mem.seed, exp.device,
                                  exp.init_params)
                     for s, mem in enumerate(members)]
            g = {k: torch.stack([i[k] for i in inits]) for k in inits[0]}
        else:
            ctx, train_fn = None, shared_task.local_train_fleet
            g = init_fleet_global(shared_task, [mem.seed for mem in members],
                                  init_params=exp.init_params)
        st = _RunState(g, protocol.broadcast_global(g, m, fleet=True),
                       protocol.broadcast_global(g, m, fleet=True))
        weights = torch.as_tensor(
            np.stack([mem.env.weights for mem in members]),
            dtype=torch.float32, device=exp.device)
        dev = fleet.to_device(exp.device)
        start = 0
        for stop in evals:
            _safa_fleet_segment(st, dev.fleet_segment(start, stop), weights,
                                train_fn, ex, ctx)
            for s, hist in enumerate(hists):
                _record_eval(hist, hist.records[stop - 1], task_of(s),
                             _member(st.global_w, s))
            start = stop
        for s, hist in enumerate(hists):
            hist.final_global = _member(st.global_w, s)
        return hists
