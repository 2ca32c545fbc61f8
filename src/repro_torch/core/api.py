"""Experiment API of the port: declarative specs -> host precompute ->
the SAFA engines on the device.

    from repro_torch import api

    exp = api.Experiment(task, env,
                         api.SafaSpec(fraction=0.5, lag_tolerance=5),
                         api.ExecSpec(eval_every=15),
                         rounds=60)
    hist = exp.compile().run()

The port runs the SAFA cells of ``repro.api`` on the dense schedule:
``engine`` None/'scan'/'loop', ``use_kernel`` False/True/'packed' and
``wire`` 'f32'/'int8'.  ``check_compat`` raises ``NotImplementedError``,
naming the ROADMAP queue item, for every cell not ported yet.

``Experiment`` takes ``device=`` (default ``'cuda'``; it raises without a
card) and ``init_params=``: a param dict to start from (``None`` means the
task's own seeded init).  JAX's PRNG cannot be reproduced in torch, so a
run that must match the JAX package passes the reference's init here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch import fedsim
from repro_torch.convert import params_from_jax
from repro_torch.core import federation, protocol
from repro_torch.core.federation import Task
from repro_torch.core.schedules import History, RoundRecord
from repro_torch.kernels.backend import resolve_device

__all__ = [
    'CompiledRunner', 'ExecSpec', 'Experiment', 'History', 'ProtocolSpec',
    'RoundRecord', 'SafaSpec', 'Task', 'check_compat',
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

    ``engine=None`` resolves to ``'scan'``: the segment engine replaying the
    device-resident schedule.  ``'loop'`` is the per-round reference and
    equals it bit for bit.  ``use_kernel`` routes Eq. 6-8 through the
    fused CUDA kernel (``True`` per leaf, ``'packed'`` once per round);
    ``wire='int8'`` sends the uploads over the int8 wire (two kernels per
    round).  Only ``schedule='dense'`` is ported; the field names the JAX
    package's sparse schedules so that they are refused by name."""
    engine: Optional[str] = None
    wire: str = 'f32'
    use_kernel: Any = False
    schedule: str = 'dense'
    eval_every: int = 10


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f'{what} is not ported to repro_torch yet (ROADMAP queue 1, item '
        f'{item})')


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
        env_spec = getattr(env, 'spec', env)
        if isinstance(env_spec, fedsim.EnvSpec):
            fedsim.validate_env_spec(env_spec)
            if env_spec.comm == 'wire':
                raise _not_ported("EnvSpec(comm='wire')",
                                  '13 (env and API extras)')
    protocol.check_wire(ex.wire)
    if ex.engine in ('fleet', 'sequential'):
        raise _not_ported(f'engine={ex.engine!r} (sweeps)',
                          '8 (fleet engine)')
    if ex.engine not in (None, 'scan', 'loop'):
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


def _init_state(task, m: int, seed: int, device,
                init_params: Optional[dict]) -> _RunState:
    g = task.init_global(seed) if init_params is None \
        else params_from_jax(init_params, device)
    return _RunState(g, protocol.broadcast_global(g, m),
                     protocol.broadcast_global(g, m))


def _fresh_records(records: list) -> list:
    """Per-run copies of the cached schedule's RoundRecords, so Histories
    of repeated run() calls never share evals."""
    return [dataclasses.replace(r, eval=None) for r in records]


def _realize_env(env):
    """``EnvSpec`` -> built ``Env``; built envs pass through."""
    if isinstance(env, fedsim.EnvSpec):
        return env.build()
    return env


def _safa_scan_segment(st: _RunState, seg: protocol.RoundSchedule, weights,
                       train_fn, ex: ExecSpec):
    st.global_w, st.local_w, st.cache = protocol.safa_run_scan(
        st.global_w, st.local_w, st.cache, seg, weights,
        local_train_fn=train_fn, use_kernel=ex.use_kernel, wire=ex.wire)


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
    or a built ``Env``."""

    def __init__(self, task, env, protocol: ProtocolSpec,
                 exec: Optional[ExecSpec] = None, *,  # noqa: A002
                 rounds: int, seed: int = 0, device='cuda',
                 init_params: Optional[dict] = None):
        self.task = task
        self.protocol = protocol
        self.exec = exec if exec is not None else ExecSpec()
        self.rounds = int(rounds)
        self.seed = int(seed)
        self.device = resolve_device(device)
        if task.device != self.device:
            raise ValueError(f'task data lies on {task.device}, the '
                             f'experiment runs on {self.device}')
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


class CompiledRunner:
    """Executes an ``Experiment``'s single run."""

    def __init__(self, exp: Experiment):
        self.exp = exp
        self._dev = None            # cached device-resident schedule

    def _engine(self) -> str:
        e = self.exp.exec.engine
        return e if e is not None else 'scan'

    def run(self, *, checkpoint: Optional[str] = None) -> History:
        """Execute the experiment: one segment per eval point, the global
        model evaluated at each."""
        if checkpoint is not None:
            raise _not_ported('checkpoint=', '7 (checkpoint and resume)')
        exp = self.exp
        ex = exp.exec
        engine = self._engine()
        sched = exp.precompute()
        hist = History('safa', records=_fresh_records(sched.records),
                       futility=sched.futility)
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

    def run_sweep(self, members, **kwargs):
        del members, kwargs
        raise _not_ported('run_sweep', '8 (fleet engine)')
