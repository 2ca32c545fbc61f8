"""Experiment API of the port: declarative specs -> protocol registry ->
host precompute -> the engines on the device.

    from repro_torch import api

    exp = api.Experiment(task, env,
                         api.SafaSpec(fraction=0.5, lag_tolerance=5),
                         api.ExecSpec(eval_every=15),
                         rounds=60)
    hist = exp.compile().run()
    # S = 4 runs as one fleet, each member with its own env and seed
    hists = exp.compile().run_sweep([api.SweepMember(env=env_spec, seed=s)
                                     for s in range(4)])

``PROTOCOLS`` maps each spec type to its ``ProtocolDef``: SAFA
(``SafaSpec``), the paper's baselines, FedAvg (``FedAvgSpec``), FedCS
(``FedCSSpec``), fully-local (``LocalSpec``) and FedAsync
(``FedAsyncSpec``), and the staleness-adaptive weighted-merge family,
SEAFL (``SeaflSpec``) and CSAFL (``CsaflSpec``), whose sweeps may fold
FedAsync members in (``SweepMember.overrides={'scheme': 'fedasync'}``).
The port runs them on the dense schedule: ``engine`` None/'scan'/'loop'
for ``run()`` and None/'fleet'/'sequential' for ``run_sweep()``,
``use_kernel`` False/True/'packed' (SAFA) or False/'packed' (SEAFL,
CSAFL) and ``wire`` 'f32'/'int8' (SAFA, FedAvg, FedCS, SEAFL, CSAFL);
``ExecSpec(numeric=False)`` gives the timing records alone.  SAFA,
FedAvg and FedCS runs and sweeps also take the sparse active-set
schedules, ``schedule='sparse'`` and ``'sparse_delta'``, and SAFA's take
the lag-tier schedule, ``'sparse_tier'``.  A dense SAFA run also takes
``SafaSpec(quantize_uploads=True)``, the per-leaf int8 reference of
``wire='int8'`` (sweeps refuse it, as the JAX package's do).
``check_compat`` raises the JAX package's errors for the cells it
refuses.  ``run(checkpoint=, max_segments=)`` and
``run_sweep(members, checkpoint=, max_segments=)`` save the carry at
every eval-segment boundary and resume from the next segment
(``repro_torch.checkpoint``: the JAX package's file layout), bit for bit
the uninterrupted run.  ``EnvSpec(comm='wire')`` derives the comm times
from the task model's bytes on the active wire (runs and sweep members).

``Experiment`` takes ``device=`` (default ``'cuda'``; it raises without a
card) and ``init_params=``: a param dict to start from, or a callable
``seed -> param dict`` (each sweep member then starts from its own seed's
params); ``None`` means the task's own seeded init.  JAX's PRNG cannot be
reproduced in torch, so a run that must match the JAX package passes the
reference's init here.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch import fedsim
from repro_torch.convert import params_from_jax
from repro_torch.core import agg_schemes, federation, protocol, schedules
from repro_torch.core.agg_schemes import STALENESS_FNS, CsaflSpec, SeaflSpec
from repro_torch.core.federation import Task
from repro_torch.core.schedules import (History, ProtocolSpec, RoundRecord,
                                        SweepMember)
from repro_torch.kernels.backend import resolve_device

__all__ = [
    'CompiledRunner', 'ExecSpec', 'Experiment', 'FedAsyncSpec', 'FedAvgSpec',
    'FedCSSpec', 'History', 'LocalSpec', 'PROTOCOLS', 'ProtocolDef',
    'ProtocolSpec', 'RoundRecord', 'STALENESS_FNS', 'SafaSpec', 'SweepMember',
    'SweepSpec', 'Task', 'check_compat', 'init_fleet_global', 'register',
    'spec',
]


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SafaSpec(ProtocolSpec):
    """SAFA (the paper's protocol): post-training CFCFM selection at
    quota C*m, Eq. 3 lag-tolerant distribution, Eq. 6-8 three-bypass
    aggregation.  ``quantize_uploads`` is the per-leaf int8 reference
    of ``wire='int8'``: each client's upload is quantised leaf by leaf
    (two launches per leaf per client), bit for bit the numbers the
    packed wire ships; single runs on the dense schedule only."""
    fraction: float = 0.5
    lag_tolerance: int = 5
    quantize_uploads: bool = False


@dataclasses.dataclass(frozen=True)
class FedAvgSpec(ProtocolSpec):
    """FedAvg baseline: random pre-training selection, synchronous.

    ``sampler`` picks the without-replacement draw: ``'choice'`` (default)
    is the legacy per-round ``Generator.choice`` stream; ``'topk'`` is the
    vectorised bulk-uniform draw (one ``rng.random((rounds, m))``),
    distributionally identical, a different stream by design."""
    fraction: float = 0.5
    sampler: str = 'choice'


@dataclasses.dataclass(frozen=True)
class FedCSSpec(ProtocolSpec):
    """FedCS baseline: fastest-first selection under the deadline."""
    fraction: float = 0.5


@dataclasses.dataclass(frozen=True)
class LocalSpec(ProtocolSpec):
    """Fully-local baseline: no aggregation except at eval points."""
    fraction: float = 0.5


@dataclasses.dataclass(frozen=True)
class FedAsyncSpec(ProtocolSpec):
    """FedAsync baseline: every client, every round; merge-per-arrival
    with staleness-discounted mixing alpha * s(staleness).

    ``staleness_fn`` picks s(dt) from ``STALENESS_FNS``; the default
    ``'poly'`` is the legacy alpha*(1+staleness)^(-staleness_exp) form.
    ``hinge_a`` / ``hinge_b`` parameterise the hinge discount (ignored
    otherwise)."""
    alpha: float = 0.6
    staleness_exp: float = 0.5
    staleness_fn: str = 'poly'
    hinge_a: float = 10.0
    hinge_b: int = 4


@dataclasses.dataclass(frozen=True)
class ExecSpec:
    """Execution knobs, orthogonal to protocol semantics.

    ``engine=None`` resolves to ``'scan'`` for ``run()``: the segment
    engine replaying the device-resident schedule; ``'loop'`` is the
    per-round reference and equals it bit for bit.  For ``run_sweep()`` it
    resolves to ``'fleet'``: all S members in one round body, one launch
    of each kernel per round for the whole fleet; ``'sequential'`` runs
    the members one after another through the scan engine.
    ``use_kernel`` routes the server aggregation through its CUDA kernel:
    SAFA's Eq. 6-8 (``True`` per leaf, ``'packed'`` once per round), the
    SEAFL/CSAFL weighted merge (``'packed'`` only); ``wire='int8'``
    sends the uploads over the int8 wire (two kernels per round; SAFA,
    FedAvg, FedCS, SEAFL and CSAFL).  ``numeric=False``
    runs the host event process alone (timing records, no model, no
    task).

    ``schedule`` picks the schedule's form.  ``'dense'`` replays
    [rounds, m] masks; ``'sparse'`` (SAFA, FedAvg, FedCS) names each
    round's K active clients and trains only them, then runs the dense
    server step, equal to dense; ``'sparse_delta'`` also aggregates from
    the K rows alone, as deltas on a running aggregate (FedAvg/FedCS carry
    the global model alone), equal to dense up to summation order.  SAFA's
    ``'sparse_delta'`` takes ``use_kernel=False`` or ``'packed'`` (the
    rows kernels, four launches a round, five on the int8 wire; a
    fleet's round launches their fleet forms, once each for all S
    members).  A sparse sweep replays the fleet-major sparse form of the
    same event streams, every member re-padded to the fleet's widest
    active set.  ``'sparse_tier'`` (SAFA) carries no [m, ...] stack: one
    value buffer of capacity + 1 rows, O(lag_tolerance + quota) whatever
    m, driven by host slot maps; it takes ``use_kernel=False`` or
    ``'packed'`` (the row gather and the tier-rows kernel, two launches a
    round, three on the int8 wire), equal to ``'sparse_delta'`` up to
    summation order.  A tier sweep's members share the fleet's width and
    capacity, on either engine."""
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


def _check_env(env) -> None:
    """Field checks of an ``EnvSpec`` (or of a built ``Env``'s spec)."""
    env_spec = getattr(env, 'spec', env)
    if isinstance(env_spec, fedsim.EnvSpec):
        fedsim.validate_env_spec(env_spec)


# ---------------------------------------------------------------------------
# Protocol registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ProtocolDef:
    """Everything the runners need to execute one protocol.

    ``precompute(env, spec, *, rounds, seed)`` runs the host event state
    machine; ``fleet_precompute(members, spec, *, rounds)`` the
    fleet-major form.  ``segment(st, seg, weights, train_fn, ex, ctx)``
    advances the model state through one eval segment of a run's or a
    fleet's device-resident schedule (``ctx``: a per-member-task fleet's
    data, else None); ``loop_round(st, sched, i, weights, train_fn, ex,
    device)`` is the per-round reference; ``finish_segment(st, weights)``
    (optional) runs at eval stops (the fully-local aggregation)."""
    name: str
    spec_cls: type
    precompute: Callable
    fleet_precompute: Callable
    segment: Callable
    loop_round: Callable
    finish_segment: Optional[Callable] = None
    uses_cache: bool = False
    supports_wire: bool = False
    #: fused-aggregation kernel support: ``False`` (no kernel), ``True``
    #: (the per-leaf kernel and the packed one), or ``'packed'``: the
    #: protocol's merge exists on pack buffers only, so ``use_kernel``
    #: takes False or 'packed' but never True (the weighted-merge family)
    supports_kernel: Any = False
    #: the schedules besides ``'dense'`` this protocol runs on
    sparse_forms: tuple = ()
    #: ``sparse_precompute(env, spec, *, rounds, seed)``: the host event
    #: process emitting the sparse schedule (``schedule='sparse'`` and
    #: ``'sparse_delta'``)
    sparse_precompute: Optional[Callable] = None
    #: ``tier_precompute(env, spec, *, rounds, seed)``: the host event
    #: process emitting the lag-tier schedule (``schedule='sparse_tier'``)
    tier_precompute: Optional[Callable] = None
    #: ``prepare_state(st, weights, ex, sched)`` builds the carry a
    #: schedule needs beyond the dense one (the running aggregate, pack
    #: buffers, the lag tier's value buffer sized by ``sched.capacity``)
    prepare_state: Optional[Callable] = None
    #: under ``'sparse_delta'`` the carry is the global model alone
    delta_stateless: bool = False
    #: leftover ``SweepMember.overrides`` keys are protocol-spec fields
    #: of the member's precompute (the staleness-adaptive family); else
    #: they are refused at sweep resolution
    spec_overrides: bool = False
    #: ``dispatch_budget(ex)``: the kernel launches of one round of the
    #: admitted exec cell (a fleet's: for all S members), or None where
    #: no budget is declared (the per-leaf kernel path, whose count is the
    #: model's leaf count); ``repro_torch.analysis`` holds every cell's
    #: rounds to it (rule T001).  The JAX package's budgets, cell for cell
    dispatch_budget: Optional[Callable] = None
    #: ``alias_claims(ex)``: {kernel wrapper: the operands it must write in
    #: place} in the cell's rounds (rule T003; None: no claim); names key
    #: into the kernel modules' ``ALIAS_CONTRACTS``
    alias_claims: Optional[Callable] = None


#: spec type -> ProtocolDef: the single source of protocol dispatch
PROTOCOLS: dict = {}
_BY_NAME: dict = {}


def register(pdef: ProtocolDef) -> ProtocolDef:
    """Add a protocol to the registry (spec type and name must be new)."""
    if pdef.spec_cls in PROTOCOLS:
        raise ValueError(f'spec type {pdef.spec_cls.__name__} already '
                         f'registered (as {PROTOCOLS[pdef.spec_cls].name!r})')
    if pdef.name in _BY_NAME:
        raise ValueError(f'protocol name {pdef.name!r} already registered')
    PROTOCOLS[pdef.spec_cls] = pdef
    _BY_NAME[pdef.name] = pdef
    return pdef


def spec(name: str, **fields) -> ProtocolSpec:
    """Build a protocol spec by registry name ('safa', 'fedavg', ...)."""
    if name not in _BY_NAME:
        raise ValueError(
            f'unknown proto {name!r} (want one of {sorted(_BY_NAME)})')
    return _BY_NAME[name].spec_cls(**fields)


def check_compat(protocol_spec: ProtocolSpec,
                 exec_spec: Optional[ExecSpec] = None,
                 env=None) -> ProtocolDef:
    """Validate a (protocol, exec[, env]) spec triple; returns the
    ProtocolDef.  Values the JAX package rejects raise its errors with its
    messages."""
    pdef = PROTOCOLS.get(type(protocol_spec))
    if pdef is None:
        raise TypeError(
            f'unregistered protocol spec {type(protocol_spec).__name__!r}; '
            f'known specs: {sorted(c.__name__ for c in PROTOCOLS)} '
            f'(register new ones via api.register)')
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
    if ex.wire != 'f32' and not pdef.supports_wire:
        wired = '/'.join(sorted(p.name for p in PROTOCOLS.values()
                                if p.supports_wire))
        raise ValueError(
            f"protocol {pdef.name!r} has no upload-aggregate wire; "
            f"wire='int8' applies to {wired} only")
    if ex.use_kernel and not pdef.supports_kernel:
        kerneled = '/'.join(sorted(p.name for p in PROTOCOLS.values()
                                   if p.supports_kernel))
        raise ValueError(
            f'protocol {pdef.name!r} has no fused aggregation kernel; '
            f'use_kernel applies to {kerneled} only')
    if ex.use_kernel is True and pdef.supports_kernel == 'packed':
        raise ValueError(
            f'protocol {pdef.name!r} aggregates on pack buffers only (no '
            f"leaf-wise kernel form); use_kernel takes False or 'packed'")
    fn = getattr(protocol_spec, 'staleness_fn', None)
    if fn is not None and fn not in STALENESS_FNS:
        raise ValueError(
            f'unknown staleness_fn {fn!r} (want one of {STALENESS_FNS})')
    alpha = getattr(protocol_spec, 'alpha', None)
    if alpha is not None and not 0.0 < alpha <= 1.0:
        raise ValueError(
            f'alpha must be in (0, 1] (the residual global weight '
            f'1 - sum(wrow) must stay non-negative), got {alpha}')
    if getattr(protocol_spec, 'hinge_a', 1.0) <= 0:
        raise ValueError(
            f'hinge_a must be > 0, got {protocol_spec.hinge_a}')
    if getattr(protocol_spec, 'clusters', 1) < 1:
        raise ValueError(
            f'clusters must be >= 1, got {protocol_spec.clusters}')
    quantize_uploads = getattr(protocol_spec, 'quantize_uploads', False)
    if quantize_uploads and ex.wire != 'f32':
        raise ValueError(
            "quantize_uploads=True is the per-leaf reference for the packed "
            "wire='int8' path; pass one or the other, not both")
    if getattr(protocol_spec, 'sampler', 'choice') not in ('choice', 'topk'):
        raise ValueError(
            f'unknown sampler {protocol_spec.sampler!r} '
            f"(want 'choice' or 'topk')")
    if ex.schedule not in ('dense', 'sparse', 'sparse_delta', 'sparse_tier'):
        raise ValueError(
            f'unknown schedule {ex.schedule!r} (want "dense", "sparse", '
            f'"sparse_delta", or "sparse_tier")')
    if ex.schedule != 'dense':
        if not pdef.sparse_forms:
            raise ValueError(
                f'protocol {pdef.name!r} has no sparse schedule form; '
                f'sparse schedules apply to safa/fedavg/fedcs only')
        if ex.schedule not in pdef.sparse_forms:
            raise ValueError(
                f'protocol {pdef.name!r} has no lag-tier schedule form; '
                f"schedule='sparse_tier' applies to safa only (the "
                f'version-ring compression needs SAFA lag-bounded bases)')
        if quantize_uploads:
            raise ValueError(
                'quantize_uploads is the dense per-leaf reference knob; '
                "sparse schedules take the packed wire instead "
                "(wire='int8')")
        if ex.schedule in ('sparse_delta', 'sparse_tier') \
                and ex.use_kernel is True:
            raise ValueError(
                f'the leaf-wise kernel (use_kernel=True) has no rows form; '
                f"schedule={ex.schedule!r} takes use_kernel=False or "
                f"'packed'")
    return pdef


# ---------------------------------------------------------------------------
# Engine plumbing
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _RunState:
    """The model-state carry between segments: global, local and (SAFA)
    cache.  Under ``schedule='sparse_delta'`` it adds ``agg`` (the running
    Eq. 7 aggregate) or, with ``use_kernel='packed'``, ``packed``: the
    (global, local, cache, agg) pack buffers with layout ``spec``, which
    then replace the local, cache and agg trees.  Under
    ``'sparse_tier'`` there is no local stack, ``cache`` is the lag tier's
    value buffer and ``packed`` (global, value buffer, agg).
    ``in_place`` names the buffers the rounds write in place
    (``prepare_state`` built them) as (entry, index) pairs, index None
    for a whole entry: ``('cache', None)``, ``('packed', 1)``; a resume
    copies into every buffer of those entries and takes the others as
    they are."""
    global_w: dict
    local_w: Optional[dict]
    cache: Optional[dict] = None
    agg: Optional[dict] = None
    packed: Optional[tuple] = None
    spec: Any = None
    in_place: tuple = ()

    def tree(self) -> dict:
        """The carry as a checkpoint tree, with the JAX package's keys:
        ``global``, ``local``, and ``cache``, ``agg`` and the ``packed``
        tuple where they are set."""
        t = {'global': self.global_w, 'local': self.local_w}
        if self.cache is not None:
            t['cache'] = self.cache
        if self.agg is not None:
            t['agg'] = self.agg
        if self.packed is not None:
            t['packed'] = self.packed
        return t

    def set_tree(self, t: dict) -> None:
        """Take the carry of ``t`` (a restored ``tree()``): the entries
        that hold an ``in_place`` buffer are copied into their buffers,
        the others taken as they are; a packed carry's global model is
        then unpacked from ``packed[0]``, as the engines derive it."""
        self.global_w, self.local_w = t['global'], t['local']
        held = {name for name, _ in self.in_place}
        for name in ('cache', 'agg', 'packed'):
            new = t.get(name)
            if new is None:
                continue
            if name not in held:
                setattr(self, name, new)
                continue
            for dst, src in zip(ckpt.flatten(getattr(self, name)).values(),
                                ckpt.flatten(new).values()):
                dst.copy_(src)
        if self.packed is not None:
            _unpack_global_state(self)


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
        g = task.init_global(seed)
    else:
        params = init_params(seed) if callable(init_params) else init_params
        g = params_from_jax(params, device)
    # sorted-key leaf order, the order every round returns the model in
    # (the JAX package's): the first segment then runs the later ones' ops
    return dict(sorted(g.items()))


def _init_state(g: dict, m: int, uses_cache: bool, *,
                fleet: bool = False, stateless: bool = False) -> _RunState:
    """The carry at round 0: every client (and, for SAFA, every cache
    entry) holds the initial global ``g`` (a fleet's: [S, ...] leaves).
    ``stateless`` (a global-only carry) never forms the [m, ...] stacks."""
    if stateless:
        return _RunState(g, None)

    def tile():
        return protocol.broadcast_global(g, m, fleet=fleet)
    return _RunState(g, tile(), tile() if uses_cache else None)


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


def _apply_saved_history(hist: History, d: dict) -> None:
    """Replay a checkpoint's eval entries into a freshly precomputed
    History (the records and futility are recomputed bit for bit; only
    the evals and best_eval need restoring)."""
    hist.best_eval = d['best_eval']
    for rec, rd in zip(hist.records, d['records']):
        if rd.get('eval') is not None:
            rec.eval = rd['eval']


def _fp_val(v):
    """Checkpoint-fingerprint form of one spec field value: recurse into
    nested dataclasses (trace specs), hash ndarrays (``Replay`` traces)
    so a fingerprint never embeds megabytes of trace data."""
    if isinstance(v, np.ndarray):
        digest = hashlib.sha1(np.ascontiguousarray(v).tobytes()).hexdigest()
        return f'ndarray{v.shape}:{digest}'
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__,
                [(f.name, _fp_val(getattr(v, f.name)))
                 for f in dataclasses.fields(v)])
    return v


def _env_fp(env) -> str:
    """Environment identity for checkpoint fingerprints: the declarative
    spec's fields (a built ``Env`` fingerprints as its spec: same
    spelling, same fingerprint)."""
    spec = getattr(env, 'spec', env)
    return repr(_fp_val(spec))


def _task_fp(task) -> str:
    """Task identity for checkpoint fingerprints.  Tasks that implement
    ``fingerprint()`` (``SupervisedTask``: a hash of the client data and
    hypers) pin the training problem; others fall back to the class name,
    which at least catches swapping task types."""
    if task is None:
        return 'None'
    fp = getattr(task, 'fingerprint', None)
    return fp() if callable(fp) else type(task).__name__


def _wire_mb_of(task, wire: str):
    """Measured (uplink, downlink) megabytes of the task's model under the
    active wire (``EnvSpec(comm='wire')``): the uplink ships client
    updates (packed int8 buffers under ``wire='int8'``, plain f32 leaves
    otherwise), while the server always distributes the uncompressed
    global.  Memoised on the task (one throwaway ``init_global`` per
    distinct wire), so sweeps measure once; the bytes follow from the
    shapes alone."""
    from repro_torch.kernels import ops as kops
    cache = task.__dict__.setdefault('_wire_mb_cache', {})
    if wire not in cache:
        g = task.init_global(0)
        up = kops.comm_bytes(g, wire == 'int8',
                             layout='packed' if wire == 'int8' else 'tree')
        down = kops.comm_bytes(g, False, layout='tree')
        cache[wire] = (up / 1e6, down / 1e6)
    return cache[wire]


def _realize_env(env, *, task, ex):
    """``EnvSpec`` -> built ``Env``; built envs pass through.  When the
    spec asks for wire-derived comm (``comm='wire'``), measure the task
    model's bytes under ``ex.wire`` and inject them before any schedule
    precompute runs."""
    if env is None:
        return None
    if isinstance(env, fedsim.EnvSpec):
        env = env.build()
    if getattr(env, 'comm', 'static') == 'wire':
        if task is None:
            raise ValueError(
                "EnvSpec(comm='wire') derives comm times from the "
                'experiment model; this run has no Task to measure '
                "(pass a Task, or use comm='static')")
        env.set_wire_mb(*_wire_mb_of(task, ex.wire))
    return env


#: declarative env fields a ``SweepMember.overrides`` dict may set
_ENV_FIELDS = frozenset(f.name for f in dataclasses.fields(fedsim.EnvSpec))


def _resolve_member(mem: SweepMember, *, pdef: ProtocolDef, task,
                    ex: ExecSpec) -> SweepMember:
    """Split a member's overrides into env fields and protocol fields,
    apply the env part to its declarative env, and build the env (its
    wire-derived comm measured on ``task`` under ``ex.wire``).
    Env-field overrides (``crash_prob``, ``traces``, ...) need an
    ``fedsim.EnvSpec`` member env; leftover keys must be protocol-spec
    fields of a ``spec_overrides`` protocol (FedAsync, SEAFL, CSAFL),
    which its precompute checks, and are refused here otherwise, with the
    JAX package's messages."""
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
    if ov and not pdef.spec_overrides:
        raise ValueError(
            f'unknown member override keys {sorted(ov)}; protocol '
            f'{pdef.name!r} takes env-field overrides only '
            f'(EnvSpec fields, e.g. crash_prob/traces/draw_seed)')
    _check_env(env)
    return dataclasses.replace(mem, env=_realize_env(env, task=task, ex=ex),
                               overrides=ov or None)


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


def _put(a, device, dtype=None) -> torch.Tensor:
    """One round's host schedule row on the device (the loop engine)."""
    return torch.as_tensor(a, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Built-in protocol defs
# ---------------------------------------------------------------------------

def _safa_precompute(env, sp, *, rounds, seed):
    del seed  # SAFA's event process draws only from the env rng
    return federation.precompute_safa_schedule(
        env, fraction=sp.fraction, lag_tolerance=sp.lag_tolerance,
        rounds=rounds)


def _safa_sparse_precompute(env, sp, *, rounds, seed):
    del seed
    return federation.precompute_safa_schedule(
        env, fraction=sp.fraction, lag_tolerance=sp.lag_tolerance,
        rounds=rounds, form='sparse')


def _safa_tier_precompute(env, sp, *, rounds, seed):
    del seed
    return federation.precompute_safa_schedule(
        env, fraction=sp.fraction, lag_tolerance=sp.lag_tolerance,
        rounds=rounds, form='sparse_tier')


def _pack_layout(global_w, wire):
    from repro_torch.kernels import ops as kops
    return kops.wire_spec(global_w) if wire == 'int8' \
        else kops.pack_spec(global_w)


def _safa_prepare_state(st, weights, ex, sched):
    """The sparse_delta carry: the running aggregate tree, or, under
    ``use_kernel='packed'``, the whole state as resident pack buffers
    (local and cache [m + 1, N], the trailing scratch row taking the
    sentinel slots).  A fleet's ([S, m] weights) are [S, m + 1, N], a
    scratch row per member, and [S, N]; its layout is one member's.  The
    lag tier's carry is ``_safa_prepare_tier_state``'s."""
    if ex.schedule == 'sparse_tier':
        _safa_prepare_tier_state(st, weights, ex, sched)
        return
    if ex.schedule != 'sparse_delta':
        return
    agg = protocol.init_aggregate(st.cache, weights)
    if ex.use_kernel != 'packed':
        st.agg = agg
        return
    from repro_torch.kernels import ops as kops
    fleet = weights.ndim == 2
    spec = _pack_layout(_member(st.global_w, 0) if fleet else st.global_w,
                        ex.wire)
    pack_g = kops.pack_stacked if fleet else kops.pack_global
    pack_m = kops.pack_fleet if fleet else kops.pack_stacked

    def scratch(tree):
        buf = pack_m(tree, spec)
        row = buf.new_zeros(buf.shape[:-2] + (1, buf.shape[-1]))
        return torch.cat([buf, row], dim=-2)

    st.packed = (pack_g(st.global_w, spec), scratch(st.local_w),
                 scratch(st.cache), pack_g(agg, spec))
    # the rounds scatter into the local and cache buffers; the global and
    # agg buffers are the rows kernel's fresh outputs
    st.spec, st.in_place = spec, (('packed', 1), ('packed', 2))
    st.local_w = st.cache = None


def _safa_prepare_tier_state(st, weights, ex, sched):
    """The lag tier's carry, from the global alone: the value buffer of
    ``sched.capacity + 1`` rows, each the initial global (as every cache
    row starts), and the running aggregate ``global * sum(weights)``; a
    fleet's ([S, m] weights) [S, capacity + 1, ...] and [S, ...].  Under
    ``use_kernel='packed'`` the three are pack buffers.  The buffer is a
    contiguous copy, not a broadcast view: the rounds write it in
    place."""
    fleet = weights.ndim == 2
    wsum = weights.sum(dim=-1)
    rows = sched.capacity + 1

    def scale(g):
        w = wsum.reshape(wsum.shape + (1,) * (g.ndim - wsum.ndim))
        return g.float() * w

    def tile(g):
        if fleet:
            return g[:, None].expand((g.shape[0], rows) + tuple(g.shape[1:]))
        return g[None].expand((rows,) + tuple(g.shape))

    agg = {k: scale(g) for k, g in st.global_w.items()}
    if ex.use_kernel != 'packed':
        st.cache = {k: tile(g).contiguous() for k, g in st.global_w.items()}
        st.agg, st.in_place = agg, (('cache', None),)
        return
    from repro_torch.kernels import ops as kops
    spec = _pack_layout(_member(st.global_w, 0) if fleet else st.global_w,
                        ex.wire)
    pack_g = kops.pack_stacked if fleet else kops.pack_global
    gbuf = pack_g(st.global_w, spec)
    st.packed = (gbuf, tile(gbuf).contiguous(), pack_g(agg, spec))
    st.spec, st.in_place = spec, (('packed', 1),)


def _unpack_global_state(st):
    """The global model dict of the packed carry (a fleet's: [S, ...])."""
    from repro_torch.kernels import ops as kops
    unpack = kops.unpack_stacked if st.packed[0].ndim == 2 \
        else kops.unpack_global
    st.global_w = unpack(st.packed[0], st.spec)


def _safa_segment(st, seg, weights, train_fn, ex, ctx):
    if ex.schedule == 'dense':
        st.global_w, st.local_w, st.cache = protocol.safa_run_scan(
            st.global_w, st.local_w, st.cache, seg, weights,
            local_train_fn=train_fn, use_kernel=ex.use_kernel, wire=ex.wire,
            train_ctx=ctx)
    elif ex.schedule == 'sparse':
        st.global_w, st.local_w, st.cache = protocol.safa_run_scan_sparse(
            st.global_w, st.local_w, st.cache, seg, weights,
            local_train_fn=train_fn, use_kernel=ex.use_kernel, wire=ex.wire)
    elif ex.schedule == 'sparse_tier':
        if st.packed is not None:
            st.packed = protocol.safa_run_scan_sparse_tier_packed(
                *st.packed, seg, weights, local_train_fn=train_fn,
                spec=st.spec, wire=ex.wire)
            _unpack_global_state(st)
        else:
            st.global_w, st.cache, st.agg = \
                protocol.safa_run_scan_sparse_tier(
                    st.global_w, st.cache, st.agg, seg, weights,
                    local_train_fn=train_fn, wire=ex.wire)
    elif st.packed is not None:
        st.packed = protocol.safa_run_scan_sparse_delta_packed(
            *st.packed, seg, weights, local_train_fn=train_fn, spec=st.spec,
            wire=ex.wire)
        _unpack_global_state(st)
    else:
        st.global_w, st.local_w, st.cache, st.agg = \
            protocol.safa_run_scan_sparse_delta(
                st.global_w, st.local_w, st.cache, st.agg, seg, weights,
                local_train_fn=train_fn, wire=ex.wire)


def _safa_loop_round(st, sched, i, weights, train_fn, ex, device):
    if ex.schedule == 'dense':
        st.global_w, st.local_w, st.cache = protocol.safa_round(
            st.global_w, st.local_w, st.cache,
            sync_mask=_put(sched.sync[i], device),
            completed=_put(sched.committed[i], device),
            picked=_put(sched.picked[i], device),
            undrafted=_put(sched.undrafted[i], device),
            deprecated=_put(sched.deprecated[i], device), weights=weights,
            local_train_fn=train_fn, train_args=(i + 1,),
            use_kernel=ex.use_kernel, wire=ex.wire)
        return
    rows = dict(idx=_put(sched.idx[i], device),
                roles=_put(sched.roles[i], device), weights=weights,
                local_train_fn=train_fn, train_args=(i + 1,), wire=ex.wire)
    if ex.schedule == 'sparse':
        st.global_w, st.local_w, st.cache = protocol.safa_round_sparse(
            st.global_w, st.local_w, st.cache, use_kernel=ex.use_kernel,
            **rows)
    elif ex.schedule == 'sparse_tier':
        rows.update({f: _put(getattr(sched, f)[i], device) for f in (
            'base_src', 'cache_src', 'cache_dst', 'global_dst')})
        if st.packed is not None:
            st.packed = protocol.safa_round_sparse_tier_packed(
                *st.packed, spec=st.spec, **rows)
            _unpack_global_state(st)
        else:
            st.global_w, st.cache, st.agg = protocol.safa_round_sparse_tier(
                st.global_w, st.cache, st.agg, **rows)
    elif st.packed is not None:
        st.packed = protocol.safa_round_sparse_delta_packed(
            *st.packed, spec=st.spec, **rows)
        _unpack_global_state(st)
    else:
        st.global_w, st.local_w, st.cache, st.agg = \
            protocol.safa_round_sparse_delta(
                st.global_w, st.local_w, st.cache, st.agg, **rows)


def _sync_precompute(fedcs, form='dense'):
    def precompute(env, sp, *, rounds, seed):
        return federation.precompute_sync_schedule(
            env, fraction=sp.fraction, rounds=rounds, seed=seed, fedcs=fedcs,
            form=form, sampler=getattr(sp, 'sampler', 'choice'))
    return precompute


def _sync_fleet_precompute(fedcs):
    def precompute(members, sp, *, rounds):
        return federation.precompute_sync_fleet_schedule(
            members, rounds=rounds, fedcs=fedcs,
            sampler=getattr(sp, 'sampler', 'choice'))
    return precompute


def _fedavg_segment(st, seg, weights, train_fn, ex, ctx):
    if ex.schedule == 'dense':
        st.global_w, st.local_w = protocol.fedavg_run_scan(
            st.global_w, st.local_w, seg, weights, local_train_fn=train_fn,
            wire=ex.wire, train_ctx=ctx)
    elif ex.schedule == 'sparse':
        st.global_w, st.local_w = protocol.fedavg_run_scan_sparse(
            st.global_w, st.local_w, seg, weights, local_train_fn=train_fn,
            wire=ex.wire)
    else:
        st.global_w = protocol.fedavg_run_scan_sparse_delta(
            st.global_w, seg, weights, local_train_fn=train_fn, wire=ex.wire)


def _fedavg_loop_round(st, sched, i, weights, train_fn, ex, device):
    if ex.schedule == 'dense':
        st.global_w, st.local_w = protocol.fedavg_round(
            st.global_w, st.local_w,
            selected=_put(sched.selected[i], device),
            completed=_put(sched.completed[i], device), weights=weights,
            local_train_fn=train_fn, train_args=(i + 1,), wire=ex.wire)
        return
    rows = dict(idx=_put(sched.idx[i], device),
                roles=_put(sched.roles[i], device), weights=weights,
                local_train_fn=train_fn, train_args=(i + 1,), wire=ex.wire)
    if ex.schedule == 'sparse':
        st.global_w, st.local_w = protocol.fedavg_round_sparse(
            st.global_w, st.local_w, **rows)
    else:
        st.global_w = protocol.fedavg_round_sparse_delta(st.global_w, **rows)


def _local_precompute(env, sp, *, rounds, seed):
    return federation.precompute_local_schedule(
        env, fraction=sp.fraction, rounds=rounds, seed=seed)


def _local_fleet_precompute(members, sp, *, rounds):
    del sp
    return schedules.LocalFleetSchedule.stack([
        federation.precompute_local_schedule(
            mem.env, fraction=mem.fraction, rounds=rounds, seed=mem.seed)
        for mem in members])


def _local_segment(st, seg, weights, train_fn, ex, ctx):
    del weights, ex
    st.local_w = protocol.local_run_scan(st.local_w, seg,
                                         local_train_fn=train_fn,
                                         train_ctx=ctx)


def _local_loop_round(st, sched, i, weights, train_fn, ex, device):
    del weights, ex
    st.local_w = protocol.local_only_round(
        st.local_w, completed=_put(sched.completed[i], device),
        local_train_fn=train_fn, train_args=(i + 1,))


def _local_finish_segment(st, weights):
    """There is no global model between rounds: aggregate at eval stops
    (and leave the result in the state, so final_global is uniform)."""
    st.global_w = protocol.aggregate(st.local_w, weights)


def _fedasync_precompute(env, sp, *, rounds, seed):
    del seed  # FedAsync's event process draws only from the env rng
    return agg_schemes.precompute_async_schedule(
        env, rounds=rounds, **agg_schemes.async_kwargs(sp))


def _fedasync_fleet_precompute(members, sp, *, rounds):
    return schedules.AsyncFleetSchedule.stack([
        agg_schemes.precompute_async_schedule(
            mem.env, rounds=rounds, **agg_schemes.async_kwargs(sp, mem))
        for mem in members])


def _fedasync_segment(st, seg, weights, train_fn, ex, ctx):
    del weights, ex  # the mixing weights live in the schedule
    st.global_w, st.local_w = protocol.fedasync_run_scan(
        st.global_w, st.local_w, seg, local_train_fn=train_fn,
        train_ctx=ctx)


def _fedasync_loop_round(st, sched, i, weights, train_fn, ex, device):
    del weights, ex
    st.global_w, st.local_w = protocol.fedasync_round(
        st.global_w, st.local_w, committed=_put(sched.committed[i], device),
        order=_put(sched.order[i], device),
        alphas=_put(sched.alphas[i], device, torch.float32),
        local_train_fn=train_fn, train_args=(i + 1,))


def _weighted_precompute(env, sp, *, rounds, seed):
    del seed  # the family's event process draws only from the env rng
    return agg_schemes.precompute_weighted_schedule(
        env, rounds=rounds, **agg_schemes.weighted_kwargs(sp))


def _weighted_fleet_precompute(members, sp, *, rounds):
    return schedules.WeightedFleetSchedule.stack([
        agg_schemes.precompute_weighted_schedule(
            mem.env, rounds=rounds, **agg_schemes.weighted_kwargs(sp, mem))
        for mem in members])


def _weighted_segment(st, seg, weights, train_fn, ex, ctx):
    del weights  # the merge weights live in the schedule
    st.global_w, st.local_w = protocol.weighted_run_scan(
        st.global_w, st.local_w, seg, local_train_fn=train_fn,
        use_kernel=ex.use_kernel, wire=ex.wire, train_ctx=ctx)


def _weighted_loop_round(st, sched, i, weights, train_fn, ex, device):
    del weights
    st.global_w, st.local_w = protocol.weighted_round(
        st.global_w, st.local_w, committed=_put(sched.committed[i], device),
        wrow=_put(sched.wrow[i], device, torch.float32),
        local_train_fn=train_fn, train_args=(i + 1,),
        use_kernel=ex.use_kernel, wire=ex.wire)


def _safa_dispatch_budget(ex) -> Optional[int]:
    """Kernel launches of one SAFA round (rule T001).  The dense and
    sparse int8 cells are the compressed round of two launches (quantise,
    then the fused int8 aggregation) whatever the model's depth."""
    if ex.schedule == 'sparse_tier':
        if not ex.use_kernel:
            return 2 if ex.wire == 'int8' else 0
        # gather the bases, the tier aggregation (+ quantise on the wire)
        return 3 if ex.wire == 'int8' else 2
    if ex.schedule == 'sparse_delta':
        if not ex.use_kernel:
            return 2 if ex.wire == 'int8' else 0
        # gather, rows aggregation, two scatters (local and cache rows)
        return 5 if ex.wire == 'int8' else 4
    if ex.wire == 'int8':
        return 2
    if ex.use_kernel == 'packed':
        return 1
    if ex.use_kernel:
        return None     # per leaf: one launch for each leaf of the model
    return 0


def _safa_alias_claims(ex) -> dict:
    """The in-place writes a SAFA cell's rounds must make (rule T003):
    without them the server holds a second cache or value buffer."""
    fleet = '_fleet' if ex.engine == 'fleet' else ''
    if ex.schedule == 'sparse_tier':
        if not ex.use_kernel:
            return {}
        q8 = '_q8' if ex.wire == 'int8' else ''
        return {f'safa_aggregate_packed{q8}_tier_rows{fleet}': ('buf',)}
    if ex.schedule == 'sparse_delta':
        return {f'scatter_rows{fleet}': ('buf',)} if ex.use_kernel else {}
    if ex.wire == 'int8':
        return {f'safa_aggregate_packed_q8{fleet}': ('cache',)}
    if ex.use_kernel == 'packed':
        return {f'safa_aggregate_packed{fleet}': ('cache',)}
    return {}


def _wire_only_dispatch_budget(ex) -> int:
    """Protocols without an aggregation kernel launch only the int8
    wire's round trip (quantise and dequantise)."""
    return 2 if ex.wire == 'int8' else 0


register(ProtocolDef(
    name='safa', spec_cls=SafaSpec,
    precompute=_safa_precompute,
    fleet_precompute=lambda members, sp, *, rounds:
        federation.precompute_fleet_schedule(members, rounds=rounds),
    segment=_safa_segment, loop_round=_safa_loop_round,
    uses_cache=True, supports_wire=True, supports_kernel=True,
    sparse_forms=('sparse', 'sparse_delta', 'sparse_tier'),
    sparse_precompute=_safa_sparse_precompute,
    tier_precompute=_safa_tier_precompute,
    prepare_state=_safa_prepare_state,
    dispatch_budget=_safa_dispatch_budget,
    alias_claims=_safa_alias_claims))

register(ProtocolDef(
    name='fedavg', spec_cls=FedAvgSpec,
    precompute=_sync_precompute(fedcs=False),
    fleet_precompute=_sync_fleet_precompute(fedcs=False),
    segment=_fedavg_segment, loop_round=_fedavg_loop_round,
    supports_wire=True, sparse_forms=('sparse', 'sparse_delta'),
    sparse_precompute=_sync_precompute(fedcs=False, form='sparse'),
    delta_stateless=True, dispatch_budget=_wire_only_dispatch_budget))

register(ProtocolDef(
    name='fedcs', spec_cls=FedCSSpec,
    precompute=_sync_precompute(fedcs=True),
    fleet_precompute=_sync_fleet_precompute(fedcs=True),
    segment=_fedavg_segment, loop_round=_fedavg_loop_round,
    supports_wire=True, sparse_forms=('sparse', 'sparse_delta'),
    sparse_precompute=_sync_precompute(fedcs=True, form='sparse'),
    delta_stateless=True, dispatch_budget=_wire_only_dispatch_budget))

register(ProtocolDef(
    name='local', spec_cls=LocalSpec,
    precompute=_local_precompute,
    fleet_precompute=_local_fleet_precompute,
    segment=_local_segment, loop_round=_local_loop_round,
    finish_segment=_local_finish_segment, dispatch_budget=lambda ex: 0))

register(ProtocolDef(
    name='fedasync', spec_cls=FedAsyncSpec,
    precompute=_fedasync_precompute,
    fleet_precompute=_fedasync_fleet_precompute,
    segment=_fedasync_segment, loop_round=_fedasync_loop_round,
    spec_overrides=True, dispatch_budget=lambda ex: 0))

for _name, _cls in (('seafl', SeaflSpec), ('csafl', CsaflSpec)):
    register(ProtocolDef(
        name=_name, spec_cls=_cls,
        precompute=_weighted_precompute,
        fleet_precompute=_weighted_fleet_precompute,
        segment=_weighted_segment, loop_round=_weighted_loop_round,
        supports_wire=True, supports_kernel='packed', spec_overrides=True,
        dispatch_budget=agg_schemes.weighted_dispatch_budget))


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
        self._pdef = check_compat(self.protocol, self.exec, env=env)
        self.env = _realize_env(env, task=task, ex=self.exec)
        self._sched = None

    def precompute(self):
        """Run the host event state machine once and cache the schedule:
        [rounds, m] masks for ``schedule='dense'``, [rounds, K] (idx,
        roles) otherwise (the same event stream), with the slot maps on
        ``'sparse_tier'``; the env rng is consumed exactly once per
        Experiment."""
        if self._sched is None:
            if self.exec.schedule == 'dense':
                pre = self._pdef.precompute
            elif self.exec.schedule == 'sparse_tier':
                pre = self._pdef.tier_precompute
            else:
                pre = self._pdef.sparse_precompute
            self._sched = pre(
                self.env, self.protocol, rounds=self.rounds, seed=self.seed)
        return self._sched

    def compile(self) -> 'CompiledRunner':
        return CompiledRunner(self)

    def fingerprint(self, members=None, tasks=None, task=None) -> str:
        """Identity of the run a checkpoint belongs to: protocol and exec
        specs, rounds, seed, env(s), and the task(s), so a carry is never
        resumed against other training data.  ``init_params`` stays out:
        a resumed carry replaces the initial state."""
        parts = [
            f'proto={self._pdef.name}',
            f'spec={dataclasses.asdict(self.protocol)!r}',
            f'exec={dataclasses.asdict(self.exec)!r}',
            f'rounds={self.rounds}', f'seed={self.seed}',
        ]
        if members is None:
            parts.append('env=' + _env_fp(self.env))
            parts.append('task=' + _task_fp(self.task))
        else:
            parts += ['member=' + _env_fp(mem.env) + repr(
                (mem.fraction, mem.lag_tolerance, mem.seed, mem.alpha,
                 mem.staleness_exp, mem.overrides)) for mem in members]
            if tasks is not None:
                parts += ['task=' + _task_fp(t) for t in tasks]
            else:
                parts.append('task=' + _task_fp(task))
        return '|'.join(parts)


def _stops(max_segments, done: int, seg_done: int, n_segments: int
           ) -> bool:
    """A call given ``max_segments`` stops once it has run that many
    segments, unless the run is over anyway."""
    return max_segments is not None and done >= max_segments \
        and seg_done < n_segments


def _check_task_device(task, device) -> None:
    if task is not None and task.device != device:
        raise ValueError(f'task data lies on {task.device}, the '
                         f'experiment runs on {device}')


class CompiledRunner:
    """Executes an ``Experiment``: ``run()`` the single run,
    ``run_sweep(members)`` S member configurations as one fleet."""

    def __init__(self, exp: Experiment):
        self.exp = exp
        self._pdef = exp._pdef
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

    def _stateless(self, ex: ExecSpec) -> bool:
        """A global-only carry: no [m, ...] local or cache stacks.  A lag
        tier run is always one (``prepare_state`` then builds its value
        buffer)."""
        return (ex.schedule == 'sparse_delta' and self._pdef.delta_stateless
                ) or ex.schedule == 'sparse_tier'

    def _finish(self, st: _RunState, weights) -> None:
        if self._pdef.finish_segment is not None:
            self._pdef.finish_segment(st, weights)

    def _train_fn(self, task):
        if self.exp.exec.schedule != 'dense':
            # rows-train contract: (params_rows, rows, round_idx)
            return task.local_train_rows
        if getattr(self.exp.protocol, 'quantize_uploads', False):
            return federation._quantized_train_fn(task.local_train)
        return task.local_train

    def _resume(self, st: _RunState, hists: list, checkpoint, fingerprint
                ) -> int:
        """Load ``checkpoint`` into ``st`` and ``hists`` when it exists;
        returns the number of segments it completed (0 without one)."""
        if checkpoint is None or not ckpt.exists(checkpoint):
            return 0
        tree, seg_done, saved = ckpt.load_run(checkpoint, st.tree(),
                                              fingerprint=fingerprint)
        st.set_tree(tree)
        for hist, d in zip(hists, saved):
            _apply_saved_history(hist, d)
        return seg_done

    def run(self, *, checkpoint: Optional[str] = None,
            max_segments: Optional[int] = None) -> History:
        """Execute the experiment: one segment per eval point, the global
        model evaluated at each.  ``checkpoint`` (a path) saves the carry
        at every eval-segment boundary and resumes from it when it
        exists; ``max_segments`` stops after that many segments in this
        call (the partial History carries the state reached so far)."""
        exp, pdef = self.exp, self._pdef
        ex = exp.exec
        engine = self._engine(sweep=False)
        sched = exp.precompute()
        hist = History(pdef.name, records=_fresh_records(sched.records),
                       futility=sched.futility)
        if not ex.numeric:
            return hist
        if exp.task is None:
            raise ValueError('numeric run needs a Task '
                             '(or ExecSpec(numeric=False))')
        st = _init_state(_init_global(exp.task, exp.seed, exp.device,
                                      exp.init_params),
                         exp.env.m, pdef.uses_cache,
                         stateless=self._stateless(ex))
        weights = torch.as_tensor(exp.env.weights, dtype=torch.float32,
                                  device=exp.device)
        if pdef.prepare_state is not None:
            pdef.prepare_state(st, weights, ex, sched)
        fingerprint = exp.fingerprint() if checkpoint is not None else None
        start_seg = self._resume(st, [hist], checkpoint, fingerprint)
        train_fn = self._train_fn(exp.task)
        if engine == 'scan' and self._dev is None:
            self._dev = sched.to_device(exp.device)
        evals = _eval_rounds(exp.rounds, ex.eval_every)
        start = evals[start_seg - 1] if start_seg else 0
        for k in range(start_seg, len(evals)):
            stop = evals[k]
            if engine == 'scan':
                pdef.segment(st, self._dev.segment(start, stop), weights,
                             train_fn, ex, None)
            else:
                for i in range(start, stop):
                    pdef.loop_round(st, sched, i, weights, train_fn, ex,
                                    exp.device)
            self._finish(st, weights)
            _record_eval(hist, hist.records[stop - 1], exp.task, st.global_w)
            start = stop
            if checkpoint is not None:
                ckpt.save_run(checkpoint, st.tree(), seg_done=k + 1,
                              histories=[hist], fingerprint=fingerprint)
            if _stops(max_segments, k - start_seg + 1, k + 1, len(evals)):
                break
        hist.final_global = st.global_w
        return hist

    # -- sweeps ---------------------------------------------------------------

    def run_sweep(self, members, *, checkpoint: Optional[str] = None,
                  max_segments: Optional[int] = None) -> list:
        """Run S = len(members) simulations of this protocol as one fleet;
        returns one ``History`` per member, in order.

        ``members`` is a list of ``SweepMember`` or a ``SweepSpec``, whose
        ``tasks`` (one per member) may hold different client partitions
        (padded stacking; dense schedules only).  Each member carries its
        own env and seed; the experiment's own are not used.
        ``engine='fleet'`` (the default) runs every member in one round
        body: one train call for all S * m client replicas (S * K on a
        sparse schedule) and one launch of each server kernel per round.
        ``engine='sequential'`` runs the same precomputed schedules member
        by member through the scan engine (a sparse member at its own
        active-set width, a lag-tier member at the fleet's width and
        capacity).  ``checkpoint`` and ``max_segments`` work as in
        ``run()`` (``engine='fleet'`` only)."""
        exp, pdef = self.exp, self._pdef
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
        members = [_resolve_member(
            mem, pdef=pdef, ex=ex,
            task=tasks[s] if tasks is not None else exp.task)
            for s, mem in enumerate(members)]
        m = members[0].env.m
        if any(mem.env.m != m for mem in members):
            raise ValueError('fleet members must share the client count m')
        if tasks is not None and all(t is tasks[0] for t in tasks):
            # one shared task object: the cheaper path without padding
            shared_task, tasks = tasks[0], None
        else:
            shared_task = exp.task
        if getattr(exp.protocol, 'quantize_uploads', False):
            raise ValueError(
                'quantize_uploads is the single-run per-leaf reference '
                "knob; sweeps take the packed wire instead (wire='int8')")
        for t in tasks or (shared_task,):
            _check_task_device(t, exp.device)
        if ex.schedule != 'dense' and tasks is not None:
            raise ValueError(
                'sparse schedules need the rows-train contract, which the '
                'padded per-member task stack does not implement; use a '
                'shared task (or schedule="dense")')

        fleet = pdef.fleet_precompute(members, exp.protocol,
                                      rounds=exp.rounds)
        if ex.schedule == 'sparse_tier':
            # the fleet-major lag-tier form of the same event streams: the
            # members' slot maps share the fleet's width and capacity
            fleet = fleet.to_tier()
        elif ex.schedule != 'dense':
            # the fleet-major sparse form of the same event streams, every
            # member re-padded to the fleet's widest active set
            fleet = fleet.to_sparse()
        hists = [History(pdef.name, records=_fresh_records(fleet.records[s]),
                         futility=float(fleet.futility[s]))
                 for s in range(fleet.size)]
        if not ex.numeric:
            return hists
        if shared_task is None and tasks is None:
            raise ValueError('numeric sweep needs a Task (shared or '
                             'per-member) or ExecSpec(numeric=False)')
        if checkpoint is not None and engine != 'fleet':
            raise ValueError("sweep checkpointing requires engine='fleet'")

        def task_of(s):
            return tasks[s] if tasks is not None else shared_task

        evals = _eval_rounds(exp.rounds, ex.eval_every)
        stateless = self._stateless(ex)
        if engine == 'sequential':
            for s, (mem, hist) in enumerate(zip(members, hists)):
                st = _init_state(_init_global(task_of(s), mem.seed,
                                              exp.device, exp.init_params),
                                 m, pdef.uses_cache, stateless=stateless)
                msched = fleet.member(s)
                dev = msched.to_device(exp.device)
                w_s = torch.as_tensor(mem.env.weights, dtype=torch.float32,
                                      device=exp.device)
                if pdef.prepare_state is not None:
                    pdef.prepare_state(st, w_s, ex, msched)
                train_fn = self._train_fn(task_of(s))
                start = 0
                for stop in evals:
                    pdef.segment(st, dev.segment(start, stop), w_s,
                                 train_fn, ex, None)
                    self._finish(st, w_s)
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
            ctx = None
            train_fn = shared_task.local_train_fleet \
                if ex.schedule == 'dense' \
                else shared_task.local_train_rows_fleet
            g = init_fleet_global(shared_task, [mem.seed for mem in members],
                                  init_params=exp.init_params)
        st = _init_state(g, m, pdef.uses_cache, fleet=True,
                         stateless=stateless)
        weights = torch.as_tensor(
            np.stack([mem.env.weights for mem in members]),
            dtype=torch.float32, device=exp.device)
        if pdef.prepare_state is not None:
            pdef.prepare_state(st, weights, ex, fleet)
        fingerprint = exp.fingerprint(members, tasks=tasks, task=shared_task) \
            if checkpoint is not None else None
        start_seg = self._resume(st, hists, checkpoint, fingerprint)
        dev = fleet.to_device(exp.device)
        start = evals[start_seg - 1] if start_seg else 0
        for k in range(start_seg, len(evals)):
            stop = evals[k]
            pdef.segment(st, dev.fleet_segment(start, stop), weights,
                         train_fn, ex, ctx)
            self._finish(st, weights)
            for s, hist in enumerate(hists):
                _record_eval(hist, hist.records[stop - 1], task_of(s),
                             _member(st.global_w, s))
            start = stop
            if checkpoint is not None:
                ckpt.save_run(checkpoint, st.tree(), seg_done=k + 1,
                              histories=hists, fingerprint=fingerprint)
            if _stops(max_segments, k - start_seg + 1, k + 1, len(evals)):
                break
        for s, hist in enumerate(hists):
            hist.final_global = _member(st.global_w, s)
        return hists
