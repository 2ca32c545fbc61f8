"""Spec, schedule and result containers for the federation layer: the
protocol-spec base class, per-round records, run histories, sweep
members, the precomputed dense mask schedules of every protocol (one
run's, and a fleet's stacked member-major) and the sparse active-set
schedules of SAFA, FedAvg and FedCS (a run's, and a fleet's re-padded to
its widest member) and SAFA's lag-tier schedules (the sparse rows plus the
slot maps of one bounded value buffer) that the engines replay.  The
state machines that produce the schedules live in
``repro_torch.core.federation`` (the FedAsync and weighted-merge
family's in ``repro_torch.core.agg_schemes``); the engines that consume
them in ``repro_torch.core.protocol``."""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import protocol


@dataclasses.dataclass(frozen=True)
class ProtocolSpec:
    """Base class for protocol specs: protocol-semantic fields only;
    execution knobs live in ``api.ExecSpec``."""


@dataclasses.dataclass
class RoundRecord:
    round: int
    round_len: float
    t_dist: float
    eur: float
    sr: float
    vv: float
    n_picked: int
    n_committed: int
    n_crashed: int
    eval: Optional[dict] = None


@dataclasses.dataclass
class History:
    protocol: str
    records: list = dataclasses.field(default_factory=list)
    futility: float = 0.0
    best_eval: Optional[dict] = None
    final_global: Any = None

    def mean(self, field: str) -> float:
        return float(np.mean([getattr(r, field) for r in self.records]))

    def evals(self):
        return [(r.round, r.eval) for r in self.records if r.eval is not None]

    def to_dict(self) -> dict:
        """JSON-serialisable form (checkpoint metadata): numpy and torch
        scalars in the records become Python numbers here, the records
        themselves unchanged.  ``final_global`` is a device tree and is
        left out: checkpoints hold the model state separately
        (``repro_torch.checkpoint``)."""
        return {
            'protocol': self.protocol,
            'futility': float(self.futility),
            'best_eval': _plain(self.best_eval),
            'records': [_plain(dataclasses.asdict(r)) for r in self.records],
        }

    @classmethod
    def from_dict(cls, d: dict) -> 'History':
        return cls(protocol=d['protocol'],
                   records=[RoundRecord(**r) for r in d['records']],
                   futility=d['futility'], best_eval=d['best_eval'])


def _plain(v):
    """``v`` with numpy and torch scalars as Python numbers (dicts and
    lists recursed), so that ``json.dumps`` takes it."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, (np.generic, torch.Tensor)):
        return v.item()
    return v


@dataclasses.dataclass
class SweepMember:
    """One simulation in a fleet sweep: its own environment and protocol
    hyper-parameters.  All members of a sweep share the client count
    ``m``; they share the Task too unless the sweep carries per-member
    Tasks (``api.SweepSpec(tasks=...)``, padded stacking)."""
    #: the member's environment: an ``fedsim.EnvSpec`` (declarative: the
    #: sweep builds each member a fresh env, and ``overrides`` may then
    #: rewrite env fields) or a built ``Env``
    env: Any
    fraction: float = 0.5       # ignored by fedasync (fully asynchronous)
    lag_tolerance: int = 5      # SAFA only
    seed: int = 0               # numeric-init (and sync/local-selection) seed
    alpha: float = 0.6          # fedasync/seafl/csafl: base mixing weight
    staleness_exp: float = 0.5  # fedasync/seafl/csafl: poly discount exponent
    #: per-member field overrides, split by key at sweep resolution:
    #: ``EnvSpec`` field names (``crash_prob``, ``traces``, ``draw_seed``,
    #: ...) rewrite the member's declarative env; the rest must be
    #: protocol-spec fields of a protocol that takes them (FedAsync:
    #: ``staleness_fn``, ``hinge_a``/``hinge_b``; SEAFL/CSAFL also
    #: ``scheme``, ``use_loss``, ``loss_coef``, ``clusters``).  ``None`` ==
    #: no overrides.
    overrides: Optional[dict] = None


@dataclasses.dataclass
class SafaSchedule:
    """Precomputed SAFA event process: [rounds, m] bool mask schedules plus
    the timing records they imply.  Independent of model weights."""
    sync: np.ndarray
    committed: np.ndarray
    picked: np.ndarray
    undrafted: np.ndarray
    deprecated: np.ndarray
    records: list
    futility: float

    @property
    def rounds(self) -> int:
        return self.sync.shape[0]

    def to_device(self, device) -> protocol.RoundSchedule:
        """One host->device hop for the whole run."""
        def put(a):
            return torch.as_tensor(a, device=device)
        return protocol.RoundSchedule(
            sync=put(self.sync), completed=put(self.committed),
            picked=put(self.picked), undrafted=put(self.undrafted),
            deprecated=put(self.deprecated),
            round_idx=_round_idx(self.rounds, device))

    def to_sparse(self, capacity: Optional[int] = None) -> 'SparseSchedule':
        """Compact [rounds, K] form of the same event stream (see the
        sparse-schedule section below)."""
        m = self.sync.shape[1]
        rows = [safa_sparse_row(self.sync[t], self.committed[t],
                                self.picked[t], self.undrafted[t],
                                self.deprecated[t], bootstrap=(t == 0))
                for t in range(self.rounds)]
        idx, roles = pack_sparse_rows(rows, m, capacity)
        return SparseSchedule(m=m, idx=idx, roles=roles,
                              records=self.records, futility=self.futility)

    def to_tier(self, capacity: Optional[int] = None) -> 'TierSchedule':
        """Lag-tier form: replay the version counters the SAFA state
        machine keeps (``v[sync] = gv`` before selection, ``v[committed] =
        t`` after) to recover each active client's base version, then hand
        the per-round event rows to the slot allocator.
        ``federation.precompute_safa_schedule(form='sparse_tier')`` records
        the same data inline, so both build the same schedule."""
        m = self.sync.shape[1]
        v = np.zeros(m, np.int64)
        rows, base_rows = [], []
        for t in range(self.rounds):
            v[self.sync[t]] = t
            row = safa_sparse_row(self.sync[t], self.committed[t],
                                  self.picked[t], self.undrafted[t],
                                  self.deprecated[t], bootstrap=(t == 0))
            rows.append(row)
            base_rows.append(v[row[0]].copy())
            v[self.committed[t]] = t + 1
        return build_tier_schedule(m, rows, base_rows, self.records,
                                   self.futility, capacity=capacity)


def _round_idx(rounds: int, device) -> torch.Tensor:
    """[rounds] round indices 1..rounds for ``to_device``."""
    return torch.arange(1, rounds + 1, dtype=torch.int32, device=device)


@dataclasses.dataclass
class SyncSchedule:
    """Precomputed FedAvg/FedCS event process ([rounds, m] masks + records).
    ``completed`` is the per-round survivor mask (``~crashed``); the numeric
    round intersects it with ``selected`` itself."""
    selected: np.ndarray
    completed: np.ndarray
    records: list
    futility: float

    @property
    def rounds(self) -> int:
        return self.selected.shape[0]

    def to_device(self, device) -> protocol.SyncSchedule:
        return protocol.SyncSchedule(
            selected=torch.as_tensor(self.selected, device=device),
            completed=torch.as_tensor(self.completed, device=device),
            round_idx=_round_idx(self.rounds, device))

    def to_sparse(self, capacity: Optional[int] = None
                  ) -> 'SparseSyncSchedule':
        """Compact [rounds, K] form of the same event stream."""
        m = self.selected.shape[1]
        rows = [sync_sparse_row(self.selected[t], self.completed[t])
                for t in range(self.rounds)]
        idx, roles = pack_sparse_rows(rows, m, capacity)
        return SparseSyncSchedule(m=m, idx=idx, roles=roles,
                                  records=self.records,
                                  futility=self.futility)


@dataclasses.dataclass
class LocalSchedule:
    """Precomputed fully-local event process ([rounds, m] survivor mask +
    records).  ``completed`` is selected & survived, the only mask the
    numeric round needs (there is no aggregation until eval points)."""
    completed: np.ndarray
    records: list
    futility: float

    @property
    def rounds(self) -> int:
        return self.completed.shape[0]

    def to_device(self, device) -> protocol.LocalSchedule:
        return protocol.LocalSchedule(
            completed=torch.as_tensor(self.completed, device=device),
            round_idx=_round_idx(self.rounds, device))


@dataclasses.dataclass
class FedasyncSchedule:
    """Precomputed FedAsync event process: [rounds, m] commit masks plus
    the arrival-ordered merge permutations and staleness-scaled mixing
    weights the sequential server applies each round.  Model weights never
    enter (merge order is arrival timing, the alphas depend on staleness
    alone), so the whole schedule is known up front."""
    committed: np.ndarray       # [rounds, m] bool
    order: np.ndarray           # [rounds, m] int: arrival merge order
    alphas: np.ndarray          # [rounds, m] float: 0 for non-commits
    records: list
    futility: float

    @property
    def rounds(self) -> int:
        return self.committed.shape[0]

    def to_device(self, device) -> protocol.AsyncSchedule:
        return protocol.AsyncSchedule(
            committed=torch.as_tensor(self.committed, device=device),
            order=torch.as_tensor(self.order, device=device),
            alphas=torch.as_tensor(self.alphas, dtype=torch.float32,
                                   device=device),
            round_idx=_round_idx(self.rounds, device))


@dataclasses.dataclass
class WeightedSchedule:
    """Precomputed weighted-merge event process: [rounds, m] commit masks
    plus the per-client effective merge weights the one-shot server merge
    applies each round (``protocol.weighted_round``).

    This is the common lowering of the staleness-adaptive aggregation
    family (SEAFL adaptive weights, CSAFL per-cluster semi-async
    aggregation, folded FedAsync discounts): the scheme lives entirely in
    how ``wrow`` was computed, so every scheme replays through one
    engine.  Rows are zero off the committed set and sum to at most 1."""
    committed: np.ndarray       # [rounds, m] bool
    wrow: np.ndarray            # [rounds, m] float: 0 for non-commits
    records: list
    futility: float

    @property
    def rounds(self) -> int:
        return self.committed.shape[0]

    def to_device(self, device) -> protocol.WeightedSchedule:
        return protocol.WeightedSchedule(
            committed=torch.as_tensor(self.committed, device=device),
            wrow=torch.as_tensor(self.wrow, dtype=torch.float32,
                                 device=device),
            round_idx=_round_idx(self.rounds, device))


# ---------------------------------------------------------------------------
# Sparse (active-set) schedules: [rounds, K] index + role tensors
# ---------------------------------------------------------------------------
#
# A dense schedule stores five [rounds, m] masks; at large m that is the
# population, not the event process.  The sparse form stores only each
# round's active set, the clients whose state the round can touch (SAFA:
# sync | committed | deprecated; the synchronous protocols: selected), as
# a [rounds, K] int32 index tensor padded with the sentinel index m, and a
# [rounds, K] uint8 role bitmask per slot (``protocol.ROLE_*``/
# ``SROLE_*``).  Every dense mask is a subset of the active set, so the
# dense masks are exactly reconstructible and both forms replay one
# event stream.


def safa_sparse_row(sync, committed, picked, undrafted, deprecated, *,
                    bootstrap: bool = False):
    """One round's compact (idx, roles) from its dense [m] bool masks.

    ``bootstrap=True`` marks round 1, where every client holds the current
    version and the dense sync mask covers the whole population.  A
    sync-only client's transition there, local := global, is the identity
    because every engine starts from local = cache = broadcast(global), so
    those clients are left out and the active set stays quota-bounded.
    Clients holding any other role keep their sync bit."""
    role = (sync * protocol.ROLE_SYNC
            + committed * protocol.ROLE_COMMITTED
            + picked * protocol.ROLE_PICKED
            + undrafted * protocol.ROLE_UNDRAFTED
            + deprecated * protocol.ROLE_DEPRECATED).astype(np.uint8)
    if bootstrap:
        role = np.where(role == protocol.ROLE_SYNC, 0, role).astype(np.uint8)
    active = np.flatnonzero(role)
    return active.astype(np.int32), role[active]


def sync_sparse_row(selected, completed):
    """One round's compact (idx, roles) for a synchronous protocol.  The
    active set is the selected set; the survivor bit is stored per slot
    (the dense ``completed`` mask outside the selection never reaches the
    numeric round, which intersects the two)."""
    role = (selected * protocol.SROLE_SELECTED
            + (selected & completed) * protocol.SROLE_COMPLETED
            ).astype(np.uint8)
    active = np.flatnonzero(role)
    return active.astype(np.int32), role[active]


def pack_sparse_rows(rows, m: int, capacity: Optional[int] = None):
    """Pad per-round (idx, roles) pairs to [rounds, capacity] arrays.

    ``capacity`` defaults to the largest active set; an explicit capacity
    below some round's active set is an error naming the round, since
    truncating would drop events."""
    need = max([len(i) for i, _ in rows] or [0])
    cap = max(need, 1) if capacity is None else capacity
    idx = np.full((len(rows), cap), m, np.int32)
    roles = np.zeros((len(rows), cap), np.uint8)
    for t, (i, r) in enumerate(rows):
        if len(i) > cap:
            raise ValueError(
                f'sparse schedule capacity {cap} < active-set size '
                f'{len(i)} at round {t}: raise capacity (or the t_lim/'
                f'lag_tolerance knobs bounding the active set)')
        idx[t, :len(i)] = i
        roles[t, :len(i)] = r
    return idx, roles


@dataclasses.dataclass
class SparseSchedule:
    """Compact SAFA event process: [rounds, K] active-set indices and role
    bitmasks, with the same host-side ``records``/``futility`` as the
    dense schedule."""
    m: int
    idx: np.ndarray             # [rounds, K] int32, sentinel == m
    roles: np.ndarray           # [rounds, K] uint8 of protocol.ROLE_* bits
    records: list
    futility: float

    @property
    def rounds(self) -> int:
        return self.idx.shape[0]

    @property
    def capacity(self) -> int:
        return self.idx.shape[1]

    @property
    def nbytes(self) -> int:
        return self.idx.nbytes + self.roles.nbytes

    def to_device(self, device) -> protocol.SparseRoundSchedule:
        """One host->device hop for the whole run."""
        return protocol.SparseRoundSchedule(
            idx=torch.as_tensor(self.idx, device=device),
            roles=torch.as_tensor(self.roles, device=device),
            round_idx=_round_idx(self.rounds, device))

    def to_dense(self) -> SafaSchedule:
        """The dense [rounds, m] masks, exact except that round 1's sync
        mask holds only the active clients: the population-wide bootstrap
        sync is left out at emission (``safa_sparse_row``), as it changes
        no state.  Engine results are the same either way."""
        bits = {'sync': protocol.ROLE_SYNC,
                'committed': protocol.ROLE_COMMITTED,
                'picked': protocol.ROLE_PICKED,
                'undrafted': protocol.ROLE_UNDRAFTED,
                'deprecated': protocol.ROLE_DEPRECATED}
        masks = {k: np.zeros((self.rounds, self.m), bool) for k in bits}
        for t in range(self.rounds):
            valid = self.idx[t] < self.m
            i, r = self.idx[t][valid], self.roles[t][valid]
            for k, b in bits.items():
                masks[k][t, i] = (r & b) != 0
        return SafaSchedule(records=self.records, futility=self.futility,
                            **masks)


@dataclasses.dataclass
class SparseSyncSchedule:
    """Compact FedAvg/FedCS event process ([rounds, K] indices and
    SROLE_* bitmasks over the selected set)."""
    m: int
    idx: np.ndarray
    roles: np.ndarray
    records: list
    futility: float

    rounds = SparseSchedule.rounds
    capacity = SparseSchedule.capacity
    nbytes = SparseSchedule.nbytes

    def to_device(self, device) -> protocol.SparseSyncSchedule:
        return protocol.SparseSyncSchedule(
            idx=torch.as_tensor(self.idx, device=device),
            roles=torch.as_tensor(self.roles, device=device),
            round_idx=_round_idx(self.rounds, device))

    def to_dense(self) -> SyncSchedule:
        """The dense [rounds, m] masks.  ``completed`` is exact on the
        selected set only, all the numeric round reads (it intersects the
        two); off the selection it reads False."""
        selected = np.zeros((self.rounds, self.m), bool)
        completed = np.zeros((self.rounds, self.m), bool)
        for t in range(self.rounds):
            valid = self.idx[t] < self.m
            i, r = self.idx[t][valid], self.roles[t][valid]
            selected[t, i] = (r & protocol.SROLE_SELECTED) != 0
            completed[t, i] = (r & protocol.SROLE_COMPLETED) != 0
        return SyncSchedule(selected=selected, completed=completed,
                            records=self.records, futility=self.futility)


# ---------------------------------------------------------------------------
# Lag-tier schedules: a version ring and the active rows' slot maps
# ---------------------------------------------------------------------------
#
# The sparse form bounds the schedule's memory, but SAFA's numeric state
# still carries [m, N] local and cache stacks.  The lag-tolerant
# distribution makes most of that redundant: an inactive client's local
# row is the global snapshot at its version (lag <= tau, so at most tau + 2
# distinct snapshots are live), and its cache row is such a snapshot or one
# of the <= quota commit rows of its last active round.  The tier form
# replaces both stacks with one value buffer of ``capacity + 1`` rows (a
# version ring and an active-commit slab in one tensor; the trailing row
# is scratch) and host-precomputed per-round slot maps:
#
#   base_src[t, j]   slot holding slot j's base model (its version's
#                    global snapshot); scratch for synced slots.
#   cache_src[t, j]  slot holding slot j's cache row c0.
#   cache_dst[t, j]  slot that receives slot j's new cache row c2; scratch
#                    when the value is never read again (or when c2 is a
#                    global snapshot already in the ring).
#   global_dst[t]    slot that receives the round's output global; scratch
#                    once no later round reads it.
#
# Slots are assigned by value lifetime (a first-fit heap over exact
# last-read rounds), so ``capacity`` is the peak number of live distinct
# rows, O(tau + quota) whatever m.  Within a round every read slot
# differs from every written slot, scratch apart (a value written in round
# t is first read strictly later): that is what lets the tier kernels
# write the buffer in place.  Local state needs no buffer: a committed
# client is force-synced the next round it appears, so a trained local row
# is never read back and base rows are always version snapshots.


def build_tier_schedule(m: int, rows, base_rows, records, futility,
                        capacity: Optional[int] = None) -> 'TierSchedule':
    """Lower per-round sparse event rows and base versions to slot maps.

    ``rows`` are ``safa_sparse_row`` outputs; ``base_rows[t]`` holds the
    version counter (after sync, before commit) of each active client,
    aligned with ``rows[t][0]``.  Two passes: record every value read and
    write with its exact rounds, then allocate buffer slots by lifetime."""
    rounds = len(rows)
    idx, roles = pack_sparse_rows(rows, m, capacity)
    width = idx.shape[1]
    R_S, R_P = protocol.ROLE_SYNC, protocol.ROLE_PICKED
    R_U, R_D = protocol.ROLE_UNDRAFTED, protocol.ROLE_DEPRECATED
    R_C = protocol.ROLE_COMMITTED

    # Pass A, value ids: version v -> v (0..rounds; version 0 is the
    # initial global, version t + 1 round t's output); commit events ->
    # rounds + 1 + their event number.
    n_vals = rounds + 1
    cache_ref: dict = {}        # client -> value id its cache row holds
    last_read: dict = {}        # value id -> last round reading it
    base_val = np.full((rounds, width), -1, np.int64)
    cache_val = np.full((rounds, width), -1, np.int64)
    commit_val = np.full((rounds, width), -1, np.int64)
    for i, ((act, rls), bv) in enumerate(zip(rows, base_rows)):
        for j in range(len(act)):
            k, r = int(act[j]), int(rls[j])
            if (r & R_C) and not (r & R_S):
                base_val[i, j] = v = int(bv[j])
                last_read[v] = i
            if r & (R_P | R_U | R_D):
                cache_val[i, j] = cv = cache_ref.get(k, 0)
                last_read[cv] = i
            if r & (R_P | R_U):
                commit_val[i, j] = cache_ref[k] = n_vals
                n_vals += 1
            elif r & R_D:
                # cache := the current global: version i is already in the
                # ring (or never read again), so no slot is written
                cache_ref[k] = i

    # Pass B, slot allocation in write order.  Version v is written in
    # round v - 1 (version 0 before the run), commit values in their
    # round.  A slot frees the round after its value's last read.
    writes: dict = {wr: [] for wr in range(-1, rounds)}
    if 0 in last_read:
        writes[-1].append(0)
    for i in range(rounds):
        for j in range(width):
            v = int(commit_val[i, j])
            if v >= 0 and v in last_read:
                writes[i].append(v)
        if (i + 1) in last_read:
            writes[i].append(i + 1)
    slot_of: dict = {}
    free: list = []
    pending: dict = {wr: [] for wr in range(rounds + 1)}
    next_slot = 0
    for wr in range(-1, rounds):
        if wr >= 0:
            for s in pending[wr]:
                heapq.heappush(free, s)
        for val in writes[wr]:
            if free:
                s = heapq.heappop(free)
            else:
                s = next_slot
                next_slot += 1
            slot_of[val] = s
            pending.setdefault(last_read[val] + 1, []).append(s)

    scratch = next_slot
    base_src = np.full((rounds, width), scratch, np.int32)
    cache_src = np.full((rounds, width), scratch, np.int32)
    cache_dst = np.full((rounds, width), scratch, np.int32)
    global_dst = np.full(rounds, scratch, np.int32)
    for i in range(rounds):
        for j in range(width):
            if base_val[i, j] >= 0:
                base_src[i, j] = slot_of[int(base_val[i, j])]
            if cache_val[i, j] >= 0:
                cache_src[i, j] = slot_of[int(cache_val[i, j])]
            v = int(commit_val[i, j])
            if v >= 0 and v in slot_of:
                cache_dst[i, j] = slot_of[v]
        if (i + 1) in slot_of:
            global_dst[i] = slot_of[i + 1]
    versions_stored = sum(1 for v in slot_of if v <= rounds)
    return TierSchedule(
        m=m, idx=idx, roles=roles, base_src=base_src, cache_src=cache_src,
        cache_dst=cache_dst, global_dst=global_dst, capacity=next_slot,
        versions_stored=versions_stored,
        commits_stored=len(slot_of) - versions_stored,
        records=records, futility=futility)


def _tier_to_device(self, device) -> protocol.TierRoundSchedule:
    """One host->device hop for a tier schedule: a run's [rounds, K] slot
    maps and [rounds] round indices, or a fleet's [S, rounds, K] and
    [S, rounds] (``fleet_segment`` cuts it into eval segments)."""
    def put(a):
        return torch.as_tensor(a, device=device)
    round_idx = _round_idx(self.rounds, device)
    if self.idx.ndim == 3:
        round_idx = round_idx.expand(self.size, self.rounds)
    return protocol.TierRoundSchedule(
        idx=put(self.idx), roles=put(self.roles),
        base_src=put(self.base_src), cache_src=put(self.cache_src),
        cache_dst=put(self.cache_dst), global_dst=put(self.global_dst),
        round_idx=round_idx)


def _tier_nbytes(self) -> int:
    return (self.idx.nbytes + self.roles.nbytes + self.base_src.nbytes
            + self.cache_src.nbytes + self.cache_dst.nbytes
            + self.global_dst.nbytes)


@dataclasses.dataclass
class TierSchedule:
    """Lag-tier SAFA event process (see the section comment above): sparse
    [rounds, K] active-set indices and roles plus the slot maps that drive
    one ``[capacity + 1, N]`` value buffer.  ``capacity`` is the peak
    live-row count (O(tau + quota)); the extra row is scratch."""
    m: int
    idx: np.ndarray             # [rounds, K] int32, sentinel == m
    roles: np.ndarray           # [rounds, K] uint8 of protocol.ROLE_* bits
    base_src: np.ndarray        # [rounds, K] int32 buffer slots
    cache_src: np.ndarray       # [rounds, K] int32
    cache_dst: np.ndarray       # [rounds, K] int32 (scratch == discard)
    global_dst: np.ndarray      # [rounds] int32
    capacity: int               # live slots; the scratch slot is capacity
    versions_stored: int
    commits_stored: int
    records: list
    futility: float

    @property
    def rounds(self) -> int:
        return self.idx.shape[0]

    @property
    def width(self) -> int:
        return self.idx.shape[1]

    @property
    def scratch(self) -> int:
        return self.capacity

    nbytes = property(_tier_nbytes)
    to_device = _tier_to_device

    def to_sparse(self) -> SparseSchedule:
        """The sparse event stream, without the slot maps."""
        return SparseSchedule(m=self.m, idx=self.idx, roles=self.roles,
                              records=self.records, futility=self.futility)

    def to_dense(self) -> SafaSchedule:
        return self.to_sparse().to_dense()


# ---------------------------------------------------------------------------
# Fleet-major stacking: [S, rounds, m] schedules for batched sweeps
# ---------------------------------------------------------------------------

class _FleetStack:
    """Fleet-major stacking of single-run schedules.  Subclasses set
    ``MASKS`` (the [S, rounds, m] field names, the first one fixing the
    shapes) and ``_MEMBER_CLS`` (the single-run schedule type)."""
    MASKS: tuple = ()
    _MEMBER_CLS = None

    @property
    def size(self) -> int:
        return getattr(self, self.MASKS[0]).shape[0]

    @property
    def rounds(self) -> int:
        return getattr(self, self.MASKS[0]).shape[1]

    @classmethod
    def stack(cls, members: list):
        """Stack S single-run schedules (all with the same rounds and m)."""
        if len({getattr(s, cls.MASKS[0]).shape for s in members}) != 1:
            raise ValueError('fleet members must share (rounds, m)')
        return cls(**{k: np.stack([getattr(s, k) for s in members])
                      for k in cls.MASKS},
                   records=[s.records for s in members],
                   futility=np.array([s.futility for s in members]))

    def member(self, s: int):
        """Member s's schedule, identical to its own precompute."""
        return self._MEMBER_CLS(
            **{k: getattr(self, k)[s] for k in self.MASKS},
            records=self.records[s], futility=float(self.futility[s]))

    def _round_idx(self, device) -> torch.Tensor:
        """[S, rounds] per-member round indices for ``to_device``."""
        return _round_idx(self.rounds, device).expand(self.size, self.rounds)


@dataclasses.dataclass
class FleetSchedule(_FleetStack):
    """S independent SAFA event processes stacked fleet-major.

    Mask arrays are [S, rounds, m]; ``records[s]`` / ``futility[s]`` hold
    member s's timing records and futility ratio, exactly as
    ``precompute_safa_schedule`` produces them."""
    sync: np.ndarray
    committed: np.ndarray
    picked: np.ndarray
    undrafted: np.ndarray
    deprecated: np.ndarray
    records: list
    futility: np.ndarray

    MASKS = ('sync', 'committed', 'picked', 'undrafted', 'deprecated')
    _MEMBER_CLS = SafaSchedule

    def to_device(self, device) -> protocol.RoundSchedule:
        """One host->device hop for the whole fleet: [S, rounds, m] masks
        and [S, rounds] round indices (``RoundSchedule.fleet_segment``
        cuts it into eval segments)."""
        def put(a):
            return torch.as_tensor(a, device=device)
        return protocol.RoundSchedule(
            sync=put(self.sync), completed=put(self.committed),
            picked=put(self.picked), undrafted=put(self.undrafted),
            deprecated=put(self.deprecated),
            round_idx=self._round_idx(device))

    def to_sparse(self, capacity: Optional[int] = None
                  ) -> 'SparseFleetSchedule':
        """Compact [S, rounds, K] form of the same event streams (K = the
        fleet-wide largest active set unless ``capacity`` is given)."""
        return SparseFleetSchedule.from_members(
            [self.member(s).to_sparse() for s in range(self.size)],
            capacity=capacity)

    def to_tier(self, capacity: Optional[int] = None
                ) -> 'TierFleetSchedule':
        """Lag-tier [S, rounds, K] form of the same event streams."""
        return TierFleetSchedule.from_members(
            [self.member(s).to_tier() for s in range(self.size)],
            capacity=capacity)


@dataclasses.dataclass
class SyncFleetSchedule(_FleetStack):
    """FedAvg/FedCS counterpart of ``FleetSchedule`` ([S, rounds, m])."""
    selected: np.ndarray
    completed: np.ndarray
    records: list
    futility: np.ndarray

    MASKS = ('selected', 'completed')
    _MEMBER_CLS = SyncSchedule

    def to_device(self, device) -> protocol.SyncSchedule:
        return protocol.SyncSchedule(
            selected=torch.as_tensor(self.selected, device=device),
            completed=torch.as_tensor(self.completed, device=device),
            round_idx=self._round_idx(device))

    def to_sparse(self, capacity: Optional[int] = None
                  ) -> 'SparseSyncFleetSchedule':
        return SparseSyncFleetSchedule.from_members(
            [self.member(s).to_sparse() for s in range(self.size)],
            capacity=capacity)


@dataclasses.dataclass
class LocalFleetSchedule(_FleetStack):
    """Fully-local counterpart of ``FleetSchedule`` ([S, rounds, m])."""
    completed: np.ndarray
    records: list
    futility: np.ndarray

    MASKS = ('completed',)
    _MEMBER_CLS = LocalSchedule

    def to_device(self, device) -> protocol.LocalSchedule:
        return protocol.LocalSchedule(
            completed=torch.as_tensor(self.completed, device=device),
            round_idx=self._round_idx(device))


@dataclasses.dataclass
class AsyncFleetSchedule(_FleetStack):
    """FedAsync counterpart of ``FleetSchedule``: [S, rounds, m] commit
    masks plus the merge-order and alpha tensors of each member's
    arrival-ordered sequential merges."""
    committed: np.ndarray
    order: np.ndarray
    alphas: np.ndarray
    records: list
    futility: np.ndarray

    MASKS = ('committed', 'order', 'alphas')
    _MEMBER_CLS = FedasyncSchedule

    def to_device(self, device) -> protocol.AsyncSchedule:
        return protocol.AsyncSchedule(
            committed=torch.as_tensor(self.committed, device=device),
            order=torch.as_tensor(self.order, device=device),
            alphas=torch.as_tensor(self.alphas, dtype=torch.float32,
                                   device=device),
            round_idx=self._round_idx(device))


@dataclasses.dataclass
class WeightedFleetSchedule(_FleetStack):
    """Weighted-merge counterpart of ``FleetSchedule``: [S, rounds, m]
    commit masks and effective merge-weight rows.  The scheme is data
    (the precomputed ``wrow``), so members of one fleet may replay
    different schemes of the staleness-adaptive family in one round
    body."""
    committed: np.ndarray
    wrow: np.ndarray
    records: list
    futility: np.ndarray

    MASKS = ('committed', 'wrow')
    _MEMBER_CLS = WeightedSchedule

    def to_device(self, device) -> protocol.WeightedSchedule:
        return protocol.WeightedSchedule(
            committed=torch.as_tensor(self.committed, device=device),
            wrow=torch.as_tensor(self.wrow, dtype=torch.float32,
                                 device=device),
            round_idx=self._round_idx(device))


# ---------------------------------------------------------------------------
# Sparse fleet stacking: [S, rounds, K] index and role arrays
# ---------------------------------------------------------------------------

class _SparseFleetStack:
    """Fleet-major stacking of sparse schedules.  Members may have grown
    different capacities; stacking re-pads every member to the fleet's
    largest (or an explicit capacity) so the arrays batch, while
    ``capacities`` keeps each member's own active-set width, so that
    ``member(s)`` hands back the ragged (unpadded) member schedule, as its
    own precompute made it.  Padded slots are sentinel no-ops (idx == m,
    roles == 0)."""
    _MEMBER_CLS = None
    _SCHEDULE_CLS = None

    @classmethod
    def from_members(cls, members: list, capacity: Optional[int] = None):
        if len({(s.m, s.rounds) for s in members}) != 1:
            raise ValueError('fleet members must share (m, rounds)')
        m = members[0].m
        need = max(s.capacity for s in members)
        cap = need if capacity is None else capacity
        if cap < need:
            raise ValueError(
                f'sparse fleet capacity {cap} < member active-set max {need}')

        def pad(a, fill):
            out = np.full(a.shape[:-1] + (cap,), fill, a.dtype)
            out[..., :a.shape[-1]] = a
            return out

        return cls(m=m,
                   idx=np.stack([pad(s.idx, m) for s in members]),
                   roles=np.stack([pad(s.roles, 0) for s in members]),
                   records=[s.records for s in members],
                   futility=np.array([s.futility for s in members]),
                   capacities=np.array([s.capacity for s in members],
                                       np.int32))

    @property
    def size(self) -> int:
        return self.idx.shape[0]

    @property
    def rounds(self) -> int:
        return self.idx.shape[1]

    @property
    def capacity(self) -> int:
        return self.idx.shape[2]

    @property
    def nbytes(self) -> int:
        return self.idx.nbytes + self.roles.nbytes

    def member(self, s: int):
        """Member s's schedule at its own capacity (a ragged slice, equal
        to the member's own precompute)."""
        cap = (int(self.capacities[s]) if self.capacities is not None
               else self.capacity)
        return self._MEMBER_CLS(m=self.m, idx=self.idx[s, :, :cap],
                                roles=self.roles[s, :, :cap],
                                records=self.records[s],
                                futility=float(self.futility[s]))

    def to_device(self, device):
        """One host->device hop for the whole fleet: [S, rounds, K] idx and
        roles and [S, rounds] round indices (``fleet_segment`` cuts it
        into eval segments)."""
        return self._SCHEDULE_CLS(
            idx=torch.as_tensor(self.idx, device=device),
            roles=torch.as_tensor(self.roles, device=device),
            round_idx=_round_idx(self.rounds, device).expand(self.size,
                                                             self.rounds))


@dataclasses.dataclass
class SparseFleetSchedule(_SparseFleetStack):
    """S compact SAFA event processes, fleet-major ([S, rounds, K])."""
    m: int
    idx: np.ndarray
    roles: np.ndarray
    records: list
    futility: np.ndarray
    capacities: Optional[np.ndarray] = None     # [S] per-member widths

    _MEMBER_CLS = SparseSchedule
    _SCHEDULE_CLS = protocol.SparseRoundSchedule


@dataclasses.dataclass
class SparseSyncFleetSchedule(_SparseFleetStack):
    """S compact FedAvg/FedCS event processes ([S, rounds, K])."""
    m: int
    idx: np.ndarray
    roles: np.ndarray
    records: list
    futility: np.ndarray
    capacities: Optional[np.ndarray] = None     # [S] per-member widths

    _MEMBER_CLS = SparseSyncSchedule
    _SCHEDULE_CLS = protocol.SparseSyncSchedule


@dataclasses.dataclass
class TierFleetSchedule:
    """S lag-tier SAFA event processes, fleet-major ([S, rounds, K]).

    Members may differ in active-set width and in slot capacity: stacking
    pads the width with sentinel no-op slots and remaps each member's
    scratch slot (its own ``capacity``) to the fleet's, so that one
    ``[S, capacity + 1, N]`` value buffer batches.  ``member(s)`` hands
    back the padded-width schedule in fleet slot space, so that the
    sequential engine replays a member with the fleet's widths and their
    numbers are the same bits."""
    m: int
    idx: np.ndarray             # [S, rounds, K]
    roles: np.ndarray
    base_src: np.ndarray
    cache_src: np.ndarray
    cache_dst: np.ndarray
    global_dst: np.ndarray      # [S, rounds]
    capacity: int               # the fleet's live slots; scratch == capacity
    capacities: np.ndarray      # [S] per-member live-slot counts
    widths: np.ndarray          # [S] per-member active-set widths
    versions_stored: np.ndarray
    commits_stored: np.ndarray
    records: list
    futility: np.ndarray

    @classmethod
    def from_members(cls, members: list,
                     capacity: Optional[int] = None) -> 'TierFleetSchedule':
        if len({(s.m, s.rounds) for s in members}) != 1:
            raise ValueError('fleet members must share (m, rounds)')
        m = members[0].m
        wid = max(s.width for s in members) if capacity is None else capacity
        need = max(s.width for s in members)
        if wid < need:
            raise ValueError(
                f'sparse fleet capacity {wid} < member active-set max {need}')
        cap = max(s.capacity for s in members)

        def pad(a, fill):
            out = np.full(a.shape[:-1] + (wid,), fill, a.dtype)
            out[..., :a.shape[-1]] = a
            return out

        def remap(s, a):
            # member scratch -> fleet scratch (the other slots keep the
            # member's own allocation)
            return np.where(a == s.capacity, cap, a).astype(np.int32)

        return cls(
            m=m,
            idx=np.stack([pad(s.idx, m) for s in members]),
            roles=np.stack([pad(s.roles, 0) for s in members]),
            base_src=np.stack([pad(remap(s, s.base_src), cap)
                               for s in members]),
            cache_src=np.stack([pad(remap(s, s.cache_src), cap)
                                for s in members]),
            cache_dst=np.stack([pad(remap(s, s.cache_dst), cap)
                                for s in members]),
            global_dst=np.stack([remap(s, s.global_dst) for s in members]),
            capacity=cap,
            capacities=np.array([s.capacity for s in members], np.int32),
            widths=np.array([s.width for s in members], np.int32),
            versions_stored=np.array([s.versions_stored for s in members],
                                     np.int32),
            commits_stored=np.array([s.commits_stored for s in members],
                                    np.int32),
            records=[s.records for s in members],
            futility=np.array([s.futility for s in members]))

    @property
    def size(self) -> int:
        return self.idx.shape[0]

    @property
    def rounds(self) -> int:
        return self.idx.shape[1]

    @property
    def width(self) -> int:
        return self.idx.shape[2]

    nbytes = property(_tier_nbytes)
    to_device = _tier_to_device

    def member(self, s: int) -> TierSchedule:
        """Member s in fleet slot space (scratch == the fleet's capacity)
        at the fleet's padded width: the sequential engine then runs the
        program the fleet runs, with the same reduction widths.  A member's
        own precompute (its own width and capacity) runs the same events
        through narrower reductions."""
        return TierSchedule(
            m=self.m, idx=self.idx[s], roles=self.roles[s],
            base_src=self.base_src[s], cache_src=self.cache_src[s],
            cache_dst=self.cache_dst[s], global_dst=self.global_dst[s],
            capacity=self.capacity,
            versions_stored=int(self.versions_stored[s]),
            commits_stored=int(self.commits_stored[s]),
            records=self.records[s], futility=float(self.futility[s]))
