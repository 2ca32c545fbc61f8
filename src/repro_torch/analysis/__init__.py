"""repro_torch.analysis — the port's contract checker for engines,
kernels and schedules, the counterpart of the JAX package's
``repro.analysis``.

Three registry-driven passes:

* **launch pass** (``T001``-``T006``, ``launch_checks``): run every
  admitted ``engine x schedule x wire x use_kernel`` cell of every spec
  in ``api.PROTOCOLS`` for two segments of two rounds at tiny shapes,
  under an aten-op recorder, and prove the invariants: kernel launches
  per round (``ProtocolDef.dispatch_budget``), the in-place carry kept in
  place, the in-place claims (``ProtocolDef.alias_claims``) against the
  kernel modules' ``ALIAS_CONTRACTS``, no f64, no host syncs inside a
  segment, and the same op sequence in both segments.
* **schedule pass** (``SCH001``-``SCH006``, ``schedule_checks``): verify
  host-precomputed schedules — tier slot disjointness and exact
  capacity, sentinel inertness, lag <= tau, weight-row bounds, sorted
  sparse indices.  ``verify_schedule(sched)`` is the standalone entry.
* **conventions pass** (``REP002``, ``REP003``, ``REP005``, ``REP006``,
  ``conventions``): AST / registry rules — numerics hygiene, frozen
  specs, the kernel inventory (C entries, launch counters, in-place
  inventories), built-env rng reuse.

``run_all(device='cuda')`` chains the three into one ``Report``;
``python -m repro_torch.analysis --all [--device cpu]`` is the command.
"""
from __future__ import annotations

from .conventions import check_conventions
from .launch_checks import check_cells, iter_cells, run_cell
from .report import AnalysisError, Finding, Report
from .schedule_checks import verify_schedule

__all__ = [
    'AnalysisError', 'Finding', 'Report', 'check_cells',
    'check_conventions', 'check_schedules', 'iter_cells', 'run_all',
    'run_cell', 'verify_schedule',
]


def check_schedules(names=None) -> Report:
    """Verify the host-precomputed schedule of every distinct
    (protocol, engine, schedule-form) cell — the same precompute path the
    runners take, deduplicated over wire and kernel (which do not change
    the schedule).  Host work only."""
    from . import launch_checks
    rep = Report()
    seen = set()
    for cell in launch_checks.iter_cells(names):
        key = (cell.pdef.name, cell.ex.engine, cell.ex.schedule)
        if key in seen:
            continue
        seen.add(key)
        subject = f'{cell.pdef.name}[{cell.ex.engine}/{cell.ex.schedule}]'
        try:
            sched = launch_checks.precompute_cell(cell)
        except Exception as e:      # precompute must not break the pass
            rep.add('SCH001', subject, False,
                    f'schedule precompute failed: {type(e).__name__}: {e}')
            continue
        rep.extend(verify_schedule(
            sched,
            lag_tolerance=getattr(cell.spec, 'lag_tolerance', None),
            alpha=getattr(cell.spec, 'alpha', None),
            subject=subject))
    return rep


def run_all(names=None, *, device='cuda') -> Report:
    """All three passes over the registry (or the named protocols), one
    combined Report; the cells run on ``device`` (the card unless the
    caller asks for the CPU; raises without one)."""
    from repro_torch.kernels.backend import resolve_device
    device = resolve_device(device)
    rep = Report()
    rep.extend(check_conventions())
    rep.extend(check_schedules(names))
    rep.extend(check_cells(names, device=device))
    return rep
