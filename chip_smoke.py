#!/usr/bin/env python3
"""Drive the PyTorch port's SAFA paths on one NVIDIA GPU and hold each of
its CUDA kernels against its plain PyTorch version.

    python3 chip_smoke.py

Phases, each of which must pass:

1. build   — nvcc compiles src/repro_torch/csrc/*.cu (one process per
             source, in parallel) into build/repro_torch/.
2. kernels — every kernel of the paths at their shapes (m = 100 clients,
             N = 342,016: the Task 2 CNN's pack width; the fleet kernels at
             S = 4 members), on seeded inputs, against its plain version on
             the card, and each fleet kernel bit for bit against the
             single-run kernel on every member's slices; times from CUDA
             events over warm launches, beside the least time the card
             could take: the bytes these inputs' masks need (Eq. 6-8
             selects whole client rows; the weighted merge reads only
             rows of non-zero weight) over the memory rate, and, where
             one PyTorch call computes the same function (the weighted
             merge: ``torch.addmv``, a fleet's ``torch.bmm``), its time.
3. main    — the paper's Task 2 CNN at full width (m = 100, 24 batches of
             40, 5 epochs) through ``Experiment(...).compile().run()``,
             with ``use_kernel='packed'`` and with ``wire='int8'``; each
             run must launch its kernels once per round, and its eval loss
             must be finite and below the initial model's.  A third run
             with the plain aggregation (``use_kernel=False``) is the
             reference the packed run's model is held to.
4. fleet   — a 4-member sweep of the same task at full width through
             ``Experiment(...).compile().run_sweep(members)`` (crash rates
             0.1 / 0.3 / 0.5 / 0.7, seeds 0-3), in the same three runs:
             each must launch its fleet kernels once per round for the
             whole fleet and no single-run kernel, and lower every
             member's eval loss; packed and plain agree per member.
5. baselines — the paper's baselines on the same task at full width, 2
             rounds each: FedAvg and FedCS on the int8 wire (each round
             launches ``quantize_packed`` and ``dequantize_packed`` once),
             FedAvg f32, fully-local and FedAsync (no kernel), and a
             4-member FedAvg int8 crash-rate sweep (the two fleet kernels
             once per round).  Every run's eval loss must fall below its
             initial model's, and FedAvg int8 and f32 must agree within
             what the int8 wire's rounding allows.
6. weighted — the staleness-adaptive family on the same task at full
             width, crash probability 0.3, 2 rounds each: SEAFL with
             ``use_kernel='packed'`` (kernel 10 once per round), on the
             int8 wire with ``'packed'`` (kernels 2, 4 and 10 once per
             round) and plain, CSAFL with 2 clusters ``'packed'``, and a
             4-member mixed-scheme sweep (SEAFL, SEAFL with the loss term,
             CSAFL, the folded FedAsync; crash rates 0.1 / 0.3 / 0.5 / 0.7)
             with ``'packed'`` (kernel 10's fleet form once per round) and
             plain.  Every eval loss must fall below the initial model's,
             packed and plain agree within 1e-5 per member, and the folded
             FedAsync agrees with the sequential FedAsync engine within
             rtol 2e-5: elementwise at one server step on the same
             uploads, and over a 2-round run on the member's env and init
             against the model's largest weight (and in its eval loss).
             The phase trains with deterministic cuDNN: by default the
             convolutions' weight gradients vary from run to run by more
             than these tolerances.

The line before the last is a JSON object of kernel records; the last
line is ``{"ok": true, "device": {...}}``.  Without a visible card, or
run from a directory that holds no ``src/repro_torch``, the script prints
no result and exits non-zero.
"""
import json
import math
import pathlib
import subprocess
import sys
import time

ROUNDS = 3              # rounds per main-path run (never cut m, widths, batch
                        # or epochs; cut this if the time limit forces it)
FLEET_ROUNDS = 2        # rounds per fleet run: a fleet round trains 4x the
                        # clients of a single-run round
M = 100                 # clients on the main path (PAPER_TASKS['task2_cnn'])
S = 4                   # fleet members
FLEET_CRASH = (0.1, 0.3, 0.5, 0.7)   # member s's crash probability
BASE_ROUNDS = 2         # rounds per baseline run and baseline sweep
WEIGHTED_ROUNDS = 2     # rounds per weighted-merge run and sweep
#: the weighted sweep's members: (protocol-field overrides, crash rate)
MIXED = (({}, 0.1), ({'use_loss': True}, 0.3),
         ({'scheme': 'csafl', 'clusters': 2}, 0.5),
         ({'scheme': 'fedasync'}, 0.7))
WARM, TIMED = 5, 30     # kernel launches before and inside the timed window
#: the H100 SXM's published device-memory rate (bytes/s) and float32
#: CUDA-core rate (FLOP/s), at its 700 W limit; the card's name and power
#: limit are printed beside every number
PEAK_BYTES, PEAK_FLOPS = 3.35e12, 67e12


def _card_line() -> str:
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired) as e:
        return f'nvidia-smi unavailable ({e!r})'


def _time_ms(torch, fn, warm=WARM, timed=TIMED) -> float:
    """Mean milliseconds per call of ``fn`` over ``timed`` warm calls."""
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(timed):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / timed


def _record(name, source, replaces, err, ms, plain_ms, nbytes, flops,
            dense_bytes, library_ms=None):
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS * 1e3
    return {'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': None, 'max_abs_err': err,
            'ms': ms, 'plain_ms': plain_ms, 'bound_ms': max(t_bytes, t_ops),
            'bound_by': 'bytes' if t_bytes >= t_ops else 'operations',
            'library_ms': library_ms, 'bytes': nbytes, 'flops': flops,
            'dense_bytes': dense_bytes}


def aggregate_bytes(n, picked, undrafted, deprecated, completed=None):
    """Bytes one Eq. 6-8 launch over [m, n] rows must move for these masks
    (numpy bool [m]), with the cache written in place: trained only where
    picked or undrafted, cache read only where neither picked nor
    deprecated, cache written only where Eq. 8 changes the row, global
    read and new_global written once, masks and weights once.  With
    ``completed`` (the int8 form) the trained rows are q and scales where
    completed and base elsewhere, needed on every row because new_local
    is written on every row."""
    m = len(picked)
    row = 4 * n
    cache_rd = int((~picked & ~deprecated).sum())
    cache_wr = int((picked | deprecated | undrafted).sum())
    if completed is None:
        trained = int((picked | undrafted).sum()) * row
        per_client = 3 + 4
    else:
        done = int(completed.sum())
        trained = done * (n + 4 * (n // 128)) + (m - done) * row + m * row
        per_client = 4 + 4
    return trained + (cache_rd + cache_wr) * row + 2 * row + per_client * m


def kernel_phase(torch, n: int, fails: list) -> list:
    import numpy as np

    from repro_torch.kernels import ref
    from repro_torch.kernels.comm_quant import (dequantize_packed,
                                                quantize_packed)
    from repro_torch.kernels.safa_aggregate import (safa_aggregate,
                                                    safa_aggregate_packed,
                                                    safa_aggregate_packed_q8)
    dev = torch.device('cuda')
    rng = np.random.default_rng(0)
    host = {k: rng.random(M) < p
            for k, p in (('picked', 0.3), ('undrafted', 0.2),
                         ('deprecated', 0.2), ('completed', 0.7))}
    masks = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
    w = torch.as_tensor(rng.dirichlet(np.ones(M)), dtype=torch.float32,
                        device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    cache0, trained, base, glob = (normal(M, n), normal(M, n), normal(M, n),
                                   normal(n))
    pk, ud, dp, cp = (masks[k] for k in ('picked', 'undrafted', 'deprecated',
                                         'completed'))
    mn = M * n
    recs = []

    def check(cond, what):
        if not cond:
            fails.append(what)
            print(f'FAIL kernels: {what}')

    def global_err(got, want, what):
        err = (got - want).abs().max().item()
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
              f'{what} new_global beyond rtol 1e-5 / atol 1e-6 '
              f'(max abs err {err:.3e})')
        return err

    # -- safa_aggregate_packed (Eq. 6-8, cache in place) ---------------------
    ng_ref, nc_ref = ref.safa_aggregate_ref(cache0, trained, glob, pk, ud,
                                            dp, w)
    cache = cache0.clone()
    ptr = cache.data_ptr()
    ng, nc = safa_aggregate_packed(cache, trained, glob, pk, ud, dp, w)
    torch.cuda.synchronize()
    check(nc.data_ptr() == ptr, 'safa_aggregate_packed cache not in place')
    check(torch.equal(nc, nc_ref), 'safa_aggregate_packed new_cache differs')
    err = global_err(ng, ng_ref, 'safa_aggregate_packed')
    ms = _time_ms(torch, lambda: safa_aggregate_packed(cache, trained, glob,
                                                       pk, ud, dp, w))
    plain = _time_ms(torch, lambda: ref.safa_aggregate_ref(
        cache, trained, glob, pk, ud, dp, w), warm=2, timed=10)
    recs.append(_record(
        'safa_aggregate_packed', 'src/repro_torch/csrc/safa_aggregate.cu',
        'src/repro/kernels/safa_aggregate.py:86', err, ms, plain,
        aggregate_bytes(n, host['picked'], host['undrafted'],
                        host['deprecated']),
        2 * mn, 12 * mn + 8 * n + 7 * M))

    # the per-leaf route (use_kernel=True) launches the same kernel into a
    # fresh output; check it at the widest leaf's shape (f1: 2450 x 128)
    leaf = 2450 * 128
    lg, lc = safa_aggregate(cache0[:, :leaf], trained[:, :leaf],
                            glob[:leaf], pk, ud, dp, w)
    torch.cuda.synchronize()
    check(torch.equal(lc, nc_ref[:, :leaf]),
          'safa_aggregate (per leaf) new_cache differs')
    global_err(lg, ng_ref[:leaf], 'safa_aggregate (per leaf)')

    # -- quantize_packed ---------------------------------------------------
    q_ref, s_ref = ref.quantize_packed_ref(trained)
    q, s = quantize_packed(trained)
    torch.cuda.synchronize()
    check(torch.equal(q, q_ref), 'quantize_packed q differs')
    check(torch.equal(s, s_ref), 'quantize_packed scales differ')
    err = max((q.int() - q_ref.int()).abs().max().item(),
              (s - s_ref).abs().max().item())
    ms = _time_ms(torch, lambda: quantize_packed(trained))
    plain = _time_ms(torch, lambda: ref.quantize_packed_ref(trained),
                     warm=2, timed=10)
    wire = 5 * mn + 4 * (mn // 128)     # f32 values, int8 values, scales
    recs.append(_record(
        'quantize_packed', 'src/repro_torch/csrc/comm_quant.cu',
        'src/repro/kernels/comm_quant.py:111', err, ms, plain, wire, 3 * mn,
        wire))

    # -- dequantize_packed (the int8 wire's inverse: x = q * scale) ---------
    x = dequantize_packed(q_ref, s_ref)
    x_ref = ref.dequantize_packed_ref(q_ref, s_ref)
    torch.cuda.synchronize()
    check(torch.equal(x, x_ref), 'dequantize_packed differs from its plain '
                                 'version')
    ms = _time_ms(torch, lambda: dequantize_packed(q_ref, s_ref))
    plain = _time_ms(torch, lambda: ref.dequantize_packed_ref(q_ref, s_ref),
                     warm=2, timed=10)
    recs.append(_record(
        'dequantize_packed', 'src/repro_torch/csrc/comm_quant.cu',
        'src/repro/kernels/comm_quant.py:122',
        (x - x_ref).abs().max().item(), ms, plain, wire, mn, wire))

    # -- safa_aggregate_packed_q8 (dequant + Eq. 6-8, cache in place) --------
    ng_ref, nc_ref, nl_ref = ref.safa_aggregate_q8_ref(
        q_ref, s_ref, base, cache0, glob, pk, ud, dp, cp, w)
    cache = cache0.clone()
    ptr = cache.data_ptr()
    ng, nc, nl = safa_aggregate_packed_q8(q_ref, s_ref, base, cache, glob,
                                          pk, ud, dp, cp, w)
    torch.cuda.synchronize()
    check(nc.data_ptr() == ptr, 'safa_aggregate_packed_q8 cache not in place')
    check(torch.equal(nc, nc_ref), 'safa_aggregate_packed_q8 new_cache differs')
    check(torch.equal(nl, nl_ref), 'safa_aggregate_packed_q8 new_local differs')
    err = global_err(ng, ng_ref, 'safa_aggregate_packed_q8')
    ms = _time_ms(torch, lambda: safa_aggregate_packed_q8(
        q_ref, s_ref, base, cache, glob, pk, ud, dp, cp, w))
    plain = _time_ms(torch, lambda: ref.safa_aggregate_q8_ref(
        q_ref, s_ref, base, cache, glob, pk, ud, dp, cp, w), warm=2,
        timed=10)
    recs.append(_record(
        'safa_aggregate_packed_q8', 'src/repro_torch/csrc/safa_aggregate.cu',
        'src/repro/kernels/safa_aggregate.py:255', err, ms, plain,
        aggregate_bytes(n, host['picked'], host['undrafted'],
                        host['deprecated'], host['completed']),
        3 * mn, 17 * mn + 4 * (mn // 128) + 8 * n + 8 * M))

    _print_records(recs)
    return recs


def _print_records(recs):
    for r in recs:
        lib = '' if r['library_ms'] is None else \
            f", one PyTorch call {r['library_ms']} ms"
        print(f"kernel {r['name']}: {r['ms']} ms (plain {r['plain_ms']} ms"
              f"{lib}), "
              f"bound {r['bound_ms']} ms by {r['bound_by']} "
              f"({r['bytes'] / 1e6:.1f} MB for these masks; every row read "
              f"and written: {r['dense_bytes'] / 1e6:.1f} MB, "
              f"{r['dense_bytes'] / PEAK_BYTES * 1e3} ms), max abs err "
              f"{r['max_abs_err']:.3e}")


def fleet_kernel_phase(torch, n: int, fails: list) -> list:
    """Kernels 7-9 (the fleet forms) at S = 4, m = 100, N = n, each member
    with its own seeded masks and weights: against the plain version on
    the stacked operands, and bit for bit against the single-run kernel on
    every member's slices."""
    import numpy as np

    from repro_torch.kernels import ref
    from repro_torch.kernels.comm_quant import (dequantize_packed,
                                                dequantize_packed_fleet,
                                                quantize_packed,
                                                quantize_packed_fleet)
    from repro_torch.kernels.safa_aggregate import (
        safa_aggregate_packed, safa_aggregate_packed_fleet,
        safa_aggregate_packed_q8, safa_aggregate_packed_q8_fleet)
    dev = torch.device('cuda')
    rng = np.random.default_rng(1)
    host = {k: rng.random((S, M)) < p
            for k, p in (('picked', 0.3), ('undrafted', 0.2),
                         ('deprecated', 0.2), ('completed', 0.7))}
    pk, ud, dp, cp = (torch.as_tensor(host[k], device=dev)
                      for k in ('picked', 'undrafted', 'deprecated',
                                'completed'))
    w = torch.as_tensor(rng.dirichlet(np.ones(M), size=S),
                        dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    cache0, trained, base, glob = (normal(S, M, n), normal(S, M, n),
                                   normal(S, M, n), normal(S, n))
    mn = S * M * n
    recs = []

    def check(cond, what):
        if not cond:
            fails.append(what)
            print(f'FAIL fleet kernels: {what}')

    def global_err(got, want, what):
        err = (got - want).abs().max().item()
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
              f'{what} new_global beyond rtol 1e-5 / atol 1e-6 '
              f'(max abs err {err:.3e})')
        return err

    def summed_bytes(**masks):
        return sum(aggregate_bytes(n, *(masks[k][s] for k in masks))
                   for s in range(S))

    def per_member(name, got, single):
        """Fleet outputs against the single-run kernel, member by member."""
        same = all(torch.equal(g[s], o) for s in range(S)
                   for g, o in zip(got, single(s)))
        check(same, f'{name} differs from the single-run kernel on a member')

    # -- safa_aggregate_packed_fleet -----------------------------------------
    ng_ref, nc_ref = ref.safa_aggregate_ref(cache0, trained, glob, pk, ud,
                                            dp, w)
    cache = cache0.clone()
    ptr = cache.data_ptr()
    ng, nc = safa_aggregate_packed_fleet(cache, trained, glob, pk, ud, dp, w)
    torch.cuda.synchronize()
    check(nc.data_ptr() == ptr, 'safa_aggregate_packed_fleet not in place')
    check(torch.equal(nc, nc_ref), 'safa_aggregate_packed_fleet new_cache '
                                   'differs from the plain version')
    err = global_err(ng, ng_ref, 'safa_aggregate_packed_fleet')
    per_member('safa_aggregate_packed_fleet', (ng, nc),
               lambda s: safa_aggregate_packed(
                   cache0[s].clone(), trained[s], glob[s], pk[s], ud[s],
                   dp[s], w[s]))
    ms = _time_ms(torch, lambda: safa_aggregate_packed_fleet(
        cache, trained, glob, pk, ud, dp, w))
    plain = _time_ms(torch, lambda: ref.safa_aggregate_ref(
        cache, trained, glob, pk, ud, dp, w), warm=2, timed=10)
    recs.append(_record(
        'safa_aggregate_packed_fleet', 'src/repro_torch/csrc/safa_aggregate.cu',
        'src/repro/kernels/safa_aggregate.py:98', err, ms, plain,
        summed_bytes(picked=host['picked'], undrafted=host['undrafted'],
                     deprecated=host['deprecated']),
        2 * mn, S * (12 * M * n + 8 * n + 7 * M)))

    # -- quantize_packed_fleet ---------------------------------------------
    q_ref, s_ref = ref.quantize_packed_ref(trained)
    q, sc = quantize_packed_fleet(trained)
    torch.cuda.synchronize()
    check(torch.equal(q, q_ref), 'quantize_packed_fleet q differs')
    check(torch.equal(sc, s_ref), 'quantize_packed_fleet scales differ')
    per_member('quantize_packed_fleet', (q, sc),
               lambda s: quantize_packed(trained[s]))
    err = max((q.int() - q_ref.int()).abs().max().item(),
              (sc - s_ref).abs().max().item())
    ms = _time_ms(torch, lambda: quantize_packed_fleet(trained))
    plain = _time_ms(torch, lambda: ref.quantize_packed_ref(trained),
                     warm=2, timed=10)
    wire = 5 * mn + 4 * (mn // 128)
    recs.append(_record(
        'quantize_packed_fleet', 'src/repro_torch/csrc/comm_quant.cu',
        'src/repro/kernels/comm_quant.py:128', err, ms, plain, wire, 3 * mn,
        wire))

    # -- dequantize_packed_fleet -------------------------------------------
    x = dequantize_packed_fleet(q_ref, s_ref)
    x_ref = ref.dequantize_packed_ref(q_ref, s_ref)
    torch.cuda.synchronize()
    check(torch.equal(x, x_ref), 'dequantize_packed_fleet differs from its '
                                 'plain version')
    per_member('dequantize_packed_fleet', (x,),
               lambda s: (dequantize_packed(q_ref[s], s_ref[s]),))
    ms = _time_ms(torch, lambda: dequantize_packed_fleet(q_ref, s_ref))
    plain = _time_ms(torch, lambda: ref.dequantize_packed_ref(q_ref, s_ref),
                     warm=2, timed=10)
    recs.append(_record(
        'dequantize_packed_fleet', 'src/repro_torch/csrc/comm_quant.cu',
        'src/repro/kernels/comm_quant.py:122',
        (x - x_ref).abs().max().item(), ms, plain, wire, mn, wire))

    # -- safa_aggregate_packed_q8_fleet ------------------------------------
    ng_ref, nc_ref, nl_ref = ref.safa_aggregate_q8_ref(
        q_ref, s_ref, base, cache0, glob, pk, ud, dp, cp, w)
    cache = cache0.clone()
    ptr = cache.data_ptr()
    ng, nc, nl = safa_aggregate_packed_q8_fleet(q_ref, s_ref, base, cache,
                                                glob, pk, ud, dp, cp, w)
    torch.cuda.synchronize()
    check(nc.data_ptr() == ptr, 'safa_aggregate_packed_q8_fleet not in place')
    check(torch.equal(nc, nc_ref), 'safa_aggregate_packed_q8_fleet new_cache '
                                   'differs from the plain version')
    check(torch.equal(nl, nl_ref), 'safa_aggregate_packed_q8_fleet new_local '
                                   'differs from the plain version')
    err = global_err(ng, ng_ref, 'safa_aggregate_packed_q8_fleet')
    per_member('safa_aggregate_packed_q8_fleet', (ng, nc, nl),
               lambda s: safa_aggregate_packed_q8(
                   q_ref[s], s_ref[s], base[s], cache0[s].clone(), glob[s],
                   pk[s], ud[s], dp[s], cp[s], w[s]))
    ms = _time_ms(torch, lambda: safa_aggregate_packed_q8_fleet(
        q_ref, s_ref, base, cache, glob, pk, ud, dp, cp, w))
    plain = _time_ms(torch, lambda: ref.safa_aggregate_q8_ref(
        q_ref, s_ref, base, cache, glob, pk, ud, dp, cp, w), warm=2,
        timed=10)
    recs.append(_record(
        'safa_aggregate_packed_q8_fleet',
        'src/repro_torch/csrc/safa_aggregate.cu',
        'src/repro/kernels/safa_aggregate.py:271', err, ms, plain,
        summed_bytes(picked=host['picked'], undrafted=host['undrafted'],
                     deprecated=host['deprecated'],
                     completed=host['completed']),
        3 * mn, S * (17 * M * n + 4 * (M * n // 128) + 8 * n + 8 * M)))

    _print_records(recs)
    return recs


def merge_kernel_phase(torch, n: int, fails: list) -> list:
    """Kernel 10 (the weighted merge) at m = 100, N = n, and its fleet
    form at S = 4, on seeded weight rows that are zero off a seeded commit
    mask and sum to 0.6: against the plain version, the fleet form bit for
    bit against the single-run kernel on every member, and each beside
    one PyTorch call that computes the same function (timed here only;
    the port never calls it)."""
    import numpy as np

    from repro_torch.kernels import ref
    from repro_torch.kernels.weighted_merge import (
        weighted_merge_packed, weighted_merge_packed_fleet)
    dev = torch.device('cuda')
    rng = np.random.default_rng(2)
    commit = rng.random((S, M)) < 0.7
    w = rng.random((S, M)) * commit
    w = 0.6 * w / w.sum(1, keepdims=True)
    wrow = torch.as_tensor(w, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    trained = torch.randn((S, M, n), generator=gen, device=dev)
    glob = torch.randn((S, n), generator=gen, device=dev)
    recs = []

    def check(cond, what):
        if not cond:
            fails.append(what)
            print(f'FAIL merge kernels: {what}')

    def global_err(got, want, what):
        err = (got - want).abs().max().item()
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
              f'{what} beyond rtol 1e-5 / atol 1e-6 (max abs err '
              f'{err:.3e})')
        return err

    def merge_bytes(rows):
        """Weighted rows read, global read, new global written, weights."""
        return 4 * (int(rows.sum()) * n + 2 * n + M)

    # -- weighted_merge_packed (one run: member 0's operands) -------------
    t0, g0, w0 = trained[0], glob[0], wrow[0]
    want = ref.weighted_merge_ref(t0, g0, w0)
    got = weighted_merge_packed(t0, g0, w0)
    torch.cuda.synchronize()
    err = global_err(got, want, 'weighted_merge_packed')
    ms = _time_ms(torch, lambda: weighted_merge_packed(t0, g0, w0))
    plain = _time_ms(torch, lambda: ref.weighted_merge_ref(t0, g0, w0),
                     warm=2, timed=10)
    beta = 1.0 - w0.sum().item()        # outside the timed window

    def addmv():
        return torch.addmv(g0, t0.t(), w0, beta=beta, alpha=1.0)
    global_err(addmv(), want, 'torch.addmv (the yardstick)')
    lib = _time_ms(torch, addmv)
    nnz = int(commit[0].sum())
    recs.append(_record(
        'weighted_merge_packed', 'src/repro_torch/csrc/weighted_merge.cu',
        'src/repro/kernels/ops.py:453', err, ms, plain, merge_bytes(commit[0]),
        2 * (nnz + 1) * n, 4 * ((M + 2) * n + M), library_ms=lib))

    # -- weighted_merge_packed_fleet -----------------------------------------
    want = ref.weighted_merge_ref(trained, glob, wrow)
    got = weighted_merge_packed_fleet(trained, glob, wrow)
    torch.cuda.synchronize()
    err = global_err(got, want, 'weighted_merge_packed_fleet')
    check(all(torch.equal(got[s], weighted_merge_packed(trained[s], glob[s],
                                                        wrow[s]))
              for s in range(S)),
          'weighted_merge_packed_fleet differs from the single-run kernel '
          'on a member')
    ms = _time_ms(torch, lambda: weighted_merge_packed_fleet(trained, glob,
                                                             wrow))
    plain = _time_ms(torch, lambda: ref.weighted_merge_ref(trained, glob,
                                                           wrow),
                     warm=2, timed=10)
    # the yardstick: one bmm of [w, 1 - sum(w)] against the stack with the
    # global row appended, both built outside the timed window
    a = torch.cat([wrow, 1.0 - wrow.sum(1, keepdim=True)], 1)[:, None]
    b = torch.cat([trained, glob[:, None]], 1)
    global_err(torch.bmm(a, b)[:, 0], want, 'torch.bmm (the yardstick)')
    lib = _time_ms(torch, lambda: torch.bmm(a, b))
    del a, b
    recs.append(_record(
        'weighted_merge_packed_fleet',
        'src/repro_torch/csrc/weighted_merge.cu',
        'src/repro/kernels/ops.py:453', err, ms, plain,
        sum(merge_bytes(commit[s]) for s in range(S)),
        2 * (int(commit.sum()) + S) * n, S * 4 * ((M + 2) * n + M),
        library_ms=lib))
    _print_records(recs)
    return recs


def cnn_setup(torch):
    """Task 2's CNN on the card at full width: (EnvSpec, task)."""
    from repro_torch.configs import PAPER_TASKS
    from repro_torch.data import make_images, partition
    from repro_torch.data.tasks import cnn_task
    from repro_torch.fedsim import EnvSpec

    cfg = PAPER_TASKS['task2_cnn']
    spec = EnvSpec(m=cfg['m'], crash_prob=0.3,
                   dataset_size=cfg['dataset_size'],
                   batch_size=cfg['batch_size'], epochs=cfg['epochs'],
                   t_lim=cfg['t_lim'], seed=0)
    t0 = time.perf_counter()
    x, y = make_images(n=spec.dataset_size, seed=0)
    data = partition(x, y, spec.build().partition_sizes, spec.batch_size,
                     seed=0)
    task = cnn_task(data, lr=1e-3, epochs=cfg['epochs'])
    print(f'setup: data {tuple(data.x.shape)} made in '
          f'{time.perf_counter() - t0:.1f} s')
    return spec, task


def _timed(torch, fn, into):
    """``fn`` with the host seconds of each call (synchronised on both
    sides) appended to ``into``."""
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        into.append(time.perf_counter() - t)
        return out
    return wrapper


def main_path_phase(torch, spec, task, fails: list) -> dict:
    """Task 2's CNN through the port's entry points; returns the launch
    counts of each kernel in the run that drives it."""
    import numpy as np

    from repro_torch import api
    from repro_torch.core import protocol
    from repro_torch.kernels import backend

    init_loss = task.evaluate(task.init_global(0))['loss']
    print(f'main: initial eval loss {init_loss:.6f}; rounds {ROUNDS} '
          f'(not cut)')
    train_s, server_s = [], []
    launches, finals = {}, {}
    runs = [('packed', dict(use_kernel='packed'),
             ('safa_aggregate_packed',)),
            ('int8', dict(wire='int8'),
             ('quantize_packed', 'safa_aggregate_packed_q8')),
            ('plain', dict(use_kernel=False), ())]
    server_step = protocol.safa_server_step
    for name, ex, kernels in runs:
        exp = api.Experiment(task, spec, api.SafaSpec(fraction=0.3,
                                                      lag_tolerance=5),
                             api.ExecSpec(eval_every=ROUNDS, **ex),
                             rounds=ROUNDS)
        train_s.clear()
        server_s.clear()
        task.local_train = _timed(torch, task.local_train, train_s)
        protocol.safa_server_step = _timed(torch, server_step, server_s)
        try:
            backend.reset_launches()
            t = time.perf_counter()
            hist = exp.compile().run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            counts = dict(backend.LAUNCHES)
        finally:
            protocol.safa_server_step = server_step
            del task.local_train
        losses = [e['loss'] for _, e in hist.evals()]
        print(f'main[{name}]: {wall:.2f} s for {ROUNDS} rounds; per round '
              f'train {[round(s, 4) for s in train_s]} s, server step '
              f'{[round(s, 4) for s in server_s]} s; launches {counts}; '
              f'eval losses {losses}')
        for k in kernels:
            launches[k] = counts[k]
            if counts[k] != ROUNDS:
                fails.append(f'{name}: {k} launched {counts[k]} times in '
                             f'{ROUNDS} rounds')
        others = {k: v for k, v in counts.items() if k not in kernels and v}
        if others:
            fails.append(f'{name}: unexpected launches {others}')
        if not all(np.isfinite(v) for v in losses) or \
                not losses[-1] < init_loss:
            fails.append(f'{name}: eval losses {losses} not finite and below '
                         f'the initial {init_loss}')
        finals[name] = hist.final_global

    diff = max((finals['packed'][k] - finals['plain'][k]).abs().max().item()
               for k in finals['plain'])
    print(f'main: packed vs plain final_global max abs diff {diff:.3e}')
    if not diff <= 1e-4:
        fails.append(f'packed vs plain final_global differ by {diff:.3e}')
    profile_train(torch, 'profile', lambda: task.local_train(
        protocol.broadcast_global(task.init_global(0), spec.m), 0))
    return launches


def fleet_path_phase(torch, spec, task, fails: list) -> dict:
    """A 4-member sweep of Task 2's CNN at full width through
    ``run_sweep``; returns the launch counts of each fleet kernel in the
    run that drives it."""
    import numpy as np

    from repro_torch import api
    from repro_torch.core import protocol
    from repro_torch.kernels import backend

    init_loss = [task.evaluate(task.init_global(s))['loss']
                 for s in range(S)]
    print(f'fleet: {S} members, crash rates {FLEET_CRASH}, initial eval '
          f'losses {init_loss}; rounds {FLEET_ROUNDS}')

    def members():
        return [api.SweepMember(env=spec, fraction=0.3, lag_tolerance=5,
                                seed=s, overrides={'crash_prob': cr})
                for s, cr in enumerate(FLEET_CRASH)]

    train_s, server_s = [], []
    launches, finals = {}, {}
    runs = [('packed', dict(use_kernel='packed'),
             ('safa_aggregate_packed_fleet',)),
            ('int8', dict(wire='int8'),
             ('quantize_packed_fleet', 'safa_aggregate_packed_q8_fleet')),
            ('plain', dict(use_kernel=False), ())]
    server_step = protocol.safa_server_step
    for name, ex, kernels in runs:
        exp = api.Experiment(task, None, api.SafaSpec(),
                             api.ExecSpec(eval_every=FLEET_ROUNDS, **ex),
                             rounds=FLEET_ROUNDS)
        train_s.clear()
        server_s.clear()
        task.local_train_fleet = _timed(torch, task.local_train_fleet,
                                        train_s)
        protocol.safa_server_step = _timed(torch, server_step, server_s)
        try:
            backend.reset_launches()
            t = time.perf_counter()
            hists = exp.compile().run_sweep(members())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            counts = dict(backend.LAUNCHES)
        finally:
            protocol.safa_server_step = server_step
            del task.local_train_fleet
        losses = [[e['loss'] for _, e in h.evals()] for h in hists]
        print(f'fleet[{name}]: {wall:.2f} s for {FLEET_ROUNDS} rounds of '
              f'{S} members; per fleet round train '
              f'{[round(v, 4) for v in train_s]} s, server step '
              f'{[round(v, 4) for v in server_s]} s; launches {counts}; '
              f'eval losses per member {losses}')
        for k in kernels:
            launches[k] = counts[k]
            if counts[k] != FLEET_ROUNDS:
                fails.append(f'fleet {name}: {k} launched {counts[k]} times '
                             f'in {FLEET_ROUNDS} rounds')
        others = {k: v for k, v in counts.items() if k not in kernels and v}
        if others:
            fails.append(f'fleet {name}: unexpected launches {others}')
        for s, ls in enumerate(losses):
            if not all(np.isfinite(v) for v in ls) or \
                    not ls[-1] < init_loss[s]:
                fails.append(f'fleet {name}: member {s} eval losses {ls} '
                             f'not finite and below the initial '
                             f'{init_loss[s]}')
        finals[name] = [h.final_global for h in hists]

    diffs = [max((finals['packed'][s][k] - finals['plain'][s][k])
                 .abs().max().item() for k in finals['plain'][s])
             for s in range(S)]
    print(f'fleet: packed vs plain final_global max abs diff per member '
          f'{diffs}')
    if not max(diffs) <= 1e-4:
        fails.append(f'fleet: packed vs plain final_global differ by '
                     f'{diffs}')
    g = api.init_fleet_global(task, list(range(S)))
    profile_train(torch, 'fleet profile', lambda: task.local_train_fleet(
        protocol.broadcast_global(g, spec.m, fleet=True), None))
    return launches


def _drive(torch, task, label, steps, kernels, rounds, go, fleet, fails):
    """Run ``go()`` once, every launch counter set to 0 just before, with
    the task's local training and the ``core.protocol`` server steps named
    in ``steps`` timed per call; print the per-round seconds and the
    launches, and fail unless each kernel in ``kernels`` launched once per
    round and no other kernel launched.  Returns (go's result, counts)."""
    from repro_torch.core import protocol
    from repro_torch.kernels import backend

    originals = {k: getattr(protocol, k) for k in steps}
    train_s, server_s = [], []
    attr = 'local_train_fleet' if fleet else 'local_train'
    setattr(task, attr, _timed(torch, getattr(task, attr), train_s))
    for k in steps:
        setattr(protocol, k, _timed(torch, originals[k], server_s))
    try:
        backend.reset_launches()
        t = time.perf_counter()
        out = go()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = dict(backend.LAUNCHES)
    finally:
        for k in steps:
            setattr(protocol, k, originals[k])
        delattr(task, attr)
    print(f'{label}: {wall:.2f} s for {rounds} rounds; per round train '
          f'{[round(v, 4) for v in train_s]} s, server step '
          f'{[round(v, 4) for v in server_s]} s; launches '
          f'{ {k: v for k, v in counts.items() if v} }')
    for k in kernels:
        if counts[k] != rounds:
            fails.append(f'{label}: {k} launched {counts[k]} times in '
                         f'{rounds} rounds')
    others = {k: v for k, v in counts.items() if k not in kernels and v}
    if others:
        fails.append(f'{label}: unexpected launches {others}')
    return out, counts


def _check_losses(label, losses, init, fails):
    print(f'{label}: eval losses {losses}')
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < init:
        fails.append(f'{label}: eval losses {losses} not finite and below '
                     f'the initial {init}')


def _max_diff(a: dict, b: dict) -> float:
    return max((a[k] - b[k]).abs().max().item() for k in b)


def baselines_phase(torch, spec, task, fails: list) -> dict:
    """The paper's baselines on Task 2's CNN at full width through the
    port's entry points: single runs of every baseline cell, then a
    4-member FedAvg int8 sweep; returns the launch counts of the
    dequantisation kernels in the runs that drive them."""
    from repro_torch import api

    init_loss = [task.evaluate(task.init_global(s))['loss']
                 for s in range(S)]
    print(f'baselines: initial eval losses {init_loss}; rounds '
          f'{BASE_ROUNDS}, C = 0.3')
    wire = ('quantize_packed', 'dequantize_packed')
    runs = [('fedavg-int8', api.FedAvgSpec(fraction=0.3), 'int8', wire),
            ('fedcs-int8', api.FedCSSpec(fraction=0.3), 'int8', wire),
            ('fedavg', api.FedAvgSpec(fraction=0.3), 'f32', ()),
            ('local', api.LocalSpec(fraction=0.3), 'f32', ()),
            ('fedasync', api.FedAsyncSpec(), 'f32', ())]
    # the server step of each protocol, timed where its round calls it
    steps = ('fedavg_server_step', 'fedasync_merge')
    launches = {'dequantize_packed': 0, 'dequantize_packed_fleet': 0}
    finals = {}

    def drive(name, kernels, rounds, go, fleet):
        out, counts = _drive(torch, task, f'baselines[{name}]', steps,
                             kernels, rounds, go, fleet, fails)
        for k in kernels:
            if k in launches:
                launches[k] += counts[k]
        return out

    def check_losses(name, losses, init):
        _check_losses(f'baselines[{name}]', losses, init, fails)

    for name, sp, wire_kind, kernels in runs:
        exp = api.Experiment(task, spec, sp,
                             api.ExecSpec(eval_every=BASE_ROUNDS,
                                          wire=wire_kind),
                             rounds=BASE_ROUNDS)
        hist = drive(name, kernels, BASE_ROUNDS, exp.compile().run, False)
        check_losses(name, [e['loss'] for _, e in hist.evals()],
                     init_loss[0])
        finals[name] = hist.final_global

    # int8 against f32 on the same schedule: each round the wire moves an
    # upload by at most half its block's step (amax / 254); the renormalised
    # average moves the global by no more, and the next round's training
    # carries it on.  Bound: one step of the largest weight per round.
    amax = max(v.abs().max().item() for v in finals['fedavg'].values())
    bound = BASE_ROUNDS * amax / 127
    diff = _max_diff(finals['fedavg-int8'], finals['fedavg'])
    print(f'baselines: FedAvg int8 vs f32 final_global max abs diff '
          f'{diff:.3e}, bound {bound:.3e} (rounds x max |w| / 127)')
    if not diff <= bound:
        fails.append(f'baselines: FedAvg int8 vs f32 differ by {diff:.3e} '
                     f'> {bound:.3e}')

    members = [api.SweepMember(env=spec, fraction=0.3, seed=s,
                               overrides={'crash_prob': cr})
               for s, cr in enumerate(FLEET_CRASH)]
    exp = api.Experiment(task, None, api.FedAvgSpec(),
                         api.ExecSpec(eval_every=BASE_ROUNDS, wire='int8'),
                         rounds=BASE_ROUNDS)
    hists = drive('fedavg-int8 sweep', tuple(k + '_fleet' for k in wire),
                  BASE_ROUNDS, lambda: exp.compile().run_sweep(members),
                  True)
    for s, h in enumerate(hists):
        check_losses(f'fedavg-int8 sweep member {s}',
                     [e['loss'] for _, e in h.evals()], init_loss[s])
    return launches


def weighted_phase(torch, spec, task, fails: list) -> dict:
    """The staleness-adaptive family on Task 2's CNN at full width through
    the port's entry points: SEAFL packed, int8 + packed and plain, CSAFL
    packed, a 4-member mixed-scheme sweep packed and plain, and the folded
    FedAsync member against the sequential FedAsync engine; returns the
    launch counts of kernel 10's two forms in the runs that drive them."""
    # the comparisons below would otherwise measure cuDNN's run-to-run
    # noise (its default weight-gradient algorithms add with atomics)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _weighted_runs(torch, spec, task, fails)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _weighted_runs(torch, spec, task, fails: list) -> dict:
    from repro_torch import api
    from repro_torch.core import agg_schemes, protocol

    rounds = WEIGHTED_ROUNDS
    init_loss = [task.evaluate(task.init_global(s))['loss']
                 for s in range(S)]
    print(f'weighted: {_card_line()}; initial eval losses {init_loss}; '
          f'rounds {rounds}')
    steps = ('weighted_server_step', 'fedasync_merge')
    merge = ('weighted_merge_packed',)
    runs = [('seafl-packed', api.SeaflSpec(), dict(use_kernel='packed'),
             merge),
            ('seafl-int8', api.SeaflSpec(),
             dict(use_kernel='packed', wire='int8'),
             merge + ('quantize_packed', 'dequantize_packed')),
            ('seafl-plain', api.SeaflSpec(), {}, ()),
            ('csafl-packed', api.CsaflSpec(clusters=2),
             dict(use_kernel='packed'), merge)]
    launches, finals = {}, {}
    for name, sp, ex, kernels in runs:
        exp = api.Experiment(task, spec, sp,
                             api.ExecSpec(eval_every=rounds, **ex),
                             rounds=rounds)
        hist, counts = _drive(torch, task, f'weighted[{name}]', steps,
                              kernels, rounds, exp.compile().run, False,
                              fails)
        launches.setdefault('weighted_merge_packed',
                            counts['weighted_merge_packed'])
        _check_losses(f'weighted[{name}]', [e['loss'] for _, e in
                                            hist.evals()],
                      init_loss[0], fails)
        finals[name] = hist.final_global
    diff = _max_diff(finals['seafl-packed'], finals['seafl-plain'])
    print(f'weighted: SEAFL packed vs plain final_global max abs diff '
          f'{diff:.3e}')
    if not diff <= 1e-5:
        fails.append(f'weighted: SEAFL packed vs plain differ by {diff:.3e}')

    members = [api.SweepMember(env=spec, seed=s,
                               overrides=dict(ov, crash_prob=cr))
               for s, (ov, cr) in enumerate(MIXED)]
    sweeps = {}
    for name, ex, kernels in (
            ('packed', dict(use_kernel='packed'),
             ('weighted_merge_packed_fleet',)),
            ('plain', {}, ())):
        exp = api.Experiment(task, None, api.SeaflSpec(),
                             api.ExecSpec(eval_every=rounds, **ex),
                             rounds=rounds)
        hists, counts = _drive(torch, task, f'weighted sweep[{name}]', steps,
                               kernels, rounds,
                               lambda: exp.compile().run_sweep(members),
                               True, fails)
        if kernels:
            launches[kernels[0]] = counts[kernels[0]]
        for s, h in enumerate(hists):
            _check_losses(f'weighted sweep[{name}] member {s}',
                          [e['loss'] for _, e in h.evals()], init_loss[s],
                          fails)
        sweeps[name] = [h.final_global for h in hists]
    diffs = [_max_diff(p, q) for p, q in zip(sweeps['packed'],
                                             sweeps['plain'])]
    print(f'weighted: sweep packed vs plain final_global max abs diff per '
          f'member {diffs}')
    if not max(diffs) <= 1e-5:
        fails.append(f'weighted: sweep packed vs plain differ by {diffs}')

    # the fold at one server step, where the JAX package's tolerance holds
    # elementwise: the folded FedAsync member's first-round row (kernel 10)
    # and the sequential chain's merges of the same uploads
    folded = members[-1]
    env = spec.replace(crash_prob=MIXED[-1][1])
    dev = torch.device('cuda')
    fold = agg_schemes.precompute_weighted_schedule(
        env.build(), rounds=1, scheme='fedasync').to_device(dev)
    chain = agg_schemes.precompute_async_schedule(env.build(),
                                                  rounds=1).to_device(dev)
    g = task.init_global(folded.seed)
    gen = torch.Generator(device=dev).manual_seed(3)
    uploads = {k: v + 0.01 * torch.randn((spec.m,) + tuple(v.shape),
                                         generator=gen, device=dev)
               for k, v in g.items()}
    got = protocol.weighted_merge(g, uploads, wrow=fold.wrow[0],
                                  use_kernel='packed')
    want = protocol.fedasync_merge(g, uploads, order=chain.order[0],
                                   alphas=chain.alphas[0])
    bad = [k for k in want if not torch.allclose(got[k], want[k], rtol=2e-5,
                                                 atol=1e-7)]
    print(f'weighted: one folded server step vs the sequential chain: max '
          f'abs diff {_max_diff(got, want):.3e}')
    if bad:
        fails.append(f'weighted: the folded merge beyond rtol 2e-5 of the '
                     f'sequential chain in {bad}')

    # and over a run, against the sequential FedAsync engine on the
    # member's env and init: both through the single-run training (the
    # fleet trains its replicas in batches of another size), so that they
    # differ by the fold's rounding as training carries it on
    seq = api.Experiment(task, env, api.FedAsyncSpec(alpha=folded.alpha,
                                                     staleness_exp=folded
                                                     .staleness_exp),
                         api.ExecSpec(eval_every=rounds), rounds=rounds,
                         seed=folded.seed)
    ref, _ = _drive(torch, task, 'weighted[fedasync sequential]', steps, (),
                    rounds, seq.compile().run, False, fails)
    exp = api.Experiment(task, None, api.SeaflSpec(),
                         api.ExecSpec(engine='sequential', eval_every=rounds,
                                      use_kernel='packed'), rounds=rounds)
    (hist,), _ = _drive(torch, task, 'weighted[fedasync folded]', steps,
                        merge, rounds,
                        lambda: exp.compile().run_sweep([folded]), False,
                        fails)
    diff = _max_diff(hist.final_global, ref.final_global)
    scale = max(v.abs().max().item() for v in ref.final_global.values())
    losses = [[e['loss'] for _, e in h.evals()] for h in (hist, ref)]
    fleet_diff = _max_diff(sweeps['packed'][-1], ref.final_global)
    print(f'weighted: folded vs sequential FedAsync final_global max abs '
          f'diff {diff:.3e}, bound 2e-5 x max |w| = {2e-5 * scale:.3e} (the '
          f'fleet member: {fleet_diff:.3e}); eval losses {losses[0]} vs '
          f'{losses[1]}')
    if not (diff <= 2e-5 * scale
            and math.isclose(losses[0][-1], losses[1][-1], rel_tol=2e-5)):
        fails.append(f'weighted: folded FedAsync beyond rtol 2e-5 of the '
                     f'sequential engine ({diff:.3e}; losses {losses})')
    return launches


def profile_train(torch, label, train, top=6):
    """Where one round's local training spends the device: torch.profiler
    over one ``train()`` call.  Device kernels are deduplicated by
    (name, start, end); the busy share is the union of their intervals
    over the call's wall time, so kernels that overlap count once.  A
    measurement only: a profiler that cannot trace the card leaves the
    other phases' verdict alone."""
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            train()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        spans = sorted({(e.time_range.start, e.time_range.end, e.name)
                        for e in prof.events()
                        if e.device_type.name == 'CUDA'})
    except Exception as e:  # noqa: BLE001 - report and go on
        print(f'{label}: not measured ({e!r})')
        return
    if not spans:
        print(f'{label}: not measured (the trace holds no device kernels)')
        return
    busy, reach = 0.0, spans[0][0]
    by_name = {}
    for start, stop, name in spans:
        busy += max(0.0, stop - max(start, reach))
        reach = max(reach, stop)
        tot, n = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + stop - start, n + 1)
    summed = sum(tot for tot, _ in by_name.values()) / 1e6
    print(f'{label}: one train call {wall:.3f} s wall; device busy '
          f'{busy / 1e6:.3f} s ({busy / 1e6 / wall:.1%}) as the union of '
          f'{len(spans)} kernels ({summed:.3f} s summed), '
          f'{len(by_name)} kernel names')
    for name, (tot, n) in sorted(by_name.items(),
                                 key=lambda kv: -kv[1][0])[:top]:
        print(f'{label}:   {tot / 1e3:9.1f} ms {n:6d}x  {name[:90]}')


def main() -> int:
    root = pathlib.Path(__file__).resolve().parent
    if not (root / 'src' / 'repro_torch').is_dir():
        print('chip_smoke: no src/repro_torch beside this script; run it '
              'from a checkout of the repository', file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / 'src'))
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this check '
              'needs an NVIDIA GPU', file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    print(_card_line())
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}')

    from repro_torch.data.tasks import _cnn_init
    from repro_torch.kernels import backend, ops
    _, build_s = backend.load_library(verbose=True)
    print(f'build: {build_s:.1f} s')

    clock = [time.perf_counter()]

    def lap(phase):
        now = time.perf_counter()
        print(f'phase {phase}: {now - clock[0]:.1f} s')
        clock[0] = now

    fails = []
    n = ops.wire_spec(_cnn_init(torch.Generator().manual_seed(0))).n_padded
    recs = (kernel_phase(torch, n, fails) + fleet_kernel_phase(torch, n, fails)
            + merge_kernel_phase(torch, n, fails))
    torch.cuda.empty_cache()
    lap('kernels')
    spec, task = cnn_setup(torch)
    launches = main_path_phase(torch, spec, task, fails)
    lap('main')
    launches.update(fleet_path_phase(torch, spec, task, fails))
    lap('fleet')
    launches.update(baselines_phase(torch, spec, task, fails))
    lap('baselines')
    launches.update(weighted_phase(torch, spec, task, fails))
    lap('weighted')
    for r in recs:
        r['launches'] = launches.get(r['name'], 0)
        del r['bytes'], r['flops'], r['dense_bytes']
    if fails:
        for f in fails:
            print(f'FAIL {f}')
        return 1
    print(json.dumps({'kernels': recs}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
