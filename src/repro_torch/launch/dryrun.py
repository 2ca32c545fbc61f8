"""Dry run: trace every (architecture x input-shape) step of the port on
the ``meta`` device, with each argument's spec on a production mesh and
a roofline at H100 constants.

The reference lowers and compiles each cell's jitted step on 512
placeholder devices.  The port's counterpart runs the port's own step
functions on ``meta`` tensors (shapes and dtypes, no storage, no
arithmetic), so a cell that traces has shapes that agree end to end at
the published widths and depths, and costs no memory:

* train: ``SiloSetup.train_client`` (``Model.loss``, its gradient and the
  SGD update, ``local_steps`` times) on one client's batch of b =
  global_batch // C sequences, what ``train_step`` repeats for each of
  its C clients (``train_step`` reads its masks on the host, which a
  meta tensor cannot give);
* prefill: ``ServeSetup.prefill_step`` on ``param_shapes()`` and
  ``prefill_batch``;
* decode: ``ServeSetup.serve_step`` on ``decode_batch`` (a cache of
  seq_len - 1 tokens).

Each row (one JSON line) gives the arguments' bytes per device from
their specs on the row's mesh (``arg_bytes``, the counterpart of XLA's
``argument_size_in_bytes``), unsharded (``whole_arg_bytes``), and
whether those alone fit one card's 80 GB (``fits_one_card``: a bound on
the arguments only, not on what a step allocates), the param, silo
state, cache and batch bytes, and the reference's analytic FLOPs and
HBM bytes with their roofline terms (``roofline``: one H100's rates, no
collective term).  A cell that does not trace prints ``FAIL`` to stderr
and makes the exit code 1.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun.jsonl
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch

from repro_torch import sharding as shd
from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, get_config,
                                 shape_supported)
from repro_torch.launch import analytic
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import roofline as rf
from repro_torch.launch.steps import SERVE_PROFILES, ServeSetup, SiloSetup
from repro_torch.models.model import build_model
from repro_torch.optim import tree_leaves


def active_params(cfg, model) -> int:
    """Per-token active parameters (MoE: shared + top-1 expert)."""
    n = model.n_params()
    if cfg.n_experts:
        expert = 3 * cfg.d_model * cfg.d_ff
        n_moe_layers = cfg.n_layers // cfg.moe_every
        n -= (cfg.n_experts - 1) * expert * n_moe_layers
    return n


def tree_bytes(tree) -> int:
    """The bytes of a tensor or of a tree's tensors (a host int, such as a
    cache's ``length``, lives on no device)."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def _sharded_bytes(shardings, tree) -> int:
    """Per-device bytes of ``tree`` laid out by its ``NamedSharding``
    tree: each tensor's bytes over the pieces its spec cuts it into."""
    if isinstance(shardings, shd.NamedSharding):
        if not isinstance(tree, torch.Tensor):
            return 0
        return (tree.numel() * tree.element_size()
                // shd.shard_count(shardings.spec, shardings.mesh))
    return sum(_sharded_bytes(shardings[k], tree[k]) for k in shardings)


def _expect(got, want, what):
    if tuple(got) != tuple(want):
        raise RuntimeError(f'{what}: shape {tuple(got)}, want {tuple(want)}')


def lower_one(arch_id: str, shape_name, *, multi_pod: bool = False,
              fedavg_baseline: bool = False, extra_cfg=None,
              profile: str = 'tp', mesh=None, n_clients=None,
              local_steps: int = 1):
    """One cell's row.  ``shape_name`` is a key of ``INPUT_SHAPES`` or an
    ``InputShape``; ``extra_cfg`` replaces config fields (such as
    ``n_layers``); ``mesh`` (default: the production mesh) and
    ``n_clients`` (default: the mesh's client axes, as the reference
    derives them) place the cell elsewhere, such as on one card."""
    cfg = get_config(arch_id)
    if extra_cfg:
        cfg = dataclasses.replace(cfg, **extra_cfg)
    shape = (INPUT_SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    if mesh is None:
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    model = build_model(cfg)
    params = model.param_shapes()

    if shape.kind != 'train' and profile in SERVE_PROFILES:
        serve_rules = SERVE_PROFILES[profile]
    else:
        serve_rules = None
    rules = shd.PROFILES.get(profile, shd.DEFAULT_RULES)
    if profile == 'fsdp' and multi_pod:
        rules = shd.FSDP_MULTIPOD_RULES
    sizes = {'state_bytes': None, 'cache_bytes': None}
    if shape.kind == 'train':
        C = n_clients or mesh_lib.n_clients(
            mesh, rules.get('clients', ('pod', 'data')))
        setup = SiloSetup(model, n_clients=C, local_steps=local_steps,
                          rules=rules)
        state, batch = setup.state_sds(), setup.client_batch(shape)
        shardings = setup.shardings(mesh, shape)
        args = (state, batch)
        sizes.update(state_bytes=tree_bytes(state),
                     batch_bytes=tree_bytes(batch))
        t0 = time.perf_counter()
        trained, loss = setup.train_client(params, setup.client(batch, 0))
        trace_s = time.perf_counter() - t0
        _expect(loss.shape, (), f'{arch_id} {shape.name} loss')
        for w, p in zip(tree_leaves(trained), tree_leaves(params)):
            _expect(w.shape, p.shape, f'{arch_id} {shape.name} trained leaf')
        tokens = shape.global_batch * shape.seq_len
    else:
        setup = ServeSetup(model, serve_rules=serve_rules)
        p_sh = setup.param_shardings(mesh)
        B = shape.global_batch
        with torch.no_grad():
            if shape.kind == 'prefill':
                batch = setup.prefill_batch(shape)
                shardings = (p_sh, setup.prefill_shardings(mesh, shape))
                args = (params, batch)
                sizes['batch_bytes'] = tree_bytes(batch)
                t0 = time.perf_counter()
                nxt = setup.prefill_step(params, batch)
                tokens = B * shape.seq_len
            else:   # decode
                cache, tok = setup.decode_batch(shape)
                shardings = (p_sh,) + setup.decode_shardings(mesh, shape)
                args = (params, cache, tok)
                sizes.update(cache_bytes=tree_bytes(cache),
                             batch_bytes=tree_bytes(tok))
                t0 = time.perf_counter()
                _, nxt = setup.serve_step(params, cache, tok)
                tokens = B   # one token per sequence
            trace_s = time.perf_counter() - t0
        _expect(nxt.shape, (B,), f'{arch_id} {shape.name} next tokens')
    n_params, n_act = model.n_params(), active_params(cfg, model)
    mf = rf.model_flops_estimate(n_act, tokens, shape.kind)

    n_cl = ((n_clients or mesh_lib.n_clients(mesh))
            if shape.kind == 'train' else 1)
    flops = analytic.flops_estimate(
        cfg, kind=shape.kind, batch=shape.global_batch, seq=shape.seq_len,
        n_active=n_act, local_steps=local_steps)
    byts = analytic.bytes_estimate(
        cfg, kind=shape.kind, batch=shape.global_batch, seq=shape.seq_len,
        n_params=n_params, n_clients=n_cl, local_steps=local_steps)
    roof = rf.Roofline(flops=flops, hbm_bytes=byts, chips=mesh.size,
                       model_flops=mf)
    whole = sum(tree_bytes(a) for a in args)
    return {
        'arch': arch_id, 'shape': shape.name,
        'mesh': mesh_lib.describe(mesh), 'chips': mesh.size,
        'kind': shape.kind, 'profile': profile,
        'step': 'fedavg' if fedavg_baseline else
                ('safa' if shape.kind == 'train' else 'serve'),
        'trace_s': trace_s,
        'n_params': n_params, 'active_params': n_act,
        'n_param_leaves': len(tree_leaves(params)),
        'param_bytes': tree_bytes(params), **sizes,
        'arg_bytes': sum(_sharded_bytes(s, a)
                         for s, a in zip(shardings, args)),
        'whole_arg_bytes': whole,
        'fits_one_card': whole <= rf.HBM_BYTES,
        **roof.as_dict(),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--arch', choices=ARCH_IDS)
    ap.add_argument('--shape', choices=list(INPUT_SHAPES))
    ap.add_argument('--all', action='store_true')
    ap.add_argument('--multi-pod', action='store_true')
    ap.add_argument('--fedavg-baseline', action='store_true')
    ap.add_argument('--profile', choices=('tp', 'fsdp', 'splitkv'),
                    default='tp')
    ap.add_argument('--out', default=None)
    ap.add_argument('--skip-existing', action='store_true')
    args = ap.parse_args(argv)

    if args.all:
        combos = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES
                  if shape_supported(a, s)]
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape)]
    else:
        ap.error('--arch and --shape, or --all')

    done = set()
    if args.out and args.skip_existing and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done.add((r['arch'], r['shape'], r['mesh'], r['step'],
                              r.get('profile', 'tp')))
                except (ValueError, KeyError):
                    pass

    mesh_desc = mesh_lib.describe(mesh_lib.make_production_mesh(
        multi_pod=args.multi_pod))
    failures = []
    for arch, shape in combos:
        kind = INPUT_SHAPES[shape].kind
        step_name = ('fedavg' if args.fedavg_baseline else
                     ('safa' if kind == 'train' else 'serve'))
        if (arch, shape, mesh_desc, step_name, args.profile) in done:
            continue
        try:
            res = lower_one(arch, shape, multi_pod=args.multi_pod,
                            fedavg_baseline=args.fedavg_baseline,
                            profile=args.profile)
        except Exception as e:  # noqa: BLE001 -- every cell is tried
            failures.append((arch, shape, repr(e)))
            print(f'FAIL {arch} {shape}: {e!r}', file=sys.stderr,
                  flush=True)
            traceback.print_exc()
            continue
        line = json.dumps(res)
        print(line, flush=True)
        if args.out:
            with open(args.out, 'a') as f:
                f.write(line + '\n')
    if failures:
        sys.exit(1)


if __name__ == '__main__':
    main()
