"""End-to-end federated training driver (silo-mode SAFA) over an LLM.

The SAFA protocol drives each round's client states from the event
simulator on the host (``classify_versions``, the env's crash draws,
CFCFM selection, the seeded document draws of every client's batch), and
the numeric round runs as one ``SiloSetup.train_step`` on the device.
The host schedule is the JAX CLI's line for line, so both packages draw
the same masks and batches for a seed; the params come from
``Model.init`` on the device (another generator than the reference's).
One difference: the token streams' Markov teacher
(``data.make_lm_tokens``) holds a [V, V] f64 transition matrix, which at
a published vocabulary is more than a host holds (184.7 GB at
qwen3-1.7b's 151,936 ids), so above ``TEACHER_VOCAB`` ids the teacher
runs over the first ``TEACHER_VOCAB`` of them; the model, its loss and
its head keep the whole vocabulary.  Every reduced configuration (at
most 512 ids) draws the reference's tokens.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --rounds 30 --clients 4 --fraction 0.5 --lag-tolerance 5

Runs on the card unless ``--device cpu`` is given; without
``--full-size`` the configuration is the reduced one.  ``--ckpt`` saves
the final global model there (``repro_torch.checkpoint``, the JAX CLI's
file), which ``repro_torch.launch.serve --ckpt`` serves.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import protocol, selection
from repro_torch.data import make_lm_tokens
from repro_torch.fedsim import EnvSpec
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch.steps import SiloSetup
from repro_torch.models.model import build_model

#: the largest vocabulary the token streams' Markov teacher covers (its
#: [V, V] f64 transition matrix: 128 MiB here)
TEACHER_VOCAB = 4096


def run(arch: str, *, rounds: int, n_clients: int, fraction: float,
        lag_tolerance: int, crash_prob: float, batch: int, seq: int,
        local_steps: int, lr: float, seed: int = 0, ckpt: str = None,
        full_size: bool = False, log_every: int = 10, device='cuda'):
    """Train ``rounds`` SAFA rounds; returns the per-round loss history
    (a list of floats).  ``ckpt`` names where to save the final global
    model, with ``{'arch', 'rounds'}`` as its metadata."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if not full_size:
        cfg = cfg.reduced()
    model = build_model(cfg)
    setup = SiloSetup(model, n_clients=n_clients, local_steps=local_steps,
                      learning_rate=lr)
    state = setup.init_state(
        model.init(torch.Generator(device=dev).manual_seed(seed)))

    # synthetic federated token streams, one shard per client
    toks = make_lm_tokens(n_docs=n_clients * batch * 4, seq_len=seq,
                          vocab=min(cfg.vocab_size, TEACHER_VOCAB),
                          seed=seed)
    env = EnvSpec(m=n_clients, crash_prob=crash_prob,
                  dataset_size=toks.shape[0], batch_size=batch, epochs=1,
                  t_lim=3600.0, seed=seed).build()
    weights = torch.as_tensor(env.weights, dtype=torch.float32, device=dev)

    versions = np.zeros(n_clients, int)
    committed_prev = np.ones(n_clients, bool)
    picked_prev = np.zeros(n_clients, bool)
    rng = np.random.default_rng(seed)
    history = []

    def on_dev(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    for t in range(1, rounds + 1):
        up, dep, _ = protocol.classify_versions(versions, t - 1,
                                                lag_tolerance, committed_prev)
        sync = up | dep
        crashed, _ = env.draw_round()
        arrival = env.t_dist(int(sync.sum())) + 2 * env.t_updown + \
            env.full_train_time()
        arrival = np.where(~crashed, arrival, np.inf)
        sel = selection.cfcfm(arrival, ~crashed, picked_prev, fraction,
                              env.t_lim)
        versions[sync] = t - 1
        versions[sel.committed] = t

        doc_idx = rng.integers(0, toks.shape[0], size=(n_clients, batch))
        tb = toks[doc_idx]
        round_batch = {
            'tokens': on_dev(tb[..., :seq], torch.int32),
            'labels': on_dev(tb[..., 1:seq + 1], torch.int32),
            'meta': {
                'sync': on_dev(sync),
                'picked': on_dev(sel.picked),
                'undrafted': on_dev(sel.undrafted),
                'deprecated': on_dev(dep),
                'completed': on_dev(sel.committed),
                'weights': weights,
            },
        }
        if cfg.family == 'vlm':
            round_batch['patch_embeds'] = torch.zeros(
                (n_clients, batch, cfg.n_patches, cfg.d_model),
                dtype=torch.float32, device=dev)
        if cfg.family == 'audio':
            round_batch['frame_embeds'] = torch.zeros(
                (n_clients, batch, cfg.enc_seq, cfg.d_model),
                dtype=torch.float32, device=dev)
        state, metrics = setup.train_step(state, round_batch)
        committed_prev = sel.committed.copy()
        picked_prev = sel.picked.copy()
        history.append(float(metrics['loss']))
        if t % log_every == 0 or t == rounds:
            print(f'round {t:4d} loss {history[-1]:.4f} '
                  f'picked {int(sel.picked.sum())}/{n_clients} '
                  f'crashed {int(crashed.sum())}', flush=True)
    if ckpt:
        checkpoint.save(ckpt, state['global'],
                        {'arch': arch, 'rounds': rounds})
        print('checkpoint saved to', ckpt)
    return history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--arch', choices=ARCH_IDS, default='qwen3-1.7b')
    ap.add_argument('--rounds', type=int, default=30)
    ap.add_argument('--clients', type=int, default=4)
    ap.add_argument('--fraction', type=float, default=0.5)
    ap.add_argument('--lag-tolerance', type=int, default=5)
    ap.add_argument('--crash-prob', type=float, default=0.2)
    ap.add_argument('--batch', type=int, default=4)
    ap.add_argument('--seq', type=int, default=64)
    ap.add_argument('--local-steps', type=int, default=2)
    ap.add_argument('--lr', type=float, default=0.05)
    ap.add_argument('--ckpt', default=None)
    ap.add_argument('--full-size', action='store_true')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    t0 = time.time()
    hist = run(args.arch, rounds=args.rounds, n_clients=args.clients,
               fraction=args.fraction, lag_tolerance=args.lag_tolerance,
               crash_prob=args.crash_prob, batch=args.batch, seq=args.seq,
               local_steps=args.local_steps, lr=args.lr, ckpt=args.ckpt,
               full_size=args.full_size, device=args.device)
    print(f'done: loss {hist[0]:.3f} -> {hist[-1]:.3f} in {time.time()-t0:.0f}s')


if __name__ == '__main__':
    main()
