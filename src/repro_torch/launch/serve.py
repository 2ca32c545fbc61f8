"""Batched serving: token-by-token prefill, then greedy decode
against the model's caches (ring-buffer KV, conv and SSM state), from
random init.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
        --full-size --batch 4 --prompt-len 32 --gen 16

Runs on the card unless ``--device cpu`` is given.  Prompts are drawn by
a CPU ``torch.Generator`` seeded with ``seed``, so every device serves the
same prompts; the params by a generator on the device, seeded the same.
Every family serves, as the JAX CLI serves it: tokens-only prompts, so the
VLM decodes text with no patch context and whisper against zero cross
caches (no encoder pass fills them).  ``--ckpt`` serves the global model
that ``repro_torch.launch.train --ckpt`` saved (or the JAX CLI's, bf16
included) instead of the seeded init.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import checkpoint
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels.backend import resolve_device
from repro_torch.models.model import build_model


def _sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def run(arch: str, *, batch: int, prompt_len: int, gen: int,
        full_size: bool = False, ckpt: str = None, seed: int = 0,
        device='cuda'):
    """Serve ``batch`` prompts of ``prompt_len`` seeded tokens and generate
    ``gen`` tokens each; returns the generated ids [batch, gen] (int64, on
    the device).  ``ckpt`` names a checkpoint of the params to serve."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if not full_size:
        cfg = cfg.reduced()
    model = build_model(cfg)
    if ckpt:
        params, meta = checkpoint.restore(ckpt, model.param_shapes(),
                                          device=dev)
        print('restored checkpoint', meta)
    else:
        params = model.init(torch.Generator(device=dev).manual_seed(seed))

    max_len = prompt_len + gen
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=torch.Generator().manual_seed(seed))
    prompts = prompts.to(dev)

    cache = model.init_cache(batch, max_len, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    cache, logits = model.prefill(params, cache, prompts)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    tok = logits[:, -1].argmax(-1)[:, None]
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        cache, logits = model.decode_step(params, cache, tok)
        tok = logits.argmax(-1)[:, None]
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    toks = torch.cat(out, dim=1)
    print(f'prefill: {batch}x{prompt_len} tokens in {t_prefill:.2f}s')
    print(f'decode:  {batch}x{gen} tokens in {t_decode:.2f}s '
          f'({batch * gen / max(t_decode, 1e-9):.1f} tok/s)')
    print('sample continuation ids:', toks[0, :12].tolist())
    return toks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--arch', choices=ARCH_IDS, default='mamba2-130m')
    ap.add_argument('--batch', type=int, default=4)
    ap.add_argument('--prompt-len', type=int, default=32)
    ap.add_argument('--gen', type=int, default=16)
    ap.add_argument('--ckpt', default=None)
    ap.add_argument('--full-size', action='store_true')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    run(args.arch, batch=args.batch, prompt_len=args.prompt_len,
        gen=args.gen, ckpt=args.ckpt, full_size=args.full_size,
        device=args.device)


if __name__ == '__main__':
    main()
