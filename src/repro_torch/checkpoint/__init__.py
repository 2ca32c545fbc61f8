"""Tree checkpointing (npz), federated run state included, so a federation
can stop and resume mid-training.  The files are the JAX package's
(``repro.checkpoint``): either package reads the other's.

Two layers:

* ``save`` / ``restore`` -- a (nested) dict/tuple tree of tensors <-> npz
  with a JSON metadata entry, ``__meta__``.  A leaf's key is its path
  joined by ``/`` (dict keys; tuple and list indices as decimals, so a
  packed carry is ``packed/0`` ... ``packed/3``); a ``None`` subtree
  writes no key.  Leaves are copied to the host and written in their own
  dtype (f32 as ``<f4``, integers as themselves), bit for bit.
* ``save_run`` / ``load_run`` -- the run-state format of
  ``repro_torch.api.CompiledRunner``: the carry (global/local/cache model
  trees, and the sparse and lag-tier carries; a fleet's stacked), how many
  eval segments completed, the histories so far (``History.to_dict``) and
  a fingerprint of the producing spec, which must match on resume.  A
  killed run resumed from its latest checkpoint replays only the
  remaining segments and ends bit for bit as the uninterrupted run.

bf16 leaves are written as the JAX package writes them: their 16-bit
patterns under the void dtype ``|V2`` (numpy has no bf16 type; the bits
go through int16).  ``restore`` reads such an entry back through int16
viewed as ``torch.bfloat16``, bit for bit, so the port restores the bf16
files that the JAX package writes but cannot read back (its restore casts
``|V2`` with numpy and fails there).  The file holds the bits either way.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

__all__ = ['exists', 'flatten', 'load_run', 'restore', 'save', 'save_run']

#: the dtype the JAX package's files hold a bf16 leaf in (its bit patterns)
_BF16 = np.dtype('V2')


def _npz_path(path: str) -> str:
    """np.savez appends '.npz' when missing; normalise so save and load
    always agree on the on-disk name."""
    return path if path.endswith('.npz') else path + '.npz'


def _leaves_with_paths(tree, prefix=()):
    """(path, leaf) pairs in the JAX package's flattening order: dict keys
    sorted, sequences by index, ``None`` subtrees skipped."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, prefix + (str(i),))
    else:
        yield '/'.join(prefix), tree


def flatten(tree) -> dict:
    """{key: leaf} of a tree, each key as the file spells it."""
    return dict(_leaves_with_paths(tree))


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16)
        return t.numpy()
    return np.asarray(leaf)


def _from_host(arr: np.ndarray, like, device) -> torch.Tensor:
    dtype = getattr(like, 'dtype', None)
    arr = np.require(arr, requirements='C')     # keeps 0-d leaves 0-d
    if arr.dtype == _BF16:
        if dtype not in (None, torch.bfloat16):
            raise ValueError(f'a bf16 entry cannot restore into a {dtype} '
                             f'leaf')
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if dtype is not None:
        t = t.to(dtype)
    if device is None:
        device = getattr(like, 'device', None)
        if device is not None and device.type == 'meta':
            device = None
    return t.to(device) if device is not None else t


def save(path: str, tree: Any, metadata: dict | None = None) -> None:
    path = _npz_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays = {k: _to_host(v) for k, v in flatten(tree).items()}
    np.savez(path, __meta__=json.dumps(metadata or {}), **arrays)


def restore(path: str, like: Any, device=None):
    """Restore into the structure of ``like`` (a tree of tensors, ``meta``
    tensors included), each leaf in its ``like`` leaf's dtype, on
    ``device`` (default: each ``like`` leaf's own device, or the host's
    for a ``meta`` leaf).  Returns (tree, metadata)."""
    with np.load(_npz_path(path), allow_pickle=False) as data:
        meta = json.loads(str(data['__meta__']))

        def build(t, prefix):
            if t is None:
                return None
            if isinstance(t, dict):
                return {k: build(v, prefix + (str(k),)) for k, v in t.items()}
            if isinstance(t, (tuple, list)):
                return type(t)(build(v, prefix + (str(i),))
                               for i, v in enumerate(t))
            return _from_host(data['/'.join(prefix)], t, device)
        return build(like, ()), meta


# ---------------------------------------------------------------------------
# Run-state checkpoints (repro_torch.api.CompiledRunner)
# ---------------------------------------------------------------------------

def exists(path: str) -> bool:
    return os.path.exists(_npz_path(path))


def save_run(path: str, state: Any, *, seg_done: int, histories: list,
             fingerprint: str) -> None:
    """Persist a (possibly partial) run: the model-state tree, how many
    eval segments completed, the per-member history dicts, and the
    fingerprint of the producing spec.  Atomic enough for a kill between
    segments: the previous checkpoint is replaced only by a complete
    ``np.savez`` write to a temp file."""
    path = _npz_path(path)
    tmp = path + '.tmp.npz'
    save(tmp, state, metadata={
        'seg_done': int(seg_done),
        'histories': [h.to_dict() for h in histories],
        'fingerprint': fingerprint,
    })
    os.replace(tmp, path)


def load_run(path: str, like: Any, *, fingerprint: str, device=None):
    """Load a run checkpoint written by ``save_run`` into the structure of
    ``like``.  Raises ``ValueError`` when the stored fingerprint does not
    match: resuming under a different spec would silently produce a
    History that belongs to neither run.  Returns
    (state, seg_done, history_dicts)."""
    state, meta = restore(path, like, device=device)
    if meta.get('fingerprint') != fingerprint:
        raise ValueError(
            'checkpoint fingerprint mismatch: the checkpoint at '
            f'{path!r} was written by a different experiment spec '
            '(protocol/exec/rounds/seed/env all participate); refusing '
            'to resume')
    return state, int(meta['seg_done']), meta['histories']
