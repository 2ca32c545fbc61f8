"""Synthetic federated datasets + partitioner.

The container is offline, so Boston/MNIST/KDDCup99 are replaced by synthetic
teacher-generated datasets with matched dimensionality and size (DESIGN.md
§6).  Partition sizes follow the paper's N(mu, 0.3 mu) imbalance model; a
Dirichlet label-skew option provides non-IID splits.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class FederatedData:
    """Stacked per-client batches: x [m, nb, B, ...], y [m, nb, B, ...]."""
    x: np.ndarray
    y: np.ndarray
    test_x: np.ndarray
    test_y: np.ndarray
    partition_sizes: np.ndarray


def make_regression(n=506, d=13, noise=0.3, seed=0):
    """Boston-housing-like regression: y = teacher(x) + noise, positive."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d,)).astype(np.float32)
    y = x @ w + noise * rng.normal(size=(n,)).astype(np.float32)
    y = (y - y.min() + 1.0).astype(np.float32)  # positive targets (house prices)
    return x, y


def make_images(n=4000, side=28, classes=10, seed=0):
    """MNIST-like: class-conditional low-rank Gaussian patterns."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(classes, side * side)).astype(np.float32)
    labels = rng.integers(0, classes, size=n)
    x = protos[labels] + 1.2 * rng.normal(size=(n, side * side)).astype(np.float32)
    return x.reshape(n, side, side, 1).astype(np.float32), labels.astype(np.int32)


def make_svm(n=20000, d=35, seed=0, flip=0.02):
    """KDD-like binary classification, labels in {-1, +1}."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d,)).astype(np.float32)
    y = np.sign(x @ w + 0.1 * rng.normal(size=(n,))).astype(np.float32)
    y[y == 0] = 1.0
    flips = rng.random(n) < flip
    y[flips] = -y[flips]
    return x, y


def partition(x, y, partition_sizes: np.ndarray, batch_size: int, *,
              test_frac=0.15, dirichlet_alpha: Optional[float] = None,
              seed=0) -> FederatedData:
    """Split (x, y) into per-client stacked batches.

    Every client is padded (wrap-around over its own samples) to the common
    batch count so replicas stack into [m, nb, B, ...]; aggregation weights
    still use the true partition sizes (Eq. 7)."""
    rng = np.random.default_rng(seed + 7)
    n = x.shape[0]
    n_test = int(n * test_frac)
    perm = rng.permutation(n)
    test_idx, pool = perm[:n_test], perm[n_test:]

    m = len(partition_sizes)
    sizes = np.maximum(1, (partition_sizes / partition_sizes.sum()
                           * len(pool)).astype(int))
    if dirichlet_alpha is not None and y.dtype.kind in 'iu':
        # label-skewed split: per-client class mixture ~ Dir(alpha)
        classes = np.unique(y[pool])
        by_class = {c: list(rng.permutation(pool[y[pool] == c])) for c in classes}
        client_idx = []
        for k in range(m):
            mix = rng.dirichlet(dirichlet_alpha * np.ones(len(classes)))
            want = np.maximum(1, (mix * sizes[k]).astype(int))
            got = []
            for c, w in zip(classes, want):
                take = by_class[c][:w]
                by_class[c] = by_class[c][w:]
                got.extend(take)
            if not got:
                got = [pool[rng.integers(len(pool))]]
            client_idx.append(np.array(got))
    else:
        splits = np.cumsum(sizes)[:-1]
        client_idx = np.split(rng.permutation(pool)[:sizes.sum()], splits)

    nb = max(1, int(np.ceil(max(len(ci) for ci in client_idx) / batch_size)))
    xs, ys = [], []
    for ci in client_idx:
        reps = nb * batch_size
        idx = np.resize(ci, reps)  # wrap-around padding
        xs.append(x[idx].reshape((nb, batch_size) + x.shape[1:]))
        ys.append(y[idx].reshape((nb, batch_size) + y.shape[1:]))
    return FederatedData(
        x=np.stack(xs), y=np.stack(ys),
        test_x=x[test_idx], test_y=y[test_idx],
        partition_sizes=np.array([len(ci) for ci in client_idx]))


def make_lm_tokens(n_docs=512, seq_len=128, vocab=512, seed=0):
    """Synthetic token streams from a first-order random Markov teacher
    (for federated LM examples)."""
    rng = np.random.default_rng(seed)
    trans = rng.dirichlet(0.3 * np.ones(vocab), size=vocab)
    toks = np.zeros((n_docs, seq_len + 1), np.int32)
    toks[:, 0] = rng.integers(0, vocab, n_docs)
    for t in range(1, seq_len + 1):
        p = trans[toks[:, t - 1]]
        toks[:, t] = (p.cumsum(1) > rng.random((n_docs, 1))).argmax(1)
    return toks
