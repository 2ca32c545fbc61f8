"""Concrete federated tasks mirroring the paper's three experiments.

Task 1: regression  (Boston-like,   m=5,   linear model, MSE)
Task 2: CNN         (MNIST-like,    m=100, 2x conv5x5 + fc, softmax)
Task 3: SVM         (KDD-like,      m=500, linear SVM, hinge loss)

Each implements ``repro_torch.core.federation.Task``: ``local_train`` runs
E epochs of mini-batch SGD (Algorithm 2's client_update) on every client
at once, batched over the stacked clients dim with
``torch.func.vmap(torch.func.grad(loss))``.  ``local_train_fleet`` trains
a fleet of S runs sharing the task in one call: a second ``vmap`` over
the members, the client data not batched over them, so it is held once
whatever S.  The sparse schedules train the K active rows alone
(``local_train_rows``; a fleet's S * K through
``local_train_rows_fleet``).  ``stack_tasks`` stacks S tasks with
different client data (padded to the longest) for a per-member-task
sweep.

Parameters keep the JAX package's layouts, so weights carry across
unchanged (``repro_torch.convert``): conv weights are HWIO, fully
connected weights [in, out], activations flatten in NHWC order.  Train
and eval steps run in full float32: TF32 is switched off for cuDNN
convolutions and for matmuls while they run, and restored after.
"""
from __future__ import annotations

import contextlib
import functools
import hashlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import optim
from repro_torch.core.federation import Task
from repro_torch.data import FederatedData
from repro_torch.kernels.backend import resolve_device


@contextlib.contextmanager
def fp32_math():
    """Full float32 convolutions and matmuls (TF32 off) for the enclosed
    steps; the process-wide flags are restored on exit."""
    matmul = torch.backends.cuda.matmul
    prev = (matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


class SupervisedTask(Task):
    def __init__(self, data: FederatedData, *, init_fn, loss_fn, acc_fn,
                 lr: float, epochs: int, device='cuda'):
        self.device = resolve_device(device)
        self.data = data
        self.init_fn = init_fn          # (torch.Generator) -> params on CPU
        self.loss_fn = loss_fn          # (params, x, y) -> scalar
        self.acc_fn = acc_fn            # (params, x, y) -> scalar
        self.epochs = epochs
        self.lr = lr
        self.opt = optim.sgd(lr)
        self._x = torch.as_tensor(data.x, device=self.device)  # [m, nb, B, ...]
        self._y = torch.as_tensor(data.y, device=self.device)
        self._test_x = torch.as_tensor(data.test_x, device=self.device)
        self._test_y = torch.as_tensor(data.test_y, device=self.device)
        self._grads = torch.func.vmap(torch.func.grad(loss_fn))
        # fleets: members outer, the client data shared by every member
        self._fleet_grads = torch.func.vmap(self._grads,
                                            in_dims=(0, None, None))

    def init_global(self, seed: int) -> dict:
        """The port's own seeded init (JAX's PRNG cannot be reproduced in
        torch; parity runs pass the reference's init instead)."""
        gen = torch.Generator().manual_seed(int(seed))
        return {k: v.to(self.device) for k, v in self.init_fn(gen).items()}

    # -- client_update (Algorithm 2), batched over clients --------------------
    def _train(self, params: dict, x, y) -> dict:
        """E epochs of SGD, replica k on client data x[k], y[k]."""
        params = dict(params)
        with fp32_math():
            for _ in range(self.epochs):
                for j in range(x.shape[1]):
                    g = self._grads(params, x[:, j], y[:, j])
                    params, _ = self.opt.update(g, (), params)
        return params

    def local_train(self, stacked_params: dict, round_idx) -> dict:
        del round_idx  # full-pass SGD; order fixed as in the paper
        return self._train(stacked_params, self._x, self._y)

    def local_train_rows(self, params_rows: dict, rows, round_idx) -> dict:
        """The sparse schedules' rows-train contract: train only the K
        replicas in ``params_rows`` ([K, ...] leaves), replica k on client
        ``rows[k]``'s data, the same step ``local_train`` runs over all m.
        Sentinel rows (``rows == m``) are clamped to the last client's
        data, as jit clamps the JAX package's gather; the engines discard
        their output through the role bits."""
        del round_idx
        r = rows.clamp(max=self._x.shape[0] - 1).long()
        return self._train(params_rows, self._x[r], self._y[r])

    def local_train_rows_fleet(self, params_rows: dict, rows,
                               round_idx) -> dict:
        """The rows-train contract for a fleet of S runs sharing this task:
        [S, K, ...] replicas, member s's replica k on client
        ``rows[s, k]``'s data.  Members train different clients, so the
        S * K replicas go through ``local_train_rows`` as one flat batch
        (one call per SGD step), each replica taking the step its own run
        takes; sentinel rows clamp as there."""
        lead = tuple(rows.shape)
        flat = {k: v.reshape((-1,) + tuple(v.shape[2:]))
                for k, v in params_rows.items()}
        out = self.local_train_rows(flat, rows.reshape(-1), round_idx)
        return {k: v.reshape(lead + tuple(v.shape[1:]))
                for k, v in out.items()}

    def local_train_fleet(self, fleet_params: dict, round_idx) -> dict:
        """``local_train`` for a fleet of S runs sharing this task:
        [S, m, ...] replicas, every member's m clients on the same client
        data, all in one call per SGD step."""
        del round_idx
        params = dict(fleet_params)
        with fp32_math():
            for _ in range(self.epochs):
                for j in range(self._x.shape[1]):
                    g = self._fleet_grads(params, self._x[:, j],
                                          self._y[:, j])
                    params, _ = self.opt.update(g, (), params)
        return params

    def evaluate(self, global_params: dict) -> dict:
        with fp32_math(), torch.no_grad():
            loss = self.loss_fn(global_params, self._test_x, self._test_y)
            acc = self.acc_fn(global_params, self._test_x, self._test_y)
        return {'loss': float(loss), 'acc': float(acc)}

    def fingerprint(self) -> str:
        """Identity of the training problem (client data + hypers)."""
        if '_fingerprint' not in self.__dict__:
            h = hashlib.sha256()
            for a in (self.data.x, self.data.y, self.data.test_x,
                      self.data.test_y):
                h.update(np.ascontiguousarray(a).tobytes())
            h.update(repr((self.lr, self.epochs)).encode())
            self._fingerprint = \
                f'{type(self).__name__}:{h.hexdigest()[:16]}'
        return self._fingerprint


# ---------------------------------------------------------------------------
# Fleet stacking: per-member tasks for batched sweeps
# ---------------------------------------------------------------------------

class StackedSupervisedTask:
    """S ``SupervisedTask``s stacked member-major, so that a sweep whose
    members hold different client data (multi-``seed`` env grids with
    distinct partitions) still trains every member in one call per step.

    Members may disagree on batch count (partition sizes differ), so each
    member's [m, nb_s, B, ...] batch stack is zero-padded to the fleet's
    largest and a per-member [nb_max] validity mask rides along: on a
    padding batch the step's result is discarded and the parameters pass
    through unchanged, an exact no-op, so each member's numbers are those
    of its own unpadded run.  Members must share the model, the client
    count m, the batch size, the epochs and the train step (lr, loss).

    This is not a ``Task``: per-member init and eval stay with the member
    tasks; the fleet engine passes ``fleet_ctx()`` to ``fleet_train``."""

    def __init__(self, tasks):
        if not tasks:
            raise ValueError('empty task stack')
        t0 = tasks[0]
        if any(t.epochs != t0.epochs for t in tasks):
            raise ValueError('stacked tasks must share the epoch count')
        # one train step serves every member, so the steps must be the
        # same: training member s with member 0's lr or loss would break
        # the fleet == sequential identity silently
        hypers = {(t.lr, t.loss_fn, t.acc_fn) for t in tasks}
        if len(hypers) != 1:
            raise ValueError(
                'stacked tasks must share lr/loss_fn/acc_fn (the fleet '
                'runs one train step for all members); got '
                f'{len(hypers)} distinct combinations')
        shapes = {t._x.shape[:1] + t._x.shape[3:] for t in tasks}
        if len(shapes) != 1 or len({t._x.shape[2] for t in tasks}) != 1:
            raise ValueError(
                'stacked tasks must share (m, batch_size, features); got '
                f'x shapes {sorted(tuple(t._x.shape) for t in tasks)}')
        if len({t.device for t in tasks}) != 1:
            raise ValueError('stacked tasks must lie on one device')
        self.tasks = tuple(tasks)
        self._t0 = t0
        self.device = t0.device
        nb = [t._x.shape[1] for t in tasks]
        nb_max = max(nb)

        def pad(a, n):
            # zero batches appended along the batch-count axis (dim 1)
            widths = [0, 0] * (a.ndim - 2) + [0, n - a.shape[1]]
            return F.pad(a, widths)

        self._x = torch.stack([pad(t._x, nb_max) for t in tasks])
        self._y = torch.stack([pad(t._y, nb_max) for t in tasks])
        self._valid = (torch.arange(nb_max, device=self.device)[None, :]
                       < torch.as_tensor(nb, device=self.device)[:, None])
        self._grads = torch.func.vmap(t0._grads)      # members outer

    def fleet_ctx(self) -> dict:
        """The [S, ...] train context the fleet engine hands to
        ``fleet_train``."""
        return {'x': self._x, 'y': self._y, 'valid': self._valid}

    def fleet_train(self, fleet_params: dict, round_idx, ctx: dict) -> dict:
        """Every member's m client replicas ([S, m, ...] leaves) trained
        on its own client data, padding batches masked out."""
        del round_idx
        t = self._t0
        params = dict(fleet_params)
        with fp32_math():
            for _ in range(t.epochs):
                for j in range(ctx['x'].shape[2]):
                    g = self._grads(params, ctx['x'][:, :, j],
                                    ctx['y'][:, :, j])
                    stepped, _ = t.opt.update(g, (), params)
                    v = ctx['valid'][:, j]
                    params = {k: torch.where(
                        v.reshape((-1,) + (1,) * (p.ndim - 1)), stepped[k], p)
                        for k, p in params.items()}
        return params


def stack_tasks(tasks) -> StackedSupervisedTask:
    """Stack per-member ``SupervisedTask``s for a per-member-task sweep
    (``repro_torch.api.SweepSpec(tasks=...)``)."""
    return StackedSupervisedTask(list(tasks))


def _normal(gen, shape):
    return torch.randn(shape, generator=gen)


# ---------------------------------------------------------------------------
# Task 1: regression
# ---------------------------------------------------------------------------

def _reg_init(gen, d=13):
    return {'w': 0.01 * _normal(gen, (d,)), 'b': torch.zeros(())}


def _reg_pred(p, x):
    # elementwise multiply + reduce, the JAX package's form
    return torch.sum(x * p['w'], dim=-1) + p['b']


def _reg_loss(p, x, y):
    return torch.mean(torch.square(_reg_pred(p, x) - y))


def _reg_acc(p, x, y):
    """Paper Table III: acc = 1 - mean(|y - yhat| / max(y, yhat))."""
    yh = _reg_pred(p, x)
    return 1.0 - torch.mean(
        torch.abs(y - yh) / torch.maximum(y, yh).clamp_min(1e-6))


def regression_task(data: FederatedData, lr=1e-4, epochs=3,
                    device='cuda') -> SupervisedTask:
    d = data.x.shape[-1]
    return SupervisedTask(data, init_fn=functools.partial(_reg_init, d=d),
                          loss_fn=_reg_loss, acc_fn=_reg_acc, lr=lr,
                          epochs=epochs, device=device)


# ---------------------------------------------------------------------------
# Task 2: CNN (2x conv 5x5 [20, 50 ch] + 2x2 maxpool + fc relu + softmax)
# ---------------------------------------------------------------------------

def _cnn_init(gen, side=28, classes=10, c1=20, c2=50, hidden=128):
    s = side // 4

    def conv_w(shape):
        fan_in = shape[0] * shape[1] * shape[2]
        return _normal(gen, shape) / math.sqrt(fan_in)
    return {
        'c1': conv_w((5, 5, 1, c1)), 'b1': torch.zeros((c1,)),
        'c2': conv_w((5, 5, c1, c2)), 'b2': torch.zeros((c2,)),
        'f1': _normal(gen, (s * s * c2, hidden)) / math.sqrt(s * s * c2),
        'fb1': torch.zeros((hidden,)),
        'f2': _normal(gen, (hidden, classes)) / math.sqrt(hidden),
        'fb2': torch.zeros((classes,)),
    }


def _conv_same(h, w_hwio, b):
    """5x5 'SAME' convolution of NCHW ``h`` by an HWIO weight, plus bias."""
    out = F.conv2d(h, w_hwio.permute(3, 2, 0, 1), padding=w_hwio.shape[0] // 2)
    return out + b[None, :, None, None]


def _cnn_logits(p, x):
    h = x.permute(0, 3, 1, 2)                          # NHWC -> NCHW
    h = F.max_pool2d(F.relu(_conv_same(h, p['c1'], p['b1'])), 2)
    h = F.max_pool2d(F.relu(_conv_same(h, p['c2'], p['b2'])), 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # flatten as NHWC
    h = F.relu(h @ p['f1'] + p['fb1'])
    return h @ p['f2'] + p['fb2']


def _cnn_loss(p, x, y):
    logits = _cnn_logits(p, x)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y[:, None].long())[:, 0]
    return torch.mean(logz - gold)


def _cnn_acc(p, x, y):
    return torch.mean((torch.argmax(_cnn_logits(p, x), -1) == y).float())


def cnn_task(data: FederatedData, lr=1e-3, epochs=5,
             device='cuda') -> SupervisedTask:
    side = data.x.shape[-3]
    classes = int(data.y.max()) + 1
    return SupervisedTask(
        data, init_fn=functools.partial(_cnn_init, side=side, classes=classes),
        loss_fn=_cnn_loss, acc_fn=_cnn_acc, lr=lr, epochs=epochs,
        device=device)


# ---------------------------------------------------------------------------
# Task 3: linear SVM, hinge loss, labels in {-1, +1}
# ---------------------------------------------------------------------------

def _svm_init(gen, d=35):
    return {'w': 0.01 * _normal(gen, (d,)), 'b': torch.zeros(())}


def _svm_margin(p, x):
    return torch.sum(x * p['w'], dim=-1) + p['b']


def _svm_loss(p, x, y, l2=1e-4):
    hinge = torch.mean(torch.clamp_min(1.0 - y * _svm_margin(p, x), 0.0))
    return hinge + l2 * torch.sum(torch.square(p['w']))


def _svm_acc(p, x, y):
    """Paper Table III: mean(max(0, sign(y * yhat)))."""
    return torch.mean(torch.clamp_min(torch.sign(y * _svm_margin(p, x)), 0.0))


def svm_task(data: FederatedData, lr=1e-2, epochs=5,
             device='cuda') -> SupervisedTask:
    d = data.x.shape[-1]
    return SupervisedTask(data, init_fn=functools.partial(_svm_init, d=d),
                          loss_fn=_svm_loss, acc_fn=_svm_acc, lr=lr,
                          epochs=epochs, device=device)
