"""Step functions of the model path: silo-mode federated training of the
LLMs (``SiloSetup``) and serving of the global model (``ServeSetup``).

``SiloSetup`` is the reference's silo-mode SAFA round: the clients are
the rows of ``[C, ...]`` stacks of the model's (nested) params, and a
round is Eq. 3 distribution, ``local_steps`` of SGD per client, the
crashed clients' rows left as they were, then the Eq. 6-8
discriminative aggregation.  The reference writes it out of place and
lets XLA reuse the donated state; in eager PyTorch that would hold four
more ``[C, ...]`` stacks than the state (95 GiB for qwen3-1.7b against
its 34 GiB state), so ``train_step`` works leaf by leaf and in place,
and trains the clients one after another from a copy of each row (the
MoE's dispatch is data-dependent, so the clients are not batched).
Sharding profiles (the reference's ``rules``, ``shardings``,
``_maybe_gather_weights``) are not ported (ROADMAP queue 1, item 28).

``ServeSetup`` is the reference's, without the shardings (the port runs
on one card): ``prefill_step`` is the bulk prefill through
``forward_logits`` (with ``attn_impl='pallas'`` it launches kernel 21 once
per causal attention layer, or application of the hybrid family's shared
block; the audio encoder's and the cross-attention take the plain path),
``serve_step`` one decode step against the model's caches.  The
``*_batch`` methods describe their inputs as ``meta`` tensors, as the
reference's give ``ShapeDtypeStruct``s.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import protocol
from repro_torch.models.model import Model
from repro_torch.optim import tree_leaves, tree_map

#: the round's client masks, in ``batch['meta']``
MASKS = ('sync', 'picked', 'undrafted', 'deprecated', 'completed')


def _host(mask) -> list:
    """A [C] mask as a list of Python bools (one device read)."""
    return [bool(x) for x in mask.tolist()]


def row(stacked, k: int):
    """Client ``k``'s row of a stacked tree (views)."""
    return tree_map(lambda t: t[k], stacked)


@dataclasses.dataclass
class SiloSetup:
    model: Model
    n_clients: int
    local_steps: int = 1
    learning_rate: float = 1e-2
    rules: dict = None   # the reference's sharding profile: not ported

    def __post_init__(self):
        if self.rules is not None:
            raise NotImplementedError(
                'sharding profiles (rules=) are not ported to repro_torch '
                'yet (ROADMAP queue 1, item 28)')

    def client_batch(self, shape):
        """One round's input batch for ``shape`` (an ``InputShape``) as
        meta tensors: tokens and labels [C, b, S] int32 with b =
        max(1, global_batch // C), the masks [C] bool, weights [C] f32;
        the VLM adds 'patch_embeds' [C, b, n_patches, d_model], audio
        'frame_embeds' [C, b, enc_seq, d_model], both f32."""
        cfg = self.model.cfg
        C = self.n_clients
        b = max(1, shape.global_batch // C)

        def meta(shp, dtype):
            return torch.empty(shp, dtype=dtype, device='meta')
        batch = {
            'tokens': meta((C, b, shape.seq_len), torch.int32),
            'labels': meta((C, b, shape.seq_len), torch.int32),
            'meta': {**{k: meta((C,), torch.bool) for k in MASKS},
                     'weights': meta((C,), torch.float32)},
        }
        extra = {'vlm': ('patch_embeds', cfg.n_patches),
                 'audio': ('frame_embeds', cfg.enc_seq)}.get(cfg.family)
        if extra:
            batch[extra[0]] = meta((C, b, extra[1], cfg.d_model),
                                   torch.float32)
        return batch

    def state_sds(self):
        """{'global': params, 'local': [C, ...], 'cache': [C, ...]} as
        meta tensors."""
        C = self.n_clients
        shapes = self.model.param_shapes()
        stack = tree_map(lambda s: torch.empty((C,) + tuple(s.shape),
                                               dtype=s.dtype, device='meta'),
                         shapes)
        return {'global': shapes, 'local': stack, 'cache': stack}

    def init_state(self, global_w):
        """The round-0 state: every client's local model and cache entry a
        copy of ``global_w`` (owned, contiguous: ``train_step`` writes
        them in place)."""
        C = self.n_clients

        def tiled(g):
            return g.unsqueeze(0).expand((C,) + tuple(g.shape)).clone()
        return {'global': global_w, 'local': tree_map(tiled, global_w),
                'cache': tree_map(tiled, global_w)}

    # -- local training ------------------------------------------------------
    def train_client(self, params, batch):
        """``local_steps`` of SGD on one client's ``batch`` from a copy of
        ``params``, each step ``w <- (w - lr * f32(grad)) in w's dtype``
        as the reference's (a leaf the loss does not reach, such as
        reduced zamba2's unused shared block, has a zero gradient and
        keeps its value); returns (trained params, mean loss)."""
        p = tree_map(lambda w: w.detach().clone().requires_grad_(), params)
        ws = tree_leaves(p)
        losses = []
        for _ in range(self.local_steps):
            with torch.enable_grad():
                loss = self.model.loss(p, batch)
                grads = torch.autograd.grad(loss, ws, allow_unused=True)
            with torch.no_grad():
                for w, g in zip(ws, grads):
                    if g is not None:
                        w.copy_(w - self.learning_rate * g.float())
            losses.append(loss.detach())
            del grads       # before the next step's backward allocates more
        return (tree_map(lambda w: w.detach(), p),
                torch.stack(losses).mean())

    @staticmethod
    def client(batch, k: int):
        """Client ``k``'s part of a round's batch (its meta left out)."""
        return {name: v[k] for name, v in batch.items() if name != 'meta'}

    def train_clients(self, local, batch, completed):
        """Train every client from its row of ``local`` (the crashed ones
        too: the loss averages over all), and write the trained row back
        in place where ``completed[k]``.  Returns the [C] mean losses."""
        losses = []
        for k in range(self.n_clients):
            trained, loss = self.train_client(row(local, k),
                                              self.client(batch, k))
            losses.append(loss)
            if completed[k]:
                with torch.no_grad():
                    for t, w in zip(tree_leaves(local), tree_leaves(trained)):
                        t[k].copy_(w)
            del trained
        return torch.stack(losses)

    # -- the round -----------------------------------------------------------
    @staticmethod
    def distribute(state, sync):
        """Eq. 3 in place: client k takes the global model where
        ``sync[k]``."""
        with torch.no_grad():
            for g, l in zip(tree_leaves(state['global']),
                            tree_leaves(state['local'])):
                for k, s in enumerate(sync):
                    if s:
                        l[k].copy_(g)

    @staticmethod
    def server_step(state, picked, undrafted, deprecated, weights):
        """Eq. 6-8 after training, leaf by leaf: Eq. 6 into ``cache`` in
        place (picked rows take their new local model, deprecated and
        unpicked rows the old global), Eq. 7 into a new global
        (``protocol.aggregate``: the clients summed in f32), Eq. 8 into
        ``cache`` in place (undrafted rows take their new local model).
        Returns the new global."""
        def leaf(g, l, c):
            for k in range(len(picked)):
                if picked[k]:
                    c[k].copy_(l[k])
                elif deprecated[k]:
                    c[k].copy_(g)
            new = protocol.aggregate({'w': c}, weights)['w']
            for k, u in enumerate(undrafted):
                if u:
                    c[k].copy_(l[k])
            return new
        with torch.no_grad():
            return tree_map(leaf, state['global'], state['local'],
                            state['cache'])

    def train_step(self, state, batch):
        """One SAFA round in silo mode: Eq. 3, local SGD, Eq. 6-8.
        Consumes ``state`` (its local and cache stacks are updated in
        place and returned; as the reference donates it) and returns
        (new state, {'loss', 'picked_frac'}): the loss is the mean over
        all clients of each one's mean loss over its local steps."""
        meta = batch['meta']
        masks = {k: _host(meta[k]) for k in MASKS}
        self.distribute(state, masks['sync'])
        losses = self.train_clients(state['local'], batch,
                                    masks['completed'])
        new_global = self.server_step(
            state, masks['picked'], masks['undrafted'], masks['deprecated'],
            meta['weights'])
        new_state = {'global': new_global, 'local': state['local'],
                     'cache': state['cache']}
        metrics = {'loss': losses.mean(),
                   'picked_frac': meta['picked'].float().mean()}
        return new_state, metrics

    def fedavg_train_step(self, state, batch):
        """Baseline: a synchronous FedAvg round on the same state (the
        cache untouched), out of place as the reference's
        (``protocol.fedavg_round``)."""
        meta = batch['meta']

        def train_fn(base):
            rows = [self.train_client(row(base, k), self.client(batch, k))[0]
                    for k in range(self.n_clients)]
            return tree_map(lambda *r: torch.stack(r), *rows)

        new_global, new_local = protocol.fedavg_round(
            state['global'], state['local'], selected=meta['picked'],
            completed=meta['completed'], weights=meta['weights'],
            local_train_fn=train_fn)
        return {'global': new_global, 'local': new_local,
                'cache': state['cache']}, {}


@dataclasses.dataclass
class ServeSetup:
    model: Model

    def prefill_batch(self, shape):
        """{'tokens': [global_batch, seq_len] int32} for ``shape`` (an
        ``InputShape``), as meta tensors; the VLM adds 'patch_embeds'
        [global_batch, n_patches, d_model], audio 'frame_embeds'
        [global_batch, enc_seq, d_model], both f32."""
        cfg = self.model.cfg
        B = shape.global_batch
        batch = {'tokens': torch.empty((B, shape.seq_len), dtype=torch.int32,
                                       device='meta')}
        extra = {'vlm': ('patch_embeds', cfg.n_patches),
                 'audio': ('frame_embeds', cfg.enc_seq)}.get(cfg.family)
        if extra:
            batch[extra[0]] = torch.empty((B, extra[1], cfg.d_model),
                                          dtype=torch.float32, device='meta')
        return batch

    def prefill_step(self, params, batch):
        """Next token of every row: argmax of the last position's logits."""
        logits, _ = self.model.logits(params, batch)
        return logits[:, -1].argmax(-1)

    def decode_batch(self, shape):
        """(cache, tokens) for one decode step with a full seq_len cache
        (audio: and its zero cross caches), as meta tensors."""
        B, S = shape.global_batch, shape.seq_len
        cache = self.model.init_cache(B, S, length=S - 1, device='meta')
        return cache, torch.empty((B, 1), dtype=torch.int32, device='meta')

    def serve_step(self, params, cache, tokens):
        """One decode step (the cache updated in place); returns (cache,
        next token [B])."""
        cache, logits = self.model.decode_step(params, cache, tokens)
        return cache, logits.argmax(-1)
