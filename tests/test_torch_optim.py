"""The port's optimizers (``repro_torch.optim``) against the JAX
package's on the CPU: ``sgd`` with and without momentum, ``adamw`` with
and without weight decay and ``clip_by_global_norm``, on one nested f32
tree over five steps of seeded gradients, and one step on a tree with
bf16 leaves (the dtypes a model's params hold).

Tolerance: the same arithmetic in the same dtypes: the f32 tree and the
optimizer states within 1e-6 after five steps; a bf16 leaf after one
step within one bf16 rounding of its value (rtol 2^-7: XLA fuses the
step's bf16 operations into one rounding, eager PyTorch rounds each);
the global norm within rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as j_optim
from repro_torch import optim
from repro_torch.convert import params_from_jax

STEPS = 5
ATOL = 1e-6
BF16_RTOL = 2 ** -7


def _tree(seed, wdtype=jnp.float32):
    """A nested tree; ``wdtype`` is the dtype of its stacked weight."""
    rng = np.random.default_rng(seed)
    return {'embed': rng.normal(size=(6, 4)).astype(np.float32),
            'layers': {'ln': (0.1 * rng.normal(size=(2, 4))).astype(
                np.float32),
                'w': jnp.asarray(rng.normal(size=(2, 4, 3)), wdtype)},
            'scale': np.float32(rng.normal()) * np.ones((1,), np.float32)}


def _pair(seed, wdtype=jnp.float32):
    j = jax.tree.map(jnp.asarray, _tree(seed, wdtype))
    return j, params_from_jax(jax.tree.map(np.asarray, j), device='cpu')


def _close(got, want):
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32),
                                       rtol=BF16_RTOL, atol=ATOL)
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


OPTIMIZERS = {
    'sgd': lambda m: m.sgd(0.1),
    'sgd_momentum': lambda m: m.sgd(0.1, momentum=0.9),
    'adamw': lambda m: m.adamw(1e-2),
    'adamw_decay': lambda m: m.adamw(1e-2, b1=0.8, b2=0.99, eps=1e-6,
                                     weight_decay=0.1),
}


@pytest.mark.parametrize('name', sorted(OPTIMIZERS))
def test_optimizer_matches_reference_over_five_steps(name):
    jopt, topt = OPTIMIZERS[name](j_optim), OPTIMIZERS[name](optim)
    jp, tp = _pair(0)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    update = jax.jit(jopt.update)
    for step in range(STEPS):
        jg, tg = _pair(100 + step)
        jp, jstate = update(jg, jstate, jp)
        tp, tstate = topt.update(tg, tstate, tp)
        _close(tp, jp)
        _close(tstate, jstate)
    if name.startswith('adamw'):
        assert int(tstate['count']) == STEPS
        assert tstate['count'].dtype == torch.int32
        assert all(t.dtype == torch.float32
                   for t in jax.tree.leaves(tstate['mu']))


@pytest.mark.parametrize('name', sorted(OPTIMIZERS))
def test_optimizer_keeps_bf16_leaves(name):
    """One step on a tree with a bf16 weight: every leaf keeps its dtype
    and agrees with the reference's."""
    jopt, topt = OPTIMIZERS[name](j_optim), OPTIMIZERS[name](optim)
    jp, tp = _pair(0, jnp.bfloat16)
    jg, tg = _pair(100, jnp.bfloat16)
    jp, _ = jax.jit(jopt.update)(jg, jopt.init(jp), jp)
    got, _ = topt.update(tg, topt.init(tp), tp)
    assert got['layers']['w'].dtype == torch.bfloat16
    assert jax.tree.map(lambda t: t.dtype, got) == \
        jax.tree.map(lambda t: t.dtype, tp)
    _close(got, jp)


@pytest.mark.parametrize('max_norm', [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    """Scaled down to ``max_norm`` (0.5) or left as they are (1e3), the
    norm summed over the leaves in f32 in sorted-key order."""
    jg, tg = _pair(7)
    want, jnorm = j_optim.clip_by_global_norm(jg, max_norm)
    got, norm = optim.clip_by_global_norm(tg, max_norm)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    _close(got, want)
    if max_norm > float(norm):
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tg)):
            assert torch.equal(a, b)


def test_tree_helpers_follow_the_reference_flattening():
    jp, tp = _pair(3)
    leaves = optim.tree_leaves(tp)
    assert [tuple(t.shape) for t in leaves] == \
        [tuple(a.shape) for a in jax.tree.leaves(jp)]
    doubled = optim.tree_map(lambda a, b: a + b, tp, tp)
    for a, b in zip(optim.tree_leaves(doubled), leaves):
        assert torch.equal(a, b + b)
