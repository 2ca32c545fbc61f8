"""The silo step of the configurations ``tests/test_torch_train.py`` does
not hold (it holds qwen3-1.7b and mamba2-130m): three
``SiloSetup.train_step`` rounds of each other reduced configuration, f32,
against the reference's jitted step on its carried params, with the same
masks, batches and tolerance (``STATE_ATOL``).  A file of its own, so
that the test runner can spread the two files' time.
"""
import jax
import numpy as np
import pytest

from repro import configs as jcfgs
from test_torch_train import STATE_ATOL, _close, _round_batches, _silo_pair

OTHERS = [a for a in jcfgs.ARCH_IDS if a not in ('qwen3-1.7b',
                                                 'mamba2-130m')]


@pytest.mark.parametrize('arch', OTHERS)
def test_silo_train_step_matches_reference_other_families(arch):
    """Three SAFA rounds (test_system.py's masks, rolled a client a round,
    two local steps): global, local and cache within atol 1e-5 after
    every round, the loss metric within 1e-5, picked_frac equal."""
    jc, jsetup, jstate, tsetup, tstate = _silo_pair(arch)
    step = jax.jit(jsetup.train_step)
    for r in range(3):
        jb, tb = _round_batches(jc, r)
        jstate, jm = step(jstate, jb)
        tstate, tm = tsetup.train_step(tstate, tb)
        for part in ('global', 'local', 'cache'):
            _close(tstate[part], jstate[part], STATE_ATOL)
        np.testing.assert_allclose(float(tm['loss']), float(jm['loss']),
                                   atol=STATE_ATOL)
        assert float(tm['picked_frac']) == float(jm['picked_frac'])
