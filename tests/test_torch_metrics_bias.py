"""The port's closed-form metrics and bias analysis
(``repro_torch.core.metrics`` and ``repro_torch.core.bias``, numpy
copies of the JAX package's modules) against the reference's on a grid of
(C, R, cr, k, r) and on seeded masks, counts and version lists.

Tolerance: none; both packages run the same numpy expressions, so every
value is compared exactly.
"""
import itertools

import numpy as np
import pytest

from repro.core import bias as jbias
from repro.core import metrics as jmetrics
from repro_torch.core import bias as tbias
from repro_torch.core import metrics as tmetrics

FRACTIONS = (0.1, 0.3, 0.5, 0.7, 1.0)          # C
CRASH = (0.0, 0.1, 0.3, 0.5, 0.7, 0.9)         # R, cr
ROUNDS = (1, 2, 3, 5, 10)                      # k, r


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert type(a) is type(b)


@pytest.mark.parametrize('fn', ['case_of'])
def test_case_of(fn):
    for C, R in itertools.product(FRACTIONS, CRASH):
        _same(getattr(tbias, fn)(C, R), getattr(jbias, fn)(C, R))


@pytest.mark.parametrize('fn', ['sigma', 'sigma_paper'])
def test_sigma(fn):
    for cr, k in itertools.product(CRASH, (0,) + ROUNDS):
        _same(getattr(tbias, fn)(cr, k), getattr(jbias, fn)(cr, k))


@pytest.mark.parametrize('faithful', [True, False])
@pytest.mark.parametrize('fn', ['p_direct', 'p_bypass', 'p_contrib'])
def test_probabilities(fn, faithful):
    for cr, r, case, fast in itertools.product(CRASH, ROUNDS, (1, 2, 3),
                                               (True, False)):
        _same(getattr(tbias, fn)(cr, r, case, fast, faithful),
              getattr(jbias, fn)(cr, r, case, fast, faithful))


@pytest.mark.parametrize('faithful', [True, False])
def test_bias_safa_and_curve(faithful):
    for cr_a, cr_b, C, R in itertools.product((0.0, 0.1, 0.3),
                                              (0.5, 0.7), FRACTIONS, CRASH):
        for r in ROUNDS:
            _same(tbias.bias_safa(cr_a, cr_b, C, R, r, faithful),
                  jbias.bias_safa(cr_a, cr_b, C, R, r, faithful))
        _same(tbias.bias_curve(cr_a, cr_b, C, R, 12, faithful),
              jbias.bias_curve(cr_a, cr_b, C, R, 12, faithful))
        _same(tbias.bias_fedavg(cr_a, cr_b), jbias.bias_fedavg(cr_a, cr_b))


@pytest.mark.parametrize('fn', ['eur_theory_safa', 'eur_theory_fedavg'])
def test_eur_theory(fn):
    for C, R in itertools.product(FRACTIONS, CRASH):
        _same(getattr(tmetrics, fn)(C, R), getattr(jmetrics, fn)(C, R))


def test_measured_metrics():
    rng = np.random.default_rng(0)
    for m, rounds in ((5, 3), (100, 10)):
        picked = rng.random(m) < 0.5
        crashed = rng.random(m) < 0.3
        _same(tmetrics.eur_measured(picked, crashed),
              jmetrics.eur_measured(picked, crashed))
        counts = rng.integers(0, m, rounds)
        _same(tmetrics.sync_ratio(counts, m, rounds),
              jmetrics.sync_ratio(counts, m, rounds))
        versions = [rng.integers(0, 5, rng.integers(0, m)) for _ in
                    range(rounds)]
        _same(tmetrics.version_variance(versions),
              jmetrics.version_variance(versions))
    _same(tmetrics.version_variance([]), jmetrics.version_variance([]))
