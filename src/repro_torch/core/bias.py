"""Closed-form bias analysis (paper §III-E, Appendix A; Eq. 11-16, 22-31).

bias(r) = P^(r)(A) / P^(r)(B) between the fastest client A and the slowest
client B, as a function of the federated round index r.
"""
from __future__ import annotations

import numpy as np


def case_of(C: float, R: float) -> int:
    """Selection-regime cases (paper §III-E)."""
    if C >= 1 - R:
        return 1
    if (1 - C) * (1 - R) <= C < 1 - R:
        return 2
    return 3


def sigma_paper(cr: float, k: int) -> float:
    """Eq. 15 EXACTLY as printed:
        sigma^(k) = (2 cr - (cr-1)^(k+1) - 3) / (cr - 2).
    Used to reproduce Fig. 5 faithfully.  Note this evaluates > 1 (e.g.
    2-cr at k=1), so it cannot be the complement of a probability — it is
    inconsistent with the paper's own recurrence (Eq. 22/24); see
    ``sigma`` for the corrected form and EXPERIMENTS.md for discussion.
    """
    return (2 * cr - (cr - 1) ** (k + 1) - 3) / (cr - 2)


def sigma(cr: float, k: int) -> float:
    """Corrected sigma^(k) = 1 - P_D^(k): exact solution of the paper's own
    recurrence P_D^(r) = (1-cr)(1 - P_D^(r-1)), P_D^(1) = 1-cr (Eq. 22/24):

        sigma^(k) = ((cr-1)^(k+1) - 1) / (cr - 2)

    Fixed point 1/(2-cr); validated by Monte-Carlo CFCFM simulation
    (tests/test_bias_montecarlo.py).
    """
    return ((cr - 1) ** (k + 1) - 1) / (cr - 2)


def p_direct(cr: float, r: int, case: int, fast: bool,
             faithful: bool = True) -> float:
    """Eq. 28 / 30: probability the client's update goes directly into the
    cache in round r.  ``faithful`` selects the paper's printed sigma
    (Fig. 5 reproduction) vs the corrected recurrence solution."""
    s = sigma_paper if faithful else sigma
    if fast:
        if case in (1, 2):
            return 1 - cr
        return (1 - cr) * s(cr, r - 1)
    else:
        if case == 1:
            return 1 - cr
        if case == 2:
            return (1 - cr) * s(cr, r - 1)
        return 0.0


def p_bypass(cr: float, r: int, case: int, fast: bool,
             faithful: bool = True) -> float:
    """Eq. 29 / 31: probability the bypass entry takes effect in round r."""
    s = sigma_paper if faithful else sigma
    if fast:
        if case in (1, 2):
            return 0.0
        return cr * (s(cr, r - 1) - cr)
    else:
        if case == 1:
            return 0.0
        if case == 2:
            return cr * (s(cr, r - 1) - cr)
        return 1 - cr


def p_contrib(cr: float, r: int, case: int, fast: bool,
              faithful: bool = True) -> float:
    """Eq. 13 / 14 via Proposition 2 (P = P_D + P_S)."""
    if r <= 1:
        return 1 - cr
    return (p_direct(cr, r, case, fast, faithful)
            + p_bypass(cr, r, case, fast, faithful))


def bias_safa(cr_a: float, cr_b: float, C: float, R: float, r: int,
              faithful: bool = True) -> float:
    """Eq. 16."""
    c = case_of(C, R)
    return (p_contrib(cr_a, r, c, True, faithful)
            / p_contrib(cr_b, r, c, False, faithful))


def bias_fedavg(cr_a: float, cr_b: float) -> float:
    """Eq. 12."""
    return (1 - cr_a) / (1 - cr_b)


def bias_curve(cr_a: float, cr_b: float, C: float, R: float, rounds: int,
               faithful: bool = True):
    return np.array([bias_safa(cr_a, cr_b, C, R, r, faithful)
                     for r in range(2, rounds + 2)])
