"""Time-domain batch-size/convergence model (paper §4.5, Eq. 21–24).

t_iter = n_b/C1 + C2 (compute + synchronization); after T = t/t_iter updates
the loss bound is ψ ≤ 1/sqrt(n_b·T) + 1/T (Dekel et al.).  Solving for the
time t that reaches a target ψ gives the predicted training time as a
function of batch size, with an interior optimum (Fig. 5).

A copy of ``repro.core.batch_model`` (numpy only; the port imports nothing
of ``repro``); ``tests/test_torch_trainer.py`` holds its four functions
equal to the original on a grid.
"""
from __future__ import annotations

import numpy as np


def iter_time(n_b, c1: float, c2: float):
    """Eq. 21: seconds per gradient update."""
    return np.asarray(n_b, float) / c1 + c2


def loss_bound(n_b, T):
    """Eq. 23 with equality."""
    n_b = np.asarray(n_b, float)
    T = np.asarray(T, float)
    return 1.0 / np.sqrt(n_b * T) + 1.0 / T


def predicted_time_to_loss(n_b, psi: float, c1: float, c2: float,
                           t_max: float = 1e9):
    """Smallest t with loss_bound(n_b, t/t_iter) <= psi (numeric, per Eq. 24)."""
    n_b = np.asarray(n_b, float)
    ti = iter_time(n_b, c1, c2)

    def solve_one(nb, t1):
        lo, hi = t1, t_max
        if loss_bound(nb, hi / t1) > psi:
            return np.inf
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            if loss_bound(nb, mid / t1) <= psi:
                hi = mid
            else:
                lo = mid
        return hi

    return np.array([solve_one(nb, t1) for nb, t1 in
                     zip(np.atleast_1d(n_b), np.atleast_1d(ti))])


def optimal_batch_size(psi: float, c1: float, c2: float,
                       candidates=None) -> int:
    """argmin over candidate batch sizes of the predicted training time."""
    if candidates is None:
        candidates = np.arange(50, 3050, 50)
    times = predicted_time_to_loss(candidates, psi, c1, c2)
    return int(candidates[int(np.argmin(times))])
