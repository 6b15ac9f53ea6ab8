"""Exact minimum-cost assignment on the host (numpy).

The counterpart of the JAX package's `utils/native.hungarian`, which calls
the C++ shortest-augmenting-path solver of `native/mvmc_native.cpp`
(`mvmc_hungarian`).  This is a transcription of that solver, vectorised
over the columns: the same float64 operations in the same order
(`(cost[i0] - u[i0]) - v[j]`), the first column on ties (the C++ loop's
strict `<`), and the same transpose when there are more rows than columns.
Its callers (`reid.match_fragments`, `eval.identity_metrics`) pass
BIG-padded or integer matrices full of ties, where another solver (scipy's
`linear_sum_assignment`) can return another optimal assignment and so
change a merge or a score; this one returns the C++ solver's.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _row_assignment(cost: np.ndarray) -> np.ndarray:
    """Column of each row of an n x m cost matrix (n <= m)."""
    n, m = cost.shape
    u = np.zeros(n + 1)
    v = np.zeros(m + 1)
    p = np.zeros(m + 1, dtype=np.int64)    # row matched to column j (1-based)
    way = np.zeros(m + 1, dtype=np.int64)
    cols = np.arange(1, m + 1)
    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = np.full(m + 1, np.inf)
        used = np.zeros(m + 1, dtype=bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            free = cols[~used[1:]]
            cur = (cost[i0 - 1, free - 1] - u[i0]) - v[free]
            better = cur < minv[free]
            minv[free[better]] = cur[better]
            way[free[better]] = j0
            j1 = int(free[np.argmin(minv[free])])
            delta = minv[j1]
            u[p[used]] += delta
            v[used] -= delta
            minv[~used] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    assign = np.full(n, -1, dtype=np.int64)
    matched = np.flatnonzero(p[1:] > 0) + 1
    assign[p[matched] - 1] = matched - 1
    return assign


def hungarian(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Minimum-cost assignment of a finite (n, m) cost matrix; returns
    (rows, cols) like scipy's `linear_sum_assignment`, rows ascending."""
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    n, m = cost.shape
    transposed = n > m
    if transposed:
        cost = np.ascontiguousarray(cost.T)
        n, m = m, n
    assign = _row_assignment(cost) if n else np.zeros(0, dtype=np.int64)
    rows = np.arange(n)[assign >= 0]
    cols = assign[assign >= 0]
    if transposed:
        rows, cols = cols, rows
        order = np.argsort(rows)
        rows, cols = rows[order], cols[order]
    return rows, cols
