"""Sparsity-pattern generators for the RBGP (srmbrep) masker.

Behavioral reference: the reference's pruners/SRMBRepMasker.py:102-334
(``get_ramanujan_pattern`` and ``generate_sparsity_pattern``).  Re-derived
with an explicit ``np.random.Generator`` so patterns are reproducible from a
seed (the reference used the global RNG).

Patterns produce an (M, N) 0/1 matrix with ``nnz_per_row = (1-sparsity)*N``
nonzeros per row (exactly row-regular for all but RANDOM).
"""

from __future__ import annotations

import numpy as np

PATTERNS = (
    "RANDOM",
    "UROW",
    "RAMANUJAN",
    "TRANS",
    "CDIA",
    "CDIASTRIDE",
    "COLUMN",
    "CBAND",
    "CCDIA",
    "CCOLUMN",
    "GROUP",
)


def ramanujan_pattern(
    rows: int,
    cols: int,
    d: int,
    rng: np.random.Generator,
    cross_prob: float = 0.5,
    is_symmetric: bool = False,
) -> np.ndarray:
    """Ramanujan-flavored bipartite pattern by iterative clone-and-lift.

    Start from a dense (rows/2^L, d) seed and repeatedly clone the block to
    the diagonal, then randomly "cross" pairs of edges between the two copies
    with probability ``cross_prob`` — a random 2-lift, which preserves left/
    right regularity and empirically keeps the spectral gap near the
    Ramanujan bound.  Matches SRMBRepMasker.get_ramanujan_pattern semantics.
    """
    assert cols % d == 0, "cols must be a multiple of the degree"
    assert (cols // d) & (cols // d - 1) == 0, "cols/d must be a power of two"
    assert rows // (cols // d) > 0, (
        f"rows too small for the lift count (rows={rows}, cols={cols}, "
        f"d={d}: the clone-and-lift construction needs rows >= cols/d).  "
        "The reference's get_ramanujan_pattern has the identical "
        "constraint (SRMBRepMasker.py:109), so configs that hit this — "
        "e.g. the shipped drn_d_22_1024X768_0.00_87.50.json, whose "
        "layer.1 inner pattern is (4, 8) at d=1 — cannot be generated by "
        "the reference implementation either."
    )
    if is_symmetric:
        assert rows == cols, "symmetric patterns need rows == cols"

    mask = np.zeros((rows, cols), dtype=np.int64)
    cur_rows = rows // (cols // d)
    cur_cols = d
    mask[:cur_rows, :cur_cols] = 1

    while cur_cols < cols:
        mask[cur_rows : 2 * cur_rows, cur_cols : 2 * cur_cols] = mask[
            :cur_rows, :cur_cols
        ]
        for l in range(cur_rows):
            start = l if is_symmetric else 0
            for r in range(start, cur_cols):
                if mask[l, r] == 1 and rng.binomial(1, cross_prob) == 1:
                    mask[l, r] = 0
                    mask[l + cur_rows, r + cur_cols] = 0
                    mask[l, r + cur_cols] = 1
                    mask[l + cur_rows, r] = 1
                    if is_symmetric:
                        mask[r, l] = 0
                        mask[r + cur_cols, l + cur_rows] = 0
                        mask[r + cur_cols, l] = 1
                        mask[r, l + cur_rows] = 1
        cur_rows *= 2
        cur_cols *= 2
    return mask


def _trans_pattern(M: int, N: int, nnz_per_row: int, rng: np.random.Generator) -> np.ndarray:
    """Doubly-regular pattern via permutation unions (sparse regime) or
    max-degree-first edge removal (dense regime).
    SRMBRepMasker.py:195-251 semantics."""
    assert M == N, "TRANS pattern needs a square matrix"
    mask = np.zeros((M, N))
    if nnz_per_row <= int(0.25 * N):
        # Union of nnz_per_row random disjoint permutation matrices.
        x = np.arange(M)
        for _ in range(nnz_per_row):
            while True:
                y = rng.permutation(M)
                if mask[x, y].sum() == 0:
                    mask[x, y] = 1
                    break
        return mask
    # Dense: start full, remove (N - nnz_per_row) edges per row, always from
    # the currently highest-degree columns, keeping column degrees balanced.
    mask += 1
    v_degrees = np.full(N, M, dtype=int)
    num_disconn = N - nnz_per_row
    for u in range(M):
        chosen = np.zeros(N, dtype=bool)
        for _ in range(num_disconn):
            avail = (~chosen) & (v_degrees > nnz_per_row)
            cand = np.flatnonzero(avail)
            degs = v_degrees[cand]
            top = cand[degs == degs.max()]
            v = int(rng.choice(top))
            mask[u, v] = 0
            chosen[v] = True
            v_degrees[v] -= 1
    return mask


def generate_sparsity_pattern(
    M: int,
    N: int,
    sparsity: float,
    pattern: str,
    rng: np.random.Generator,
    cross_prob: float = 0.5,
    is_symmetric: bool = False,
) -> np.ndarray:
    """Generate an (M, N) 0/1 pattern at the given sparsity.

    Pattern semantics mirror SRMBRepMasker.generate_sparsity_pattern
    (SRMBRepMasker.py:171-334).
    """
    nnz = M * int((1.0 - sparsity) * N)
    nnz_per_row = nnz // M
    mask = np.zeros((M, N))

    if sparsity == 0:
        mask[:] = 1
        return mask

    if pattern == "RANDOM":
        flat = rng.choice(M * N, nnz, replace=False)
        mask.reshape(-1)[flat] = 1
    elif pattern == "UROW":
        assert nnz % M == 0
        for i in range(M):
            mask[i, rng.choice(N, nnz_per_row, replace=False)] = 1
    elif pattern == "RAMANUJAN":
        mask = ramanujan_pattern(M, N, nnz_per_row, rng, cross_prob, is_symmetric)
    elif pattern == "TRANS":
        assert nnz % M == 0
        mask = _trans_pattern(M, N, nnz_per_row, rng)
    elif pattern == "CDIA":
        assert nnz % M == 0
        base = rng.choice(N, nnz_per_row, replace=False)
        for i in range(M):
            mask[i, (i + base) % N] = 1
    elif pattern == "CDIASTRIDE":
        assert nnz % M == 0
        stride = N // nnz_per_row
        base = np.arange(0, N, stride)
        for i in range(M):
            mask[i, (i + base) % N] = 1
    elif pattern == "COLUMN":
        assert nnz % M == 0
        mask[:, rng.choice(N, nnz_per_row, replace=False)] = 1
    elif pattern == "CBAND":
        assert nnz % M == 0
        k = nnz_per_row // 2
        base = (np.arange(-k, k) + N) % N
        for i in range(M):
            mask[i, (i + base) % N] = 1
    elif pattern == "CCDIA":
        assert nnz % M == 0
        base = np.arange(nnz_per_row)
        for i in range(M):
            mask[i, (i + base) % N] = 1
    elif pattern == "CCOLUMN":
        assert nnz % M == 0
        mask[:, :nnz_per_row] = 1
    elif pattern == "GROUP":
        num_groups = N // nnz_per_row
        sh, sw = M // num_groups, nnz_per_row
        for g in range(num_groups):
            mask[g * sh : (g + 1) * sh, g * sw : (g + 1) * sw] = 1
    else:
        raise ValueError(f"Unsupported pattern {pattern!r}")
    return mask
