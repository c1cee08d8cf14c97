"""Ramanujan-graph spectral analysis of sparsity masks (the port's copy of
``tpuseg/tools/spectral.py``; numpy only).

Behavioral reference: the reference's tools/calculate_spectral_gap.py:16-67
(bipartite adjacency from a layer mask, eigendecomposition, gap normalized by
the Ramanujan bound sqrt(d_l - 1) + sqrt(d_r - 1)) and
tools/create_rambs4_graph.py + tools/analyze_eigvalues.py (Kronecker-product
eigenvalue structure).
"""

from __future__ import annotations

import numpy as np


def mask_bipartite_adjacency(mask2d: np.ndarray) -> np.ndarray:
    """Bipartite adjacency [[0, M], [M^T, 0]] of a 0/1 mask matrix."""
    m, n = mask2d.shape
    adj = np.zeros((m + n, m + n))
    adj[:m, m:] = mask2d
    adj[m:, :m] = mask2d.T
    return adj


def calculate_spectral_gap(mask: np.ndarray, assert_regular: bool = False):
    """Spectral gap of the mask's bipartite graph.

    Matches the reference definitions (calculate_spectral_gap.py:40-49):
    conv masks are collapsed to (OFM, IFM) by summing the kernel dims;
    lambda_1/lambda_2 are the top-2 *signed* eigenvalues; the gap is
    lambda_1 - lambda_2, normalized by (lambda_1 - ramanujan_bound) with
    bound = sqrt(d_l - 1) + sqrt(d_r - 1).  normalized_gap >= 1 means the
    mask is Ramanujan-quality.
    """
    if mask.ndim >= 4:
        mask = np.abs(mask).sum(axis=tuple(range(2, mask.ndim)))
    mask2d = (mask.reshape(mask.shape[0], -1) != 0).astype(np.float64)
    d_l = mask2d.sum(axis=1)
    d_r = mask2d.sum(axis=0)
    if assert_regular:
        assert np.all(d_l == d_l[0]), "Graph is irregular from left"
        assert np.all(d_r == d_r[0]), "Graph is irregular from right"
    adj = mask_bipartite_adjacency(mask2d)
    evals = np.sort(np.linalg.eigvalsh(adj))
    lam1, lam2 = evals[-1], evals[-2]
    bound = np.sqrt(max(d_l.mean() - 1, 0)) + np.sqrt(max(d_r.mean() - 1, 0))
    gap = lam1 - lam2
    denom = lam1 - bound
    return {
        "lambda1": float(lam1),
        "lambda2": float(lam2),
        "spectral_gap": float(gap),
        "d_left": float(d_l.mean()),
        "d_right": float(d_r.mean()),
        "ramanujan_bound": float(bound),
        "normalized_gap": float(gap / denom) if denom > 0 else float("inf"),
    }


def kronecker_eigen_check(a_mask: np.ndarray, b_mask: np.ndarray, k: int = 4):
    """Verify the graph-product eigenvalue property the RBGP construction
    relies on: singular values of A (x) B are the outer products of the
    factors' singular values (analyze_eigvalues.py)."""
    sa = np.linalg.svd(a_mask.astype(float), compute_uv=False)
    sb = np.linalg.svd(b_mask.astype(float), compute_uv=False)
    prod = np.sort(np.outer(sa, sb).ravel())[::-1]
    kron = np.linalg.svd(np.kron(a_mask, b_mask).astype(float), compute_uv=False)
    kron = np.sort(kron)[::-1]
    k = min(k, len(kron), len(prod))
    return np.allclose(prod[:k], kron[:k], atol=1e-8), prod[:k], kron[:k]
