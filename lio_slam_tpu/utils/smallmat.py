"""Tiny fixed-size linear algebra, unrolled.

XLA lowers `jnp.linalg.solve` / `jnp.linalg.eigh` on a 6x6 through its
general batched LAPACK-style machinery (blocked triangular solves, iterative
eigensolver) — a long chain of small kernels for a single 6x6, inside the
per-scan GN loop (`ops/registration.py`).  The
reference does these with OpenCV `cv::solve(QR)` and `cv::eigen`
(`src/liorf/src/mapOptmization.cpp:1781-1808`) on the CPU where small dense
ops are cheap; the equivalent here is fully unrolled scalar code that
XLA schedules as a short dependency chain (~a few us).

All functions are pure jnp, shape-generic over leading batch dims, and
differentiable.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def cholesky_solve(A: jax.Array, b: jax.Array, eps: float = 0.0) -> jax.Array:
    """Solve A x = b for symmetric positive-definite A (n x n, n static and
    small — fully unrolled).  `eps` adds Tikhonov damping to the diagonal.

    Equivalent of the GN normal-equation solve `cv::solve(matAtA, matAtB, QR)`
    (mapOptmization.cpp:1784) — PSD by construction there.
    """
    n = A.shape[-1]
    A = A + eps * jnp.eye(n, dtype=A.dtype)
    # unrolled Cholesky A = L L^T
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, 1e-30))
            else:
                L[i][j] = s / L[j][j]
    # forward substitution L y = b
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    # back substitution L^T x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1)


def cholesky_solve_mat(A: jax.Array, B: jax.Array, eps: float = 0.0) -> jax.Array:
    """Solve A X = B for SPD A (n x n) with matrix RHS B (n x m), fully
    unrolled like `cholesky_solve` (batched over leading dims)."""
    n = A.shape[-1]
    m = B.shape[-1]
    A = A + eps * jnp.eye(n, dtype=A.dtype)
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, 1e-30))
            else:
                L[i][j] = s / L[j][j]
    cols = []
    for c in range(m):
        y = [None] * n
        for i in range(n):
            s = B[..., i, c]
            for k in range(i):
                s = s - L[i][k] * y[k]
            y[i] = s / L[i][i]
        x = [None] * n
        for i in reversed(range(n)):
            s = y[i]
            for k in range(i + 1, n):
                s = s - L[k][i] * x[k]
            x[i] = s / L[i][i]
        cols.append(jnp.stack(x, axis=-1))
    return jnp.stack(cols, axis=-1)


def eigh_jacobi(A: jax.Array, sweeps: int = 8):
    """Symmetric eigendecomposition by cyclic Jacobi rotations, fully
    unrolled (n static, small; `sweeps` full sweeps are plenty for n<=6 —
    off-diagonal norm falls quadratically).

    Returns (eigenvalues ascending, eigenvectors as columns) matching
    `jnp.linalg.eigh` conventions.  Replaces the degeneracy-gate
    eigendecomposition (mapOptmization.cpp:1786-1808 `cv::eigen`).
    """
    n = A.shape[-1]
    dtype = A.dtype
    V = jnp.broadcast_to(jnp.eye(n, dtype=dtype), A.shape)

    def rotate(AV, pq):
        A, V = AV
        p, q = pq
        app = A[..., p, p]
        aqq = A[..., q, q]
        apq = A[..., p, q]
        # stable rotation angle: theta = (aqq - app) / (2 apq)
        small = jnp.abs(apq) < 1e-30
        theta = (aqq - app) / (2.0 * jnp.where(small, 1.0, apq))
        sign = jnp.where(theta >= 0.0, 1.0, -1.0).astype(dtype)
        t = sign / (jnp.abs(theta) + jnp.sqrt(theta * theta + 1.0))
        t = jnp.where(small, 0.0, t)
        c = 1.0 / jnp.sqrt(t * t + 1.0)
        s = t * c
        # G = I with [pp,pq;qp,qq] = [c,s;-s,c]; A <- G^T A G, V <- V G
        rp = A[..., p, :]
        rq = A[..., q, :]
        A = A.at[..., p, :].set(c * rp - s * rq)
        A = A.at[..., q, :].set(s * rp + c * rq)
        cp = A[..., :, p]
        cq = A[..., :, q]
        A = A.at[..., :, p].set(c * cp - s * cq)
        A = A.at[..., :, q].set(s * cp + c * cq)
        vp = V[..., :, p]
        vq = V[..., :, q]
        V = V.at[..., :, p].set(c * vp - s * vq)
        V = V.at[..., :, q].set(s * vp + c * vq)
        return A, V

    for _ in range(sweeps):
        for p in range(n):
            for q in range(p + 1, n):
                A, V = rotate((A, V), (p, q))

    w = jnp.diagonal(A, axis1=-2, axis2=-1)
    order = jnp.argsort(w, axis=-1)
    w = jnp.take_along_axis(w, order, axis=-1)
    V = jnp.take_along_axis(V, order[..., None, :], axis=-1)
    return w, V
