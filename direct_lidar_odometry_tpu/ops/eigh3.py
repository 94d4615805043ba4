"""Closed-form symmetric 3x3 eigen-analysis, batched.

The reference runs one LAPACK ``JacobiSVD`` per point to regularize GICP
covariances (``nano_gicp_impl.hpp:332-352``). Iterative per-matrix
factorizations batch poorly as array programs; for symmetric 3x3 we instead
use the trigonometric (Cardano) closed form for eigenvalues and
cross-product eigenvectors — pure elementwise math that XLA fuses, fully
vmappable.

Under PLANE regularization only the *smallest* eigenvector (the surface
normal) matters, since the regularized covariance is
``R diag(1, 1, eps) R^T = I - (1 - eps) n n^T``.
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-12


def eigvalsh3(a: jnp.ndarray) -> jnp.ndarray:
    """Eigenvalues of symmetric [..., 3, 3], ascending. Trigonometric method."""
    a00, a11, a22 = a[..., 0, 0], a[..., 1, 1], a[..., 2, 2]
    a01, a02, a12 = a[..., 0, 1], a[..., 0, 2], a[..., 1, 2]
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, _EPS))
    # det(B) / 2 with B = (A - qI)
    detb = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    )
    r = jnp.clip(detb / (2.0 * p * p * p), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    e_hi = q + 2.0 * p * jnp.cos(phi)
    e_lo = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    return jnp.stack([e_lo, e_mid, e_hi], axis=-1)


def _eigvec_for(a: jnp.ndarray, lam: jnp.ndarray) -> jnp.ndarray:
    """Eigenvector of symmetric [..., 3, 3] for eigenvalue lam [...].

    Rows of (A - lam I) span the orthogonal complement of the eigenvector;
    the eigenvector is the largest cross product of row pairs. Degenerate
    (repeated-eigenvalue) cases fall back to a fixed axis orthogonalized
    against nothing — callers treat those neighborhoods as isotropic anyway.
    """
    m = a - lam[..., None, None] * jnp.eye(3, dtype=a.dtype)
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    c01 = jnp.cross(r0, r1)
    c02 = jnp.cross(r0, r2)
    c12 = jnp.cross(r1, r2)
    n01 = jnp.sum(c01 * c01, axis=-1)
    n02 = jnp.sum(c02 * c02, axis=-1)
    n12 = jnp.sum(c12 * c12, axis=-1)
    norms = jnp.stack([n01, n02, n12], axis=-1)
    best = jnp.argmax(norms, axis=-1)
    cands = jnp.stack([c01, c02, c12], axis=-2)  # [..., 3cand, 3]
    v = jnp.take_along_axis(cands, best[..., None, None].astype(jnp.int32), axis=-2)[
        ..., 0, :
    ]
    nrm = jnp.linalg.norm(v, axis=-1, keepdims=True)
    v = jnp.where(nrm > 1e-12, v / jnp.maximum(nrm, _EPS), jnp.asarray([0.0, 0.0, 1.0], a.dtype))
    return v


def smallest_eigvec3(a: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(unit eigenvector of the smallest eigenvalue, eigenvalues ascending)."""
    evals = eigvalsh3(a)
    v = _eigvec_for(a, evals[..., 0])
    return v, evals
