"""Batched on-line EM Gaussian mixture models.

Counterpart of reference ``Kernel/ParametricModels/GaussianMixtureModel.h``
(416 LoC: D-dimensional GMMs fitted with on-line/stepwise EM, qMatrix-based
Cholesky sampling, per-grid-cell instances). Design translation: all cells
fit *in parallel* — the model state is a struct-of-arrays over (C cells,
K components, D dims), the E-step is a batched responsibility computation, and
the M-step is a segment-sum over samples binned to cells, blended with the
stepwise-EM learning rate eta = (t+1)^-alpha (Cappé & Moulines; the reference
uses the same scheme). No loops over cells, no per-cell objects.

Used for path guiding (fit incoming-radiance direction distributions per
spatial cell) and any density-estimation task the reference's GMM served.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..math.vecmath import PI


class GMM(NamedTuple):
    weight: jnp.ndarray   # (C, K) mixture weights (sum to 1 per cell)
    mean: jnp.ndarray     # (C, K, D)
    cov: jnp.ndarray      # (C, K, D, D)
    # sufficient-statistic accumulators for stepwise EM
    sw: jnp.ndarray       # (C, K) accumulated responsibility mass
    t: jnp.ndarray        # (C,) update counter


def gmm_init(n_cells: int, n_components: int, dim: int,
             spread: float = 0.25, domain: float = 1.0) -> GMM:
    """Deterministic initialization: means on a low-discrepancy lattice over
    [0, domain]^D, isotropic covariances (the reference seeds from a uniform
    prior too)."""
    C, K, D = n_cells, n_components, dim
    # Halton-like lattice for the K means (replayable, no RNG needed)
    idx = jnp.arange(K, dtype=jnp.float32) + 0.5
    cols = []
    base = jnp.asarray([2, 3, 5, 7, 11, 13], jnp.float32)
    for d in range(D):
        b = base[d % base.shape[0]]
        # radical inverse approximation: golden-ratio style lattice
        cols.append(jnp.mod(idx * jnp.mod(jnp.sqrt(b), 1.0), 1.0))
    means = jnp.stack(cols, -1) * domain                      # (K, D)
    cov = jnp.eye(D) * (spread * domain) ** 2
    return GMM(
        weight=jnp.full((C, K), 1.0 / K, jnp.float32),
        mean=jnp.broadcast_to(means, (C, K, D)).astype(jnp.float32),
        cov=jnp.broadcast_to(cov, (C, K, D, D)).astype(jnp.float32),
        sw=jnp.zeros((C, K), jnp.float32),
        t=jnp.zeros((C,), jnp.float32),
    )


def _log_gauss(x, mean, cov):
    """log N(x | mean, cov) batched over leading axes."""
    D = x.shape[-1]
    diff = x - mean
    chol = jnp.linalg.cholesky(cov)
    sol = jax.scipy.linalg.solve_triangular(chol, diff[..., None], lower=True)[..., 0]
    maha = jnp.sum(sol * sol, axis=-1)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)), axis=-1)
    return -0.5 * (maha + logdet + D * jnp.log(2.0 * PI))


def gmm_pdf(gmm: GMM, cell_id, x):
    """Mixture pdf at x (..., D) in cells cell_id (...,)."""
    w = gmm.weight[cell_id]                    # (..., K)
    mu = gmm.mean[cell_id]                     # (..., K, D)
    cov = gmm.cov[cell_id]
    lg = _log_gauss(x[..., None, :], mu, cov)  # (..., K)
    return jnp.sum(w * jnp.exp(lg), axis=-1)


def gmm_em_step(gmm: GMM, cell_id, x, sample_weight, alpha: float = 0.7,
                min_var: float = 1e-4) -> GMM:
    """One stepwise-EM mini-batch update.

    cell_id (N,) int32, x (N, D), sample_weight (N,) >= 0 (e.g. radiance).
    eta = (t+1)^-alpha per cell; cells receiving no samples are unchanged.
    """
    C, K, D = gmm.mean.shape

    # E-step: responsibilities under the current model
    w = gmm.weight[cell_id]                       # (N, K)
    mu = gmm.mean[cell_id]
    cov = gmm.cov[cell_id]
    lg = _log_gauss(x[:, None, :], mu, cov)       # (N, K)
    logr = jnp.log(jnp.maximum(w, 1e-12)) + lg
    logr = logr - jax.scipy.special.logsumexp(logr, axis=-1, keepdims=True)
    r = jnp.exp(logr) * sample_weight[:, None]    # weighted responsibilities

    # M-step sufficient statistics per (cell, component) via segment sums
    seg = cell_id
    s0 = jax.ops.segment_sum(r, seg, num_segments=C)                    # (C, K)
    s1 = jax.ops.segment_sum(r[..., None] * x[:, None, :], seg, C)      # (C, K, D)
    xxT = x[:, None, :, None] * x[:, None, None, :]                     # (N,1,D,D)
    s2 = jax.ops.segment_sum(r[..., None, None] * xxT, seg, C)          # (C, K, D, D)
    n_cell = jax.ops.segment_sum(sample_weight, seg, C)                 # (C,)

    got = n_cell > 0
    eta = jnp.where(got, (gmm.t + 1.0) ** (-alpha), 0.0)                # (C,)

    # blend accumulators (stepwise EM): sw' = (1-eta) sw + eta s0-normalized
    tot = jnp.maximum(jnp.sum(s0, axis=-1, keepdims=True), 1e-12)
    w_new = (1.0 - eta[:, None]) * gmm.weight + eta[:, None] * (s0 / tot)
    w_new = w_new / jnp.maximum(jnp.sum(w_new, -1, keepdims=True), 1e-12)

    mean_batch = s1 / jnp.maximum(s0[..., None], 1e-12)
    mu_new = jnp.where(
        (got[:, None] & (s0 > 1e-9))[..., None],
        (1.0 - eta[:, None, None]) * gmm.mean + eta[:, None, None] * mean_batch,
        gmm.mean,
    )
    cov_batch = s2 / jnp.maximum(s0[..., None, None], 1e-12) \
        - mean_batch[..., :, None] * mean_batch[..., None, :]
    cov_new = jnp.where(
        (got[:, None] & (s0 > 1e-9))[..., None, None],
        (1.0 - eta[:, None, None, None]) * gmm.cov
        + eta[:, None, None, None] * cov_batch,
        gmm.cov,
    )
    # regularize: keep covariances SPD (reference clamps eigenvalues too)
    cov_new = cov_new + jnp.eye(D) * min_var

    return GMM(
        weight=w_new, mean=mu_new, cov=cov_new,
        sw=gmm.sw + s0,
        t=gmm.t + got.astype(jnp.float32),
    )


def gmm_sample(gmm: GMM, cell_id, u_select, u_gauss):
    """Draw one sample per entry: u_select (...,) uniform picks the component
    via the weight CDF, u_gauss (..., D) standard normals map through the
    Cholesky factor (the reference's qMatrix Cholesky sampling)."""
    w = gmm.weight[cell_id]                       # (..., K)
    cdf = jnp.cumsum(w, axis=-1)
    k = jnp.sum((cdf < u_select[..., None]).astype(jnp.int32), axis=-1)
    k = jnp.minimum(k, w.shape[-1] - 1)
    mu = jnp.take_along_axis(gmm.mean[cell_id], k[..., None, None], axis=-2)[..., 0, :]
    cov = jnp.take_along_axis(
        gmm.cov[cell_id], k[..., None, None, None], axis=-3)[..., 0, :, :]
    chol = jnp.linalg.cholesky(cov)
    return mu + jnp.einsum("...ij,...j->...i", chol, u_gauss,
                           precision=jax.lax.Precision.HIGHEST)
