"""Monte-Carlo helpers: MIS heuristics, discrete CDF sampling with sample reuse.

Counterpart of reference ``Math/MonteCarlo.h`` (balance/power heuristics at
Math/MonteCarlo.h:24-33) and the CDF `sampleReuse` machinery used for light
selection (Engine/KernelDynamicScene.cu:25-46).
"""
from __future__ import annotations

import jax.numpy as jnp


def balance_heuristic(n_f, pdf_f, n_g, pdf_g):
    f = n_f * pdf_f
    g = n_g * pdf_g
    return f / jnp.maximum(f + g, 1e-20)


def power_heuristic(n_f, pdf_f, n_g, pdf_g):
    """Veach power heuristic with beta=2 (the reference's default for PT MIS)."""
    f = n_f * pdf_f
    g = n_g * pdf_g
    return (f * f) / jnp.maximum(f * f + g * g, 1e-20)


def mis_weight(pdf_a, pdf_b):
    """Power-heuristic weight for strategy a vs b with one sample each."""
    return power_heuristic(1.0, pdf_a, 1.0, pdf_b)


def build_cdf(weights, axis: int = -1):
    """Normalized inclusive CDF; returns (cdf, total). Zero-total maps to uniform."""
    w = jnp.maximum(weights, 0.0)
    total = jnp.sum(w, axis=axis, keepdims=True)
    n = w.shape[axis]
    uniform = jnp.cumsum(jnp.ones_like(w), axis=axis) / n
    cdf = jnp.where(total > 0.0, jnp.cumsum(w, axis=axis) / jnp.maximum(total, 1e-30), uniform)
    return cdf, jnp.squeeze(total, axis=axis)


def sample_discrete(cdf, u):
    """Sample index from an inclusive normalized CDF (last axis).

    Returns (index, pmf, u_reused) where u_reused is the sample rescaled to
    [0,1) within the chosen bin — the reference's `sampleReuse` trick
    (Engine/KernelDynamicScene.cu:33-40) that lets one random number drive both
    the discrete choice and a continuous follow-up sample.
    """
    u = jnp.asarray(u)
    n = cdf.shape[-1]
    cdf_b = jnp.broadcast_to(cdf, u.shape + (n,))
    # The last entry never counts as "below": this bakes the idx<=n-1 clip in,
    # so u >= cdf[-1] (fp slack) still lands in the final bin.
    below = (cdf_b < u[..., None]) & (jnp.arange(n) < n - 1)
    idx = jnp.sum(below.astype(jnp.int32), axis=-1)
    # hi = cdf[idx], lo = cdf[idx-1] (0 if idx==0). The CDF is sorted, so both
    # are masked min/max reductions over the (broadcast) entries — pure vector
    # ops instead of a take_along_axis gather on the minor axis.
    hi = jnp.min(jnp.where(below, jnp.inf, cdf_b), axis=-1)
    lo = jnp.max(jnp.where(below, cdf_b, 0.0), axis=-1)
    pmf = jnp.maximum(hi - lo, 0.0)
    u_reused = jnp.clip((u - lo) / jnp.maximum(pmf, 1e-20), 0.0, 1.0 - 1e-7)
    return idx, pmf, u_reused


def russian_roulette_prob(throughput_max, depth, start_depth: int, cap: float = 0.95):
    """Continuation probability: min(max throughput, cap) after start_depth
    (reference PathTracer.cu:91-96 uses throughput-based RR from depth 5)."""
    p = jnp.minimum(throughput_max, cap)
    return jnp.where(depth >= start_depth, p, 1.0)
