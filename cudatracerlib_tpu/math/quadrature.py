"""Gauss-Legendre / Gauss-Lobatto quadrature.

Counterpart of reference ``Math/Integrator.h:49-107`` (adaptive
GaussLobattoIntegrator) and ``gaussLegendre``/``gaussLobatto`` node tables
(``Math/Integrator.cu``).

Design translation: the reference's recursive *adaptive* subdivision is
data-dependent control flow — hostile to XLA. Here quadrature is a fixed
composite rule: `n_panels` sub-intervals, each integrated with a 7-point
Gauss-Lobatto rule, fully vectorized over both panels and any batch axes of
the integrand. For the smooth transmittance/σ_t integrands this framework
needs, 4-16 panels already exceed the reference's adaptive tolerance; error
control is by panel count (a static knob) instead of recursion.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# 7-point Gauss-Lobatto nodes/weights on [-1, 1] (degree-9 exactness).
# Nodes are the reference's m_alpha/m_beta/x1..x3 constants (Integrator.h:12-16).
_GL7_NODES = np.array(
    [-1.0, -np.sqrt(2.0 / 3.0), -1.0 / np.sqrt(5.0), 0.0,
     1.0 / np.sqrt(5.0), np.sqrt(2.0 / 3.0), 1.0],
    np.float64,
)
# Weights solve the Vandermonde system so monomials x^0..x^6 integrate exactly.
_V = np.vander(_GL7_NODES, 7, increasing=True).T
_m = np.array([(1.0 - (-1.0) ** (k + 1)) / (k + 1) for k in range(7)])
_GL7_WEIGHTS = np.linalg.solve(_V, _m)


def gauss_legendre(n: int):
    """Nodes/weights of the n-point Gauss-Legendre rule on [-1,1] (host-side)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return jnp.asarray(x, jnp.float32), jnp.asarray(w, jnp.float32)


def gauss_lobatto(n: int):
    """Nodes/weights of the n-point Gauss-Lobatto rule on [-1,1] (host-side).

    Endpoints included (reference ``gaussLobatto``, Integrator.cu). Interior
    nodes are roots of P'_{n-1}; weights 2/(n(n-1) P_{n-1}(x)^2).
    """
    if n < 2:
        raise ValueError("Gauss-Lobatto needs n >= 2")
    # interior nodes: roots of derivative of Legendre P_{n-1}
    c = np.zeros(n)
    c[-1] = 1.0
    dP = np.polynomial.legendre.legder(c)
    xi = np.polynomial.legendre.legroots(dP)
    x = np.concatenate([[-1.0], np.sort(xi), [1.0]])
    Pn1 = np.polynomial.legendre.legval(x, c)
    w = 2.0 / (n * (n - 1) * Pn1**2)
    return jnp.asarray(x, jnp.float32), jnp.asarray(w, jnp.float32)


def integrate(f, a, b, n_panels: int = 8):
    """Composite 7-point Gauss-Lobatto integral of `f` over [a, b].

    `f` maps an array of sample positions (broadcast over the batch shape of
    a/b plus a trailing quadrature axis) to integrand values. a, b may be
    batched; returns an array of the broadcast batch shape. Differentiable in
    everything (a, b, and f's parameters).
    """
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    nodes = jnp.asarray(_GL7_NODES, jnp.float32)
    weights = jnp.asarray(_GL7_WEIGHTS, jnp.float32)
    # panel edges: (..., P+1)
    t = jnp.linspace(0.0, 1.0, n_panels + 1, dtype=jnp.float32)
    lo = a[..., None] + (b - a)[..., None] * t[:-1]
    hi = a[..., None] + (b - a)[..., None] * t[1:]
    mid = 0.5 * (lo + hi)
    half = 0.5 * (hi - lo)
    # sample positions: (..., P, 7)
    x = mid[..., None] + half[..., None] * nodes
    fx = f(x)
    panel = jnp.sum(fx * weights, axis=-1) * half
    return jnp.sum(panel, axis=-1)
