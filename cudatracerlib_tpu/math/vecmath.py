"""Vector math over trailing-dim-3 jnp arrays.

Counterpart of the reference's ``Math/Vector.h`` / ``Math/MathFunc.h``
(CudaTracerLib, see /root/reference/Math/Vector.h). Instead of a Vec3f class we
use plain ``jnp.ndarray`` with shape ``(..., 3)`` so everything vmaps/shards and
XLA fuses elementwise chains into single VPU loops.

All functions are pure and differentiable unless noted.
"""
from __future__ import annotations

import jax.numpy as jnp
import jax

EPS = 1e-6
INF = jnp.inf
PI = float(jnp.pi)
INV_PI = 1.0 / PI
INV_TWOPI = 1.0 / (2.0 * PI)
INV_FOURPI = 1.0 / (4.0 * PI)


def vec3(x, y, z, dtype=jnp.float32):
    return jnp.stack([jnp.asarray(x, dtype), jnp.asarray(y, dtype), jnp.asarray(z, dtype)], axis=-1)


def dot(a, b, keepdims: bool = False):
    return jnp.sum(a * b, axis=-1, keepdims=keepdims)


def absdot(a, b, keepdims: bool = False):
    return jnp.abs(dot(a, b, keepdims))


def cross(a, b):
    return jnp.cross(a, b)


def length(v, keepdims: bool = False):
    return jnp.sqrt(jnp.maximum(dot(v, v, keepdims), 0.0))


def length_sqr(v, keepdims: bool = False):
    return dot(v, v, keepdims)


def normalize(v):
    """Safe normalize; returns v/|v| (0 stays 0)."""
    l2 = dot(v, v, keepdims=True)
    return v * jax.lax.rsqrt(jnp.maximum(l2, 1e-20))


def distance(a, b):
    return length(a - b)


def distance_sqr(a, b):
    return length_sqr(a - b)


def lerp(a, b, t):
    return a + (b - a) * t


def clamp(x, lo, hi):
    return jnp.clip(x, lo, hi)


def saturate(x):
    return jnp.clip(x, 0.0, 1.0)


def safe_sqrt(x):
    """sqrt clamped away from 0 so the backward pass never produces inf
    (0 * inf = NaN poisons masked-branch gradients)."""
    return jnp.sqrt(jnp.maximum(x, 1e-20))


def safe_acos(x):
    return jnp.arccos(jnp.clip(x, -1.0 + 1e-7, 1.0 - 1e-7))


def sqr(x):
    return x * x


def reflect(w, n):
    """Mirror reflection of direction ``w`` about normal ``n`` (both pointing away
    from surface, Mitsuba convention as in reference BSDF_Simple.h)."""
    return 2.0 * dot(w, n, keepdims=True) * n - w


def refract(w, n, eta, cos_theta_t):
    """Refract ``w`` about ``n`` given relative IOR ``eta`` (eta_i/eta_t applied
    signwise by caller) and the transmitted cosine (signed, from fresnel_dielectric)."""
    cos_theta_i = dot(w, n, keepdims=True)
    ct = jnp.asarray(cos_theta_t)
    if ct.ndim < cos_theta_i.ndim:
        ct = ct[..., None]
    eta_ = jnp.asarray(eta)
    if eta_.ndim < cos_theta_i.ndim:
        eta_ = eta_[..., None]
    return n * (cos_theta_i * eta_ + ct) - w * eta_


def face_forward(n, ref):
    """Flip n so it lies in the same hemisphere as ref."""
    s = jnp.sign(dot(n, ref, keepdims=True))
    s = jnp.where(s == 0.0, 1.0, s)
    return n * s


def spherical_direction(sin_theta, cos_theta, phi):
    return jnp.stack(
        [sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), cos_theta], axis=-1
    )


def spherical_coordinates(d):
    """Direction -> (theta, phi) with phi in [0, 2pi)."""
    theta = safe_acos(d[..., 2])
    phi = jnp.arctan2(d[..., 1], d[..., 0])
    phi = jnp.where(phi < 0.0, phi + 2.0 * PI, phi)
    return theta, phi


def coordinate_system(n):
    """Branchless orthonormal basis from a unit vector (Duff et al. 2017).

    Returns (s, t) with (s, t, n) right-handed orthonormal. Counterpart of
    reference ``Math/Frame.h`` constructor.
    """
    sign = jnp.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    s = jnp.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]], axis=-1
    )
    t = jnp.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], axis=-1)
    return s, t


def max3(v):
    return jnp.max(v, axis=-1)


def min3(v):
    return jnp.min(v, axis=-1)


def mean3(v):
    return jnp.mean(v, axis=-1)


def is_finite(v):
    return jnp.all(jnp.isfinite(v), axis=-1)
