"""Direction <-> packed integer encodings for compact photon storage.

Counterpart of reference ``Math/Compression.h:12-50`` (spherical uint16
encoding used by photon maps and TriangleData). Here these live in uint32
arrays; octahedral encoding is added as the higher-quality default.
"""
from __future__ import annotations

import jax.numpy as jnp

from .vecmath import PI, normalize, safe_sqrt


def encode_spherical_u16(d):
    """Direction -> uint32 holding (theta:8, phi:8)-style 16-bit spherical code
    (reference NormalizedFloat3ToUchar2)."""
    theta = jnp.arccos(jnp.clip(d[..., 2], -1.0, 1.0))
    phi = jnp.arctan2(d[..., 1], d[..., 0])
    phi = jnp.where(phi < 0.0, phi + 2.0 * PI, phi)
    t = jnp.clip(jnp.round(theta / PI * 255.0), 0, 255).astype(jnp.uint32)
    p = jnp.clip(jnp.round(phi / (2.0 * PI) * 255.0), 0, 255).astype(jnp.uint32)
    return t | (p << 8)


def decode_spherical_u16(code):
    code = code.astype(jnp.uint32)
    theta = (code & 0xFF).astype(jnp.float32) / 255.0 * PI
    phi = ((code >> 8) & 0xFF).astype(jnp.float32) / 255.0 * 2.0 * PI
    st = jnp.sin(theta)
    return jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), jnp.cos(theta)], axis=-1)


def _oct_wrap(v):
    return (1.0 - jnp.abs(v[..., ::-1])) * jnp.where(v >= 0.0, 1.0, -1.0)


def encode_octahedral_u32(d):
    """Direction -> uint32 octahedral (16 bits per component)."""
    d = normalize(d)
    denom = jnp.sum(jnp.abs(d), axis=-1, keepdims=True)
    p = d[..., :2] / jnp.maximum(denom, 1e-12)
    p = jnp.where((d[..., 2:3] < 0.0), _oct_wrap(p), p)
    q = jnp.clip(jnp.round((p * 0.5 + 0.5) * 65535.0), 0, 65535).astype(jnp.uint32)
    return q[..., 0] | (q[..., 1] << 16)


def decode_octahedral_u32(code):
    code = code.astype(jnp.uint32)
    x = (code & 0xFFFF).astype(jnp.float32) / 65535.0 * 2.0 - 1.0
    y = ((code >> 16) & 0xFFFF).astype(jnp.float32) / 65535.0 * 2.0 - 1.0
    z = 1.0 - jnp.abs(x) - jnp.abs(y)
    t = jnp.maximum(-z, 0.0)
    x = x - jnp.where(x >= 0.0, t, -t)
    y = y - jnp.where(y >= 0.0, t, -t)
    return normalize(jnp.stack([x, y, z], axis=-1))


def encode_uv_u32(uv):
    """(u, v) in [0,1] -> uint32, 16 bits each (reference TriangleData UV packing)."""
    q = jnp.clip(jnp.round(jnp.mod(uv, 1.0) * 65535.0), 0, 65535).astype(jnp.uint32)
    return q[..., 0] | (q[..., 1] << 16)


def decode_uv_u32(code):
    code = code.astype(jnp.uint32)
    u = (code & 0xFFFF).astype(jnp.float32) / 65535.0
    v = ((code >> 16) & 0xFFFF).astype(jnp.float32) / 65535.0
    return jnp.stack([u, v], axis=-1)
