"""Pixel debug visualizers: per-pixel auxiliary buffers rendered as images or
geometric overlays.

Counterpart of reference ``Kernel/PixelDebugVisualizers/`` — named per-pixel
float/Vec2f/Vec3f buffers (PixelDebugVisualizer.h:70+) with full-image
normalize+colorize passes (FloatPixelDebugVisualizer.cu:9-32) and per-pixel
geometric drawing via ``IDebugDrawer`` (DrawLine/DrawEllipse/DrawCone,
PixelDebugVisualizer.h:15-67).

Design translation: buffers are plain (H, W[, C]) arrays (any AOV dict
entry qualifies); colorization/normalization are jnp image ops; the geometric
overlay drawer is a host-side numpy line rasterizer projecting world-space
segments through the scene camera — visualization tooling is not a hot path,
so it deliberately stays off-device.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# full-image visualization (PixelDebugVisualizer<T>::Visualize)
# ---------------------------------------------------------------------------

def colorize(t):
    """Blue->cyan->green->yellow->red ramp of t in [0,1] (the reference's
    ``colorize`` helper used for normalized scalar buffers)."""
    t = jnp.clip(t, 0.0, 1.0)
    r = jnp.clip(1.5 - jnp.abs(4.0 * t - 3.0), 0.0, 1.0)
    g = jnp.clip(1.5 - jnp.abs(4.0 * t - 2.0), 0.0, 1.0)
    b = jnp.clip(1.5 - jnp.abs(4.0 * t - 1.0), 0.0, 1.0)
    return jnp.stack([r, g, b], axis=-1)


def visualize_scalar(buf, normalize: bool = True, scale: float = 1.0):
    """(H, W) scalar buffer -> (H, W, 3) image
    (FloatPixelDebugVisualizer.cu float_op)."""
    v = jnp.asarray(buf) * scale
    if normalize:
        lo = jnp.min(v)
        hi = jnp.max(v)
        t = (v - lo) / jnp.maximum(hi - lo, 1e-12)
        return colorize(t)
    return jnp.repeat(jnp.clip(v, 0.0, 1.0)[..., None], 3, axis=-1)


def visualize_vec2(buf, normalize: bool = True):
    """(H, W, 2) buffer -> RGB (x, y in RG, magnitude in B)
    (Vec2fPixelDebugVisualizer full-image pass)."""
    v = jnp.asarray(buf)
    if normalize:
        m = jnp.maximum(jnp.max(jnp.abs(v)), 1e-12)
        v = v / m
    mag = jnp.sqrt(jnp.sum(v * v, axis=-1))
    return jnp.stack(
        [v[..., 0] * 0.5 + 0.5, v[..., 1] * 0.5 + 0.5, jnp.clip(mag, 0, 1)],
        axis=-1,
    )


def visualize_vec3(buf, normalize: bool = True):
    """(H, W, 3) buffer -> RGB (direction color-coding, 0.5v+0.5)."""
    v = jnp.asarray(buf)
    if normalize:
        m = jnp.maximum(jnp.max(jnp.abs(v)), 1e-12)
        v = v / m
    return v * 0.5 + 0.5


def overlay(base, aux, alpha: float = 0.5, mask=None):
    """Alpha-blend an auxiliary visualization over a rendered image."""
    base = jnp.asarray(base)
    aux = jnp.asarray(aux)
    out = base * (1 - alpha) + aux * alpha
    if mask is not None:
        out = jnp.where(jnp.asarray(mask)[..., None], out, base)
    return out


# ---------------------------------------------------------------------------
# per-pixel geometric overlays (IDebugDrawer, host-side)
# ---------------------------------------------------------------------------

class DebugDrawer:
    """Rasterizes world-space debug geometry into an (H, W, 3) numpy image.

    The stand-in for the reference ``IDebugDrawer``: DrawEllipse /
    DrawEllipsoid / DrawCone are built from DrawLine exactly like the
    reference's default implementations (PixelDebugVisualizer.h:19-67).
    `project` maps world points -> film uv; build one with
    ``camera_projector(scene.camera)``.
    """

    def __init__(self, image: np.ndarray, project):
        self.img = image
        self.project = project
        self.h, self.w = image.shape[:2]

    def _to_px(self, p):
        uv, ok = self.project(np.asarray(p, np.float64))
        return uv[0] * self.w, uv[1] * self.h, ok

    def draw_line(self, p1, p2, col=(1.0, 0.0, 0.0)):
        x0, y0, ok0 = self._to_px(p1)
        x1, y1, ok1 = self._to_px(p2)
        if not (ok0 or ok1):
            return
        n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) + 1
        xs = np.linspace(x0, x1, n).round().astype(int)
        ys = np.linspace(y0, y1, n).round().astype(int)
        keep = (xs >= 0) & (xs < self.w) & (ys >= 0) & (ys < self.h)
        self.img[ys[keep], xs[keep]] = np.asarray(col, np.float32)

    def draw_ellipse(self, p, t1, t2, l1, l2, col=(1.0, 0.0, 0.0), n: int = 32):
        p, t1, t2 = (np.asarray(a, np.float64) for a in (p, t1, t2))
        ang = np.linspace(0.0, 2 * np.pi, n)
        pts = p + np.outer(l1 * np.cos(ang), t1) + np.outer(l2 * np.sin(ang), t2)
        for a, b in zip(pts[:-1], pts[1:]):
            self.draw_line(a, b, col)
        self.draw_line(p - t1 * l1, p + t1 * l1, col)
        self.draw_line(p - t2 * l2, p + t2 * l2, col)

    def draw_ellipsoid(self, p, t1, t2, t3, l1, l2, l3, col=(1.0, 0.0, 0.0)):
        self.draw_ellipse(p, t1, t2, l1, l2, col)
        self.draw_ellipse(p, t1, t3, l1, l3, col)
        self.draw_ellipse(p, t2, t3, l2, l3, col)

    def draw_cone(self, p, d, theta, length, col=(1.0, 0.0, 0.0), n: int = 16):
        p = np.asarray(p, np.float64)
        d = np.asarray(d, np.float64)
        d = d / max(np.linalg.norm(d), 1e-12)
        c = p + d * length
        rad = length * np.tan(theta / 2.0)
        a = np.array([1.0, 0.0, 0.0]) if abs(d[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
        t1 = np.cross(d, a)
        t1 /= np.linalg.norm(t1)
        t2 = np.cross(d, t1)
        ang = np.linspace(0.0, 2 * np.pi, n)
        rim = c + np.outer(rad * np.cos(ang), t1) + np.outer(rad * np.sin(ang), t2)
        for q1, q2 in zip(rim[:-1], rim[1:]):
            self.draw_line(q1, q2, col)
            self.draw_line(p, q1, col)


def camera_projector(camera):
    """world point -> (film uv, in_frustum) using the scene camera
    (Sensor::sampleDirect projection)."""
    from ..scene import sensors

    def project(p):
        uv, _, _, _, ok = sensors.sample_direct(camera, jnp.asarray(p, jnp.float32))
        return np.asarray(uv, np.float64), bool(np.asarray(ok))

    return project


def draw_vector_field(image, camera, points, vectors, valid=None,
                      stride: int = 8, scale: float = 1.0,
                      col=(1.0, 0.2, 0.2)):
    """Overlay a sparse world-space vector field onto a rendered image —
    the Vec3f visualizer's ``Vector`` per-pixel mode applied on a stride grid
    (the reference draws one pixel at a time; batch-drawing a grid is the
    useful whole-image form of the same tool).

    `points`/`vectors`: (H, W, 3) world positions + vectors per pixel.
    Returns a new numpy image.
    """
    img = np.array(image, np.float32, copy=True)
    drawer = DebugDrawer(img, camera_projector(camera))
    pts = np.asarray(points)
    vecs = np.asarray(vectors)
    h, w = pts.shape[:2]
    for y in range(stride // 2, h, stride):
        for x in range(stride // 2, w, stride):
            if valid is not None and not np.asarray(valid)[y, x]:
                continue
            p = pts[y, x]
            v = vecs[y, x] * scale
            if np.linalg.norm(v) < 1e-12:
                continue
            drawer.draw_line(p, p + v, col)
    return img
