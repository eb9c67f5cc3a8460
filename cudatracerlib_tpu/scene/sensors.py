"""Camera / sensor models.

Counterpart of reference ``SceneTypes/Sensor.h:527`` (PerspectiveSensor:189,
ThinLensSensor:270, OrthographicSensor:362, SphericalSensor:105,
TelecentricSensor:443). Ray generation is differentiable w.r.t. the
camera-to-world transform, fov and lens parameters (the BASELINE "camera
gradients" axis).

Cameras look down +z in camera space; `to_world` is a (4,4) rigid(+scale)
transform. Film coordinates are (u, v) in [0,1]^2 with (0,0) at the top-left
pixel, matching the reference's image layout.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..math import warp
from ..math.vecmath import PI, normalize

PERSPECTIVE = 0
THINLENS = 1
ORTHOGRAPHIC = 2
SPHERICAL = 3
TELECENTRIC = 4


class Camera(NamedTuple):
    ctype: jnp.ndarray           # () int32
    to_world: jnp.ndarray        # (4, 4) camera-to-world
    tan_half_fov: jnp.ndarray    # () tan(fov_x / 2)
    aspect: jnp.ndarray          # () width / height
    aperture_radius: jnp.ndarray # ()
    focal_distance: jnp.ndarray  # ()
    ortho_scale: jnp.ndarray     # () half-width of ortho/telecentric view

    @staticmethod
    def look_at(origin, target, up=(0.0, 0.0, 1.0), fov_deg: float = 45.0,
                aspect: float = 1.0, ctype: int = PERSPECTIVE,
                aperture_radius: float = 0.0, focal_distance: float = 1.0,
                ortho_scale: float = 1.0) -> "Camera":
        origin = np.asarray(origin, np.float64)
        target = np.asarray(target, np.float64)
        up = np.asarray(up, np.float64)
        fwd = target - origin
        fwd = fwd / max(np.linalg.norm(fwd), 1e-12)
        right = np.cross(fwd, up)
        if np.linalg.norm(right) < 1e-9:
            right = np.cross(fwd, np.array([1.0, 0.0, 0.0]))
        right = right / max(np.linalg.norm(right), 1e-12)
        true_up = np.cross(right, fwd)
        m = np.eye(4)
        m[:3, 0] = right
        m[:3, 1] = true_up
        m[:3, 2] = fwd
        m[:3, 3] = origin
        return Camera(
            ctype=jnp.asarray(np.int32(ctype)),
            to_world=jnp.asarray(m.astype(np.float32)),
            tan_half_fov=jnp.asarray(np.float32(np.tan(np.radians(fov_deg) / 2))),
            aspect=jnp.asarray(np.float32(aspect)),
            aperture_radius=jnp.asarray(np.float32(aperture_radius)),
            focal_distance=jnp.asarray(np.float32(focal_distance)),
            ortho_scale=jnp.asarray(np.float32(ortho_scale)),
        )


def _xform_point(m, p):
    return jnp.einsum("ij,...j->...i", m[:3, :3], p, precision="highest") + m[:3, 3]


def _xform_dir(m, d):
    return jnp.einsum("ij,...j->...i", m[:3, :3], d, precision="highest")


def sample_ray(cam: Camera, film_uv, u_aperture):
    """Generate primary rays for film positions (..., 2) in [0,1]^2.

    Returns (origin, direction, importance_weight). u_aperture drives the
    thin-lens aperture (ignored by other models). Counterpart of
    Sensor::sampleRay (SceneTypes/Sensor.h:217).
    """
    # NDC in [-1, 1], y flipped (film v grows downward, camera y grows up)
    x = (film_uv[..., 0] * 2.0 - 1.0) * cam.tan_half_fov
    y = (1.0 - film_uv[..., 1] * 2.0) * cam.tan_half_fov / cam.aspect

    # perspective
    d_cam_persp = normalize(jnp.stack([x, y, jnp.ones_like(x)], axis=-1))
    o_cam_persp = jnp.zeros_like(d_cam_persp)

    # thin lens: focus plane at focal_distance
    lens = warp.square_to_uniform_disk_concentric(u_aperture) * cam.aperture_radius
    focus_p = d_cam_persp * (
        cam.focal_distance / jnp.maximum(d_cam_persp[..., 2:3], 1e-6)
    )
    o_cam_lens = jnp.stack([lens[..., 0], lens[..., 1], jnp.zeros_like(lens[..., 0])], axis=-1)
    d_cam_lens = normalize(focus_p - o_cam_lens)

    # orthographic / telecentric
    ox = (film_uv[..., 0] * 2.0 - 1.0) * cam.ortho_scale
    oy = (1.0 - film_uv[..., 1] * 2.0) * cam.ortho_scale / cam.aspect
    o_cam_ortho = jnp.stack([ox, oy, jnp.zeros_like(ox)], axis=-1)
    d_cam_ortho = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 1.0], jnp.float32), o_cam_ortho.shape
    )
    o_cam_tele = o_cam_ortho + jnp.stack(
        [lens[..., 0], lens[..., 1], jnp.zeros_like(lens[..., 0])], axis=-1
    )

    # spherical: equirect over the full sphere
    phi = (1.0 - film_uv[..., 0]) * 2.0 * PI - PI
    theta = film_uv[..., 1] * PI
    st = jnp.sin(theta)
    d_cam_sph = jnp.stack([st * jnp.sin(phi), jnp.cos(theta), st * jnp.cos(phi)], axis=-1)

    t = cam.ctype
    o_cam = jnp.where((t == THINLENS), o_cam_lens, o_cam_persp)
    o_cam = jnp.where((t == ORTHOGRAPHIC), o_cam_ortho, o_cam)
    o_cam = jnp.where((t == TELECENTRIC), o_cam_tele, o_cam)
    d_cam = jnp.where((t == THINLENS), d_cam_lens, d_cam_persp)
    d_cam = jnp.where((t == ORTHOGRAPHIC) | (t == TELECENTRIC), d_cam_ortho, d_cam)
    d_cam = jnp.where((t == SPHERICAL), d_cam_sph, d_cam)

    o = _xform_point(cam.to_world, o_cam)
    d = normalize(_xform_dir(cam.to_world, d_cam))
    weight = jnp.ones(o.shape[:-1] + (3,), jnp.float32)
    return o, d, weight


def sample_direct(cam: Camera, ref_p):
    """Connect a scene point to the camera: returns (film_uv, direction
    ref->camera, dist, importance, valid). Used by light tracing / BDPT to
    splat (counterpart of Sensor::sampleDirect, Sensor.h:527 interface)."""
    m = cam.to_world
    # world -> camera (rigid inverse)
    R = m[:3, :3]
    t = m[:3, 3]
    p_cam = jnp.einsum("ji,...j->...i", R, ref_p - t, precision="highest")

    z = jnp.maximum(p_cam[..., 2], 1e-6)
    x_ndc = p_cam[..., 0] / (z * cam.tan_half_fov)
    y_ndc = p_cam[..., 1] / (z * cam.tan_half_fov / cam.aspect)
    u = (x_ndc + 1.0) * 0.5
    v = (1.0 - y_ndc) * 0.5
    uv = jnp.stack([u, v], axis=-1)

    cam_pos = t
    to_cam = cam_pos - ref_p
    dist = jnp.sqrt(jnp.maximum(jnp.sum(to_cam * to_cam, axis=-1), 1e-12))
    d = to_cam / dist[..., None]

    # importance W_e for a pinhole camera over the film area measure:
    # W = dist^2 / (A_film * cos^3) in solid-angle terms -> standard splat weight
    fwd = R[:, 2]
    cos_theta = jnp.maximum(-jnp.sum(d * fwd, axis=-1), 1e-6)
    film_area = 4.0 * cam.tan_half_fov * (cam.tan_half_fov / cam.aspect)
    importance = 1.0 / (film_area * cos_theta ** 4)
    in_frustum = (
        (u >= 0.0) & (u < 1.0) & (v >= 0.0) & (v < 1.0) & (p_cam[..., 2] > 1e-6)
    )
    return uv, d, dist, importance, in_frustum


def pixel_spread(cam: Camera, width: int, height: int):
    """Per-pixel ray-cone parameters (r0, slope): the world-space footprint
    radius of one pixel at distance t is ~ r0 + slope * t.

    Replacement for the reference's per-ray differential
    generation (Sensor.h:217 sampleRayDifferential): a scalar cone is carried
    per path instead of two differential rays, which is what drives MIP LOD
    selection (MIPMap Sample(uv, width)).
    """
    persp_slope = 2.0 * cam.tan_half_fov / width
    ortho_r0 = 2.0 * cam.ortho_scale / width
    sph_slope = 2.0 * jnp.pi / width
    is_ortho = (cam.ctype == ORTHOGRAPHIC) | (cam.ctype == TELECENTRIC)
    r0 = jnp.where(is_ortho, ortho_r0, 0.0)
    slope = jnp.where(is_ortho, 0.0,
                      jnp.where(cam.ctype == SPHERICAL, sph_slope, persp_slope))
    return r0, slope
