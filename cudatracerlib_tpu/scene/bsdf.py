"""BSDF models: evaluation, importance sampling, pdfs — pure differentiable JAX.

Counterpart of reference ``SceneTypes/BSDF.h`` + ``BSDF_Simple.{h,cu}`` (the
Mitsuba-derived material system: diffuse:BSDF_Simple.h:6, roughdiffuse:26,
dielectric:62, thindielectric:96, roughdielectric:127, conductor:165,
roughconductor:195, plastic:234, roughplastic:272, phong:313, ward:342).

Design translation (SURVEY.md §7): the reference's
CudaVirtualAggregate + CALLER if-else dispatch (Base/VirtualFuncType.h:90-111)
becomes *branch-free vectorized dispatch*: every lobe family is computed for
every lane and the result is selected by the per-lane type tag. On the VPU
this is a handful of fused elementwise ops per type — far cheaper than the
divergence it avoids — and it keeps the whole shading path differentiable
w.r.t. every material parameter (the capability the CUDA reference lacks).

Conventions (Mitsuba / reference BSDFSamplingRecord, SceneTypes/Samples.h:167):
  * directions are unit vectors in the *local shading frame* (+z = normal);
  * `wo` points toward the camera/previous vertex, `wi` is the new direction;
  * `eval` returns f(wo, wi) * |cos_theta(wi)|  (radiance-mode foreshortening
    included, as Mitsuba's BSDF::eval);
  * `sample` returns weight = f * |cos| / pdf, with the discrete lobe choice
    already folded in; delta lobes have pdf reported as their discrete choice
    probability and eval/pdf == 0 for MIS purposes.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..math import frame as fr
from ..math import fresnel as fres
from ..math import microfacet as mf
from ..math import warp
from ..math.vecmath import INV_PI, PI, reflect, safe_sqrt
from ..sampling.records import (
    BSDFSample,
    E_DELTA_REFLECTION,
    E_DELTA_TRANSMISSION,
    E_DIFFUSE_REFLECTION,
    E_GLOSSY_REFLECTION,
    E_GLOSSY_TRANSMISSION,
    E_NULL,
)



def _sg(x):
    """stop_gradient shorthand: sampling decisions and pdf denominators are
    detached so sample_bsdf implements the *detached* gradient estimator
    (unbiased for material parameters at fixed discontinuities; this is the
    differentiability layer the CUDA reference lacks, SURVEY.md §7)."""
    return jax.lax.stop_gradient(x)

# BSDF type tags (mirror the reference's variant list, SceneTypes/BSDF.h:141)
DIFFUSE = 0
ROUGHDIFFUSE = 1
DIELECTRIC = 2
THINDIELECTRIC = 3
ROUGHDIELECTRIC = 4
CONDUCTOR = 5
ROUGHCONDUCTOR = 6
PLASTIC = 7
ROUGHPLASTIC = 8
PHONG = 9
WARD = 10
COATING = 11
ROUGHCOATING = 12
BLEND = 13
HK = 14
NULL_BSDF = 15

N_BSDF_TYPES = 16

# Types that are "opaque two-sided": shade in the upper hemisphere by flipping.
_TWO_SIDED = (DIFFUSE, ROUGHDIFFUSE, CONDUCTOR, ROUGHCONDUCTOR, PLASTIC,
              ROUGHPLASTIC, PHONG, WARD)


class MatParams(NamedTuple):
    """Per-lane material parameters after texture evaluation (pytree)."""

    bsdf_type: jnp.ndarray    # (...,) int32
    dist_type: jnp.ndarray    # (...,) int32 microfacet NDF (mf.BECKMANN/GGX/PHONG)
    albedo: jnp.ndarray       # (..., 3) diffuse reflectance
    specular: jnp.ndarray     # (..., 3) specular reflectance scale
    transmittance: jnp.ndarray  # (..., 3) specular transmittance scale
    eta: jnp.ndarray          # (...,) relative IOR (int/ext)
    cond_eta: jnp.ndarray     # (..., 3) conductor eta
    cond_k: jnp.ndarray       # (..., 3) conductor k
    alpha_u: jnp.ndarray      # (...,)
    alpha_v: jnp.ndarray      # (...,)
    exponent: jnp.ndarray     # (...,) phong exponent
    nonlinear: jnp.ndarray    # (...,) plastic nonlinear flag (0/1 float)
    blend_weight: jnp.ndarray # (...,) blend factor for BLEND (0 = nested only)

    @staticmethod
    def default(batch_shape=()):
        z = jnp.zeros(batch_shape, jnp.float32)
        z3 = jnp.zeros(batch_shape + (3,), jnp.float32)
        return MatParams(
            bsdf_type=jnp.zeros(batch_shape, jnp.int32),
            dist_type=jnp.full(batch_shape, mf.GGX, jnp.int32),
            albedo=z3 + 0.5,
            specular=z3 + 1.0,
            transmittance=z3 + 1.0,
            eta=z + 1.5,
            cond_eta=z3 + jnp.asarray([0.2, 0.92, 1.1]),
            cond_k=z3 + jnp.asarray([3.9, 2.45, 2.14]),
            alpha_u=z + 0.1,
            alpha_v=z + 0.1,
            exponent=z + 30.0,
            nonlinear=z,
            blend_weight=z + 0.5,
        )


def _mulz(v, s):
    """Multiply z component by per-lane sign s."""
    return jnp.concatenate([v[..., :2], v[..., 2:3] * s[..., None]], axis=-1)


def _flip_sign(mp: MatParams, wo):
    """Two-sided adapter (reference BSDF.h:144-166): opaque BSDFs are shaded
    in the +z hemisphere; transmissive ones keep the true side."""
    two_sided = jnp.zeros(mp.bsdf_type.shape, bool)
    for t in _TWO_SIDED:
        two_sided = two_sided | (mp.bsdf_type == t)
    s = jnp.where(two_sided & (wo[..., 2] < 0.0), -1.0, 1.0)
    return s


# --------------------------------------------------------------------------
# Individual lobe families. Each returns (f_cos, pdf) for eval/pdf and
# (wi, weight, pdf, stype, eta) for sample. All masked-safe (no NaNs for
# irrelevant lanes).
# --------------------------------------------------------------------------

def _diffuse_eval(mp, wo, wi):
    valid = (fr.cos_theta(wo) > 0) & (fr.cos_theta(wi) > 0)
    f = mp.albedo * (INV_PI * jnp.maximum(fr.cos_theta(wi), 0.0))[..., None]
    return jnp.where(valid[..., None], f, 0.0), jnp.where(
        valid, warp.square_to_cosine_hemisphere_pdf(wi), 0.0
    )


def _roughdiffuse_eval(mp, wo, wi):
    """Oren-Nayar (qualitative model), reference BSDF_Simple.h:26."""
    valid = (fr.cos_theta(wo) > 0) & (fr.cos_theta(wi) > 0)
    sigma = mp.alpha_u  # roughness in radians, as reference uses alpha
    s2 = sigma * sigma
    A = 1.0 - 0.5 * s2 / (s2 + 0.33)
    B = 0.45 * s2 / (s2 + 0.09)
    # cos(phi_i - phi_o) via projected directions
    cos_dphi = (
        fr.cos_phi(wi) * fr.cos_phi(wo) + fr.sin_phi(wi) * fr.sin_phi(wo)
    )
    st_i, st_o = fr.sin_theta(wi), fr.sin_theta(wo)
    ct_i = jnp.maximum(fr.cos_theta(wi), 1e-6)
    ct_o = jnp.maximum(fr.cos_theta(wo), 1e-6)
    sin_alpha = jnp.maximum(st_i, st_o)
    tan_beta = jnp.minimum(st_i / ct_i, st_o / ct_o)
    f_scalar = INV_PI * (A + B * jnp.maximum(cos_dphi, 0.0) * sin_alpha * tan_beta)
    f = mp.albedo * (f_scalar * jnp.maximum(fr.cos_theta(wi), 0.0))[..., None]
    return jnp.where(valid[..., None], f, 0.0), jnp.where(
        valid, warp.square_to_cosine_hemisphere_pdf(wi), 0.0
    )


def _diffuse_like_sample(mp, wo, u2, rough: bool):
    wi = warp.square_to_cosine_hemisphere(u2)
    pdf = warp.square_to_cosine_hemisphere_pdf(wi)
    if rough:
        f, _ = _roughdiffuse_eval(mp, wo, wi)
    else:
        f, _ = _diffuse_eval(mp, wo, wi)
    weight = f / jnp.maximum(pdf, 1e-12)[..., None]
    valid = fr.cos_theta(wo) > 0
    return (
        wi,
        jnp.where(valid[..., None], weight, 0.0),
        jnp.where(valid, pdf, 0.0),
        jnp.full(pdf.shape, E_DIFFUSE_REFLECTION, jnp.int32),
        jnp.ones_like(pdf),
    )


def _conductor_sample(mp, wo):
    wi = jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], axis=-1)
    F = fres.fresnel_conductor(fr.cos_theta(wo), mp.cond_eta, mp.cond_k)
    valid = fr.cos_theta(wo) > 0
    weight = jnp.where(valid[..., None], mp.specular * F, 0.0)
    pdf = jnp.where(valid, 1.0, 0.0)
    return wi, weight, pdf, jnp.full(pdf.shape, E_DELTA_REFLECTION, jnp.int32), jnp.ones_like(pdf)


def _dielectric_sample(mp, wo, u1):
    ci = fr.cos_theta(wo)
    F, cos_t, eta_it, eta_ti = fres.fresnel_dielectric(ci, mp.eta)
    pick_reflect = u1 < F
    wi_r = jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], axis=-1)
    # refraction in local frame: n = +z; works for both sides via signed cos_t
    wi_t = jnp.stack(
        [-wo[..., 0] * eta_ti, -wo[..., 1] * eta_ti, cos_t], axis=-1
    )
    # radiance transport: compress by 1/eta_it^2 (Mitsuba convention)
    factor = eta_ti * eta_ti
    wi = jnp.where(pick_reflect[..., None], wi_r, wi_t)
    # F/sg(F) ratios keep d(weight)/d(eta) unbiased through the discrete choice
    r_refl = F / jnp.maximum(_sg(F), 1e-12)
    r_trans = (1.0 - F) / jnp.maximum(_sg(1.0 - F), 1e-12)
    weight = jnp.where(
        pick_reflect[..., None],
        mp.specular * r_refl[..., None],
        mp.transmittance * (factor * r_trans)[..., None],
    )
    pdf = _sg(jnp.where(pick_reflect, F, 1.0 - F))
    stype = jnp.where(pick_reflect, E_DELTA_REFLECTION, E_DELTA_TRANSMISSION)
    eta_rec = jnp.where(pick_reflect, 1.0, eta_it)
    return wi, weight, pdf, stype.astype(jnp.int32), eta_rec


def _thindielectric_sample(mp, wo, u1):
    ci = jnp.abs(fr.cos_theta(wo))
    F, _, _, _ = fres.fresnel_dielectric(ci, mp.eta)
    # account for internal bounces: R' = 2R/(1+R) (reference thindielectric)
    R = jnp.where(F < 1.0, 2.0 * F / (1.0 + F), 1.0)
    pick_reflect = u1 < R
    wi_r = jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], axis=-1)
    wi_t = -wo
    wi = jnp.where(pick_reflect[..., None], wi_r, wi_t)
    r_refl = R / jnp.maximum(_sg(R), 1e-12)
    r_trans = (1.0 - R) / jnp.maximum(_sg(1.0 - R), 1e-12)
    weight = jnp.where(
        pick_reflect[..., None],
        mp.specular * r_refl[..., None],
        mp.transmittance * r_trans[..., None],
    )
    pdf = _sg(jnp.where(pick_reflect, R, 1.0 - R))
    stype = jnp.where(pick_reflect, E_DELTA_REFLECTION, E_NULL)
    return wi, weight, pdf, stype.astype(jnp.int32), jnp.ones_like(pdf)


def _roughconductor_f_pdf(mp, wo, wi):
    valid = (fr.cos_theta(wo) > 0) & (fr.cos_theta(wi) > 0)
    m = wo + wi
    m = m / jnp.maximum(jnp.linalg.norm(m, axis=-1, keepdims=True), 1e-12)
    d = mf.D(mp.dist_type, m, mp.alpha_u, mp.alpha_v)
    g = mf.G(mp.dist_type, wo, wi, m, mp.alpha_u, mp.alpha_v)
    F = fres.fresnel_conductor(jnp.sum(wo * m, axis=-1), mp.cond_eta, mp.cond_k)
    denom = 4.0 * jnp.maximum(fr.cos_theta(wo), 1e-6)
    f = mp.specular * F * (d * g / denom)[..., None]  # includes cos_i via G/denom? no:
    # f*cos_i = F D G / (4 cos_o); the cos_i cancels: f = FDG/(4 cos_o cos_i), eval=f*cos_i.
    pdf_m = mf.pdf(mp.dist_type, wo, m, mp.alpha_u, mp.alpha_v)
    pdf = pdf_m / jnp.maximum(4.0 * jnp.abs(jnp.sum(wo * m, axis=-1)), 1e-8)
    return (
        jnp.where(valid[..., None], f, 0.0),
        jnp.where(valid, pdf, 0.0),
    )


def _roughconductor_sample(mp, wo, u2):
    m, pdf_m = mf.sample(mp.dist_type, wo, mp.alpha_u, mp.alpha_v, u2)
    wi = _sg(2.0 * jnp.sum(wo * m, axis=-1, keepdims=True) * m - wo)
    f, pdf = _roughconductor_f_pdf(mp, wo, wi)
    weight = f / jnp.maximum(_sg(pdf), 1e-12)[..., None]
    valid = (fr.cos_theta(wo) > 0) & (fr.cos_theta(wi) > 0) & (pdf > 0)
    return (
        wi,
        jnp.where(valid[..., None], weight, 0.0),
        jnp.where(valid, pdf, 0.0),
        jnp.full(pdf.shape, E_GLOSSY_REFLECTION, jnp.int32),
        jnp.ones_like(pdf),
    )


def _roughdielectric_f_pdf(mp, wo, wi):
    """Walter et al. 2007 rough dielectric eval + pdf (reference
    BSDF_Simple.h:127 roughdielectric; math follows Mitsuba in radiance mode).

    Convention: the microfacet normal m always lives in the +z hemisphere; the
    sampling direction handed to the NDF routines is sign(cos_o) * wo (full
    negation, matching `_roughdielectric_sample`)."""
    ci, co = fr.cos_theta(wi), fr.cos_theta(wo)
    is_reflect = ci * co > 0.0
    eta = jnp.where(co > 0, mp.eta, 1.0 / mp.eta)  # n_wi_side / n_wo_side

    # half vectors, forced to +z by full negation
    m_r = wo + wi
    m_t = -(wo + wi * eta[..., None])
    m = jnp.where(is_reflect[..., None], m_r, m_t)
    m = m / jnp.maximum(jnp.linalg.norm(m, axis=-1, keepdims=True), 1e-12)
    m = m * jnp.sign(fr.cos_theta(m))[..., None]

    d = mf.D(mp.dist_type, m, mp.alpha_u, mp.alpha_v)
    g = mf.G(mp.dist_type, wo, wi, m, mp.alpha_u, mp.alpha_v)
    wo_m = jnp.sum(wo * m, axis=-1)
    wi_m = jnp.sum(wi * m, axis=-1)
    F, _, _, _ = fres.fresnel_dielectric(wo_m, mp.eta)

    abs_co = jnp.maximum(jnp.abs(co), 1e-6)
    # reflection: f*|cos_i| = F D G / (4 |cos_o|)
    f_r = F * d * g / (4.0 * abs_co)
    # transmission (Walter eq. 21, radiance mode: the eta_b^2 numerator and the
    # 1/eta^2 radiance-compression factor cancel):
    denom_t = wo_m + eta * wi_m
    f_t = (
        jnp.abs(wo_m * wi_m) * (1.0 - F) * d * g
        / jnp.maximum(denom_t * denom_t * abs_co, 1e-8)
    )

    v_up = wo * jnp.sign(co)[..., None]
    pdf_m = mf.pdf(mp.dist_type, v_up, m, mp.alpha_u, mp.alpha_v)
    jac_r = 1.0 / jnp.maximum(4.0 * jnp.abs(wi_m), 1e-8)
    jac_t = (eta * eta * jnp.abs(wi_m)) / jnp.maximum(denom_t * denom_t, 1e-8)
    pdf = jnp.where(is_reflect, F * pdf_m * jac_r, (1.0 - F) * pdf_m * jac_t)

    # sidedness: wo must see the front of m, wi the correct side per mode
    valid_r = is_reflect & (wo_m * co > 0) & (wi_m * ci > 0)
    valid_t = (~is_reflect) & (wo_m * co > 0) & (wi_m * ci > 0)
    f = jnp.where(
        valid_r[..., None],
        mp.specular * f_r[..., None],
        jnp.where(valid_t[..., None], mp.transmittance * f_t[..., None], 0.0),
    )
    pdf = jnp.where(valid_r | valid_t, pdf, 0.0)
    return f, pdf


def _roughdielectric_sample(mp, wo, u2, u1):
    co = fr.cos_theta(wo)
    v_up = wo * jnp.sign(co)[..., None]
    m, pdf_m = mf.sample(mp.dist_type, v_up, mp.alpha_u, mp.alpha_v, u2)  # m.z > 0
    wo_m = jnp.sum(wo * m, axis=-1)
    F, cos_t, eta_it, eta_ti = fres.fresnel_dielectric(wo_m, mp.eta)
    pick_reflect = u1 < F

    wi_r = 2.0 * wo_m[..., None] * m - wo
    # generalized refract about m (signed cos_t from fresnel_dielectric)
    wi_t = m * (wo_m * eta_ti + cos_t)[..., None] - wo * eta_ti[..., None]
    wi = _sg(jnp.where(pick_reflect[..., None], wi_r, wi_t))

    f, pdf = _roughdielectric_f_pdf(mp, wo, wi)
    weight = f / jnp.maximum(_sg(pdf), 1e-12)[..., None]
    valid = (pdf > 1e-12) & (pdf_m > 0)
    stype = jnp.where(pick_reflect, E_GLOSSY_REFLECTION, E_GLOSSY_TRANSMISSION)
    eta_rec = jnp.where(pick_reflect, 1.0, eta_it)
    return (
        wi,
        jnp.where(valid[..., None], weight, 0.0),
        jnp.where(valid, pdf, 0.0),
        stype.astype(jnp.int32),
        eta_rec,
    )


def _plastic_terms(mp, wo, wi, rough: bool = False):
    """Plastic diffuse term + specular probability (reference plastic,
    BSDF_Simple.h:234 / Mitsuba plastic).

    `rough=True` (roughplastic): the interface transmittances and the
    internal diffuse reflectance come from the precomputed ROUGH tables
    (math/rough_transmittance.py — the reference's RoughTransmittance.h
    data files), closing the ~0.12 grazing-energy error of the smooth
    Fresnel substitute. F_o stays smooth:
    it only steers sampling probabilities."""
    F_o, _, _, _ = fres.fresnel_dielectric(fr.cos_theta(wo), mp.eta)
    F_i, _, _, _ = fres.fresnel_dielectric(fr.cos_theta(wi), mp.eta)
    if rough:
        from ..math.rough_transmittance import (rough_fdr,
                                                rough_transmittance)

        T_o = rough_transmittance(fr.cos_theta(wo), mp.alpha_u, mp.eta)
        T_i = rough_transmittance(fr.cos_theta(wi), mp.alpha_u, mp.eta)
        fdr = rough_fdr(mp.alpha_u, mp.eta)
    else:
        T_o = 1.0 - F_o
        T_i = 1.0 - F_i
        fdr = fres.fresnel_diffuse_reflectance(mp.eta)
    inv_eta2 = 1.0 / jnp.maximum(mp.eta * mp.eta, 1e-8)
    denom_lin = 1.0 - fdr[..., None]
    denom_nonlin = 1.0 - mp.albedo * fdr[..., None]
    denom = jnp.where(mp.nonlinear[..., None] > 0.5, denom_nonlin, denom_lin)
    f_diff = (
        mp.albedo
        / jnp.maximum(denom, 1e-6)
        * (INV_PI * inv_eta2 * T_o * T_i * jnp.maximum(fr.cos_theta(wi), 0.0))[
            ..., None
        ]
    )
    return f_diff, F_o


def _plastic_eval(mp, wo, wi):
    valid = (fr.cos_theta(wo) > 0) & (fr.cos_theta(wi) > 0)
    f_diff, F_o = _plastic_terms(mp, wo, wi)
    pdf = (1.0 - F_o) * warp.square_to_cosine_hemisphere_pdf(wi)
    return jnp.where(valid[..., None], f_diff, 0.0), jnp.where(valid, pdf, 0.0)


def _plastic_sample(mp, wo, u2, u1):
    F_o, _, _, _ = fres.fresnel_dielectric(fr.cos_theta(wo), mp.eta)
    pick_spec = u1 < F_o
    wi_s = jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], axis=-1)
    wi_d = warp.square_to_cosine_hemisphere(u2)
    wi = jnp.where(pick_spec[..., None], wi_s, wi_d)
    f_diff, _ = _plastic_terms(mp, wo, wi)
    pdf_d = (1.0 - F_o) * warp.square_to_cosine_hemisphere_pdf(wi)
    r_spec = F_o / jnp.maximum(_sg(F_o), 1e-12)
    weight = jnp.where(
        pick_spec[..., None],
        mp.specular * r_spec[..., None],
        f_diff / jnp.maximum(_sg(pdf_d), 1e-12)[..., None],
    )
    pdf = jnp.where(pick_spec, F_o, pdf_d)
    valid = fr.cos_theta(wo) > 0
    stype = jnp.where(pick_spec, E_DELTA_REFLECTION, E_DIFFUSE_REFLECTION)
    return (
        wi,
        jnp.where(valid[..., None], weight, 0.0),
        jnp.where(valid, pdf, 0.0),
        stype.astype(jnp.int32),
        jnp.ones_like(pdf),
    )


def _roughplastic_eval(mp, wo, wi):
    valid = (fr.cos_theta(wo) > 0) & (fr.cos_theta(wi) > 0)
    m = wo + wi
    m = m / jnp.maximum(jnp.linalg.norm(m, axis=-1, keepdims=True), 1e-12)
    d = mf.D(mp.dist_type, m, mp.alpha_u, mp.alpha_v)
    g = mf.G(mp.dist_type, wo, wi, m, mp.alpha_u, mp.alpha_v)
    F_m, _, _, _ = fres.fresnel_dielectric(jnp.sum(wo * m, axis=-1), mp.eta)
    f_spec = mp.specular * (F_m * d * g / (4.0 * jnp.maximum(fr.cos_theta(wo), 1e-6)))[
        ..., None
    ]
    f_diff, F_o = _plastic_terms(mp, wo, wi, rough=True)
    f = f_spec + f_diff

    prob_spec = _roughplastic_spec_prob(F_o)
    pdf_m = mf.pdf(mp.dist_type, wo, m, mp.alpha_u, mp.alpha_v)
    pdf_s = pdf_m / jnp.maximum(4.0 * jnp.abs(jnp.sum(wo * m, axis=-1)), 1e-8)
    pdf = prob_spec * pdf_s + (1.0 - prob_spec) * warp.square_to_cosine_hemisphere_pdf(wi)
    return jnp.where(valid[..., None], f, 0.0), jnp.where(valid, pdf, 0.0)


def _roughplastic_spec_prob(F_o):
    return jnp.clip(F_o, 0.25, 0.9)


def _roughplastic_sample(mp, wo, u2, u1):
    F_o, _, _, _ = fres.fresnel_dielectric(fr.cos_theta(wo), mp.eta)
    prob_spec = _roughplastic_spec_prob(F_o)
    pick_spec = u1 < prob_spec
    m, _ = mf.sample(mp.dist_type, wo, mp.alpha_u, mp.alpha_v, u2)
    wi_s = 2.0 * jnp.sum(wo * m, axis=-1, keepdims=True) * m - wo
    wi_d = warp.square_to_cosine_hemisphere(u2)
    wi = _sg(jnp.where(pick_spec[..., None], wi_s, wi_d))
    f, pdf = _roughplastic_eval(mp, wo, wi)
    weight = f / jnp.maximum(_sg(pdf), 1e-12)[..., None]
    valid = (pdf > 1e-12) & (fr.cos_theta(wi) > 0)
    return (
        wi,
        jnp.where(valid[..., None], weight, 0.0),
        jnp.where(valid, pdf, 0.0),
        jnp.full(pdf.shape, E_GLOSSY_REFLECTION, jnp.int32),
        jnp.ones_like(pdf),
    )


def _phong_eval(mp, wo, wi):
    """Modified Phong (reference BSDF_Simple.h:313): kd/pi + ks (n+2)/2pi cos^n."""
    valid = (fr.cos_theta(wo) > 0) & (fr.cos_theta(wi) > 0)
    r = jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], axis=-1)
    cos_a = jnp.maximum(jnp.sum(r * wi, axis=-1), 0.0)
    n = mp.exponent
    f_spec = mp.specular * ((n + 2.0) * jnp.float32(0.5 / PI) * jnp.power(cos_a, n))[..., None]
    f = (mp.albedo * INV_PI + f_spec) * jnp.maximum(fr.cos_theta(wi), 0.0)[..., None]

    w_d, w_s = _phong_lobe_weights(mp)
    pdf_spec = (n + 1.0) * jnp.float32(0.5 / PI) * jnp.power(cos_a, n)
    pdf = w_d * warp.square_to_cosine_hemisphere_pdf(wi) + w_s * pdf_spec
    return jnp.where(valid[..., None], f, 0.0), jnp.where(valid, pdf, 0.0)


def _phong_lobe_weights(mp):
    ld = jnp.mean(mp.albedo, axis=-1)
    ls = jnp.mean(mp.specular, axis=-1)
    w_d = ld / jnp.maximum(ld + ls, 1e-6)
    return w_d, 1.0 - w_d


def _phong_sample(mp, wo, u2, u1):
    w_d, w_s = _phong_lobe_weights(mp)
    pick_d = u1 < w_d
    wi_d = warp.square_to_cosine_hemisphere(u2)
    # sample around reflection dir
    n = mp.exponent
    ct = jnp.power(jnp.maximum(u2[..., 0], 1e-12), 1.0 / (n + 1.0))
    st = safe_sqrt(1.0 - ct * ct)
    phi = 2.0 * PI * u2[..., 1]
    local = jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), ct], axis=-1)
    r = jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], axis=-1)
    f_r = fr.Frame.from_normal(r)
    wi_s = f_r.to_world(local)
    wi = _sg(jnp.where(pick_d[..., None], wi_d, wi_s))
    f, pdf = _phong_eval(mp, wo, wi)
    weight = f / jnp.maximum(_sg(pdf), 1e-12)[..., None]
    valid = (pdf > 1e-12) & (fr.cos_theta(wi) > 0)
    return (
        wi,
        jnp.where(valid[..., None], weight, 0.0),
        jnp.where(valid, pdf, 0.0),
        jnp.full(pdf.shape, E_GLOSSY_REFLECTION, jnp.int32),
        jnp.ones_like(pdf),
    )


def _ward_eval(mp, wo, wi):
    """Anisotropic Ward-Duer (reference BSDF_Simple.h:342)."""
    valid = (fr.cos_theta(wo) > 0) & (fr.cos_theta(wi) > 0)
    h = wo + wi
    ax, ay = mp.alpha_u, mp.alpha_v
    hz2 = jnp.maximum(h[..., 2] * h[..., 2], 1e-12)
    expo = -(h[..., 0] ** 2 / jnp.maximum(ax * ax, 1e-8) + h[..., 1] ** 2 / jnp.maximum(ay * ay, 1e-8)) / hz2
    ci = jnp.maximum(fr.cos_theta(wi), 1e-6)
    co = jnp.maximum(fr.cos_theta(wo), 1e-6)
    spec = jnp.exp(expo) / (4.0 * PI * ax * ay * jnp.sqrt(ci * co))
    f = (mp.albedo * INV_PI + mp.specular * spec[..., None]) * ci[..., None]

    # pdf: mix of cosine + ward half-vector sampling pdf
    hn = h / jnp.maximum(jnp.linalg.norm(h, axis=-1, keepdims=True), 1e-12)
    hz3 = jnp.maximum(hn[..., 2] ** 3, 1e-9)
    exph = -(hn[..., 0] ** 2 / jnp.maximum(ax * ax, 1e-8) + hn[..., 1] ** 2 / jnp.maximum(ay * ay, 1e-8)) / jnp.maximum(hn[..., 2] ** 2, 1e-9)
    pdf_h = jnp.exp(exph) / (PI * ax * ay * hz3)
    pdf_spec = pdf_h / jnp.maximum(4.0 * jnp.abs(jnp.sum(wo * hn, axis=-1)), 1e-8)
    w_d, w_s = _phong_lobe_weights(mp)
    pdf = w_d * warp.square_to_cosine_hemisphere_pdf(wi) + w_s * pdf_spec
    return jnp.where(valid[..., None], f, 0.0), jnp.where(valid, pdf, 0.0)


def _ward_sample(mp, wo, u2, u1):
    w_d, w_s = _phong_lobe_weights(mp)
    pick_d = u1 < w_d
    wi_d = warp.square_to_cosine_hemisphere(u2)
    ax, ay = mp.alpha_u, mp.alpha_v
    phi = jnp.arctan2(ay * jnp.sin(2.0 * PI * u2[..., 1]), ax * jnp.cos(2.0 * PI * u2[..., 1]))
    cp, sp = jnp.cos(phi), jnp.sin(phi)
    denom = cp * cp / jnp.maximum(ax * ax, 1e-8) + sp * sp / jnp.maximum(ay * ay, 1e-8)
    tan2t = -jnp.log(jnp.maximum(u2[..., 0], 1e-12)) / jnp.maximum(denom, 1e-8)
    ct = 1.0 / jnp.sqrt(1.0 + tan2t)
    st = safe_sqrt(1.0 - ct * ct)
    h = jnp.stack([st * cp, st * sp, ct], axis=-1)
    wi_s = 2.0 * jnp.sum(wo * h, axis=-1, keepdims=True) * h - wo
    wi = _sg(jnp.where(pick_d[..., None], wi_d, wi_s))
    f, pdf = _ward_eval(mp, wo, wi)
    weight = f / jnp.maximum(_sg(pdf), 1e-12)[..., None]
    valid = (pdf > 1e-12) & (fr.cos_theta(wi) > 0)
    return (
        wi,
        jnp.where(valid[..., None], weight, 0.0),
        jnp.where(valid, pdf, 0.0),
        jnp.full(pdf.shape, E_GLOSSY_REFLECTION, jnp.int32),
        jnp.ones_like(pdf),
    )


def _hk_eval(mp, wo, wi):
    """Hanrahan-Krueger single-scattering slab BSDF (reference BSDF_Simple.h:381).

    Parameter mapping: sigma_s -> cond_eta, sigma_a -> cond_k, slab
    thickness -> exponent (world units), HG g -> alpha_u. Reflection term of
    the single-scattering solution; transmission handled in sampling as
    attenuated pass-through."""
    from ..scene import phase as phase_mod  # local import (no cycle at module load)

    sigma_s = jnp.abs(mp.cond_eta)
    sigma_a = jnp.abs(mp.cond_k)
    sigma_t = jnp.maximum(sigma_s + sigma_a, 1e-6)
    w_alb = sigma_s / sigma_t
    tau = sigma_t * mp.exponent[..., None]

    ci = jnp.abs(fr.cos_theta(wi))
    co = jnp.abs(fr.cos_theta(wo))
    same = fr.cos_theta(wi) * fr.cos_theta(wo) > 0
    cos_g = -jnp.sum(wo * wi, axis=-1)  # angle between -wo and wi directions
    g = mp.alpha_u
    g2 = g * g
    ph = (1.0 - g2) / jnp.maximum(
        4.0 * PI * (1.0 + g2 - 2.0 * g * cos_g) ** 1.5, 1e-8
    )
    denom = jnp.maximum(ci + co, 1e-6)
    atten = 1.0 - jnp.exp(-tau * (1.0 / jnp.maximum(ci, 1e-4)
                                  + 1.0 / jnp.maximum(co, 1e-4))[..., None])
    f = w_alb * ph[..., None] * (ci / denom)[..., None] * atten
    valid = same & (ci > 1e-4) & (co > 1e-4)
    pdf = jnp.where(valid, fr.abs_cos_theta(wi) * INV_PI * 0.5, 0.0)
    return jnp.where(valid[..., None], f, 0.0), pdf


def _hk_sample(mp, wo, u2, u1):
    # 50/50: cosine-reflect vs attenuated straight-through transmission
    pick_refl = u1 < 0.5
    wi_r = warp.square_to_cosine_hemisphere(u2)
    wi_r = _mulz(wi_r, jnp.sign(fr.cos_theta(wo)))
    wi_t = -wo
    wi = jnp.where(pick_refl[..., None], wi_r, wi_t)
    sigma_t = jnp.maximum(jnp.abs(mp.cond_eta) + jnp.abs(mp.cond_k), 1e-6)
    tau = sigma_t * mp.exponent[..., None]
    trans = jnp.exp(-tau / jnp.maximum(jnp.abs(fr.cos_theta(wo)), 1e-4)[..., None])
    f, pdf_r = _hk_eval(mp, wo, wi)
    w_refl = f / jnp.maximum(_sg(pdf_r) * 0.5, 1e-12)[..., None]
    weight = jnp.where(pick_refl[..., None], w_refl, trans * 2.0)
    pdf = jnp.where(pick_refl, 0.5 * pdf_r, 0.5)
    stype = jnp.where(pick_refl, E_GLOSSY_REFLECTION, E_NULL)
    return wi, weight, pdf, stype.astype(jnp.int32), jnp.ones_like(pdf)


# --------------------------------------------------------------------------
# Dispatch
# --------------------------------------------------------------------------

def eval_bsdf(mp: MatParams, wo, wi, active=None):
    """f(wo, wi) * |cos_theta(wi)| and solid-angle pdf; 0 for delta lobes.

    `active`: optional static tuple of bsdf type tags present in the scene —
    absent families are skipped entirely (scene-static specialization, the
    analogue of the reference's per-type template instantiation).
    """
    s = _flip_sign(mp, wo)
    wo_l = _mulz(wo, s)
    wi_l = _mulz(wi, s)

    t = mp.bsdf_type
    f = jnp.zeros(wo.shape, jnp.float32)
    pdf = jnp.zeros(wo.shape[:-1], jnp.float32)

    for tag, fn in [
        (DIFFUSE, _diffuse_eval),
        (ROUGHDIFFUSE, _roughdiffuse_eval),
        (ROUGHCONDUCTOR, _roughconductor_f_pdf),
        (ROUGHDIELECTRIC, _roughdielectric_f_pdf),
        (HK, _hk_eval),
        (PLASTIC, _plastic_eval),
        (ROUGHPLASTIC, _roughplastic_eval),
        (PHONG, _phong_eval),
        (WARD, _ward_eval),
    ]:
        if active is not None and tag not in active:
            continue
        fi, pi_ = fn(mp, wo_l, wi_l)
        m = (t == tag)
        f = jnp.where(m[..., None], fi, f)
        pdf = jnp.where(m, pi_, pdf)
    return f, pdf


def pdf_bsdf(mp: MatParams, wo, wi, active=None):
    return eval_bsdf(mp, wo, wi, active)[1]


def sample_bsdf(mp: MatParams, wo, u2, u1, active=None) -> BSDFSample:
    """Importance-sample the BSDF. u2: (..., 2); u1: (...,).
    `active`: static tuple of present type tags (see eval_bsdf)."""
    s = _flip_sign(mp, wo)
    wo_l = _mulz(wo, s)
    t = mp.bsdf_type

    wi = jnp.zeros(wo.shape, jnp.float32)
    weight = jnp.zeros(wo.shape, jnp.float32)
    pdf = jnp.zeros(wo.shape[:-1], jnp.float32)
    stype = jnp.zeros(wo.shape[:-1], jnp.int32)
    eta = jnp.ones(wo.shape[:-1], jnp.float32)

    makers = [
        (DIFFUSE, lambda: _diffuse_like_sample(mp, wo_l, u2, rough=False)),
        (ROUGHDIFFUSE, lambda: _diffuse_like_sample(mp, wo_l, u2, rough=True)),
        (CONDUCTOR, lambda: _conductor_sample(mp, wo_l)),
        (DIELECTRIC, lambda: _dielectric_sample(mp, wo_l, u1)),
        (THINDIELECTRIC, lambda: _thindielectric_sample(mp, wo_l, u1)),
        (ROUGHCONDUCTOR, lambda: _roughconductor_sample(mp, wo_l, u2)),
        (ROUGHDIELECTRIC, lambda: _roughdielectric_sample(mp, wo_l, u2, u1)),
        (PLASTIC, lambda: _plastic_sample(mp, wo_l, u2, u1)),
        (ROUGHPLASTIC, lambda: _roughplastic_sample(mp, wo_l, u2, u1)),
        (PHONG, lambda: _phong_sample(mp, wo_l, u2, u1)),
        (WARD, lambda: _ward_sample(mp, wo_l, u2, u1)),
        (HK, lambda: _hk_sample(mp, wo_l, u2, u1)),
    ]
    results = [
        (tag, mk()) for tag, mk in makers
        if active is None or tag in active
    ]
    for tag, (wi_i, w_i, p_i, st_i, eta_i) in results:
        m = (t == tag)
        wi = jnp.where(m[..., None], wi_i, wi)
        weight = jnp.where(m[..., None], w_i, weight)
        pdf = jnp.where(m, p_i, pdf)
        stype = jnp.where(m, st_i, stype)
        eta = jnp.where(m, eta_i, eta)

    wi = _mulz(wi, s)
    return BSDFSample(wi=wi, weight=weight, pdf=pdf, sampled_type=stype, eta=eta)


def is_delta(mp: MatParams):
    """Lanes whose sampled lobe can never be hit by light sampling (pure delta)."""
    t = mp.bsdf_type
    return (t == CONDUCTOR) | (t == DIELECTRIC) | (t == THINDIELECTRIC)


def is_smooth(mp: MatParams):
    return ~is_delta(mp)


# --------------------------------------------------------------------------
# Nested BSDFs: coating / roughcoating / blend (reference BSDF_Complex.h:9-166,
# the BSDFFirst -> BSDFALL nesting split). One nesting level: the nested model
# must be a non-nested type. Coating uses the thin-layer approximation
# (Fresnel-weighted specular lobe over the attenuated inner BSDF; refraction
# bending inside the coating is neglected).
# --------------------------------------------------------------------------

def eval_bsdf_nested(mp: MatParams, mp_inner: MatParams, wo, wi, active=None):
    """eval for scenes containing coating/blend: mp_inner holds the nested
    material parameters per lane (same pytree structure)."""
    f0, p0 = eval_bsdf(mp, wo, wi, active)
    fi, pi_ = eval_bsdf(mp_inner, wo, wi, active)

    t = mp.bsdf_type
    is_coat = (t == COATING) | (t == ROUGHCOATING)
    is_blend = t == BLEND

    # coating: specular layer handled by sampling (delta/glossy); transmitted
    # part = T(wo) T(wi) * inner — smooth Fresnel for COATING, precomputed
    # rough-interface transmittance for ROUGHCOATING
    # (math/rough_transmittance.py; reference RoughTransmittance.h)
    from ..math.rough_transmittance import rough_transmittance

    F_o, _, _, _ = fres.fresnel_dielectric(jnp.abs(fr.cos_theta(wo)), mp.eta)
    F_i, _, _, _ = fres.fresnel_dielectric(jnp.abs(fr.cos_theta(wi)), mp.eta)
    T_o = jnp.where(t == ROUGHCOATING,
                    rough_transmittance(jnp.abs(fr.cos_theta(wo)),
                                        mp.alpha_u, mp.eta), 1.0 - F_o)
    T_i = jnp.where(t == ROUGHCOATING,
                    rough_transmittance(jnp.abs(fr.cos_theta(wi)),
                                        mp.alpha_u, mp.eta), 1.0 - F_i)
    trans = T_o * T_i
    # rough coating adds a microfacet specular lobe evaluated here
    mp_spec = mp._replace(bsdf_type=jnp.full(jnp.shape(t), ROUGHCONDUCTOR, jnp.int32),
                          cond_eta=jnp.ones_like(mp.cond_eta) * 1e6,
                          cond_k=jnp.zeros_like(mp.cond_k))
    f_spec, p_spec = _roughconductor_f_pdf(mp_spec, _mulz(wo, _flip_sign(mp, wo)),
                                           _mulz(wi, _flip_sign(mp, wo)))
    f_coat = trans[..., None] * fi + jnp.where(
        (t == ROUGHCOATING)[..., None], f_spec * F_o[..., None], 0.0
    )
    p_coat = (1.0 - F_o) * pi_ + jnp.where(t == ROUGHCOATING, F_o * p_spec, 0.0)

    w = jnp.clip(mp.blend_weight, 0.0, 1.0)
    f_blend = w[..., None] * f0_self(mp, wo, wi, active) + (1 - w)[..., None] * fi
    p_blend = w * pdf_self(mp, wo, wi, active) + (1 - w) * pi_

    f = jnp.where(is_coat[..., None], f_coat, f0)
    f = jnp.where(is_blend[..., None], f_blend, f)
    p = jnp.where(is_coat, p_coat, p0)
    p = jnp.where(is_blend, p_blend, p)
    return f, p


def f0_self(mp, wo, wi, active):
    """Blend component B: the material's own fields interpreted as a simple
    model chosen by dist_type (diffuse when alpha ~ 1, else roughconductor)."""
    mp_b = mp._replace(bsdf_type=jnp.full(jnp.shape(mp.bsdf_type), DIFFUSE, jnp.int32))
    f, _ = eval_bsdf(mp_b, wo, wi, (DIFFUSE,))
    return f


def pdf_self(mp, wo, wi, active):
    mp_b = mp._replace(bsdf_type=jnp.full(jnp.shape(mp.bsdf_type), DIFFUSE, jnp.int32))
    _, p = eval_bsdf(mp_b, wo, wi, (DIFFUSE,))
    return p


def sample_bsdf_nested(mp: MatParams, mp_inner: MatParams, wo, u2, u1,
                       active=None) -> BSDFSample:
    """sample for scenes containing nested BSDFs."""
    bs0 = sample_bsdf(mp, wo, u2, u1, active)
    bsi = sample_bsdf(mp_inner, wo, u2, u1, active)

    t = mp.bsdf_type
    is_coat = (t == COATING) | (t == ROUGHCOATING)
    is_blend = t == BLEND

    s = _flip_sign(mp, wo)
    wo_l = _mulz(wo, s)
    F_o, _, _, _ = fres.fresnel_dielectric(jnp.abs(fr.cos_theta(wo_l)), mp.eta)

    # coating: choose specular reflection w.p. F_o else inner sample
    # attenuated; energy transmittances are rough for ROUGHCOATING (the
    # smooth (1-F_o) sampling probability divides back out)
    from ..math.rough_transmittance import rough_transmittance

    pick_spec = u1 < F_o
    wi_spec = _mulz(jnp.stack([-wo_l[..., 0], -wo_l[..., 1], wo_l[..., 2]], -1), s)
    F_i, _, _, _ = fres.fresnel_dielectric(jnp.abs(fr.cos_theta(bsi.wi)), mp.eta)
    is_rc = t == ROUGHCOATING
    T_o = jnp.where(is_rc,
                    rough_transmittance(jnp.abs(fr.cos_theta(wo_l)),
                                        mp.alpha_u, mp.eta), 1.0 - F_o)
    T_i = jnp.where(is_rc,
                    rough_transmittance(jnp.abs(fr.cos_theta(bsi.wi)),
                                        mp.alpha_u, mp.eta), 1.0 - F_i)
    w_inner = bsi.weight * (T_o * T_i
                            / jnp.maximum(_sg(1.0 - F_o), 1e-6))[..., None]
    wi_coat = jnp.where(pick_spec[..., None], wi_spec, bsi.wi)
    wt_coat = jnp.where(pick_spec[..., None], mp.specular, w_inner)
    pdf_coat = jnp.where(pick_spec, F_o, (1.0 - F_o) * bsi.pdf)
    st_coat = jnp.where(pick_spec, E_DELTA_REFLECTION, bsi.sampled_type)

    # blend: pick component by weight
    w = jnp.clip(mp.blend_weight, 0.0, 1.0)
    pick_a = u1 < w
    mp_b = mp._replace(bsdf_type=jnp.full(jnp.shape(mp.bsdf_type), DIFFUSE, jnp.int32))
    bsa = sample_bsdf(mp_b, wo, u2, jnp.zeros_like(u1), (DIFFUSE,))
    wi_blend = jnp.where(pick_a[..., None], bsa.wi, bsi.wi)
    f_bl, p_bl = eval_bsdf_nested(mp, mp_inner, wo, wi_blend, active)
    wt_blend = f_bl / jnp.maximum(_sg(p_bl), 1e-12)[..., None]
    st_blend = jnp.where(pick_a, bsa.sampled_type, bsi.sampled_type)

    wi = jnp.where(is_coat[..., None], wi_coat, bs0.wi)
    wi = jnp.where(is_blend[..., None], wi_blend, wi)
    weight = jnp.where(is_coat[..., None], wt_coat, bs0.weight)
    weight = jnp.where(is_blend[..., None], wt_blend, weight)
    pdf = jnp.where(is_coat, pdf_coat, bs0.pdf)
    pdf = jnp.where(is_blend, p_bl, pdf)
    stype = jnp.where(is_coat, st_coat, bs0.sampled_type)
    stype = jnp.where(is_blend, st_blend, stype)
    eta = jnp.where(is_coat | is_blend, bsi.eta, bs0.eta)
    return BSDFSample(wi=wi, weight=weight, pdf=pdf,
                      sampled_type=stype.astype(jnp.int32), eta=eta)
