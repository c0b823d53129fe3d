"""Sampling / BRDF / spherical-geometry helpers, vectorized over pixel arrays.

Vectorized JAX ports of the reference's device-side math library
(src/shaders/Helpers.glsl, src/shaders/common.glsl). All functions take and
return jnp arrays with vectors in a trailing dim of 3 and broadcast over
leading dims, so they compose with vmap-free whole-image kernels.

Parity notes:
- The reference's `square` GLSL macro has no parentheses (common.glsl:2),
  which mis-expands the GGX D denominator `square(a + b)` into `a + b*a + b`
  (Helpers.glsl:189, 226). Since rendered images depend on this, `ggx_d`
  reproduces it by default; pass `quirk=False` for the mathematically
  correct NDF.
- Luminance here is the Rec.601 variant used by the app shaders
  (Helpers.glsl:94-97); the resampling library uses Rec.709
  (rtxdi/RtxdiMath.hlsli:120-123), exposed as `luminance_rec709`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

PI = 3.1415926535  # RTXDI_PI (rtxdi/RtxdiMath.hlsli:14)
K_MIN_ROUGHNESS = 0.05  # kMinRoughness (common.glsl:3)

# Reproduce the reference's unparenthesized `square` macro in the GGX
# D denominator by default (see module docstring).
GGX_MACRO_QUIRK = True


def dot3(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.sum(a * b, axis=-1)


def normalize(v: jax.Array, eps: float = 1e-20) -> jax.Array:
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), eps)


def reflect(incident: jax.Array, normal: jax.Array) -> jax.Array:
    """GLSL reflect: I - 2*dot(N,I)*N."""
    return incident - 2.0 * dot3(normal, incident)[..., None] * normal


def saturate(x: jax.Array) -> jax.Array:
    return jnp.clip(x, 0.0, 1.0)


def luminance(color: jax.Array) -> jax.Array:
    """Rec.601 luminance used by app shaders (ref: Helpers.glsl:94-97)."""
    w = jnp.array([0.299, 0.587, 0.114], dtype=color.dtype)
    return jnp.sum(color * w, axis=-1)


def luminance_rec709(color: jax.Array) -> jax.Array:
    """Rec.709 luminance used by the resampling library (ref: RtxdiMath.hlsli:120-123)."""
    w = jnp.array([0.2126, 0.7152, 0.0722], dtype=color.dtype)
    return jnp.sum(color * w, axis=-1)


# ---------------------------------------------------------------------------
# Low-distortion mappings
# ---------------------------------------------------------------------------

def sample_triangle(rnd: jax.Array) -> jax.Array:
    """[..., 2] uniforms -> [..., 3] barycentrics (ref: Helpers.glsl:66-74)."""
    sqrtx = jnp.sqrt(rnd[..., 0])
    return jnp.stack(
        [1.0 - sqrtx, sqrtx * (1.0 - rnd[..., 1]), sqrtx * rnd[..., 1]], axis=-1
    )


def hit_uv_to_barycentric(uv: jax.Array) -> jax.Array:
    """[..., 2] hit attribs -> [..., 3] barycentrics (ref: Helpers.glsl:76-79)."""
    return jnp.stack(
        [1.0 - uv[..., 0] - uv[..., 1], uv[..., 0], uv[..., 1]], axis=-1
    )


def random_from_barycentric(bary: jax.Array) -> jax.Array:
    """Inverse of sample_triangle (ref: Helpers.glsl:81-86)."""
    sqrtx = 1.0 - bary[..., 0]
    return jnp.stack(
        [sqrtx * sqrtx, bary[..., 2] / jnp.maximum(sqrtx, 1e-20)], axis=-1
    )


def pdf_area_to_solid_angle(pdf_a: jax.Array, distance: jax.Array,
                            cos_theta: jax.Array) -> jax.Array:
    """Area-measure pdf -> solid-angle-measure (ref: Helpers.glsl:88-92)."""
    return pdf_a * (distance * distance) / cos_theta


def sample_disk(random: jax.Array) -> jax.Array:
    """[..., 2] uniforms -> [..., 2] point on unit disk (ref: Helpers.glsl:122-126)."""
    angle = 2.0 * PI * random[..., 0]
    r = jnp.sqrt(random[..., 1])
    return jnp.stack([jnp.cos(angle), jnp.sin(angle)], axis=-1) * r[..., None]


def sample_cos_hemisphere(random: jax.Array) -> tuple[jax.Array, jax.Array]:
    """[..., 2] uniforms -> (dir [...,3] in tangent space, pdf) (ref: Helpers.glsl:171-179)."""
    tangential = sample_disk(random)
    elevation = jnp.sqrt(saturate(1.0 - random[..., 1]))
    pdf = elevation / PI
    return jnp.concatenate([tangential, elevation[..., None]], axis=-1), pdf


def sample_sphere(rand: jax.Array) -> tuple[jax.Array, jax.Array]:
    """[..., 2] uniforms -> (unit dir, pdf=1/4pi) (ref: Helpers.glsl:347-359)."""
    y = rand[..., 1] * 2.0 - 1.0
    tangential = sample_disk(jnp.stack([rand[..., 0], 1.0 - y * y], axis=-1))
    dirs = jnp.concatenate([tangential, y[..., None]], axis=-1)
    pdf = jnp.full(y.shape, 0.25 / PI, dtype=y.dtype)
    return dirs, pdf


# ---------------------------------------------------------------------------
# Orthonormal basis / tangent frames
# ---------------------------------------------------------------------------

def construct_onb(normal: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Branchless ONB; returns (tangent, bitangent) (ref: Helpers.glsl:112-119)."""
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    sign = jnp.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    tangent = jnp.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], axis=-1)
    bitangent = jnp.stack([b, sign + ny * ny * a, -ny], axis=-1)
    return tangent, bitangent


def world_to_tangent(normal: jax.Array, w: jax.Array) -> jax.Array:
    """World dir -> tangent space; basis order (bitangent, tangent, normal)
    matches the bridge (ref: RtxdiApplicationBridge.glsl:106-116)."""
    tangent, bitangent = construct_onb(normal)
    return jnp.stack(
        [dot3(bitangent, w), dot3(tangent, w), dot3(normal, w)], axis=-1
    )


def tangent_to_world(normal: jax.Array, h: jax.Array) -> jax.Array:
    """Tangent space dir -> world (ref: RtxdiApplicationBridge.glsl:118-128)."""
    tangent, bitangent = construct_onb(normal)
    return (bitangent * h[..., 0:1] + tangent * h[..., 1:2]
            + normal * h[..., 2:3])


# ---------------------------------------------------------------------------
# GGX microfacet model
# ---------------------------------------------------------------------------

def _ggx_d_denom_core(noh: jax.Array, alpha: jax.Array, quirk: bool) -> jax.Array:
    a = noh * noh * alpha * alpha
    b = 1.0 - noh * noh
    if quirk:
        # textual macro expansion: a + b*a + b   (see module docstring)
        return a + b * a + b
    s = a + b
    return s * s


def ggx_d(noh: jax.Array, alpha: jax.Array, quirk: bool | None = None) -> jax.Array:
    """GGX normal distribution D(h) (ref: Helpers.glsl:226, 189)."""
    if quirk is None:
        quirk = GGX_MACRO_QUIRK
    return (alpha * alpha) / (PI * _ggx_d_denom_core(noh, alpha, quirk))


def importance_sample_ggx(random: jax.Array, roughness: jax.Array) -> jax.Array:
    """Classic NDF sampling, returns half-vector in tangent space
    (ref: Helpers.glsl:128-142)."""
    alpha = roughness * roughness
    phi = 2.0 * PI * random[..., 0]
    cos_theta = jnp.sqrt(
        (1.0 - random[..., 1])
        / (1.0 + (alpha * alpha - 1.0) * random[..., 1])
    )
    sin_theta = jnp.sqrt(1.0 - cos_theta * cos_theta)
    return jnp.stack(
        [sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), cos_theta], axis=-1
    )


def importance_sample_ggx_vndf(random: jax.Array, roughness: jax.Array,
                               ve: jax.Array, ndf_trim: float = 1.0) -> jax.Array:
    """Visible-NDF sampling (Heitz); ve is the view dir in tangent space,
    returns (unnormalized) half-vector in tangent space
    (ref: Helpers.glsl:144-169; sampleGGX_VNDF variant :281-303)."""
    alpha = (roughness * roughness)[..., None]
    vh = normalize(jnp.concatenate(
        [alpha * ve[..., 0:1], alpha * ve[..., 1:2], ve[..., 2:3]], axis=-1))

    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    t1_safe = jnp.stack([-vh[..., 1], vh[..., 0], jnp.zeros_like(lensq)], axis=-1) \
        / jnp.sqrt(jnp.maximum(lensq, 1e-30))[..., None]
    t1_fallback = jnp.broadcast_to(
        jnp.array([1.0, 0.0, 0.0], dtype=vh.dtype), vh.shape)
    t1 = jnp.where((lensq > 0.0)[..., None], t1_safe, t1_fallback)
    t2 = jnp.cross(vh, t1)

    r = jnp.sqrt(random[..., 0] * ndf_trim)
    phi = 2.0 * PI * random[..., 1]
    p1 = r * jnp.cos(phi)
    p2 = r * jnp.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * jnp.sqrt(jnp.maximum(1.0 - p1 * p1, 0.0)) + s * p2

    nh = (p1[..., None] * t1 + p2[..., None] * t2
          + jnp.sqrt(jnp.maximum(0.0, 1.0 - p1 * p1 - p2 * p2))[..., None] * vh)

    return jnp.concatenate(
        [alpha * nh[..., 0:1], alpha * nh[..., 1:2],
         jnp.maximum(0.0, nh[..., 2:3])], axis=-1)


def importance_sample_ggx_vndf_pdf(roughness: jax.Array, n: jax.Array,
                                   v: jax.Array, l: jax.Array,
                                   quirk: bool | None = None) -> jax.Array:
    """Solid-angle pdf of VNDF sampling (ref: Helpers.glsl:182-191)."""
    h = normalize(l + v)
    noh = saturate(dot3(n, h))
    voh = saturate(dot3(v, h))
    alpha = roughness * roughness
    d = ggx_d(noh, alpha, quirk)
    return jnp.where(voh > 0.0, d / (4.0 * voh), 0.0)


def schlick_fresnel(f0: jax.Array, voh: jax.Array) -> jax.Array:
    """Schlick approximation; f0 may be scalar-shaped or [...,3]
    (ref: Helpers.glsl:194-202)."""
    p = jnp.power(jnp.maximum(1.0 - voh, 0.0), 5.0)
    if f0.ndim == voh.ndim + 1:
        p = p[..., None]
    return f0 + (1.0 - f0) * p


def g_smith_over_ndotv(roughness: jax.Array, ndotv: jax.Array,
                       ndotl: jax.Array) -> jax.Array:
    """Height-correlated Smith G / NdotV (ref: Helpers.glsl:205-211)."""
    alpha = roughness * roughness
    a2 = alpha * alpha
    g1 = ndotv * jnp.sqrt(a2 + (1.0 - a2) * ndotl * ndotl)
    g2 = ndotl * jnp.sqrt(a2 + (1.0 - a2) * ndotv * ndotv)
    return 2.0 * ndotl / jnp.maximum(g1 + g2, 1e-20)


def g1_smith(roughness: jax.Array, ndotl: jax.Array) -> jax.Array:
    """Smith masking for a single direction (ref: Helpers.glsl:305-309)."""
    alpha = roughness * roughness
    a2 = alpha * alpha
    return 2.0 * ndotl / (ndotl + jnp.sqrt(a2 + (1.0 - a2) * ndotl * ndotl))


def ggx_times_ndotl(v: jax.Array, l: jax.Array, n: jax.Array,
                    roughness: jax.Array, f0: jax.Array,
                    quirk: bool | None = None) -> jax.Array:
    """Full specular BRDF * NdotL, [...,3] (ref: Helpers.glsl:213-233)."""
    h = normalize(l + v)
    nol = saturate(dot3(n, l))
    voh = saturate(dot3(v, h))
    nov = saturate(dot3(n, v))
    noh = saturate(dot3(n, h))

    g = g_smith_over_ndotv(roughness, nov, nol)
    alpha = roughness * roughness
    d = ggx_d(noh, alpha, quirk)
    f = schlick_fresnel(f0, voh)
    spec = f * (d * g / 4.0)[..., None]
    return jnp.where((nol > 0.0)[..., None], spec, 0.0)


def lambert(normal: jax.Array, light_incident: jax.Array) -> jax.Array:
    """Lambert term of incident dir (ref: Helpers.glsl:236-239)."""
    return jnp.maximum(0.0, -dot3(normal, light_incident)) / PI


def demodulate_specular(specular_f0: jax.Array, specular: jax.Array) -> jax.Array:
    """(ref: Helpers.glsl:312-315)."""
    return specular / jnp.maximum(0.01, specular_f0)


# ---------------------------------------------------------------------------
# Equirectangular environment mapping
# ---------------------------------------------------------------------------

def direction_to_equirect_uv(direction: jax.Array) -> jax.Array:
    """Unit dir -> equirect uv in [0,1]^2 (ref: Helpers.glsl:242-248)."""
    u = 0.5 + jnp.arctan2(direction[..., 2], direction[..., 0]) / (2.0 * PI)
    v = 0.5 - jnp.arcsin(jnp.clip(direction[..., 1], -1.0, 1.0)) / PI
    return jnp.stack([u, v], axis=-1)


def equirect_uv_to_direction(uv: jax.Array) -> tuple[jax.Array, jax.Array]:
    """uv -> (unit dir, cos(elevation)) (ref: Helpers.glsl:334-345)."""
    azimuth = (uv[..., 0] + 0.25) * (2.0 * PI)
    elevation = (0.5 - uv[..., 1]) * PI
    cos_el = jnp.cos(elevation)
    d = jnp.stack(
        [jnp.cos(azimuth) * cos_el, jnp.sin(elevation), jnp.sin(azimuth) * cos_el],
        axis=-1,
    )
    return d, cos_el


def basic_tone_mapping(color: jax.Array, bias: jax.Array) -> jax.Array:
    """Reinhard-style luminance mapping (ref: Helpers.glsl:99-110)."""
    lum = luminance(color)
    new_lum = lum / (bias + lum)
    scale = jnp.where(lum > 0.0, new_lum / jnp.maximum(lum, 1e-20), 1.0)
    return color * scale[..., None]


def cartesian_to_spherical(v: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
    """(r, azimuth, elevation) (ref: RtxdiMath.hlsli:81-88)."""
    r = jnp.linalg.norm(v, axis=-1)
    n = v / jnp.maximum(r, 1e-30)[..., None]
    azimuth = jnp.arctan2(n[..., 2], n[..., 0])
    elevation = jnp.arcsin(jnp.clip(n[..., 1], -1.0, 1.0))
    return r, azimuth, elevation


def spherical_to_cartesian(r: jax.Array, azimuth: jax.Array,
                           elevation: jax.Array) -> jax.Array:
    """(ref: RtxdiMath.hlsli:90-101)."""
    cos_el = jnp.cos(elevation)
    return jnp.stack(
        [r * jnp.cos(azimuth) * cos_el, r * jnp.sin(elevation),
         r * jnp.sin(azimuth) * cos_el], axis=-1)
