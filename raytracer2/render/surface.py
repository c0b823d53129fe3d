"""RAB_Surface and the scene-access bridge functions.

This is the JAX equivalent of the reference's application bridge
(src/shaders/lighting_passes/RtxdiApplicationBridge.glsl): the resampling
library (raytracer2.restir) is written purely against Surface pytrees and
closures; everything scene-specific (G-buffer access, BRDF sampling, tracing)
lives here — the cross-layer contract SURVEY.md §1 calls out as the key
architectural idea to preserve.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytracer2.params import BACKGROUND_DEPTH
from raytracer2.scene.scene import Scene, get_geometry_from_hit
from raytracer2.utils import brdf
from raytracer2.utils import rng as rtrng
from raytracer2.ops.intersect import HitRecord


class Surface(NamedTuple):
    """RAB_Surface (ref: RtxdiApplicationBridge.glsl:83-94), SoA over pixels."""

    world_pos: jax.Array  # [..., 3]
    view_dir: jax.Array  # [..., 3]
    view_depth: jax.Array  # [...]
    normal: jax.Array  # [..., 3]
    geo_normal: jax.Array  # [..., 3]
    diffuse_albedo: jax.Array  # [..., 3]
    specular_f0: jax.Array  # [..., 3]
    roughness: jax.Array  # [...]
    diffuse_probability: jax.Array  # [...]

    @property
    def valid(self) -> jax.Array:
        """RAB_IsSurfaceValid (bridge:347-350)."""
        return self.view_depth != BACKGROUND_DEPTH


def empty_surface(shape, dtype=jnp.float32) -> Surface:
    """RAB_EmptySurface (bridge:161-166): view_depth = BACKGROUND_DEPTH."""
    v3 = jnp.zeros(shape + (3,), dtype)
    v1 = jnp.zeros(shape, dtype)
    return Surface(
        world_pos=v3, view_dir=v3,
        view_depth=jnp.full(shape, BACKGROUND_DEPTH, dtype),
        normal=v3, geo_normal=v3, diffuse_albedo=v3, specular_f0=v3,
        roughness=v1, diffuse_probability=v1)


def get_surface_diffuse_probability(surface_albedo, specular_f0, view_dir,
                                    normal) -> jax.Array:
    """Bridge getSurfaceDiffuseProbability is hardcoded to 1.0 — the weighted
    version is commented out (bridge:131-138). Quirk preserved."""
    return jnp.ones(surface_albedo.shape[:-1], surface_albedo.dtype)


def surface_from_hit(scene: Scene, ray_origin: jax.Array,
                     ray_direction: jax.Array, hit: HitRecord,
                     textures_enabled: bool = True
                     ) -> tuple[Surface, jax.Array]:
    """Port of GetSurface (Hit.glsl:44-70): builds a Surface + emission from
    a hit record. Missed lanes produce an invalid surface; their emission is
    NOT filled with environment radiance here (callers decide, as the
    raygen shaders do)."""
    missed = hit.missed
    attribs = jnp.stack([hit.u, hit.v], axis=-1)
    geom = get_geometry_from_hit(
        scene, hit.geometry_index.astype(jnp.int32),
        hit.primitive_id.astype(jnp.int32), attribs,
        textures_enabled=textures_enabled,
        triangle_index=hit.triangle_index)

    world_pos = ray_origin + ray_direction * hit.t[..., None]
    depth = jnp.where(missed, BACKGROUND_DEPTH, hit.t)
    diffuse_prob = get_surface_diffuse_probability(
        geom.diffuse_albedo, geom.specular_f0, ray_direction, geom.normal)

    surface = Surface(
        world_pos=world_pos,
        view_dir=ray_direction,  # Hit.glsl:68 stores the ray direction
        view_depth=depth,
        normal=geom.normal,
        geo_normal=geom.normal,  # geoNormal = normal (Hit.glsl:66 quirk)
        diffuse_albedo=geom.diffuse_albedo,
        specular_f0=geom.specular_f0,
        roughness=geom.roughness,
        diffuse_probability=diffuse_prob,
    )
    emission = jnp.where(missed[..., None], 0.0, geom.emission)
    return surface, emission


def get_surface_brdf_sample(surface: Surface, state: rtrng.RngState
                            ) -> tuple[jax.Array, jax.Array, rtrng.RngState]:
    """Port of RAB_GetSurfaceBrdfSample (bridge:437-461).

    Draws 3 uniforms; picks the cosine lobe with diffuse_probability, else
    GGX-VNDF reflection. Returns (direction, valid_mask, new_state).
    """
    rand, state = rtrng.sample_uniform_n(state, 3)
    use_diffuse = rand[..., 0] < surface.diffuse_probability

    h_diff, _ = brdf.sample_cos_hemisphere(rand[..., 1:3])
    dir_diffuse = brdf.tangent_to_world(surface.normal, h_diff)

    ve = brdf.normalize(brdf.world_to_tangent(surface.normal, surface.view_dir))
    h_spec = brdf.importance_sample_ggx_vndf(
        rand[..., 1:3],
        jnp.maximum(surface.roughness, brdf.K_MIN_ROUGHNESS), ve, 1.0)
    h_spec = brdf.normalize(h_spec)
    dir_specular = brdf.reflect(
        -surface.view_dir, brdf.tangent_to_world(surface.normal, h_spec))

    direction = jnp.where(use_diffuse[..., None], dir_diffuse, dir_specular)
    valid = brdf.dot3(surface.normal, direction) > 0.0
    return direction, valid, state


def get_surface_brdf_pdf(surface: Surface, direction: jax.Array) -> jax.Array:
    """Port of RAB_GetSurfaceBrdfPdf (bridge:463-470)."""
    cos_theta = brdf.saturate(brdf.dot3(surface.normal, direction))
    diffuse_pdf = cos_theta / brdf.PI
    specular_pdf = brdf.importance_sample_ggx_vndf_pdf(
        jnp.maximum(surface.roughness, brdf.K_MIN_ROUGHNESS),
        surface.normal, surface.view_dir, direction)
    pdf = (specular_pdf
           + (diffuse_pdf - specular_pdf) * surface.diffuse_probability)
    return jnp.where(cos_theta > 0.0, pdf, 0.0)


class SplitBrdf(NamedTuple):
    """(ref: bridge:140-144)."""

    demodulated_diffuse: jax.Array  # [...]
    specular: jax.Array  # [..., 3]


def evaluate_brdf(surface: Surface, sample_position: jax.Array) -> SplitBrdf:
    """Port of EvaluateBrdf (bridge:146-159)."""
    l = brdf.normalize(sample_position - surface.world_pos)
    demod_diffuse = brdf.lambert(surface.normal, -l)
    spec = brdf.ggx_times_ndotl(
        surface.view_dir, l, surface.normal,
        jnp.maximum(surface.roughness, brdf.K_MIN_ROUGHNESS),
        surface.specular_f0)
    spec = jnp.where((surface.roughness == 0.0)[..., None], 0.0, spec)
    return SplitBrdf(demodulated_diffuse=demod_diffuse, specular=spec)


def are_materials_similar(a: Surface, b: Surface) -> jax.Array:
    """Port of RAB_AreMaterialsSimilar (bridge:600-616)."""
    def compare_relative(ref, cand, threshold):
        # RTXDI_CompareRelativeDifference (RtxdiMath.hlsli:18-21)
        return ((threshold <= 0.0)
                | (jnp.abs(ref - cand) <= threshold * jnp.maximum(ref, cand)))

    ok = compare_relative(a.roughness, b.roughness, 0.5)
    ok &= (jnp.abs(brdf.luminance(a.specular_f0)
                   - brdf.luminance(b.specular_f0)) <= 0.25)
    ok &= (jnp.abs(brdf.luminance(a.diffuse_albedo)
                   - brdf.luminance(b.diffuse_albedo)) <= 0.25)
    return ok


def clamp_sample_position_into_view(px: jax.Array, py: jax.Array,
                                    width: int, height: int
                                    ) -> tuple[jax.Array, jax.Array]:
    """Port of RAB_ClampSamplePositionIntoView (bridge:252-265): reflect
    off-screen positions across the nearest edge. Under pixel-space sharding
    the same reflection applies at shard borders (SURVEY.md §2.4)."""
    px = jnp.where(px < 0, -px, px)
    py = jnp.where(py < 0, -py, py)
    px = jnp.where(px >= width, 2 * width - px - 1, px)
    py = jnp.where(py >= height, 2 * height - py - 1, py)
    return px, py
