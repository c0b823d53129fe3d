"""Spot-light shaping and IES profiles.

Port of src/shaders/LightShaping.glsl. The reference packs cone
axis/angle/softness into the light record's third uint4 (LightShaping.glsl:
16-25) but its IES evaluation is stubbed to 1.0 (:27-54) and no light is ever
created with shaping enabled — behavior preserved: the cone falloff math is
implemented, and `evaluate_light_shaping` returns 1.0 for unshaped lights
(i.e. every light the prepare pass emits).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytracer2.params import (  # noqa: F401 (parity constants)
    K_SECONDARY_IS_SPECULAR_RAY,
)
from raytracer2.utils import brdf
from raytracer2.utils import packing as pk

# flag bits in colorTypeAndFlags (ShaderParameters.glsl:16-17)
K_SHAPING_ENABLE_BIT = 1 << 28
K_IES_PROFILE_ENABLE_BIT = 1 << 29


class LightShaping(NamedTuple):
    """(ref: LightShaping.glsl struct)."""

    is_spot: jax.Array  # [...] bool
    primary_axis: jax.Array  # [..., 3]
    cos_cone_angle: jax.Array  # [...]
    cone_softness: jax.Array  # [...]
    ies_profile_index: jax.Array  # [...] int32 (-1 none)


def unpack_light_shaping(color_type_and_flags: jax.Array,
                         primary_axis_packed: jax.Array,
                         cos_cone_angle_and_softness: jax.Array,
                         ies_profile_index: jax.Array) -> LightShaping:
    """(ref: LightShaping.glsl:16-25). Our LightInfo SoA omits the shaping
    uint4 (never populated by the reference); callers pass zeros."""
    is_spot = (color_type_and_flags & jnp.uint32(K_SHAPING_ENABLE_BIT)) != 0
    has_ies = (color_type_and_flags & jnp.uint32(K_IES_PROFILE_ENABLE_BIT)) != 0
    return LightShaping(
        is_spot=is_spot,
        primary_axis=pk.oct_unorm32_to_ndir(primary_axis_packed),
        cos_cone_angle=pk.f16_bits_to_f32(cos_cone_angle_and_softness),
        cone_softness=pk.f16_bits_to_f32(cos_cone_angle_and_softness >> 16),
        ies_profile_index=jnp.where(has_ies,
                                    ies_profile_index.astype(jnp.int32), -1),
    )


def evaluate_ies_profile(profile_index: jax.Array, direction: jax.Array
                         ) -> jax.Array:
    """IES lookup — stubbed to 1.0 exactly like the reference
    (LightShaping.glsl:27-54)."""
    return jnp.ones(direction.shape[:-1], direction.dtype)


def evaluate_light_shaping(shaping: LightShaping, surface_pos: jax.Array,
                           light_sample_pos: jax.Array) -> jax.Array:
    """Smoothstep cone falloff (ref: LightShaping.glsl:56-75)."""
    to_surface = brdf.normalize(surface_pos - light_sample_pos)
    cos_theta = brdf.dot3(shaping.primary_axis, to_surface)
    edge0 = shaping.cos_cone_angle
    edge1 = shaping.cos_cone_angle + shaping.cone_softness
    t = jnp.clip((cos_theta - edge0)
                 / jnp.maximum(edge1 - edge0, 1e-6), 0.0, 1.0)
    falloff = t * t * (3.0 - 2.0 * t)
    falloff = falloff * evaluate_ies_profile(shaping.ies_profile_index,
                                             to_surface)
    return jnp.where(shaping.is_spot, falloff, 1.0)


def get_shaping_flux_factor(shaping: LightShaping) -> jax.Array:
    """Approximate cone flux fraction (ref: getShapingFluxFactor): unshaped
    lights contribute full flux."""
    frac = (1.0 - shaping.cos_cone_angle) * 0.5
    return jnp.where(shaping.is_spot, frac, 1.0)


def test_sphere_intersection_for_shaped_light(
        light_pos: jax.Array, light_radius, shaping: LightShaping,
        volume_center: jax.Array, volume_radius) -> jax.Array:
    """Sphere-vs-cone culling (ref: LightShaping.glsl:~130): conservative
    accept for unshaped lights, cone half-space test for spots."""
    to_volume = volume_center - light_pos
    dist = jnp.linalg.norm(to_volume, axis=-1)
    cos_to_volume = brdf.dot3(shaping.primary_axis,
                              to_volume / jnp.maximum(dist, 1e-20)[..., None])
    # expand the cone angle by the volume's angular radius
    sin_ang = jnp.clip(volume_radius / jnp.maximum(dist, 1e-20), 0.0, 1.0)
    cos_expanded = (shaping.cos_cone_angle * jnp.sqrt(1.0 - sin_ang ** 2)
                    - jnp.sqrt(jnp.maximum(
                        1.0 - shaping.cos_cone_angle ** 2, 0.0)) * sin_ang)
    inside = cos_to_volume >= cos_expanded
    return jnp.where(shaping.is_spot, inside | (dist <= volume_radius),
                     jnp.ones_like(inside))
