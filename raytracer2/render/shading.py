"""Shading glue: light-sample shading and output accumulation.

Port of src/shaders/ShadingHelpers.glsl. The final visibility ray inside
ShadeSurfaceWithLightSample (ShadingHelpers.glsl:34-38) becomes one batched
occlusion query through the bridge.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raytracer2.lights.polymorphic import LightSample
from raytracer2.params import DIShadingParameters, DITemporalResamplingParameters
from raytracer2.render.surface import Surface, evaluate_brdf
from raytracer2.restir import di_reservoir as dires
from raytracer2.restir.bridge import Bridge


def setup_visibility_ray(surface: Surface, sample_position: jax.Array,
                         offset: float = 0.001
                         ) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """(RtxdiApplicationBridge.glsl:191-217). Returns (origin, dir, tmin, tmax)."""
    l = sample_position - surface.world_pos
    dist = jnp.linalg.norm(l, axis=-1)
    direction = l / jnp.maximum(dist, 1e-30)[..., None]
    t_min = jnp.full(dist.shape, offset, jnp.float32)
    t_max = jnp.maximum(offset, dist - offset * 2.0)
    return surface.world_pos, direction, t_min, t_max


def shade_surface_with_light_sample(
    reservoir: dires.DIReservoir,
    surface: Surface,
    light_sample: LightSample,
    shading_params: DIShadingParameters,
    temporal_params: DITemporalResamplingParameters,
    bridge: Bridge,
    enable_visibility_reuse: bool,
    known_visibility: jax.Array | None = None,
) -> tuple[dires.DIReservoir, jax.Array, jax.Array, jax.Array]:
    """Port of ShadeSurfaceWithLightSample (ShadingHelpers.glsl:2-58).

    known_visibility: the result of an earlier
    get_conservative_visibility(surface, light_sample.position) for the
    SAME sample, if one was already traced this pass. The fused DI pass
    runs no resampling between its initial-visibility kill and shading
    (the reference's commented-out call, di_fused_resampling.rgen:69-70),
    so the shading visibility ray is bitwise identical to the initial one
    — reusing it drops a full-screen shadow trace with zero estimator
    change.

    Returns (reservoir, diffuse [...,3], specular [...,3], light_distance).
    """
    shape = surface.view_depth.shape
    live = light_sample.solid_angle_pdf > 0.0

    radiance = light_sample.radiance

    if shading_params.enable_final_visibility:
        if shading_params.reuse_final_visibility and enable_visibility_reuse:
            reused, vis = dires.get_reservoir_visibility(
                reservoir,
                shading_params.final_visibility_max_age,
                shading_params.final_visibility_max_distance)
        else:
            reused = jnp.zeros(shape, bool)
            vis = jnp.zeros(shape + (3,), jnp.float32)

        # batched visibility ray for lanes without reusable visibility
        if known_visibility is not None:
            visible = known_visibility
        else:
            visible = bridge.get_conservative_visibility(
                surface, light_sample.position)
        traced_vis = jnp.where(visible[..., None], 1.0, 0.0)
        need_trace = live & ~reused
        vis = jnp.where(need_trace[..., None], traced_vis, vis)
        reservoir = dires.store_visibility(
            reservoir, vis,
            bool(temporal_params.discard_invisible_samples),
            active=need_trace)
        radiance = radiance * vis

    radiance = radiance * (dires.inv_pdf(reservoir)
                           / jnp.maximum(light_sample.solid_angle_pdf,
                                         1e-30))[..., None]

    lit = live & (jnp.any(radiance > 0.0, axis=-1))
    brdf = evaluate_brdf(surface, light_sample.position)
    diffuse = jnp.where(lit[..., None],
                        brdf.demodulated_diffuse[..., None] * radiance, 0.0)
    specular = jnp.where(lit[..., None], brdf.specular * radiance, 0.0)
    light_distance = jnp.where(
        lit, jnp.linalg.norm(light_sample.position - surface.world_pos,
                             axis=-1), 0.0)
    return reservoir, diffuse, specular, light_distance


def store_shading_output(
    diffuse_img: jax.Array,  # [H, W, 3] prior
    specular_img: jax.Array,
    diffuse: jax.Array,  # [H, W, 3] new contribution
    specular: jax.Array,
    is_first_pass: bool,
    enable_accumulation: int,
    blend_factor,
    write_mask: jax.Array | None = None,  # lanes that execute the store
    correct_specular_accumulation: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Functional StoreShadingOutput (ShadingHelpers.glsl:61-88).

    QUIRK preserved by default: in accumulation mode the reference blends
    the NEW diffuse into BOTH outputs using priorDiffuse (copy-paste bug,
    ShadingHelpers.glsl:72-73) — the specular channel accumulates diffuse.
    correct_specular_accumulation=True (GConst.correct_specular_accumulation)
    accumulates specular properly instead — required by the RMSE gate,
    since the quirk corrupts every converged ReSTIR-mode image.
    """
    if enable_accumulation:
        new_diffuse = diffuse_img + (diffuse - diffuse_img) * blend_factor
        if correct_specular_accumulation:
            new_specular = (specular_img
                            + (specular - specular_img) * blend_factor)
        else:
            new_specular = new_diffuse  # [sic] mix(priorDiffuse, diffuse, t)
    elif not is_first_pass:
        new_diffuse = diffuse_img + diffuse
        new_specular = specular_img + specular
    else:
        new_diffuse = diffuse
        new_specular = specular
    if write_mask is not None:
        m = write_mask[..., None]
        new_diffuse = jnp.where(m, new_diffuse, diffuse_img)
        new_specular = jnp.where(m, new_specular, specular_img)
    return new_diffuse, new_specular
