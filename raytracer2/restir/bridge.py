"""The resampling-library <-> application bridge contract.

JAX formalization of the reference's RAB_* interface
(lighting_passes/RtxdiApplicationBridge.glsl): the restir library is written
purely against this NamedTuple of closures, so the resampling math stays
generic while scene access, G-buffer reads and ray tracing are injected by
the renderer (SURVEY.md §1 'cross-layer contract worth preserving').

All closures are whole-array (SoA over pixels/lanes):
- gathers take integer pixel coordinate arrays;
- visibility queries take batched origins/targets and return boolean masks.

Vectorized restructure: visibility rays that the reference traces *inside*
resampling callbacks are still expressed as closures here, but each pass
invokes them a FIXED small number of times on full lane batches (collect ->
batched trace -> merge), never per-lane (SURVEY.md §7 step 6).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax

from raytracer2.render.surface import Surface


class Bridge(NamedTuple):
    """RAB_* closure bundle. Members mirror RtxdiApplicationBridge.glsl."""

    # RAB_GetGBufferSurface (bridge:328-344): (px, py, previous_frame) -> Surface
    get_gbuffer_surface: Callable[[jax.Array, jax.Array, bool], Surface]

    # RAB_GetLightSampleTargetPdfForSurface (bridge:478-500):
    # (light_sample, surface) -> [...] f32
    get_light_sample_target_pdf: Callable

    # RAB_GetGISampleTargetPdfForSurface (bridge:687-694):
    # (sample_pos, sample_radiance, surface) -> [...] f32
    get_gi_sample_target_pdf: Callable

    # RAB_GetConservativeVisibility (bridge:700-703):
    # (surface, sample_position) -> visible mask
    get_conservative_visibility: Callable

    # RAB_GetTemporalConservativeVisibility (bridge:708-711):
    # (current_surface, previous_surface, sample_position) -> visible mask
    get_temporal_conservative_visibility: Callable

    # RAB_AreMaterialsSimilar (bridge:600-616): (a, b) -> mask
    are_materials_similar: Callable

    # RAB_SamplePolymorphicLight (bridge:514-525):
    # (light_info, surface, uv) -> LightSample
    sample_polymorphic_light: Callable

    # RAB_LoadLightInfo (bridge:556-559): (index, previous_frame) -> LightInfo
    load_light_info: Callable

    # RAB_GetSurfaceBrdfSample / Pdf (bridge:437-470)
    get_surface_brdf_sample: Callable
    get_surface_brdf_pdf: Callable

    # RAB_TraceRayForLocalLight (bridge:639-669):
    # (origins, directions, t_min, t_max) -> (hit_anything, light_index, rand_xy)
    trace_ray_for_local_light: Callable

    # RAB_EvaluateLocalLightSourcePdf / EnvironmentMapSamplingPdf
    # (bridge:397-434): index/direction arrays -> pdf arrays
    evaluate_local_light_source_pdf: Callable
    evaluate_environment_map_sampling_pdf: Callable

    # Low-discrepancy neighbor offsets [N, 2] floats in [-1, 1]
    neighbor_offsets: jax.Array

    # viewport (width, height) for RAB_ClampSamplePositionIntoView
    viewport: tuple[int, int]


def validate_gi_sample_with_jacobian(jacobian: jax.Array
                                     ) -> tuple[jax.Array, jax.Array]:
    """RAB_ValidateGISampleWithJacobian (bridge:673-684): reject if the
    solid-angle ratio is >10x off, else clamp to [1/3, 3].
    Returns (valid_mask, clamped_jacobian)."""
    import jax.numpy as jnp

    valid = (jacobian <= 10.0) & (jacobian >= 0.1)
    return valid, jnp.clip(jacobian, 1.0 / 3.0, 3.0)
