"""ReSTIR DI fused sampling + shading pass.

Port of lighting_passes/di_fused_resampling.rgen:16-93: initial candidate
sampling via RTXDI_SampleLightsForSurface, optional initial-visibility kill,
then shading. QUIRK preserved: the actual spatio-temporal resampling call is
commented out in the reference (di_fused_resampling.rgen:69-70), so the
reservoir shipped to shading is the initial-candidate one; the library's DI
temporal/spatial functions (restir/di_resampling.py) exist for capability
parity and can be toggled in.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raytracer2.params import GConst
from raytracer2.render import rays as raysmod
from raytracer2.render.shading import (
    shade_surface_with_light_sample, store_shading_output)
from raytracer2.restir import di_reservoir as dires
from raytracer2.restir.bridge import Bridge
from raytracer2.restir.initial_sampling import (
    LightSamplingContext, init_sample_parameters, sample_lights_for_surface)
from raytracer2.utils import brdf as brdfm
from raytracer2.utils import rng as rtrng


def di_fused_resampling_pass(
    g_const: GConst,
    bridge: Bridge,
    light_ctx: LightSamplingContext,
    diffuse_img: jax.Array,
    specular_img: jax.Array,
    width: int,
    height: int,
    row0=0,
    field: int = 0,
    primary_surface=None,
    motion=None,
    prev_di_reservoirs=None,
    halo_fn=None,
    halo_rows: int = 8,
) -> tuple[dires.DIReservoir, jax.Array, jax.Array]:
    """Returns (reservoirs for the shading-input slot, diffuse,
    specular) — [H, W] arrays, or [H, W//2] under checkerboard
    (field != 0), where only the active half-field is sampled and
    shaded (di_fused_resampling.rgen:19). primary_surface: the
    gather-free launch-grid surface (surface_from_gbuffer_grid),
    computed once per frame by render_frame.

    GConst.enable_di_resampling != 0 turns the reference's commented-out
    spatio-temporal call (di_fused_resampling.rgen:69-70) back ON through
    the library path (restir/di_resampling.py): 1 =
    temporal (needs `motion` + `prev_di_reservoirs`), 2 = spatial,
    3 = both.

    4K-class launches (> _BAND_THRESHOLD lanes) in the default mode-0
    configuration run the body in row bands under lax.map (the
    sampling/shading temps of this pass are among the largest
    contributors to the whole-image peak device memory at 4K). Banding
    is bit-exact — every RNG stream is seeded by pixel coordinates and
    mode 0 has no cross-pixel reads. Resampling modes (stencil reads)
    and the boiling filter (16x16 tile reduce) disable it."""
    from raytracer2.render.gi_passes import _BAND_THRESHOLD

    px, py = raysmod.active_pixel_grid(width, height, field)
    py = py + row0
    w_res = width // 2 if field else width

    mode = int(g_const.enable_di_resampling)
    if mode and not isinstance(row0, int) and halo_fn is None:
        # ADVICE r4 (medium): under row sharding the reservoir buffers are
        # LOCAL row slabs — gathering global rows into them silently clamps
        # to wrong rows. The explicit-halo path provides halo_fn; anything
        # else (a traced row0 without halo plumbing) must not run modes 1-3.
        raise ValueError(
            "enable_di_resampling != 0 under row sharding requires the "
            "explicit-halo path (make_sharded_render_fn(explicit_halo="
            "True)); local reservoir slabs cannot be gathered with global "
            "rows")

    trp = g_const.restir_di.temporal_resampling_params
    if (mode == 0 and height * w_res > _BAND_THRESHOLD
            and primary_surface is not None and isinstance(row0, int)
            and not trp.enable_boiling_filter):
        # band height: ~half the threshold's lane count per band (so a
        # monkeypatched threshold in tests forces real multi-band runs)
        hb = max(1, min(1 << 21, _BAND_THRESHOLD // 2) // max(w_res, 1))
        nb = (height + hb - 1) // hb
        pad = nb * hb - height

        def band(tree):
            return jax.tree_util.tree_map(
                lambda a: jnp.concatenate(
                    [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)]
                ).reshape((nb, hb) + a.shape[1:]) if pad else
                a.reshape((nb, hb) + a.shape[1:]), tree)

        args = (band(px), band(py), band(primary_surface),
                band(diffuse_img), band(specular_img))

        def one(a):
            px_b, py_b, prim_b, dif_b, spec_b = a
            return _di_fused_body(g_const, bridge, light_ctx, px_b, py_b,
                                  prim_b, dif_b, spec_b)

        out = jax.lax.map(one, args)
        return jax.tree_util.tree_map(
            lambda a: a.reshape((nb * hb,) + a.shape[2:])[:height], out)

    return _di_fused_body(
        g_const, bridge, light_ctx, px, py,
        (primary_surface if primary_surface is not None
         else bridge.get_gbuffer_surface(px, py, False)),
        diffuse_img, specular_img,
        mode=mode, motion=motion, prev_di_reservoirs=prev_di_reservoirs,
        row0=row0, field=field, halo_fn=halo_fn, halo_rows=halo_rows)


def _di_fused_body(
    g_const: GConst,
    bridge: Bridge,
    light_ctx: LightSamplingContext,
    px, py,
    surface,
    diffuse_img: jax.Array,
    specular_img: jax.Array,
    mode: int = 0,
    motion=None,
    prev_di_reservoirs=None,
    row0=0,
    field: int = 0,
    halo_fn=None,
    halo_rows: int = 8,
) -> tuple[dires.DIReservoir, jax.Array, jax.Array]:
    rng = rtrng.init_random_sampler(
        px.astype(jnp.uint32), py.astype(jnp.uint32),
        g_const.frame + jnp.uint32(13))
    tile_rng = rtrng.init_random_sampler(
        (px // 16).astype(jnp.uint32), (py // 16).astype(jnp.uint32),
        g_const.frame + jnp.uint32(13))

    isp = g_const.restir_di.initial_sampling_params
    sample_params = init_sample_parameters(
        isp.num_primary_local_light_samples,
        isp.num_primary_infinite_light_samples,
        isp.num_primary_environment_samples,
        isp.num_primary_brdf_samples,
        isp.brdf_cutoff, 0.001)

    reservoir, light_sample, rng, tile_rng = sample_lights_for_surface(
        rng, tile_rng, surface, sample_params, light_ctx, bridge)

    vis_known = None
    if isp.enable_initial_visibility:
        # initial visibility kill (di_fused_resampling.rgen:40-46)
        visible = bridge.get_conservative_visibility(
            surface, light_sample.position)
        need = dires.is_valid(reservoir) & ~visible
        reservoir = dires.store_visibility(
            reservoir, jnp.zeros(light_sample.position.shape, jnp.float32),
            True, active=need)
        # no resampling runs between here and shading (the reference's
        # commented-out spatio-temporal call below), so the shading
        # visibility ray is IDENTICAL to this one — reuse it instead of
        # tracing a second full-screen shadow batch
        vis_known = visible

    # spatio-temporal resampling: commented out in the reference
    # (di_fused_resampling.rgen:69-70) — quirk preserved at mode 0; modes
    # 1/2/3 run the library's temporal/spatial/both stages
    # (DIResamplingFunctions.hlsli:170/504 made executable)
    trp = g_const.restir_di.temporal_resampling_params
    if mode in (1, 3) and prev_di_reservoirs is not None \
            and motion is not None:
        from raytracer2.restir.di_resampling import (
            DITemporalSpec, di_temporal_resampling)

        t_spec = DITemporalSpec(
            max_history_length=trp.max_history_length,
            bias_correction_mode=trp.temporal_bias_correction,
            depth_threshold=trp.temporal_depth_threshold,
            normal_threshold=trp.temporal_normal_threshold,
            enable_visibility_shortcut=bool(trp.discard_invisible_samples),
            enable_permutation_sampling=bool(
                trp.enable_permutation_sampling),
            active_checkerboard_field=field)
        # under sharding: pad the previous-frame reservoir tile with halo
        # rows so motion-offset gathers stay on-shard (same treatment as
        # gi_temporal_pass; reprojection rarely moves > halo_rows/frame)
        prev_src, prev_base = prev_di_reservoirs, 0
        if halo_fn is not None:
            prev_src = halo_fn(prev_di_reservoirs, halo_rows)
            prev_base = row0 - halo_rows
        reservoir, rng = di_temporal_resampling(
            px, py, surface, reservoir, rng, t_spec, motion,
            trp.uniform_random_number, prev_src, bridge,
            row_base=prev_base)
        vis_known = None  # the selected sample may no longer be ours

    # DI boiling filter (DIResamplingFunctions.hlsli:101-116): applied to
    # the temporal stage's reservoir image when enabled (default off, like
    # the reference's RTXDI_ENABLE_BOILING_FILTER compile switch)
    if trp.enable_boiling_filter:
        from raytracer2.restir.di_resampling import di_boiling_filter

        reservoir = di_boiling_filter(reservoir, trp.boiling_filter_strength)

    if mode in (2, 3):
        from raytracer2.restir.di_resampling import (
            DISpatialSpec, di_spatial_resampling)

        srp = g_const.restir_di.spatial_resampling_params
        s_spec = DISpatialSpec(
            num_samples=srp.num_spatial_samples,
            num_disocclusion_boost_samples=(
                srp.num_disocclusion_boost_samples),
            target_history_length=trp.max_history_length,
            bias_correction_mode=srp.spatial_bias_correction,
            sampling_radius=srp.spatial_sampling_radius,
            depth_threshold=srp.spatial_depth_threshold,
            normal_threshold=srp.spatial_normal_threshold,
            discount_naive_samples=bool(srp.discount_naive_samples),
            active_checkerboard_field=field,
            neighbor_offset_mask=srp.neighbor_offset_mask)
        # the source buffer for neighbor gathers is this frame's reservoir
        # image itself (the whole-grid vectorized analogue of the spatial
        # pass reading its own input buffer). Under sharding, pad it with
        # up to a tile height of halo rows (the DI radius of 32 px can
        # exceed small shard tiles; gathers beyond the halo clamp, the
        # same per-shard edge treatment the reference applies at screen
        # edges, RtxdiApplicationBridge.glsl:252-265)
        src, src_base = reservoir, 0
        if halo_fn is not None:
            import math

            r = min(int(math.ceil(float(srp.spatial_sampling_radius))) + 1,
                    int(reservoir.weight_sum.shape[0]))
            src = halo_fn(reservoir, r)
            src_base = row0 - r
        reservoir, rng = di_spatial_resampling(
            px, py, surface, reservoir, rng, s_spec, src, bridge,
            row_base=src_base)
        vis_known = None

    if mode != 0:
        # ADVICE r4 (high): after temporal/spatial resampling the winning
        # reservoir may carry a REUSED sample — shading with the stale
        # initial-candidate light_sample pairs the winner's inv_pdf with
        # the loser's radiance/position. The reference's resampling
        # functions regenerate lightSample for the selected reservoir via
        # their out-param (DIResamplingFunctions.hlsli:345-352); do the
        # same from the final reservoir (invalid lanes are masked below).
        info = bridge.load_light_info(dires.light_index(reservoir), False)
        light_sample = bridge.sample_polymorphic_light(
            info, surface, dires.sample_uv(reservoir))

    valid = dires.is_valid(reservoir)
    reservoir_shaded, diffuse, specular, _ = shade_surface_with_light_sample(
        reservoir, surface, light_sample,
        g_const.restir_di.shading_params,
        g_const.restir_di.temporal_resampling_params,
        bridge, enable_visibility_reuse=True,
        known_visibility=vis_known)
    diffuse = jnp.where(valid[..., None], diffuse, 0.0)
    specular = jnp.where(valid[..., None],
                         brdfm.demodulate_specular(
                             surface.specular_f0, specular), 0.0)

    diffuse_img, specular_img = store_shading_output(
        diffuse_img, specular_img, diffuse, specular,
        is_first_pass=(g_const.enable_restir_di == 1),
        enable_accumulation=g_const.enable_accumulation,
        blend_factor=g_const.blend_factor,
        correct_specular_accumulation=bool(
            g_const.correct_specular_accumulation))
    return reservoir_shaded, diffuse_img, specular_img
