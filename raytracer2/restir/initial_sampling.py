"""DI initial candidate sampling: local / infinite / environment / BRDF.

Port of rtxdi/InitialSamplingFunctions.hlsli + the RIS-tile plumbing
(RISBuffer.hlsli, LocalLightSelection.hlsli, UniformSampling.hlsli),
vectorized over pixel lanes. The BRDF candidate's ray trace
(RAB_TraceRayForLocalLight inside RTXDI_SampleBrdf,
InitialSamplingFunctions.hlsli:507-591) becomes one batched trace per
candidate through the bridge closure.

Presampling (RIS tiles) is a static capability flag: the reference compiles
it out of the lighting passes (RtxdiApplicationBridge.glsl:12,
RTXDI_ENABLE_PRESAMPLING 0) but still runs the presample passes; we support
both modes, defaulting to off for behavioral parity.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytracer2.lights.polymorphic import (
    K_ENVIRONMENT, K_TRIANGLE, LightInfo, LightSample)
from raytracer2.params import (
    LightBufferParameters, RISBufferSegmentParameters, RTXDI_INVALID_LIGHT_INDEX)
from raytracer2.restir.bridge import Bridge
from raytracer2.restir.di_reservoir import (
    DIReservoir, combine_reservoirs, empty_di_reservoir, finalize_resampling,
    stream_sample)
from raytracer2.render.surface import Surface
from raytracer2.utils import rng as rtrng

RTXDI_LIGHT_COMPACT_BIT = 0x80000000


class SampleParameters(NamedTuple):
    """RTXDI_SampleParameters (InitialSamplingFunctions.hlsli:29-73).
    All static (compile-time specialization like the GLSL)."""

    num_local_light_samples: int
    num_infinite_light_samples: int
    num_environment_map_samples: int
    num_brdf_samples: int
    num_mis_samples: int
    local_light_mis_weight: float
    environment_map_mis_weight: float
    brdf_mis_weight: float
    brdf_cutoff: float
    brdf_ray_min_t: float


def init_sample_parameters(num_local, num_infinite, num_environment, num_brdf,
                           brdf_cutoff=0.0, brdf_ray_min_t=0.001
                           ) -> SampleParameters:
    """(InitialSamplingFunctions.hlsli:51-73)."""
    num_mis = max(num_local + num_environment + num_brdf, 1)
    return SampleParameters(
        num_local_light_samples=num_local,
        num_infinite_light_samples=num_infinite,
        num_environment_map_samples=num_environment,
        num_brdf_samples=num_brdf,
        num_mis_samples=num_local + num_environment + num_brdf,
        local_light_mis_weight=num_local / num_mis,
        environment_map_mis_weight=num_environment / num_mis,
        brdf_mis_weight=num_brdf / num_mis,
        brdf_cutoff=brdf_cutoff,
        brdf_ray_min_t=brdf_ray_min_t)


def brdf_max_distance_from_pdf(brdf_cutoff: float, pdf: jax.Array) -> jax.Array:
    """(InitialSamplingFunctions.hlsli:76-80)."""
    flt_max = jnp.float32(3.402823466e38)
    if brdf_cutoff <= 0.0:
        return jnp.full(pdf.shape, flt_max)
    return jnp.sqrt(jnp.maximum((1.0 / brdf_cutoff - 1.0) * pdf, 0.0))


def _empty_light_sample(shape) -> LightSample:
    z3 = jnp.zeros(shape + (3,), jnp.float32)
    return LightSample(
        position=z3, normal=z3, radiance=z3,
        solid_angle_pdf=jnp.zeros(shape, jnp.float32),
        light_type=jnp.zeros(shape, jnp.uint32))


def _select_sample(mask, a: LightSample, b: LightSample) -> LightSample:
    m = mask[..., None]
    return LightSample(
        position=jnp.where(m, a.position, b.position),
        normal=jnp.where(m, a.normal, b.normal),
        radiance=jnp.where(m, a.radiance, b.radiance),
        solid_angle_pdf=jnp.where(mask, a.solid_angle_pdf, b.solid_angle_pdf),
        light_type=jnp.where(mask, a.light_type, b.light_type))


def light_brdf_mis_weight(bridge: Bridge, surface: Surface,
                          light_sample: LightSample,
                          light_selection_pdf: jax.Array,
                          light_mis_weight: float,
                          is_environment_map: bool,
                          sample_params: SampleParameters) -> jax.Array:
    """(InitialSamplingFunctions.hlsli:85-115)."""
    sa_pdf = light_sample.solid_angle_pdf
    analytic = ((light_sample.light_type != K_TRIANGLE)
                & (light_sample.light_type != K_ENVIRONMENT))
    simple = (sample_params.brdf_mis_weight == 0) | analytic \
        | (sa_pdf <= 0) | ~jnp.isfinite(sa_pdf)
    simple_weight = light_mis_weight * light_selection_pdf

    # RAB_GetLightDirDistance (bridge:527-542)
    to_light = light_sample.position - surface.world_pos
    dist = jnp.linalg.norm(to_light, axis=-1)
    ldir_local = to_light / jnp.maximum(dist, 1e-30)[..., None]
    env = light_sample.light_type == K_ENVIRONMENT
    ldir = jnp.where(env[..., None], -light_sample.normal, ldir_local)
    dist = jnp.where(env, 1000.0, dist)

    brdf_pdf = bridge.get_surface_brdf_pdf(surface, ldir)
    max_dist = brdf_max_distance_from_pdf(sample_params.brdf_cutoff, brdf_pdf)
    if not is_environment_map:
        brdf_pdf = jnp.where(dist > max_dist, 0.0, brdf_pdf)

    src_sa = light_selection_pdf * sa_pdf
    blended = (light_mis_weight * src_sa
               + sample_params.brdf_mis_weight * brdf_pdf)
    full_weight = blended / jnp.maximum(sa_pdf, 1e-30)
    return jnp.where(simple, simple_weight, full_weight)


# ---------------------------------------------------------------------------
# RIS tiles (RISBuffer.hlsli)
# ---------------------------------------------------------------------------

class RISTileInfo(NamedTuple):
    """(RISBuffer.hlsli:14-18) — per-lane arrays."""

    offset: jax.Array  # u32
    size: int


def randomly_select_ris_tile(coherent_rng: rtrng.RngState,
                             params: RISBufferSegmentParameters
                             ) -> tuple[RISTileInfo, rtrng.RngState]:
    """(RISBuffer.hlsli:32-42)."""
    rnd, coherent_rng = rtrng.sample_uniform(coherent_rng)
    tile = (rnd * params.tile_count).astype(jnp.uint32)
    return RISTileInfo(
        offset=tile * params.tile_size + params.buffer_offset,
        size=params.tile_size), coherent_rng


def randomly_select_light_data_from_ris_tile(
        rng: rtrng.RngState, tile: RISTileInfo, ris_buffer: jax.Array
) -> tuple[jax.Array, jax.Array, rtrng.RngState]:
    """(RISBuffer.hlsli:20-30). ris_buffer: [S, 2] u32.
    Returns (tile_data [.., 2], ris_ptr, rng)."""
    rnd, rng = rtrng.sample_uniform(rng)
    sample = jnp.minimum((rnd * tile.size).astype(jnp.uint32), tile.size - 1)
    ptr = (sample + tile.offset).astype(jnp.int32)
    return ris_buffer[ptr], ptr, rng


# ---------------------------------------------------------------------------
# Candidate streams
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LightSamplingContext:
    """Static sampling configuration + device light tables the candidate
    streams read. Groups what the GLSL passes as globals."""

    lights: LightInfo  # [L] full light table
    light_buffer_params: LightBufferParameters
    local_light_sampling_mode: int = 0  # 0 uniform, 1 power RIS, 2 ReGIR
    enable_presampling: bool = False
    ris_buffer: jax.Array | None = None  # [S, 2] u32
    local_ris_params: RISBufferSegmentParameters | None = None
    env_ris_params: RISBufferSegmentParameters | None = None
    # ReGIR world-space grid (local_light_sampling_mode == 2)
    regir_ris_buffer: jax.Array | None = None  # [cells * per_cell, 2] u32
    regir_params: object | None = None  # regir.ReGIRGridParameters


def sample_local_lights(
    rng: rtrng.RngState,
    coherent_rng: rtrng.RngState,
    surface: Surface,
    sample_params: SampleParameters,
    ctx: LightSamplingContext,
    bridge: Bridge,
) -> tuple[DIReservoir, LightSample, rtrng.RngState, rtrng.RngState]:
    """(InitialSamplingFunctions.hlsli:261-343)."""
    shape = surface.view_depth.shape
    state = empty_di_reservoir(shape)
    selected = _empty_light_sample(shape)
    region = ctx.light_buffer_params.local_light_buffer_region
    if (region.num_lights == 0
            or sample_params.num_local_light_samples == 0):
        return state, selected, rng, coherent_rng

    use_ris = (ctx.enable_presampling
               and ctx.local_light_sampling_mode == 1
               and ctx.ris_buffer is not None)
    use_regir = (ctx.enable_presampling
                 and ctx.local_light_sampling_mode == 2
                 and ctx.regir_ris_buffer is not None
                 and ctx.regir_params is not None)
    if use_ris:
        tile, coherent_rng = randomly_select_ris_tile(
            coherent_rng, ctx.local_ris_params)
    if use_regir:
        # RTXDI_CalculateReGIRCellIndex (InitialSamplingFunctions.hlsli:
        # 165-183): jitter the sampling position, find the grid cell
        from raytracer2.restir import regir as regir_mod

        jit3, coherent_rng = rtrng.sample_uniform_n(coherent_rng, 3)
        pos = (surface.world_pos + (jit3 - 0.5)
               * regir_mod.get_jitter_scale(ctx.regir_params,
                                            surface.world_pos))
        regir_cell = regir_mod.world_pos_to_cell_index(ctx.regir_params, pos)

    for _ in range(sample_params.num_local_light_samples):
        if use_regir:
            # lanes inside the grid draw from their cell; lanes outside
            # fall back to uniform (the GLSL picks one path per pixel,
            # :211-219; the masked form consumes both rng draws on every
            # lane — statistics match, sequences differ)
            from raytracer2.restir import regir as regir_mod

            li_r, inv_r, valid_r, rng = regir_mod.select_light_from_regir_cell(
                rng, ctx.regir_ris_buffer, regir_cell, ctx.regir_params)
            rnd, rng = rtrng.sample_uniform(rng)
            li_u = (region.first_light_index + jnp.minimum(
                (rnd * region.num_lights).astype(jnp.uint32),
                region.num_lights - 1))
            light_index = jnp.where(valid_r, li_r, li_u)
            inv_source_pdf = jnp.where(
                valid_r, inv_r, jnp.float32(region.num_lights))
            light_info = LightInfo(*(l[light_index.astype(jnp.int32)]
                                     for l in ctx.lights))
        elif use_ris:
            tile_data, ris_ptr, rng = randomly_select_light_data_from_ris_tile(
                rng, tile, ctx.ris_buffer)
            light_index = tile_data[..., 0] & jnp.uint32(0x7FFFFFFF)
            inv_source_pdf = jax.lax.bitcast_convert_type(
                tile_data[..., 1], jnp.float32)
            # compact-light reload is equivalent to table load here: our
            # compact records round-trip the same fields
            light_info = LightInfo(*(l[jnp.maximum(
                light_index.astype(jnp.int32), 0)] for l in ctx.lights))
        else:
            rnd, rng = rtrng.sample_uniform(rng)
            inv_source_pdf = jnp.full(shape, float(region.num_lights),
                                      jnp.float32)
            light_index = (region.first_light_index + jnp.minimum(
                (rnd * region.num_lights).astype(jnp.uint32),
                region.num_lights - 1))
            light_info = LightInfo(*(l[light_index.astype(jnp.int32)]
                                     for l in ctx.lights))

        uv, rng = rtrng.sample_uniform_n(rng, 2)
        candidate = bridge.sample_polymorphic_light(light_info, surface, uv)
        blended_pdf = light_brdf_mis_weight(
            bridge, surface, candidate, 1.0 / inv_source_pdf,
            sample_params.local_light_mis_weight, False, sample_params)
        target_pdf = bridge.get_light_sample_target_pdf(candidate, surface)
        ris_rnd, rng = rtrng.sample_uniform(rng)
        nonzero = blended_pdf != 0.0
        state, sel = stream_sample(
            state, light_index, uv, ris_rnd, target_pdf,
            1.0 / jnp.where(nonzero, blended_pdf, 1.0), active=nonzero)
        selected = _select_sample(sel, candidate, selected)

    state = finalize_resampling(state, 1.0, float(sample_params.num_mis_samples))
    state = state._replace(m=jnp.ones(shape, jnp.float32))
    return state, selected, rng, coherent_rng


def sample_infinite_lights(
    rng: rtrng.RngState,
    surface: Surface,
    num_samples: int,
    ctx: LightSamplingContext,
    bridge: Bridge,
) -> tuple[DIReservoir, LightSample, rtrng.RngState]:
    """(InitialSamplingFunctions.hlsli:378-409)."""
    shape = surface.view_depth.shape
    state = empty_di_reservoir(shape)
    selected = _empty_light_sample(shape)
    region = ctx.light_buffer_params.infinite_light_buffer_region
    if region.num_lights == 0 or num_samples == 0:
        return state, selected, rng

    for _ in range(num_samples):
        rnd, rng = rtrng.sample_uniform(rng)
        inv_source_pdf = jnp.full(shape, float(region.num_lights), jnp.float32)
        light_index = (region.first_light_index + jnp.minimum(
            (rnd * region.num_lights).astype(jnp.uint32),
            region.num_lights - 1))
        light_info = LightInfo(*(l[light_index.astype(jnp.int32)]
                                 for l in ctx.lights))
        uv, rng = rtrng.sample_uniform_n(rng, 2)
        candidate = bridge.sample_polymorphic_light(light_info, surface, uv)
        target_pdf = bridge.get_light_sample_target_pdf(candidate, surface)
        ris_rnd, rng = rtrng.sample_uniform(rng)
        state, sel = stream_sample(
            state, light_index, uv, ris_rnd, target_pdf, inv_source_pdf)
        selected = _select_sample(sel, candidate, selected)

    state = finalize_resampling(state, 1.0, state.m)
    state = state._replace(m=jnp.ones(shape, jnp.float32))
    return state, selected, rng


def sample_environment_map(
    rng: rtrng.RngState,
    coherent_rng: rtrng.RngState,
    surface: Surface,
    sample_params: SampleParameters,
    ctx: LightSamplingContext,
    bridge: Bridge,
) -> tuple[DIReservoir, LightSample, rtrng.RngState, rtrng.RngState]:
    """(InitialSamplingFunctions.hlsli:465-499; presampling only)."""
    shape = surface.view_depth.shape
    state = empty_di_reservoir(shape)
    selected = _empty_light_sample(shape)
    env = ctx.light_buffer_params.environment_light_params
    if (not ctx.enable_presampling or env.light_present == 0
            or sample_params.num_environment_map_samples == 0
            or ctx.ris_buffer is None):
        return state, selected, rng, coherent_rng

    tile, coherent_rng = randomly_select_ris_tile(
        coherent_rng, ctx.env_ris_params)
    light_info = LightInfo(*(l[jnp.full(shape, env.light_index, jnp.int32)]
                             for l in ctx.lights))

    for _ in range(sample_params.num_environment_map_samples):
        tile_data, _, rng = randomly_select_light_data_from_ris_tile(
            rng, tile, ctx.ris_buffer)
        packed_uv = tile_data[..., 0]
        inv_source_pdf = jax.lax.bitcast_convert_type(
            tile_data[..., 1], jnp.float32)
        uv = jnp.stack([(packed_uv & 0xFFFF).astype(jnp.float32),
                        (packed_uv >> 16).astype(jnp.float32)],
                       axis=-1) / 65535.0
        candidate = bridge.sample_polymorphic_light(light_info, surface, uv)
        blended_pdf = light_brdf_mis_weight(
            bridge, surface, candidate,
            1.0 / jnp.maximum(inv_source_pdf, 1e-30),
            sample_params.environment_map_mis_weight, True, sample_params)
        target_pdf = bridge.get_light_sample_target_pdf(candidate, surface)
        ris_rnd, rng = rtrng.sample_uniform(rng)
        nonzero = (blended_pdf != 0.0) & (inv_source_pdf > 0.0)
        state, sel = stream_sample(
            state, jnp.full(shape, env.light_index, jnp.uint32), uv, ris_rnd,
            target_pdf, 1.0 / jnp.where(nonzero, blended_pdf, 1.0),
            active=nonzero)
        selected = _select_sample(sel, candidate, selected)

    state = finalize_resampling(state, 1.0, float(sample_params.num_mis_samples))
    state = state._replace(m=jnp.ones(shape, jnp.float32))
    return state, selected, rng, coherent_rng


def sample_brdf(
    rng: rtrng.RngState,
    surface: Surface,
    sample_params: SampleParameters,
    ctx: LightSamplingContext,
    bridge: Bridge,
) -> tuple[DIReservoir, LightSample, rtrng.RngState]:
    """RTXDI_SampleBrdf (InitialSamplingFunctions.hlsli:507-591): sample the
    BRDF, trace the candidate ray (batched), identify the hit light or fall
    through to the environment."""
    shape = surface.view_depth.shape
    state = empty_di_reservoir(shape)
    selected = _empty_light_sample(shape)
    env = ctx.light_buffer_params.environment_light_params

    for _ in range(sample_params.num_brdf_samples):
        sample_dir, dir_valid, rng = bridge.get_surface_brdf_sample(
            surface, rng)
        brdf_pdf = bridge.get_surface_brdf_pdf(surface, sample_dir)
        max_dist = brdf_max_distance_from_pdf(
            sample_params.brdf_cutoff, brdf_pdf)

        hit_anything, light_index, rand_xy = bridge.trace_ray_for_local_light(
            surface.world_pos, sample_dir,
            jnp.full(shape, sample_params.brdf_ray_min_t, jnp.float32),
            max_dist)
        # lanes with an invalid brdf sample trace nothing
        hit_anything = hit_anything & dir_valid
        light_index = jnp.where(dir_valid, light_index,
                                jnp.uint32(RTXDI_INVALID_LIGHT_INDEX))

        hit_light = light_index != jnp.uint32(RTXDI_INVALID_LIGHT_INDEX)
        light_info = LightInfo(*(l[jnp.where(
            hit_light, light_index, 0).astype(jnp.int32)]
            for l in ctx.lights))
        candidate_local = bridge.sample_polymorphic_light(
            light_info, surface, rand_xy)

        if sample_params.brdf_cutoff > 0.0:
            to_light = candidate_local.position - surface.world_pos
            dist = jnp.linalg.norm(to_light, axis=-1)
            ldir = to_light / jnp.maximum(dist, 1e-30)[..., None]
            pdf2 = bridge.get_surface_brdf_pdf(surface, ldir)
            max2 = brdf_max_distance_from_pdf(sample_params.brdf_cutoff, pdf2)
            hit_light &= dist <= max2

        local_pdf = jnp.where(
            hit_light,
            bridge.evaluate_local_light_source_pdf(light_index), 0.0)

        # environment fall-through (:556-564)
        env_case = dir_valid & ~hit_anything & (env.light_present != 0)
        if env.light_present:
            from raytracer2.utils.brdf import direction_to_equirect_uv

            env_info = LightInfo(*(
                l[jnp.full(shape, env.light_index, jnp.int32)]
                for l in ctx.lights))
            env_uv = direction_to_equirect_uv(sample_dir)
            candidate_env = bridge.sample_polymorphic_light(
                env_info, surface, env_uv)
            env_pdf = bridge.evaluate_environment_map_sampling_pdf(sample_dir)
            candidate = _select_sample(env_case, candidate_env,
                                       candidate_local)
            light_index = jnp.where(env_case,
                                    jnp.uint32(env.light_index), light_index)
            rand_xy = jnp.where(env_case[..., None], env_uv, rand_xy)
            source_pdf = jnp.where(env_case, env_pdf, local_pdf)
        else:
            candidate = candidate_local
            source_pdf = local_pdf

        live = source_pdf != 0.0
        is_env = light_index == env.light_index
        target_pdf = bridge.get_light_sample_target_pdf(candidate, surface)
        mis_w_env = light_brdf_mis_weight(
            bridge, surface, candidate, source_pdf,
            sample_params.environment_map_mis_weight, True, sample_params)
        mis_w_local = light_brdf_mis_weight(
            bridge, surface, candidate, source_pdf,
            sample_params.local_light_mis_weight, False, sample_params)
        blended_pdf = jnp.where(is_env, mis_w_env, mis_w_local)

        ris_rnd, advanced = rtrng.sample_uniform(rng)
        rng = rtrng.RngState(seed=rng.seed,
                             index=jnp.where(live, advanced.index, rng.index))
        state, sel = stream_sample(
            state, light_index, rand_xy, ris_rnd, target_pdf,
            1.0 / jnp.where(blended_pdf != 0, blended_pdf, 1.0),
            active=live & (blended_pdf != 0))
        selected = _select_sample(sel, candidate, selected)

    state = finalize_resampling(state, 1.0, float(sample_params.num_mis_samples))
    state = state._replace(m=jnp.ones(shape, jnp.float32))
    return state, selected, rng


def sample_lights_for_surface(
    rng: rtrng.RngState,
    coherent_rng: rtrng.RngState,
    surface: Surface,
    sample_params: SampleParameters,
    ctx: LightSamplingContext,
    bridge: Bridge,
) -> tuple[DIReservoir, LightSample, rtrng.RngState, rtrng.RngState]:
    """RTXDI_SampleLightsForSurface (InitialSamplingFunctions.hlsli:594-664):
    RIS-combine the four candidate reservoirs."""
    local_res, local_sample, rng, coherent_rng = sample_local_lights(
        rng, coherent_rng, surface, sample_params, ctx, bridge)
    inf_res, inf_sample, rng = sample_infinite_lights(
        rng, surface, sample_params.num_infinite_light_samples, ctx, bridge)
    if ctx.enable_presampling:
        env_res, env_sample, rng, coherent_rng = sample_environment_map(
            rng, coherent_rng, surface, sample_params, ctx, bridge)
    brdf_res, brdf_sample, rng = sample_brdf(
        rng, surface, sample_params, ctx, bridge)

    shape = surface.view_depth.shape
    state = empty_di_reservoir(shape)
    state, _ = combine_reservoirs(state, local_res, 0.5, local_res.target_pdf)
    r1, rng = rtrng.sample_uniform(rng)
    state, sel_inf = combine_reservoirs(state, inf_res, r1, inf_res.target_pdf)
    if ctx.enable_presampling:
        r2, rng = rtrng.sample_uniform(rng)
        state, sel_env = combine_reservoirs(state, env_res, r2,
                                            env_res.target_pdf)
    r3, rng = rtrng.sample_uniform(rng)
    state, sel_brdf = combine_reservoirs(state, brdf_res, r3,
                                         brdf_res.target_pdf)

    state = finalize_resampling(state, 1.0, 1.0)
    state = state._replace(m=jnp.ones(shape, jnp.float32))

    out = local_sample
    out = _select_sample(sel_inf, inf_sample, out)
    if ctx.enable_presampling:
        out = _select_sample(sel_env, env_sample, out)
    out = _select_sample(sel_brdf, brdf_sample, out)
    return state, out, rng, coherent_rng
