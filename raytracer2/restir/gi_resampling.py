"""ReSTIR GI temporal and spatial resampling, whole-image vectorized.

Port of rtxdi/GIResamplingFunctions.hlsli restructured for whole-array
execution: the per-pixel loops with `break`/`continue` become fixed-trip
masked iterations,
reservoir buffer loads become gathers on [H, W] SoA arrays, and the optional
bias-correction visibility ray (mode 3) is issued as ONE batched occlusion
query over all lanes per pass instead of per-thread traceRayEXT
(SURVEY.md §7 step 6: collect-rays -> batched traversal -> resume-merge).

RNG parity: lanes that skip a draw in the GLSL (failed tests, early break)
also skip advancing their murmur3 counter here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp

from raytracer2.restir import helpers
from raytracer2.restir.bridge import Bridge, validate_gi_sample_with_jacobian
from raytracer2.restir.gi_reservoir import (
    GIReservoir, empty_gi_reservoir, is_valid, where_gi)
from raytracer2.render.surface import Surface
from raytracer2.utils import rng as rtrng
from raytracer2.utils.brdf import dot3, saturate


def _gather_reservoir(buf: GIReservoir, x, y) -> GIReservoir:
    """Gather per-pixel reservoirs from a [H, W] SoA buffer."""
    return GIReservoir(
        position=buf.position[y, x], normal=buf.normal[y, x],
        radiance=buf.radiance[y, x], weight_sum=buf.weight_sum[y, x],
        m=buf.m[y, x], age=buf.age[y, x])


def combine_gi_reservoirs(res: GIReservoir, new_res: GIReservoir,
                          random, target_pdf,
                          active=None) -> tuple[GIReservoir, jax.Array]:
    """RTXDI_CombineGIReservoirs (GIResamplingFunctions.hlsli:28-55)."""
    if active is None:
        active = jnp.ones(res.weight_sum.shape, bool)
    ris_weight = target_pdf * new_res.weight_sum * new_res.m.astype(jnp.float32)
    m = res.m + jnp.where(active, new_res.m, 0)
    weight_sum = res.weight_sum + jnp.where(active, ris_weight, 0.0)
    select = active & (random * weight_sum <= ris_weight)
    out = GIReservoir(
        position=jnp.where(select[..., None], new_res.position, res.position),
        normal=jnp.where(select[..., None], new_res.normal, res.normal),
        radiance=jnp.where(select[..., None], new_res.radiance, res.radiance),
        weight_sum=weight_sum, m=m,
        age=jnp.where(select, new_res.age, res.age))
    return out, select


def finalize_gi_resampling(res: GIReservoir, numerator, denominator
                           ) -> GIReservoir:
    """(GIResamplingFunctions.hlsli:58-64)."""
    w = jnp.where(denominator == 0.0, 0.0,
                  res.weight_sum * numerator
                  / jnp.where(denominator == 0.0, 1.0, denominator))
    return res._replace(weight_sum=w)


def calculate_jacobian(receiver_pos, neighbor_receiver_pos,
                       neighbor_res: GIReservoir) -> jax.Array:
    """Solid-angle reuse Jacobian (GIResamplingFunctions.hlsli:67-93)."""
    def partial(recv):
        vec = recv - neighbor_res.position
        dist = jnp.linalg.norm(vec, axis=-1)
        cos = saturate(dot3(neighbor_res.normal,
                            vec / jnp.maximum(dist, 1e-30)[..., None]))
        return dist, cos

    new_dist, new_cos = partial(receiver_pos)
    orig_dist, orig_cos = partial(neighbor_receiver_pos)
    jac = (new_cos * orig_dist * orig_dist) / jnp.maximum(
        orig_cos * new_dist * new_dist, 1e-30)
    jac = jnp.where(orig_cos * new_dist * new_dist <= 0.0, 0.0, jac)
    return jnp.where(jnp.isfinite(jac), jac, 0.0)


@dataclasses.dataclass(frozen=True)
class GITemporalSpec:
    """Static subset of GITemporalResamplingParameters the compiled kernel
    specializes on (the dynamic parts — motion, random number — are args)."""

    max_history_length: int = 20
    bias_correction_mode: int = 2
    depth_threshold: float = 0.1
    normal_threshold: float = 0.3
    enable_permutation_sampling: bool = False
    enable_fallback_sampling: bool = True
    active_checkerboard_field: int = 0


def gi_temporal_resampling(
    px: jax.Array,  # [N] current pixel positions
    py: jax.Array,
    surface: Surface,  # current-frame surfaces at (px, py)
    input_reservoir: GIReservoir,  # [N]
    rng_state: rtrng.RngState,
    spec: GITemporalSpec,
    screen_space_motion: jax.Array,  # [N, 3] pixel-space motion
    uniform_random_number: jax.Array,  # u32 scalar
    max_reservoir_age,  # [N] or scalar (jittered per pixel by the caller)
    prev_reservoirs: GIReservoir,  # [H, W] source buffer (previous frame)
    bridge: Bridge,
    row_base=0,  # global row of the source tile's first row (sharding)
) -> tuple[GIReservoir, rtrng.RngState]:
    """RTXDI_GITemporalResampling (GIResamplingFunctions.hlsli:186-359)."""
    width, height = bridge.viewport
    n = px.shape[0]
    f32 = jnp.float32

    prev_x = jnp.round(px.astype(f32) + screen_space_motion[..., 0]).astype(jnp.int32)
    prev_y = jnp.round(py.astype(f32) + screen_space_motion[..., 1]).astype(jnp.int32)
    expected_prev_depth = surface.view_depth + screen_space_motion[..., 2]
    radius = 1 if spec.active_checkerboard_field == 0 else 2

    r, rng_state = rtrng.sample_uniform(rng_state)
    start_idx = (r * 8).astype(jnp.int32)

    found = jnp.zeros((n,), bool)
    sel_surface = None  # temporal surface of the found sample
    sel_res = empty_gi_reservoir((n,))

    temporal_sample_count = 5
    sample_count = temporal_sample_count + (
        1 if spec.enable_fallback_sampling else 0)

    for i in range(sample_count):
        is_first = i == 0
        is_fallback = i == temporal_sample_count

        if is_fallback:
            base_x, base_y = px, py
        else:
            base_x, base_y = prev_x, prev_y
        if is_first or is_fallback:
            ox = jnp.zeros((n,), jnp.int32)
            oy = jnp.zeros((n,), jnp.int32)
        else:
            ox, oy = helpers.calculate_temporal_resampling_offset(
                start_idx + i, radius)
        ix = base_x + ox
        iy = base_y + oy
        if (spec.enable_permutation_sampling and is_first) or is_fallback:
            ix, iy = helpers.apply_permutation_sampling(
                ix, iy, uniform_random_number)
        ix, iy = helpers.activate_checkerboard_pixel(
            ix, iy, True, spec.active_checkerboard_field)

        t_surface = bridge.get_gbuffer_surface(ix, iy, True)
        ok = t_surface.valid
        if not is_fallback:
            ok &= helpers.is_valid_neighbor(
                surface.normal, t_surface.normal,
                expected_prev_depth, t_surface.view_depth,
                spec.normal_threshold, spec.depth_threshold)
        ok &= bridge.are_materials_similar(surface, t_surface)

        rx, ry = helpers.pixel_pos_to_reservoir_pos(
            ix, iy, spec.active_checkerboard_field)
        # clamp to the reservoir ARRAY's extent: under checkerboard the
        # buffer is [H, W//2] while `width` is the full viewport
        rx = jnp.clip(rx, 0, prev_reservoirs.weight_sum.shape[1] - 1)
        ry = jnp.clip(ry, 0, height - 1)
        t_res = _gather_reservoir(
            prev_reservoirs, rx,
            jnp.clip(ry - row_base, 0,
                     prev_reservoirs.weight_sum.shape[0] - 1))
        ok &= is_valid(t_res)

        take = ok & ~found
        if sel_surface is None:
            sel_surface = t_surface
            sel_res = where_gi(take, t_res, sel_res)
        else:
            sel_surface = Surface(*(
                jnp.where(take[..., None] if a.ndim > take.ndim else take,
                          a, b)
                for a, b in zip(t_surface, sel_surface)))
            sel_res = where_gi(take, t_res, sel_res)
        found = found | take

    # start with the input reservoir (random = 0.5, :277-282)
    cur = empty_gi_reservoir((n,))
    input_valid = is_valid(input_reservoir)
    in_pdf = bridge.get_gi_sample_target_pdf(
        input_reservoir.position, input_reservoir.radiance, surface)
    selected_target_pdf = jnp.where(input_valid, in_pdf, 0.0)
    cur, _ = combine_gi_reservoirs(cur, input_reservoir, 0.5, in_pdf,
                                   active=input_valid)

    # jacobian / history clamps on the temporal sample (:284-304)
    jac = calculate_jacobian(surface.world_pos, sel_surface.world_pos, sel_res)
    jac_ok, jac = validate_gi_sample_with_jacobian(jac)
    found &= jac_ok
    sel_res = sel_res._replace(
        weight_sum=sel_res.weight_sum * jac,
        m=jnp.minimum(sel_res.m, spec.max_history_length),
        age=sel_res.age + 1)
    found &= sel_res.age <= jnp.asarray(max_reservoir_age, jnp.uint32)

    # temporal merge (1 conditional RNG draw, :306-318)
    t_pdf = bridge.get_gi_sample_target_pdf(
        sel_res.position, sel_res.radiance, surface)
    rr, advanced = rtrng.sample_uniform(rng_state)
    rng_state = rtrng.RngState(
        seed=rng_state.seed,
        index=jnp.where(found, advanced.index, rng_state.index))
    cur, selected_prev = combine_gi_reservoirs(cur, sel_res, rr, t_pdf,
                                               active=found)
    selected_target_pdf = jnp.where(selected_prev, t_pdf, selected_target_pdf)

    if spec.bias_correction_mode >= helpers.BIAS_CORRECTION_BASIC:
        # MIS-like normalization (:320-348)
        pi = selected_target_pdf
        pi_sum = selected_target_pdf * input_reservoir.m.astype(f32)
        use = is_valid(cur) & found
        temporal_p = bridge.get_gi_sample_target_pdf(
            cur.position, cur.radiance, sel_surface)
        if spec.bias_correction_mode == helpers.BIAS_CORRECTION_RAY_TRACED:
            # one batched visibility query (previous surface -> sample)
            visible = bridge.get_temporal_conservative_visibility(
                surface, sel_surface, cur.position)
            temporal_p = jnp.where(visible, temporal_p, 0.0)
        pi = jnp.where(use & selected_prev, temporal_p, pi)
        pi_sum = pi_sum + jnp.where(
            use, temporal_p * sel_res.m.astype(f32), 0.0)
        cur = finalize_gi_resampling(cur, pi, pi_sum * selected_target_pdf)
    else:
        cur = finalize_gi_resampling(
            cur, 1.0, selected_target_pdf * cur.m.astype(f32))

    return cur, rng_state


@dataclasses.dataclass(frozen=True)
class GISpatialSpec:
    """Static subset of GISpatialResamplingParameters."""

    depth_threshold: float = 0.1
    normal_threshold: float = 0.3
    num_samples: int = 1
    sampling_radius: float = 3.0
    bias_correction_mode: int = 2
    active_checkerboard_field: int = 0
    neighbor_offset_mask: int = 8191


def gi_spatial_resampling(
    px: jax.Array,
    py: jax.Array,
    surface: Surface,
    input_reservoir: GIReservoir,
    rng_state: rtrng.RngState,
    spec: GISpatialSpec,
    cur_reservoirs: GIReservoir,  # [H, W] source buffer (current frame)
    bridge: Bridge,
    row_base=0,
) -> tuple[GIReservoir, rtrng.RngState]:
    """RTXDI_GISpatialResampling (GIResamplingFunctions.hlsli:391-553)."""
    from raytracer2.render.surface import clamp_sample_position_into_view

    width, height = bridge.viewport
    n = px.shape[0]
    f32 = jnp.float32

    cur = empty_gi_reservoir((n,))
    input_valid = is_valid(input_reservoir)
    in_pdf = bridge.get_gi_sample_target_pdf(
        input_reservoir.position, input_reservoir.radiance, surface)
    selected_target_pdf = jnp.where(input_valid, in_pdf, 0.0)
    cur, _ = combine_gi_reservoirs(cur, input_reservoir, 0.5, in_pdf,
                                   active=input_valid)

    r, rng_state = rtrng.sample_uniform(rng_state)
    start_idx = (r * spec.neighbor_offset_mask).astype(jnp.int32)

    selected = jnp.full((n,), -1, jnp.int32)
    cached = []  # per-i merged masks (the cachedResult bits)
    neighbor_info = []  # (ix, iy) per i for the normalization walk

    for i in range(spec.num_samples):
        ox, oy = helpers.calculate_spatial_resampling_offset(
            start_idx + i, spec.sampling_radius, bridge.neighbor_offsets,
            spec.neighbor_offset_mask)
        ix, iy = clamp_sample_position_into_view(
            px + ox, py + oy, width, height)
        ix, iy = helpers.activate_checkerboard_pixel(
            ix, iy, False, spec.active_checkerboard_field)
        neighbor_info.append((ix, iy))

        n_surface = bridge.get_gbuffer_surface(ix, iy, False)
        ok = helpers.is_valid_neighbor(
            surface.normal, n_surface.normal,
            surface.view_depth, n_surface.view_depth,
            spec.normal_threshold, spec.depth_threshold)
        ok &= bridge.are_materials_similar(surface, n_surface)

        rx, ry = helpers.pixel_pos_to_reservoir_pos(
            ix, iy, spec.active_checkerboard_field)
        n_res = _gather_reservoir(
            cur_reservoirs,
            jnp.clip(rx, 0, cur_reservoirs.weight_sum.shape[1] - 1),
            jnp.clip(jnp.clip(ry, 0, height - 1) - row_base, 0,
                     cur_reservoirs.weight_sum.shape[0] - 1))
        ok &= is_valid(n_res)

        jac = calculate_jacobian(surface.world_pos, n_surface.world_pos, n_res)
        t_pdf = bridge.get_gi_sample_target_pdf(
            n_res.position, n_res.radiance, surface)
        jac_ok, jac = validate_gi_sample_with_jacobian(jac)
        ok &= jac_ok
        cached.append(ok)

        rr, advanced = rtrng.sample_uniform(rng_state)
        rng_state = rtrng.RngState(
            seed=rng_state.seed,
            index=jnp.where(ok, advanced.index, rng_state.index))
        cur, updated = combine_gi_reservoirs(cur, n_res, rr, t_pdf * jac,
                                             active=ok)
        selected = jnp.where(updated, i, selected)
        selected_target_pdf = jnp.where(updated, t_pdf, selected_target_pdf)

    if spec.bias_correction_mode >= helpers.BIAS_CORRECTION_BASIC:
        pi = selected_target_pdf
        pi_sum = selected_target_pdf * input_reservoir.m.astype(f32)
        for i in range(spec.num_samples):
            ix, iy = neighbor_info[i]
            ok = cached[i]
            n_surface = bridge.get_gbuffer_surface(ix, iy, False)
            rx, ry = helpers.pixel_pos_to_reservoir_pos(
                ix, iy, spec.active_checkerboard_field)
            n_res = _gather_reservoir(
                cur_reservoirs,
                jnp.clip(rx, 0, cur_reservoirs.weight_sum.shape[1] - 1),
                jnp.clip(jnp.clip(ry, 0, height - 1) - row_base, 0,
                         cur_reservoirs.weight_sum.shape[0] - 1))
            ps = bridge.get_gi_sample_target_pdf(
                cur.position, cur.radiance, n_surface)
            if spec.bias_correction_mode == helpers.BIAS_CORRECTION_RAY_TRACED:
                visible = bridge.get_conservative_visibility(
                    n_surface, cur.position)
                ps = jnp.where(visible, ps, 0.0)
            pi = jnp.where(ok & (selected == i), ps, pi)
            pi_sum = pi_sum + jnp.where(ok, ps * n_res.m.astype(f32), 0.0)
        cur = finalize_gi_resampling(cur, pi, selected_target_pdf * pi_sum)
    else:
        cur = finalize_gi_resampling(
            cur, 1.0, cur.m.astype(f32) * selected_target_pdf)

    return cur, rng_state


def gi_boiling_filter(reservoirs: GIReservoir, filter_strength
                      ) -> GIReservoir:
    """RTXDI_GIBoilingFilter (GIResamplingFunctions.hlsli:885-894) over a
    full [H, W] reservoir image."""
    from raytracer2.utils.brdf import luminance_rec709

    weight = luminance_rec709(reservoirs.radiance) * reservoirs.weight_sum
    kill = helpers.boiling_filter_mask(weight, filter_strength)
    return where_gi(kill, empty_gi_reservoir(weight.shape), reservoirs)


def gi_spatio_temporal_resampling(
    px: jax.Array,
    py: jax.Array,
    surface: Surface,
    input_reservoir: GIReservoir,
    rng_state: rtrng.RngState,
    t_spec: GITemporalSpec,
    s_spec: GISpatialSpec,
    screen_space_motion: jax.Array,
    uniform_random_number: jax.Array,
    max_reservoir_age,
    prev_reservoirs: GIReservoir,
    bridge: Bridge,
    row_base=0,
) -> tuple[GIReservoir, rtrng.RngState]:
    """RTXDI_GISpatioTemporalResampling (GIResamplingFunctions.hlsli:611-880).

    The reference's fused pass runs the 5+1 temporal surface search and then
    spatial neighbors against the SAME previous-frame source buffer. This
    composition performs the temporal merge followed by a spatial walk over
    the previous-frame reservoirs — the same sample set and normalization
    family, restructured for batched visibility."""
    merged, rng_state = gi_temporal_resampling(
        px, py, surface, input_reservoir, rng_state, t_spec,
        screen_space_motion, uniform_random_number, max_reservoir_age,
        prev_reservoirs, bridge, row_base=row_base)
    return gi_spatial_resampling(
        px, py, surface, merged, rng_state, s_spec, prev_reservoirs, bridge,
        row_base=row_base)
