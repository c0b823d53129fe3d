"""ReSTIR DI temporal and spatial resampling, whole-image vectorized.

Port of rtxdi/DIResamplingFunctions.hlsli with all four bias-correction
modes (off / basic / pairwise / ray-traced, RtxdiParameters.h:28-36).
Same vectorized restructure as the GI passes: fixed-trip masked loops, gathers on
[H, W] reservoir planes, batched visibility queries through the bridge.

Note: the reference's fused DI pass never actually calls these
(di_fused_resampling.rgen:69-70 commented out); they're provided for full
library capability parity and can be enabled via the frame graph.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from raytracer2.lights.polymorphic import LightInfo
from raytracer2.render.surface import Surface
from raytracer2.restir import helpers
from raytracer2.restir.bridge import Bridge
from raytracer2.restir.di_reservoir import (
    DIReservoir, combine_reservoirs, empty_di_reservoir, finalize_resampling,
    internal_simple_resample, is_valid, light_index, sample_uv)
from raytracer2.utils import rng as rtrng

NAIVE_SAMPLING_M_THRESHOLD = 2  # (DIResamplingFunctions.hlsli:27)
MAX_M = 0x3FFF


def _gather_di(buf: DIReservoir, x, y) -> DIReservoir:
    return DIReservoir(*(leaf[y, x] for leaf in buf))


def _target_pdf_helper(bridge: Bridge, reservoir: DIReservoir,
                       surface: Surface, prior_frame: bool = False):
    """RTXDI_TargetPdfHelper (DIResamplingFunctions.hlsli:30-37)."""
    info = bridge.load_light_info(light_index(reservoir), prior_frame)
    ls = bridge.sample_polymorphic_light(info, surface, sample_uv(reservoir))
    return bridge.get_light_sample_target_pdf(ls, surface), ls


def stream_neighbor_with_pairwise_mis(
    state: DIReservoir, random, neighbor: DIReservoir,
    neighbor_surface: Surface, canonical: DIReservoir,
    canonical_surface: Surface, num_neighbors, bridge: Bridge,
    active) -> tuple[DIReservoir, jax.Array]:
    """(DIResamplingFunctions.hlsli:46-83)."""
    n_at_c, _ = _target_pdf_helper(bridge, neighbor, canonical_surface)
    c_at_n, _ = _target_pdf_helper(bridge, canonical, neighbor_surface)
    n_at_n, _ = _target_pdf_helper(bridge, neighbor, neighbor_surface)
    c_at_c, _ = _target_pdf_helper(bridge, canonical, canonical_surface)
    n_at_c = jnp.maximum(n_at_c, 0.0)
    c_at_n = jnp.maximum(c_at_n, 0.0)
    n_at_n = jnp.maximum(n_at_n, 0.0)
    c_at_c = jnp.maximum(c_at_c, 0.0)

    w0 = helpers.pairwise_mis_weight(
        n_at_n, n_at_c, neighbor.m * num_neighbors, canonical.m)
    w1 = helpers.pairwise_mis_weight(
        c_at_n, c_at_c, neighbor.m * num_neighbors, canonical.m)
    m = neighbor.m * jnp.minimum(
        helpers.m_factor(n_at_n, n_at_c), helpers.m_factor(c_at_n, c_at_c))

    state = state._replace(
        canonical_weight=state.canonical_weight
        + jnp.where(active, 1.0 - w1, 0.0))
    return internal_simple_resample(
        state, neighbor, random, n_at_c, neighbor.weight_sum * w0, m,
        active=active)


def stream_canonical_with_pairwise_step(
    state: DIReservoir, random, canonical: DIReservoir,
    canonical_surface: Surface) -> tuple[DIReservoir, jax.Array]:
    """(DIResamplingFunctions.hlsli:88-97)."""
    return internal_simple_resample(
        state, canonical, random, canonical.target_pdf,
        canonical.weight_sum * state.canonical_weight, canonical.m)


@dataclasses.dataclass(frozen=True)
class DITemporalSpec:
    max_history_length: int = 5
    bias_correction_mode: int = 2
    depth_threshold: float = 0.1
    normal_threshold: float = 0.3
    enable_visibility_shortcut: bool = True  # discard_invisible_samples
    enable_permutation_sampling: bool = False
    active_checkerboard_field: int = 0


def di_temporal_resampling(
    px: jax.Array, py: jax.Array,
    surface: Surface,
    cur_sample: DIReservoir,
    rng: rtrng.RngState,
    spec: DITemporalSpec,
    screen_space_motion: jax.Array,  # [N, 3] pixel space
    uniform_random_number,
    prev_reservoirs: DIReservoir,  # [H, W] (or a halo-padded row tile)
    bridge: Bridge,
    row_base=0,  # global row of prev_reservoirs' first row (sharding)
) -> tuple[DIReservoir, rtrng.RngState]:
    """RTXDI_DITemporalResampling (DIResamplingFunctions.hlsli:170-360).
    px/py may be flat [N] or any pixel grid shape (e.g. [H, W]).

    Under row sharding prev_reservoirs is a LOCAL halo-padded tile and
    row_base maps global rows into it (ADVICE r4: global rows gathered
    into a local slab silently clamp to wrong rows otherwise)."""
    width, height = bridge.viewport
    shape = px.shape
    f32 = jnp.float32

    bias_mode = spec.bias_correction_mode
    if bias_mode == helpers.BIAS_CORRECTION_PAIRWISE:
        bias_mode = helpers.BIAS_CORRECTION_BASIC  # (:181-185)

    history_limit = jnp.minimum(
        f32(MAX_M), spec.max_history_length * cur_sample.m)

    state = empty_di_reservoir(shape)
    state, _ = combine_reservoirs(state, cur_sample, 0.5,
                                  cur_sample.target_pdf)

    motion = screen_space_motion
    if not spec.enable_permutation_sampling:
        # jitter the reprojection (:204-207): 2 unconditional draws
        jx, rng = rtrng.sample_uniform(rng)
        jy, rng = rtrng.sample_uniform(rng)
        motion = motion.at[..., 0].add(jx - 0.5)
        motion = motion.at[..., 1].add(jy - 0.5)

    prev_x = jnp.round(px.astype(f32) + motion[..., 0]).astype(jnp.int32)
    prev_y = jnp.round(py.astype(f32) + motion[..., 1]).astype(jnp.int32)
    expected_prev_depth = surface.view_depth + motion[..., 2]
    radius = 4.0 if spec.active_checkerboard_field == 0 else 8.0

    found = jnp.zeros(shape, bool)
    sel_x = prev_x
    sel_y = prev_y
    sel_surface = None
    sel_offset = jnp.zeros(shape + (2,), jnp.int32)

    # 9-candidate surface search (:220-254); draws 2 uniforms per i>0 —
    # GLSL lanes that break early stop drawing
    for i in range(9):
        if i == 0:
            ox = jnp.zeros(shape, jnp.int32)
            oy = jnp.zeros(shape, jnp.int32)
        else:
            rx_, adv = rtrng.sample_uniform(rng)
            rng = rtrng.RngState(
                seed=rng.seed, index=jnp.where(~found, adv.index, rng.index))
            ry_, adv = rtrng.sample_uniform(rng)
            rng = rtrng.RngState(
                seed=rng.seed, index=jnp.where(~found, adv.index, rng.index))
            ox = ((rx_ - 0.5) * radius).astype(jnp.int32)
            oy = ((ry_ - 0.5) * radius).astype(jnp.int32)

        ix = prev_x + ox
        iy = prev_y + oy
        if spec.enable_permutation_sampling and i == 0:
            ix, iy = helpers.apply_permutation_sampling(
                ix, iy, uniform_random_number)
        ix, iy = helpers.activate_checkerboard_pixel(
            ix, iy, True, spec.active_checkerboard_field)

        t_surface = bridge.get_gbuffer_surface(ix, iy, True)
        ok = t_surface.valid & helpers.is_valid_neighbor(
            surface.normal, t_surface.normal,
            expected_prev_depth, t_surface.view_depth,
            spec.normal_threshold, spec.depth_threshold)
        take = ok & ~found
        sel_x = jnp.where(take, ix, sel_x)
        sel_y = jnp.where(take, iy, sel_y)
        sel_offset = jnp.where(take[..., None],
                               jnp.stack([ox, oy], -1), sel_offset)
        if sel_surface is None:
            sel_surface = t_surface
        else:
            sel_surface = Surface(*(
                jnp.where(take[..., None] if a.ndim > take.ndim else take,
                          a, b) for a, b in zip(t_surface, sel_surface)))
        found = found | take

    # load + merge the previous reservoir (:259-316)
    rx, ry = helpers.pixel_pos_to_reservoir_pos(
        jnp.clip(sel_x, 0, prev_reservoirs.weight_sum.shape[1] - 1),
        jnp.clip(sel_y, 0, height - 1),
        spec.active_checkerboard_field)
    prev = _gather_di(
        prev_reservoirs, rx,
        jnp.clip(ry - row_base, 0, prev_reservoirs.weight_sum.shape[0] - 1))
    prev = prev._replace(
        m=jnp.minimum(prev.m, history_limit),
        spatial_distance=prev.spatial_distance + sel_offset,
        age=prev.age + 1)
    # RAB_TranslateLightIndex is identity (bridge:589-592)

    info = bridge.load_light_info(light_index(prev), False)
    candidate = bridge.sample_polymorphic_light(info, surface, sample_uv(prev))
    weight_at_current = jnp.where(
        is_valid(prev),
        bridge.get_light_sample_target_pdf(candidate, surface), 0.0)

    rr, adv = rtrng.sample_uniform(rng)
    rng = rtrng.RngState(seed=rng.seed,
                         index=jnp.where(found, adv.index, rng.index))
    prev_m = jnp.where(found, prev.m, 0.0)
    state, selected_prev = combine_reservoirs(
        state, prev, rr, weight_at_current, active=found)

    if bias_mode >= helpers.BIAS_CORRECTION_BASIC:
        pi = state.target_pdf
        pi_sum = state.target_pdf * cur_sample.m
        use = is_valid(state) & found & (prev_m > 0)
        # pdf of the selected sample at the temporal surface (:329-335)
        sel_info = bridge.load_light_info(light_index(state), True)
        sel_at_temporal = bridge.sample_polymorphic_light(
            sel_info, sel_surface, sample_uv(state))
        temporal_p = bridge.get_light_sample_target_pdf(
            sel_at_temporal, sel_surface)
        if bias_mode == helpers.BIAS_CORRECTION_RAY_TRACED:
            need_ray = (temporal_p > 0) & (
                ~selected_prev | (not spec.enable_visibility_shortcut))
            visible = bridge.get_temporal_conservative_visibility(
                surface, sel_surface, sel_at_temporal.position)
            temporal_p = jnp.where(need_ray & ~visible, 0.0, temporal_p)
        pi = jnp.where(use & selected_prev, temporal_p, pi)
        pi_sum = pi_sum + jnp.where(use, temporal_p * prev_m, 0.0)
        state = finalize_resampling(state, pi, pi_sum)
    else:
        state = finalize_resampling(state, 1.0, state.m)

    return state, rng


@dataclasses.dataclass(frozen=True)
class DISpatialSpec:
    num_samples: int = 3
    num_disocclusion_boost_samples: int = 2
    target_history_length: int = 0
    bias_correction_mode: int = 2
    sampling_radius: float = 32.0
    depth_threshold: float = 0.1
    normal_threshold: float = 0.3
    enable_material_similarity_test: bool = True
    discount_naive_samples: bool = False
    active_checkerboard_field: int = 0
    neighbor_offset_mask: int = 8191


def di_spatial_resampling(
    px: jax.Array, py: jax.Array,
    surface: Surface,
    center_sample: DIReservoir,
    rng: rtrng.RngState,
    spec: DISpatialSpec,
    cur_reservoirs: DIReservoir,  # [H, W] source buffer (or halo tile)
    bridge: Bridge,
    row_base=0,  # global row of cur_reservoirs' first row (sharding)
) -> tuple[DIReservoir, rtrng.RngState]:
    """RTXDI_DISpatialResampling (DIResamplingFunctions.hlsli:504-677),
    including the pairwise-MIS variant (:409-494). Under row sharding
    cur_reservoirs is a local halo-padded tile addressed via row_base."""
    from raytracer2.render.surface import clamp_sample_position_into_view

    width, height = bridge.viewport
    shape = px.shape
    f32 = jnp.float32

    # note: the disocclusion boost expands the loop per-lane in the GLSL; we
    # take the static max and mask the extra samples per lane
    max_samples = min(max(spec.num_samples,
                          spec.num_disocclusion_boost_samples), 32)
    boost = center_sample.m < spec.target_history_length
    lane_samples = jnp.where(
        boost,
        max(spec.num_disocclusion_boost_samples, spec.num_samples),
        spec.num_samples)

    pairwise = spec.bias_correction_mode == helpers.BIAS_CORRECTION_PAIRWISE

    state = empty_di_reservoir(shape)
    if pairwise:
        pass  # canonical streamed at the end (:420-421, 482-483)
    else:
        state, _ = combine_reservoirs(state, center_sample, 0.5,
                                      center_sample.target_pdf)

    r0, rng = rtrng.sample_uniform(rng)
    start_idx = (r0 * spec.neighbor_offset_mask).astype(jnp.int32)

    selected = jnp.full(shape, -1, jnp.int32)
    cached = []
    neighbor_xy = []
    valid_spatial = jnp.zeros(shape, jnp.int32)

    for i in range(max_samples):
        in_count = i < lane_samples
        ox, oy = helpers.calculate_spatial_resampling_offset(
            start_idx + i, spec.sampling_radius, bridge.neighbor_offsets,
            spec.neighbor_offset_mask)
        ix, iy = clamp_sample_position_into_view(px + ox, py + oy,
                                                 width, height)
        ix, iy = helpers.activate_checkerboard_pixel(
            ix, iy, False, spec.active_checkerboard_field)
        neighbor_xy.append((ix, iy, ox, oy))

        n_surface = bridge.get_gbuffer_surface(ix, iy, False)
        ok = in_count & n_surface.valid
        ok &= helpers.is_valid_neighbor(
            surface.normal, n_surface.normal,
            surface.view_depth, n_surface.view_depth,
            spec.normal_threshold, spec.depth_threshold)
        if spec.enable_material_similarity_test:
            ok &= bridge.are_materials_similar(surface, n_surface)

        rx, ry = helpers.pixel_pos_to_reservoir_pos(
            ix, iy, spec.active_checkerboard_field)
        n_res = _gather_di(
            cur_reservoirs,
            jnp.clip(rx, 0, cur_reservoirs.weight_sum.shape[1] - 1),
            jnp.clip(jnp.clip(ry, 0, height - 1) - row_base, 0,
                     cur_reservoirs.weight_sum.shape[0] - 1))
        n_res = n_res._replace(
            spatial_distance=n_res.spatial_distance
            + jnp.stack([ox, oy], -1))

        if spec.discount_naive_samples:
            ok &= ~(is_valid(n_res) & (n_res.m <= NAIVE_SAMPLING_M_THRESHOLD))
        cached.append(ok)

        if pairwise:
            valid_spatial = valid_spatial + ok.astype(jnp.int32)
            merge = ok & (n_res.m > 0)
            rr, adv = rtrng.sample_uniform(rng)
            rng = rtrng.RngState(
                seed=rng.seed, index=jnp.where(merge, adv.index, rng.index))
            state, _ = stream_neighbor_with_pairwise_mis(
                state, rr, n_res, n_surface, center_sample, surface,
                lane_samples.astype(f32), bridge, active=merge)
        else:
            info = bridge.load_light_info(light_index(n_res), False)
            cand = bridge.sample_polymorphic_light(info, surface,
                                                   sample_uv(n_res))
            weight = jnp.where(
                is_valid(n_res),
                bridge.get_light_sample_target_pdf(cand, surface), 0.0)
            rr, adv = rtrng.sample_uniform(rng)
            rng = rtrng.RngState(
                seed=rng.seed, index=jnp.where(ok, adv.index, rng.index))
            state, upd = combine_reservoirs(state, n_res, rr, weight,
                                            active=ok)
            selected = jnp.where(upd, i, selected)

    if pairwise:
        # (:479-485)
        state = state._replace(canonical_weight=jnp.where(
            valid_spatial <= 0, 1.0, state.canonical_weight))
        rr, rng = rtrng.sample_uniform(rng)
        state, _ = stream_canonical_with_pairwise_step(
            state, rr, center_sample, surface)
        state = finalize_resampling(
            state, 1.0, jnp.maximum(1.0, valid_spatial.astype(f32)))
        return state, rng

    ok_state = is_valid(state)
    if spec.bias_correction_mode >= helpers.BIAS_CORRECTION_BASIC:
        pi = state.target_pdf
        pi_sum = state.target_pdf * center_sample.m
        sel_info = bridge.load_light_info(light_index(state), False)
        for i in range(max_samples):
            ix, iy, _, _ = neighbor_xy[i]
            ok = cached[i]
            n_surface = bridge.get_gbuffer_surface(ix, iy, False)
            sel_at_n = bridge.sample_polymorphic_light(
                sel_info, n_surface, sample_uv(state))
            ps = bridge.get_light_sample_target_pdf(sel_at_n, n_surface)
            if spec.bias_correction_mode == helpers.BIAS_CORRECTION_RAY_TRACED:
                visible = bridge.get_conservative_visibility(
                    n_surface, sel_at_n.position)
                ps = jnp.where(visible, ps, 0.0)
            rx, ry = helpers.pixel_pos_to_reservoir_pos(
                ix, iy, spec.active_checkerboard_field)
            n_res = _gather_di(
                cur_reservoirs,
                jnp.clip(rx, 0, cur_reservoirs.weight_sum.shape[1] - 1),
                jnp.clip(jnp.clip(ry, 0, height - 1) - row_base, 0,
                         cur_reservoirs.weight_sum.shape[0] - 1))
            pi = jnp.where(ok & (selected == i), ps, pi)
            pi_sum = pi_sum + jnp.where(ok, ps * n_res.m, 0.0)
        finalized = finalize_resampling(state, pi, pi_sum)
    else:
        finalized = finalize_resampling(state, 1.0, state.m)
    # (:610: normalization only applies to valid reservoirs)
    state = state._replace(
        weight_sum=jnp.where(ok_state, finalized.weight_sum,
                             state.weight_sum))
    return state, rng


def di_spatio_temporal_resampling(
    px: jax.Array, py: jax.Array,
    surface: Surface,
    cur_sample: DIReservoir,
    rng: rtrng.RngState,
    t_spec: DITemporalSpec,
    s_spec: DISpatialSpec,
    screen_space_motion: jax.Array,
    uniform_random_number,
    prev_reservoirs: DIReservoir,
    bridge: Bridge,
    row_base=0,
) -> tuple[DIReservoir, rtrng.RngState]:
    """RTXDI_DISpatioTemporalResampling (DIResamplingFunctions.hlsli:935+).

    The reference's fused pass interleaves one temporal merge with the
    spatial neighbor walk over the PREVIOUS frame's reservoirs. This
    implementation composes the temporal merge with a spatial walk whose
    source is the previous-frame buffer — statistically equivalent
    normalization, structured for batched visibility. (The reference app
    never executes its fused call: di_fused_resampling.rgen:69-70.)
    """
    merged, rng = di_temporal_resampling(
        px, py, surface, cur_sample, rng, t_spec, screen_space_motion,
        uniform_random_number, prev_reservoirs, bridge, row_base=row_base)
    return di_spatial_resampling(
        px, py, surface, merged, rng, s_spec, prev_reservoirs, bridge,
        row_base=row_base)


def di_boiling_filter(reservoirs: DIReservoir, filter_strength
                      ) -> DIReservoir:
    """RTXDI_BoilingFilter for DI (DIResamplingFunctions.hlsli:101-116):
    discard reservoirs whose weightSum is far above their 16x16 tile's
    average — the wave-op group reduction becomes an image-space tile
    reduce (restir/helpers.py boiling_filter_mask). Applied after temporal
    resampling, exactly like the GI variant (the reference allows it 'in a
    separate pass', :102-104). Operates on a full [H, W] reservoir image."""
    from raytracer2.restir.di_reservoir import (
        _where_res, empty_di_reservoir)
    from raytracer2.restir import helpers

    kill = helpers.boiling_filter_mask(reservoirs.weight_sum,
                                       filter_strength)
    return _where_res(kill, empty_di_reservoir(kill.shape), reservoirs)
