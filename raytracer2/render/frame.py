"""The frame graph: one jittable function from (frame state, GConst) to
(new frame state, display image).

JAX replacement for the reference's pass orchestration
(light_passes.rs:550-663 + the main-loop scheduling main.rs:644-721):
XLA's dataflow replaces every manual barrier; double-buffered G-buffers and
reservoir ping-pong (main.rs:649-651, light_passes.rs:517-537) become a
functional swap of pytrees inside FrameState.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytracer2.lights.prepare import SceneLights, prepare_lights
from raytracer2.params import GConst
from raytracer2.render.app_bridge import Tracers, make_bridge, make_tracers
from raytracer2.render.di_passes import di_fused_resampling_pass
from raytracer2.render.gbuffer import (
    GBuffer, empty_gbuffer, gbuffer_pass, surface_from_gbuffer_grid)
from raytracer2.render.gi_passes import (
    SecondaryGBuffer, brdf_rays_pass, empty_secondary_gbuffer,
    gi_final_shading_pass, gi_spatial_pass, gi_temporal_pass,
    shade_secondary_surfaces_pass)
from raytracer2.render import rays as raysmod
from raytracer2.render.postprocess import PostProcessInputs, post_process
from raytracer2.render.reference import render_reference
from raytracer2.restir.gi_reservoir import GIReservoir, empty_gi_reservoir
from raytracer2.restir.di_reservoir import DIReservoir, empty_di_reservoir
from raytracer2.restir.initial_sampling import LightSamplingContext
from raytracer2.lights.pdf_texture import fill_neighbor_offsets
from raytracer2.scene.scene import Scene
from raytracer2.utils import packing as pk


class FrameState(NamedTuple):
    """Persistent cross-frame GPU state (render_resources.rs:130-342
    equivalent, as one pytree). Ping-pong = leaf swap."""

    gbuffer: GBuffer  # current (becomes prev next frame)
    prev_gbuffer: GBuffer
    motion: jax.Array  # [H, W, 3]
    diffuse_lighting: jax.Array  # [H, W, 3]
    specular_lighting: jax.Array  # [H, W, 3]
    gi_reservoirs: tuple[GIReservoir, GIReservoir]  # 2 slots [H, W]
    di_reservoirs: tuple[DIReservoir, DIReservoir]
    secondary: SecondaryGBuffer


def init_frame_state(width: int, height: int,
                     checkerboard: bool = False) -> FrameState:
    """checkerboard=True sizes the per-launch-lane buffers (reservoirs,
    secondary G-buffer) at [H, W//2] — the reference's reservoir layout
    under RTXDI_PixelPosToReservoirPos (RtxdiHelpers.hlsli:45-51). The
    G-buffer, motion, and lighting images stay full-res."""
    w_res = width // 2 if checkerboard else width
    return FrameState(
        gbuffer=empty_gbuffer(height, width),
        prev_gbuffer=empty_gbuffer(height, width),
        motion=jnp.zeros((height, width, 3), jnp.float32),
        diffuse_lighting=jnp.zeros((height, width, 3), jnp.float32),
        specular_lighting=jnp.zeros((height, width, 3), jnp.float32),
        gi_reservoirs=(empty_gi_reservoir((height, w_res)),
                       empty_gi_reservoir((height, w_res))),
        di_reservoirs=(empty_di_reservoir((height, w_res)),
                       empty_di_reservoir((height, w_res))),
        secondary=empty_secondary_gbuffer(height, w_res),
    )


class Renderer(NamedTuple):
    """Per-scene immutable resources: scene arrays, traversal closures,
    light table, neighbor offsets, presampled RIS buffers. Built once at
    load (the reference's frame-1 prepare/presample/mip block,
    main.rs:663-697 + light_passes.rs:538-547)."""

    scene: Scene
    tracers: Tracers
    scene_lights: SceneLights
    neighbor_offsets: jax.Array
    width: int
    height: int
    # RIS tiles (presample_locallights/environment.comp): local tiles at
    # segment offset 0, environment tiles appended (GConst's
    # *_risbuffer_segment_params layout). None when presampling is off.
    ris_buffer: jax.Array | None = None
    # ReGIR world-space grid (local_light_sampling_mode == 2)
    regir_ris_buffer: jax.Array | None = None
    regir_params: object | None = None

    def light_ctx(self, g_const: GConst,
                  ris_buffer=None) -> LightSamplingContext:
        if ris_buffer is None:
            ris_buffer = self.ris_buffer
        mode = (g_const.restir_di.initial_sampling_params
                .local_light_sampling_mode)
        has_buffers = (ris_buffer is not None
                       or (mode == 2 and self.regir_ris_buffer is not None))
        return LightSamplingContext(
            lights=self.scene_lights.lights,
            light_buffer_params=g_const.light_buffer_params,
            local_light_sampling_mode=mode,
            enable_presampling=has_buffers,
            ris_buffer=ris_buffer,
            local_ris_params=g_const.local_lights_risbuffer_segment_params,
            env_ris_params=g_const.environment_light_risbuffer_segment_params,
            regir_ris_buffer=self.regir_ris_buffer,
            regir_params=self.regir_params,
        )


def make_regir_params(scene: Scene, cells: tuple[int, int, int] = (16, 16, 16),
                      lights_per_cell: int = 128):
    """Grid parameters sized to the scene AABB (the reference host would
    configure these; it never enables ReGIR, SURVEY.md §2.3)."""
    import numpy as np

    from raytracer2.restir.regir import ReGIRGridParameters

    # scene AABB from the host triangle copy when available (no
    # device-to-host copy)
    if scene.num_triangles and scene.host_tri_v0 is not None:
        lo = scene.host_tri_v0.min(axis=0)
        hi = scene.host_tri_v0.max(axis=0)
    elif scene.num_triangles:
        lo = np.asarray(jnp.min(scene.tri_v0, axis=0))
        hi = np.asarray(jnp.max(scene.tri_v0, axis=0))
    else:
        lo, hi = np.zeros(3), np.ones(3)
    center = 0.5 * (lo + hi)
    cell = float(np.max((hi - lo) / np.asarray(cells))) or 1.0
    return ReGIRGridParameters(
        center=(float(center[0]), float(center[1]), float(center[2])),
        cell_size=cell, cells=cells, lights_per_cell=lights_per_cell)


def create_renderer(scene: Scene, width: int, height: int,
                    use_bvh: bool = True,
                    backend: str = "auto",
                    presample: bool = True,
                    regir: bool = False,
                    presample_seed: int = 0,
                    tracer_opts: dict | None = None) -> Renderer:
    """presample=True fills the RIS tile buffer once at creation — the
    static-scene equivalent of the reference's frame-1 presample dispatch
    (light_passes.rs:538-547; the tiles only refresh with the scene).
    regir=True additionally builds the ReGIR world-space grid so
    local_light_sampling_mode=2 is live."""
    from raytracer2.lights.prepare import (
        presample_environment_map, presample_local_lights)

    scene_lights = prepare_lights(scene)
    ris_buffer = None
    if presample and scene_lights.num_local_lights > 0:
        # jit: the 128x1024-slot mip-descent fills dispatch thousands of
        # tiny eager ops otherwise (minutes on CPU)
        local = jax.jit(presample_local_lights, static_argnums=0)(
            presample_seed, scene_lights)
        if scene_lights.env_pdf_mips is not None:
            env = jax.jit(presample_environment_map, static_argnums=0)(
                presample_seed, scene_lights)
        else:
            env = jnp.zeros_like(local)
        ris_buffer = jnp.concatenate([local, env], axis=0)

    regir_buf = None
    regir_p = None
    if regir and scene_lights.num_local_lights > 0:
        from raytracer2.params import LightBufferRegion
        from raytracer2.restir.regir import presample_regir_grid

        regir_p = make_regir_params(scene)
        regir_buf = jax.jit(presample_regir_grid,
                            static_argnums=(0, 2, 3))(
            presample_seed, scene_lights.lights,
            LightBufferRegion(first_light_index=0,
                              num_lights=scene_lights.num_local_lights),
            regir_p)

    return Renderer(
        scene=scene,
        tracers=make_tracers(scene, use_bvh=use_bvh, backend=backend,
                             **(tracer_opts or {})),
        scene_lights=scene_lights,
        neighbor_offsets=fill_neighbor_offsets(),
        width=width,
        height=height,
        ris_buffer=ris_buffer,
        regir_ris_buffer=regir_buf,
        regir_params=regir_p,
    )


# pass names in execution order, for profiling prefixes (bench.py
# --per-pass jits the frame stopped after each and diffs the medians)
FRAME_PASSES = ("gbuffer", "di", "brdf_rays", "shade_secondary",
                "gi_temporal", "gi_spatial", "gi_final", "post")


def render_frame(renderer: Renderer, g_const: GConst,
                 state: FrameState,
                 stop_after: str | None = None,
                 row0=0,
                 halo_fn=None,
                 halo_rows: int = 8,
                 ) -> tuple[FrameState, jax.Array]:
    """Execute one frame (light_passes.rs:550-663 + post-process +
    frame-state rotation). Returns (new state, display image [H, W, 3]).
    stop_after (a FRAME_PASSES name) truncates the frame after that pass
    for cumulative-prefix profiling — the second return value is then that
    pass's intermediate tuple, NOT an image ("post" has no early branch
    and is equivalent to a full frame, which is what the cumulative bench
    diff wants).

    Row sharding (parallel/mesh.py make_sharded_render_fn): `state` holds
    this shard's row tile, row0 its first global row, and halo_fn(tree, r)
    pads row tiles with r neighbour rows (parallel/halo.py ppermute). The
    stencil passes (GI temporal reprojection, GI spatial) read neighbours
    through the halo; pixel RNG/view math stays global so the sharded
    image is identical to the single-chip one wherever reprojection stays
    within halo_rows."""
    scene = renderer.scene
    width, height = renderer.width, renderer.height
    height_local = state.gbuffer.depth.shape[0]
    gi_idx = g_const.restir_gi.buffer_indices

    # checkerboard rendering (RtxdiHelpers.hlsli:16-61): when the static
    # field is 1/2, every lighting pass launches on the active half-grid
    # only — tracing half the DI/BRDF/shadow/secondary rays per frame.
    # The G-buffer and post stay full-res; the lighting images persist so
    # the inactive field keeps last frame's shading, exactly like the
    # reference's unlaunched pixels.
    field = int(g_const.runtime_params.active_checkerboard_field)

    # previous frame's G-buffer is the one rendered last frame
    prev_gbuffer = state.gbuffer

    if g_const.refrence_mode:
        radiance = render_reference(
            scene, g_const, width, height,
            trace_fn=renderer.tracers.closest_hit)
        from raytracer2.render.shading import store_shading_output

        diffuse, spec_out = store_shading_output(
            state.diffuse_lighting, state.specular_lighting,
            radiance, jnp.zeros_like(radiance), is_first_pass=True,
            enable_accumulation=g_const.enable_accumulation,
            blend_factor=g_const.blend_factor,
        correct_specular_accumulation=bool(
            g_const.correct_specular_accumulation))
        new_state = state._replace(
            prev_gbuffer=prev_gbuffer,
            diffuse_lighting=diffuse,
            specular_lighting=spec_out)
        inputs = PostProcessInputs(
            depth=jnp.zeros((height, width), jnp.float32),
            diffuse_albedo=jnp.zeros((height, width, 3), jnp.float32),
            specular_f0=jnp.zeros((height, width, 3), jnp.float32),
            emissive=jnp.zeros((height, width, 3), jnp.float32),
            diffuse=diffuse,
            specular=new_state.specular_lighting)
        output, _ = post_process(scene, g_const, inputs)
        return new_state, output

    # 1. G-buffer pass (light_passes.rs:598-606)
    gbuffer, motion = gbuffer_pass(
        scene, g_const, renderer.tracers.closest_hit, width, height_local,
        row0=row0)
    if stop_after == "gbuffer":
        return state, (gbuffer, motion)

    # under sharding the bridge reads halo-padded G-buffer tiles so
    # neighbour surface reads (temporal reprojection, spatial stencil)
    # stay on-shard; row_base maps global rows into the padded tiles
    if halo_fn is not None:
        bridge_gbuffer = halo_fn(gbuffer, halo_rows)
        bridge_prev = halo_fn(prev_gbuffer, halo_rows)
        row_base = row0 - halo_rows
    else:
        bridge_gbuffer = gbuffer
        bridge_prev = prev_gbuffer
        row_base = 0

    bridge = make_bridge(
        scene, renderer.tracers, bridge_gbuffer, bridge_prev, g_const,
        renderer.scene_lights.lights,
        renderer.scene_lights.geometry_to_light,
        renderer.scene_lights.local_pdf_mips,
        renderer.scene_lights.env_pdf_mips,
        renderer.neighbor_offsets, width, height, row_base=row_base)
    light_ctx = renderer.light_ctx(g_const)

    # every lighting pass reads the primary surface at exactly the launch
    # grid; reconstruct it ONCE, gather-free (strided slices instead of
    # [N]-row gathers)
    primary_surface = surface_from_gbuffer_grid(
        gbuffer, g_const.view, row0=row0, field=field)

    # lighting images persist across frames: lanes whose stores don't execute
    # keep last frame's values, and accumulation mode blends against them
    # (ShadingHelpers.glsl:68-81). Under checkerboard the passes run on the
    # active half-field and their results scatter back afterwards.
    diffuse = raysmod.gather_field(state.diffuse_lighting, field)
    specular = raysmod.gather_field(state.specular_lighting, field)
    motion_act = raysmod.gather_field(motion, field)
    gi_slots = list(state.gi_reservoirs)
    di_slots = list(state.di_reservoirs)
    secondary = state.secondary

    # 2. DI fused resampling (light_passes.rs:608-619); with
    # enable_di_resampling != 0 the library's temporal/spatial stages run
    # inside it (the reference's commented-out call made executable) —
    # this frame's shaded reservoir then ping-pongs into the temporal
    # input slot for next frame (the functional XOR-swap, main.rs:649-651)
    if g_const.enable_restir_di:
        di_idx = g_const.restir_di.buffer_indices
        di_res, diffuse, specular = di_fused_resampling_pass(
            g_const, bridge, light_ctx, diffuse, specular, width,
            height_local, row0=row0, field=field,
            primary_surface=primary_surface,
            motion=motion_act,
            prev_di_reservoirs=state.di_reservoirs[
                di_idx.temporal_resampling_input_buffer_index],
            halo_fn=halo_fn, halo_rows=halo_rows)
        di_slots[di_idx.shading_input_buffer_index] = di_res
        if g_const.enable_di_resampling:
            di_slots[di_idx.temporal_resampling_input_buffer_index] = di_res
    if stop_after == "di":
        return state, (diffuse, specular)

    # 3. ReSTIR GI chain (light_passes.rs:621-660)
    if g_const.enable_restir_gi:
        secondary, diffuse, specular = brdf_rays_pass(
            scene, g_const, renderer.tracers, bridge, diffuse, specular,
            width, height_local, row0=row0, field=field,
            primary_surface=primary_surface)
        if stop_after == "brdf_rays":
            return state, (secondary, diffuse, specular)
        gi_initial, secondary, diffuse, specular = \
            shade_secondary_surfaces_pass(
                scene, g_const, renderer.tracers, bridge, light_ctx,
                secondary, diffuse, specular, width, height_local,
                row0=row0, field=field, primary_surface=primary_surface)
        gi_slots[gi_idx.secondary_surface_restir_di_output_buffer_index] = \
            gi_initial
        if stop_after == "shade_secondary":
            return state, (gi_initial, diffuse, specular)

        current = gi_initial
        if g_const.enable_temporal_resampling:
            prev_src = state.gi_reservoirs[
                gi_idx.temporal_resampling_input_buffer_index]
            current = gi_temporal_pass(
                g_const, bridge, current, prev_src, motion_act, width,
                height_local, row0=row0, halo_fn=halo_fn,
                halo_rows=halo_rows, field=field,
                primary_surface=primary_surface)
            gi_slots[gi_idx.temporal_resampling_output_buffer_index] = current
        if stop_after == "gi_temporal":
            return state, (current, diffuse, specular)
        if g_const.enable_spatial_resampling:
            current = gi_spatial_pass(
                g_const, bridge, current, width, height_local, row0=row0,
                halo_fn=halo_fn, field=field,
                primary_surface=primary_surface)
            gi_slots[gi_idx.spatial_resampling_output_buffer_index] = current
        if stop_after == "gi_spatial":
            return state, (current, diffuse, specular)

        diffuse, specular = gi_final_shading_pass(
            g_const, bridge, current, secondary, diffuse, specular,
            width, height_local, row0=row0, field=field,
            primary_surface=primary_surface)
    if stop_after == "gi_final":
        return state, (diffuse, specular)

    # scatter the active field's shading back into the persistent
    # full-res lighting images (inactive pixels keep last frame's values)
    diffuse = raysmod.scatter_field(state.diffuse_lighting, diffuse, field)
    specular = raysmod.scatter_field(state.specular_lighting, specular,
                                     field)

    # accumulation blending happens inside store_shading_output per pass; the
    # persistent lighting buffers feed it next frame
    new_state = FrameState(
        gbuffer=gbuffer,
        prev_gbuffer=prev_gbuffer,
        motion=motion,
        diffuse_lighting=diffuse,
        specular_lighting=specular,
        gi_reservoirs=(gi_slots[0], gi_slots[1]),
        di_reservoirs=(di_slots[0], di_slots[1]),
        secondary=secondary,
    )

    # 4. post-process (post_processing.comp)
    inputs = PostProcessInputs(
        depth=gbuffer.depth,
        diffuse_albedo=pk.unpack_r11g11b10_ufloat(gbuffer.diffuse_albedo),
        specular_f0=pk.unpack_rgba8_gamma_ufloat(
            gbuffer.specular_rough)[..., :3],
        emissive=gbuffer.emissive,
        diffuse=diffuse,
        specular=specular)
    output, env_motion = post_process(scene, g_const, inputs, row0=row0)
    new_state = new_state._replace(
        motion=new_state.motion.at[..., :2].set(
            jnp.where((gbuffer.depth == jnp.float32(100000.0))[..., None],
                      env_motion, new_state.motion[..., :2])))
    return new_state, output
