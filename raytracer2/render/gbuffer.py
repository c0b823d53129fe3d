"""Primary-ray G-buffer pass.

Port of src/shaders/lighting_passes/g_buffer.rgen: one camera ray per pixel,
hit attributes packed into the same formats the reference uses
(render_resources.rs:39-101): depth R32F, oct-unorm32 normals, R11G11B10
albedo, RGBA8-gamma specular+roughness, RGBA16F emissive, motion vectors.
Keeping the packed layout costs a few vector ops but keeps memory at 4 bytes per
channel and gives byte-level parity for golden tests.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytracer2.params import BACKGROUND_DEPTH, GConst, PlanarViewConstants
from raytracer2.render import rays as raysmod
from raytracer2.render.reference import TraceFn
from raytracer2.render.surface import (
    Surface, get_surface_diffuse_probability)
from raytracer2.scene.scene import Scene, get_geometry_from_hit
from raytracer2.utils import packing as pk
from raytracer2.utils.brdf import normalize


class GBuffer(NamedTuple):
    """Packed G-buffer planes (ref: render_resources.rs:39-46, 52-101)."""

    depth: jax.Array  # [H, W] f32
    normals: jax.Array  # [H, W] u32 oct-unorm32
    geo_normals: jax.Array  # [H, W] u32
    diffuse_albedo: jax.Array  # [H, W] u32 R11G11B10
    specular_rough: jax.Array  # [H, W] u32 RGBA8-gamma (rgb=F0, a=roughness)
    emissive: jax.Array  # [H, W, 3] f32


def empty_gbuffer(height: int, width: int) -> GBuffer:
    return GBuffer(
        depth=jnp.full((height, width), BACKGROUND_DEPTH, jnp.float32),
        normals=jnp.zeros((height, width), jnp.uint32),
        geo_normals=jnp.zeros((height, width), jnp.uint32),
        diffuse_albedo=jnp.zeros((height, width), jnp.uint32),
        specular_rough=jnp.zeros((height, width), jnp.uint32),
        emissive=jnp.zeros((height, width, 3), jnp.float32),
    )


def gbuffer_pass(
    scene: Scene,
    g_const: GConst,
    trace_fn: TraceFn,
    width: int,
    height: int,
    row0=0,
) -> tuple[GBuffer, jax.Array]:
    """Trace primary rays and fill the G-buffer + motion vectors
    (g_buffer.rgen:14-47). Returns (GBuffer, motion [H, W, 3]).

    Rays are generated in screen-tile order (the static pixel Z-curve when
    the viewport does not divide into tiles). The bundle engine's coherence
    sort is stable and its key is coarse, so rays that tie on it stay in
    compact tiles rather than scanline strips. ALL shading work (material
    fetch, motion vectors, packing, miss masking) happens in that order —
    only the finished, packed G-buffer channels are put back in row order,
    with ONE [N, 10] i32 row gather (floats ride as bitcast i32: exact, and
    the int path never flushes denormals): one wide gather instead of
    several narrower ones."""
    import numpy as np

    # coherent ray layout: 8x16 pixel tiles via reshape/transpose when the
    # viewport divides (the un-order of the packed outputs is then a
    # bandwidth copy, not a ~62 ms [N, 10] permutation gather); Z-curve
    # permutation otherwise
    tiles = raysmod.tile_shape(width, height) if isinstance(row0, int) \
        else None
    if tiles is not None:
        th, tw = tiles
        zidx = raysmod.tile_permutation(width, height, tw, th)
        zinv = None
    else:
        zidx, zinv = raysmod.zorder_permutation(width, height)
    # coherent-order pixel coords are compile-time constants: permute with
    # numpy so no runtime [N] gathers exist (row0 is traced only under
    # sharding; keep the device gather for that rare case)
    if isinstance(row0, int):
        lin = np.arange(width * height)
        px_z = jnp.asarray((lin % width).astype(np.int32)[zidx])
        py_z = jnp.asarray((lin // width + row0).astype(np.int32)[zidx])
    else:
        px, py = raysmod.pixel_grid(width, height)
        px_z = px.reshape(-1)[jnp.asarray(zidx)]
        py_z = (py.reshape(-1) + row0)[jnp.asarray(zidx)]

    rays_z = raysmod.setup_primary_ray(px_z, py_z, g_const.view)
    hit = trace_fn(rays_z.origin, rays_z.direction, rays_z.t_min,
                   rays_z.t_max)

    def fetch_pack(hit_c, origin_c, direction_c):
        """Material fetch + motion + packing for one pixel chunk."""
        missed = hit_c.missed
        attribs = jnp.stack([hit_c.u, hit_c.v], axis=-1)
        geom = get_geometry_from_hit(
            scene, hit_c.geometry_index.astype(jnp.int32),
            hit_c.primitive_id.astype(jnp.int32), attribs,
            textures_enabled=bool(g_const.textures),
            triangle_index=hit_c.triangle_index)

        world_pos = origin_c + direction_c * hit_c.t[..., None]
        # static scene: prev position == current (g_buffer.rgen:28-29)
        motion = raysmod.get_motion_vector(
            g_const.view, g_const.prev_view, world_pos, world_pos)

        oct_n = pk.ndir_to_oct_unorm32(geom.normal)
        albedo = pk.pack_r11g11b10_ufloat(geom.diffuse_albedo)
        spec_rough = pk.pack_rgba8_gamma_ufloat(
            jnp.concatenate([geom.specular_f0, geom.roughness[..., None]],
                            axis=-1))

        def ch(x, fill):
            return jnp.where(missed, fill, x)

        def bc(x):
            return jax.lax.bitcast_convert_type(x, jnp.int32)

        packed_z = jnp.stack(
            [bc(ch(hit_c.t, jnp.float32(BACKGROUND_DEPTH))),
             ch(oct_n, jnp.uint32(0)).astype(jnp.int32),
             ch(albedo, jnp.uint32(0)).astype(jnp.int32),
             ch(spec_rough, jnp.uint32(0)).astype(jnp.int32)], axis=1)
        em_mo_z = bc(jnp.where(
            missed[:, None], 0.0,
            jnp.concatenate([geom.emission, motion], axis=1)))
        return jnp.concatenate([packed_z, em_mo_z], axis=1)

    n = width * height
    # 4K frames: the [N, 80] fetch output alone is 2.65 GB; chunking the
    # per-pixel fetch+pack bounds peak device memory for 4K-class temps
    # (1080p sizes keep the whole-image form)
    chunk = 1 << 21  # 2M pixels: the measured-good 1080p working size
    if n > (1 << 22):
        nc = (n + chunk - 1) // chunk
        pad = nc * chunk - n

        def padc(a):
            if pad == 0:
                return a
            return jnp.concatenate([a, jnp.zeros((pad,) + a.shape[1:],
                                                 a.dtype)])

        hit_p = jax.tree_util.tree_map(
            lambda a: padc(a).reshape((nc, chunk) + a.shape[1:]), hit)
        o_p = padc(rays_z.origin).reshape(nc, chunk, 3)
        d_p = padc(rays_z.direction).reshape(nc, chunk, 3)
        packed = jax.lax.map(
            lambda args: fetch_pack(*args), (hit_p, o_p, d_p))
        packed = packed.reshape(nc * chunk, -1)[:n]
    else:
        packed = fetch_pack(hit, rays_z.origin, rays_z.direction)
    if tiles is not None:
        packed = raysmod.tile_unflatten(
            packed, height, width, tw, th).reshape(height * width, -1)
    else:
        packed = packed[jnp.asarray(zinv)]

    depth = jax.lax.bitcast_convert_type(packed[:, 0], jnp.float32)
    oct_row = packed[:, 1].astype(jnp.uint32)
    em_mo = jax.lax.bitcast_convert_type(packed[:, 4:10], jnp.float32)
    gbuffer = GBuffer(
        depth=depth.reshape(height, width),
        normals=oct_row.reshape(height, width),
        # geo normal = shading normal (g_buffer.rgen:32-33 quirk)
        geo_normals=oct_row.reshape(height, width),
        diffuse_albedo=packed[:, 2].astype(jnp.uint32).reshape(height, width),
        specular_rough=packed[:, 3].astype(jnp.uint32).reshape(height, width),
        emissive=em_mo[:, 0:3].reshape(height, width, 3),
    )
    return gbuffer, em_mo[:, 3:6].reshape(height, width, 3)


def surface_from_gbuffer_grid(gbuffer: GBuffer, view: PlanarViewConstants,
                              row0=0, field: int = 0) -> Surface:
    """Gather-free surface reconstruction over the full (or checkerboard)
    launch grid: planes are read whole (or by strided slicing under
    field != 0), never through [N]-row gathers, since every lighting pass
    reads the primary surface at exactly these positions. Produces values
    bitwise-identical to surface_from_gbuffer at the same pixels (there,
    in-view identity positions make every clip/where a no-op).
    row0: first global row of this (row-sharded) G-buffer tile."""
    from raytracer2.render.rays import active_pixel_grid, gather_field

    h, w = gbuffer.depth.shape

    depth = gather_field(gbuffer.depth, field)
    normal = pk.oct_unorm32_to_ndir(gather_field(gbuffer.normals, field))
    geo_normal = pk.oct_unorm32_to_ndir(
        gather_field(gbuffer.geo_normals, field))
    albedo = pk.unpack_r11g11b10_ufloat(
        gather_field(gbuffer.diffuse_albedo, field))
    spec_rough = pk.unpack_rgba8_gamma_ufloat(
        gather_field(gbuffer.specular_rough, field))

    px, py = active_pixel_grid(w, h, field)
    world_pos = raysmod.view_depth_to_world_pos(view, px, py + row0, depth)
    view_dir = normalize(
        view.camera_direction_or_position[:3] - world_pos)
    return Surface(
        world_pos=world_pos,
        view_dir=view_dir,
        view_depth=depth,
        normal=normal,
        geo_normal=geo_normal,
        diffuse_albedo=albedo,
        specular_f0=spec_rough[..., :3],
        roughness=spec_rough[..., 3],
        diffuse_probability=get_surface_diffuse_probability(
            albedo, spec_rough[..., :3], view_dir, normal),
    )


def surface_from_gbuffer(gbuffer: GBuffer, view: PlanarViewConstants,
                         pixel_x: jax.Array, pixel_y: jax.Array,
                         width: int, height: int, row_base=0) -> Surface:
    """Port of GetGBufferSurface (RtxdiApplicationBridge.glsl:295-321):
    rebuild a Surface from packed G-buffer planes at (possibly gathered)
    pixel positions. Out-of-view positions yield invalid surfaces.
    row_base: global row of the G-buffer tile's first row — nonzero when
    the tile is a halo-padded row shard; view math stays global."""
    in_view = ((pixel_x >= 0) & (pixel_x < width)
               & (pixel_y >= 0) & (pixel_y < height))
    x = jnp.clip(pixel_x, 0, width - 1)
    y = jnp.clip(jnp.clip(pixel_y, 0, height - 1) - row_base, 0,
                 gbuffer.depth.shape[0] - 1)

    depth = jnp.where(in_view, gbuffer.depth[y, x], BACKGROUND_DEPTH)
    normal = pk.oct_unorm32_to_ndir(gbuffer.normals[y, x])
    geo_normal = pk.oct_unorm32_to_ndir(gbuffer.geo_normals[y, x])
    albedo = pk.unpack_r11g11b10_ufloat(gbuffer.diffuse_albedo[y, x])
    spec_rough = pk.unpack_rgba8_gamma_ufloat(gbuffer.specular_rough[y, x])

    y_global = y + row_base
    world_pos = raysmod.view_depth_to_world_pos(view, x, y_global, depth)
    view_dir = normalize(
        view.camera_direction_or_position[:3] - world_pos)
    return Surface(
        world_pos=world_pos,
        view_dir=view_dir,
        view_depth=depth,
        normal=normal,
        geo_normal=geo_normal,
        diffuse_albedo=albedo,
        specular_f0=spec_rough[..., :3],
        roughness=spec_rough[..., 3],
        diffuse_probability=get_surface_diffuse_probability(
            albedo, spec_rough[..., :3], view_dir, normal),
    )
