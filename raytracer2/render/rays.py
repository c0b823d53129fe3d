"""Primary-ray generation and view-space helpers.

Whole-image ports of src/shaders/GBufferHelpers.glsl: rays for every pixel are
produced as SoA arrays in one shot (the raygen "launch grid" is just array
shape here).
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from raytracer2.params import BACKGROUND_DEPTH, PlanarViewConstants
from raytracer2.utils.brdf import normalize

# f32 products that feed geometry and colour: never reduced precision
# (a GPU may run a plain f32 matrix product in TF32)
_HI = jax.lax.Precision.HIGHEST


class Rays(NamedTuple):
    """SoA ray batch (ref RayDesc: GBufferHelpers.glsl:5-10)."""

    origin: jax.Array  # [..., 3]
    direction: jax.Array  # [..., 3]
    t_min: jax.Array  # [...]
    t_max: jax.Array  # [...]


def pixel_grid(width: int, height: int) -> tuple[jax.Array, jax.Array]:
    """Integer pixel coordinates (x, y) as [H, W] arrays (gl_LaunchIDEXT.xy)."""
    ys = jax.lax.broadcasted_iota(jnp.int32, (height, width), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (height, width), 1)
    return xs, ys


def active_pixel_grid(width: int, height: int, field: int
                      ) -> tuple[jax.Array, jax.Array]:
    """Pixel coordinates of the checkerboard launch grid.

    field == 0: the full [H, W] grid. Otherwise the active half-field as
    [H, W//2] arrays — column r maps to pixel x = 2r + ((y + field) & 1),
    the RTXDI_ReservoirPosToPixelPos mapping (RtxdiHelpers.hlsli:53-61)
    every checkerboard-aware raygen applies to gl_LaunchIDEXT
    (e.g. brdf_rays.rgen:21)."""
    if field == 0:
        return pixel_grid(width, height)
    assert width % 2 == 0, "checkerboard rendering needs an even width"
    rx, ys = pixel_grid(width // 2, height)
    return (rx << 1) + ((ys + field) & 1), ys


def gather_field(img: jax.Array, field: int) -> jax.Array:
    """Extract the active checkerboard field of a full-res [H, W, ...]
    array as [H, W//2, ...] (identity when field == 0)."""
    if field == 0:
        return img
    b = field & 1
    even = img[0::2, b::2]       # rows 0,2,..: offset (0 + field) & 1
    odd = img[1::2, 1 - b::2]    # rows 1,3,..: offset (1 + field) & 1
    h, w = img.shape[0], img.shape[1]
    out = jnp.empty((h, w // 2) + img.shape[2:], img.dtype)
    out = out.at[0::2].set(even)
    out = out.at[1::2].set(odd)
    return out


def scatter_field(full: jax.Array, half: jax.Array, field: int) -> jax.Array:
    """Write the active field's [H, W//2, ...] values into a full-res
    array, leaving inactive pixels untouched (the reference's raygens
    simply never launch them, so their textures persist)."""
    if field == 0:
        return half
    b = field & 1
    full = full.at[0::2, b::2].set(half[0::2])
    full = full.at[1::2, 1 - b::2].set(half[1::2])
    return full


TILE_H = 8  # pixel-tile height of the gather-free coherent ray layout


def tile_shape(width: int, height: int, bundle: int = 128
               ) -> tuple[int, int] | None:
    """(tile_h, tile_w) of the reshape-expressible coherent layout, or
    None when the viewport doesn't divide. One tile = one `bundle`-ray
    tracer bundle; wider tracer bundles (256) take two horizontally
    adjacent tiles, still a compact 8x32 screen region."""
    th = TILE_H
    tw = bundle // th
    if height % th == 0 and width % tw == 0 and bundle % th == 0:
        return th, tw
    return None


def tile_unflatten(flat: jax.Array, height: int, width: int, tile_w: int,
                   tile_h: int = TILE_H) -> jax.Array:
    """[H*W, ...] in tile order (every consecutive tile_h*tile_w chunk is
    one compact screen tile, tiles row-major) -> [H, W, ...]. A pure
    reshape+transpose: a bandwidth copy, where a permutation would be a
    row gather."""
    rest = flat.shape[1:]
    x = flat.reshape(height // tile_h, width // tile_w, tile_h, tile_w,
                     *rest)
    x = jnp.swapaxes(x, 1, 2)
    return x.reshape((height, width) + rest)


@lru_cache(maxsize=8)
def tile_permutation(width: int, height: int, tile_w: int,
                     tile_h: int = TILE_H) -> np.ndarray:
    """tidx[j] = row-major pixel index of the j-th pixel in tile order
    (the inverse of tile_unflatten, for compile-time ray constants)."""
    lin = np.arange(width * height, dtype=np.int32).reshape(height, width)
    x = lin.reshape(height // tile_h, tile_h, width // tile_w, tile_w)
    return np.swapaxes(x, 1, 2).reshape(-1)


@lru_cache(maxsize=8)
def zorder_permutation(width: int, height: int
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Static Z-curve (Morton) pixel layout: (zidx, inv).

    zidx[j] = linear (row-major) pixel index of the j-th pixel in Z order;
    inv = argsort(zidx) maps back. Launching per-pixel rays in Z order makes
    every 256-ray bundle a compact screen tile with a tight frustum, with
    zero sort cost (both permutations are compile-time constants). Bounce
    rays keep the runtime sort (their origins scatter in world space)."""
    lin = np.arange(width * height)
    px = (lin % width).astype(np.uint64)
    py = (lin // width).astype(np.uint64)
    code = np.zeros(lin.shape, np.uint64)
    for b in range(16):
        code |= ((px >> b) & 1) << (2 * b)
        code |= ((py >> b) & 1) << (2 * b + 1)
    zidx = np.argsort(code, kind="stable").astype(np.int32)
    inv = np.argsort(zidx, kind="stable").astype(np.int32)
    return zidx, inv


def setup_primary_ray(pixel_x: jax.Array, pixel_y: jax.Array,
                      view: PlanarViewConstants) -> Rays:
    """Port of setupPrimaryRay (GBufferHelpers.glsl:12-27)."""
    px = pixel_x.astype(jnp.float32) + 0.5
    py = pixel_y.astype(jnp.float32) + 0.5
    uv_x = px / view.viewport_size[0]
    uv_y = py / view.viewport_size[1]
    dx = uv_x * 2.0 - 1.0
    dy = uv_y * 2.0 - 1.0

    clip = jnp.stack([dx, dy, jnp.ones_like(dx), jnp.ones_like(dx)], axis=-1)
    target = jnp.einsum("ij,...j->...i", view.mat_clip_to_view, clip,
                        precision=_HI)
    tdir = normalize(target[..., :3])
    world_dir = jnp.einsum(
        "ij,...j->...i", view.mat_view_to_world[:3, :3], tdir,
        precision=_HI)

    origin = jnp.broadcast_to(
        view.camera_direction_or_position[:3], world_dir.shape)
    return Rays(
        origin=origin,
        direction=world_dir,
        t_min=jnp.zeros(world_dir.shape[:-1], jnp.float32),
        t_max=jnp.full(world_dir.shape[:-1], BACKGROUND_DEPTH, jnp.float32),
    )


def view_depth_to_world_pos(view: PlanarViewConstants, pixel_x: jax.Array,
                            pixel_y: jax.Array,
                            view_depth: jax.Array) -> jax.Array:
    """Port of viewDepthToWorldPos (GBufferHelpers.glsl:54-67)."""
    rays = setup_primary_ray(pixel_x, pixel_y, view)
    return rays.origin + rays.direction * view_depth[..., None]


def get_motion_vector(view: PlanarViewConstants, view_prev: PlanarViewConstants,
                      world_pos: jax.Array,
                      prev_world_pos: jax.Array) -> jax.Array:
    """Port of getMotionVector (GBufferHelpers.glsl:29-52): pixel-space xy
    delta to the previous frame + clip-w depth delta."""
    ones = jnp.ones(world_pos.shape[:-1] + (1,), world_pos.dtype)
    clip = jnp.einsum("ij,...j->...i", view.mat_world_to_clip,
                      jnp.concatenate([world_pos, ones], axis=-1),
                      precision=_HI)
    prev_clip = jnp.einsum("ij,...j->...i", view_prev.mat_world_to_clip,
                           jnp.concatenate([prev_world_pos, ones], axis=-1),
                           precision=_HI)
    w = clip[..., 3:4]
    pw = prev_clip[..., 3:4]
    ndc = clip[..., :3] / jnp.where(w == 0.0, 1.0, w)
    prev_ndc = prev_clip[..., :3] / jnp.where(pw == 0.0, 1.0, pw)

    motion_xy = ((prev_ndc[..., :2] - ndc[..., :2]) / 2.0
                 * view.viewport_size
                 + (view.pixel_offset - view_prev.pixel_offset))
    motion_z = (prev_clip[..., 3] - clip[..., 3])[..., None]
    motion = jnp.concatenate([motion_xy, motion_z], axis=-1)
    valid = (clip[..., 3:4] > 0.0) & (prev_clip[..., 3:4] > 0.0)
    return jnp.where(valid, motion, 0.0)


def get_environment_motion_vector(view: PlanarViewConstants,
                                  view_prev: PlanarViewConstants,
                                  window_pos: jax.Array) -> jax.Array:
    """Port of getEnvironmentMotionVector (post_processing.comp:127-146)."""
    clip_xy = view.window_to_clip_scale * window_pos + view.window_to_clip_bias
    zeros = jnp.zeros(window_pos.shape[:-1] + (1,), window_pos.dtype)
    ones = jnp.ones_like(zeros)
    clip = jnp.concatenate([clip_xy, zeros, ones], axis=-1)
    world = jnp.einsum("ij,...j->...i", view.mat_clip_to_world, clip,
                       precision=_HI)
    prev_clip = jnp.einsum("ij,...j->...i", view_prev.mat_world_to_clip,
                           world, precision=_HI)
    pw = prev_clip[..., 3:4]
    prev_ndc = prev_clip[..., :2] / jnp.where(pw == 0.0, 1.0, pw)
    motion = (view.clip_to_window_scale * (prev_ndc - clip_xy)
              + (view.pixel_offset - view_prev.pixel_offset))
    return motion


def convert_motion_vector_to_pixel_space(
        view: PlanarViewConstants, view_prev: PlanarViewConstants,
        pixel_x: jax.Array, pixel_y: jax.Array,
        motion: jax.Array) -> jax.Array:
    """Port of convertMotionVectorToPixelSpace (GBufferHelpers.glsl:69-80)."""
    center = jnp.stack([pixel_x.astype(jnp.float32) + 0.5,
                        pixel_y.astype(jnp.float32) + 0.5], axis=-1)
    prev_pos = center + motion[..., :2]
    prev_pos = prev_pos * (view_prev.viewport_size * view.viewport_size_inv)
    return jnp.concatenate([prev_pos - center, motion[..., 2:]], axis=-1)
