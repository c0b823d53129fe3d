"""Composite + AgX tonemap pass.

Port of src/shaders/post_processing.comp: reference-mode passthrough,
albedo/specular remodulation + emissive add for the lit path, environment
radiance + env motion vectors for background pixels, then AgX (input
transform, log2 encode, sigmoid fit, look, inverse outset + 2.2 EOTF), a
gamma-2.2 encode whose result the reference computes but never uses
(post_processing.comp:186 assigns `gamma_cor` then stores `col` — quirk
preserved), and the NaN->red debug canary (post_processing.comp:187-189).

One fused XLA kernel; no 8x8 workgroup tiling needed.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytracer2.params import BACKGROUND_DEPTH, GConst
from raytracer2.render import rays as raysmod
from raytracer2.scene.scene import Scene, get_environment_radiance

# f32 products that feed geometry and colour: never reduced precision
# (a GPU may run a plain f32 matrix product in TF32)
_HI = jax.lax.Precision.HIGHEST

_AGX_MAT = jnp.array([
    [0.842479062253094, 0.0784335999999992, 0.0792237451477643],
    [0.0423282422610123, 0.878468636469772, 0.0791661274605434],
    [0.0423756549057051, 0.0784336, 0.879142973793104],
], dtype=jnp.float32)
# GLSL mat3 constructor is column-major; `agx_mat * val` therefore applies the
# matrix whose ROWS are the listed triples transposed (post_processing.comp:61-64)

_AGX_MAT_INV = jnp.array([
    [1.19687900512017, -0.0980208811401368, -0.0990297440797205],
    [-0.0528968517574562, 1.15190312990417, -0.0989611768448433],
    [-0.0529716355144438, -0.0980434501171241, 1.15107367264116],
], dtype=jnp.float32)

_MIN_EV = -12.47393
_MAX_EV = 4.026069


def agx_default_contrast_approx(x: jax.Array) -> jax.Array:
    """6th-order sigmoid fit (post_processing.comp:47-58)."""
    x2 = x * x
    x4 = x2 * x2
    return (15.5 * x4 * x2 - 40.14 * x4 * x + 31.96 * x4
            - 6.868 * x2 * x + 0.4298 * x2 + 0.1191 * x - 0.00232)


def agx(val: jax.Array) -> jax.Array:
    """AgX input transform + log2 encode + sigmoid (post_processing.comp:60-80)."""
    val = jnp.einsum("ij,...j->...i", _AGX_MAT, val, precision=_HI)
    val = jnp.clip(jnp.log2(jnp.maximum(val, 1e-10)), _MIN_EV, _MAX_EV)
    val = (val - _MIN_EV) / (_MAX_EV - _MIN_EV)
    return agx_default_contrast_approx(val)


def agx_eotf(val: jax.Array) -> jax.Array:
    """Inverse outset + sRGB 2.2 linearization (post_processing.comp:82-97)."""
    val = jnp.einsum("ij,...j->...i", _AGX_MAT_INV, val, precision=_HI)
    return jnp.power(jnp.maximum(val, 0.0), 2.2)


def agx_look(val: jax.Array, look: int = 0) -> jax.Array:
    """ASC CDL grade (post_processing.comp:99-124). look: 0 default,
    1 golden, 2 punchy (compile-time AGX_LOOK in the reference)."""
    lw = jnp.array([0.2126, 0.7152, 0.0722], dtype=val.dtype)
    luma = jnp.sum(val * lw, axis=-1, keepdims=True)
    if look == 1:
        slope = jnp.array([1.0, 0.9, 0.5], val.dtype)
        power = jnp.array([0.8, 0.8, 0.8], val.dtype)
        sat = 0.8
    elif look == 2:
        slope = jnp.array([1.0, 1.0, 1.0], val.dtype)
        power = jnp.array([1.35, 1.35, 1.35], val.dtype)
        sat = 1.4
    else:
        slope = jnp.ones(3, val.dtype)
        power = jnp.ones(3, val.dtype)
        sat = 1.0
    val = jnp.power(jnp.maximum(val * slope, 0.0), power)
    return luma + sat * (val - luma)


def tonemap(col: jax.Array, look: int = 0) -> jax.Array:
    """Full AgX chain incl. the NaN->red canary (post_processing.comp:182-189)."""
    col = agx(col)
    col = agx_look(col, look)
    col = agx_eotf(col)
    col = jnp.maximum(col, 0.000001)
    nan = jnp.isnan(col).any(axis=-1, keepdims=True)
    red = jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], col.dtype), col.shape)
    # the rgba8-unorm swapchain store clamps (post_processing.comp:190);
    # the AgX sigmoid fit can overshoot 1.0 by ~6e-4
    return jnp.clip(jnp.where(nan, red, col), 0.0, 1.0)


class PostProcessInputs(NamedTuple):
    """Buffers the pass reads (post_processing.comp:9-19)."""

    depth: jax.Array  # [H, W]
    diffuse_albedo: jax.Array  # [H, W, 3] (unpacked R11G11B10)
    specular_f0: jax.Array  # [H, W, 3] (unpacked RGBA8-gamma rgb)
    emissive: jax.Array  # [H, W, 3]
    diffuse: jax.Array  # [H, W, 3] diffuse lighting
    specular: jax.Array  # [H, W, 3] specular lighting


def post_process(
    scene: Scene,
    g_const: GConst,
    inputs: PostProcessInputs,
    row0=0,
) -> tuple[jax.Array, jax.Array]:
    """Full pass (post_processing.comp:152-190). Returns (output [H,W,3] in
    [0,1], env_motion [H,W,2] for background pixels — the pass writes these
    into MotionVectors, post_processing.comp:178)."""
    h, w = inputs.depth.shape
    px, py = raysmod.pixel_grid(w, h)
    py = py + row0

    if g_const.refrence_mode:
        col = inputs.diffuse
        env_motion = jnp.zeros((h, w, 2), jnp.float32)
    else:
        lit = inputs.diffuse
        spec = inputs.specular
        if g_const.textures:
            lit = lit * inputs.diffuse_albedo
            spec = spec * jnp.maximum(0.01, inputs.specular_f0)
        col_fg = lit + spec + inputs.emissive

        rays = raysmod.setup_primary_ray(px, py, g_const.view)
        col_bg = get_environment_radiance(
            scene, rays.direction, g_const.environment)
        window_pos = jnp.stack(
            [px.astype(jnp.float32) + 0.5, py.astype(jnp.float32) + 0.5],
            axis=-1)
        env_motion = raysmod.get_environment_motion_vector(
            g_const.view, g_const.prev_view, window_pos)

        is_fg = (inputs.depth != BACKGROUND_DEPTH)[..., None]
        col = jnp.where(is_fg, col_fg, col_bg)
        env_motion = jnp.where(is_fg[..., 0:1], 0.0, env_motion)

    return tonemap(col), env_motion


def to_srgb_u8(img: jax.Array) -> jax.Array:
    """[0,1] float -> u8 for display/PNG (the rgba8 swapchain store)."""
    return jnp.clip(jnp.round(img * 255.0), 0, 255).astype(jnp.uint8)
