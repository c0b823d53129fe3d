"""PDF textures, mip pyramids and hierarchical importance sampling.

Replaces three reference pieces:
- the mip-generation compute kernels (src/shaders/generate_mip_levels/
  mips.glsl: 16x16-tile subgroup reduction, 5 mips per dispatch) with a
  `lax.scan`-style chain of 2x2 average pools — no wave intrinsics needed;
- env-PDF initialization (env variant: luminance x cos(elevation), f16-clamped,
  mips.glsl:44-62);
- the hierarchical mip-descent sampler RTXDI_SamplePdfMipmap
  (rtxdi/PresamplingFunctions.hlsli:30-94), vectorized over a sample batch.

Texture sizing ports compute_pdf_texture_size (light_passes.rs:700-716).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from raytracer2.utils import brdf
from raytracer2.utils import rng as rtrng

F16_MAX = 65504.0


def compute_pdf_texture_size(max_items: int) -> tuple[int, int, int]:
    """Power-of-2 rectangle fitting max_items (light_passes.rs:700-716).
    Returns (width, height, mips)."""
    w = max(1.0, math.ceil(math.sqrt(max(max_items, 1))))
    w = 2.0 ** math.ceil(math.log2(w))
    h = max(1.0, math.ceil(max(max_items, 1) / w))
    h = 2.0 ** math.ceil(math.log2(h))
    mips = max(1.0, math.log2(max(w, h)) + 1.0)
    return int(w), int(h), int(mips)


def build_mip_chain(base: jax.Array) -> tuple[jax.Array, ...]:
    """Full 2x2-average mip chain down to 1x1 (mips.glsl equivalent).
    base: [H, W]; H, W powers of two (H may differ from W)."""
    mips = [base]
    cur = base
    while cur.shape[0] > 1 or cur.shape[1] > 1:
        h, w = cur.shape
        nh, nw = max(h // 2, 1), max(w // 2, 1)
        if h > 1 and w > 1:
            cur = cur.reshape(nh, 2, nw, 2).mean(axis=(1, 3))
        elif w > 1:
            cur = cur.reshape(1, nw, 2).mean(axis=2)
        else:
            cur = cur.reshape(nh, 2, 1).mean(axis=1)
        mips.append(cur)
    return tuple(mips)


def environment_pdf_base(skybox: jax.Array, out_size: tuple[int, int]
                         ) -> jax.Array:
    """Env-PDF mip 0: luminance x cos(elevation), f16-clamped
    (env_mip_levels variant of mips.glsl:44-62). The reference sizes this
    texture to the skybox extent (render_resources.rs:208-220); `out_size`
    is (w, h) and the skybox is point-sampled into it."""
    w, h = out_size
    ys = (jnp.arange(h, dtype=jnp.float32) + 0.5) / h
    xs = (jnp.arange(w, dtype=jnp.float32) + 0.5) / w
    sy = jnp.clip((ys * skybox.shape[0]).astype(jnp.int32), 0,
                  skybox.shape[0] - 1)
    sx = jnp.clip((xs * skybox.shape[1]).astype(jnp.int32), 0,
                  skybox.shape[1] - 1)
    texel = skybox[sy[:, None], sx[None, :]]
    lum = brdf.luminance(texel)
    elevation = (0.5 - ys) * jnp.pi
    weight = lum * jnp.cos(elevation)[:, None]
    return jnp.clip(weight, 0.0, F16_MAX)


def local_light_pdf_base(flux: jax.Array, tex_w: int, tex_h: int) -> jax.Array:
    """Local-light PDF mip 0: flux scattered to the Z-curve texel of each
    light index (prepare_lights.comp:121-125)."""
    from raytracer2.utils.packing import linear_to_zcurve

    idx = jnp.arange(flux.shape[0], dtype=jnp.uint32)
    x, y = linear_to_zcurve(idx)
    tex = jnp.zeros((tex_h, tex_w), jnp.float32)
    return tex.at[y.astype(jnp.int32), x.astype(jnp.int32)].set(flux)


def sample_pdf_mipmap(
    rng_state: rtrng.RngState,
    mips: tuple[jax.Array, ...],
    batch_shape: tuple[int, ...],
) -> tuple[jax.Array, jax.Array, jax.Array, rtrng.RngState]:
    """Vectorized RTXDI_SamplePdfMipmap (PresamplingFunctions.hlsli:30-94).

    Descends the quadtree from lastMip-1 to mip 0, choosing one of 4 texels
    per level proportionally to weight. Returns (x, y, pdf, rng); pdf is the
    discrete probability of the chosen mip-0 texel. Lanes that hit a
    zero-weight quad go dead (pdf=0) and stop consuming RNG draws, matching
    the GLSL early-return.
    """
    h0, w0 = mips[0].shape
    last_mip = max(0, int(math.floor(math.log2(max(w0, h0)))) - 1)

    x = jnp.zeros(batch_shape, jnp.int32)
    y = jnp.zeros(batch_shape, jnp.int32)
    pdf = jnp.ones(batch_shape, jnp.float32)
    dead = jnp.zeros(batch_shape, bool)

    for level in range(last_mip, -1, -1):
        tex = mips[level]
        th, tw = tex.shape
        x = x * 2
        y = y * 2

        def texel(dx, dy):
            xx = jnp.clip(x + dx, 0, tw - 1)
            yy = jnp.clip(y + dy, 0, th - 1)
            v = tex[yy, xx]
            # out-of-range loads return 0 in the GLSL (robustness2)
            v = jnp.where((x + dx < tw) & (y + dy < th), v, 0.0)
            return jnp.maximum(v, 0.0)

        s00 = texel(0, 0)  # samples.x
        s01 = texel(0, 1)  # samples.y (x+0, y+1)
        s10 = texel(1, 0)  # samples.z
        s11 = texel(1, 1)  # samples.w
        wsum = s00 + s01 + s10 + s11
        newly_dead = wsum <= 0.0
        wsafe = jnp.where(newly_dead, 1.0, wsum)
        p00, p01, p10, p11 = s00 / wsafe, s01 / wsafe, s10 / wsafe, s11 / wsafe

        rnd, advanced = rtrng.sample_uniform(rng_state)
        take = ~dead & ~newly_dead
        rng_state = rtrng.RngState(
            seed=rng_state.seed,
            index=jnp.where(take, advanced.index, rng_state.index))

        in0 = rnd < p00
        r1 = rnd - p00
        in1 = ~in0 & (r1 < p01)
        r2 = r1 - p01
        in2 = ~in0 & ~in1 & (r2 < p10)
        in3 = ~in0 & ~in1 & ~in2

        dx = jnp.where(in2 | in3, 1, 0)
        dy = jnp.where(in1 | in3, 1, 0)
        psel = jnp.where(in0, p00,
                         jnp.where(in1, p01, jnp.where(in2, p10, p11)))

        x = jnp.where(take, x + dx, x)
        y = jnp.where(take, y + dy, y)
        pdf = jnp.where(take, pdf * psel, pdf)
        dead = dead | newly_dead
        pdf = jnp.where(dead, 0.0, pdf)

    return x, y, pdf, rng_state


def evaluate_pdf_texture(mips: tuple[jax.Array, ...], x: jax.Array,
                         y: jax.Array) -> jax.Array:
    """Normalized pdf of texel (x, y): texel / (avg * squarePaddedCount)
    (RAB_EvaluateEnvironmentMapSamplingPdf / LocalLightSourcePdf,
    RtxdiApplicationBridge.glsl:397-434)."""
    h, w = mips[0].shape
    last_mip = max(0, int(math.floor(math.log2(max(w, h)))))
    avg = mips[min(last_mip, len(mips) - 1)][0, 0]
    total = avg * jnp.float32((1 << last_mip) ** 2)
    xx = jnp.clip(x, 0, w - 1)
    yy = jnp.clip(y, 0, h - 1)
    return mips[0][yy, xx] / jnp.maximum(total, 1e-30)


def fill_neighbor_offsets(count: int = 8192) -> jax.Array:
    """Low-discrepancy disk offsets (light_passes.rs:671-698): plastic
    sequence points inside a disk, radius-250 bytes. The reference stores
    them as i8 and the shader reads them as snorm-scaled floats; we emit the
    equivalent floats in [-1, 1] (value/127 of the stored byte) directly."""
    import numpy as np

    offsets = np.zeros((count, 2), np.float32)
    phi2 = 1.0 / 1.3247179572447
    u, v = 0.5, 0.5
    n = 0
    while n < count:
        u += phi2
        v += phi2 * phi2
        if u >= 1.0:
            u -= 1.0
        if v >= 1.0:
            v -= 1.0
        if (u - 0.5) ** 2 + (v - 0.5) ** 2 > 0.25:
            continue
        # i8 truncation of (u-0.5)*250, then snorm /127 on read
        bx = np.float32(int((u - 0.5) * 250.0)) / 127.0
        by = np.float32(int((v - 0.5) * 250.0)) / 127.0
        offsets[n] = (bx, by)
        n += 1
    return jnp.asarray(offsets)
