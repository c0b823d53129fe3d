"""Counter-based per-pixel RNG, bit-exact port of the reference's murmur3 sampler.

The reference seeds one sampler per (pixel, pass, frame) with a Jenkins hash of
the Z-curve pixel index (src/shaders/Helpers.glsl:13-23) and draws uniforms by
hashing an incrementing counter with a murmur3 finalizer (Helpers.glsl:25-64).
Stateless counter-based hashing is the natural fit for whole-array execution: the "state" is a
pair of uint32 arrays (seed, index) carried functionally, so any number of
pixels draw in parallel with zero cross-lane interaction.

All functions broadcast over arbitrary leading shapes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

_U32 = jnp.uint32


def jenkins_hash(a: jax.Array) -> jax.Array:
    """32-bit Jenkins integer hash (ref: rtxdi/RtxdiMath.hlsli:69-79)."""
    a = a.astype(_U32)
    a = (a + jnp.uint32(0x7ED55D16)) + (a << 12)
    a = (a ^ jnp.uint32(0xC761C23C)) ^ (a >> 19)
    a = (a + jnp.uint32(0x165667B1)) + (a << 5)
    a = (a + jnp.uint32(0xD3A2646C)) ^ (a << 9)
    a = (a + jnp.uint32(0xFD7046C5)) + (a << 3)
    a = (a ^ jnp.uint32(0xB55A4F09)) ^ (a >> 16)
    return a


class RngState(NamedTuple):
    """Functional murmur3 sampler state (ref: Helpers.glsl:7-11)."""

    seed: jax.Array  # uint32
    index: jax.Array  # uint32


def init_random_sampler(pixel_x: jax.Array, pixel_y: jax.Array,
                        frame_index) -> RngState:
    """Seed one sampler per pixel (ref: Helpers.glsl:13-23).

    `frame_index` is `frame + pass * 13` at call sites that mirror
    RAB_InitRandomSampler (RtxdiApplicationBridge.glsl:378-381).
    """
    from raytracer2.utils.packing import zcurve_to_linear

    linear = zcurve_to_linear(pixel_x.astype(_U32), pixel_y.astype(_U32))
    seed = jenkins_hash(linear) + jnp.uint32(frame_index)
    return RngState(seed=seed, index=jnp.ones_like(seed))


def _rot32(x: jax.Array, y: int) -> jax.Array:
    return (x << y) | (x >> (32 - y))


def murmur3(state: RngState) -> tuple[jax.Array, RngState]:
    """One murmur3 finalizer step; returns (bits, new_state) (ref: Helpers.glsl:25-56)."""
    c1 = jnp.uint32(0xCC9E2D51)
    c2 = jnp.uint32(0x1B873593)

    h = state.seed
    k = state.index * c1
    k = _rot32(k, 15)
    k = k * c2

    h = h ^ k
    h = _rot32(h, 13) * jnp.uint32(5) + jnp.uint32(0xE6546B64)

    h = h ^ jnp.uint32(4)
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0xC2B2AE35)
    h = h ^ (h >> 16)

    return h, RngState(seed=state.seed, index=state.index + jnp.uint32(1))


def sample_uniform(state: RngState) -> tuple[jax.Array, RngState]:
    """Uniform float in [0, 1); returns (value, new_state) (ref: Helpers.glsl:58-64).

    Builds the float from 23 mantissa bits exactly like the GLSL:
    asfloat((mask & v) | asuint(1.f)) - 1.f
    """
    v, state = murmur3(state)
    mantissa = (v & jnp.uint32((1 << 23) - 1)) | jnp.uint32(0x3F800000)
    f = jax.lax.bitcast_convert_type(mantissa, jnp.float32) - 1.0
    return f, state


def sample_uniform_n(state: RngState, n: int) -> tuple[jax.Array, RngState]:
    """Draw n uniforms; returns (values stacked on axis -1, new_state)."""
    vals = []
    for _ in range(n):
        v, state = sample_uniform(state)
        vals.append(v)
    return jnp.stack(vals, axis=-1), state


# ---------------------------------------------------------------------------
# The simple LCG-ish generator from common.glsl (used by the legacy helpers)
# ---------------------------------------------------------------------------

def next_random(state: jax.Array) -> tuple[jax.Array, jax.Array]:
    """PCG-style hash step (ref: src/shaders/common.glsl:39-44)."""
    state = state.astype(_U32) * jnp.uint32(747796405) + jnp.uint32(2891336453)
    result = ((state >> ((state >> 28) + jnp.uint32(4))) ^ state) * jnp.uint32(277803737)
    result = (result >> 22) ^ result
    return result, state


def random_value(state: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Uniform [0,1] from the PCG step (ref: common.glsl:46-48)."""
    bits, state = next_random(state)
    return bits.astype(jnp.float32) / jnp.float32(4294967295.0), state
