"""GI sample reservoirs.

Pure-functional port of rtxdi/GIReservoir.hlsli: SoA reservoir pytree plus
the packed 32-byte form (position f32x3 + snorm2x16 oct normal + LogLuv
radiance + age/M byte fields) for storage-parity tests.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytracer2.utils import packing as pk

MAX_M = 0xFF  # (GIReservoir.hlsli:52-56)
MAX_AGE = 0xFF
M_SHIFT = 0
AGE_SHIFT = 8
MISC_DATA_MASK = 0xFFFF0000


class GIReservoir(NamedTuple):
    """RTXDI_GIReservoir (GIReservoir.hlsli:29-49), SoA over pixels."""

    position: jax.Array  # [..., 3] secondary-surface position
    normal: jax.Array  # [..., 3]
    radiance: jax.Array  # [..., 3]
    weight_sum: jax.Array  # [...]
    m: jax.Array  # [...] u32
    age: jax.Array  # [...] u32


def empty_gi_reservoir(shape) -> GIReservoir:
    """(GIReservoir.hlsli:168-180)."""
    return GIReservoir(
        position=jnp.zeros(shape + (3,), jnp.float32),
        normal=jnp.zeros(shape + (3,), jnp.float32),
        radiance=jnp.zeros(shape + (3,), jnp.float32),
        weight_sum=jnp.zeros(shape, jnp.float32),
        m=jnp.zeros(shape, jnp.uint32),
        age=jnp.zeros(shape, jnp.uint32),
    )


def is_valid(res: GIReservoir) -> jax.Array:
    """(GIReservoir.hlsli:182-185)."""
    return res.m != 0


def where_gi(mask: jax.Array, a: GIReservoir, b: GIReservoir) -> GIReservoir:
    m2 = mask[..., None]
    return GIReservoir(
        position=jnp.where(m2, a.position, b.position),
        normal=jnp.where(m2, a.normal, b.normal),
        radiance=jnp.where(m2, a.radiance, b.radiance),
        weight_sum=jnp.where(mask, a.weight_sum, b.weight_sum),
        m=jnp.where(mask, a.m, b.m),
        age=jnp.where(mask, a.age, b.age),
    )


def make_gi_reservoir(position: jax.Array, normal: jax.Array,
                      radiance: jax.Array, sample_pdf: jax.Array
                      ) -> GIReservoir:
    """RTXDI_MakeGIReservoir (GIResamplingFunctions.hlsli:97-127 in the
    reference tree): a fresh single-sample reservoir; weightSum = 1/pdf."""
    inv_pdf = jnp.where(sample_pdf > 0.0, 1.0 / jnp.maximum(sample_pdf, 1e-30),
                        0.0)
    shape = sample_pdf.shape
    return GIReservoir(
        position=position, normal=normal, radiance=radiance,
        weight_sum=inv_pdf,
        m=jnp.where(sample_pdf > 0.0, 1, 0).astype(jnp.uint32),
        age=jnp.zeros(shape, jnp.uint32),
    )


class PackedGIReservoir(NamedTuple):
    """(ReSTIRGIParameters.h packed struct): 8 u32 words / 32 bytes."""

    position: jax.Array  # [..., 3] f32
    packed_normal: jax.Array  # u32 snorm2x16 oct
    weight: jax.Array  # f32
    packed_radiance: jax.Array  # u32 LogLuv
    packed_misc_age_m: jax.Array  # u32
    unused: jax.Array  # u32


def pack_gi_reservoir(res: GIReservoir, misc_data=0) -> PackedGIReservoir:
    """(GIReservoir.hlsli:66-83)."""
    packed_misc = ((jnp.uint32(misc_data) & jnp.uint32(MISC_DATA_MASK))
                   | (jnp.minimum(res.age, MAX_AGE) << AGE_SHIFT)
                   | (jnp.minimum(res.m, MAX_M) << M_SHIFT))
    return PackedGIReservoir(
        position=res.position,
        packed_normal=pk.encode_normal_snorm2x16(res.normal),
        weight=res.weight_sum,
        packed_radiance=pk.encode_rgb_to_logluv(res.radiance),
        packed_misc_age_m=packed_misc,
        unused=jnp.zeros_like(packed_misc),
    )


def unpack_gi_reservoir(p: PackedGIReservoir) -> GIReservoir:
    """(GIReservoir.hlsli:87-105)."""
    return GIReservoir(
        position=p.position,
        normal=pk.decode_normal_snorm2x16(p.packed_normal),
        radiance=pk.decode_logluv_to_rgb(p.packed_radiance),
        weight_sum=p.weight,
        m=(p.packed_misc_age_m >> M_SHIFT) & MAX_M,
        age=(p.packed_misc_age_m >> AGE_SHIFT) & MAX_AGE,
    )
