"""Bit-packing utilities for G-buffer / reservoir / light-record layouts.

JAX re-implementations (vectorized jnp uint32 bit ops) of the packed
encodings the reference renderer uses on the GPU:

- UFLOAT pack/unpack templates (8/10/11/16 bit)      (ref: src/shaders/packing.glsl:3-36)
- R11G11B10_UFLOAT                                    (ref: packing.glsl:38-53)
- R8G8B8A8 with gamma 2.2                             (ref: packing.glsl:56-89)
- R8G8B8_UFLOAT                                       (ref: src/shaders/Helpers.glsl:317-332)
- f16 pair packing (R16G16 / R16G16B16A16)            (ref: packing.glsl:92-113)
- octahedral unit-vector encodings, unorm32 + snorm2x16
  (ref: Helpers.glsl:251-268, packing.glsl:116-133, rtxdi/RtxdiMath.hlsli:126-195)
- LogLuv HDR color encoding                           (ref: rtxdi/RtxdiMath.hlsli:227-298)

All functions broadcast over leading dims; color vectors live in a trailing
dim of size 3 or 4. Everything is jit-safe and differentiable where sensible.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# f32 products that feed geometry and colour: never reduced precision
# (a GPU may run a plain f32 matrix product in TF32)
_HI = jax.lax.Precision.HIGHEST

_U32 = jnp.uint32


def _to_u32(x):
    return x.astype(_U32)


# ---------------------------------------------------------------------------
# UFLOAT templates (unsigned normalized fixed point stored in N bits)
# ---------------------------------------------------------------------------

def pack_unorm(r: jax.Array, bits: int, d: float = 0.5) -> jax.Array:
    """Pack [0,1] float into `bits`-bit unorm (ref: packing.glsl:3-17)."""
    mask = jnp.uint32((1 << bits) - 1)
    v = jnp.floor(r * jnp.float32((1 << bits) - 1) + jnp.float32(d))
    # floor of a possibly-negative/NaN float -> clamp before cast, then mask
    v = jnp.clip(v, 0.0, jnp.float32(2**32 - 1))
    return _to_u32(v) & mask


def unpack_unorm(r: jax.Array, bits: int) -> jax.Array:
    """Unpack `bits`-bit unorm to [0,1] float (ref: packing.glsl:12-17)."""
    mask = jnp.uint32((1 << bits) - 1)
    return (_to_u32(r) & mask).astype(jnp.float32) / jnp.float32((1 << bits) - 1)


# ---------------------------------------------------------------------------
# R11G11B10 UFLOAT
# ---------------------------------------------------------------------------

def pack_r11g11b10_ufloat(rgb: jax.Array) -> jax.Array:
    """[..., 3] floats in [0,1] -> u32 (ref: packing.glsl:46-53)."""
    r = pack_unorm(rgb[..., 0], 11)
    g = pack_unorm(rgb[..., 1], 11) << 11
    b = pack_unorm(rgb[..., 2], 10) << 22
    return r | g | b


def unpack_r11g11b10_ufloat(v: jax.Array) -> jax.Array:
    """u32 -> [..., 3] floats (ref: packing.glsl:38-44)."""
    v = _to_u32(v)
    return jnp.stack(
        [unpack_unorm(v, 11), unpack_unorm(v >> 11, 11), unpack_unorm(v >> 22, 10)],
        axis=-1,
    )


# ---------------------------------------------------------------------------
# R8G8B8(A8) with gamma
# ---------------------------------------------------------------------------

def pack_rgba8_gamma_ufloat(rgba: jax.Array, gamma: float = 2.2) -> jax.Array:
    """[..., 4] linear floats -> u32, gamma-encoded (ref: packing.glsl:56-66)."""
    e = jnp.power(jnp.clip(rgba, 0.0, 1.0), jnp.float32(1.0 / gamma))
    r = pack_unorm(e[..., 0], 8)
    g = pack_unorm(e[..., 1], 8) << 8
    b = pack_unorm(e[..., 2], 8) << 16
    a = pack_unorm(e[..., 3], 8) << 24
    return r | g | b | a


def unpack_rgba8_gamma_ufloat(v: jax.Array, gamma: float = 2.2) -> jax.Array:
    """u32 -> [..., 4] linear floats (ref: packing.glsl:69-79)."""
    v = _to_u32(v)
    e = jnp.stack(
        [unpack_unorm(v, 8), unpack_unorm(v >> 8, 8),
         unpack_unorm(v >> 16, 8), unpack_unorm(v >> 24, 8)],
        axis=-1,
    )
    return jnp.power(jnp.clip(e, 0.0, 1.0), jnp.float32(gamma))


def pack_rgb8_ufloat(rgb: jax.Array) -> jax.Array:
    """[..., 3] floats -> u32 low 24 bits (ref: Helpers.glsl:325-332)."""
    r = pack_unorm(rgb[..., 0], 8)
    g = pack_unorm(rgb[..., 1], 8) << 8
    b = pack_unorm(rgb[..., 2], 8) << 16
    return r | g | b


def unpack_rgb8_ufloat(v: jax.Array) -> jax.Array:
    """u32 -> [..., 3] floats (ref: Helpers.glsl:317-323)."""
    v = _to_u32(v)
    return jnp.stack(
        [unpack_unorm(v, 8), unpack_unorm(v >> 8, 8), unpack_unorm(v >> 16, 8)],
        axis=-1,
    )


# ---------------------------------------------------------------------------
# IEEE f16 pair packing
# ---------------------------------------------------------------------------

def f32_to_f16_bits(x: jax.Array) -> jax.Array:
    """float32 -> uint32 holding the 16-bit half representation (f32tof16)."""
    h = x.astype(jnp.float16)
    return jax.lax.bitcast_convert_type(h, jnp.uint16).astype(_U32)


def f16_bits_to_f32(v: jax.Array) -> jax.Array:
    """low 16 bits interpreted as half -> float32 (unpackHalf2x16 lane)."""
    h = jax.lax.bitcast_convert_type((_to_u32(v) & 0xFFFF).astype(jnp.uint16), jnp.float16)
    return h.astype(jnp.float32)


def pack_r16g16_float(rg: jax.Array) -> jax.Array:
    """[..., 2] floats -> u32 of two halves (ref: packing.glsl:92-97)."""
    return f32_to_f16_bits(rg[..., 0]) | (f32_to_f16_bits(rg[..., 1]) << 16)


def unpack_r16g16_float(v: jax.Array) -> jax.Array:
    """u32 -> [..., 2] floats (ref: packing.glsl:104-108)."""
    v = _to_u32(v)
    return jnp.stack([f16_bits_to_f32(v), f16_bits_to_f32(v >> 16)], axis=-1)


def pack_r16g16b16a16_float(rgba: jax.Array) -> jax.Array:
    """[..., 4] floats -> [..., 2] u32 (ref: packing.glsl:99-102)."""
    return jnp.stack(
        [pack_r16g16_float(rgba[..., 0:2]), pack_r16g16_float(rgba[..., 2:4])],
        axis=-1,
    )


def unpack_r16g16b16a16_float(v: jax.Array) -> jax.Array:
    """[..., 2] u32 -> [..., 4] floats (ref: packing.glsl:110-113)."""
    return jnp.concatenate(
        [unpack_r16g16_float(v[..., 0]), unpack_r16g16_float(v[..., 1])],
        axis=-1,
    )


# ---------------------------------------------------------------------------
# Octahedral unit-vector encodings
# ---------------------------------------------------------------------------

def oct_wrap(v: jax.Array) -> jax.Array:
    """Fold lower-hemisphere oct coords, per-component signs
    (ref: RtxdiMath.hlsli:155-159).

    NOTE: the reference's app-shader variant (Helpers.glsl:251-254) mistranslates
    the HLSL vector select into a scalar `(v.x >= 0 || v.y >= 0)`, which destroys
    the sign of one component whenever z < 0 and sign(x) != sign(y) — G-buffer
    normals in that octant decode wrong in the reference renderer. We use the
    correct per-component mapping (which the RTXDI reservoir path also uses).
    """
    vx, vy = v[..., 0], v[..., 1]
    sx = jnp.where(vx >= 0.0, 1.0, -1.0)
    sy = jnp.where(vy >= 0.0, 1.0, -1.0)
    return jnp.stack(
        [(1.0 - jnp.abs(vy)) * sx, (1.0 - jnp.abs(vx)) * sy], axis=-1
    )


def ndir_to_oct_signed(n: jax.Array) -> jax.Array:
    """Unit vector [...,3] -> signed oct coords [...,2]
    (ref: RtxdiMath.hlsli:149-163, Helpers.glsl:256-261 modulo its wrap bug)."""
    denom = jnp.abs(n[..., 0]) + jnp.abs(n[..., 1]) + jnp.abs(n[..., 2])
    p = n[..., 0:2] / denom[..., None]
    return jnp.where(n[..., 2:3] < 0.0, oct_wrap(p), p)


def oct_to_ndir_signed(p: jax.Array) -> jax.Array:
    """Signed oct coords [...,2] -> unit vector [...,3]
    (ref: RtxdiMath.hlsli:168-181; packing.glsl:116-124 has the scalar-sign
    porting bug, see oct_wrap)."""
    px, py = p[..., 0], p[..., 1]
    nz = 1.0 - jnp.abs(px) - jnp.abs(py)
    t = jnp.maximum(0.0, -nz)
    nx = px + jnp.where(px >= 0.0, -t, t)
    ny = py + jnp.where(py >= 0.0, -t, t)
    n = jnp.stack([nx, ny, nz], axis=-1)
    return n / jnp.linalg.norm(n, axis=-1, keepdims=True)


def ndir_to_oct_unorm32(n: jax.Array) -> jax.Array:
    """Unit vector -> u32 (2x16 unorm oct) (ref: Helpers.glsl:263-268)."""
    p = jnp.clip(ndir_to_oct_signed(n) * 0.5 + 0.5, 0.0, 1.0)
    x = _to_u32(p[..., 0] * jnp.float32(0xFFFE))
    y = _to_u32(p[..., 1] * jnp.float32(0xFFFE))
    return x | (y << 16)


def oct_unorm32_to_ndir(v: jax.Array) -> jax.Array:
    """u32 -> unit vector (ref: packing.glsl:126-133)."""
    v = _to_u32(v)
    px = jnp.clip((v & 0xFFFF).astype(jnp.float32) / jnp.float32(0xFFFE), 0.0, 1.0)
    py = jnp.clip((v >> 16).astype(jnp.float32) / jnp.float32(0xFFFE), 0.0, 1.0)
    p = jnp.stack([px, py], axis=-1) * 2.0 - 1.0
    return oct_to_ndir_signed(p)


# ---------------------------------------------------------------------------
# snorm2x16 octahedral variant used by reservoirs (rtxdi/RtxdiMath.hlsli)
# ---------------------------------------------------------------------------

def pack_snorm2x16(v: jax.Array) -> jax.Array:
    """[..., 2] floats in [-1,1] -> u32 (ref: RtxdiMath.hlsli:135-144)."""
    nan = jnp.isnan(v).any(axis=-1, keepdims=True)
    v = jnp.where(nan, 0.0, jnp.clip(v, -1.0, 1.0))
    iv = jnp.round(v * 32767.0).astype(jnp.int32)
    return (iv[..., 0].astype(_U32) & 0xFFFF) | (iv[..., 1].astype(_U32) << 16)


def unpack_snorm2x16(packed: jax.Array) -> jax.Array:
    """u32 -> [..., 2] floats in [-1,1] (ref: RtxdiMath.hlsli:126-133)."""
    p = _to_u32(packed)
    x = (p << 16).astype(jnp.int32) >> 16
    y = p.astype(jnp.int32) >> 16
    return jnp.maximum(jnp.stack([x, y], axis=-1).astype(jnp.float32) / 32767.0, -1.0)


def encode_normal_snorm2x16(n: jax.Array) -> jax.Array:
    """Unit vector -> u32 via oct + snorm2x16 (ref: RtxdiMath.hlsli:184-188)."""
    return pack_snorm2x16(ndir_to_oct_signed(n))


def decode_normal_snorm2x16(packed: jax.Array) -> jax.Array:
    """u32 -> unit vector (ref: RtxdiMath.hlsli:190-195)."""
    return oct_to_ndir_signed(unpack_snorm2x16(packed))


# ---------------------------------------------------------------------------
# Z-curve (Morton order) index math
# ---------------------------------------------------------------------------

def integer_explode(x: jax.Array) -> jax.Array:
    """Insert 0 between each of the low 16 bits (ref: RtxdiMath.hlsli:33-40)."""
    x = _to_u32(x)
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def integer_compact(x: jax.Array) -> jax.Array:
    """Inverse of integer_explode (ref: RtxdiMath.hlsli:45-52)."""
    x = _to_u32(x)
    x = (x & 0x11111111) | ((x & 0x44444444) >> 1)
    x = (x & 0x03030303) | ((x & 0x30303030) >> 2)
    x = (x & 0x000F000F) | ((x & 0x0F000F00) >> 4)
    x = (x & 0x000000FF) | ((x & 0x00FF0000) >> 8)
    return x


def zcurve_to_linear(x: jax.Array, y: jax.Array) -> jax.Array:
    """(x, y) -> Z-curve linear index (ref: RtxdiMath.hlsli:55-58)."""
    return integer_explode(x) | (integer_explode(y) << 1)


def linear_to_zcurve(index: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Z-curve linear index -> (x, y) (ref: RtxdiMath.hlsli:61-66)."""
    i = _to_u32(index)
    return integer_compact(i), integer_compact(i >> 1)


# ---------------------------------------------------------------------------
# LogLuv HDR color (used by packed light-info records)
# ---------------------------------------------------------------------------

_RGB_TO_XYZ = jnp.array(
    [[0.4123907992659595, 0.3575843393838780, 0.1804807884018343],
     [0.2126390058715104, 0.7151686787677559, 0.0721923153607337],
     [0.0193308187155918, 0.1191947797946259, 0.9505321522496608]],
    dtype=jnp.float32,
)

_XYZ_TO_RGB = jnp.array(
    [[3.240969941904522, -1.537383177570094, -0.4986107602930032],
     [-0.9692436362808803, 1.875967501507721, 0.04155505740717569],
     [0.05563007969699373, -0.2039769588889765, 1.056971514242878]],
    dtype=jnp.float32,
)


def encode_rgb_to_logluv(color: jax.Array) -> jax.Array:
    """[..., 3] HDR RGB -> u32 LogLuv (ref: RtxdiMath.hlsli:233-265)."""
    xyz = jnp.einsum("ij,...j->...i", _RGB_TO_XYZ, color, precision=_HI)
    y = xyz[..., 1]
    log_y = 409.6 * (jnp.log2(jnp.maximum(y, 1e-30)) + 20.0)
    le = _to_u32(jnp.clip(log_y, 0.0, 16383.0))
    inv_denom = 1.0 / (-2.0 * xyz[..., 0] + 12.0 * xyz[..., 1]
                       + 3.0 * (xyz[..., 0] + xyz[..., 1] + xyz[..., 2]))
    u = 4.0 * xyz[..., 0] * inv_denom
    v = 9.0 * xyz[..., 1] * inv_denom
    ue = _to_u32(jnp.clip(820.0 * u, 0.0, 511.0))
    ve = _to_u32(jnp.clip(820.0 * v, 0.0, 511.0))
    packed = (le << 18) | (ue << 9) | ve
    return jnp.where((le == 0) | (y <= 0.0), jnp.uint32(0), packed)


def decode_logluv_to_rgb(packed: jax.Array) -> jax.Array:
    """u32 LogLuv -> [..., 3] HDR RGB (ref: RtxdiMath.hlsli:269-298)."""
    packed = _to_u32(packed)
    le = packed >> 18
    log_y = (le.astype(jnp.float32) + 0.5) / 409.6 - 20.0
    y = jnp.exp2(log_y)
    ue = ((packed >> 9) & 0x1FF).astype(jnp.float32)
    ve = (packed & 0x1FF).astype(jnp.float32)
    u = (ue + 0.5) / 820.0
    v = (ve + 0.5) / 820.0
    inv_denom = 1.0 / (6.0 * u - 16.0 * v + 12.0)
    x = 9.0 * u * inv_denom
    yy = 4.0 * v * inv_denom
    s = y / jnp.maximum(yy, 1e-30)
    xyz = jnp.stack([s * x, y, s * (1.0 - x - yy)], axis=-1)
    rgb = jnp.maximum(
        jnp.einsum("ij,...j->...i", _XYZ_TO_RGB, xyz, precision=_HI), 0.0)
    return jnp.where((le == 0)[..., None], 0.0, rgb)
