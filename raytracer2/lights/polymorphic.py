"""Polymorphic light records and sampling.

Port of src/shaders/PolymorphicLight.glsl as SoA arrays + branchless
type dispatch: the 48-byte packed RAB_LightInfo record (PolymorphicLight.glsl:
19-36) becomes six parallel u32/f32 arrays with byte-identical field
encodings (RGB8+log-radiance color :62-93, oct-encoded edge directions +
f16 lengths for triangles :345-357). Light types: point, triangle,
directional, environment (sphere/cylinder/disk/rect exist in the enum but the
reference never creates them — same here).

The GLSL switch dispatch (calcSample :429-452) becomes masked evaluation of
all four types + `jnp.where` select: a vectorized batch pays every branch
anyway, and there are only four cheap branches. Light shaping (spot/IES) is
stubbed to 1.0 exactly like the reference (LightShaping.glsl:27-54).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytracer2.utils import brdf
from raytracer2.utils import packing as pk

# Light-type codes (PolymorphicLight.glsl:6-13)
K_SPHERE = 0
K_CYLINDER = 1
K_DISK = 2
K_RECT = 3
K_TRIANGLE = 4
K_DIRECTIONAL = 5
K_ENVIRONMENT = 6
K_POINT = 7

# Packing constants (ShaderParameters.glsl:14-19)
K_TYPE_SHIFT = 24
K_TYPE_MASK = 0xF
K_MIN_LOG2_RADIANCE = -8.0
K_MAX_LOG2_RADIANCE = 40.0

LIGHT_SAMPLING_EPSILON = 1e-10
DISTANT_LIGHT_DISTANCE = 1000.0  # (PolymorphicLight.glsl:43)


class LightInfo(NamedTuple):
    """SoA RAB_LightInfo (PolymorphicLight.glsl:19-36) including the
    optional shaping words (the reference's uint4[2] second half,
    LightShaping.glsl:16-25). All-zero shaping words = unshaped (the
    shaping-enable bit lives in color_type_and_flags bit 28), which is
    what the reference's prepare pass always emits."""

    center: jax.Array  # [L, 3] f32
    color_type_and_flags: jax.Array  # [L] u32
    direction1: jax.Array  # [L] u32 oct
    direction2: jax.Array  # [L] u32 oct
    scalars: jax.Array  # [L] u32 2xf16
    log_radiance: jax.Array  # [L] u32 (u16 used)
    shaping_axis: jax.Array  # [L] u32 oct primary axis
    shaping_cone: jax.Array  # [L] u32 f16 cosConeAngle | f16 softness << 16
    shaping_ies: jax.Array  # [L] u32 IES profile index


def _zero_shaping(n: int) -> dict:
    return dict(shaping_axis=jnp.zeros((n,), jnp.uint32),
                shaping_cone=jnp.zeros((n,), jnp.uint32),
                shaping_ies=jnp.zeros((n,), jnp.uint32))


def get_shaping(info: LightInfo):
    """unpackLightShaping (LightShaping.glsl:16-25)."""
    from raytracer2.lights.shaping import unpack_light_shaping

    return unpack_light_shaping(info.color_type_and_flags,
                                info.shaping_axis, info.shaping_cone,
                                info.shaping_ies)


def empty_light_info(n: int) -> LightInfo:
    return LightInfo(
        center=jnp.zeros((n, 3), jnp.float32),
        color_type_and_flags=jnp.zeros((n,), jnp.uint32),
        direction1=jnp.zeros((n,), jnp.uint32),
        direction2=jnp.zeros((n,), jnp.uint32),
        scalars=jnp.zeros((n,), jnp.uint32),
        log_radiance=jnp.zeros((n,), jnp.uint32),
        **_zero_shaping(n),
    )


def gather_light(lights: LightInfo, index: jax.Array) -> LightInfo:
    """RAB_LoadLightInfo (bridge:556-559): gather records at `index`."""
    i = jnp.maximum(index.astype(jnp.int32), 0)
    return LightInfo(*(leaf[i] for leaf in lights))


class LightSample(NamedTuple):
    """PolymorphicLightSample / RAB_LightSample (PolymorphicLight.glsl:49-55)."""

    position: jax.Array  # [..., 3]
    normal: jax.Array  # [..., 3]
    radiance: jax.Array  # [..., 3]
    solid_angle_pdf: jax.Array  # [...]
    light_type: jax.Array  # [...] uint32


def get_light_type(color_type_and_flags: jax.Array) -> jax.Array:
    """(PolymorphicLight.glsl:57-63)."""
    return (color_type_and_flags >> K_TYPE_SHIFT) & jnp.uint32(K_TYPE_MASK)


def unpack_light_radiance(log_radiance: jax.Array) -> jax.Array:
    """(PolymorphicLight.glsl:65-68)."""
    lr = (log_radiance & jnp.uint32(0xFFFF)).astype(jnp.float32)
    val = jnp.exp2((lr - 1.0) / 65534.0
                   * (K_MAX_LOG2_RADIANCE - K_MIN_LOG2_RADIANCE)
                   + K_MIN_LOG2_RADIANCE)
    return jnp.where(log_radiance == 0, 0.0, val)


def unpack_light_color(info: LightInfo) -> jax.Array:
    """(PolymorphicLight.glsl:70-75)."""
    color = pk.unpack_rgb8_ufloat(info.color_type_and_flags)
    radiance = unpack_light_radiance(info.log_radiance & jnp.uint32(0xFFFF))
    return color * radiance[..., None]


def pack_light_color(radiance: jax.Array
                     ) -> tuple[jax.Array, jax.Array]:
    """(PolymorphicLight.glsl:77-93). Returns (color_bits, log_radiance)
    to OR into the record."""
    intensity = jnp.max(radiance, axis=-1)
    log_r = brdf.saturate(
        (jnp.log2(jnp.maximum(intensity, 1e-30)) - K_MIN_LOG2_RADIANCE)
        / (K_MAX_LOG2_RADIANCE - K_MIN_LOG2_RADIANCE))
    packed_radiance = jnp.minimum(
        jnp.ceil(log_r * 65534.0).astype(jnp.uint32) + 1, jnp.uint32(0xFFFF))
    unpacked = unpack_light_radiance(packed_radiance)
    normalized = brdf.saturate(radiance / jnp.maximum(unpacked, 1e-30)[..., None])
    color_bits = pk.pack_rgb8_ufloat(normalized)
    zero = intensity <= 0.0
    return (jnp.where(zero, jnp.uint32(0), color_bits),
            jnp.where(zero, jnp.uint32(0), packed_radiance))


# ---------------------------------------------------------------------------
# Triangle lights
# ---------------------------------------------------------------------------

def store_triangle_lights(base: jax.Array, edge1: jax.Array, edge2: jax.Array,
                          radiance: jax.Array) -> LightInfo:
    """Vectorized StoreTriangleLight (PolymorphicLight.glsl:345-357):
    center = barycenter, edges as oct dirs + f16 lengths."""
    color_bits, log_radiance = pack_light_color(radiance)
    len1 = jnp.linalg.norm(edge1, axis=-1)
    len2 = jnp.linalg.norm(edge2, axis=-1)
    d1 = pk.ndir_to_oct_unorm32(edge1 / jnp.maximum(len1, 1e-20)[..., None])
    d2 = pk.ndir_to_oct_unorm32(edge2 / jnp.maximum(len2, 1e-20)[..., None])
    scalars = pk.f32_to_f16_bits(len1) | (pk.f32_to_f16_bits(len2) << 16)
    type_bits = jnp.uint32(K_TRIANGLE << K_TYPE_SHIFT)
    return LightInfo(
        center=base + (edge1 + edge2) / 3.0,
        color_type_and_flags=color_bits | type_bits,
        direction1=d1, direction2=d2, scalars=scalars,
        log_radiance=log_radiance, **_zero_shaping(base.shape[0]))


class _Tri(NamedTuple):
    base: jax.Array
    edge1: jax.Array
    edge2: jax.Array
    radiance: jax.Array
    normal: jax.Array
    surface_area: jax.Array


def _create_triangle(info: LightInfo) -> _Tri:
    """(PolymorphicLight.glsl:320-343)."""
    len1 = pk.f16_bits_to_f32(info.scalars)
    len2 = pk.f16_bits_to_f32(info.scalars >> 16)
    edge1 = pk.oct_unorm32_to_ndir(info.direction1) * len1[..., None]
    edge2 = pk.oct_unorm32_to_ndir(info.direction2) * len2[..., None]
    base = info.center - (edge1 + edge2) / 3.0
    radiance = unpack_light_color(info)
    n = jnp.cross(edge1, edge2)
    nlen = jnp.linalg.norm(n, axis=-1)
    ok = nlen > 0.0
    normal = jnp.where(ok[..., None], n / jnp.maximum(nlen, 1e-30)[..., None], 0.0)
    area = jnp.where(ok, 0.5 * nlen, 0.0)
    return _Tri(base, edge1, edge2, radiance, normal, area)


def triangle_solid_angle_pdf(viewer_pos, sample_pos, sample_normal, area):
    """(PolymorphicLight.glsl:266-279)."""
    l = sample_pos - viewer_pos
    dist = jnp.linalg.norm(l, axis=-1)
    l = l / jnp.maximum(dist, 1e-20)[..., None]
    area_pdf = 1.0 / jnp.maximum(area, 1e-20)
    cos_theta = jnp.clip(-brdf.dot3(l, sample_normal), 0.0, 1.0)
    return brdf.pdf_area_to_solid_angle(
        area_pdf, dist, jnp.maximum(cos_theta, 1e-20))


def _calc_triangle_sample(info: LightInfo, random, viewer_pos) -> LightSample:
    """(PolymorphicLight.glsl:281-294)."""
    tri = _create_triangle(info)
    bary = brdf.sample_triangle(random)
    pos = (tri.base + tri.edge1 * bary[..., 1:2] + tri.edge2 * bary[..., 2:3])
    pdf = triangle_solid_angle_pdf(viewer_pos, pos, tri.normal,
                                   tri.surface_area)
    return LightSample(
        position=pos, normal=tri.normal, radiance=tri.radiance,
        solid_angle_pdf=pdf,
        light_type=jnp.full(pdf.shape, K_TRIANGLE, jnp.uint32))


def triangle_light_power(info: LightInfo) -> jax.Array:
    """(PolymorphicLight.glsl:297-300)."""
    tri = _create_triangle(info)
    return tri.surface_area * brdf.PI * brdf.luminance(tri.radiance)


# ---------------------------------------------------------------------------
# Point lights
# ---------------------------------------------------------------------------

def store_point_lights(position: jax.Array, flux: jax.Array,
                       cone_axis: jax.Array | None = None,
                       cos_cone_angle: jax.Array | None = None,
                       cone_softness: jax.Array | None = None) -> LightInfo:
    """Point-light records (CreatePointLight inverse; PolymorphicLight.glsl:
    186-195: center + packed flux). Optional spot shaping packs the cone
    into the shaping words and sets the enable bit (LightShaping.glsl:
    16-25); the reference never creates shaped lights, so this is a
    capability extension with identical defaults."""
    from raytracer2.lights.shaping import K_SHAPING_ENABLE_BIT

    color_bits, log_radiance = pack_light_color(flux)
    n = position.shape[0]
    type_bits = jnp.uint32(K_POINT << K_TYPE_SHIFT)
    shaping = _zero_shaping(n)
    if cone_axis is not None:
        type_bits = type_bits | jnp.uint32(K_SHAPING_ENABLE_BIT)
        soft = (cone_softness if cone_softness is not None
                else jnp.zeros((n,), jnp.float32))
        shaping = dict(
            shaping_axis=pk.ndir_to_oct_unorm32(cone_axis),
            shaping_cone=(pk.f32_to_f16_bits(cos_cone_angle)
                          | (pk.f32_to_f16_bits(soft) << 16)),
            shaping_ies=jnp.zeros((n,), jnp.uint32))
    return LightInfo(
        center=position,
        color_type_and_flags=color_bits | type_bits,
        direction1=jnp.zeros((n,), jnp.uint32),
        direction2=jnp.zeros((n,), jnp.uint32),
        scalars=jnp.zeros((n,), jnp.uint32),
        log_radiance=log_radiance, **shaping)


def _calc_point_sample(info: LightInfo, viewer_pos) -> LightSample:
    """(PolymorphicLight.glsl:154-168)."""
    flux = unpack_light_color(info)
    lv = info.center - viewer_pos
    d2 = jnp.maximum(brdf.dot3(lv, lv), 1e-20)
    return LightSample(
        position=info.center,
        normal=brdf.normalize(-lv),
        radiance=flux / d2[..., None],
        solid_angle_pdf=jnp.ones(d2.shape, jnp.float32),
        light_type=jnp.full(d2.shape, K_POINT, jnp.uint32))


def point_light_power(info: LightInfo) -> jax.Array:
    """(PolymorphicLight.glsl:170-172) incl. the shaping flux factor."""
    from raytracer2.lights.shaping import get_shaping_flux_factor

    return (4.0 * brdf.PI * brdf.luminance(unpack_light_color(info))
            * get_shaping_flux_factor(get_shaping(info)))


# ---------------------------------------------------------------------------
# Directional lights
# ---------------------------------------------------------------------------

def store_directional_lights(direction: jax.Array, radiance: jax.Array,
                             half_angle: jax.Array) -> LightInfo:
    """Directional records (CreateDirectionalLight inverse,
    PolymorphicLight.glsl:240-252)."""
    color_bits, log_radiance = pack_light_color(radiance)
    solid_angle = 2.0 * brdf.PI * (1.0 - jnp.cos(half_angle))
    scalars = (pk.f32_to_f16_bits(half_angle)
               | (pk.f32_to_f16_bits(solid_angle) << 16))
    n = direction.shape[0]
    type_bits = jnp.uint32(K_DIRECTIONAL << K_TYPE_SHIFT)
    return LightInfo(
        center=jnp.zeros((n, 3), jnp.float32),
        color_type_and_flags=color_bits | type_bits,
        direction1=pk.ndir_to_oct_unorm32(direction),
        direction2=jnp.zeros((n,), jnp.uint32),
        scalars=scalars, log_radiance=log_radiance, **_zero_shaping(n))


def _calc_directional_sample(info: LightInfo, random, viewer_pos) -> LightSample:
    """(PolymorphicLight.glsl:208-236)."""
    direction = pk.oct_unorm32_to_ndir(info.direction1)
    half_angle = pk.f16_bits_to_f32(info.scalars)
    solid_angle = pk.f16_bits_to_f32(info.scalars >> 16)
    sin_half = jnp.sin(half_angle)
    radiance = unpack_light_color(info)

    disk = brdf.sample_disk(random)
    tangent, bitangent = brdf.construct_onb(direction)
    sample_dir = (direction + tangent * (disk[..., 0] * sin_half)[..., None]
                  + bitangent * (disk[..., 1] * sin_half)[..., None])
    pos = viewer_pos - sample_dir * DISTANT_LIGHT_DISTANCE
    pdf = 1.0 / jnp.maximum(solid_angle, 1e-20)
    return LightSample(
        position=pos, normal=direction, radiance=radiance,
        solid_angle_pdf=pdf,
        light_type=jnp.full(pdf.shape, K_DIRECTIONAL, jnp.uint32))


# ---------------------------------------------------------------------------
# Environment light
# ---------------------------------------------------------------------------

def store_environment_light(texture_size: tuple[int, int],
                            importance_sampled: bool = True,
                            radiance_scale=(1.0, 1.0, 1.0),
                            rotation: float = 0.0) -> LightInfo:
    """Environment record (CreateEnvironmentLight inverse,
    PolymorphicLight.glsl:414-426). textureIndex is stored as direction1 = 0
    (our skybox is a dedicated array, index unused)."""
    color_bits, log_radiance = pack_light_color(
        jnp.asarray([radiance_scale], jnp.float32))
    scalars = (pk.f32_to_f16_bits(jnp.asarray([rotation], jnp.float32))
               | (jnp.uint32(1 if importance_sampled else 0) << 16))
    type_bits = jnp.uint32(K_ENVIRONMENT << K_TYPE_SHIFT)
    return LightInfo(
        center=jnp.zeros((1, 3), jnp.float32),
        color_type_and_flags=color_bits | type_bits,
        direction1=jnp.zeros((1,), jnp.uint32),
        direction2=jnp.asarray(
            [texture_size[0] | (texture_size[1] << 16)], jnp.uint32),
        scalars=scalars, log_radiance=log_radiance, **_zero_shaping(1))


def _calc_environment_sample(info: LightInfo, random, viewer_pos,
                             skybox: jax.Array | None) -> LightSample:
    """(PolymorphicLight.glsl:368-410)."""
    rotation = pk.f16_bits_to_f32(info.scalars)
    importance = (info.scalars >> 16) != 0
    radiance_scale = unpack_light_color(info)
    tw = (info.direction2 & jnp.uint32(0xFFFF)).astype(jnp.float32)
    th = (info.direction2 >> 16).astype(jnp.float32)

    # importance-sampled branch: uv IS the pdf-texture coordinate
    uv_is = jnp.stack([random[..., 0] + rotation, random[..., 1]], axis=-1)
    dir_is, cos_el = brdf.equirect_uv_to_direction(uv_is)
    pdf_is = (tw * th) / (2.0 * brdf.PI * brdf.PI
                          * jnp.maximum(cos_el, 1e-6))
    tex_uv_is = random

    # uniform-sphere branch
    dir_us, pdf_us = brdf.sample_sphere(random)
    tex_uv_us = brdf.direction_to_equirect_uv(dir_us)
    tex_uv_us = tex_uv_us.at[..., 0].add(-rotation)

    sample_dir = jnp.where(importance[..., None], dir_is, dir_us)
    pdf = jnp.where(importance, pdf_is, pdf_us)
    tex_uv = jnp.where(importance[..., None], tex_uv_is, tex_uv_us)

    if skybox is not None:
        from raytracer2.scene.scene import sample_equirect

        radiance = radiance_scale * sample_equirect(skybox, tex_uv)
    else:
        # no environment map bound (GConst.environment == 0): the light
        # samples black, matching get_environment_radiance's zero — the
        # reference always binds a skybox texture so this case never
        # arises there; returning radiance_scale here injected phantom
        # energy through the BRDF candidate stream's miss fall-through
        # (measured +47% direct lighting on an env-less Cornell box)
        radiance = jnp.zeros_like(radiance_scale)
    bad = ~jnp.isfinite(jnp.sum(radiance, axis=-1))
    radiance = jnp.where(bad[..., None], 0.0, radiance)

    return LightSample(
        position=viewer_pos + sample_dir * DISTANT_LIGHT_DISTANCE,
        normal=-sample_dir, radiance=radiance, solid_angle_pdf=pdf,
        light_type=jnp.full(pdf.shape, K_ENVIRONMENT, jnp.uint32))


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def calc_sample(info: LightInfo, random: jax.Array, viewer_pos: jax.Array,
                skybox: jax.Array | None = None) -> LightSample:
    """Polymorphic dispatch (PolymorphicLight.glsl:429-452): every type is
    evaluated and masked-selected — cheap and branch-free.
    Shaping is applied to the selected sample when pdf > 0
    (PolymorphicLight.glsl:444-448); unshaped lights get factor 1.0."""
    ltype = get_light_type(info.color_type_and_flags)

    s_point = _calc_point_sample(info, viewer_pos)
    s_tri = _calc_triangle_sample(info, random, viewer_pos)
    s_dir = _calc_directional_sample(info, random, viewer_pos)
    s_env = _calc_environment_sample(info, random, viewer_pos, skybox)

    def sel(field):
        a = getattr(s_point, field)
        b = getattr(s_tri, field)
        c = getattr(s_dir, field)
        d = getattr(s_env, field)
        t = ltype[..., None] if a.ndim > ltype.ndim else ltype
        out = jnp.where(t == K_TRIANGLE, b, a)
        out = jnp.where(t == K_DIRECTIONAL, c, out)
        out = jnp.where(t == K_ENVIRONMENT, d, out)
        # unknown types -> zero pdf (GLSL switch leaves the sample empty)
        known = ((t == K_POINT) | (t == K_TRIANGLE)
                 | (t == K_DIRECTIONAL) | (t == K_ENVIRONMENT))
        return jnp.where(known, out, jnp.zeros_like(out))

    pdf = sel("solid_angle_pdf")
    pos = sel("position")
    radiance = sel("radiance")
    # shaping falloff (PolymorphicLight.glsl:444-448); branchless — for
    # unshaped lights evaluate_light_shaping is identically 1.0
    from raytracer2.lights.shaping import evaluate_light_shaping

    factor = evaluate_light_shaping(get_shaping(info), viewer_pos, pos)
    radiance = radiance * jnp.where(pdf > 0, factor, 1.0)[..., None]
    return LightSample(
        position=pos, normal=sel("normal"),
        radiance=radiance, solid_angle_pdf=pdf,
        light_type=ltype)


def get_power(info: LightInfo) -> jax.Array:
    """(PolymorphicLight.glsl:454-471): only point + triangle contribute to
    the local-light PDF map."""
    ltype = get_light_type(info.color_type_and_flags)
    p = jnp.where(ltype == K_POINT, point_light_power(info), 0.0)
    return jnp.where(ltype == K_TRIANGLE, triangle_light_power(info), p)
