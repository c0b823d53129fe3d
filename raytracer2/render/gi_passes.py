"""The ReSTIR GI pass chain: BRDF rays -> secondary shading -> temporal ->
spatial -> final shading.

Whole-image ports of the four GI raygen shaders (SURVEY.md §3.4):
- brdf_rays.rgen:19-194  (bounce-ray wavefront -> packed SecondaryGBuffer)
- shade_secondary_surfaces.rgen:26-157  (1-sample ReSTIR DI on the bounce hit
  -> initial GI reservoir)
- temporal_resampling.rgen:13-48 / spatial_resampling.rgen:13-39 (wrappers
  around the restir library)
- gi_final_shading.rgen:43-101  (final visibility + split BRDF + MIS)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytracer2.lights.polymorphic import DISTANT_LIGHT_DISTANCE
from raytracer2.params import (
    BACKGROUND_DEPTH, GConst, K_SECONDARY_IS_DELTA_SURFACE,
    K_SECONDARY_IS_ENVIRONMENT_MAP, K_SECONDARY_IS_SPECULAR_RAY)
from raytracer2.render import rays as raysmod
from raytracer2.render.app_bridge import Tracers
from raytracer2.render.shading import (
    shade_surface_with_light_sample, store_shading_output)
from raytracer2.render.surface import (
    Surface, get_surface_brdf_sample, get_surface_diffuse_probability)
from raytracer2.restir import gi_resampling
from raytracer2.restir.bridge import Bridge
from raytracer2.restir.gi_reservoir import (
    GIReservoir, empty_gi_reservoir, is_valid as gi_is_valid, make_gi_reservoir,
    where_gi)
from raytracer2.restir.initial_sampling import (
    LightSamplingContext, init_sample_parameters, sample_lights_for_surface)
from raytracer2.scene.scene import (
    Scene, get_environment_radiance, get_geometry_from_hit)
from raytracer2.utils import brdf as brdfm
from raytracer2.utils import packing as pk
from raytracer2.utils import rng as rtrng

K_MAX_INDIRECT_RADIANCE = 100.0  # c_MaxIndirectRadiance (shade_secondary:24)
K_MIS_ROUGHNESS = 0.3  # (gi_final_shading.rgen:16)
K_MAX_BRDF_VALUE = 1e4  # (gi_final_shading.rgen:15)

# launches above this lane count run shade_secondary in row bands under
# lax.map, which bounds the pass's peak device memory at 4K (tests shrink
# it to cover the banded path at CPU sizes)
_BAND_THRESHOLD = 1 << 22


class SecondaryGBuffer(NamedTuple):
    """SecondaryGBufferData SoA, packed-field parity
    (ShaderParameters.glsl:49-60). [H, W] planes."""

    world_pos: jax.Array  # [H, W, 3] f32
    normal: jax.Array  # [H, W] u32 oct
    throughput: jax.Array  # [H, W, 2] u32 (f16 rg / b + flags<<16)
    diffuse_albedo: jax.Array  # [H, W] u32 R11G11B10
    specular_and_roughness: jax.Array  # [H, W] u32 RGBA8-gamma
    emission: jax.Array  # [H, W, 3] f32
    pdf: jax.Array  # [H, W] f32


def empty_secondary_gbuffer(height: int, width: int) -> SecondaryGBuffer:
    return SecondaryGBuffer(
        world_pos=jnp.zeros((height, width, 3), jnp.float32),
        normal=jnp.zeros((height, width), jnp.uint32),
        throughput=jnp.zeros((height, width, 2), jnp.uint32),
        diffuse_albedo=jnp.zeros((height, width), jnp.uint32),
        specular_and_roughness=jnp.zeros((height, width), jnp.uint32),
        emission=jnp.zeros((height, width, 3), jnp.float32),
        pdf=jnp.zeros((height, width), jnp.float32),
    )


def brdf_rays_pass(
    scene: Scene,
    g_const: GConst,
    tracers: Tracers,
    bridge: Bridge,
    diffuse_img: jax.Array,
    specular_img: jax.Array,
    width: int,
    height: int,
    row0=0,
    field: int = 0,
    primary_surface=None,
) -> tuple[SecondaryGBuffer, jax.Array, jax.Array]:
    """brdf_rays.rgen:19-194. Returns (secondary gbuffer, diffuse,
    specular). Under checkerboard (field != 0) the launch grid is the
    active half-field (brdf_rays.rgen:21) and every returned image is
    [H, W//2]. primary_surface: the gather-free launch-grid surface
    (gbuffer.surface_from_gbuffer_grid), computed once per frame.

    4K-class launches (> _BAND_THRESHOLD lanes) run the body in row
    bands under lax.map (the per-lane lobe-sampling and
    SecondaryGBuffer pack temps are 4K-peak contributors; the pass is
    per-pixel independent and RNG is pixel-seeded, so banding is
    bit-exact up to the band-local bounce-ray sort, which the exact cull
    makes hit-identical)."""
    px, py = raysmod.active_pixel_grid(width, height, field)
    py = py + row0
    w_res = width // 2 if field else width

    if (height * w_res > _BAND_THRESHOLD and primary_surface is not None
            and isinstance(row0, int)):
        # band height: ~half the threshold's lane count per band (so a
        # monkeypatched threshold in tests forces real multi-band runs)
        hb = max(1, min(1 << 21, _BAND_THRESHOLD // 2) // max(w_res, 1))
        nb = (height + hb - 1) // hb
        pad = nb * hb - height

        def band(tree):
            return jax.tree_util.tree_map(
                lambda a: jnp.concatenate(
                    [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)]
                ).reshape((nb, hb) + a.shape[1:]) if pad else
                a.reshape((nb, hb) + a.shape[1:]), tree)

        args = (band(px), band(py), band(primary_surface),
                band(diffuse_img), band(specular_img))

        def one(a):
            px_b, py_b, prim_b, dif_b, spec_b = a
            flat = jax.tree_util.tree_map(
                lambda x: x.reshape((hb * w_res,) + x.shape[2:]), prim_b)
            return _brdf_rays_body(
                scene, g_const, tracers, bridge, px_b.reshape(-1),
                py_b.reshape(-1), flat, dif_b, spec_b, hb, w_res)

        out = jax.lax.map(one, args)
        return jax.tree_util.tree_map(
            lambda a: a.reshape((nb * hb,) + a.shape[2:])[:height], out)

    pxf = px.reshape(-1)
    pyf = py.reshape(-1)
    n = pxf.shape[0]
    if primary_surface is not None:
        surface = jax.tree_util.tree_map(
            lambda a: a.reshape((n,) + a.shape[2:]), primary_surface)
    else:
        surface = bridge.get_gbuffer_surface(pxf, pyf, False)
    return _brdf_rays_body(scene, g_const, tracers, bridge, pxf, pyf,
                           surface, diffuse_img, specular_img,
                           height, w_res)


def _brdf_rays_body(scene, g_const, tracers, bridge, pxf, pyf, surface,
                    diffuse_img, specular_img, height, w_res):
    n = pxf.shape[0]
    valid = surface.valid

    # RAB_InitRandomSampler(launchID, 5) (brdf_rays.rgen:28)
    rng = rtrng.init_random_sampler(
        pxf.astype(jnp.uint32), pyf.astype(jnp.uint32),
        g_const.frame + jnp.uint32(5 * 13))

    tangent, bitangent = brdfm.construct_onb(surface.normal)
    cam = g_const.view.camera_direction_or_position[:3]
    depth_scale = jnp.maximum(
        1.0, 0.1 * jnp.linalg.norm(surface.world_pos - cam, axis=-1))
    t_min = 0.001 * depth_scale

    # only valid lanes consume RNG (the shader early-returns, :25-26)
    rand2, adv = rtrng.sample_uniform_n(rng, 2)
    rng = rtrng.RngState(seed=rng.seed,
                         index=jnp.where(valid, adv.index, rng.index))

    v = brdfm.normalize(cam - surface.world_pos)
    is_delta = surface.roughness == 0.0

    # specular lobe (brdf_rays.rgen:51-65): note tangent-frame order here is
    # (tangent, bitangent, normal) unlike the bridge helpers
    ve = jnp.stack([brdfm.dot3(v, tangent), brdfm.dot3(v, bitangent),
                    brdfm.dot3(v, surface.normal)], axis=-1)
    he = brdfm.importance_sample_ggx_vndf(rand2, surface.roughness, ve)
    h_vec = brdfm.normalize(
        he[..., 0:1] * tangent + he[..., 1:2] * bitangent
        + he[..., 2:3] * surface.normal)
    h_vec = jnp.where(is_delta[..., None], surface.normal, h_vec)
    specular_dir = brdfm.reflect(-v, h_vec)
    hov = brdfm.saturate(brdfm.dot3(h_vec, v))
    nov = brdfm.saturate(brdfm.dot3(surface.normal, v))
    f = brdfm.schlick_fresnel(surface.specular_f0, hov)
    g1 = jnp.where(is_delta, 1.0,
                   jnp.where(nov > 0.0,
                             brdfm.g1_smith(surface.roughness, nov), 0.0))
    specular_brdf_over_pdf = f * g1[..., None]

    # diffuse lobe (:67-74)
    local_dir, _ = brdfm.sample_cos_hemisphere(rand2)
    diffuse_dir = (tangent * local_dir[..., 0:1]
                   + bitangent * local_dir[..., 1:2]
                   + surface.normal * local_dir[..., 2:3])

    spec_pdf = brdfm.saturate(
        brdfm.luminance(specular_brdf_over_pdf)
        / jnp.maximum(brdfm.luminance(
            specular_brdf_over_pdf + surface.diffuse_albedo), 1e-30))

    r_spec, adv = rtrng.sample_uniform(rng)
    rng = rtrng.RngState(seed=rng.seed,
                         index=jnp.where(valid, adv.index, rng.index))
    is_specular_ray = r_spec < spec_pdf

    direction = jnp.where(is_specular_ray[..., None], specular_dir,
                          diffuse_dir)
    brdf_over_pdf = jnp.where(
        is_specular_ray[..., None],
        specular_brdf_over_pdf / jnp.maximum(spec_pdf, 1e-30)[..., None],
        (1.0 / jnp.maximum(1.0 - spec_pdf, 1e-30))[..., None])

    specular_lobe_pdf = brdfm.importance_sample_ggx_vndf_pdf(
        surface.roughness, surface.normal, v, direction)
    diffuse_lobe_pdf = brdfm.saturate(
        brdfm.dot3(direction, surface.normal)) / brdfm.PI
    overall_pdf = jnp.where(
        is_delta, diffuse_lobe_pdf,
        diffuse_lobe_pdf + (specular_lobe_pdf - diffuse_lobe_pdf) * spec_pdf)

    # geo-normal backface kill (:99-103)
    backface = brdfm.dot3(surface.geo_normal, direction) <= 0.0
    brdf_over_pdf = jnp.where(backface[..., None], 0.0, brdf_over_pdf)
    t_max = jnp.where(backface | ~valid, 0.0,
                      jnp.full((n,), BACKGROUND_DEPTH))

    hit = tracers.closest_hit(surface.world_pos, direction, t_min, t_max)
    missed = hit.missed

    geom = get_geometry_from_hit(
        scene, hit.geometry_index.astype(jnp.int32),
        hit.primitive_id.astype(jnp.int32),
        jnp.stack([hit.u, hit.v], axis=-1),
        textures_enabled=bool(g_const.textures),
        triangle_index=hit.triangle_index)

    # (brdf_rays.rgen:121-124)
    include_emissive = jnp.logical_or(g_const.enable_restir_di == 0,
                                      is_specular_ray & is_delta)

    hit_pos = surface.world_pos + direction * hit.t[..., None]
    env_radiance = get_environment_radiance(scene, direction,
                                            g_const.environment)
    radiance = jnp.where(
        include_emissive[..., None],
        jnp.where(missed[..., None], env_radiance, geom.emission), 0.0)

    sec_normal = jnp.where(
        (brdfm.dot3(geom.normal, direction) < 0.0)[..., None],
        geom.normal, -geom.normal)
    sec_pos = jnp.where(missed[..., None],
                        surface.world_pos + direction * DISTANT_LIGHT_DISTANCE,
                        hit_pos)
    sec_normal = jnp.where(missed[..., None], -direction, sec_normal)
    sec_albedo = jnp.where(missed[..., None], 0.0, geom.diffuse_albedo)
    sec_f0 = jnp.where(missed[..., None], 0.0, geom.specular_f0)
    sec_rough = jnp.where(missed, 0.0, geom.roughness)

    flags = (jnp.where(is_specular_ray, K_SECONDARY_IS_SPECULAR_RAY, 0)
             | jnp.where(is_delta, K_SECONDARY_IS_DELTA_SURFACE, 0)
             | jnp.where(missed, K_SECONDARY_IS_ENVIRONMENT_MAP, 0)
             ).astype(jnp.uint32)

    if g_const.enable_restir_gi:
        stored_emission = radiance
        radiance = jnp.zeros_like(radiance)
    else:
        stored_emission = radiance

    # pack (brdf_rays.rgen:158-183); invalid lanes keep zeros
    tp = pk.pack_r16g16b16a16_float(
        jnp.concatenate([brdf_over_pdf, jnp.zeros((n, 1))], axis=-1))
    tp = tp.at[..., 1].set(tp[..., 1] | (flags << 16))

    def img(x, extra_dims=0):
        shape = (height, w_res) + ((x.shape[-1],) if extra_dims else ())
        mask = valid if not extra_dims else valid[..., None]
        return jnp.where(mask, x, jnp.zeros_like(x)).reshape(shape)

    secondary = SecondaryGBuffer(
        world_pos=img(sec_pos, 1),
        normal=img(pk.ndir_to_oct_unorm32(sec_normal)),
        throughput=jnp.where(valid[..., None], tp,
                             jnp.zeros_like(tp)).reshape(height, w_res, 2),
        diffuse_albedo=img(pk.pack_r11g11b10_ufloat(sec_albedo)),
        specular_and_roughness=img(pk.pack_rgba8_gamma_ufloat(
            jnp.concatenate([sec_f0, sec_rough[..., None]], axis=-1))),
        emission=img(stored_emission, 1),
        pdf=img(overall_pdf),
    )
    if not g_const.enable_brdf_indirect:
        secondary = empty_secondary_gbuffer(height, w_res)

    # immediate output for emissive/env radiance (:186-194)
    out_d = jnp.where(is_specular_ray[..., None], 0.0,
                      radiance * brdf_over_pdf)
    out_s = jnp.where(is_specular_ray[..., None],
                      radiance * brdf_over_pdf, 0.0)
    out_s = brdfm.demodulate_specular(surface.specular_f0, out_s)
    write = valid & (jnp.any(radiance > 0.0, axis=-1)
                     | (g_const.enable_brdf_additive_blend == 0))
    diffuse_img, specular_img = store_shading_output(
        diffuse_img, specular_img,
        out_d.reshape(height, w_res, 3), out_s.reshape(height, w_res, 3),
        is_first_pass=False,
        enable_accumulation=g_const.enable_accumulation,
        blend_factor=g_const.blend_factor,
        correct_specular_accumulation=bool(
            g_const.correct_specular_accumulation),
        write_mask=write.reshape(height, w_res))
    return secondary, diffuse_img, specular_img


def _unpack_secondary_surface(secondary: SecondaryGBuffer, primary: Surface
                              ) -> tuple[Surface, jax.Array, jax.Array]:
    """shade_secondary_surfaces.rgen:39-61. Returns
    (surface, throughput, flags)."""
    h, w = secondary.normal.shape
    tp4 = pk.unpack_r16g16b16a16_float(secondary.throughput)
    throughput = tp4[..., :3]
    flags = secondary.throughput[..., 1] >> 16

    normal = pk.oct_unorm32_to_ndir(secondary.normal)
    albedo = pk.unpack_r11g11b10_ufloat(secondary.diffuse_albedo)
    sr = pk.unpack_rgba8_gamma_ufloat(secondary.specular_and_roughness)
    view_dir = brdfm.normalize(primary.world_pos - secondary.world_pos)
    surface = Surface(
        world_pos=secondary.world_pos,
        view_dir=view_dir,
        view_depth=jnp.ones((h, w), jnp.float32),  # 'doesn't matter' (:53)
        normal=normal,
        geo_normal=normal,
        diffuse_albedo=albedo,
        specular_f0=sr[..., :3],
        roughness=sr[..., 3],
        diffuse_probability=get_surface_diffuse_probability(
            albedo, sr[..., :3], view_dir, normal))
    return surface, throughput, flags


def shade_secondary_surfaces_pass(
    scene: Scene,
    g_const: GConst,
    tracers: Tracers,
    bridge: Bridge,
    light_ctx: LightSamplingContext,
    secondary: SecondaryGBuffer,
    diffuse_img: jax.Array,
    specular_img: jax.Array,
    width: int,
    height: int,
    row0=0,
    field: int = 0,
    primary_surface=None,
) -> tuple[GIReservoir, SecondaryGBuffer, jax.Array, jax.Array]:
    """shade_secondary_surfaces.rgen:26-157. Returns (initial GI
    reservoirs, updated secondary gbuffer, diffuse, specular) at launch
    resolution ([H, W//2] under checkerboard, shade_secondary_
    surfaces.rgen:30 via RTXDI_ReservoirPosToPixelPos).

    4K-class launches (> 4M lanes) run the body in row bands under
    lax.map: the pass is per-pixel independent and its sampling/shading
    temps are among the biggest contributors to the whole-image frame's
    peak device memory. Banding is bit-exact: every RNG stream is seeded
    by pixel coordinates."""
    px, py = raysmod.active_pixel_grid(width, height, field)
    py = py + row0
    w_res = width // 2 if field else width

    n_lanes = height * w_res
    if n_lanes > _BAND_THRESHOLD and primary_surface is not None \
            and isinstance(row0, int):
        # band height: ~half the threshold's lane count per band (so a
        # monkeypatched threshold in tests forces real multi-band runs)
        hb = max(1, min(1 << 21, _BAND_THRESHOLD // 2) // max(w_res, 1))
        nb = (height + hb - 1) // hb
        pad = nb * hb - height

        def band(tree):
            return jax.tree_util.tree_map(
                lambda a: jnp.concatenate(
                    [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)]
                ).reshape((nb, hb) + a.shape[1:]) if pad else
                a.reshape((nb, hb) + a.shape[1:]), tree)

        args = (band(px), band(py), band(primary_surface),
                band(secondary), band(diffuse_img), band(specular_img))

        def one(a):
            px_b, py_b, prim_b, sec_b, dif_b, spec_b = a
            return _shade_secondary_body(
                scene, g_const, tracers, bridge, light_ctx,
                px_b, py_b, prim_b, sec_b, dif_b, spec_b, hb, w_res)

        out = jax.lax.map(one, args)
        return jax.tree_util.tree_map(
            lambda a: a.reshape((nb * hb,) + a.shape[2:])[:height], out)

    return _shade_secondary_body(
        scene, g_const, tracers, bridge, light_ctx, px, py,
        primary_surface, secondary, diffuse_img, specular_img,
        height, w_res)


def _shade_secondary_body(scene, g_const, tracers, bridge, light_ctx,
                          px, py, primary_surface, secondary,
                          diffuse_img, specular_img, height, w_res):
    rng = rtrng.init_random_sampler(
        px.astype(jnp.uint32).reshape(height, w_res),
        py.astype(jnp.uint32).reshape(height, w_res),
        g_const.frame + jnp.uint32(6 * 13))
    tile_rng = rtrng.init_random_sampler(
        (px // 16).astype(jnp.uint32), (py // 16).astype(jnp.uint32),
        g_const.frame + jnp.uint32(13))

    primary = (primary_surface if primary_surface is not None
               else bridge.get_gbuffer_surface(px, py, False))
    sec_surface, throughput, flags = _unpack_secondary_surface(
        secondary, primary)

    is_valid_secondary = jnp.any(throughput != 0.0, axis=-1)
    is_specular_ray = (flags & K_SECONDARY_IS_SPECULAR_RAY) != 0
    is_delta = (flags & K_SECONDARY_IS_DELTA_SURFACE) != 0
    is_env = (flags & K_SECONDARY_IS_ENVIRONMENT_MAP) != 0

    radiance = secondary.emission

    if g_const.enable_restir_di:
        # 1-sample BRDF ReSTIR DI on the secondary surface (:64-117)
        sample_params = init_sample_parameters(0, 0, 0, 1, 0.0, 0.001)
        reservoir, light_sample, rng, tile_rng = sample_lights_for_surface(
            rng, tile_rng, sec_surface, sample_params, light_ctx, bridge)
        # the ONLY candidate here is the BRDF sample (matching
        # shade_secondary_surfaces.rgen:67-76), and its visibility is
        # established by the candidate ray itself: the closest hit either
        # WAS the identified light or escaped to the environment, so the
        # sample position is reachable by construction. The reference
        # re-traces the identical ray inside ShadeSurfaceWithLightSample
        # (:109); the result is 'visible' for every lane that holds a
        # valid sample — skip the full-screen shadow trace. (Lanes whose
        # candidate ray found no light have solid_angle_pdf == 0 and shade
        # to zero regardless of the visibility value.)
        reservoir, ind_diffuse, ind_specular, _ = \
            shade_surface_with_light_sample(
                reservoir, sec_surface, light_sample,
                g_const.restir_di.shading_params,
                g_const.restir_di.temporal_resampling_params,
                bridge, enable_visibility_reuse=False,
                known_visibility=jnp.ones(sec_surface.view_depth.shape,
                                          bool))
        shade_ok = is_valid_secondary & ~is_env
        radiance = radiance + jnp.where(
            shade_ok[..., None],
            ind_diffuse * sec_surface.diffuse_albedo + ind_specular, 0.0)
        # firefly clamp (:113-116)
        lum = brdfm.luminance(radiance)
        scale = jnp.where(lum > K_MAX_INDIRECT_RADIANCE,
                          K_MAX_INDIRECT_RADIANCE / jnp.maximum(lum, 1e-30),
                          1.0)
        radiance = radiance * jnp.where(shade_ok, scale, 1.0)[..., None]
    else:
        # fallback single bounce (:119-128)
        new_dir, _, adv = get_surface_brdf_sample(sec_surface, rng)
        take = is_valid_secondary & ~is_env
        rng = rtrng.RngState(seed=rng.seed,
                             index=jnp.where(take, adv.index, rng.index))
        o = sec_surface.world_pos.reshape(-1, 3)
        d = new_dir.reshape(-1, 3)
        hit = tracers.closest_hit(o, d, jnp.float32(0.001),
                                  jnp.float32(1000.0))
        geom = get_geometry_from_hit(
            scene, hit.geometry_index.astype(jnp.int32),
            hit.primitive_id.astype(jnp.int32),
            jnp.stack([hit.u, hit.v], axis=-1),
            textures_enabled=bool(g_const.textures),
            triangle_index=hit.triangle_index)
        emission = jnp.where(hit.missed[..., None],
                             get_environment_radiance(
                                 scene, d, g_const.environment),
                             geom.emission).reshape(height, w_res, 3)
        radiance = radiance + jnp.where(
            take[..., None], emission * sec_surface.diffuse_albedo, 0.0)

    # initial GI reservoir (:130-142)
    output_shading_result = is_specular_ray & is_delta
    reservoir_gi = make_gi_reservoir(
        sec_surface.world_pos, sec_surface.normal, radiance, secondary.pdf)
    keep = is_valid_secondary & ~output_shading_result
    reservoir_gi = where_gi(keep, reservoir_gi,
                            empty_gi_reservoir((height, w_res)))

    # save radiance for final-pass MIS (:144-146)
    secondary = secondary._replace(
        emission=jnp.where(output_shading_result[..., None], 0.0, radiance))

    # delta-specular shortcut output (:148-156)
    out_d = jnp.where(is_specular_ray[..., None], 0.0, radiance)
    out_s = jnp.where(is_specular_ray[..., None], radiance, 0.0)
    out_s = brdfm.demodulate_specular(primary.specular_f0, out_s)
    diffuse_img, specular_img = store_shading_output(
        diffuse_img, specular_img, out_d, out_s,
        is_first_pass=False,
        enable_accumulation=g_const.enable_accumulation,
        blend_factor=g_const.blend_factor,
        correct_specular_accumulation=bool(
            g_const.correct_specular_accumulation),
        write_mask=output_shading_result)

    return reservoir_gi, secondary, diffuse_img, specular_img


def gi_temporal_pass(
    g_const: GConst,
    bridge: Bridge,
    input_reservoirs: GIReservoir,  # [H, W] current initial reservoirs
    prev_reservoirs: GIReservoir,  # [H, W] previous frame source
    motion: jax.Array,  # [H, W, 3]
    width: int,
    height: int,
    row0=0,
    row_base=0,
    halo_fn=None,
    halo_rows: int = 8,
    field: int = 0,
    primary_surface=None,
) -> GIReservoir:
    """temporal_resampling.rgen:13-48. Under row sharding, halo_fn pads
    the previous-frame reservoir tile by halo_rows (reprojection offsets
    beyond the halo clamp to it — motion is rarely > 8 rows/frame) and
    row_base maps global rows into the padded tile. Under checkerboard
    the pass runs on the active half-field ([H, W//2] reservoirs);
    neighbor pixel math stays in full-res pixel space and the library
    maps to reservoir positions (temporal_resampling.rgen:16)."""
    px, py = raysmod.active_pixel_grid(width, height, field)
    py = py + row0
    w_res = width // 2 if field else width
    rng = rtrng.init_random_sampler(
        px.astype(jnp.uint32), py.astype(jnp.uint32),
        g_const.frame + jnp.uint32(7 * 13))

    primary = (primary_surface if primary_surface is not None
               else bridge.get_gbuffer_surface(px, py, False))
    motion_px = raysmod.convert_motion_vector_to_pixel_space(
        g_const.view, g_const.prev_view, px, py, motion)

    tp = g_const.restir_gi.temporal_resampling_params
    # jittered age threshold to avoid mass reservoir death (:39-41)
    r, rng = rtrng.sample_uniform(rng)
    max_age = (tp.max_reservoir_age * (0.5 + r * 0.5)).astype(jnp.uint32)

    prev_src = prev_reservoirs
    prev_base = row_base
    if halo_fn is not None:
        prev_src = halo_fn(prev_reservoirs, halo_rows)
        prev_base = row0 - halo_rows

    spec = gi_resampling.GITemporalSpec(
        max_history_length=tp.max_history_length,
        bias_correction_mode=tp.temporal_bias_correction_mode,
        depth_threshold=tp.depth_threshold,
        normal_threshold=tp.normal_threshold,
        enable_permutation_sampling=bool(tp.enable_permutation_sampling),
        enable_fallback_sampling=bool(tp.enable_fallback_sampling),
        active_checkerboard_field=g_const.runtime_params
        .active_checkerboard_field)

    flat = lambda a: a.reshape((-1,) + a.shape[2:])
    out, rng = gi_resampling.gi_temporal_resampling(
        px.reshape(-1), py.reshape(-1),
        jax.tree_util.tree_map(flat, primary),
        jax.tree_util.tree_map(flat, input_reservoirs),
        rtrng.RngState(seed=rng.seed.reshape(-1),
                       index=rng.index.reshape(-1)),
        spec,
        motion_px.reshape(-1, 3),
        tp.uniform_random_number,
        max_age.reshape(-1),
        prev_src,
        bridge,
        row_base=prev_base,
        )
    out = jax.tree_util.tree_map(
        lambda a: a.reshape((height, w_res) + a.shape[1:]), out)

    if tp.enable_boiling_filter:
        # applied at the end of the temporal pass (DIResamplingFunctions
        # comment :102-105 / GIResamplingFunctions.hlsli:885-894)
        from raytracer2.restir.gi_resampling import gi_boiling_filter

        out = gi_boiling_filter(out, tp.boiling_filter_strength)

    return where_gi(primary.valid, out, input_reservoirs)


def gi_spatial_pass(
    g_const: GConst,
    bridge: Bridge,
    input_reservoirs: GIReservoir,  # [H, W]
    width: int,
    height: int,
    row0=0,
    row_base=0,
    halo_fn=None,
    field: int = 0,
    primary_surface=None,
) -> GIReservoir:
    """spatial_resampling.rgen:13-39. Under row sharding, halo_fn pads the
    neighbor-source reservoir tile and row_base maps global rows into it.
    Under checkerboard the pass runs on the active half-field."""
    px, py = raysmod.active_pixel_grid(width, height, field)
    py = py + row0
    w_res = width // 2 if field else width
    rng = rtrng.init_random_sampler(
        px.astype(jnp.uint32), py.astype(jnp.uint32),
        g_const.frame + jnp.uint32(8 * 13))
    primary = (primary_surface if primary_surface is not None
               else bridge.get_gbuffer_surface(px, py, False))

    sp = g_const.restir_gi.spatial_resampling_params
    spec = gi_resampling.GISpatialSpec(
        depth_threshold=sp.spatial_depth_threshold,
        normal_threshold=sp.spatial_normal_threshold,
        num_samples=sp.num_spatial_samples,
        sampling_radius=sp.spatial_sampling_radius,
        bias_correction_mode=sp.spatial_bias_correction_mode,
        active_checkerboard_field=g_const.runtime_params
        .active_checkerboard_field,
        neighbor_offset_mask=g_const.runtime_params.neighbor_offset_mask)

    # neighbor source: under sharding, pad the current-reservoir tile
    # with halo rows so radius-R gathers stay local (parallel/halo.py)
    source = input_reservoirs
    src_base = row_base
    if halo_fn is not None:
        import math

        r = int(math.ceil(float(sp.spatial_sampling_radius))) + 1
        source = halo_fn(input_reservoirs, r)
        src_base = row0 - r

    flat = lambda a: a.reshape((-1,) + a.shape[2:])
    out, _ = gi_resampling.gi_spatial_resampling(
        px.reshape(-1), py.reshape(-1),
        jax.tree_util.tree_map(flat, primary),
        jax.tree_util.tree_map(flat, input_reservoirs),
        rtrng.RngState(seed=rng.seed.reshape(-1), index=rng.index.reshape(-1)),
        spec,
        source,
        bridge,
        row_base=src_base)
    out = jax.tree_util.tree_map(
        lambda a: a.reshape((height, w_res) + a.shape[1:]), out)
    return where_gi(primary.valid, out, input_reservoirs)


def _get_mis_weight(rough_brdf, true_brdf, diffuse_albedo) -> jax.Array:
    """GetMISWeight (gi_final_shading.rgen:18-28)."""
    combined_rough = (rough_brdf.demodulated_diffuse[..., None]
                      * diffuse_albedo + rough_brdf.specular)
    combined_true = (true_brdf.demodulated_diffuse[..., None]
                     * diffuse_albedo + true_brdf.specular)
    combined_rough = jnp.clip(combined_rough, 1e-4, K_MAX_BRDF_VALUE)
    combined_true = jnp.clip(combined_true, 0.0, K_MAX_BRDF_VALUE)
    w = brdfm.saturate(
        brdfm.luminance(combined_true)
        / jnp.maximum(brdfm.luminance(combined_true + combined_rough), 1e-30))
    return w * w * w


def gi_final_shading_pass(
    g_const: GConst,
    bridge: Bridge,
    reservoirs: GIReservoir,  # [H, W] final reservoirs
    secondary: SecondaryGBuffer,
    diffuse_img: jax.Array,
    specular_img: jax.Array,
    width: int,
    height: int,
    row0=0,
    field: int = 0,
    primary_surface=None,
) -> tuple[jax.Array, jax.Array]:
    """gi_final_shading.rgen:43-101 (checkerboard launch mapping :45).

    4K-class launches run per-pixel in row bands under lax.map — the
    pass is pixel-independent (final visibility ray, split
    BRDF, MIS vs the initial sample) so banding is bit-exact."""
    px, py = raysmod.active_pixel_grid(width, height, field)
    py = py + row0
    w_res = width // 2 if field else width

    if (height * w_res > _BAND_THRESHOLD and primary_surface is not None
            and isinstance(row0, int)):
        # band height: ~half the threshold's lane count per band (so a
        # monkeypatched threshold in tests forces real multi-band runs)
        hb = max(1, min(1 << 21, _BAND_THRESHOLD // 2) // max(w_res, 1))
        nb = (height + hb - 1) // hb
        pad = nb * hb - height

        def band(tree):
            return jax.tree_util.tree_map(
                lambda a: jnp.concatenate(
                    [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)]
                ).reshape((nb, hb) + a.shape[1:]) if pad else
                a.reshape((nb, hb) + a.shape[1:]), tree)

        args = (band(primary_surface), band(reservoirs), band(secondary),
                band(diffuse_img), band(specular_img))

        def one(a):
            prim_b, res_b, sec_b, dif_b, spec_b = a
            return _gi_final_shading_body(
                g_const, bridge, res_b, sec_b, dif_b, spec_b, prim_b)

        out = jax.lax.map(one, args)
        return jax.tree_util.tree_map(
            lambda a: a.reshape((nb * hb,) + a.shape[2:])[:height], out)

    primary = (primary_surface if primary_surface is not None
               else bridge.get_gbuffer_surface(px, py, False))
    return _gi_final_shading_body(g_const, bridge, reservoirs, secondary,
                                  diffuse_img, specular_img, primary)


def _gi_final_shading_body(g_const, bridge, reservoirs, secondary,
                           diffuse_img, specular_img, primary):
    from raytracer2.render.surface import evaluate_brdf

    valid = gi_is_valid(reservoirs)
    radiance = reservoirs.radiance * reservoirs.weight_sum[..., None]

    if g_const.restir_gi.final_shading_params.enable_final_visibility:
        visible = bridge.get_conservative_visibility(
            primary, reservoirs.position)
        radiance = radiance * jnp.where(visible, 1.0, 0.0)[..., None]

    brdf = evaluate_brdf(primary, reservoirs.position)

    if g_const.restir_gi.final_shading_params.enable_final_mis:
        # initial-sample reservoir from the secondary G-buffer (:30-41)
        tp4 = pk.unpack_r16g16b16a16_float(secondary.throughput)
        init_normal = pk.oct_unorm32_to_ndir(secondary.normal)
        init_res = make_gi_reservoir(
            secondary.world_pos, init_normal,
            secondary.emission * tp4[..., :3], secondary.pdf)

        brdf0 = evaluate_brdf(primary, init_res.position)
        rough_surface = primary._replace(
            roughness=jnp.maximum(primary.roughness, K_MIS_ROUGHNESS))
        rough_brdf = evaluate_brdf(rough_surface, reservoirs.position)
        rough_brdf0 = evaluate_brdf(rough_surface, init_res.position)

        final_w = 1.0 - _get_mis_weight(rough_brdf, brdf,
                                        primary.diffuse_albedo)
        init_w = _get_mis_weight(rough_brdf0, brdf0, primary.diffuse_albedo)
        init_radiance = init_res.radiance * init_res.weight_sum[..., None]

        diffuse = (brdf.demodulated_diffuse[..., None] * radiance
                   * final_w[..., None]
                   + brdf0.demodulated_diffuse[..., None] * init_radiance
                   * init_w[..., None])
        specular = (brdf.specular * radiance * final_w[..., None]
                    + brdf0.specular * init_radiance * init_w[..., None])
    else:
        diffuse = brdf.demodulated_diffuse[..., None] * radiance
        specular = brdf.specular * radiance

    specular = brdfm.demodulate_specular(primary.specular_f0, specular)
    diffuse = jnp.where(valid[..., None], diffuse, 0.0)
    specular = jnp.where(valid[..., None], specular, 0.0)

    return store_shading_output(
        diffuse_img, specular_img, diffuse, specular,
        is_first_pass=(g_const.enable_restir_di == 0),
        enable_accumulation=g_const.enable_accumulation,
        blend_factor=g_const.blend_factor,
        correct_specular_accumulation=bool(
            g_const.correct_specular_accumulation))
