"""Emissive light-table preparation.

Replaces the reference's CPU task builder + GPU binary-search dispatch
(src/prepare_lights.rs:182-255, src/shaders/prepare_lights.comp) with
mask + cumsum over the scene's triangle soup (SURVEY.md §2: 'mask emissive
geoms, cumsum for offsets, vmap over triangles'):

- geometry_to_light map with the 0xFFFFFFFF sentinel (prepare_lights.rs:190-207);
- per-triangle TriangleLight records packed via StoreTriangleLight
  (prepare_lights.comp:105-120) with radiance = emission * 12 (the Hit.glsl
  quirk, applied in prepare_lights.comp:105 too);
- flux scattered into the Z-curve local-light PDF texture
  (prepare_lights.comp:121-125) + full mip pyramid;
- the environment light record appended at light index `lights + 1`
  (main.rs:381-386).

NOTE the reference's prepare_lights.comp transforms positions with
`vec4(p,1) * transform` (comp:101-103) — GLSL row-vector times matrix, i.e.
the TRANSPOSED matrix, dropping translation. That places light records wrong
for any transformed node (a real bug, invisible with identity transforms).
We build from the correctly world-transformed triangle soup instead.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from raytracer2.lights import pdf_texture
from raytracer2.lights.polymorphic import (
    LightInfo, get_power, store_environment_light, store_triangle_lights)
from raytracer2.params import RTXDI_INVALID_LIGHT_INDEX
from raytracer2.scene.scene import EMISSION_SCALE, Scene


class SceneLights(NamedTuple):
    """Per-scene light resources (render_resources.rs:143-239 equivalents)."""

    lights: LightInfo  # [num_lights + 2] (locals, pad, environment)
    geometry_to_light: jax.Array  # [G] u32 (first light of each geometry)
    num_local_lights: int
    local_pdf_mips: tuple[jax.Array, ...]  # local-light power pyramid
    env_pdf_mips: tuple[jax.Array, ...] | None  # environment luminance pyramid


def prepare_lights(scene: Scene, emission_scale: float = EMISSION_SCALE,
                   build_env_pdf: bool = True) -> SceneLights:
    """Build the light table + PDF textures. Host-side (numpy ordering /
    compaction) + device math, executed once per scene like the reference's
    frame-1 prepare pass (main.rs:663-697)."""
    g = scene.num_geometries
    # host copies of the masking inputs (build_scene keeps them), which
    # saves copying the device arrays back
    emission = (scene.host_emission if scene.host_emission is not None
                else np.asarray(scene.geometry.emission))  # [G, 4]
    tri_geo = (scene.host_tri_geometry
               if scene.host_tri_geometry is not None
               else np.asarray(scene.tri_geometry))
    is_emissive = np.any(emission[:, :3] != 0.0, axis=-1) if g else np.zeros(0, bool)
    # triangle counts per geometry from the soup
    index_counts = (np.bincount(tri_geo, minlength=g).astype(np.int64)
                    if g else np.zeros(0, np.int64))

    # light buffer offsets per geometry (prepare_lights.rs:182-209)
    geometry_to_light = np.full(g, RTXDI_INVALID_LIGHT_INDEX, np.uint32)
    offset = 0
    for gi in range(g):
        if is_emissive[gi]:
            geometry_to_light[gi] = offset
            offset += int(index_counts[gi])
    num_local = offset

    # gather emissive triangles in (geometry, primitive) order — the soup is
    # already in that order, so a stable mask keeps task ordering
    emissive_tri_mask = is_emissive[tri_geo] if g else np.zeros(0, bool)
    sel = np.nonzero(emissive_tri_mask)[0]

    base = scene.tri_v0[sel]
    edge1 = scene.tri_edge1[sel]
    edge2 = scene.tri_edge2[sel]
    radiance = (scene.geometry.emission[scene.tri_geometry[sel]][..., :3]
                * emission_scale)

    if num_local > 0:
        tri_lights = store_triangle_lights(base, edge1, edge2, radiance)
    else:
        from raytracer2.lights.polymorphic import empty_light_info

        tri_lights = empty_light_info(0)

    # environment record at index num_local + 1 (main.rs:381-386); slot
    # num_local stays empty (the empty infinite-light region sits there)
    env_size = (int(scene.skybox.shape[1]), int(scene.skybox.shape[0]))
    env_light = store_environment_light(env_size, importance_sampled=True)

    from raytracer2.lights.polymorphic import empty_light_info

    pad = empty_light_info(1)
    lights = LightInfo(*(
        jnp.concatenate([a, b, c], axis=0)
        for a, b, c in zip(tri_lights, pad, env_light)))

    # local-light PDF texture: flux at Z-curve texel + mips
    tex_w, tex_h, _ = pdf_texture.compute_pdf_texture_size(max(num_local, 1))
    if num_local > 0:
        flux = get_power(tri_lights)
    else:
        flux = jnp.zeros((0,), jnp.float32)
    local_base = pdf_texture.local_light_pdf_base(flux, tex_w, tex_h)
    local_mips = pdf_texture.build_mip_chain(local_base)

    env_mips = None
    if build_env_pdf and scene.skybox.shape[0] > 1:
        # pow2-padded env pdf sized from the skybox (render_resources.rs:208)
        ew, eh, _ = pdf_texture.compute_pdf_texture_size(
            scene.skybox.shape[0] * scene.skybox.shape[1])
        env_base = pdf_texture.environment_pdf_base(scene.skybox, (ew, eh))
        env_mips = pdf_texture.build_mip_chain(env_base)

    return SceneLights(
        lights=lights,
        geometry_to_light=jnp.asarray(geometry_to_light),
        num_local_lights=num_local,
        local_pdf_mips=local_mips,
        env_pdf_mips=env_mips,
    )


def presample_local_lights(
    rng_seed: int,
    scene_lights: SceneLights,
    tile_count: int = 128,
    tile_size: int = 1024,
) -> jax.Array:
    """RIS-tile presampling (presample_locallights.comp +
    PresamplingFunctions.hlsli:96-133): fills [tile_count * tile_size, 2] u32
    with (light index | compact bit, invPdf bits). One hierarchical mip
    descent per slot."""
    from raytracer2.utils import rng as rtrng
    from raytracer2.utils.packing import zcurve_to_linear

    n = tile_count * tile_size
    idx = jnp.arange(n, dtype=jnp.uint32)
    # each slot gets its own sampler seeded by its linear index (the compute
    # shader seeds by dispatch coordinates; exact layout differs, statistics
    # match)
    state = rtrng.RngState(
        seed=rtrng.jenkins_hash(idx) + jnp.uint32(rng_seed),
        index=jnp.ones_like(idx))
    x, y, pdf, state = pdf_texture.sample_pdf_mipmap(
        state, scene_lights.local_pdf_mips, (n,))
    light_index = zcurve_to_linear(x.astype(jnp.uint32), y.astype(jnp.uint32))
    inv_pdf = jnp.where(pdf > 0.0, 1.0 / jnp.maximum(pdf, 1e-30), 0.0)
    ok = pdf > 0.0
    entry_index = jnp.where(ok, light_index, jnp.uint32(0))
    entry_pdf = jnp.where(ok, inv_pdf, 0.0)
    return jnp.stack(
        [entry_index,
         jax.lax.bitcast_convert_type(entry_pdf, jnp.uint32)], axis=-1)


def presample_environment_map(
    rng_seed: int,
    scene_lights: SceneLights,
    tile_count: int = 128,
    tile_size: int = 1024,
) -> jax.Array:
    """Environment presampling (presample_environment.comp +
    PresamplingFunctions.hlsli:135-162): [tiles*size, 2] u32 of
    (packed uv, invPdf bits)."""
    from raytracer2.utils import rng as rtrng

    assert scene_lights.env_pdf_mips is not None
    n = tile_count * tile_size
    idx = jnp.arange(n, dtype=jnp.uint32)
    state = rtrng.RngState(
        seed=rtrng.jenkins_hash(idx) + jnp.uint32(rng_seed),
        index=jnp.ones_like(idx))
    x, y, pdf, state = pdf_texture.sample_pdf_mipmap(
        state, scene_lights.env_pdf_mips, (n,))
    jx, state = rtrng.sample_uniform(state)
    jy, state = rtrng.sample_uniform(state)
    h, w = scene_lights.env_pdf_mips[0].shape
    u = jnp.clip((x.astype(jnp.float32) + jx) / w, 0.0, 1.0)
    v = jnp.clip((y.astype(jnp.float32) + jy) / h, 0.0, 1.0)
    packed_uv = ((u * 0xFFFF).astype(jnp.uint32)
                 | ((v * 0xFFFF).astype(jnp.uint32) << 16))
    inv_pdf = jnp.where(pdf > 0.0, 1.0 / jnp.maximum(pdf, 1e-30), 0.0)
    return jnp.stack(
        [packed_uv, jax.lax.bitcast_convert_type(inv_pdf, jnp.uint32)],
        axis=-1)
