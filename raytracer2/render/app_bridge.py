"""Concrete bridge construction: wire scene + traversal + G-buffers into
the RAB closure bundle the restir library consumes.

This is the renderer's implementation of the contract in restir/bridge.py,
mirroring lighting_passes/RtxdiApplicationBridge.glsl. The traversal
engines are listed in make_tracers; brute force is the oracle.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp

from raytracer2.lights.polymorphic import LightInfo, calc_sample
from raytracer2.ops.bvh import BVH, build_lbvh
from raytracer2.ops import traverse
from raytracer2.ops.intersect import (
    INVALID_INDEX, HitRecord, intersect_brute_force, occluded_brute_force)
from raytracer2.params import RTXDI_INVALID_LIGHT_INDEX, GConst
from raytracer2.render.gbuffer import GBuffer, surface_from_gbuffer
from raytracer2.render.surface import (
    Surface, are_materials_similar, evaluate_brdf, get_surface_brdf_pdf,
    get_surface_brdf_sample)
from raytracer2.restir.bridge import Bridge
from raytracer2.scene.scene import Scene
from raytracer2.utils import brdf as brdfm
from raytracer2.utils.packing import linear_to_zcurve


def _host_tris(scene: Scene):
    """Triangle soup for the HOST-side acceleration builders: prefer the
    numpy copies build_scene keeps (Scene.host_tri_*), which saves copying
    the whole soup back from the device."""
    if scene.host_tri_v0 is not None:
        return (scene.host_tri_v0, scene.host_tri_edge1,
                scene.host_tri_edge2)
    return scene.tri_v0, scene.tri_edge1, scene.tri_edge2


# traversal engines a caller may name; "auto" resolves by platform
BACKENDS = ("auto", "bundle", "scatter", "lbvh", "brute")


def resolve_backend(platform: str) -> str:
    """The engine `backend="auto"` runs on a JAX platform ("gpu", "cpu",
    ...). The XLA bundle engine is plain JAX and runs on both; any other
    platform is an error rather than a silent fallback."""
    if platform in ("gpu", "cpu"):
        return "bundle"
    raise ValueError(
        f"no traversal engine is chosen for platform {platform!r}; "
        f"name one explicitly (backend in {BACKENDS[1:]})")


@dataclasses.dataclass(frozen=True)
class Tracers:
    """Closest-hit + any-hit query closures over a scene."""

    closest_hit: Callable  # (o, d, tmin, tmax) -> HitRecord
    occluded: Callable  # (o, d, tmin, tmax) -> blocked mask


def make_tracers(scene: Scene, bvh: BVH | None = None,
                 use_bvh: bool = True, backend: str = "auto",
                 cluster_size: int | None = None,
                 sort_secondary: bool = True,
                 ) -> Tracers:
    """Traversal backends:
    - "auto" (default): resolve_backend(jax.default_backend())
    - "bundle": frustum-bundle tracer (ops/traverse_bundle.py);
      fastest for coherent rays, degrades on incoherent batches
    - "scatter": per-ray exact culling + supercluster ray-binning
      (ops/traverse_scatter.py); coherence-independent throughput
    - "lbvh": per-ray stack traversal over the device LBVH
    - "brute": all-pairs oracle
    """
    if not use_bvh or scene.num_triangles < 2:
        backend = "brute"
    if backend == "auto":
        backend = resolve_backend(jax.default_backend())
    if backend not in BACKENDS:
        raise ValueError(f"unknown traversal backend {backend!r}")

    if backend == "scatter":
        from raytracer2.ops.cluster import build_clusters
        from raytracer2.ops import traverse_scatter as tsm

        clusters = build_clusters(
            *_host_tris(scene), cluster_size=min(cluster_size or 64, 16))
        sc = tsm.build_superclusters(clusters, group=16)
        # exact: a pair pool with room for every supercluster per ray (no
        # candidate is ever dropped), with ray slices sized so the pool
        # stays near 16M pairs
        cap = dict(avg_candidates=sc.num_superclusters,
                   ray_batch=max(tsm.PAIR_BLOCK, (1 << 24)
                                 // sc.num_superclusters
                                 // tsm.PAIR_BLOCK * tsm.PAIR_BLOCK))

        def closest(o, d, tmin, tmax):
            return tsm.closest_hit_scatter(
                sc, scene.tri_geometry, scene.tri_primitive,
                o, d, tmin, tmax, **cap)

        def occl(o, d, tmin, tmax):
            return tsm.occluded_scatter(sc, o, d, tmin, tmax, **cap)
    elif backend == "bundle":
        from raytracer2.ops.cluster import build_clusters
        from raytracer2.ops import traverse_bundle as tbm

        clusters = build_clusters(
            *_host_tris(scene), cluster_size=cluster_size or 64)
        scene_min = jnp.min(clusters.aabb_min, axis=0)
        scene_max = jnp.max(clusters.aabb_max, axis=0)

        def closest(o, d, tmin, tmax):
            return tbm.closest_hit_bundle(
                clusters, scene.tri_geometry, scene.tri_primitive,
                o, d, tmin, tmax, scene_min, scene_max,
                sort_rays=sort_secondary)

        def occl(o, d, tmin, tmax):
            return tbm.occluded_bundle(
                clusters, o, d, tmin, tmax, scene_min, scene_max,
                sort_rays=sort_secondary)
    elif backend == "lbvh":
        if bvh is None:
            bvh = build_lbvh(*_host_tris(scene))
        from raytracer2.ops.bvh import max_depth
        from raytracer2.ops.traverse import STACK_SIZE

        depth = max_depth(bvh)
        assert depth <= STACK_SIZE, (
            f"LBVH depth {depth} exceeds the traversal stack "
            f"({STACK_SIZE}); overflow would silently drop subtrees "
            "(ADVICE r1) — deepen STACK_SIZE or rebalance the tree")

        def closest(o, d, tmin, tmax):
            return traverse.closest_hit(
                bvh, scene.tri_v0, scene.tri_edge1, scene.tri_edge2,
                scene.tri_geometry, scene.tri_primitive, o, d, tmin, tmax)

        def occl(o, d, tmin, tmax):
            return traverse.occluded(
                bvh, scene.tri_v0, scene.tri_edge1, scene.tri_edge2,
                o, d, tmin, tmax)
    else:
        def closest(o, d, tmin, tmax):
            return intersect_brute_force(
                o, d, scene.tri_v0, scene.tri_edge1, scene.tri_edge2,
                scene.tri_geometry, scene.tri_primitive, tmin, tmax)

        def occl(o, d, tmin, tmax):
            return occluded_brute_force(
                o, d, scene.tri_v0, scene.tri_edge1, scene.tri_edge2,
                tmin, tmax)

    return Tracers(closest_hit=closest, occluded=occl)


def get_light_sample_target_pdf(light_sample, surface: Surface) -> jax.Array:
    """RAB_GetLightSampleTargetPdfForSurface (bridge:478-500)."""
    live = light_sample.solid_angle_pdf > 0.0
    l = brdfm.normalize(light_sample.position - surface.world_pos)
    live &= brdfm.dot3(l, surface.geo_normal) > 0.0

    d = brdfm.lambert(surface.normal, -l)
    s = brdfm.ggx_times_ndotl(
        surface.view_dir, l, surface.normal,
        jnp.maximum(surface.roughness, brdfm.K_MIN_ROUGHNESS),
        surface.specular_f0)
    s = jnp.where((surface.roughness == 0.0)[..., None], 0.0, s)
    reflected = light_sample.radiance * (
        d[..., None] * surface.diffuse_albedo + s)
    pdf = brdfm.luminance(reflected) / jnp.maximum(
        light_sample.solid_angle_pdf, 1e-30)
    return jnp.where(live, pdf, 0.0)


def get_gi_sample_target_pdf(sample_position, sample_radiance,
                             surface: Surface) -> jax.Array:
    """RAB_GetGISampleTargetPdfForSurface (bridge:687-694)."""
    b = evaluate_brdf(surface, sample_position)
    reflected = sample_radiance * (
        b.demodulated_diffuse[..., None] * surface.diffuse_albedo + b.specular)
    return brdfm.luminance_rec709(reflected)


def make_bridge(
    scene: Scene,
    tracers: Tracers,
    gbuffer: GBuffer,
    prev_gbuffer: GBuffer,
    g_const: GConst,
    lights: LightInfo,
    geometry_to_light: jax.Array,  # [G] u32, sentinel INVALID
    local_pdf_mips: tuple[jax.Array, ...] | None,
    env_pdf_mips: tuple[jax.Array, ...] | None,
    neighbor_offsets: jax.Array,
    width: int,
    height: int,
    row_base=0,
) -> Bridge:
    """Assemble the full RAB closure bundle for one frame. row_base maps
    global pixel rows into (halo-padded) G-buffer row tiles (sharding)."""
    view = g_const.view
    prev_view = g_const.prev_view
    environment = g_const.environment

    def get_gbuffer_surface(px, py, previous_frame):
        if previous_frame:
            return surface_from_gbuffer(prev_gbuffer, prev_view, px, py,
                                        width, height, row_base=row_base)
        return surface_from_gbuffer(gbuffer, view, px, py, width, height,
                                    row_base=row_base)

    def get_conservative_visibility(surface: Surface, sample_position):
        from raytracer2.render.shading import setup_visibility_ray

        o, d, tmin, tmax = setup_visibility_ray(surface, sample_position)
        batch = tmin.shape
        blocked = tracers.occluded(o.reshape(-1, 3), d.reshape(-1, 3),
                                   tmin.reshape(-1), tmax.reshape(-1))
        return ~blocked.reshape(batch)

    def get_temporal_conservative_visibility(cur_surface, prev_surface,
                                             sample_position):
        # uses the previous surface + current AS (bridge:242-245)
        return get_conservative_visibility(prev_surface, sample_position)

    def sample_polymorphic_light(light_info, surface, uv):
        return calc_sample(light_info, uv, surface.world_pos,
                           skybox=scene.skybox if environment else None)

    def load_light_info(index, previous_frame):
        i = jnp.maximum(index.astype(jnp.int32), 0)
        return LightInfo(*(leaf[i] for leaf in lights))

    def trace_ray_for_local_light(origins, directions, t_min, t_max):
        """(bridge:639-669): closest-hit, then geometry -> light-table index."""
        batch = t_min.shape
        hit = tracers.closest_hit(
            origins.reshape(-1, 3), directions.reshape(-1, 3),
            jnp.broadcast_to(t_min, batch).reshape(-1),
            jnp.broadcast_to(t_max, batch).reshape(-1))
        hit = jax.tree_util.tree_map(lambda a: a.reshape(batch), hit)
        hit_anything = ~hit.missed
        geom = jnp.where(hit_anything, hit.geometry_index, 0).astype(jnp.int32)
        base = geometry_to_light[geom]
        # one-sided emitters: a hit on the BACK face of an emissive
        # triangle identifies no light. The solid-angle pdf cancels out of
        # the RIS estimator (radiance * invPdf / sapdf with invPdf ~
        # sapdf/brdfPdf), so without this test back-face hits contribute
        # FULL front radiance — measured +41% direct light on a Cornell
        # box whose lamp back is reachable. (The reference has the same
        # leak, latent because its scene hides every emitter's back.)
        tri = jnp.maximum(hit.triangle_index, 0)
        tri_n = jnp.cross(scene.tri_edge1[tri], scene.tri_edge2[tri])
        front = brdfm.dot3(directions.reshape(batch + (3,)), tri_n) < 0.0
        light_index = jnp.where(
            (base != jnp.uint32(RTXDI_INVALID_LIGHT_INDEX)) & hit_anything
            & front,
            base + hit.primitive_id, jnp.uint32(RTXDI_INVALID_LIGHT_INDEX))
        bary = brdfm.hit_uv_to_barycentric(
            jnp.stack([hit.u, hit.v], axis=-1))
        rand_xy = jnp.where(
            (light_index != jnp.uint32(RTXDI_INVALID_LIGHT_INDEX))[..., None],
            brdfm.random_from_barycentric(bary), 0.0)
        return hit_anything, light_index, rand_xy

    def evaluate_local_light_source_pdf(light_index):
        """(bridge:420-434) — with a bias fix the reference lacks: the
        reference always returns the POWER pdf from the pdf texture even
        though its app samples local lights UNIFORMLY (presampling compiled
        out), so the BRDF candidate stream MIS-weights against a different
        selection pdf than the light stream uses — inconsistent balance
        denominators = biased MIS (measured +6% on Cornell with local
        candidates enabled; dormant at reference defaults because
        numPrimaryLocalLightSamples=0 makes localLightMisWeight 0). We
        return the pdf of the ACTIVE local sampling mode: uniform for
        mode 0, the power texture for modes 1/2."""
        mode = (g_const.restir_di.initial_sampling_params
                .local_light_sampling_mode)
        region = g_const.light_buffer_params.local_light_buffer_region
        if mode == 0 or local_pdf_mips is None:
            return jnp.full(light_index.shape,
                            1.0 / max(region.num_lights, 1), jnp.float32)
        from raytracer2.lights.pdf_texture import evaluate_pdf_texture

        x, y = linear_to_zcurve(light_index)
        return evaluate_pdf_texture(local_pdf_mips, x.astype(jnp.int32),
                                    y.astype(jnp.int32))

    def evaluate_environment_map_sampling_pdf(direction):
        """(bridge:397-418)."""
        if (env_pdf_mips is None or
                g_const.restir_di.initial_sampling_params
                .environment_map_importance_sampling == 0):
            return jnp.ones(direction.shape[:-1], jnp.float32)
        from raytracer2.lights.pdf_texture import evaluate_pdf_texture

        uv = brdfm.direction_to_equirect_uv(direction)
        h, w = env_pdf_mips[0].shape
        x = (uv[..., 0] * w).astype(jnp.int32)
        y = (uv[..., 1] * h).astype(jnp.int32)
        return evaluate_pdf_texture(env_pdf_mips, x, y)

    return Bridge(
        get_gbuffer_surface=get_gbuffer_surface,
        get_light_sample_target_pdf=get_light_sample_target_pdf,
        get_gi_sample_target_pdf=get_gi_sample_target_pdf,
        get_conservative_visibility=get_conservative_visibility,
        get_temporal_conservative_visibility=get_temporal_conservative_visibility,
        are_materials_similar=are_materials_similar,
        sample_polymorphic_light=sample_polymorphic_light,
        load_light_info=load_light_info,
        get_surface_brdf_sample=get_surface_brdf_sample,
        get_surface_brdf_pdf=get_surface_brdf_pdf,
        trace_ray_for_local_light=trace_ray_for_local_light,
        evaluate_local_light_source_pdf=evaluate_local_light_source_pdf,
        evaluate_environment_map_sampling_pdf=evaluate_environment_map_sampling_pdf,
        neighbor_offsets=neighbor_offsets,
        viewport=(width, height),
    )

