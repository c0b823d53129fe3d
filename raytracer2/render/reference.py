"""Brute-force reference path tracer — the correctness oracle.

Port of src/shaders/lighting_passes/refrence.rgen: maxSamples diffuse paths of
maxBounces bounces per pixel, environment termination, emission accumulated at
every hit. The GLSL per-pixel loop with `break` becomes a masked lax loop:
inactive lanes stop contributing AND stop consuming RNG draws, so the random
sequence stays bit-identical to the sequential shader.

This is the ground-truth mode toggled by GConst.refrence_mode (main.rs:536,
light_passes.rs:587-596) and the RMSE baseline for every ReSTIR pass
(SURVEY.md §4).
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp

from raytracer2.params import BACKGROUND_DEPTH, GConst
from raytracer2.render import rays as raysmod
from raytracer2.render.surface import get_surface_brdf_sample, surface_from_hit
from raytracer2.scene.scene import Scene, get_environment_radiance
from raytracer2.ops.intersect import HitRecord, intersect_brute_force
from raytracer2.utils import rng as rtrng

MAX_BOUNCES = 5  # (ref: refrence.rgen:16)
MAX_SAMPLES = 12  # (ref: refrence.rgen:17)

TraceFn = Callable[[jax.Array, jax.Array, jax.Array, jax.Array], HitRecord]


def make_brute_force_tracer(scene: Scene, chunk: int = 512) -> TraceFn:
    """Closest-hit tracer closure over the scene's world-space triangle soup
    (the `trace()` wrapper, bridge:74-81, minus the driver)."""

    def trace(origins, directions, t_min, t_max) -> HitRecord:
        return intersect_brute_force(
            origins, directions,
            scene.tri_v0, scene.tri_edge1, scene.tri_edge2,
            scene.tri_geometry, scene.tri_primitive,
            t_min, t_max, chunk=chunk)

    return trace


def render_reference(
    scene: Scene,
    g_const: GConst,
    width: int,
    height: int,
    max_bounces: int = MAX_BOUNCES,
    max_samples: int = MAX_SAMPLES,
    trace_fn: TraceFn | None = None,
    textures_enabled: bool | None = None,
    with_ray_count: bool = False,
    chunk_pixels: int = 1 << 18,
    emission_facing: str = "double",
    compact_dead_lanes: bool = False,
) -> jax.Array:
    """Render the reference image; returns linear radiance [H, W, 3]
    (the Diffuse buffer the post-process pass reads in refrence mode,
    post_processing.comp:156-157). With with_ray_count=True also returns
    the number of LIVE rays traced (lanes not yet terminated by a miss),
    for honest Mrays/s accounting across scenes with different escape
    fractions — the nominal count is W*H*spp*bounces.

    Pixels are processed in chunk_pixels-wide slices (lax.map): the
    slice bounds the per-bounce loop temps and so the peak device memory
    at 1080p and above; Z-order chunks keep each slice coherent.

    emission_facing: "double" (default) adds hit emission regardless of
    facing, byte-faithful to refrence.rgen:38. "front" counts emission
    only when the ray hits the front face — the transport the RTXDI
    single-sided triangle lights estimate, used by the RMSE gate
    (tests/test_rmse.py) so estimator bias is measured against a
    matched-transport oracle instead of the back-face quirk."""
    if trace_fn is None:
        trace_fn = make_brute_force_tracer(scene)
    if textures_enabled is None:
        textures_enabled = bool(g_const.textures)
    environment = g_const.environment

    # pixels are laid out along a Z-curve so every chunk is a compact
    # screen region and its trace launches see coherent ray batches
    # (rays.zorder_permutation). Per-pixel RNG and
    # radiance are keyed by (px, py) values, so the image is bit-identical
    # to the row-major layout after the final unpermute.
    zidx, zinv = raysmod.zorder_permutation(width, height)
    px_all, py_all = raysmod.pixel_grid(width, height)
    px_all = px_all.reshape(-1)[zidx]
    py_all = py_all.reshape(-1)[zidx]
    n_img = px_all.shape[0]

    # pixel chunking (docstring): pad to a whole number of chunks with
    # dummy (0, 0) pixels whose output is sliced away
    n = min(chunk_pixels, n_img)
    pad = (-n_img) % n
    if pad:
        px_all = jnp.concatenate([px_all, jnp.zeros((pad,), px_all.dtype)])
        py_all = jnp.concatenate([py_all, jnp.zeros((pad,), py_all.dtype)])
    valid_all = jnp.arange(px_all.shape[0]) < n_img  # pad lanes never trace
    n_chunks = px_all.shape[0] // n

    def tf_compact(o, d, tn, tx):
        """Bounce-level dead-lane compaction: when at least half the
        lanes are dead, trace a half-size batch of the live ones. Default
        off: dead lanes (t_max < 0) are excluded from bundle bounds and
        cost no candidate work, so the half batch saves little and pays
        an argsort, gathers and a two-branch cond. Not yet measured on
        the GPU. Bit-identical when enabled
        (tests/test_reference_render.py)."""
        nn = o.shape[0]
        h = nn // 2
        dead = tx < 0.0
        live_count = jnp.sum((~dead).astype(jnp.int32))

        def full(_):
            return trace_fn(o, d, tn, tx)

        def half(_):
            perm = jnp.argsort(dead)[:h]  # live lanes first, stable
            rec = trace_fn(o[perm], d[perm], tn[perm], tx[perm])

            def back(leaf, fill):
                out = jnp.full((nn,) + leaf.shape[1:], fill, leaf.dtype)
                return out.at[perm].set(leaf)

            from raytracer2.ops.intersect import INVALID_INDEX

            return HitRecord(
                t=back(rec.t, 0.0),
                u=back(rec.u, 0.0),
                v=back(rec.v, 0.0),
                geometry_index=back(rec.geometry_index, INVALID_INDEX),
                primitive_id=back(rec.primitive_id, 0),
                triangle_index=back(rec.triangle_index, -1))

        if nn < 2048 or not compact_dead_lanes:
            return full(None)
        return jax.lax.cond(live_count <= h, half, full, None)

    def render_chunk(args):
        px, py, valid = args

        # RAB_InitRandomSampler(pixel, pass=1) -> frame + 13 (bridge:378-381;
        # refrence.rgen:21 passes frameIndex=1 meaning pass=1)
        chunk_rng = rtrng.init_random_sampler(
            px.astype(jnp.uint32), py.astype(jnp.uint32),
            g_const.frame + jnp.uint32(13))
        primary = raysmod.setup_primary_ray(px, py, g_const.view)
        # the camera ray is identical for every sample: trace bounce 0
        # ONCE and reuse its hit/surface across the sample loop (the
        # shader re-traces per sample, refrence.rgen:25-29, but tracing
        # is deterministic so this is bit-identical at (spp-1)/spp fewer
        # primary traces; the sample RNG streams start at the bounce-0
        # BRDF draw, which stays inside the loop)
        t_min0 = jnp.full((n,), 0.001, jnp.float32)
        hit0 = trace_fn(primary.origin, primary.direction, t_min0,
                  jnp.where(valid, BACKGROUND_DEPTH, -1.0))
        surface0, emission0 = surface_from_hit(
            scene, primary.origin, primary.direction, hit0,
            textures_enabled=textures_enabled)
        return jax.lax.fori_loop(
            0, max_samples,
            lambda _, c: sample_body(c, primary, valid,
                                     (hit0, surface0, emission0)),
            (jnp.zeros((n, 3), jnp.float32), chunk_rng, jnp.uint32(0)))

    def sample_body(carry, primary, valid, pre0):
        radiance, rng_state, live_rays = carry
        throughput = jnp.ones((n, 3), jnp.float32)
        active = valid
        origin = primary.origin
        direction = primary.direction
        t_min = jnp.full((n,), 0.001, jnp.float32)  # refrence.rgen:27
        t_max = jnp.full((n,), BACKGROUND_DEPTH, jnp.float32)

        def bounce_body(bcarry, pre=None):
            (radiance, throughput, active, origin, direction, rng_state,
             live_rays) = bcarry
            if with_ray_count:
                live_rays = live_rays + jnp.sum(active.astype(jnp.uint32))
            if pre is None:
                # dead lanes get t_max = -1: the bundle tracer excludes
                # them from bundle bounds and they can never hit; when
                # at least half the lanes are dead the batch itself
                # compacts to half size (tf_compact)
                lane_tmax = jnp.where(active, t_max, -1.0)
                hit = tf_compact(origin, direction, t_min, lane_tmax)
                surface, emission = surface_from_hit(
                    scene, origin, direction, hit,
                    textures_enabled=textures_enabled)
            else:
                hit, surface, emission = pre

            missed = hit.missed
            env = get_environment_radiance(scene, direction, environment)
            # miss: add env once then terminate (refrence.rgen:32-36)
            radiance = radiance + jnp.where(
                (active & missed)[..., None], throughput * env, 0.0)
            # hit: add emission, attenuate (refrence.rgen:38-39)
            emit = emission
            if emission_facing == "front":
                from raytracer2.utils.brdf import dot3

                front = dot3(direction, surface.normal) < 0.0
                emit = jnp.where(front[..., None], emission, 0.0)
            radiance = radiance + jnp.where(
                (active & ~missed)[..., None], throughput * emit, 0.0)
            throughput = jnp.where(
                (active & ~missed)[..., None],
                throughput * surface.diffuse_albedo, throughput)

            # next bounce dir; only active hit lanes consume RNG draws
            new_dir, _, advanced = get_surface_brdf_sample(surface, rng_state)
            take = active & ~missed
            rng_state = rtrng.RngState(
                seed=rng_state.seed,
                index=jnp.where(take, advanced.index, rng_state.index))
            direction = jnp.where(take[..., None], new_dir, direction)
            origin = jnp.where(take[..., None], surface.world_pos, origin)
            active = take
            return (radiance, throughput, active, origin, direction,
                    rng_state, live_rays)

        bcarry = (radiance, throughput, active, origin, direction, rng_state,
                  live_rays)
        # bounce 0 is peeled out with the hoisted primary hit (above)
        if max_bounces >= 1:
            bcarry = bounce_body(bcarry, pre=pre0)
        radiance, _, _, _, _, rng_state, live_rays = jax.lax.fori_loop(
            1, max_bounces, lambda _, c: bounce_body(c), bcarry)
        return radiance, rng_state, live_rays

    if n_chunks == 1:
        radiance, _, live_rays = render_chunk((px_all, py_all, valid_all))
    else:
        radiance, _, live_chunks = jax.lax.map(
            render_chunk, (px_all.reshape(n_chunks, n),
                           py_all.reshape(n_chunks, n),
                           valid_all.reshape(n_chunks, n)))
        radiance = radiance.reshape(n_chunks * n, 3)
        live_rays = jnp.sum(live_chunks)
    radiance = radiance[:n_img]

    img = (radiance[zinv] / max_samples).reshape(height, width, 3)
    if with_ray_count:
        return img, live_rays
    return img


@partial(jax.jit, static_argnums=(2, 3, 4, 5))
def render_reference_jit(scene: Scene, g_const: GConst, width: int,
                         height: int, max_bounces: int = MAX_BOUNCES,
                         max_samples: int = MAX_SAMPLES) -> jax.Array:
    return render_reference(scene, g_const, width, height,
                            max_bounces, max_samples)
