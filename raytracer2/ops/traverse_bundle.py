"""Bundle traversal: the production ray-casting engine, in plain JAX.

Replaces per-ray stack traversal (ops/traverse.py) for the hot path. Design
(SURVEY.md §7 'the perf risk'):

1. rays are grouped into fixed-size BUNDLES. Primary rays are coherent by
   construction (pixel-major order ~ screen tiles); secondary/visibility rays
   are sorted by (direction octant, origin morton cell) first, so each bundle
   has a tight origin box + direction cone.
2. every bundle is tested against every triangle cluster with a conservative
   interval-arithmetic slab test (ops/cluster.py) — a dense [B, C] map
   with zero gather traffic; clusters are ranked by conservative entry
   distance.
3. a lax.while_loop walks each bundle's candidate list front-to-back; each
   step intersects [bundle_size rays x cluster_chunk*cluster_size tris] as
   broadcast FMAs (ops/cluster.py intersect_cluster_block). Bundles
   terminate early when every remaining candidate's entry distance exceeds
   the bundle's worst committed hit — the same early-out a BVH gives,
   amortized per bundle.

The walk is exact: every cluster a bundle may touch stays on its list, so
incoherent bundles cost more steps, never dropped hits.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from raytracer2.ops.cluster import (
    Clusters, bundle_cluster_overlap, intersect_cluster_block)
from raytracer2.ops.intersect import INVALID_INDEX, HitRecord

BUNDLE_SIZE = 128
MAX_CANDIDATES = 192  # unused by the exact walk; kept for API compat
RAY_BATCH = 65536  # rays per dispatch slice (bounds all-pairs intermediates)


def _pad_rays(origins, directions, t_min, t_max, bundle_size):
    n = origins.shape[0]
    pad = (-n) % bundle_size
    if pad:
        origins = jnp.concatenate(
            [origins, jnp.zeros((pad, 3), origins.dtype)])
        directions = jnp.concatenate(
            [directions, jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]],
                                              directions.dtype), (pad, 1))])
        t_min = jnp.concatenate([t_min, jnp.zeros((pad,), t_min.dtype)])
        # padded rays never hit anything
        t_max = jnp.concatenate([t_max, jnp.full((pad,), -1.0, t_max.dtype)])
    return origins, directions, t_min, t_max, n


def _expand_bits(v: jax.Array, bits: int) -> jax.Array:
    """Spread the low `bits` bits with 2 zeros between each (morton helper)."""
    v = v & jnp.uint32((1 << bits) - 1)
    v = (v | (v << 16)) & jnp.uint32(0x030000FF)
    v = (v | (v << 8)) & jnp.uint32(0x0300F00F)
    v = (v | (v << 4)) & jnp.uint32(0x030C30C3)
    v = (v | (v << 2)) & jnp.uint32(0x09249249)
    return v


def sort_rays_for_coherence(origins: jax.Array, directions: jax.Array,
                            scene_min: jax.Array, scene_max: jax.Array
                            ) -> jax.Array:
    """Sort key (32 bits): [octant:3 | origin morton:15 | direction morton:12].

    Origin-major grouping keeps secondary/visibility rays with nearby origins
    together; the direction morton breaks ties so pinhole-camera rays (one
    shared origin cell) cluster into compact screen-space tiles rather than
    scanline strips — both cases yield tight bundle frusta."""
    octant = ((directions[:, 0] >= 0).astype(jnp.uint32)
              | ((directions[:, 1] >= 0).astype(jnp.uint32) << 1)
              | ((directions[:, 2] >= 0).astype(jnp.uint32) << 2))
    extent = jnp.maximum(scene_max - scene_min, 1e-12)
    q = jnp.clip((origins - scene_min) / extent, 0.0, 0.999)
    ocell = (q * 32.0).astype(jnp.uint32)  # 5 bits per axis
    o_morton = (_expand_bits(ocell[:, 0], 5)
                | (_expand_bits(ocell[:, 1], 5) << 1)
                | (_expand_bits(ocell[:, 2], 5) << 2))
    dq = jnp.clip(directions * 0.5 + 0.5, 0.0, 0.999)
    dcell = (dq * 16.0).astype(jnp.uint32)  # 4 bits per axis
    d_morton = (_expand_bits(dcell[:, 0], 4)
                | (_expand_bits(dcell[:, 1], 4) << 1)
                | (_expand_bits(dcell[:, 2], 4) << 2))
    key = (octant << 27) | (o_morton << 12) | d_morton
    return jnp.argsort(key)


def _bundle_bounds(origins, directions, t_max, bundle_size):
    """Per-bundle origin AABB + conservative 1/d interval. Padded rays
    (t_max < 0) are excluded from the bounds via +-inf sentinels."""
    b = origins.shape[0] // bundle_size
    o = origins.reshape(b, bundle_size, 3)
    d = directions.reshape(b, bundle_size, 3)
    tm = t_max.reshape(b, bundle_size)
    live = (tm >= 0.0)[..., None]

    big = jnp.float32(3e38)
    o_min = jnp.min(jnp.where(live, o, big), axis=1)
    o_max = jnp.max(jnp.where(live, o, -big), axis=1)
    d_min = jnp.min(jnp.where(live, d, big), axis=1)
    d_max = jnp.max(jnp.where(live, d, -big), axis=1)

    # conservative reciprocal interval; sign change across the bundle ->
    # unbounded axis (inf sentinels understood by the overlap test)
    spans_zero = (d_min <= 0.0) & (d_max >= 0.0)
    inv_a = 1.0 / jnp.where(jnp.abs(d_min) < 1e-12,
                            jnp.where(d_min >= 0, 1e-12, -1e-12), d_min)
    inv_b = 1.0 / jnp.where(jnp.abs(d_max) < 1e-12,
                            jnp.where(d_max >= 0, 1e-12, -1e-12), d_max)
    inv_lo = jnp.minimum(inv_a, inv_b)
    inv_hi = jnp.maximum(inv_a, inv_b)
    inv_lo = jnp.where(spans_zero, -jnp.inf, inv_lo)
    inv_hi = jnp.where(spans_zero, jnp.inf, inv_hi)

    bundle_tmax = jnp.max(jnp.where(live[..., 0], tm, 0.0), axis=1)
    return o_min, o_max, inv_lo, inv_hi, bundle_tmax


class BundleTraceResult(NamedTuple):
    t: jax.Array
    u: jax.Array
    v: jax.Array
    tri: jax.Array  # original triangle index; -1 miss
    overflowed: jax.Array  # scalar bool: some bundle exceeded MAX_CANDIDATES


CLUSTER_CHUNK = 16  # clusters intersected per loop step (amortizes step cost)


def _trace_bundles(origins, directions, t_min, t_max, clusters: Clusters,
                   max_candidates: int, bundle_size: int, any_hit: bool,
                   cluster_chunk: int = CLUSTER_CHUNK):
    """Core loop shared by closest-hit and any-hit."""
    b = origins.shape[0] // bundle_size
    s = clusters.cluster_size
    o_min, o_max, inv_lo, inv_hi, bundle_tmax = _bundle_bounds(
        origins, directions, t_max, bundle_size)

    may_hit, t_enter = bundle_cluster_overlap(
        o_min, o_max, inv_lo, inv_hi, bundle_tmax,
        clusters.aabb_min, clusters.aabb_max)

    overflowed = jnp.asarray(False)  # exact walk: no capacity truncation

    # rank ALL clusters by conservative entry distance; clamp to >= 0 so
    # unbounded-axis bundles (-inf entries) still rank and count correctly;
    # misses rank last with +inf. Correctness never depends on a capacity —
    # the front-to-back early-exit bounds the WORK instead (incoherent
    # bundles degrade to more steps, not to dropped hits).
    entry = jnp.where(may_hit, jnp.maximum(t_enter, 0.0), jnp.inf)
    chunk = min(cluster_chunk, clusters.num_clusters)
    k = ((clusters.num_clusters + chunk - 1) // chunk) * chunk
    order = jnp.argsort(entry, axis=-1)  # [B, C] ascending
    cand_t_full = jnp.take_along_axis(entry, order, axis=-1)
    if k > clusters.num_clusters:  # pad candidate lists to the chunk multiple
        pad = k - clusters.num_clusters
        cand_t_full = jnp.concatenate(
            [cand_t_full, jnp.full((b, pad), jnp.inf)], axis=-1)
        order = jnp.concatenate(
            [order, jnp.zeros((b, pad), order.dtype)], axis=-1)
    cand_idx = order.astype(jnp.int32)
    cand_t = cand_t_full  # [B, k] ascending entry distance
    cand_count = jnp.sum(jnp.isfinite(cand_t), axis=-1)

    o_b = origins.reshape(b, bundle_size, 3)
    d_b = directions.reshape(b, bundle_size, 3)
    tmin_b = t_min.reshape(b, bundle_size)
    n_steps = k // chunk
    bi_full = jnp.arange(b)

    init = (
        jnp.zeros((b,), jnp.int32),  # step (chunk) cursor
        t_max.reshape(b, bundle_size).astype(jnp.float32),  # best t
        jnp.zeros((b, bundle_size), jnp.float32),  # u
        jnp.zeros((b, bundle_size), jnp.float32),  # v
        jnp.full((b, bundle_size), -1, jnp.int32),  # sorted-tri winner
    )

    def active(state):
        step, best_t, _, _, _ = state
        has_work = step * chunk < cand_count
        next_t = cand_t[bi_full, jnp.minimum(step * chunk, k - 1)]
        if not any_hit:
            # early out: next chunk enters beyond the worst live hit
            worst = jnp.max(best_t, axis=-1)
            has_work &= next_t <= worst
        else:
            has_work &= jnp.any(best_t >= 0.0, axis=-1)
        return has_work

    def cond(state):
        return jnp.any(active(state))

    def body(state):
        step, best_t, best_u, best_v, best_tri = state
        live = active(state)
        base = jnp.minimum(step * chunk, k - chunk)
        # gather this chunk's clusters: [B, chunk]
        ci = cand_idx[bi_full[:, None], base[:, None]
                      + jnp.arange(chunk)[None, :]]
        # fuse the chunk into one wide matmul block [B, 4, chunk*3S]
        wald = (clusters.wald[ci]  # [B, chunk, 4, 3S]
                .transpose(0, 2, 1, 3).reshape(b, 4, chunk * 3 * s))
        tri_ids = clusters.tri_index[ci].reshape(b, chunk * s)

        hit, t, u, v = jax.vmap(intersect_cluster_block)(
            o_b, d_b, wald, tmin_b, best_t)
        hit &= (tri_ids >= 0)[:, None, :]
        hit &= live[:, None, None]

        if any_hit:
            blocked = jnp.any(hit, axis=-1)  # [B, R]
            best_tri = jnp.where(blocked & (best_tri < 0), 0x7FFFFFFF,
                                 best_tri)
            best_t = jnp.where(blocked, -1.0, best_t)
        else:
            t_masked = jnp.where(hit, t, jnp.inf)
            arg = jnp.argmin(t_masked, axis=-1)  # [B, R]
            bi = bi_full[:, None]
            ri = jnp.arange(bundle_size)[None, :]
            tbest = t_masked[bi, ri, arg]
            better = tbest < best_t
            best_t = jnp.where(better, tbest, best_t)
            best_u = jnp.where(better, u[bi, ri, arg], best_u)
            best_v = jnp.where(better, v[bi, ri, arg], best_v)
            best_tri = jnp.where(better, tri_ids[bi, arg], best_tri)

        step = step + live.astype(jnp.int32)
        return step, best_t, best_u, best_v, best_tri

    _, best_t, best_u, best_v, best_tri = jax.lax.while_loop(
        cond, body, init)
    return (best_t.reshape(-1), best_u.reshape(-1), best_v.reshape(-1),
            best_tri.reshape(-1), overflowed)


def _bundle_candidate_counts(origins, directions, t_max, clusters,
                             bundle_size) -> jax.Array:
    """[B] number of clusters each bundle's frustum may touch (cheap pre-pass
    reusing the conservative overlap test)."""
    o_min, o_max, inv_lo, inv_hi, bundle_tmax = _bundle_bounds(
        origins, directions, t_max, bundle_size)
    may_hit, _ = bundle_cluster_overlap(
        o_min, o_max, inv_lo, inv_hi, bundle_tmax,
        clusters.aabb_min, clusters.aabb_max)
    return jnp.sum(may_hit, axis=-1).astype(jnp.int32)


def _trace_batched(origins, directions, t_min, t_max, clusters,
                   max_candidates, bundle_size, any_hit,
                   ray_batch: int = RAY_BATCH,
                   cluster_chunk: int = CLUSTER_CHUNK):
    """Work-efficient dispatch: bundles are sorted by candidate count, then
    sliced into fixed ray batches for lax.map. Each batch's while_loop stops
    at ITS worst bundle, so light batches (sky, simple geometry) retire in a
    few steps while only the genuinely deep batches walk long candidate
    lists — total work tracks the SUM of per-bundle candidates instead of
    batch-count times the global maximum. Also bounds the all-pairs
    intermediates to O(ray_batch * chunk * cluster_size)."""
    n = origins.shape[0]
    pad = (-n) % bundle_size
    if pad:
        origins = jnp.concatenate([origins, jnp.zeros((pad, 3))])
        directions = jnp.concatenate(
            [directions, jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (pad, 1))])
        t_min = jnp.concatenate([t_min, jnp.zeros((pad,))])
        t_max = jnp.concatenate([t_max, jnp.full((pad,), -1.0)])
    n_padded = origins.shape[0]

    batch = min(ray_batch, n_padded)
    batch = max((batch // bundle_size) * bundle_size, bundle_size)
    nb = (n_padded + batch - 1) // batch

    # sort bundles by workload (skip when everything fits in one batch)
    if nb > 1:
        counts = _bundle_candidate_counts(
            origins, directions, t_max, clusters, bundle_size)
        bundle_order = jnp.argsort(counts)
        ray_perm = (bundle_order[:, None] * bundle_size
                    + jnp.arange(bundle_size)[None, :]).reshape(-1)
        origins = origins[ray_perm]
        directions = directions[ray_perm]
        t_min = t_min[ray_perm]
        t_max = t_max[ray_perm]

    pad2 = nb * batch - n_padded
    if pad2:
        origins = jnp.concatenate([origins, jnp.zeros((pad2, 3))])
        directions = jnp.concatenate(
            [directions, jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (pad2, 1))])
        t_min = jnp.concatenate([t_min, jnp.zeros((pad2,))])
        t_max = jnp.concatenate([t_max, jnp.full((pad2,), -1.0)])

    def one(slice_args):
        o, d, tn, tx = slice_args
        bt, u, v, tri, _ = _trace_bundles(
            o, d, tn, tx, clusters, max_candidates, bundle_size, any_hit,
            cluster_chunk)
        return bt, u, v, tri

    if nb == 1:
        bt, u, v, tri = one((origins, directions, t_min, t_max))
    else:
        bt, u, v, tri = jax.lax.map(
            one, (origins.reshape(nb, batch, 3),
                  directions.reshape(nb, batch, 3),
                  t_min.reshape(nb, batch), t_max.reshape(nb, batch)))
        bt = bt.reshape(-1)[:n_padded]
        u = u.reshape(-1)[:n_padded]
        v = v.reshape(-1)[:n_padded]
        tri = tri.reshape(-1)[:n_padded]
        inv = jnp.argsort(ray_perm)
        bt = bt[inv]
        u = u[inv]
        v = v[inv]
        tri = tri[inv]
    return bt[:n], u[:n], v[:n], tri[:n], jnp.asarray(False)


@partial(jax.jit, static_argnames=("bundle_size", "max_candidates",
                                   "sort_rays", "cluster_chunk"))
def closest_hit_bundle(
    clusters: Clusters,
    tri_geometry: jax.Array,
    tri_primitive: jax.Array,
    origins: jax.Array,
    directions: jax.Array,
    t_min,
    t_max,
    scene_min: jax.Array,
    scene_max: jax.Array,
    bundle_size: int = BUNDLE_SIZE,
    max_candidates: int = MAX_CANDIDATES,
    sort_rays: bool = False,
    cluster_chunk: int = CLUSTER_CHUNK,
) -> HitRecord:
    """Closest-hit for a ray batch [N]. Set sort_rays=True for incoherent
    batches (bounce / light rays)."""
    n_orig = origins.shape[0]
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (n_orig,))
    t_max_a = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n_orig,))

    if sort_rays:
        perm = sort_rays_for_coherence(origins, directions,
                                       scene_min, scene_max)
        inv_perm = jnp.argsort(perm)
        origins = origins[perm]
        directions = directions[perm]
        t_min_s = t_min[perm]
        t_max_s = t_max_a[perm]
    else:
        t_min_s, t_max_s = t_min, t_max_a

    best_t, u, v, tri, _ = _trace_batched(
        origins, directions, t_min_s, t_max_s, clusters, max_candidates,
        bundle_size, any_hit=False, cluster_chunk=cluster_chunk)
    if sort_rays:
        best_t = best_t[inv_perm]
        u = u[inv_perm]
        v = v[inv_perm]
        tri = tri[inv_perm]

    missed = tri < 0
    safe = jnp.maximum(tri, 0)
    geom = jnp.where(missed, INVALID_INDEX,
                     tri_geometry[safe].astype(jnp.uint32))
    prim = jnp.where(missed, jnp.uint32(0),
                     tri_primitive[safe].astype(jnp.uint32))
    return HitRecord(
        t=jnp.where(missed, t_max_a, best_t), u=u, v=v,
        geometry_index=geom, primitive_id=prim, triangle_index=tri)


@partial(jax.jit, static_argnames=("bundle_size", "max_candidates",
                                   "sort_rays", "cluster_chunk"))
def occluded_bundle(
    clusters: Clusters,
    origins: jax.Array,
    directions: jax.Array,
    t_min,
    t_max,
    scene_min: jax.Array,
    scene_max: jax.Array,
    bundle_size: int = BUNDLE_SIZE,
    max_candidates: int = MAX_CANDIDATES,
    sort_rays: bool = True,
    cluster_chunk: int = CLUSTER_CHUNK,
) -> jax.Array:
    """Any-hit visibility batch: True where blocked."""
    n_orig = origins.shape[0]
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (n_orig,))
    t_max_a = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n_orig,))

    if sort_rays:
        perm = sort_rays_for_coherence(origins, directions,
                                       scene_min, scene_max)
        inv_perm = jnp.argsort(perm)
        origins = origins[perm]
        directions = directions[perm]
        t_min_s = t_min[perm]
        t_max_s = t_max_a[perm]
    else:
        t_min_s, t_max_s = t_min, t_max_a

    _, _, _, tri, _ = _trace_batched(
        origins, directions, t_min_s, t_max_s, clusters, max_candidates,
        bundle_size, any_hit=True, cluster_chunk=cluster_chunk)
    blocked = tri >= 0
    if sort_rays:
        blocked = blocked[inv_perm]
    return blocked
