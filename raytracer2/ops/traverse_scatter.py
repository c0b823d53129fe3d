"""Scatter traversal: per-ray exact culling + ray-binning over superclusters.

Second XLA ray-casting engine, complementary to ops/traverse_bundle:
instead of amortizing culling over ray bundles (which needs coherence), every
ray is culled EXACTLY against supercluster AABBs, and the surviving
(ray, supercluster) pairs are binned BY SUPERCLUSTER so that each fixed-size
work block intersects P rays against one supercluster's triangle block —
triangle data is gathered once per block instead of once per ray, and ray
records (32 B) are the only per-pair gather. Incoherent bounce/visibility
rays cost the same as primaries.

Pipeline (all dense, jit-compatible):
1. slab-test each ray against every supercluster (chunk-sized [n, C2] map);
2. counts -> padded per-supercluster offsets (cumsum) -> scatter pair lists
   grouped by supercluster, padded to the block size;
3. one vmapped intersection sweep over [blocks, P rays, G*S tris] using the
   Wald unit-triangle FMAs (ops/cluster.py);
4. segment-min the pair results back onto rays (order-preserving float bits);
5. one final per-ray re-evaluation of the winning triangle for exact (t,u,v).

Capacity: the pair pool is sized by AVG_CANDIDATES x rays (a global average,
not a per-ray bound); `overflowed` reports true if the pool was exceeded
(pairs dropped -> possible missed hits). Tests pick capacities that never
overflow; production telemetry should watch the flag.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from raytracer2.ops.cluster import Clusters
from raytracer2.ops.intersect import INVALID_INDEX, HitRecord

PAIR_BLOCK = 128  # rays per work block
AVG_CANDIDATES = 16  # pair-pool size = rays * this
RAY_BATCH = 131072  # rays per dispatch slice


class SuperClusters(NamedTuple):
    """Clusters regrouped into G-cluster superclusters (host build)."""

    aabb_min: jax.Array  # [C2, 3]
    aabb_max: jax.Array  # [C2, 3]
    wald: jax.Array  # [C2, 4, G*3*S]
    tri_index: jax.Array  # [C2, G*S]
    tri_wald: jax.Array  # [T, 4, 3] per-triangle transform (final re-eval)

    @property
    def num_superclusters(self) -> int:
        return self.aabb_min.shape[0]

    @property
    def tris_per_group(self) -> int:
        return self.tri_index.shape[1]


def build_superclusters(clusters: Clusters, group: int = 16
                        ) -> SuperClusters:
    """Regroup a Clusters structure into supercluster blocks."""
    c = clusters.num_clusters
    s = clusters.cluster_size
    pad = (-c) % group
    amin = np.asarray(clusters.aabb_min)
    amax = np.asarray(clusters.aabb_max)
    wald = np.asarray(clusters.wald)
    tri = np.asarray(clusters.tri_index)
    if pad:
        amin = np.concatenate([amin, np.full((pad, 3), 1e30, np.float32)])
        amax = np.concatenate([amax, np.full((pad, 3), -1e30, np.float32)])
        wald = np.concatenate(
            [wald, np.zeros((pad,) + wald.shape[1:], np.float32)])
        tri = np.concatenate([tri, np.full((pad, s), -1, np.int32)])
    c2 = (c + pad) // group

    sc_min = amin.reshape(c2, group, 3).min(1)
    sc_max = amax.reshape(c2, group, 3).max(1)
    sc_min = np.where(sc_min > 1e29, 1e30, sc_min)
    sc_max = np.where(sc_max < -1e29, -1e30, sc_max)
    sc_wald = (wald.reshape(c2, group, 4, 3 * s)
               .transpose(0, 2, 1, 3).reshape(c2, 4, group * 3 * s))
    sc_tri = tri.reshape(c2, group * s)

    # per-triangle [4, 3] transforms for the final exact re-evaluation:
    # wald layout is [C, 4, S, 3] flattened — recover per-tri columns
    w4 = wald.reshape(-1, 4, s, 3)  # [C+pad, 4, S, 3]
    tri_wald = w4.transpose(0, 2, 1, 3).reshape(-1, 4, 3)  # [(C+pad)*S, 4, 3]
    flat_tri = tri.reshape(-1)
    n_tri = int(flat_tri.max()) + 1 if flat_tri.size else 0
    per_tri = np.zeros((max(n_tri, 1), 4, 3), np.float32)
    valid = flat_tri >= 0
    per_tri[flat_tri[valid]] = tri_wald[valid]

    return SuperClusters(
        aabb_min=jnp.asarray(sc_min, jnp.float32),
        aabb_max=jnp.asarray(sc_max, jnp.float32),
        wald=jnp.asarray(sc_wald, jnp.float32),
        tri_index=jnp.asarray(sc_tri),
        tri_wald=jnp.asarray(per_tri, jnp.float32),
    )


def _f32_sortable_bits(t: jax.Array) -> jax.Array:
    """Monotonic uint32 encoding of non-negative floats (inf-safe)."""
    return jax.lax.bitcast_convert_type(t, jnp.uint32)


def _ray_sc_overlap(origins, directions, t_min, t_max, sc: SuperClusters):
    """Exact per-ray slab test vs every supercluster: [n, C2] mask."""
    eps = 1e-12
    d = jnp.where(jnp.abs(directions) < eps,
                  jnp.where(directions >= 0, eps, -eps), directions)
    inv = 1.0 / d  # [n, 3]
    t0 = (sc.aabb_min[None] - origins[:, None]) * inv[:, None]
    t1 = (sc.aabb_max[None] - origins[:, None]) * inv[:, None]
    near = jnp.max(jnp.minimum(t0, t1), axis=-1)  # [n, C2]
    far = jnp.min(jnp.maximum(t0, t1), axis=-1)
    hit = ((near <= far) & (far >= t_min[:, None])
           & (near <= t_max[:, None]) & (t_max >= 0.0)[:, None])
    return hit


def _trace_scatter_batch(origins, directions, t_min, t_max,
                         sc: SuperClusters, avg_candidates: int,
                         any_hit: bool):
    """One ray batch through the scatter pipeline. Returns per-ray
    (t_bits_best, blocked, overflow).

    Binning is gather-only: per-ray top-K candidate superclusters (nearest
    entry first), one sort of the n*K pair keys, then every padded pair slot
    PULLS its (ray, sc) from the sorted list instead of a scatter of tens
    of millions of elements."""
    n = origins.shape[0]
    c2 = sc.num_superclusters
    p = PAIR_BLOCK
    k_cand = min(avg_candidates, c2)

    mask = _ray_sc_overlap(origins, directions, t_min, t_max, sc)  # [n, C2]

    # entry distance for nearest-first truncation when a ray exceeds K
    eps = 1e-12
    d_safe = jnp.where(jnp.abs(directions) < eps,
                       jnp.where(directions >= 0, eps, -eps), directions)
    inv = 1.0 / d_safe
    t0 = (sc.aabb_min[None] - origins[:, None]) * inv[:, None]
    t1 = (sc.aabb_max[None] - origins[:, None]) * inv[:, None]
    near = jnp.maximum(jnp.max(jnp.minimum(t0, t1), axis=-1), 0.0)
    entry = jnp.where(mask, near, jnp.inf)  # [n, C2]

    overflow = jnp.any(jnp.sum(mask, axis=-1) > k_cand)

    neg_entry, cand_sc = jax.lax.top_k(-entry, k_cand)  # [n, K]
    cand_live = jnp.isfinite(neg_entry)

    # sort the n*K pairs by supercluster id (dead pairs last)
    flat_sc = jnp.where(cand_live, cand_sc, c2).astype(jnp.uint32).reshape(-1)
    order = jnp.argsort(flat_sc)  # [n*K]
    sorted_sc = flat_sc[order]
    sorted_ray = (jnp.arange(n * k_cand, dtype=jnp.int32) // k_cand)[order]

    # per-supercluster counts -> padded slot layout (all tiny [C2] math)
    count_sc = jnp.bincount(jnp.minimum(sorted_sc, c2), length=c2 + 1)[:c2]
    base_sc = jnp.concatenate(
        [jnp.zeros((1,), count_sc.dtype), jnp.cumsum(count_sc)[:-1]])
    padded_sc = ((count_sc + p - 1) // p) * p
    padded_cum = jnp.cumsum(padded_sc)
    padded_base = padded_cum - padded_sc
    total_needed = padded_cum[-1] if c2 else 0

    tp = ((n * k_cand + c2 * p) // p) * p  # static pool size (worst case)
    overflow |= total_needed > tp

    # each padded slot pulls its pair from the sorted list (gather-only)
    slots = jnp.arange(tp, dtype=jnp.int32)
    slot_sc = jnp.searchsorted(padded_cum, slots,
                               side="right").astype(jnp.int32)
    slot_sc = jnp.minimum(slot_sc, c2 - 1)
    src = slots - padded_base[slot_sc] + base_sc[slot_sc].astype(jnp.int32)
    in_range = (slots < total_needed) & (
        src < (base_sc[slot_sc] + count_sc[slot_sc]).astype(jnp.int32))
    src = jnp.clip(src, 0, n * k_cand - 1)
    pair_ray = jnp.where(in_range, sorted_ray[src], -1)

    block_sc = slot_sc.reshape(-1, p)[:, 0]

    live = pair_ray >= 0
    safe_ray = jnp.maximum(pair_ray, 0)

    def intersect_block(o, d, wald, tri_ids, tmin_b, tcap_b):
        from raytracer2.ops.cluster import intersect_cluster_block

        hit, t, u, v = intersect_cluster_block(o, d, wald, tmin_b, tcap_b)
        hit &= (tri_ids >= 0)[None, :]
        t = jnp.where(hit, t, jnp.inf)
        best = jnp.argmin(t, axis=-1)  # [P]
        rows = jnp.arange(o.shape[0])
        return (t[rows, best],
                jnp.where(jnp.isfinite(t[rows, best]),
                          tri_ids[best], -1))

    # Chunk the [blocks, P, G*S] sweep so the per-step intermediates stay
    # bounded (~16M lanes); an unchunked vmap materializes the whole
    # [blocks, P, G*S, 3] Wald product in device memory and OOMs at
    # scale.
    nblk = tp // p
    gs = sc.tris_per_group
    chunk = max(1, min(nblk, (1 << 24) // max(p * gs, 1)))
    nchunks = (nblk + chunk - 1) // chunk
    pad_blk = nchunks * chunk - nblk
    ray_mat = safe_ray.reshape(nblk, p)
    live_mat = live.reshape(nblk, p)
    bsc = block_sc
    if pad_blk:
        ray_mat = jnp.concatenate(
            [ray_mat, jnp.zeros((pad_blk, p), ray_mat.dtype)])
        live_mat = jnp.concatenate(
            [live_mat, jnp.zeros((pad_blk, p), bool)])
        bsc = jnp.concatenate([bsc, jnp.zeros((pad_blk,), bsc.dtype)])

    def sweep_chunk(args):
        rays_c, live_c, bsc_c = args  # [chunk, P], [chunk, P], [chunk]
        po = origins[rays_c]  # [chunk, P, 3]
        pd = directions[rays_c]
        ptmin = jnp.where(live_c, t_min[rays_c], 0.0)
        ptmax = jnp.where(live_c, t_max[rays_c], -1.0)
        wald_c = sc.wald[bsc_c]  # [chunk, 4, G*3*S]
        tri_c = sc.tri_index[bsc_c]  # [chunk, G*S]
        return jax.vmap(intersect_block)(po, pd, wald_c, tri_c, ptmin, ptmax)

    t_pair, tri_pair = jax.lax.map(
        sweep_chunk, (ray_mat.reshape(nchunks, chunk, p),
                      live_mat.reshape(nchunks, chunk, p),
                      bsc.reshape(nchunks, chunk)))
    t_pair = t_pair.reshape(-1)[:tp]
    tri_pair = tri_pair.reshape(-1)[:tp]
    hit_pair = (tri_pair >= 0) & live

    if any_hit:
        blocked = jnp.zeros((n,), bool).at[safe_ray].max(
            hit_pair, mode="drop")
        return None, None, blocked, overflow

    # segment-min via order-preserving bits
    key = jnp.where(hit_pair, _f32_sortable_bits(t_pair),
                    jnp.uint32(0xFFFFFFFF))
    best_key = jnp.full((n,), 0xFFFFFFFF, jnp.uint32).at[safe_ray].min(
        key, mode="drop")
    win = hit_pair & (key == best_key[safe_ray])
    best_tri = jnp.full((n,), jnp.iinfo(jnp.int32).max, jnp.int32
                        ).at[safe_ray].min(
        jnp.where(win, tri_pair, jnp.iinfo(jnp.int32).max), mode="drop")
    missed = best_key == jnp.uint32(0xFFFFFFFF)
    best_tri = jnp.where(missed, -1, best_tri)
    return best_tri, missed, None, overflow


@partial(jax.jit, static_argnames=("avg_candidates", "ray_batch"))
def closest_hit_scatter(
    sc: SuperClusters,
    tri_geometry: jax.Array,
    tri_primitive: jax.Array,
    origins: jax.Array,
    directions: jax.Array,
    t_min,
    t_max,
    avg_candidates: int = AVG_CANDIDATES,
    ray_batch: int = RAY_BATCH,
) -> HitRecord:
    n = origins.shape[0]
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (n,))
    t_max_a = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))

    batch = min(ray_batch, n)
    pad = (-n) % batch
    o = jnp.concatenate([origins, jnp.zeros((pad, 3))]) if pad else origins
    d = (jnp.concatenate([directions,
                          jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (pad, 1))])
         if pad else directions)
    tn = jnp.concatenate([t_min, jnp.zeros((pad,))]) if pad else t_min
    tx = (jnp.concatenate([t_max_a, jnp.full((pad,), -1.0)])
          if pad else t_max_a)
    nb = o.shape[0] // batch

    def one(args):
        oo, dd, tnn, txx = args
        tri, missed, _, _ = _trace_scatter_batch(
            oo, dd, tnn, txx, sc, avg_candidates, any_hit=False)
        return tri, missed

    if nb == 1:
        tri, missed = one((o, d, tn, tx))
    else:
        tri, missed = jax.lax.map(
            one, (o.reshape(nb, batch, 3), d.reshape(nb, batch, 3),
                  tn.reshape(nb, batch), tx.reshape(nb, batch)))
        tri = tri.reshape(-1)
        missed = missed.reshape(-1)
    tri = tri[:n]
    missed = missed[:n]

    # exact (t, u, v) by re-evaluating the winning triangle per ray
    safe_tri = jnp.maximum(tri, 0)
    w = sc.tri_wald[safe_tri]  # [n, 4, 3]
    op = (origins[:, 0:1] * w[:, 0] + origins[:, 1:2] * w[:, 1]
          + origins[:, 2:3] * w[:, 2] + w[:, 3])
    dp = (directions[:, 0:1] * w[:, 0] + directions[:, 1:2] * w[:, 1]
          + directions[:, 2:3] * w[:, 2])
    dz = jnp.where(jnp.abs(dp[:, 2]) > 1e-12, dp[:, 2], 1.0)
    t = -op[:, 2] / dz
    u = op[:, 0] + t * dp[:, 0]
    v = op[:, 1] + t * dp[:, 1]

    geom = jnp.where(missed, INVALID_INDEX,
                     tri_geometry[safe_tri].astype(jnp.uint32))
    prim = jnp.where(missed, jnp.uint32(0),
                     tri_primitive[safe_tri].astype(jnp.uint32))
    return HitRecord(
        t=jnp.where(missed, t_max_a, t),
        u=jnp.where(missed, 0.0, u),
        v=jnp.where(missed, 0.0, v),
        geometry_index=geom, primitive_id=prim, triangle_index=tri)


@partial(jax.jit, static_argnames=("avg_candidates", "ray_batch"))
def occluded_scatter(
    sc: SuperClusters,
    origins: jax.Array,
    directions: jax.Array,
    t_min,
    t_max,
    avg_candidates: int = AVG_CANDIDATES,
    ray_batch: int = RAY_BATCH,
) -> jax.Array:
    n = origins.shape[0]
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (n,))
    t_max_a = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))

    batch = min(ray_batch, n)
    pad = (-n) % batch
    o = jnp.concatenate([origins, jnp.zeros((pad, 3))]) if pad else origins
    d = (jnp.concatenate([directions,
                          jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (pad, 1))])
         if pad else directions)
    tn = jnp.concatenate([t_min, jnp.zeros((pad,))]) if pad else t_min
    tx = (jnp.concatenate([t_max_a, jnp.full((pad,), -1.0)])
          if pad else t_max_a)
    nb = o.shape[0] // batch

    def one(args):
        oo, dd, tnn, txx = args
        _, _, blocked, _ = _trace_scatter_batch(
            oo, dd, tnn, txx, sc, avg_candidates, any_hit=True)
        return blocked

    if nb == 1:
        blocked = one((o, d, tn, tx))
    else:
        blocked = jax.lax.map(
            one, (o.reshape(nb, batch, 3), d.reshape(nb, batch, 3),
                  tn.reshape(nb, batch), tx.reshape(nb, batch))).reshape(-1)
    return blocked[:n]
