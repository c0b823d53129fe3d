"""Triangle clusters + unit-triangle-space (Wald) transforms.

The acceleration structure of the bundle engine (SURVEY.md §7 'hard
parts' #1): triangles are SAH- (or morton-) ordered and chunked into
fixed-size clusters with AABBs, and intersection is reformulated as an
affine map per triangle:

For each triangle, precompute the affine map W = [A | b] that carries world
space into the triangle's unit space (v0 -> origin, edge1 -> x axis,
edge2 -> y axis, normal -> z axis). For a ray (o, d):

    o' = A @ o + b        d' = A @ d
    t  = -o'_z / d'_z     u = o'_x + t * d'_x     v = o'_y + t * d'_y

For a block of R rays against a cluster of T triangles both o' and d' are
a K=4 contraction against one [4, 3T] block, evaluated as broadcast FMAs
in f32 (intersect_cluster_block). The hit test is then a handful of
compares.

Cluster culling uses conservative interval arithmetic over ray *bundles*
(ops/traverse_bundle.py), so the intersection runs on dense rectangular
blocks.
"""

from __future__ import annotations

from typing import NamedTuple

import logging

import jax
import jax.numpy as jnp
import numpy as np

log = logging.getLogger(__name__)

# which builder the last build_clusters call used: "sah" or "morton"
last_build_method: str | None = None


class Clusters(NamedTuple):
    """Morton-ordered triangle clusters, SoA. All arrays padded so that
    num_triangles == num_clusters * cluster_size (degenerate padding)."""

    # per-cluster
    aabb_min: jax.Array  # [C, 3]
    aabb_max: jax.Array  # [C, 3]
    # per (padded, sorted) triangle
    wald: jax.Array  # [C, 4, 3*S]: the [A|b]^T blocks, matmul-ready
    tri_index: jax.Array  # [C, S] int32 original triangle id (-1 = pad)

    @property
    def num_clusters(self) -> int:
        return self.aabb_min.shape[0]

    @property
    def cluster_size(self) -> int:
        return self.tri_index.shape[1]


def _wald_matrices(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray
                   ) -> np.ndarray:
    """[T, 3, 4] affine world->unit-triangle maps (rows: u, v, z planes)."""
    t = v0.shape[0]
    n = np.cross(e1, e2)
    m = np.stack([e1, e2, n], axis=-1)  # [T, 3, 3] columns = basis
    # robust inverse: degenerate triangles get zero maps (never hit)
    det = np.linalg.det(m)
    good = np.abs(det) > 1e-20
    m_safe = np.where(good[:, None, None], m, np.eye(3)[None])
    inv = np.linalg.inv(m_safe)
    inv = np.where(good[:, None, None], inv, 0.0)
    b = -np.einsum("tij,tj->ti", inv, v0)
    out = np.zeros((t, 3, 4), np.float32)
    out[:, :, :3] = inv
    out[:, :, 3] = b
    return out


def _morton_order(centroid: np.ndarray) -> np.ndarray:
    lo = centroid.min(0)
    extent = np.maximum(centroid.max(0) - lo, 1e-12)
    cells = np.clip(((centroid - lo) / extent) * 1024.0, 0,
                    1023.999).astype(np.uint32)

    def expand(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & 0x0000FFFF0000FFFF
        v = (v | (v << 8)) & 0x00FF00FF00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0F
        v = (v | (v << 2)) & 0x3333333333333333
        v = (v | (v << 1)) & 0x5555555555555555
        return v

    codes = (expand(cells[:, 0]) << 2) | (expand(cells[:, 1]) << 1) \
        | expand(cells[:, 2])
    return np.argsort(codes, kind="stable").astype(np.int32)


def build_clusters(tri_v0, tri_edge1, tri_edge2,
                   cluster_size: int = 64,
                   method: str = "auto") -> Clusters:
    """Host-side build (numpy/C++; scenes are static like the reference's
    one-time BLAS build). method: "sah" (native binned-SAH builder,
    csrc/cluster_builder.cpp — tighter boxes, fewer candidates per bundle),
    "morton" (pure-numpy fallback), "auto" (sah when the native lib loads).
    """
    v0 = np.asarray(tri_v0, np.float64)
    e1 = np.asarray(tri_edge1, np.float64)
    e2 = np.asarray(tri_edge2, np.float64)
    t = v0.shape[0]

    v1 = v0 + e1
    v2 = v0 + e2
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    centroid = 0.5 * (tmin + tmax)

    # --- choose a triangle order + cluster ranges -------------------------
    ranges = None
    if method in ("auto", "sah") and t > 0:
        from raytracer2.ops import native

        sah = native.build_sah_clusters(
            v0.astype(np.float32), e1.astype(np.float32),
            e2.astype(np.float32), cluster_size)
        if sah is not None:
            order, offsets, counts = sah
            ranges = list(zip(offsets.tolist(), counts.tolist()))
        elif method == "sah":
            raise RuntimeError("native SAH builder unavailable")
        else:
            log.warning("native SAH builder unavailable; clustering %d "
                        "triangles in morton order", t)
    global last_build_method
    last_build_method = "morton" if ranges is None else "sah"
    if ranges is None:
        order = _morton_order(centroid) if t else np.zeros(0, np.int32)
        ranges = [(i, min(cluster_size, t - i))
                  for i in range(0, t, cluster_size)]

    c = max(len(ranges), 1)
    n_padded = c * cluster_size

    # scatter the ordered triangles into fixed-stride cluster rows
    tri_index = np.full(n_padded, -1, np.int32)
    src = np.zeros(n_padded, np.int64)  # index into `order`
    valid = np.zeros(n_padded, bool)
    for ci, (start, count) in enumerate(ranges):
        row = ci * cluster_size
        tri_index[row:row + count] = order[start:start + count]
        src[row:row + count] = np.arange(start, start + count)
        valid[row:row + count] = True

    def take(arr, fill):
        out = np.full((n_padded, 3), fill, np.float64)
        out[valid] = arr[order[src[valid]]]
        return out

    sv0 = take(v0, 0.0)
    se1 = take(e1, 0.0)
    se2 = take(e2, 0.0)
    stmin = take(tmin, np.inf)
    stmax = take(tmax, -np.inf)

    aabb_min = stmin.reshape(c, cluster_size, 3).min(1)
    aabb_max = stmax.reshape(c, cluster_size, 3).max(1)
    # empty (all-pad) clusters get never-hit boxes
    aabb_min = np.where(np.isfinite(aabb_min), aabb_min, 1e30)
    aabb_max = np.where(np.isfinite(aabb_max), aabb_max, -1e30)

    wald = _wald_matrices(sv0, se1, se2)  # [n_padded, 3, 4]
    # layout: per cluster, one [4, 3S] block whose columns are the (u, v, z)
    # rows of each triangle: rays @ block -> [R, 3S]
    wald = (wald.reshape(c, cluster_size, 3, 4)
            .transpose(0, 3, 1, 2)  # [C, 4, S, 3]
            .reshape(c, 4, cluster_size * 3))

    return Clusters(
        aabb_min=jnp.asarray(aabb_min, jnp.float32),
        aabb_max=jnp.asarray(aabb_max, jnp.float32),
        wald=jnp.asarray(wald, jnp.float32),
        tri_index=jnp.asarray(tri_index.reshape(c, cluster_size)),
    )


def intersect_cluster_block(
    origins: jax.Array,  # [R, 3]
    directions: jax.Array,  # [R, 3]
    wald_block: jax.Array,  # [4, 3S]
    t_min: jax.Array,  # [R]
    t_cap: jax.Array,  # [R]
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """All-pairs intersection of R rays vs one cluster (two K=4
    contractions). Returns (hit [R, S], t, u, v)."""
    r = origins.shape[0]
    # K=4 contraction as four broadcast FMAs in native f32: a matrix
    # product would waste a matrix unit on K=4 and may run at reduced
    # precision (TF32), which hit distances cannot afford.
    op = (origins[:, 0:1] * wald_block[0][None]
          + origins[:, 1:2] * wald_block[1][None]
          + origins[:, 2:3] * wald_block[2][None]
          + wald_block[3][None])
    dp = (directions[:, 0:1] * wald_block[0][None]
          + directions[:, 1:2] * wald_block[1][None]
          + directions[:, 2:3] * wald_block[2][None])
    s3 = op.shape[-1]
    op = op.reshape(r, s3 // 3, 3)
    dp = dp.reshape(r, s3 // 3, 3)

    dz = dp[..., 2]
    safe_dz = jnp.where(jnp.abs(dz) > 1e-12, dz, 1.0)
    t = -op[..., 2] / safe_dz
    u = op[..., 0] + t * dp[..., 0]
    v = op[..., 1] + t * dp[..., 1]
    hit = ((jnp.abs(dz) > 1e-12)
           & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > t_min[:, None]) & (t < t_cap[:, None]))
    return hit, t, u, v


def bundle_cluster_overlap(
    o_min: jax.Array,  # [B, 3] bundle origin box
    o_max: jax.Array,
    inv_lo: jax.Array,  # [B, 3] conservative 1/d interval (lo)
    inv_hi: jax.Array,  # [B, 3] (hi); axis spans 0 -> (-inf, +inf)
    t_max: jax.Array,  # [B] max ray t in bundle
    box_min: jax.Array,  # [C, 3]
    box_max: jax.Array,  # [C, 3]
) -> tuple[jax.Array, jax.Array]:
    """Conservative bundle-vs-cluster slab test with interval arithmetic.
    Never reports a false miss. Returns (may_hit [B, C], t_enter_lo [B, C])."""

    def interval_mul(a_lo, a_hi, b_lo, b_hi):
        p1 = a_lo * b_lo
        p2 = a_lo * b_hi
        p3 = a_hi * b_lo
        p4 = a_hi * b_hi
        return (jnp.minimum(jnp.minimum(p1, p2), jnp.minimum(p3, p4)),
                jnp.maximum(jnp.maximum(p1, p2), jnp.maximum(p3, p4)))

    # plane distances as intervals: (box - o) with o in [o_min, o_max]
    # shapes: [B, 1, 3] x [1, C, 3]
    bm = box_min[None, :, :]
    bx = box_max[None, :, :]
    d0_lo = bm - o_max[:, None, :]
    d0_hi = bm - o_min[:, None, :]
    d1_lo = bx - o_max[:, None, :]
    d1_hi = bx - o_min[:, None, :]

    il = inv_lo[:, None, :]
    ih = inv_hi[:, None, :]
    t0_lo, t0_hi = interval_mul(d0_lo, d0_hi, il, ih)
    t1_lo, t1_hi = interval_mul(d1_lo, d1_hi, il, ih)

    near_lo = jnp.minimum(t0_lo, t1_lo)  # lower bound of per-axis t_near
    far_hi = jnp.maximum(t0_hi, t1_hi)  # upper bound of per-axis t_far

    # axes whose direction interval spans zero are unbounded
    unbounded = (~jnp.isfinite(il) | ~jnp.isfinite(ih))
    near_lo = jnp.where(unbounded, -jnp.inf, near_lo)
    far_hi = jnp.where(unbounded, jnp.inf, far_hi)

    t_enter_lo = jnp.max(near_lo, axis=-1)
    t_exit_hi = jnp.min(far_hi, axis=-1)
    may_hit = ((t_enter_lo <= t_exit_hi)
               & (t_exit_hi >= 0.0)
               & (t_enter_lo <= t_max[:, None]))
    return may_hit, t_enter_lo
