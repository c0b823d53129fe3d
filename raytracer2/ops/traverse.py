"""BVH traversal: closest-hit and any-hit queries over the LBVH.

Replaces traceRayEXT (the hardware traversal the reference gets from Vulkan,
RtxdiApplicationBridge.glsl:74-81). Design per SURVEY.md §7 step 3: a
short-stack `lax.while_loop` per ray over the SoA node arrays, vmapped across
the ray batch — XLA batches the loop with masked lanes, so wall-clock per
step is set by the deepest surviving ray (ray sorting/compaction is the
planned optimization lever).

Returns exactly the reference's payload (t, u, v, geometryIndex, primitiveId;
common.glsl:23-28), INVALID on miss.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from raytracer2.ops.bvh import BVH
from raytracer2.ops.intersect import (
    INVALID_INDEX, HitRecord, moller_trumbore, safe_inv_dir)

STACK_SIZE = 64  # checked against BVH.max_depth at trace setup


def _traverse_one_closest(
    origin, direction, t_min, t_max,
    left, right, aabb_min, aabb_max, tri_order,
    tri_v0, tri_edge1, tri_edge2, n_leaves,
):
    """Single-ray closest-hit; vmapped by `closest_hit`."""
    inv_dir = safe_inv_dir(direction)
    n_internal = n_leaves - 1

    def slab(node, upper):
        bmin = aabb_min[node]
        bmax = aabb_max[node]
        t0 = (bmin - origin) * inv_dir
        t1 = (bmax - origin) * inv_dir
        near = jnp.max(jnp.minimum(t0, t1))
        far = jnp.min(jnp.maximum(t0, t1))
        return (near <= far) & (far >= t_min) & (near <= upper), near

    stack = jnp.zeros((STACK_SIZE,), jnp.int32)
    # state: (sp, stack, best_t, best_u, best_v, best_leaf)
    state = (jnp.int32(1), stack.at[0].set(0), t_max,
             jnp.float32(0.0), jnp.float32(0.0), jnp.int32(-1))

    def cond(state):
        sp = state[0]
        return sp > 0

    def body(state):
        sp, stack, best_t, best_u, best_v, best_leaf = state
        sp = sp - 1
        node = stack[sp]

        is_leaf = node >= n_internal

        # --- leaf: intersect its triangle
        leaf_id = jnp.maximum(node - n_internal, 0)
        tri = tri_order[leaf_id]
        hit, t, u, v = moller_trumbore(
            origin, direction, tri_v0[tri], tri_edge1[tri], tri_edge2[tri],
            t_min, best_t)
        take = is_leaf & hit
        best_u = jnp.where(take, u, best_u)
        best_v = jnp.where(take, v, best_v)
        best_leaf = jnp.where(take, leaf_id, best_leaf)
        best_t = jnp.where(take, t, best_t)

        # --- internal: push children that pass the slab test, near first
        node_i = jnp.minimum(node, n_internal - 1)
        lc = left[node_i]
        rc = right[node_i]
        lhit, lnear = slab(lc, best_t)
        rhit, rnear = slab(rc, best_t)
        lhit = lhit & ~is_leaf
        rhit = rhit & ~is_leaf
        # order: push far child first so near pops first
        swap = rnear < lnear
        first = jnp.where(swap, rc, lc)
        first_hit = jnp.where(swap, rhit, lhit)
        second = jnp.where(swap, lc, rc)
        second_hit = jnp.where(swap, lhit, rhit)

        stack = stack.at[sp].set(jnp.where(second_hit, second, stack[sp]))
        sp = sp + second_hit.astype(jnp.int32)
        sp_c = jnp.minimum(sp, STACK_SIZE - 1)
        stack = stack.at[sp_c].set(jnp.where(first_hit, first, stack[sp_c]))
        sp = sp + first_hit.astype(jnp.int32)
        sp = jnp.minimum(sp, STACK_SIZE - 1)

        return sp, stack, best_t, best_u, best_v, best_leaf

    _, _, best_t, best_u, best_v, best_leaf = jax.lax.while_loop(
        cond, body, state)
    return best_t, best_u, best_v, best_leaf


def closest_hit(bvh: BVH, tri_v0: jax.Array, tri_edge1: jax.Array,
                tri_edge2: jax.Array, tri_geometry: jax.Array,
                tri_primitive: jax.Array, origins: jax.Array,
                directions: jax.Array, t_min, t_max) -> HitRecord:
    """Closest-hit query for a ray batch [N, 3] -> HitRecord."""
    n = origins.shape[0]
    t_min_a = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (n,))
    t_max_a = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))

    fn = partial(
        _traverse_one_closest,
        left=bvh.left, right=bvh.right,
        aabb_min=bvh.aabb_min, aabb_max=bvh.aabb_max,
        tri_order=bvh.tri_order,
        tri_v0=tri_v0, tri_edge1=tri_edge1, tri_edge2=tri_edge2,
        n_leaves=bvh.num_leaves)
    best_t, best_u, best_v, best_leaf = jax.vmap(fn)(
        origins, directions, t_min_a, t_max_a)

    missed = best_leaf < 0
    tri = bvh.tri_order[jnp.maximum(best_leaf, 0)]
    geom = jnp.where(missed, INVALID_INDEX,
                     tri_geometry[tri].astype(jnp.uint32))
    prim = jnp.where(missed, jnp.uint32(0),
                     tri_primitive[tri].astype(jnp.uint32))
    return HitRecord(
        t=jnp.where(missed, t_max_a, best_t), u=best_u, v=best_v,
        geometry_index=geom, primitive_id=prim,
        triangle_index=jnp.where(missed, -1, tri))


def _traverse_one_any(
    origin, direction, t_min, t_max,
    left, right, aabb_min, aabb_max, tri_order,
    tri_v0, tri_edge1, tri_edge2, n_leaves,
):
    """Single-ray any-hit (early-out visibility); vmapped by `occluded`."""
    inv_dir = safe_inv_dir(direction)
    n_internal = n_leaves - 1

    def slab(node):
        bmin = aabb_min[node]
        bmax = aabb_max[node]
        t0 = (bmin - origin) * inv_dir
        t1 = (bmax - origin) * inv_dir
        near = jnp.max(jnp.minimum(t0, t1))
        far = jnp.min(jnp.maximum(t0, t1))
        return (near <= far) & (far >= t_min) & (near <= t_max)

    stack = jnp.zeros((STACK_SIZE,), jnp.int32)
    state = (jnp.int32(1), stack.at[0].set(0), jnp.bool_(False))

    def cond(state):
        sp, _, blocked = state
        return (sp > 0) & ~blocked

    def body(state):
        sp, stack, blocked = state
        sp = sp - 1
        node = stack[sp]
        is_leaf = node >= n_internal

        leaf_id = jnp.maximum(node - n_internal, 0)
        tri = tri_order[leaf_id]
        hit, _, _, _ = moller_trumbore(
            origin, direction, tri_v0[tri], tri_edge1[tri], tri_edge2[tri],
            t_min, t_max)
        blocked = blocked | (is_leaf & hit)

        node_i = jnp.minimum(node, n_internal - 1)
        lc = left[node_i]
        rc = right[node_i]
        lhit = slab(lc) & ~is_leaf
        rhit = slab(rc) & ~is_leaf
        stack = stack.at[sp].set(jnp.where(rhit, rc, stack[sp]))
        sp = sp + rhit.astype(jnp.int32)
        sp_c = jnp.minimum(sp, STACK_SIZE - 1)
        stack = stack.at[sp_c].set(jnp.where(lhit, lc, stack[sp_c]))
        sp = sp + lhit.astype(jnp.int32)
        sp = jnp.minimum(sp, STACK_SIZE - 1)
        return sp, stack, blocked

    _, _, blocked = jax.lax.while_loop(cond, body, state)
    return blocked


def occluded(bvh: BVH, tri_v0: jax.Array, tri_edge1: jax.Array,
             tri_edge2: jax.Array, origins: jax.Array,
             directions: jax.Array, t_min, t_max) -> jax.Array:
    """Any-hit visibility batch query: True where blocked."""
    n = origins.shape[0]
    t_min_a = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (n,))
    t_max_a = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    fn = partial(
        _traverse_one_any,
        left=bvh.left, right=bvh.right,
        aabb_min=bvh.aabb_min, aabb_max=bvh.aabb_max,
        tri_order=bvh.tri_order,
        tri_v0=tri_v0, tri_edge1=tri_edge1, tri_edge2=tri_edge2,
        n_leaves=bvh.num_leaves)
    return jax.vmap(fn)(origins, directions, t_min_a, t_max_a)
