"""Explicit ppermute halo exchange for row-sharded image passes.

The resampling passes gather from bounded pixel stencils (GI spatial
radius 3 px, DI spatial radius 32 px — reference main.rs:264,353; temporal
reprojection is bounded by motion vectors). Under plain GSPMD those
gathers lower to full-array collectives; exchanging only the RADIUS
boundary rows between row-neighbour shards is the bandwidth-optimal
form (SURVEY.md §2.4, §5 "distributed communication backend").

Screen edges reflect, matching the reference's screen-edge clamp for
spatial neighbours (RtxdiApplicationBridge.glsl:252-265), so the first and
last shard reflect their own rows instead of wrapping around the image.

Use inside jax.shard_map over the row mesh:

    @partial(jax.shard_map, mesh=mesh, in_specs=P("rows"), out_specs=P("rows"))
    def pass_fn(tile):                     # tile: [h_local, W, ...]
        padded = exchange_row_halos(tile, radius)   # [h_local+2r, W, ...]
        return gather_rows(padded, radius, dy, dx)  # stencil reads
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raytracer2.parallel.mesh import ROW_AXIS


def _reflect_top(x: jax.Array, radius: int) -> jax.Array:
    """Rows above the image: mirror of the first rows (row r-1 .. 0)."""
    return x[:radius][::-1]


def _reflect_bottom(x: jax.Array, radius: int) -> jax.Array:
    """Rows below the image: mirror of the last rows."""
    return x[-radius:][::-1]


def local_pad_rows(x: jax.Array, radius: int) -> jax.Array:
    """Reflect-pad a tile with its OWN rows — the same shapes/compute as
    exchange_row_halos but zero communication. Wrong pixels at interior
    shard boundaries; exists so the scaling bench can measure the halo's
    true comm cost as (exchange time - local-pad time) on an otherwise
    identical program (an instrumented comm estimate of
    exactly zero is an unmeasured estimate)."""
    return jnp.concatenate(
        [_reflect_top(x, radius), x, _reflect_bottom(x, radius)], axis=0)


def exchange_row_halos(x: jax.Array, radius: int,
                       axis_name: str = ROW_AXIS) -> jax.Array:
    """Pad a per-shard row tile with RADIUS rows from each row-neighbour
    shard (reflected at the outer image edges). Must run inside shard_map
    / pmap over `axis_name`. Returns [h_local + 2*radius, ...]."""
    # a radius beyond the tile height would silently mis-align the halo:
    # the slices below clamp to h_local rows while callers compute source
    # offsets assuming full padding (ADVICE r2)
    assert radius <= x.shape[0], (
        f"halo radius {radius} exceeds the shard tile height {x.shape[0]}; "
        "use more rows per shard or a smaller stencil radius")
    n = jax.lax.axis_size(axis_name)
    if n == 1:
        return jnp.concatenate(
            [_reflect_top(x, radius), x, _reflect_bottom(x, radius)], axis=0)
    idx = jax.lax.axis_index(axis_name)

    # shard i's BOTTOM rows become shard i+1's TOP halo, and vice versa;
    # one ppermute each way between row neighbours
    down = [(i, (i + 1) % n) for i in range(n)]
    up = [(i, (i - 1) % n) for i in range(n)]
    from_above = jax.lax.ppermute(x[-radius:], axis_name, down)
    from_below = jax.lax.ppermute(x[:radius], axis_name, up)

    top = jnp.where(idx == 0, _reflect_top(x, radius), from_above)
    bottom = jnp.where(idx == n - 1, _reflect_bottom(x, radius), from_below)
    return jnp.concatenate([top, x, bottom], axis=0)


def gather_rows(padded: jax.Array, radius: int, dy: jax.Array,
                dx: jax.Array) -> jax.Array:
    """Stencil gather over a halo-padded tile: for every local pixel (y, x)
    read (y + dy, x + dx), with dy in [-radius, radius] guaranteed in-halo
    and dx clamped to the image width (the reference clamps/reflects only
    in screen space, and columns are unsharded)."""
    h = padded.shape[0] - 2 * radius
    w = padded.shape[1]
    ys = jnp.arange(h)[:, None] + radius + dy
    xs = jnp.clip(jnp.arange(w)[None, :] + dx, 0, w - 1)
    return padded[ys, xs]
