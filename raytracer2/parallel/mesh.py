"""Multi-chip execution: pixel-space sharding over a device mesh.

The reference is strictly single-GPU (SURVEY.md §2.4); this module is the
multi-device scaling story it lacks: the image/ray space is the batch
dimension, sharded by pixel ROWS over a 1-D mesh while scene arrays (BVH,
triangles, lights, textures) are replicated on every chip. Ray passes are
embarrassingly parallel; the bounded-stencil gather passes (GI spatial
radius 3 px, DI radius 32 px, temporal reprojection) compile under GSPMD,
which inserts the boundary collectives automatically; the explicit
ppermute halo exchange for those stencils lives in parallel/halo.py for
shard_map'd passes where GSPMD's choice is too coarse.

Usage:
    mesh = make_mesh()                       # all local devices
    step = make_sharded_render_fn(renderer, mesh)
    state = shard_frame_state(state, mesh)
    state, image = step(g_const, state)
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ROW_AXIS = "rows"


def make_mesh(devices=None) -> Mesh:
    """1-D mesh over pixel rows. Multi-axis (rows x cols) meshes are a
    natural extension once per-axis halos pay off."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (ROW_AXIS,))


def row_sharding(mesh: Mesh) -> NamedSharding:
    """Shard dim 0 (image rows / flattened pixel-major batches)."""
    return NamedSharding(mesh, P(ROW_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _image_leaf_sharding(leaf: jax.Array, mesh: Mesh, height: int):
    """Row-shard anything whose leading dim is the image height; replicate
    everything else (scene tables, scalars, small params)."""
    if hasattr(leaf, "shape") and leaf.ndim >= 1 and leaf.shape[0] == height:
        return row_sharding(mesh)
    return replicated(mesh)


def shard_frame_state(state, mesh: Mesh):
    """Place a FrameState pytree: [H, ...] leaves row-sharded."""
    height = state.gbuffer.depth.shape[0]
    return jax.tree_util.tree_map(
        lambda leaf: jax.device_put(
            leaf, _image_leaf_sharding(leaf, mesh, height)), state)


def make_sharded_render_fn(renderer, mesh: Mesh,
                           explicit_halo: bool = False,
                           halo_rows: int = 8,
                           halo_impl: str = "exchange") -> Callable:
    """jit the frame graph with row-sharded frame state in/out; scene and
    light resources are closed over (replicated constants folded into the
    executable).

    explicit_halo=True runs the frame inside shard_map: every device owns
    a row tile, the stencil passes exchange exactly `halo_rows` boundary
    rows with their row neighbours (parallel/halo.py ppermute)
    instead of whatever collective GSPMD infers for the whole-array
    gathers. Pixel RNG and view math stay global, so the sharded image
    matches the single-chip frame wherever temporal reprojection stays
    within halo_rows (GI spatial radius 3 always does).

    halo_impl="local" replaces the ppermute exchange with a same-shape
    reflect-pad of the tile's OWN rows — a measurement-only mode whose
    timing difference vs "exchange" is the halo's real comm cost."""
    from raytracer2.render.frame import render_frame

    height = renderer.height

    if explicit_halo:
        from raytracer2.parallel.halo import (
            exchange_row_halos, local_pad_rows)

        n = mesh.devices.size
        assert height % n == 0, "image rows must divide the mesh"
        h_local = height // n
        # a halo can only borrow from the immediate row neighbour, so the
        # radius is capped by the tile height (ppermute ships whole slabs)
        halo_rows = min(halo_rows, h_local)

        # trace-time comm telemetry: every exchanged leaf adds
        # 2 * radius boundary rows per direction pair; collected once at
        # compile and exposed as step.halo_telemetry (the scaling bench
        # carries a comm/halo-rows accounting)
        telemetry = {"halo_rows": halo_rows, "halo_exchanges": 0,
                     "halo_bytes_per_device_frame": 0}

        def halo_fn(tree, radius):
            for leaf in jax.tree_util.tree_leaves(tree):
                row_bytes = ((leaf.size // max(leaf.shape[0], 1))
                             * leaf.dtype.itemsize)
                telemetry["halo_exchanges"] += 1
                telemetry["halo_bytes_per_device_frame"] += (
                    2 * radius * row_bytes)
            pad = (local_pad_rows if halo_impl == "local"
                   else exchange_row_halos)
            return jax.tree_util.tree_map(lambda a: pad(a, radius), tree)

        def tile_step(g_const, state_tile):
            row0 = jax.lax.axis_index(ROW_AXIS) * h_local
            return render_frame(renderer, g_const, state_tile,
                                row0=row0, halo_fn=halo_fn,
                                halo_rows=halo_rows)

        def step(g_const, state):
            # reset per trace so a retrace doesn't double-count
            telemetry["halo_exchanges"] = 0
            telemetry["halo_bytes_per_device_frame"] = 0
            specs_in = jax.tree_util.tree_map(
                lambda leaf: (P(ROW_AXIS)
                              if hasattr(leaf, "ndim") and leaf.ndim >= 1
                              and leaf.shape[0] == height else P()), state)
            gspec = jax.tree_util.tree_map(lambda _: P(), g_const)
            sharded = jax.shard_map(
                tile_step, mesh=mesh,
                in_specs=(gspec, specs_in),
                out_specs=(specs_in, P(ROW_AXIS)),
                check_vma=False)
            return sharded(g_const, state)

        jitted = jax.jit(step)

        def stepper(g_const, state):
            return jitted(g_const, state)

        stepper.halo_telemetry = telemetry  # filled during the first trace
        return stepper

    def step(g_const, state):
        state = jax.tree_util.tree_map(
            lambda leaf: jax.lax.with_sharding_constraint(
                leaf, _image_leaf_sharding(leaf, mesh, height)), state)
        new_state, image = render_frame(renderer, g_const, state)
        image = jax.lax.with_sharding_constraint(image, row_sharding(mesh))
        return new_state, image

    return jax.jit(step)


def psum_image_metric(values: jax.Array, mesh: Mesh) -> jax.Array:
    """Whole-image reductions (RMSE / accumulation stats) — the only
    all-reduce the renderer needs (SURVEY.md §2.4). Under jit+GSPMD a plain
    jnp.sum lowers to the psum; this helper exists for explicit shard_map
    code paths."""
    return jnp.sum(values)
