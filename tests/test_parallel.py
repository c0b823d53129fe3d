"""Multi-chip sharding tests on the virtual 8-device CPU mesh.

Covers parallel/mesh.py (row sharding of the frame) and parallel/halo.py
(explicit ppermute halo exchange for the bounded-stencil resampling
gathers, SURVEY.md §2.4)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from raytracer2.parallel.halo import exchange_row_halos, gather_rows
from raytracer2.parallel.mesh import ROW_AXIS, make_mesh


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 2:
        pytest.skip("needs the virtual multi-device CPU mesh")
    return make_mesh()


class TestHaloExchange:
    def _reference_pad(self, img, radius):
        top = img[:radius][::-1]
        bottom = img[-radius:][::-1]
        return np.concatenate([top, img, bottom], axis=0)

    @pytest.mark.parametrize("radius", [1, 3])
    def test_halos_match_global_reflection(self, mesh, radius):
        n = len(mesh.devices.flat)
        h, w = 8 * n, 16
        img = jnp.asarray(
            np.random.default_rng(0).normal(size=(h, w)), jnp.float32)

        @partial(shard_map, mesh=mesh, in_specs=P(ROW_AXIS),
                 out_specs=P(ROW_AXIS))
        def padded_identity(tile):
            padded = exchange_row_halos(tile, radius)
            return padded[radius:-radius]  # interior unchanged

        np.testing.assert_array_equal(np.asarray(padded_identity(img)),
                                      np.asarray(img))

    @pytest.mark.parametrize("dy,dx", [(-3, 0), (3, 2), (0, -5), (2, 1)])
    def test_stencil_gather_matches_unsharded(self, mesh, dy, dx):
        radius = 3
        n = len(mesh.devices.flat)
        h, w = 8 * n, 16
        img = jnp.asarray(
            np.random.default_rng(1).normal(size=(h, w)), jnp.float32)

        @partial(shard_map, mesh=mesh, in_specs=P(ROW_AXIS),
                 out_specs=P(ROW_AXIS))
        def sharded_gather(tile):
            padded = exchange_row_halos(tile, radius)
            return gather_rows(padded, radius, jnp.int32(dy), jnp.int32(dx))

        # unsharded oracle: same reflected-rows / clamped-columns semantics
        ref_img = self._reference_pad(np.asarray(img), radius)
        ys = np.arange(h)[:, None] + radius + dy
        xs = np.clip(np.arange(w)[None, :] + dx, 0, w - 1)
        expected = ref_img[ys, xs]

        np.testing.assert_array_equal(np.asarray(sharded_gather(img)),
                                      expected)

    def test_single_shard_reflects(self):
        img = jnp.arange(24, dtype=jnp.float32).reshape(6, 4)
        mesh1 = Mesh(np.asarray(jax.devices()[:1]), (ROW_AXIS,))

        @partial(shard_map, mesh=mesh1, in_specs=P(ROW_AXIS),
                 out_specs=P(ROW_AXIS))
        def padded(tile):
            return exchange_row_halos(tile, 2)

        got = np.asarray(padded(img))
        np.testing.assert_array_equal(got[:2], np.asarray(img[:2][::-1]))
        np.testing.assert_array_equal(got[-2:], np.asarray(img[-2:][::-1]))


class TestExplicitHaloFrame:
    """The full ReSTIR frame inside shard_map with ppermute halos
    (make_sharded_render_fn(explicit_halo=True)) matches the single-device
    frame. Pixel RNG/view math is global, stencils read through halos; the
    only tolerated deviation is fp tie-breaking on speckle pixels (the
    high-variance 1-candidate default flips winners on one-ulp t ties)."""

    def test_matches_single_device(self, tmp_path):
        from raytracer2.models import procedural as proc
        from raytracer2.params import default_gconst
        from raytracer2.render.frame import (
            create_renderer, init_frame_state, render_frame)
        from raytracer2.parallel.mesh import (
            make_mesh, make_sharded_render_fn, shard_frame_state)
        from raytracer2.scene import gltf
        from raytracer2.scene.camera import default_camera
        from raytracer2.scene.scene import build_scene

        W = H = 32
        p = tmp_path / "c.glb"
        proc.write_glb(p, proc.cornell_box_glb(light_emission=2.0))
        scene = build_scene(gltf.load_file(p))
        r = create_renderer(scene, W, H)
        cam = default_camera(window_size=(W, H), position=(0, 0, -12),
                             direction=(0, 0, -1))
        g = default_gconst(cam.planar_view_constants(),
                           r.scene_lights.num_local_lights,
                           enable_restir_di=1, enable_restir_gi=1,
                           enable_temporal_resampling=1,
                           enable_spatial_resampling=1)

        fn1 = jax.jit(lambda gc, s: render_frame(r, gc, s))
        s1 = init_frame_state(W, H)
        for f in range(2):
            s1, img1 = fn1(g.replace(frame=jnp.uint32(f)), s1)

        mesh = make_mesh()
        assert mesh.devices.size == 8
        step = make_sharded_render_fn(r, mesh, explicit_halo=True)
        s8 = shard_frame_state(init_frame_state(W, H), mesh)
        for f in range(2):
            s8, img8 = step(g.replace(frame=jnp.uint32(f)), s8)

        img1 = np.asarray(img1)
        img8 = np.asarray(img8)
        # G-buffers bit-identical (pointwise passes)
        np.testing.assert_array_equal(np.asarray(s1.gbuffer.depth),
                                      np.asarray(s8.gbuffer.depth))
        d = np.abs(img1 - img8)
        assert d.mean() < 5e-3, f"sharded frame diverged: mean {d.mean()}"
        # the overwhelming majority of pixels are exact
        assert (d.max(axis=-1) < 1e-6).mean() > 0.95
