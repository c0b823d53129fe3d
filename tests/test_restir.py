"""Unit tests for the reservoir library: streaming RIS invariants,
pack/unpack roundtrips, helpers (SURVEY.md §4 test pyramid)."""

import numpy as np
import jax.numpy as jnp

from raytracer2.restir import di_reservoir as dr
from raytracer2.restir import gi_reservoir as gr
from raytracer2.restir import helpers
from raytracer2.restir.gi_resampling import (
    calculate_jacobian, combine_gi_reservoirs, finalize_gi_resampling)


class TestDIReservoir:
    def test_empty_invalid(self):
        r = dr.empty_di_reservoir((4,))
        assert not np.any(np.asarray(dr.is_valid(r)))

    def test_stream_sample_updates(self):
        r = dr.empty_di_reservoir((1,))
        r, sel = dr.stream_sample(
            r, jnp.uint32([7]), jnp.asarray([[0.25, 0.75]]),
            jnp.asarray([0.1]), jnp.asarray([2.0]), jnp.asarray([0.5]))
        # first sample with positive weight is always selected
        assert bool(sel[0])
        assert float(r.m[0]) == 1.0
        assert abs(float(r.weight_sum[0]) - 1.0) < 1e-6  # 2.0 * 0.5
        assert int(dr.light_index(r)[0]) == 7
        assert bool(dr.is_valid(r)[0])
        uv = np.asarray(dr.sample_uv(r))[0]
        np.testing.assert_allclose(uv, [0.25, 0.75], atol=1e-4)

    def test_stream_selection_proportional(self):
        # streaming two samples: second selected w.p. w2/(w1+w2)
        n = 20000
        rng = np.random.default_rng(0)
        r = dr.empty_di_reservoir((n,))
        ones = jnp.ones((n,))
        r, _ = dr.stream_sample(
            r, jnp.zeros(n, jnp.uint32), jnp.zeros((n, 2)),
            jnp.asarray(rng.uniform(size=n), jnp.float32), ones * 1.0, ones)
        r, sel2 = dr.stream_sample(
            r, jnp.ones(n, jnp.uint32), jnp.zeros((n, 2)),
            jnp.asarray(rng.uniform(size=n), jnp.float32), ones * 3.0, ones)
        frac = np.asarray(sel2).mean()
        assert abs(frac - 0.75) < 0.02  # 3/(1+3)

    def test_finalize_weight_algebra(self):
        # single sample: finalize(1, 1) gives weightSum/targetPdf = invPdf
        r = dr.empty_di_reservoir((1,))
        r, _ = dr.stream_sample(
            r, jnp.uint32([3]), jnp.zeros((1, 2)), jnp.asarray([0.0]),
            jnp.asarray([4.0]), jnp.asarray([0.25]))
        r = dr.finalize_resampling(r, 1.0, 1.0)
        # wsum = targetPdf*invSrc = 1.0 -> normalized = 1.0/4.0 = invSrc/1
        assert abs(float(dr.inv_pdf(r)[0]) - 0.25) < 1e-6

    def test_combine_preserves_m(self):
        a = dr.empty_di_reservoir((1,))
        a, _ = dr.stream_sample(a, jnp.uint32([1]), jnp.zeros((1, 2)),
                                jnp.asarray([0.0]), jnp.asarray([1.0]),
                                jnp.asarray([1.0]))
        b = dr.empty_di_reservoir((1,))
        b, _ = dr.stream_sample(b, jnp.uint32([2]), jnp.zeros((1, 2)),
                                jnp.asarray([0.0]), jnp.asarray([1.0]),
                                jnp.asarray([1.0]))
        b = b._replace(m=jnp.asarray([5.0]))
        out = dr.empty_di_reservoir((1,))
        out, _ = dr.combine_reservoirs(out, a, jnp.asarray([0.5]), a.target_pdf)
        out, _ = dr.combine_reservoirs(out, b, jnp.asarray([0.5]), b.target_pdf)
        assert float(out.m[0]) == 6.0

    def test_pack_unpack_roundtrip(self):
        r = dr.DIReservoir(
            light_data=jnp.uint32([5 | dr.LIGHT_VALID_BIT]),
            uv_data=jnp.uint32([0x1234ABCD]),
            weight_sum=jnp.asarray([3.5]),
            target_pdf=jnp.asarray([0.7]),
            m=jnp.asarray([12.0]),
            packed_visibility=jnp.uint32([0x2345]),
            spatial_distance=jnp.asarray([[-3, 5]], jnp.int32),
            age=jnp.uint32([9]),
            canonical_weight=jnp.asarray([0.0]))
        back = dr.unpack_di_reservoir(dr.pack_di_reservoir(r))
        assert int(back.light_data[0]) == int(r.light_data[0])
        assert int(back.uv_data[0]) == int(r.uv_data[0])
        assert float(back.weight_sum[0]) == 3.5
        assert float(back.m[0]) == 12.0
        np.testing.assert_array_equal(np.asarray(back.spatial_distance),
                                      [[-3, 5]])
        assert int(back.age[0]) == 9

    def test_unpack_nan_discard(self):
        r = dr.empty_di_reservoir((1,))._replace(
            weight_sum=jnp.asarray([np.nan]),
            light_data=jnp.uint32([1 | dr.LIGHT_VALID_BIT]))
        back = dr.unpack_di_reservoir(dr.pack_di_reservoir(r))
        assert not bool(dr.is_valid(back)[0])

    def test_store_visibility_discard(self):
        r = dr.empty_di_reservoir((1,))
        r, _ = dr.stream_sample(r, jnp.uint32([1]), jnp.zeros((1, 2)),
                                jnp.asarray([0.0]), jnp.asarray([1.0]),
                                jnp.asarray([1.0]))
        r2 = dr.store_visibility(r, jnp.zeros((1, 3)), True)
        assert not bool(dr.is_valid(r2)[0])
        assert float(r2.m[0]) == 1.0  # M kept for correct resampling


class TestGIReservoir:
    def test_make_and_validity(self):
        r = gr.make_gi_reservoir(
            jnp.ones((2, 3)), jnp.asarray([[0, 0, 1.0]] * 2),
            jnp.ones((2, 3)) * 5.0, jnp.asarray([2.0, 0.0]))
        assert bool(gr.is_valid(r)[0])
        assert not bool(gr.is_valid(r)[1])
        assert abs(float(r.weight_sum[0]) - 0.5) < 1e-6

    def test_pack_unpack_roundtrip(self):
        n = jnp.asarray([[0.6, -0.8, 0.0]])
        r = gr.GIReservoir(
            position=jnp.asarray([[1.0, 2.0, 3.0]]),
            normal=n / jnp.linalg.norm(n),
            radiance=jnp.asarray([[10.0, 5.0, 2.0]]),
            weight_sum=jnp.asarray([1.25]),
            m=jnp.uint32([17]), age=jnp.uint32([3]))
        back = gr.unpack_gi_reservoir(gr.pack_gi_reservoir(r))
        np.testing.assert_allclose(np.asarray(back.position),
                                   np.asarray(r.position))
        assert float(np.sum(np.asarray(back.normal) * np.asarray(r.normal))) \
            > 0.9999
        np.testing.assert_allclose(np.asarray(back.radiance),
                                   np.asarray(r.radiance), rtol=0.05)
        assert int(back.m[0]) == 17 and int(back.age[0]) == 3

    def test_combine_weight_sum(self):
        a = gr.make_gi_reservoir(jnp.zeros((1, 3)), jnp.asarray([[0, 0, 1.0]]),
                                 jnp.ones((1, 3)), jnp.asarray([1.0]))
        state = gr.empty_gi_reservoir((1,))
        state, sel = combine_gi_reservoirs(state, a, 0.5, jnp.asarray([2.0]))
        assert bool(sel[0])
        # risWeight = targetPdf * wsum * M = 2*1*1
        assert abs(float(state.weight_sum[0]) - 2.0) < 1e-6
        state = finalize_gi_resampling(state, 1.0,
                                       state.m.astype(jnp.float32) * 2.0)
        assert abs(float(state.weight_sum[0]) - 1.0) < 1e-6


class TestJacobian:
    def test_identity_when_same_receiver(self):
        res = gr.make_gi_reservoir(
            jnp.asarray([[0.0, 0.0, 5.0]]), jnp.asarray([[0.0, 0.0, -1.0]]),
            jnp.ones((1, 3)), jnp.asarray([1.0]))
        p = jnp.asarray([[1.0, 2.0, 0.0]])
        jac = calculate_jacobian(p, p, res)
        np.testing.assert_allclose(np.asarray(jac), 1.0, rtol=1e-5)

    def test_closer_receiver_larger_jacobian(self):
        res = gr.make_gi_reservoir(
            jnp.asarray([[0.0, 0.0, 10.0]]), jnp.asarray([[0.0, 0.0, -1.0]]),
            jnp.ones((1, 3)), jnp.asarray([1.0]))
        near = jnp.asarray([[0.0, 0.0, 5.0]])
        far = jnp.asarray([[0.0, 0.0, 0.0]])
        jac = calculate_jacobian(near, far, res)
        assert float(jac[0]) > 1.0  # moving closer increases solid angle


class TestHelpers:
    def test_compare_relative_difference(self):
        assert bool(helpers.compare_relative_difference(10.0, 10.5, 0.1))
        assert not bool(helpers.compare_relative_difference(10.0, 12.0, 0.1))
        assert bool(helpers.compare_relative_difference(10.0, 99.0, 0.0))

    def test_pairwise_mis_weight(self):
        w = helpers.pairwise_mis_weight(
            jnp.asarray(1.0), jnp.asarray(1.0), jnp.asarray(1.0),
            jnp.asarray(1.0))
        assert abs(float(w) - 0.5) < 1e-6
        z = helpers.pairwise_mis_weight(
            jnp.asarray(0.0), jnp.asarray(0.0), jnp.asarray(1.0),
            jnp.asarray(1.0))
        assert float(z) == 0.0

    def test_checkerboard_roundtrip(self):
        px = jnp.arange(16, dtype=jnp.int32)
        py = jnp.arange(16, dtype=jnp.int32) // 2
        for field in (1, 2):
            rx, ry = helpers.pixel_pos_to_reservoir_pos(px, py, field)
            bx, by = helpers.reservoir_pos_to_pixel_pos(rx, ry, field)
            active = helpers.is_active_checkerboard_pixel(bx, by, False, field)
            assert np.all(np.asarray(active))

    def test_permutation_sampling_involution(self):
        px = jnp.arange(64, dtype=jnp.int32)
        py = (jnp.arange(64, dtype=jnp.int32) * 7) % 64
        u = jnp.uint32(0b1101)
        ax, ay = helpers.apply_permutation_sampling(px, py, u)
        bx, by = helpers.apply_permutation_sampling(ax, ay, u)
        np.testing.assert_array_equal(np.asarray(bx), np.asarray(px))
        np.testing.assert_array_equal(np.asarray(by), np.asarray(py))

    def test_reservoir_pointer_block_linear(self):
        from raytracer2.params import calculate_reservoir_buffer_parameters

        params = calculate_reservoir_buffer_parameters(64, 48)
        # walk a few positions; pointers must be unique and in range
        xs, ys = np.meshgrid(np.arange(64), np.arange(48))
        ptr = helpers.reservoir_position_to_pointer(
            params, jnp.asarray(xs.ravel()), jnp.asarray(ys.ravel()), 0)
        ptr = np.asarray(ptr)
        assert len(np.unique(ptr)) == ptr.size
        assert ptr.max() < params.reservoir_array_pitch
        ptr1 = helpers.reservoir_position_to_pointer(
            params, jnp.asarray([0]), jnp.asarray([0]), 1)
        assert int(ptr1[0]) == params.reservoir_array_pitch

    def test_temporal_offset_pattern(self):
        # 8 distinct non-zero offsets within radius
        offsets = set()
        for i in range(8):
            ox, oy = helpers.calculate_temporal_resampling_offset(
                jnp.int32(i), 1)
            offsets.add((int(ox), int(oy)))
        assert len(offsets) == 8
        assert (0, 0) not in offsets
        for ox, oy in offsets:
            assert abs(ox) <= 1 and abs(oy) <= 1

    def test_boiling_filter(self):
        w = np.ones((32, 32), np.float32)
        w[5, 5] = 1000.0  # boiling outlier
        kill = np.asarray(helpers.boiling_filter_mask(jnp.asarray(w), 0.5))
        assert kill[5, 5]
        assert kill.sum() == 1


class TestDIBoilingFilter:
    def test_outlier_killed_average_kept(self):
        """DI boiling filter (DIResamplingFunctions.hlsli:101-116): a
        reservoir with weightSum far above its 16x16 tile average is
        discarded; normal reservoirs survive."""
        from raytracer2.restir.di_resampling import di_boiling_filter
        from raytracer2.restir.di_reservoir import empty_di_reservoir

        res = empty_di_reservoir((16, 16))
        w = jnp.full((16, 16), 1.0).at[3, 5].set(1e5)
        res = res._replace(weight_sum=w,
                           m=jnp.ones((16, 16), jnp.float32))
        out = di_boiling_filter(res, filter_strength=0.8)
        assert float(out.weight_sum[3, 5]) == 0.0  # outlier gone
        assert float(out.m[3, 5]) == 0.0
        assert float(out.weight_sum[0, 0]) == 1.0  # average survives

    def test_frame_gated_by_gconst(self, tmp_path):
        """enable_boiling_filter on the DI temporal params routes through
        the fused pass without breaking the frame."""
        import dataclasses

        import numpy as np

        from raytracer2.models import procedural as proc
        from raytracer2.params import default_gconst
        from raytracer2.render.frame import (
            create_renderer, init_frame_state, render_frame)
        from raytracer2.scene import gltf
        from raytracer2.scene.camera import default_camera
        from raytracer2.scene.scene import build_scene

        p = tmp_path / "c.glb"
        proc.write_glb(p, proc.cornell_box_glb(light_emission=2.0))
        scene = build_scene(gltf.load_file(p))
        renderer = create_renderer(scene, 16, 16)
        cam = default_camera(window_size=(16, 16), position=(0, 0, -12),
                             direction=(0, 0, -1))
        g = default_gconst(cam.planar_view_constants(),
                           renderer.scene_lights.num_local_lights)
        trp = dataclasses.replace(
            g.restir_di.temporal_resampling_params,
            enable_boiling_filter=1, boiling_filter_strength=0.5)
        g = g.replace(enable_restir_di=1,
                      restir_di=dataclasses.replace(
                          g.restir_di, temporal_resampling_params=trp))
        state = init_frame_state(16, 16)
        state, img = render_frame(renderer, g, state)
        assert np.all(np.isfinite(np.asarray(img)))
