"""LBVH build + traversal tests: structure validation and hit-parity against
the brute-force oracle (SURVEY.md §7 step 3)."""

import numpy as np
import jax.numpy as jnp
import pytest

from raytracer2.models import procedural as proc
from raytracer2.ops.bvh import build_lbvh, morton_codes_3d, validate_bvh
from raytracer2.ops.intersect import intersect_brute_force, occluded_brute_force
from raytracer2.ops.traverse import closest_hit, occluded
from raytracer2.scene import gltf
from raytracer2.scene.scene import build_scene


@pytest.fixture(scope="module")
def sphere_scene(tmp_path_factory):
    p = tmp_path_factory.mktemp("b") / "grid.glb"
    proc.write_glb(p, proc.sphere_grid_glb(n=2, lat=8, lon=10))
    return build_scene(gltf.load_file(p))


@pytest.fixture(scope="module")
def sphere_bvh(sphere_scene):
    return build_lbvh(sphere_scene.tri_v0, sphere_scene.tri_edge1,
                      sphere_scene.tri_edge2)


def test_morton_ordering():
    # points along the diagonal get increasing codes
    pts = jnp.asarray(np.linspace(0, 1, 16)[:, None].repeat(3, 1), jnp.float32)
    codes = np.asarray(morton_codes_3d(
        pts, jnp.zeros(3), jnp.ones(3)))
    assert np.all(np.diff(codes.astype(np.int64)) > 0)


def test_bvh_structure(sphere_bvh, sphere_scene):
    info = validate_bvh(sphere_bvh)
    assert info["max_depth"] < 64
    # root AABB covers all triangles
    v0 = np.asarray(sphere_scene.tri_v0)
    v1 = v0 + np.asarray(sphere_scene.tri_edge1)
    v2 = v0 + np.asarray(sphere_scene.tri_edge2)
    all_min = np.minimum(np.minimum(v0, v1), v2).min(0)
    all_max = np.maximum(np.maximum(v0, v1), v2).max(0)
    np.testing.assert_allclose(np.asarray(sphere_bvh.aabb_min[0]), all_min,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(sphere_bvh.aabb_max[0]), all_max,
                               atol=1e-5)


def test_duplicate_positions_ok():
    # identical centroids (duplicate morton codes) must still build
    v0 = jnp.zeros((8, 3), jnp.float32)
    e1 = jnp.tile(jnp.asarray([[1.0, 0, 0]], jnp.float32), (8, 1))
    e2 = jnp.tile(jnp.asarray([[0, 1.0, 0]], jnp.float32), (8, 1))
    bvh = build_lbvh(v0, e1, e2)
    validate_bvh(bvh)


def _random_rays(n, seed, spread=12.0):
    rng = np.random.default_rng(seed)
    origins = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return jnp.asarray(origins), jnp.asarray(dirs)


def test_closest_hit_parity_with_brute_force(sphere_scene, sphere_bvh):
    origins, dirs = _random_rays(256, seed=5)
    t_min, t_max = 1e-3, 1e5
    ref = intersect_brute_force(
        origins, dirs, sphere_scene.tri_v0, sphere_scene.tri_edge1,
        sphere_scene.tri_edge2, sphere_scene.tri_geometry,
        sphere_scene.tri_primitive, t_min, t_max)
    got = closest_hit(
        sphere_bvh, sphere_scene.tri_v0, sphere_scene.tri_edge1,
        sphere_scene.tri_edge2, sphere_scene.tri_geometry,
        sphere_scene.tri_primitive, origins, dirs, t_min, t_max)

    np.testing.assert_array_equal(np.asarray(got.missed),
                                  np.asarray(ref.missed))
    hitm = ~np.asarray(ref.missed)
    np.testing.assert_allclose(np.asarray(got.t)[hitm],
                               np.asarray(ref.t)[hitm], rtol=1e-4)
    # same triangle except exact-tie cases
    same = (np.asarray(got.triangle_index)[hitm]
            == np.asarray(ref.triangle_index)[hitm])
    assert same.mean() > 0.99


def test_occlusion_parity(sphere_scene, sphere_bvh):
    origins, dirs = _random_rays(256, seed=9)
    t_min, t_max = 1e-3, 30.0
    ref = occluded_brute_force(
        origins, dirs, sphere_scene.tri_v0, sphere_scene.tri_edge1,
        sphere_scene.tri_edge2, t_min, t_max)
    got = occluded(
        sphere_bvh, sphere_scene.tri_v0, sphere_scene.tri_edge1,
        sphere_scene.tri_edge2, origins, dirs, t_min, t_max)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_rays_through_empty_space_miss(sphere_bvh, sphere_scene):
    origins = jnp.asarray([[100.0, 100.0, 100.0]] * 4, jnp.float32)
    dirs = jnp.asarray([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0],
                        [0.577, 0.577, 0.577]], jnp.float32)
    got = closest_hit(
        sphere_bvh, sphere_scene.tri_v0, sphere_scene.tri_edge1,
        sphere_scene.tri_edge2, sphere_scene.tri_geometry,
        sphere_scene.tri_primitive, origins, dirs, 1e-3, 1e5)
    assert np.all(np.asarray(got.missed))


class TestBundleTracer:
    """Bundle tracer parity (ops/traverse_bundle.py) vs brute force."""

    def _clusters(self, scene, size=16):
        from raytracer2.ops.cluster import build_clusters

        return build_clusters(scene.tri_v0, scene.tri_edge1,
                              scene.tri_edge2, cluster_size=size)

    def test_closest_hit_parity(self, sphere_scene):
        from raytracer2.ops.traverse_bundle import closest_hit_bundle

        clusters = self._clusters(sphere_scene)
        smin = jnp.min(clusters.aabb_min, 0)
        smax = jnp.max(clusters.aabb_max, 0)
        origins, dirs = _random_rays(512, seed=11, spread=5.0)
        ref = intersect_brute_force(
            origins, dirs, sphere_scene.tri_v0, sphere_scene.tri_edge1,
            sphere_scene.tri_edge2, sphere_scene.tri_geometry,
            sphere_scene.tri_primitive, 1e-3, 1e5)
        for sort in (False, True):
            got = closest_hit_bundle(
                clusters, sphere_scene.tri_geometry,
                sphere_scene.tri_primitive, origins, dirs, 1e-3,
                jnp.full((512,), 1e5), smin, smax, sort_rays=sort)
            np.testing.assert_array_equal(np.asarray(got.missed),
                                          np.asarray(ref.missed))
            m = ~np.asarray(ref.missed)
            np.testing.assert_allclose(np.asarray(got.t)[m],
                                       np.asarray(ref.t)[m], rtol=1e-3)

    def test_occlusion_parity(self, sphere_scene):
        from raytracer2.ops.traverse_bundle import occluded_bundle

        clusters = self._clusters(sphere_scene)
        smin = jnp.min(clusters.aabb_min, 0)
        smax = jnp.max(clusters.aabb_max, 0)
        origins, dirs = _random_rays(512, seed=13, spread=5.0)
        ref = occluded_brute_force(
            origins, dirs, sphere_scene.tri_v0, sphere_scene.tri_edge1,
            sphere_scene.tri_edge2, 1e-3, 20.0)
        got = occluded_bundle(clusters, origins, dirs, 1e-3,
                              jnp.full((512,), 20.0), smin, smax)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))

    def test_per_ray_tmax_respected(self, sphere_scene):
        from raytracer2.ops.traverse_bundle import closest_hit_bundle

        clusters = self._clusters(sphere_scene)
        smin = jnp.min(clusters.aabb_min, 0)
        smax = jnp.max(clusters.aabb_max, 0)
        origins, dirs = _random_rays(256, seed=17, spread=5.0)
        far = closest_hit_bundle(
            clusters, sphere_scene.tri_geometry, sphere_scene.tri_primitive,
            origins, dirs, 1e-3, jnp.full((256,), 1e5), smin, smax)
        # clamp tmax below each found hit: all must miss
        short_tmax = jnp.where(far.missed, 1e5, far.t * 0.5)
        near = closest_hit_bundle(
            clusters, sphere_scene.tri_geometry, sphere_scene.tri_primitive,
            origins, dirs, 1e-3, short_tmax, smin, smax)
        hitm = ~np.asarray(far.missed)
        assert np.all(np.asarray(near.missed)[hitm])


class TestNativeSAH:
    def test_native_available_and_valid(self, sphere_scene):
        from raytracer2.ops import native

        if not native.available():
            pytest.skip("native toolchain unavailable")
        v0 = np.asarray(sphere_scene.tri_v0)
        e1 = np.asarray(sphere_scene.tri_edge1)
        e2 = np.asarray(sphere_scene.tri_edge2)
        order, offsets, counts = native.build_sah_clusters(v0, e1, e2, 16)
        n = v0.shape[0]
        # permutation covers every triangle exactly once
        assert sorted(order.tolist()) == list(range(n))
        assert counts.sum() == n
        assert np.all(counts <= 16) and np.all(counts > 0)
        # ranges tile [0, n)
        assert offsets[0] == 0
        np.testing.assert_array_equal(offsets[1:], offsets[:-1] + counts[:-1])

    def test_sah_clusters_tighter_than_morton(self, sphere_scene):
        from raytracer2.ops import native
        from raytracer2.ops.cluster import build_clusters

        if not native.available():
            pytest.skip("native toolchain unavailable")
        sah = build_clusters(sphere_scene.tri_v0, sphere_scene.tri_edge1,
                             sphere_scene.tri_edge2, 16, method="sah")
        mor = build_clusters(sphere_scene.tri_v0, sphere_scene.tri_edge1,
                             sphere_scene.tri_edge2, 16, method="morton")

        def total_area(c):
            ext = np.maximum(np.asarray(c.aabb_max) - np.asarray(c.aabb_min), 0)
            ext = np.where(ext > 1e20, 0, ext)  # skip empty sentinels
            return (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
                    + ext[:, 2] * ext[:, 0]).sum()

        assert total_area(sah) <= total_area(mor) * 1.05


class TestScatterTracer:
    """Scatter engine parity (ops/traverse_scatter.py) vs brute force."""

    def _sc(self, scene):
        from raytracer2.ops.cluster import build_clusters
        from raytracer2.ops.traverse_scatter import build_superclusters

        clusters = build_clusters(scene.tri_v0, scene.tri_edge1,
                                  scene.tri_edge2, cluster_size=16)
        return build_superclusters(clusters, group=8)

    def test_closest_hit_parity(self, sphere_scene):
        from raytracer2.ops.traverse_scatter import closest_hit_scatter

        sc = self._sc(sphere_scene)
        origins, dirs = _random_rays(512, seed=21, spread=5.0)
        ref = intersect_brute_force(
            origins, dirs, sphere_scene.tri_v0, sphere_scene.tri_edge1,
            sphere_scene.tri_edge2, sphere_scene.tri_geometry,
            sphere_scene.tri_primitive, 1e-3, 1e5)
        got = closest_hit_scatter(
            sc, sphere_scene.tri_geometry, sphere_scene.tri_primitive,
            origins, dirs, 1e-3, jnp.full((512,), 1e5), avg_candidates=64)
        np.testing.assert_array_equal(np.asarray(got.missed),
                                      np.asarray(ref.missed))
        m = ~np.asarray(ref.missed)
        np.testing.assert_allclose(np.asarray(got.t)[m],
                                   np.asarray(ref.t)[m], rtol=1e-3)
        np.testing.assert_array_equal(
            np.asarray(got.triangle_index)[m],
            np.asarray(ref.triangle_index)[m])

    def test_occlusion_parity(self, sphere_scene):
        from raytracer2.ops.traverse_scatter import occluded_scatter

        sc = self._sc(sphere_scene)
        origins, dirs = _random_rays(512, seed=23, spread=5.0)
        ref = occluded_brute_force(
            origins, dirs, sphere_scene.tri_v0, sphere_scene.tri_edge1,
            sphere_scene.tri_edge2, 1e-3, 20.0)
        got = occluded_scatter(sc, origins, dirs, 1e-3,
                               jnp.full((512,), 20.0), avg_candidates=64)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))

    def test_dead_lanes_never_hit(self, sphere_scene):
        from raytracer2.ops.traverse_scatter import closest_hit_scatter

        sc = self._sc(sphere_scene)
        origins, dirs = _random_rays(128, seed=25, spread=5.0)
        tmax = jnp.where(jnp.arange(128) % 2 == 0, 1e5, -1.0)
        got = closest_hit_scatter(
            sc, sphere_scene.tri_geometry, sphere_scene.tri_primitive,
            origins, dirs, 1e-3, tmax, avg_candidates=64)
        dead = np.arange(128) % 2 == 1
        assert np.all(np.asarray(got.missed)[dead])
