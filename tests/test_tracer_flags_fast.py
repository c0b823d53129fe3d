"""Fast-tier traversal parity: every `--backend` engine vs the brute-force
oracle.

One tiny scene (a ~100-tri sphere, cluster_size=4 so the cluster engines
walk several clusters) x 96 random rays, closest-hit and any-hit, through
make_tracers exactly as the renderer builds them. The full-size parity
classes in tests/test_bvh.py stay in the slow gate.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from raytracer2.models import procedural as proc
from raytracer2.ops.intersect import (
    intersect_brute_force, occluded_brute_force)
from raytracer2.render.app_bridge import BACKENDS, make_tracers
from raytracer2.scene import gltf
from raytracer2.scene.scene import build_scene

N_RAYS = 96
ENGINES = [b for b in BACKENDS if b not in ("auto", "brute")]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    p = tmp_path_factory.mktemp("tf") / "s.glb"
    proc.write_glb(p, proc.sphere_grid_glb(n=1, lat=6, lon=8))
    scene = build_scene(gltf.load_file(p))

    rng = np.random.default_rng(77)
    origins = jnp.asarray(rng.uniform(-4, 4, (N_RAYS, 3)).astype(np.float32))
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    dirs = jnp.asarray(d / np.linalg.norm(d, axis=-1, keepdims=True))
    # half the segments stop short, so any-hit sees both outcomes
    t_max = jnp.asarray(np.where(np.arange(N_RAYS) % 2, 1e5, 3.0),
                        jnp.float32)
    return scene, origins, dirs, t_max


@pytest.mark.parametrize("backend", ENGINES)
def test_closest_hit_parity(tiny, backend):
    scene, origins, dirs, t_max = tiny
    ref = intersect_brute_force(
        origins, dirs, scene.tri_v0, scene.tri_edge1, scene.tri_edge2,
        scene.tri_geometry, scene.tri_primitive, 1e-3, t_max)
    tracers = make_tracers(scene, backend=backend, cluster_size=4)
    got = tracers.closest_hit(origins, dirs, jnp.full((N_RAYS,), 1e-3),
                              t_max)
    np.testing.assert_array_equal(np.asarray(got.missed),
                                  np.asarray(ref.missed))
    m = ~np.asarray(ref.missed)
    assert m.any()
    np.testing.assert_allclose(np.asarray(got.t)[m],
                               np.asarray(ref.t)[m], rtol=1e-4)
    np.testing.assert_array_equal(np.asarray(got.triangle_index)[m],
                                  np.asarray(ref.triangle_index)[m])


@pytest.mark.parametrize("backend", ENGINES)
def test_occlusion_parity(tiny, backend):
    scene, origins, dirs, t_max = tiny
    ref = occluded_brute_force(origins, dirs, scene.tri_v0, scene.tri_edge1,
                               scene.tri_edge2, 1e-3, t_max)
    tracers = make_tracers(scene, backend=backend, cluster_size=4)
    got = tracers.occluded(origins, dirs, jnp.full((N_RAYS,), 1e-3), t_max)
    ref = np.asarray(ref)
    assert ref.any() and not ref.all()
    np.testing.assert_array_equal(np.asarray(got), ref)
