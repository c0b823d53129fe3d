"""End-to-end brute-force reference render on a Cornell box
(the minimum end-to-end slice, SURVEY.md §7 step 2)."""

import numpy as np
import jax.numpy as jnp
import pytest

from raytracer2.models import procedural as proc
from raytracer2.params import GConst, default_gconst
from raytracer2.render.postprocess import PostProcessInputs, post_process, tonemap
from raytracer2.render.reference import render_reference
from raytracer2.scene import gltf
from raytracer2.scene.camera import default_camera
from raytracer2.scene.scene import build_scene

W = H = 48


@pytest.fixture(scope="module")
def cornell_scene(tmp_path_factory):
    p = tmp_path_factory.mktemp("s") / "cornell.glb"
    proc.write_glb(p, proc.cornell_box_glb(light_emission=2.0))
    return build_scene(gltf.load_file(p))


@pytest.fixture(scope="module")
def gconst():
    # NOTE: primary rays point opposite Camera.direction (projection quirk,
    # see scene/camera.py perspective()); direction -z looks at the box at +z
    cam = default_camera(window_size=(W, H), position=(0, 0, -12),
                         direction=(0, 0, -1))
    view = cam.planar_view_constants()
    return default_gconst(view, num_local_lights=2, refrence_mode=1)


@pytest.fixture(scope="module")
def image(cornell_scene, gconst):
    img = render_reference(cornell_scene, gconst, W, H,
                           max_bounces=3, max_samples=4)
    return np.asarray(img)


def test_image_finite_nonnegative(image):
    assert image.shape == (H, W, 3)
    assert np.all(np.isfinite(image))
    assert np.all(image >= 0.0)


def test_light_is_brightest(image):
    # emissive quad radiance = 2.0 * 12 (Hit.glsl:41) plus bounce light
    assert image.max() > 10.0
    # interior receives indirect light (low spp -> sparse, but present)
    assert (image.mean(-1) > 0.01).mean() > 0.1
    assert image.mean() > 0.1


def test_colored_walls_bleed(image):
    # red (x=-5) and green (x=+5) walls tint opposite image halves
    left = image[:, : W // 3]
    right = image[:, -W // 3:]
    halves = [left, right]
    red_ratio = [h[..., 0].mean() / (h[..., 1].mean() + 1e-6) for h in halves]
    # one half clearly redder than the other
    assert max(red_ratio) > 1.2 * min(red_ratio)


def test_deterministic(cornell_scene, gconst):
    a = render_reference(cornell_scene, gconst, 16, 16,
                         max_bounces=2, max_samples=2)
    b = render_reference(cornell_scene, gconst, 16, 16,
                         max_bounces=2, max_samples=2)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_frame_changes_noise(cornell_scene, gconst):
    a = render_reference(cornell_scene, gconst, 16, 16,
                         max_bounces=2, max_samples=2)
    g2 = gconst.replace(frame=jnp.uint32(7))
    b = render_reference(cornell_scene, g2, 16, 16,
                         max_bounces=2, max_samples=2)
    assert not np.array_equal(np.asarray(a), np.asarray(b))


def test_spp_converges(cornell_scene, gconst):
    # variance between two independent frames shrinks with sample count
    lo_a = np.asarray(render_reference(
        cornell_scene, gconst, 16, 16, max_bounces=2, max_samples=1))
    lo_b = np.asarray(render_reference(
        cornell_scene, gconst.replace(frame=jnp.uint32(3)), 16, 16,
        max_bounces=2, max_samples=1))
    hi_a = np.asarray(render_reference(
        cornell_scene, gconst, 16, 16, max_bounces=2, max_samples=8))
    hi_b = np.asarray(render_reference(
        cornell_scene, gconst.replace(frame=jnp.uint32(3)), 16, 16,
        max_bounces=2, max_samples=8))
    err_lo = np.abs(lo_a - lo_b).mean()
    err_hi = np.abs(hi_a - hi_b).mean()
    assert err_hi < err_lo


def test_postprocess_reference_mode(cornell_scene, gconst, image):
    inputs = PostProcessInputs(
        depth=jnp.zeros((H, W)),
        diffuse_albedo=jnp.zeros((H, W, 3)),
        specular_f0=jnp.zeros((H, W, 3)),
        emissive=jnp.zeros((H, W, 3)),
        diffuse=jnp.asarray(image),
        specular=jnp.zeros((H, W, 3)),
    )
    out, _ = post_process(cornell_scene, gconst, inputs)
    out = np.asarray(out)
    assert out.shape == (H, W, 3)
    assert np.all(out >= 0.0) and np.all(out <= 1.0 + 1e-5)
    assert np.all(np.isfinite(out))


def test_tonemap_nan_canary():
    img = jnp.array([[[np.nan, 0.5, 0.5], [0.5, 0.5, 0.5]]], jnp.float32)
    out = np.asarray(tonemap(img))
    np.testing.assert_allclose(out[0, 0], [1.0, 0.0, 0.0])
    assert not np.allclose(out[0, 1], [1.0, 0.0, 0.0])


def test_tonemap_monotone_gray():
    xs = jnp.asarray(np.geomspace(1e-3, 100.0, 32), jnp.float32)
    gray = jnp.stack([xs, xs, xs], -1)[None]
    out = np.asarray(tonemap(gray))[0]
    lum = out.mean(-1)
    assert np.all(np.diff(lum) > -1e-4)  # monotone nondecreasing


def test_dead_lane_compaction_bit_identical():
    """tf_compact: on a miss-heavy scene (sphere grid
    against sky) the compacted bounce batches must produce a bit-identical
    image — tracing is per-ray deterministic and RNG never sees lane
    positions."""
    import tempfile
    from pathlib import Path

    import numpy as np
    import jax.numpy as jnp

    from raytracer2.models import procedural as proc
    from raytracer2.params import default_gconst
    from raytracer2.render.frame import create_renderer
    from raytracer2.render.reference import render_reference
    from raytracer2.scene import gltf
    from raytracer2.scene.camera import default_camera
    from raytracer2.scene.scene import build_scene

    with tempfile.TemporaryDirectory() as d:
        p = Path(d) / "grid.glb"
        proc.write_glb(p, proc.sphere_grid_glb(n=2, lat=8, lon=10,
                                               emissive_every=4))
        scene = build_scene(gltf.load_file(p))
    W = H = 64  # 4096 lanes > the 2048 compaction floor
    renderer = create_renderer(scene, W, H)
    cam = default_camera(window_size=(W, H), position=(0, 1.5, -7),
                         direction=(0, 0, -1))
    g = default_gconst(cam.planar_view_constants(),
                       renderer.scene_lights.num_local_lights,
                       refrence_mode=1)
    kw = dict(max_bounces=3, max_samples=2,
              trace_fn=renderer.tracers.closest_hit)
    a = np.asarray(render_reference(scene, g, W, H,
                                    compact_dead_lanes=True, **kw))
    b = np.asarray(render_reference(scene, g, W, H,
                                    compact_dead_lanes=False, **kw))
    assert np.array_equal(a, b), (
        f"compaction changed the image: max|diff| {np.abs(a - b).max()}")
