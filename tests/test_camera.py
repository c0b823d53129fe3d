"""Camera / PlanarViewConstants tests (ref: camera.rs)."""

import numpy as np
import pytest

from raytracer2.scene.camera import (
    Camera, Controls, default_camera, look_at_rh, perspective)


def test_look_at_rh_properties():
    eye = np.array([1.0, 2.0, 3.0], np.float32)
    center = np.array([0.0, 0.0, 0.0], np.float32)
    up = np.array([0.0, -1.0, 0.0], np.float32)
    m = look_at_rh(eye, center, up)
    # eye maps to origin
    p = m @ np.array([*eye, 1.0], np.float32)
    np.testing.assert_allclose(p[:3], 0.0, atol=1e-5)
    # forward dir maps to -z
    f = (center - eye) / np.linalg.norm(center - eye)
    d = m @ np.array([*f, 0.0], np.float32)
    np.testing.assert_allclose(d[:3], [0, 0, -1], atol=1e-5)
    # rotation part orthonormal
    r = m[:3, :3]
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-5)


def test_perspective_matches_reference_layout():
    # camera.rs:146-157: col2=(0,0,-(n+f)z,1), col3=(0,0,-2nfz,0)
    fovy, aspect, near, far = np.deg2rad(65.0), 16 / 9, 0.1, 1000.0
    m = perspective(fovy, aspect, near, far)
    y = 1.0 / np.tan(0.5 * fovy)
    z = 1.0 / (far - near)
    np.testing.assert_allclose(m[0, 0], y / aspect, rtol=1e-6)
    np.testing.assert_allclose(m[1, 1], y, rtol=1e-6)
    np.testing.assert_allclose(m[2, 2], -(near + far) * z, rtol=1e-6)
    np.testing.assert_allclose(m[2, 3], -2 * near * far * z, rtol=1e-6)
    assert m[3, 2] == 1.0 and m[3, 3] == 0.0


def test_planar_view_constants_inverses():
    cam = default_camera(window_size=(640, 360))
    pvc = cam.planar_view_constants()
    np.testing.assert_allclose(
        pvc.mat_world_to_view @ pvc.mat_view_to_world, np.eye(4), atol=1e-4)
    np.testing.assert_allclose(
        pvc.mat_view_to_clip @ pvc.mat_clip_to_view, np.eye(4), atol=1e-4)
    np.testing.assert_allclose(
        pvc.mat_world_to_clip,
        pvc.mat_view_to_clip @ pvc.mat_world_to_view, atol=1e-4)
    np.testing.assert_allclose(pvc.viewport_size, [640, 360])
    np.testing.assert_allclose(
        pvc.clip_to_window_scale, [320, -180])  # camera.rs:113
    np.testing.assert_allclose(pvc.camera_direction_or_position,
                               [*cam.position, 1.0])


def test_camera_update_forward():
    cam = default_camera()
    moved = cam.update(Controls(go_forward=True), delta_time=0.1)
    # go_forward SUBTRACTS direction (camera.rs:67-69)
    expected = np.asarray(cam.position) - np.asarray(cam.direction) * 30.0 * 0.1
    np.testing.assert_allclose(np.asarray(moved.position), expected, atol=1e-5)
    # direction unchanged without look_around
    np.testing.assert_allclose(np.asarray(moved.direction),
                               np.asarray(cam.direction))


def test_camera_look_around_normalized():
    cam = default_camera()
    turned = cam.update(
        Controls(look_around=True, cursor_delta=(10.0, -5.0)), delta_time=0.016)
    d = np.asarray(turned.direction)
    np.testing.assert_allclose(np.linalg.norm(d), 1.0, atol=1e-5)
    assert not np.allclose(d, np.asarray(cam.direction))


def test_camera_direction_always_normalized():
    cam = Camera(position=(0, 0, 0), direction=(3.0, 4.0, 0.0), fov=65,
                 aspect_ratio=1.0, z_near=0.1, z_far=100.0)
    np.testing.assert_allclose(np.linalg.norm(cam.direction), 1.0, atol=1e-6)


# ---------------------------------------------------------------------------
# The f32 view maths against float64 numpy: the products run at HIGHEST
# precision, so a GPU that would take a plain f32 matrix product in TF32
# still matches (render/rays.py).
# ---------------------------------------------------------------------------

def _views():
    cur = default_camera(window_size=(320, 180), position=(1.0, 2.0, -7.0),
                         direction=(0.1, -0.2, 1.0)).planar_view_constants()
    prev = default_camera(window_size=(320, 180), position=(1.3, 2.0, -7.4),
                          direction=(0.12, -0.2, 1.0)).planar_view_constants()
    return cur, prev


def _f64(m):
    return np.asarray(m, np.float64)


def _primary_f64(view, px, py):
    uv = (np.stack([px, py], -1) + 0.5) / _f64(view.viewport_size)
    clip = np.concatenate([uv * 2.0 - 1.0, np.ones((px.size, 2))], -1)
    target = clip @ _f64(view.mat_clip_to_view).T
    tdir = target[:, :3] / np.linalg.norm(target[:, :3], axis=-1,
                                          keepdims=True)
    return tdir @ _f64(view.mat_view_to_world)[:3, :3].T


def _motion_f64(view, prev, world):
    hom = np.concatenate([world, np.ones((world.shape[0], 1))], -1)
    clip = hom @ _f64(view.mat_world_to_clip).T
    pclip = hom @ _f64(prev.mat_world_to_clip).T
    ndc = clip[:, :2] / clip[:, 3:4]
    pndc = pclip[:, :2] / pclip[:, 3:4]
    xy = (pndc - ndc) / 2.0 * _f64(view.viewport_size)
    return np.concatenate([xy, (pclip[:, 3] - clip[:, 3])[:, None]], -1)


def _env_motion_f64(view, prev, window):
    clip_xy = (_f64(view.window_to_clip_scale) * window
               + _f64(view.window_to_clip_bias))
    clip = np.concatenate([clip_xy, np.zeros((window.shape[0], 1)),
                           np.ones((window.shape[0], 1))], -1)
    world = clip @ _f64(view.mat_clip_to_world).T
    pclip = world @ _f64(prev.mat_world_to_clip).T
    return _f64(view.clip_to_window_scale) * (pclip[:, :2] / pclip[:, 3:4]
                                              - clip_xy)


@pytest.mark.parametrize("case", ["primary", "motion", "environment"])
def test_view_maths_match_float64(case):
    import jax.numpy as jnp

    from raytracer2.render import rays as raysmod

    view, prev = _views()
    rng = np.random.default_rng(3)
    px = rng.integers(0, 320, 512)
    py = rng.integers(0, 180, 512)
    if case == "primary":
        got = raysmod.setup_primary_ray(jnp.asarray(px), jnp.asarray(py),
                                        view).direction
        want = _primary_f64(view, px, py)
        scale = 1.0
    elif case == "motion":
        world = _primary_f64(view, px, py) * rng.uniform(
            2.0, 40.0, (512, 1)) + _f64(view.camera_direction_or_position)[:3]
        got = raysmod.get_motion_vector(
            view, prev, jnp.asarray(world, jnp.float32),
            jnp.asarray(world, jnp.float32))
        want = _motion_f64(view, prev, np.asarray(world, np.float32))
        # compare in units of the viewport (xy) and of depth (z)
        scale = np.array([320.0, 180.0, 40.0])
    else:
        window = np.stack([px, py], -1) + 0.5
        got = raysmod.get_environment_motion_vector(
            view, prev, jnp.asarray(window, jnp.float32))
        want = _env_motion_f64(view, prev, window)
        scale = np.array([320.0, 180.0])
    np.testing.assert_allclose(np.asarray(got, np.float64) / scale,
                               want / scale, rtol=0, atol=1e-6)
