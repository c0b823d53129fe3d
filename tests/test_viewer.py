"""Interactive viewer logic (raytracer2/viewer.py): the pure
helpers that the TTY loop delegates to — key folding into the Camera
Controls port (camera.rs:45-97 / main.rs key map) and the half-block
frame encoding."""

import numpy as np

from raytracer2.params import default_gconst
from raytracer2.scene.camera import default_camera
from raytracer2.viewer import apply_keys, image_to_ansi


def _setup():
    cam = default_camera(window_size=(64, 64), position=(0.0, 0.0, 10.0),
                         direction=(0.0, 0.0, 1.0))
    g = default_gconst(cam.planar_view_constants(), 1)
    return cam, g


class TestApplyKeys:
    def test_forward_moves_against_direction(self):
        # camera.rs:66 quirk: go_forward moves along -direction (paired
        # with the opposite-pointing primary rays, camera.py:51)
        cam, g = _setup()
        cam2, _, quit_ = apply_keys("w", cam, g, dt=0.1)
        assert not quit_
        assert cam2.position[2] < cam.position[2]
        assert cam2.direction == cam.direction

    def test_look_rotates_direction(self):
        cam, g = _setup()
        cam2, _, _ = apply_keys("l", cam, g, dt=0.1)
        assert cam2.direction != cam.direction
        # still unit length
        np.testing.assert_allclose(
            np.linalg.norm(np.asarray(cam2.direction)), 1.0, rtol=1e-5)

    def test_toggles_flip_gconst_fields(self):
        cam, g = _setup()
        di0 = g.enable_restir_di
        _, g2, _ = apply_keys("1", cam, g, dt=0.1)
        assert g2.enable_restir_di == 1 - di0
        _, g3, _ = apply_keys("11", cam, g, dt=0.1)
        assert g3.enable_restir_di == di0

    def test_quit_keys(self):
        cam, g = _setup()
        for key in ("x", "\x1b", "\x03"):
            _, _, quit_ = apply_keys(key, cam, g, dt=0.1)
            assert quit_

    def test_no_keys_is_identity(self):
        cam, g = _setup()
        cam2, g2, quit_ = apply_keys("", cam, g, dt=0.1)
        assert cam2.position == cam.position
        assert g2 is g
        assert not quit_


class TestImageToAnsi:
    def test_shape_and_colors(self):
        img = np.zeros((8, 8, 3), np.uint8)
        img[:4] = (255, 0, 0)   # top half red
        img[4:] = (0, 0, 255)   # bottom half blue
        s = image_to_ansi(img, cols=4, rows=2)
        lines = s.split("\n")
        assert len(lines) == 2
        assert s.count("▀") == 8  # cols * rows cells
        # row 0 covers image rows 0-3: red fg over red bg
        assert "\x1b[38;2;255;0;0m" in lines[0]
        assert "\x1b[48;2;0;0;255m" in lines[1]
        assert s.startswith("\x1b[H")
        assert lines[0].endswith("\x1b[0m")
