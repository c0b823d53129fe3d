"""Golden-image regression: each pass's output on a tiny deterministic
scene, compared against checked-in snapshots ('a silent
estimator-bias regression would pass CI' without these).

Goldens are generated on the CPU backend (the CI platform) by running
this file as a script:  python tests/test_goldens.py --regen
Tolerances absorb cross-libm fp noise, not estimator changes; the same
scene runs on the GPU against these files in chip_smoke.py.
"""

from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracer2.models import procedural as proc
from raytracer2.params import default_gconst
from raytracer2.render.frame import (
    create_renderer, init_frame_state, render_frame)
from raytracer2.scene import gltf
from raytracer2.scene.camera import default_camera
from raytracer2.scene.scene import build_scene

W = H = 16
GOLDEN_DIR = Path(__file__).parent / "goldens"


def _setup():
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        p = Path(d) / "c.glb"
        proc.write_glb(p, proc.cornell_box_glb(light_emission=2.0))
        scene = build_scene(gltf.load_file(p))
    renderer = create_renderer(scene, W, H)
    # slightly off the box's axis: from the centre, six pixel rays pass
    # exactly through mesh edges, where hit or miss is decided by the last
    # bit of rounding, which differs between CPU and GPU code generation
    cam = default_camera(window_size=(W, H), position=(0.031, -0.017, -12),
                         direction=(0, 0, -1))
    g = default_gconst(cam.planar_view_constants(),
                       renderer.scene_lights.num_local_lights,
                       enable_restir_di=1, enable_restir_gi=1,
                       enable_temporal_resampling=1,
                       enable_spatial_resampling=1)
    return renderer, g


def _render(renderer, g):
    fn = jax.jit(lambda gc, s: render_frame(renderer, gc, s))
    state = init_frame_state(W, H)
    for f in range(2):
        state, img = fn(g.replace(frame=jnp.uint32(f)), state)
    return {
        "depth": np.asarray(state.gbuffer.depth),
        "normals_bits": np.asarray(state.gbuffer.normals).astype(np.int64),
        "diffuse": np.asarray(state.diffuse_lighting),
        "specular": np.asarray(state.specular_lighting),
        "display": np.asarray(img),
    }


_CASES = ("depth", "normals_bits", "diffuse", "specular", "display")


@pytest.fixture(scope="module")
def outputs():
    renderer, g = _setup()
    return _render(renderer, g)


@pytest.mark.parametrize("name", _CASES)
def test_golden(outputs, name):
    path = GOLDEN_DIR / f"{name}.npy"
    assert path.exists(), f"golden missing — run python {__file__} --regen"
    want = np.load(path)
    got = outputs[name]
    if name == "normals_bits":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


if __name__ == "__main__":
    import sys

    jax.config.update("jax_platforms", "cpu")
    if "--regen" in sys.argv:
        GOLDEN_DIR.mkdir(exist_ok=True)
        renderer, g = _setup()
        for name, arr in _render(renderer, g).items():
            np.save(GOLDEN_DIR / f"{name}.npy", arr)
            print("wrote", name, arr.shape)
