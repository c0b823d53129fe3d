"""bench.capture_frame_rays: the traversal batches one flagship frame
traces, recorded from inside the jitted frame."""

import numpy as np
import jax.numpy as jnp
import pytest

import bench
from raytracer2.render.frame import init_frame_state
from raytracer2.render.rays import setup_primary_ray

W, H = 16, 8


@pytest.fixture(scope="module")
def case():
    scene, renderer, cam = bench.build_case("cornell", W, H)
    return renderer, bench.flagship_gconst(renderer, cam)


@pytest.mark.parametrize("visibility", [False, True])
def test_capture_frame_rays(case, visibility):
    renderer, g = case
    if visibility:
        g = bench.with_final_visibility(g)
    calls = bench.capture_frame_rays(renderer, g, init_frame_state(W, H))
    sites = [(site, query) for site, query, _ in calls]

    # the G-buffer's camera rays come first, one per pixel
    site, query, (o, d, tmin, tmax) = calls[0]
    assert (site, query) == ("gbuffer.gbuffer_pass", "closest")
    for a in (o, d, tmin, tmax):
        assert isinstance(a, np.ndarray) and a.shape[0] == W * H
    assert o.shape == d.shape == (W * H, 3)
    px, py = (jnp.asarray(v) for v in np.meshgrid(np.arange(W),
                                                   np.arange(H)))
    want = setup_primary_ray(px.reshape(-1), py.reshape(-1), g.view)
    np.testing.assert_allclose(np.sort(d, axis=0),
                               np.sort(np.asarray(want.direction), axis=0),
                               rtol=1e-6, atol=1e-6)

    # at the reference's defaults the frame traces no any-hit rays; final
    # visibility adds one batch for DI shading and one for GI final shading
    occluded = sorted(s for s, q in sites if q == "occluded")
    if visibility:
        assert occluded == ["gi_passes._gi_final_shading_body",
                            "shading.shade_surface_with_light_sample"]
    else:
        assert occluded == []
    assert ("gi_passes._brdf_rays_body", "closest") in sites
