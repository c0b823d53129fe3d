"""Image-error integration tests: ReSTIR output vs the brute-force oracle.

BASELINE.md's strict RMSE <= 1e-2 gate applies to converged high-spp renders
on the benchmark ladder (device scale); these CPU-sized tests check the two
properties that gate implies: accumulation CONVERGES toward the oracle
(error shrinks with frames) and the estimators agree on ENERGY (no bias).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from raytracer2.models import procedural as proc
from raytracer2.params import default_gconst
from raytracer2.render.frame import (
    create_renderer, init_frame_state, render_frame)
from raytracer2.render.reference import render_reference
from raytracer2.scene import gltf
from raytracer2.scene.camera import default_camera
from raytracer2.scene.scene import build_scene

W = H = 32


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    p = tmp_path_factory.mktemp("r") / "c.glb"
    proc.write_glb(p, proc.cornell_box_glb(light_emission=2.0))
    scene = build_scene(gltf.load_file(p))
    renderer = create_renderer(scene, W, H)
    cam = default_camera(window_size=(W, H), position=(0, 0, -12),
                         direction=(0, 0, -1))
    view = cam.planar_view_constants()
    return scene, renderer, view


def _tm(x):
    x = np.asarray(x)
    return x / (1.0 + x)  # bounded tone curve for stable RMSE


def _rmse(a, b):
    return float(np.sqrt(np.mean((_tm(a) - _tm(b)) ** 2)))


def _accumulate_reference(renderer, view, n_frames, frame0=0):
    g = default_gconst(view, 2, refrence_mode=1, enable_accumulation=1)
    state = init_frame_state(W, H)
    checkpoints = {}
    for i in range(n_frames):
        gf = g.replace(frame=jnp.uint32(frame0 + i),
                       blend_factor=jnp.float32(1.0 / (i + 1)))
        state, _ = render_frame(renderer, gf, state)
        checkpoints[i + 1] = np.asarray(state.diffuse_lighting)
    return checkpoints


def test_reference_accumulation_converges_to_oracle(setup):
    scene, renderer, view = setup
    oracle = np.asarray(render_reference(
        scene, default_gconst(view, 2, refrence_mode=1), W, H,
        max_bounces=4, max_samples=64,
        trace_fn=renderer.tracers.closest_hit))

    acc = _accumulate_reference(renderer, view, n_frames=12)
    early = _rmse(acc[2], oracle)
    late = _rmse(acc[12], oracle)
    # error vs the (noisy) oracle shrinks as accumulation converges
    assert late < early, f"no convergence: rmse {early} -> {late}"
    # energy agreement: both estimate the same integral
    ratio = acc[12].mean() / max(oracle.mean(), 1e-9)
    assert 0.8 < ratio < 1.25, f"energy mismatch ratio {ratio}"


def test_independent_accumulations_agree(setup):
    """Two accumulations with disjoint RNG streams converge to each other —
    the estimator is consistent (catches systematic bias in traversal,
    material fetch, RNG wiring)."""
    scene, renderer, view = setup
    a = _accumulate_reference(renderer, view, n_frames=10, frame0=0)[10]
    b = _accumulate_reference(renderer, view, n_frames=10, frame0=1000)[10]
    rmse_ab = _rmse(a, b)
    assert rmse_ab < 0.12, f"independent runs disagree: {rmse_ab}"
    ratio = a.mean() / max(b.mean(), 1e-9)
    assert 0.85 < ratio < 1.18


def test_gi_pipeline_energy_and_structure(setup):
    """Single-bounce ReSTIR GI vs the oracle: same scene structure (spatial
    correlation of the display image) and same order of magnitude of energy
    (GI carries fewer bounces, so it may be dimmer but not wildly off)."""
    scene, renderer, view = setup
    g_ref = default_gconst(view, 2, refrence_mode=1, enable_accumulation=1)
    state = init_frame_state(W, H)
    img_ref = None
    for f in range(6):
        state, img_ref = render_frame(
            renderer, g_ref.replace(frame=jnp.uint32(f),
                                    blend_factor=jnp.float32(1 / (f + 1))),
            state)
    img_ref = np.asarray(img_ref)

    g_gi = default_gconst(view, 2, enable_restir_gi=1, enable_restir_di=0)
    state = init_frame_state(W, H)
    outs = []
    for f in range(8):
        state, img = render_frame(
            renderer, g_gi.replace(frame=jnp.uint32(f)), state)
        outs.append(np.asarray(img))
    img_gi = np.mean(outs, axis=0)

    a = img_ref.reshape(-1)
    b = img_gi.reshape(-1)
    corr = np.corrcoef(a, b)[0, 1]
    assert corr > 0.35, f"GI/display correlation too low: {corr}"
    assert 0.15 < b.mean() / max(a.mean(), 1e-6) < 6.0


def _oracle_display(scene, renderer, view, bounces, frames=60, spp=16):
    """Converged front-facing-emission oracle, through the display path."""
    import jax

    from raytracer2.render.postprocess import (
        PostProcessInputs, post_process)

    g1 = default_gconst(view, renderer.scene_lights.num_local_lights,
                        refrence_mode=1)
    fn_o = jax.jit(lambda gc: render_reference(
        scene, gc, W, H, max_bounces=bounces, max_samples=spp,
        trace_fn=renderer.tracers.closest_hit, emission_facing="front"))
    acc = np.zeros((H, W, 3), np.float32)
    for f in range(frames):
        acc += np.asarray(fn_o(g1.replace(frame=jnp.uint32(f))))
    acc /= frames
    z = jnp.zeros((H, W, 3), jnp.float32)
    disp, _ = post_process(scene, g1, PostProcessInputs(
        depth=jnp.zeros((H, W)), diffuse_albedo=z, specular_f0=z,
        emissive=z, diffuse=jnp.asarray(acc), specular=z))
    return np.asarray(disp)


def test_di_display_matches_oracle_strict(setup):
    """THE estimator-bias gate: converged ReSTIR DI (4 NEE + 1 BRDF
    candidates, final visibility, corrected specular accumulation) vs a
    transport-matched converged oracle (2 bounces, front-facing emission),
    compared on tone-mapped display images. The threshold sits just above
    the measured Monte-Carlo noise floor (~0.024 at these sample counts) —
    any systematic estimator bias (wrong MIS weights, pdf mismatches,
    phantom lights, back-face leaks — all bugs this gate caught during
    round 2) pushes RMSE well past it."""
    import dataclasses

    import jax

    from raytracer2.render.frame import render_frame as rf

    scene, renderer, view = setup
    oracle = _oracle_display(scene, renderer, view, bounces=2)

    g = default_gconst(view, renderer.scene_lights.num_local_lights,
                       enable_restir_di=1, enable_restir_gi=0,
                       enable_accumulation=1,
                       correct_specular_accumulation=1)
    isp = dataclasses.replace(g.restir_di.initial_sampling_params,
                              num_primary_local_light_samples=4)
    shp = dataclasses.replace(g.restir_di.shading_params,
                              enable_final_visibility=1)
    g = g.replace(restir_di=dataclasses.replace(
        g.restir_di, initial_sampling_params=isp, shading_params=shp))
    fn = jax.jit(lambda gc, s: rf(renderer, gc, s))
    state = init_frame_state(W, H)
    for f in range(150):
        state, img = fn(g.replace(frame=jnp.uint32(f),
                                  blend_factor=jnp.float32(1.0 / (f + 1))),
                        state)
    img = np.asarray(img)
    err = float(np.sqrt(np.mean((oracle - img) ** 2)))
    ratio = img.mean() / oracle.mean()
    assert err < 0.04, f"DI estimator bias: display RMSE {err:.4f}"
    assert 0.97 < ratio < 1.03, f"DI energy off: ratio {ratio:.4f}"


def test_di_gi_display_matches_oracle(setup):
    """Full DI+GI (one indirect bounce) vs the 3-bounce front-facing
    oracle, converged in LINEAR space: the persistent lighting buffers
    are averaged across frames and post-processed once.

    Round-3 decomposition of the old -16% "energy deficit": averaging
    AgX-TONEMAPPED frames under-reports energy by the Jensen gap of the
    concave tonemap, and the gap scales with estimator variance — the
    spiky 1-BRDF-sample secondary DI (shade_secondary_surfaces.rgen:
    64-117) lost ~87% of its display-space indirect while a smooth
    4-local-sample variant lost almost none, even though both streams
    carry identical linear-space expectations (verified at the GI
    reservoir boundary: E[radiance*weight_sum] equal to ~3%). Converged
    linearly, DI+GI sits at ratio ~1.03 — the estimator is unbiased, so
    the gate is tight."""
    import dataclasses

    import jax

    from raytracer2.render.frame import render_frame as rf
    from raytracer2.render.postprocess import (
        PostProcessInputs, post_process)
    from raytracer2.utils import packing as pk

    scene, renderer, view = setup
    oracle = _oracle_display(scene, renderer, view, bounces=3)

    g = default_gconst(view, renderer.scene_lights.num_local_lights,
                       enable_restir_di=1, enable_restir_gi=1,
                       enable_temporal_resampling=0,
                       enable_spatial_resampling=0)
    isp = dataclasses.replace(g.restir_di.initial_sampling_params,
                              num_primary_local_light_samples=4)
    g = g.replace(restir_di=dataclasses.replace(
        g.restir_di, initial_sampling_params=isp))
    fn = jax.jit(lambda gc, s: rf(renderer, gc, s))
    state = init_frame_state(W, H)
    accd = np.zeros((H, W, 3), np.float32)
    accs = np.zeros((H, W, 3), np.float32)
    n_frames = 150
    for f in range(n_frames):
        state, _ = fn(g.replace(frame=jnp.uint32(f)), state)
        accd += np.asarray(state.diffuse_lighting)
        accs += np.asarray(state.specular_lighting)
    accd /= n_frames
    accs /= n_frames
    gb = state.gbuffer
    acc, _ = post_process(scene, g, PostProcessInputs(
        depth=gb.depth,
        diffuse_albedo=pk.unpack_r11g11b10_ufloat(gb.diffuse_albedo),
        specular_f0=pk.unpack_rgba8_gamma_ufloat(
            gb.specular_rough)[..., :3],
        emissive=gb.emissive,
        diffuse=jnp.asarray(accd),
        specular=jnp.asarray(accs)))
    acc = np.asarray(acc)
    err = float(np.sqrt(np.mean((oracle - acc) ** 2)))
    ratio = acc.mean() / oracle.mean()
    assert err < 0.12, f"DI+GI display RMSE {err:.4f}"
    # measured 1.028 at 300 frames (DI alone converges to 1.042 on this
    # config; the GI increment itself is ~0.98 of the oracle's) — the
    # bound leaves ~2x the observed frame-count wobble above that
    assert 0.95 < ratio < 1.08, f"DI+GI energy ratio {ratio:.4f}"
