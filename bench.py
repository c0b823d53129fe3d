"""Benchmark driver: prints ONE JSON line with the headline metric.

Headline: ray throughput (Mrays/s/chip) of the jitted reference path tracer
at the BASELINE.md ladder config #3 — a Sponza-class ~260k-triangle
procedural corridor at 1920x1080, 8 spp, 5 bounces (the north-star is
>= 200 Mrays/s/chip there). The run also measures:

- "quick": the 256x256 / 18.5k-tri corridor config benchmarked since round
  1, for round-over-round comparability;
- "pipeline": the flagship ReSTIR DI+GI frame graph at 1080p — p50/p95
  frame time and rays/s (the reference's real-time contract,
  /root/reference/src/main.rs:653-656);
- honest ray accounting: nominal rays (W*H*spp*bounces) AND live rays
  (lanes not yet terminated by a miss), so numbers survive scene changes.

Usage:
    python bench.py              # full ladder + quick + pipeline
    python bench.py --quick      # only the round-1 comparable config
    python bench.py --smoke      # tiny/fast correctness smoke (CPU-friendly)
    python bench.py --mode pipeline ...
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import threading
import time
from pathlib import Path

from raytracer2.render.app_bridge import BACKENDS

BASELINE_MRAYS = 200.0  # north-star target (BASELINE.md, ladder config 3)


def enable_compile_cache():
    """Back-compat shim; the real implementation lives in the package
    (raytracer2/compile_cache.py, ADVICE r3)."""
    from raytracer2.compile_cache import enable_compile_cache as impl

    return impl()


def build_case(scene_kind: str, width: int, height: int,
               backend: str = "auto"):
    """(scene, renderer, camera) for one of the bench scenes, generated
    from fixed seeds by models/procedural.py."""
    from raytracer2.models import procedural as proc
    from raytracer2.render.frame import create_renderer
    from raytracer2.scene import gltf
    from raytracer2.scene.camera import default_camera
    from raytracer2.scene.scene import build_scene

    with tempfile.TemporaryDirectory() as d:
        p = Path(d) / "scene.glb"
        if scene_kind == "ladder":
            # ~260k tris (BASELINE ladder config 3, Sponza-class)
            proc.write_glb(p, proc.corridor_glb(
                segments=24, pillars_per_side=12, lat=34, lon=53))
            cam = default_camera(window_size=(width, height),
                                 position=(0, 4, 90), direction=(0, 0, 1))
        elif scene_kind == "corridor":
            proc.write_glb(p, proc.corridor_glb(
                segments=12, pillars_per_side=8, lat=12, lon=16))
            cam = default_camera(window_size=(width, height),
                                 position=(0, 4, 60), direction=(0, 0, 1))
        elif scene_kind == "duck":
            # BASELINE config 2: ~10k-tri textured object class
            proc.write_glb(p, proc.sphere_grid_glb(
                n=2, lat=28, lon=40, emissive_every=4, textured=True))
            cam = default_camera(window_size=(width, height),
                                 position=(0, 1.5, -7), direction=(0, 0, -1))
        elif scene_kind == "emissive":
            # BASELINE config 4: 1k+ area lights (reservoir sampling +
            # PDF-mip presample stress)
            proc.write_glb(p, proc.emissive_stress_glb(num_lights=1024))
            cam = default_camera(window_size=(width, height),
                                 position=(0, 10, -52),
                                 direction=(0, 0.25, -1))
        else:
            proc.write_glb(p, proc.cornell_box_glb(light_emission=2.0))
            cam = default_camera(window_size=(width, height),
                                 position=(0, 0, -12), direction=(0, 0, -1))
        scene = build_scene(gltf.load_file(p))
    renderer = create_renderer(scene, width, height, use_bvh=True,
                               backend=backend)
    return scene, renderer, cam


def run_reference(width: int, height: int, spp: int, bounces: int,
                  frames: int, scene_kind: str,
                  backend: str = "auto") -> dict:
    import numpy as np

    import jax
    import jax.numpy as jnp

    from raytracer2.params import default_gconst
    from raytracer2.render.reference import render_reference

    scene, renderer, cam = build_case(scene_kind, width, height, backend)
    g_const = default_gconst(
        cam.planar_view_constants(),
        renderer.scene_lights.num_local_lights, refrence_mode=1)

    fn = jax.jit(lambda g: render_reference(
        scene, g, width, height, max_bounces=bounces, max_samples=spp,
        trace_fn=renderer.tracers.closest_hit, with_ray_count=True))

    # compile + warmup
    img, live = fn(g_const)
    jax.block_until_ready(img)

    t0 = time.perf_counter()
    lives = []
    for i in range(frames):
        img, live = fn(g_const.replace(frame=jnp.uint32(i + 1)))
        lives.append(live)  # device values; read back after timing
    jax.block_until_ready(img)
    elapsed = time.perf_counter() - t0
    # one readback for all frames' live-ray counters, after timing
    total_live = int(np.asarray(jnp.stack(lives)).sum())

    nominal = width * height * spp * bounces * frames
    mrays = nominal / elapsed / 1e6
    return {
        "mrays_nominal": round(mrays, 3),
        "mrays_live": round(total_live / elapsed / 1e6, 3),
        "scene": scene_kind,
        "triangles": scene.num_triangles,
        "resolution": f"{width}x{height}",
        "spp": spp,
        "bounces": bounces,
        "frames": frames,
        "seconds": round(elapsed, 3),
        "rays_nominal": nominal,
        "rays_live": total_live,
        "platform": jax.devices()[0].platform,
        "backend": backend,
    }


def run_pipeline(width: int, height: int, frames: int, scene_kind: str,
                 backend: str = "auto", per_pass: bool = False,
                 checkerboard: bool = False,
                 enable_di: bool = False) -> dict:
    """Flagship ReSTIR DI+GI frame graph: p50/p95 frame time + rays/s.
    per_pass=True additionally times cumulative pass prefixes (each a
    separately jitted frame stopped after pass k) and reports diffs."""
    import numpy as np

    import jax
    import jax.numpy as jnp

    from raytracer2.params import default_gconst
    from raytracer2.render.frame import init_frame_state, render_frame
    from raytracer2.utils.profiler import count_frame_rays

    import dataclasses

    scene, renderer, cam = build_case(scene_kind, width, height, backend)
    g_const = default_gconst(
        cam.planar_view_constants(),
        renderer.scene_lights.num_local_lights)
    if enable_di:
        # the flagship DI+GI config (the app CLI default; GConst itself
        # keeps the reference's DI-off startup value for parity)
        g_const = g_const.replace(enable_restir_di=1)
    state = init_frame_state(width, height, checkerboard=checkerboard)

    def at_frame(i):
        g = g_const.replace(frame=jnp.uint32(i))
        if checkerboard:
            g = g.replace(runtime_params=dataclasses.replace(
                g.runtime_params, active_checkerboard_field=1 + (i & 1)))
        return g

    fn = jax.jit(lambda g, s: render_frame(renderer, g, s))
    state1, img = fn(at_frame(0), state)
    jax.block_until_ready(img)
    if checkerboard:  # compile the second field variant too
        state1, img = fn(at_frame(1), state1)
        jax.block_until_ready(img)

    times = []
    s = state
    for i in range(frames):
        t0 = time.perf_counter()
        s, img = fn(at_frame(i + 1), s)
        jax.block_until_ready(img)
        times.append(time.perf_counter() - t0)
    times_ms = np.asarray(times) * 1e3
    p50 = float(np.percentile(times_ms, 50))
    rays = count_frame_rays(at_frame(1), width, height)

    out = {
        "p50_ms": round(p50, 2),
        "p95_ms": round(float(np.percentile(times_ms, 95)), 2),
        "rays_per_frame": rays,
        "mrays_nominal": round(rays / (p50 / 1e3) / 1e6, 3),
        "scene": scene_kind,
        "triangles": scene.num_triangles,
        "resolution": f"{width}x{height}",
        "frames": frames,
        "platform": jax.devices()[0].platform,
        "backend": backend,
    }

    if per_pass:
        from raytracer2.render.frame import FRAME_PASSES

        breakdown = {}
        prev = 0.0
        for stop in FRAME_PASSES:
            pfn = jax.jit(lambda g, s, stop=stop: render_frame(
                renderer, g, s, stop_after=stop))
            out_s = pfn(g_const, state)
            jax.block_until_ready(out_s)
            ts = []
            for i in range(max(frames // 2, 2)):
                t0 = time.perf_counter()
                r = pfn(g_const.replace(frame=jnp.uint32(i + 1)), state)
                jax.block_until_ready(r)
                ts.append(time.perf_counter() - t0)
            cum = float(np.percentile(np.asarray(ts) * 1e3, 50))
            breakdown[stop] = round(max(cum - prev, 0.0), 2)
            prev = max(cum, prev)
        out["per_pass_ms"] = breakdown
    return out


def ray_classes(scene, trace_fn, view, px, py, seed: int = 0) -> dict:
    """Synthetic rays of three kinds for pixels (px, py), for checking an
    engine against the brute-force oracle (chip_smoke.py): primary camera
    rays, cosine BRDF bounces off their closest hits (random points in the
    scene box where the camera ray missed), and shadow segments from the
    same origins to uniform points on random scene triangles. The segments
    are longer and less coherent than the frame's light-sample shadow rays,
    so they stress the any-hit query but say nothing of its cost in a
    frame (capture_frame_rays has the frame's own batches).
    Returns {class: (origins, directions, t_min, t_max)} device arrays."""
    import jax
    import jax.numpy as jnp

    from raytracer2.render import rays as raysmod

    pr = raysmod.setup_primary_ray(px, py, view)
    n = px.shape[0]
    hit = trace_fn(pr.origin, pr.direction, pr.t_min, pr.t_max)
    tri = jnp.maximum(hit.triangle_index, 0)
    nrm = jnp.cross(scene.tri_edge1[tri], scene.tri_edge2[tri])
    nrm = nrm / jnp.maximum(jnp.linalg.norm(nrm, axis=1, keepdims=True),
                            1e-30)
    nrm = jnp.where((jnp.sum(nrm * pr.direction, axis=1) > 0)[:, None],
                    -nrm, nrm)
    keys = jax.random.split(jax.random.key(seed), 4)
    lo = jnp.min(scene.tri_v0, axis=0)
    hi = jnp.max(scene.tri_v0, axis=0)
    p = jnp.where(hit.missed[:, None],
                  jax.random.uniform(keys[0], (n, 3), minval=lo, maxval=hi),
                  pr.origin + pr.direction * hit.t[:, None])

    # cosine-weighted hemisphere around the facing normal
    u1, u2 = jax.random.uniform(keys[1], (2, n))
    r, phi = jnp.sqrt(u1), 2.0 * jnp.pi * u2
    axis = jnp.where((jnp.abs(nrm[:, :1]) > 0.9),
                     jnp.asarray([[0.0, 1.0, 0.0]]),
                     jnp.asarray([[1.0, 0.0, 0.0]]))
    t_ax = jnp.cross(axis, nrm)
    t_ax = t_ax / jnp.linalg.norm(t_ax, axis=1, keepdims=True)
    b_ax = jnp.cross(nrm, t_ax)
    bounce = ((r * jnp.cos(phi))[:, None] * t_ax
              + (r * jnp.sin(phi))[:, None] * b_ax
              + jnp.sqrt(1.0 - u1)[:, None] * nrm)

    k = jax.random.randint(keys[2], (n,), 0, scene.num_triangles)
    w1, w2 = jax.random.uniform(keys[3], (2, n))
    flip = w1 + w2 > 1.0
    w1, w2 = jnp.where(flip, 1.0 - w1, w1), jnp.where(flip, 1.0 - w2, w2)
    target = (scene.tri_v0[k] + w1[:, None] * scene.tri_edge1[k]
              + w2[:, None] * scene.tri_edge2[k])
    seg = target - p
    dist = jnp.linalg.norm(seg, axis=1)
    eps = jnp.full((n,), 1e-3, jnp.float32)
    return {
        "primary": (pr.origin, pr.direction, pr.t_min, pr.t_max),
        "brdf": (p, bounce, eps, jnp.full((n,), 1e5, jnp.float32)),
        # t_max as shading.setup_visibility_ray sets it
        "shadow": (p, seg / jnp.maximum(dist, 1e-30)[:, None], eps,
                   jnp.maximum(eps, dist - 2e-3)),
    }


def flagship_gconst(renderer, cam):
    """The flagship frame: DI + GI with temporal and spatial resampling."""
    from raytracer2.params import default_gconst

    return default_gconst(
        cam.planar_view_constants(), renderer.scene_lights.num_local_lights,
        enable_restir_di=1, enable_restir_gi=1,
        enable_temporal_resampling=1, enable_spatial_resampling=1)


def capture_frame_rays(renderer, g_const, state) -> list:
    """Every traversal call one render_frame traces, in call order, as
    (site, query, (origins, directions, t_min, t_max)) host arrays. site
    is the render or restir function that asked for the rays; query is
    "closest" or "occluded". The frame runs once under jit with each
    engine call copying its inputs to the host (jax.debug.callback), so a
    call inside a lax.map (row bands at 4K) records once per band."""
    import inspect

    import numpy as np

    import jax
    import jax.numpy as jnp

    from raytracer2.render.app_bridge import Tracers
    from raytracer2.render.frame import render_frame

    calls: list = []

    def caller() -> str:
        for f in inspect.stack()[2:]:
            path = Path(f.filename)
            if "raytracer2" in path.parts and path.name != "app_bridge.py":
                return f"{path.stem}.{f.function}"
        return "?"

    def record(fn, query):
        def traced(o, d, tmin, tmax):
            site = caller()
            n = o.shape[:1]

            def keep(*rays):
                calls.append((site, query, tuple(np.asarray(a)
                                                 for a in rays)))

            jax.debug.callback(keep, o, d, jnp.broadcast_to(tmin, n),
                               jnp.broadcast_to(tmax, n))
            return fn(o, d, tmin, tmax)
        return traced

    tracers = renderer.tracers
    recording = renderer._replace(tracers=Tracers(
        closest_hit=record(tracers.closest_hit, "closest"),
        occluded=record(tracers.occluded, "occluded")))
    out = jax.jit(lambda g, s: render_frame(recording, g, s))(g_const, state)
    jax.block_until_ready(out)
    jax.effects_barrier()
    return calls


def with_final_visibility(g):
    """g with the DI and GI final-shading visibility rays on (off at the
    reference's defaults, so the flagship frame traces no shadow rays)."""
    import dataclasses

    di, gi = g.restir_di, g.restir_gi
    return g.replace(
        restir_di=dataclasses.replace(di, shading_params=dataclasses.replace(
            di.shading_params, enable_final_visibility=1)),
        restir_gi=dataclasses.replace(
            gi, final_shading_params=dataclasses.replace(
                gi.final_shading_params, enable_final_visibility=1)))


def run_trace_frame(width: int = 1920, height: int = 1080,
                    scene_kind: str = "ladder", backend: str = "auto",
                    visibility: bool = False, reps: int = 5) -> dict:
    """The traversal engine alone on the batches one flagship frame
    traces (capture_frame_rays on the second frame, after one frame of
    temporal history), next to that frame's own time. visibility=True
    runs the flagship frame with_final_visibility. Each batch is timed as
    the frame calls it: median ms over reps, one engine call per batch.
    Classes: primary (the G-buffer pass), brdf (other closest-hit
    queries), shadow (any-hit queries)."""
    import numpy as np

    import jax
    import jax.numpy as jnp

    from raytracer2.render.frame import init_frame_state, render_frame

    scene, renderer, cam = build_case(scene_kind, width, height, backend)
    g = flagship_gconst(renderer, cam)
    if visibility:
        g = with_final_visibility(g)
    frame = jax.jit(lambda gc, s: render_frame(renderer, gc, s))
    state, img = frame(g, init_frame_state(width, height))
    jax.block_until_ready(img)
    ts = []
    for i in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(frame(g.replace(frame=jnp.uint32(1)), state))
        ts.append(time.perf_counter() - t0)
    frame_ms = float(np.median(ts)) * 1e3

    calls = capture_frame_rays(renderer, g.replace(frame=jnp.uint32(1)),
                               state)
    engines = {"closest": jax.jit(renderer.tracers.closest_hit),
               "occluded": jax.jit(renderer.tracers.occluded)}
    batches, classes = [], {}
    for site, query, host in calls:
        rays = tuple(jnp.asarray(a) for a in host)
        fn = engines[query]
        jax.block_until_ready(fn(*rays))  # compile + warm up
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*rays))
            ts.append(time.perf_counter() - t0)
        ms = float(np.median(ts)) * 1e3
        n = int(host[0].shape[0])
        live = int(np.sum(host[3] > host[2]))
        cls = ("shadow" if query == "occluded" else
               "primary" if site.startswith("gbuffer.") else "brdf")
        batches.append({"site": site, "query": query, "class": cls,
                        "rays": n, "live": live, "ms": ms,
                        "mrays": n / ms / 1e3})
        c = classes.setdefault(cls, {"batches": 0, "rays": 0, "ms": 0.0})
        c["batches"] += 1
        c["rays"] += n
        c["ms"] += ms
    traversal_ms = sum(b["ms"] for b in batches)
    d = jax.devices()[0]
    return {"scene": scene_kind, "triangles": scene.num_triangles,
            "resolution": f"{width}x{height}", "backend": backend,
            "final_visibility": visibility,
            "platform": d.platform, "device_kind": d.device_kind,
            "frame_ms": frame_ms, "traversal_ms": traversal_ms,
            "traversal_share": traversal_ms / frame_ms,
            "classes": classes, "batches": batches}


def run_flythrough(width: int = 3840, height: int = 2160,
                   frames: int = 3, scene_kind: str = "ladder",
                   backend: str = "auto") -> dict:
    """BASELINE config 5: 4K camera fly-through through the full ReSTIR
    DI+GI pipeline with post-process/tonemap and temporal accumulation.
    The camera dollies forward each frame (app.py --orbit analogue), so
    view/prev_view and motion vectors are exercised for real. Runs in this
    process; an error (e.g. out of device memory) is the stage's result."""
    import numpy as np

    import jax
    import jax.numpy as jnp

    from raytracer2.params import default_gconst
    from raytracer2.render.frame import init_frame_state, render_frame
    from raytracer2.scene.camera import default_camera
    from raytracer2.utils.profiler import count_frame_rays

    z0 = 90 if scene_kind == "ladder" else 60
    w, h = width, height

    scene, renderer, cam = build_case(scene_kind, w, h, backend)
    g_const = default_gconst(
        cam.planar_view_constants(),
        renderer.scene_lights.num_local_lights).replace(
        enable_restir_di=1, enable_restir_gi=1, enable_accumulation=1)

    def view_at(i):
        # dolly forward along the corridor axis
        return default_camera(
            window_size=(w, h), position=(0, 4, z0 - 2.0 * i),
            direction=(0, 0, 1)).planar_view_constants()

    def g_at(i, v, prev):
        return g_const.replace(view=v, prev_view=prev, frame=jnp.uint32(i))

    # donate the frame state: at 4K the previous frame's planes are
    # ~1.5 GB the jit would otherwise hold live across the call
    fn = jax.jit(lambda g, s: render_frame(renderer, g, s),
                 donate_argnums=(1,))
    v0 = view_at(0)
    st, img = fn(g_at(0, v0, g_const.view), init_frame_state(w, h))
    jax.block_until_ready(img)

    times = []
    prev = v0
    for i in range(1, frames + 1):
        v = view_at(i)
        g = g_at(i, v, prev)
        t0 = time.perf_counter()
        st, img = fn(g, st)
        jax.block_until_ready(img)
        times.append(time.perf_counter() - t0)
        prev = v

    arr = np.asarray(times) * 1e3
    rays = int(count_frame_rays(g_at(1, v0, v0), w, h))
    p50 = float(np.percentile(arr, 50))
    return {
        "p50_ms": round(p50, 2),
        "mean_ms": round(float(arr.mean()), 2),
        "frames": frames,
        "resolution": f"{w}x{h}",
        "rays_per_frame": rays,
        "mrays_nominal": round(rays / (p50 / 1e3) / 1e6, 3),
        "accumulation": True,
        "scene": scene_kind,
        "triangles": int(scene.num_triangles),
        "platform": jax.default_backend(),
        "image_finite": bool(np.isfinite(np.asarray(img)).all()),
    }


def run_rmse(size: int = 128, restir_frames: int = 1536,
             oracle_frames: int = 1024, oracle_spp: int = 64,
             backend: str = "auto", scene_kind: str = "cornell") -> dict:
    """BASELINE.md's RMSE gate at device scale:
    converged accumulated ReSTIR DI vs a transport-matched converged
    oracle (2 bounces, front-facing emission — the matching validated by
    tests/test_rmse.py::test_di_display_matches_oracle_strict), compared
    on display images at `size`^2 on the Cornell box.

    Budgets: RMSE is a per-pixel statistic, so measure at 128^2 and spend
    the cheap frames on samples: 1024 frames x 64 spp = 65536 oracle spp
    puts the oracle's own noise floor well under the 1e-2 gate (it scales
    ~1/sqrt(spp)), so the measurement resolves estimator error instead of
    sitting on its floor."""
    import dataclasses

    import numpy as np

    import jax
    import jax.numpy as jnp

    from raytracer2.params import default_gconst
    from raytracer2.render.frame import init_frame_state, render_frame
    from raytracer2.render.postprocess import (
        PostProcessInputs, post_process)
    from raytracer2.render.reference import render_reference

    scene, renderer, cam = build_case(scene_kind, size, size, backend)
    view = cam.planar_view_constants()
    n_lights = renderer.scene_lights.num_local_lights

    g1 = default_gconst(view, n_lights, refrence_mode=1)
    fn_o = jax.jit(lambda gc: render_reference(
        scene, gc, size, size, max_bounces=2, max_samples=oracle_spp,
        trace_fn=renderer.tracers.closest_hit, emission_facing="front"))
    # oracle accumulation stays on the device; three scalars are read
    # back at the end
    acc_a = jnp.zeros((size, size, 3), jnp.float32)
    acc_b = jnp.zeros((size, size, 3), jnp.float32)
    for f in range(oracle_frames):
        img_f = fn_o(g1.replace(frame=jnp.uint32(f)))
        if f % 2 == 0:
            acc_a = acc_a + img_f
        else:
            acc_b = acc_b + img_f
    half_a = acc_a / max(oracle_frames - oracle_frames // 2, 1)
    half_b = acc_b / max(oracle_frames // 2, 1)
    acc = (acc_a + acc_b) / oracle_frames
    z = jnp.zeros((size, size, 3), jnp.float32)

    def display(linear):
        out, _ = post_process(scene, g1, PostProcessInputs(
            depth=jnp.zeros((size, size)), diffuse_albedo=z, specular_f0=z,
            emissive=z, diffuse=linear, specular=z))
        return out

    oracle = display(acc)
    # split-half noise floor: RMSE between two independent oracle halves
    # bounds what ANY estimator can score against this oracle (the
    # full-mean comparison floor is ~this / sqrt(2) / sqrt(2))
    oracle_noise_dev = jnp.sqrt(jnp.mean(
        (display(half_a) - display(half_b)) ** 2))

    g = default_gconst(view, n_lights,
                       enable_restir_di=1, enable_restir_gi=0,
                       enable_accumulation=1,
                       correct_specular_accumulation=1)
    isp = dataclasses.replace(g.restir_di.initial_sampling_params,
                              num_primary_local_light_samples=4)
    shp = dataclasses.replace(g.restir_di.shading_params,
                              enable_final_visibility=1)
    g = g.replace(restir_di=dataclasses.replace(
        g.restir_di, initial_sampling_params=isp, shading_params=shp))
    fn = jax.jit(lambda gc, s: render_frame(renderer, gc, s))
    state = init_frame_state(size, size)
    img = None
    for f in range(restir_frames):
        state, img = fn(g.replace(
            frame=jnp.uint32(f), blend_factor=jnp.float32(1.0 / (f + 1))),
            state)
    stats = jnp.stack([
        jnp.sqrt(jnp.mean((oracle - img) ** 2)),
        oracle_noise_dev,
        img.mean() / jnp.maximum(oracle.mean(), 1e-9)])
    rmse, oracle_noise, ratio = (float(v) for v in np.asarray(stats))
    return {
        "rmse": round(rmse, 5),
        "oracle_noise_rmse": round(oracle_noise, 5),
        # the split-half RMSE compares two N/2-sample halves, so it reads
        # 2x the full-mean oracle's own noise (E[rmse_sh^2] = 2*var_half
        # = 4*var_full): this derived field is the actual noise floor of
        # the restir-vs-oracle comparison from the oracle side
        "oracle_noise_full_mean": round(oracle_noise / 2.0, 5),
        "energy_ratio": round(ratio, 4),
        "gate": 1e-2,
        # gate on the DERIVED full-mean floor (oracle_noise / 2), not the
        # split-half value, which reads 2x the actual restir-vs-oracle
        # floor (ADVICE r4); the face-value BASELINE gate reported too
        "passes_gate": bool(rmse <= max(1e-2, oracle_noise / 2.0)),
        "passes_gate_face_value": bool(rmse <= 1e-2),
        "size": size,
        "restir_frames": restir_frames,
        "oracle_frames": oracle_frames,
        "oracle_spp": oracle_spp,
        "config": f"{scene_kind} restir-di 4NEE+1BRDF finalvis vs "
                  "2-bounce front-emission oracle",
    }


def run_rmse_gi(size: int = 128, restir_frames: int = 384,
                oracle_frames: int = 768, oracle_spp: int = 32,
                backend: str = "auto",
                scene_kind: str = "cornell") -> dict:
    """GI-on RMSE stage: the flagship DI+GI pipeline vs
    the transport-matched 3-bounce front-facing oracle, converged in
    LINEAR space (the recipe validated by
    tests/test_rmse.py::test_di_gi_display_matches_oracle — averaging
    tonemapped frames would under-count the spiky secondary-DI stream by
    the AgX Jensen gap).

    Characterization (frame-count sweep 96/384 at 48^2 and 384 at
    128^2): the DI term alone sits ON the oracle noise floor
    (residual ~0.003), while the GI chain carries a stable structured
    display-RMSE residual of ~0.056 with a +2% energy surplus —
    frame-count- and size-independent, so it is structure, not noise.
    Direct A/Bs exonerate the final-MIS heuristic (identical RMSE with
    enable_final_mis=0), the firefly clamp (identical at clamp=1e9), and
    the specular demod/remod round trip (exact inverse, Helpers.glsl:
    312-315 parity). Packing quantization is ruled out analytically
    (f16 throughput ~0.05%, R11G11B10 albedo ~0.8% relative — far below
    5%); the remaining candidate is the 1-sample BRDF-NEE estimator at
    the bounce surface (solid-angle/area pdf conversion and eps guards
    at grazing angles), to be bisected pixel by pixel against quadrature
    (ROADMAP Reach 1). The gates
    reflect this: display-space energy (unbiasedness) is the hard gate;
    rmse_consistent_with_noise is a diagnostic that currently reads
    False by design until the residual is decomposed further."""
    import dataclasses

    import numpy as np

    import jax
    import jax.numpy as jnp

    from raytracer2.params import default_gconst
    from raytracer2.render.frame import init_frame_state, render_frame
    from raytracer2.render.postprocess import (
        PostProcessInputs, post_process)
    from raytracer2.render.reference import render_reference
    from raytracer2.utils import packing as pk

    scene, renderer, cam = build_case(scene_kind, size, size, backend)
    view = cam.planar_view_constants()
    n_lights = renderer.scene_lights.num_local_lights

    g1 = default_gconst(view, n_lights, refrence_mode=1)
    fn_o = jax.jit(lambda gc: render_reference(
        scene, gc, size, size, max_bounces=3, max_samples=oracle_spp,
        trace_fn=renderer.tracers.closest_hit, emission_facing="front"))
    acc_a = jnp.zeros((size, size, 3), jnp.float32)
    acc_b = jnp.zeros((size, size, 3), jnp.float32)
    for f in range(oracle_frames):
        img_f = fn_o(g1.replace(frame=jnp.uint32(f)))
        if f % 2 == 0:
            acc_a = acc_a + img_f
        else:
            acc_b = acc_b + img_f
    half_a = acc_a / max(oracle_frames - oracle_frames // 2, 1)
    half_b = acc_b / max(oracle_frames // 2, 1)
    oracle_lin = (acc_a + acc_b) / oracle_frames

    g = default_gconst(view, n_lights,
                       enable_restir_di=1, enable_restir_gi=1,
                       enable_temporal_resampling=0,
                       enable_spatial_resampling=0)
    isp = dataclasses.replace(g.restir_di.initial_sampling_params,
                              num_primary_local_light_samples=4)
    g = g.replace(restir_di=dataclasses.replace(
        g.restir_di, initial_sampling_params=isp))
    fn = jax.jit(lambda gc, s: render_frame(renderer, gc, s))
    state = init_frame_state(size, size)
    # split-half restir accumulation: the GI stream is 1 BRDF sample per
    # pixel per frame, so its display RMSE at feasible frame counts IS
    # its Monte-Carlo noise — the meaningful gates are (a) display-space
    # energy (unbiasedness, the band validated by
    # tests/test_rmse.py::test_di_gi_display_matches_oracle) and (b)
    # RMSE consistent with the MEASURED noise floors
    acc = [jnp.zeros((size, size, 3), jnp.float32) for _ in range(4)]
    for f in range(restir_frames):
        state, _ = fn(g.replace(frame=jnp.uint32(f)), state)
        k = 2 * (f % 2)
        acc[k] = acc[k] + state.diffuse_lighting
        acc[k + 1] = acc[k + 1] + state.specular_lighting
    na = restir_frames - restir_frames // 2
    nb = restir_frames // 2
    accd = (acc[0] + acc[2]) / restir_frames
    accs = (acc[1] + acc[3]) / restir_frames

    gb = state.gbuffer

    def display(diffuse, specular):
        out, _ = post_process(scene, g, PostProcessInputs(
            depth=gb.depth,
            diffuse_albedo=pk.unpack_r11g11b10_ufloat(gb.diffuse_albedo),
            specular_f0=pk.unpack_rgba8_gamma_ufloat(
                gb.specular_rough)[..., :3],
            emissive=gb.emissive,
            diffuse=diffuse, specular=specular))
        return out

    z = jnp.zeros((size, size, 3), jnp.float32)

    def display_oracle(linear):
        # refrence_mode GConst: post_process passes the radiance through
        # (post_processing.comp:157-158) — the oracle's radiance already
        # carries albedo modulation and emission, unlike the restir
        # lighting buffers (tests/test_rmse.py::_oracle_display)
        out, _ = post_process(scene, g1, PostProcessInputs(
            depth=jnp.zeros((size, size)), diffuse_albedo=z,
            specular_f0=z, emissive=z, diffuse=linear, specular=z))
        return out

    oracle_img = display_oracle(oracle_lin)
    img = display(accd, accs)
    # split-half noise of the restir estimator itself (reads 2x the
    # full-mean floor, like the oracle's)
    restir_noise_dev = jnp.sqrt(jnp.mean(
        (display(acc[0] / na, acc[1] / na)
         - display(acc[2] / nb, acc[3] / nb)) ** 2))
    oracle_noise_dev = jnp.sqrt(jnp.mean(
        (display_oracle(half_a) - display_oracle(half_b)) ** 2))
    stats = jnp.stack([
        jnp.sqrt(jnp.mean((oracle_img - img) ** 2)),
        oracle_noise_dev,
        restir_noise_dev,
        img.mean() / jnp.maximum(oracle_img.mean(), 1e-9)])
    rmse, oracle_noise, restir_noise, ratio = (
        float(v) for v in np.asarray(stats))
    floor = ((oracle_noise / 2.0) ** 2 + (restir_noise / 2.0) ** 2) ** 0.5
    return {
        "rmse_gi": round(rmse, 5),
        "oracle_noise_full_mean": round(oracle_noise / 2.0, 5),
        "restir_noise_full_mean": round(restir_noise / 2.0, 5),
        "noise_floor_combined": round(floor, 5),
        "energy_ratio_display": round(ratio, 4),
        # unbiasedness gate: the band test_di_gi_display_matches_oracle
        # validates; RMSE must additionally be explained by the measured
        # noise floors (1.5x slack for correlation/fp)
        "passes_energy_gate": bool(0.95 < ratio < 1.08),
        "rmse_consistent_with_noise": bool(rmse <= max(1e-2, 1.5 * floor)),
        "passes_gate_face_value": bool(rmse <= 1e-2),
        "size": size,
        "restir_frames": restir_frames,
        "oracle_frames": oracle_frames,
        "oracle_spp": oracle_spp,
        "config": f"{scene_kind} restir di+gi (4NEE DI, 1-bounce GI) vs "
                  "3-bounce front-emission oracle, linear accumulation",
    }


def run_scaling(width: int = 64, height: int = 64, frames: int = 2,
                scene_kind: str = "corridor") -> dict:
    """1/2/4/8-virtual-device frame-time curve on the host CPU mesh
    (the scaling evidence needs the 2/4-device points and
    a MEASURED comm fraction, not a zeroed estimate). One fresh
    interpreter per device count (the virtual count is fixed at backend
    init). All virtual devices share this host's cores, so the honest
    signals are the ratios between sharded paths, the curve shape, and
    the comm fraction — not device scaling, which is why `all` does not
    run this stage (chip_smoke.py --four-cards runs the halo path on real
    cards)."""
    import os
    import subprocess

    res: dict = {"width": width, "height": height, "curve": {}}
    for n, full in ((8, True), (2, False), (4, False)):
        env = dict(os.environ)
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                            + f" --xla_force_host_platform_device_count={n}"
                            ).strip()
        try:
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--mode",
                 "_scaling_inner", "--width", str(width), "--height",
                 str(height), "--frames", str(frames), "--scene",
                 scene_kind, "--scaling-full", "1" if full else "0"],
                env=env, capture_output=True, text=True, timeout=420)
        except subprocess.TimeoutExpired:
            res["curve"][str(n)] = {"error": "420s point timeout"}
            continue
        out = None
        for line in reversed(proc.stdout.splitlines()):
            try:
                out = json.loads(line)
                break
            except ValueError:
                continue
        if out is None:
            res["curve"][str(n)] = {
                "error": (proc.stderr or "no JSON")[-200:]}
            continue
        if full:  # the 8-dev run carries the single-device baseline
            res["devices"] = out.pop("devices", n)
            for k in ("single_device_ms", "gspmd_8dev_ms",
                      "gspmd_speedup_vs_1dev", "halo_vs_gspmd"):
                if k in out:
                    res[k] = out.pop(k)
        out.pop("devices", None)
        res["curve"][str(n)] = out
    t1 = res.get("single_device_ms")
    if t1:
        for n, row in res["curve"].items():
            ms = row.get("halo_ms")
            if ms:
                row["halo_speedup_vs_1dev"] = round(t1 / ms, 3)
    # headline compat fields (r2-r4 records carried these at 8 dev)
    c8 = res["curve"].get("8", {})
    if "halo_ms" in c8:
        res["halo_8dev_ms"] = c8["halo_ms"]
        res["halo_speedup_vs_1dev"] = c8.get("halo_speedup_vs_1dev")
    return res


def _run_scaling_inner(width: int, height: int, frames: int,
                       scene_kind: str, full: bool = True) -> dict:
    """One device-count point. full=True (the 8-dev run) additionally
    measures the single-device baseline and the GSPMD fallback; every run
    measures the halo path AND the local-pad control, whose timing
    difference is the halo's real measured comm cost."""
    import jax

    jax.config.update("jax_platforms", "cpu")  # a virtual CPU mesh
    import numpy as np

    from raytracer2.params import default_gconst
    from raytracer2.parallel.mesh import (
        make_mesh, make_sharded_render_fn, shard_frame_state)
    from raytracer2.render.frame import init_frame_state, render_frame

    n_dev = len(jax.devices())
    scene, renderer, cam = build_case(scene_kind, width, height, "bundle")
    g = default_gconst(cam.planar_view_constants(),
                       renderer.scene_lights.num_local_lights)
    g = g.replace(enable_restir_di=1, enable_restir_gi=1)

    def median_ms(step, state):
        state2, img = step(g, state)
        jax.block_until_ready(img)
        ts = []
        for _ in range(frames):
            t0 = time.perf_counter()
            state2, img = step(g, state2)
            jax.block_until_ready(img)
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts) * 1e3)

    res = {"devices": n_dev}
    if full:
        single = jax.jit(lambda gc, s: render_frame(renderer, gc, s))
        res["single_device_ms"] = round(
            median_ms(single, init_frame_state(width, height)), 2)

    mesh = make_mesh()
    step = make_sharded_render_fn(renderer, mesh, explicit_halo=True)
    tn = median_ms(step, shard_frame_state(
        init_frame_state(width, height), mesh))
    res["halo_ms"] = round(tn, 2)
    tel = dict(getattr(step, "halo_telemetry", {}))
    res["halo_rows"] = tel.get("halo_rows")
    res["halo_exchanges_per_frame"] = tel.get("halo_exchanges")
    res["halo_kb_per_device_frame"] = round(
        tel.get("halo_bytes_per_device_frame", 0) / 1024, 1)

    # measured comm: identical program with the ppermute replaced by a
    # local reflect-pad (same shapes, same compute, zero communication)
    step_local = make_sharded_render_fn(
        renderer, mesh, explicit_halo=True, halo_impl="local")
    t_local = median_ms(step_local, shard_frame_state(
        init_frame_state(width, height), mesh))
    comm = max(tn - t_local, 0.0)
    res["halo_local_pad_ms"] = round(t_local, 2)
    res["halo_comm_ms_measured"] = round(comm, 2)
    res["halo_comm_fraction_measured"] = round(comm / max(tn, 1e-9), 4)

    if full:
        gs = make_sharded_render_fn(renderer, mesh, explicit_halo=False)
        tg = median_ms(gs, shard_frame_state(
            init_frame_state(width, height), mesh))
        res[f"gspmd_{n_dev}dev_ms"] = round(tg, 2)
        t1 = res.get("single_device_ms") or 0.0
        res["gspmd_speedup_vs_1dev"] = round(t1 / max(tg, 1e-9), 3)
        res["halo_vs_gspmd"] = round(tg / max(tn, 1e-9), 3)
    return res


def main():
    enable_compile_cache()
    parser = argparse.ArgumentParser()
    parser.add_argument("--smoke", action="store_true",
                        help="tiny fast run (CPU-friendly)")
    parser.add_argument("--quick", action="store_true",
                        help="only the 256x256 round-1-comparable config")
    parser.add_argument("--budget-s", type=float,
                        default=float(__import__("os").environ.get(
                            "RT2_BENCH_BUDGET_S", 2250)),
                        help="total wall-clock budget; stages that would "
                             "overrun are skipped, and a hard watchdog "
                             "prints the final headline line and exits 0 "
                             "at the deadline no matter what is running "
                             "(default 2250s / env RT2_BENCH_BUDGET_S)")
    parser.add_argument("--mode", default="all",
                        # also: duck | emissive | flythrough (BASELINE
                        # ladder configs 2/4/5); scaling runs a virtual
                        # CPU mesh and is never part of `all`
                        choices=["all", "reference", "pipeline", "rmse",
                                 "trace", "scaling", "duck", "emissive",
                                 "flythrough", "_scaling_inner"])
    parser.add_argument("--scaling-full", type=int, default=1,
                        help="_scaling_inner: also measure the 1-device "
                             "baseline and the GSPMD fallback")
    parser.add_argument("--per-pass", action="store_true", default=None,
                        help="per-pass breakdown in pipeline mode "
                             "(default on for full runs)")
    parser.add_argument("--no-per-pass", dest="per_pass",
                        action="store_false")
    parser.add_argument("--width", type=int, default=None)
    parser.add_argument("--height", type=int, default=None)
    parser.add_argument("--spp", type=int, default=None)
    parser.add_argument("--bounces", type=int, default=None)
    parser.add_argument("--frames", type=int, default=None)
    parser.add_argument("--scene", default=None,
                        choices=["ladder", "corridor", "cornell"])
    parser.add_argument("--backend", default="auto", choices=BACKENDS)
    args = parser.parse_args()

    if args.mode == "_scaling_inner":
        print(json.dumps(_run_scaling_inner(
            args.width or 64, args.height or 64, args.frames or 2,
            args.scene or "corridor", full=bool(args.scaling_full))))
        return 0

    start = time.monotonic()

    def remaining() -> float:
        return args.budget_s - (time.monotonic() - start)

    detail: dict = {}
    _emit = {"done": False}
    _emit_lock = threading.Lock()

    def emit_final(name: str, value, exit_now: bool = False):
        """Print THE final JSON line exactly once (normal completion or
        watchdog deadline). vs_baseline semantics depend on the metric."""
        with _emit_lock:
            if _emit["done"]:
                return
            _emit["done"] = True
            if "p50" in name or name.endswith("_ms"):
                vs = round(16.0 / max(value, 1e-9), 4)  # 16 ms budget
                unit = "ms"
            elif "rmse" in name:
                vs = round(1e-2 / max(value, 1e-9), 4)  # <=1e-2 gate
                unit = "rmse"
            else:
                vs = round(value / BASELINE_MRAYS, 4)
                unit = "Mrays/s"
            detail["total_seconds"] = round(time.monotonic() - start, 1)
            print(json.dumps({
                "metric": name, "value": value, "unit": unit,
                "vs_baseline": vs, "detail": detail,
            }), flush=True)
        if exit_now:
            import os

            os._exit(0)

    def watchdog():
        """Hard deadline: whatever stage is running (or hung — a long
        compile, a wedged subprocess), the final line prints and the
        process exits 0."""
        h = best_headline() or ("bench_incomplete", 0.0)
        print(f"bench: watchdog fired at {args.budget_s:.0f}s — emitting "
              "final line with completed stages", file=sys.stderr,
              flush=True)
        emit_final(h[0], h[1], exit_now=True)

    if args.mode == "all":
        wd = threading.Timer(max(args.budget_s, 60.0), watchdog)
        wd.daemon = True
        wd.start()

    def ref_cfg(**kw):
        cfg = dict(width=args.width or kw["width"],
                   height=args.height or kw["height"],
                   spp=args.spp or kw["spp"],
                   bounces=args.bounces or kw["bounces"],
                   frames=args.frames or kw["frames"],
                   scene_kind=args.scene or kw["scene_kind"],
                   backend=args.backend)
        return cfg

    def attempt(fn, /, **cfg):
        # a failed stage reports its error instead of killing the whole
        # bench (later stages still run)
        t0 = time.monotonic()
        try:
            out = fn(**cfg)
        except Exception as e:  # noqa: BLE001
            print(f"bench stage failed: {e!r}"[:500], file=sys.stderr)
            out = {"error": f"{type(e).__name__}: {e}"[:200]}
        if isinstance(out, dict):
            out.setdefault("stage_seconds", round(time.monotonic() - t0, 1))
        return out

    def best_headline():
        """Best available headline for an 'all' run: ladder Mrays/s once
        measured, the quick config's before that."""
        v = detail.get("ladder", {}).get("mrays_nominal")
        if v is not None:
            return ("ladder_reference_mrays_per_sec_per_chip", v)
        v = detail.get("quick", {}).get("mrays_nominal")
        if v is not None:
            return ("reference_path_tracer_mrays_per_sec_per_chip", v)
        return None

    def provisional():
        # checkpoint line after every completed stage, so an external
        # timeout still finds the best headline so far
        if args.mode != "all":
            return
        h = best_headline()
        if h is None:
            return
        name, v = h
        print(json.dumps({
            "metric": name,
            "value": v, "unit": "Mrays/s",
            "vs_baseline": round(v / BASELINE_MRAYS, 4),
            "detail": dict(detail, provisional=True),
        }), flush=True)

    if args.smoke:
        detail["quick"] = attempt(run_reference, **ref_cfg(
            width=64, height=64, spp=1, bounces=2, frames=2,
            scene_kind="cornell"))
        headline = ("smoke_reference_mrays_per_sec_per_chip",
                    detail["quick"].get("mrays_nominal", 0.0))
    elif args.quick:
        detail["quick"] = attempt(run_reference, **ref_cfg(
            width=256, height=256, spp=2, bounces=3, frames=8,
            scene_kind="corridor"))
        headline = ("reference_path_tracer_mrays_per_sec_per_chip",
                    detail["quick"].get("mrays_nominal", 0.0))
    else:
        W, H = args.width or 1920, args.height or 1080

        def pipe_cfg(**kw):
            cfg = dict(width=W, height=H, frames=args.frames or 8,
                       scene_kind=args.scene or "ladder",
                       backend=args.backend, per_pass=False)
            cfg.update(kw)
            return cfg

        # ordered (key, in_all, thunk): importance-first so the headline
        # prints early; in_all=False stages run only in their own --mode
        stages = [
            ("quick", True, lambda: attempt(run_reference, **ref_cfg(
                width=256, height=256, spp=2, bounces=3, frames=8,
                scene_kind="corridor"))),
            ("ladder", True, lambda: attempt(run_reference, **ref_cfg(
                width=1920, height=1080, spp=8, bounces=5, frames=2,
                scene_kind="ladder"))),
            # flagship DI+GI frame (what `app.py` renders by default)
            ("pipeline_di", True, lambda: attempt(
                run_pipeline, **pipe_cfg(enable_di=True))),
            # per-pass only when explicitly asked or in single-stage
            # pipeline mode ('all' runs the breakdown as its own late
            # stage instead)
            ("pipeline", True, lambda: attempt(run_pipeline, **pipe_cfg(
                per_pass=(args.per_pass if args.per_pass is not None
                          else args.mode == "pipeline")))),
            ("rmse", True, lambda: attempt(run_rmse, backend=args.backend)),
            # the traversal engine alone on the flagship frame's batches,
            # then with final visibility, whose any-hit rays it lacks
            ("trace", False, lambda: attempt(
                run_trace_frame, width=W, height=H,
                scene_kind=args.scene or "ladder", backend=args.backend)),
            ("trace_visibility", False, lambda: attempt(
                run_trace_frame, width=W, height=H,
                scene_kind=args.scene or "ladder", backend=args.backend,
                visibility=True)),
            # 1/2/4/8-virtual-CPU-device scaling curve (CPU milliseconds)
            ("scaling", False, lambda: attempt(run_scaling)),
            # BASELINE config 5: 4K fly-through, DI+GI + accumulation
            ("flythrough_4k", True, lambda: attempt(
                run_flythrough,
                width=args.width or 3840, height=args.height or 2160,
                frames=args.frames or 3,
                scene_kind=args.scene or "ladder",
                backend=args.backend)),
            # BASELINE config 2: ~12k-tri textured grid, 512^2, 4 spp
            ("duck", True, lambda: attempt(run_reference, **ref_cfg(
                width=args.width or 512, height=args.height or 512,
                spp=args.spp or 4, bounces=args.bounces or 3,
                frames=args.frames or 4, scene_kind="duck"))),
            # checkerboard variant (RtxdiHelpers.hlsli:16-61): half the
            # lighting rays per frame, alternating fields
            ("pipeline_checkerboard", True, lambda: attempt(
                run_pipeline, **pipe_cfg(checkerboard=True))),
            # BASELINE config 4: 1k+ area lights through the DI
            # reservoir path (presample + PDF mips at renderer creation)
            ("emissive", True, lambda: attempt(run_pipeline, **pipe_cfg(
                frames=args.frames or 4, scene_kind="emissive",
                enable_di=True))),
            # GI-on RMSE: the flagship pipeline, not just
            # DI, error-gated in the driver record
            ("rmse_gi", True, lambda: attempt(
                run_rmse_gi, backend=args.backend)),
            # the RMSE gate on the textured many-light corridor (the
            # BASELINE ladder scene family) — cornell stays the headline
            # (its transport matching is test-validated)
            ("rmse_corridor", True, lambda: attempt(
                run_rmse, backend=args.backend, scene_kind="corridor")),
            # cumulative-prefix per-pass breakdown (compiles one program
            # per pass prefix — the slowest stage, so it runs late)
            ("pipeline_breakdown", True, lambda: attempt(
                run_pipeline, **pipe_cfg(per_pass=True))),
        ]
        mode_stage = {  # single-stage modes reuse the same thunks
            "reference": ("quick", "ladder"),
            "pipeline": ("pipeline", "pipeline_checkerboard",
                         "pipeline_di"),
            "rmse": ("rmse", "rmse_gi"), "scaling": ("scaling",),
            "trace": ("trace", "trace_visibility"),
            "duck": ("duck",),
            "emissive": ("emissive",), "flythrough": ("flythrough_4k",),
        }
        # reserve headroom for the final print + interpreter teardown so
        # the watchdog is a backstop, not the normal exit path
        reserve = 90.0
        for key, in_all, thunk in stages:
            if args.mode == "all" and not in_all:
                continue
            if args.mode != "all" and key not in mode_stage.get(
                    args.mode, ()):
                continue
            if args.mode == "all" and remaining() < reserve:
                detail[key] = {"skipped": (
                    f"budget: {remaining():.0f}s left")}
                print(f"bench: skipping {key} (budget)", file=sys.stderr,
                      flush=True)
                continue
            detail[key] = thunk()
            provisional()

        if args.mode == "scaling":
            headline = ("cpu_mesh_halo_8dev_frame_ms",
                        detail["scaling"].get("halo_8dev_ms", 0.0))
        elif args.mode == "duck":
            headline = ("duck_reference_mrays_per_sec_per_chip",
                        detail["duck"].get("mrays_nominal", 0.0))
        elif args.mode == "emissive":
            headline = ("emissive_restir_di_p50_frame_ms",
                        detail["emissive"].get("p50_ms", 0.0))
        elif args.mode == "flythrough":
            headline = ("flythrough_4k_p50_frame_ms",
                        detail["flythrough_4k"].get("p50_ms", 0.0))
        elif args.mode == "trace":
            headline = ("trace_frame_traversal_ms",
                        detail["trace"].get("traversal_ms", 0.0))
        elif args.mode == "rmse":
            headline = ("restir_di_display_rmse_vs_oracle",
                        detail["rmse"].get("rmse", 1.0))
        elif args.mode == "pipeline":
            headline = ("restir_pipeline_p50_frame_ms",
                        detail["pipeline"].get("p50_ms", 0.0))
        elif "mrays_nominal" in detail.get("ladder", {}):
            headline = ("ladder_reference_mrays_per_sec_per_chip",
                        detail["ladder"]["mrays_nominal"])
        else:  # ladder failed: fall back to the quick number
            headline = ("reference_path_tracer_mrays_per_sec_per_chip",
                        detail.get("quick", {}).get("mrays_nominal", 0.0))
    name, value = headline
    emit_final(name, value)
    return 0


if __name__ == "__main__":
    sys.exit(main())
