"""Prove that the renderer's main path runs on one NVIDIA GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # the row-sharded halo path on 4 cards

Phases (one card):
  device    JAX must report a GPU; prints the card's name and power limit
            and which SAH builder clustered the ladder scene
  compile   the flagship ReSTIR DI+GI frame and reference mode, both at
            1920x1080 on the ~260k-triangle ladder scene: compile seconds
            and compiled.memory_analysis()
  tracers   16,384 synthetic rays per class (bench.ray_classes: primary,
            BRDF bounce, shadow) on the ladder scene, bundle engine vs the
            brute-force oracle; the other --backend engines once on a
            small scene
  goldens   tests/test_goldens.py's 16x16 two-frame scene vs the CPU
            snapshots at that test's tolerance
  frames    8 flagship frames at 1080p, each read back and checked
  rmse      bench.run_rmse's Cornell DI error gate (face value)

Any failed check exits non-zero. The last line of standard output is one
JSON object naming the device; nothing is printed there on failure.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
from raytracer2.compile_cache import enable_compile_cache  # noqa: E402
from raytracer2.ops import cluster as cluster_mod  # noqa: E402
from raytracer2.ops.intersect import (  # noqa: E402
    intersect_brute_force, occluded_brute_force)
from raytracer2.render.app_bridge import BACKENDS, make_tracers  # noqa: E402
from raytracer2.render.frame import (  # noqa: E402
    init_frame_state, render_frame)
from raytracer2.render.reference import render_reference  # noqa: E402

W, H = 1920, 1080
SCENE = "ladder"  # ~260k triangles (bench.py)
N_RAYS = 16384
GOLDEN_TOL = 2e-3  # tests/test_goldens.py's rtol = atol


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def check_devices(devices) -> None:
    """The smoke test measures the card: a device list that is not all
    GPUs is refused, never run on as a fallback."""
    check(len(devices) > 0, "JAX reports no devices")
    platforms = sorted({d.platform for d in devices})
    check(platforms == ["gpu"],
          f"JAX found no GPU (platforms {platforms}); refusing to run")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def memory_line(compiled) -> str:
    m = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "alias_size_in_bytes",
              "generated_code_size_in_bytes")
    return ", ".join(f"{f}={getattr(m, f, None)}" for f in fields)


def phase_compile(scene, renderer, g, state):
    frame_fn = jax.jit(lambda gc, s: render_frame(renderer, gc, s))
    t0 = time.perf_counter()
    frame = frame_fn.lower(g, state).compile()
    print(f"compile flagship DI+GI {W}x{H}: "
          f"{time.perf_counter() - t0:.1f} s; {memory_line(frame)}")

    g_ref = g.replace(refrence_mode=1)
    ref_fn = jax.jit(lambda gc: render_reference(
        scene, gc, W, H, max_bounces=5, max_samples=8,
        trace_fn=renderer.tracers.closest_hit))
    t0 = time.perf_counter()
    ref = ref_fn.lower(g_ref).compile()
    print(f"compile reference {W}x{H} 8 spp 5 bounces: "
          f"{time.perf_counter() - t0:.1f} s; {memory_line(ref)}")
    return frame


def parity_rays(scene, tracers, cam, width: int, height: int,
                n: int = N_RAYS, seed: int = 0) -> dict:
    """n rays of each bench.ray_classes class, from a strided pixel grid
    spanning the whole image, as host arrays."""
    side = int(np.sqrt(n))
    xs = np.linspace(0, width - 1, side).astype(np.int32)
    ys = np.linspace(0, height - 1, side).astype(np.int32)
    px, py = np.meshgrid(xs, ys)
    classes = bench.ray_classes(
        scene, tracers.closest_hit, cam.planar_view_constants(),
        jnp.asarray(px.reshape(-1)), jnp.asarray(py.reshape(-1)), seed=seed)
    return {cls: tuple(np.asarray(a) for a in rays)
            for cls, rays in classes.items()}


GRAZING_COS = 1e-3
EPS32 = float(np.finfo(np.float32).eps)


def _cos(scene, directions, hit) -> np.ndarray:
    """|cos| between each ray and the triangle `hit` names."""
    tri = np.maximum(np.asarray(hit.triangle_index), 0)
    n = np.cross(scene.host_tri_edge1[tri], scene.host_tri_edge2[tri])
    d = np.asarray(directions)
    return np.abs(np.sum(n * d, axis=1)) / np.maximum(
        np.linalg.norm(n, axis=1) * np.linalg.norm(d, axis=1), 1e-30)


def grazing(scene, directions, *hits) -> np.ndarray:
    """Rays whose hit in any of `hits` meets its triangle at |cos| below
    GRAZING_COS: their t is ill-conditioned (-o'_z / d'_z with d'_z ~ 0),
    so two correct f32 intersectors may place it either side of t_max."""
    out = np.zeros(np.asarray(directions).shape[0], bool)
    for hit in hits:
        out |= ~np.asarray(hit.missed) & (
            _cos(scene, directions, hit) < GRAZING_COS)
    return out


ORIGIN_EPS = 4  # f32 eps of the ray's origin that |dt| may take


def compare_closest(name: str, scene, origins, directions, got, ref,
                    skip: np.ndarray) -> None:
    """Hit/miss must agree exactly and triangle ids on >= 99.99% of hits,
    except on grazing rays (`skip`). |dt| may be 1e-5 t plus the f32
    resolution of the ray's origin (ORIGIN_EPS eps (|o| + t) / |cos|): a
    ray that leaves a surface can hit at small t, where the rounding of its
    origin coordinates, not t, sets how exact t can be. Where ids agree,
    every |dt| must be within it; a different id counts as an edge or
    vertex tie only where |dt| is within it too."""
    keep = ~skip
    g_miss = np.asarray(got.missed)[keep]
    r_miss = np.asarray(ref.missed)[keep]
    check(np.array_equal(g_miss, r_miss),
          f"{name}: hit/miss differs on {int((g_miss != r_miss).sum())} rays")
    hit = np.zeros_like(keep)
    hit[keep] = ~r_miss
    if not hit.any():
        print(f"{name}: 0 hits, all misses agree")
        return
    g_t, r_t = np.asarray(got.t)[hit], np.asarray(ref.t)[hit]
    same = (np.asarray(got.triangle_index)[hit]
            == np.asarray(ref.triangle_index)[hit])
    dt = np.abs(g_t - r_t)
    rel_ok = dt <= 1e-5 * np.abs(r_t)
    o_mag = np.abs(np.asarray(origins)[hit]).max(axis=1)
    cos = np.maximum(_cos(scene, directions, ref)[hit], GRAZING_COS)
    tol = (1e-5 * np.abs(r_t)
           + ORIGIN_EPS * EPS32 * (o_mag + np.abs(r_t)) / cos)
    agree = float(np.mean(same | (dt <= tol)))
    t_ok = bool(np.all((dt <= tol)[same]))
    worst = float(np.max((dt / tol)[same])) if same.any() else 0.0
    print(f"{name}: {int(hit.sum())} hits ({int(skip.sum())} grazing rays "
          f"set aside), ids equal {same.mean():.6f}, equal or tied "
          f"{agree:.6f}, |dt| <= 1e-5 t on {float(np.mean(rel_ok[same])):.6f}"
          f" of equal ids, worst |dt| / tolerance {worst:.3f}")
    check(agree >= 0.9999, f"{name}: triangle ids agree on {agree:.6f}")
    check(t_ok, f"{name}: |dt| exceeds the tolerance ({worst:.3f}x)")


def compare_occluded(name: str, got, ref, skip: np.ndarray) -> None:
    got, ref = np.asarray(got)[~skip], np.asarray(ref)[~skip]
    print(f"{name}: {int(ref.sum())} of {ref.size} blocked "
          f"({int(skip.sum())} grazing rays set aside), "
          f"{int((got != ref).sum())} differ")
    check(np.array_equal(got, ref), f"{name}: occlusion differs")


def run_parity(scene, tracers, rays: dict, label: str) -> None:
    for cls, (o, d, tn, tx) in rays.items():
        o, d, tn, tx = (jnp.asarray(a) for a in (o, d, tn, tx))
        name = f"{label} {cls}"
        ref = intersect_brute_force(
            o, d, scene.tri_v0, scene.tri_edge1, scene.tri_edge2,
            scene.tri_geometry, scene.tri_primitive, tn, tx)
        got = tracers.closest_hit(o, d, tn, tx)
        skip = grazing(scene, d, got, ref)
        compare_closest(name + " closest", scene, o, d, got, ref, skip)
        ref_b = occluded_brute_force(o, d, scene.tri_v0, scene.tri_edge1,
                                     scene.tri_edge2, tn, tx)
        compare_occluded(name + " occluded", tracers.occluded(o, d, tn, tx),
                         ref_b, skip)


def phase_tracers(scene, renderer, cam) -> None:
    rays = parity_rays(scene, renderer.tracers, cam, W, H)
    run_parity(scene, renderer.tracers, rays, f"{SCENE} bundle")

    small, small_renderer, small_cam = bench.build_case("corridor", 256, 256)
    small_rays = parity_rays(small, small_renderer.tracers, small_cam,
                             256, 256, n=4096, seed=1)
    for backend in BACKENDS:
        if backend in ("auto", "bundle"):
            continue
        run_parity(small, make_tracers(small, backend=backend), small_rays,
                   f"corridor {backend}")


def phase_goldens() -> None:
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "goldens", REPO / "tests" / "test_goldens.py")
    goldens = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(goldens)
    outputs = goldens._render(*goldens._setup())
    failed = []
    for name in goldens._CASES:
        want = np.load(goldens.GOLDEN_DIR / f"{name}.npy")
        got = outputs[name]
        if name == "normals_bits":
            bad = got != want
        else:
            bad = ~np.isclose(got, want, rtol=GOLDEN_TOL, atol=GOLDEN_TOL)
        diff = float(np.max(np.abs(got.astype(np.float64) - want)))
        print(f"golden {name}: max |diff| {diff:.3e}, "
              f"{int(bad.sum())} values outside tolerance"
              + (f" at {np.argwhere(bad)[:8].tolist()}" if bad.any() else ""))
        if bad.any():
            failed.append(name)
    check(not failed, f"golden planes outside rtol=atol={GOLDEN_TOL} "
                      f"(normals exact): {failed}")


def phase_frames(frame, g, state, card: str, n: int = 8) -> None:
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        state, img = frame(g.replace(frame=jnp.uint32(i)), state)
        host = np.asarray(img)
        times.append(time.perf_counter() - t0)
        check(host.shape == (H, W, 3), f"frame {i}: shape {host.shape}")
        check(bool(np.isfinite(host).all()), f"frame {i}: non-finite pixels")
        check(float(host.max()) > 0.0, f"frame {i}: image is black")
    print(f"flagship frames {W}x{H} on {card}: wall ms incl. readback "
          + " ".join(f"{t * 1e3:.1f}" for t in times))


def phase_rmse() -> None:
    out = bench.run_rmse(size=128, restir_frames=1536)
    print("rmse: " + json.dumps({k: out.get(k) for k in (
        "rmse", "energy_ratio", "passes_gate_face_value", "size",
        "restir_frames", "oracle_frames", "oracle_spp")}))
    check(bool(out.get("passes_gate_face_value")),
          f"DI RMSE {out.get('rmse')} fails the 1e-2 face-value gate")


def four_cards(renderer, cam) -> None:
    """The row-sharded halo path over a 4-card 1-D mesh vs the same frame
    on one card, for the flagship config and for checkerboard with DI
    temporal resampling."""
    import dataclasses

    from raytracer2.parallel.mesh import (
        make_mesh, make_sharded_render_fn, shard_frame_state)

    devices = jax.devices()
    check(len(devices) >= 4, f"--four-cards needs 4 GPUs, have {len(devices)}")
    mesh = make_mesh(devices[:4])
    g = bench.flagship_gconst(renderer, cam)
    g_cb = g.replace(
        enable_di_resampling=1,
        runtime_params=dataclasses.replace(
            g.runtime_params, active_checkerboard_field=1))
    single = jax.jit(lambda gc, s: render_frame(renderer, gc, s))
    for name, gc, cb in (("flagship", g, False),
                         ("checkerboard+DI temporal", g_cb, True)):
        state = init_frame_state(W, H, checkerboard=cb)
        ref = np.asarray(single(gc, state)[1])
        step = make_sharded_render_fn(renderer, mesh, explicit_halo=True)
        t0 = time.perf_counter()
        got = np.asarray(step(gc, shard_frame_state(state, mesh))[1])
        sec = time.perf_counter() - t0
        exact = float(np.mean(np.all(got == ref, axis=-1)))
        mean = float(np.mean(np.abs(got - ref)))
        print(f"four cards {name} {W}x{H}: bit-exact {exact:.4f}, "
              f"mean|diff| {mean:.2e} (first call {sec:.1f} s)")
        check(exact >= 0.95, f"{name}: {exact:.4f} bit-exact")
        check(mean < 1e-3, f"{name}: mean|diff| {mean:.2e}")
    for d in devices[:4]:
        peak = (d.memory_stats() or {}).get("peak_bytes_in_use")
        print(f"peak memory {d}: {peak} bytes")


def timed(name: str, phase, *args):
    t0 = time.perf_counter()
    out = phase(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the 4-card halo-sharded parity check")
    args = parser.parse_args(argv)

    enable_compile_cache()
    devices = jax.devices()
    print(f"devices: {devices}")
    check_devices(devices)
    card = card_line()
    print(f"card: {card}")

    t0 = time.perf_counter()
    scene, renderer, cam = bench.build_case(SCENE, W, H)
    print(f"{SCENE} scene: {scene.num_triangles} triangles, clusters built "
          f"by {cluster_mod.last_build_method} "
          f"({time.perf_counter() - t0:.1f} s)")
    check(cluster_mod.last_build_method == "sah",
          "the native SAH builder did not load")

    if args.four_cards:
        four_cards(renderer, cam)
    else:
        g = bench.flagship_gconst(renderer, cam)
        state = init_frame_state(W, H)
        frame = timed("compile", phase_compile, scene, renderer, g, state)
        timed("tracers", phase_tracers, scene, renderer, cam)
        timed("goldens", phase_goldens)
        timed("frames", phase_frames, frame, g, state, card)
        timed("rmse", phase_rmse)

    print(f"card: {card}")
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
