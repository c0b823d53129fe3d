"""Application driver: the main.rs equivalent as an offline/headless CLI.

The reference's frame loop (src/main.rs:484-733) is a winit window + imgui
parameter editor; the capabilities that matter — scene load, per-frame GConst
mutation, camera fly-through, reservoir ping-pong, frame-budget telemetry —
are reproduced here as a headless driver that renders N frames along a camera
path and writes PNGs/metrics. Live parameter editing maps to CLI flags over
the same GConst surface.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
import time
from pathlib import Path

import numpy as np

from raytracer2.render.app_bridge import BACKENDS

logger = logging.getLogger("raytracer2")

FRAME_BUDGET_SECONDS = 0.016  # 16 ms budget (main.rs:653-656)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="ReSTIR path tracer in JAX (RayTracer2 rebuild)")
    p.add_argument("scene", nargs="?", default=None,
                   help=".glb/.gltf scene (default: procedural Cornell box)")
    p.add_argument("--skybox", default=None, help=".exr equirect environment")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--out", default="out", help="output directory for PNGs")
    p.add_argument("--save-every", type=int, default=1)
    p.add_argument("--camera-pos", type=float, nargs=3, default=(0.0, 0.0, 10.0))
    p.add_argument("--camera-dir", type=float, nargs=3, default=(0.0, 0.0, 1.0))
    p.add_argument("--fov", type=float, default=65.0)
    p.add_argument("--orbit", action="store_true",
                   help="orbit the camera around the origin (fly-through)")
    # GConst surface (the imgui GConstEditor fields, main.rs:522-627).
    # NOTE: GConst itself keeps the reference's startup value
    # enable_restir_di=0 (main.rs:391) for parity; the CLI defaults DI ON
    # so the flagship demo command renders DI+GI with no extra flags.
    p.add_argument("--reference-mode", action="store_true")
    p.add_argument("--enable-restir-di", type=int, default=1)
    p.add_argument("--enable-restir-gi", type=int, default=1)
    p.add_argument("--enable-temporal-resampling", type=int, default=0)
    p.add_argument("--enable-spatial-resampling", type=int, default=0)
    p.add_argument("--di-resampling", default="off",
                   choices=["off", "temporal", "spatial", "spatiotemporal"],
                   help="DI reservoir reuse in the fused pass; 'off' is "
                        "the reference quirk (the spatio-temporal call is "
                        "commented out, di_fused_resampling.rgen:69-70)")
    p.add_argument("--enable-accumulation", type=int, default=0)
    p.add_argument("--blend-factor", type=float, default=None,
                   help="accumulation blend; default auto-computes 1/N "
                        "while accumulating (main.rs:629-635)")
    p.add_argument("--environment", type=int, default=None,
                   help="1 to enable the environment light (auto if --skybox)")
    p.add_argument("--textures", type=int, default=1)
    p.add_argument("--no-bvh", action="store_true",
                   help="brute-force intersection (oracle mode)")
    p.add_argument("--backend", default="auto", choices=BACKENDS,
                   help="ray traversal engine (auto: chosen by platform)")
    # light-sampling subsystems (frame-1 presample dispatch analogues,
    # light_passes.rs:538-547; ReGIR grid = local_light_sampling_mode 2)
    p.add_argument("--presample", type=int, default=1,
                   help="fill the RIS presample tiles at scene load")
    p.add_argument("--regir", action="store_true",
                   help="build the ReGIR world-space light grid (enables "
                        "local_light_sampling_mode=2)")
    p.add_argument("--local-light-sampling-mode", type=int, default=None,
                   choices=[0, 1, 2],
                   help="0 uniform, 1 power-RIS, 2 ReGIR (needs --regir)")
    p.add_argument("--cluster-size", type=int, default=None,
                   help="triangles per cluster (acceleration build)")
    p.add_argument("--checkerboard", action="store_true",
                   help="checkerboard rendering: lighting passes trace "
                        "half the pixel grid per frame, alternating "
                        "fields (RtxdiHelpers.hlsli:16-61)")
    p.add_argument("--interactive", action="store_true",
                   help="live terminal session (main.rs:484-733 analogue): "
                        "frames render continuously as truecolor half-block "
                        "cells; WASD+QE fly, IJKL look, number keys toggle "
                        "the GConstEditor fields live")
    p.add_argument("--animate", default=None,
                   help="JSON file of per-frame GConst overrides: "
                        '{"<frame>": {"field": value, ...}, ...} — the '
                        "offline analogue of the imgui GConstEditor's "
                        "live parameter edits (main.rs:522-627)")
    p.add_argument("--profile", default=None,
                   help="write a jax profiler trace to this directory")
    p.add_argument("--checkpoint", default=None,
                   help="save final frame state to this .npz for resume")
    p.add_argument("--resume", default=None,
                   help="load frame state from a .npz checkpoint")
    return p


def load_scene(args):
    from raytracer2.scene import gltf
    from raytracer2.scene.scene import build_scene

    skybox = None
    if args.skybox:
        from raytracer2.scene.exr import load_exr

        skybox = load_exr(args.skybox)
        logger.info("skybox %s: %sx%s", args.skybox,
                    skybox.shape[1], skybox.shape[0])

    if args.scene:
        model = gltf.load_file(args.scene)
        logger.info("model loaded: %d vertices, %d indices, %d nodes",
                    model.positions.shape[0], model.indices.shape[0],
                    len(model.nodes))
    else:
        import tempfile

        from raytracer2.models import procedural as proc

        with tempfile.TemporaryDirectory() as d:
            p = Path(d) / "cornell.glb"
            proc.write_glb(p, proc.cornell_box_glb(light_emission=2.0))
            model = gltf.load_file(p)
        logger.info("procedural Cornell box loaded")
    return build_scene(model, skybox=skybox)


def save_checkpoint(path: str, state, frame: int) -> None:
    """Serialize the frame-state pytree (reservoirs, G-buffers, lighting) —
    the cross-frame persistent state the reference can't save (SURVEY.md §5)."""
    import jax

    leaves, treedef = jax.tree_util.tree_flatten(state)
    np.savez_compressed(
        path, frame=frame, treedef=str(treedef),
        **{f"leaf_{i}": np.asarray(leaf) for i, leaf in enumerate(leaves)})


def load_checkpoint(path: str, template):
    import jax
    import jax.numpy as jnp

    data = np.load(path, allow_pickle=False)
    leaves, treedef = jax.tree_util.tree_flatten(template)
    restored = [jnp.asarray(data[f"leaf_{i}"]) for i in range(len(leaves))]
    return jax.tree_util.tree_unflatten(treedef, restored), int(data["frame"])


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = build_arg_parser().parse_args(argv)

    import jax
    import jax.numpy as jnp

    # persistent XLA compile cache: the 1080p frame programs take minutes
    # to compile; cache them on disk so repeated renders pay it once per
    # machine, not once per process
    from raytracer2.compile_cache import enable_compile_cache
    enable_compile_cache()

    from raytracer2.params import default_gconst
    from raytracer2.render.frame import (
        create_renderer, init_frame_state, render_frame)
    from raytracer2.render.postprocess import to_srgb_u8
    from raytracer2.scene.camera import default_camera
    from raytracer2.utils.png import write_png

    scene = load_scene(args)
    logger.info("scene: %d triangles, %d geometries, %d emissive",
                scene.num_triangles, scene.num_geometries,
                scene.num_emissive_triangles)

    tracer_opts = ({"cluster_size": args.cluster_size}
                   if args.cluster_size is not None else None)
    renderer = create_renderer(scene, args.width, args.height,
                               use_bvh=not args.no_bvh,
                               backend=args.backend,
                               presample=bool(args.presample),
                               regir=args.regir,
                               tracer_opts=tracer_opts)
    camera = default_camera(
        window_size=(args.width, args.height),
        position=tuple(args.camera_pos), direction=tuple(args.camera_dir),
        fov=args.fov)

    environment = args.environment
    if environment is None:
        environment = 1 if args.skybox else 0

    g_const = default_gconst(
        camera.planar_view_constants(),
        renderer.scene_lights.num_local_lights,
        refrence_mode=1 if args.reference_mode else 0,
        enable_restir_di=args.enable_restir_di,
        enable_restir_gi=args.enable_restir_gi,
        enable_temporal_resampling=args.enable_temporal_resampling,
        enable_spatial_resampling=args.enable_spatial_resampling,
        enable_accumulation=args.enable_accumulation,
        textures=args.textures,
        environment=environment,
        blend_factor=jnp.float32(
            0.1 if args.blend_factor is None else args.blend_factor),
        enable_di_resampling={"off": 0, "temporal": 1, "spatial": 2,
                              "spatiotemporal": 3}[args.di_resampling],
    )

    if args.local_light_sampling_mode is not None:
        import dataclasses

        isp = dataclasses.replace(
            g_const.restir_di.initial_sampling_params,
            local_light_sampling_mode=args.local_light_sampling_mode)
        g_const = g_const.replace(restir_di=dataclasses.replace(
            g_const.restir_di, initial_sampling_params=isp))

    state = init_frame_state(args.width, args.height,
                             checkerboard=args.checkerboard)
    start_frame = 0
    if args.resume:
        state, start_frame = load_checkpoint(args.resume, state)
        logger.info("resumed from %s at frame %d", args.resume, start_frame)

    step = jax.jit(lambda g, s: render_frame(renderer, g, s))

    if args.interactive:
        from raytracer2.viewer import run_interactive

        run_interactive(step, camera, g_const, state, to_srgb_u8)
        return 0

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.profile:
        jax.profiler.start_trace(args.profile)

    from raytracer2.utils.profiler import PassTimer, count_frame_rays

    timer = PassTimer(enabled=True)

    # live GConst mutation (imgui GConstEditor analogue, main.rs:522-627):
    # overrides apply at their frame and persist; static-field changes
    # retrace the frame jit exactly like the reference rebuilding state
    animate = {}
    if args.animate:
        raw = json.loads(Path(args.animate).read_text())
        animate = {int(k): v for k, v in raw.items()}

    prev_view = g_const.view
    frame_times = []
    for f in range(start_frame, start_frame + args.frames):
        if args.orbit:
            angle = 2.0 * np.pi * (f / max(args.frames, 1)) * 0.25
            r = float(np.linalg.norm(np.asarray(args.camera_pos)))
            pos = (r * np.sin(angle), args.camera_pos[1],
                   -r * np.cos(angle))
            camera = default_camera(
                window_size=(args.width, args.height), position=pos,
                direction=tuple(-np.asarray(pos) / max(r, 1e-6)),
                fov=args.fov)
        if f in animate:
            g_const = g_const.replace(**animate[f])
            logger.info("frame %d: applied overrides %s", f, animate[f])
        view = camera.planar_view_constants()
        g = g_const.replace(view=view, prev_view=prev_view,
                            frame=jnp.uint32(f))
        if args.blend_factor is None and args.enable_accumulation:
            # auto 1/N while accumulating, exactly like the reference
            # (main.rs:629-635: blend_factor = 1 / frames_accumulated)
            g = g.replace(blend_factor=jnp.float32(
                1.0 / (f - start_frame + 1)))
        if args.checkerboard:
            g = g.replace(runtime_params=dataclasses.replace(
                g.runtime_params, active_checkerboard_field=1 + (f & 1)))
        prev_view = view

        with timer.time("frame", result=None):
            t0 = time.perf_counter()
            state, image = step(g, state)
            jax.block_until_ready(image)
            dt = time.perf_counter() - t0
        timer.count("rays", count_frame_rays(g, args.width, args.height))
        frame_times.append(dt)
        if dt > FRAME_BUDGET_SECONDS and f > start_frame:
            logger.error("Over Frame Budget!!!! %.1f ms", dt * 1000)
        logger.info("frame %d: %.1f ms (%.1f fps)", f, dt * 1000,
                    1.0 / max(dt, 1e-9))

        if (f - start_frame) % args.save_every == 0:
            write_png(out_dir / f"frame_{f:04d}.png",
                      np.asarray(to_srgb_u8(image)))

    if args.profile:
        jax.profiler.stop_trace()
        logger.info("profiler trace written to %s", args.profile)
    if args.checkpoint:
        save_checkpoint(args.checkpoint, state,
                        start_frame + args.frames)
        logger.info("checkpoint written to %s", args.checkpoint)

    steady = frame_times[1:] or frame_times
    metrics = {
        "frames": len(frame_times),
        "p50_ms": round(float(np.percentile(steady, 50)) * 1000, 2),
        "mean_ms": round(float(np.mean(steady)) * 1000, 2),
        "fps": round(1.0 / max(float(np.percentile(steady, 50)), 1e-9), 2),
        # PassTimer telemetry: p50/p95 + rays/s (strictly more than the
        # reference's FPS overlay, SURVEY.md par.5)
        "telemetry": timer.summary(),
    }
    logger.info("metrics: %s", json.dumps(metrics))
    (out_dir / "metrics.json").write_text(json.dumps(metrics))
    return 0


if __name__ == "__main__":
    sys.exit(main())
