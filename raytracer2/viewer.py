"""Interactive frame loop: a live, controllable render session.

The reference's interactive surface is a winit window + imgui GConstEditor
(src/main.rs:484-733): fly the camera with WASD/mouse while editing ReSTIR
parameters live, every change applied to the NEXT frame's GConst. This
module reproduces that capability for a terminal: frames render
continuously, display as 24-bit-color half-block cells (two pixels per
character), and keystrokes drive the same Camera.update Controls port
(scene/camera.py, camera.rs:45-97) plus live GConst toggles.

Pure helpers (`apply_keys`, `image_to_ansi`) carry all the logic so the
loop is testable without a TTY.
"""

from __future__ import annotations

import dataclasses
import select
import sys
import time

import numpy as np

from raytracer2.scene.camera import Camera, Controls

# key -> Controls field (camera.rs:160-183 key map; ijkl = mouse look)
_MOVE_KEYS = {
    "w": "go_forward",
    "s": "go_backward",
    "d": "strafe_right",
    "a": "strafe_left",
    "q": "go_up",
    "e": "go_down",
}
_LOOK_KEYS = {"i": (0.0, -40.0), "k": (0.0, 40.0),
              "j": (-40.0, 0.0), "l": (40.0, 0.0)}

# number keys toggle the GConstEditor's checkbox fields (main.rs:522-627)
_TOGGLE_KEYS = {
    "1": "enable_restir_di",
    "2": "enable_restir_gi",
    "3": "enable_temporal_resampling",
    "4": "enable_spatial_resampling",
    "5": "enable_accumulation",
    "6": "refrence_mode",
}

HELP = ("wasd+qe move | ijkl look | 1 DI | 2 GI | 3 temporal | 4 spatial | "
        "5 accumulate | 6 reference | x quit")


def apply_keys(keys: str, camera: Camera, g_const, dt: float):
    """Fold one frame's keystrokes into (camera, g_const, quit).

    Mirrors the reference loop: input events update Controls, the camera
    integrates them with the frame dt (camera.rs:45-97), and editor
    toggles rewrite GConst fields for the next frame."""
    fields = {}
    cursor = np.zeros(2, np.float32)
    quit_requested = False
    for key in keys:
        if key in _MOVE_KEYS:
            fields[_MOVE_KEYS[key]] = True
        elif key in _LOOK_KEYS:
            cursor += np.asarray(_LOOK_KEYS[key], np.float32)
        elif key in _TOGGLE_KEYS:
            name = _TOGGLE_KEYS[key]
            g_const = g_const.replace(**{name: 1 - getattr(g_const, name)})
        elif key in ("x", "\x1b", "\x03"):
            quit_requested = True
    controls = Controls(
        look_around=bool(np.any(cursor != 0.0)),
        cursor_delta=(float(cursor[0]), float(cursor[1])),
        **fields)
    return camera.update(controls, dt), g_const, quit_requested


def image_to_ansi(img_u8: np.ndarray, cols: int, rows: int) -> str:
    """[H, W, 3] u8 -> truecolor half-block frame (2 pixels per cell:
    upper pixel = foreground over `▀`, lower = background). Nearest
    sampling to the cell grid; one string, cursor-homed, no flicker."""
    h, w = img_u8.shape[:2]
    ys = (np.arange(rows * 2) * h) // (rows * 2)
    xs = (np.arange(cols) * w) // cols
    sampled = img_u8[np.ix_(ys, xs)]  # [rows*2, cols, 3]
    top = sampled[0::2]
    bot = sampled[1::2]
    lines = []
    for r in range(rows):
        cells = []
        for c in range(cols):
            tr, tg, tb = top[r, c]
            br, bg, bb = bot[r, c]
            cells.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                         f"\x1b[48;2;{br};{bg};{bb}m▀")
        lines.append("".join(cells) + "\x1b[0m")
    return "\x1b[H" + "\n".join(lines)


def _pending_keys(timeout: float) -> str:
    """Drain stdin without blocking past `timeout` (terminal-mode input:
    there are no key-up events, so each frame consumes what arrived)."""
    keys = []
    deadline = time.perf_counter() + timeout
    while True:
        wait = max(0.0, deadline - time.perf_counter())
        ready, _, _ = select.select([sys.stdin], [], [], wait)
        if not ready:
            break
        ch = sys.stdin.read(1)
        if not ch:
            break
        keys.append(ch)
        deadline = time.perf_counter()  # drain what's buffered, then go
    return "".join(keys)


def run_interactive(render_frame_fn, camera: Camera, g_const, state,
                    to_display, max_frames: int | None = None,
                    out=sys.stdout) -> None:
    """The interactive session loop (main.rs:644-733 analogue).

    render_frame_fn(g_const, state) -> (state, image); to_display(image)
    -> [H, W, 3] u8. Static-field GConst toggles retrace the frame jit,
    exactly like the reference rebuilding pipeline state on editor
    changes — the first frame after a toggle pays a compile."""
    import termios
    import tty

    if not sys.stdin.isatty():
        raise RuntimeError("interactive mode needs a TTY "
                           "(use --animate for scripted sessions)")
    import shutil

    size = shutil.get_terminal_size((100, 40))
    cols, rows = size.columns, max(size.lines - 2, 4)

    old_attrs = termios.tcgetattr(sys.stdin)
    tty.setcbreak(sys.stdin.fileno())
    out.write("\x1b[2J\x1b[?25l")  # clear, hide cursor
    try:
        prev_view = g_const.view
        frame = 0
        dt = 1.0 / 30.0
        while max_frames is None or frame < max_frames:
            t0 = time.perf_counter()
            view = camera.planar_view_constants()
            g = g_const.replace(view=view, prev_view=prev_view,
                                frame=np.uint32(frame))
            prev_view = view
            state, image = render_frame_fn(g, state)
            img_u8 = np.asarray(to_display(image))
            out.write(image_to_ansi(img_u8, cols, rows))
            dt = max(time.perf_counter() - t0, 1e-4)
            toggles = " ".join(
                k for k, f in _TOGGLE_KEYS.items() if getattr(g_const, f))
            out.write(f"\n\x1b[K{1.0 / dt:6.1f} fps | {dt * 1e3:7.1f} ms | "
                      f"pos {tuple(round(p, 1) for p in camera.position)} | "
                      f"on: [{toggles}] | {HELP}")
            out.flush()

            keys = _pending_keys(timeout=0.0)
            camera, g_const, quit_requested = apply_keys(
                keys, camera, g_const, dt)
            if quit_requested:
                break
            frame += 1
    finally:
        termios.tcsetattr(sys.stdin, termios.TCSADRAIN, old_attrs)
        out.write("\x1b[?25h\x1b[0m\n")  # restore cursor
        out.flush()
