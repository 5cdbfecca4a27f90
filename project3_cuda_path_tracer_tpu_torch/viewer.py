"""Interactive progressive preview (--preview): the JAX package's
viewer.py over the port's Renderer.

The CUDA reference blits a PBO into a GLFW window each frame with
orbit/zoom/pan mouse controls (its src/preview.cpp and src/main.cpp:
149-205). Here, as in the JAX package, the tonemapped uint8 frame
(`Renderer.frame_uint8`) is fetched at display rate, not every iteration,
and shown with matplotlib, which is imported only inside `run_viewer`:
the card's machine may lack it. `next_frame` (step_batch, then the
displayed frame) is the loop's body without a display.

Controls, the JAX package's (the reference's mouse bindings plus
keyboard analogs, the tested headless contract):
  LMB drag    orbit phi/theta        RMB drag   zoom
  MMB drag    pan look-at in XZ
  left/right  orbit phi (LMB x)      up/down   orbit theta (LMB y)
  +/-         zoom (RMB)             a/d w/x   pan look-at in XZ (MMB)
  space       recenter look-at (Space upstream)
  s           save PNG (S upstream)  escape    save and quit (Esc upstream)
Any camera change resets the accumulator (Renderer.orbit_camera /
pan_camera: the reference's camchanged contract).
"""

from __future__ import annotations

import logging
import os

import numpy as np

log = logging.getLogger("pathtracer.viewer")

PAN_STEP = 0.5  # world units per keypress (MMB drag analog)


def handle_key(renderer, key, original_look_at=None):
    """Apply one key binding to the renderer. Returns "save", "quit" or
    None. Pure of any GUI state so it tests headlessly."""
    if key == "left":
        renderer.orbit_camera(dphi=0.1)
    elif key == "right":
        renderer.orbit_camera(dphi=-0.1)
    elif key == "up":
        renderer.orbit_camera(dtheta=-0.1)
    elif key == "down":
        renderer.orbit_camera(dtheta=0.1)
    elif key in ("+", "="):
        renderer.orbit_camera(dzoom=-0.5)
    elif key == "-":
        renderer.orbit_camera(dzoom=0.5)
    elif key == "a":
        renderer.pan_camera(dx=-PAN_STEP)
    elif key == "d":
        renderer.pan_camera(dx=PAN_STEP)
    elif key == "w":
        renderer.pan_camera(dy=PAN_STEP)
    elif key == "x":
        renderer.pan_camera(dy=-PAN_STEP)
    elif key == " ":
        # Space restores the scene file's original lookAt (the reference
        # resets to its ogLookAt)
        la = (
            original_look_at
            if original_look_at is not None
            else renderer.scene.state.camera.look_at
        )
        renderer.orbit_camera(look_at=la)
    elif key == "s":
        return "save"
    elif key == "escape":
        return "quit"
    return None


def handle_drag(renderer, button, dx_px, dy_px, size):
    """Apply one mouse-drag delta (pixels) to the renderer: the math of
    the reference's mousePositionCallback. button: 1=LMB orbit, 2=MMB pan,
    3=RMB zoom (matplotlib MouseButton values). size = (width, height) in
    pixels. Camera changes reset the accumulator."""
    w, h = size
    if button == 1:
        # phi -= dx/width; theta -= dy/height
        renderer.orbit_camera(dphi=-dx_px / w, dtheta=-dy_px / h)
    elif button == 3:
        # zoom += dy/height, clamped >= 0.1 in orbit_camera
        renderer.orbit_camera(dzoom=dy_px / h)
    elif button == 2:
        # lookAt -= dx*right*0.01; += dy*forward*0.01 with y-flattened axes
        renderer.pan_camera(dx=0.01 * dx_px, dy=0.01 * dy_px)


def next_frame(renderer, batch: int) -> np.ndarray:
    """One frame of the loop: `batch` more samples (step_batch), then the
    tonemapped frame as displayed (x flipped, as the saved image is)."""
    renderer.step_batch(batch)
    return renderer.frame_uint8()[:, ::-1, :]


def run_viewer(renderer, target_iterations: int, batch: int = 8,
               backend: str | None = None, max_frames: int | None = None,
               out_dir: str = "."):
    """Drive the interactive preview loop; the saves (s, escape, the
    render's completion) go to `out_dir`.

    backend: matplotlib backend override ("Agg" runs headless, as the
    tests and chip_smoke.py do); None takes $MPLBACKEND, else TkAgg.
    max_frames bounds the loop for tests."""
    import matplotlib

    backend = backend or os.environ.get("MPLBACKEND") or "TkAgg"
    try:
        matplotlib.use(backend)
    except Exception:
        pass
    import matplotlib.pyplot as plt

    original_look_at = renderer.scene.state.camera.look_at.copy()

    fig, ax = plt.subplots(figsize=(7, 7))
    if fig.canvas.manager is not None:
        try:
            fig.canvas.manager.set_window_title("pathtracer (torch)")
        except Exception:
            pass
    im = ax.imshow(renderer.frame_uint8()[:, ::-1, :])
    ax.axis("off")

    state = {"quit": False}

    def on_key(event):
        action = handle_key(renderer, event.key, original_look_at)
        if action in ("save", "quit"):
            path = renderer.save(out_dir=out_dir)
            log.info("saved %s", path)
        if action == "quit":
            state["quit"] = True

    fig.canvas.mpl_connect("key_press_event", on_key)

    # mouse drags (LMB orbit / RMB zoom / MMB pan); the displayed frame is
    # x-flipped ([:, ::-1]), so screen-x deltas negate to match the
    # reference's world-space drag direction
    drag = {"button": None, "x": None, "y": None}

    def on_press(event):
        drag["button"] = getattr(event.button, "value", event.button)
        drag["x"], drag["y"] = event.x, event.y

    def on_release(event):
        drag["button"] = None

    def on_motion(event):
        if drag["button"] is None or event.x is None or event.y is None:
            return
        dx = event.x - (drag["x"] if drag["x"] is not None else event.x)
        # mpl canvas y grows upward; GLFW ypos grows downward
        dy = (drag["y"] if drag["y"] is not None else event.y) - event.y
        drag["x"], drag["y"] = event.x, event.y
        if dx == 0 and dy == 0:
            return
        w, hgt = fig.canvas.get_width_height()
        handle_drag(renderer, drag["button"], -dx, dy, (w, hgt))

    fig.canvas.mpl_connect("button_press_event", on_press)
    fig.canvas.mpl_connect("button_release_event", on_release)
    fig.canvas.mpl_connect("motion_notify_event", on_motion)
    interactive = backend.lower() != "agg"
    if interactive:
        plt.ion()
        plt.show()

    frames = 0
    while not state["quit"] and renderer.iteration < target_iterations:
        im.set_data(next_frame(renderer, batch))
        # the window title shows the iteration count
        ax.set_title(f"iteration {renderer.iteration}", fontsize=9)
        fig.canvas.draw_idle()
        if interactive:
            plt.pause(0.001)
        frames += 1
        if max_frames is not None and frames >= max_frames:
            break

    if renderer.iteration >= target_iterations:
        path = renderer.save(out_dir=out_dir)
        log.info("render complete, saved %s", path)
    if interactive:
        plt.ioff()
    plt.close(fig)
