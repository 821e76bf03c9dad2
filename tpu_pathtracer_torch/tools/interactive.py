"""Interactive progressive viewer in the terminal (port of
tools/interactive.py).

An ANSI truecolor half-block display with termios raw input, in place of
the reference's GLUT window, with the same bindings:

  w/a/s/d  move camera (goForward/strafe)     r/f  altitude up/down
  arrows   yaw / pitch                        [ ]  orbit radius
  g/h      aperture -/+                       t/y  focal distance +/-
  n/m      rotate envmap (also: shift-drag)
  space    reset accumulation (buffer_reset)  ,/.  save / load camera (.cam)
  q / ESC  save output500.ppm and exit

Mouse (xterm SGR 1006 reporting, on while the viewer runs): left-drag
orbits (yaw / pitch), right-drag and the wheel change the orbit radius,
shift-drag rotates the environment map.

Any camera change resets the accumulation, like the reference's
buffer_reset. For 0.25 s after a change the view renders a 1-spp preview
at 1/div of the resolution (a second Renderer on the first one's scene
tensors, `base_scene`), upscaled by pixel repetition on the device; then
it converges at full resolution, `--batch` samples a step. Snapshots
output5.ppm and output50.ppm are written after 5 s and 50 s,
output500.ppm on exit, and a stats line once a second.

The loop is a `ViewerSession`: it takes one step's key and mouse events
and returns that step's image, on an injected clock, so tests and
chip_smoke.py drive it without a terminal; `main()` alone owns the
terminal. Each step reads back only the finished uint8 image, in one
copy (Renderer.accum_to_image tonemaps, un-swizzles and repeats the
preview's pixels on the device).

    python -m tpu_pathtracer_torch.tools.interactive [--demo default]
        [--scene desc.json] [--size 128] [--batch 4] [--preview-div 2]

The device is --device (default cuda). The JAX tool's
--compile-cache-dir has no counterpart: the kernels' build is cached by
utils/cuda_build.py (a hashed build directory per source).
"""
from __future__ import annotations

import argparse
import os
import select
import sys
import time

import torch

from ..utils.profiling import span

MOVING_S = 0.25                 # preview window after a camera change
SNAPSHOTS = ((5.0, "output5.ppm"), (50.0, "output50.ppm"))


def half_block_frame(img):
    """img: uint8 [H,W,3] with H even -> ANSI string, 2 pixels per cell."""
    H, W, _ = img.shape
    rows = []
    for y in range(0, H - 1, 2):
        cells = []
        for x in range(W):
            t = img[y, x]
            b = img[y + 1, x]
            cells.append("\x1b[38;2;%d;%d;%dm\x1b[48;2;%d;%d;%dm▀"
                         % (t[0], t[1], t[2], b[0], b[1], b[2]))
        rows.append("".join(cells) + "\x1b[0m")
    return "\n".join(rows)


def decode_sgr_mouse(params, final):
    """Decode one xterm SGR-1006 mouse report \\x1b[<b;x;y(M|m).

    Returns ("MOUSE", kind, button, shift, x, y) where kind is "press",
    "drag", "release" or "wheel"; button is 0 left / 1 middle / 2 right
    (wheel: +1 up / -1 down). None on a malformed report."""
    try:
        b, x, y = (int(p) for p in params.split(";"))
    except ValueError:
        return None
    shift = bool(b & 4)
    if b & 64:                       # wheel: 64 = up, 65 = down
        return ("MOUSE", "wheel", 1 if (b & 3) == 0 else -1, shift, x, y)
    kind = ("release" if final == "m"
            else "drag" if b & 32 else "press")
    return ("MOUSE", kind, b & 3, shift, x, y)


class RawInput:
    """The terminal in cbreak mode with mouse reporting, for `with`."""
    # 1002 = button-event (drag) tracking; 1006 = SGR extended coords
    _MOUSE_ON = "\x1b[?1002h\x1b[?1006h"
    _MOUSE_OFF = "\x1b[?1002l\x1b[?1006l"

    def __enter__(self):
        import termios
        import tty
        self.fd = sys.stdin.fileno()
        self.old = termios.tcgetattr(self.fd)
        tty.setcbreak(self.fd)
        sys.stdout.write(self._MOUSE_ON)
        sys.stdout.flush()
        return self

    def __exit__(self, *a):
        import termios
        sys.stdout.write(self._MOUSE_OFF)
        sys.stdout.flush()
        termios.tcsetattr(self.fd, termios.TCSADRAIN, self.old)

    def poll(self):
        keys = []
        while select.select([sys.stdin], [], [], 0)[0]:
            ch = sys.stdin.read(1)
            if ch != "\x1b":
                keys.append(ch)
                continue
            if not select.select([sys.stdin], [], [], 0.01)[0]:
                keys.append("ESC")
                continue
            c1 = sys.stdin.read(1)
            if c1 != "[":
                keys.append("ESC")
                continue
            c2 = sys.stdin.read(1)
            if c2 in "ABCD":
                keys.append({"A": "UP", "B": "DOWN", "C": "RIGHT",
                             "D": "LEFT"}[c2])
            elif c2 == "<":
                params = ""
                while True:
                    c = sys.stdin.read(1)
                    if c in "Mm" or not c:
                        break
                    params += c
                ev = decode_sgr_mouse(params, c)
                if ev is not None:
                    keys.append(ev)
            else:
                keys.append("ESC")
        return keys


class MouseOrbit:
    """Drag state machine mapping SGR mouse events onto the interactive
    camera, with the reference's gesture map (src/MouseKeyboardInput.h:
    67-111)."""

    YAW_PER_CELL = 0.01     # rad per terminal cell (2 image px vertically)
    PITCH_PER_CELL = 0.02
    RADIUS_PER_CELL = 0.05
    ENV_PER_CELL = 0.002    # envmap rotation is in [0,1) turns

    def __init__(self):
        self.last = None     # (x, y) of the previous press/drag report

    def apply(self, ev, icam):
        """Returns True if the camera changed (=> reset accumulation)."""
        _, kind, button, shift, x, y = ev
        if kind == "wheel":
            icam.change_radius(-button * self.RADIUS_PER_CELL * 3.0)
            return True
        if kind == "press":
            self.last = (x, y)
            return False
        if kind == "release":
            self.last = None
            return False
        # drag
        if self.last is None:
            self.last = (x, y)
            return False
        dx, dy = x - self.last[0], y - self.last[1]
        self.last = (x, y)
        if dx == 0 and dy == 0:
            return False
        if shift:
            icam.env_map_rotation = (
                icam.env_map_rotation + dx * self.ENV_PER_CELL) % 1.0
        elif button == 2:
            icam.change_radius(dy * self.RADIUS_PER_CELL)
        else:
            icam.change_yaw(-dx * self.YAW_PER_CELL)
            icam.change_pitch(-dy * self.PITCH_PER_CELL)
        return True


# key bindings of src/MouseKeyboardInput.h:26-64: key -> (InteractiveCamera
# method, argument); n / m turn the environment map
KEYS = {
    "w": ("go_forward", 0.1), "s": ("go_forward", -0.1),
    "a": ("strafe", -0.1), "d": ("strafe", 0.1),
    "r": ("change_altitude", 0.1), "f": ("change_altitude", -0.1),
    "g": ("change_aperture_diameter", -0.1),
    "h": ("change_aperture_diameter", 0.1),
    "t": ("change_focal_distance", 0.1),
    "y": ("change_focal_distance", -0.1),
    "LEFT": ("change_yaw", 0.02), "RIGHT": ("change_yaw", -0.02),
    "UP": ("change_pitch", 0.02), "DOWN": ("change_pitch", -0.02),
    "[": ("change_radius", -0.1), "]": ("change_radius", 0.1),
}
ENV_KEYS = {"n": 0.01, "m": -0.01}


def apply_key(icam, k, cam_path):
    """Apply key k to the camera; True if the accumulation must reset
    (a camera change, or space). ',' saves the camera to cam_path and '.'
    loads it from there."""
    from ..scene.camera import InteractiveCamera
    if k in KEYS:
        method, arg = KEYS[k]
        getattr(icam, method)(arg)
    elif k in ENV_KEYS:
        icam.env_map_rotation = (icam.env_map_rotation + ENV_KEYS[k]) % 1.0
    elif k == ",":
        icam.save_cam(cam_path)
        return False
    elif k == ".":
        if os.path.exists(cam_path):
            icam.__dict__.update(InteractiveCamera.load_cam(cam_path).__dict__)
    elif k != " ":
        return False
    return True


def preview_renderer(renderer, parts, div):
    """The Renderer of the moving-camera preview at 1/div of renderer's
    resolution, on its scene tensors (base_scene); parts = (flat_bvh,
    materials, envmap, texture) it was built from. None where the upscale
    is not exact (then moving frames render at full resolution)."""
    from ..tracer.renderer import Renderer
    W, H = renderer.width, renderer.height
    if not (div > 1 and W % div == 0 and H % div == 0 and W >= 32 * div
            and H >= 32 * div):
        return None
    fb, mats, envmap, texture = parts
    return Renderer(fb, mats, envmap=envmap, texture=texture,
                    width=W // div, height=H // div,
                    settings=renderer.settings, base_scene=renderer.scene,
                    device=renderer.device)


class ViewerSession:
    """The viewer's loop without the terminal. step(events) applies one
    step's keys ("w", "LEFT", " ", "q", ...) and mouse events
    (decode_sgr_mouse tuples) and returns the step's uint8 [H,W,3] image,
    or None after q / ESC. renderer_lo: the preview Renderer
    (preview_renderer) or None. Times come from `clock` (seconds,
    monotonic):
    the preview window after a camera change, the snapshots (written into
    out_dir) and the stats line. Attributes after a step: kind ("preview"
    or "full"), frame (samples in the accumulation), accum, camera (the
    RenderCamera rendered)."""

    def __init__(self, renderer, icam, renderer_lo=None, batch=4,
                 cam_path="viewer.cam", out_dir=".", clock=time.monotonic):
        self.renderer = renderer
        self.icam = icam
        self.batch = int(batch)
        self.cam_path = cam_path
        self.out_dir = out_dir
        self.clock = clock
        self.lo = renderer_lo
        self.mouse = MouseOrbit()
        self.accum = renderer.zeros_accum()
        self.frame = 0
        self.t_start = clock()
        self.last_move = -1.0
        self.last_stats = 0.0
        self.written = set()
        self.kind = None
        self.camera = None

    def step(self, events=()):
        r = self.renderer
        reset = False
        for k in events:
            if isinstance(k, tuple) and k[0] == "MOUSE":
                reset = self.mouse.apply(k, self.icam) or reset
            elif k in ("q", "ESC"):
                return None
            else:
                reset = apply_key(self.icam, k, self.cam_path) or reset
        now = self.clock()
        if reset:
            self.accum = r.zeros_accum()
            self.frame = 0
            self.last_move = now
        if self.lo is not None and now - self.last_move < MOVING_S:
            lo = self.lo
            self.icam.set_resolution(lo.width, lo.height)
            self.camera = self.icam.build_render_camera()
            self.icam.set_resolution(r.width, r.height)
            with span("pt.viewer.preview"):
                acc = lo.render_frames(lo.zeros_accum(), self.camera, 1, 1)
            # preview_renderer guarantees one exact factor in both axes
            img = lo.accum_to_image(acc, 1, repeat=r.height // lo.height)
            self.kind = "preview"
        else:
            self.camera = self.icam.build_render_camera()
            self.accum = r.render_frames(self.accum, self.camera,
                                         self.frame + 1, self.batch)
            self.frame += self.batch
            img = r.accum_to_image(self.accum, self.frame)
            self.kind = "full"
        el = now - self.t_start
        for t, name in SNAPSHOTS:
            if el > t and name not in self.written:
                self.snapshot(name)
        return img

    def snapshot(self, name):
        """Write the accumulation to out_dir/name as a PPM."""
        from ..core.image import write_ppm
        write_ppm(os.path.join(self.out_dir, name),
                  self.renderer.accum_to_buffer(self.accum),
                  max(self.frame, 1))
        self.written.add(name)

    def stats_line(self):
        """The once-a-second stats line, or None when one is not due."""
        el = self.clock() - self.t_start
        if el - self.last_stats < 1.0:
            return None
        self.last_stats = el
        return ("time %.1fs  frames %d  %.1f spp/s   [wasd/rf move, arrows "
                "look, g/h t/y lens, space reset, q quit]"
                % (el, self.frame, self.frame / max(el, 1e-9)))

    def close(self):
        """Write output500.ppm."""
        self.snapshot("output500.ppm")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m tpu_pathtracer_torch.tools.interactive",
        description=__doc__.splitlines()[0])
    ap.add_argument("--demo", default="default")
    ap.add_argument("--scene", help="scene description (JSON) path")
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--cam", default="viewer.cam")
    ap.add_argument("--cache-dir", default=".bvh_cache_torch")
    ap.add_argument("--batch", type=int, default=4,
                    help="samples per converging step")
    ap.add_argument("--preview-div", type=int, default=2,
                    help="moving-camera preview downscale (2 = half-res, "
                         "4 = quarter-res)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap.parse_args(argv)


def build(args, device):
    """(renderer, interactive camera, (flat_bvh, materials, envmap,
    texture)) of the arguments."""
    from ..scene.camera import InteractiveCamera
    from ..scene.demo import default_camera
    from ..tracer.renderer import Renderer, scene_parts_from_desc
    from .render import DEMOS, _demo_parts
    W = H = args.size
    settings = None
    if args.scene:
        from ..scene.config import load_scene_desc
        desc = load_scene_desc(args.scene)
        fb, mats, envmap, texture, settings = scene_parts_from_desc(
            desc, base_dir=os.path.dirname(args.scene),
            cache_dir=args.cache_dir)
    else:
        if args.demo not in DEMOS:
            raise SystemExit("unknown demo %r (want one of %s)"
                             % (args.demo, ", ".join(DEMOS)))
        fb, mats, envmap, texture = _demo_parts(args.demo, args.cache_dir)
    renderer = Renderer(fb, mats, envmap=envmap, texture=texture, width=W,
                        height=H, settings=settings, device=device)
    icam = default_camera(W, H)
    if os.path.exists(args.cam):
        icam = InteractiveCamera.load_cam(args.cam)
        icam.set_resolution(W, H)
    return renderer, icam, (fb, mats, envmap, texture)


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("interactive: no CUDA device (pass --device cpu to "
                         "view on the CPU)")
    renderer, icam, parts = build(args, device)
    sess = ViewerSession(
        renderer, icam,
        preview_renderer(renderer, parts, max(1, args.preview_div)),
        batch=args.batch, cam_path=args.cam)
    sys.stdout.write("\x1b[2J")  # clear
    with RawInput() as inp:
        while True:
            img = sess.step(inp.poll())
            if img is None:
                break
            sys.stdout.write("\x1b[H" + half_block_frame(img))
            line = sess.stats_line()
            if line:
                sys.stdout.write("\n\x1b[0m" + line)
            sys.stdout.flush()
    sess.close()
    print("\nsaved output500.ppm (%d spp)" % sess.frame)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
