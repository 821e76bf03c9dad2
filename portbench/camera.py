"""The benchmark's orbit camera: the upstream viewer's model (yaw and pitch
around a centre at a radius, src/Camera.cpp:111-130; its drag gestures,
src/MouseKeyboardInput.h:67-111), in double precision, packed into the
16-float camera vector the renderer takes (resolution, position, view, up,
fov, aperture, focal distance, environment rotation)."""
from __future__ import annotations

import dataclasses
import math

import numpy as np

YAW_PER_CELL = 0.01       # a left drag's radians per terminal cell
PITCH_PER_CELL = 0.02
PITCH_PAD = 0.05


@dataclasses.dataclass
class Orbit:
    center: tuple = (0.0, 0.8, 0.0)
    radius: float = 4.0
    yaw: float = 0.0
    pitch: float = 0.25
    fovx: float = 60.0

    def drag(self, dx, dy):
        """A left drag of (dx, dy) cells: yaw and pitch, pitch clamped."""
        self.yaw = (self.yaw + -dx * YAW_PER_CELL) % (2 * math.pi)
        self.pitch = min(max(self.pitch + -dy * PITCH_PER_CELL,
                             -math.pi / 2 + PITCH_PAD),
                         math.pi / 2 - PITCH_PAD)

    def fields(self, width, height):
        """The camera's fields at a resolution, as the renderer's camera
        record holds them: (resolution, position, view, up, fov)."""
        to_cam = np.array([math.sin(self.yaw) * math.cos(self.pitch),
                           math.sin(self.pitch),
                           math.cos(self.yaw) * math.cos(self.pitch)])
        fovy = math.degrees(math.atan(math.tan(math.radians(self.fovx) * 0.5)
                                      * (float(height) / float(width))) * 2.0)
        return ((float(width), float(height)),
                tuple(np.asarray(self.center) + to_cam * self.radius),
                tuple(-to_cam), (0.0, 1.0, 0.0), (self.fovx, fovy))

    def vector(self, width, height):
        """The [16] f32 camera vector (no lens, no env rotation)."""
        res, pos, view, up, fov = self.fields(width, height)
        return np.array(list(res) + list(pos) + list(view) + list(up)
                        + list(fov) + [0.0, 1.0, 0.0], np.float32)
