"""Camera model: render camera POD + interactive orbit camera + .cam file IO.

Parity with reference src/Camera.h / src/Camera.cpp: the orbit model
(yaw/pitch/radius around centerPosition, buildRenderCamera at
src/Camera.cpp:111-130), pitch clamp +/-(pi/2 - 0.05), and the 64-byte raw
binary .cam dump format (src/Camera.cpp:176-203).
"""
from __future__ import annotations

import dataclasses
import math
import struct

import numpy as np

PI = math.pi


@dataclasses.dataclass
class RenderCamera:
    """POD handed to the device each frame (reference Camera, src/Camera.h:10-20)."""
    resolution: tuple = (1920.0, 1080.0)
    position: tuple = (0.0, 0.0, 0.0)
    view: tuple = (0.0, 0.0, -1.0)
    up: tuple = (0.0, 1.0, 0.0)
    fov: tuple = (60.0, 60.0)
    aperture_radius: float = 0.0
    focal_distance: float = 1.0
    env_map_rotation: float = 0.0

    def as_array(self) -> np.ndarray:
        """Pack into a flat f32 array for a cheap host->device transfer
        (analog of the 64-byte cudaMemcpy at src/main.cpp:173).
        Layout: res(2) pos(3) view(3) up(3) fov(2) aperture(1) focal(1) envrot(1)."""
        return np.array(
            list(self.resolution) + list(self.position) + list(self.view)
            + list(self.up) + list(self.fov)
            + [self.aperture_radius, self.focal_distance, self.env_map_rotation],
            np.float32)


@dataclasses.dataclass
class InteractiveCamera:
    """Orbit camera; defaults match the reference ctor (src/Camera.cpp:9-22)."""
    center_position: tuple = (0.0, 0.0, 0.0)
    view_direction: tuple = (0.0, 0.0, -1.0)
    yaw: float = 0.0
    pitch: float = 0.3
    radius: float = 5.0
    aperture_radius: float = 0.0
    focal_distance: float = 1.0
    env_map_rotation: float = 0.0
    resolution: tuple = (1920.0, 1080.0)
    fov: tuple = (60.0, 60.0 / 1920.0 * 1080.0)

    # ---- interaction ops (reference src/Camera.cpp:26-109 +
    # src/MouseKeyboardInput.h key bindings) ----
    def change_yaw(self, m):
        self.yaw = (self.yaw + m) % (2 * PI)

    def change_pitch(self, m):
        pad = 0.05
        self.pitch = min(max(self.pitch + m, -PI / 2 + pad), PI / 2 - pad)

    def change_radius(self, m):
        self.radius = min(max(self.radius * (1 + m), 0.2), 100.0)

    def change_altitude(self, m):
        c = list(self.center_position)
        c[1] += m
        self.center_position = tuple(c)

    def go_forward(self, m):
        self.center_position = tuple(
            np.asarray(self.center_position) + np.asarray(self.view_direction) * m)

    def strafe(self, m):
        axis = np.cross(np.asarray(self.view_direction), [0.0, 1.0, 0.0])
        axis = axis / max(np.linalg.norm(axis), 1e-20)
        self.center_position = tuple(np.asarray(self.center_position) + axis * m)

    def change_aperture_diameter(self, m):
        self.aperture_radius = min(max((self.aperture_radius + 0.01) * m
                                       + self.aperture_radius, 0.0), 25.0)

    def change_focal_distance(self, m):
        self.focal_distance = min(max(self.focal_distance + m, 0.2), 100.0)

    def set_resolution(self, x, y):
        self.resolution = (float(x), float(y))
        self.set_fovx(self.fov[0])

    def set_fovx(self, fovx):
        fovy = math.degrees(math.atan(math.tan(math.radians(fovx) * 0.5)
                                      * (self.resolution[1] / self.resolution[0])) * 2.0)
        self.fov = (fovx, fovy)

    def build_render_camera(self) -> RenderCamera:
        xd = math.sin(self.yaw) * math.cos(self.pitch)
        yd = math.sin(self.pitch)
        zd = math.cos(self.yaw) * math.cos(self.pitch)
        to_cam = np.array([xd, yd, zd])
        view = tuple(-to_cam)
        self.view_direction = view
        eye = tuple(np.asarray(self.center_position) + to_cam * self.radius)
        return RenderCamera(
            resolution=self.resolution,
            position=eye,
            view=view,
            up=(0.0, 1.0, 0.0),
            fov=self.fov,
            aperture_radius=self.aperture_radius,
            focal_distance=self.focal_distance,
            env_map_rotation=self.env_map_rotation,
        )

    # ---- 64-byte binary .cam IO; field order = reference member declaration
    # order (src/Camera.h:26-64): centerPosition, viewDirection, yaw, pitch,
    # radius, apertureRadius, focalDistance, envMapRotation, resolution, fov.
    _FMT = "<3f3f5f1f2f2f"

    def save_cam(self, path):
        with open(path, "wb") as f:
            f.write(struct.pack(
                self._FMT,
                *self.center_position, *self.view_direction,
                self.yaw, self.pitch, self.radius,
                self.aperture_radius, self.focal_distance,
                self.env_map_rotation, *self.resolution, *self.fov))

    @classmethod
    def load_cam(cls, path):
        with open(path, "rb") as f:
            vals = struct.unpack(cls._FMT, f.read(struct.calcsize(cls._FMT)))
        cam = cls()
        cam.center_position = vals[0:3]
        cam.view_direction = vals[3:6]
        (cam.yaw, cam.pitch, cam.radius,
         cam.aperture_radius, cam.focal_distance, cam.env_map_rotation) = vals[6:12]
        cam.resolution = vals[12:14]
        cam.fov = vals[14:16]
        return cam
