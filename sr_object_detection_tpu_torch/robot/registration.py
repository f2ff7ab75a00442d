"""RGB-D camera registration: map color-frame pixels/boxes to depth frame.

The reference relies on the Kinect SDK's coordinate mapper
(MapColorFrameToDepthSpace in KinectUtil.cpp:207-235 and
MapDepthPointToCameraSpace:437-443). Headless equivalent: pinhole
reprojection through the depth camera's intrinsics + the rigid
color<->depth extrinsic transform.

Pipeline per detection box (color-relative coords):
  1. project the box center into a depth-frame pixel via
     :func:`color_box_to_depth` (using the current depth for parallax);
  2. average non-zero depth in the remapped ROI;
  3. back-project to camera meters (native.sr_depth_to_camera).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CameraModel:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    def project(self, pts_xyz: np.ndarray) -> np.ndarray:
        """(N,3) camera-space meters -> (N,2) pixels."""
        z = np.maximum(pts_xyz[:, 2:3], 1e-6)
        u = pts_xyz[:, 0:1] / z * self.fx + self.cx
        v = pts_xyz[:, 1:2] / z * self.fy + self.cy
        return np.concatenate([u, v], axis=1)

    def unproject(self, px: np.ndarray, depth_m: np.ndarray) -> np.ndarray:
        """(N,2) pixels + (N,) depth meters -> (N,3) camera meters."""
        x = (px[:, 0] - self.cx) / self.fx * depth_m
        y = (px[:, 1] - self.cy) / self.fy * depth_m
        return np.stack([x, y, depth_m], axis=1)


@dataclasses.dataclass(frozen=True)
class Registration:
    """color = R @ depth + t (rigid transform of camera frames)."""
    color: CameraModel
    depth: CameraModel
    r_depth_to_color: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(3, dtype=np.float32))
    t_depth_to_color: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, dtype=np.float32))

    def depth_px_to_color_px(self, depth_px: np.ndarray,
                             depth_m: np.ndarray) -> np.ndarray:
        pts = self.depth.unproject(depth_px, depth_m)
        pts_c = pts @ self.r_depth_to_color.T + self.t_depth_to_color
        return self.color.project(pts_c)

    def color_px_to_depth_px(self, color_px: np.ndarray,
                             depth_map_mm: np.ndarray,
                             iters: int = 3) -> np.ndarray:
        """Inverse mapping by fixed-point iteration: guess the depth
        pixel, read its depth, reproject, refine — the software analog
        of the SDK's MapColorFrameToDepthSpace lookup table."""
        # initial guess: scale by resolution ratio
        guess = color_px * np.array([
            self.depth.width / self.color.width,
            self.depth.height / self.color.height], np.float32)
        for _ in range(iters):
            xi = np.clip(guess[:, 0].astype(int), 0,
                         self.depth.width - 1)
            yi = np.clip(guess[:, 1].astype(int), 0,
                         self.depth.height - 1)
            d = depth_map_mm[yi, xi].astype(np.float32) * 1e-3
            d = np.where(d <= 0, 1.0, d)
            # project the guessed depth point into color and correct
            cpx = self.depth_px_to_color_px(guess, d)
            guess = guess + (color_px - cpx) * np.array([
                self.depth.fx / self.color.fx,
                self.depth.fy / self.color.fy], np.float32)
        return guess

    def color_box_to_depth(self, box_rel, depth_map_mm: np.ndarray):
        """(x,y,w,h) color-relative box -> depth-relative box."""
        x, y, w, h = box_rel
        cw, ch = self.color.width, self.color.height
        corners = np.array([
            [(x - w / 2) * cw, (y - h / 2) * ch],
            [(x + w / 2) * cw, (y + h / 2) * ch],
        ], np.float32)
        dpx = self.color_px_to_depth_px(corners, depth_map_mm)
        dw, dh = self.depth.width, self.depth.height
        x0, y0 = dpx[0]
        x1, y1 = dpx[1]
        return ((x0 + x1) / 2 / dw, (y0 + y1) / 2 / dh,
                abs(x1 - x0) / dw, abs(y1 - y0) / dh)


# Kinect v2 nominal models (public calibration values)
KINECT_DEPTH = CameraModel(365.456, 365.456, 254.878, 205.395, 512, 424)
KINECT_COLOR = CameraModel(1081.37, 1081.37, 959.5, 539.5, 1920, 1080)
KINECT_T = np.array([-0.052, 0.0, 0.0], np.float32)   # ~52mm baseline


def kinect_registration() -> Registration:
    return Registration(color=KINECT_COLOR, depth=KINECT_DEPTH,
                        t_depth_to_color=KINECT_T)


__all__ = ["CameraModel", "Registration", "kinect_registration",
           "KINECT_DEPTH", "KINECT_COLOR"]
