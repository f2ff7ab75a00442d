"""Skeleton + hand-state visualization — the BodyBasics sample's
rendering (src_yolo2/BodyBasics.cpp:100-634) without Direct2D: bones as
line segments between tracked joints, hands as filled circles colored
by state (green=open, red=closed, blue=lasso), inferred joints drawn
thin. Pure numpy onto an RGB frame so it composes with ops/draw and the
streaming demo writer.
"""

from __future__ import annotations

import numpy as np

# Kinect v2 joint indices used by the bone list (JointType enum)
SPINE_BASE, SPINE_MID, NECK, HEAD = 0, 1, 2, 3
SHOULDER_L, ELBOW_L, WRIST_L, HAND_L = 4, 5, 6, 7
SHOULDER_R, ELBOW_R, WRIST_R, HAND_R = 8, 9, 10, 11
HIP_L, KNEE_L, ANKLE_L, FOOT_L = 12, 13, 14, 15
HIP_R, KNEE_R, ANKLE_R, FOOT_R = 16, 17, 18, 19
SPINE_SHOULDER = 20

# the torso/arm/leg bone list BodyBasics draws (DrawBody:525-560)
BONES = [
    (HEAD, NECK), (NECK, SPINE_SHOULDER), (SPINE_SHOULDER, SPINE_MID),
    (SPINE_MID, SPINE_BASE),
    (SPINE_SHOULDER, SHOULDER_R), (SPINE_SHOULDER, SHOULDER_L),
    (SPINE_BASE, HIP_R), (SPINE_BASE, HIP_L),
    (SHOULDER_R, ELBOW_R), (ELBOW_R, WRIST_R), (WRIST_R, HAND_R),
    (SHOULDER_L, ELBOW_L), (ELBOW_L, WRIST_L), (WRIST_L, HAND_L),
    (HIP_R, KNEE_R), (KNEE_R, ANKLE_R), (ANKLE_R, FOOT_R),
    (HIP_L, KNEE_L), (KNEE_L, ANKLE_L), (ANKLE_L, FOOT_L),
]

# HandState colors (DrawHand:585-607)
HAND_COLORS = {
    "closed": np.array([1.0, 0.0, 0.0], np.float32),
    "open": np.array([0.0, 1.0, 0.0], np.float32),
    "lasso": np.array([0.0, 0.0, 1.0], np.float32),
}

TRACKED, INFERRED = 2, 1   # TrackingState enum values


def draw_line(im: np.ndarray, p0, p1, color, width: int = 2):
    """Clipped line via dense parameter sampling (no cv2)."""
    h, w = im.shape[:2]
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1)) * 2
    ts = np.linspace(0.0, 1.0, n)
    xs = (p0[0] + (p1[0] - p0[0]) * ts).astype(int)
    ys = (p0[1] + (p1[1] - p0[1]) * ts).astype(int)
    r = width // 2
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            xi = np.clip(xs + dx, 0, w - 1)
            yi = np.clip(ys + dy, 0, h - 1)
            im[yi, xi] = color
    return im


def draw_circle(im: np.ndarray, center, radius: float, color):
    h, w = im.shape[:2]
    yy, xx = np.mgrid[:h, :w]
    m = (yy - center[1]) ** 2 + (xx - center[0]) ** 2 <= radius ** 2
    im[m] = color
    return im


def draw_body(im: np.ndarray, joints_px: np.ndarray,
              tracking_state=None, hand_left: str = "unknown",
              hand_right: str = "unknown",
              hand_radius: float = 10.0) -> np.ndarray:
    """Render one body. im: HWC float RGB [0,1] (modified in place).
    joints_px: (25, 2) pixel coords. tracking_state: (25,) ints
    (2=tracked, 1=inferred, 0=not tracked) — bones with a not-tracked
    end are skipped, inferred bones drawn thin, exactly DrawBone's
    three-way policy (BodyBasics.cpp:565-583)."""
    ts = (np.full(len(joints_px), TRACKED) if tracking_state is None
          else np.asarray(tracking_state))
    bone_col = np.array([0.2, 1.0, 0.2], np.float32)
    thin_col = np.array([0.7, 0.7, 0.7], np.float32)
    for a, b in BONES:
        if a >= len(joints_px) or b >= len(joints_px):
            continue
        if ts[a] == 0 or ts[b] == 0:
            continue
        if ts[a] == TRACKED and ts[b] == TRACKED:
            draw_line(im, joints_px[a], joints_px[b], bone_col, width=3)
        else:
            draw_line(im, joints_px[a], joints_px[b], thin_col, width=1)
    for hand, state in ((HAND_L, hand_left), (HAND_R, hand_right)):
        color = HAND_COLORS.get(state)
        if color is not None and hand < len(joints_px):
            draw_circle(im, joints_px[hand], hand_radius, color)
    return im


__all__ = ["draw_body", "draw_line", "draw_circle", "BONES",
           "HAND_COLORS"]
