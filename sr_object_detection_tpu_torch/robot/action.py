"""Skeleton-based action recognition: motion histograms + ELM classifier.

Re-design of the reference's Process_Kinect pipeline
(src_yolo2/Process_Kinect.cpp: Compute_Action_Histograms:2173 building
body-centric motion histograms over grids x cells x orientation bins
from joint trajectories; ELM classifier with random input weights
inW/bias and solved output weights outW, Process_Kinect.h:222 /
ELM_Initialize:183). The Kinect body-frame plumbing is replaced by a
plain (T, J, 3) joint-trajectory input so the recognizer is testable
headless.

ELM (extreme learning machine): H = g(X W_in + b) with W_in, b random
and fixed; W_out solves the ridge-regularized least squares
H W_out ~= Y. Training is a single linear solve — no SGD.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Kinect v2 joint count (JointType_Count)
N_JOINTS = 25
SPINE_BASE = 0


@dataclasses.dataclass
class HistogramConfig:
    """Body-centric motion histogram layout (Process_Kinect.h:46-78:
    grids x cells x orientations)."""
    grid: int = 3            # spatial grid over the body-centric plane
    orientations: int = 8    # motion direction bins
    min_motion: float = 1e-3


def motion_histograms(joints: np.ndarray,
                      cfg: HistogramConfig = HistogramConfig()
                      ) -> np.ndarray:
    """joints: (T, J, 3) camera-space joint positions over a clip.

    Returns a fixed-length descriptor: per spatial cell (body-centric,
    normalized by torso position/scale), a histogram of inter-frame
    joint displacement directions weighted by magnitude, plus per-joint
    mean displacement — the vectorized analog of the reference's
    cell/joint binning functions (Process_Kinect.cpp:3010-3752).
    """
    t, j, _ = joints.shape
    if t < 2:
        return np.zeros(descriptor_size(cfg, j), np.float32)
    # body-centric normalization: subtract spine base, scale by median
    # torso extent per frame
    center = joints[:, SPINE_BASE:SPINE_BASE + 1, :]
    rel = joints - center
    scale = np.median(np.linalg.norm(rel, axis=2)) + 1e-6
    rel = rel / scale

    disp = rel[1:] - rel[:-1]                     # (T-1, J, 3)
    mag = np.linalg.norm(disp, axis=2)
    ang = np.arctan2(disp[..., 1], disp[..., 0])  # in-plane direction
    obin = ((ang + np.pi) / (2 * np.pi) * cfg.orientations
            ).astype(int) % cfg.orientations

    # spatial cell of each joint (clipped grid over [-1.5, 1.5])
    gx = np.clip(((rel[:-1, :, 0] + 1.5) / 3.0 * cfg.grid).astype(int),
                 0, cfg.grid - 1)
    gy = np.clip(((rel[:-1, :, 1] + 1.5) / 3.0 * cfg.grid).astype(int),
                 0, cfg.grid - 1)
    cell = gy * cfg.grid + gx

    n_cells = cfg.grid * cfg.grid
    hist = np.zeros((n_cells, cfg.orientations), np.float32)
    moving = mag > cfg.min_motion
    np.add.at(hist, (cell[moving], obin[moving]), mag[moving])
    total = hist.sum()
    if total > 0:
        hist /= total

    per_joint = mag.mean(axis=0)                  # (J,)

    # global body motion ("scene flow" component, Process_Kinect.cpp:3876):
    # body-centric coords cancel whole-body translation, so the center
    # trajectory carries locomotion — bin its direction + magnitude.
    cdisp = (center[1:, 0, :] - center[:-1, 0, :]) / scale  # (T-1, 3)
    cmag = np.linalg.norm(cdisp, axis=1)
    cang = np.arctan2(cdisp[:, 1], cdisp[:, 0])
    cbin = ((cang + np.pi) / (2 * np.pi) * cfg.orientations
            ).astype(int) % cfg.orientations
    ghist = np.zeros(cfg.orientations, np.float32)
    gmoving = cmag > cfg.min_motion
    np.add.at(ghist, cbin[gmoving], cmag[gmoving])
    gsum = ghist.sum()
    if gsum > 0:
        ghist /= gsum
    gstats = np.array([cmag.mean(), cmag.std()], np.float32)

    return np.concatenate([hist.ravel(), per_joint, ghist, gstats]
                          ).astype(np.float32)


def descriptor_size(cfg: HistogramConfig, n_joints: int = N_JOINTS) -> int:
    return (cfg.grid * cfg.grid * cfg.orientations + n_joints
            + cfg.orientations + 2)


def scene_flow(prev_gray: np.ndarray, cur_gray: np.ndarray,
               prev_depth: np.ndarray, cur_depth: np.ndarray,
               *, block: int = 16, search: int = 4):
    """Coarse RGB-D scene flow: per-block integer 2D motion (SAD block
    matching) + depth change — (u, v, dz) on a (H//block, W//block)
    grid.

    The reference declares SceneFlow(Color_Prev, Color_Curr, Depth_Prev,
    Depth_Curr, ...) but ships it as an EMPTY stub
    (Process_Kinect.cpp:3876-3879); this is a working implementation of
    the declared intent, dependency-free.
    """
    h = (prev_gray.shape[0] // block) * block
    w = (prev_gray.shape[1] // block) * block
    pg = prev_gray[:h, :w].astype(np.float32)
    cg = cur_gray[:h, :w].astype(np.float32)
    bh, bw = h // block, w // block

    def blocks(a):
        return a.reshape(bh, block, bw, block).transpose(0, 2, 1, 3)

    pb = blocks(pg)                                # (bh, bw, B, B)
    best = np.full((bh, bw), np.inf, np.float32)
    u = np.zeros((bh, bw), np.float32)
    v = np.zeros((bh, bw), np.float32)
    for dy in range(-search, search + 1):
        for dx in range(-search, search + 1):
            shifted = np.roll(cg, (-dy, -dx), axis=(0, 1))
            sad = np.abs(blocks(shifted) - pb).mean(axis=(2, 3))
            better = sad < best
            best = np.where(better, sad, best)
            u = np.where(better, dx, u)
            v = np.where(better, dy, v)

    pd = prev_depth[:h, :w].astype(np.float32)
    cd = cur_depth[:h, :w].astype(np.float32)
    valid = (pd > 0) & (cd > 0)
    dz_full = np.where(valid, cd - pd, 0.0)
    dz = blocks(dz_full).mean(axis=(2, 3))
    return u, v, dz


def scene_flow_features(prev_rgb: np.ndarray, cur_rgb: np.ndarray,
                        prev_depth: np.ndarray, cur_depth: np.ndarray,
                        *, orientations: int = 8, block: int = 16,
                        search: int = 4) -> np.ndarray:
    """Fixed-length scene-flow descriptor (orientations + 3): motion
    direction histogram weighted by magnitude, plus [moving fraction,
    mean dz, std dz] — appended to the action histogram vector."""
    pg = prev_rgb.mean(axis=2) if prev_rgb.ndim == 3 else prev_rgb
    cg = cur_rgb.mean(axis=2) if cur_rgb.ndim == 3 else cur_rgb
    u, v, dz = scene_flow(pg, cg, prev_depth, cur_depth,
                          block=block, search=search)
    mag = np.sqrt(u * u + v * v)
    ang = np.arctan2(v, u)
    obin = ((ang + np.pi) / (2 * np.pi) * orientations
            ).astype(int) % orientations
    hist = np.zeros(orientations, np.float32)
    moving = mag > 0
    np.add.at(hist, obin[moving], mag[moving])
    s = hist.sum()
    if s > 0:
        hist /= s
    stats = np.array([float(moving.mean()), float(dz.mean()),
                      float(dz.std())], np.float32)
    return np.concatenate([hist, stats]).astype(np.float32)


SCENE_FLOW_DIM = 8 + 3


def body_part_stats(label_map: np.ndarray, body_mask: np.ndarray,
                    n_parts: int = 32):
    """Per-pixel body-part label aggregation: for each part id, the
    foreground pixel count and centroid (row, col).

    The reference's PixeltoBodyPartLabel (Process_Kinect.cpp:955-979)
    iterates the body's foreground pixels and reads the label value
    into a local — the loop body is otherwise EMPTY; this computes the
    aggregation that read was evidently for. label_map: (H, W) int
    part ids; body_mask: (H, W) bool foreground."""
    lab = np.where(body_mask, label_map, -1).ravel()
    valid = lab >= 0
    idx = np.flatnonzero(valid)
    l = lab[idx].astype(np.int64)
    counts = np.bincount(l, minlength=n_parts)[:n_parts]
    h, w = label_map.shape
    rows = idx // w
    cols = idx % w
    rsum = np.bincount(l, weights=rows, minlength=n_parts)[:n_parts]
    csum = np.bincount(l, weights=cols, minlength=n_parts)[:n_parts]
    denom = np.maximum(counts, 1)
    centroids = np.stack([rsum / denom, csum / denom], axis=1)
    centroids[counts == 0] = -1.0
    return counts.astype(np.int64), centroids.astype(np.float32)


def clip_features(joints: np.ndarray, rgbd_clip=None,
                  cfg: HistogramConfig = HistogramConfig()) -> np.ndarray:
    """Full clip descriptor: skeleton motion histograms plus (when an
    RGB-D clip is provided) the mean scene-flow descriptor over
    consecutive frame pairs."""
    feat = motion_histograms(joints, cfg)
    if rgbd_clip is not None and len(rgbd_clip) >= 2:
        sf = np.mean([
            scene_flow_features(rgbd_clip[i][0], rgbd_clip[i + 1][0],
                                rgbd_clip[i][1], rgbd_clip[i + 1][1])
            for i in range(len(rgbd_clip) - 1)], axis=0)
        feat = np.concatenate([feat, sf.astype(np.float32)])
    return feat


class ELM:
    """Extreme learning machine: random hidden layer + ridge solve."""

    def __init__(self, hidden: int = 256, reg: float = 1e-3,
                 seed: int = 0):
        self.hidden = hidden
        self.reg = reg
        self.seed = seed
        self.in_w: np.ndarray | None = None
        self.bias: np.ndarray | None = None
        self.out_w: np.ndarray | None = None

    def _hidden(self, x: np.ndarray) -> np.ndarray:
        z = x @ self.in_w + self.bias
        return 1.0 / (1.0 + np.exp(-z))           # logistic hidden units

    def fit(self, x: np.ndarray, labels: np.ndarray, n_classes: int):
        rng = np.random.default_rng(self.seed)
        d = x.shape[1]
        self.in_w = rng.uniform(-1, 1, (d, self.hidden)).astype(np.float32)
        self.bias = rng.uniform(-1, 1, self.hidden).astype(np.float32)
        h = self._hidden(x)
        y = np.zeros((len(labels), n_classes), np.float32)
        y[np.arange(len(labels)), labels] = 1.0
        a = h.T @ h + self.reg * np.eye(self.hidden, dtype=np.float32)
        self.out_w = np.linalg.solve(a, h.T @ y)
        return self

    def predict_scores(self, x: np.ndarray) -> np.ndarray:
        return self._hidden(np.atleast_2d(x)) @ self.out_w

    def predict(self, x: np.ndarray) -> np.ndarray:
        return self.predict_scores(x).argmax(axis=1)

    def save(self, path: str):
        np.savez(path, in_w=self.in_w, bias=self.bias, out_w=self.out_w)

    @classmethod
    def load(cls, path: str) -> "ELM":
        z = np.load(path)
        m = cls(hidden=z["in_w"].shape[1])
        m.in_w, m.bias, m.out_w = z["in_w"], z["bias"], z["out_w"]
        return m


class ActionRecognizer:
    """Clip-level recognizer: buffer joint frames, classify on flush
    (the reference classifies when the skeleton leaves / clip ends,
    Process_Kinect.cpp:800-835)."""

    def __init__(self, model: ELM, labels: list[str],
                 cfg: HistogramConfig = HistogramConfig(),
                 min_frames: int = 8, use_scene_flow: bool = False):
        self.model = model
        self.labels = labels
        self.cfg = cfg
        self.min_frames = min_frames
        self.use_scene_flow = use_scene_flow
        self.buffer: list[np.ndarray] = []
        self.rgbd_buffer: list[tuple] = []

    def push(self, joints: np.ndarray, rgb=None, depth=None):
        self.buffer.append(np.asarray(joints, np.float32))
        if self.use_scene_flow and rgb is not None and depth is not None:
            self.rgbd_buffer.append((np.asarray(rgb), np.asarray(depth)))

    def flush(self):
        """Classify the buffered clip; returns (label, score) or None."""
        if len(self.buffer) < self.min_frames:
            self.buffer.clear()
            self.rgbd_buffer.clear()
            return None
        clip = np.stack(self.buffer)
        rgbd = self.rgbd_buffer if (self.use_scene_flow
                                    and len(self.rgbd_buffer) >= 2) else None
        self.buffer = []
        self.rgbd_buffer = []
        feat = clip_features(clip, rgbd, self.cfg)
        scores = self.model.predict_scores(feat[None])[0]
        idx = int(scores.argmax())
        return self.labels[idx], float(scores[idx])


__all__ = ["motion_histograms", "descriptor_size", "HistogramConfig",
           "scene_flow", "scene_flow_features", "clip_features",
           "SCENE_FLOW_DIM", "body_part_stats", "ELM",
           "ActionRecognizer", "N_JOINTS"]
