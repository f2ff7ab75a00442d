"""Batch-1 latency engine.

Counterpart of ``fold_params_for_inference`` and ``LatencyEngine`` in
``sr_object_detection_tpu/infer/engine.py``: the robot loop's bf16 engine
(KinectUtil::detection -> test_detector_img, src_yolo2/KinectUtil.cpp:
379-487). One call runs u8 frame -> normalize (+ resize) -> forward ->
region decode -> top-k candidates, all on the engine's device; only the
64 candidates' boxes and probs are meant to leave it.

The engine always folds BN and runs bf16 (the JAX engine's defaults, the
only values its callers use). With ``fused_stem=True`` the leading
conv+pool pairs run through the batch-1 stem kernel
(``kernels/b1_stem.py``): on CUDA that is the hand-written kernel or an
exception, never a silent fallback. A spec with no eligible pairs runs
plain and says so through ``fused_stem=False``.
The tail convs run through ``F.conv2d`` in bf16 — the TPU-only 9-tap
matmul formulation of the JAX engine (``conv2d_b1_tap_matmul``) is not
ported. ThroughputEngine, best_latency_engine and int8 serving come with
ROADMAP queue 1, items 5 and 6.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..graph import spec as S
from ..graph.compiler import Network
from ..io.convert import params_to_torch
from ..kernels import _build
from ..kernels import b1_stem as BS
from ..ops import boxes as B
from ..ops import conv as C
from ..ops import image as I


def fold_params_for_inference(spec: S.NetworkSpec, params,
                              dtype=torch.bfloat16):
    """Fold BN into conv weights/biases in float32, then cast to
    ``dtype``. ``params``: the port's tensors (``io.convert``), float32.

    Returns (folded_params, folded_spec); folded conv layers carry
    batch_normalize=False."""
    new_params, new_layers = [], []
    for l, p in zip(spec.layers, params):
        if isinstance(l, S.ConvSpec) and l.batch_normalize and p:
            p = C.fold_batchnorm({k: v.float() for k, v in p.items()})
            l = dataclasses.replace(l, batch_normalize=False)
        new_params.append({k: v.to(dtype) for k, v in p.items()})
        new_layers.append(l)
    folded = S.NetworkSpec(net=spec.net, layers=tuple(new_layers),
                           cfg_path=spec.cfg_path)
    return new_params, folded


class LatencyEngine:
    """Batch-1 low-latency path with on-device preprocessing, bf16 with
    BN folded.

    ``params``: numpy params in the JAX package's layout (HWIO), as
    ``io.weights.load_weights`` / ``init_params`` return them."""

    TOPK = 64
    DTYPE = torch.bfloat16

    def __init__(self, spec: S.NetworkSpec, params, *, device,
                 frame_hw: Optional[tuple[int, int]] = None,
                 int8_calib=None, fused_stem: bool = False):
        if int8_calib is not None:
            raise NotImplementedError(
                "int8 serving is not ported yet (ROADMAP queue 1, item 6)")
        region = spec.layers[-1]
        if not isinstance(region, S.RegionSpec):
            raise ValueError("LatencyEngine requires a [region] final layer")
        self.region = region
        self.device = torch.device(device)
        self.params, self.spec = fold_params_for_inference(
            spec, params_to_torch(spec, params, self.device), self.DTYPE)
        self._stem, n = None, 0
        if fused_stem:
            self._stem, n = BS.build_stem(self.spec, self.params)
            if self._stem is not None and self.device.type == "cuda":
                _build.load()            # build now: fail at construction
        self.fused_stem = self._stem is not None
        tail = self.spec if n == 0 else BS.truncate_spec(self.spec, n)
        self._net = Network(tail, self.params[n:], compute_dtype=self.DTYPE)

        net = spec.net
        self.net_hw = (net.h, net.w)
        self.frame_hw = frame_hw
        h, w = frame_hw if frame_hw else (net.h, net.w)
        self.frame_shape = (h, w, net.c)
        self._anchors = torch.tensor(
            np.asarray(region.anchors, np.float32).reshape(region.n, 2),
            device=self.device)

    def forward(self, x):
        """Raw network forward on a preprocessed NHWC batch-1 input (the
        counterpart of the JAX engine's ``_fwd``). Returns (out, aux)."""
        if self._stem is not None:
            x = self._stem(x)
        return self._net(x.to(self.DTYPE))

    @torch.no_grad()
    def __call__(self, frame_u8):
        """One HWC uint8 frame -> (boxes (64, 4), probs (64, classes))
        float32 on the engine's device."""
        frame = torch.as_tensor(frame_u8)
        if frame.ndim != 3:
            raise ValueError(
                f"LatencyEngine expects one unbatched HWC frame "
                f"{self.frame_shape}, got shape {tuple(frame.shape)}")
        x = frame.to(self.device).float() / 255.0
        if self.frame_hw is not None and self.frame_hw != self.net_hw:
            x = I.resize_image(x, self.net_hw[1], self.net_hw[0])
        out, _ = self.forward(x[None].to(self.DTYPE))
        r = self.region
        acts = out.reshape(1, r.h, r.w, r.n, r.coords + r.classes + 1).float()
        boxes = B.decode_region_boxes(acts, self._anchors, img_w=1.0,
                                      img_h=1.0).reshape(-1, 4)
        probs = (acts[..., 4:5] * acts[..., 5:]).reshape(-1, r.classes)
        # compact on device: top-k candidates by best class prob (ties:
        # lower index first, as lax.top_k orders them)
        best = probs.max(dim=-1).values
        idx = torch.sort(best, descending=True, stable=True).indices
        idx = idx[:min(self.TOPK, best.shape[0])]
        return boxes[idx], probs[idx]


__all__ = ["LatencyEngine", "fold_params_for_inference"]
