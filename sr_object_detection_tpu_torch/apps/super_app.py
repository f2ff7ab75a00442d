"""super: single-image super-resolution (src_yolo2/super.c:1-131).

Counterpart of ``sr_object_detection_tpu/apps/super_app.py``:

  super [test] <cfg> <weights> <image> [-out path] [-cpu]

The reference's super-resolution net ends in a deconvolutional layer;
the network is resized to the image, the image forwarded on ``device``
(CUDA unless the CLI's -cpu) in float32 and the upscaled output saved.
``super train`` (train_super, super.c:10) is ``apps/misc_train.py``'s.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..graph.compiler import Network
from ..graph.spec import parse_network_cfg
from ..io.convert import params_to_torch
from ..io.weights import load_weights
from ..ops.image import load_image_rgb
from .cli import find_value


def super_resolve(cfg: str, weights: str, image_path: str, *,
                  device="cuda") -> np.ndarray:
    device = torch.device(device)
    if device.type == "cuda":
        from ..infer.detector import disable_tf32
        disable_tf32()
    spec = parse_network_cfg(cfg)
    im = load_image_rgb(image_path)
    # the network at the image's own resolution (super.c resizes the net
    # to the input: resize_network(&net, im.w, im.h))
    spec = spec.resize(im.shape[1], im.shape[0])
    params, _ = load_weights(spec, weights)
    net = Network(spec, params_to_torch(spec, params, device))
    with torch.no_grad():
        out, _ = net(torch.from_numpy(im).to(device)[None])
    return np.clip(out[0].cpu().numpy(), 0, 1)


def run_super(argv, *, device="cuda"):
    cfg, weights, image = argv[0], argv[1], argv[2]
    out_path = find_value(argv, "-out", None) or (
        os.path.splitext(image)[0] + "_super.ppm")
    out = super_resolve(cfg, weights, image, device=device)
    from .nightmare_app import _save_ppm
    _save_ppm(out_path, out)
    print(f"wrote {out_path} ({out.shape[1]}x{out.shape[0]})")
    return out


__all__ = ["super_resolve", "run_super"]
