"""nightmare: deep-dream gradient ascent on layer activations.

Counterpart of ``sr_object_detection_tpu/apps/nightmare_app.py``
(run_nightmare, src_yolo2/nightmare.c:228-308): repeatedly maximize
||layer activations||^2 with respect to the input image at several
octaves. The reference hand-rolls the backward pass per octave
(optimize_picture:60-100); here it is ``torch.autograd.grad`` to the
input through ``Network.forward``, on ``device`` (CUDA unless the CLI's
-cpu), in float32. ``_save_ppm`` is the JAX module's, copied as it is;
``detect -out`` and the streaming demo's ``-outdir`` use it too.

CLI: nightmare <cfg> <weights> <image> <layer>
     [-rounds n] [-iters n] [-octaves o] [-rate lr] [-out dir] [-cpu]
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..graph.compiler import Network
from ..graph.spec import parse_network_cfg
from ..io.convert import params_to_torch
from ..io.weights import load_weights
from ..ops.image import resize_image, load_image_rgb
from .cli import find_value


def make_dream_step(spec, layer_index: int):
    """grad(params, x) -> d(0.5 * ||layer_index's output||^2)/dx for the
    port's torch ``params`` and an NHWC float32 ``x``; every layer's
    output is kept, as the JAX step's ``keep_all=True`` keeps it."""
    nets: dict = {}

    def grad(params, x):
        if id(params) not in nets:
            nets.clear()
            nets[id(params)] = Network(spec, params)
        x = x.detach().requires_grad_(True)
        _, aux = nets[id(params)](x, keep_all=True)
        act = aux["outputs"][layer_index]
        return torch.autograd.grad(0.5 * act.square().sum(), x)[0]

    return grad


def nightmare(cfg: str, weights: str, image_path: str, layer: int, *,
              rounds: int = 1, iters: int = 10, octaves: int = 4,
              rate: float = 0.05, out_dir: str = ".",
              device="cuda") -> np.ndarray:
    """Normalized gradient ascent on the image, largest octave last;
    writes ``<image>_nightmare_l<layer>_r<round>.ppm`` a round and returns
    the last round's image."""
    device = torch.device(device)
    if device.type == "cuda":
        from ..infer.detector import disable_tf32
        disable_tf32()
    spec = parse_network_cfg(cfg)
    params, _ = load_weights(spec, weights)
    params = params_to_torch(spec, params, device)

    im = load_image_rgb(image_path)
    base_h = spec.net.h
    base_w = spec.net.w

    out = None
    for r in range(rounds):
        for octave in range(octaves, 0, -1):
            scale = 1.0 / (1.3 ** (octave - 1))
            w = max(int(base_w * scale) // 2 * 2, 32)
            h = max(int(base_h * scale) // 2 * 2, 32)
            oct_spec = spec.resize(w, h)
            grad = make_dream_step(oct_spec, layer)
            x = resize_image(torch.from_numpy(im).to(device), w, h)[None]
            for it in range(iters):
                g = grad(params, x)
                gn = g.abs().mean() + 1e-8
                x = x + rate * g / gn          # normalized ascent
                x = x.clamp(0.0, 1.0)
            im = resize_image(x[0].detach(), im.shape[1],
                              im.shape[0]).cpu().numpy()
            im = np.clip(im, 0, 1)
        out = im
        base = os.path.splitext(os.path.basename(image_path))[0]
        _save_ppm(os.path.join(
            out_dir, f"{base}_nightmare_l{layer}_r{r}.ppm"), out)
    return out


def _save_ppm(path: str, im: np.ndarray):
    with open(path, "wb") as f:
        h, w = im.shape[:2]
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write((np.clip(im, 0, 1) * 255).astype(np.uint8).tobytes())


def run_nightmare(argv, *, device="cuda"):
    cfg, weights, image, layer = argv[0], argv[1], argv[2], int(argv[3])
    rounds = find_value(argv, "-rounds", 1, int)
    iters = find_value(argv, "-iters", 10, int)
    octaves = find_value(argv, "-octaves", 4, int)
    rate = find_value(argv, "-rate", 0.05, float)
    out_dir = find_value(argv, "-out", ".", str)
    return nightmare(cfg, weights, image, layer, rounds=rounds, iters=iters,
                     octaves=octaves, rate=rate, out_dir=out_dir,
                     device=device)


__all__ = ["nightmare", "run_nightmare", "make_dream_step", "_save_ppm"]
