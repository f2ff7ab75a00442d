"""int8 quantized serving path (post-training quantization).

Counterpart of ``sr_object_detection_tpu/infer/quant.py``. Scheme
(standard symmetric PTQ), as there:

  * weights: per-output-channel symmetric int8, scale = amax/127,
    quantized once at load from the BN-folded float32 weights — in numpy,
    with the JAX module's exact expressions, so weights and scales are
    bit-identical to it;
  * activations: per-layer symmetric int8 with scales calibrated by one
    float32 forward over sample images (amax observer);
  * convs run int8 x int8 -> int32 (``ops.conv.conv2d_i8``); the dequant
    + bias + activation + requant epilogue runs in float32 in the JAX
    module's op order (``acc * dequant``, ``+ bias``, activation,
    ``round(v * inv)`` half to even, clamp to +-127);
  * maxpool operates directly on int8 (``ops.pooling.maxpool_i8``);
  * the head conv (the one feeding [region]) stays bf16 on dequantized
    input, unless ``quantize_head``.

With ``phase_stem=True`` the leading conv3x3+pool2x2 pairs run through
the int8 stem kernel (``kernels/phase_stem.py``), bit-exact to the chain
above, at batch 128 only — the JAX rule (its kernel's lanes are the
batch), kept though the CUDA kernel needs no particular batch.

Route and reorg run on the int8 codes as in the JAX module: reorg keeps
its input's scale, and a route takes the largest of its sources' scales
and requantizes each source whose scale differs.

The region decode runs the compiler's ``RegionLayer`` on the head's
float output: a WordTree head's grouped softmax (its group ids built
once on the device) and, with ``presplit``, the aligned head's (fields,
cls) pair (``infer.engine.align_region_head``; ``"flat"`` keeps the
class tensor in the head conv's layout).

A spec the int8 dataflow covers only in part (a classifier: darknet19's
avgpool + softmax + cost) runs its int8 trunk up to the first layer it
does not cover and the rest as a float tail, a ``graph.compiler.Network``
over the re-indexed layers in ``HEAD_DTYPE``; the last trunk conv, which
feeds the tail, stays in ``HEAD_DTYPE`` like a head conv, so the logits
take no int8 step. A route in the tail, or a shortcut from the trunk
into it, raises ``NotImplementedError``, as in the JAX module.

Activations are NHWC throughout, like the JAX module. Not ported yet: a
``mesh`` (ROADMAP queue 1, item 11), which raises
``NotImplementedError`` naming its item.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import numpy as np
import torch

from ..graph import spec as S
from ..graph.compiler import Network, RegionLayer, live_set, resolve_trees
from ..io.convert import params_to_torch
from ..kernels import _build
from ..kernels import phase_stem as PS
from ..kernels.phase_stem import requant as _requant
from ..ops import activations as A
from ..ops import conv as C
from ..ops import layout as L
from ..ops import pooling as P
from .engine import align_region_head, checksum_benchmark, \
    fold_params_for_inference, presplit_spec, sync_checksum

I8MIN, I8MAX = -127, 127     # symmetric: keep -128 out so |q| <= 127
HEAD_DTYPE = torch.bfloat16  # the float head conv's dtype


def load_calib(path: str) -> np.ndarray:
    """Load a saved calibration batch (.npy, or .npz under key 'calib'
    / the sole array): preprocessed NHWC f32 frames. Pair with
    ``save_calib`` — calibrate once on representative traffic, reuse
    across restarts instead of the first-frame / noise fallbacks."""
    if path.endswith(".npz"):
        z = np.load(path)
        key = "calib" if "calib" in z.files else z.files[0]
        arr = z[key]
    else:
        arr = np.load(path)
    arr = np.asarray(arr, np.float32)
    if arr.ndim == 3:
        arr = arr[None]
    if arr.ndim != 4:
        raise ValueError(f"calibration file {path}: expected NHWC or "
                         f"HWC array, got shape {arr.shape}")
    return arr


def save_calib(path: str, calib_x) -> None:
    """Persist a calibration batch for :func:`load_calib`."""
    if path.endswith(".npz"):
        np.savez_compressed(path, calib=np.asarray(calib_x, np.float32))
    else:
        np.save(path, np.asarray(calib_x, np.float32))


def _resolve_calib(calib_x):
    return load_calib(calib_x) if isinstance(calib_x, str) else calib_x


def _head_conv_indices(spec: S.NetworkSpec) -> set[int]:
    """Convs feeding a [region]/[detection] head directly (the darknet
    head pattern) — kept in bf16."""
    heads = set()
    for i, l in enumerate(spec.layers):
        if isinstance(l, (S.RegionSpec, S.DetectionSpec)) and i > 0:
            if isinstance(spec.layers[i - 1], S.ConvSpec):
                heads.add(i - 1)
    return heads


_SUPPORTED = (S.ConvSpec, S.MaxPoolSpec, S.RouteSpec, S.ReorgSpec,
              S.RegionSpec)


def _supported_prefix(layers) -> int:
    """Longest prefix of the layer list the int8 dataflow covers (the
    JAX module runs the remainder, e.g. darknet19's avgpool + softmax,
    as a float tail)."""
    t = 0
    for l in layers:
        if not isinstance(l, _SUPPORTED):
            break
        if isinstance(l, S.ConvSpec) and getattr(l, "xnor", False):
            break
        if isinstance(l, S.RouteSpec) and l.out_c <= 0:
            break
        t += 1
    return t


@torch.no_grad()
def calibrate_amax(spec: S.NetworkSpec, params_f32, calib_x, *,
                   device) -> tuple[float, dict[int, float]]:
    """One float32 forward over calibration images on ``device``;
    returns (input_amax, {layer_index: output_amax}); a pre-split
    region's amax is that of both its tensors. ``params_f32``: the
    port's float32 tensors (OIHW, BN folded). On CUDA it switches TF32
    off first, as the float32 Detector does."""
    if torch.device(device).type == "cuda":
        from .detector import disable_tf32
        disable_tf32()
    net = Network(spec, [{k: v.to(device) for k, v in p.items()}
                         for p in params_f32])
    x = torch.as_tensor(np.asarray(calib_x, np.float32)).to(device)
    _, aux = net(x, keep_all=True)

    def amax_of(t):
        if isinstance(t, tuple):
            return max(amax_of(p) for p in t)
        return float(t.float().abs().max())
    amax = {i: amax_of(t) for i, t in aux["outputs"].items()}
    return float(np.max(np.abs(np.asarray(calib_x)))), amax


class QuantizedNetwork:
    """BN-folded, int8-quantized inference program for a detection spec.

    Build with :func:`quantize_for_inference`; ``forward(x)`` maps an NHWC
    batch (float32 [0,1] or uint8 frames) to the flat region output
    (float32), the layout of the bf16 engines. ``qparams`` hold the JAX
    module's layout: HWIO int8 weights, float32 dequant and biases (bf16
    HWIO weights for a float head)."""

    def __init__(self, spec: S.NetworkSpec, qparams, forward,
                 act_scales: dict[int, float], in_scale: float):
        self.spec = spec
        self.qparams = qparams
        self.forward = forward
        self.act_scales = act_scales
        self.in_scale = in_scale        # int8 scale of the input frame


def quantize_for_inference(spec: S.NetworkSpec, params, calib_x, *,
                           device, presplit=False,
                           quantize_head: bool = False,
                           region_dtype=None,
                           phase_stem: bool = False) -> QuantizedNetwork:
    """Fold BN, calibrate activation scales on ``calib_x`` (float32 NHWC
    sample batch, or a path saved with :func:`save_calib`), quantize
    weights per channel, and build the int8 forward on ``device``.

    ``params``: numpy params in the JAX package's layout (HWIO), as
    ``io.weights.load_weights`` / ``init_params`` return them.
    ``quantize_head`` runs the head conv in int8 too (float32 dequant
    epilogue, no requant of the logits); ``region_dtype`` sets the dtype
    of the region decode (default float32); ``phase_stem`` owns the
    leading conv+pool pairs with the stem kernel (batch 128 only) and
    raises ``NotImplementedError`` if the spec has none. ``presplit``
    (True or ``"flat"``) aligns the region head and returns its (fields,
    cls) pair, as ``ThroughputEngine(presplit=...)`` does."""
    device = torch.device(device)
    calib_x = _resolve_calib(calib_x)
    params_f, fspec = fold_params_for_inference(
        spec, params_to_torch(spec, params, "cpu"), torch.float32)
    if presplit:
        fspec, params_f = align_region_head(fspec, params_f, min_classes=1)
        fspec = presplit_spec(fspec, presplit)
    split = _supported_prefix(fspec.layers)
    if split < 2:
        raise NotImplementedError(
            "no int8-quantizable prefix (first layers unsupported); "
            "use the bf16 ThroughputEngine")
    for l in fspec.layers[split:]:
        if isinstance(l, S.RouteSpec):
            raise NotImplementedError("route in the float tail")
        if isinstance(l, S.ShortcutSpec) and l.from_index < split:
            raise NotImplementedError("shortcut crossing the int8 trunk")
    if split == len(fspec.layers) \
            and isinstance(fspec.layers[-1], S.RegionSpec) \
            and not isinstance(fspec.layers[-2], S.ConvSpec):
        # a region inside the float tail is fine: the tail runs in float
        raise NotImplementedError(
            "int8 path: [region] must be fed by a conv layer")

    in_amax, amax = calibrate_amax(fspec, params_f, calib_x, device=device)
    # darknet inputs are [0,1] images; floor the input amax at 1.0 so a
    # full-brightness uint8 frame never saturates the input requant
    in_amax = max(in_amax, 1.0)
    heads = _head_conv_indices(fspec)
    if split < len(fspec.layers) and isinstance(fspec.layers[split - 1],
                                                S.ConvSpec):
        # the last trunk conv feeds the float tail (darknet19's 1000-class
        # 1x1 conv before avgpool + softmax): kept in HEAD_DTYPE so that
        # the logits take no int8 step
        heads.add(split - 1)
    tail = None
    if split < len(fspec.layers):
        # the float tail: the remaining layers re-indexed from 0 (a
        # shortcut inside it shifted with them), in HEAD_DTYPE
        tail_spec = S.NetworkSpec(
            net=fspec.net, layers=tuple(
                dataclasses.replace(l, from_index=l.from_index - split)
                if isinstance(l, S.ShortcutSpec) else l
                for l in fspec.layers[split:]), cfg_path=fspec.cfg_path)
        tail = Network(tail_spec, [
            {k: v.to(device, HEAD_DTYPE) for k, v in p.items()}
            for p in params_f[split:]], compute_dtype=HEAD_DTYPE)

    # ---- static per-layer scale propagation and parameter quantization
    # (numpy, the JAX module's expressions) ----------------------------
    def scale_of(amax_v: float) -> float:
        return max(amax_v, 1e-8) / I8MAX

    def dev(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device, dtype)

    layers = fspec.layers[:split]
    s_out: dict[int, float] = {}       # int8 scale of each layer output
    qparams: list[dict[str, Any]] = []
    in_scale = scale_of(in_amax)

    def in_scale_of(i: int) -> float:
        return in_scale if i == 0 else s_out[i - 1]

    for i, l in enumerate(layers):
        p: dict[str, Any] = {}
        if isinstance(l, S.ConvSpec):
            # HWIO float32, from the port's folded OIHW tensors
            w = params_f[i]["weights"].permute(2, 3, 1, 0).numpy()
            b = params_f[i]["biases"].numpy()
            if i in heads and not quantize_head:
                p = {"weights": dev(w.astype(np.float32), HEAD_DTYPE),
                     "biases": dev(b.astype(np.float32))}
                s_out[i] = -1.0        # float-domain output
            else:
                w_s = np.maximum(np.abs(w).reshape(-1, w.shape[3]).max(0),
                                 1e-8) / I8MAX           # per-out-channel
                w_q = np.clip(np.round(w / w_s), I8MIN, I8MAX).astype(
                    np.int8)
                s_x = in_scale_of(i)
                p = {"weights": dev(w_q),
                     # int32 -> f32 dequant constant, folds s_x * s_w
                     "dequant": dev(np.asarray(s_x * w_s, np.float32)),
                     "biases": dev(np.asarray(b, np.float32))}
                s_out[i] = -1.0 if i in heads else scale_of(amax[i])
        elif isinstance(l, (S.MaxPoolSpec, S.ReorgSpec)):
            s_out[i] = in_scale_of(i)   # scale-preserving
        elif isinstance(l, S.RouteSpec):
            srcs = [s_out[j] for j in l.layers]
            if any(s < 0 for s in srcs):
                raise NotImplementedError("route from a head conv")
            s_out[i] = max(srcs)
        elif isinstance(l, S.RegionSpec):
            s_out[i] = -1.0
        qparams.append(p)

    act_scales = dict(s_out)

    stem_fn, n_stem = None, 0
    if phase_stem:
        stem_fn, n_stem = PS.build_phase_stem(fspec, qparams, s_out,
                                              in_scale)
        if stem_fn is None:
            raise NotImplementedError(
                "phase_stem: no eligible conv3x3+pool2x2 stem pairs "
                "in this spec")
        if device.type == "cuda":
            _build.load()               # build now: fail at construction

    # ---- forward --------------------------------------------------------
    rdt = region_dtype if region_dtype is not None else torch.float32
    # float heads run F.conv2d, which wants OIHW
    head_w = {i: qparams[i]["weights"].permute(3, 2, 0, 1).contiguous()
              for i in heads if "dequant" not in qparams[i]}
    live = live_set(fspec)             # outputs a route reads later
    # the region decode, its tree's group ids built once on the device
    trees = resolve_trees(fspec)
    regions = {i: RegionLayer(l, trees.get(i), device)
               for i, l in enumerate(layers) if isinstance(l, S.RegionSpec)}

    @torch.no_grad()
    def forward(x, stop=None):
        """x: NHWC batch on the device. ``stop``: return the activation
        after layer ``stop - 1`` of the int8 trunk instead (int8 inside
        it, before the float tail)."""
        if stop is not None and stop < n_stem:
            raise ValueError(f"stop={stop} falls inside the fused stem "
                             f"(layers 0..{n_stem - 1})")
        if stop is not None and stop > split:
            raise ValueError(f"stop={stop} falls inside the float tail "
                             f"(layers {split}..)")
        x = torch.as_tensor(x).to(device)
        if x.dtype not in (torch.uint8, torch.float32):
            x = x.float()
        start, saved = 0, {}
        if stem_fn is not None and x.shape[0] == 128:
            # requant + pairs [0, n_stem); plan_pairs keeps every route
            # source past the stem
            cur = stem_fn(x)
            start = n_stem
        elif x.dtype == torch.uint8:
            # raw camera frames: the /255 folds into the input requant
            cur = _requant(x.float(),
                           float(np.float32(1.0 / (255.0 * in_scale))))
        else:
            cur = _requant(x, float(np.float32(1.0 / in_scale)))
        for i in range(start, len(layers) if stop is None else stop):
            l, qp = layers[i], qparams[i]
            if isinstance(l, S.ConvSpec):
                act = A.get_activation(l.activation)
                if i in heads and "dequant" in qp:
                    # int8 head: float32 logits, no requant
                    y = C.conv2d_i8(cur, qp["weights"], stride=l.stride,
                                    pad=l.pad)
                    cur = act(y.float() * qp["dequant"] + qp["biases"])
                elif i in heads:
                    xf = (cur.to(HEAD_DTYPE)
                          * torch.tensor(in_scale_of(i), dtype=HEAD_DTYPE,
                                         device=device))
                    y = C.conv2d(xf.permute(0, 3, 1, 2), head_w[i],
                                 stride=l.stride, pad=l.pad,
                                 compute_dtype=HEAD_DTYPE)
                    cur = act(y.permute(0, 2, 3, 1) + qp["biases"])
                else:
                    y = C.conv2d_i8(cur, qp["weights"], stride=l.stride,
                                    pad=l.pad)
                    y = act(y.float() * qp["dequant"] + qp["biases"])
                    cur = _requant(y, float(np.float32(1.0 / s_out[i])))
            elif isinstance(l, S.MaxPoolSpec):
                cur = P.maxpool_i8(cur, size=l.size, stride=l.stride,
                                   pad=l.pad)
            elif isinstance(l, S.ReorgSpec):
                cur = (L.reorg_reverse_darknet(cur, stride=l.stride)
                       if l.reverse else
                       L.reorg_darknet(cur, stride=l.stride))
            elif isinstance(l, S.RouteSpec):
                parts = []
                for j in l.layers:
                    t = saved[j]
                    if s_out[j] != s_out[i]:
                        # to the route's (largest) scale in the int8
                        # domain, the JAX module's expression
                        r = np.float32(s_out[j] / s_out[i])
                        t = _requant(t.float() * float(r), 1.0)
                    parts.append(t)
                cur = L.route(parts)
            elif isinstance(l, S.RegionSpec):
                cur = regions[i].activate(cur.to(rdt))
            if i in live:
                saved[i] = cur
        if stop is not None:
            return cur
        if tail is not None:
            if cur.dtype == torch.int8:     # the trunk ended on int8
                cur = cur.to(HEAD_DTYPE) * torch.tensor(
                    s_out[split - 1], dtype=HEAD_DTYPE, device=device)
            return tail(cur)[0]
        if not isinstance(cur, tuple) and cur.dtype == torch.int8:
            # a net ending on a non-head int8 layer: dequantize so the
            # contract — float outputs — holds
            cur = cur.float() * float(np.float32(s_out[split - 1]))
        return cur

    return QuantizedNetwork(fspec, qparams, forward, act_scales, in_scale)


class QuantizedForwardShim:
    """Drop-in replacement for the ``net`` attribute of ``Detector`` and
    ``Classifier``: the same ``shim(x) -> (out, aux)`` call, running the
    int8 program."""

    def __init__(self, spec: S.NetworkSpec, params, calib_x, *, device,
                 quantize_head: bool = False, region_dtype=None):
        self.qnet = quantize_for_inference(
            spec, params, _resolve_calib(calib_x), device=device,
            quantize_head=quantize_head, region_dtype=region_dtype)

    def __call__(self, x):
        return self.qnet.forward(x), None


class QuantizedThroughputEngine:
    """Batched int8 serving engine; same interface and benchmark protocol
    as ``infer.engine.ThroughputEngine`` (checksum readback)."""

    def __init__(self, spec: S.NetworkSpec, params, *, device,
                 batch: int = 128, calib_x=None, presplit=False,
                 quantize_head: bool = False, region_dtype=None,
                 mesh=None, phase_stem: bool = False):
        if mesh is not None:
            raise NotImplementedError(
                "sharded int8 serving is not ported yet (ROADMAP queue 1, "
                "item 11)")
        self.batch = batch
        self.device = torch.device(device)
        calib_x = _resolve_calib(calib_x)   # str -> saved batch
        if calib_x is None:
            # benchmark convenience only: noise calibration bears no
            # relation to real-image activation ranges — serving MUST
            # pass representative preprocessed frames
            warnings.warn(
                "QuantizedThroughputEngine: no calib_x given; "
                "calibrating on random noise (fine for benchmarks, "
                "wrong for serving accuracy)", stacklevel=2)
            rng = np.random.RandomState(0)
            calib_x = rng.uniform(
                0, 1, (min(batch, 8), spec.net.h, spec.net.w,
                       spec.net.c)).astype(np.float32)
        if phase_stem and batch != 128:
            # the JAX rule: the stem runs at batch 128 only
            raise ValueError("phase_stem requires batch=128")
        self.qnet = quantize_for_inference(
            spec, params, calib_x, device=self.device, presplit=presplit,
            quantize_head=quantize_head, region_dtype=region_dtype,
            phase_stem=phase_stem)
        last = self.qnet.spec.layers[-1]
        self.presplit = isinstance(last, S.RegionSpec) and last.presplit
        self.input_shape = (batch, spec.net.h, spec.net.w, spec.net.c)

    def warmup(self):
        sync_checksum(self.qnet.forward(
            torch.zeros(self.input_shape, device=self.device))).item()

    def __call__(self, x):
        return self.qnet.forward(x)

    def benchmark(self, iters: int = 50, warmup: int = 5,
                  input_dtype=torch.float32) -> dict:
        """``input_dtype=torch.uint8`` measures the raw-camera-frame feed
        (the /255 is folded into the input quant)."""
        return checksum_benchmark(
            lambda x: sync_checksum(self.qnet.forward(x)),
            self.input_shape, self.batch, iters=iters, warmup=warmup,
            dtype=input_dtype, device=self.device)


__all__ = ["quantize_for_inference", "QuantizedNetwork",
           "QuantizedForwardShim", "QuantizedThroughputEngine",
           "calibrate_amax", "load_calib", "save_calib"]
