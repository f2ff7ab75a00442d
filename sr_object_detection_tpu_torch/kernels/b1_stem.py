"""Batch-1 stem pairs: the CUDA kernel ``csrc/b1_stem.cu`` and its wrapper.

Counterpart of ``sr_object_detection_tpu/kernels/b1_stem.py``. A pair is
[conv3x3 s1 p1 + bias + leaky 0.1 -> maxpool 2x2/2] with BN already
folded; tiny-yolo-voc-416 has four of them (3->16 @416, 16->32 @208,
32->64 @104, 64->128 @52). The kernel computes
``bf16(max over 2x2 of leaky(conv3x3(x, w) + b))`` with float32 products,
sums and bias and ONE rounding, the TPU kernel's order; its design and
bound are described in the source. The TPU kernel's flat channels-first
layout helpers (``to_flat``, ``from_flat``, ``pack_weights``,
``_sel_matrix``, ``_cpad16``) were TPU layout answers and are not ported.

``plan_pairs`` and ``truncate_spec`` are the JAX module's pure spec
logic, unchanged. Dispatch is by device only: a CPU tensor takes
:func:`stem_pair_plain`, a CUDA tensor launches the kernel or raises.
``launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..graph import spec as S
from . import _build

launches = 0        # kernel launches since the last reset


def stem_pair_plain(x, w_hwio, bias):
    """Plain PyTorch version of the kernel, same inputs and output:
    x (1,H,W,Cin) bf16, w_hwio (3,3,Cin,Cout) bf16, bias (Cout,) f32 ->
    (1,H/2,W/2,Cout) bf16, everything before the last cast in float32."""
    xf = x.float().permute(0, 3, 1, 2)
    wf = w_hwio.float().permute(3, 2, 0, 1)
    y = F.conv2d(xf, wf, padding=1) + bias.float().reshape(1, -1, 1, 1)
    y = torch.where(y > 0, y, 0.1 * y)
    y = F.max_pool2d(y, kernel_size=2, stride=2)
    return y.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()


def stem_pair(x, w_hwio, bias):
    """One fused pair. x (1,H,W,Cin) bf16 NHWC, w_hwio (3,3,Cin,Cout)
    bf16, bias (Cout,) f32 -> (1,H/2,W/2,Cout) bf16 NHWC."""
    global launches
    if x.device.type == "cpu":
        return stem_pair_plain(x, w_hwio, bias)
    n, h, w, cin = x.shape
    cout = w_hwio.shape[3]
    if (n != 1 or h % 2 or w % 2 or x.dtype != torch.bfloat16
            or w_hwio.shape != (3, 3, cin, cout)
            or w_hwio.dtype != torch.bfloat16
            or bias.shape != (cout,) or bias.dtype != torch.float32
            or not (x.device == w_hwio.device == bias.device)):
        raise ValueError(
            "stem_pair: want x (1,H,W,Cin) bf16 with H, W even, w "
            "(3,3,Cin,Cout) bf16 and bias (Cout,) f32 on one device; got "
            f"{tuple(x.shape)} {x.dtype}, {tuple(w_hwio.shape)} "
            f"{w_hwio.dtype}, {tuple(bias.shape)} {bias.dtype}")
    x = x.contiguous()
    w_hwio = w_hwio.contiguous()
    bias = bias.contiguous()
    out = torch.empty((1, h // 2, w // 2, cout), dtype=torch.bfloat16,
                      device=x.device)
    err = _build.load().srod_stem_pair(
        x.data_ptr(), w_hwio.data_ptr(), bias.data_ptr(), out.data_ptr(),
        h, w, cin, cout, _build.stream_ptr(x.device))
    _build.check(err, "srod_stem_pair")
    launches += 1
    return out


def plan_pairs(spec: S.NetworkSpec):
    """Leading [conv3x3 s1 p1 leaky (BN folded), maxpool2x2 s2 p0] pairs
    this kernel can own. Returns list of (conv_idx, pool_idx)."""
    pairs = []
    layers = spec.layers
    i = 0
    while i + 1 < len(layers):
        l, nxt = layers[i], layers[i + 1]
        if not (isinstance(l, S.ConvSpec) and l.size == 3 and l.stride == 1
                and l.pad == 1 and l.activation == "leaky"
                and not l.batch_normalize and not l.xnor and not l.binary
                and l.filters <= 128
                and isinstance(nxt, S.MaxPoolSpec) and nxt.size == 2
                and nxt.stride == 2 and nxt.pad == 0
                and l.out_h % 2 == 0 and l.out_w % 2 == 0):
            break
        pairs.append((i, i + 1))
        i += 2
    # no later layer may route/shortcut back into the fused prefix
    consumed = i
    for j in range(consumed, len(layers)):
        l = layers[j]
        if isinstance(l, S.RouteSpec) and any(k < consumed for k in l.layers):
            return []
        if isinstance(l, S.ShortcutSpec) and l.from_index < consumed:
            return []
    return pairs


def truncate_spec(spec: S.NetworkSpec, n: int) -> S.NetworkSpec:
    """spec with the first n layers removed: net geometry rebased to
    layer n's input and route/shortcut indices shifted by -n (plan_pairs
    already guarantees none point into the removed prefix)."""
    first = spec.layers[n]
    net = dataclasses.replace(spec.net, h=first.h, w=first.w, c=first.c,
                              inputs=first.h * first.w * first.c)
    out = []
    for l in spec.layers[n:]:
        if isinstance(l, S.RouteSpec):
            l = dataclasses.replace(
                l, layers=tuple(j - n for j in l.layers))
        elif isinstance(l, S.ShortcutSpec):
            l = dataclasses.replace(l, from_index=l.from_index - n)
        out.append(l)
    return S.NetworkSpec(net=net, layers=tuple(out), cfg_path=spec.cfg_path)


def build_stem(spec: S.NetworkSpec, params):
    """Returns (stem_fn, n_consumed) or (None, 0).

    ``params``: the port's folded params (OIHW weights, biases) for a
    spec with BN folded. stem_fn(x) maps the NHWC (1,H,W,C) input to the
    NHWC bf16 activation after the last fused pair, one kernel launch per
    pair and no host work between them. Weights are repacked to HWIO
    bf16 and biases to f32 once, here."""
    pairs = plan_pairs(spec)
    if not pairs:
        return None, 0
    packed = [(params[ci]["weights"].permute(2, 3, 1, 0)
               .to(torch.bfloat16).contiguous(),
               params[ci]["biases"].float().contiguous())
              for ci, _ in pairs]

    def stem_fn(x):
        cur = x.to(torch.bfloat16)
        for w_hwio, b in packed:
            cur = stem_pair(cur, w_hwio, b)
        return cur

    return stem_fn, pairs[-1][1] + 1


__all__ = ["stem_pair", "stem_pair_plain", "build_stem", "plan_pairs",
           "truncate_spec", "launches"]
