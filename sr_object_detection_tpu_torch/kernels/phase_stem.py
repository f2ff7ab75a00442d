"""int8 stem pairs at batch 128: the CUDA kernel ``csrc/phase_stem.cu``
and its wrapper.

Counterpart of ``sr_object_detection_tpu/kernels/phase_stem.py``. A pair
is [conv3x3 s1 p1 + bias + leaky 0.1 -> maxpool 2x2/2] of the int8
serving engine (``infer/quant.py``); tiny-yolo-voc-416 has four of them
(3->16 @416, 16->32 @208, 32->64 @104, 64->128 @52). The kernel maxes the
four raw int32 conv accumulators under each pooled pixel and runs the
dequant + bias + leaky + requant epilogue once, which is bit-exact to
the int8 chain because that epilogue is monotone (dq > 0). Its design
and bound are described in the source.

The TPU kernel's phase-split layout helpers (``to_phase``,
``from_phase``, ``pre_overlap``, ``halo_rows``, ``halo_pad``), the pool
variants' M-packing (``_groups``, ``_pack_mode``, ``_pack_lhs``) and its
VMEM planner (``_pick_rp_ws``, ``_vmem_bytes``) exist because Mosaic has
no strided lane slice and the batch fills the 128-lane tile; they are
not ported. ``plan_pairs`` is the JAX module's pure spec logic,
unchanged.

Dispatch is by device only: a CPU tensor takes
:func:`stem_pair_i8_plain`, a CUDA tensor launches the kernel or raises.
``launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph import spec as S
from ..ops import conv as C
from ..ops import pooling as P
from . import _build

launches = 0        # kernel launches since the last reset

# input dtypes the kernel takes, as its x_dtype code
_X_DTYPES = {torch.int8: 0, torch.uint8: 1, torch.float32: 2}


def requant(v, inv_scale):
    """float32 -> int8 codes: clamp(round(v * inv), -127, 127), round
    half to even (the JAX package's ``infer.quant._requant``)."""
    return torch.clamp(torch.round(v * inv_scale), -127, 127).to(torch.int8)


def stem_pair_i8_plain(x, w_q, dq, bias, inv_out, inv_in=None):
    """Plain PyTorch version of the kernel, same inputs and output.

    x (B,H,W,Cin) int8 codes — or raw frames, uint8 or float32, which are
    first requantized with ``inv_in`` — w_q (3,3,Cin,Cout) int8, dq and
    bias (Cout,) float32, inv_out a float32 scalar -> (B,H/2,W/2,Cout)
    int8: the int8 chain conv -> dequant + bias -> leaky -> requant ->
    maxpool 2x2/2."""
    if x.dtype != torch.int8:
        x = requant(x.float(), float(inv_in))
    y = C.conv2d_i8(x, w_q, stride=1, pad=1).float() * dq + bias
    y = torch.where(y > 0, y, 0.1 * y)
    q = requant(y, float(inv_out))
    return P.maxpool_i8(q, size=2, stride=2, pad=0)


def stem_pair_i8(x, w_q, dq, bias, inv_out, inv_in=None):
    """One fused pair; arguments as :func:`stem_pair_i8_plain`."""
    global launches
    if x.device.type == "cpu":
        return stem_pair_i8_plain(x, w_q, dq, bias, inv_out, inv_in)
    n, h, w, cin = x.shape
    cout = w_q.shape[3]
    raw = x.dtype != torch.int8
    if (x.dtype not in _X_DTYPES or h % 2 or w % 2
            or raw != (inv_in is not None)
            or w_q.shape != (3, 3, cin, cout) or w_q.dtype != torch.int8
            or dq.shape != (cout,) or dq.dtype != torch.float32
            or bias.shape != (cout,) or bias.dtype != torch.float32
            or not (x.device == w_q.device == dq.device == bias.device)):
        raise ValueError(
            "stem_pair_i8: want x (B,H,W,Cin) int8 (or uint8/float32 "
            "frames with inv_in) with H, W even, w (3,3,Cin,Cout) int8, "
            "dq and bias (Cout,) float32 on one device; got "
            f"{tuple(x.shape)} {x.dtype} inv_in={inv_in}, "
            f"{tuple(w_q.shape)} {w_q.dtype}, {tuple(dq.shape)} "
            f"{dq.dtype}, {tuple(bias.shape)} {bias.dtype}")
    x = x.contiguous()
    w_q = w_q.contiguous()
    out = torch.empty((n, h // 2, w // 2, cout), dtype=torch.int8,
                      device=x.device)
    err = _build.load().srod_phase_pair(
        x.data_ptr(), _X_DTYPES[x.dtype], w_q.data_ptr(),
        dq.contiguous().data_ptr(), bias.contiguous().data_ptr(),
        float(inv_in) if raw else 0.0, float(inv_out), out.data_ptr(),
        n, h, w, cin, cout, _build.stream_ptr(x.device))
    _build.check(err, "srod_phase_pair")
    launches += 1
    return out


def plan_pairs(spec: S.NetworkSpec, max_pairs: int = 4):
    """Leading [conv3x3 s1 p1 leaky, maxpool2x2 s2 p0] pairs the phase
    kernel can own: W divisible by 2^K, H/W even at each level, no
    route/shortcut back into the prefix. Returns list of (ci, pi)."""
    pairs = []
    layers = spec.layers
    i = 0
    while i + 1 < len(layers) and len(pairs) < max_pairs:
        l, nxt = layers[i], layers[i + 1]
        if not (isinstance(l, S.ConvSpec) and l.size == 3
                and l.stride == 1 and l.pad == 1
                and l.activation == "leaky"
                and not getattr(l, "xnor", False)
                and not getattr(l, "binary", False)
                and isinstance(nxt, S.MaxPoolSpec) and nxt.size == 2
                and nxt.stride == 2 and nxt.pad == 0
                and l.out_h % 2 == 0 and l.out_w % 2 == 0):
            break
        pairs.append((i, i + 1))
        i += 2
    while pairs:
        K = len(pairs)
        W, H = layers[0].w, layers[0].h
        if W % (1 << K) == 0 and H % (1 << K) == 0:
            break
        pairs.pop()                      # shrink K until W_P is whole
    if not pairs:
        return []
    consumed = pairs[-1][1] + 1
    for j in range(consumed, len(layers)):
        l = layers[j]
        if isinstance(l, S.RouteSpec) and any(k < consumed
                                              for k in l.layers):
            return []
        if isinstance(l, S.ShortcutSpec) and l.from_index < consumed:
            return []
    return pairs


def build_phase_stem(spec: S.NetworkSpec, qparams, s_out, in_scale):
    """Build the fused int8 stem over the quantized params of
    ``infer.quant.quantize_for_inference`` (torch tensors: HWIO int8
    weights, float32 dequant and biases).

    Returns (stem_fn, n_consumed) or (None, 0). stem_fn(x) takes the raw
    engine input (float32 [0,1] or uint8 frames, NHWC) and returns the
    int8 NHWC activation after the last fused pair (scale
    s_out[n_consumed-1]), one kernel launch per pair: pair 1 requantizes
    the frame as it loads it."""
    pairs = plan_pairs(spec)
    # a head conv (float weights, no dequant) ends the fused prefix
    for k, (ci, _) in enumerate(pairs):
        if "dequant" not in qparams[ci]:
            pairs = pairs[:k]
            break
    if not pairs:
        return None, 0
    packed = [(qparams[ci]["weights"].contiguous(),
               qparams[ci]["dequant"].contiguous(),
               qparams[ci]["biases"].contiguous(),
               np.float32(1.0 / s_out[ci])) for ci, _ in pairs]
    inv_in = np.float32(1.0 / in_scale)
    inv_in_u8 = np.float32(1.0 / (255.0 * in_scale))

    def stem_fn(x):
        cur = x
        inv = inv_in_u8 if x.dtype == torch.uint8 else inv_in
        for w_q, dq, b, inv_out in packed:
            cur = stem_pair_i8(cur, w_q, dq, b, inv_out,
                               inv if cur.dtype != torch.int8 else None)
        return cur

    return stem_fn, pairs[-1][1] + 1


__all__ = ["stem_pair_i8", "stem_pair_i8_plain", "build_phase_stem",
           "plan_pairs", "requant", "launches"]
