"""The fused training stem of bf16 training: the CUDA kernels
``csrc/fused_stem.cu`` and their wrappers.

Counterpart of ``sr_object_detection_tpu/kernels/fused_stem.py``
(``fused_bn_leaky_pool``). With ``fused_stem=True`` the trainer runs each
fusable [conv + BN + leaky, maxpool 2x2/2] pair as the library conv
(``F.conv2d`` and its autograd, as the JAX package leaves the conv to
XLA) followed by :func:`fused_bn_leaky_pool` on its bf16 output y:

* forward: the batch statistics (a torch reduction, as the JAX package's
  ``_fused_stats`` is XLA's) -> :func:`f2` (BN apply + bias + leaky +
  pool, the full-resolution activation never written);
* backward: :func:`b1` (pool routing + leaky backward -> per channel
  sum dz and sum dz * x_hat) -> darknet's BN constants -> :func:`b2` (the
  cotangent of y in one pass).

The kernels read the layout the port's conv writes: y is logically NCHW,
NCHW or channels-last in memory, and nothing is copied around them. F2,
B1 and B2 have two kernels each: the row kernels (``f2_row_kernel``,
``b1_row_kernel``, ``b2_row_kernel``: one pooled row a task, 16-byte
vectors of 8 channels) where :func:`_row_path` holds (y, dp, dy and F2's
output dense channels-last, C a multiple of 8, 16-byte aligned: the
training step's case on the card), and the strided kernels
(``f2_kernel``, ``b1_kernel``, ``b2_kernel``) for every other layout.

Each kernel has a plain PyTorch version beside it (``*_plain``); a CPU
tensor takes it, a CUDA tensor launches the kernel or raises.
``launches`` counts each op's launches and nothing else; ``paths`` says
which kernel took each launch.

Not ported: ``_pick_tiles``, ``_grids``, ``_kcols`` and the lane-splatted
``_consts`` (the TPU's (8, 128) tiling with the batch in the lanes), and
with them the batch-128 gate of ``_supported``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..ops.activations import LEAKY_BF16
from ..ops.conv import BN_EPS, _sqrt_rn, shifted_moments
from . import _build
from .phase_train import _bn_roll, bn_backward_consts

launches = {"f2": 0, "b1": 0, "b2": 0}
# which kernel took each launch: the row kernels or the strided ones
paths = {"f2_row": 0, "b1_row": 0, "b2_row": 0, "f2": 0, "b1": 0, "b2": 0}

THREADS = 256               # csrc/fused_stem.cu's block (B1's lanes)
B1_BLOCKS = 4096            # B1's partial rows at most
ROW_THREADS = 448           # a row kernel's block at most (csrc ROW_THREADS)


def reset_launches():
    for counts in (launches, paths):
        for k in counts:
            counts[k] = 0


def _b1_takes(c) -> bool:
    """B1 gives each thread one channel: C divides 256 or is a multiple."""
    return c % THREADS == 0 if c >= THREADS else THREADS % c == 0


def supported(spec) -> bool:
    """Whether the kernels take the conv layer's channel count; the
    compiler checks the layer kinds first."""
    return _b1_takes(spec.filters)


# ------------------------------------------------------ plain versions

def _ch(v):
    return v.reshape(1, -1, 1, 1, 1)


def _windows(y, mean, inv, scales, biases):
    """Per tap of each 2x2 window (B, C, H/2, W/2, 4 taps row-major):
    y - mean, x_hat, the bf16 activation and the pre-activation's sign
    (the JAX package's ``_bn_leaky``)."""
    b, c, h, w = y.shape
    taps = y.float().reshape(b, c, h // 2, 2, w // 2, 2).permute(
        0, 1, 2, 4, 3, 5).reshape(b, c, h // 2, w // 2, 4)
    xm = taps - _ch(mean)
    xhat = xm * _ch(inv)
    zb = (xhat * _ch(scales)).to(torch.bfloat16) + _ch(
        biases.to(torch.bfloat16))
    pos = zb > 0
    return xm, xhat, torch.where(pos, zb, zb * LEAKY_BF16), pos


def _dz(a, pos, dp):
    """The pooled cotangent to the first tap attaining the window's
    maximum, through the bf16 leaky slope (``_recompute_dz``)."""
    af = a.float()
    first = (af == af.amax(-1, keepdim=True)).float().argmax(-1)
    g = dp.float()[..., None]
    neg = (g * LEAKY_BF16).to(torch.bfloat16).float()
    return torch.where(F.one_hot(first, 4).bool(), torch.where(pos, g, neg),
                       0.0)


def _like(t, y):
    """t in y's memory format, as the kernels write their outputs: the
    next layer's conv then sums in the order it would on the unfused
    chain's tensors (the CPU library picks its order by memory format)."""
    return t.contiguous(memory_format=(
        torch.channels_last if _channels_last(y) else torch.contiguous_format))


def f2_plain(y, mean, inv, scales, biases):
    """Plain version of F2: y (B,C,H,W) bf16 (H, W even) and four (C,)
    float32 constants -> the pooled activation (B,C,H/2,W/2) bf16 in y's
    memory format, max over each window of bf16 leaky(bf16(bf16((y -
    mean) * inv * scale) + bf16(bias)))."""
    return _like(_windows(y, mean, inv, scales, biases)[2].amax(-1), y)


def b1_plain(y, dp, mean, inv, scales, biases):
    """Plain version of B1: y (B,C,H,W) bf16, the pooled cotangent dp
    (B,C,H/2,W/2) bf16 and four (C,) constants -> (C, 2) float32 = [sum
    dz, sum dz * x_hat] per channel (dbiases, dscales)."""
    _, xhat, a, pos = _windows(y, mean, inv, scales, biases)
    dz = _dz(a, pos, dp)
    return torch.stack([dz.sum(dim=(0, 2, 3, 4)),
                        (dz * xhat).sum(dim=(0, 2, 3, 4))], dim=1)


def b2_plain(y, dp, mean, inv, scales, biases, c1, c2, c3):
    """Plain version of B2: the routing of :func:`b1_plain`, then the
    cotangent of y, bf16(dz*c1 + (y - mean)*c2 + c3) (B,C,H,W) bf16 in
    y's memory format."""
    xm, _, a, pos = _windows(y, mean, inv, scales, biases)
    t = (_dz(a, pos, dp) * _ch(c1) + xm * _ch(c2) + _ch(c3)).to(
        torch.bfloat16)
    b, c, h, w = y.shape
    return _like(t.reshape(b, c, h // 2, w // 2, 2, 2).permute(
        0, 1, 2, 4, 3, 5).reshape(b, c, h, w), y)


# ------------------------------------------------------------ kernels

def _check(name, y, dp, consts):
    b, c, h, w = y.shape
    if (y.dtype != torch.bfloat16 or h % 2 or w % 2
            or (dp is not None and (dp.dtype != torch.bfloat16
                                    or tuple(dp.shape) != (b, c, h // 2,
                                                           w // 2)))
            or any(k.shape != (c,) for k in consts)
            or any(t.device != y.device for t in
                   (*consts, *([dp] if dp is not None else [])))):
        raise ValueError(
            f"fused_stem.{name}: want y (B,C,H,W) bf16 with H, W even, dp "
            "(B,C,H/2,W/2) bf16 and (C,) constants on one device; got "
            f"{tuple(y.shape)} {y.dtype}, "
            f"{None if dp is None else (tuple(dp.shape), dp.dtype)}, "
            f"{[tuple(k.shape) for k in consts]}")


def _consts(consts):
    """The kernels' constant rows (csrc kc): mean, inv, scales, bias and,
    for B2, c1, c2, c3, as one float32 (rows, C) tensor; F2 and B1 read
    the first four rows only."""
    return torch.stack([k.float() for k in consts])


def _strides(y, dp, out):
    vals = []
    for t in (y, dp, out):
        vals += list(t.stride()) if t is not None else [0] * 4
    return (ctypes.c_longlong * 12)(*vals)


def _row_path(y, dp, out=None) -> bool:
    """Whether the row kernels take F2 / B1 / B2 on these tensors: y, dp
    and out (each when given) dense channels-last, C a multiple of 8 (a
    16-byte vector of channels) and each data pointer 16-byte aligned."""
    c = y.shape[1]
    return (c % 8 == 0 and c // 8 <= ROW_THREADS
            and all(t.is_contiguous(memory_format=torch.channels_last)
                    and t.data_ptr() % 16 == 0
                    for t in (y, dp, out) if t is not None))


def row_geometry(c, w):
    """The row kernels' block for C channels and width W: (G, kper,
    ntile, threads). Thread t holds channel group t % G (G = C/8) and
    pooled column tile * kper + t // G; a row's W/2 columns are split
    into ntile tiles of kper, as evenly as ROW_THREADS threads allow."""
    g, w2 = c // 8, w // 2
    ntile = -(-w2 // (ROW_THREADS // g))
    kper = -(-w2 // ntile)
    return g, kper, ntile, kper * g


ROW_KINDS = ("b2", "b1", "f2")      # csrc srod_fs_row_grid's kind


@functools.lru_cache(maxsize=None)
def _row_grid(device_index, kind, threads, tasks):
    """Blocks of a row kernel: as many as the device holds at once, at
    most one a task (csrc: srod_fs_row_grid)."""
    with torch.cuda.device(device_index):
        nblk = _build.load().srod_fs_row_grid(ROW_KINDS.index(kind),
                                              threads, tasks)
    if nblk < 1:
        raise RuntimeError(f"srod_fs_row_grid: {nblk} for {kind}, "
                           f"{threads} threads, {tasks} tasks")
    return nblk


def _row_launch(kind, y):
    """(kper, ntile, nblk) of a row-kernel launch (``kind`` "f2", "b1"
    or "b2") on y."""
    b, c, h, w = y.shape
    _, kper, ntile, threads = row_geometry(c, w)
    return kper, ntile, _row_grid(y.device.index, kind, threads,
                                  b * (h // 2) * ntile)


def _channels_last(y):
    """Walk the elements channel-fastest when that is y's memory order."""
    return int(y.stride(1) == 1 and y.shape[1] > 1)


def f2(y, mean, inv, scales, biases):
    """The F2 kernel; arguments and result as :func:`f2_plain` (the output
    in y's memory format)."""
    if y.device.type == "cpu":
        return f2_plain(y, mean, inv, scales, biases)
    consts = (mean, inv, scales, biases)
    _check("f2", y, None, consts)
    b, c, h, w = y.shape
    cl = _channels_last(y)
    out = torch.empty((b, c, h // 2, w // 2), dtype=torch.bfloat16,
                      device=y.device,
                      memory_format=(torch.channels_last if cl
                                     else torch.contiguous_format))
    kc = _consts(consts)
    if _row_path(y, None, out):
        kper, ntile, nblk = _row_launch("f2", y)
        err = _build.load().srod_fs_f2_row(
            y.data_ptr(), kc.data_ptr(), out.data_ptr(), nblk, b, c, h, w,
            kper, ntile, _build.stream_ptr(y.device))
        _build.check(err, "srod_fs_f2_row")
        paths["f2_row"] += 1
    else:
        strides = _strides(y, None, out)
        err = _build.load().srod_fs_f2(
            y.data_ptr(), kc.data_ptr(), out.data_ptr(),
            ctypes.addressof(strides), b, c, h, w, cl,
            _build.stream_ptr(y.device))
        _build.check(err, "srod_fs_f2")
        paths["f2"] += 1
    launches["f2"] += 1
    return out


def b1(y, dp, mean, inv, scales, biases):
    """The B1 kernel; arguments and result as :func:`b1_plain`."""
    if y.device.type == "cpu":
        return b1_plain(y, dp, mean, inv, scales, biases)
    consts = (mean, inv, scales, biases)
    _check("b1", y, dp, consts)
    b, c, h, w = y.shape
    kc = _consts(consts)
    out = torch.empty(2 * c, dtype=torch.float32, device=y.device)
    if _row_path(y, dp):
        kper, ntile, nblk = _row_launch("b1", y)
        partial = torch.empty((nblk, 2 * c), dtype=torch.float32,
                              device=y.device)
        err = _build.load().srod_fs_b1_row(
            y.data_ptr(), dp.data_ptr(), kc.data_ptr(), partial.data_ptr(),
            nblk, out.data_ptr(), b, c, h, w, kper, ntile,
            _build.stream_ptr(y.device))
        _build.check(err, "srod_fs_b1_row")
        launches["b1"] += 1
        paths["b1_row"] += 1
        return out.reshape(2, c).T
    if not _b1_takes(c):
        raise ValueError(f"fused_stem.b1: {c} channels neither divide "
                         f"{THREADS} nor are a multiple of it")
    positions = b * (h // 2) * (w // 2)
    lanes = THREADS // min(c, THREADS)
    nblk = max(1, min(B1_BLOCKS, -(-positions // (16 * lanes))))
    per_block = -(-positions // nblk)
    partial = torch.empty((nblk, 2 * c), dtype=torch.float32,
                          device=y.device)
    strides = _strides(y, dp, None)
    err = _build.load().srod_fs_b1(
        y.data_ptr(), dp.data_ptr(), kc.data_ptr(), partial.data_ptr(),
        nblk, per_block, out.data_ptr(),
        ctypes.addressof(strides), b, c, h, w, _build.stream_ptr(y.device))
    _build.check(err, "srod_fs_b1")
    launches["b1"] += 1
    paths["b1"] += 1
    return out.reshape(2, c).T


def b2(y, dp, mean, inv, scales, biases, c1, c2, c3):
    """The B2 kernel; arguments and result as :func:`b2_plain` (the
    output in y's memory format)."""
    if y.device.type == "cpu":
        return b2_plain(y, dp, mean, inv, scales, biases, c1, c2, c3)
    consts = (mean, inv, scales, biases, c1, c2, c3)
    _check("b2", y, dp, consts)
    b, c, h, w = y.shape
    kc = _consts(consts)
    out = torch.empty_like(y)
    if _row_path(y, dp, out):
        kper, ntile, nblk = _row_launch("b2", y)
        err = _build.load().srod_fs_b2_row(
            y.data_ptr(), dp.data_ptr(), kc.data_ptr(), out.data_ptr(), nblk,
            b, c, h, w, kper, ntile, _build.stream_ptr(y.device))
        _build.check(err, "srod_fs_b2_row")
        paths["b2_row"] += 1
    else:
        strides = _strides(y, dp, out)
        err = _build.load().srod_fs_b2(
            y.data_ptr(), dp.data_ptr(), kc.data_ptr(), out.data_ptr(),
            ctypes.addressof(strides), b, c, h, w,
            _channels_last(y), _build.stream_ptr(y.device))
        _build.check(err, "srod_fs_b2")
        paths["b2"] += 1
    launches["b2"] += 1
    return out


# ------------------------------------------------------- the fused op

class _FusedBNLeakyPool(torch.autograd.Function):
    """stats -> F2; backward B1 -> BN constants -> B2. The statistics are
    the unfused bf16 chain's (``ops.conv.shifted_moments``, the JAX
    package's ``_fused_stats``); the cotangents of mean and var are
    ignored (the rolling update is not differentiated)."""

    @staticmethod
    def forward(ctx, y, scales, biases, shift):
        mean, var = shifted_moments(y, shift)
        inv = 1.0 / (_sqrt_rn(var) + BN_EPS)
        pooled = f2(y, mean, inv, scales, biases)
        ctx.save_for_backward(y, scales, biases, mean, var)
        ctx.mark_non_differentiable(mean, var)
        return pooled, mean, var

    @staticmethod
    def backward(ctx, gpooled, _gm, _gv):
        y, scales, biases, mean, var = ctx.saved_tensors
        n = y.shape[0] * y.shape[2] * y.shape[3]
        inv = 1.0 / (_sqrt_rn(var) + BN_EPS)
        dp = gpooled.to(torch.bfloat16)
        s = b1(y, dp, mean, inv, scales, biases)
        dbiases, dscales = s[:, 0], s[:, 1]
        c1, c2, c3 = bn_backward_consts(scales, var, dbiases, dscales, n)
        dyv = b2(y, dp, mean, inv, scales, biases, c1, c2, c3)
        return (dyv, dscales.to(scales.dtype), dbiases.to(biases.dtype),
                None)


def fused_bn_leaky_pool(y, scales, biases, shift):
    """y: (B, C, H, W) bf16 conv output, H and W even. Returns (pooled
    (B, C, H/2, W/2) bf16, batch mean (C,), batch var (C,)): the bf16
    train-mode BN + bias + leaky + darknet maxpool(2, 2, 0), with darknet's
    hand-written BN backward."""
    return _FusedBNLeakyPool.apply(y, scales, biases, shift)


def fused_stem_block(x, params, spec):
    """One [conv + BN + bias + leaky, maxpool 2x2/2] training pair: the
    bf16 conv of NCHW x, then :func:`fused_bn_leaky_pool`. Returns (pooled
    NCHW bf16, bn_updates) — a drop-in for conv_block_train + maxpool."""
    y = F.conv2d(x.to(torch.bfloat16), params["weights"].to(torch.bfloat16),
                 stride=spec.stride, padding=spec.pad)
    pooled, mean, var = fused_bn_leaky_pool(
        y, params["scales"], params["biases"],
        params["rolling_mean"].detach())
    return pooled, _bn_roll(params, mean, var)


__all__ = ["fused_bn_leaky_pool", "fused_stem_block", "f2", "f2_plain",
           "b1", "b1_plain", "b2", "b2_plain", "supported", "row_geometry",
           "launches", "paths", "reset_launches"]
