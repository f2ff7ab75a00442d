"""The fused leading pair of bf16 training: the CUDA kernels
``csrc/phase_train.cu`` and their wrappers.

Counterpart of ``sr_object_detection_tpu/kernels/phase_train.py``
(``phase_train_block``, ``build_bf16_stem``). A pair is [conv3x3 s1 p1 +
train-mode BN + bias + leaky, maxpool 2x2/2]; the JAX trainer with
``phase_train=True`` runs the network's leading pair through it, so the
full-resolution conv output never reaches device memory:

* forward: :func:`fwdstats` (the four bf16 conv outputs under each pooled
  pixel, their extreme in the direction of the channel's BN slope, the
  first tap attaining it, and the shifted moments) -> the batch
  statistics -> :func:`apply` (BN + bias + leaky on the pooled values);
* backward: :func:`bwdg` (no conv recompute: the cotangent routed by the
  saved argmax, the BN reductions, and the weight gradient in its Gram
  form) -> darknet's hand-written BN constants -> ``dw``.

:func:`build_bf16_stem` is the bf16 serving stem of
``ThroughputEngine(phase_stem=True)``: the JAX kernel's mode ``fwd``
(conv, per tap bf16 rounding, bf16 bias and leaky, first-max pool), one
launch of :func:`fwd_pair` a pair on the conv tile.

:func:`phase_train_chain2` (``phase_train="chain"``) runs the leading two
pairs: pair 0 as above, and pair 1 (whose input gradient is needed)
forward through fwdstats + apply, backward through :func:`red` (conv
recompute, first-max routing of the recomputed activation, the BN
reductions) -> the BN constants -> :func:`dy` (the full-resolution
cotangent and the direct weight gradient) -> :func:`dgrad` (the input
gradient, which pair 0's bwdg takes as its pooled cotangent).

Each kernel has a plain PyTorch version beside it (``*_plain``); a CPU
tensor takes it, a CUDA tensor launches the kernel or raises.
``launches`` counts each kernel's launches and nothing else;
``bwdg_kernels`` says which of bwdg's two kernels they ran, and
``conv_kernels`` which conv path fwdstats, red, dy and fwd ran
(:func:`conv_path`): the tensor-core tile for Cin a multiple of 16 in
every mode (so the chain's pair 1 recomputes its forward's y bit for
bit), the tile with the taps fold for fwdstats and fwd at Cin <= 3 (the
leading pair's 3 -> 16), the FP32-core loop for the rest.

Not ported: the TPU layout (``to_phase_np``/``from_phase_np``, the halo
sidebands, ``Geom``/``plan_pair``'s VMEM planner, ``_pack_w`` and the
pool-variant M-packing; for dgrad ``DgradGeom``/``plan_dgrad``,
``_pack_w_dgrad``, ``_halo_rows_3d``, ``_dy_side_cols`` and ``_DG_CSL``):
Mosaic's limits, not the function. Modes ``stats`` and ``bwd`` are TPU
packing fallbacks of ``fwdstats`` and ``bwdg``; the JAX chain runs pair
0's backward in mode ``bwd``, the port runs bwdg on the argmax its
forward saved (the same function up to the tie rule and the bf16
rounding of y in the Gram term).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.activations import LEAKY_BF16
from ..ops.conv import BN_EPS, EPS_B, _sqrt_rn
from . import _build

launches = {"fwdstats": 0, "apply": 0, "bwdg": 0, "red": 0, "dy": 0,
            "dgrad": 0, "fwd": 0}
# which of bwdg's two kernels each launch ran: bwdg_tc_kernel (the tensor
# cores; Cin <= 3, Cout 16 or 32) or bwdg_kernel (the FP32 cores)
bwdg_kernels = {"tensor_core": 0, "fp32_core": 0}
# which conv path each launch of fwdstats, red, dy and fwd ran
# (conv_path): the tensor-core tile (fwdstats_tc_kernel, red_tc_kernel,
# dy_tc_kernel, fwd_tc_kernel; Cin a multiple of 16), the tile with the
# taps fold (fwdstats_fold_kernel, fwd_fold_kernel; Cin <= 3) or the
# FP32-core loop (fwdstats_kernel, chain_bwd_kernel; fwd's shapes off the
# tile run fwdstats_kernel + apply_kernel)
CONV_MODES = ("fwdstats", "red", "dy", "fwd")
CONV_PATHS = ("fp32_core", "tensor_core", "tensor_core_fold")
conv_kernels = {mode: dict.fromkeys(CONV_PATHS, 0) for mode in CONV_MODES}
# the library's mode numbers (csrc CT_*), the batch-1 stem's
# (kernels/b1_stem.py) among them: it runs on the same tile
MODE_INDEX = {"fwdstats": 0, "red": 1, "dy": 2, "stem": 3, "fwd": 4}

# the kernels' shape limits (csrc/phase_train.cu)
MAX_CIN_FWD, MAX_COUT_FWD = 64, 128
MAX_CIN_STEM = 128          # the stem's tile (csrc PT_MAX_CIN_STEM)
MAX_CIN_BWD, MAX_COUT_BWD = 16, 64
MAX_CIN_CHAIN = 16          # red, dy and dgrad: Cin 8 or 16
CHAIN_BLOCKS = 2048         # red/dy blocks to aim for (B x groups x chunks)


def reset_launches():
    for counts in (launches, bwdg_kernels, *conv_kernels.values()):
        for k in counts:
            counts[k] = 0


def conv_path(mode, cin, cout):
    """The conv path a launch of fwdstats, red, dy, the batch-1 stem
    (``mode`` "stem") or the bf16 serving stem ("fwd") runs for a shape,
    as the library picks it (``srod_pt_conv_tensor_core``): the
    tensor-core tile for Cin a multiple of 16 (the batch-1 stem's up to
    ``MAX_CIN_STEM``), the tile with the taps fold for fwdstats and the
    two stems at Cin <= 3, else the FP32-core loop (the batch-1 stem's:
    ``stem_pair_kernel``; fwd's: fwdstats_kernel + apply_kernel)."""
    if (cin <= 0 or cout <= 0 or cout % 16
            or (mode == "stem" and cin > MAX_CIN_STEM)):
        return "fp32_core"
    if cin % 16 == 0:
        return "tensor_core"
    return ("tensor_core_fold"
            if mode in ("fwdstats", "stem", "fwd") and cin <= 3
            else "fp32_core")


def library_conv_path(lib, mode, cin, cout):
    """The library's own answer to :func:`conv_path`."""
    return CONV_PATHS[lib.srod_pt_conv_tensor_core(MODE_INDEX[mode], cin,
                                                   cout)]


def _count_conv(lib, mode, cin, cout):
    """One launch of fwdstats, red, dy or fwd, and the conv path it ran."""
    launches[mode] += 1
    conv_kernels[mode][library_conv_path(lib, mode, cin, cout)] += 1


def supported(spec) -> bool:
    """Whether the training pair's kernels take a conv layer's shape (the
    compiler's predicate on the layer kind comes first)."""
    return (spec.c <= MAX_CIN_BWD and spec.filters % 16 == 0
            and spec.filters <= MAX_COUT_BWD)


def supported_chain(spec0, spec2) -> bool:
    """Whether the two-pair chain's kernels take pair 0 (layer 0) and
    pair 1 (layer 2); the compiler checks the layer kinds first. The JAX
    package's batch-128 and planner gates (phase_train.py:1384-1393) were
    TPU rules and are dropped."""
    return (supported(spec0) and spec2.c <= MAX_CIN_CHAIN
            and spec2.c % 8 == 0 and spec2.filters % 16 == 0
            and spec2.filters <= MAX_COUT_FWD)


def _f32(*ts):
    return [t.to(torch.float32).contiguous() for t in ts]


# ------------------------------------------------------------ fwdstats

def fwdstats_plain(x, w_hwio, shift, scales):
    """Plain version of the fwdstats kernel, same inputs and outputs.

    x (B,H,W,Cin) bf16 NHWC, w_hwio (3,3,Cin,Cout) bf16, shift and scales
    (Cout,) f32 -> (Z (B,H/2,W/2,Cout) bf16, argmax int8 (0..3, window
    row-major), stats (2, Cout) f32 = [sum(y - shift), sum((y - shift)^2)])
    where y is the bf16 conv output."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1),
                 padding=1).float()
    b, c, h, w = y.shape
    taps = y.reshape(b, c, h // 2, 2, w // 2, 2).permute(
        0, 2, 4, 1, 3, 5).reshape(b, h // 2, w // 2, c, 4)
    z = torch.where(scales > 0, taps.amax(-1), taps.amin(-1))
    am = (taps == z[..., None]).float().argmax(-1)     # the first tap
    xs = y - shift.reshape(1, -1, 1, 1)
    stats = torch.stack([xs.sum(dim=(0, 2, 3)),
                         (xs * xs).sum(dim=(0, 2, 3))])
    return z.to(torch.bfloat16), am.to(torch.int8), stats


def fwdstats(x, w_hwio, shift, scales):
    """The fwdstats kernel; arguments and results as :func:`fwdstats_plain`.
    The library picks its conv path by shape (:func:`conv_path`);
    ``conv_kernels["fwdstats"]`` counts which ran."""
    if x.device.type == "cpu":
        return fwdstats_plain(x, w_hwio, shift, scales)
    n, h, w, cin = x.shape
    cout = w_hwio.shape[3]
    if (x.dtype != torch.bfloat16 or w_hwio.dtype != torch.bfloat16
            or w_hwio.shape != (3, 3, cin, cout) or h % 2 or w % 2
            or cin > MAX_CIN_FWD or cout % 16 or cout > MAX_COUT_FWD
            or shift.shape != (cout,) or scales.shape != (cout,)
            or not (x.device == w_hwio.device == shift.device
                    == scales.device)):
        raise ValueError(
            "phase_train.fwdstats: want x (B,H,W,Cin<=64) bf16 with H, W "
            "even, w (3,3,Cin,Cout) bf16 with Cout a multiple of 16 up to "
            "128, shift and scales (Cout,) on one device; got "
            f"{tuple(x.shape)} {x.dtype}, {tuple(w_hwio.shape)} "
            f"{w_hwio.dtype}, {tuple(shift.shape)}, {tuple(scales.shape)}")
    x, w_hwio = x.contiguous(), w_hwio.contiguous()
    if x.data_ptr() % 16:            # the tile's paths copy 16-byte units
        x = x.clone()
    lib = _build.load()
    out = _launch_fwdstats(lib, x, w_hwio, *_f32(shift, scales))
    _count_conv(lib, "fwdstats", cin, cout)
    return out


def _launch_fwdstats(lib, x, w_hwio, shift, scales):
    """srod_pt_fwdstats on checked, contiguous inputs (float32 shift and
    scales) -> (Z, argmax, stats (2, Cout))."""
    n, h, w, cin = x.shape
    cout = w_hwio.shape[3]
    h2, w2 = h // 2, w // 2
    tiles = -(-h2 // 8) * -(-w2 // 8)
    z = torch.empty((n, h2, w2, cout), dtype=torch.bfloat16, device=x.device)
    am = torch.empty((n, h2, w2, cout), dtype=torch.int8, device=x.device)
    partial = torch.empty((n * tiles, 2 * cout), dtype=torch.float32,
                          device=x.device)
    stats = torch.empty((2, cout), dtype=torch.float32, device=x.device)
    err = lib.srod_pt_fwdstats(
        x.data_ptr(), w_hwio.data_ptr(), shift.data_ptr(), scales.data_ptr(),
        z.data_ptr(), am.data_ptr(), partial.data_ptr(), stats.data_ptr(),
        n, h, w, cin, cout, _build.stream_ptr(x.device))
    _build.check(err, "srod_pt_fwdstats")
    return z, am, stats


# --------------------------------------------------------------- apply

def apply_plain(z, mean, inv, scales, biases):
    """Plain version of the apply kernel: z (...,Cout) bf16 and per-channel
    float32 constants -> bf16(bf16((z - mean) * inv * scale) + bf16(bias))
    through the bf16-slope leaky (phase_train.py:739-742 of the JAX
    package)."""
    t = ((z.float() - mean) * inv * scales).to(torch.bfloat16)
    zb = t + biases.to(torch.bfloat16)
    return torch.where(zb > 0, zb, zb * LEAKY_BF16)


def apply(z, mean, inv, scales, biases):
    """The apply kernel; arguments and result as :func:`apply_plain`."""
    if z.device.type == "cpu":
        return apply_plain(z, mean, inv, scales, biases)
    cout = z.shape[-1]
    consts = (mean, inv, scales, biases)
    if (z.dtype != torch.bfloat16 or cout % 8
            or any(c.shape != (cout,) or c.device != z.device
                   for c in consts)):
        raise ValueError(
            "phase_train.apply: want z (...,Cout) bf16 with Cout a multiple "
            "of 8 and four (Cout,) constants on its device; got "
            f"{tuple(z.shape)} {z.dtype}, "
            f"{[tuple(c.shape) for c in consts]}")
    out = _launch_apply(_build.load(), z.contiguous(), *_f32(*consts))
    launches["apply"] += 1
    return out


def _launch_apply(lib, z, mean, inv, scales, biases):
    """srod_pt_apply on a contiguous z and float32 constants."""
    out = torch.empty_like(z)
    err = lib.srod_pt_apply(
        z.data_ptr(), mean.data_ptr(), inv.data_ptr(), scales.data_ptr(),
        biases.data_ptr(), out.data_ptr(), z.numel(), z.shape[-1],
        _build.stream_ptr(z.device))
    _build.check(err, "srod_pt_apply")
    return out


# ---------------------------------------------------------------- bwdg

def _taps(x):
    """x (B,H,W,Cin) -> (9*Cin, B*H*W) float32 tap vectors of the 3x3 s1
    p1 conv, row t*Cin + ci for tap t = ky*3 + kx (HWIO order)."""
    b, h, w, cin = x.shape
    cols = F.unfold(x.permute(0, 3, 1, 2).float(), 3, padding=1)
    return cols.reshape(b, cin, 9, h * w).permute(2, 1, 0, 3).reshape(
        9 * cin, b * h * w)


def bwdg_plain(x, dp, z, am, mean, inv, scales, biases):
    """Plain version of the bwdg kernel, same inputs and outputs.

    x (B,H,W,Cin) bf16, dp, z (B,H/2,W/2,Cout) bf16, am int8 and four
    (Cout,) f32 constants -> (S (2, Cout) = [sum dzs, sum dzs * x_hat],
    A (9Cin, Cout), D (9Cin,), G (9Cin, 9Cin)), all float32."""
    xhat = (z.float() - mean) * inv
    zb = (xhat * scales).to(torch.bfloat16) + biases.to(torch.bfloat16)
    g = dp.float()
    neg = (g * LEAKY_BF16).to(torch.bfloat16).float()
    dzs = torch.where(zb > 0, g, neg)
    s = torch.stack([dzs.sum(dim=(0, 1, 2)),
                     (dzs * xhat).sum(dim=(0, 1, 2))])
    b, h2, w2, cout = dzs.shape
    # dzs at the selected tap of each window, zero elsewhere: (Cout, BHW)
    sel = F.one_hot(am.long(), 4).to(dzs.dtype) * dzs[..., None]
    full = sel.reshape(b, h2, w2, cout, 2, 2).permute(3, 0, 1, 4, 2, 5)
    full = full.reshape(cout, b * 2 * h2 * 2 * w2)
    taps = _taps(x)
    return s, taps @ full.T, taps.sum(dim=1), taps @ taps.T


def bwdg(x, dp, z, am, mean, inv, scales, biases):
    """The bwdg kernel; arguments and results as :func:`bwdg_plain`. The
    library picks the kernel by shape: bwdg_tc_kernel (tensor cores) for
    Cin <= 3 and Cout 16 or 32, bwdg_kernel (FP32 cores) for the rest;
    ``bwdg_kernels`` counts which ran."""
    if x.device.type == "cpu":
        return bwdg_plain(x, dp, z, am, mean, inv, scales, biases)
    n, h, w, cin = x.shape
    cout = z.shape[-1]
    pooled = (n, h // 2, w // 2, cout)
    consts = (mean, inv, scales, biases)
    if (x.dtype != torch.bfloat16 or dp.dtype != torch.bfloat16
            or z.dtype != torch.bfloat16 or am.dtype != torch.int8
            or tuple(dp.shape) != pooled or tuple(z.shape) != pooled
            or tuple(am.shape) != pooled or h % 2 or w % 2
            or cin > MAX_CIN_BWD or cout % 16 or cout > MAX_COUT_BWD
            or any(c.shape != (cout,) for c in consts)
            or any(t.device != x.device for t in (dp, z, am, *consts))):
        raise ValueError(
            "phase_train.bwdg: want x (B,H,W,Cin<=16) bf16 with H, W even, "
            "dp and z (B,H/2,W/2,Cout) bf16 with Cout a multiple of 16 up "
            "to 64, am of that shape int8 and four (Cout,) constants on "
            f"one device; got {tuple(x.shape)} {x.dtype}, "
            f"{tuple(dp.shape)} {dp.dtype}, {tuple(z.shape)} {z.dtype}, "
            f"{tuple(am.shape)} {am.dtype}")
    lib = _build.load()
    blocks = lib.srod_pt_bwdg_blocks(n, h, w, cin, cout)
    if blocks < 1:
        raise RuntimeError("phase_train.bwdg: no launch configuration for "
                           f"B={n} H={h} W={w} Cin={cin} Cout={cout}")
    x, dp, z, am = (t.contiguous() for t in (x, dp, z, am))
    mean, inv, scales, biases = _f32(*consts)
    n9 = 9 * cin
    ncols = 2 * cout + n9 * cout + n9 + n9 * n9
    partial = torch.empty((blocks, ncols), dtype=torch.float32,
                          device=x.device)
    out = torch.empty(ncols, dtype=torch.float32, device=x.device)
    err = lib.srod_pt_bwdg(
        x.data_ptr(), dp.data_ptr(), z.data_ptr(), am.data_ptr(),
        mean.data_ptr(), inv.data_ptr(), scales.data_ptr(),
        biases.data_ptr(), partial.data_ptr(), blocks, out.data_ptr(), n, h,
        w, cin, cout, _build.stream_ptr(x.device))
    _build.check(err, "srod_pt_bwdg")
    launches["bwdg"] += 1
    tc = lib.srod_pt_bwdg_tensor_core(cin, cout)
    bwdg_kernels["tensor_core" if tc else "fp32_core"] += 1
    s, a, d, g = torch.split(out, [2 * cout, n9 * cout, n9, n9 * n9])
    g = g.reshape(n9, n9).triu()                 # the upper triangle
    g = g + g.triu(1).T
    return s.reshape(2, cout), a.reshape(n9, cout), d, g


# ------------------------------------------ red and dy (the chain's pair 1)

def _routed(x, w_hwio, dp, mean, inv, scales, biases):
    """The conv recompute and pool routing shared by modes "red" and "dy"
    (phase_train.py:454-512 of the JAX package): per tap of each 2x2
    window (B, H/2, W/2, Cout, 4 taps in row-major order), the bf16 conv
    output's y - mean, x_hat and the cotangent dz. The window's pooled
    cotangent goes to the first tap attaining the maximum of the
    recomputed bf16 BN + bias + leaky activation, through the bf16 leaky
    slope."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1),
                 padding=1).float()
    b, c, h, w = y.shape
    taps = y.reshape(b, c, h // 2, 2, w // 2, 2).permute(
        0, 2, 4, 1, 3, 5).reshape(b, h // 2, w // 2, c, 4)
    xm = taps - mean[:, None]
    xhat = xm * inv[:, None]
    zb = ((xhat * scales[:, None]).to(torch.bfloat16)
          + biases.to(torch.bfloat16)[:, None])
    pos = zb > 0
    a = torch.where(pos, zb, zb * LEAKY_BF16).float()
    first = (a == a.amax(-1, keepdim=True)).float().argmax(-1)
    g = dp.float()[..., None]
    neg = (g * LEAKY_BF16).to(torch.bfloat16).float()
    sel = F.one_hot(first, 4).bool()
    dz = torch.where(sel, torch.where(pos, g, neg), 0.0)
    return xm, xhat, dz


def kernel_consts(cout, device, *consts):
    """The (7, Cout) float32 constant rows of red/dy (and of
    fused_stem's kernels): mean, inv, scales, bias, c1, c2, c3 (zeros
    where not given)."""
    rows = [c.to(torch.float32) for c in consts]
    rows += [torch.zeros(cout, device=device)] * (7 - len(rows))
    return torch.stack(rows).contiguous()


def _chain_check(name, x, w_hwio, dp, consts):
    n, h, w, cin = x.shape
    cout = w_hwio.shape[3]
    if (x.dtype != torch.bfloat16 or w_hwio.dtype != torch.bfloat16
            or dp.dtype != torch.bfloat16
            or w_hwio.shape != (3, 3, cin, cout)
            or tuple(dp.shape) != (n, h // 2, w // 2, cout) or h % 2
            or w % 2 or cin > MAX_CIN_CHAIN or cin % 8 or cout % 16
            or cout > MAX_COUT_FWD
            or any(c.shape != (cout,) for c in consts)
            or any(t.device != x.device for t in (w_hwio, dp, *consts))):
        raise ValueError(
            f"phase_train.{name}: want x (B,H,W,Cin) bf16 with Cin 8 or 16 "
            "and H, W even, w (3,3,Cin,Cout) bf16 with Cout a multiple of "
            "16 up to 128, dp (B,H/2,W/2,Cout) bf16 and (Cout,) constants on "
            f"one device; got {tuple(x.shape)} {x.dtype}, "
            f"{tuple(w_hwio.shape)} {w_hwio.dtype}, {tuple(dp.shape)} "
            f"{dp.dtype}, "
            f"{[tuple(c.shape) for c in consts]}")


def _chain_launch(entry, x, w_hwio, dp, kc, cols, dy=None):
    """Launch red or dy: per-chunk partial rows, colsum -> (cols,)."""
    n, h, w, cin = x.shape
    cout = w_hwio.shape[3]
    tiles = -(-h // 16) * -(-w // 16)
    nchunk = max(1, min(tiles, -(-CHAIN_BLOCKS // (n * cout // 16))))
    x, w_hwio, dp = (t.contiguous() for t in (x, w_hwio, dp))
    partial = torch.empty((n * nchunk, cols), dtype=torch.float32,
                          device=x.device)
    out = torch.empty(cols, dtype=torch.float32, device=x.device)
    lib = _build.load()
    args = [x.data_ptr(), w_hwio.data_ptr(), dp.data_ptr(), kc.data_ptr()]
    if dy is not None:
        args.append(dy.data_ptr())
    err = getattr(lib, entry)(*args, partial.data_ptr(), nchunk,
                              out.data_ptr(), n, h, w, cin, cout,
                              _build.stream_ptr(x.device))
    _build.check(err, entry)
    _count_conv(lib, entry[len("srod_pt_"):], cin, cout)
    return out


def red_plain(x, w_hwio, dp, mean, inv, scales, biases):
    """Plain version of mode "red": x (B,H,W,Cin) bf16, w_hwio
    (3,3,Cin,Cout) bf16, the pooled cotangent dp (B,H/2,W/2,Cout) bf16 and
    four (Cout,) float32 constants -> S (2, Cout) float32 = [sum dz,
    sum dz * x_hat] (dbiases, dscales)."""
    _, xhat, dz = _routed(x, w_hwio, dp, mean, inv, scales, biases)
    return torch.stack([dz.sum(dim=(0, 1, 2, 4)),
                        (dz * xhat).sum(dim=(0, 1, 2, 4))])


def red(x, w_hwio, dp, mean, inv, scales, biases):
    """The red kernel; arguments and result as :func:`red_plain`."""
    if x.device.type == "cpu":
        return red_plain(x, w_hwio, dp, mean, inv, scales, biases)
    consts = (mean, inv, scales, biases)
    _chain_check("red", x, w_hwio, dp, consts)
    cout = w_hwio.shape[3]
    s = _chain_launch("srod_pt_red", x, w_hwio, dp,
                      kernel_consts(cout, x.device, *consts), 2 * cout)
    return s.reshape(2, cout)


def dy_plain(x, w_hwio, dp, mean, inv, scales, biases, c1, c2, c3):
    """Plain version of mode "dy" with the weight gradient: the routing of
    :func:`red_plain`, then the full-resolution cotangent of the conv
    output dy = bf16(dz*c1 + (y - mean)*c2 + c3) (B,H,W,Cout) and the
    direct weight gradient dw = sum x_taps (x) dy (3,3,Cin,Cout) float32."""
    xm, _, dz = _routed(x, w_hwio, dp, mean, inv, scales, biases)
    b, h2, w2, c, _ = dz.shape
    t = (dz * c1[:, None] + xm * c2[:, None] + c3[:, None]).to(
        torch.bfloat16)
    dyf = t.reshape(b, h2, w2, c, 2, 2).permute(0, 1, 4, 2, 5, 3).reshape(
        b, 2 * h2, 2 * w2, c)
    dw = _taps(x) @ dyf.reshape(-1, c).float()
    return dyf, dw.reshape(3, 3, x.shape[3], c)


def dy(x, w_hwio, dp, mean, inv, scales, biases, c1, c2, c3):
    """The dy kernel; arguments and results as :func:`dy_plain`."""
    if x.device.type == "cpu":
        return dy_plain(x, w_hwio, dp, mean, inv, scales, biases, c1, c2, c3)
    consts = (mean, inv, scales, biases, c1, c2, c3)
    _chain_check("dy", x, w_hwio, dp, consts)
    n, h, w, cin = x.shape
    cout = w_hwio.shape[3]
    out = torch.empty((n, h, w, cout), dtype=torch.bfloat16, device=x.device)
    dw = _chain_launch("srod_pt_dy", x, w_hwio, dp,
                       kernel_consts(cout, x.device, *consts),
                       9 * cin * cout, dy=out)
    return out, dw.reshape(3, 3, cin, cout)


# --------------------------------------------------------------- dgrad

def dgrad_plain(dy_, w_hwio):
    """Plain version of the dgrad kernel: the input gradient of the 3x3
    s1 p1 conv, dx = dy conv w with flipped taps and swapped channels, as
    float32 sums rounded to bf16. dy_ (B,H,W,Cout) bf16, w_hwio
    (3,3,Cin,Cout) bf16 -> dx (B,H,W,Cin) bf16."""
    dx = F.conv_transpose2d(dy_.permute(0, 3, 1, 2).float(),
                            w_hwio.permute(3, 2, 0, 1).float(), padding=1)
    return dx.permute(0, 2, 3, 1).to(torch.bfloat16)


def dgrad(dy_, w_hwio):
    """The dgrad kernel; arguments and result as :func:`dgrad_plain`."""
    if dy_.device.type == "cpu":
        return dgrad_plain(dy_, w_hwio)
    n, h, w, cout = dy_.shape
    cin = w_hwio.shape[2]
    if (dy_.dtype != torch.bfloat16 or w_hwio.dtype != torch.bfloat16
            or w_hwio.shape != (3, 3, cin, cout) or cin > MAX_CIN_CHAIN
            or cin % 8 or cout % 16 or w_hwio.device != dy_.device):
        raise ValueError(
            "phase_train.dgrad: want dy (B,H,W,Cout) bf16 with Cout a "
            "multiple of 16 and w (3,3,Cin,Cout) bf16 with Cin 8 or 16 on "
            f"its device; got {tuple(dy_.shape)} {dy_.dtype}, "
            f"{tuple(w_hwio.shape)} {w_hwio.dtype}")
    dy_, w_hwio = dy_.contiguous(), w_hwio.contiguous()
    dx = torch.empty((n, h, w, cin), dtype=torch.bfloat16, device=dy_.device)
    err = _build.load().srod_pt_dgrad(
        dy_.data_ptr(), w_hwio.data_ptr(), dx.data_ptr(), n, h, w, cin, cout,
        _build.stream_ptr(dy_.device))
    _build.check(err, "srod_pt_dgrad")
    launches["dgrad"] += 1
    return dx


# ------------------------------------------------------- the fused op

def _batch_stats(stats, shift, n):
    """mean, clamped variance and inv = 1/(sqrt(var) + eps) from the
    shifted moments (phase_train.py:1019-1023 of the JAX package)."""
    sx, sxx = stats[0], stats[1]
    mean = shift + sx / n
    var = torch.clamp_min((sxx - sx * sx / n) / max(n - 1, 1), 0.0)
    return mean, var, 1.0 / (_sqrt_rn(var) + BN_EPS)


def bn_backward_consts(scales, var, dbiases, dscales, n):
    """darknet's hand-written BN backward (batchnorm_layer.c:147-157)
    folded to per-channel constants: dy = dz*c1 + (y - mean)*c2 + c3
    (phase_train.py:1093-1099 and fused_stem.py:326-332 of the JAX
    package). Returns (c1, c2, c3)."""
    sd = _sqrt_rn(var)
    sum_d = scales * dbiases
    sum_dxm = scales * (sd + BN_EPS) * dscales
    variance_delta = sum_dxm * (-0.5) * torch.pow(var + EPS_B, -1.5)
    mean_delta = sum_d * (-1.0 / _sqrt_rn(var + EPS_B))
    return scales / (sd + EPS_B), variance_delta * 2.0 / n, mean_delta / n


class _Pair(torch.autograd.Function):
    """fwdstats -> stats -> apply; backward bwdg -> BN constants -> dw.
    The input's gradient is not computed: the leading pair's input is the
    image."""

    @staticmethod
    def forward(ctx, x, w, scales, biases, shift):
        w_hwio = w.permute(2, 3, 1, 0).to(torch.bfloat16).contiguous()
        z, am, stats = fwdstats(x, w_hwio, shift, scales)
        n = x.shape[0] * x.shape[1] * x.shape[2]
        mean, var, inv = _batch_stats(stats, shift, n)
        pooled = apply(z, mean, inv, scales, biases)
        ctx.save_for_backward(x, w, scales, biases, mean, var, z, am)
        ctx.mark_non_differentiable(mean, var)
        return pooled, mean, var

    @staticmethod
    def backward(ctx, gpooled, _gm, _gv):
        x, w, scales, biases, mean, var, z, am = ctx.saved_tensors
        n = x.shape[0] * x.shape[1] * x.shape[2]
        sd = _sqrt_rn(var)
        inv = 1.0 / (sd + BN_EPS)
        s, a, d, g = bwdg(x, gpooled.to(torch.bfloat16), z, am, mean, inv,
                          scales, biases)
        dbiases, dscales = s[0], s[1]
        # darknet's BN backward is linear in (dz, y, 1) per out channel:
        # dw = c1*A + c2*E' + c3*D
        c1, c2, c3 = bn_backward_consts(scales, var, dbiases, dscales, n)
        cout, cin = w.shape[0], w.shape[1]
        w9 = w.permute(2, 3, 1, 0).reshape(9 * cin, cout).float()
        e = g @ w9                           # sum x (x) y, y linear in w
        dw9 = c1 * a + c2 * (e - d[:, None] * mean) + c3 * d[:, None]
        dw = dw9.reshape(3, 3, cin, cout).permute(3, 2, 0, 1)
        return (None, dw.to(w.dtype), dscales.to(scales.dtype),
                dbiases.to(biases.dtype), None)


def phase_train_block(x_nhwc, params, spec):
    """One fused [conv3x3 + BN + bias + leaky, maxpool 2x2/2] training
    pair. x_nhwc: (B, H, W, C) input of any float dtype (cast to bf16 like
    the bf16 conv), H and W even; ``params`` the layer's tensors (OIHW
    weights). Returns (pooled NHWC bf16, bn_updates) — a drop-in for the
    conv_block + maxpool pair in bf16 training."""
    pooled, mean, var = _Pair.apply(
        x_nhwc.to(torch.bfloat16).contiguous(), params["weights"],
        params["scales"], params["biases"], params["rolling_mean"].detach())
    return pooled, _bn_roll(params, mean, var)


def _bn_roll(params, mean, var):
    return {"rolling_mean": 0.9 * params["rolling_mean"].detach() + 0.1 * mean,
            "rolling_variance":
                0.9 * params["rolling_variance"].detach() + 0.1 * var}


class _DxPair(torch.autograd.Function):
    """The chain's second pair: fwdstats -> stats -> apply forward; backward
    red -> BN constants -> dy (+ dw) -> dgrad, with the input's gradient
    (the JAX package's _pair_grads(want_dx=True), phase_train.py:1075-
    1118)."""

    @staticmethod
    def forward(ctx, x, w, scales, biases, shift):
        w_hwio = w.permute(2, 3, 1, 0).to(torch.bfloat16).contiguous()
        z, _, stats = fwdstats(x, w_hwio, shift, scales)
        n = x.shape[0] * x.shape[1] * x.shape[2]
        mean, var, inv = _batch_stats(stats, shift, n)
        pooled = apply(z, mean, inv, scales, biases)
        ctx.save_for_backward(x, w, scales, biases, mean, var)
        ctx.mark_non_differentiable(mean, var)
        return pooled, mean, var

    @staticmethod
    def backward(ctx, gpooled, _gm, _gv):
        x, w, scales, biases, mean, var = ctx.saved_tensors
        n = x.shape[0] * x.shape[1] * x.shape[2]
        inv = 1.0 / (_sqrt_rn(var) + BN_EPS)
        w_hwio = w.permute(2, 3, 1, 0).to(torch.bfloat16).contiguous()
        dp = gpooled.to(torch.bfloat16)
        s = red(x, w_hwio, dp, mean, inv, scales, biases)
        dbiases, dscales = s[0], s[1]
        c1, c2, c3 = bn_backward_consts(scales, var, dbiases, dscales, n)
        dyf, dw = dy(x, w_hwio, dp, mean, inv, scales, biases, c1, c2, c3)
        dx = dgrad(dyf, w_hwio)
        return (dx, dw.permute(3, 2, 0, 1).to(w.dtype),
                dscales.to(scales.dtype), dbiases.to(biases.dtype), None)


def phase_train_dx_block(x_nhwc, params, spec):
    """:func:`phase_train_block` with the input's gradient (the chain's
    second pair): backward through red, dy and dgrad. x_nhwc: (B, H, W, C)
    with C 8 or 16 and H, W even. Returns (pooled NHWC bf16, bn_updates)."""
    pooled, mean, var = _DxPair.apply(
        x_nhwc.to(torch.bfloat16).contiguous(), params["weights"],
        params["scales"], params["biases"], params["rolling_mean"].detach())
    return pooled, _bn_roll(params, mean, var)


def phase_train_chain2(x_nhwc, params0, spec0, params2, spec2):
    """The leading two [conv3x3 + BN + bias + leaky, maxpool 2x2/2] pairs
    (layers 0-3), neither full-resolution conv output kept for the
    backward: :func:`phase_train_block`, then :func:`phase_train_dx_block`,
    whose input gradient (dgrad's output) is pair 0's pooled cotangent.
    Returns (pooled NHWC bf16 after the second pool, bn0, bn2)."""
    p0, bn0 = phase_train_block(x_nhwc, params0, spec0)
    p1, bn2 = phase_train_dx_block(p0, params2, spec2)
    return p1, bn0, bn2


# ------------------------------------------------ the bf16 serving stem

def fwd_epilogue_plain(y, bias):
    """The JAX kernel's mode ``fwd`` after the conv (phase_train.py:455-474
    of the JAX package), per tap in its order: y (B,H,W,Cout) float32 conv
    sums, bias (Cout,) float32 rounded to bf16 -> v = bf16(y), zb = bf16(v +
    bias), a = zb > 0 ? zb : bf16(zb * 0.10009765625), then the first
    maximum of each 2x2 window in row-major order (a later tap replaces
    the best only when strictly greater): (B,H/2,W/2,Cout) bf16."""
    v = y.to(torch.bfloat16).float()
    zb = (v + bias.to(torch.bfloat16).float()).to(torch.bfloat16)
    a = torch.where(zb > 0, zb, (zb.float() * LEAKY_BF16).to(torch.bfloat16))
    best = a[:, 0::2, 0::2]
    for tap in (a[:, 0::2, 1::2], a[:, 1::2, 0::2], a[:, 1::2, 1::2]):
        best = torch.where(tap.float() > best.float(), tap, best)
    return best.contiguous()


def fwd_pair_plain(x, w_hwio, bias):
    """Plain version of the fwd kernel, same inputs and output: x
    (B,H,W,Cin) bf16, w_hwio (3,3,Cin,Cout) bf16, bias (Cout,) float32,
    rounded to bf16 as ``apply`` rounds it -> (B,H/2,W/2,Cout) bf16. The
    conv in float32 (on the card with TF32 off:
    ``infer.detector.disable_tf32``), then :func:`fwd_epilogue_plain`; no
    shortcut through fwdstats."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2),
                 w_hwio.float().permute(3, 2, 0, 1), padding=1)
    return fwd_epilogue_plain(y.permute(0, 2, 3, 1), bias)


def fwd_pair(x, w_hwio, bias):
    """The fwd kernel (one launch a pair of the bf16 serving stem);
    arguments and result as :func:`fwd_pair_plain`. The library puts the
    shape on the tile or its taps fold (:func:`conv_path`); the shapes it
    refuses (Cin 4-15, Cin > 16 no multiple of 16) run fwdstats_kernel +
    apply_kernel with identity constants, the same function, by shape.
    ``launches["fwd"]`` counts the pairs, ``conv_kernels["fwd"]`` which
    path each ran."""
    if x.device.type == "cpu":
        return fwd_pair_plain(x, w_hwio, bias)
    n, h, w, cin = x.shape
    cout = w_hwio.shape[3]
    if (x.dtype != torch.bfloat16 or w_hwio.dtype != torch.bfloat16
            or w_hwio.shape != (3, 3, cin, cout) or h % 2 or w % 2
            or cin > MAX_CIN_FWD or cout % 16 or cout > MAX_COUT_FWD
            or bias.shape != (cout,) or bias.dtype != torch.float32
            or not (x.device == w_hwio.device == bias.device)):
        raise ValueError(
            "phase_train.fwd_pair: want x (B,H,W,Cin<=64) bf16 with H, W "
            "even, w (3,3,Cin,Cout) bf16 with Cout a multiple of 16 up to "
            "128 and bias (Cout,) float32 on one device; got "
            f"{tuple(x.shape)} {x.dtype}, {tuple(w_hwio.shape)} "
            f"{w_hwio.dtype}, {tuple(bias.shape)} {bias.dtype}")
    x, w_hwio, bias = x.contiguous(), w_hwio.contiguous(), bias.contiguous()
    if x.data_ptr() % 16:            # the tile copies 16-byte units
        x = x.clone()
    if w_hwio.data_ptr() % 16:
        w_hwio = w_hwio.clone()
    lib = _build.load()
    path = library_conv_path(lib, "fwd", cin, cout)
    if path == "fp32_core":
        # fwdstats_kernel + apply_kernel with identity BN constants
        zero = torch.zeros(cout, dtype=torch.float32, device=x.device)
        one = torch.ones(cout, dtype=torch.float32, device=x.device)
        z, _, _ = _launch_fwdstats(lib, x, w_hwio, zero, one)
        out = _launch_apply(lib, z, zero, one, one, bias)
    else:
        out = torch.empty((n, h // 2, w // 2, cout), dtype=torch.bfloat16,
                          device=x.device)
        _build.check(lib.srod_pt_fwd_pair(
            x.data_ptr(), w_hwio.data_ptr(), bias.data_ptr(), out.data_ptr(),
            n, h, w, cin, cout, _build.stream_ptr(x.device)),
            "srod_pt_fwd_pair")
    launches["fwd"] += 1
    conv_kernels["fwd"][path] += 1
    return out


def build_bf16_stem(spec, params):
    """bf16 serving stem: the leading [conv3x3 + bias + leaky, maxpool
    2x2/2] pairs of a BN-folded spec, one :func:`fwd_pair` a pair (the JAX
    package's ``build_bf16_stem`` through its ``fwd`` mode: the per-tap
    bf16 roundings of fwdstats + apply with identity BN constants, mean
    0, inv 1, scale 1).

    ``params``: the folded torch params (OIHW bf16 weights, bf16 biases).
    Returns (stem_fn, n_consumed) or (None, 0); stem_fn takes the NHWC
    input and returns the bf16 NHWC activation after the last pair."""
    from .phase_stem import plan_pairs
    pairs = plan_pairs(spec)
    for k, (ci, _) in enumerate(pairs):
        l = spec.layers[ci]
        if (l.c > MAX_CIN_FWD or l.filters % 16
                or l.filters > MAX_COUT_FWD):
            pairs = pairs[:k]
            break
    if not pairs:
        return None, 0
    packed = [(params[ci]["weights"].permute(2, 3, 1, 0).to(torch.bfloat16)
               .contiguous(), params[ci]["biases"].float().contiguous())
              for ci, _ in pairs]

    def stem_fn(x):
        cur = x.to(torch.bfloat16)
        for w_hwio, bias in packed:
            cur = fwd_pair(cur, w_hwio, bias)
        return cur

    return stem_fn, pairs[-1][1] + 1


__all__ = ["phase_train_block", "phase_train_dx_block", "phase_train_chain2",
           "build_bf16_stem", "fwd_pair", "fwd_pair_plain",
           "fwd_epilogue_plain",
           "fwdstats", "fwdstats_plain", "apply", "apply_plain", "bwdg",
           "bwdg_plain", "red", "red_plain", "dy", "dy_plain", "dgrad",
           "dgrad_plain", "bn_backward_consts", "supported",
           "supported_chain", "launches", "bwdg_kernels", "conv_kernels",
           "conv_path", "library_conv_path", "reset_launches"]
