"""cfg graph -> torch ``nn.Module``.

Counterpart of ``sr_object_detection_tpu/graph/compiler.py``
(``CompiledNetwork`` / ``build_forward``). :class:`Network` wraps a
``NetworkSpec`` and one module per layer; PyTorch runs it eagerly.

Layouts: the input is NHWC like the JAX package's, the layers pass NCHW
between them (``F.conv2d``'s native layout), and every tensor that leaves
the network is converted back — spatial outputs as NHWC, the region
output as the flat darknet raster ``[row][col][anchor][field]``
(compiler.py:417-424 of the JAX package).

The port holds conv, maxpool, region (with the WordTree softmax of a
``tree=`` head, and the engines' aligned and pre-split head layouts),
and yolov2's route, reorg and
shortcut, for inference and for training (``Network.forward(x,
train=True)``, with the bf16 training kernels of ``phase_train`` and
``fused_stem``, and the trainer's ``remat``); autograd gives route,
reorg and shortcut their backwards.

The classifier family's kinds run for inference and for training:
connected (with its BN), avgpool, lrn, dropout, crop, batchnorm,
activation, softmax (``groups``, ``temperature``, a ``tree=`` through
``ops.boxes.grouped_softmax``), cost, local, deconv, XNOR convs and a
route of flat outputs. In training, dropout keeps each element with
probability 1-p and crop takes a random offset and flip, both drawn from
a ``torch.Generator`` (the JAX compiler draws from ``jax.random``, whose
stream the port does not reproduce); the plain softmax has darknet's
straight-through backward; the cost layers' loss comes back as
aux['cost']; autograd gives lrn, local, deconv, avgpool and the
activations their backwards. Flat (B, N) tensors are darknet's CHW
raster, which is NCHW's own order, so a flat layer after a spatial one
reshapes, and a spatial layer after a flat one reshapes back to its
input geometry (the JAX compiler's ``_as_flat`` / ``_as_nhwc``).

The last four kinds: rnn, gru and crnn (``ops/rnn.py``: the step-major
recurrence over ``net.time_steps``, parameters keyed
``<sublayer>.<name>``, a crnn on NCHW) and YOLOv1's detection layer (the class softmax where
``softmax`` is set, straight through in training as the JAX compiler's
``_softmax_straight_through``; its loss is ``train/detection_loss.py``).
A network whose input is flat, as a char-rnn's (B, inputs), takes it as
it is.
"""

from __future__ import annotations

import itertools
import os
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from . import spec as S
from ..io.tree import WordTree, read_tree
from ..ops import activations as A
from ..ops import boxes as B
from ..ops import conv as C
from ..ops import layout as L
from ..ops import pooling as P
from ..ops import rnn as R


class ConvLayer(nn.Module):
    """conv [+BN] + bias + activation; buffers hold OIHW weights. An XNOR
    conv binarizes its weights and input at inference
    (``ops.conv.conv_block``) and trains on the real ones
    (``ops.conv.conv_block_train``)."""

    def __init__(self, spec: S.ConvSpec, params: dict, compute_dtype=None):
        super().__init__()
        self.spec = spec
        self.compute_dtype = compute_dtype
        self.act = A.get_activation(spec.activation)
        for k, v in params.items():
            self.register_buffer(k, v)

    def forward(self, x):
        p = {k: v for k, v in self.named_buffers()}
        return C.conv_block(x, p, self.spec, self.act,
                            compute_dtype=self.compute_dtype)


class MaxPoolLayer(nn.Module):
    def __init__(self, spec: S.MaxPoolSpec):
        super().__init__()
        self.spec = spec

    def forward(self, x):
        l = self.spec
        return P.maxpool(x, size=l.size, stride=l.stride, pad=l.pad)


def _resolve_tree(spec_layer, search_dirs) -> Optional[WordTree]:
    if getattr(spec_layer, "tree_file", None) is None:
        return None
    tf = spec_layer.tree_file
    candidates = [tf] + [os.path.join(d, os.path.basename(tf))
                         for d in search_dirs]
    pad_to = getattr(spec_layer, "classes", None)
    for c in candidates:
        if os.path.exists(c):
            return read_tree(c, pad_to=pad_to)
    raise FileNotFoundError(f"tree file not found: {tf}")


def resolve_trees(spec: S.NetworkSpec) -> dict[int, WordTree]:
    """The WordTree of every ``tree=`` layer (the JAX compiler's
    ``resolve_trees``): the path as given, then beside the cfg; a
    truncated file is padded to the layer's classes with singleton roots
    (``io.tree.read_tree``)."""
    dirs = []
    if spec.cfg_path:
        dirs.append(os.path.dirname(os.path.abspath(spec.cfg_path)))
    trees: dict[int, WordTree] = {}
    for i, l in enumerate(spec.layers):
        if isinstance(l, (S.RegionSpec, S.SoftmaxSpec)):
            t = _resolve_tree(l, dirs)
            if t is not None:
                trees[i] = t
    return trees


class RegionLayer(nn.Module):
    """NCHW head output -> the activated region output: the flat darknet
    raster (B, H*W*A*F), or with ``presplit`` the (fields, cls) pair of
    ``ops.boxes.region_activate_split[_flat]`` (the JAX compiler's
    region branch, compiler.py:397-423). ``tree``: the layer's WordTree,
    whose sibling groups the class softmax runs over; its group ids (and
    the flat head's extended ids and mask) are built once, on
    ``device``."""

    def __init__(self, spec: S.RegionSpec, tree: Optional[WordTree] = None,
                 device="cpu"):
        super().__init__()
        if spec.tree_file is not None and tree is None:
            raise ValueError(f"layer {spec.index}: tree={spec.tree_file} "
                             "but no WordTree was given")
        self.spec = spec
        self.tree = tree
        self.gids = None if tree is None else B.GroupIds(tree.group, device)
        self.flat_gids = None
        if (spec.presplit and spec.presplit_flat and spec.head_block
                and (tree is not None or spec.softmax)):
            ext, mask = B.flat_head_gids(
                spec.n, spec.coords, spec.classes, spec.head_block,
                None if tree is None else tree.group)
            self.flat_gids = (B.GroupIds(ext, device),
                              torch.from_numpy(mask).to(device))

    def activate(self, x):
        """The region activations of an NHWC head output."""
        l = self.spec
        if l.presplit and l.head_block:
            if l.presplit_flat:
                return B.region_activate_split_flat(
                    x, l.n, l.coords, l.head_block,
                    flat_gids=self.flat_gids)
            return B.region_activate_split(
                x, l.n, l.coords, l.classes, l.head_block,
                softmax=l.softmax, tree_groups=self.gids)
        if l.head_block:
            acts = B.region_activate_aligned(
                x, l.n, l.coords, l.classes, l.head_block,
                softmax=l.softmax, tree_groups=self.gids)
        else:
            acts = B.region_activate(x, l.n, l.coords + l.classes + 1,
                                     softmax=l.softmax, tree_groups=self.gids)
        return acts.reshape(acts.shape[0], -1)

    def forward(self, x):
        return self.activate(x.permute(0, 2, 3, 1))


class RouteLayer(nn.Module):
    """Channel concat of earlier NCHW outputs (``forward(outputs)``), or,
    where the route's output is flat (out_c 0), the concat of its
    sources' flat rasters (the JAX compiler's compiler.py:337-339)."""

    def __init__(self, spec: S.RouteSpec):
        super().__init__()
        self.spec = spec

    def forward(self, outputs):
        srcs = [outputs[j] for j in self.spec.layers]
        if self.spec.out_c > 0:
            return L.route(srcs, dim=1)
        return torch.cat([L.nchw_to_flat(t) for t in srcs], dim=1)


class ReorgLayer(nn.Module):
    def __init__(self, spec: S.ReorgSpec):
        super().__init__()
        self.spec = spec

    def forward(self, x):
        l = self.spec
        fn = (L.reorg_reverse_darknet_nchw if l.reverse
              else L.reorg_darknet_nchw)
        return fn(x, stride=l.stride)


class ShortcutLayer(nn.Module):
    """Residual add of an earlier NCHW output (``forward(x, outputs)``)."""

    def __init__(self, spec: S.ShortcutSpec):
        super().__init__()
        self.spec = spec
        self.act = A.get_activation(spec.activation)

    def forward(self, x, outputs):
        return L.shortcut_nchw(x, outputs[self.spec.from_index], self.act)


class _Layer(nn.Module):
    """A layer whose ``params`` become buffers."""

    def __init__(self, spec, params=None):
        super().__init__()
        self.spec = spec
        for k, v in (params or {}).items():
            self.register_buffer(k, v)


class ConnectedLayer(_Layer):
    """Fully connected [+BN] + bias + activation on the flat raster;
    float32 output (``ops.conv.connected``). ``forward_train`` runs the
    batch-statistics BN and returns (y, bn update or None)."""

    def forward(self, x):
        l = self.spec
        p = dict(self.named_buffers())
        return C.connected(L.nchw_to_flat(x), p,
                           A.get_activation(l.activation),
                           batch_normalize=l.batch_normalize)

    def forward_train(self, x, p):
        l = self.spec
        return C.connected(L.nchw_to_flat(x), p,
                           A.get_activation(l.activation),
                           batch_normalize=l.batch_normalize, train=True)


class AvgPoolLayer(_Layer):
    def forward(self, x):
        return P.avgpool_global(x)


class DropoutLayer(_Layer):
    """The identity at inference. In training the keep mask is a draw
    (:meth:`draw`), passed in, so that a checkpoint's recompute and a
    test supplying the JAX package's mask use the same one."""

    def forward(self, x):
        return L.dropout(x)

    def draw(self, x, generator):
        """The keep mask of x's shape (``ops.layout.dropout_keep``; None
        at probability 0)."""
        p = self.spec.probability
        return None if p == 0.0 else L.dropout_keep(x, p, generator)

    def forward_train(self, x, keep):
        if keep is None:
            return x
        return L.dropout_masked(x, keep, self.spec.probability)


class CropLayer(_Layer):
    """crop_layer.c:67-110's CPU path, then 2x - 1 unless ``noadjust``
    (the JAX compiler's ``_crop_forward``): the centre crop at inference;
    in training the offsets and flip of :meth:`draw`."""

    def forward(self, x):
        l = self.spec
        return self._crop(x, (x.shape[2] - l.crop_h) // 2,
                          (x.shape[3] - l.crop_w) // 2, False)

    def draw(self, x, generator):
        """(dh, dw, flip): offsets uniform in [0, h - crop_h] and
        [0, w - crop_w], a flip with probability 1/2 where ``flip`` is
        set."""
        l = self.spec
        dh = int(torch.randint(0, x.shape[2] - l.crop_h + 1, (),
                               generator=generator))
        dw = int(torch.randint(0, x.shape[3] - l.crop_w + 1, (),
                               generator=generator))
        flip = bool(l.flip) and bool(torch.rand((), generator=generator)
                                     < 0.5)
        return dh, dw, flip

    def forward_train(self, x, draw):
        return self._crop(x, *draw)

    def _crop(self, x, dh, dw, flip):
        l = self.spec
        scale, trans = (1.0, 0.0) if l.noadjust else (2.0, -1.0)
        out = x[:, :, dh:dh + l.crop_h, dw:dw + l.crop_w]
        if flip:
            out = out.flip(3)
        return out * scale + trans


class BatchNormLayer(_Layer):
    """The standalone [batchnorm] layer with its rolling statistics; in
    training the batch statistics (``ops.conv.batchnorm_train``)."""

    def forward(self, x):
        return C.batchnorm_inference(x, self.scales, self.rolling_mean,
                                     self.rolling_variance)

    def forward_train(self, x, p):
        y, rm, rv, _, _ = C.batchnorm_train(x, p["scales"],
                                            p["rolling_mean"],
                                            p["rolling_variance"])
        return y, {"rolling_mean": rm, "rolling_variance": rv}


class LRNLayer(_Layer):
    def forward(self, x):
        l = self.spec
        return P.lrn(x, size=l.size, alpha=l.alpha, beta=l.beta,
                     kappa=l.kappa)


class ActivationLayer(_Layer):
    """The activation alone, in its input's dtype (the bf16 leaky slope on
    bf16), on any layout."""

    def forward(self, x):
        return A.get_activation(self.spec.activation, x.dtype)(x)


class SoftmaxLayer(_Layer):
    """softmax_layer.c:49-61 on the flat raster: ``groups`` fold into the
    batch, the logits are divided by ``temperature``, and a ``tree=``
    runs the WordTree's grouped softmax (its group ids built once on
    ``device``). The plain softmax rounds where jax.nn.softmax does:
    x - max, exp and the sum in the input's dtype, then the quotient.
    In training the plain softmax's backward is the identity
    (backward_softmax_layer, softmax_layer.c:62-68: darknet adds the
    output's delta straight into the input's); a ``tree=`` softmax keeps
    its full Jacobian, as the JAX compiler's does."""

    def __init__(self, spec: S.SoftmaxSpec, tree: Optional[WordTree] = None,
                 device="cpu"):
        super().__init__(spec)
        if spec.tree_file is not None and tree is None:
            raise ValueError(f"layer {spec.index}: tree={spec.tree_file} "
                             "but no WordTree was given")
        self.gids = None if tree is None else B.GroupIds(tree.group, device)

    def forward(self, x, train: bool = False):
        l = self.spec
        x = L.nchw_to_flat(x)
        b = x.shape[0]
        v = x.reshape(b * l.groups, l.inputs // l.groups) / l.temperature
        if self.gids is not None:
            out = B.grouped_softmax(v, self.gids)
        elif train:
            out = _SoftmaxStraightThrough.apply(v)
        else:
            out = _softmax(v)
        return out.reshape(b, l.inputs)


def _softmax(v):
    e = torch.exp(v - v.max(dim=-1, keepdim=True).values)
    return e / e.sum(dim=-1, keepdim=True)


class _SoftmaxStraightThrough(torch.autograd.Function):
    """Softmax forward, identity backward (the JAX compiler's
    ``_softmax_straight_through``)."""

    @staticmethod
    def forward(ctx, v):
        return _softmax(v)

    @staticmethod
    def backward(ctx, g):
        return g


class CostLayer(_Layer):
    """The cost layer copies its input; in training :func:`cost` is its
    loss against the truth."""

    def forward(self, x):
        return x


def cost(pred, truth, l: S.CostSpec):
    """cost_layer.c:73-110 (the JAX compiler's ``_cost_forward``): the sum
    of squared differences (``sse``), with the truths that hold
    SECRET_NUM skipped (``masked``), or the smooth-L1 sum (``smooth``),
    times ``scale``; float32 whatever the prediction's dtype, as JAX's
    promotion of a bf16 prediction against float32 truth gives."""
    truth = truth.float()
    diff = truth - L.nchw_to_flat(pred).float()
    if l.cost_type == "masked":
        diff = torch.where(truth == L.SECRET_NUM, 0.0, diff)
    if l.cost_type == "smooth":
        a = diff.abs()
        return torch.where(a < 1, diff * diff, 2 * a - 1).sum() * l.scale
    return (diff * diff).sum() * l.scale


class DetectionLayer(_Layer):
    """YOLOv1's [detection] layer (detection_layer.c:49-73) on the flat
    raster [side^2 * classes | side^2 * n objectness | boxes]: the
    class block softmaxed per cell where ``softmax`` is set (in training
    with the identity backward, darknet's delta copied straight through),
    the rest passed as it is (the JAX compiler's detection branch)."""

    def forward(self, x, train: bool = False):
        l = self.spec
        x = L.nchw_to_flat(x)
        if not l.softmax:
            return x
        b, loc = x.shape[0], l.side * l.side
        cls = x[:, :loc * l.classes].reshape(b * loc, l.classes)
        cls = _SoftmaxStraightThrough.apply(cls) if train else _softmax(cls)
        return torch.cat([cls.reshape(b, -1), x[:, loc * l.classes:]], 1)


class _Params(nn.Module):
    """One sublayer's tensors as buffers."""

    def __init__(self, params: dict):
        super().__init__()
        for k, v in params.items():
            self.register_buffer(k, v)


class _RecurrentLayer(nn.Module):
    """rnn / gru / crnn: one ``_Params`` a sublayer, so that
    ``named_buffers()`` gives the port's flat ``<sublayer>.<name>``
    keys, and the recurrence of ``ops/rnn.py`` over ``time_steps``."""

    def __init__(self, spec, params: dict, time_steps: int):
        super().__init__()
        self.spec = spec
        self.time_steps = time_steps
        for sub, p in R.sublayers(params).items():
            self.add_module(sub, _Params(p))

    def forward(self, x):
        return self.forward_train(x, dict(self.named_buffers()),
                                  train=False)

    def forward_train(self, x, p, train: bool = True):
        l = self.spec
        if isinstance(l, S.CRNNSpec):
            return R.crnn_forward(x, p, l, time_steps=self.time_steps,
                                  train=train)[0]
        fn = R.rnn_forward if isinstance(l, S.RNNSpec) else R.gru_forward
        return fn(L.nchw_to_flat(x), p, l, time_steps=self.time_steps,
                  train=train)[0]


def _spatial(layer: nn.Module) -> bool:
    """Whether a layer reads an NCHW input (a flat one is reshaped to
    its input geometry first)."""
    return isinstance(layer, _SPATIAL) or (
        isinstance(layer, _RecurrentLayer)
        and isinstance(layer.spec, S.CRNNSpec))


class LocalLayer(_Layer):
    """Locally connected layer (local_layer.c): per-location weights
    ``(locations, n, c*size*size)`` over darknet's im2col columns (channel
    major, as ``F.unfold`` orders them), biases ``[n][locations]``,
    float32 sums and output (the JAX compiler's ``_local_forward``)."""

    def forward(self, x):
        return self.forward_train(x, dict(self.named_buffers()))

    def forward_train(self, x, p):
        l = self.spec
        pad = l.size // 2 if l.pad else 0
        cols = F.unfold(x.float(), l.size, padding=pad, stride=l.stride)
        y = torch.einsum("bkl,lnk->bnl", cols, p["weights"].float())
        y = y + p["biases"].reshape(l.filters, -1)
        y = y.reshape(x.shape[0], l.filters, l.out_h, l.out_w)
        return A.get_activation(l.activation)(y)


class DeconvLayer(_Layer):
    """Transposed conv (deconvolutional_layer.c), out = s*(in-1) + size.
    The reference's col2im scatter indexes the kernel unflipped, which is
    ``F.conv_transpose2d``'s own sum over (Cin, Cout, kh, kw) weights;
    the JAX compiler flips the kernel because ``lax.conv_transpose`` runs
    a forward conv (``io.convert`` lays the weights out)."""

    def forward(self, x):
        return self.forward_train(x, dict(self.named_buffers()))

    def forward_train(self, x, p):
        l = self.spec
        y = F.conv_transpose2d(x, p["weights"].to(x.dtype), stride=l.stride)
        y = y + p["biases"].to(y.dtype).reshape(1, -1, 1, 1)
        return A.get_activation(l.activation, y.dtype)(y)


_INFERENCE_KINDS = {S.ConnectedSpec: ConnectedLayer, S.AvgPoolSpec:
                    AvgPoolLayer, S.DropoutSpec: DropoutLayer,
                    S.CropSpec: CropLayer, S.BatchNormSpec: BatchNormLayer,
                    S.LRNSpec: LRNLayer, S.ActivationSpec: ActivationLayer,
                    S.CostSpec: CostLayer, S.LocalSpec: LocalLayer,
                    S.DeconvSpec: DeconvLayer, S.DetectionSpec:
                    DetectionLayer}
# layers that read an NCHW input: a flat one is reshaped to their input
# geometry first
_SPATIAL = (ConvLayer, MaxPoolLayer, RegionLayer, ReorgLayer, ShortcutLayer,
            AvgPoolLayer, CropLayer, BatchNormLayer, LRNLayer, LocalLayer,
            DeconvLayer)
_RECURRENT = (S.RNNSpec, S.GRUSpec, S.CRNNSpec)


def build_layer(l: S.LayerSpec, params: dict, compute_dtype=None, *,
                tree: Optional[WordTree] = None, device="cpu",
                time_steps: int = 1):
    if isinstance(l, S.ConvSpec):
        return ConvLayer(l, params, compute_dtype)
    if isinstance(l, S.MaxPoolSpec):
        return MaxPoolLayer(l)
    if isinstance(l, S.RegionSpec):
        return RegionLayer(l, tree, device)
    if isinstance(l, S.RouteSpec):
        return RouteLayer(l)
    if isinstance(l, S.ReorgSpec):
        return ReorgLayer(l)
    if isinstance(l, S.ShortcutSpec):
        return ShortcutLayer(l)
    if isinstance(l, S.SoftmaxSpec):
        return SoftmaxLayer(l, tree, device)
    if type(l) in _INFERENCE_KINDS:
        return _INFERENCE_KINDS[type(l)](l, params)
    if isinstance(l, _RECURRENT):
        return _RecurrentLayer(l, params, time_steps)
    raise NotImplementedError(
        f"layer {l.index} ({l.kind}): the JAX package's polyphase rewrite "
        "is not ported (ROADMAP, 'Not ported')")


def _to_public(t):
    """NCHW -> NHWC for a spatial tensor; flat tensors and the pre-split
    region's (fields, cls) pair pass through."""
    return t.permute(0, 2, 3, 1) if not isinstance(t, tuple) and \
        t.ndim == 4 else t


def _phase_pair_ok(layers, ci: int) -> bool:
    """The JAX compiler's fused-pair predicate (compiler.py:156-165): conv
    3x3 s1 p1 with BN and leaky, then maxpool 2/2/0."""
    if ci + 1 >= len(layers):
        return False
    l, nxt = layers[ci], layers[ci + 1]
    return (isinstance(l, S.ConvSpec) and l.batch_normalize
            and l.size == 3 and l.stride == 1 and l.pad == 1
            and l.activation == "leaky" and not l.xnor and not l.binary
            and isinstance(nxt, S.MaxPoolSpec)
            and nxt.size == 2 and nxt.stride == 2 and nxt.pad == 0)


def live_set(spec: S.NetworkSpec) -> set[int]:
    """Indices whose outputs a later non-adjacent layer reads."""
    live: set[int] = set()
    for l in spec.layers:
        if isinstance(l, S.RouteSpec):
            live.update(l.layers)
        elif isinstance(l, S.ShortcutSpec):
            live.add(l.from_index)
    return live


def remat_divisor(remat):
    """The trainer's ``remat`` as a number: None when off, 0 for
    ``True`` (every unit of the training forward a checkpointed segment
    of its own), k for ``"selective:k"`` (``"selective"`` is k = 8, as
    in the JAX trainer)."""
    if remat is False or remat is None:
        return None
    if remat is True:
        return 0
    if isinstance(remat, str) and remat.split(":")[0] == "selective":
        k = int(remat.split(":", 1)[1]) if ":" in remat else 8
        if k >= 1:
            return k
    raise ValueError(f"remat={remat!r}: want False, True, 'selective' or "
                     "'selective:k' with k >= 1")


def remat_saved(spec: S.NetworkSpec, k: int) -> set[int]:
    """The layers whose outputs ``remat="selective:k"`` saves: those of
    output area at most max((net.w // k) * (net.h // k), 1), the JAX
    trainer's saved names (sr_object_detection_tpu/train/trainer.py:
    124-133)."""
    cut = max((spec.net.w // k) * (spec.net.h // k), 1)
    return {i for i, l in enumerate(spec.layers)
            if l.out_w and l.out_w * l.out_h <= cut}


class Network(nn.Module):
    """A NetworkSpec bound to torch params (see ``io.convert``).

    ``params``: per-layer dicts of tensors with OIHW conv weights, all
    on one device. ``compute_dtype`` (e.g. ``torch.bfloat16``) runs the
    convs in that dtype as the JAX package's ``compute_dtype`` does.

    bf16 training only, as the JAX compiler (compiler.py:147-203):
    ``phase_train=True`` runs the leading [conv3x3 + BN + leaky, maxpool
    2x2/2] pair through the fused training kernels
    (``kernels/phase_train.py``) when the JAX predicate holds and the
    kernels take the layer's shape; ``phase_train="chain"`` runs the
    leading two pairs (layers 0-3) that way, the second with its input
    gradient. ``fused_stem=True`` runs every later [conv + BN + leaky,
    maxpool 2x2/2] pair as the library conv followed by the fused
    BN/leaky/pool kernels (``kernels/fused_stem.py``). The JAX package's
    batch-128 and VMEM planner gates were TPU rules and are dropped.

    ``trees``: {layer: WordTree} of the ``tree=`` layers, as
    :func:`resolve_trees` finds them; the region layer's group ids live
    on the params' device."""

    def __init__(self, spec: S.NetworkSpec, params, *, compute_dtype=None,
                 phase_train=False, fused_stem: bool = False):
        super().__init__()
        self.spec = spec
        self.compute_dtype = compute_dtype
        self.trees = resolve_trees(spec)
        device = next((v.device for p in params for v in p.values()),
                      torch.device("cpu"))
        self.layers = nn.ModuleList(
            build_layer(l, p, compute_dtype, tree=self.trees.get(i),
                        device=device, time_steps=spec.net.time_steps)
            for i, (l, p) in enumerate(zip(spec.layers, params)))
        self.out_idx = spec.output_layer_index()
        self.phase_pair = self.phase_chain = False
        self.fusable: set[int] = set()
        layers = spec.layers
        self.live = live = live_set(spec)
        bf16 = compute_dtype == torch.bfloat16
        if phase_train and bf16:
            from ..kernels import phase_train as PT
            self.phase_pair = (_phase_pair_ok(layers, 0) and 0 not in live
                               and PT.supported(layers[0]))
            self.phase_chain = (self.phase_pair and phase_train == "chain"
                                and _phase_pair_ok(layers, 2)
                                and not live & {1, 2}
                                and PT.supported_chain(layers[0],
                                                       layers[2]))
        if fused_stem and bf16:
            from ..kernels import fused_stem as FS
            for i, (l, nxt) in enumerate(zip(layers, layers[1:])):
                if (isinstance(l, S.ConvSpec) and l.batch_normalize
                        and l.activation == "leaky" and not l.xnor
                        and not l.binary and isinstance(nxt, S.MaxPoolSpec)
                        and nxt.size == 2 and nxt.stride == 2
                        and nxt.pad == 0 and nxt.h % 2 == 0
                        and nxt.w % 2 == 0 and i not in live
                        and FS.supported(l)):
                    self.fusable.add(i)

    def forward(self, x, keep_all: bool = False, *, train: bool = False,
                params=None, want=None, remat=False, truth=None,
                generator=None, draws=None):
        """x: NHWC input, or a flat (B, inputs) one for a network whose
        first layer reads the flat raster (a char-rnn's one-hot rows).
        Returns (out, aux): out is the output layer's
        tensor in the public layout, aux = {'outputs': {i: tensor}}
        (every layer when ``keep_all``, else only the output layer).

        ``train=True`` runs the training forward (batch-statistics BN with
        darknet's hand-written backward) over ``params`` (default: the
        network's own tensors) and adds aux['bn'] = {i: rolling-stat
        updates}. It runs the layers up to the last index of ``want``
        (default: the output layer), returns that layer's output as out
        and keeps the outputs of ``want`` (of every unit with
        ``keep_all``); ``remat`` (the trainer's option, see
        :meth:`remat_segments`) recomputes the checkpointed segments'
        activations in the backward. With ``truth`` it runs on to the
        last cost layer and adds aux['cost'], the sum of the cost layers'
        losses. Dropout and crop draw from ``generator`` (a CPU
        ``torch.Generator``; default one seeded 0, as the JAX forward's
        default key is 0; dropout draws its mask on x's device from a
        seed it takes there) in layer order, unless ``draws`` holds their
        draw ({layer: keep mask in the port's layout, or (dh, dw,
        flip)}); the draws made are added to ``draws``."""
        if not train:
            cur = x.permute(0, 3, 1, 2) if x.ndim == 4 else x
            saved, kept = {}, {}    # public outputs; NCHW ones read later
            for i, layer in enumerate(self.layers):
                if isinstance(layer, RouteLayer):
                    cur = layer(kept)
                else:
                    if cur.ndim == 2 and _spatial(layer):
                        l = layer.spec
                        cur = L.flat_to_nchw(cur, l.h, l.w, l.c)
                    cur = (layer(cur, kept) if isinstance(layer, ShortcutLayer)
                           else layer(cur))
                if i in self.live:
                    kept[i] = cur
                if keep_all or i == self.out_idx:
                    saved[i] = _to_public(cur)
            return saved[self.out_idx], {"outputs": saved}
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        return self._forward_train(
            x, keep_all, params, want, remat,
            dict(truth=truth, generator=generator,
                 draws={} if draws is None else draws))

    def train_units(self, h: int, w: int):
        """The training forward's units at input height h and width w,
        in order: (first layer, last layer, kind), kind "chain" (layers
        0-3 through ``phase_train_chain2``), "pair" (layers 0-1 through
        ``phase_train_block``), "fused" (a conv and its pool through
        ``fused_stem_block``) or "layer". A unit's output is its last
        layer's; a kernel unit never materializes the others."""
        units, i = [], 0
        if self.phase_chain and h % 4 == 0 and w % 4 == 0:
            units.append((0, 3, "chain"))
            i = 4
        elif self.phase_pair and h % 2 == 0 and w % 2 == 0:
            units.append((0, 1, "pair"))
            i = 2
        while i < len(self.layers):
            if i in self.fusable:
                units.append((i, i + 1, "fused"))
                i += 2
            else:
                units.append((i, i, "layer"))
                i += 1
        return units

    def remat_segments(self, remat, h: int, w: int):
        """The checkpointed segments of ``remat`` at input h x w, each a
        list of consecutive units (:meth:`train_units`). A segment keeps
        its input and its outputs (its last unit's and the live ones
        inside it) for the backward and recomputes everything else there.

        * ``True``: every unit is a segment of its own, so only unit
          outputs are saved, and each conv's BN, bias and leaky
          internals are recomputed;
        * ``"selective:k"``: each run of consecutive units whose outputs
          lie outside :func:`remat_saved` is one segment; on yolov2 and
          tiny-yolo that is the leading layers. A unit counts as its
          last layer, so the fused pair's pooled output counts as layer
          1's, as the JAX compiler names it. Everything else runs as
          without remat."""
        k = remat_divisor(remat)
        units = self.train_units(h, w)
        if k is None:
            return []
        if k == 0:
            return [[u] for u in units]
        saved = remat_saved(self.spec, k)
        return [list(run) for kept, run in itertools.groupby(
            units, key=lambda u: u[1] in saved) if not kept]

    def _run_unit(self, unit, cur, kept, params, rt):
        """One unit on NCHW or flat ``cur`` -> (its output, {i: bn
        update}, [costs]). ``rt``: the forward's truth, generator and
        draws."""
        i, j, kind = unit
        layers = self.spec.layers
        if cur.ndim == 2 and _spatial(self.layers[i]):
            l = layers[i]
            cur = L.flat_to_nchw(cur, l.h, l.w, l.c)
        if kind == "chain":
            # the leading two pairs (compiler.py:219-236 of the JAX
            # package); pair 0's pooled output is not kept
            from ..kernels.phase_train import phase_train_chain2
            pooled, bn0, bn2 = phase_train_chain2(
                cur.permute(0, 2, 3, 1), params[0], layers[0], params[2],
                layers[2])
            return pooled.permute(0, 3, 1, 2), {0: bn0, 2: bn2}, []
        if kind == "pair":
            from ..kernels.phase_train import phase_train_block
            pooled, bn = phase_train_block(cur.permute(0, 2, 3, 1),
                                           params[0], layers[0])
            return pooled.permute(0, 3, 1, 2), {0: bn}, []
        if kind == "fused":
            # conv + fused BN/leaky/pool (compiler.py:255-285 of the JAX
            # package): the conv output is never kept
            from ..kernels.fused_stem import fused_stem_block
            pooled, bn = fused_stem_block(cur, params[i], layers[i])
            return pooled, {i: bn}, []
        l, layer = layers[i], self.layers[i]
        bn = None
        if isinstance(l, S.ConvSpec):
            cur, bn = C.conv_block_train(cur, params[i], l,
                                         compute_dtype=self.compute_dtype)
        elif isinstance(layer, (ConnectedLayer, BatchNormLayer)):
            cur, bn = layer.forward_train(cur, params[i])
        elif isinstance(layer, (DropoutLayer, CropLayer)):
            draws = rt["draws"]
            if i not in draws:
                draws[i] = layer.draw(cur, rt["generator"])
            cur = layer.forward_train(cur, draws[i])
        elif isinstance(layer, (SoftmaxLayer, DetectionLayer)):
            cur = layer(cur, train=True)
        elif isinstance(layer, CostLayer):
            if rt["truth"] is not None:
                return cur, {}, [cost(cur, rt["truth"], l)]
        elif isinstance(layer, RouteLayer):
            cur = layer(kept)
        elif isinstance(layer, ShortcutLayer):
            cur = layer(cur, kept)
        elif isinstance(layer, (LocalLayer, DeconvLayer, _RecurrentLayer)):
            cur = layer.forward_train(cur, params[i])
        else:
            cur = layer(cur)
        return cur, ({} if bn is None else {i: bn}), []

    def _forward_train(self, x, keep_all, params, want, remat, rt):
        if params is None:
            params = [dict(layer.named_buffers()) for layer in self.layers]
        want = {self.out_idx} if want is None else set(want)
        out_i = last = max(want)
        if rt["truth"] is not None:
            last = max([last] + [i for i, l in enumerate(self.spec.layers)
                                 if isinstance(l, S.CostSpec)])
        h, w = (x.shape[1], x.shape[2]) if x.ndim == 4 else (0, 0)
        units = [u for u in self.train_units(h, w) if u[0] <= last]
        inner = [i for i in want if any(u[0] <= i < u[1] for u in units)]
        if inner:
            raise ValueError(f"layers {inner} run inside a kernel unit and "
                             "have no output of their own")
        # consecutive units of one segment run as one checkpointed call
        seg_of = {u: n for n, seg in enumerate(
            self.remat_segments(remat, h, w)) for u in seg}
        groups = []
        for u in units:
            n = seg_of.get(u)
            if groups and n is not None and groups[-1][1] == n:
                groups[-1][0].append(u)
            else:
                groups.append(([u], n))

        def run(group, cur, kept):
            """A group's units -> (last output, live outputs, outputs
            asked for, bn updates, costs): a pure function of its
            arguments, the params and the draws (made on the first run),
            so a checkpoint's recompute gives the same tensors and its
            rolling updates are dropped."""
            live, outs, bn, costs = {}, {}, {}, []
            for u in group:
                cur, upd, c = self._run_unit(u, cur, {**kept, **live},
                                             params, rt)
                bn.update(upd)
                costs += c
                if u[1] in self.live:
                    live[u[1]] = cur
                if keep_all or u[1] in want:
                    outs[u[1]] = cur
            return cur, live, outs, bn, costs

        cur = x.permute(0, 3, 1, 2) if x.ndim == 4 else x
        kept, saved, bn_updates = {}, {}, {}
        costs = []
        for group, n in groups:
            if n is None:
                cur, live, outs, bn, c = run(group, cur, kept)
            else:
                cur, live, outs, bn, c = torch.utils.checkpoint.checkpoint(
                    run, group, cur, kept, use_reentrant=False)
            kept.update(live)
            saved.update({i: _to_public(t) for i, t in outs.items()})
            bn_updates.update(bn)
            costs += c
        aux = {"outputs": saved, "bn": bn_updates}
        if costs:
            aux["cost"] = sum(costs)
        return saved[out_i], aux


__all__ = ["Network", "ConvLayer", "MaxPoolLayer", "RegionLayer",
           "RouteLayer", "ReorgLayer", "ShortcutLayer", "ConnectedLayer",
           "AvgPoolLayer", "DropoutLayer", "CropLayer", "BatchNormLayer",
           "LRNLayer", "ActivationLayer", "SoftmaxLayer", "CostLayer",
           "LocalLayer", "DeconvLayer", "DetectionLayer", "build_layer",
           "cost",
           "live_set", "remat_divisor", "remat_saved", "resolve_trees"]
