"""cfg graph -> torch ``nn.Module``.

Counterpart of ``sr_object_detection_tpu/graph/compiler.py``
(``CompiledNetwork`` / ``build_forward``). :class:`Network` wraps a
``NetworkSpec`` and one module per layer; PyTorch runs it eagerly.

Layouts: the input is NHWC like the JAX package's, the layers pass NCHW
between them (``F.conv2d``'s native layout), and every tensor that leaves
the network is converted back — spatial outputs as NHWC, the region
output as the flat darknet raster ``[row][col][anchor][field]``
(compiler.py:417-424 of the JAX package).

This slice holds the kinds tiny-yolo-voc runs: conv, maxpool and region.
Any other kind raises ``NotImplementedError`` when the network is built,
naming the ROADMAP queue item that ports it.
"""

from __future__ import annotations

from torch import nn

from . import spec as S
from ..ops import activations as A
from ..ops import boxes as B
from ..ops import conv as C
from ..ops import pooling as P

# kinds that come with the apps slice (ROADMAP queue 1, item 10); every
# other kind not built here comes with the graph builder (item 3)
_APPS_KINDS = (S.DetectionSpec, S.RNNSpec, S.GRUSpec, S.CRNNSpec)


class ConvLayer(nn.Module):
    """conv [+BN] + bias + activation; buffers hold OIHW weights."""

    def __init__(self, spec: S.ConvSpec, params: dict, compute_dtype=None):
        super().__init__()
        if spec.xnor or spec.binary:
            raise NotImplementedError(
                f"layer {spec.index}: XNOR/binary convs are not ported yet "
                "(ROADMAP queue 1, item 2)")
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


class RegionLayer(nn.Module):
    """NCHW head output -> flat (B, H*W*A*F) activated region output."""

    def __init__(self, spec: S.RegionSpec):
        super().__init__()
        if spec.tree_file is not None:
            raise NotImplementedError(
                f"layer {spec.index}: WordTree region heads are not "
                "ported yet (ROADMAP queue 1, item 4)")
        if spec.head_block or spec.presplit:
            raise NotImplementedError(
                f"layer {spec.index}: aligned/pre-split region heads are "
                "not ported yet (ROADMAP queue 1, item 5)")
        self.spec = spec

    def forward(self, x):
        l = self.spec
        nhwc = x.permute(0, 2, 3, 1)
        acts = B.region_activate(nhwc, l.n, l.coords + l.classes + 1,
                                 softmax=l.softmax)
        return acts.reshape(acts.shape[0], -1)


def build_layer(l: S.LayerSpec, params: dict, compute_dtype=None):
    if isinstance(l, S.ConvSpec):
        return ConvLayer(l, params, compute_dtype)
    if isinstance(l, S.MaxPoolSpec):
        return MaxPoolLayer(l)
    if isinstance(l, S.RegionSpec):
        return RegionLayer(l)
    item = 10 if isinstance(l, _APPS_KINDS) else 3
    raise NotImplementedError(
        f"layer {l.index} ({l.kind}) is not ported yet (ROADMAP queue 1, "
        f"item {item})")


def _to_public(t):
    """NCHW -> NHWC for a spatial tensor; flat tensors pass through."""
    return t.permute(0, 2, 3, 1) if t.ndim == 4 else t


class Network(nn.Module):
    """A NetworkSpec bound to torch params (see ``io.convert``).

    ``params``: per-layer dicts of tensors with OIHW conv weights, all
    on one device. ``compute_dtype`` (e.g. ``torch.bfloat16``) runs the
    convs in that dtype as the JAX package's ``compute_dtype`` does."""

    def __init__(self, spec: S.NetworkSpec, params, *, compute_dtype=None):
        super().__init__()
        self.spec = spec
        self.compute_dtype = compute_dtype
        self.layers = nn.ModuleList(
            build_layer(l, p, compute_dtype)
            for l, p in zip(spec.layers, params))
        self.out_idx = spec.output_layer_index()

    def forward(self, x, keep_all: bool = False):
        """x: NHWC input. Returns (out, aux): out is the output layer's
        tensor in the public layout, aux = {'outputs': {i: tensor}}
        (every layer when ``keep_all``, else only the output layer)."""
        cur = x.permute(0, 3, 1, 2)
        saved = {}
        for i, layer in enumerate(self.layers):
            cur = layer(cur)
            if keep_all or i == self.out_idx:
                saved[i] = _to_public(cur)
        return saved[self.out_idx], {"outputs": saved}


__all__ = ["Network", "ConvLayer", "MaxPoolLayer", "RegionLayer",
           "build_layer"]
