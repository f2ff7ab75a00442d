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
reorg and shortcut their backwards. Any other kind raises
``NotImplementedError`` when the network is built, naming the ROADMAP
queue item that ports it.
"""

from __future__ import annotations

import itertools
import os
from typing import Optional

import torch
import torch.utils.checkpoint
from torch import nn

from . import spec as S
from ..io.tree import WordTree, read_tree
from ..ops import activations as A
from ..ops import boxes as B
from ..ops import conv as C
from ..ops import layout as L
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
    """Channel concat of earlier NCHW outputs (``forward(outputs)``)."""

    def __init__(self, spec: S.RouteSpec):
        super().__init__()
        if spec.out_c <= 0:
            raise NotImplementedError(
                f"layer {spec.index}: a route of flat outputs is not "
                "ported yet (ROADMAP queue 1, item 3)")
        self.spec = spec

    def forward(self, outputs):
        return L.route([outputs[j] for j in self.spec.layers], dim=1)


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


def build_layer(l: S.LayerSpec, params: dict, compute_dtype=None, *,
                tree: Optional[WordTree] = None, device="cpu"):
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
    item = 10 if isinstance(l, _APPS_KINDS) else 3
    raise NotImplementedError(
        f"layer {l.index} ({l.kind}) is not ported yet (ROADMAP queue 1, "
        f"item {item})")


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
                        device=device)
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
                params=None, want=None, remat=False):
        """x: NHWC input. Returns (out, aux): out is the output layer's
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
        activations in the backward."""
        if not train:
            cur = x.permute(0, 3, 1, 2)
            saved, kept = {}, {}    # public outputs; NCHW ones read later
            for i, layer in enumerate(self.layers):
                if isinstance(layer, RouteLayer):
                    cur = layer(kept)
                elif isinstance(layer, ShortcutLayer):
                    cur = layer(cur, kept)
                else:
                    cur = layer(cur)
                if i in self.live:
                    kept[i] = cur
                if keep_all or i == self.out_idx:
                    saved[i] = _to_public(cur)
            return saved[self.out_idx], {"outputs": saved}
        return self._forward_train(x, keep_all, params, want, remat)

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

    def _run_unit(self, unit, cur, kept, params):
        """One unit on NCHW ``cur`` -> (its NCHW output, {i: bn update})."""
        i, j, kind = unit
        layers = self.spec.layers
        if kind == "chain":
            # the leading two pairs (compiler.py:219-236 of the JAX
            # package); pair 0's pooled output is not kept
            from ..kernels.phase_train import phase_train_chain2
            pooled, bn0, bn2 = phase_train_chain2(
                cur.permute(0, 2, 3, 1), params[0], layers[0], params[2],
                layers[2])
            return pooled.permute(0, 3, 1, 2), {0: bn0, 2: bn2}
        if kind == "pair":
            from ..kernels.phase_train import phase_train_block
            pooled, bn = phase_train_block(cur.permute(0, 2, 3, 1),
                                           params[0], layers[0])
            return pooled.permute(0, 3, 1, 2), {0: bn}
        if kind == "fused":
            # conv + fused BN/leaky/pool (compiler.py:255-285 of the JAX
            # package): the conv output is never kept
            from ..kernels.fused_stem import fused_stem_block
            pooled, bn = fused_stem_block(cur, params[i], layers[i])
            return pooled, {i: bn}
        l, layer = layers[i], self.layers[i]
        if isinstance(l, S.ConvSpec):
            cur, bn = C.conv_block_train(cur, params[i], l,
                                         compute_dtype=self.compute_dtype)
            return cur, ({} if bn is None else {i: bn})
        if isinstance(layer, RouteLayer):
            return layer(kept), {}
        if isinstance(layer, ShortcutLayer):
            return layer(cur, kept), {}
        return layer(cur), {}

    def _forward_train(self, x, keep_all, params, want, remat):
        if params is None:
            params = [dict(layer.named_buffers()) for layer in self.layers]
        want = {self.out_idx} if want is None else set(want)
        last = max(want)
        units = [u for u in self.train_units(x.shape[1], x.shape[2])
                 if u[0] <= last]
        inner = [i for i in want if any(u[0] <= i < u[1] for u in units)]
        if inner:
            raise ValueError(f"layers {inner} run inside a kernel unit and "
                             "have no output of their own")
        # consecutive units of one segment run as one checkpointed call
        seg_of = {u: n for n, seg in enumerate(
            self.remat_segments(remat, x.shape[1], x.shape[2]))
            for u in seg}
        groups = []
        for u in units:
            n = seg_of.get(u)
            if groups and n is not None and groups[-1][1] == n:
                groups[-1][0].append(u)
            else:
                groups.append(([u], n))

        def run(group, cur, kept):
            """A group's units -> (last output, live outputs, outputs
            asked for, bn updates): a pure function of its arguments and
            the params, so a checkpoint's recompute gives the same
            tensors and its rolling updates are dropped."""
            live, outs, bn = {}, {}, {}
            for u in group:
                cur, upd = self._run_unit(u, cur, {**kept, **live}, params)
                bn.update(upd)
                if u[1] in self.live:
                    live[u[1]] = cur
                if keep_all or u[1] in want:
                    outs[u[1]] = cur
            return cur, live, outs, bn

        cur, kept, saved, bn_updates = x.permute(0, 3, 1, 2), {}, {}, {}
        for group, n in groups:
            if n is None:
                cur, live, outs, bn = run(group, cur, kept)
            else:
                cur, live, outs, bn = torch.utils.checkpoint.checkpoint(
                    run, group, cur, kept, use_reentrant=False)
            kept.update(live)
            saved.update({i: _to_public(t) for i, t in outs.items()})
            bn_updates.update(bn)
        return saved[last], {"outputs": saved, "bn": bn_updates}


__all__ = ["Network", "ConvLayer", "MaxPoolLayer", "RegionLayer",
           "RouteLayer", "ReorgLayer", "ShortcutLayer", "build_layer",
           "live_set", "remat_divisor", "remat_saved", "resolve_trees"]
