"""Typed layer specifications + shape inference: the cfg -> graph front-end.

This is the TPU-native replacement for the reference's cfg parser
(src_yolo2/parser.c:585-700): instead of mutating a ``struct network`` of
``struct layer`` function pointers, we compile the cfg into an immutable
list of :class:`LayerSpec` dataclasses with fully-resolved static shapes.
The back-end (graph/compiler.py) turns that list into a pure
``apply(params, x)`` JAX program.

Shape-inference rules are kept bit-identical to the reference:
  * conv:     out = (in + 2*pad - size)//stride + 1      (convolutional_layer.c:75-83)
  * maxpool:  out = (in + 2*pad)//stride                 (maxpool_layer.c:30-31)
  * reorg:    out = in//stride (or *stride if reverse)   (reorg_layer.c:16-23)
  * route:    channels summed when spatial dims match    (parser.c route path)
  * region:   outputs = h*w*n*(classes+coords+1)         (region_layer.c:28)
  * net batch: batch = batch//subdivisions*time_steps    (parser.c:504-514)
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

from ..config import Section, is_network_section, read_cfg


# ---------------------------------------------------------------------------
# Net-level hyperparameters ([net] section — parser.c parse_net_options)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NetSpec:
    batch: int = 1                 # micro-batch (already / subdivisions * time_steps)
    subdivisions: int = 1
    time_steps: int = 1
    h: int = 0
    w: int = 0
    c: int = 0
    inputs: int = 0
    learning_rate: float = 1e-3
    momentum: float = 0.9
    decay: float = 1e-4
    adam: bool = False
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-6
    max_crop: int = 0
    min_crop: int = 0
    angle: float = 0.0
    aspect: float = 1.0
    saturation: float = 1.0
    exposure: float = 1.0
    hue: float = 0.0
    policy: str = "constant"
    burn_in: int = 0
    step: int = 1
    scale: float = 1.0
    steps: tuple[int, ...] = ()
    scales: tuple[float, ...] = ()
    gamma: float = 1.0
    power: float = 1.0
    max_batches: int = 0


def parse_net_options(s: Section) -> NetSpec:
    batch = s.find_int("batch", 1)
    subdivs = s.find_int("subdivisions", 1)
    time_steps = s.find_int("time_steps", 1)
    batch = batch // subdivs
    batch = batch * time_steps

    h = s.find_int("height", 0)
    w = s.find_int("width", 0)
    c = s.find_int("channels", 0)
    inputs = s.find_int("inputs", h * w * c)
    if not inputs and not (h and w and c):
        raise ValueError("No input parameters supplied in [net] section")

    policy = s.find_str("policy", "constant")
    known = {"random", "poly", "constant", "step", "exp", "sigmoid", "steps"}
    if policy not in known:
        policy = "constant"

    steps: tuple[int, ...] = ()
    scales: tuple[float, ...] = ()
    step = 1
    scale = 1.0
    gamma = 1.0
    power = 1.0
    if policy == "step":
        step = s.find_int("step", 1)
        scale = s.find_float("scale", 1.0)
    elif policy == "steps":
        st = s.find_int_list("steps")
        sc = s.find_float_list("scales")
        if st is None or sc is None:
            raise ValueError("STEPS policy must have steps and scales in cfg")
        steps, scales = tuple(st), tuple(sc)
    elif policy == "exp":
        gamma = s.find_float("gamma", 1.0)
    elif policy == "sigmoid":
        gamma = s.find_float("gamma", 1.0)
        step = s.find_int("step", 1)
    elif policy in ("poly", "random"):
        power = s.find_float("power", 1.0)

    return NetSpec(
        batch=batch,
        subdivisions=subdivs,
        time_steps=time_steps,
        h=h,
        w=w,
        c=c,
        inputs=inputs,
        learning_rate=s.find_float("learning_rate", 1e-3),
        momentum=s.find_float("momentum", 0.9),
        decay=s.find_float("decay", 1e-4),
        adam=bool(s.find_int("adam", 0)),
        b1=s.find_float("B1", 0.9),
        b2=s.find_float("B2", 0.999),
        eps=s.find_float("eps", 1e-6),
        max_crop=s.find_int("max_crop", w * 2),
        min_crop=s.find_int("min_crop", w),
        angle=s.find_float("angle", 0.0),
        aspect=s.find_float("aspect", 1.0),
        saturation=s.find_float("saturation", 1.0),
        exposure=s.find_float("exposure", 1.0),
        hue=s.find_float("hue", 0.0),
        policy=policy,
        burn_in=s.find_int("burn_in", 0),
        step=step,
        scale=scale,
        steps=steps,
        scales=scales,
        gamma=gamma,
        power=power,
        max_batches=s.find_int("max_batches", 0),
    )


# ---------------------------------------------------------------------------
# Layer specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LayerSpec:
    """Base class: every layer records its input and output geometry."""

    index: int
    # input geometry
    h: int = 0
    w: int = 0
    c: int = 0
    inputs: int = 0
    # output geometry
    out_h: int = 0
    out_w: int = 0
    out_c: int = 0
    outputs: int = 0
    dontload: bool = False
    dontloadscales: bool = False

    @property
    def kind(self) -> str:
        return type(self).__name__.removesuffix("Spec").lower()


@dataclass(frozen=True)
class ConvSpec(LayerSpec):
    filters: int = 1
    size: int = 1
    stride: int = 1
    pad: int = 0
    activation: str = "logistic"
    batch_normalize: bool = False
    binary: bool = False
    xnor: bool = False
    flipped: bool = False
    adam: bool = False     # net-level adam flag (parser.c:161: layer.adam)


@dataclass(frozen=True)
class FusedConvPoolSpec(LayerSpec):
    """Inference-only rewrite of [3x3/s1/p1 conv + 2x2/s2 maxpool]:
    a stride-2 4x4 conv producing 4*filters phase channels, followed by
    a max over the 4 pooling phases, then bias+activation. Exact for
    monotonic activations (max commutes). Built by
    infer.engine.optimize_for_inference; never parsed from cfg."""
    filters: int = 1           # ORIGINAL conv filters (output channels)
    activation: str = "leaky"


@dataclass(frozen=True)
class LocalSpec(LayerSpec):
    filters: int = 1
    size: int = 1
    stride: int = 1
    pad: int = 0           # raw cfg flag: out = (in + 2*(size//2 if pad else 0) - ...)
    activation: str = "logistic"


@dataclass(frozen=True)
class DeconvSpec(LayerSpec):
    filters: int = 1
    size: int = 1
    stride: int = 1
    activation: str = "logistic"


@dataclass(frozen=True)
class ConnectedSpec(LayerSpec):
    output: int = 1
    activation: str = "logistic"
    batch_normalize: bool = False


@dataclass(frozen=True)
class MaxPoolSpec(LayerSpec):
    size: int = 1
    stride: int = 1
    pad: int = 0


@dataclass(frozen=True)
class AvgPoolSpec(LayerSpec):
    pass


@dataclass(frozen=True)
class RouteSpec(LayerSpec):
    layers: tuple[int, ...] = ()
    sizes: tuple[int, ...] = ()


@dataclass(frozen=True)
class ShortcutSpec(LayerSpec):
    from_index: int = 0
    activation: str = "linear"
    # geometry of the 'from' layer (needed for stride/sample resampling)
    from_h: int = 0
    from_w: int = 0
    from_c: int = 0


@dataclass(frozen=True)
class ReorgSpec(LayerSpec):
    stride: int = 1
    reverse: bool = False


@dataclass(frozen=True)
class DropoutSpec(LayerSpec):
    probability: float = 0.5


@dataclass(frozen=True)
class CropSpec(LayerSpec):
    crop_h: int = 1
    crop_w: int = 1
    flip: bool = False
    angle: float = 0.0
    saturation: float = 1.0
    exposure: float = 1.0
    shift: float = 0.0
    noadjust: bool = False


@dataclass(frozen=True)
class BatchNormSpec(LayerSpec):
    pass


@dataclass(frozen=True)
class LRNSpec(LayerSpec):
    alpha: float = 1e-4
    beta: float = 0.75
    kappa: float = 1.0
    size: int = 5


@dataclass(frozen=True)
class ActivationSpec(LayerSpec):
    activation: str = "linear"


@dataclass(frozen=True)
class SoftmaxSpec(LayerSpec):
    groups: int = 1
    temperature: float = 1.0
    tree_file: Optional[str] = None


@dataclass(frozen=True)
class CostSpec(LayerSpec):
    cost_type: str = "sse"     # sse | masked | smooth
    scale: float = 1.0
    ratio: float = 0.0


@dataclass(frozen=True)
class RegionSpec(LayerSpec):
    n: int = 1                 # anchors
    classes: int = 20
    coords: int = 4
    anchors: tuple[float, ...] = ()
    softmax: bool = False
    tree_file: Optional[str] = None
    map_file: Optional[str] = None
    log: bool = False
    sqrt: bool = False
    max_boxes: int = 30
    jitter: float = 0.2
    rescore: bool = False
    thresh: float = 0.5
    classfix: int = 0
    absolute: bool = False
    random: bool = False
    coord_scale: float = 1.0
    object_scale: float = 1.0
    noobject_scale: float = 1.0
    class_scale: float = 1.0
    bias_match: bool = False
    # engine-internal (never parsed from cfg): per-anchor channel block
    # of a lane-ALIGNED head layout — [coords+1 fields | pad to 128 |
    # classes | pad] — produced by infer.engine.align_region_head so
    # the (B,H,W,A,block) reshape and the class slice are tile-aligned
    # (0 = darknet-contiguous layout)
    head_block: int = 0
    # engine-internal: emit (fields, class-probs) as SEPARATE tensors
    # instead of reassembling the darknet-flat output — removes three
    # full passes over the class tensor at the engine boundary (the
    # yolo9000 decode wall). Requires head_block != 0.
    presplit: bool = False
    # engine-internal: with presplit, keep the class tensor FLAT as
    # (B, H, W, A*head_block) instead of the (B, H, W, A, classes) 5-D
    # view — the A=3 sublane dim of the 5-D layout forces
    # T(8,128)->T(4,128) retile copies (profiled 7.5 ms of a 52 ms
    # yolo9000-416 B=128 batch). Class probs sit at
    # [a*block+128 : a*block+128+classes] per anchor; the other lanes
    # are junk (see ops.boxes.region_activate_split_flat).
    presplit_flat: bool = False


@dataclass(frozen=True)
class DetectionSpec(LayerSpec):
    n: int = 1
    classes: int = 1
    coords: int = 1
    side: int = 7
    rescore: bool = False
    softmax: bool = False
    sqrt: bool = False
    max_boxes: int = 30
    jitter: float = 0.2
    forced: bool = False
    random: bool = False
    reorg: bool = False
    coord_scale: float = 1.0
    object_scale: float = 1.0
    noobject_scale: float = 1.0
    class_scale: float = 1.0


@dataclass(frozen=True)
class RNNSpec(LayerSpec):
    output: int = 1
    hidden: int = 1
    activation: str = "logistic"
    batch_normalize: bool = False
    logistic: bool = False


@dataclass(frozen=True)
class GRUSpec(LayerSpec):
    output: int = 1
    batch_normalize: bool = False


@dataclass(frozen=True)
class CRNNSpec(LayerSpec):
    output_filters: int = 1
    hidden_filters: int = 1
    activation: str = "logistic"
    batch_normalize: bool = False


# ---------------------------------------------------------------------------
# cfg section -> LayerSpec  (mirrors parser.c parse_* fns)
# ---------------------------------------------------------------------------


_SECTION_ALIASES = {
    "[conv]": "[convolutional]",
    "[conn]": "[connected]",
    "[max]": "[maxpool]",
    "[avg]": "[avgpool]",
    "[lrn]": "[normalization]",
    "[soft]": "[softmax]",
    "[network]": "[net]",
}


def canonical_type(t: str) -> str:
    return _SECTION_ALIASES.get(t, t)


@dataclass(frozen=True)
class NetworkSpec:
    """A fully shape-inferred network: [net] options + ordered layers."""

    net: NetSpec
    layers: tuple[LayerSpec, ...]
    cfg_path: Optional[str] = None

    @property
    def outputs(self) -> int:
        for l in reversed(self.layers):
            if not isinstance(l, CostSpec):
                return l.outputs
        return self.layers[-1].outputs

    def output_layer_index(self) -> int:
        """Index of the layer whose output is 'the network output'.

        Mirrors get_network_output: last non-cost layer (network.c:437-456).
        """
        for i in range(len(self.layers) - 1, -1, -1):
            if not isinstance(self.layers[i], CostSpec):
                return i
        return len(self.layers) - 1

    def resize(self, w: int, h: int) -> "NetworkSpec":
        """Re-infer all shapes at a new input resolution.

        The analog of resize_network (network.c:322-388): because specs are
        immutable and shapes static, 'resizing' is re-compilation at a new
        static shape — the TPU-native answer to random=1 multi-scale.
        """
        net = dataclasses.replace(self.net, w=w, h=h,
                                  inputs=w * h * self.net.c)
        return _infer(net, [(l, _raw_of(l)) for l in self.layers],
                      cfg_path=self.cfg_path)


# Raw per-layer constructor data captured at parse time so resize() can
# re-run inference. For simplicity we stash the original Section on parse.
_RAW_ATTR = "_raw_section"


def _raw_of(l: LayerSpec) -> Section:
    s = getattr(l, _RAW_ATTR, None)
    if s is None:
        raise ValueError(f"layer {l.index} has no raw section; cannot resize")
    return s


def _attach_raw(l: LayerSpec, s: Section) -> LayerSpec:
    object.__setattr__(l, _RAW_ATTR, s)
    return l


def parse_network_cfg(path: str) -> NetworkSpec:
    sections = read_cfg(path)
    return build_network_spec(sections, cfg_path=path)


def build_network_spec(sections: list[Section],
                       cfg_path: Optional[str] = None) -> NetworkSpec:
    if not sections:
        raise ValueError("Config file has no sections")
    first = sections[0]
    if not is_network_section(first):
        raise ValueError("First section must be [net] or [network]")
    net = parse_net_options(first)
    return _infer(net, [(None, s) for s in sections[1:]], cfg_path=cfg_path)


def _infer(net: NetSpec,
           layer_sections: list[tuple[Optional[LayerSpec], Section]],
           cfg_path: Optional[str] = None) -> NetworkSpec:
    """Run the parser.c assembly loop: thread (h,w,c,inputs) through layers."""
    h, w, c, inputs = net.h, net.w, net.c, net.inputs
    layers: list[LayerSpec] = []

    for index, (_, s) in enumerate(layer_sections):
        t = canonical_type(s.type)
        common = dict(index=index, h=h, w=w, c=c, inputs=inputs)
        l: LayerSpec

        if t == "[convolutional]":
            filters = s.find_int("filters", 1)
            size = s.find_int("size", 1)
            stride = s.find_int("stride", 1)
            pad_flag = s.find_int("pad", 0)
            padding = s.find_int("padding", 0)
            if pad_flag:
                padding = size // 2
            if not (h and w and c):
                raise ValueError("Layer before convolutional layer must output image.")
            out_h = (h + 2 * padding - size) // stride + 1
            out_w = (w + 2 * padding - size) // stride + 1
            l = ConvSpec(
                **common,
                filters=filters, size=size, stride=stride, pad=padding,
                activation=s.find_str("activation", "logistic"),
                batch_normalize=bool(s.find_int("batch_normalize", 0)),
                binary=bool(s.find_int("binary", 0)),
                xnor=bool(s.find_int("xnor", 0)),
                flipped=bool(s.find_int("flipped", 0)),
                adam=net.adam,
                out_h=out_h, out_w=out_w, out_c=filters,
                outputs=out_h * out_w * filters,
            )
            s.find("dot")  # parsed-but-unused smoothing knob

        elif t == "[local]":
            filters = s.find_int("filters", 1)
            size = s.find_int("size", 1)
            stride = s.find_int("stride", 1)
            pad_flag = s.find_int("pad", 0)
            if not (h and w and c):
                raise ValueError("Layer before local layer must output image.")
            eff_pad = size // 2 if pad_flag else 0
            out_h = (h + 2 * eff_pad - size) // stride + 1
            out_w = (w + 2 * eff_pad - size) // stride + 1
            l = LocalSpec(
                **common,
                filters=filters, size=size, stride=stride, pad=pad_flag,
                activation=s.find_str("activation", "logistic"),
                out_h=out_h, out_w=out_w, out_c=filters,
                outputs=out_h * out_w * filters,
            )

        elif t == "[deconvolutional]":
            filters = s.find_int("filters", 1)
            size = s.find_int("size", 1)
            stride = s.find_int("stride", 1)
            if not (h and w and c):
                raise ValueError("Layer before deconvolutional layer must output image.")
            # deconvolutional_layer.c: out = stride*(in-1) + size
            out_h = stride * (h - 1) + size
            out_w = stride * (w - 1) + size
            l = DeconvSpec(
                **common,
                filters=filters, size=size, stride=stride,
                activation=s.find_str("activation", "logistic"),
                out_h=out_h, out_w=out_w, out_c=filters,
                outputs=out_h * out_w * filters,
            )

        elif t == "[connected]":
            output = s.find_int("output", 1)
            l = ConnectedSpec(
                **common,
                output=output,
                activation=s.find_str("activation", "logistic"),
                batch_normalize=bool(s.find_int("batch_normalize", 0)),
                out_h=1, out_w=1, out_c=output, outputs=output,
            )

        elif t == "[maxpool]":
            stride = s.find_int("stride", 1)
            size = s.find_int("size", stride)
            padding = s.find_int("padding", (size - 1) // 2)
            if not (h and w and c):
                raise ValueError("Layer before maxpool layer must output image.")
            out_h = (h + 2 * padding) // stride
            out_w = (w + 2 * padding) // stride
            l = MaxPoolSpec(
                **common,
                size=size, stride=stride, pad=padding,
                out_h=out_h, out_w=out_w, out_c=c,
                outputs=out_h * out_w * c,
            )

        elif t == "[avgpool]":
            if not (h and w and c):
                raise ValueError("Layer before avgpool layer must output image.")
            l = AvgPoolSpec(
                **common, out_h=1, out_w=1, out_c=c, outputs=c,
            )

        elif t == "[route]":
            idxs = s.find_int_list("layers")
            if not idxs:
                raise ValueError("Route Layer must specify input layers")
            resolved = tuple(i if i >= 0 else index + i for i in idxs)
            sizes = tuple(layers[i].outputs for i in resolved)
            first_l = layers[resolved[0]]
            out_h, out_w, out_c = first_l.out_h, first_l.out_w, first_l.out_c
            for i in resolved[1:]:
                nxt = layers[i]
                if nxt.out_w == first_l.out_w and nxt.out_h == first_l.out_h:
                    out_c += nxt.out_c
                else:
                    out_h = out_w = out_c = 0
            l = RouteSpec(
                **common,
                layers=resolved, sizes=sizes,
                out_h=out_h, out_w=out_w, out_c=out_c,
                outputs=sum(sizes),
            )

        elif t == "[shortcut]":
            frm = s.find_str("from")
            if frm is None:
                raise ValueError("shortcut layer needs 'from'")
            fi = int(frm)
            if fi < 0:
                fi = index + fi
            from_l = layers[fi]
            l = ShortcutSpec(
                **common,
                from_index=fi,
                activation=s.find_str("activation", "linear"),
                from_h=from_l.out_h, from_w=from_l.out_w, from_c=from_l.out_c,
                out_h=h, out_w=w, out_c=c, outputs=h * w * c,
            )

        elif t == "[reorg]":
            stride = s.find_int("stride", 1)
            reverse = bool(s.find_int("reverse", 0))
            if not (h and w and c):
                raise ValueError("Layer before reorg layer must output image.")
            if reverse:
                out_h, out_w, out_c = h * stride, w * stride, c // (stride * stride)
            else:
                out_h, out_w, out_c = h // stride, w // stride, c * stride * stride
            l = ReorgSpec(
                **common,
                stride=stride, reverse=reverse,
                out_h=out_h, out_w=out_w, out_c=out_c,
                outputs=out_h * out_w * out_c,
            )

        elif t == "[dropout]":
            l = DropoutSpec(
                **common,
                probability=s.find_float("probability", 0.5),
                out_h=h, out_w=w, out_c=c, outputs=inputs,
            )

        elif t == "[crop]":
            crop_h = s.find_int("crop_height", 1)
            crop_w = s.find_int("crop_width", 1)
            if not (h and w and c):
                raise ValueError("Layer before crop layer must output image.")
            l = CropSpec(
                **common,
                crop_h=crop_h, crop_w=crop_w,
                flip=bool(s.find_int("flip", 0)),
                angle=s.find_float("angle", 0.0),
                saturation=s.find_float("saturation", 1.0),
                exposure=s.find_float("exposure", 1.0),
                shift=s.find_float("shift", 0.0),
                noadjust=bool(s.find_int("noadjust", 0)),
                out_h=crop_h, out_w=crop_w, out_c=c,
                outputs=crop_h * crop_w * c,
            )

        elif t == "[batchnorm]":
            l = BatchNormSpec(
                **common, out_h=h, out_w=w, out_c=c, outputs=h * w * c,
            )

        elif t == "[normalization]":
            l = LRNSpec(
                **common,
                alpha=s.find_float("alpha", 1e-4),
                beta=s.find_float("beta", 0.75),
                kappa=s.find_float("kappa", 1.0),
                size=s.find_int("size", 5),
                out_h=h, out_w=w, out_c=c, outputs=h * w * c,
            )

        elif t == "[activation]":
            l = ActivationSpec(
                **common,
                activation=s.find_str("activation", "linear"),
                out_h=h, out_w=w, out_c=c, outputs=inputs,
            )

        elif t == "[softmax]":
            groups = s.find_int("groups", 1)
            if inputs % groups != 0:
                raise ValueError("softmax inputs must divide groups")
            l = SoftmaxSpec(
                **common,
                groups=groups,
                temperature=s.find_float("temperature", 1.0),
                tree_file=s.find_str("tree"),
                out_h=h, out_w=w, out_c=c, outputs=inputs,
            )

        elif t == "[cost]":
            l = CostSpec(
                **common,
                cost_type=s.find_str("type", "sse"),
                scale=s.find_float("scale", 1.0),
                ratio=s.find_float("ratio", 0.0),
                out_h=h, out_w=w, out_c=c, outputs=inputs,
            )

        elif t == "[region]":
            coords = s.find_int("coords", 4)
            classes = s.find_int("classes", 20)
            num = s.find_int("num", 1)
            outputs = h * w * num * (classes + coords + 1)
            if outputs != inputs:
                raise ValueError(
                    f"region layer size mismatch: {outputs} != {inputs}")
            anchors = s.find_float_list("anchors")
            if anchors is None:
                anchors = [0.5] * (num * 2)
            l = RegionSpec(
                **common,
                n=num, classes=classes, coords=coords,
                anchors=tuple(anchors),
                softmax=bool(s.find_int("softmax", 0)),
                tree_file=s.find_str("tree"),
                map_file=s.find_str("map"),
                log=bool(s.find_int("log", 0)),
                sqrt=bool(s.find_int("sqrt", 0)),
                max_boxes=s.find_int("max", 30),
                jitter=s.find_float("jitter", 0.2),
                rescore=bool(s.find_int("rescore", 0)),
                thresh=s.find_float("thresh", 0.5),
                classfix=s.find_int("classfix", 0),
                absolute=bool(s.find_int("absolute", 0)),
                random=bool(s.find_int("random", 0)),
                coord_scale=s.find_float("coord_scale", 1.0),
                object_scale=s.find_float("object_scale", 1.0),
                noobject_scale=s.find_float("noobject_scale", 1.0),
                class_scale=s.find_float("class_scale", 1.0),
                bias_match=bool(s.find_int("bias_match", 0)),
                out_h=h, out_w=w, out_c=num * (classes + coords + 1),
                outputs=outputs,
            )

        elif t == "[detection]":
            coords = s.find_int("coords", 1)
            classes = s.find_int("classes", 1)
            num = s.find_int("num", 1)
            side = s.find_int("side", 7)
            # detection_layer.c:27 asserts this decomposition of the input
            if side * side * ((1 + coords) * num + classes) != inputs:
                raise ValueError("detection layer size mismatch")
            outputs = inputs
            l = DetectionSpec(
                **common,
                n=num, classes=classes, coords=coords, side=side,
                rescore=bool(s.find_int("rescore", 0)),
                softmax=bool(s.find_int("softmax", 0)),
                sqrt=bool(s.find_int("sqrt", 0)),
                max_boxes=s.find_int("max", 30),
                jitter=s.find_float("jitter", 0.2),
                forced=bool(s.find_int("forced", 0)),
                random=bool(s.find_int("random", 0)),
                reorg=bool(s.find_int("reorg", 0)),
                coord_scale=s.find_float("coord_scale", 1.0),
                object_scale=s.find_float("object_scale", 1.0),
                noobject_scale=s.find_float("noobject_scale", 1.0),
                class_scale=s.find_float("class_scale", 1.0),
                out_h=1, out_w=1, out_c=outputs, outputs=outputs,
            )

        elif t == "[rnn]":
            output = s.find_int("output", 1)
            hidden = s.find_int("hidden", 1)
            l = RNNSpec(
                **common,
                output=output, hidden=hidden,
                activation=s.find_str("activation", "logistic"),
                batch_normalize=bool(s.find_int("batch_normalize", 0)),
                logistic=bool(s.find_int("logistic", 0)),
                out_h=1, out_w=1, out_c=output, outputs=output,
            )
            s.find("shortcut")

        elif t == "[gru]":
            output = s.find_int("output", 1)
            l = GRUSpec(
                **common,
                output=output,
                batch_normalize=bool(s.find_int("batch_normalize", 0)),
                out_h=1, out_w=1, out_c=output, outputs=output,
            )

        elif t == "[crnn]":
            output_filters = s.find_int("output_filters", 1)
            hidden_filters = s.find_int("hidden_filters", 1)
            l = CRNNSpec(
                **common,
                output_filters=output_filters,
                hidden_filters=hidden_filters,
                activation=s.find_str("activation", "logistic"),
                batch_normalize=bool(s.find_int("batch_normalize", 0)),
                out_h=h, out_w=w, out_c=output_filters,
                outputs=output_filters * h * w,
            )
            s.find("shortcut")

        else:
            raise ValueError(f"Type not recognized: {s.type}")

        l = dataclasses.replace(
            l,
            dontload=bool(s.find_int("dontload", 0)),
            dontloadscales=bool(s.find_int("dontloadscales", 0)),
        )
        _attach_raw(l, s)
        layers.append(l)

        # thread geometry to the next layer (parser.c:692-698)
        h, w, c, inputs = l.out_h, l.out_w, l.out_c, l.outputs

    # option_unused analog (parser.c:671): warn on unrecognized keys
    import sys as _sys
    for _, sec in layer_sections:
        for k in sec.unused_keys():
            print(f"Warning: unused cfg option: {sec.type} {k}",
                  file=_sys.stderr)
    return NetworkSpec(net=net, layers=tuple(layers), cfg_path=cfg_path)


__all__ = [
    "NetSpec", "NetworkSpec", "LayerSpec",
    "ConvSpec", "LocalSpec", "DeconvSpec", "ConnectedSpec",
    "MaxPoolSpec", "AvgPoolSpec", "RouteSpec", "ShortcutSpec", "ReorgSpec",
    "DropoutSpec", "CropSpec", "BatchNormSpec", "LRNSpec", "ActivationSpec",
    "SoftmaxSpec", "CostSpec", "RegionSpec", "DetectionSpec",
    "RNNSpec", "GRUSpec", "CRNNSpec",
    "parse_net_options", "parse_network_cfg", "build_network_spec",
]
