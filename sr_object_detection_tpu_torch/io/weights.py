"""Bit-compatible darknet ``.weights`` reader/writer + parameter init.

The ``.weights`` binary is the pretrained-model interchange format of the
reference (src_yolo2/parser.c:822-1087):

  header: int32 major, int32 minor, int32 revision,
          then ``seen``: uint64 if major*10+minor >= 2 else int32
  per layer, in network order, float32 raw arrays:
    convolutional: biases[n], [scales[n], rolling_mean[n],
                   rolling_var[n] if batch_normalize], weights[n*c*k*k]
                   (OIHW raster)
    connected:     biases[out], weights[out*in] (+transpose if
                   major>1000||minor>1000), [bn triplet]
    batchnorm:     scales[c], rolling_mean[c], rolling_var[c]
    rnn:           3x connected (input, self, output)
    gru:           6x connected (input_z, input_r, input_h,
                   state_z, state_r, state_h)
    crnn:          3x convolutional (input, self, output)
    local:         biases[outputs], weights[size^2*c*n*locations]

We store parameters as a per-layer list of pytrees with TPU-friendly
layouts (conv HWIO, NHWC activations) and convert at the I/O boundary.
Saving writes header (0,1,0) + int32 seen exactly like
save_weights_upto (parser.c:831-839).
"""

from __future__ import annotations

import struct
from typing import BinaryIO

import numpy as np

from ..graph import spec as S


class WeightsReader:
    def __init__(self, f: BinaryIO):
        self.f = f

    def floats(self, n: int) -> np.ndarray:
        buf = self.f.read(4 * n)
        if len(buf) != 4 * n:
            raise EOFError(f"weights file truncated: wanted {n} floats")
        return np.frombuffer(buf, dtype="<f4").copy()

    def read(self, n: int) -> bytes:
        buf = self.f.read(n)
        if len(buf) != n:
            raise EOFError(f"weights file truncated: wanted {n} bytes")
        return buf


def _conv_from_darknet(w_flat: np.ndarray, spec) -> np.ndarray:
    """OIHW raster -> HWIO (for lax.conv NHWC/HWIO)."""
    w = w_flat.reshape(spec.filters, spec.c, spec.size, spec.size)
    return np.transpose(w, (2, 3, 1, 0)).copy()


def _conv_to_darknet(w_hwio: np.ndarray) -> np.ndarray:
    return np.transpose(np.asarray(w_hwio, np.float32), (3, 2, 0, 1)).ravel()


def _load_conv(r: WeightsReader, spec: S.ConvSpec | S.CRNNSpec,
               *, filters: int, c: int, size: int,
               batch_normalize: bool, dontloadscales: bool,
               flipped: bool, adam: bool = False) -> dict:
    p: dict = {}
    p["biases"] = r.floats(filters)
    if batch_normalize and not dontloadscales:
        p["scales"] = r.floats(filters)
        p["rolling_mean"] = r.floats(filters)
        p["rolling_variance"] = r.floats(filters)
    elif batch_normalize:
        p["scales"] = np.ones(filters, np.float32)
        p["rolling_mean"] = np.zeros(filters, np.float32)
        p["rolling_variance"] = np.ones(filters, np.float32)
    w = r.floats(filters * c * size * size)
    if flipped:
        # parser.c:997-999: transpose_matrix(weights, c*size*size, n)
        w = w.reshape(c * size * size, filters).T.ravel().copy()
    w4 = w.reshape(filters, c, size, size)
    p["weights"] = np.transpose(w4, (2, 3, 1, 0)).copy()
    if adam:
        # parser.c:1001-1004: adam first/second moments follow weights
        num = filters * c * size * size
        p["adam_m"] = r.floats(num)
        p["adam_v"] = r.floats(num)
    return p


def _load_connected(r: WeightsReader, *, outputs: int, inputs: int,
                    batch_normalize: bool, dontloadscales: bool,
                    transpose: bool) -> dict:
    p: dict = {}
    p["biases"] = r.floats(outputs)
    w = r.floats(outputs * inputs)
    if transpose:
        # parser.c:897-901: stored as (inputs, outputs), transpose to
        # the modern (outputs, inputs) layout
        w = w.reshape(inputs, outputs).T.ravel().copy()
    p["weights"] = w.reshape(outputs, inputs)
    if batch_normalize and not dontloadscales:
        p["scales"] = r.floats(outputs)
        p["rolling_mean"] = r.floats(outputs)
        p["rolling_variance"] = r.floats(outputs)
    elif batch_normalize:
        p["scales"] = np.ones(outputs, np.float32)
        p["rolling_mean"] = np.zeros(outputs, np.float32)
        p["rolling_variance"] = np.ones(outputs, np.float32)
    return p


def load_weights(net: S.NetworkSpec, path: str, cutoff: int | None = None):
    """Read a .weights file into (params_list, seen).

    params_list[i] is a dict pytree for layer i ({} for parameterless
    layers). Mirrors load_weights_upto (parser.c:1007-1083).
    """
    # dontload layers keep their random initialization (the reference
    # simply skips them in load_weights_upto, parser.c:1018, leaving
    # make_*_layer's init in place) — an empty dict would KeyError on
    # the first forward pass.
    if any(l.dontload for l in net.layers):
        fallback = init_params(net)
        params: list[dict] = [fallback[i] if l.dontload else dict()
                              for i, l in enumerate(net.layers)]
    else:
        params = [dict() for _ in net.layers]
    with open(path, "rb") as f:
        major, minor, revision = struct.unpack("<iii", f.read(12))
        if major * 10 + minor >= 2:
            (seen,) = struct.unpack("<Q", f.read(8))
        else:
            (seen,) = struct.unpack("<i", f.read(4))
        transpose = (major > 1000) or (minor > 1000)
        r = WeightsReader(f)

        n = len(net.layers) if cutoff is None else min(cutoff, len(net.layers))
        for i in range(n):
            l = net.layers[i]
            if l.dontload:
                continue
            if isinstance(l, S.ConvSpec):
                params[i] = _load_conv(
                    r, l, filters=l.filters, c=l.c, size=l.size,
                    batch_normalize=l.batch_normalize,
                    dontloadscales=l.dontloadscales, flipped=l.flipped,
                    adam=getattr(l, "adam", False))
            elif isinstance(l, S.ConnectedSpec):
                params[i] = _load_connected(
                    r, outputs=l.output, inputs=l.inputs,
                    batch_normalize=l.batch_normalize,
                    dontloadscales=l.dontloadscales, transpose=transpose)
            elif isinstance(l, S.BatchNormSpec):
                params[i] = {
                    "scales": r.floats(l.c),
                    "rolling_mean": r.floats(l.c),
                    "rolling_variance": r.floats(l.c),
                }
            elif isinstance(l, S.CRNNSpec):
                sub = {}
                for name, (cin, cout) in _crnn_sublayer_dims(l).items():
                    sub[name] = _load_conv(
                        r, l, filters=cout, c=cin, size=3,
                        batch_normalize=l.batch_normalize,
                        dontloadscales=l.dontloadscales, flipped=False)
                params[i] = sub
            elif isinstance(l, S.RNNSpec):
                dims = _rnn_sublayer_dims(l)
                params[i] = {
                    name: _load_connected(
                        r, outputs=o, inputs=inp,
                        batch_normalize=l.batch_normalize,
                        dontloadscales=l.dontloadscales, transpose=transpose)
                    for name, (inp, o) in dims.items()
                }
            elif isinstance(l, S.GRUSpec):
                dims = _gru_sublayer_dims(l)
                params[i] = {
                    name: _load_connected(
                        r, outputs=o, inputs=inp,
                        batch_normalize=l.batch_normalize,
                        dontloadscales=l.dontloadscales, transpose=transpose)
                    for name, (inp, o) in dims.items()
                }
            elif isinstance(l, S.LocalSpec):
                locations = l.out_w * l.out_h
                size = l.size * l.size * l.c * l.filters * locations
                params[i] = {
                    "biases": r.floats(l.outputs),
                    "weights": r.floats(size),
                }
            elif isinstance(l, S.DeconvSpec):
                # our own format (see save_weights): biases then
                # weights in (c, n, size, size) order -> HWIO
                b = r.floats(l.filters)
                w = r.floats(l.c * l.filters * l.size * l.size)
                params[i] = {
                    "biases": b,
                    "weights": np.transpose(
                        w.reshape(l.c, l.filters, l.size, l.size),
                        (2, 3, 0, 1)).copy(),
                }
    return params, seen


def _rnn_sublayer_dims(l: S.RNNSpec) -> dict[str, tuple[int, int]]:
    # rnn_layer.c:29-52: input(inputs->hidden), self(hidden->hidden),
    # output(hidden->output)
    return {
        "input": (l.inputs, l.hidden),
        "self": (l.hidden, l.hidden),
        "output": (l.hidden, l.output),
    }


def _gru_sublayer_dims(l: S.GRUSpec) -> dict[str, tuple[int, int]]:
    # gru_layer.c: z/r/h input (inputs->output) + state (output->output),
    # save order input_z,input_r,input_h,state_z,state_r,state_h
    # (parser.c save_weights GRU block)
    return {
        "input_z": (l.inputs, l.output),
        "input_r": (l.inputs, l.output),
        "input_h": (l.inputs, l.output),
        "state_z": (l.output, l.output),
        "state_r": (l.output, l.output),
        "state_h": (l.output, l.output),
    }


def _crnn_sublayer_dims(l: S.CRNNSpec) -> dict[str, tuple[int, int]]:
    # crnn_layer.c: input(c->hidden,3x3), self(hidden->hidden,3x3),
    # output(hidden->output,3x3) — all size-3 pad-1 stride-1 convs
    return {
        "input": (l.c, l.hidden_filters),
        "self": (l.hidden_filters, l.hidden_filters),
        "output": (l.hidden_filters, l.output_filters),
    }


def _save_conv(out: list[np.ndarray], p: dict, batch_normalize: bool):
    out.append(np.asarray(p["biases"], np.float32))
    if batch_normalize:
        out.append(np.asarray(p["scales"], np.float32))
        out.append(np.asarray(p["rolling_mean"], np.float32))
        out.append(np.asarray(p["rolling_variance"], np.float32))
    out.append(_conv_to_darknet(p["weights"]))
    if "adam_m" in p:
        out.append(np.asarray(p["adam_m"], np.float32))
        out.append(np.asarray(p["adam_v"], np.float32))


def _save_connected(out: list[np.ndarray], p: dict, batch_normalize: bool):
    out.append(np.asarray(p["biases"], np.float32))
    out.append(np.asarray(p["weights"], np.float32).ravel())
    if batch_normalize:
        out.append(np.asarray(p["scales"], np.float32))
        out.append(np.asarray(p["rolling_mean"], np.float32))
        out.append(np.asarray(p["rolling_variance"], np.float32))


def pack_binary_conv(p: dict, *, batch_normalize: bool) -> bytes:
    """XNOR bit-packed conv weights
    (save_convolutional_weights_binary, parser.c:737-766 — dead code
    upstream, the call sites are commented out): biases [+ BN triple],
    then per filter one f32 |mean| followed by size//8 bytes of sign
    bits (bit k = weight > 0). QUIRK kept: the integer division drops
    the trailing size%8 weights entirely — they are neither saved nor
    restored."""
    w = np.asarray(p["weights"], np.float32)           # HWIO
    n = w.shape[-1]
    size = w.shape[0] * w.shape[1] * w.shape[2]
    flat = np.transpose(w, (3, 2, 0, 1)).reshape(n, size)  # (n, c*s*s)
    mean = np.mean(np.abs(flat), axis=1).astype(np.float32)
    out = [np.asarray(p["biases"], np.float32).tobytes()]
    if batch_normalize:
        for k in ("scales", "rolling_mean", "rolling_variance"):
            out.append(np.asarray(p[k], np.float32).tobytes())
    nbytes = size // 8
    bits = (flat[:, :nbytes * 8] > 0).reshape(n, nbytes, 8)
    packed = np.sum(bits.astype(np.uint8)
                    << np.arange(8, dtype=np.uint8), axis=2,
                    dtype=np.uint8)                    # LSB-first, :761
    for i in range(n):
        out.append(mean[i:i + 1].tobytes())
        out.append(packed[i].tobytes())
    return b"".join(out)


def unpack_binary_conv(r: "WeightsReader", spec, *,
                       batch_normalize: bool) -> dict:
    """load_convolutional_weights_binary (parser.c:933-961): weights
    reconstructed as ±mean per sign bit; the trailing size%8 weights
    per filter are left at zero (the reference leaves them at whatever
    init memory held)."""
    n, c, size = spec.filters, spec.c, spec.size
    p = {"biases": r.floats(n)}
    if batch_normalize:
        p["scales"] = r.floats(n)
        p["rolling_mean"] = r.floats(n)
        p["rolling_variance"] = r.floats(n)
    ksize = size * size * c
    nbytes = ksize // 8
    flat = np.zeros((n, ksize), np.float32)
    for i in range(n):
        mean = r.floats(1)[0]
        raw = np.frombuffer(r.read(nbytes), np.uint8)
        bits = ((raw[:, None] >> np.arange(8)) & 1).astype(bool)
        flat[i, :nbytes * 8] = np.where(bits.reshape(-1), mean, -mean)
    p["weights"] = np.transpose(
        flat.reshape(n, c, size, size), (2, 3, 1, 0)).copy()
    return p


def save_weights(net: S.NetworkSpec, params: list[dict], path: str,
                 seen: int = 0, cutoff: int | None = None):
    """Write .weights bit-compatible with save_weights_upto
    (parser.c:822-882): header (0,1,0) + int32 seen."""
    chunks: list[np.ndarray] = []
    n = len(net.layers) if cutoff is None else min(cutoff, len(net.layers))
    for i in range(n):
        l = net.layers[i]
        p = params[i]
        if isinstance(l, S.ConvSpec):
            _save_conv(chunks, p, l.batch_normalize)
        elif isinstance(l, S.ConnectedSpec):
            _save_connected(chunks, p, l.batch_normalize)
        elif isinstance(l, S.BatchNormSpec):
            chunks.append(np.asarray(p["scales"], np.float32))
            chunks.append(np.asarray(p["rolling_mean"], np.float32))
            chunks.append(np.asarray(p["rolling_variance"], np.float32))
        elif isinstance(l, S.RNNSpec):
            for name in ("input", "self", "output"):
                _save_connected(chunks, p[name], l.batch_normalize)
        elif isinstance(l, S.GRUSpec):
            for name in ("input_z", "input_r", "input_h",
                         "state_z", "state_r", "state_h"):
                _save_connected(chunks, p[name], l.batch_normalize)
        elif isinstance(l, S.CRNNSpec):
            for name in ("input", "self", "output"):
                _save_conv(chunks, p[name], l.batch_normalize)
        elif isinstance(l, S.LocalSpec):
            chunks.append(np.asarray(p["biases"], np.float32))
            chunks.append(np.asarray(p["weights"], np.float32).ravel())
        elif isinstance(l, S.DeconvSpec):
            # no upstream format exists (parser.c never saves/loads
            # DECONVOLUTIONAL); ours mirrors the conv convention with
            # the layer's natural (c, n, size, size) weight order
            chunks.append(np.asarray(p["biases"], np.float32))
            chunks.append(np.transpose(
                np.asarray(p["weights"], np.float32),
                (2, 3, 0, 1)).ravel())
    with open(path, "wb") as f:
        f.write(struct.pack("<iii", 0, 1, 0))
        f.write(struct.pack("<i", int(seen) & 0x7FFFFFFF))
        for c in chunks:
            f.write(c.astype("<f4").tobytes())


# ---------------------------------------------------------------------------
# Random init (darknet formulas)
# ---------------------------------------------------------------------------


def _rand_uniform(rng: np.random.Generator, lo, hi, n) -> np.ndarray:
    return rng.uniform(lo, hi, size=n).astype(np.float32)


def fast_init_params(net: S.NetworkSpec, seed: int = 0) -> list[dict]:
    """Structure-identical to init_params but float32-native RNG — NOT
    darknet-RNG-exact (goldens must keep init_params). For big models
    (yolo9000: ~50M params) the exact path's float64 uniform + astype +
    copy costs minutes on a throttled host; this is a single f32 pass.
    """
    rng = np.random.default_rng(seed)
    params: list[dict] = []

    def fill(p):
        out = {}
        for k, v in p.items():
            if isinstance(v, dict):
                out[k] = fill(v)
            elif k in ("weights",):
                out[k] = (0.05 * rng.standard_normal(
                    v.shape, dtype=np.float32) if hasattr(v, "shape")
                    else v)
            else:
                out[k] = v
        return out

    # build shapes from the exact initializer's structure per layer but
    # without paying its RNG cost: zero-filled template via dtype-only
    # allocation, then one fast f32 fill for weight tensors
    template = _param_template(net)
    for p in template:
        params.append(fill(p) if p else p)
    return params


def _param_template(net: S.NetworkSpec) -> list[dict]:
    """Zero-cost param skeleton: same keys/shapes as init_params, all
    zeros/ones (no RNG)."""
    z, o = np.zeros, np.ones

    def conv(filters, c, size, bn):
        p = {"weights": z((size, size, c, filters), np.float32),
             "biases": z(filters, np.float32)}
        if bn:
            p["scales"] = o(filters, np.float32)
            p["rolling_mean"] = z(filters, np.float32)
            p["rolling_variance"] = o(filters, np.float32)
        return p

    def conn(inputs, outputs, bn):
        p = {"weights": z((outputs, inputs), np.float32),
             "biases": z(outputs, np.float32)}
        if bn:
            p["scales"] = o(outputs, np.float32)
            p["rolling_mean"] = z(outputs, np.float32)
            p["rolling_variance"] = o(outputs, np.float32)
        return p

    params: list[dict] = []
    for l in net.layers:
        if isinstance(l, S.ConvSpec):
            params.append(conv(l.filters, l.c, l.size, l.batch_normalize))
        elif isinstance(l, S.ConnectedSpec):
            params.append(conn(l.inputs, l.output, l.batch_normalize))
        elif isinstance(l, S.BatchNormSpec):
            params.append({"scales": o(l.c, np.float32),
                           "rolling_mean": z(l.c, np.float32),
                           "rolling_variance": o(l.c, np.float32)})
        elif isinstance(l, S.CRNNSpec):
            params.append({name: conv(cout, cin, 3, l.batch_normalize)
                           for name, (cin, cout)
                           in _crnn_sublayer_dims(l).items()})
        elif isinstance(l, S.RNNSpec):
            params.append({name: conn(i, o_, l.batch_normalize)
                           for name, (i, o_)
                           in _rnn_sublayer_dims(l).items()})
        elif isinstance(l, S.GRUSpec):
            params.append({name: conn(i, o_, l.batch_normalize)
                           for name, (i, o_)
                           in _gru_sublayer_dims(l).items()})
        elif isinstance(l, S.LocalSpec):
            n = l.size * l.size * l.c * l.filters * l.out_w * l.out_h
            params.append({"weights": z(n, np.float32),
                           "biases": z(l.outputs, np.float32)})
        elif isinstance(l, S.DeconvSpec):
            params.append(conv(l.filters, l.c, l.size, False))
        else:
            params.append({})
    return params


def _init_conv(rng, *, filters, c, size, batch_normalize) -> dict:
    # convolutional_layer.c:207-208: scale = sqrt(2/(size*size*c)),
    # weights = scale * U(-1, 1)
    scale = np.sqrt(2.0 / (size * size * c))
    w = (scale * _rand_uniform(rng, -1, 1, filters * c * size * size))
    p = {
        "weights": np.transpose(
            w.reshape(filters, c, size, size), (2, 3, 1, 0)).copy(),
        "biases": np.zeros(filters, np.float32),
    }
    if batch_normalize:
        p["scales"] = np.ones(filters, np.float32)
        p["rolling_mean"] = np.zeros(filters, np.float32)
        p["rolling_variance"] = np.ones(filters, np.float32)
    return p


def _init_connected(rng, *, inputs, outputs, batch_normalize) -> dict:
    # connected_layer.c:44-47: scale = sqrt(2/inputs), U(-1,1)
    scale = np.sqrt(2.0 / inputs)
    p = {
        "weights": (scale * _rand_uniform(rng, -1, 1, outputs * inputs)
                    ).reshape(outputs, inputs),
        "biases": np.zeros(outputs, np.float32),
    }
    if batch_normalize:
        p["scales"] = np.ones(outputs, np.float32)
        p["rolling_mean"] = np.zeros(outputs, np.float32)
        p["rolling_variance"] = np.ones(outputs, np.float32)
    return p


def init_params(net: S.NetworkSpec, seed: int = 0) -> list[dict]:
    """Random init for every parameterized layer (darknet formulas)."""
    rng = np.random.default_rng(seed)
    params: list[dict] = []
    for l in net.layers:
        if isinstance(l, S.ConvSpec):
            params.append(_init_conv(
                rng, filters=l.filters, c=l.c, size=l.size,
                batch_normalize=l.batch_normalize))
        elif isinstance(l, S.ConnectedSpec):
            params.append(_init_connected(
                rng, inputs=l.inputs, outputs=l.output,
                batch_normalize=l.batch_normalize))
        elif isinstance(l, S.BatchNormSpec):
            params.append({
                "scales": np.ones(l.c, np.float32),
                "rolling_mean": np.zeros(l.c, np.float32),
                "rolling_variance": np.ones(l.c, np.float32),
            })
        elif isinstance(l, S.RNNSpec):
            params.append({
                name: _init_connected(rng, inputs=inp, outputs=o,
                                      batch_normalize=l.batch_normalize)
                for name, (inp, o) in _rnn_sublayer_dims(l).items()})
        elif isinstance(l, S.GRUSpec):
            params.append({
                name: _init_connected(rng, inputs=inp, outputs=o,
                                      batch_normalize=l.batch_normalize)
                for name, (inp, o) in _gru_sublayer_dims(l).items()})
        elif isinstance(l, S.CRNNSpec):
            params.append({
                name: _init_conv(rng, filters=cout, c=cin, size=3,
                                 batch_normalize=l.batch_normalize)
                for name, (cin, cout) in _crnn_sublayer_dims(l).items()})
        elif isinstance(l, S.LocalSpec):
            locations = l.out_w * l.out_h
            size = l.size * l.size * l.c * l.filters * locations
            scale = np.sqrt(2.0 / (l.size * l.size * l.c))
            params.append({
                "weights": scale * _rand_uniform(rng, -1, 1, size),
                "biases": np.zeros(l.outputs, np.float32),
            })
        elif isinstance(l, S.DeconvSpec):
            scale = np.sqrt(2.0 / (l.size * l.size * l.c))
            w = scale * _rand_uniform(
                rng, -1, 1, l.filters * l.c * l.size * l.size)
            params.append({
                "weights": np.transpose(
                    w.reshape(l.filters, l.c, l.size, l.size),
                    (2, 3, 1, 0)).copy(),
                "biases": np.zeros(l.filters, np.float32),
            })
        else:
            params.append({})
    return params


__all__ = ["load_weights", "save_weights", "init_params",
           "fast_init_params", "pack_binary_conv", "unpack_binary_conv"]
