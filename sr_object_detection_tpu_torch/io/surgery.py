"""Weight-surgery tools: the analogs of darknet.c's offline commands
(average:42, oneoff:133, partial:158, rescale_net:170, rgbgr_net:188,
normalize_net:247, denormalize_net:309).

Counterpart of ``sr_object_detection_tpu/io/surgery.py``: the same numpy
functions on the port's own spec and weights modules, with
``denormalize_net``'s BN fold written in numpy.
"""

from __future__ import annotations

import numpy as np

from ..graph import spec as S
from ..ops.conv import BN_EPS
from .weights import load_weights, save_weights


def partial(spec: S.NetworkSpec, params, out_path: str, cutoff: int):
    """Truncate a checkpoint at `cutoff` layers for transfer learning
    (darknet.c:158-167 — saves with seen=0)."""
    save_weights(spec, params, out_path, seen=0, cutoff=cutoff)


def average(spec: S.NetworkSpec, weight_paths: list[str], out_path: str):
    """Ensemble-average N checkpoints of the same architecture
    (darknet.c:42-96)."""
    if not weight_paths:
        raise ValueError("need at least one weights file")
    acc, _ = load_weights(spec, weight_paths[0])
    for p in weight_paths[1:]:
        nxt, _ = load_weights(spec, p)
        acc = _tree_add(acc, nxt)
    n = len(weight_paths)
    acc = _tree_scale(acc, 1.0 / n)
    save_weights(spec, acc, out_path, seen=0)
    return acc


def _tree_add(a, b):
    if isinstance(a, dict):
        return {k: _tree_add(a[k], b[k]) for k in a}
    if isinstance(a, list):
        return [_tree_add(x, y) for x, y in zip(a, b)]
    return a + b


def _tree_scale(a, s):
    if isinstance(a, dict):
        return {k: _tree_scale(v, s) for k, v in a.items()}
    if isinstance(a, list):
        return [_tree_scale(x, s) for x in a]
    return a * s


def rescale_net(params, spec: S.NetworkSpec):
    """rescale_net (darknet.c:170-186): rescale_weights(2, -.5) on the
    FIRST conv layer only, so a [0,1]-trained first layer accepts
    [-1,1]-style inputs."""
    return rescale(params, spec, 2.0, -0.5)


def rescale(params, spec: S.NetworkSpec, a: float, trans: float):
    """rescale_weights (convolutional_layer.c:550-561): for the first
    conv layer's 3-channel filters, w *= a, then
    bias += trans * sum(SCALED filter weights)."""
    out = list(params)
    for i, l in enumerate(spec.layers):
        if isinstance(l, S.ConvSpec) and out[i]:
            p = dict(out[i])
            w = np.asarray(p["weights"])           # HWIO
            if w.shape[2] == 3:                    # im.c == 3 gate
                w = w * a
                sums = w.sum(axis=(0, 1, 2))       # per out-channel
                p["weights"] = w
                p["biases"] = np.asarray(p["biases"]) + trans * sums
                out[i] = p
            break                                  # first conv only
    return out


def rgbgr_net(params, spec: S.NetworkSpec):
    """Swap R<->B in the first conv's input channels (darknet.c:188-200,
    rgbgr_weights) so BGR frames can feed an RGB-trained net."""
    out = list(params)
    for i, l in enumerate(spec.layers):
        if isinstance(l, S.ConvSpec) and out[i]:
            p = dict(out[i])
            w = np.asarray(p["weights"])           # HWIO, I==3
            p["weights"] = w[:, :, ::-1, :].copy()
            out[i] = p
            break
    return out


def denormalize_net(params, spec: S.NetworkSpec):
    """Fold BN into weights/biases on every BN conv/connected layer
    (darknet.c:309-344). Returns (params, spec) with BN flags cleared.
    The conv branch is the JAX package's fold_batchnorm
    (ops/conv.py:366-378) in numpy float32, whose sqrt is correctly
    rounded: inv = scales / (sqrt(var) + BN_EPS)."""
    import dataclasses
    new_params, new_layers = [], []
    for l, p in zip(spec.layers, params):
        if isinstance(l, (S.ConvSpec, S.ConnectedSpec)) and p and \
                getattr(l, "batch_normalize", False):
            if isinstance(l, S.ConvSpec):
                p = _fold_batchnorm(p)
            else:
                scales = np.asarray(p["scales"])
                mean = np.asarray(p["rolling_mean"])
                var = np.asarray(p["rolling_variance"])
                inv = scales / (np.sqrt(var) + 1e-6)
                p = {"weights": np.asarray(p["weights"]) * inv[:, None],
                     "biases": np.asarray(p["biases"]) - mean * inv}
            l = dataclasses.replace(l, batch_normalize=False)
        new_params.append(p)
        new_layers.append(l)
    return new_params, S.NetworkSpec(net=spec.net, layers=tuple(new_layers),
                                     cfg_path=spec.cfg_path)


def _fold_batchnorm(params):
    """fold_batchnorm (convolutional_layer.c:321-334) on float32 numpy
    params: a dict with only 'weights' (HWIO) and 'biases'."""
    scales = np.asarray(params["scales"], np.float32)
    mean = np.asarray(params["rolling_mean"], np.float32)
    var = np.asarray(params["rolling_variance"], np.float32)
    inv = scales / (np.sqrt(var) + np.float32(BN_EPS))
    w = np.asarray(params["weights"], np.float32) * inv[None, None, None, :]
    b = np.asarray(params["biases"], np.float32) - mean * inv
    return {"weights": w, "biases": b}


def normalize_net(params, spec: S.NetworkSpec):
    """Insert identity BN stats on conv/connected layers
    (darknet.c:247-307) so a folded net can be fine-tuned with BN."""
    import dataclasses
    new_params, new_layers = [], []
    for l, p in zip(spec.layers, params):
        if isinstance(l, (S.ConvSpec, S.ConnectedSpec)) and p and \
                not getattr(l, "batch_normalize", False):
            n = l.filters if isinstance(l, S.ConvSpec) else l.output
            p = dict(p)
            p["scales"] = np.ones(n, np.float32)
            p["rolling_mean"] = np.zeros(n, np.float32)
            p["rolling_variance"] = np.ones(n, np.float32)
            l = dataclasses.replace(l, batch_normalize=True)
        new_params.append(p)
        new_layers.append(l)
    return new_params, S.NetworkSpec(net=spec.net, layers=tuple(new_layers),
                                     cfg_path=spec.cfg_path)


def statistics(params, spec: S.NetworkSpec):
    """Per-layer weight statistics (darknet.c 'statistics' command /
    statistics_connected_layer)."""
    rows = []
    for i, (l, p) in enumerate(zip(spec.layers, params)):
        if p and "weights" in p:
            w = np.asarray(p["weights"])
            rows.append({"layer": i, "kind": l.kind, "shape": w.shape,
                         "mean": float(w.mean()), "std": float(w.std()),
                         "min": float(w.min()), "max": float(w.max())})
    return rows


__all__ = ["partial", "average", "rescale", "rescale_net", "rgbgr_net",
           "denormalize_net", "normalize_net", "statistics"]


def transfer(src_params, src_spec, dst_spec, dst_params):
    """Copy shape-matching layer weights from one net into another —
    the generalized form of the reference's ad-hoc 'oneoff' transfer
    surgery (darknet.c:133-156): layers whose parameter shapes agree
    are copied; everything else keeps the destination's init."""
    out = []
    copied = 0
    for i, dp in enumerate(dst_params):
        if i < len(src_params) and src_params[i] and dp:
            sp = src_params[i]
            if all(k in sp and np.shape(sp[k]) == np.shape(dp[k])
                   for k in dp):
                out.append({k: np.asarray(sp[k]).copy() for k in dp})
                copied += 1
                continue
        out.append(dp)
    return out, copied


def reset_normalize_net(params, spec: S.NetworkSpec):
    """'reset' command (darknet.c:206-232): fold BN statistics into the
    weights (denormalize_convolutional/connected_layer) but KEEP the BN
    structure with identity stats — unlike denormalize_net which strips
    BN from the graph."""
    out = []
    for l, p in zip(spec.layers, params):
        if isinstance(l, (S.ConvSpec, S.ConnectedSpec)) and p and \
                getattr(l, "batch_normalize", False):
            p = dict(p)
            scales = np.asarray(p["scales"])
            mean = np.asarray(p["rolling_mean"])
            var = np.asarray(p["rolling_variance"])
            inv = scales / (np.sqrt(var) + 1e-6)
            w = np.asarray(p["weights"])
            if isinstance(l, S.ConvSpec):
                p["weights"] = w * inv[None, None, None, :]
            else:
                p["weights"] = w * inv[:, None]
            p["biases"] = np.asarray(p["biases"]) - mean * inv
            n = len(scales)
            p["scales"] = np.ones(n, np.float32)
            p["rolling_mean"] = np.zeros(n, np.float32)
            p["rolling_variance"] = np.ones(n, np.float32)
        out.append(p)
    return out
