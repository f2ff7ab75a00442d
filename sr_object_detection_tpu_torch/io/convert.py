"""numpy params (the JAX package's layout) <-> the port's torch tensors.

``io/weights.py`` (a verbatim copy of the JAX package's reader) returns
one dict per layer with conv weights in HWIO. The port runs its convs
through ``F.conv2d``, which wants OIHW, so conv weights are transposed
here once, at load. A deconv's HWIO (size, size, c, filters) weights
become the (c, filters, size, size) that ``F.conv_transpose2d`` reads,
unflipped (``graph.compiler.DeconvLayer``), and a local layer's flat
weights the (locations, filters, c*size*size) of darknet's
``[locations][n][c*size*size]`` order. Connected weights keep darknet's
(outputs, inputs), and BN parameters their (C,). Each conversion is a
reshape or a transpose, so the round trip is exact.

The recurrent kinds hold one dict per sublayer in the JAX package's
``io/weights.py`` layout: an RNN ``{"input", "self", "output"}`` and a
GRU ``{"input_z", "input_r", "input_h", "state_z", "state_r",
"state_h"}`` of connected parameters, a CRNN ``{"input", "self",
"output"}`` of 3x3 conv parameters whose HWIO weights go to OIHW. The
port keeps them flat, one ``<sublayer>.<name>`` key a tensor (what
``named_buffers()`` yields for the compiler's recurrent layer), so only
this module nests and un-nests them.

Every array is cast to float32 FIRST: ``init_params`` returns float64
conv weights (a float64 numpy scale times a float32 draw), and the JAX
package's ``jnp.asarray`` silently narrows them to float32 — the port
does the same narrowing explicitly before any further cast.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph import spec as S


def params_to_torch(spec: S.NetworkSpec, params_np, device,
                    dtype=torch.float32) -> list[dict]:
    """Convert a per-layer list of numpy param dicts to torch tensors.

    Conv layers' ``weights`` go from HWIO (3,3,Cin,Cout) to OIHW
    (Cout,Cin,3,3), a deconv's to (Cin, Cout, kh, kw) and a local
    layer's to (locations, filters, c*size*size); every other array
    keeps its shape, and a recurrent layer's sublayer dicts become
    ``<sublayer>.<name>`` keys (:func:`flat`). Returns a new list of
    dicts ({} for parameterless layers)."""
    if not isinstance(spec, S.NetworkSpec):
        # a spec built by the JAX package has other classes, and every
        # isinstance test below would silently fail
        raise TypeError(f"want this package's NetworkSpec, got "
                        f"{type(spec).__module__}.{type(spec).__name__}")

    out: list[dict] = []
    for l, p in zip(spec.layers, params_np):
        q = {}
        for k, v in flat(p).items():
            a = np.asarray(v, np.float32)
            if _is_conv_weights(l, k):
                a = np.transpose(a, (3, 2, 0, 1))
            elif k == "weights" and isinstance(l, S.DeconvSpec):
                a = np.transpose(a, (2, 3, 0, 1))
            elif k == "weights" and isinstance(l, S.LocalSpec):
                a = a.reshape(l.out_h * l.out_w, l.filters, -1)
            q[k] = torch.from_numpy(np.ascontiguousarray(a)).to(
                device=device, dtype=dtype)
        out.append(q)
    return out


def params_to_numpy(spec: S.NetworkSpec, params) -> list[dict]:
    """The inverse of :func:`params_to_torch`: torch tensors (any device
    and float dtype) -> float32 numpy arrays, conv and deconv ``weights``
    back to HWIO, a local layer's flat again, a recurrent layer's
    sublayers nested again."""
    if not isinstance(spec, S.NetworkSpec):
        raise TypeError(f"want this package's NetworkSpec, got "
                        f"{type(spec).__module__}.{type(spec).__name__}")
    out: list[dict] = []
    for l, p in zip(spec.layers, params):
        q = {}
        for k, v in p.items():
            a = v.detach().to("cpu", torch.float32).numpy()
            if _is_conv_weights(l, k):
                a = np.transpose(a, (2, 3, 1, 0))
            elif k == "weights" and isinstance(l, S.DeconvSpec):
                a = np.transpose(a, (2, 3, 0, 1))
            elif k == "weights" and isinstance(l, S.LocalSpec):
                a = a.reshape(-1)
            q[k] = np.ascontiguousarray(a)
        out.append(_nest(q))
    return out


def _is_conv_weights(l, k: str) -> bool:
    return (k == "weights" and isinstance(l, S.ConvSpec)) or (
        k.endswith(".weights") and isinstance(l, S.CRNNSpec))


def flat(p: dict) -> dict:
    """One layer's params with each sublayer's dict spread into
    ``<sublayer>.<name>`` keys (the port's layout)."""
    out = {}
    for k, v in p.items():
        if isinstance(v, dict):
            out.update({f"{k}.{name}": a for name, a in v.items()})
        else:
            out[k] = v
    return out


def _nest(p: dict) -> dict:
    """The inverse of :func:`flat`."""
    out = {}
    for k, v in p.items():
        sub, dot, name = k.partition(".")
        if dot:
            out.setdefault(sub, {})[name] = v
        else:
            out[k] = v
    return out


__all__ = ["params_to_torch", "params_to_numpy", "flat"]
