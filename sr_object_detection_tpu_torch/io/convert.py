"""numpy params (the JAX package's layout) -> the port's torch tensors.

``io/weights.py`` (a verbatim copy of the JAX package's reader) returns
one dict per layer with conv weights in HWIO. The port runs its convs
through ``F.conv2d``, which wants OIHW, so conv weights are transposed
here once, at load.

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
    (Cout,Cin,3,3); every other array keeps its shape. Returns a new
    list of dicts ({} for parameterless layers)."""
    if not isinstance(spec, S.NetworkSpec):
        # a spec built by the JAX package has other classes, and every
        # isinstance test below would silently fail
        raise TypeError(f"want this package's NetworkSpec, got "
                        f"{type(spec).__module__}.{type(spec).__name__}")

    out: list[dict] = []
    for l, p in zip(spec.layers, params_np):
        q = {}
        for k, v in p.items():
            a = np.asarray(v, np.float32)
            if k == "weights" and isinstance(l, S.ConvSpec):
                a = np.transpose(a, (3, 2, 0, 1))
            q[k] = torch.from_numpy(np.ascontiguousarray(a)).to(
                device=device, dtype=dtype)
        out.append(q)
    return out


__all__ = ["params_to_torch"]
