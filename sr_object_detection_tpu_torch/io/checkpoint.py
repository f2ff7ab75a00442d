"""Checkpoint / resume for training state.

Counterpart of ``sr_object_detection_tpu/io/checkpoint.py``, in the same
two formats (SURVEY §5.4):
  * ``.weights`` export — the bit-compatible interchange format (weights
    + seen counter; the reference's .backup cadence, detector.c:150-157);
  * ``.npz`` train-state checkpoints carrying params + momentum velocity
    + seen, in the JAX package's layout (keys ``p/<layer>/<name>``,
    ``v/<layer>/<name>``, a recurrent sublayer's
    ``p/<layer>/<sublayer>/<name>``, ``seen``; conv weights HWIO), so a
    state saved by either package loads in the other.

The port's params hold conv weights OIHW, deconv weights (Cin, Cout, k,
k) and local weights (locations, n, c*k*k), so the train-state
checkpoints take the network's spec and convert every layer as
``io.convert`` does.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from ..graph import spec as S
from .convert import flat, params_to_numpy, params_to_torch
from .weights import save_weights


def save_train_state(path: str, state, spec: S.NetworkSpec):
    """state: train.trainer.TrainState of a network of ``spec``. Written
    to a temporary file and renamed, so a crash never leaves a
    half-written checkpoint."""
    arrays = {}
    for tag, tree in (("p", state.params), ("v", state.velocity)):
        for i, p in enumerate(params_to_numpy(spec, tree)):
            for k, v in flat(p).items():
                arrays[_key(tag, i, k)] = v
    arrays["seen"] = np.asarray(int(state.seen), np.int64)
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz")
    os.close(fd)
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def load_train_state(path: str, template_state, spec: S.NetworkSpec):
    """Restore into the structure, device and dtypes of template_state,
    a state of a network of ``spec``."""
    from ..train.trainer import TrainState
    z = np.load(path)

    def rebuild(tag, tree):
        arrays = [{k: z[_key(tag, i, k)] for k in p}
                  for i, p in enumerate(tree)]
        dev = next((t.device for p in tree for t in p.values()), "cpu")
        return [{k: v.to(dtype=p[k].dtype) for k, v in q.items()}
                for p, q in zip(tree, params_to_torch(spec, arrays, dev))]

    return TrainState(params=rebuild("p", template_state.params),
                      velocity=rebuild("v", template_state.velocity),
                      seen=torch.tensor(int(z["seen"]), dtype=torch.int64))


def _key(tag: str, i: int, k: str) -> str:
    """``<tag>/<layer>/<name>``; a sublayer's ``<sublayer>.<name>`` key
    is ``<tag>/<layer>/<sublayer>/<name>``, as in the JAX package."""
    return f"{tag}/{i}/{k.replace('.', '/')}"


def export_weights(path: str, spec: S.NetworkSpec, state):
    """Write the interchange .weights with the live seen counter."""
    save_weights(spec, params_to_numpy(spec, state.params), path,
                 seen=int(state.seen))


def checkpoint_name(backup_dir: str, base: str, batch_num: int,
                    final: bool = False) -> str:
    """The reference's naming scheme (detector.c:150-165):
    <base>_<N>.weights every 1000 (100 below 1000), <base>_final.weights."""
    if final:
        return os.path.join(backup_dir, f"{base}_final.weights")
    return os.path.join(backup_dir, f"{base}_{batch_num}.weights")


def should_checkpoint(batch_num: int) -> bool:
    """detector.c:150: every 1000 iters, every 100 below 1000."""
    if batch_num >= 1000:
        return batch_num % 1000 == 0
    return batch_num % 100 == 0


__all__ = ["save_train_state", "load_train_state", "export_weights",
           "checkpoint_name", "should_checkpoint"]
