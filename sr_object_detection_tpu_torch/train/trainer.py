"""Training driver: the train step with subdivision accumulation, LR
schedules and the SGD update.

Counterpart of ``sr_object_detection_tpu/train/trainer.py`` (the analog
of train_network / update_network, src_yolo2/network.c:225-306): one
step runs ``subdivisions`` micro-batches, sums their gradients, and
makes one darknet SGD update. PyTorch runs eagerly, so the JAX step's
``lax.scan`` over micro-batches is a Python loop; the BN rolling
statistics are carried from one micro-batch to the next as the scan
carries them (the reference's sequential cadence,
batchnorm_layer.c:133-136, pinned by ``train_region_bn_subdiv.npz``).

The bf16 step takes the JAX trainer's kernel options: ``phase_train``
(False, True for the fused leading pair, "chain" for the leading two
pairs) and ``fused_stem`` (the fused BN/leaky/pool kernels on every later
conv + maxpool pair); ``graph/compiler.Network`` says how they combine.
``remat`` (False, True, "selective" or "selective:k", the JAX trainer's
modes) recomputes activations in the backward through
``torch.utils.checkpoint``; ``Network.remat_segments`` says which.

Not ported here: ``mesh`` (ROADMAP queue 1, item 11), the detection and
cost heads (queue 1, item 10) and ``make_multi_step`` (a scan-dispatch
experiment that lost in the JAX package; ROADMAP "Not ported").
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch

from ..graph import spec as S
from ..graph.compiler import Network, remat_divisor
from ..io.convert import params_to_torch
from ..io.weights import init_params
from .region_loss import make_region_loss
from .sgd import init_velocity, learning_rate, sgd_update

_ROLLING = ("rolling_mean", "rolling_variance")


@dataclasses.dataclass
class TrainState:
    params: Any          # per-layer dicts of tensors, OIHW conv weights
    velocity: Any        # same structure
    seen: torch.Tensor   # images seen, int64 on the host

    def batch_num(self, net: S.NetSpec):
        return int(self.seen) // (net.batch * net.subdivisions)


def _find_head(spec: S.NetworkSpec):
    for i, l in enumerate(spec.layers):
        if isinstance(l, S.RegionSpec):
            return i
        if isinstance(l, (S.DetectionSpec, S.CostSpec)):
            raise NotImplementedError(
                f"training a {l.kind} head is not ported yet (ROADMAP queue "
                "1, item 10)")
    raise ValueError("no trainable head (region/detection/cost) in network")


def _class_map(spec: S.NetworkSpec, head):
    if not head.map_file:
        return None
    from ..config import read_map
    candidates = [head.map_file]
    if spec.cfg_path:
        candidates.append(os.path.join(
            os.path.dirname(os.path.abspath(spec.cfg_path)),
            os.path.basename(head.map_file)))
    for cand in candidates:
        if os.path.exists(cand):
            return read_map(cand)
    return None


def make_train_step(spec: S.NetworkSpec, *, mesh=None, compute_dtype=None,
                    remat=False, fused_stem: bool = False,
                    phase_train=False):
    """Returns train_step(state, x, truth) -> (state, metrics).

    x: (B, H, W, C) float32 or bf16 NHWC on the state's device, where
    B = net.batch * net.subdivisions; truth: (B, 30, 5). The metrics are
    0-d tensors on the device (reading one waits for the step).

    ``remat``: False, True (every layer's internals recomputed in the
    backward, only layer outputs saved) or "selective[:k]" (the leading
    layers whose outputs the JAX trainer's policy does not save run as
    one checkpointed segment; k = 8 by default). The recompute runs the
    same kernels on the same inputs, and the BN rolling updates come
    from the first run only."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh training is not ported yet (ROADMAP queue 1, item 11)")
    remat_divisor(remat)
    net = spec.net
    head_idx = _find_head(spec)
    head = spec.layers[head_idx]
    _, loss_with_stats = make_region_loss(
        head, class_map=_class_map(spec, head))
    micro, subdivs = net.batch, net.subdivisions
    holder = {}

    def _network(params):
        # the layers' buffers are never read in train mode (the step
        # passes its params), so one Network per step function will do
        if "net" not in holder:
            holder["net"] = Network(spec, params, compute_dtype=compute_dtype,
                                    phase_train=phase_train,
                                    fused_stem=fused_stem)
        return holder["net"]

    def train_step(state: TrainState, x, truth):
        network = _network(state.params)
        xs = x.reshape(subdivs, micro, *x.shape[1:])
        ts = truth.reshape(subdivs, micro, *truth.shape[1:])
        seen = int(state.seen)
        bn_carry: dict = {}
        grads_acc = None
        costs, stats_all = [], []
        for m in range(subdivs):
            leaves = []
            params = []
            for i, p in enumerate(state.params):
                q = {}
                for k, v in p.items():
                    if k in _ROLLING:
                        q[k] = bn_carry.get(i, {}).get(k, v)
                    else:
                        q[k] = v.detach().requires_grad_(True)
                        leaves.append((i, k, q[k]))
                params.append(q)
            raw, aux = network(xs[m], train=True, params=params,
                               want=(head_idx - 1,), remat=remat)
            raw = raw.reshape(raw.shape[0], -1).float()
            cost, stats = loss_with_stats(raw, ts[m], seen)
            grads = torch.autograd.grad(cost, [t for _, _, t in leaves])
            if grads_acc is None:
                grads_acc = [dict() for _ in state.params]
                for (i, k, _), g in zip(leaves, grads):
                    grads_acc[i][k] = g
            else:
                for (i, k, _), g in zip(leaves, grads):
                    grads_acc[i][k] = grads_acc[i][k] + g
            bn_carry = aux["bn"]
            seen += micro
            costs.append(cost.detach())
            stats_all.append(stats)
        batch_num = seen // (micro * subdivs)
        lr = learning_rate(net, batch_num)
        with torch.no_grad():
            new_params, new_vel = sgd_update(
                state.params, grads_acc, state.velocity, lr=lr,
                batch_size=micro * subdivs, momentum=net.momentum,
                decay=net.decay)
        for i, upd in bn_carry.items():
            new_params[i] = {**new_params[i],
                             **{k: v.detach() for k, v in upd.items()}}
        metrics = {"loss": torch.stack(costs).sum(), "lr": lr,
                   "batch_num": batch_num}
        for k in ("avg_iou", "recall", "avg_obj", "avg_anyobj", "count"):
            metrics[k] = torch.stack(
                [s[k].float() for s in stats_all]).mean()
        return (TrainState(new_params, new_vel,
                           torch.tensor(seen, dtype=torch.int64)), metrics)

    return train_step


class Trainer:
    """High-level loop: the analog of train_detector's step
    (src_yolo2/detector.c:25-168), single device.

    ``params``: numpy params in the JAX package's layout (HWIO), as
    ``io.weights.load_weights`` / ``init_params`` return them (default:
    ``init_params(spec, seed)``). ``device`` defaults to CUDA; the tests
    pass "cpu"."""

    def __init__(self, spec: S.NetworkSpec, params=None, *, device="cuda",
                 mesh=None, seed: int = 0, compute_dtype=None,
                 remat=False, fused_stem: bool = False,
                 phase_train=False):
        self.spec = spec
        self.device = torch.device(device)
        if params is None:
            params = init_params(spec, seed=seed)
        tparams = params_to_torch(spec, params, self.device)
        self.state = TrainState(tparams, init_velocity(tparams),
                                torch.tensor(0, dtype=torch.int64))
        self._kw = dict(mesh=mesh, compute_dtype=compute_dtype, remat=remat,
                        fused_stem=fused_stem, phase_train=phase_train)
        self._steps: dict = {}
        self._steps[(spec.net.h, spec.net.w)] = make_train_step(
            spec, **self._kw)

    def _step_for(self, h: int, w: int):
        """Multi-scale training (detector.c:91-109 resize_network): one
        step function per resolution, sharing the same state."""
        key = (h, w)
        if key not in self._steps:
            self._steps[key] = make_train_step(self.spec.resize(w, h),
                                               **self._kw)
        return self._steps[key]

    def step(self, x, truth):
        """x: (B, H, W, C) float32 or bf16 NHWC (numpy or tensor); truth
        (B, 30, 5). Returns the step's metrics."""
        x = torch.as_tensor(x).to(self.device)
        truth = torch.as_tensor(truth, dtype=torch.float32).to(self.device)
        step = self._step_for(x.shape[1], x.shape[2])
        self.state, metrics = step(self.state, x, truth)
        return metrics

    @property
    def outer_batch(self) -> int:
        return self.spec.net.batch * self.spec.net.subdivisions


def nan_guarded(step_fn):
    """Wrap a train step: keep the old state when the loss is not finite
    (keeps long runs alive through rare numeric blowups — a recovery the
    reference lacks, SURVEY §5.3). The check reads the loss on the host."""
    def guarded(state, x, truth):
        new_state, metrics = step_fn(state, x, truth)
        ok = bool(torch.isfinite(metrics["loss"]))
        metrics["skipped_nonfinite"] = not ok
        return (new_state if ok else state), metrics
    return guarded


__all__ = ["Trainer", "TrainState", "make_train_step", "nan_guarded"]
