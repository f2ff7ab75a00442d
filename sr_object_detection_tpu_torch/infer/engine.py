"""Serving engines: batched throughput (bf16) and batch-1 latency.

Counterpart of ``sr_object_detection_tpu/infer/engine.py``: the
perf-path analog of the reference's ``darknet speed`` harness
(src_yolo2/darknet.c:98-113) and the robot loop's batch-1 engine
(KinectUtil::detection -> test_detector_img,
src_yolo2/KinectUtil.cpp:379-487).

* :class:`ThroughputEngine` runs a batch through the network in bf16
  with BN folded; with ``phase_stem=True`` its leading conv+pool pairs
  run through the training pair's fwdstats + apply kernels with identity
  BN constants (``kernels/phase_train.build_bf16_stem``, TPU kernel 4's
  ``fwd`` mode in the JAX package). Its ``benchmark`` follows the JAX module's checksum
  protocol (:func:`checksum_benchmark`): ``iters`` queued forwards of a
  checksum that depends on every output element, one ``.item()`` at the
  end. The int8 sibling is ``infer.quant.QuantizedThroughputEngine``.
* :class:`LatencyEngine` runs u8 frame -> normalize (+ resize) ->
  forward -> region decode -> top-k candidates on the engine's device
  (a net without a region head, a classifier, returns its output),
  in bf16 (BN folded) or, with ``int8_calib``, through the int8 program
  of ``infer/quant.py``. With ``fused_stem=True`` the bf16 engine's
  leading conv+pool pairs run through the batch-1 stem kernel
  (``kernels/b1_stem.py``): on CUDA that is the hand-written kernel or
  an exception, never a silent fallback. The tail convs run through
  ``F.conv2d`` in bf16 — the TPU-only 9-tap matmul formulation of the
  JAX engine (``conv2d_b1_tap_matmul``) is not ported.
* :func:`best_latency_engine` times the batch-1 candidates on the card
  (``LatencyEngine.device_benchmark``, CUDA events) and returns the
  fastest.

``ThroughputEngine(align_head=True)`` runs the region head rewritten by
:func:`align_region_head` (each anchor's block 128 + ceil(classes/128)
* 128 channels, the JAX engine's rewrite, so that both packages' specs
and pre-split outputs have the same shapes); ``presplit=True`` or
``"flat"`` returns the head's (fields, cls) pair instead of the flat
darknet output (``ops.boxes.region_activate_split[_flat]``).

Not ported: ``fuse_pool`` (the polyphase conv+pool rewrite, measured
slower in the JAX package; ROADMAP "Not ported"), the checksum protocol's
``chunk`` probe (measured negative in the JAX package) and the sharded
engine (queue 1, item 11).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..graph import spec as S
from ..graph.compiler import Network
from ..io.convert import params_to_torch
from ..kernels import _build
from ..kernels import b1_stem as BS
from ..kernels import phase_train as PT
from ..ops import boxes as B
from ..ops import conv as C
from ..ops import image as I


def fold_params_for_inference(spec: S.NetworkSpec, params,
                              dtype=torch.bfloat16):
    """Fold BN into conv weights/biases in float32, then cast to
    ``dtype``. ``params``: the port's tensors (``io.convert``), float32.

    Returns (folded_params, folded_spec); folded conv layers carry
    batch_normalize=False."""
    new_params, new_layers = [], []
    for l, p in zip(spec.layers, params):
        if isinstance(l, S.ConvSpec) and l.batch_normalize and p:
            p = C.fold_batchnorm({k: v.float() for k, v in p.items()})
            l = dataclasses.replace(l, batch_normalize=False)
        new_params.append({k: v.to(dtype) for k, v in p.items()})
        new_layers.append(l)
    folded = S.NetworkSpec(net=spec.net, layers=tuple(new_layers),
                           cfg_path=spec.cfg_path)
    return new_params, folded


def align_region_head(spec: S.NetworkSpec, params, *,
                      min_classes: int = 1024):
    """The JAX engine's head rewrite (``infer/engine.py``
    ``align_region_head``): re-lay the region head conv's output channels
    so that each anchor's block is [coords+1 fields | zeros to 128 |
    classes | zeros to a multiple of 128], and set the region's
    ``head_block``. The 128 is the TPU's lane width; the port keeps it so
    that both packages give the same specs and pre-split outputs. Exact:
    the extra channels are zero and the activations read only the real
    ones.

    ``params``: the port's folded tensors (OIHW). Returns (spec, params)
    unchanged unless the last layer is a region with at least
    ``min_classes`` classes fed by a conv without BN whose filters are
    the region's A * (coords + 1 + classes)."""
    region = spec.layers[-1]
    head = spec.layers[-2] if len(spec.layers) >= 2 else None
    nf = region.coords + region.classes + 1 if isinstance(
        region, S.RegionSpec) else 0
    if (not isinstance(region, S.RegionSpec)
            or region.classes < min_classes
            or not isinstance(head, S.ConvSpec)
            or head.batch_normalize          # fold BN first
            or head.filters != region.n * nf):
        return spec, params
    fields = region.coords + 1
    block = 128 + -(-region.classes // 128) * 128
    w, bias = params[-2]["weights"], params[-2]["biases"]
    w2 = w.new_zeros((region.n * block, *w.shape[1:]))
    b2 = bias.new_zeros((region.n * block,))
    for a in range(region.n):
        src, dst = a * nf, a * block
        w2[dst:dst + fields] = w[src:src + fields]
        b2[dst:dst + fields] = bias[src:src + fields]
        w2[dst + 128:dst + 128 + region.classes] = w[src + fields:src + nf]
        b2[dst + 128:dst + 128 + region.classes] = bias[src + fields:src + nf]
    new_head = dataclasses.replace(
        head, filters=region.n * block, out_c=region.n * block,
        outputs=head.out_h * head.out_w * region.n * block)
    new_region = dataclasses.replace(
        region, c=region.n * block, head_block=block,
        inputs=region.h * region.w * region.n * block)
    new_params = list(params)
    new_params[-2] = {"weights": w2, "biases": b2}
    return S.NetworkSpec(net=spec.net,
                         layers=(*spec.layers[:-2], new_head, new_region),
                         cfg_path=spec.cfg_path), new_params


def presplit_spec(spec: S.NetworkSpec, presplit) -> S.NetworkSpec:
    """``spec`` with its aligned region head switched to the pre-split
    contract (``presplit_flat`` when ``presplit == "flat"``); a spec
    without an aligned region head comes back unchanged."""
    last = spec.layers[-1]
    if not (presplit and isinstance(last, S.RegionSpec)
            and last.head_block):
        return spec
    return S.NetworkSpec(
        net=spec.net,
        layers=(*spec.layers[:-1], dataclasses.replace(
            last, presplit=True, presplit_flat=(presplit == "flat"))),
        cfg_path=spec.cfg_path)


def sync_checksum(out):
    """float32 scalar that data-depends on every output element, for
    the benchmark/warmup host sync only (its value is never checked)."""
    outs = out if isinstance(out, tuple) else (out,)
    tot = None
    for o in outs:
        t = o.sum(dtype=torch.float32)
        tot = t if tot is None else tot + t
    return tot


def checksum_benchmark(run_sum, input_shape, batch, *, iters: int,
                       warmup: int, device, dtype=torch.float32) -> dict:
    """Steady-state throughput protocol (the darknet 'speed' analog):
    device-resident input, ``iters`` queued calls of ``run_sum`` (a full
    forward reduced to a scalar), ONE host sync at the end (``.item()``
    of the last checksum). ``dtype=torch.uint8`` feeds raw camera
    frames."""
    rng = np.random.RandomState(0)
    if dtype == torch.uint8:
        x = torch.from_numpy(rng.randint(0, 256, input_shape, np.uint8))
    else:
        x = torch.from_numpy(rng.uniform(0, 1, input_shape).astype(
            np.float32)).to(dtype)
    x = x.to(device)
    with torch.no_grad():
        for _ in range(warmup):
            run_sum(x).item()
        start = time.perf_counter()
        s = None
        for _ in range(iters):
            s = run_sum(x)
        s.item()
    dt = time.perf_counter() - start
    return {"images_per_sec": iters * batch / dt,
            "sec_per_batch": dt / iters, "batch": batch}


class ThroughputEngine:
    """Batched forward for maximum images/sec. It always folds BN and
    runs bf16 (the JAX engine's defaults, the only values its callers
    use).

    ``params``: numpy params in the JAX package's layout (HWIO).
    ``align_head`` rewrites a region head of at least 1024 classes with
    :func:`align_region_head`; ``presplit`` (True or ``"flat"``) aligns
    any region head and returns its (fields, cls) pair (``presplit``
    tells whether it engaged)."""

    DTYPE = torch.bfloat16

    def __init__(self, spec: S.NetworkSpec, params, *, device,
                 batch: int = 64, fuse_pool: bool = False,
                 align_head: bool = False, presplit: bool = False,
                 phase_stem: bool = False):
        if fuse_pool:
            raise NotImplementedError(
                "fuse_pool (the polyphase conv+pool rewrite, measured "
                "slower in the JAX package) is not ported (ROADMAP, "
                "'Not ported')")
        self.batch = batch
        self.device = torch.device(device)
        self.params, self.spec = fold_params_for_inference(
            spec, params_to_torch(spec, params, self.device), self.DTYPE)
        if align_head or presplit:
            self.spec, self.params = align_region_head(
                self.spec, self.params,
                min_classes=1 if presplit else 1024)
        self.spec = presplit_spec(self.spec, presplit)
        self.presplit = getattr(self.spec.layers[-1], "presplit", False)
        self._stem, n = None, 0
        if phase_stem:
            self._stem, n = PT.build_bf16_stem(self.spec, self.params)
            if self._stem is not None and self.device.type == "cuda":
                _build.load()            # build now: fail at construction
        self.phase_stem = self._stem is not None
        tail = self.spec if n == 0 else BS.truncate_spec(self.spec, n)
        self._net = Network(tail, self.params[n:], compute_dtype=self.DTYPE)
        self.input_shape = (batch, spec.net.h, spec.net.w, spec.net.c)

    @torch.no_grad()
    def forward(self, x):
        """(out, aux) of the bf16 network on an NHWC batch; with the
        phase stem, aux['outputs'] are numbered from the first layer after
        it."""
        x = torch.as_tensor(x).to(self.device, self.DTYPE)
        if self._stem is not None:
            x = self._stem(x)
        return self._net(x)

    def _run(self, x):
        return self.forward(x)[0]

    def warmup(self):
        sync_checksum(self._run(torch.zeros(self.input_shape))).item()

    def __call__(self, x):
        return self._run(x)

    def benchmark(self, iters: int = 50, warmup: int = 5) -> dict:
        return checksum_benchmark(
            lambda x: sync_checksum(self._run(x)), self.input_shape,
            self.batch, iters=iters, warmup=warmup, dtype=self.DTYPE,
            device=self.device)


class LatencyEngine:
    """Batch-1 low-latency path with on-device preprocessing: bf16 with
    BN folded, or int8 with ``int8_calib`` (a preprocessed NHWC float32
    calibration batch; ``fused_stem`` is then ignored, as in the JAX
    engine).

    ``params``: numpy params in the JAX package's layout (HWIO), as
    ``io.weights.load_weights`` / ``init_params`` return them."""

    TOPK = 64

    def __init__(self, spec: S.NetworkSpec, params, *, device,
                 frame_hw: Optional[tuple[int, int]] = None,
                 int8_calib=None, fused_stem: bool = False):
        region = spec.layers[-1]
        self.region = region if isinstance(region, S.RegionSpec) else None
        self.device = torch.device(device)
        self._stem = None
        if int8_calib is not None:
            from .quant import quantize_for_inference
            qnet = quantize_for_inference(spec, params,
                                          np.asarray(int8_calib),
                                          device=self.device)
            self.spec, self.params = qnet.spec, qnet.qparams
            # the int8 program requantizes the float32 frame itself
            self.dtype = torch.float32
            self._net = lambda x: (qnet.forward(x), None)
        else:
            self.dtype = torch.bfloat16
            self.params, self.spec = fold_params_for_inference(
                spec, params_to_torch(spec, params, self.device),
                self.dtype)
            n = 0
            if fused_stem:
                self._stem, n = BS.build_stem(self.spec, self.params)
                if self._stem is not None and self.device.type == "cuda":
                    _build.load()        # build now: fail at construction
            tail = self.spec if n == 0 else BS.truncate_spec(self.spec, n)
            self._net = Network(tail, self.params[n:],
                                compute_dtype=self.dtype)
        self.fused_stem = self._stem is not None

        net = spec.net
        self.net_hw = (net.h, net.w)
        self.frame_hw = frame_hw
        h, w = frame_hw if frame_hw else (net.h, net.w)
        self.frame_shape = (h, w, net.c)
        self._anchors = None if self.region is None else torch.tensor(
            np.asarray(region.anchors, np.float32).reshape(region.n, 2),
            device=self.device)

    def forward(self, x):
        """Raw network forward on a preprocessed NHWC batch-1 input (the
        counterpart of the JAX engine's ``_fwd``). Returns (out, aux)."""
        if self._stem is not None:
            x = self._stem(x)
        return self._net(x.to(self.dtype))

    @torch.no_grad()
    def __call__(self, frame_u8):
        """One HWC uint8 frame -> (boxes (64, 4), probs (64, classes))
        float32 on the engine's device; on a net without a [region] head
        (a classifier), (the network's output, None), as the JAX engine
        returns it."""
        frame = torch.as_tensor(frame_u8)
        if frame.ndim != 3:
            raise ValueError(
                f"LatencyEngine expects one unbatched HWC frame "
                f"{self.frame_shape}, got shape {tuple(frame.shape)}")
        x = frame.to(self.device).float() / 255.0
        if self.frame_hw is not None and self.frame_hw != self.net_hw:
            x = I.resize_image(x, self.net_hw[1], self.net_hw[0])
        out, _ = self.forward(x[None].to(self.dtype))
        if self.region is None:
            return out, None
        r = self.region
        acts = out.reshape(1, r.h, r.w, r.n, r.coords + r.classes + 1).float()
        boxes = B.decode_region_boxes(acts, self._anchors, img_w=1.0,
                                      img_h=1.0).reshape(-1, 4)
        probs = (acts[..., 4:5] * acts[..., 5:]).reshape(-1, r.classes)
        # compact on device: top-k candidates by best class prob (ties:
        # lower index first, as lax.top_k orders them)
        best = probs.max(dim=-1).values
        idx = torch.sort(best, descending=True, stable=True).indices
        idx = idx[:min(self.TOPK, best.shape[0])]
        return boxes[idx], probs[idx]

    @torch.no_grad()
    def device_benchmark(self, reps: int = 200) -> dict:
        """Batch-1 forward time on the card: CUDA events around ``reps``
        forwards queued back to back on one stream (which runs them in
        order), after one warm-up forward. The events' elapsed time over
        ``reps`` is the time per frame on the device's clock, idle gaps
        included where the host cannot launch fast enough. There is no
        CPU fallback: a CPU engine raises."""
        if self.device.type != "cuda":
            raise RuntimeError("device_benchmark times the card with CUDA "
                               "events; this engine runs on "
                               f"{self.device}")
        net = self.spec.net
        x = torch.from_numpy(np.random.default_rng(0).uniform(
            0, 1, (1, net.h, net.w, net.c)).astype(np.float32)).to(
                self.device, self.dtype)
        self.forward(x)
        torch.cuda.synchronize(self.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            self.forward(x)
        end.record()
        torch.cuda.synchronize(self.device)
        return {"device_ms_per_frame": start.elapsed_time(end) / reps,
                "reps": reps}


def best_latency_engine(spec: S.NetworkSpec, params, *, device,
                        int8_calib, reps: int = 100, frame_hw=None):
    """Serving-default batch-1 engine: time the candidates on the card
    and return the fastest — bf16 with the fused stem (when the spec has
    an eligible stem), plain bf16, and int8 (skipped for a topology the
    int8 path does not cover).

    The returned engine carries a ``selection`` dict:
    {"bf16_ms", "fused_ms", "int8_ms", "chosen"}."""
    cands = {}
    e_bf = LatencyEngine(spec, params, device=device, frame_hw=frame_hw)
    cands["bf16"] = (
        e_bf, e_bf.device_benchmark(reps=reps)["device_ms_per_frame"])
    e_fs = LatencyEngine(spec, params, device=device, frame_hw=frame_hw,
                         fused_stem=True)
    if e_fs.fused_stem:
        cands["fused"] = (
            e_fs, e_fs.device_benchmark(reps=reps)["device_ms_per_frame"])
    try:
        e_i8 = LatencyEngine(spec, params, device=device,
                             int8_calib=int8_calib, frame_hw=frame_hw)
        cands["int8"] = (
            e_i8, e_i8.device_benchmark(reps=reps)["device_ms_per_frame"])
    except NotImplementedError:
        pass
    chosen = min(cands, key=lambda k: cands[k][1])
    win = cands[chosen][0]
    win.selection = {f"{k}_ms": v for k, (_, v) in cands.items()}
    win.selection["chosen"] = chosen
    return win


def analytic_flops(spec: S.NetworkSpec) -> float:
    """Per-image forward FLOPs, same formula as the reference 'ops'
    command (darknet.c:115-131): 2*n*k^2*c*out_h*out_w per conv plus
    2*in*out per connected."""
    total = 0.0
    for l in spec.layers:
        if isinstance(l, S.ConvSpec):
            total += 2.0 * l.filters * l.size * l.size * l.c * l.out_h * l.out_w
        elif isinstance(l, S.ConnectedSpec):
            total += 2.0 * l.inputs * l.output
        elif isinstance(l, S.LocalSpec):
            total += 2.0 * l.filters * l.size * l.size * l.c * l.out_h * l.out_w
    return total


__all__ = ["ThroughputEngine", "LatencyEngine", "best_latency_engine",
           "fold_params_for_inference", "align_region_head",
           "presplit_spec", "analytic_flops", "sync_checksum",
           "checksum_benchmark"]
