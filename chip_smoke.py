"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths — tiny-yolo-voc-416 detection at batch 1,
batch-128 serving in bf16 and int8, bf16 training at batch 128 with
the fused pair, the two-pair chain and the fused stem, yolov2-608
serving (route, reorg) and yolov2-608 training at batch 128 — through the entry points a user calls, builds
the hand-written CUDA kernels from ``sr_object_detection_tpu_torch/csrc``
and holds each against its plain PyTorch version. Phases, in order; any failure ends the run with a
non-zero status and no result line:

  0. device: a CUDA device, its name and power limit, the kernel build;
  1. the NMS kernel (32-rank chunks) against its plain version (C=20,
     k=128 and k=845, random boxes plus ties): torch.equal; its device
     time from a CUDA graph beside the launch floor, an empty kernel with
     its grid, block and shared memory from a graph;
  2. the batch-1 stem kernel (the tensor-core conv tile's stem mode of
     csrc/phase_train.cu, its taps fold at pair 1; by b1_stem.paths, no
     pair on stem_pair_kernel) against its plain version at the four
     tiny-yolo-416 pair shapes with random biases, then link by link
     along the chained stem: every element within one bf16 ulp (see
     bf16_err);
  3. the batch-1 slice at full width: Detector.detect on CUDA (random
     weights with randomized BN and biases, written as a .weights file)
     against the same Detector on the CPU, det for det; the C-oracle
     golden detect_tiny_yolo.npz on CUDA; LatencyEngine(fused_stem=True)
     on u8 frames against fused_stem=False. Kernel launch counts are
     reset just before this phase and read just after it;
  4. the pipe server (infer/serve.py) on CUDA answers 3 requests, equal
     to the in-process Detector;
  5. times from CUDA events: each batch-1 kernel beside its plain
     version and LatencyEngine per frame fused beside plain, each pair
     timed in turns (plain, kernel, kernel, plain), NMS on a frame's
     candidates, the stem chain and each of its pairs also replayed from
     a CUDA graph (device time without the host's launch cost) — NMS
     beside its launch floor; Detector.predict_batch and detect;
  6. the int8 stem kernel (csrc/phase_stem.cu, phase_pair_tc_kernel on
     the int8 tensor cores) against its plain version at the four
     tiny-yolo-416 pair shapes at batch 128 with random int8 data (pair 1
     also from u8 and float32 frames), each launch counted under its K
     fold (taps, tap pairs, chunks, chunks), then link by link along the
     engine's own chain from u8 frames, the whole chain, and two launches
     on one input: every one torch.equal (the chain is exact);
  7. the batch-128 slice at full width: ThroughputEngine (bf16) with and
     without its phase stem (kernel 4's mode fwd, one launch a pair on
     the conv tile: pairs 2-4 on the tile, pair 1 on its taps fold, none
     on the FP32-core path, no fwdstats, colsum or apply, counted; each
     link torch.equal to fwdstats + apply with identity BN, within one
     bf16 ulp of the plain engine's layers and of fwd_pair_plain, the
     bias add's and the leaky's roundings allowed for) and
     QuantizedThroughputEngine (int8,
     u8 frames)
     with and without the phase stem (its four pairs counted under their
     K folds); the two int8 engines' int8 trunks
     equal and their
     outputs equal (or within one bf16 step of the head's logits, should
     cuDNN pick another algorithm). Launch counts are reset just before
     this phase and read just after it;
  8. the int8 Detector on CUDA against the same Detector on the CPU, det
     for det within a prob band (the two calibrations differ in the last
     bits); the int8 LatencyEngine's candidates are finite;
  9. the pipe server with --int8 answers 3 requests, equal to the
     in-process int8 Detector calibrated on the same first frame;
 10. times from CUDA events, in turns: the int8 stem chain against its
     plain chain, and each pair on the chain's inputs beside its bound;
     the same for the bf16 serving stem (kernel 4's mode fwd), each pair
     and the chain also from a CUDA graph;
     images/s of ThroughputEngine bf16 without and with its
     phase stem and of the int8 engine on u8 frames without and with the
     phase stem (host clock
     around queued batches, one sync); the int8 LatencyEngine per frame
     and best_latency_engine's selection;
 11. torch.profiler over each engine: wall and device busy time per
     frame or batch, the device's idle share, the top kernels; the bf16
     phase stem's batch ran fwd_tc_kernel 3 times, fwd_fold_kernel once
     and no fwdstats, colsum or apply kernel, the int8 phase
     stem's batch
     phase_pair_tc_kernel and no dp4a phase_pair_kernel;
 12. the three training kernels (csrc/phase_train.cu) against their
     plain versions at the training pair's shape (416, B=128, 3 -> 16):
     fwdstats (on the tensor-core tile's taps fold, fwdstats_fold_kernel,
     by conv_kernels) Z within one bf16 ulp, its argmax equal wherever the
     two extreme taps differ by more than an ulp, its sums at 1e-4, two
     launches bit-equal, its time in turns with fwdstats_plain beside its
     bound and cuDNN's bf16 F.conv2d alone (the conv without the pool,
     argmax and sums: context, not the same function); apply
     bit-equal; every bwdg reduction at 1e-3 of its largest magnitude
     (bwdg on the tensor cores, bwdg_tc_kernel), two bwdg launches
     bit-equal; then phase_train_block's gradient (on a case with no
     zero-variance channel, the cotangent zeroed where the two tie rules
     route apart)
     at 1e-3 of a float64 evaluation of the unfused chain's formulas,
     and its scale and bias gradients at 1e-3 of the chain's (the bf16
     chain's own weight gradient is several per cent off that
     evaluation at this size: printed, not gated);
 13. the training slice at full width: Trainer on tiny-yolo-voc 416,
     batch 128, bf16 with phase_train, three steps on one batch (losses
     finite, the third below the first, each training kernel launched 3
     times, fwdstats (3 -> 16) on the taps fold, counts reset just before
     and read just after), the first
     loss within 0.03*|loss| + 0.05 of a trainer without the pair; the
     float32 Trainer on CUDA reproduces the four train_region_* goldens;
 14. `cli detector train -bf16` on 256 synthetic PPM images: two
     iterations, a _final.weights that loads and moved;
 15. times, in turns: apply and bwdg beside their plain versions and
     bounds; Trainer.step images/s, TFLOP/s and MFU (3 x analytic_flops
     per image against the bf16 dense peak) for bf16 + phase_train,
     bf16 and float32;
 16. torch.profiler over one bf16 step with the pair and one without;
     the step with the pair ran bwdg_tc_kernel, not bwdg_kernel; over
     three steps of the pair path in one profiler window, fwdstats'
     launches by the counter and by CUDA events around each launch equal
     three (the profiler's count of fwdstats_fold_kernel under three
     settings is printed and held between 1 and 3), and the same steps
     through fwdstats_plain
     from the same state give the same losses and layer 0's BN
     statistics (settle_fwdstats_count);
 17. the opt-in training paths' kernels against their plain versions at
     the main path's shapes: kernel 4's modes red and dy (+ its weight
     gradient) and the dgrad kernel (an implicit GEMM on the bf16 tensor
     cores, mma.sync) at the chain's second pair (208x208,
     16 -> 32, B=128; inputs on a coarse grid where the conv's sums are
     exact, so both recompute the same conv): red's sums at 1e-4, dy
     bit-equal, dw at 1e-3, dgrad within one bf16 ulp; fwdstats there
     at phase 12's tolerances; red, dy and fwdstats on the tensor-core
     conv tile; on general inputs at that shape, fwdstats' Z and argmax
     equal to the pooled extreme of dy's recomputed y (dy with unit
     constants) and its first tap, bit for bit; F2, B1 and B2
     (csrc/fused_stem.cu) at the five fusable pairs' conv outputs
     (416x16 ... 26x256, B=128, channels-last): F2 and B2 bit-equal, B1's
     sums at 1e-4 and bit-equal across two launches, F2, B1 and B2 on the
     row kernels (f2_row_kernel, b1_row_kernel, b2_row_kernel) by
     fused_stem.paths;
 18. the chain's second pair's gradient (dw, dscales, dbiases, dx) at
     416 B=128 against a float64 evaluation of the unfused chain's
     formulas (dy rounded to bf16 where the pair rounds it): 3e-3 (the
     two round dy from float32 and float64, an ulp apart at a boundary),
     dx at 1e-2; the fused stem op against the unfused chain on the same conv
     output at pair 2's shape: forward and statistics equal, scale and
     bias gradients at 1e-3, dy within one bf16 ulp;
 19. Trainer bf16 at 416 B=128 with phase_train="chain", with
     phase_train=True + fused_stem=True and with fused_stem=True, three
     steps each, counts reset just before and read just after each: per
     step fwdstats 2 (pair 1's on the tensor-core tile, pair 0's on its
     taps fold), apply 2, red 1,
     dy 1 (both on the tile), dgrad 1, bwdg 1 / the pair's
     three + F2, B1, B2 4 each / F2, B1, B2 5 each, F2, B1 and B2 on the
     row kernels; losses finite and falling, the first within
     0.03*|loss| + 0.05 of the step without kernels;
 20. times, in turns: red, dy, dgrad, F2, B1 and B2 (F2 in turns at
     pair 2; the three at the five fusable pairs replayed from a CUDA
     graph, B1 and B2 also in turns) beside their plain
     versions and bounds, F.conv_transpose2d (dgrad's function in one
     library call, cuDNN, timed in the same run), fwdstats on the
     tensor-core tile at 16->32 @208, 32->64 @104 and 64->128 @52 beside
     its bounds (cuDNN's bf16 F.conv2d at those shapes for reference: the
     conv alone);
     Trainer.step images/s of the three paths against bf16 + phase_train;
 21. torch.profiler over one step of each of the three paths; the two
     with the pair ran bwdg_tc_kernel, not bwdg_kernel; the two with the
     fused stem ran f2_row_kernel, b1_row_kernel and b2_row_kernel, not
     f2_kernel, b1_kernel or b2_kernel; the chain's step
     ran fwdstats_tc_kernel, red_tc_kernel and dy_tc_kernel once each,
     fwdstats_fold_kernel once (pair 0), no fwdstats_kernel and no
     chain_bwd_kernel; the pair + fused stem step fwdstats_fold_kernel;
 22. yolov2-608 (cfg/yolo.cfg, 80 classes; random weights from seed 0
     with randomized BN and biases, written as a .weights file): its four
     serving kernels at its shapes against their plain versions — kernel
     4's mode fwd at B=128 (3 -> 32 @608 on fwd_fold_kernel, 32 -> 64
     @304 on fwd_tc_kernel, by conv_kernels; each torch.equal to fwdstats
     + apply with identity BN, within assert_fwd_close of fwd_pair_plain),
     the int8 stem from u8 frames (taps and chunks folds; torch.equal),
     the batch-1 stem on the conv tile (within one bf16 ulp) and NMS at
     C=80, k=128 (a frame's candidates, all and gated, and random ones
     with every rank live; bit-equal);
 23. the yolov2-608 main path, counted (every count reset just before and
     read just after): Detector.detect float32 and int8, the three
     LatencyEngines on u8 frames and the four batch-128 engines; the
     float32 Detector det for det against the CPU, the int8 Detector
     within the prob band that the two calibrations leave, the C-oracle
     golden yolo_coco_416.npz on CUDA (2e-4), the pipe server on the
     yolov2 cfg (3 requests equal to the in-process Detector);
 24. yolov2-608 at B=128: the bf16 phase stem link by link within
     assert_stem_link_close of the plain engine's layers, the int8 trunks
     with and without the phase stem equal; at batch 1 the fused stem's
     candidates against the plain engine's within the band their probs
     leave, the int8 engine's finite;
 25. yolov2-608 times: each of the four kernels and its chain from a CUDA
     graph in turns with its plain version, beside its bound (NMS beside
     its launch floor); images/s of the four batch-128 engines in turns;
     the three LatencyEngines' device time a frame; torch.profiler over a
     bf16 and an int8 phase-stem batch (fwd_fold_kernel and fwd_tc_kernel
     once each, no colsum or apply kernel; phase_pair_tc_kernel, no
     phase_pair_kernel);
 26. yolov2-608 training's kernels at its shapes, B=128, against their
     plain versions (the plain versions 16 or 32 images at a time, every
     image compared): the pair 3 -> 32 at 608 and at 152 (W2 = 76,
     partial 8x8 pooled tiles) at phase 12's tolerances, fwdstats on the
     taps fold and bwdg on the tensor cores, two launches of each
     bit-equal, the pair's gradient against the float64 evaluation
     (check_pair_gradient; at 608 on 16 images); F2, B1 and B2 at the
     four fused-stem pairs (layers 0, 2, 6, 10: 608x32 ... 76x256) on the
     row kernels, layer 0's y 3.03 GB, its images past 2^31 bytes
     included, with the batch's own statistics; each kernel's time from
     a CUDA graph in turns with its plain version on the whole batch,
     beside its bound (fwdstats beside cuDNN's F.conv2d alone);
 27. Trainer on yolov2-608 (cfg/yolo.cfg, 80 classes, full depth, random
     weights from seed 0) at B=128, bf16, 3 steps a path, counts reset
     just before and read just after each: (d) no kernels with
     remat="selective:2" (the JAX package's bench configuration), (a)
     phase_train + "selective:2", (b) phase_train + fused_stem, (c)
     fused_stem; launches a step (a) the pair once, (b) the pair and F2,
     B1, B2 three times, (c) F2, B1, B2 four times (layer 16 is live), on
     the row kernels; each first loss within 0.03*|loss| + 0.05 of (d)'s;
     each path's peak device memory, images/s and a torch.profiler step;
     (a) at 416 through Trainer._step_for; (a) and (d) with remat
     against without: the first loss (equal for (a)) and the parameters
     after one step within the spread of two runs without remat, and
     the peak memory without remat; phase_train="chain" runs the pair
     alone (no red, dy or dgrad: layer 2's Cin is 32);
 28. `cli detector train -bf16` on yolo.cfg at 608 with its published
     batch=64, subdivisions=8 on 128 synthetic PPMs: two iterations
     (random=1 resizes at the first), a _final.weights that loads, seen
     128, layer 0's rolling statistics moved.

The last lines are one JSON object with the four kernels at yolov2-608's
shapes (the keys of the kernels line; their launches counted in phase
23), the card (nvidia-smi), one JSON object describing the
14 kernels and, under names that end in "(yolov2-608 training: ...)",
the pair's and the fused stem's kernels at yolov2-608's training shapes
(phase 26's times; the fused stem's summed over its four pairs; their
launches counted in phase 27's paths (a) and (c)) (time, plain time,
bound, launches and library call of each;
``stem_pair`` is the batch-1 stem on the tensor-core conv tile of
csrc/phase_train.cu (``stem_fold_kernel`` at pair 1, ``stem_tc_kernel``
at pairs 2-4; ``stem_pair_kernel`` in csrc/b1_stem.cu takes the other
shapes), its time the four-pair chain's from a CUDA graph replay,
``nms_per_class`` its time on a frame's candidates from a CUDA graph,
``phase_train_fwd`` kernel 4's mode fwd (``fwd_fold_kernel`` at pair 1,
``fwd_tc_kernel`` at pairs 2-4), its time the bf16 serving stem's
four-pair chain at B=128 in turns with the plain chain,
``fused_stem_f2`` the row kernel ``f2_row_kernel``,
``phase_train_dgrad`` is the tensor-core implicit GEMM in
csrc/phase_train.cu, ``phase_train_bwdg`` its tensor-core
``bwdg_tc_kernel``, ``phase_train_fwdstats`` the tensor-core tile's taps
fold (``fwdstats_fold_kernel``) at the leading pair and
``phase_train_fwdstats_tc`` the tensor-core conv tile at
the chain's pair 1, which ``phase_train_red`` and ``phase_train_dy`` run
too), and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import re
import struct
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"
WORK = ROOT / "build" / "chip_smoke"
sys.path.insert(0, str(ROOT / "tests"))
from torch_parity import (  # noqa: E402  (JAX-free helpers)
    TRAIN_GOLDENS, assert_bf16_close, assert_fwd_close,
    assert_stem_link_close, chain_case,
    check_chain_kernels, check_fused_op, check_fused_stem_kernels,
    check_fwdstats, check_pair_gradient, check_train_golden,
    check_train_kernels, check_y_consistency, images_past_2g, pair_spec,
    random_bn, phase_pair_case, stem_case, train_case, train_cfg_text,
    write_ppm_dataset)

NET = 416          # tiny-yolo-voc's published width and height
BATCH = 128        # the batch serving engines' batch
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): the bounds below
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}
IOU_FLOPS = 20     # float ops of one IoU test (nms.cu)


def bound(n_bytes, n_ops, kind):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the peak rate of their type."""
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = n_ops / PEAK_OPS_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


T0 = time.perf_counter()


def log(msg):
    """Print a line; a phase's line ends with the run's elapsed seconds."""
    if msg.startswith("phase "):
        msg += f" ({time.perf_counter() - T0:.1f} s)"
    print(msg, flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=50, warmup=5) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=20) -> float:
    """Device time of fn() a call: ``iters`` calls captured in one CUDA
    graph and replayed, so no host launch cost sits between them."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def step_rate(trainer, x, t, iters):
    """images/s of Trainer.step on (x, t): host clock around ``iters``
    queued steps and one .item() at the end, after one warm-up step."""
    float(trainer.step(x, t)["loss"])
    t0 = time.perf_counter()
    for _ in range(iters):
        m = trainer.step(x, t)
    float(m["loss"])
    return iters * x.shape[0] / (time.perf_counter() - t0)


def profile(name, fn, iters, gpu, top=6):
    """torch.profiler over ``iters`` calls of fn after one warm-up: wall
    time per call (host clock, ending in a synchronize, profiler
    overhead included), device busy time per call (the CUDA kernels'
    self time; the port runs one stream, so kernels do not overlap),
    the idle share, and the kernels that take the most device time.
    Returns {name: calls over the ``iters`` calls} of the CUDA kernels
    the profiler saw."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / iters * 1e3
    rows = [(e.self_device_time_total / iters / 1e3, e.key, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(t for t, _, _ in rows)
    if busy == 0:
        log(f"profile {name}: wall {wall} ms; device time not measured "
            f"(the profiler saw no kernel) [{gpu}]")
        return {}
    log(f"profile {name}: wall {wall} ms, device busy {busy} ms, idle "
        f"share {1 - busy / wall} [{gpu}]")
    # the top kernels, and every tensor-core kernel of the port below them
    ranked = sorted(rows, reverse=True)
    for i, (t, key, _) in enumerate(ranked):
        if i < top or "_tc_kernel" in key or "_fold_kernel" in key:
            log(f"  {t} ms ({t / busy:.1%}) {key[:90]}")
    return {key: calls for _, key, calls in rows}


def named(kernel, key) -> bool:
    """Whether a profiler key names ``kernel``: demangled ("...::kernel("
    or "kernel<") or mangled ("...13kernelE..." / "kernelI"), and not a
    longer name ending in it (bwdg_kernel is not bwdg_tc_kernel)."""
    return re.search(rf"(?<![A-Za-z_]){kernel}(?![a-z_])", key) is not None


def assert_bwdg_tensor_core(name, kernels):
    """A profiled step with the fused pair ran bwdg on the tensor cores:
    bwdg_tc_kernel among its kernels, the FP32-core bwdg_kernel not."""
    assert any("bwdg_tc_kernel" in k for k in kernels), (name, kernels)
    assert not any(named("bwdg_kernel", k) for k in kernels), (
        name, kernels)
    log(f"  {name}: bwdg ran as bwdg_tc_kernel (tensor cores)")


def assert_fused_stem_rows(name, kernels):
    """A profiled step with the fused stem ran it on the row kernels:
    f2_row_kernel, b1_row_kernel and b2_row_kernel among its kernels, the
    strided f2_kernel, b1_kernel and b2_kernel not."""
    for k in ("f2_row_kernel", "b1_row_kernel", "b2_row_kernel"):
        assert any(k in key for key in kernels), (name, k, kernels)
    assert not any(named(s, k) for s in ("f2_kernel", "b1_kernel",
                                         "b2_kernel") for k in kernels), (
        name, kernels)
    log(f"  {name}: F2, B1 and B2 ran as f2_row_kernel, b1_row_kernel and "
        f"b2_row_kernel")


def assert_conv_tensor_core(name, kernels, iters, per_call):
    """A profiled run (``iters`` calls) ran the conv of fwdstats, red and
    dy on the tensor cores: the tile for every Cin >= 16 instance, the
    tile's taps fold for the leading pair's 3 -> 16. ``per_call`` gives
    the calls a call makes of fwdstats_tc_kernel, red_tc_kernel,
    dy_tc_kernel, fwdstats_fold_kernel and the FP32-core fwdstats_kernel
    (0 on every path); chain_bwd_kernel (the FP32-core red/dy) never ran.
    A count is held between 1 and ``iters`` times its value (0 where it
    is 0): the profiler has been seen to miss one launch of a window
    (fwdstats_kernel's in PRs 9-11, and fwdstats_fold_kernel's in a
    two-step window of tools/fwdstats_fold_ab.py), and an instance on
    the FP32-core loop would add ``iters`` launches of fwdstats_kernel or
    chain_bwd_kernel."""
    got = {k: sum(c for key, c in kernels.items()
                  if named(k, key)) for k in per_call}
    assert all(got[k] == 0 if v == 0 else 1 <= got[k] <= iters * v
               for k, v in per_call.items()), (name, got, iters)
    assert not any("chain_bwd_kernel" in k for k in kernels), (name, kernels)
    log(f"  {name}: conv kernels over {iters} calls {got}, no "
        f"chain_bwd_kernel")


def settle_fwdstats_count(PT, make_trainer, x, t, steps, gpu):
    """The pair path's fwdstats launches over ``steps`` training steps
    from one state in one profiler window: the launch counter and a pair
    of CUDA events around each launch (each timing a positive span) equal
    ``steps``; the same steps with fwdstats' plain version from the same
    state give each step's loss within 1e-2 of its magnitude and layer
    0's rolling BN statistics (which the batch statistics from fwdstats
    move) within 1e-3 of their largest magnitude: a launch that did not
    run would leave Z and the statistics unwritten. The profiler's count
    of fwdstats_fold_kernel, under three settings (CPU and CUDA
    activities,
    CUDA only, and a schedule with one warm-up step before the ``steps``
    it records), is printed and held between 1 and ``steps``, as
    assert_conv_tensor_core holds it: in this script it has read one
    launch fewer than ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    kernel_fn, marks = PT.fwdstats, []
    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def evented(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = kernel_fn(*args)
        end.record()
        marks.append((start, end))
        return out

    def run(fn, activities, warmup):
        """(losses, layer 0's rolling statistics, counter, profiler count)
        over ``steps`` recorded steps of a new trainer."""
        trainer = make_trainer()
        before = PT.launches["fwdstats"]
        losses, stats = [], []
        sched = (torch.profiler.schedule(wait=0, warmup=1, active=steps,
                                         repeat=1) if warmup else None)
        PT.fwdstats = fn
        try:
            with torch.profiler.profile(activities=activities,
                                        schedule=sched) as prof:
                for _ in range(steps + warmup):
                    losses.append(float(trainer.step(x, t)["loss"]))
                    p0 = trainer.state.params[0]
                    stats.append(torch.stack([p0["rolling_mean"],
                                              p0["rolling_variance"]]))
                    if warmup:
                        prof.step()
                torch.cuda.synchronize()
        finally:
            PT.fwdstats = kernel_fn
        seen = sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and named("fwdstats_fold_kernel", e.key))
        return losses, stats, PT.launches["fwdstats"] - before - warmup, seen
    lk, sk, ck, pk = run(evented, both, 0)
    spans = [a.elapsed_time(b) for a, b in marks]
    lp, sp, cp, pp = run(PT.fwdstats_plain, both, 0)
    assert ck == len(spans) == steps and min(spans) > 0, (ck, spans)
    assert cp == pp == 0, (cp, pp)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    stat_rel = max(((a - b).abs().max() / b.abs().max()).item()
                   for a, b in zip(sk, sp))
    assert loss_rel <= 1e-2 and stat_rel <= 1e-3, (lk, lp, stat_rel)
    counts = {"CPU + CUDA": pk,
              "CUDA only": run(kernel_fn, [ProfilerActivity.CUDA], 0)[3],
              "a warm-up step": run(kernel_fn, both, 1)[3]}
    assert all(1 <= n <= steps for n in counts.values()), counts
    log(f"  fwdstats over {steps} steps of the pair path: counter {ck}, "
        f"CUDA-event spans {spans} ms; losses {lk} against "
        f"fwdstats_plain's {lp} (max rel {loss_rel}), layer 0 rolling BN "
        f"statistics max rel {stat_rel}; the profiler's "
        f"fwdstats_fold_kernel "
        f"count by setting {counts} [{gpu}]")


def bf16_err(got, ref) -> float:
    """Assert every element within one bf16 ulp (tests/torch_parity.py);
    return the max absolute difference."""
    got, ref = got.float().cpu().numpy(), ref.float().cpu().numpy()
    assert_bf16_close(got, ref)
    return float(np.abs(got - ref).max())


def match_dets(a, b, thr, margin, require=True):
    """Det for det within a prob band: every detection (class, prob, box)
    of either list with prob > thr + margin has one in the other list of
    the same class, a prob within margin and the same box (within bf16
    resolution). Returns how many were matched (with ``require``, at
    least one)."""
    n = 0
    for x, y in ((a, b), (b, a)):
        for c, p, box in x:
            if p <= thr + margin:
                continue
            n += 1
            assert any(c2 == c and abs(p2 - p) <= margin
                       and np.allclose(b2, box, rtol=2 ** -6, atol=1e-3)
                       for c2, p2, b2 in y), (c, p, box)
    assert n > 0 or not require
    return n


def voc_map(det, paths, gt, thresh, nms):
    """VOC mAP of a Detector on the synthetic A/B set (the port's
    tests/test_torch_int8.py::test_int8_map_delta protocol)."""
    from sr_object_detection_tpu_torch.eval.voc import mean_ap, voc_det_lines
    from sr_object_detection_tpu_torch.kernels import nms as NMS
    from sr_object_detection_tpu_torch.ops.image import load_image_rgb
    from tools.synth_dataset import N_CLASSES, gt_corner_boxes
    names = [str(c) for c in range(N_CLASSES)]
    per_class = {c: [] for c in range(N_CLASSES)}
    for path in paths:
        img = load_image_rgb(path)
        boxes, probs = det.predict_batch(det.preprocess(img)[None],
                                         thresh=thresh)
        probs = NMS.nms_sort_topk(boxes[0], probs[0], nms, k=boxes.shape[1])
        lines = voc_det_lines(pathlib.Path(path).stem, boxes[0].cpu().numpy(),
                              probs.cpu().numpy(), names, img.shape[1],
                              img.shape[0])
        for c in range(N_CLASSES):
            for line in lines[names[c]]:
                f = line.split()
                per_class[c].append((f[0], *map(float, f[1:6])))
    return mean_ap(per_class, gt_corner_boxes(gt))[0]


def candidates(boxes, probs):
    """LatencyEngine output -> [(class, prob, box)]."""
    boxes, probs = boxes.cpu().numpy(), probs.cpu().numpy()
    return [(int(p.argmax()), float(p.max()), bx)
            for bx, p in zip(boxes, probs)]


Y_NET = 608        # yolov2's published width and height (cfg/yolo.cfg)
Y_PAIRS = [(0, 1), (2, 3)]    # its stem pairs: 3 -> 32 @608, 32 -> 64 @304


def abba_graph(name, kernel_fn, plain_fn, gpu, iters=10, plain_iters=3):
    """A kernel from a CUDA graph (graph_ms) in turns with its plain
    version from CUDA events (cuda_ms): plain, kernel, kernel, plain.
    Returns (kernel ms, plain ms), each the mean of its two readings."""
    p1 = cuda_ms(plain_fn, plain_iters, 1)
    k1, k2 = graph_ms(kernel_fn, iters), graph_ms(kernel_fn, iters)
    p2 = cuda_ms(plain_fn, plain_iters, 1)
    log(f"time {name}: kernel from a CUDA graph {(k1 + k2) / 2} ms ({k1}, "
        f"{k2}), plain {(p1 + p2) / 2} ms ({p1}, {p2}) [{gpu}]")
    return (k1 + k2) / 2, (p1 + p2) / 2


def yolov2_608(gpu, dev, reset_counts, counts):
    """Phases 22-25 (the module docstring): yolov2-608 serving. Returns
    the kernels line's entries for the four kernels on this path, at
    yolov2-608's shapes."""
    from sr_object_detection_tpu_torch.graph.spec import parse_network_cfg
    from sr_object_detection_tpu_torch.infer.detector import Detector
    from sr_object_detection_tpu_torch.infer.engine import (
        LatencyEngine, ThroughputEngine)
    from sr_object_detection_tpu_torch.infer.quant import (
        QuantizedThroughputEngine)
    from sr_object_detection_tpu_torch.io.weights import (
        init_params, save_weights)
    from sr_object_detection_tpu_torch.kernels import b1_stem as BS
    from sr_object_detection_tpu_torch.kernels import nms as NMS
    from sr_object_detection_tpu_torch.kernels import phase_stem as PS
    from sr_object_detection_tpu_torch.kernels import phase_train as PT
    from sr_object_detection_tpu_torch.models.zoo import yolov2
    from sr_object_detection_tpu_torch.ops import boxes as B

    # ---------------------------------------------------------- phase 22
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(22)
    bf16 = torch.bfloat16
    spec = yolov2(width=Y_NET, height=Y_NET)
    # random weights from seed 0, BN statistics and biases randomized; the
    # head scaled so that the 80-class probs spread
    params_np = random_bn(init_params(spec, seed=0), 1, head_gain=16.0)
    g416 = np.load(GOLDEN / "yolo_coco_416.npz")
    cfg_text = bytes(g416["cfg"]).decode()       # cfg/yolo.cfg at 416
    WORK.mkdir(parents=True, exist_ok=True)
    cfg = WORK / "yolo-608.cfg"
    cfg.write_text(cfg_text.replace("width=416", f"width={Y_NET}")
                   .replace("height=416", f"height={Y_NET}"))
    assert parse_network_cfg(str(cfg)).layers == spec.layers
    weights = WORK / "yolo-608.weights"
    save_weights(spec, params_np, str(weights))
    tag = f"yolov2-{Y_NET}"
    y16 = Y_NET // 32        # the region grid: 19 at 608
    n_boxes = y16 * y16 * 5
    n_out = n_boxes * 85
    k_nms = min(128, n_boxes)                # the Detector's NMS top-k
    k_lat = min(LatencyEngine.TOPK, n_boxes)

    bf = ThroughputEngine(spec, params_np, batch=BATCH, device=dev)
    bf_stem = ThroughputEngine(spec, params_np, batch=BATCH, device=dev,
                               phase_stem=True)
    calib = rng.uniform(0, 1, (4, Y_NET, Y_NET, 3)).astype(np.float32)
    q_stem = QuantizedThroughputEngine(spec, params_np, batch=BATCH,
                                       device=dev, calib_x=calib,
                                       phase_stem=True)
    q_plain = QuantizedThroughputEngine(spec, params_np, batch=BATCH,
                                        device=dev, calib_x=calib)
    assert bf_stem.phase_stem
    assert PS.plan_pairs(q_stem.qnet.spec) == Y_PAIRS
    assert BS.plan_pairs(bf_stem.spec) == Y_PAIRS
    frames_u8 = torch.from_numpy(rng.integers(
        0, 256, (BATCH, Y_NET, Y_NET, 3), dtype=np.uint8)).to(dev)
    x_b = frames_u8.float() / 255.0
    x_bf = x_b.to(bf16)

    # kernel 4's mode fwd at B=128 along the bf16 engine's chain: each
    # pair torch.equal to fwdstats + apply with identity BN, within
    # assert_fwd_close of fwd_pair_plain; the fold at pair 1, the tile at
    # pair 2, nothing on the FP32-core path
    fwd_err, fwd_links = 0.0, []
    before = dict(PT.conv_kernels["fwd"])
    v = x_bf
    for ci, _ in Y_PAIRS:
        p = bf_stem.params[ci]
        l = spec.layers[ci]
        cout = p["weights"].shape[0]
        zero = torch.zeros(cout, device=dev)
        one = torch.ones(cout, device=dev)
        w_hwio = p["weights"].permute(2, 3, 1, 0).contiguous()
        bias = p["biases"].float()
        got = PT.fwd_pair(v, w_hwio, bias)
        z, _, _ = PT.fwdstats(v, w_hwio, zero, one)
        comp = PT.apply(z, zero, one, one, bias)
        assert torch.equal(got, comp), (ci, (got != comp).sum().item())
        del comp
        z_np = z.float().cpu().numpy()
        del z
        ref = PT.fwd_pair_plain(v, w_hwio, bias).float().cpu().numpy()
        fwd_err = max(fwd_err, assert_fwd_close(got.float().cpu().numpy(),
                                                ref, z_np))
        del ref, z_np
        torch.cuda.empty_cache()
        fwd_links.append((l, v, w_hwio, bias))
        log(f"  bf16 serving stem pair {l.c}->{l.filters} @{l.h} "
            f"B={BATCH}: fwd == fwdstats + apply "
            f"({PT.conv_path('fwd', l.c, l.filters)}) "
            f"({time.perf_counter() - T0:.1f} s)")
        v = got
    assert {k: PT.conv_kernels["fwd"][k] - before[k] for k in before} == {
        "tensor_core": 1, "tensor_core_fold": 1, "fp32_core": 0}, (
        PT.conv_kernels)
    assert torch.equal(bf_stem._stem(x_b), v)

    # kernel 3 at B=128 from u8 frames along the int8 engine's chain:
    # torch.equal to the plain int8 chain, each launch under its K fold
    qn = q_stem.qnet
    links = [(qn.qparams[ci]["weights"], qn.qparams[ci]["dequant"],
              qn.qparams[ci]["biases"],
              float(np.float32(1.0 / qn.act_scales[ci])))
             for ci, _ in Y_PAIRS]
    inv_u8 = float(np.float32(1.0 / (255.0 * qn.in_scale)))
    folds = dict(PS.folds)
    v, ps_inputs = frames_u8, []
    for (w, dq, b, inv_out), (ci, _) in zip(links, Y_PAIRS):
        l = qn.spec.layers[ci]
        args = (v, w, dq, b, inv_out,
                inv_u8 if v.dtype == torch.uint8 else None)
        ps_inputs.append((l, args))
        out = PS.stem_pair_i8(*args)
        ref = PS.stem_pair_i8_plain(*args)
        assert torch.equal(out, ref), (ci, (out != ref).sum().item())
        del ref
        torch.cuda.empty_cache()
        log(f"  int8 stem pair {l.c}->{l.filters} @{l.h} B={BATCH}: kernel "
            f"== plain ({time.perf_counter() - T0:.1f} s)")
        v = out
    assert {k: PS.folds[k] - folds[k] for k in folds} == {
        "taps": 1, "tap_pairs": 0, "chunks": 1}, PS.folds
    assert torch.equal(qn.forward(frames_u8, stop=4), v)
    assert v.abs().max().item() > 60

    # kernel 2 (the batch-1 stem) at the two pairs, link by link, within
    # one bf16 ulp of its plain version, on the conv tile
    lat_f = LatencyEngine(spec, params_np, device=dev, fused_stem=True)
    lat_p = LatencyEngine(spec, params_np, device=dev)
    assert lat_f.fused_stem and not lat_p.fused_stem
    paths = dict(BS.paths)
    x1 = torch.from_numpy(rng.uniform(0, 1, (1, Y_NET, Y_NET, 3)).astype(
        np.float32)).to(dev, bf16)
    b1_err, b1_links, v = 0.0, [], x1
    for ci, _ in Y_PAIRS:
        p = lat_f.params[ci]
        w = p["weights"].permute(2, 3, 1, 0).to(bf16).contiguous()
        b = p["biases"].float()
        got = BS.stem_pair(v, w, b)
        b1_err = max(b1_err, bf16_err(got, BS.stem_pair_plain(v, w, b)))
        b1_links.append((spec.layers[ci], v, w, b))
        v = got
    assert {k: BS.paths[k] - paths[k] for k in paths} == {
        "tensor_core": 1, "tensor_core_fold": 1, "fp32_core": 0}, BS.paths
    assert torch.equal(lat_f._stem(x1), v)

    # kernel 1 at C=80, k=128: a frame's candidates as the Detector makes
    # them (every prob kept, and gated at the detection threshold), and
    # random candidates with every rank live
    det = Detector(str(cfg), str(weights), device=dev)
    frames = [rng.uniform(0, 1, (480, 640, 3)).astype(np.float32)
              for _ in range(3)]
    fb, fp = det.predict_batch(det.preprocess(frames[0])[None])
    assert fp.shape == (1, n_boxes, 80)
    thresh = float(np.sort(fp[0].max(-1).values.cpu().numpy())[::-1][
        min(10, n_boxes - 1)])
    nms_cases = []
    for name, probs in (("every prob", fp[0]),
                        ("gated", torch.where(fp[0] > thresh, fp[0], 0.0))):
        nms_cases.append((name, *B.topk_candidates(fb[0], probs,
                                                   k_nms)[:2]))
    n = n_boxes
    rb = torch.from_numpy(np.stack(
        [rng.uniform(0, 1, n), rng.uniform(0, 1, n), rng.uniform(.02, .4, n),
         rng.uniform(.02, .4, n)], axis=1).astype(np.float32)).to(dev)
    rp = torch.from_numpy(rng.uniform(.05, 1, (n, 80)).astype(
        np.float32)).to(dev)
    nms_cases.append(("random, every rank live",
                      *B.topk_candidates(rb, rp, k_nms)[:2]))
    nms_err = 0.0
    for name, tb, tp in nms_cases:
        assert tp.shape == (80, k_nms)
        got = NMS.nms_per_class(tb, tp, 0.4)
        ref = NMS.nms_per_class_plain(tb, tp, 0.4)
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), name
        nms_err = max(nms_err, (got - ref).abs().max().item())
    torch.cuda.synchronize()
    log(f"phase 22 ok: {tag}'s four serving kernels at its shapes == their "
        f"plain versions: kernel 4's fwd at B={BATCH} (3->32 @{Y_NET} on "
        f"the fold, 32->64 @{Y_NET // 2} on the tile; torch.equal to "
        f"fwdstats + apply, max |err| against fwd_pair_plain {fwd_err}), "
        f"kernel 3 from u8 frames (taps and chunks folds, torch.equal), "
        f"the batch-1 stem on the conv tile (max |err| {b1_err}), NMS at "
        f"C=80 k={k_nms} (torch.equal, {len(nms_cases)} cases) [{gpu}]")

    # ---------------------------------------------------------- phase 23
    # the main path, counted: detection, the batch-1 engines and the four
    # batch-128 engines through the entry points a user calls
    calib8 = det.preprocess(frames[0])[None]
    det8 = Detector(str(cfg), str(weights), device=dev, int8_calib=calib8)
    lat8 = LatencyEngine(spec, params_np, device=dev, int8_calib=calib8)
    u8 = [rng.integers(0, 256, (Y_NET, Y_NET, 3), dtype=np.uint8)
          for _ in range(3)]
    reset_counts()
    dets = [det.detect(f, thresh=thresh - 1e-4) for f in frames]
    dets8 = [det8.detect(frames[0], thresh=0.0)]
    lat_out = [(lat_f(f), lat_p(f), lat8(f)) for f in u8]
    out_bf = bf(x_b)
    out_bfs = bf_stem(x_b)
    out_s = q_stem(frames_u8)
    out_p = q_plain(frames_u8)
    torch.cuda.synchronize()
    launches_y, want = counts(nms_per_class=4, stem_pair=6,
                              phase_stem_pair=2, phase_train_fwd=2)
    log(f"  {tag} main path: launches {launches_y} "
        f"({time.perf_counter() - T0:.1f} s)")
    assert launches_y == want, launches_y
    for o, dt in ((out_bf, bf16), (out_bfs, bf16), (out_s, torch.float32),
                  (out_p, torch.float32)):
        assert o.shape == (BATCH, n_out) and o.dtype == dt, o.shape
        assert torch.isfinite(o.float()).all()

    # the float32 Detector on CUDA against the CPU, det for det
    det_cpu = Detector(str(cfg), str(weights), device="cpu")
    n_dets = 0
    for f, got in zip(frames, dets):
        want = det_cpu.detect(f, thresh=thresh - 1e-4)
        n_dets += match_dets(
            [(d.class_id, d.prob, np.asarray(d.box)) for d in got],
            [(d.class_id, d.prob, np.asarray(d.box)) for d in want],
            thresh, 1e-4)
    # the int8 Detector: CUDA and CPU calibrate with float32 sums in other
    # orders, so scales and codes may differ in the last bits, and the
    # bf16 head's logits by a bf16 step. Random weights give probs closer
    # together than that shift (phase 8), so at 608 the two are held to a
    # band before NMS, and det for det runs on the trained yolov2-style
    # A/B model of tests/golden/map_ab_v2.npz (route -3, reorg 2, route
    # -1,-3), with its mAP gates on CUDA
    det8_cpu = Detector(str(cfg), str(weights), device="cpu",
                        int8_calib=calib8)
    x0 = det8.preprocess(frames[0])[None]
    p8 = det8.predict_batch(x0)[1][0].cpu()
    p8_diff = (p8 - det8_cpu.predict_batch(x0)[1][0]).abs().max().item()
    assert torch.isfinite(p8).all() and p8_diff <= 0.1, p8_diff
    assert all(np.isfinite(d.prob) for d in dets8[0])
    from sr_object_detection_tpu_torch.ops.image import load_image_rgb
    from tools.synth_dataset import make_dataset
    g = np.load(GOLDEN / "map_ab_v2.npz")
    list_path, gt = make_dataset(str(WORK / "map_ab_v2"),
                                 int(g["n_images"]), int(g["seed"]))
    (WORK / "map_ab_v2.cfg").write_text(bytes(g["cfg"]).decode())
    (WORK / "map_ab_v2.weights").write_bytes(bytes(g["weights"]))
    ab = (str(WORK / "map_ab_v2.cfg"), str(WORK / "map_ab_v2.weights"))
    ab_paths = [l.strip() for l in open(list_path) if l.strip()]
    d32 = Detector(*ab, device=dev)
    calib_ab = np.stack([d32.preprocess(load_image_rgb(p))
                         for p in ab_paths[:8]])
    d8 = Detector(*ab, device=dev, int8_calib=calib_ab)
    d8_cpu = Detector(*ab, device="cpu", int8_calib=calib_ab)
    s8 = d8.net.qnet.act_scales
    assert s8[9] == max(s8[8], s8[6]) and s8[8] == s8[4] and s8[6] != s8[8]
    thr_ab, margin_ab = 0.15, 0.02
    n_ab, p_ab = 0, 0.0
    for path in ab_paths:
        img = load_image_rgb(path)
        xf = d8.preprocess(img)[None]
        p_ab = max(p_ab, (d8.predict_batch(xf)[1].cpu()
                          - d8_cpu.predict_batch(xf)[1]).abs().max().item())
        got, want = (
            [(d.class_id, d.prob, np.asarray(d.box)) for d in
             d_.detect(img, thresh=thr_ab - margin_ab)] for d_ in (d8, d8_cpu))
        n_ab += match_dets(got, want, thr_ab, margin_ab, require=False)
    assert n_ab > 0 and p_ab <= margin_ab, (n_ab, p_ab)
    oracle = float(g["oracle_map"])
    map32 = voc_map(d32, ab_paths, gt, float(g["thresh"]), float(g["nms"]))
    map8 = voc_map(d8, ab_paths, gt, float(g["thresh"]), float(g["nms"]))
    assert abs(map32 - oracle) <= 0.1 and abs(map8 - map32) <= 0.05, (
        oracle, map32, map8)
    # the C-oracle golden at 416 (cfg/yolo.cfg at full width) on CUDA
    gcfg = WORK / "yolo-416.cfg"
    gcfg.write_text(cfg_text)
    gspec = parse_network_cfg(str(gcfg))
    save_weights(gspec, init_params(gspec, seed=int(g416["seed"])),
                 str(WORK / "yolo-416.weights"))
    gdet = Detector(str(gcfg), str(WORK / "yolo-416.weights"), device=dev)
    with torch.no_grad():
        gout, _ = gdet.net(torch.from_numpy(
            np.transpose(g416["input_chw"], (1, 2, 0))[None].copy()).to(dev))
    gout = gout[0].cpu().numpy()
    assert np.allclose(gout, g416["output"], rtol=2e-4, atol=2e-4)
    golden_err = float(np.abs(gout - g416["output"]).max())
    del gdet
    # the pipe server on the yolov2 cfg: 3 requests, equal to the
    # in-process Detector
    req = b"".join(struct.pack("<3if", f.shape[1], f.shape[0], f.shape[2],
                               thresh) + f.astype("<f4").tobytes()
                   for f in frames) + struct.pack("<3if", 0, 0, 0, 0.0)
    proc = subprocess.Popen(
        [sys.executable, "-m", "sr_object_detection_tpu_torch.infer.serve",
         str(cfg), str(weights)], cwd=ROOT, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        out, err = proc.communicate(req, timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err.decode()[-2000:]
    assert struct.unpack("<5i", out[:20]) == (0x53524456, Y_NET, Y_NET,
                                              n_boxes, 80)
    per = 4 * n_boxes * (4 + 80)
    assert len(out) == 20 + 3 * per
    for i, f in enumerate(frames):
        blob = np.frombuffer(out[20 + i * per:20 + (i + 1) * per], "<f4")
        wb, wp = det.predict_batch(det.preprocess(f)[None], thresh=thresh)
        assert np.allclose(blob[:n_boxes * 4].reshape(-1, 4),
                           wb[0].cpu().numpy(), rtol=1e-5, atol=1e-6)
        assert np.allclose(blob[n_boxes * 4:].reshape(-1, 80),
                           wp[0].cpu().numpy(), rtol=1e-5, atol=1e-6)
    log(f"phase 23 ok: {tag} detection: {n_dets} float32 detections "
        f"matched on CUDA and CPU; int8 probs on CUDA and CPU max |diff| "
        f"{p8_diff} before NMS (band 0.1); map_ab_v2 int8: {n_ab} "
        f"detections matched on CUDA and CPU within {margin_ab} (max |prob "
        f"diff| before NMS {p_ab}), mAP on CUDA f32 {map32}, int8 {map8}, "
        f"oracle {oracle}; golden yolo_coco_416 on CUDA (max |err| "
        f"{golden_err}); the server answered 3 requests, equal to the "
        f"in-process Detector [{gpu}]")

    # ---------------------------------------------------------- phase 24
    # batch 128: the bf16 phase stem link by link against the plain
    # engine's conv + pool layers on the same input; the int8 trunks
    stem_link_err = 0.0
    for l, xi, w_hwio, bias in fwd_links:
        got = PT.fwd_pair(xi, w_hwio, bias)
        with torch.no_grad():
            ref = bf._net.layers[l.index + 1](bf._net.layers[l.index](
                xi.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
        zero = torch.zeros(bias.shape[0], device=dev)
        z, _, _ = PT.fwdstats(xi, w_hwio, zero, torch.ones_like(zero))
        stem_link_err = max(stem_link_err, assert_stem_link_close(
            got.float().cpu().numpy(), ref.float().cpu().numpy(),
            z.float().cpu().numpy()))
        del got, ref, z
        torch.cuda.empty_cache()
    bfs_diff = (out_bfs.float() - out_bf.float()).abs().max().item()
    head = len(spec.layers) - 2
    assert torch.equal(q_stem.qnet.forward(frames_u8, stop=head),
                       q_plain.qnet.forward(frames_u8, stop=head))
    out_diff = (out_s - out_p).abs().max().item()
    assert out_diff <= 2 ** -7, out_diff
    # batch 1: the fused stem rounds once, the plain chain twice, so the
    # two engines' candidates match within the band their probs leave
    # (measured on every box and class of the frame); the int8 engine's
    # candidates are finite
    def frame_probs(eng, f):
        """Every box's class probs of a u8 frame, as LatencyEngine's call
        computes them before its top-k."""
        x = torch.as_tensor(f).to(dev).float() / 255.0
        out, _ = eng.forward(x[None].to(eng.dtype))
        acts = out.float().reshape(-1, 85)
        return acts[:, 4:5] * acts[:, 5:]
    n_cands, lat_margin = 0, 0.0
    for f, (of, op, o8) in zip(u8, lat_out):
        for bx, pr in (of, op, o8):
            assert bx.shape == (k_lat, 4) and pr.shape == (k_lat, 80)
            assert torch.isfinite(bx).all() and torch.isfinite(pr).all()
        pf, pp = (frame_probs(e, f) for e in (lat_f, lat_p))
        margin = max(1.5 * (pf - pp).abs().max().item(), 1e-3)
        cf, cp = candidates(*of), candidates(*op)
        thr = sorted((p for _, p, _ in cp), reverse=True)[4] - margin
        # every box above thr - margin is a candidate of both engines
        assert k_lat == n_boxes or max(
            min(p for _, p, _ in c) for c in (cf, cp)) < thr - margin
        n_cands += match_dets(cf, cp, thr, margin)
        lat_margin = max(lat_margin, margin)
    del out_bf, out_bfs, out_s, out_p
    torch.cuda.empty_cache()
    log(f"phase 24 ok: {tag} B={BATCH}: bf16 ThroughputEngine with its "
        f"phase stem within the link bounds of the plain engine's layers "
        f"(max |err| {stem_link_err}; whole outputs max |diff| {bfs_diff}); "
        f"int8 trunks equal with and without the phase stem, outputs "
        f"{'equal' if out_diff == 0 else f'max |diff| {out_diff}'}; "
        f"batch 1: {n_cands} candidates matched between the fused and "
        f"plain engines within {lat_margin}, int8 candidates finite "
        f"[{gpu}]")

    # ---------------------------------------------------------- phase 25
    # the four kernels against their plain versions in turns, each from a
    # CUDA graph, beside their bounds (each input read once, each output
    # written once; or the operations over their type's peak)
    times, bounds, errs, plains = {}, {}, {}, {}
    n_bytes = n_ops = 0
    for l, xi, w_hwio, bias in fwd_links:
        name = f"{tag} bf16 serving stem pair (fwd) {l.c}->{l.filters} @{l.h}"
        k_ms, _ = abba_graph(name, lambda: PT.fwd_pair(xi, w_hwio, bias),
                             lambda: PT.fwd_pair_plain(xi, w_hwio, bias),
                             gpu, plain_iters=2)
        p_bytes = (2 * xi.numel() + 2 * w_hwio.numel() + 4 * bias.numel()
                   + 2 * BATCH * (l.h // 2) * (l.w // 2) * l.filters)
        p_ops = 2 * BATCH * l.h * l.w * l.filters * 9 * l.c
        b_ms, b_by = bound(p_bytes, p_ops, "bf16")
        log(f"bound {name}: {b_ms} ms by {b_by}; kernel {k_ms / b_ms:.2f}x "
            f"[{gpu}]")
        n_bytes += p_bytes
        n_ops += p_ops

    def plain_fwd_chain(v):
        for _, _, w_hwio, bias in fwd_links:
            v = PT.fwd_pair_plain(v, w_hwio, bias)
        return v
    times["phase_train_fwd"] = abba_graph(
        f"{tag} bf16 serving stem, 2 chained pairs B={BATCH}",
        lambda: bf_stem._stem(x_bf), lambda: plain_fwd_chain(x_bf), gpu,
        plain_iters=2)
    bounds["phase_train_fwd"] = bound(n_bytes, n_ops, "bf16")
    errs["phase_train_fwd"] = fwd_err
    n_bytes = n_ops = 0
    for l, args in ps_inputs:
        name = f"{tag} int8 stem pair {l.c}->{l.filters} @{l.h}"
        k_ms, _ = abba_graph(name, lambda: PS.stem_pair_i8(*args),
                             lambda: PS.stem_pair_i8_plain(*args), gpu,
                             plain_iters=2)
        p_bytes = (args[0].numel() * args[0].element_size()
                   + 9 * l.c * l.filters + 8 * l.filters
                   + BATCH * (l.h // 2) * (l.w // 2) * l.filters)
        p_ops = 2 * BATCH * l.h * l.w * l.filters * 9 * l.c
        b_ms, b_by = bound(p_bytes, p_ops, "int8")
        log(f"bound {name}: {b_ms} ms by {b_by}; kernel {k_ms / b_ms:.2f}x "
            f"[{gpu}]")
        n_bytes += p_bytes
        n_ops += p_ops

    def int8_chain(v, pair_fn):
        for w, dq, b, inv_out in links:
            v = pair_fn(v, w, dq, b, inv_out,
                        inv_u8 if v.dtype == torch.uint8 else None)
        return v
    times["phase_stem_pair"] = abba_graph(
        f"{tag} int8 stem, 2 chained pairs B={BATCH} from u8 frames",
        lambda: int8_chain(frames_u8, PS.stem_pair_i8),
        lambda: int8_chain(frames_u8, PS.stem_pair_i8_plain), gpu,
        plain_iters=2)
    bounds["phase_stem_pair"] = bound(n_bytes, n_ops, "int8")
    errs["phase_stem_pair"] = 0
    n_bytes = n_ops = 0
    for l, xi, w, b in b1_links:
        name = f"{tag} batch-1 stem pair {l.c}->{l.filters} @{l.h}"
        k_ms, _ = abba_graph(name, lambda: BS.stem_pair(xi, w, b),
                             lambda: BS.stem_pair_plain(xi, w, b), gpu,
                             iters=50, plain_iters=20)
        p_bytes = (2 * (l.h * l.w * l.c + l.out_h // 2 * l.out_w // 2
                        * l.filters) + 2 * w.numel() + 4 * b.numel())
        p_ops = 2 * l.h * l.w * l.filters * 9 * l.c
        b_ms, b_by = bound(p_bytes, p_ops, "bf16")
        log(f"bound {name}: {b_ms} ms by {b_by}; kernel {k_ms / b_ms:.2f}x "
            f"[{gpu}]")
        n_bytes += p_bytes
        n_ops += p_ops

    def plain_b1_chain(v):
        for _, _, w, b in b1_links:
            v = BS.stem_pair_plain(v, w, b)
        return v
    times["stem_pair"] = abba_graph(
        f"{tag} batch-1 stem, 2 chained pairs", lambda: lat_f._stem(x1),
        lambda: plain_b1_chain(x1), gpu, iters=50, plain_iters=20)
    bounds["stem_pair"] = bound(n_bytes, n_ops, "bf16")
    errs["stem_pair"] = b1_err
    _, tb, tp = nms_cases[1]          # the Detector's gated candidates
    times["nms_per_class"] = abba_graph(
        f"{tag} nms_per_class C=80 k={k_nms} (a frame's candidates)",
        lambda: NMS.nms_per_class(tb, tp, 0.4),
        lambda: NMS.nms_per_class_plain(tb, tp, 0.4), gpu, iters=50,
        plain_iters=5)
    nms_floor = graph_ms(lambda: NMS.empty_launch(*tp.shape, dev), 50)
    live = (tp > 0).sum(dim=1).tolist()
    bounds["nms_per_class"] = bound(
        tb.numel() * 4 + 2 * tp.numel() * 4,
        IOU_FLOPS * sum(k * (k - 1) // 2 for k in live), "f32")
    errs["nms_per_class"] = nms_err
    log(f"time {tag} NMS launch floor (an empty kernel, same launch shape, "
        f"graph): {nms_floor} ms; kernel "
        f"{times['nms_per_class'][0] / nms_floor:.1f}x the floor [{gpu}]")
    for name in ("phase_train_fwd", "phase_stem_pair", "stem_pair",
                 "nms_per_class"):
        log(f"bound {tag} {name}: {bounds[name][0]} ms by {bounds[name][1]};"
            f" kernel {times[name][0] / bounds[name][0]:.2f}x [{gpu}]")

    # the batch-128 engines' images/s (host clock around queued batches,
    # one sync), in turns; the batch-1 engines' device time a frame
    for kind, pair in (("bf16", (bf, bf_stem)), ("int8 u8", (q_plain,
                                                             q_stem))):
        kw = {"input_dtype": torch.uint8} if kind == "int8 u8" else {}
        for name, eng in zip(("plain", "phase stem", "phase stem", "plain"),
                             (*pair, *reversed(pair))):
            r = eng.benchmark(iters=10, warmup=2, **kw)
            log(f"time {tag} {kind} engine B={BATCH}, {name}: "
                f"{r['images_per_sec']} images/s ({r['sec_per_batch']} "
                f"s/batch) [{gpu}]")
    for name, eng in (("bf16 fused stem", lat_f), ("bf16 plain", lat_p),
                      ("int8", lat8)):
        ms = eng.device_benchmark(reps=30)["device_ms_per_frame"]
        log(f"time {tag} LatencyEngine {name} per frame (CUDA events, 30 "
            f"queued frames): {ms} ms [{gpu}]")
    # torch.profiler over a bf16 and an int8 batch with their stems
    name = f"{tag} ThroughputEngine bf16 + phase stem B={BATCH}, per batch"
    seen = profile(name, lambda: bf_stem(x_b), 3, gpu)
    assert_conv_tensor_core(name, seen, 3, {
        "fwd_tc_kernel": 1, "fwd_fold_kernel": 1, "fwdstats_tc_kernel": 0,
        "fwdstats_fold_kernel": 0, "fwdstats_kernel": 0})
    assert not any(named(k, key) for k in ("colsum_kernel", "apply_kernel")
                   for key in seen), (name, seen)
    name = f"{tag} int8 engine B={BATCH} u8, phase stem, per batch"
    seen = profile(name, lambda: q_stem(frames_u8), 3, gpu)
    assert any("phase_pair_tc_kernel" in k for k in seen), (name, seen)
    assert not any(named("phase_pair_kernel", k) for k in seen), (name, seen)
    log(f"  {name}: the stem ran as phase_pair_tc_kernel (int8 tensor "
        f"cores), no phase_pair_kernel")
    log(f"phase 25 ok: {tag} times, bounds and profiles; peak device "
        f"memory since phase 22 "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{gpu}]")

    replaces = {
        "nms_per_class": "sr_object_detection_tpu/kernels/nms_pallas.py:29",
        "stem_pair": "sr_object_detection_tpu/kernels/b1_stem.py:82",
        "phase_stem_pair":
            "sr_object_detection_tpu/kernels/phase_stem.py:235",
        "phase_train_fwd":
            "sr_object_detection_tpu/kernels/phase_train.py:209"}
    sources = {"nms_per_class": "nms.cu", "stem_pair": "phase_train.cu",
               "phase_stem_pair": "phase_stem.cu",
               "phase_train_fwd": "phase_train.cu"}
    return [{"name": name, "route": "cuda",
             "source": f"sr_object_detection_tpu_torch/csrc/{sources[name]}",
             "replaces": replaces[name], "launches": launches_y[name],
             "max_abs_err": errs[name], "ms": times[name][0],
             "plain_ms": times[name][1], "bound_ms": bounds[name][0],
             "bound_by": bounds[name][1], "library_ms": None}
            for name in replaces]


Y2_CHUNK = 16      # images a plain version takes at once at 608
Y_ALT = 416        # a multi-scale size for Trainer._step_for


def yolov2_608_train(gpu, dev, reset_counts, counts):
    """Phases 26-28 (the module docstring): yolov2-608 training. Returns
    the kernels line's entries for the pair's and the fused stem's
    kernels at yolov2-608's training shapes."""
    import torch.nn.functional as F
    from sr_object_detection_tpu_torch.graph.spec import parse_network_cfg
    from sr_object_detection_tpu_torch.infer.engine import analytic_flops
    from sr_object_detection_tpu_torch.io.weights import (
        init_params, load_weights)
    from sr_object_detection_tpu_torch.kernels import fused_stem as FS
    from sr_object_detection_tpu_torch.kernels import phase_train as PT
    from sr_object_detection_tpu_torch.models.zoo import yolov2
    from sr_object_detection_tpu_torch.ops import conv as C
    from sr_object_detection_tpu_torch.ops import pooling as P
    from sr_object_detection_tpu_torch.train.trainer import Trainer
    tag = f"yolov2-{Y_NET}"
    bf16 = torch.bfloat16
    GiB = 2 ** 30

    # ---------------------------------------------------------- phase 26
    # the pair (3 -> 32) at 608 and at 152 (W2 = 76, partial 8x8 pooled
    # tiles), B=128, and F2/B1/B2 at the four fused-stem pairs, against
    # their plain versions; each time from a CUDA graph in turns with
    # its plain version, beside its bound
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times, bounds, errs, plains, library = {}, {}, {}, {}, {}
    conv0, tc0 = dict(PT.conv_kernels["fwdstats"]), dict(PT.bwdg_kernels)
    pair_errs = {}
    for h, chunk in ((Y_NET // 4, None), (Y_NET, Y2_CHUNK)):
        case = train_case(26 + h, BATCH, h, 3, 32, dev)
        e = check_train_kernels(PT, case, chunk=chunk)
        pair_errs[h] = e
        log(f"  pair 3->32 @{h} B={BATCH}: fwdstats, apply, bwdg == plain "
            f"(max |err| {e}; W2 = {h // 2}: "
            f"{'whole' if (h // 2) % 8 == 0 else 'partial'} 8x8 pooled "
            f"tiles) ({time.perf_counter() - T0:.1f} s)")
        if h != Y_NET:
            del case
            continue
        x0, w0, dp0 = case["x"], case["w"], case["dp"]
        sh0, sc0, b0 = case["shift"], case["scales"], case["biases"]
        f1, f2 = (PT.fwdstats(x0, w0, sh0, sc0) for _ in range(2))
        assert all(torch.equal(a, b) for a, b in zip(f1, f2))
        z0, am0, st0 = f1
        del f1, f2
        n0 = BATCH * h * h
        mean0, _, inv0 = PT._batch_stats(st0, sh0, n0)
        bw = [PT.bwdg(x0, dp0, z0, am0, mean0, inv0, sc0, b0)
              for _ in range(2)]
        assert all(torch.equal(a, b) for a, b in zip(*bw))
        del bw
    assert PT.conv_kernels["fwdstats"]["tensor_core_fold"] - conv0[
        "tensor_core_fold"] == 4 and PT.conv_kernels["fwdstats"][
        "fp32_core"] == conv0["fp32_core"], PT.conv_kernels
    assert PT.bwdg_kernels == {"tensor_core": tc0["tensor_core"] + 4,
                               "fp32_core": tc0["fp32_core"]}
    # the pair's gradient against a float64 evaluation of the unfused
    # chain's formulas: at 608 on 16 images (the float64 evaluation holds
    # several 1.5 GB copies of the conv output), at 152 on all 128
    grads = {}
    for h, b in ((Y_NET, 16), (Y_NET // 4, BATCH)):
        grads[h] = check_pair_gradient(
            PT, C, P, pair_spec(h, 3, 32),
            train_case(260 + h, b, h, 3, 32, dev, flat=False))
        torch.cuda.empty_cache()
    # times: fwdstats, apply and bwdg at 608 B=128
    x_bytes = 2 * x0.numel()
    pooled = z0.numel()
    conv_ops = 2 * BATCH * Y_NET * Y_NET * 32 * 27
    name = "phase_train_fwdstats"
    times[name] = abba_graph(f"{tag} {name} 3->32 B={BATCH}",
                             lambda: PT.fwdstats(x0, w0, sh0, sc0),
                             lambda: PT.fwdstats_plain(x0, w0, sh0, sc0),
                             gpu, plain_iters=2)
    bounds[name] = bound(x_bytes + 2 * 27 * 32 + 8 * 32 + 3 * pooled
                         + 8 * 32, conv_ops, "bf16")
    xc0, wc0 = x0.permute(0, 3, 1, 2), w0.permute(3, 2, 0, 1).contiguous()
    library[name] = (cuda_ms(lambda: F.conv2d(xc0, wc0, padding=1), 5)
                     + cuda_ms(lambda: F.conv2d(xc0, wc0, padding=1), 5)) / 2
    del xc0
    name = "phase_train_apply"
    times[name] = abba_graph(
        f"{tag} {name} 32 ch B={BATCH}",
        lambda: PT.apply(z0, mean0, inv0, sc0, b0),
        lambda: PT.apply_plain(z0, mean0, inv0, sc0, b0), gpu,
        plain_iters=2)
    bounds[name] = bound(4 * pooled + 16 * 32, 6 * pooled, "bf16")
    name = "phase_train_bwdg"
    times[name] = abba_graph(
        f"{tag} {name} 3->32 B={BATCH}",
        lambda: PT.bwdg(x0, dp0, z0, am0, mean0, inv0, sc0, b0),
        lambda: PT.bwdg_plain(x0, dp0, z0, am0, mean0, inv0, sc0, b0), gpu,
        plain_iters=2)
    bounds[name] = bound(
        x_bytes + 5 * pooled + 16 * 32
        + 4 * (2 * 32 + 27 * 32 + 27 + 27 * 27),
        2 * BATCH * Y_NET * Y_NET * 27 * 27 + 2 * pooled * 27, "bf16")
    for name in ("phase_train_fwdstats", "phase_train_apply",
                 "phase_train_bwdg"):
        errs[name] = pair_errs[Y_NET][name[len("phase_train_"):]]
        log(f"bound {tag} {name}: {bounds[name][0]} ms by {bounds[name][1]}"
            f"; kernel {times[name][0] / bounds[name][0]:.2f}x [{gpu}]")
    log(f"time {tag} library F.conv2d bf16 (cuDNN, the conv alone) 3->32 "
        f"B={BATCH}: {library['phase_train_fwdstats']} ms [{gpu}]")
    del case, x0, w0, dp0, z0, am0
    torch.cuda.empty_cache()
    # F2, B1 and B2 at the four fused-stem pairs' conv outputs, B=128,
    # channels-last as the conv writes them; the plain versions 16 or 32
    # images at a time for the check, the whole batch for the time
    stem_errs = {"f2": 0.0, "b1": 0.0, "b2": 0.0}
    # per kernel: kernel ms, plain ms, bound ms summed over the pairs, and
    # the largest pair's (bound, bound_by)
    fs = {n: [0.0, 0.0, 0.0, (0.0, "bytes")] for n in ("f2", "b1", "b2")}
    # the fused-stem pairs (layer, H, C): layers 0, 2, 6 and 10
    for li, h, c in ((0, Y_NET, 32), (2, Y_NET // 2, 64),
                     (6, Y_NET // 4, 128), (10, Y_NET // 8, 256)):
        scase = stem_case(2600 + li, BATCH, h, c, dev)
        paths0 = dict(FS.paths)
        y2 = scase["y"]
        past = images_past_2g(y2)
        e = check_fused_stem_kernels(FS, scase, chunk=Y2_CHUNK if h == Y_NET
                                     else 2 * Y2_CHUNK)
        stem_errs = {n: max(stem_errs[n], e[n]) for n in e}
        # the check's launches: F2 once, B1 twice, B2 once, row kernels
        assert {k: FS.paths[k] - paths0[k] for k in FS.paths} == {
            **dict.fromkeys(FS.paths, 0), "f2_row": 1, "b1_row": 2,
            "b2_row": 1}, FS.paths
        log(f"  fused stem layer {li} {h}x{h}x{c} B={BATCH}: F2, B1, B2 == "
            f"plain (max |err| {e}); y {y2.numel() * 2 / 1e9:.2f} GB, "
            f"images {past}-{BATCH - 1} wholly past 2^31 bytes"
            f"{' (none)' if past == BATCH else ''} "
            f"({time.perf_counter() - T0:.1f} s)")
        dp2 = scase["dp"]
        k4 = [scase[n] for n in ("mean", "inv", "scales", "biases")]
        s123 = [scase[n] for n in ("c1", "c2", "c3")]
        yb, win = y2.numel() * 2, y2.numel() // 4
        pb = {"f2": bound(yb + yb // 4 + 16 * c, 36 * win, "f32"),
              "b1": bound(yb + yb // 4 + 16 * c + 8 * c, 52 * win, "f32"),
              "b2": bound(2 * yb + yb // 4 + 28 * c, 64 * win, "f32")}
        fns = {"f2": (lambda: FS.f2(y2, *k4), lambda: FS.f2_plain(y2, *k4)),
               "b1": (lambda: FS.b1(y2, dp2, *k4),
                      lambda: FS.b1_plain(y2, dp2, *k4)),
               "b2": (lambda: FS.b2(y2, dp2, *k4, *s123),
                      lambda: FS.b2_plain(y2, dp2, *k4, *s123))}
        for n, (kf, pf) in fns.items():
            k_ms, p_ms = abba_graph(f"{tag} fused_stem {n.upper()} layer "
                                    f"{li} {h}x{h}x{c} B={BATCH}", kf, pf,
                                    gpu, plain_iters=2)
            log(f"bound {tag} fused_stem {n.upper()} layer {li}: "
                f"{pb[n][0]} ms by {pb[n][1]}; kernel "
                f"{k_ms / pb[n][0]:.2f}x [{gpu}]")
            acc = fs[n]
            acc[0] += k_ms
            acc[1] += p_ms
            acc[2] += pb[n][0]
            acc[3] = max(acc[3], pb[n])
        del scase, y2, dp2, k4, s123, fns
        torch.cuda.empty_cache()
    for n, (k_ms, p_ms, b_ms, (_, b_by)) in fs.items():
        name = f"fused_stem_{n}"
        times[name] = (k_ms, p_ms)
        bounds[name] = (b_ms, b_by)
        errs[name] = stem_errs[n]
    torch.cuda.synchronize()
    log(f"phase 26 ok: {tag} training kernels == plain: the pair 3->32 at "
        f"{Y_NET} and {Y_NET // 4} (W2 = {Y_NET // 8}) B={BATCH}, fwdstats "
        f"on the taps fold and bwdg on the tensor cores, two launches of "
        f"each bit-equal; its gradient within {grads[Y_NET]['fused']} "
        f"({Y_NET}, B=16) and {grads[Y_NET // 4]['fused']} ({Y_NET // 4}, "
        f"B={BATCH}) of a "
        f"float64 evaluation (gate 1e-3); F2, B1, B2 at layers 0, 2, 6, 10 "
        f"on the row kernels (max |err| {stem_errs}), layer 0's images "
        f"past 2^31 bytes included; peak device memory "
        f"{torch.cuda.max_memory_allocated() / GiB:.2f} GiB [{gpu}]")

    # ---------------------------------------------------------- phase 27
    # Trainer on yolov2-608 at B=128 (one micro-batch, as the JAX
    # package's bench), 3 steps on one batch a path, each path's peak
    # device memory; input as bench.py's training bench
    base = yolov2(Y_NET, Y_NET)
    yspec = dataclasses.replace(base, net=dataclasses.replace(
        base.net, batch=BATCH, subdivisions=1))
    yparams = init_params(yspec, seed=0)
    gx = torch.Generator(device=dev).manual_seed(27)
    xy = torch.rand((BATCH, Y_NET, Y_NET, 3), generator=gx, device=dev)
    ty_np = np.zeros((BATCH, 30, 5), np.float32)
    ty_np[:, 0] = [0.5, 0.5, 0.3, 0.3, 1]
    ty_np[::2, 1] = [0.3, 0.6, 0.2, 0.25, 17]
    ty = torch.from_numpy(ty_np).to(dev)
    step_flops = 3 * analytic_flops(yspec)
    paths = {
        "(d) bf16 + remat selective:2": dict(remat="selective:2"),
        "(a) bf16 + phase_train + remat selective:2": dict(
            phase_train=True, remat="selective:2"),
        "(b) bf16 + phase_train + fused_stem": dict(phase_train=True,
                                                    fused_stem=True),
        "(c) bf16 + fused_stem": dict(fused_stem=True)}
    pair1 = dict(phase_train_fwdstats=1, phase_train_apply=1,
                 phase_train_bwdg=1)
    per_step = {
        "(d) bf16 + remat selective:2": {},
        "(a) bf16 + phase_train + remat selective:2": pair1,
        "(b) bf16 + phase_train + fused_stem": dict(
            pair1, fused_stem_f2=3, fused_stem_b1=3, fused_stem_b2=3),
        "(c) bf16 + fused_stem": dict(fused_stem_f2=4, fused_stem_b1=4,
                                      fused_stem_b2=4)}

    def trainer(**kw):
        return Trainer(yspec, yparams, device=dev, compute_dtype=bf16,
                       **kw)

    first, peaks, launches_p = {}, {}, {}
    for name, kw in paths.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr = trainer(**kw)
        reset_counts()
        losses = [float(tr.step(xy, ty)["loss"]) for _ in range(3)]
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() / GiB
        got, want = counts(**{k: 3 * v for k, v in per_step[name].items()})
        assert got == want, (name, got)
        assert FS.paths == {"f2_row": got["fused_stem_f2"],
                            "b1_row": got["fused_stem_b1"],
                            "b2_row": got["fused_stem_b2"], "f2": 0,
                            "b1": 0, "b2": 0}, (name, FS.paths)
        assert not any(c["fp32_core"] for c in PT.conv_kernels.values())
        assert PT.bwdg_kernels["fp32_core"] == 0
        assert all(np.isfinite(losses)), (name, losses)
        first[name] = losses[0]
        ref = first["(d) bf16 + remat selective:2"]
        assert abs(losses[0] - ref) <= 0.03 * abs(ref) + 0.05, (
            name, losses[0], ref)
        launches_p[name] = got
        log(f"  Trainer {tag} {name} B={BATCH}, 3 steps: losses {losses}; "
            f"launches {dict((k, v) for k, v in got.items() if v)}; peak "
            f"device memory {peaks[name]:.2f} GiB "
            f"({time.perf_counter() - T0:.1f} s)")
        ips = step_rate(tr, xy, ty, 3)
        log(f"time Trainer.step {tag} {name} B={BATCH}: {ips} images/s, "
            f"{ips * step_flops / 1e12} TFLOP/s, MFU "
            f"{ips * step_flops / PEAK_OPS_S['bf16']} of the bf16 dense "
            f"peak [{gpu}]")
        seen = profile(f"Trainer.step {tag} {name} B={BATCH}, per step",
                       lambda: tr.step(xy, ty), 1, gpu, top=8)
        if "fused_stem" in name:
            assert_fused_stem_rows(name, seen)
        if "phase_train" in name:
            assert_bwdg_tensor_core(name, seen)
        if name.startswith("(a)"):
            # one step at another size through Trainer._step_for
            x_alt = torch.rand((BATCH, Y_ALT, Y_ALT, 3), generator=gx,
                               device=dev)
            reset_counts()
            l_alt = float(tr.step(x_alt, ty)["loss"])
            got_alt, want_alt = counts(**pair1)
            assert (Y_ALT, Y_ALT) in tr._steps and got_alt == want_alt, (
                got_alt)
            assert np.isfinite(l_alt), l_alt
            log(f"  {name} at {Y_ALT} through Trainer._step_for: loss "
                f"{l_alt}, launches "
                f"{dict((k, v) for k, v in got_alt.items() if v)}")
            del x_alt
        del tr
    # remat against no remat, for (a) (the pair's output is layer 1's,
    # which selective:2 saves: nothing is checkpointed) and (d) (layer 0
    # is checkpointed): the first loss and the parameters after one step
    # against the spread of two runs without remat; the peak memory
    # without remat
    for name, kw in (("(a)", dict(phase_train=True)), ("(d)", {})):
        runs = []
        for remat in (False, False, "selective:2"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            tr = trainer(remat=remat, **kw)
            loss = float(tr.step(xy, ty)["loss"])
            flat = torch.cat([v.float().flatten() for p in tr.state.params
                              for _, v in sorted(p.items())])
            runs.append((loss, flat, torch.cuda.max_memory_allocated() / GiB))
            del tr
        (l1, p1, m1), (l2, p2, m2), (l3, p3, m3) = runs
        spread = (p1 - p2).abs().max().item()
        apart = (p3 - p1).abs().max().item()
        assert apart <= 2 * spread, (name, apart, spread)
        if name == "(a)":
            assert l3 == l1, (l3, l1)
        else:
            assert abs(l3 - l1) <= 2 * abs(l2 - l1), (l3, l1, l2)
        peaks[f"{name} without remat"] = max(m1, m2)
        log(f"  {name} remat selective:2 against none: first losses {l3} / "
            f"{l1}, {l2}; parameters after one step max |diff| {apart} "
            f"(two runs without remat: {spread}); peak device memory "
            f"{m3:.2f} GiB with remat, {max(m1, m2):.2f} GiB without")
        del runs, p1, p2, p3
    # phase_train="chain": the chain refuses layer 2 at Cin 32 and runs
    # the single pair
    torch.cuda.empty_cache()
    tr = trainer(phase_train="chain")
    reset_counts()
    float(tr.step(xy, ty)["loss"])
    got, want = counts(**pair1)
    assert got == want, got
    del tr
    torch.cuda.empty_cache()
    log(f"phase 27 ok: {tag} Trainer B={BATCH}, paths (a)-(d) 3 steps each "
        f"with the launch counts a step {per_step}; first losses within "
        f"0.03*|loss| + 0.05 of (d)'s {first['(d) bf16 + remat selective:2']}"
        f"; phase_train=\"chain\" ran the pair alone (no red, dy or dgrad); "
        f"peak device memory by path "
        f"{ {k: round(v, 2) for k, v in peaks.items()} } GiB [{gpu}]")

    # ---------------------------------------------------------- phase 28
    # `cli detector train -bf16` on the yolov2 cfg at its published
    # training batch (batch=64, subdivisions=8), 2 iterations on
    # synthetic PPMs; random=1 resizes to one of 320..608 at iteration 1
    g416 = np.load(GOLDEN / "yolo_coco_416.npz")
    cfg_text = bytes(g416["cfg"]).decode()
    WORK.mkdir(parents=True, exist_ok=True)
    ycfg = WORK / f"yolo-{Y_NET}-train.cfg"
    ycfg.write_text(train_cfg_text(cfg_text, size=Y_NET, batch=64,
                                   subdivisions=8, max_batches=2))
    lst = write_ppm_dataset(WORK / "coco-synth", 128, classes=80, seed=28)
    backup = WORK / "backup-yolo"
    data_cfg = WORK / "coco-synth.data"
    data_cfg.write_text(f"classes=80\ntrain={lst}\nbackup={backup}\n")
    final = backup / f"{ycfg.stem}_final.weights"
    final.unlink(missing_ok=True)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "sr_object_detection_tpu_torch.apps.cli",
         "detector", "train", str(data_cfg), str(ycfg), "-bf16"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    iters = [l for l in lines if l.split(":")[0] in ("1", "2")]
    resized = [l for l in lines if l.startswith("Resizing")]
    assert len(iters) == 2 and len(resized) == 1, res.stdout[-2000:]
    assert all(np.isfinite(float(l.split()[1].rstrip(","))) for l in iters)
    cspec = parse_network_cfg(str(ycfg))
    got_w, seen_w = load_weights(cspec, str(final))
    init_w = init_params(cspec, seed=0)
    assert seen_w == 2 * 64
    assert not np.allclose(got_w[0]["rolling_mean"],
                           init_w[0]["rolling_mean"])
    log(f"phase 28 ok: cli detector train -bf16 on {ycfg.name} (batch=64, "
        f"subdivisions=8) ran 2 iterations in "
        f"{time.perf_counter() - t0:.1f} s ({resized[0]}; "
        f"{' | '.join(iters)}); {final.name} loads, seen {seen_w}, layer "
        f"0's rolling statistics moved [{gpu}]")

    launches_k = {
        **{k: launches_p["(a) bf16 + phase_train + remat selective:2"][k]
           for k in ("phase_train_fwdstats", "phase_train_apply",
                     "phase_train_bwdg")},
        **{k: launches_p["(c) bf16 + fused_stem"][k]
           for k in ("fused_stem_f2", "fused_stem_b1", "fused_stem_b2")}}
    replaces = {
        "phase_train_fwdstats":
            "sr_object_detection_tpu/kernels/phase_train.py:209",
        "phase_train_apply":
            "sr_object_detection_tpu/kernels/phase_train.py:722",
        "phase_train_bwdg":
            "sr_object_detection_tpu/kernels/phase_train.py:209",
        "fused_stem_f2": "sr_object_detection_tpu/kernels/fused_stem.py:135",
        "fused_stem_b1": "sr_object_detection_tpu/kernels/fused_stem.py:170",
        "fused_stem_b2": "sr_object_detection_tpu/kernels/fused_stem.py:187"}
    shapes = {"phase_train": f"3->32 @{Y_NET} B={BATCH}",
              "fused_stem": f"layers 0, 2, 6, 10 B={BATCH}"}
    return [{"name": f"{name} ({tag} training: "
                     f"{shapes[name.rsplit('_', 1)[0]]})", "route": "cuda",
             "source": "sr_object_detection_tpu_torch/csrc/"
                       + ("phase_train.cu" if name.startswith("phase")
                          else "fused_stem.cu"),
             "replaces": replaces[name], "launches": launches_k[name],
             "max_abs_err": errs[name], "ms": times[name][0],
             "plain_ms": times[name][1], "bound_ms": bounds[name][0],
             "bound_by": bounds[name][1],
             "library_ms": library.get(name)}
            for name in replaces]


def main() -> int:
    # ---------------------------------------------------------- phase 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    gpu = card()
    log(gpu)
    from sr_object_detection_tpu_torch.infer.detector import (
        Detector, disable_tf32)
    from sr_object_detection_tpu_torch.infer.engine import (
        LatencyEngine, fold_params_for_inference)
    from sr_object_detection_tpu_torch.io.convert import params_to_torch
    from sr_object_detection_tpu_torch.io.weights import (
        init_params, save_weights)
    from sr_object_detection_tpu_torch.kernels import _build
    from sr_object_detection_tpu_torch.kernels import b1_stem as BS
    from sr_object_detection_tpu_torch.kernels import fused_stem as FS
    from sr_object_detection_tpu_torch.kernels import nms as NMS
    from sr_object_detection_tpu_torch.kernels import phase_stem as PS
    from sr_object_detection_tpu_torch.kernels import phase_train as PT
    from sr_object_detection_tpu_torch.models.zoo import tiny_yolo_voc
    from sr_object_detection_tpu_torch.ops import boxes as B

    disable_tf32()
    dev = torch.device("cuda")

    def reset_counts():
        """Every kernel's launch count to 0."""
        NMS.launches = 0
        BS.reset_launches()
        PS.reset_launches()
        PT.reset_launches()
        FS.reset_launches()

    def counts(**expected):
        """(every kernel's launch count, the counts ``expected`` names with
        0 for the rest), under the names of the kernels JSON line."""
        got = {"nms_per_class": NMS.launches, "stem_pair": BS.launches,
               "phase_stem_pair": PS.launches,
               **{f"phase_train_{k}": v for k, v in PT.launches.items()},
               **{f"fused_stem_{k}": v for k, v in FS.launches.items()}}
        return got, {k: expected.get(k, 0) for k in got}
    t0 = time.perf_counter()
    _build.load()
    log(f"phase 0 ok: kernels built and loaded in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds} s) "
        f"from {_build.library_path().relative_to(ROOT)} [{gpu}]")

    # ---------------------------------------------------------- phase 1
    rng = np.random.default_rng(0)
    nms_err, nms_cases = 0.0, []
    before = NMS.launches
    for k in (128, 845):
        n, c = 845, 20
        boxes = np.stack([rng.uniform(0, 1, n), rng.uniform(0, 1, n),
                          rng.uniform(.02, .4, n), rng.uniform(.02, .4, n)],
                         axis=1).astype(np.float32)
        boxes[100:110] = boxes[99]                      # duplicate boxes
        probs = rng.uniform(0, 1, (n, c)).astype(np.float32) ** 4
        probs[probs < 0.05] = 0
        probs[::7, 3] = probs[0, 3]                     # equal probs
        probs[100:110, 5] = 0.5                         # equal on equal
        tb, tp, _ = B.topk_candidates(torch.from_numpy(boxes).to(dev),
                                      torch.from_numpy(probs).to(dev), k)
        got = NMS.nms_per_class(tb, tp, 0.4)
        ref = NMS.nms_per_class_plain(tb, tp, 0.4)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), f"NMS differs from plain, k={k}"
        nms_err = max(nms_err, (got - ref).abs().max().item())
        nms_cases.append((k, tb, tp))
    assert NMS.launches == before + 2
    # device time from a CUDA graph, beside the launch floor: an empty
    # kernel with the same grid, block and shared memory
    for k, tb, tp in nms_cases:
        g_ms = graph_ms(lambda: NMS.nms_per_class(tb, tp, 0.4), 50)
        f_ms = graph_ms(lambda: NMS.empty_launch(20, k, dev), 50)
        log(f"time nms_per_class C=20 k={k} from a CUDA graph: {g_ms} ms; "
            f"launch floor (empty kernel, same launch shape, graph) "
            f"{f_ms} ms; {g_ms / f_ms:.1f}x the floor [{gpu}]")
    log(f"phase 1 ok: NMS kernel torch.equal to plain at C=20 k=128,845 "
        f"(max |err| {nms_err}) [{gpu}]")

    # ---------------------------------------------------------- phase 2
    spec = tiny_yolo_voc()
    params_np = random_bn(init_params(spec, seed=0), 1, head_gain=8.0)
    folded, fspec = fold_params_for_inference(
        spec, params_to_torch(spec, params_np, dev), torch.bfloat16)
    pairs = BS.plan_pairs(fspec)
    assert pairs == [(0, 1), (2, 3), (4, 5), (6, 7)], pairs
    stem_err = 0.0
    pair_inputs = []
    x = torch.from_numpy(rng.uniform(0, 1, (1, 416, 416, 3)).astype(
        np.float32)).to(dev, torch.bfloat16)
    # pair 1 (Cin 3) on the tile's taps fold, pairs 2-4 on the tile
    stem_paths = {"tensor_core": 3, "tensor_core_fold": 1, "fp32_core": 0}
    BS.reset_launches()
    for ci, _ in pairs:
        l = fspec.layers[ci]
        w = torch.from_numpy(rng.normal(0, 0.3, (3, 3, l.c, l.filters))
                             .astype(np.float32)).to(dev, torch.bfloat16)
        b = torch.from_numpy(rng.normal(0, 0.3, l.filters).astype(
            np.float32)).to(dev)
        xi = torch.from_numpy(rng.uniform(0, 1, (1, l.h, l.w, l.c)).astype(
            np.float32)).to(dev, torch.bfloat16)
        pair_inputs.append((xi, w, b))
        e = bf16_err(BS.stem_pair(xi, w, b), BS.stem_pair_plain(xi, w, b))
        stem_err = max(stem_err, e)
        log(f"  stem pair {l.c}->{l.filters} @{l.h}: max |err| {e} "
            f"({PT.conv_path('stem', l.c, l.filters)})")
    assert BS.paths == stem_paths, BS.paths
    stem_fn, n_stem = BS.build_stem(fspec, folded)
    assert n_stem == 8
    packed = [(folded[ci]["weights"].permute(2, 3, 1, 0).to(torch.bfloat16)
               .contiguous(), folded[ci]["biases"].float())
              for ci, _ in pairs]

    def plain_stem(v):
        for w, b in packed:
            v = BS.stem_pair_plain(v, w, b)
        return v
    # the chain link by link: each kernel output against the plain
    # version on the same input (the kernel's previous output); a 1-ulp
    # difference fed on to the next pair may grow, so the two whole
    # chains are compared for information only
    v = x
    for w, b in packed:
        out = BS.stem_pair(v, w, b)
        stem_err = max(stem_err, bf16_err(out, BS.stem_pair_plain(v, w, b)))
        v = out
    assert torch.equal(stem_fn(x), v)
    chain_diff = (stem_fn(x).float() - plain_stem(x).float()).abs().max()
    torch.cuda.synchronize()
    assert BS.paths == {k: 4 * n for k, n in stem_paths.items()}, BS.paths
    log(f"phase 2 ok: stem kernel (tensor-core conv tile, launches by path "
        f"{BS.paths}) == plain at the 4 pair shapes and along "
        f"the chain (max |err| {stem_err}); whole chain against the plain "
        f"chain: max |diff| {chain_diff.item()} [{gpu}]")

    # ---------------------------------------------------------- phase 3
    WORK.mkdir(parents=True, exist_ok=True)
    g = np.load(GOLDEN / "detect_tiny_yolo.npz")
    cfg = WORK / "tiny-yolo-voc.cfg"
    cfg.write_text(bytes(g["cfg"]).decode())
    weights = WORK / "random.weights"
    save_weights(spec, params_np, str(weights))
    det = Detector(str(cfg), str(weights), device=dev)
    det_cpu = Detector(str(cfg), str(weights), device="cpu")
    frames = [rng.uniform(0, 1, (480, 640, 3)).astype(np.float32)
              for _ in range(3)]
    _, p_cpu = det_cpu.predict_batch(det_cpu.preprocess(frames[0])[None])
    thresh = float(np.sort(p_cpu[0].max(-1).values.numpy())[::-1][10])
    u8 = [rng.integers(0, 256, (416, 416, 3), dtype=np.uint8)
          for _ in range(3)]
    fused = LatencyEngine(spec, params_np, device=dev, fused_stem=True)
    plain = LatencyEngine(spec, params_np, device=dev)
    assert fused.fused_stem and not plain.fused_stem

    reset_counts()
    n_dets = 0
    for f in frames:
        got, want = (
            [(d.class_id, d.prob, np.asarray(d.box)) for d in
             d_.detect(f, thresh=thresh - 1e-4)] for d_ in (det, det_cpu))
        n_dets += match_dets(got, want, thresh, 1e-4)
    # the C-oracle golden, float32 on CUDA (gates of test_parity.py)
    gspec_params = init_params(spec, seed=int(g["seed"]))
    save_weights(spec, gspec_params, str(WORK / "golden.weights"))
    gdet = Detector(str(cfg), str(WORK / "golden.weights"), device=dev)
    gb, gp = gdet.predict_batch(np.transpose(g["input_chw"], (1, 2, 0))[None])
    gp = torch.where(gp[0] > float(g["thresh"]), gp[0], 0.0)
    gp = NMS.nms_sort_topk(gb[0], gp, float(g["nms"]), k=gb.shape[1])
    gb, gp = gb[0].cpu().numpy(), gp.cpu().numpy()
    assert np.allclose(gb, g["boxes"], rtol=2e-4, atol=2e-4)
    assert np.array_equal(gp > 0, g["probs"] > 0)
    assert np.allclose(gp, g["probs"], rtol=3e-4, atol=3e-4)
    golden_err = float(np.abs(gp - g["probs"]).max())
    # the batch-1 bf16 engine, fused stem against the plain chain: the
    # stem rounds once (fused) or twice (plain), so probs may differ by
    # a few bf16 ulps; the band keeps every compared candidate inside
    # both top-64 lists
    n_cands = 0
    for f in u8:
        out_f, out_p = fused(f), plain(f)
        for bx, pr in (out_f, out_p):
            assert bx.shape == (64, 4) and pr.shape == (64, 20)
            assert torch.isfinite(bx).all() and torch.isfinite(pr).all()
        cf, cp = candidates(*out_f), candidates(*out_p)
        best = sorted((p for _, p, _ in cp), reverse=True)
        thr, margin = best[8] - 0.02, 0.02
        assert max(min(p for _, p, _ in c) for c in (cf, cp)) < thr - margin
        n_cands += match_dets(cf, cp, thr, margin)
    torch.cuda.synchronize()
    launches, want = counts(nms_per_class=4, stem_pair=12)
    log(f"phase 3 ok: {n_dets} detections matched on CUDA and CPU; golden "
        f"gates met on CUDA (max |prob err| {golden_err}); {n_cands} "
        f"candidates matched between the fused and plain engines; "
        f"launches {launches}, the stem's by path {BS.paths} [{gpu}]")
    assert launches == want, launches
    assert BS.paths == {k: 3 * n for k, n in stem_paths.items()}, BS.paths

    # ---------------------------------------------------------- phase 4
    req = b"".join(struct.pack("<3if", f.shape[1], f.shape[0], f.shape[2],
                               thresh) + f.astype("<f4").tobytes()
                   for f in frames) + struct.pack("<3if", 0, 0, 0, 0.0)
    proc = subprocess.Popen(
        [sys.executable, "-m", "sr_object_detection_tpu_torch.infer.serve",
         str(cfg), str(weights)], cwd=ROOT, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        out, err = proc.communicate(req, timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err.decode()[-2000:]
    magic, nw, nh, n_boxes, classes = struct.unpack("<5i", out[:20])
    assert (magic, nw, nh, n_boxes, classes) == (0x53524456, 416, 416, 845,
                                                 20)
    per = 4 * n_boxes * (4 + classes)
    assert len(out) == 20 + 3 * per
    for i, f in enumerate(frames):
        blob = np.frombuffer(out[20 + i * per:20 + (i + 1) * per], "<f4")
        wb, wp = det.predict_batch(det.preprocess(f)[None], thresh=thresh)
        assert np.allclose(blob[:n_boxes * 4].reshape(-1, 4),
                           wb[0].cpu().numpy(), rtol=1e-5, atol=1e-6)
        assert np.allclose(blob[n_boxes * 4:].reshape(-1, classes),
                           wp[0].cpu().numpy(), rtol=1e-5, atol=1e-6)
    log(f"phase 4 ok: the server answered 3 requests, equal to the "
        f"in-process Detector [{gpu}]")

    # ---------------------------------------------------------- phase 5
    # every comparison in turns (plain, kernel, kernel, plain): readings
    # drift within a run and differ between machines
    def abba(name, kernel_fn, plain_fn, iters=50, plain_iters=50):
        warm = min(5, plain_iters)      # slow plain versions: few warm-ups
        p1 = cuda_ms(plain_fn, plain_iters, warm)
        k1, k2 = cuda_ms(kernel_fn, iters), cuda_ms(kernel_fn, iters)
        p2 = cuda_ms(plain_fn, plain_iters, warm)
        log(f"time {name}: kernel {(k1 + k2) / 2} ms ({k1}, {k2}), plain "
            f"{(p1 + p2) / 2} ms ({p1}, {p2}) [{gpu}]")
        return (k1 + k2) / 2, (p1 + p2) / 2

    # the NMS kernel at the main path's shapes: one frame's candidates
    fb, fp = det.predict_batch(det.preprocess(frames[0])[None],
                               thresh=thresh)
    tb, tp, _ = B.topk_candidates(fb[0], fp[0], 128)
    times = {
        "nms_per_class": abba(
            "nms_per_class C=20 k=128",
            lambda: NMS.nms_per_class(tb, tp, 0.4),
            lambda: NMS.nms_per_class_plain(tb, tp, 0.4), plain_iters=10),
        "stem_pair": abba("stem, 4 chained pairs @416",
                          lambda: stem_fn(x), lambda: plain_stem(x)),
    }
    # the chain and each pair replayed from a CUDA graph: the device time
    # without the host's launch cost, which sets the kernel's figures
    # above (the plain chain's are device time); the kernels line carries
    # the chain's graph time
    nms_graph = graph_ms(lambda: NMS.nms_per_class(tb, tp, 0.4), 50)
    nms_floor = graph_ms(lambda: NMS.empty_launch(*tp.shape, dev), 50)
    times["nms_per_class"] = (nms_graph, times["nms_per_class"][1])
    log(f"time nms_per_class C=20 k=128 (a frame's candidates) from a CUDA "
        f"graph: {nms_graph} ms; launch floor {nms_floor} ms [{gpu}]")
    stem_graph = {"chain": graph_ms(lambda: stem_fn(x))}
    times["stem_pair"] = (stem_graph["chain"], times["stem_pair"][1])
    log(f"time stem, 4 chained pairs @416 from a CUDA graph: "
        f"{stem_graph['chain']} ms [{gpu}]")
    for (xi, w, b), (ci, _) in zip(pair_inputs, pairs):
        l = fspec.layers[ci]
        abba(f"stem pair {l.c}->{l.filters} @{l.h}",
             lambda: BS.stem_pair(xi, w, b),
             lambda: BS.stem_pair_plain(xi, w, b))
        stem_graph[ci] = graph_ms(lambda: BS.stem_pair(xi, w, b))
        log(f"time stem pair {l.c}->{l.filters} @{l.h} from a CUDA graph: "
            f"{stem_graph[ci]} ms [{gpu}]")
    abba("LatencyEngine 416 bf16 per u8 frame (kernel = fused stem)",
         lambda: fused(u8[0]), lambda: plain(u8[0]))
    xin = torch.from_numpy(det.preprocess(frames[0])[None]).to(dev)
    log(f"time Detector.predict_batch 416 f32 batch 1: "
        f"{cuda_ms(lambda: det.predict_batch(xin), iters=20)} ms [{gpu}]")
    log(f"time Detector.detect 416 f32 (host resize + NMS kernel): "
        f"{cuda_ms(lambda: det.detect(frames[0], thresh=thresh), iters=10)}"
        f" ms [{gpu}]")

    # bounds of the batch-1 kernels at the timed shapes: NMS moves its
    # candidates once and tests each pair of live boxes of a class once;
    # the stem chain reads each pair's input, weights and bias and writes
    # its output once
    live = (tp > 0).sum(dim=1).tolist()
    bounds = {"nms_per_class": bound(
        tb.numel() * 4 + 2 * tp.numel() * 4,
        IOU_FLOPS * sum(n * (n - 1) // 2 for n in live), "f32")}
    log(f"bound nms_per_class C=20 k=128: {bounds['nms_per_class'][0]} ms "
        f"by {bounds['nms_per_class'][1]}; the launch floor {nms_floor} ms "
        f"sets what a launch can take; kernel {nms_graph / nms_floor:.1f}x "
        f"the floor [{gpu}]")
    n_bytes = n_ops = 0
    for (w, b), (ci, _) in zip(packed, pairs):
        l = fspec.layers[ci]
        p_bytes = (2 * (l.h * l.w * l.c + l.out_h // 2 * l.out_w // 2
                        * l.filters) + 2 * w.numel() + 4 * b.numel())
        p_ops = 2 * l.h * l.w * l.filters * 9 * l.c
        b_ms, b_by = bound(p_bytes, p_ops, "bf16")
        log(f"bound stem pair {l.c}->{l.filters} @{l.h}: {b_ms} ms by "
            f"{b_by} [{gpu}]")
        n_bytes += p_bytes
        n_ops += p_ops
    bounds["stem_pair"] = bound(n_bytes, n_ops, "bf16")

    # ---------------------------------------------------------- phase 6
    from sr_object_detection_tpu_torch.infer.engine import (
        ThroughputEngine, best_latency_engine)
    from sr_object_detection_tpu_torch.infer.quant import (
        QuantizedThroughputEngine)
    qspec = tiny_yolo_voc(width=NET, height=NET)
    qparams_np = random_bn(init_params(qspec, seed=0), 1, head_gain=8.0)
    calib_q = rng.uniform(0, 1, (8, NET, NET, 3)).astype(np.float32)
    q_stem = QuantizedThroughputEngine(qspec, qparams_np, batch=BATCH,
                                       device=dev, calib_x=calib_q,
                                       phase_stem=True)
    q_plain = QuantizedThroughputEngine(qspec, qparams_np, batch=BATCH,
                                        device=dev, calib_x=calib_q)
    qn = q_stem.qnet
    qpairs = PS.plan_pairs(qn.spec)
    assert qpairs == [(0, 1), (2, 3), (4, 5), (6, 7)], qpairs
    ps_err = 0
    # the K fold of each pair's tensor-core GEMM (kernels/phase_stem.py)
    pair_folds = ("taps", "tap_pairs", "chunks", "chunks")
    for k, (ci, _) in enumerate(qpairs):
        l = qn.spec.layers[ci]
        for x_dtype in ([np.uint8, np.float32, np.int8] if k == 0
                        else [np.int8]):
            PS.reset_launches()
            case = phase_pair_case(100 + k, BATCH, l.h, l.c, l.filters,
                                   x_dtype)
            args = (*(torch.from_numpy(a).to(dev) for a in case[:4]),
                    float(case[4]),
                    None if case[5] is None else float(case[5]))
            got = PS.stem_pair_i8(*args)
            assert PS.folds[pair_folds[k]] == PS.launches == 1, PS.folds
            ref = PS.stem_pair_i8_plain(*args)
            torch.cuda.synchronize()
            err = (got.int() - ref.int()).abs().max().item()
            assert torch.equal(got, ref), (l.c, l.filters, x_dtype, err)
            ps_err = max(ps_err, err)
            del args, got, ref
        torch.cuda.empty_cache()
        log(f"  int8 stem pair {l.c}->{l.filters} @{l.h} B={BATCH}: "
            f"kernel == plain (tensor cores, {pair_folds[k]} fold)")
    # the engine's own chain from u8 frames, link by link (same input to
    # kernel and plain), then whole
    frames_u8 = torch.from_numpy(rng.integers(
        0, 256, (BATCH, NET, NET, 3), dtype=np.uint8)).to(dev)
    links = [(qn.qparams[ci]["weights"], qn.qparams[ci]["dequant"],
              qn.qparams[ci]["biases"],
              float(np.float32(1.0 / qn.act_scales[ci])))
             for ci, _ in qpairs]
    inv_u8 = float(np.float32(1.0 / (255.0 * qn.in_scale)))

    def int8_chain(v, pair_fn):
        for w, dq, b, inv_out in links:
            v = pair_fn(v, w, dq, b, inv_out,
                        inv_u8 if v.dtype == torch.uint8 else None)
        return v
    v = frames_u8
    ps_inputs = []       # each pair's input on the engine's chain
    for (w, dq, b, inv_out), (ci, _) in zip(links, qpairs):
        ii = inv_u8 if v.dtype == torch.uint8 else None
        ps_inputs.append((qn.spec.layers[ci], (v, w, dq, b, inv_out, ii)))
        out = PS.stem_pair_i8(v, w, dq, b, inv_out, ii)
        assert torch.equal(out, PS.stem_pair_i8_plain(v, w, dq, b, inv_out,
                                                      ii))
        v = out
    # two launches on the same input: bit-equal
    assert torch.equal(PS.stem_pair_i8(*ps_inputs[0][1]),
                       PS.stem_pair_i8(*ps_inputs[0][1]))
    n_stem = qpairs[-1][1] + 1
    assert torch.equal(qn.forward(frames_u8, stop=n_stem), v)
    assert torch.equal(int8_chain(frames_u8, PS.stem_pair_i8_plain), v)
    assert v.abs().max().item() > 60
    log(f"phase 6 ok: int8 stem kernel (phase_pair_tc_kernel, int8 tensor "
        f"cores) == plain at the 4 pair shapes at B={BATCH} (pair 1 from "
        f"u8 and float32 frames and from int8), link by link along the "
        f"engine's chain and whole, two launches bit-equal [{gpu}]")

    # ---------------------------------------------------------- phase 7
    bf = ThroughputEngine(qspec, qparams_np, batch=BATCH, device=dev)
    bf_stem = ThroughputEngine(qspec, qparams_np, batch=BATCH, device=dev,
                               phase_stem=True)
    assert bf_stem.phase_stem
    head = len(qspec.layers) - 2
    r = qspec.layers[-1]
    n_out = r.h * r.w * r.n * (r.coords + r.classes + 1)
    x_b128 = frames_u8.float() / 255.0
    reset_counts()
    out_bf = bf(x_b128)
    out_bfs = bf_stem(x_b128)
    out_s = q_stem(frames_u8)
    out_p = q_plain(frames_u8)
    torch.cuda.synchronize()
    # the bf16 stem: one fwd kernel a pair, no fwdstats, colsum or apply
    launches_b128, want = counts(phase_stem_pair=4, phase_train_fwd=4)
    assert launches_b128 == want, launches_b128
    # the int8 batch's four pairs on the tensor-core kernel, by K fold
    assert PS.folds == {"taps": 1, "tap_pairs": 1, "chunks": 2}, PS.folds
    # the stem's pairs 2-4 (Cin 16, 32, 64) on the tensor-core conv tile,
    # pair 1 (3 -> 16) on the tile's taps fold, none on the FP32-core path
    fwd_paths = dict(PT.conv_kernels["fwd"])
    assert fwd_paths == {"tensor_core": 3, "tensor_core_fold": 1,
                         "fp32_core": 0}, PT.conv_kernels
    # the bf16 phase stem link by link (the same input to each): the fwd
    # kernel torch.equal to fwdstats + apply with identity BN, within one
    # bf16 ulp of the plain engine's conv + pool layers (ROADMAP queue 3,
    # item 10: where two conv sums round apart, one ulp of the pooled
    # conv value more) and of fwd_pair_plain (assert_fwd_close: there the
    # bias add and the bf16 leaky round once more each)
    v = x_b128.to(torch.bfloat16)
    stem_link_err, fwd_err, fwd_links = 0.0, 0.0, []
    for ci in (0, 2, 4, 6):
        p = bf_stem.params[ci]
        l = qspec.layers[ci]
        cout = p["weights"].shape[0]
        zero = torch.zeros(cout, device=dev)
        one = torch.ones(cout, device=dev)
        w_hwio = p["weights"].permute(2, 3, 1, 0).contiguous()
        bias = p["biases"].float()
        got = PT.fwd_pair(v, w_hwio, bias)
        z, _, _ = PT.fwdstats(v, w_hwio, zero, one)
        comp = PT.apply(z, zero, one, one, bias)
        assert torch.equal(got, comp), (ci, (got != comp).sum().item())
        z_np = z.float().cpu().numpy()
        fwd_err = max(fwd_err, assert_fwd_close(
            got.float().cpu().numpy(),
            PT.fwd_pair_plain(v, w_hwio, bias).float().cpu().numpy(), z_np))
        with torch.no_grad():
            ref = bf._net.layers[ci + 1](bf._net.layers[ci](
                v.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
        stem_link_err = max(stem_link_err, assert_stem_link_close(
            got.float().cpu().numpy(), ref.float().cpu().numpy(), z_np))
        fwd_links.append((l, v, w_hwio, bias))
        del z, comp, ref
        v = got
    assert torch.equal(bf_stem._stem(x_b128), v)
    torch.cuda.empty_cache()
    bfs_diff = (out_bfs.float() - out_bf.float()).abs().max().item()
    for o, dt in ((out_bf, torch.bfloat16), (out_bfs, torch.bfloat16),
                  (out_s, torch.float32), (out_p, torch.float32)):
        assert o.shape == (BATCH, n_out) and o.dtype == dt, o.shape
        assert torch.isfinite(o.float()).all()
    assert torch.equal(q_stem.qnet.forward(frames_u8, stop=head),
                       q_plain.qnet.forward(frames_u8, stop=head))
    out_diff = (out_s - out_p).abs().max().item()
    # equal unless cuDNN picked another algorithm for the bf16 head of
    # one engine: then within one bf16 step of the logits
    assert out_diff <= 2 ** -7, out_diff
    log(f"phase 7 ok: bf16 ThroughputEngine with and without the phase "
        f"stem (kernel 4's mode fwd, by path {fwd_paths}; "
        f"link by link torch.equal to fwdstats + apply, within one bf16 ulp "
        f"of fwd_pair_plain, max |err| {fwd_err}, and of the plain layers, "
        f"max |err| {stem_link_err}; whole outputs max |diff| {bfs_diff}) "
        f"and int8 engines at B={BATCH} "
        f"@{NET} on u8 frames: outputs finite, (B, {n_out}); int8 trunk "
        f"equal with and without the phase stem, outputs "
        f"{'equal' if out_diff == 0 else f'max |diff| {out_diff}'}; "
        f"launches {launches_b128} [{gpu}]")

    # ---------------------------------------------------------- phase 8
    # the trained A/B model of tests/golden/map_ab.npz on its synthetic
    # set: random weights give flat probs, closer together than the
    # shift that a one-ulp change of a calibrated scale causes (CUDA and
    # CPU calibrate with sums in other orders), so det-for-det matching
    # needs a model that separates its detections
    from sr_object_detection_tpu_torch.ops.image import load_image_rgb
    from tools.synth_dataset import make_dataset
    g = np.load(GOLDEN / "map_ab.npz")
    list_path, gt = make_dataset(str(WORK / "map_ab"), int(g["n_images"]),
                                 int(g["seed"]))
    (WORK / "map_ab.cfg").write_text(bytes(g["cfg"]).decode())
    (WORK / "map_ab.weights").write_bytes(bytes(g["weights"]))
    ab = (str(WORK / "map_ab.cfg"), str(WORK / "map_ab.weights"))
    paths = [l.strip() for l in open(list_path) if l.strip()]
    d32 = Detector(*ab, device=dev)
    calib_ab = np.stack([d32.preprocess(load_image_rgb(p))
                         for p in paths[:8]])
    d8 = Detector(*ab, device=dev, int8_calib=calib_ab)
    d8_cpu = Detector(*ab, device="cpu", int8_calib=calib_ab)
    thr8, margin8 = 0.15, 0.02
    n_dets8, p_diff = 0, 0.0
    for path in paths:
        img = load_image_rgb(path)
        xf = d8.preprocess(img)[None]
        p_diff = max(p_diff, (d8.predict_batch(xf)[1].cpu()
                              - d8_cpu.predict_batch(xf)[1]).abs().max()
                     .item())
        got, want = (
            [(d.class_id, d.prob, np.asarray(d.box)) for d in
             d_.detect(img, thresh=thr8 - margin8)] for d_ in (d8, d8_cpu))
        n_dets8 += match_dets(got, want, thr8, margin8, require=False)
    assert n_dets8 > 0 and p_diff <= margin8, (n_dets8, p_diff)
    map32 = voc_map(d32, paths, gt, float(g["thresh"]), float(g["nms"]))
    map8 = voc_map(d8, paths, gt, float(g["thresh"]), float(g["nms"]))
    assert map32 > 0.2 and abs(map8 - map32) <= 0.05, (map32, map8)
    # the 416 int8 Detector (served in phase 9) and LatencyEngine
    calib8 = det.preprocess(frames[0])[None]
    det8 = Detector(str(cfg), str(weights), device=dev, int8_calib=calib8)
    lat8 = LatencyEngine(spec, params_np, device=dev, int8_calib=calib8)
    bx8, pr8 = lat8(u8[0])
    assert bx8.shape == (64, 4) and pr8.shape == (64, 20)
    assert torch.isfinite(bx8).all() and torch.isfinite(pr8).all()
    log(f"phase 8 ok: int8 Detector (map_ab model), {n_dets8} detections "
        f"matched on CUDA and CPU within {margin8} (max |prob diff| before "
        f"NMS {p_diff}); mAP on CUDA f32 {map32}, int8 {map8}; 416 int8 "
        f"LatencyEngine candidates finite [{gpu}]")

    # ---------------------------------------------------------- phase 9
    proc = subprocess.Popen(
        [sys.executable, "-m", "sr_object_detection_tpu_torch.infer.serve",
         str(cfg), str(weights), "--int8"], cwd=ROOT,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    try:
        out, err = proc.communicate(req, timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err.decode()[-2000:]
    assert struct.unpack("<5i", out[:20]) == (0x53524456, 416, 416, 845, 20)
    assert len(out) == 20 + 3 * per
    for i, f in enumerate(frames):
        blob = np.frombuffer(out[20 + i * per:20 + (i + 1) * per], "<f4")
        wb, wp = det8.predict_batch(det8.preprocess(f)[None], thresh=thresh)
        assert np.allclose(blob[:n_boxes * 4].reshape(-1, 4),
                           wb[0].cpu().numpy(), rtol=1e-5, atol=1e-6)
        assert np.allclose(blob[n_boxes * 4:].reshape(-1, classes),
                           wp[0].cpu().numpy(), rtol=1e-5, atol=1e-6)
    log(f"phase 9 ok: the server with --int8 answered 3 requests, equal to "
        f"the in-process int8 Detector [{gpu}]")

    # --------------------------------------------------------- phase 10
    times["phase_stem_pair"] = abba(
        f"int8 stem, 4 chained pairs @{NET} B={BATCH} from u8 frames",
        lambda: int8_chain(frames_u8, PS.stem_pair_i8),
        lambda: int8_chain(frames_u8, PS.stem_pair_i8_plain), iters=20,
        plain_iters=5)
    # each pair on its input along the engine's chain (pair 1 from u8
    # frames) beside its bound: its input read once, weights, dq and bias
    # read once, its output written once
    n_bytes = n_ops = 0
    for l, args in ps_inputs:
        p_ms, _ = abba(f"int8 stem pair {l.c}->{l.filters} @{l.h} "
                       f"B={BATCH}", lambda: PS.stem_pair_i8(*args),
                       lambda: PS.stem_pair_i8_plain(*args), iters=20,
                       plain_iters=5)
        p_bytes = (args[0].numel() * args[0].element_size()
                   + 9 * l.c * l.filters + 8 * l.filters
                   + BATCH * (l.h // 2) * (l.w // 2) * l.filters)
        p_ops = 2 * BATCH * l.h * l.w * l.filters * 9 * l.c
        b_ms, b_by = bound(p_bytes, p_ops, "int8")
        log(f"bound int8 stem pair {l.c}->{l.filters} @{l.h}: {b_ms} ms by "
            f"{b_by} ({p_bytes} bytes, {p_ops} int8 ops); kernel "
            f"{p_ms / b_ms:.2f}x its bound [{gpu}]")
        n_bytes += p_bytes
        n_ops += p_ops
    # the chain moves each intermediate twice (written, then read), as the
    # pairs' sum counts it
    bounds["phase_stem_pair"] = bound(n_bytes, n_ops, "int8")
    log(f"bound int8 stem chain: {bounds['phase_stem_pair'][0]} ms by "
        f"{bounds['phase_stem_pair'][1]} ({n_bytes} bytes, {n_ops} int8 "
        f"ops) [{gpu}]")
    # the bf16 serving stem (kernel 4's mode fwd): each pair on its input
    # along the engine's chain, in turns with fwd_pair_plain and from a
    # CUDA graph, beside its bound (input read once, weights and bias read
    # once, output written once; or its bf16 products); then the chain
    n_bytes = n_ops = 0
    for l, xi, w_hwio, bias in fwd_links:
        tag = f"{l.c}->{l.filters} @{l.h} B={BATCH}"
        p_ms, _ = abba(f"bf16 serving stem pair (fwd kernel) {tag}",
                       lambda: PT.fwd_pair(xi, w_hwio, bias),
                       lambda: PT.fwd_pair_plain(xi, w_hwio, bias), iters=20,
                       plain_iters=3)
        g_ms = graph_ms(lambda: PT.fwd_pair(xi, w_hwio, bias), 10)
        p_bytes = (2 * xi.numel() + 2 * w_hwio.numel() + 4 * bias.numel()
                   + 2 * BATCH * (l.h // 2) * (l.w // 2) * l.filters)
        p_ops = 2 * BATCH * l.h * l.w * l.filters * 9 * l.c
        b_ms, b_by = bound(p_bytes, p_ops, "bf16")
        log(f"bound bf16 serving stem pair {tag}: {b_ms} ms by {b_by}; "
            f"kernel {p_ms / b_ms:.2f}x in turns, from a CUDA graph {g_ms} "
            f"ms ({g_ms / b_ms:.2f}x) [{gpu}]")
        n_bytes += p_bytes
        n_ops += p_ops
    x_bf = x_b128.to(torch.bfloat16)

    def plain_fwd_chain(v):
        for _, _, w_hwio, bias in fwd_links:
            v = PT.fwd_pair_plain(v, w_hwio, bias)
        return v
    times["phase_train_fwd"] = abba(
        f"bf16 serving stem, 4 chained pairs @{NET} B={BATCH} (fwd kernel)",
        lambda: bf_stem._stem(x_bf), lambda: plain_fwd_chain(x_bf), iters=20,
        plain_iters=3)
    bounds["phase_train_fwd"] = bound(n_bytes, n_ops, "bf16")
    log(f"time bf16 serving stem chain from a CUDA graph: "
        f"{graph_ms(lambda: bf_stem._stem(x_bf), 5)} ms; bound "
        f"{bounds['phase_train_fwd'][0]} ms by "
        f"{bounds['phase_train_fwd'][1]} [{gpu}]")
    del x_bf
    torch.cuda.empty_cache()

    bf.warmup()
    bf_stem.warmup()
    for name, eng in (("plain", bf), ("phase stem", bf_stem),
                      ("phase stem", bf_stem), ("plain", bf)):
        r_bf = eng.benchmark(iters=20, warmup=3)
        log(f"time ThroughputEngine bf16 B={BATCH} @{NET}, {name}: "
            f"{r_bf['images_per_sec']} images/s ({r_bf['sec_per_batch']} "
            f"s/batch) [{gpu}]")
    q_plain.warmup()
    q_stem.warmup()
    turns = [(name, eng.benchmark(iters=20, warmup=3,
                                  input_dtype=torch.uint8))
             for name, eng in (("plain", q_plain), ("phase stem", q_stem),
                               ("phase stem", q_stem), ("plain", q_plain))]
    for name, rr in turns:
        log(f"time int8 engine B={BATCH} @{NET} u8 frames, {name}: "
            f"{rr['images_per_sec']} images/s ({rr['sec_per_batch']} "
            f"s/batch) [{gpu}]")
    i8_ms = lat8.device_benchmark(reps=50)["device_ms_per_frame"]
    log(f"time int8 LatencyEngine @416 per frame (CUDA events, 50 queued "
        f"frames): {i8_ms} ms [{gpu}]")
    best = best_latency_engine(spec, params_np, device=dev,
                               int8_calib=calib8, reps=50)
    log(f"best_latency_engine selection @416: {best.selection} [{gpu}]")

    # --------------------------------------------------------- phase 11
    profile("LatencyEngine 416 bf16 fused stem, per frame",
            lambda: fused(u8[0]), 20, gpu)
    profile("LatencyEngine 416 bf16 plain, per frame",
            lambda: plain(u8[0]), 20, gpu)
    profile("Detector.predict_batch 416 f32, per frame",
            lambda: det.predict_batch(xin), 20, gpu)
    profile(f"ThroughputEngine bf16 B={BATCH} @{NET}, per batch",
            lambda: bf(frames_u8.float() / 255.0), 5, gpu)
    name = f"ThroughputEngine bf16 + phase stem B={BATCH} @{NET}, per batch"
    seen = profile(name, lambda: bf_stem(frames_u8.float() / 255.0), 5, gpu)
    assert_conv_tensor_core(name, seen, 5, {
        "fwd_tc_kernel": 3, "fwd_fold_kernel": 1, "fwdstats_tc_kernel": 0,
        "fwdstats_fold_kernel": 0, "fwdstats_kernel": 0})
    assert not any(named(k, key) for k in ("colsum_kernel", "apply_kernel")
                   for key in seen), (name, seen)
    log(f"  {name}: no colsum_kernel or apply_kernel")
    name = f"int8 engine B={BATCH} @{NET} u8, phase stem, per batch"
    seen = profile(name, lambda: q_stem(frames_u8), 5, gpu)
    assert any("phase_pair_tc_kernel" in k for k in seen), (name, seen)
    assert not any(named("phase_pair_kernel", k) for k in seen), (
        name, seen)
    log(f"  {name}: the stem ran as phase_pair_tc_kernel (int8 tensor "
        f"cores), no phase_pair_kernel")
    profile(f"int8 engine B={BATCH} @{NET} u8, plain, per batch",
            lambda: q_plain(frames_u8), 3, gpu)


    # --------------------------------------------------------- phase 12
    # the training kernels against their plain versions at the training
    # pair's shape (416, B=128, 3 -> 16), TF32 off (disable_tf32 above)
    from sr_object_detection_tpu_torch.ops import conv as C
    from sr_object_detection_tpu_torch.ops import pooling as P
    from sr_object_detection_tpu_torch.train.trainer import Trainer
    import torch.nn.functional as F
    tcase = train_case(12, BATCH, NET, 3, 16, dev)
    fold_before = dict(PT.conv_kernels["fwdstats"])
    train_errs = check_train_kernels(PT, tcase)
    x0, w0 = tcase["x"], tcase["w"]
    sh0, sc0, b0, dp0 = (tcase[k] for k in ("shift", "scales", "biases",
                                            "dp"))
    # fwdstats on the tile's taps fold (fwdstats_fold_kernel): one owner
    # and one order per sum, so two launches are bit-equal
    f1, f2 = (PT.fwdstats(x0, w0, sh0, sc0) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(f1, f2))
    del f1, f2
    assert PT.conv_kernels["fwdstats"] == {
        **fold_before, "tensor_core_fold":
            fold_before["tensor_core_fold"] + 3}, PT.conv_kernels
    # its time in turns with its plain version beside its bound: x read,
    # Z and the argmax written (the weights and constants are a few KB);
    # cuDNN's bf16 F.conv2d at the same shape for context only: it
    # computes the conv alone, without the pool, argmax and sums
    times["phase_train_fwdstats"] = abba(
        f"phase_train fwdstats (taps fold) {NET} B={BATCH} 3->16",
        lambda: PT.fwdstats(x0, w0, sh0, sc0),
        lambda: PT.fwdstats_plain(x0, w0, sh0, sc0), iters=20,
        plain_iters=5)
    h2 = NET // 2
    pooled_n = BATCH * h2 * h2 * 16
    x_bytes = 2 * BATCH * NET * NET * 3
    conv_ops = 2 * BATCH * NET * NET * 16 * 27
    bounds["phase_train_fwdstats"] = bound(
        x_bytes + 2 * 27 * 16 + 8 * 16 + 3 * pooled_n + 8 * 16, conv_ops,
        "bf16")
    xc0, wc0 = x0.permute(0, 3, 1, 2), w0.permute(3, 2, 0, 1).contiguous()
    conv0_ms = (cuda_ms(lambda: F.conv2d(xc0, wc0, padding=1), 10)
                + cuda_ms(lambda: F.conv2d(xc0, wc0, padding=1), 10)) / 2
    b_ms, b_by = bounds["phase_train_fwdstats"]
    log(f"bound phase_train fwdstats 3->16 @{NET}: {b_ms} ms by {b_by}; "
        f"kernel {times['phase_train_fwdstats'][0] / b_ms}x its bound; "
        f"reference F.conv2d bf16 (cuDNN, the conv alone) {conv0_ms} ms "
        f"[{gpu}]")
    del xc0
    # bwdg on the tensor cores: one owner and one order per sum, so two
    # launches on the same inputs are bit-equal
    z0, am0, st0 = PT.fwdstats_plain(x0, w0, sh0, sc0)
    n0 = BATCH * NET * NET
    mean0, _, inv0 = PT._batch_stats(st0, sh0, n0)
    tc_before = PT.bwdg_kernels["tensor_core"]
    bw1 = PT.bwdg(x0, dp0, z0, am0, mean0, inv0, sc0, b0)
    bw2 = PT.bwdg(x0, dp0, z0, am0, mean0, inv0, sc0, b0)
    assert all(torch.equal(a, b) for a, b in zip(bw1, bw2))
    assert PT.bwdg_kernels["tensor_core"] == tc_before + 2
    del bw1, bw2
    grad = check_pair_gradient(
        PT, C, P, pair_spec(NET, 3, 16), train_case(12, BATCH, NET, 3, 16,
                                                    dev, flat=False))
    torch.cuda.synchronize()
    log(f"phase 12 ok: training kernels == plain at {NET} B={BATCH} 3->16 "
        f"(max |err| {train_errs}); fwdstats on the taps fold and bwdg on "
        f"the tensor cores, two launches of each bit-equal; "
        f"phase_train_block gradient within "
        f"{grad['fused']} of a float64 evaluation of the unfused chain's "
        f"formulas (gate 1e-3), the bf16 unfused chain's weight gradient "
        f"{grad['chain']} from it; cotangent zeroed on {grad['masked']} of "
        f"the windows, where the two tie rules route apart [{gpu}]")
    torch.cuda.empty_cache()

    # --------------------------------------------------------- phase 13
    # the training slice at full width: tiny-yolo-voc 416, batch 128,
    # subdivisions 1, bf16 with the fused pair; input as bench.py's
    # training bench (uniform [0,1) from a seed, one box per image)
    tbase = tiny_yolo_voc()
    tspec = dataclasses.replace(tbase, net=dataclasses.replace(
        tbase.net, batch=BATCH, subdivisions=1))
    tparams = init_params(tspec, seed=0)
    xt = torch.from_numpy(np.random.default_rng(13).uniform(
        0, 1, (BATCH, NET, NET, 3)).astype(np.float32)).to(dev)
    tt_np = np.zeros((BATCH, 30, 5), np.float32)
    tt_np[:, 0] = [0.5, 0.5, 0.3, 0.3, 1]
    tt = torch.from_numpy(tt_np).to(dev)
    trainers = {
        "bf16 + phase_train": Trainer(tspec, tparams, device=dev,
                                      compute_dtype=torch.bfloat16,
                                      phase_train=True),
        "bf16": Trainer(tspec, tparams, device=dev,
                        compute_dtype=torch.bfloat16),
        "f32": Trainer(tspec, tparams, device=dev)}
    reset_counts()
    tr = trainers["bf16 + phase_train"]
    losses = [float(tr.step(xt, tt)["loss"]) for _ in range(3)]
    torch.cuda.synchronize()
    launches_train, want = counts(phase_train_fwdstats=3,
                                  phase_train_apply=3, phase_train_bwdg=3)
    assert launches_train == want, launches_train
    assert PT.conv_kernels["fwdstats"] == {
        "tensor_core": 0, "tensor_core_fold": 3,
        "fp32_core": 0}, PT.conv_kernels
    assert all(np.isfinite(losses)) and losses[2] < losses[0], losses
    loss_plain = float(trainers["bf16"].step(xt, tt)["loss"])
    assert abs(losses[0] - loss_plain) <= 0.03 * abs(loss_plain) + 0.05, (
        losses[0], loss_plain)
    golden_cost_err = {name: check_train_golden(name, dev)
                       for name in sorted(TRAIN_GOLDENS)}
    log(f"phase 13 ok: Trainer tiny-yolo-voc {NET} B={BATCH} bf16 + "
        f"phase_train, 3 steps: losses {losses}; first step without the "
        f"pair {loss_plain}; launches {launches_train}; float32 Trainer on "
        f"CUDA reproduces the C-oracle goldens (max relative cost error "
        f"{golden_cost_err}) [{gpu}]")

    # --------------------------------------------------------- phase 14
    # `cli detector train -bf16` on the card, on 256 synthetic 500x375
    # PPM images with labels
    tcfg = WORK / "tiny-yolo-voc-train.cfg"
    tcfg.write_text(train_cfg_text(cfg.read_text(), batch=BATCH,
                                   subdivisions=1, max_batches=2))
    lst = write_ppm_dataset(WORK / "voc", 256, seed=14)
    backup = WORK / "backup"
    data_cfg = WORK / "voc.data"
    data_cfg.write_text(f"classes=20\ntrain={lst}\nbackup={backup}\n")
    final = backup / "tiny-yolo-voc-train_final.weights"
    final.unlink(missing_ok=True)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "sr_object_detection_tpu_torch.apps.cli",
         "detector", "train", str(data_cfg), str(tcfg), "-bf16"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    iters = [l for l in res.stdout.splitlines()
             if l.split(":")[0] in ("1", "2")]
    assert len(iters) == 2, res.stdout[-2000:]
    from sr_object_detection_tpu_torch.graph.spec import parse_network_cfg
    from sr_object_detection_tpu_torch.io.weights import load_weights
    cspec = parse_network_cfg(str(tcfg))
    got_w, seen_w = load_weights(cspec, str(final))
    init_w = init_params(cspec, seed=0)
    assert seen_w == 2 * BATCH
    assert not np.allclose(got_w[0]["weights"], init_w[0]["weights"])
    log(f"phase 14 ok: cli detector train -bf16 ran 2 iterations in "
        f"{time.perf_counter() - t0:.1f} s ({' | '.join(iters)}); "
        f"{final.name} loads, seen {seen_w}, weights moved [{gpu}]")

    # --------------------------------------------------------- phase 15
    # times, in turns (plain, kernel, kernel, plain): apply and bwdg at
    # the pair's shape beside their bounds (fwdstats: phase 12);
    # Trainer.step images/s (x0 ... inv0: phase 12's inputs)
    times["phase_train_apply"] = abba(
        f"phase_train apply {NET} B={BATCH} 16 ch",
        lambda: PT.apply(z0, mean0, inv0, sc0, b0),
        lambda: PT.apply_plain(z0, mean0, inv0, sc0, b0), iters=20,
        plain_iters=10)
    times["phase_train_bwdg"] = abba(
        f"phase_train bwdg {NET} B={BATCH} 3->16",
        lambda: PT.bwdg(x0, dp0, z0, am0, mean0, inv0, sc0, b0),
        lambda: PT.bwdg_plain(x0, dp0, z0, am0, mean0, inv0, sc0, b0),
        iters=10, plain_iters=3)
    bounds["phase_train_apply"] = bound(4 * pooled_n + 16 * 16,
                                        6 * pooled_n, "bf16")
    bounds["phase_train_bwdg"] = bound(
        x_bytes + 5 * pooled_n + 16 * 16
        + 4 * (2 * 16 + 27 * 16 + 27 + 27 * 27),
        2 * BATCH * NET * NET * 27 * 27 + 2 * pooled_n * 27, "bf16")
    for name in ("phase_train_apply", "phase_train_bwdg"):
        log(f"bound {name}: {bounds[name][0]} ms by {bounds[name][1]} "
            f"[{gpu}]")
    del z0, am0
    torch.cuda.empty_cache()

    from sr_object_detection_tpu_torch.infer.engine import analytic_flops
    step_flops = 3 * analytic_flops(tspec)           # per image
    PEAK_BF16 = PEAK_OPS_S["bf16"]

    order = ["bf16 + phase_train", "bf16", "f32", "f32", "bf16",
             "bf16 + phase_train"]
    rates = {}
    for name in order:
        ips = step_rate(trainers[name], xt, tt, 5)
        rates.setdefault(name, []).append(ips)
        log(f"time Trainer.step {name} {NET} B={BATCH}: {ips} images/s, "
            f"{ips * step_flops / 1e12} TFLOP/s, MFU "
            f"{ips * step_flops / PEAK_BF16} of the bf16 dense peak "
            f"[{gpu}]")

    # --------------------------------------------------------- phase 16
    name = f"Trainer.step bf16 + phase_train {NET} B={BATCH}, per step"
    assert_bwdg_tensor_core(name, profile(
        name, lambda: trainers["bf16 + phase_train"].step(xt, tt), 2, gpu,
        top=8))
    profile(f"Trainer.step bf16 (no pair) {NET} B={BATCH}, per step",
            lambda: trainers["bf16"].step(xt, tt), 2, gpu, top=8)
    settle_fwdstats_count(PT, lambda: Trainer(
        tspec, tparams, device=dev, compute_dtype=torch.bfloat16,
        phase_train=True), xt, tt, 3, gpu)

    # --------------------------------------------------------- phase 17
    # the opt-in training paths' kernels against their plain versions at
    # the main path's shapes: red, dy (+ dw) and dgrad at the chain's
    # second pair (416 -> 208x208, 16 -> 32, B=128), F2/B1/B2 at the five
    # fusable pairs' conv outputs (channels-last, as the conv writes them)
    h1 = NET // 2
    ccase = chain_case(17, BATCH, h1, 16, 32, dev)
    tc_before = {m: c["tensor_core"] for m, c in PT.conv_kernels.items()}
    chain_errs = check_chain_kernels(PT, ccase)
    # fwdstats on the tensor-core tile at the chain's pair 1, and on
    # general inputs the forward's Z and argmax against dy's recomputed y
    fcase = train_case(17, BATCH, h1, 16, 32, dev)
    fwd_tc_err = check_fwdstats(PT, fcase["x"], fcase["w"], fcase["shift"],
                                fcase["scales"])[0]
    del fcase
    g17 = torch.Generator(device=dev).manual_seed(17)
    x17 = torch.randn((BATCH, h1, h1, 16), generator=g17, device=dev).to(
        torch.bfloat16)
    w17 = (0.3 * torch.randn((3, 3, 16, 32), generator=g17,
                             device=dev)).to(torch.bfloat16)
    n_windows = check_y_consistency(PT, x17, w17,
                                    torch.linspace(-1, 1, 32, device=dev))
    del x17, w17
    assert {m: c["tensor_core"] - tc_before[m]
            for m, c in PT.conv_kernels.items()} == {
        "fwdstats": 2, "red": 1, "dy": 2, "fwd": 0}, PT.conv_kernels
    torch.cuda.empty_cache()
    stem_shapes = [(NET >> k, 16 << k) for k in range(5)]      # (H, C)
    stem_errs = {"f2": 0.0, "b1": 0.0, "b2": 0.0}
    paths_before = dict(FS.paths)
    for k, (h, c) in enumerate(stem_shapes):
        e = check_fused_stem_kernels(FS, stem_case(170 + k, BATCH, h, c,
                                                   dev))
        stem_errs = {n: max(stem_errs[n], e[n]) for n in e}
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    # channels-last pairs: F2, B1 (twice a shape) and B2 on the row kernels
    assert {k: FS.paths[k] - paths_before[k] for k in FS.paths} == {
        "f2_row": 5, "b1_row": 10, "b2_row": 5, "f2": 0, "b1": 0,
        "b2": 0}, FS.paths
    log(f"phase 17 ok: red, dy and dgrad == plain at {NET} B={BATCH} "
        f"{h1}x{h1} 16->32 (max |err| {chain_errs}), fwdstats there "
        f"(max |err| {fwd_tc_err}), the three on the tensor-core conv "
        f"tile; fwdstats' Z and argmax equal dy's recomputed y's pooled "
        f"extreme bit for bit on {n_windows} windows of general inputs; "
        f"F2, B1, B2 == plain "
        f"at (H, C) {stem_shapes} (max |err| {stem_errs}; F2, B1 and B2 "
        f"on the row kernels, B1 bit-equal across two launches) [{gpu}]")

    # --------------------------------------------------------- phase 18
    # the chain's second pair's gradient (dw, dscales, dbiases, dx) against
    # a float64 evaluation of the unfused chain's formulas; the fused op
    # against the unfused chain on the same conv output, at pair 2's shape
    # dw at 3e-3: the pair rounds its float32 dy to bf16, the evaluation
    # its float64 one; where the two sit on either side of a rounding
    # boundary they part by an ulp, which over 5.5 M positions moves dw
    # by about 1e-3 of its largest magnitude (1.25e-3 in the first run)
    l2 = tspec.layers[2]
    grad2 = check_pair_gradient(
        PT, C, P, l2, train_case(18, BATCH, h1, 16, 32, dev, flat=False),
        tol=3e-3, dx=1e-2)
    torch.cuda.empty_cache()
    y_fmt = F.conv2d(torch.zeros((1, h1, h1, 16), device=dev,
                                 dtype=torch.bfloat16).permute(0, 3, 1, 2),
                     torch.zeros((32, 16, 3, 3), device=dev,
                                 dtype=torch.bfloat16), padding=1)
    y_cl = y_fmt.is_contiguous(memory_format=torch.channels_last)
    fused_rel, fused_dy = check_fused_op(FS, C, P, stem_case(
        18, BATCH, h1, 32, dev, channels_last=y_cl))
    torch.cuda.synchronize()
    log(f"phase 18 ok: the chain's second pair at {NET} B={BATCH}: dw, "
        f"dscales, dbiases within {grad2['fused']} of a float64 evaluation "
        f"of the unfused chain's formulas (dy rounded to bf16 as the pair "
        f"rounds it; gate 3e-3), dx within {grad2['dx']} (gate 1e-2), the "
        f"unfused bf16 chain's weight gradient {grad2['chain']} from it, "
        f"cotangent zeroed on {grad2['masked']} of the windows; the fused "
        f"stem op at {h1}x{h1}x32 equals the unfused chain forward, scale "
        f"and bias gradients within {fused_rel}, dy max |diff| {fused_dy} "
        f"(one bf16 ulp); the conv writes "
        f"{'channels-last' if y_cl else 'NCHW'} [{gpu}]")
    torch.cuda.empty_cache()

    # --------------------------------------------------------- phase 19
    # the opt-in paths at full width: Trainer bf16 at 416 B=128, three
    # steps each, every kernel's launches counted from 0
    cfgs = {"bf16 + chain": dict(phase_train="chain"),
            "bf16 + phase_train + fused_stem": dict(phase_train=True,
                                                    fused_stem=True),
            "bf16 + fused_stem": dict(fused_stem=True)}
    per_step = {
        "bf16 + chain": dict(phase_train_fwdstats=2, phase_train_apply=2,
                             phase_train_red=1, phase_train_dy=1,
                             phase_train_dgrad=1, phase_train_bwdg=1),
        "bf16 + phase_train + fused_stem": dict(
            phase_train_fwdstats=1, phase_train_apply=1, phase_train_bwdg=1,
            fused_stem_f2=4, fused_stem_b1=4, fused_stem_b2=4),
        "bf16 + fused_stem": dict(fused_stem_f2=5, fused_stem_b1=5,
                                  fused_stem_b2=5)}
    # the conv kernels a step runs, by their profiler names: pair 1 of the
    # chain (16 -> 32) on the tensor-core tile, pair 0 (3 -> 16) on its
    # taps fold, none on the FP32-core loop
    conv_per_step = {
        "bf16 + chain": {"fwdstats_tc_kernel": 1, "red_tc_kernel": 1,
                         "dy_tc_kernel": 1, "fwdstats_fold_kernel": 1,
                         "fwdstats_kernel": 0},
        "bf16 + phase_train + fused_stem": {"fwdstats_fold_kernel": 1,
                                            "fwdstats_tc_kernel": 0,
                                            "fwdstats_kernel": 0},
        "bf16 + fused_stem": {"fwdstats_fold_kernel": 0,
                              "fwdstats_tc_kernel": 0,
                              "fwdstats_kernel": 0}}
    launches_opt, conv_opt = {}, {}
    for name, kw in cfgs.items():
        trainers[name] = Trainer(tspec, tparams, device=dev,
                                 compute_dtype=torch.bfloat16, **kw)
        reset_counts()
        ls = [float(trainers[name].step(xt, tt)["loss"]) for _ in range(3)]
        torch.cuda.synchronize()
        got, want = counts(**{k: 3 * v for k, v in per_step[name].items()})
        assert got == want, (name, got)
        tc = {m: c["tensor_core"] for m, c in PT.conv_kernels.items()}
        assert tc == {m: 3 * conv_per_step[name].get(f"{m}_tc_kernel", 0)
                      for m in tc}, (name, PT.conv_kernels)
        assert PT.conv_kernels["fwdstats"]["tensor_core_fold"] == 3 * (
            conv_per_step[name]["fwdstats_fold_kernel"]), PT.conv_kernels
        assert not any(c["fp32_core"] for c in PT.conv_kernels.values()), (
            name, PT.conv_kernels)
        # the fused stem on the row kernels (channels-last y)
        assert FS.paths == {"f2_row": got["fused_stem_f2"],
                            "b1_row": got["fused_stem_b1"],
                            "b2_row": got["fused_stem_b2"], "f2": 0,
                            "b1": 0, "b2": 0}, (name, FS.paths)
        conv_opt[name] = tc
        assert all(np.isfinite(ls)) and ls[2] < ls[0], (name, ls)
        assert abs(ls[0] - loss_plain) <= 0.03 * abs(loss_plain) + 0.05, (
            name, ls[0], loss_plain)
        launches_opt[name] = got
        log(f"  Trainer {name} {NET} B={BATCH}, 3 steps: losses {ls}; "
            f"launches {dict((k, v) for k, v in got.items() if v)}")
    log(f"phase 19 ok: the chain, the pair + fused stem and the fused stem "
        f"train at {NET} B={BATCH} with the launch counts per step "
        f"{per_step}; first losses within 0.03*|loss| + 0.05 of the step "
        f"without kernels ({loss_plain}) [{gpu}]")

    # --------------------------------------------------------- phase 20
    # times, in turns: the six kernels beside their bounds, dgrad's
    # library call; Trainer.step images/s of the opt-in paths against
    # bf16 + phase_train
    cargs = [ccase[k] for k in ("x", "w", "dp", "mean", "inv", "scales",
                                "biases")]
    c123 = [ccase[k] for k in ("c1", "c2", "c3")]
    times["phase_train_red"] = abba(
        f"phase_train red {h1}x{h1} B={BATCH} 16->32",
        lambda: PT.red(*cargs), lambda: PT.red_plain(*cargs), iters=10,
        plain_iters=3)
    times["phase_train_dy"] = abba(
        f"phase_train dy (+dw) {h1}x{h1} B={BATCH} 16->32",
        lambda: PT.dy(*cargs, *c123), lambda: PT.dy_plain(*cargs, *c123),
        iters=10, plain_iters=2)
    times["phase_train_dgrad"] = abba(
        f"phase_train dgrad {h1}x{h1} B={BATCH} 32->16",
        lambda: PT.dgrad(ccase["d"], ccase["w"]),
        lambda: PT.dgrad_plain(ccase["d"], ccase["w"]), iters=10,
        plain_iters=5)
    d_nchw = ccase["d"].permute(0, 3, 1, 2)
    w_oihw = ccase["w"].permute(3, 2, 0, 1).contiguous()
    library = {"phase_train_dgrad": (
        cuda_ms(lambda: F.conv_transpose2d(d_nchw, w_oihw, padding=1), 10)
        + cuda_ms(lambda: F.conv_transpose2d(d_nchw, w_oihw, padding=1),
                  10)) / 2}
    log(f"time library F.conv_transpose2d bf16 (cuDNN) {h1}x{h1} B={BATCH} "
        f"32->16: {library['phase_train_dgrad']} ms [{gpu}]")
    n1 = BATCH * h1 * h1
    conv1 = 2 * n1 * 32 * 9 * 16
    bytes_w = 2 * 9 * 16 * 32 + 4 * 7 * 32
    bounds["phase_train_red"] = bound(
        2 * n1 * 16 + bytes_w + 2 * n1 // 4 * 32 + 4 * 2 * 32, conv1, "bf16")
    bounds["phase_train_dy"] = bound(
        2 * n1 * 16 + bytes_w + 2 * n1 // 4 * 32 + 2 * n1 * 32
        + 4 * 9 * 16 * 32, 2 * conv1, "bf16")
    bounds["phase_train_dgrad"] = bound(2 * n1 * 32 + 2 * 9 * 16 * 32
                                        + 2 * n1 * 16, conv1, "bf16")
    del ccase, cargs, d_nchw
    torch.cuda.empty_cache()
    # F2, B1 and B2 at the five fusable pairs' conv outputs (in the layout
    # the conv writes) from a CUDA graph, B1 and B2 also in turns, F2 in
    # turns at pair 2 (208x208, 32 channels), beside their bounds; per
    # window about 52, 64 and 36 float32 operations. The kernels line
    # carries pair 2's times.
    for k, (h, c) in enumerate(stem_shapes):
        scase = stem_case(20 + k, BATCH, h, c, dev, channels_last=y_cl)
        y2, dp2 = scase["y"], scase["dp"]
        k4 = [scase[n] for n in ("mean", "inv", "scales", "biases")]
        s123 = [scase[n] for n in ("c1", "c2", "c3")]
        tag = f"{h}x{h}x{c} B={BATCH}"
        before = dict(FS.paths)
        tb = {"fused_stem_b1": abba(
            f"fused_stem B1 {tag}", lambda: FS.b1(y2, dp2, *k4),
            lambda: FS.b1_plain(y2, dp2, *k4), iters=20, plain_iters=3),
            "fused_stem_b2": abba(
            f"fused_stem B2 {tag}", lambda: FS.b2(y2, dp2, *k4, *s123),
            lambda: FS.b2_plain(y2, dp2, *k4, *s123), iters=20,
            plain_iters=3)}
        # the same calls replayed from a CUDA graph: device time without
        # the host's launch cost, which bounds the figures above at the
        # small pairs
        if h == h1:
            tb["fused_stem_f2"] = abba(
                f"fused_stem F2 {tag}", lambda: FS.f2(y2, *k4),
                lambda: FS.f2_plain(y2, *k4), iters=20, plain_iters=5)
        tg = {"fused_stem_f2": graph_ms(lambda: FS.f2(y2, *k4)),
              "fused_stem_b1": graph_ms(lambda: FS.b1(y2, dp2, *k4)),
              "fused_stem_b2": graph_ms(lambda: FS.b2(y2, dp2, *k4,
                                                      *s123))}
        yb, win = y2.numel() * 2, y2.numel() // 4
        bb = {"fused_stem_f2": bound(yb + yb // 4 + 16 * c, 36 * win,
                                     "f32"),
              "fused_stem_b1": bound(yb + yb // 4 + 16 * c + 8 * c,
                                     52 * win, "f32"),
              "fused_stem_b2": bound(2 * yb + yb // 4 + 28 * c, 64 * win,
                                     "f32")}
        for n in tg:
            turns = (f"kernel {tb[n][0]} ms ({tb[n][0] / bb[n][0]} x), "
                     if n in tb else "")
            log(f"bound {n} {tag}: {bb[n][0]} ms by {bb[n][1]}; {turns}"
                f"from a CUDA graph {tg[n]} ms ({tg[n] / bb[n][0]} x); "
                f"launches by kernel "
                f"{ {m: FS.paths[m] - before[m] for m in FS.paths} } "
                f"[{gpu}]")
        if h == h1:
            times.update(tb)
            bounds.update(bb)
        del scase, y2, dp2
        torch.cuda.empty_cache()
    # fwdstats alone on the tensor-core conv tile at its three Cin >= 16
    # instances (the chain's pair 1, the serving stem's pairs 2-4) beside
    # its bound; cuDNN's bf16 F.conv2d at the same shapes for reference
    # only: it computes the conv alone, without the pool, argmax and sums
    g20 = torch.Generator(device=dev).manual_seed(20)
    conv_lib = {}
    for h, cin, cout in ((h1, 16, 32), (NET // 4, 32, 64),
                         (NET // 8, 64, 128)):
        xs = torch.rand((BATCH, h, h, cin), generator=g20,
                        device=dev).to(torch.bfloat16)
        ws = (0.3 * torch.randn((3, 3, cin, cout), generator=g20,
                                device=dev)).to(torch.bfloat16)
        sh = 0.1 * torch.randn(cout, generator=g20, device=dev)
        sc = torch.linspace(-1, 1, cout, device=dev)
        tag = f"{cin}->{cout} @{h}"
        k_ms, p_ms = abba(
            f"phase_train fwdstats (tensor-core tile) {tag} B={BATCH}",
            lambda: PT.fwdstats(xs, ws, sh, sc),
            lambda: PT.fwdstats_plain(xs, ws, sh, sc), iters=20,
            plain_iters=3)
        xc, wc = xs.permute(0, 3, 1, 2), ws.permute(3, 2, 0, 1).contiguous()
        conv_lib[tag] = (cuda_ms(lambda: F.conv2d(xc, wc, padding=1), 10)
                         + cuda_ms(lambda: F.conv2d(xc, wc, padding=1),
                                   10)) / 2
        pooled = BATCH * (h // 2) * (h // 2) * cout
        b_tc = bound(2 * BATCH * h * h * cin + 2 * 9 * cin * cout + 8 * cout
                     + 3 * pooled + 8 * cout,
                     2 * BATCH * h * h * cout * 9 * cin, "bf16")
        log(f"bound phase_train fwdstats {tag}: {b_tc[0]} ms by {b_tc[1]}; "
            f"reference F.conv2d bf16 (cuDNN, the conv alone) "
            f"{conv_lib[tag]} ms [{gpu}]")
        if cin == 16:
            times["phase_train_fwdstats_tc"] = (k_ms, p_ms)
            bounds["phase_train_fwdstats_tc"] = b_tc
        del xs, xc
    torch.cuda.empty_cache()
    for name in ("phase_train_red", "phase_train_dy", "phase_train_dgrad",
                 "fused_stem_f2", "fused_stem_b1", "fused_stem_b2"):
        log(f"bound {name}: {bounds[name][0]} ms by {bounds[name][1]} "
            f"[{gpu}]")
    order = ["bf16 + phase_train", *cfgs, *reversed(cfgs),
             "bf16 + phase_train"]
    for name in order:
        ips = step_rate(trainers[name], xt, tt, 5)
        log(f"time Trainer.step {name} {NET} B={BATCH}: {ips} images/s, "
            f"{ips * step_flops / 1e12} TFLOP/s, MFU "
            f"{ips * step_flops / PEAK_BF16} of the bf16 dense peak "
            f"[{gpu}]")

    # --------------------------------------------------------- phase 21
    for name in cfgs:
        before = PT.launches["fwdstats"]
        seen = profile(f"Trainer.step {name} {NET} B={BATCH}, per step",
                       lambda: trainers[name].step(xt, tt), 2, gpu, top=8)
        log(f"  {name}: fwdstats launches by the counter over the warm-up "
            f"step and the 2 profiled steps: "
            f"{PT.launches['fwdstats'] - before}")
        if per_step[name].get("phase_train_bwdg"):
            assert_bwdg_tensor_core(name, seen)
        if per_step[name].get("fused_stem_b1"):
            assert_fused_stem_rows(name, seen)
        assert_conv_tensor_core(name, seen, 2, conv_per_step[name])

    # --------------------------------------------------- phases 22-25
    log(f"  device memory before yolov2-608: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    yolo_kernels = yolov2_608(gpu, dev, reset_counts, counts)

    # --------------------------------------------------- phases 26-28
    trainers.clear()
    torch.cuda.empty_cache()
    log(f"  device memory before yolov2-608 training: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    yolo_train_kernels = yolov2_608_train(gpu, dev, reset_counts, counts)

    replaces = {
        "nms_per_class": "sr_object_detection_tpu/kernels/nms_pallas.py:29",
        "stem_pair": "sr_object_detection_tpu/kernels/b1_stem.py:82",
        "phase_stem_pair":
            "sr_object_detection_tpu/kernels/phase_stem.py:235",
        "phase_train_fwdstats":
            "sr_object_detection_tpu/kernels/phase_train.py:209",
        "phase_train_fwdstats_tc":
            "sr_object_detection_tpu/kernels/phase_train.py:209",
        "phase_train_fwd":
            "sr_object_detection_tpu/kernels/phase_train.py:209",
        "phase_train_apply":
            "sr_object_detection_tpu/kernels/phase_train.py:722",
        "phase_train_bwdg":
            "sr_object_detection_tpu/kernels/phase_train.py:209",
        "phase_train_red":
            "sr_object_detection_tpu/kernels/phase_train.py:209",
        "phase_train_dy":
            "sr_object_detection_tpu/kernels/phase_train.py:209",
        "phase_train_dgrad":
            "sr_object_detection_tpu/kernels/phase_train.py:1256",
        "fused_stem_f2": "sr_object_detection_tpu/kernels/fused_stem.py:135",
        "fused_stem_b1": "sr_object_detection_tpu/kernels/fused_stem.py:170",
        "fused_stem_b2": "sr_object_detection_tpu/kernels/fused_stem.py:187"}
    sources = {name: "phase_train.cu" for name in replaces
               if name.startswith("phase_train")}
    sources.update(nms_per_class="nms.cu", stem_pair="phase_train.cu",
                   phase_stem_pair="phase_stem.cu", fused_stem_f2=
                   "fused_stem.cu", fused_stem_b1="fused_stem.cu",
                   fused_stem_b2="fused_stem.cu")
    # launches: each kernel's count on the main path that runs it
    main_counts = {**launches,
                   "phase_stem_pair": launches_b128["phase_stem_pair"],
                   **{k: v for k, v in launches_train.items()
                      if k.startswith("phase_train")},
                   **{k: launches_opt["bf16 + chain"][k] for k in
                      ("phase_train_red", "phase_train_dy",
                       "phase_train_dgrad")},
                   **{k: v for k, v in launches_opt["bf16 + fused_stem"]
                      .items() if k.startswith("fused_stem")},
                   "phase_train_fwdstats_tc":
                       conv_opt["bf16 + chain"]["fwdstats"],
                   "phase_train_fwd": launches_b128["phase_train_fwd"]}
    errs = {"nms_per_class": nms_err, "stem_pair": stem_err,
            "phase_stem_pair": ps_err,
            **{f"phase_train_{k}": v for k, v in train_errs.items()},
            **{f"phase_train_{k}": v for k, v in chain_errs.items()},
            "phase_train_fwdstats_tc": fwd_tc_err,
            "phase_train_fwd": fwd_err,
            **{f"fused_stem_{k}": v for k, v in stem_errs.items()}}
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"sr_object_detection_tpu_torch/csrc/{sources[name]}",
         "replaces": replaces[name], "launches": main_counts[name],
         "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1],
         # one PyTorch call computes dgrad's function (the conv's input
         # gradient); none computes per-class greedy NMS, conv + bias +
         # leaky + maxpool (+ requant), conv + BN statistics + pool, the
         # pooled BN apply with eps outside the sqrt, the gram-factored
         # backward, the recomputing BN-backward passes or the fused
         # BN/leaky/pool passes
         "library_ms": library.get(name)}
        for name in replaces] + yolo_train_kernels
    log(json.dumps({"yolov2_608_kernels": yolo_kernels}))
    log(gpu)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
