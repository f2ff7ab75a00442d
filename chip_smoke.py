"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths — tiny-yolo-voc-416 detection at batch 1
and batch-128 serving in bf16 and int8 — through the entry points a user
calls, builds the hand-written CUDA kernels from
``sr_object_detection_tpu_torch/csrc`` and holds each against its plain
PyTorch version. Phases, in order; any failure ends the run with a
non-zero status and no result line:

  0. device: a CUDA device, its name and power limit, the kernel build;
  1. the NMS kernel against its plain version (C=20, k=128 and k=845,
     random boxes plus ties): same suppression pattern, values to 1e-6;
  2. the batch-1 stem kernel against its plain version at the four
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
     timed in turns (plain, kernel, kernel, plain); Detector.predict_batch
     and detect;
  6. the int8 stem kernel (csrc/phase_stem.cu) against its plain version
     at the four tiny-yolo-416 pair shapes at batch 128 with random int8
     data (pair 1 also from u8 frames), then link by link along the
     engine's own chain from u8 frames, and the whole chain: every one
     torch.equal (the chain is exact);
  7. the batch-128 slice at full width: ThroughputEngine (bf16) and
     QuantizedThroughputEngine (int8, u8 frames) with and without the
     phase stem; the two int8 engines' int8 trunks equal and their
     outputs equal (or within one bf16 step of the head's logits, should
     cuDNN pick another algorithm). Launch counts are reset just before
     this phase and read just after it;
  8. the int8 Detector on CUDA against the same Detector on the CPU, det
     for det within a prob band (the two calibrations differ in the last
     bits); the int8 LatencyEngine's candidates are finite;
  9. the pipe server with --int8 answers 3 requests, equal to the
     in-process int8 Detector calibrated on the same first frame;
 10. times from CUDA events, in turns: the int8 stem chain against its
     plain chain; images/s of ThroughputEngine bf16 and of the int8
     engine on u8 frames without and with the phase stem (host clock
     around queued batches, one sync); the int8 LatencyEngine per frame
     and best_latency_engine's selection;
 11. torch.profiler over each engine: wall and device busy time per
     frame or batch, the device's idle share, the top kernels.

The last lines are the card (nvidia-smi), one JSON object describing the
kernels (time, plain time, bound and launches of each), and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import pathlib
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
from torch_parity import (assert_bf16_close, phase_pair_case,  # noqa: E402
                          random_bn)                           # (JAX-free)

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


def log(msg):
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


def profile(name, fn, iters, gpu, top=6):
    """torch.profiler over ``iters`` calls of fn after one warm-up: wall
    time per call (host clock, ending in a synchronize, profiler
    overhead included), device busy time per call (the CUDA kernels'
    self time; the port runs one stream, so kernels do not overlap),
    the idle share, and the kernels that take the most device time."""
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
    rows = [(e.self_device_time_total / iters / 1e3, e.key) for e in
            prof.key_averages() if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(t for t, _ in rows)
    if busy == 0:
        log(f"profile {name}: wall {wall} ms; device time not measured "
            f"(the profiler saw no kernel) [{gpu}]")
        return
    log(f"profile {name}: wall {wall} ms, device busy {busy} ms, idle "
        f"share {1 - busy / wall} [{gpu}]")
    for t, key in sorted(rows, reverse=True)[:top]:
        log(f"  {t} ms ({t / busy:.1%}) {key[:90]}")


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
    from sr_object_detection_tpu_torch.kernels import nms as NMS
    from sr_object_detection_tpu_torch.kernels import phase_stem as PS
    from sr_object_detection_tpu_torch.models.zoo import tiny_yolo_voc
    from sr_object_detection_tpu_torch.ops import boxes as B

    disable_tf32()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.load()
    log(f"phase 0 ok: kernels built and loaded in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds} s) "
        f"from {_build.library_path().relative_to(ROOT)} [{gpu}]")

    # ---------------------------------------------------------- phase 1
    rng = np.random.default_rng(0)
    nms_err = 0.0
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
        assert torch.equal(got > 0, ref > 0), f"NMS pattern differs, k={k}"
        err = (got - ref).abs().max().item()
        assert err <= 1e-6, f"NMS values differ by {err}, k={k}"
        nms_err = max(nms_err, err)
    assert NMS.launches == before + 2
    log(f"phase 1 ok: NMS kernel == plain at C=20 k=128,845 "
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
        log(f"  stem pair {l.c}->{l.filters} @{l.h}: max |err| {e}")
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
    log(f"phase 2 ok: stem kernel == plain at the 4 pair shapes and along "
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

    NMS.launches = 0
    BS.launches = 0
    PS.launches = 0
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
    launches = {"nms_per_class": NMS.launches, "stem_pair": BS.launches,
                "phase_stem_pair": PS.launches}
    log(f"phase 3 ok: {n_dets} detections matched on CUDA and CPU; golden "
        f"gates met on CUDA (max |prob err| {golden_err}); {n_cands} "
        f"candidates matched between the fused and plain engines; "
        f"launches {launches} [{gpu}]")
    assert launches == {"nms_per_class": 4, "stem_pair": 12,
                        "phase_stem_pair": 0}, launches

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
        p1 = cuda_ms(plain_fn, plain_iters)
        k1, k2 = cuda_ms(kernel_fn, iters), cuda_ms(kernel_fn, iters)
        p2 = cuda_ms(plain_fn, plain_iters)
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
    for (xi, w, b), (ci, _) in zip(pair_inputs, pairs):
        l = fspec.layers[ci]
        abba(f"stem pair {l.c}->{l.filters} @{l.h}",
             lambda: BS.stem_pair(xi, w, b),
             lambda: BS.stem_pair_plain(xi, w, b))
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
    n_bytes = n_ops = 0
    for (w, b), (ci, _) in zip(packed, pairs):
        l = fspec.layers[ci]
        n_bytes += (2 * (l.h * l.w * l.c + l.out_h // 2 * l.out_w // 2
                         * l.filters) + 2 * w.numel() + 4 * b.numel())
        n_ops += 2 * l.h * l.w * l.filters * 9 * l.c
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
    ps_inputs = []
    for k, (ci, _) in enumerate(qpairs):
        l = qn.spec.layers[ci]
        for x_dtype in ([np.uint8, np.int8] if k == 0 else [np.int8]):
            case = phase_pair_case(100 + k, BATCH, l.h, l.c, l.filters,
                                   x_dtype)
            args = (*(torch.from_numpy(a).to(dev) for a in case[:4]),
                    float(case[4]),
                    None if case[5] is None else float(case[5]))
            got = PS.stem_pair_i8(*args)
            ref = PS.stem_pair_i8_plain(*args)
            torch.cuda.synchronize()
            err = (got.int() - ref.int()).abs().max().item()
            assert torch.equal(got, ref), (l.c, l.filters, x_dtype, err)
            ps_err = max(ps_err, err)
            if x_dtype == np.int8:
                ps_inputs.append((l, args))
        log(f"  int8 stem pair {l.c}->{l.filters} @{l.h} B={BATCH}: "
            f"kernel == plain")
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
    for w, dq, b, inv_out in links:
        ii = inv_u8 if v.dtype == torch.uint8 else None
        out = PS.stem_pair_i8(v, w, dq, b, inv_out, ii)
        assert torch.equal(out, PS.stem_pair_i8_plain(v, w, dq, b, inv_out,
                                                      ii))
        v = out
    n_stem = qpairs[-1][1] + 1
    assert torch.equal(qn.forward(frames_u8, stop=n_stem), v)
    assert torch.equal(int8_chain(frames_u8, PS.stem_pair_i8_plain), v)
    assert v.abs().max().item() > 60
    log(f"phase 6 ok: int8 stem kernel == plain at the 4 pair shapes at "
        f"B={BATCH} (pair 1 also from u8 frames), link by link along the "
        f"engine's chain and whole [{gpu}]")

    # ---------------------------------------------------------- phase 7
    bf = ThroughputEngine(qspec, qparams_np, batch=BATCH, device=dev)
    head = len(qspec.layers) - 2
    r = qspec.layers[-1]
    n_out = r.h * r.w * r.n * (r.coords + r.classes + 1)
    NMS.launches = 0
    BS.launches = 0
    PS.launches = 0
    out_bf = bf(frames_u8.float() / 255.0)
    out_s = q_stem(frames_u8)
    out_p = q_plain(frames_u8)
    torch.cuda.synchronize()
    launches_b128 = {"nms_per_class": NMS.launches,
                     "stem_pair": BS.launches,
                     "phase_stem_pair": PS.launches}
    assert launches_b128 == {"nms_per_class": 0, "stem_pair": 0,
                             "phase_stem_pair": 4}, launches_b128
    for o, dt in ((out_bf, torch.bfloat16), (out_s, torch.float32),
                  (out_p, torch.float32)):
        assert o.shape == (BATCH, n_out) and o.dtype == dt, o.shape
        assert torch.isfinite(o.float()).all()
    assert torch.equal(q_stem.qnet.forward(frames_u8, stop=head),
                       q_plain.qnet.forward(frames_u8, stop=head))
    out_diff = (out_s - out_p).abs().max().item()
    # equal unless cuDNN picked another algorithm for the bf16 head of
    # one engine: then within one bf16 step of the logits
    assert out_diff <= 2 ** -7, out_diff
    log(f"phase 7 ok: bf16 ThroughputEngine and int8 engines at B={BATCH} "
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
    for l, args in ps_inputs:
        abba(f"int8 stem pair {l.c}->{l.filters} @{l.h} B={BATCH}",
             lambda: PS.stem_pair_i8(*args),
             lambda: PS.stem_pair_i8_plain(*args), iters=20, plain_iters=5)
    n_bytes = BATCH * NET * NET * 3
    n_ops = 0
    for k, (ci, _) in enumerate(qpairs):
        l = qn.spec.layers[ci]
        out_b = BATCH * (l.h // 2) * (l.w // 2) * l.filters
        n_bytes += (9 * l.c * l.filters + 8 * l.filters
                    + out_b * (1 if k == len(qpairs) - 1 else 2))
        n_ops += 2 * BATCH * l.h * l.w * l.filters * 9 * l.c
    bounds["phase_stem_pair"] = bound(n_bytes, n_ops, "int8")
    log(f"bound int8 stem chain: {bounds['phase_stem_pair'][0]} ms by "
        f"{bounds['phase_stem_pair'][1]} ({n_bytes} bytes, {n_ops} int8 "
        f"ops) [{gpu}]")

    bf.warmup()
    r_bf = bf.benchmark(iters=20, warmup=3)
    log(f"time ThroughputEngine bf16 B={BATCH} @{NET}: "
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
    profile(f"int8 engine B={BATCH} @{NET} u8, phase stem, per batch",
            lambda: q_stem(frames_u8), 5, gpu)
    profile(f"int8 engine B={BATCH} @{NET} u8, plain, per batch",
            lambda: q_plain(frames_u8), 3, gpu)

    replaces = {
        "nms_per_class": "sr_object_detection_tpu/kernels/nms_pallas.py:29",
        "stem_pair": "sr_object_detection_tpu/kernels/b1_stem.py:82",
        "phase_stem_pair":
            "sr_object_detection_tpu/kernels/phase_stem.py:235"}
    sources = {"nms_per_class": "nms.cu", "stem_pair": "b1_stem.cu",
               "phase_stem_pair": "phase_stem.cu"}
    launches.update(phase_stem_pair=launches_b128["phase_stem_pair"])
    errs = {"nms_per_class": nms_err, "stem_pair": stem_err,
            "phase_stem_pair": ps_err}
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"sr_object_detection_tpu_torch/csrc/{sources[name]}",
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1],
         # no single PyTorch call computes per-class greedy NMS or
         # conv + bias + leaky + maxpool (+ requant)
         "library_ms": None}
        for name in ("nms_per_class", "stem_pair", "phase_stem_pair")]
    log(gpu)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
