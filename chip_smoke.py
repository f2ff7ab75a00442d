"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — tiny-yolo-voc-416 detection — through the
entry points a user calls, builds the hand-written CUDA kernels from
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
  3. the slice at full width: Detector.detect on CUDA (random weights
     with randomized BN and biases, written as a .weights file) against
     the same Detector on the CPU, det for det; the C-oracle golden
     detect_tiny_yolo.npz on CUDA; LatencyEngine(fused_stem=True) on u8
     frames against fused_stem=False. Kernel launch counts are reset
     just before this phase and read just after it;
  4. the pipe server (infer/serve.py) on CUDA answers 3 requests, equal
     to the in-process Detector;
  5. times from CUDA events: each kernel beside its plain version and
     LatencyEngine per frame fused beside plain, each pair timed in turns
     (plain, kernel, kernel, plain); Detector.predict_batch and detect.

The last lines are the card (nvidia-smi), one JSON object describing the
kernels, and ``{"ok": true, "device": {...}}``.
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
from torch_parity import assert_bf16_close, random_bn  # noqa: E402 (JAX-free)


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


def bf16_err(got, ref) -> float:
    """Assert every element within one bf16 ulp (tests/torch_parity.py);
    return the max absolute difference."""
    got, ref = got.float().cpu().numpy(), ref.float().cpu().numpy()
    assert_bf16_close(got, ref)
    return float(np.abs(got - ref).max())


def match_dets(a, b, thr, margin):
    """Det for det within a prob band: every detection (class, prob, box)
    of either list with prob > thr + margin has one in the other list of
    the same class, a prob within margin and the same box (within bf16
    resolution). Returns how many were matched."""
    n = 0
    for x, y in ((a, b), (b, a)):
        for c, p, box in x:
            if p <= thr + margin:
                continue
            n += 1
            assert any(c2 == c and abs(p2 - p) <= margin
                       and np.allclose(b2, box, rtol=2 ** -6, atol=1e-3)
                       for c2, p2, b2 in y), (c, p, box)
    assert n > 0
    return n


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
    launches = {"nms_per_class": NMS.launches, "stem_pair": BS.launches}
    log(f"phase 3 ok: {n_dets} detections matched on CUDA and CPU; golden "
        f"gates met on CUDA (max |prob err| {golden_err}); {n_cands} "
        f"candidates matched between the fused and plain engines; "
        f"launches {launches} [{gpu}]")
    assert launches == {"nms_per_class": 4, "stem_pair": 12}, launches

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

    kernels = [
        {"name": "nms_per_class", "route": "cuda",
         "source": "sr_object_detection_tpu_torch/csrc/nms.cu",
         "replaces": "sr_object_detection_tpu/kernels/nms_pallas.py:29",
         "launches": launches["nms_per_class"], "max_abs_err": nms_err,
         "ms": times["nms_per_class"][0],
         "plain_ms": times["nms_per_class"][1]},
        {"name": "stem_pair", "route": "cuda",
         "source": "sr_object_detection_tpu_torch/csrc/b1_stem.cu",
         "replaces": "sr_object_detection_tpu/kernels/b1_stem.py:82",
         "launches": launches["stem_pair"], "max_abs_err": stem_err,
         "ms": times["stem_pair"][0], "plain_ms": times["stem_pair"][1]},
    ]
    log(gpu)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
