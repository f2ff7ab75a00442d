"""Times the int8 stem pairs (kernel 3) and the paths around them, in the
checkout this file lies in, for comparing two checkouts on one card.

    python3 tools/phase_stem_ab.py LABEL

Prints, with the card's name and power limit (tiny-yolo-voc-416, random
weights from seed 0, B=128):
  * each of the four int8 stem pairs on the engine's own inputs (pair 1
    from u8 frames, pairs 2-4 from the codes the pair before wrote), and
    the 4-pair chain from u8 frames: CUDA events over 20 back-to-back
    calls, best of two;
  * ``QuantizedThroughputEngine(phase_stem=True)`` on u8 frames: images/s
    over 20 queued batches, twice; under torch.profiler over 5 batches
    the device busy time per batch and the stem pairs' part of it;
  * what should not move: bf16 ``ThroughputEngine(phase_stem=True)``
    images/s over 20 queued batches, twice, and the bf16
    ``Trainer(phase_train=True)`` step: images/s over 5 queued steps,
    twice, and its device busy time per step over 2 profiled steps.

The file uses nothing else of tools/ or tests/, so a copy of it placed in
another checkout's tools/ times that checkout: run parent, change,
change, parent one after another on one card.
"""

from __future__ import annotations

import dataclasses
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

NET, BATCH = 416, 128


def cuda_ms(fn, iters=20, warmup=3):
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


def device_ms(fn, iters, key=None):
    """(device busy ms per call, the part of kernels whose name holds
    ``key``) under torch.profiler over ``iters`` calls after one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total / iters / 1e3, e.key)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    return (sum(ms for ms, _ in rows),
            sum(ms for ms, k in rows if key and key in k))


def main(label: str) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from sr_object_detection_tpu_torch.infer.detector import disable_tf32
    from sr_object_detection_tpu_torch.infer.engine import ThroughputEngine
    from sr_object_detection_tpu_torch.infer.quant import (
        QuantizedThroughputEngine)
    from sr_object_detection_tpu_torch.io.weights import init_params
    from sr_object_detection_tpu_torch.kernels import phase_stem as PS
    from sr_object_detection_tpu_torch.models.zoo import tiny_yolo_voc
    from sr_object_detection_tpu_torch.train.trainer import Trainer

    disable_tf32()
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    def say(msg):
        print(f"{label} {msg} [{card}]", flush=True)

    spec = tiny_yolo_voc()
    params = init_params(spec, seed=0)
    calib = np.random.default_rng(0).uniform(
        0, 1, (2, NET, NET, 3)).astype(np.float32)
    q = QuantizedThroughputEngine(spec, params, batch=BATCH, device=dev,
                                  calib_x=calib, phase_stem=True)
    qn = q.qnet
    frames = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (BATCH, NET, NET, 3), dtype=np.uint8)).to(dev)
    inv_u8 = float(np.float32(1.0 / (255.0 * qn.in_scale)))
    links = []
    v = frames
    for ci, _ in PS.plan_pairs(qn.spec):
        l = qn.spec.layers[ci]
        args = (v, qn.qparams[ci]["weights"], qn.qparams[ci]["dequant"],
                qn.qparams[ci]["biases"],
                float(np.float32(1.0 / qn.act_scales[ci])),
                inv_u8 if v.dtype == torch.uint8 else None)
        links.append(args)
        ms = min(cuda_ms(lambda: PS.stem_pair_i8(*args)) for _ in range(2))
        say(f"int8 stem pair {l.c}->{l.filters} @{l.h} B={BATCH}: {ms} ms")
        v = PS.stem_pair_i8(*args)

    def chain():
        x = frames
        for args in links:
            x = PS.stem_pair_i8(x, *args[1:5],
                                inv_u8 if x.dtype == torch.uint8 else None)
        return x
    ms = min(cuda_ms(chain) for _ in range(2))
    say(f"int8 stem chain, 4 pairs @{NET} B={BATCH} from u8 frames: {ms} ms")

    q.warmup()
    for _ in range(2):
        r = q.benchmark(iters=20, warmup=3, input_dtype=torch.uint8)
        say(f"QuantizedThroughputEngine int8 + phase stem B={BATCH} @{NET} "
            f"u8: {r['images_per_sec']} images/s")
    busy, stem = device_ms(lambda: q(frames), 5, key="phase_pair")
    say(f"QuantizedThroughputEngine int8 + phase stem: device busy {busy} "
        f"ms per batch, stem pairs {stem} ms ({stem / busy:.1%})")
    del q, links, v
    torch.cuda.empty_cache()

    eng = ThroughputEngine(spec, params, batch=BATCH, device=dev,
                           phase_stem=True)
    eng.warmup()
    for _ in range(2):
        r = eng.benchmark(iters=20, warmup=3)
        say(f"ThroughputEngine bf16 + phase stem B={BATCH} @{NET}: "
            f"{r['images_per_sec']} images/s")
    del eng
    torch.cuda.empty_cache()

    tspec = dataclasses.replace(spec, net=dataclasses.replace(
        spec.net, batch=BATCH, subdivisions=1))
    x = frames.float() / 255.0
    t_np = np.zeros((BATCH, 30, 5), np.float32)
    t_np[:, 0] = [0.5, 0.5, 0.3, 0.3, 1]
    t = torch.from_numpy(t_np).to(dev)
    trainer = Trainer(tspec, params, device=dev,
                      compute_dtype=torch.bfloat16, phase_train=True)
    rates = []
    for _ in range(2):
        float(trainer.step(x, t)["loss"])
        t0 = time.perf_counter()
        for _ in range(5):
            m = trainer.step(x, t)
        float(m["loss"])
        rates.append(5 * BATCH / (time.perf_counter() - t0))
    busy, _ = device_ms(lambda: trainer.step(x, t), 2)
    say(f"step bf16 + phase_train {NET} B={BATCH}: {rates[0]}, {rates[1]} "
        f"images/s; device busy {busy} ms per step")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "this"))
