"""Times the conv of fwdstats, red and dy and the paths that run them, in
the checkout this file lies in, for comparing two checkouts on one card.

    python3 tools/conv_tile_ab.py LABEL

Prints, with the card's name and power limit (tiny-yolo-voc-416, random
weights from seed 0, B=128):
  * ``fwdstats`` (the kernel and its colsum) at 16->32 @208, 32->64 @104
    and 64->128 @52, ``red`` and ``dy`` (+ dw) at 208x208, 16->32 (the
    chain's pair 1): CUDA events over 20 back-to-back calls, best of two;
  * the bf16 steps ``phase_train="chain"`` (runs all three on pair 1),
    ``phase_train=True``, ``phase_train=True, fused_stem=True`` and
    ``fused_stem=True``: images/s from the host clock around 5 queued
    steps, twice, and under torch.profiler over 2 steps the device busy
    time per step and the part of fwdstats, red and dy in it;
  * ``ThroughputEngine(phase_stem=True)`` (bf16; pairs 2-4 run fwdstats)
    and ``QuantizedThroughputEngine(phase_stem=True)`` (int8, u8 frames):
    images/s over 20 queued batches, twice; the batch-1
    ``LatencyEngine(fused_stem=True)``: device ms per frame over 50
    queued frames.

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
CONV_KEYS = ("fwdstats", "red_tc", "dy_tc", "chain_bwd")


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


def conv_inputs(PT, h, cin, cout, dev):
    """x uniform [0, 1), w normal(0, 0.3), a BN shift and scales of both
    signs, the pooled cotangent dp, the batch statistics of the conv and
    BN-backward constants of their size, from a seed."""
    g = torch.Generator(device=dev).manual_seed(h + cin + cout)
    bf = torch.bfloat16
    x = torch.rand((BATCH, h, h, cin), generator=g, device=dev).to(bf)
    w = (0.3 * torch.randn((3, 3, cin, cout), generator=g,
                           device=dev)).to(bf)
    shift = 0.1 * torch.randn(cout, generator=g, device=dev)
    scales = torch.linspace(-1, 1, cout, device=dev)
    dp = torch.randn((BATCH, h // 2, h // 2, cout), generator=g,
                     device=dev).to(bf)
    _, _, st = PT.fwdstats_plain(x, w, shift, scales)
    mean, _, inv = PT._batch_stats(st, shift, BATCH * h * h)
    biases = 0.2 * torch.randn(cout, generator=g, device=dev)
    c1 = 0.5 + torch.rand(cout, generator=g, device=dev)
    c23 = 1e-3 * torch.randn((2, cout), generator=g, device=dev)
    return x, w, shift, scales, dp, mean, inv, biases, c1, c23[0], c23[1]


def main(label: str) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from sr_object_detection_tpu_torch.infer.detector import disable_tf32
    from sr_object_detection_tpu_torch.infer.engine import (
        LatencyEngine, ThroughputEngine)
    from sr_object_detection_tpu_torch.infer.quant import (
        QuantizedThroughputEngine)
    from sr_object_detection_tpu_torch.io.weights import init_params
    from sr_object_detection_tpu_torch.kernels import phase_train as PT
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

    for h, cin, cout in ((NET // 2, 16, 32), (NET // 4, 32, 64),
                         (NET // 8, 64, 128)):
        x, w, shift, scales, dp, mean, inv, b, c1, c2, c3 = conv_inputs(
            PT, h, cin, cout, dev)
        ms = min(cuda_ms(lambda: PT.fwdstats(x, w, shift, scales))
                 for _ in range(2))
        say(f"fwdstats {cin}->{cout} @{h} B={BATCH}: {ms} ms")
        if cin == 16:
            args = (x, w, dp, mean, inv, scales, b)
            ms = min(cuda_ms(lambda: PT.red(*args)) for _ in range(2))
            say(f"red {cin}->{cout} @{h} B={BATCH}: {ms} ms")
            ms = min(cuda_ms(lambda: PT.dy(*args, c1, c2, c3))
                     for _ in range(2))
            say(f"dy (+dw) {cin}->{cout} @{h} B={BATCH}: {ms} ms")
        del x, dp
        torch.cuda.empty_cache()

    base = tiny_yolo_voc()
    spec = dataclasses.replace(base, net=dataclasses.replace(
        base.net, batch=BATCH, subdivisions=1))
    params = init_params(spec, seed=0)
    x = torch.from_numpy(np.random.default_rng(13).uniform(
        0, 1, (BATCH, NET, NET, 3)).astype(np.float32)).to(dev)
    t_np = np.zeros((BATCH, 30, 5), np.float32)
    t_np[:, 0] = [0.5, 0.5, 0.3, 0.3, 1]
    t = torch.from_numpy(t_np).to(dev)
    for name, kw in (("chain", dict(phase_train="chain")),
                     ("phase_train", dict(phase_train=True)),
                     ("phase_train + fused_stem",
                      dict(phase_train=True, fused_stem=True)),
                     ("fused_stem", dict(fused_stem=True))):
        trainer = Trainer(spec, params, device=dev,
                          compute_dtype=torch.bfloat16, **kw)
        rates = []
        for _ in range(2):
            float(trainer.step(x, t)["loss"])
            t0 = time.perf_counter()
            for _ in range(5):
                m = trainer.step(x, t)
            float(m["loss"])
            rates.append(5 * BATCH / (time.perf_counter() - t0))
        with torch.profiler.profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                trainer.step(x, t)
            torch.cuda.synchronize()
        rows = [(e.self_device_time_total / 2 / 1e3, e.key)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        busy = sum(ms for ms, _ in rows)
        conv = sum(ms for ms, key in rows
                   if any(k in key for k in CONV_KEYS))
        say(f"step bf16 + {name} {NET} B={BATCH}: {rates[0]}, {rates[1]} "
            f"images/s; device busy {busy} ms per step, fwdstats/red/dy "
            f"kernels {conv} ms")
        del trainer
        torch.cuda.empty_cache()

    fspec = tiny_yolo_voc()
    fparams = init_params(fspec, seed=0)
    eng = ThroughputEngine(fspec, fparams, batch=BATCH, device=dev,
                           phase_stem=True)
    eng.warmup()
    for _ in range(2):
        r = eng.benchmark(iters=20, warmup=3)
        say(f"ThroughputEngine bf16 + phase stem B={BATCH} @{NET}: "
            f"{r['images_per_sec']} images/s")
    del eng
    calib = np.random.default_rng(0).uniform(
        0, 1, (2, NET, NET, 3)).astype(np.float32)
    q = QuantizedThroughputEngine(fspec, fparams, batch=BATCH, device=dev,
                                  calib_x=calib, phase_stem=True)
    q.warmup()
    for _ in range(2):
        r = q.benchmark(iters=20, warmup=3, input_dtype=torch.uint8)
        say(f"QuantizedThroughputEngine int8 + phase stem B={BATCH} @{NET} "
            f"u8: {r['images_per_sec']} images/s")
    del q
    lat = LatencyEngine(fspec, fparams, device=dev, fused_stem=True)
    ms = lat.device_benchmark(reps=50)["device_ms_per_frame"]
    say(f"LatencyEngine bf16 fused stem @{NET} batch 1: {ms} ms per frame")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "this"))
