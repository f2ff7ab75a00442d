"""Times the bwdg kernel and the training steps that run it, in the
checkout this file lies in, for comparing two checkouts on one card.

    python3 tools/bwdg_ab.py LABEL

Prints, with the card's name and power limit:
  * ``bwdg``: phase_train.bwdg (the kernel and its colsum) at the leading
    pair of tiny-yolo-voc-416 at B=128 (416x416, Cin 3 -> Cout 16) and at
    Cout 32, on inputs as chip_smoke.py phase 12's (tests/torch_parity
    train_case's recipe, seed 12); CUDA events over 20 back-to-back
    calls, best of two;
  * for the bf16 steps with the pair at 416, B=128 (random weights from
    seed 0, input as chip_smoke.py phase 13), ``phase_train=True`` and
    ``phase_train=True, fused_stem=True``: images/s from the host clock
    around 5 queued steps, twice, and under torch.profiler over 2 steps
    the device busy time per step and the bwdg kernels' part of it.

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


def bwdg_args(PT, cout, dev):
    """bwdg's inputs at the leading pair: x uniform [0, 1), w normal(0,
    0.3) with its last channel zero, one negative BN scale, dp normal;
    Z and the argmax from fwdstats' plain version."""
    rng = np.random.default_rng(12)
    w = rng.normal(0, 0.3, (3, 3, 3, cout)).astype(np.float32)
    w[..., -1] = 0
    scales = rng.uniform(0.6, 1.4, cout).astype(np.float32)
    scales[1] = -0.8
    x = rng.uniform(0, 1, (BATCH, NET, NET, 3)).astype(np.float32)
    shift = rng.normal(0, 0.1, cout).astype(np.float32)
    biases = rng.normal(0, 0.2, cout).astype(np.float32)
    dp = rng.normal(0, 1, (BATCH, NET // 2, NET // 2, cout)).astype(
        np.float32)
    t = {k: torch.from_numpy(v).to(dev) for k, v in dict(
        x=x, w=w, shift=shift, scales=scales, biases=biases, dp=dp).items()}
    for k in ("x", "w", "dp"):
        t[k] = t[k].to(torch.bfloat16)
    z, am, st = PT.fwdstats_plain(t["x"], t["w"], t["shift"], t["scales"])
    mean, _, inv = PT._batch_stats(st, t["shift"], BATCH * NET * NET)
    return (t["x"], t["dp"], z, am, mean, inv, t["scales"], t["biases"])


def main(label: str) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from sr_object_detection_tpu_torch.infer.detector import disable_tf32
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
    for cout in (16, 32):
        args = bwdg_args(PT, cout, dev)
        kern = min(cuda_ms(lambda: PT.bwdg(*args)) for _ in range(2))
        print(f"{label} bwdg {NET} B={BATCH} 3->{cout}: {kern} ms [{card}]",
              flush=True)
        del args
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
    for name, kw in (("phase_train", dict(phase_train=True)),
                     ("phase_train + fused_stem",
                      dict(phase_train=True, fused_stem=True))):
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
        bw = sum(ms for ms, key in rows if "bwdg" in key)
        print(f"{label} step bf16 + {name} {NET} B={BATCH}: {rates[0]}, "
              f"{rates[1]} images/s; device busy {busy} ms per step, bwdg "
              f"kernels {bw} ms [{card}]", flush=True)
        del trainer
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "this"))
