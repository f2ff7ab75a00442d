"""Times the dgrad kernel and the training step that runs it, in the
checkout this file lies in, for comparing two checkouts on one card.

    python3 tools/dgrad_ab.py LABEL

Prints, with the card's name and power limit:
  * ``dgrad``: phase_train.dgrad (the kernel) beside F.conv_transpose2d
    (cuDNN, the one PyTorch call with dgrad's function) on the same bf16
    inputs, at the chain's second pair of tiny-yolo-voc-416 at B=128
    (208x208, Cout 32 -> Cin 16) and at the other widths the kernel takes
    (Cin 8 / 16, Cout 16 / 32 / 64); CUDA events over 20 back-to-back
    calls, best of two;
  * ``chain step``: Trainer.step bf16 with phase_train="chain" at 416,
    B=128 (random weights from seed 0, input as chip_smoke.py phase 13):
    images/s from the host clock around 5 queued steps, twice, and under
    torch.profiler over 2 steps the device busy time per step and the
    dgrad kernel's part of it.

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
import torch.nn.functional as F

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
    g = torch.Generator(device=dev).manual_seed(0)
    h = NET // 2
    for cin, cout in ((16, 32), (8, 32), (16, 16), (16, 64)):
        d = torch.randn((BATCH, h, h, cout), generator=g,
                        device=dev).to(torch.bfloat16)
        w = (0.3 * torch.randn((3, 3, cin, cout), generator=g,
                               device=dev)).to(torch.bfloat16)
        d_nchw = d.permute(0, 3, 1, 2)
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        kern = min(cuda_ms(lambda: PT.dgrad(d, w)) for _ in range(2))
        lib = min(cuda_ms(lambda: F.conv_transpose2d(d_nchw, w_oihw,
                                                     padding=1))
                  for _ in range(2))
        print(f"{label} dgrad {h}x{h} B={BATCH} {cout}->{cin}: kernel "
              f"{kern} ms, F.conv_transpose2d {lib} ms [{card}]",
              flush=True)
        del d, d_nchw
        torch.cuda.empty_cache()

    base = tiny_yolo_voc()
    spec = dataclasses.replace(base, net=dataclasses.replace(
        base.net, batch=BATCH, subdivisions=1))
    trainer = Trainer(spec, init_params(spec, seed=0), device=dev,
                      compute_dtype=torch.bfloat16, phase_train="chain")
    x = torch.from_numpy(np.random.default_rng(13).uniform(
        0, 1, (BATCH, NET, NET, 3)).astype(np.float32)).to(dev)
    t_np = np.zeros((BATCH, 30, 5), np.float32)
    t_np[:, 0] = [0.5, 0.5, 0.3, 0.3, 1]
    t = torch.from_numpy(t_np).to(dev)
    rates = []
    for _ in range(2):
        float(trainer.step(x, t)["loss"])
        t0 = time.perf_counter()
        for _ in range(5):
            m = trainer.step(x, t)
        float(m["loss"])
        rates.append(5 * BATCH / (time.perf_counter() - t0))
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            trainer.step(x, t)
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total / 2 / 1e3, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(ms for ms, _ in rows)
    dg = sum(ms for ms, key in rows if "dgrad_kernel" in key)
    print(f"{label} chain step {NET} B={BATCH}: {rates[0]}, {rates[1]} "
          f"images/s; device busy {busy} ms per step, dgrad_kernel {dg} ms "
          f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "this"))
