"""Times the fused stem's kernels (F2, B1, B2) and the training steps
that run them, in the checkout this file lies in, for comparing two
checkouts on one card.

    python3 tools/fused_stem_ab.py LABEL [--variants]

Prints, with the card's name and power limit:
  * ``F2``, ``B1``, ``B2``: kernels/fused_stem.f2, .b1 and .b2 (B1 with
    its colsum) at the conv outputs of the five fusable pairs of
    tiny-yolo-voc-416 at B=128 (416x416x16 ... 26x26x256), channels-last
    as the port's conv writes them on the card, on inputs as
    tests/torch_parity.stem_case makes them (seed 170 + pair); CUDA events
    over 20 back-to-back calls, best of two, and over a replay of 20 calls
    captured in one CUDA graph (device time without the host's launch
    cost, which bounds the back-to-back figure at the small pairs);
  * for the bf16 steps with the fused stem at 416, B=128 (random weights
    from seed 0, input as chip_smoke.py phase 13), ``fused_stem=True``
    and ``phase_train=True, fused_stem=True``: images/s from the host
    clock around 5 queued steps, twice, and under torch.profiler over 2
    steps the device busy time per step and the part of it in the B1 and
    B2 kernels and every ``colsum_kernel`` (the profiler cannot tell
    fused_stem.cu's colsum from phase_train.cu's; the latter's are a few
    microseconds a step).

With ``--variants`` (a checkout whose csrc/fused_stem.cu has
``f2_row_kernel``) it also builds the kernel library again under build/
with each other count of F2's row kernel's blocks an SM
(``-DF2_MIN_BLOCKS=1`` and ``3``; the library's own is 2) and times F2
at the five pairs through each, from a CUDA graph, checking its output
equal to the library's.

The file uses nothing else of tools/ or tests/, so a copy of it placed in
another checkout's tools/ times that checkout: run parent, change,
change, parent one after another on one card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

NET, BATCH = 416, 128
# the library rebuilt with other launch bounds of f2_row_kernel
VARIANTS = {"F2 one block an SM": ["-DF2_MIN_BLOCKS=1"],
            "F2 three blocks an SM": ["-DF2_MIN_BLOCKS=3"]}


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


def graph_ms(fn, iters=20):
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


def stem_args(seed, h, c, dev):
    """y (B,C,h,h) bf16 channels-last with exact ties in some windows,
    dp (B,C,h/2,h/2), the batch statistics, scales (one negative),
    biases, c1..c3: tests/torch_parity.stem_case's recipe."""
    g = torch.Generator(device=dev).manual_seed(seed)
    y = 1.5 * torch.randn((BATCH, c, h, h), generator=g, device=dev)
    y[:, :, 0:2, 0:2] = 0.75
    y[:, :, -2:, -1] = y[:, :, -2:, -2]
    cl = torch.channels_last
    y = y.to(torch.bfloat16).contiguous(memory_format=cl)
    dp = torch.randn((BATCH, c, h // 2, h // 2), generator=g,
                     device=dev).to(torch.bfloat16).contiguous(
                         memory_format=cl)
    scales = 0.5 + torch.rand(c, generator=g, device=dev)
    biases = torch.rand(c, generator=g, device=dev) - 0.5
    c1 = 0.5 + torch.rand(c, generator=g, device=dev)
    c2 = 1e-3 * torch.randn(c, generator=g, device=dev)
    c3 = 1e-3 * torch.randn(c, generator=g, device=dev)
    scales[1] = -0.8
    yf = y.float()
    mean = yf.mean(dim=(0, 2, 3))
    inv = 1.0 / (yf.var(dim=(0, 2, 3)).sqrt() + 1e-6)
    return y, dp, [mean, inv, scales, biases], [c1, c2, c3]


def build_variant(name, flags):
    """The kernel library compiled with extra nvcc ``flags``, loaded with
    the signatures of kernels/_build.py."""
    from sr_object_detection_tpu_torch.kernels import _build
    out = ROOT / "build" / "fused_stem_ab" / name.replace(" ", "_")
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = [(src, subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, *flags, "-c", str(src), "-o",
         str(out / (src.stem + ".o"))], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)) for src in _build._sources()]
    for src, proc in procs:
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {src.name} {flags}: {err}")
    lib_path = out / _build.LIB_NAME
    subprocess.run([nvcc, "-shared", "-o", str(lib_path),
                    *(str(out / (s.stem + ".o")) for s in _build._sources())],
                   check=True)
    lib = ctypes.CDLL(str(lib_path))
    for fn, (argtypes, restype) in _build.SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def main(label: str, variants: bool) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from sr_object_detection_tpu_torch.infer.detector import disable_tf32
    from sr_object_detection_tpu_torch.io.weights import init_params
    from sr_object_detection_tpu_torch.kernels import _build
    from sr_object_detection_tpu_torch.kernels import fused_stem as FS
    from sr_object_detection_tpu_torch.models.zoo import tiny_yolo_voc
    from sr_object_detection_tpu_torch.train.trainer import Trainer

    disable_tf32()
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs = {"library": _build.load()}
    if variants:
        libs.update((name, build_variant(name, flags))
                    for name, flags in VARIANTS.items())
    for k in range(5):
        h, c = NET >> k, 16 << k
        y, dp, k4, c3 = stem_args(170 + k, h, c, dev)
        f2 = min(cuda_ms(lambda: FS.f2(y, *k4)) for _ in range(2))
        gf = graph_ms(lambda: FS.f2(y, *k4))
        print(f"{label} F2 {h}x{h}x{c} B={BATCH}: {f2} ms, graph {gf} ms "
              f"[{card}]", flush=True)
        ref = FS.f2(y, *k4)
        for name, lib in libs.items():
            if name == "library":
                continue
            _build._lib = lib
            FS._row_grid.cache_clear()
            try:
                same = torch.equal(FS.f2(y, *k4), ref)
                gv = min(graph_ms(lambda: FS.f2(y, *k4)) for _ in range(2))
            finally:
                _build._lib = libs["library"]
                FS._row_grid.cache_clear()
            print(f"{label} F2 {h}x{h}x{c} B={BATCH}, {name} "
                  f"({' '.join(VARIANTS[name])}; output "
                  f"{'equal' if same else 'DIFFERS'}): graph {gv} ms "
                  f"[{card}]", flush=True)
        b1 = min(cuda_ms(lambda: FS.b1(y, dp, *k4)) for _ in range(2))
        b2 = min(cuda_ms(lambda: FS.b2(y, dp, *k4, *c3)) for _ in range(2))
        g1 = graph_ms(lambda: FS.b1(y, dp, *k4))
        g2 = graph_ms(lambda: FS.b2(y, dp, *k4, *c3))
        print(f"{label} B1 {h}x{h}x{c} B={BATCH}: {b1} ms, graph {g1} ms; "
              f"B2: {b2} ms, graph {g2} ms [{card}]", flush=True)
        del y, dp
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
    backward = re.compile(r"\b(b[12](_row)?|colsum)_kernel\b")
    forward = re.compile(r"\bf2(_row)?_kernel\b")
    for name, kw in (("fused_stem", dict(fused_stem=True)),
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
        bwd = sum(ms for ms, key in rows if backward.search(key))
        fwd = sum(ms for ms, key in rows if forward.search(key))
        print(f"{label} step bf16 + {name} {NET} B={BATCH}: {rates[0]}, "
              f"{rates[1]} images/s; device busy {busy} ms per step, F2 "
              f"kernels {fwd} ms, B1 + B2 kernels and colsum {bwd} ms "
              f"[{card}]", flush=True)
        del trainer
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    sys.exit(main(next((a for a in args if not a.startswith("--")), "this"),
                  "--variants" in args))
