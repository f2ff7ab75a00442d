"""Times the leading pair's fwdstats (3 -> 16) and the paths that run it,
in the checkout this file lies in, for comparing two checkouts on one
card.

    python3 tools/fwdstats_fold_ab.py LABEL [--variants]

Prints, with the card's name and power limit (tiny-yolo-voc-416, B=128):
  * ``fwdstats`` (the kernel and its colsum) at 3 -> 16, 416x416, on x
    uniform [0, 1), w normal(0, 0.3) and BN scales of both signs from a
    seed: device time a call from a replay of 20 calls captured in one
    CUDA graph, and from CUDA events over 20 back-to-back calls, best of
    two each;
  * ``ThroughputEngine(phase_stem=True)`` (bf16, random weights from seed
    0; its pair 1 runs fwdstats at 3 -> 16): images/s over 20 queued
    batches, twice, and under torch.profiler over 5 batches the device
    busy time a batch and the part of it in pair 1's fwdstats kernel;
  * the bf16 step with ``phase_train=True, fused_stem=True`` (input as
    chip_smoke.py phase 13): images/s from the host clock around 5 queued
    steps, twice, and under torch.profiler over 2 steps the device busy
    time a step and the part of it in pair 0's fwdstats kernel.

With ``--variants`` (a checkout whose csrc/phase_train.cu has the taps
fold) it also builds the kernel library again with each of the fold's
probes under build/ (``-DPT_FOLD_PROBE=1/2/3``: without the epilogue,
without building X', with float32 statistics), times fwdstats 3 -> 16
through each as above and says whether its Z and argmax equal the
library's and how far its statistics are (a probe's outputs are not
meant to be right).

The file uses nothing else of tools/ or tests/, so a copy of it placed in
another checkout's tools/ times that checkout: run parent, change,
change, parent one after another on one card.
"""

from __future__ import annotations

import ctypes
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
# the fold's compile-time probes (csrc/phase_train.cu), each leaving out
# a part of its work
VARIANTS = {"no epilogue": ["-DPT_FOLD_PROBE=1"],
            "no X' build": ["-DPT_FOLD_PROBE=2"],
            "float32 statistics": ["-DPT_FOLD_PROBE=3"]}


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


def device_busy(fn, iters):
    """(device busy ms a call, the part in the leading pair's fwdstats
    kernel: fwdstats_kernel or fwdstats_fold_kernel) under torch.profiler
    over ``iters`` calls after one warm-up."""
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
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    return (sum(ms for ms, _ in rows),
            sum(ms for ms, key in rows if "fwdstats_kernel" in key
                or "fwdstats_fold_kernel" in key))


def build_variant(name, flags):
    """The kernel library compiled with extra nvcc ``flags``, loaded with
    the signatures of kernels/_build.py."""
    from sr_object_detection_tpu_torch.kernels import _build
    out = ROOT / "build" / "fwdstats_fold_ab" / name.replace(" ", "_")
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
    from sr_object_detection_tpu_torch.infer.detector import disable_tf32
    from sr_object_detection_tpu_torch.infer.engine import ThroughputEngine
    from sr_object_detection_tpu_torch.io.weights import init_params
    from sr_object_detection_tpu_torch.kernels import _build
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

    g = torch.Generator(device=dev).manual_seed(12)
    x = torch.rand((BATCH, NET, NET, 3), generator=g, device=dev).to(
        torch.bfloat16)
    w = (0.3 * torch.randn((3, 3, 3, 16), generator=g, device=dev)).to(
        torch.bfloat16)
    shift = 0.1 * torch.randn(16, generator=g, device=dev)
    scales = torch.linspace(-1, 1, 16, device=dev)

    def fwd():
        return PT.fwdstats(x, w, shift, scales)

    def time_fwdstats(tag):
        gm = min(graph_ms(fwd) for _ in range(2))
        bm = min(cuda_ms(fwd) for _ in range(2))
        say(f"fwdstats 3->16 @{NET} B={BATCH}{tag}: {gm} ms from a CUDA "
            f"graph, {bm} ms back to back")

    time_fwdstats("")
    if variants:
        lib = _build.load()
        ref = [t.clone() for t in fwd()]
        try:
            for name, flags in VARIANTS.items():
                _build._lib = build_variant(name, flags)
                got = fwd()
                same = all(torch.equal(a, b) for a, b in zip(got[:2],
                                                             ref[:2]))
                rel = ((got[2] - ref[2]).abs().max()
                       / ref[2].abs().max()).item()
                time_fwdstats(f", {name} ({' '.join(flags)}; Z and argmax "
                              f"{'equal' if same else 'differ'}, "
                              f"statistics max rel {rel})")
        finally:
            _build._lib = lib
    del x
    torch.cuda.empty_cache()

    spec = tiny_yolo_voc()
    params = init_params(spec, seed=0)
    eng = ThroughputEngine(spec, params, batch=BATCH, device=dev,
                           phase_stem=True)
    eng.warmup()
    xb = torch.from_numpy(np.random.default_rng(7).uniform(
        0, 1, (BATCH, NET, NET, 3)).astype(np.float32)).to(dev)
    rates = [eng.benchmark(iters=20, warmup=3)["images_per_sec"]
             for _ in range(2)]
    busy, fw = device_busy(lambda: eng(xb), 5)
    say(f"ThroughputEngine bf16 + phase stem B={BATCH} @{NET}: {rates[0]}, "
        f"{rates[1]} images/s; device busy {busy} ms a batch, pair 1's "
        f"fwdstats kernel {fw} ms")
    del eng, xb
    torch.cuda.empty_cache()

    base = tiny_yolo_voc()
    tspec = dataclasses.replace(base, net=dataclasses.replace(
        base.net, batch=BATCH, subdivisions=1))
    tparams = init_params(tspec, seed=0)
    xt = torch.from_numpy(np.random.default_rng(13).uniform(
        0, 1, (BATCH, NET, NET, 3)).astype(np.float32)).to(dev)
    t_np = np.zeros((BATCH, 30, 5), np.float32)
    t_np[:, 0] = [0.5, 0.5, 0.3, 0.3, 1]
    tt = torch.from_numpy(t_np).to(dev)
    trainer = Trainer(tspec, tparams, device=dev,
                      compute_dtype=torch.bfloat16, phase_train=True,
                      fused_stem=True)
    rates = []
    for _ in range(2):
        float(trainer.step(xt, tt)["loss"])
        t0 = time.perf_counter()
        for _ in range(5):
            m = trainer.step(xt, tt)
        float(m["loss"])
        rates.append(5 * BATCH / (time.perf_counter() - t0))
    busy, fw = device_busy(lambda: trainer.step(xt, tt), 2)
    say(f"step bf16 + phase_train + fused_stem {NET} B={BATCH}: {rates[0]}, "
        f"{rates[1]} images/s; device busy {busy} ms a step, pair 0's "
        f"fwdstats kernel {fw} ms")
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    sys.exit(main(next((a for a in args if not a.startswith("--")), "this"),
                  "--variants" in args))
