"""Times the batch-1 stem (kernel 2) and the batch-1 frame that runs it, in
the checkout this file lies in, for comparing two checkouts on one card.

    python3 tools/b1_stem_ab.py LABEL [--variants]

Prints, with the card's name and power limit (tiny-yolo-voc-416, batch 1,
random weights from seed 0 with BN folded as LatencyEngine folds them):
  * the stem's four chained pairs (3 -> 16 @416 ... 64 -> 128 @52): device
    time a chain from a replay of 20 chains captured in one CUDA graph,
    best of two, and from CUDA events over 50 chains queued back to back
    (there the host's launch cost sets the figure once the kernels are
    short); each pair from a CUDA graph on the chain's own input;
  * ``LatencyEngine(fused_stem=True)`` on a u8 frame: wall time a frame
    (host clock around 50 frames ending in a synchronize, best of two),
    and under torch.profiler over 20 frames the device busy time a frame,
    the idle share and the part of the busy time in the stem's kernels.

With ``--variants`` (a checkout whose stem runs on the tensor-core conv
tile) it also builds the kernel library again under build/ with the
stem's channel group at 16 at every pair (``-DPT_STEM_NC=16``; the
library's own takes 32 where Cout allows) and times the chain and each
pair through it as above, checking its output equal to the library's.

The file uses nothing else of tools/ or tests/, so a copy of it placed in
another checkout's tools/ times that checkout: run parent, change,
change, parent one after another on one card.
"""

from __future__ import annotations

import ctypes
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

NET = 416
VARIANTS = {"NC 16": ["-DPT_STEM_NC=16"]}
STEM_KERNEL = re.compile(r"\bstem_(pair|tc|fold)_kernel\b")


def cuda_ms(fn, iters=50, warmup=5):
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


def build_variant(name, flags):
    """The kernel library compiled with extra nvcc ``flags``, loaded with
    the signatures of kernels/_build.py."""
    from sr_object_detection_tpu_torch.kernels import _build
    out = ROOT / "build" / "b1_stem_ab" / name.replace(" ", "_")
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

    from sr_object_detection_tpu_torch.infer.engine import LatencyEngine
    from sr_object_detection_tpu_torch.io.weights import init_params
    from sr_object_detection_tpu_torch.kernels import _build
    from sr_object_detection_tpu_torch.kernels import b1_stem as BS
    from sr_object_detection_tpu_torch.models.zoo import tiny_yolo_voc

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    def say(msg):
        print(f"{label} {msg} [{card}]", flush=True)

    spec = tiny_yolo_voc()
    eng = LatencyEngine(spec, init_params(spec, seed=0), device=dev,
                        fused_stem=True)
    pairs = BS.plan_pairs(eng.spec)
    packed = [(eng.params[ci]["weights"].permute(2, 3, 1, 0)
               .to(torch.bfloat16).contiguous(),
               eng.params[ci]["biases"].float().contiguous())
              for ci, _ in pairs]
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 1, (1, NET, NET, 3)).astype(np.float32)).to(dev, torch.bfloat16)
    inputs, v = [], x
    for w, b in packed:
        inputs.append(v)
        v = BS.stem_pair(v, w, b)
    ref = v.clone()

    def chain():
        return eng._stem(x)

    def time_stem(tag):
        gm = min(graph_ms(chain) for _ in range(2))
        bm = min(cuda_ms(chain) for _ in range(2))
        say(f"stem, 4 chained pairs @{NET} batch 1{tag}: {gm} ms from a "
            f"CUDA graph, {bm} ms back to back")
        for (ci, _), (w, b), xi in zip(pairs, packed, inputs):
            l = eng.spec.layers[ci]
            pm = min(graph_ms(lambda: BS.stem_pair(xi, w, b))
                     for _ in range(2))
            say(f"stem pair {l.c}->{l.filters} @{l.h}{tag}: {pm} ms from "
                f"a CUDA graph")

    time_stem("")
    if variants:
        lib = _build.load()
        try:
            for name, flags in VARIANTS.items():
                _build._lib = build_variant(name, flags)
                same = torch.equal(chain(), ref)
                time_stem(f", {name} ({' '.join(flags)}; output "
                          f"{'equal' if same else 'DIFFERS'})")
        finally:
            _build._lib = lib

    frame = np.random.default_rng(6).integers(0, 256, (NET, NET, 3),
                                              dtype=np.uint8)
    for _ in range(5):
        eng(frame)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            eng(frame)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / 50 * 1e3)
    iters = 20
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            eng(frame)
        torch.cuda.synchronize()
        wall_p = (time.perf_counter() - t0) / iters * 1e3
    rows = [(e.self_device_time_total / iters / 1e3, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(ms for ms, _ in rows)
    stem = sum(ms for ms, key in rows if STEM_KERNEL.search(key))
    say(f"LatencyEngine bf16 fused stem @{NET}: wall {min(walls)} ms a frame "
        f"({walls}); under the profiler wall {wall_p} ms, device busy "
        f"{busy} ms a frame (idle share {1 - busy / wall_p}), the stem's "
        f"kernels {stem} ms")
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    sys.exit(main(next((a for a in args if not a.startswith("--")), "this"),
                  "--variants" in args))
