"""Times the bf16 serving stem (kernel 4's mode fwd) and the batch that runs
it, in the checkout this file lies in, for comparing two checkouts on one
card.

    python3 tools/bf16_stem_ab.py LABEL [--variants]

Prints, with the card's name and power limit
(``ThroughputEngine(phase_stem=True)``, tiny-yolo-voc-416, batch 128,
random weights from seed 0 with randomized BN, folded as the engine folds
them; u8 frames from a seed):
  * each of the stem's four pairs (3 -> 16 @416 ... 64 -> 128 @52) on its
    input along the engine's chain: device time a pair from a replay of 10
    pairs captured in one CUDA graph, best of two, beside its bound (the
    pair's input read once, weights and bias read once, its output written
    once, or its bf16 products at 989 TFLOP/s, whichever is longer). A pair
    is ``phase_train.fwd_pair`` where the checkout has it, else its former
    form, fwdstats + apply with identity BN constants;
  * the four chained pairs (the engine's stem) from a CUDA graph;
  * the engine: images/s (host clock around 20 queued batches and one
    sync, best of two), and under torch.profiler over 5 batches the wall
    and device busy time a batch, the idle share and the stem's kernels'
    part of the busy time.

With ``--variants`` (a checkout whose stem has the fwd kernel) it also
builds the kernel library under build/ from copies of the sources in which
csrc/phase_train.cu is patched: the fwd tile's channel group at 16 (the
library's takes 32 where Cout allows) and three blocks an SM on the tile
(the library's asks for two); it times the pairs and the chain through
each, checking the chain's output equal to the library's.

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

NET, BATCH = 416, 128
HBM_BYTES_S, BF16_OPS_S = 3.35e12, 989e12     # H100 SXM, 700 W
# name -> [(text of csrc/phase_train.cu, its replacement)]
VARIANTS = {
    "NC 16": [("Cout % 32 == 0 && (mode != CT_STEM || PT_STEM_NC == 32) ?",
               "Cout % 32 == 0 && (mode != CT_STEM || PT_STEM_NC == 32) && "
               "mode != CT_FWD ?")],
    "3 blocks an SM": [("__launch_bounds__(PT_THREADS, 2)\nfwd_tc_kernel",
                        "__launch_bounds__(PT_THREADS, 3)\nfwd_tc_kernel")]}
STEM_KERNEL = re.compile(
    r"\b(fwd_tc|fwd_fold|fwdstats_tc|fwdstats_fold|fwdstats|colsum|apply)"
    r"_kernel\b")


def graph_ms(fn, iters=10):
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


def build_variant(name, patches):
    """The kernel library compiled from copies of the sources with
    csrc/phase_train.cu patched, loaded with the signatures of
    kernels/_build.py."""
    from sr_object_detection_tpu_torch.kernels import _build
    out = ROOT / "build" / "bf16_stem_ab" / re.sub(r"\W+", "_", name)
    out.mkdir(parents=True, exist_ok=True)
    srcs = []
    for src in _build._sources():
        text = src.read_text()
        if src.name == "phase_train.cu":
            for old, new in patches:
                if text.count(old) != 1:
                    raise RuntimeError(
                        f"{name}: {old!r} not once in phase_train.cu")
                text = text.replace(old, new)
        (out / src.name).write_text(text)
        srcs.append(out / src.name)
    nvcc = _build._nvcc()
    procs = [(src, subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-c", str(src), "-o",
         str(out / (src.stem + ".o"))], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)) for src in srcs]
    for src, proc in procs:
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {src.name} ({name}): {err}")
    lib_path = out / _build.LIB_NAME
    subprocess.run([nvcc, "-shared", "-o", str(lib_path),
                    *(str(out / (s.stem + ".o")) for s in srcs)], check=True)
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
    from sr_object_detection_tpu_torch.infer.engine import ThroughputEngine
    from sr_object_detection_tpu_torch.io.weights import init_params
    from sr_object_detection_tpu_torch.kernels import _build
    from sr_object_detection_tpu_torch.kernels import phase_train as PT
    from sr_object_detection_tpu_torch.models.zoo import tiny_yolo_voc

    disable_tf32()
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    def say(msg):
        print(f"{label} {msg} [{card}]", flush=True)

    spec = tiny_yolo_voc(width=NET, height=NET)
    params = init_params(spec, seed=0)
    rng = np.random.default_rng(7)
    for p in params:                     # randomized BN, as chip_smoke's
        if "rolling_mean" in p:
            n = len(p["rolling_mean"])
            p["rolling_mean"] = rng.normal(0, 0.2, n).astype(np.float32)
            p["rolling_variance"] = rng.uniform(0.5, 2, n).astype(np.float32)
            p["scales"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            p["biases"] = rng.normal(0, 0.2, n).astype(np.float32)
    eng = ThroughputEngine(spec, params, batch=BATCH, device=dev,
                           phase_stem=True)
    assert eng.phase_stem
    frames = torch.from_numpy(rng.integers(
        0, 256, (BATCH, NET, NET, 3), dtype=np.uint8)).to(dev)
    x = (frames.float() / 255.0).to(torch.bfloat16)
    fwd_pair = getattr(PT, "fwd_pair", None)

    def pair(v, w, b):
        if fwd_pair is not None:
            return fwd_pair(v, w, b)
        cout = w.shape[3]
        zero = torch.zeros(cout, device=dev)
        one = torch.ones(cout, device=dev)
        z, _, _ = PT.fwdstats(v, w, zero, one)
        return PT.apply(z, zero, one, one, b)

    links, v = [], x
    for ci in (0, 2, 4, 6):
        p = eng.params[ci]
        w = p["weights"].permute(2, 3, 1, 0).to(torch.bfloat16).contiguous()
        b = p["biases"].float().contiguous()
        links.append((eng.spec.layers[ci], v, w, b))
        v = pair(v, w, b)
    ref = eng._stem(x)
    assert torch.equal(ref, v)
    say(f"pair = {'fwd_pair' if fwd_pair else 'fwdstats + apply'}")

    def time_stem(tag):
        total = 0.0
        for l, xi, w, b in links:
            ms = min(graph_ms(lambda: pair(xi, w, b)) for _ in range(2))
            out_b = 2 * BATCH * (l.h // 2) * (l.w // 2) * l.filters
            n_bytes = 2 * xi.numel() + 2 * w.numel() + 4 * b.numel() + out_b
            n_ops = 2 * BATCH * l.h * l.w * l.filters * 9 * l.c
            bound = max(n_bytes / HBM_BYTES_S, n_ops / BF16_OPS_S) * 1e3
            total += ms
            say(f"bf16 stem pair {l.c}->{l.filters} @{l.h} B={BATCH}{tag}: "
                f"{ms} ms from a CUDA graph, bound {bound} ms "
                f"({ms / bound:.2f}x)")
        cm = min(graph_ms(lambda: eng._stem(x), 5) for _ in range(2))
        say(f"bf16 stem, 4 chained pairs{tag}: {cm} ms from a CUDA graph "
            f"(pairs alone {total} ms)")

    time_stem("")
    if variants:
        lib = _build.load()
        try:
            for name, patches in VARIANTS.items():
                _build._lib = build_variant(name, patches)
                same = torch.equal(eng._stem(x), ref)
                time_stem(f", {name} (output "
                          f"{'equal' if same else 'DIFFERS'})")
        finally:
            _build._lib = lib

    eng.warmup()
    rates = [eng.benchmark(iters=20, warmup=3)["images_per_sec"]
             for _ in range(2)]
    iters = 5
    batch_in = frames.float() / 255.0
    eng(batch_in)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            eng(batch_in)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / iters * 1e3
    rows = [(e.self_device_time_total / iters / 1e3, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(ms for ms, _ in rows)
    stem = sum(ms for ms, key in rows if STEM_KERNEL.search(key))
    say(f"ThroughputEngine bf16 + phase stem B={BATCH} @{NET}: "
        f"{max(rates)} images/s ({rates}); under the profiler wall {wall} "
        f"ms, device busy {busy} ms a batch (idle share {1 - busy / wall}), "
        f"the stem's kernels {stem} ms")
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    sys.exit(main(next((a for a in args if not a.startswith("--")), "this"),
                  "--variants" in args))
