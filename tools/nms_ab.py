"""Times the NMS kernel (kernel 1) in the checkout this file lies in, for
comparing two checkouts on one card.

    python3 tools/nms_ab.py LABEL [--variants]

Prints, with the card's name and power limit, for C=20 classes:
  * a frame's candidates as the batch-1 ``Detector`` makes them
    (chip_smoke.py phase 5: tiny-yolo-voc-416 f32, random weights from
    seed 0 with randomized BN and a head gain of 8, a random 480x640
    frame, the threshold at the 11th best box, k=128: few ranks live);
  * random boxes from a seed (chip_smoke.py phase 1's data) at k=128, 256,
    512 and 845 (every box of tiny-yolo-voc-416; many ranks live);
each the kernel's device time a call from a replay of 50 calls captured in
one CUDA graph (best of two), the same from CUDA events over 50 calls
queued back to back (there the host's launch cost sets the figure), and,
where the checkout has it (``kernels.nms.empty_launch``), the launch
floor: an empty kernel with the same grid, block and shared memory, from
a graph the same way. Each output is checked equal to
``nms_per_class_plain``.

With ``--variants`` (a checkout with the chunked kernel) it also builds
the kernel library under build/ from copies of the sources in which
csrc/nms.cu is patched, and times each the same way: the block at 256
and 1024 threads (the library's takes 512; outputs checked equal), three
probes whose outputs differ by design — no chunk at all, the prologue and
the output alone (1); no suppression of the ranks past a chunk (2); no
IoUs in the diagonal blocks (3).

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

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

THREADS = "#define SROD_NMS_THREADS 512"
# name -> [(text of csrc/nms.cu, its replacement)]
VARIANTS = {
    "256 threads": [(THREADS, "#define SROD_NMS_THREADS 256")],
    "1024 threads": [(THREADS, "#define SROD_NMS_THREADS 1024")],
    "probe 1 (prologue and output)": [
        ("const int n = n_live, nz = n_tail;",
         "const int n = 0 * n_live, nz = 0 * n_tail;")],
    "probe 2 (no later-rank suppression)": [("if (surv && end < nz) {",
                                             "if (false) {")],
    "probe 3 (no diagonal IoUs)": [
        ("if (r < n && p[r] > 0.0f && qin && lane > i)", "if (false)")],
}


def graph_ms(fn, iters=50):
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


def events_ms(fn, iters=50):
    for _ in range(5):
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


def build_variant(name, patches):
    """The kernel library compiled from copies of the sources with
    csrc/nms.cu patched, loaded with the signatures of kernels/_build.py."""
    from sr_object_detection_tpu_torch.kernels import _build
    out = ROOT / "build" / "nms_ab" / re.sub(r"\W+", "_", name)
    out.mkdir(parents=True, exist_ok=True)
    srcs = []
    for src in _build._sources():
        text = src.read_text()
        if src.name == "nms.cu":
            for old, new in patches:
                if text.count(old) != 1:
                    raise RuntimeError(f"{name}: {old!r} not once in nms.cu")
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


def frame_candidates(dev, k=128):
    """A frame's top-k candidates (C, k, 4), (C, k) as chip_smoke.py phase
    5's Detector makes them."""
    from sr_object_detection_tpu_torch.infer.detector import Detector
    from sr_object_detection_tpu_torch.io.weights import (init_params,
                                                          save_weights)
    from sr_object_detection_tpu_torch.models.zoo import tiny_yolo_voc
    from sr_object_detection_tpu_torch.ops import boxes as B

    spec = tiny_yolo_voc()
    params = init_params(spec, seed=0)
    rng = np.random.default_rng(1)       # randomized BN and biases
    for p in params:
        if "biases" in p:
            n = p["biases"].shape[0]
            p["biases"] = rng.normal(0, 0.2, n).astype(np.float32)
            if "scales" in p:
                p["scales"] = rng.uniform(0.6, 1.4, n).astype(np.float32)
                p["rolling_mean"] = rng.normal(0, 0.1, n).astype(np.float32)
                p["rolling_variance"] = rng.uniform(
                    0.6, 1.6, n).astype(np.float32)
    head = max(i for i, p in enumerate(params) if "weights" in p)
    params[head]["weights"] = np.asarray(params[head]["weights"],
                                         np.float32) * 8.0
    work = ROOT / "build" / "nms_ab"
    work.mkdir(parents=True, exist_ok=True)
    g = np.load(ROOT / "tests" / "golden" / "detect_tiny_yolo.npz")
    (work / "tiny-yolo-voc.cfg").write_text(bytes(g["cfg"]).decode())
    save_weights(spec, params, str(work / "random.weights"))
    det = Detector(str(work / "tiny-yolo-voc.cfg"),
                   str(work / "random.weights"), device=dev)
    frame = np.random.default_rng(0).uniform(
        0, 1, (480, 640, 3)).astype(np.float32)
    x = det.preprocess(frame)[None]
    _, p_all = det.predict_batch(x)
    thresh = float(p_all[0].max(-1).values.sort(descending=True).values[10])
    fb, fp = det.predict_batch(x, thresh=thresh)
    tb, tp, _ = B.topk_candidates(fb[0], fp[0], k)
    return tb, tp


def random_candidates(dev, k, seed=0):
    from sr_object_detection_tpu_torch.ops import boxes as B
    rng = np.random.default_rng(seed)
    n, c = 845, 20
    boxes = np.stack([rng.uniform(0, 1, n), rng.uniform(0, 1, n),
                      rng.uniform(.02, .4, n), rng.uniform(.02, .4, n)],
                     axis=1).astype(np.float32)
    boxes[100:110] = boxes[99]
    probs = rng.uniform(0, 1, (n, c)).astype(np.float32) ** 4
    probs[probs < 0.05] = 0
    probs[::7, 3] = probs[0, 3]
    probs[100:110, 5] = 0.5
    tb, tp, _ = B.topk_candidates(torch.from_numpy(boxes).to(dev),
                                  torch.from_numpy(probs).to(dev), k)
    return tb, tp


def main(label: str, variants: bool) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from sr_object_detection_tpu_torch.infer.detector import disable_tf32
    from sr_object_detection_tpu_torch.kernels import _build
    from sr_object_detection_tpu_torch.kernels import nms as NMS

    disable_tf32()
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    floor_fn = getattr(NMS, "empty_launch", None)
    cases = [("a frame's candidates", *frame_candidates(dev))]
    cases += [("random", *random_candidates(dev, k))
              for k in (128, 256, 512, 845)]

    def time_case(name, tb, tp, tag=""):
        c, k = tp.shape
        live = int((tp > 0).sum(dim=1).max())
        gm = min(graph_ms(lambda: NMS.nms_per_class(tb, tp, 0.4))
                 for _ in range(2))
        em = events_ms(lambda: NMS.nms_per_class(tb, tp, 0.4))
        floor = (min(graph_ms(lambda: floor_fn(c, k, dev)) for _ in range(2))
                 if floor_fn else None)
        print(f"{label} nms_per_class C={c} k={k}, {name} (largest class "
              f"{live} positive){tag}: {gm} ms from a CUDA graph, {em} ms "
              f"back to back; empty kernel on its launch shape from a "
              f"graph: {'not in this checkout' if floor is None else floor}"
              f" ms [{card}]", flush=True)

    refs = []
    for name, tb, tp in cases:
        got = NMS.nms_per_class(tb, tp, 0.4)
        assert torch.equal(got, NMS.nms_per_class_plain(tb, tp, 0.4)), name
        refs.append(got)
        time_case(name, tb, tp)
    if variants:
        lib = _build.load()
        try:
            for vname, patches in VARIANTS.items():
                _build._lib = build_variant(vname, patches)
                for (name, tb, tp), ref in zip(cases, refs):
                    same = torch.equal(NMS.nms_per_class(tb, tp, 0.4), ref)
                    time_case(name, tb, tp, f", {vname} (output "
                              f"{'equal' if same else 'differs'})")
        finally:
            _build._lib = lib
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    sys.exit(main(next((a for a in args if not a.startswith("--")), "this"),
                  "--variants" in args))
