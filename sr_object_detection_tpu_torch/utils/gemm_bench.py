"""GEMM micro-benchmark of the library's matmul (cuBLAS on the card) —
the analog of the reference's embedded `time_ongpu` GFLOPS timings
(src_yolo2/gemm.c:232-341, shapes from test_gpu_blas:330-338: darknet
conv-as-GEMM dimensions m x k x n).

Counterpart of ``sr_object_detection_tpu/utils/gemm_bench.py``. This
times ``torch.matmul``; it ports no kernel. ``reps`` matmuls are queued
back to back, each one's A operand taking a 1e-30 multiple of the last
product's first element (a data dependence through every product, as
the JAX tool's scan carries one). On CUDA the queue is captured once
into a CUDA graph and replayed, so the host's launch cost stays out of
small shapes; the host clock runs around one replay and one
synchronisation. float32 runs with TF32 off.
"""

from __future__ import annotations

import time

import numpy as np
import torch

# (TA, TB, m, k, n) — test_gpu_blas's live list (gemm.c:330-338)
DARKNET_SHAPES = [
    (0, 0, 64, 75, 12544),
    (0, 0, 64, 576, 12544),
    (0, 0, 256, 2304, 784),
    (1, 1, 2304, 256, 784),
    (0, 0, 512, 4608, 196),
    (1, 1, 4608, 512, 196),
]


def time_gemm(m: int, k: int, n: int, *, dtype=torch.bfloat16,
              ta: int = 0, tb: int = 0, reps: int = 200,
              device="cuda") -> dict:
    """GFLOPS for one (m,k)x(k,n) matmul shape (time_ongpu analog) on
    ``device``. Returns {m, k, n, ta, tb, sec (a matmul), gflops,
    flops (of one matmul)}."""
    device = torch.device(device)
    if device.type == "cuda":
        from ..infer.detector import disable_tf32
        disable_tf32()
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal(
        (k, m) if ta else (m, k)).astype(np.float32)).to(device, dtype)
    b = torch.from_numpy(rng.standard_normal(
        (n, k) if tb else (k, n)).astype(np.float32)).to(device, dtype)
    bb = b.t() if tb else b

    def rep():
        for _ in range(reps):
            c = torch.matmul(a.t() if ta else a, bb)
            # data-dependent feedback: the next product reads this one
            a.add_(c[0, 0], alpha=1e-30)
        return c

    rep()                               # warm (library handles, plans)
    if device.type == "cuda":
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            rep()
        graph.replay()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph.replay()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / reps
    else:
        t0 = time.perf_counter()
        rep()
        dt = (time.perf_counter() - t0) / reps
    flops = 2.0 * m * k * n
    return {"m": m, "k": k, "n": n, "ta": ta, "tb": tb,
            "sec": dt, "gflops": flops / dt / 1e9, "flops": flops}


def run_gemm_bench(shapes=None, *, dtype=torch.bfloat16, reps: int = 200,
                   device="cuda"):
    """Print the GFLOPS table (the `gemm` command)."""
    rows = []
    for ta, tb, m, k, n in (shapes or DARKNET_SHAPES):
        r = time_gemm(m, k, n, dtype=dtype, ta=ta, tb=tb, reps=reps,
                      device=device)
        rows.append(r)
        print(f"Matrix Multiplication {m}x{k} * {k}x{n}"
              f"{' (TA,TB)' if ta or tb else ''}: "
              f"{r['gflops']:.1f} GFLOP/s ({r['sec']*1e6:.1f} us/op)")
    return rows


__all__ = ["time_gemm", "run_gemm_bench", "DARKNET_SHAPES"]
