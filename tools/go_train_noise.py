"""How far float32 rounding alone moves go-19 training, and the card.

    python3 tools/go_train_noise.py [--lr 0.1 0.01 0.001] [--steps 1 2]
        [--no-cudnn]

Trains chip_smoke.py's go-19 (tests/torch_parity.go19_cfg_text at
full width, seeded weights: phase 52's) at a constant rate for 1 and 2
steps of 16 boards drawn as `go train` draws them, each time from the
same weights: with
torch on its default threads and on 1 on the CPU, and on the card where
there is one (TF32 off; with --no-cudnn also with cuDNN switched off, so
the card's convs run PyTorch's own kernels), and on the CPU in float64
(``torch_parity.train_float64``: float64 throughout but for the loss's
delta, which the trainer takes in float32). For each learning rate and
step count it prints each float32 run's difference from the
default-thread CPU run and from the float64 run, for the three tensors
where it is largest:
the norm of the difference over the norm of the update (after -
before), the measure chip_smoke.py's phase 52 holds at GO_UPDATE_TOL
after 1 step and at GO_UPDATE_TOL_2 after 2.
The BN biases' gradients sum over 5,776 positions a channel with heavy
cancellation, so float32 lands ~1e-2 of their update from float64
whichever way it orders the sums.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import tempfile

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from sr_object_detection_tpu_torch.apps import go_app as G  # noqa: E402
from sr_object_detection_tpu_torch.config import parse_cfg_text  # noqa: E402
from sr_object_detection_tpu_torch.graph import spec as S  # noqa: E402
from sr_object_detection_tpu_torch.io.convert import params_to_torch  # noqa: E402
from sr_object_detection_tpu_torch.io.weights import init_params  # noqa: E402
from sr_object_detection_tpu_torch.train.trainer import Trainer  # noqa: E402
from torch_parity import (go19_cfg_text, random_bn, train_float64,  # noqa: E402
                          write_go_moves)

BOARDS = 16


def run(spec, params, batches, device, threads):
    torch.set_num_threads(threads)
    tr = Trainer(spec, params=params, device=device)
    for x, t in batches:
        tr.step(x, t)
    return [{k: v.cpu() for k, v in p.items()} for p in tr.state.params]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lr", type=float, nargs="+", default=[0.1, 0.01, 0.001])
    ap.add_argument("--steps", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--no-cudnn", action="store_true")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as d:
        moves = G.load_go_moves(write_go_moves(pathlib.Path(d) / "go.train",
                                               1024, 52))
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(max(args.steps)):
        b, l = G.random_go_moves(moves, rng, BOARDS)
        batches.append((b.reshape(BOARDS, 19, 19, 1), l.reshape(BOARDS, 361)))
    threads = torch.get_num_threads()
    runs = [("1 thread", "cpu", 1, True)]
    if torch.cuda.is_available():
        from sr_object_detection_tpu_torch.infer.detector import disable_tf32
        disable_tf32()
        runs.append(("card", "cuda", threads, True))
        if args.no_cudnn:
            runs.append(("card, cuDNN off", "cuda", threads, False))
    for lr in args.lr:
        spec = S.build_network_spec(parse_cfg_text(go19_cfg_text(
            batch=BOARDS, learning_rate=lr, policy="constant")))
        params = random_bn(init_params(spec, seed=52), 52)
        init = params_to_torch(spec, params, "cpu")
        head = max(i for i, l in enumerate(spec.layers)
                   if isinstance(l, S.ConvSpec))
        for steps in args.steps:
            torch.set_num_threads(threads)
            f64 = train_float64(spec, params, batches[:steps])[-1]
            refs = {f"{threads} threads": run(spec, params, batches[:steps],
                                              "cpu", threads),
                    "float64": f64}
            got = {f"{threads} threads": refs[f"{threads} threads"]}
            for name, device, n, cudnn in runs:
                torch.backends.cudnn.enabled = cudnn
                got[name] = run(spec, params, batches[:steps], device, n)
                torch.backends.cudnn.enabled = True
            for rname, ref in refs.items():
                for name, res in got.items():
                    if name == rname:
                        continue
                    of_norm = {}
                    for i, p in enumerate(f64):
                        for k, want in p.items():
                            step = torch.linalg.vector_norm(
                                want - init[i][k].double())
                            # the head's bias: its gradient is 1 - 1 a
                            # board, zero up to rounding
                            if (i, k) != (head, "biases"):
                                of_norm[f"{i}.{k}"] = float(
                                    torch.linalg.vector_norm(
                                        res[i][k].double()
                                        - ref[i][k].double()) / step)
                    worst = sorted(of_norm, key=of_norm.get,
                                   reverse=True)[:3]
                    print(f"lr {lr}, {steps} step(s), {name} against "
                          f"{rname}, difference over the update's norm: "
                          + ", ".join(f"{w} {of_norm[w]:.3e}"
                                      for w in worst), flush=True)
    torch.set_num_threads(threads)
    return 0


if __name__ == "__main__":
    sys.exit(main())
