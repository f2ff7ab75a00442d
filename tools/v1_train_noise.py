"""How far float32 rounding alone moves YOLOv1 training, and the card.

    python3 tools/v1_train_noise.py [--lr 1e-5 1e-4 1e-3]

Trains chip_smoke.py's tinyyolo-v1-448 (seeded weights, the head
unscaled) 2 steps of B=2 on seeded images and grid truths, each time
from the same weights: with torch on its default threads and on 1 on
the CPU, and on the card where there is one (TF32 off). For each learning rate it
prints, over the tensors: how far training moved each (the largest
|after - before| over the tensor's largest |value|, smallest and
largest), and the 1-thread run's and the card's difference from the
default-thread run, its largest |value| over the tensor's largest
|value| and over its largest |update|, and its norm over the update's
norm, with the tensor where each is worst. chip_smoke.py's
phase 50 holds the card's update to the CPU's at a limit set from these.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import chip_smoke as CS  # noqa: E402
from sr_object_detection_tpu_torch.apps.misc_apps import (  # noqa: E402
    fill_truth_region_np)
from sr_object_detection_tpu_torch.config import parse_cfg_text  # noqa: E402
from sr_object_detection_tpu_torch.graph import spec as S  # noqa: E402
from sr_object_detection_tpu_torch.io.convert import params_to_torch  # noqa: E402
from sr_object_detection_tpu_torch.io.weights import init_params  # noqa: E402
from sr_object_detection_tpu_torch.train.trainer import Trainer  # noqa: E402
from torch_parity import random_bn  # noqa: E402


def run(spec, params, batches, device, threads):
    torch.set_num_threads(threads)
    tr = Trainer(spec, params=params, device=device)
    for x, t in batches:
        tr.step(x, t)
    return [{k: v.cpu() for k, v in p.items()} for p in tr.state.params]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lr", type=float, nargs="+", default=[1e-5, 1e-4, 1e-3])
    args = ap.parse_args()
    rng = np.random.default_rng(50)
    batches = [(rng.uniform(0, 1, (2, CS.V1, CS.V1, 3)).astype(np.float32),
                np.stack([fill_truth_region_np(np.asarray(
                    [[c, *rng.uniform(.2, .8, 2), *rng.uniform(.1, .4, 2)]
                     for c in rng.integers(0, 20, 3)]), CS.V1_SIDE, 20)
                    for _ in range(2)])) for _ in range(2)]
    runs = [("1 thread", "cpu", 1)]
    if torch.cuda.is_available():
        from sr_object_detection_tpu_torch.infer.detector import disable_tf32
        disable_tf32()
        runs.append(("card", "cuda", torch.get_num_threads()))
    threads = torch.get_num_threads()
    for lr in args.lr:
        spec = S.build_network_spec(parse_cfg_text(
            CS.v1_cfg_text(20, 2, learning_rate=lr)))
        params = random_bn(init_params(spec, seed=50), 50)
        init = params_to_torch(spec, params, "cpu")
        ref = run(spec, params, batches, "cpu", threads)
        moved = {}
        for i, p in enumerate(ref):
            for k, want in p.items():
                moved[i, k] = float((want - init[i][k]).abs().max()
                                    / want.abs().max())
        lo, hi = min(moved, key=moved.get), max(moved, key=moved.get)
        print(f"lr {lr}: moved {moved[lo]:.3e} ({lo}) ... {moved[hi]:.3e} "
              f"({hi}) of a tensor's largest value")
        for name, device, n in runs:
            got = run(spec, params, batches, device, n)
            of_value, of_update, of_norm = {}, {}, {}
            for i, p in enumerate(ref):
                for k, want in p.items():
                    step = want - init[i][k]
                    d = got[i][k] - want
                    of_value[i, k] = float(d.abs().max() / want.abs().max())
                    of_update[i, k] = float(d.abs().max() / step.abs().max())
                    of_norm[i, k] = float(torch.linalg.vector_norm(d)
                                          / torch.linalg.vector_norm(step))
            for what, m in (("of the largest value", of_value),
                            ("of the largest update", of_update),
                            ("of the update's norm (in norm)", of_norm)):
                w = max(m, key=m.get)
                print(f"  {name} against {threads} threads: {m[w]:.3e} "
                      f"{what} ({w})")
    torch.set_num_threads(threads)
    return 0


if __name__ == "__main__":
    sys.exit(main())
