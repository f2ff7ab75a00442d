"""How far float32 rounding alone moves char_rnn training, on the CPU.

    python3 tools/rnn_train_noise.py [--lr 0.1 0.001 0.0001] [--hidden 1024]

Trains the zoo's char_rnn (3 BN rnn layers, connected 256, softmax, sse
cost) at ``--hidden``, 32 streams x 32 time steps, 3 steps from one
seeded set of weights on a seeded text, once with torch on 8 threads and
once on 1 (the same float32 arithmetic summed in other orders), and
prints for each learning rate the largest difference of the two runs'
parameters over each tensor's largest value, and how far training moved
the weights from their initial values (the same ratio). chip_smoke.py's
phase 49 gates the card against the CPU at 1e-4 and trains at a learning
rate where this floor lies well under it.
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

from sr_object_detection_tpu_torch.apps.rnn_app import CharStream  # noqa: E402
from sr_object_detection_tpu_torch.config import parse_cfg_text  # noqa: E402
from sr_object_detection_tpu_torch.graph import spec as S  # noqa: E402
from sr_object_detection_tpu_torch.io.convert import (  # noqa: E402
    flat, params_to_numpy)
from sr_object_detection_tpu_torch.io.weights import init_params  # noqa: E402
from sr_object_detection_tpu_torch.models.zoo import char_rnn  # noqa: E402
from sr_object_detection_tpu_torch.train.trainer import Trainer  # noqa: E402
from torch_parity import random_bn_nested, zoo_cfg_text  # noqa: E402


def run(spec, params, text, threads):
    torch.set_num_threads(threads)
    stream = CharStream(text, 32, 32, seed=48)
    tr = Trainer(spec, params=params, device="cpu")
    for _ in range(3):
        tr.step(*stream.next_batch())
    return params_to_numpy(spec, tr.state.params)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lr", type=float, nargs="+", default=[0.1, 0.001, 1e-4])
    ap.add_argument("--hidden", type=int, default=1024)
    args = ap.parse_args()
    rng = np.random.default_rng(48)
    text = b" ".join(bytes(rng.integers(97, 123, int(n)))
                     for n in rng.integers(2, 9, 4000))
    for lr in args.lr:
        cfg = zoo_cfg_text(char_rnn, hidden=args.hidden, batch=32,
                           time_steps=32).replace("learning_rate=0.1",
                                                  f"learning_rate={lr}")
        spec = S.build_network_spec(parse_cfg_text(cfg))
        params = random_bn_nested(init_params(spec, seed=48), 48)
        a, b = (run(spec, params, text, t) for t in (8, 1))
        diff = moved = 0.0
        for i, p0 in enumerate(params):
            got = flat(a[i])
            for name, want in flat(b[i]).items():
                scale = max(float(np.abs(want).max()), 1e-30)
                diff = max(diff, float(np.abs(got[name] - want).max()) / scale)
                init = flat(p0)[name]
                moved = max(moved, float(np.abs(want - init).max()) / scale)
        print(f"lr {lr}: 8 against 1 thread {diff:.3e} of a tensor's largest "
              f"value; training moved the weights {moved:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
