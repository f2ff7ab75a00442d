"""How far float32 rounding alone moves `nightmare`, and the card.

    python3 tools/nightmare_sensitivity.py

Runs the nightmare app's normalized gradient ascent (1 octave, 2
iterations, rate 0.05) on one seeded image, once as it is and once with
the input scaled by 1 + 1e-7 and by 1 + 1e-6 (changes at float32's
resolution), on two seeded nets: chip_smoke.py's tinyyolo-v1-448 (layer
10: six max-pools on the way) and its super-resolution net (layer 1:
convs only). Prints, per net and iteration, the two gradients' largest
difference over the mean |gradient| and the norm of their difference
over the gradient's norm, and for the image after 2 steps the 99th
percentile of the differences and how many values differ by more than
1e-4. Where there is a card, the card's first gradient is held against
the CPU's in the same two measures. Where the perturbed run moves many
values, a card-against-CPU comparison of that net's nightmare can only
be as close as this; chip_smoke.py's phase 51 holds tinyyolo-v1's first
gradient on the card to the CPU's at a limit set from the step-1
readings.
"""

from __future__ import annotations

import pathlib
import sys
import tempfile

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import chip_smoke as CS  # noqa: E402
from sr_object_detection_tpu_torch.apps.nightmare_app import (  # noqa: E402
    make_dream_step)
from sr_object_detection_tpu_torch.graph import spec as S  # noqa: E402
from sr_object_detection_tpu_torch.io.convert import params_to_torch  # noqa: E402
from sr_object_detection_tpu_torch.io.weights import init_params  # noqa: E402
from sr_object_detection_tpu_torch.ops.image import resize_image  # noqa: E402
from torch_parity import random_bn  # noqa: E402


def measures(g, ref):
    """(largest |g - ref| over the mean |ref|, |g - ref| over |ref|)."""
    d = (g - ref).abs()
    return (float(d.max() / ref.abs().mean()),
            float(torch.linalg.vector_norm(g - ref)
                  / torch.linalg.vector_norm(ref)))


def sensitivity(cfg_text, layer, head_gain, seed):
    with tempfile.TemporaryDirectory() as td:
        cfg = pathlib.Path(td) / "net.cfg"
        cfg.write_text(cfg_text)
        spec = S.parse_network_cfg(str(cfg))
    nparams = random_bn(init_params(spec, seed=seed), seed,
                        head_gain=head_gain)
    params = params_to_torch(spec, nparams, "cpu")
    rng = np.random.default_rng(seed)
    im = torch.from_numpy(rng.integers(0, 256, (375, 500, 3)).astype(
        np.float32) / 255)
    grad = make_dream_step(spec, layer)
    x0 = resize_image(im, spec.net.w, spec.net.h)[None]

    def run(scale):
        x = x0 * scale
        gs = []
        for _ in range(2):
            g = grad(params, x)
            gs.append(g)
            x = (x + 0.05 * g / (g.abs().mean() + 1e-8)).clamp(0, 1)
        return x.detach(), gs

    a, ga = run(1.0)
    for eps in (1e-7, 1e-6):
        b, gb = run(1.0 + eps)
        print(f"  input scaled by 1 + {eps:g}:")
        for i, (p, q) in enumerate(zip(ga, gb)):
            most, norm = measures(q, p)
            print(f"    step {i + 1}: gradient difference up to {most:.3e} "
                  f"of the mean |gradient|, norm {norm:.3e} of its norm")
        diff = (a - b).abs().numpy()
        print(f"    after 2 steps: 99th percentile "
              f"{np.quantile(diff, 0.99):.3e}, {int((diff > 1e-4).sum())} of "
              f"{diff.size} values beyond 1e-4")
    if torch.cuda.is_available():
        from sr_object_detection_tpu_torch.infer.detector import disable_tf32
        disable_tf32()
        g = make_dream_step(spec, layer)(
            params_to_torch(spec, nparams, "cuda"), x0.cuda()).cpu()
        most, norm = measures(g, ga[0])
        print(f"  the card's step-1 gradient against the CPU's: up to "
              f"{most:.3e} of the mean |gradient|, norm {norm:.3e}")


def main() -> int:
    torch.manual_seed(0)
    print(f"tinyyolo-v1-{CS.V1}, layer 10:")
    sensitivity(CS.v1_cfg_text(20, 1), 10, CS.V1_HEAD_GAIN, 50)
    print("the super-resolution net, layer 1:")
    sensitivity(CS.SUPER_CFG, 1, 1.0, 51)
    return 0


if __name__ == "__main__":
    sys.exit(main())
