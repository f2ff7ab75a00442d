"""CIFAR-10 application (src_yolo2/cifar.c:1-277).

Counterpart of ``sr_object_detection_tpu/apps/cifar_app.py``:

  cifar train <cfg> [weights] -data <dir with data_batch_*.bin> [-backup d]
  cifar distill <cfg> [weights] -data <dir> -csv <soft targets>
  cifar test|multi|csv|csvtrain <cfg> <weights> -data <dir>
  cifar eval -data <dir> -csv <predictions>
  cifar extract -data <dir> [-out d]

Training runs the float32 ``Trainer`` on the cost head, the forward
modes a float32 ``Network``, both on ``device`` (CUDA unless the CLI's
-cpu; TF32 off there). The batches, the draws from the fixed seed and
the printed lines are the JAX module's.
"""

from __future__ import annotations

import glob
import os
import sys

import numpy as np
import torch

from ..data.loader import load_cifar10_batch
from ..graph.spec import parse_network_cfg
from ..io import checkpoint as ckpt
from ..io.weights import load_weights
from .cli import find_value

CIFAR_LABELS = ("airplane", "automobile", "bird", "cat", "deer",
                "dog", "frog", "horse", "ship", "truck")


def load_cifar_dir(data_dir: str, train: bool = True):
    """(x NHWC float32, one-hot y) of the training batches
    (data_batch_*.bin, sorted) or of test_batch.bin."""
    if train:
        files = sorted(glob.glob(os.path.join(data_dir, "data_batch_*.bin")))
    else:
        files = [os.path.join(data_dir, "test_batch.bin")]
    xs, ys = [], []
    for f in files:
        x, y = load_cifar10_batch(f)
        xs.append(x)
        ys.append(y)
    return np.concatenate(xs), np.concatenate(ys)


def _float32(device):
    if torch.device(device).type == "cuda":
        from ..infer.detector import disable_tf32
        disable_tf32()


def _train(cfg, weights, argv, device, soft=None):
    """The shared loop of train_cifar and train_cifar_distill: random
    batches from a seed-0 numpy generator, ``<cfg>.backup`` every 500
    iterations (train only) and ``<cfg>.weights`` at the end in -backup.
    ``soft`` blends the truth: 0.9 * soft + 0.1 * one-hot. Returns
    (trainer, per-iteration losses)."""
    from ..train.trainer import Trainer
    _float32(device)
    data_dir = find_value(argv, "-data", "data/cifar")
    spec = parse_network_cfg(cfg)
    params = None
    if weights:
        params, _ = load_weights(spec, weights)
    trainer = Trainer(spec, params=params, device=device)
    x_all, y_all = load_cifar_dir(data_dir, train=True)
    if soft is not None:
        w = 0.9
        y_all = w * soft[:len(y_all)] + (1. - w) * y_all
    outer = trainer.outer_batch
    rng = np.random.default_rng(0)
    max_batches = spec.net.max_batches or 5000
    avg = None
    backup = find_value(argv, "-backup", "backup")
    os.makedirs(backup, exist_ok=True)
    base = os.path.splitext(os.path.basename(cfg))[0]
    losses = []
    while True:
        i = int(trainer.state.seen) // outer + 1
        if i > max_batches:
            break
        idx = rng.integers(0, len(x_all), outer)
        m = trainer.step(x_all[idx], y_all[idx])
        loss = float(m["loss"]) / outer
        losses.append(loss)
        avg = loss if avg is None else avg * .95 + loss * .05
        if i % 20 == 0:
            print(f"{i}: loss {loss:.5f} avg {avg:.5f} "
                  f"lr {float(m['lr']):.5f}")
        if soft is None and i % 500 == 0:
            ckpt.export_weights(os.path.join(backup, f"{base}.backup"),
                                spec, trainer.state)
    ckpt.export_weights(os.path.join(backup, f"{base}.weights"),
                        spec, trainer.state)
    return trainer, losses


def train_cifar(cfg: str, weights, argv, *, device="cuda"):
    """train_cifar (cifar.c:8-57)."""
    return _train(cfg, weights, argv, device)[0]


def train_cifar_distill(cfg: str, weights, argv, *, device="cuda"):
    """train_cifar_distill (cifar.c:59-113): soft-target training, truth
    = .9 * ensemble CSV + .1 * one-hot. Returns the losses."""
    csv = find_value(argv, "-csv", "results/ensemble.csv")
    soft = np.loadtxt(csv, delimiter=",", ndmin=2).astype(np.float32)
    return _train(cfg, weights, argv, device, soft=soft)[1]


def _batched_forward(cfg: str, weights, device):
    """The float32 Network of ``cfg`` on ``device`` (seeded weights
    without ``weights``)."""
    from ..graph.compiler import Network
    from ..io.convert import params_to_torch
    from ..io.weights import init_params
    _float32(device)
    spec = parse_network_cfg(cfg)
    params = load_weights(spec, weights)[0] if weights else \
        init_params(spec)
    return Network(spec, params_to_torch(spec, params, device))


def _predict_all(net, x_all, bs=500):
    """The network's flat outputs over ``x_all`` in batches of ``bs``."""
    dev = next(net.buffers()).device
    outs = []
    with torch.no_grad():
        for i in range(0, len(x_all), bs):
            x = torch.from_numpy(np.ascontiguousarray(x_all[i:i + bs]))
            out, _ = net(x.to(dev))
            outs.append(out.reshape(out.shape[0], -1).float().cpu().numpy())
    return np.concatenate(outs).reshape(len(x_all), -1)


def test_cifar(cfg: str, weights: str, argv, *, device="cuda"):
    """test_cifar (cifar.c:148-167): top-1 over test_batch.bin."""
    data_dir = find_value(argv, "-data", "data/cifar")
    net = _batched_forward(cfg, weights, device)
    x_all, y_all = load_cifar_dir(data_dir, train=False)
    out = _predict_all(net, x_all)
    correct = int((out.argmax(1) == y_all.argmax(1)).sum())
    acc = correct / len(x_all)
    print(f"top-1 accuracy: {acc:.4f} ({correct}/{len(x_all)})")
    return acc


def test_cifar_multi(cfg: str, weights: str, argv, *, device="cuda"):
    """test_cifar_multi (cifar.c:115-146): image + horizontal-flip
    prediction sum, both orientations in batches."""
    data_dir = find_value(argv, "-data", "data/cifar")
    net = _batched_forward(cfg, weights, device)
    x_all, y_all = load_cifar_dir(data_dir, train=False)
    pred = _predict_all(net, x_all) + _predict_all(net, x_all[:, :, ::-1, :])
    hit = (pred.argmax(1) == y_all.argmax(1))
    running = np.cumsum(hit) / np.arange(1, len(hit) + 1)
    for i in range(0, len(hit), max(len(hit) // 10, 1)):
        print(f"{i:4d}: {100. * running[i]:.2f}%")
    acc = float(running[-1])
    print(f"multi top-1: {acc:.4f}")
    return acc


def _csv_ensemble(cfg, weights, argv, *, train: bool, device):
    """test_cifar_csv/csvtrain (cifar.c:191-244): predict, predict the
    flipped set, average — then, bug-for-bug with the reference, write
    and score ``pred`` (the half-scaled unflipped matrix): the C code
    calls matrix_add_matrix(pred, pred2), which accumulates into pred2,
    and prints pred, so the flip ensemble is computed and discarded."""
    data_dir = find_value(argv, "-data", "data/cifar")
    net = _batched_forward(cfg, weights, device)
    x_all, y_all = load_cifar_dir(data_dir, train=train)
    pred = _predict_all(net, x_all) * .5
    pred2 = _predict_all(net, x_all[:, :, ::-1, :]) * .5
    pred2 = pred2 + pred    # the ensemble lives in pred2, unused (quirk)
    for row in pred:
        print(",".join(f"{v:.17g}" for v in row))
    acc = float((pred.argmax(1) == y_all.argmax(1)).mean())
    print(f"Accuracy: {acc:f}", file=sys.stderr)
    return acc


def test_cifar_csv(cfg, weights, argv, *, device="cuda"):
    return _csv_ensemble(cfg, weights, argv, train=False, device=device)


def test_cifar_csvtrain(cfg, weights, argv, *, device="cuda"):
    return _csv_ensemble(cfg, weights, argv, train=True, device=device)


def eval_cifar_csv(argv):
    """eval_cifar_csv (cifar.c:246-257): score a saved prediction CSV
    (e.g. an ensemble average) against the test labels."""
    data_dir = find_value(argv, "-data", "data/cifar")
    csv = find_value(argv, "-csv", "results/combined.csv")
    _, y_all = load_cifar_dir(data_dir, train=False)
    pred = np.loadtxt(csv, delimiter=",", ndmin=2)
    print(f"{pred.shape[0]} {pred.shape[1]}", file=sys.stderr)
    acc = float((pred.argmax(1) == y_all[:len(pred)].argmax(1)).mean())
    print(f"Accuracy: {acc:f}", file=sys.stderr)
    return acc


def extract_cifar(argv):
    """extract_cifar (cifar.c:169-189): dump the train and test batches
    as image files named <index>_<label> (ppm here, png in the
    reference)."""
    from .nightmare_app import _save_ppm
    data_dir = find_value(argv, "-data", "data/cifar")
    out_dir = find_value(argv, "-out", data_dir)
    written = []
    for split, train in (("train", True), ("test", False)):
        x_all, y_all = load_cifar_dir(data_dir, train=train)
        d = os.path.join(out_dir, split)
        os.makedirs(d, exist_ok=True)
        for i, (x, y) in enumerate(zip(x_all, y_all)):
            name = os.path.join(
                d, f"{i}_{CIFAR_LABELS[int(y.argmax())]}.ppm")
            _save_ppm(name, x)
            written.append(name)
    print(f"extracted {len(written)} images -> {out_dir}")
    return written


def run_cifar(argv, *, device="cuda"):
    sub = argv.pop(0)
    if sub == "extract":
        return extract_cifar(argv)
    if sub == "eval":
        return eval_cifar_csv(argv)
    fn = {"train": train_cifar, "distill": train_cifar_distill,
          "test": test_cifar, "multi": test_cifar_multi,
          "csv": test_cifar_csv, "csvtrain": test_cifar_csvtrain}.get(sub)
    if fn is None:
        raise SystemExit(f"unknown cifar subcommand {sub}")
    cfg = argv.pop(0)
    weights = argv.pop(0) if argv and not argv[0].startswith("-") \
        else None
    return fn(cfg, weights, argv, device=device)


__all__ = ["run_cifar", "train_cifar", "test_cifar", "load_cifar_dir",
           "test_cifar_multi", "test_cifar_csv", "test_cifar_csvtrain",
           "eval_cifar_csv", "extract_cifar", "train_cifar_distill",
           "CIFAR_LABELS"]
