"""Training loops for the small reference apps: captcha, tag, writing,
compare, vid-rnn, dice, super/voxel (src_yolo2/captcha.c:29, tag.c:9,
writing.c:9, compare.c:10, rnn_vid.c:80, dice.c:7, super.c:10,
voxel.c:51), and captcha's test / valid modes.

Counterpart of ``sr_object_detection_tpu/apps/misc_train.py``. All the
reference loops share one skeleton — threaded batch load,
train_network, 0.9/0.1 rolling loss, cadence checkpoints — so one
``_train_loop`` drives per-app batch functions; each loop is the float32
``Trainer`` on ``device`` (CUDA unless the CLI's -cpu). The per-app
pieces are the DATA semantics, cited on each, and they are numpy
on the host, copied as they are from the JAX module:

  * captcha: paired label slots with SECRET_NUM masking
    (fix_data_captcha, captcha.c:5-27);
  * tag: multi-hot tags from per-image label files via the
    imgs->labels / _iconl.jpeg->.txt path chain (load_tags_paths,
    data.c:446-471);
  * writing: pixel-wise targets — grayscale "-label.png" images at the
    network's output resolution (load_data_writing, data.c:800-813);
  * compare: 6-channel image pairs with win/lose/masked pair labels
    (load_data_compare, data.c:547-609);
  * vid-rnn: feature-space next-step prediction — an extractor net
    embeds (steps+1) consecutive frames and the RNN learns
    feats[t] -> feats[t+1] (get_rnn_vid_data, rnn_vid.c:24-78). Videos
    are frame DIRECTORIES here (no OpenCV decode).

Each batch function draws from ``np.random.default_rng(0)`` as the JAX loop
does, so both packages train on the same batches.
"""

from __future__ import annotations

import glob
import os
import time

import numpy as np
import torch

from ..graph.spec import parse_network_cfg
from ..io.weights import load_weights
from ..io import checkpoint as ckpt
from .cli import find_value, find_arg

SECRET_NUM = -1234.0


def _read_list(path: str) -> list[str]:
    with open(path) as f:
        return [l.strip() for l in f if l.strip()]


def _find_replace_path(path: str, pairs) -> str:
    for old, new in pairs:
        path = path.replace(old, new)
    return path


def _make_trainer(cfg: str, weights, argv, device, spec=None):
    """(spec, float32 Trainer on ``device``); the weights' seen count
    carries over unless -clear. ``spec`` overrides the parsed cfg."""
    from ..train.trainer import Trainer
    spec = spec or parse_network_cfg(cfg)
    params = None
    seen = 0
    if weights:
        params, seen = load_weights(spec, weights)
    if torch.device(device).type == "cuda":
        from ..infer.detector import disable_tf32
        disable_tf32()
    trainer = Trainer(spec, params=params, device=device)
    if weights and not find_arg(argv, "-clear"):
        trainer.state.seen = torch.tensor(int(seen), dtype=torch.int64)
    return spec, trainer


def _train_loop(spec, trainer, next_batch, argv, cfg, *,
                max_batches=None, log_every: int = 1):
    """The shared loop skeleton (captcha.c:70-95 et al.): returns the
    per-batch loss list."""
    backup = find_value(argv, "-backup", "backup")
    os.makedirs(backup, exist_ok=True)
    base = os.path.splitext(os.path.basename(cfg))[0]
    outer = trainer.outer_batch
    limit = max_batches if max_batches is not None \
        else (spec.net.max_batches or 0)
    avg = None
    losses = []
    while True:
        i = int(trainer.state.seen) // outer + 1
        if limit and i > limit:
            break
        t0 = time.time()
        x, y = next_batch(outer)
        m = trainer.step(x, y)
        loss = float(m["loss"]) / outer
        losses.append(loss)
        avg = loss if avg is None else avg * .9 + loss * .1
        if i % log_every == 0:
            print(f"{i}: {loss:f}, {avg:f} avg, {float(m['lr']):f} "
                  f"rate, {time.time()-t0:.3f} seconds, "
                  f"{int(trainer.state.seen)} images")
        if i % 100 == 0:
            ckpt.export_weights(os.path.join(backup, f"{base}.backup"),
                                spec, trainer.state)
    ckpt.export_weights(os.path.join(backup, f"{base}.weights"),
                        spec, trainer.state)
    return losses


def _load_resized(path: str, w: int, h: int) -> np.ndarray:
    from ..ops.image import load_image_rgb, resize_image_np
    return resize_image_np(load_image_rgb(path), w, h)


def _network(cfg: str, weights, device):
    """(spec, predict): ``misc_apps._load``'s float32 forward on
    ``device``, its output flattened to (B, -1)."""
    from .misc_apps import _load
    spec, _, predict = _load(cfg, weights, device)
    return spec, lambda x: predict(x).reshape(len(x), -1)


# ---------------------------------------------------------------------
# captcha
# ---------------------------------------------------------------------

def fix_data_captcha(y: np.ndarray, mask: bool) -> np.ndarray:
    """fix_data_captcha (captcha.c:5-27): labels come in (present,
    absent) slot pairs. mask (the 'solved' list): unlabeled pairs are
    SECRET_NUM-masked out of the loss; both-hot pairs keep only the
    'absent' slot. Unmasked mode derives the complement slot."""
    y = y.copy()
    for j in range(0, y.shape[1] - 1, 2):
        a, b = y[:, j], y[:, j + 1]
        if mask:
            off = a == 0
            y[off, j] = SECRET_NUM
            y[off, j + 1] = SECRET_NUM
            both = (a != 0) & (b != 0) & ~off
            y[both, j] = 0
        else:
            y[:, j + 1] = np.where(a != 0, 0.0, 1.0)
    return y


def train_captcha(cfg: str, weights, argv, *, device="cuda"):
    """train_captcha (captcha.c:29-95): classification batches over the
    solved list with the captcha label fixup."""
    from ..data.loader import ClassificationLoader
    argv = list(argv)
    list_path = find_value(argv, "-list", "reimgs.solved.list")
    labels_path = find_value(argv, "-labels", "reimgs.labels.list")
    solved = not find_arg(argv, "-raw")
    from ..config import read_names
    labels = read_names(labels_path)
    spec, trainer = _make_trainer(cfg, weights, argv, device)
    loader = ClassificationLoader(list_path, labels, w=spec.net.w,
                                  h=spec.net.h,
                                  batch=trainer.outer_batch,
                                  augment=False, device=device)

    def next_batch(n):
        x, y = loader.next_batch()
        return x, fix_data_captcha(y, solved)

    try:
        return _train_loop(spec, trainer, next_batch, argv, cfg)
    finally:
        loader.close()


# ---------------------------------------------------------------------
# tag
# ---------------------------------------------------------------------

def load_tags(path: str, k: int) -> np.ndarray:
    """load_tags_paths (data.c:446-471): label file path derived via
    imgs->labels, _iconl.jpeg->.txt (labels2 fallback); file holds int
    tag ids, one-hot ORed into a k-vector."""
    y = np.zeros(k, np.float32)
    label = _find_replace_path(path, [("imgs", "labels"),
                                      ("_iconl.jpeg", ".txt")])
    if not os.path.exists(label):
        label = label.replace("labels", "labels2")
        if not os.path.exists(label):
            return y
    with open(label) as f:
        for tok in f.read().split():
            try:
                tag = int(tok)
            except ValueError:
                continue
            if 0 <= tag < k:
                y[tag] = 1.0
    return y


def train_tag(cfg: str, weights, argv, *, device="cuda"):
    """train_tag (tag.c:9-92): augmented images + multi-hot tag
    vectors sized to the network output."""
    argv = list(argv)
    list_path = find_value(argv, "-list", "tag/train.list")
    spec, trainer = _make_trainer(cfg, weights, argv, device)
    k = spec.layers[-1].outputs
    paths = _read_list(list_path)
    rng = np.random.default_rng(0)

    def next_batch(n):
        picks = [paths[rng.integers(0, len(paths))] for _ in range(n)]
        x = np.stack([_load_resized(p, spec.net.w, spec.net.h)
                      for p in picks])
        y = np.stack([load_tags(p, k) for p in picks])
        return x, y

    return _train_loop(spec, trainer, next_batch, argv, cfg)


# ---------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------

def _load_gray(path: str, w: int, h: int) -> np.ndarray:
    """load_image_paths_gray analog: luma of the RGB load."""
    im = _load_resized(path, w, h)
    return (0.299 * im[..., 0] + 0.587 * im[..., 1]
            + 0.114 * im[..., 2]).astype(np.float32)


def train_writing(cfg: str, weights, argv, *, device="cuda"):
    """train_writing (writing.c:9-103): input images vs grayscale
    '-label.png' targets at the network's output resolution
    (load_data_writing, data.c:800-813)."""
    argv = list(argv)
    list_path = find_value(argv, "-list", "figures.list")
    spec, trainer = _make_trainer(cfg, weights, argv, device)
    head = spec.layers[-1]
    # output image dims (get_network_image): last spatial layer
    out_w, out_h = head.out_w, head.out_h
    for l in reversed(spec.layers):
        if l.out_w and l.out_h:
            out_w, out_h = l.out_w, l.out_h
            break
    paths = _read_list(list_path)
    rng = np.random.default_rng(0)

    def next_batch(n):
        picks = [paths[rng.integers(0, len(paths))] for _ in range(n)]
        x = np.stack([_load_resized(p, spec.net.w, spec.net.h)
                      for p in picks])
        y = np.stack([
            _load_gray(_find_replace_path(p, [(".png", "-label.png")]),
                       out_w, out_h).reshape(-1)
            for p in picks])
        return x, y

    return _train_loop(spec, trainer, next_batch, argv, cfg)


# ---------------------------------------------------------------------
# compare
# ---------------------------------------------------------------------

def load_compare_labels(path_a: str, path_b: str, classes: int
                        ) -> np.ndarray:
    """Pairwise labels (load_data_compare, data.c:570-601): per class
    2 slots (a-wins, b-wins); ties/unknowns are SECRET_NUM-masked."""
    y = np.zeros(2 * classes, np.float32)
    for slot, p in ((0, path_a), (1, path_b)):
        label = _find_replace_path(p, [("imgs", "labels"),
                                       ("jpg", "txt")])
        if os.path.exists(label):
            with open(label) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) >= 2:
                        cid, iou = int(parts[0]), float(parts[1])
                        if 0 <= cid < classes:
                            y[2 * cid + slot] = max(y[2 * cid + slot],
                                                    iou)
    for j in range(classes):
        a, b = y[2 * j], y[2 * j + 1]
        if a > .5 and b < .5:
            y[2 * j], y[2 * j + 1] = 1.0, 0.0
        elif a < .5 and b > .5:
            y[2 * j], y[2 * j + 1] = 0.0, 1.0
        else:
            y[2 * j] = y[2 * j + 1] = SECRET_NUM
    return y


def train_compare(cfg: str, weights, argv, *, device="cuda"):
    """train_compare (compare.c:10-81): consecutive path pairs ->
    6-channel stacked input, 2*classes pairwise truth."""
    argv = list(argv)
    list_path = find_value(argv, "-list", "data/compare.train.list")
    classes = find_value(argv, "-classes", 20, int)
    spec, trainer = _make_trainer(cfg, weights, argv, device)
    paths = _read_list(list_path)
    rng = np.random.default_rng(0)

    def next_batch(n):
        xs, ys = [], []
        for _ in range(n):
            i = rng.integers(0, len(paths) // 2)
            pa, pb = paths[2 * i], paths[2 * i + 1]
            ia = _load_resized(pa, spec.net.w, spec.net.h)
            ib = _load_resized(pb, spec.net.w, spec.net.h)
            xs.append(np.concatenate([ia, ib], axis=-1))   # 6 channels
            ys.append(load_compare_labels(pa, pb, classes))
        return np.stack(xs), np.stack(ys)

    return _train_loop(spec, trainer, next_batch, argv, cfg)


# ---------------------------------------------------------------------
# vid-rnn
# ---------------------------------------------------------------------

class FrameDirVideos:
    """Video source for train_vid_rnn without OpenCV: each entry in the
    list file is a DIRECTORY of ordered frames (the robot pipeline's
    dump format)."""

    def __init__(self, list_path: str):
        self.dirs = _read_list(list_path)

    def clip(self, rng, length: int):
        for _ in range(20):
            d = self.dirs[rng.integers(0, len(self.dirs))]
            frames = sorted(glob.glob(os.path.join(d, "*")))
            if len(frames) >= length + 2:
                start = int(rng.integers(0, len(frames) - length - 1))
                return frames[start:start + length]
        raise ValueError("no video directory with enough frames")


def train_vid_rnn(cfg: str, weights, argv, *, device="cuda"):
    """train_vid_rnn (rnn_vid.c:80-146): an extractor net embeds
    (steps+1) consecutive frames per clip; the RNN net trains on
    x = feats[0:steps], y = feats[1:steps+1], step-major across clips
    (get_rnn_vid_data's feats[(b + i*batch)] layout). Both nets run on
    ``device``."""
    argv = list(argv)
    list_path = find_value(argv, "-list", "data/vid/train.txt")
    ext_cfg = find_value(argv, "-extractor", None)
    ext_weights = find_value(argv, "-extractor-weights", None)
    if ext_cfg is None:
        raise SystemExit("vid-rnn training needs -extractor <cfg> "
                         "(rnn_vid.c:102 parses cfg/extractor.cfg)")
    ext_spec, ext_fwd = _network(ext_cfg, ext_weights, device)

    spec, trainer = _make_trainer(cfg, weights, argv, device)
    steps = spec.net.time_steps
    outer = trainer.outer_batch
    if outer % steps:
        raise SystemExit(f"net.batch*subdivisions ({outer}) must be a "
                         f"multiple of time_steps ({steps})")
    nvids = outer // steps
    videos = FrameDirVideos(list_path)
    rng = np.random.default_rng(0)

    def next_batch(n):
        feats = []                          # (steps+1, nvids, F)
        for v in range(nvids):
            clip = videos.clip(rng, steps + 1)
            x = np.stack([_load_resized(f, ext_spec.net.w,
                                        ext_spec.net.h) for f in clip])
            out = ext_fwd(x)
            feats.append(out.reshape(steps + 1, -1))
        f = np.stack(feats, axis=1)          # step-major, clips minor
        fdim = f.shape[-1]
        x = f[:steps].reshape(outer, fdim)
        y = f[1:].reshape(outer, fdim)
        return x, y

    return _train_loop(spec, trainer, next_batch, argv, cfg)


# ---------------------------------------------------------------------
# dice
# ---------------------------------------------------------------------

DICE_LABELS = ["face1", "face2", "face3", "face4", "face5", "face6"]


def train_dice(cfg: str, weights, argv, *, device="cuda"):
    """train_dice (dice.c:7-46): classification over the six face
    labels, truth by path-substring match (fill_truth, data.c:387),
    images stretch-resized to net size (load_data_old, data.c:815).
    The reference mutates net.learning_rate *= .1 every 100 iters on
    top of whatever the cfg says (dice.c:38) — that is exactly the
    STEP policy with step=100, scale=.1, applied here by overriding
    the parsed net schedule."""
    import dataclasses
    list_path = find_value(argv, "-list", "data/dice/dice.train.list")
    spec = parse_network_cfg(cfg)
    spec = dataclasses.replace(spec, net=dataclasses.replace(
        spec.net, policy="step", step=100, scale=0.1))
    spec, trainer = _make_trainer(cfg, weights, argv, device, spec=spec)
    paths = _read_list(list_path)
    rng = np.random.default_rng(0)

    def next_batch(n):
        picks = [paths[rng.integers(0, len(paths))] for _ in range(n)]
        x = np.stack([_load_resized(p, spec.net.w, spec.net.h)
                      for p in picks])
        y = np.zeros((n, len(DICE_LABELS)), np.float32)
        for i, p in enumerate(picks):
            for j, lab in enumerate(DICE_LABELS):
                if lab in p:
                    y[i, j] = 1.0
        return x, y

    return _train_loop(spec, trainer, next_batch, argv, cfg)


def validate_dice(cfg: str, weights, argv, *, device="cuda"):
    """validate_dice (dice.c:47-67): whole val list in one pass,
    top-1/top-2 accuracy (network_accuracies(net, val, 2));
    the reference prints acc[0]."""
    list_path = find_value(argv, "-list", "data/dice/dice.val.list")
    spec, fwd = _network(cfg, weights, device)
    paths = _read_list(list_path)
    hits1 = hits2 = 0
    for s in range(0, len(paths), 64):
        chunk = paths[s:s + 64]
        x = np.stack([_load_resized(p, spec.net.w, spec.net.h)
                      for p in chunk])
        out = fwd(x)
        truth = np.array([[j for j, lab in enumerate(DICE_LABELS)
                           if lab in p][0] for p in chunk])
        order = np.argsort(-out, axis=1)
        hits1 += int(np.sum(order[:, 0] == truth))
        hits2 += int(np.sum(np.any(order[:, :2] == truth[:, None],
                                   axis=1)))
    acc1, acc2 = hits1 / len(paths), hits2 / len(paths)
    print(f"Validation Accuracy: {acc1:f}, {len(paths)} images")
    return acc1, acc2


# ---------------------------------------------------------------------
# super / voxel
# ---------------------------------------------------------------------

def train_super(cfg: str, weights, argv, *, device="cuda"):
    """train_super (super.c:10-106); train_voxel (voxel.c:51-117) is a
    byte-identical copy of it in the reference, so both CLI commands
    dispatch here. SUPER_DATA pairs (load_data_super, data.c:840-868):
    y = a random (w*scale, h*scale) crop (flip-augmented), x = its
    bilinear downsample to the net input; truth is the darknet CHW
    raster of the crop."""
    from ..ops.image import load_image_rgb, resize_image_np, \
        crop_image_np
    argv = list(argv)
    list_path = find_value(argv, "-list", "data/super.list")
    scale = find_value(argv, "-scale", 4, int)
    spec, trainer = _make_trainer(cfg, weights, argv, device)
    w, h = spec.net.w, spec.net.h
    paths = _read_list(list_path)
    rng = np.random.default_rng(0)

    def next_batch(n):
        xs, ys = [], []
        for _ in range(n):
            im = load_image_rgb(paths[int(rng.integers(0, len(paths)))])
            cw, ch = w * scale, h * scale
            dx = int(rng.integers(0, max(im.shape[1] - cw, 0) + 1))
            dy = int(rng.integers(0, max(im.shape[0] - ch, 0) + 1))
            crop = crop_image_np(im, dx, dy, cw, ch)
            if rng.integers(0, 2):
                crop = crop[:, ::-1, :]
            xs.append(resize_image_np(crop, w, h))
            ys.append(np.transpose(crop, (2, 0, 1)).reshape(-1))
        return np.stack(xs), np.stack(ys)

    return _train_loop(spec, trainer, next_batch, argv, cfg)


train_voxel = train_super


# ---------------------------------------------------------------------
# captcha test / valid
# ---------------------------------------------------------------------

def test_captcha(cfg: str, weights, image: str, argv, out=None, *,
                 device="cuda"):
    """test_captcha (captcha.c:98-136): stretch-resize, forward, print
    EVERY label sorted by score as 'name prob, name prob, ...'."""
    import sys
    out = out or sys.stdout
    labels_path = find_value(argv, "-labels", "reimgs.labels.list")
    names = _read_list(labels_path)
    spec, fwd = _network(cfg, weights, device)
    x = _load_resized(image, spec.net.w, spec.net.h)[None]
    pred = fwd(x).reshape(-1)
    order = np.argsort(-pred[:len(names)])
    out.write(", ".join(f"{names[i]} {pred[i]:f}" for i in order)
              + "\n")
    return pred


def valid_captcha(cfg: str, weights, argv, out=None, *, device="cuda"):
    """valid_captcha (captcha.c:138-177): per list path print
    'truth, p0, p1, ...' where truth is the LAST label whose name is a
    substring of the path (the reference scan does not break). The
    per-image batch-1 forwards become chunked batched forwards."""
    import sys
    out = out or sys.stdout
    list_path = find_value(argv, "-list", "reimgs.fg.list")
    labels_path = find_value(argv, "-labels", "reimgs.labels.list")
    batch = find_value(argv, "-batch", 64, int)
    names = _read_list(labels_path)
    spec, fwd = _network(cfg, weights, device)
    paths = _read_list(list_path)
    rows = []
    for off in range(0, len(paths), batch):
        chunk = paths[off:off + batch]
        x = np.stack([_load_resized(p, spec.net.w, spec.net.h)
                      for p in chunk])
        pred = fwd(x)
        for p, row in zip(chunk, pred):
            truth = -1
            for j, lab in enumerate(names):
                if lab in p:
                    truth = j
            if truth == -1:
                print(f"bad: {p}", file=sys.stderr)
                return rows
            out.write(f"{truth}, "
                      + ", ".join(f"{v:f}" for v in row) + "\n")
            rows.append((truth, row))
    return rows


__all__ = ["train_captcha", "train_tag", "train_writing",
           "train_compare", "train_vid_rnn", "train_dice",
           "validate_dice", "train_super", "train_voxel",
           "test_captcha", "valid_captcha", "fix_data_captcha",
           "load_tags", "load_compare_labels", "FrameDirVideos",
           "DICE_LABELS"]
