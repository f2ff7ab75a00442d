"""Small demo applications over the shared runtime.

Counterpart of ``sr_object_detection_tpu/apps/misc_apps.py``. The
reference ships many thin CLI apps that all reuse the same network
runtime (src_yolo2/: art.c, tag.c, captcha.c, writing.c, compare.c,
dice.c, yolo.c, coco.c, swag.c, voxel.c, rnn_vid.c). Their substance is
a data format + a decode; the forward path is identical: one ``_load``
gives a ``Network`` on ``device`` (CUDA unless the CLI's -cpu) and its
float32 predict function. The YOLOv1 training path (``run_yolo_v1``)
trains on the float32 ``Trainer``; ``VideoRNN`` reads a layer's output
from one forward that keeps every layer's output; the vid-rnn generator
reconstructs images from feature space by ``torch.autograd`` gradient
steps (``make_reconstructor``) and drives the char-rnn sampler
(``apps/rnn_app.CharRNNSampler``). The numpy-only pieces (decodes, truth
packing, the stereo tools and image tests) are copied as they are from
the JAX module.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph.spec import parse_network_cfg, DetectionSpec
from ..io.weights import load_weights
from ..ops.image import load_image_rgb, resize_image_np, letterbox_image_np


def _load(cfg, weights, device):
    """(spec, Network on ``device``, predict): ``predict(x)`` is the
    float32 forward of an NHWC numpy batch, its output as numpy in the
    public layout. No weights: ``init_params`` (seed 0)."""
    from ..graph.compiler import Network
    from ..io.convert import params_to_torch
    from ..io.weights import init_params
    device = torch.device(device)
    if device.type == "cuda":
        from ..infer.detector import disable_tf32
        disable_tf32()
    spec = parse_network_cfg(cfg)
    params = load_weights(spec, weights)[0] if weights \
        else init_params(spec)
    net = Network(spec, params_to_torch(spec, params, device))

    @torch.no_grad()
    def predict(x):
        out, _ = net(torch.from_numpy(
            np.ascontiguousarray(x, np.float32)).to(device))
        return out.cpu().numpy()
    return spec, net, predict


def art(cfg: str, weights: str, image_path: str, *, device="cuda"
        ) -> float:
    """art.c:1-88: aesthetics score = normalized rank of neuron 0's
    activation (the reference prints a star meter from the score)."""
    spec, _, predict = _load(cfg, weights, device)
    im = letterbox_image_np(load_image_rgb(image_path),
                            spec.net.w, spec.net.h)
    out = predict(im[None])[0].ravel()
    p = out[0]
    score = float((out < p).mean())   # rank of neuron 0 among all outputs
    stars = int(score * 10)
    print("[" + "*" * stars + " " * (10 - stars) + f"] {score:.3f}")
    return score


NUMCHARS = 37   # data.c:318 — a-z, 0-9, '.'


def _int_to_alphanum(i: int) -> str:
    if i == 36:
        return "."
    if i < 10:
        return chr(ord("0") + i)
    return chr(ord("a") + i - 10)


def captcha(cfg: str, weights: str, image_path: str, *, device="cuda"
            ) -> str:
    """captcha.c predict: per-position 37-way argmax
    (data.c print_letters:308-316)."""
    spec, _, predict = _load(cfg, weights, device)
    im = resize_image_np(load_image_rgb(image_path),
                         spec.net.w, spec.net.h)
    out = predict(im[None])[0].ravel()
    n = len(out) // NUMCHARS
    chars = [_int_to_alphanum(int(out[i * NUMCHARS:(i + 1) * NUMCHARS]
                                  .argmax())) for i in range(n)]
    s = "".join(chars)
    print(s)
    return s


def tag(cfg: str, weights: str, image_path: str, names=None, k: int = 10,
        *, device="cuda"):
    """tag.c: multi-label prediction — top-k independent tag scores."""
    spec, _, predict = _load(cfg, weights, device)
    im = resize_image_np(load_image_rgb(image_path),
                         spec.net.w, spec.net.h)
    out = predict(im[None])[0].ravel()
    order = np.argsort(-out)[:k]
    results = [(int(i), float(out[i]),
                names[int(i)] if names else None) for i in order]
    for i, p, name in results:
        print(f"{p:.4f}: {name or i}")
    return results


def compare(cfg: str, weights: str, image_a: str, image_b: str, *,
            device="cuda") -> float:
    """compare.c: feed two images stacked channelwise (6ch input) and
    read the comparison score."""
    spec, _, predict = _load(cfg, weights, device)
    a = resize_image_np(load_image_rgb(image_a), spec.net.w, spec.net.h)
    b = resize_image_np(load_image_rgb(image_b), spec.net.w, spec.net.h)
    x = np.concatenate([a, b], axis=2)[None]
    out = predict(x)[0].ravel()
    print(f"compare score: {out[0]:.6f}")
    return float(out[0])


def writing(cfg: str, weights: str, image_path: str, out_path=None, *,
            device="cuda"):
    """writing.c: dense per-pixel prediction (e.g. handwriting mask);
    the network output is an image-shaped map."""
    spec, _, predict = _load(cfg, weights, device)
    im = resize_image_np(load_image_rgb(image_path),
                         spec.net.w, spec.net.h)
    out = predict(im[None])[0]
    if out.ndim == 2:
        last = spec.layers[spec.output_layer_index()]
        out = out.reshape(last.out_c, last.out_h, last.out_w)
        out = np.transpose(out, (1, 2, 0))
    mask = np.repeat(out[..., :1], 3, axis=2)
    if out_path:
        from .nightmare_app import _save_ppm
        _save_ppm(out_path, mask)
    return mask


# ---------------------------------------------------------------------------
# YOLOv1 pipelines (yolo.c / coco.c): decode + truth packing
# ---------------------------------------------------------------------------

VOC_NAMES = ["aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
             "car", "cat", "chair", "cow", "diningtable", "dog", "horse",
             "motorbike", "person", "pottedplant", "sheep", "sofa",
             "train", "tvmonitor"]


def decode_detection_boxes(output, spec: DetectionSpec):
    """get_detection_boxes (detection_layer.c:224-250): flat v1 output
    -> (boxes (side^2*n, 4) relative, probs (side^2*n, classes))."""
    s2 = spec.side * spec.side
    nc, nb = spec.classes, spec.n
    cls = output[:s2 * nc].reshape(s2, nc)
    obj = output[s2 * nc:s2 * (nc + nb)].reshape(s2, nb)
    raw = output[s2 * (nc + nb):].reshape(s2, nb, 4)
    rows, cols = np.divmod(np.arange(s2), spec.side)
    bx = (raw[..., 0] + cols[:, None]) / spec.side
    by = (raw[..., 1] + rows[:, None]) / spec.side
    pw = raw[..., 2] ** (2 if spec.sqrt else 1)
    ph = raw[..., 3] ** (2 if spec.sqrt else 1)
    boxes = np.stack([bx, by, pw, ph], axis=-1).reshape(-1, 4)
    probs = (obj[..., None] * cls[:, None, :]).reshape(-1, nc)
    return boxes, probs


def fill_truth_region_np(labels: np.ndarray, side: int, classes: int
                         ) -> np.ndarray:
    """YOLOv1 grid truth (data.c fill_truth_region:247-293):
    per cell [is_obj, onehot, cell-rel x, cell-rel y, w, h] — note our
    detection loss consumes [is_obj, onehot, x, y, w, h] with 4 coords.
    labels: (N, 5) [id, x, y, w, h]."""
    truth = np.zeros((side * side, 1 + classes + 4), np.float32)
    for row_ in labels:
        cid, x, y, w, h = row_
        if w < 0.01 or h < 0.01:
            continue
        col = min(int(x * side), side - 1)
        row = min(int(y * side), side - 1)
        idx = col + row * side
        if truth[idx, 0]:
            continue
        truth[idx, 0] = 1
        if int(cid) < classes:
            truth[idx, 1 + int(cid)] = 1
        truth[idx, 1 + classes:] = [x * side - col, y * side - row, w, h]
    return truth


# dice_labels (dice.c:5) — also the path substrings that label the
# training images (fill_truth path match; scripts/dice_label.sh names
# frames face1_*.jpg .. face6_*.jpg)
DICE_LABELS = ["face1", "face2", "face3", "face4", "face5", "face6"]


def dice(cfg: str, weights: str, image_path: str, *, device="cuda"):
    """dice.c: classify a die face (six labels, dice_label.sh dataset)."""
    from ..infer.classifier import Classifier
    clf = Classifier(cfg, weights, names=DICE_LABELS, device=device)
    top = clf.predict_topk(load_image_rgb(image_path), k=1)[0]
    print(f"{top[2]}: {top[1]:.4f}")
    return top


def voxel(cfg: str, weights: str, frame_glob: str, out_dir: str = ".", *,
          device="cuda"):
    """voxel.c: video super-resolution — upscale every frame of a
    sequence with the super-resolution net."""
    import os
    from .super_app import super_resolve
    from .nightmare_app import _save_ppm
    import glob as _glob
    frames = sorted(_glob.glob(frame_glob))
    outs = []
    for i, f in enumerate(frames):
        up = super_resolve(cfg, weights, f, device=device)
        out = os.path.join(out_dir, f"voxel_{i:05d}.ppm")
        _save_ppm(out, up)
        outs.append(out)
    print(f"upscaled {len(outs)} frames")
    return outs


class VideoRNN:
    """rnn_vid.c analog: conv features per frame feed an RNN that
    predicts the next frame's feature vector (generative video model).
    The conv trunk is any classifier cfg truncated at `feature_layer`;
    its features are that layer's output in one forward on ``device``
    that keeps every layer's output."""

    def __init__(self, cfg: str, weights=None, feature_layer: int = -3, *,
                 device="cuda"):
        from ..graph.compiler import Network
        from ..io.convert import params_to_torch
        from ..io.weights import init_params
        self.device = torch.device(device)
        if self.device.type == "cuda":
            from ..infer.detector import disable_tf32
            disable_tf32()
        self.spec = parse_network_cfg(cfg)
        if weights:
            params, _ = load_weights(self.spec, weights)
        else:
            params = init_params(self.spec, seed=0)
        self.params = params_to_torch(self.spec, params, self.device)
        self.net = Network(self.spec, self.params)
        n_layers = len(self.spec.layers)
        self.feat_idx = feature_layer % n_layers

    @torch.no_grad()
    def features(self, frames_nhwc):
        x = torch.from_numpy(np.ascontiguousarray(frames_nhwc, np.float32))
        _, aux = self.net(x.to(self.device), keep_all=True)
        f = aux["outputs"][self.feat_idx]
        return f.reshape(f.shape[0], -1).cpu().numpy()


def run_yolo_v1(data_cfg: str, cfg: str, weights, argv, *, device="cuda"):
    """yolo.c / coco.c / swag.c train path: YOLOv1 grid-truth training
    over the float32 Trainer on the detection loss, on ``device``; the
    grid takes the detection layer's class count."""
    import os
    import torch
    from ..config import read_data_cfg
    from ..data.loader import DetectionLoader
    from ..graph.spec import parse_network_cfg
    from ..io import checkpoint as ckpt
    from ..io.weights import load_weights
    from ..train.trainer import Trainer

    options = read_data_cfg(data_cfg)
    train_list = options.get("train", "data/train.list")
    backup_dir = options.get("backup", "backup")
    os.makedirs(backup_dir, exist_ok=True)
    spec = parse_network_cfg(cfg)
    det = spec.layers[-1]
    if not isinstance(det, DetectionSpec):
        raise ValueError(f"{cfg}: v1 training needs a [detection] head")
    params = None
    if weights:
        params, _ = load_weights(spec, weights)
    if torch.device(device).type == "cuda":
        from ..infer.detector import disable_tf32
        disable_tf32()
    trainer = Trainer(spec, params=params, device=device)
    outer = trainer.outer_batch
    loader = DetectionLoader(train_list, w=spec.net.w, h=spec.net.h,
                             batch=outer, classes=det.classes,
                             jitter=det.jitter, device=device)
    base = os.path.splitext(os.path.basename(cfg))[0]
    max_batches = spec.net.max_batches or 10000
    try:
        while True:
            i = int(trainer.state.seen) // outer + 1
            if i > max_batches:
                break
            x, boxes_truth = loader.next_batch()
            # repack box truths into the v1 grid layout
            grid = np.stack([
                fill_truth_region_np(
                    boxes_truth[b][boxes_truth[b, :, 2] > 0]
                    [:, [4, 0, 1, 2, 3]], det.side, det.classes)
                for b in range(outer)])
            m = trainer.step(x, grid)
            print(f"{i}: {float(m['loss'])/outer:.6f}")
            if ckpt.should_checkpoint(i):
                ckpt.export_weights(
                    ckpt.checkpoint_name(backup_dir, base, i), spec,
                    trainer.state)
    finally:
        loader.close()
    return trainer


def composite_3d(path_a: str, path_b: str, out_path: str = "out.ppm",
                 delta: int = 0, search: int = 0):
    """'3d' command (darknet.c:461 / image.c composite_3d): red-cyan
    anaglyph from a stereo pair after finding the vertical shift that
    best aligns them."""
    a = load_image_rgb(path_a)
    b = load_image_rgb(path_b)
    h = min(a.shape[0], b.shape[0])
    w = min(a.shape[1], b.shape[1])
    a, b = a[:h, :w], b[:h, :w]
    rng = search or max(h // 100, 1)
    best_shift, best_d = 0, np.inf
    for s in range(-rng, rng + 1):
        bs = np.roll(b, s, axis=0)
        d = float(np.mean(np.abs(bs[rng:-rng or None] -
                                 a[rng:-rng or None])))
        if d < best_d:
            best_d, best_shift = d, s
    bs = np.roll(b, best_shift + delta, axis=0)
    out = bs.copy()
    out[..., 0] = a[..., 0]          # red from the left eye
    from .nightmare_app import _save_ppm
    _save_ppm(out_path, out)
    print(f"3d: shift {best_shift}, wrote {out_path}")
    return out


def imtest(image_path: str, out_dir: str = "."):
    """test_resize (image.c:1995-2042): write resized / letterboxed /
    distorted variants for visual inspection."""
    import os
    from ..ops.image import letterbox_image_np
    from ..data.augment import distort_image, flip_horizontal
    from .nightmare_app import _save_ppm
    im = load_image_rgb(image_path)
    h, w = im.shape[:2]
    variants = {
        "resize_half": resize_image_np(im, w // 2, h // 2),
        "resize_double": resize_image_np(im, w * 2, h * 2),
        "letterbox": letterbox_image_np(im, max(w, h), max(w, h)),
        "flip": flip_horizontal(im),
        "sat2": distort_image(im, 0.0, 2.0, 1.0),
        "exp2": distort_image(im, 0.0, 1.0, 2.0),
        "hue_shift": distort_image(im, 0.1, 1.0, 1.0),
    }
    outs = []
    base = os.path.splitext(os.path.basename(image_path))[0]
    for name, v in variants.items():
        p = os.path.join(out_dir, f"{base}_{name}.ppm")
        _save_ppm(p, np.clip(v, 0, 1))
        outs.append(p)
    print(f"wrote {len(outs)} variants")
    return outs


# ---------------------------------------------------------------------
# voxel extract + vid-rnn generate
# ---------------------------------------------------------------------

def _dist_array(a: np.ndarray, b: np.ndarray, sub: int = 10) -> float:
    """dist_array (utils.c): strided L2 distance."""
    af, bf = a.reshape(-1)[::sub], b.reshape(-1)[::sub]
    return float(np.sqrt(np.sum((af - bf) ** 2)))


def best_3d_shift_r(a: np.ndarray, b: np.ndarray, mn: int, mx: int,
                    sub: int = 10) -> int:
    """best_3d_shift_r (image.c:1534-1546): binary search for the
    vertical shift of b minimizing the strided L2 to a; crop_image's
    edge replication supplies the out-of-range rows."""
    from ..ops.image import crop_image_np
    h, w = a.shape[:2]
    while mn != mx:
        mid = int(np.floor((mn + mx) / 2.0))
        c1 = crop_image_np(b, 0, mid, w, h)
        c2 = crop_image_np(b, 0, mid + 1, w, h)
        if _dist_array(c1, a, sub) < _dist_array(c2, a, sub):
            mx = mid
        else:
            mn = mid + 1
    return mn


def _frame_iter(src_path: str):
    """Frames from a video file, a directory, or a glob."""
    import os
    from ..robot.frame_source import (ImageDirectorySource,
                                      VideoFileSource)
    if os.path.isdir(src_path):
        src = ImageDirectorySource(os.path.join(src_path, "*"))
    elif any(ch in src_path for ch in "*?["):
        src = ImageDirectorySource(src_path)
    else:
        src = VideoFileSource(src_path)
    while True:
        f = src.next()
        if f is None:
            return
        yield f.color.astype(np.float32) / 255.0


def extract_voxel(lfile: str, rfile: str, prefix: str, argv=()):
    """extract_voxel (voxel.c:15-49): walk a stereo pair of streams,
    re-estimate the vertical alignment shift every 100 frames
    (best_3d_shift_r over ±h/100), crop the left eye centered and the
    right eye at the fixed 105px horizontal disparity + shift, save
    pairs as <prefix>_<n>_l/r."""
    from ..ops.image import crop_image_np
    from .cli import find_value
    from .nightmare_app import _save_ppm
    argv = list(argv)
    w = find_value(argv, "-w", 1920, int)
    h = find_value(argv, "-h", 1080, int)
    xoff = find_value(argv, "-xoff", 105, int)
    shift = 0
    count = 0
    written = []
    for l, r in zip(_frame_iter(lfile), _frame_iter(rfile)):
        if count % 100 == 0:
            rng_ = max(l.shape[0] // 100, 1)
            shift = best_3d_shift_r(l, r, -rng_, rng_)
            print(shift)
        ls = crop_image_np(l, (l.shape[1] - w) // 2,
                           (l.shape[0] - h) // 2, w, h)
        rs = crop_image_np(r, xoff + (r.shape[1] - w) // 2,
                           (r.shape[0] - h) // 2 + shift, w, h)
        _save_ppm(f"{prefix}_{count:05d}_l.ppm", ls)
        _save_ppm(f"{prefix}_{count:05d}_r.ppm", rs)
        written += [f"{prefix}_{count:05d}_l.ppm",
                    f"{prefix}_{count:05d}_r.ppm"]
        count += 1
    print(f"extracted {count} stereo pairs")
    return written


def make_reconstructor(spec, smooth_size: int = 2):
    """reconstruct_picture's update rule (nightmare.c:117-178) as one
    step(params, feat, recon, update, rate, momentum, lam) over the
    port's torch ``params`` and an NHWC (1, H, W, 3) ``recon``:
    delta = -d/dx 0.5||f(x)-feat||^2 (``torch.autograd.grad`` through
    ``Network``), update += delta + lambda * sum_window(recon[q] -
    recon[p]) (the reference's `smooth`; the window sum and the count of
    in-image pixels are box filters over the zero-padded image, so both
    are exact at the borders, as the JAX validity-count window is), then
    recon += rate*update clipped to [0,1], update *= momentum."""
    import torch.nn.functional as F
    from ..graph.compiler import Network
    win = 2 * smooth_size + 1

    def step(params, feat, recon, update, rate, momentum, lam):
        x = recon.detach().requires_grad_(True)
        out, _ = Network(spec, params)(x)
        objective = 0.5 * torch.sum(torch.square(out.reshape(-1) - feat))
        delta = -torch.autograd.grad(objective, x)[0]
        with torch.no_grad():
            r = recon[0].permute(2, 0, 1)[:, None]       # (3, 1, H, W)
            box = torch.ones((1, 1, win, win), dtype=r.dtype,
                             device=r.device)
            sums = F.conv2d(r, box, padding=smooth_size)
            cnt = F.conv2d(torch.ones_like(r[:1]), box,
                           padding=smooth_size)
            smooth = (sums - cnt * r)[:, 0].permute(1, 2, 0)[None]
            update = update + delta + lam * smooth
            recon = torch.clamp(recon + rate * update, 0.0, 1.0)
            return recon, momentum * update

    return step


def reconstruct_picture(spec, params, feat, recon, *, rate=0.01,
                        momentum=0.9, lam=0.1, smooth_size=2, iters=50):
    """``iters`` steps of :func:`make_reconstructor` from the numpy
    (1, H, W, 3) ``recon`` toward the features ``feat``, on the device
    of ``params`` (the port's torch params); returns numpy."""
    device = next((v.device for p in params for v in p.values()),
                  torch.device("cpu"))
    step = make_reconstructor(spec, smooth_size)
    feat = torch.from_numpy(np.asarray(feat, np.float32).reshape(-1)
                            ).to(device)
    recon = torch.from_numpy(np.asarray(recon, np.float32)).to(device)
    update = torch.zeros_like(recon)
    for _ in range(iters):
        recon, update = step(params, feat, recon, update, rate,
                             momentum, lam)
    return recon.cpu().numpy()


def generate_vid_rnn(cfg: str, weights, argv, out_dir: str = ".", *,
                     device="cuda"):
    """generate_vid_rnn (rnn_vid.c:154-198): prime the feature-RNN with
    extractor features of N real frames (reconstructing 'feat'/'next'
    images from feature space each step), then free-run M steps,
    reconstructing each predicted feature starting from the previous
    reconstruction ('new%d'). Both nets run on ``device``."""
    import os
    from .cli import find_value
    from .rnn_app import CharRNNSampler
    from ..graph.compiler import Network
    from ..io.convert import params_to_torch
    from ..io.weights import init_params
    from .nightmare_app import _save_ppm

    argv = list(argv)
    ext_cfg = find_value(argv, "-extractor", None)
    if ext_cfg is None:
        raise SystemExit("vid-rnn generate needs -extractor <cfg> "
                         "(rnn_vid.c:156 parses cfg/extractor.recon.cfg)")
    ext_weights = find_value(argv, "-extractor-weights", None)
    frames_src = find_value(argv, "-frames", "frames")
    n_prime = find_value(argv, "-n", 25, int)
    n_gen = find_value(argv, "-gen", 30, int)
    recon_iters = find_value(argv, "-recon-iters", 50, int)
    out_dir = find_value(argv, "-out", out_dir)
    os.makedirs(out_dir, exist_ok=True)

    device = torch.device(device)
    ext_spec = parse_network_cfg(ext_cfg)
    ext_params = params_to_torch(
        ext_spec, load_weights(ext_spec, ext_weights)[0] if ext_weights
        else init_params(ext_spec), device)
    ext_net = Network(ext_spec, ext_params)

    spec = parse_network_cfg(cfg)
    params, _ = load_weights(spec, weights) if weights else \
        (init_params(spec), 0)
    sampler = CharRNNSampler(spec, params, device=device)
    states = sampler.init_state()

    rng = np.random.default_rng(0)
    w, h = ext_spec.net.w, ext_spec.net.h

    def recon_from(feat, init, name, i):
        start = init[None] if init is not None else \
            rng.random((1, h, w, 3), np.float32)
        img = reconstruct_picture(ext_spec, ext_params, feat,
                                  start.astype(np.float32),
                                  iters=recon_iters)[0]
        _save_ppm(os.path.join(out_dir, f"{name}{i}.ppm"), img)
        return img

    last = None
    nxt = None
    for i, frame in enumerate(_frame_iter(frames_src)):
        if i >= n_prime:
            break
        re = resize_image_np(frame, w, h)
        with torch.no_grad():
            feat = ext_net(torch.from_numpy(re[None]).to(device))[0]
        feat = feat.cpu().numpy()
        nxt, states = sampler._step(
            sampler.params,
            torch.from_numpy(feat.reshape(1, -1)).to(sampler.device),
            states)
        recon_from(feat, None, "feat", i)
        recon_from(nxt.cpu().numpy(), None, "next", i)
        last = re
    outs = []
    for i in range(n_gen):
        nxt, states = sampler._step(sampler.params, nxt, states)
        last = recon_from(nxt.cpu().numpy(), last, "new", i)
        outs.append(last)
    return outs


__all__ = ["art", "captcha", "tag", "compare", "writing", "dice", "voxel",
           "VideoRNN", "decode_detection_boxes", "fill_truth_region_np",
           "VOC_NAMES", "NUMCHARS", "DICE_LABELS", "run_yolo_v1",
           "composite_3d", "imtest", "best_3d_shift_r", "extract_voxel",
           "make_reconstructor", "reconstruct_picture",
           "generate_vid_rnn"]
