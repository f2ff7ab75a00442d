"""Classifier application: train / valid / predict and the other modes.

Counterpart of ``sr_object_detection_tpu/apps/classifier_app.py``
(run_classifier, src_yolo2/classifier.c:1124-1178):

  classifier train <data> <cfg> [weights] [-clear]
  classifier predict <data> <cfg> <weights> <image>
  classifier try <data> <cfg> <weights> <image> [layer]
  classifier valid|valid_multi|valid_crop|valid_full|valid_10 <data> <cfg>
      <weights> [-topk K] [-batch N]
  classifier test|label <data> <cfg> <weights> [-batch N]
  classifier demo|threat|gun <data> <cfg> <weights> -file <dir|glob>

Every mode runs on ``device`` (CUDA unless the CLI's -cpu), in float32.
The modes that go through ``Classifier`` letterbox and take the
hierarchy's path products; ``valid_crop``, ``valid_full``, ``test`` and
``try`` run the network's raw output, as in the JAX module. ``train``
runs the float32 ``Trainer`` on the cost head over a
``ClassificationLoader``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..config import read_data_cfg, read_names
from ..graph.compiler import Network
from ..graph.spec import parse_network_cfg
from ..io import checkpoint as ckpt
from ..io.convert import params_to_torch
from ..io.weights import init_params, load_weights
from .cli import find_arg, find_value


def _labels(options):
    return read_names(options["labels"]) if "labels" in options else \
        read_names(options["names"])


def _network(cfg: str, weights: str | None, device):
    """(spec, numpy params, float32 Network on ``device``) of a cfg and
    its weights (seeded weights from ``init_params`` without them)."""
    from ..infer.detector import disable_tf32
    if torch.device(device).type == "cuda":
        disable_tf32()
    spec = parse_network_cfg(cfg)
    params = load_weights(spec, weights)[0] if weights else \
        init_params(spec)
    return spec, params, Network(spec, params_to_torch(spec, params,
                                                       device))


def _forward(net, x, device):
    """The network's output on an NHWC numpy batch, flattened to (B, N)
    float32 numpy; ``aux`` too."""
    with torch.no_grad():
        out, aux = net(torch.from_numpy(np.ascontiguousarray(
            x, np.float32)).to(device), keep_all=True)
    return out.reshape(out.shape[0], -1).float().cpu().numpy(), aux


def train_classifier(data_cfg: str, cfg: str, weights: str | None,
                     argv: list[str], *, device="cuda"):
    """train_classifier (classifier.c:38-150): the float32 Trainer over
    the classification loader, ``<cfg>.backup`` every 100 iterations
    (classifier.c:135-145) and ``<cfg>.weights`` at the end, both in the
    data cfg's backup directory. ``-clear`` starts the seen counter of
    the given weights at 0."""
    from ..data.loader import ClassificationLoader
    from ..infer.detector import disable_tf32
    from ..train.trainer import Trainer

    options = read_data_cfg(data_cfg)
    train_list = options.get("train", "data/train.list")
    backup_dir = options.get("backup", "backup")
    labels = _labels(options)
    os.makedirs(backup_dir, exist_ok=True)
    base = os.path.splitext(os.path.basename(cfg))[0]
    if torch.device(device).type == "cuda":
        disable_tf32()

    spec = parse_network_cfg(cfg)
    params = None
    seen = 0
    if weights:
        params, seen = load_weights(spec, weights)
    trainer = Trainer(spec, params=params, device=device)
    if weights and not find_arg(argv, "-clear"):
        trainer.state.seen = torch.tensor(int(seen), dtype=torch.int64)

    outer = trainer.outer_batch
    n = spec.net
    loader = ClassificationLoader(
        train_list, labels, w=n.w, h=n.h, batch=outer, min_crop=n.min_crop,
        max_crop=n.max_crop, angle=n.angle, aspect=n.aspect, hue=n.hue,
        saturation=n.saturation, exposure=n.exposure, device=device)
    max_batches = n.max_batches or 10000
    avg_loss = None
    try:
        while True:
            i = int(trainer.state.seen) // outer + 1
            if i > max_batches:
                break
            x, y = loader.next_batch()
            t0 = time.time()
            m = trainer.step(x, y)
            loss = float(m["loss"]) / outer
            avg_loss = loss if avg_loss is None else \
                avg_loss * .9 + loss * .1
            print(f"{i}: {loss:.6f}, {avg_loss:.6f} avg, "
                  f"{float(m['lr']):.6f} rate, {time.time()-t0:.3f} s")
            if i % 100 == 0:
                ckpt.export_weights(
                    os.path.join(backup_dir, f"{base}.backup"), spec,
                    trainer.state)
    finally:
        loader.close()
    ckpt.export_weights(os.path.join(backup_dir, f"{base}.weights"), spec,
                        trainer.state)


def validate_classifier(data_cfg: str, cfg: str, weights: str,
                        argv: list[str], *, device="cuda"):
    """validate_classifier_single semantics (classifier.c:417-470):
    letterboxed single-crop top-1/top-k over the valid list."""
    from ..infer.classifier import Classifier
    from ..ops.image import load_image_rgb

    options = read_data_cfg(data_cfg)
    valid_list = options.get("valid", "data/valid.list")
    labels = _labels(options)
    topk = find_value(argv, "-topk", int(options.get("top", 5)), int)
    clf = Classifier(cfg, weights, names=labels, device=device)

    with open(valid_list) as f:
        paths = [l.strip() for l in f if l.strip()]
    top1 = topn = 0
    for k, path in enumerate(paths):
        truth = next((i for i, n in enumerate(labels) if n in path), 0)
        pred = clf.predict(load_image_rgb(path))
        order = np.argsort(-pred)[:topk]
        top1 += int(order[0] == truth)
        topn += int(truth in order)
        if (k + 1) % 100 == 0:
            print(f"{k+1}: top1 {top1/(k+1):.4f} top{topk} "
                  f"{topn/(k+1):.4f}")
    n = max(len(paths), 1)
    print(f"top1: {top1/n:.4f}, top{topk}: {topn/n:.4f}")
    return top1 / n, topn / n


def predict_classifier(data_cfg: str, cfg: str, weights: str, image: str,
                       argv: list[str], *, device="cuda"):
    """predict_classifier (classifier.c:676-760)."""
    from ..infer.classifier import Classifier
    from ..ops.image import load_image_rgb
    options = read_data_cfg(data_cfg) if data_cfg else {}
    labels = None
    if "names" in options:
        labels = read_names(options["names"])
    elif "labels" in options:
        labels = read_names(options["labels"])
    clf = Classifier(cfg, weights, names=labels, device=device)
    top = clf.predict_topk(load_image_rgb(image),
                           k=int(options.get("top", 5)))
    for idx, p, name in top:
        print(f"{name or idx}: {p:.6f}")
    return top


def run_classifier(argv: list[str], *, device="cuda"):
    sub = argv.pop(0)
    if sub == "predict":
        return predict_classifier(argv[0], argv[1], argv[2], argv[3],
                                  argv[4:], device=device)
    if sub == "try":
        # classifier.c:1164: try <data> <cfg> <weights> <image> [layer]
        rest = argv[4:]
        if rest and not rest[0].startswith("-"):
            rest = ["-layer", rest[0]] + rest[1:]
        return try_classifier(argv[0], argv[1], argv[2], argv[3], rest,
                              device=device)
    data_cfg, cfg = argv[0], argv[1]
    weights = argv[2] if len(argv) > 2 and not argv[2].startswith("-") \
        else None
    rest = argv[3:] if weights else argv[2:]
    modes = {"train": train_classifier, "valid": validate_classifier,
             "valid_multi": validate_classifier_multi,
             "validmulti": validate_classifier_multi,
             "valid_crop": validate_classifier_crop,
             "validcrop": validate_classifier_crop,
             "valid_full": validate_classifier_full,
             "validfull": validate_classifier_full,
             "valid_10": validate_classifier_10,
             "valid10": validate_classifier_10,
             "test": test_classifier, "label": label_classifier,
             "demo": demo_classifier, "threat": threat_classifier,
             "gun": gun_classifier}
    if sub not in modes:
        raise SystemExit(f"unknown classifier subcommand {sub}")
    return modes[sub](data_cfg, cfg, weights, rest, device=device)


def validate_classifier_multi(data_cfg: str, cfg: str, weights: str,
                              argv: list[str], *, device="cuda"):
    """validate_classifier_multi (classifier.c:472-534): average
    predictions over multiple scales + horizontal flips."""
    from ..infer.classifier import Classifier
    from ..ops.image import load_image_rgb, resize_image_np

    options = read_data_cfg(data_cfg)
    valid_list = options.get("valid", "data/valid.list")
    labels = _labels(options)
    topk = find_value(argv, "-topk", int(options.get("top", 5)), int)
    clf = Classifier(cfg, weights, names=labels, device=device)
    base = clf.spec.net.w
    scales = [int(base * s) for s in (1.0, 1.15, 1.3)]

    with open(valid_list) as f:
        paths = [l.strip() for l in f if l.strip()]
    top1 = topn = 0
    for path in paths:
        truth = next((i for i, n in enumerate(labels) if n in path), 0)
        img = load_image_rgb(path)
        pred = None
        for s in scales:
            # classifier.c:512-519: resize to scale, predict image and
            # its horizontal flip, accumulate
            r = resize_image_np(img, s, s)
            r = resize_image_np(r, base, base)
            for flip in (False, True):
                v = r[:, ::-1, :] if flip else r
                p = clf.predict_batch(v[None])[0].float().cpu().numpy()
                pred = p if pred is None else pred + p
        order = np.argsort(-pred)[:topk]
        top1 += int(order[0] == truth)
        topn += int(truth in order)
    n = max(len(paths), 1)
    print(f"multi-crop top1: {top1/n:.4f}, top{topk}: {topn/n:.4f}")
    return top1 / n, topn / n


def _class_of_path(path: str, labels) -> int:
    return next((i for i, n in enumerate(labels) if n in path), -1)


def validate_classifier_crop(data_cfg: str, cfg: str, weights: str,
                             argv: list[str], *, device="cuda"):
    """validate_classifier_crop (classifier.c:269-334): batched
    plain-resize evaluation (OLD_CLASSIFICATION_DATA) in ~1000-image
    splits with running top-1/top-k averages, one batched forward per
    ``-batch`` images."""
    from ..ops.image import load_image_rgb, resize_image_np

    options = read_data_cfg(data_cfg)
    valid_list = options.get("valid", "data/train.list")
    labels = _labels(options)
    topk = find_value(argv, "-topk", int(options.get("top", 1)), int)
    batch = find_value(argv, "-batch", 64, int)
    spec, _, net = _network(cfg, weights, device)

    with open(valid_list) as f:
        paths = [l.strip() for l in f if l.strip()]
    m = len(paths)
    splits = max(m // 1000, 1)
    avg_acc = avg_topk = 0.0
    done = 0
    for s in range(splits):
        part = paths[s * m // splits:(s + 1) * m // splits]
        acc1 = acck = 0
        for off in range(0, len(part), batch):
            chunk = part[off:off + batch]
            x = np.stack([resize_image_np(load_image_rgb(p),
                                          spec.net.w, spec.net.h)
                          for p in chunk])
            pred = _forward(net, x, device)[0][:, :len(labels)]
            order = np.argsort(-pred, axis=1)[:, :topk]
            truth = np.array([_class_of_path(p, labels) for p in chunk])
            acc1 += int((order[:, 0] == truth).sum())
            acck += int((order == truth[:, None]).any(axis=1).sum())
        avg_acc += acc1 / max(len(part), 1)
        avg_topk += acck / max(len(part), 1)
        done += 1
        print(f"{done}: top 1: {avg_acc/done:f}, top {topk}: "
              f"{avg_topk/done:f}, {len(part)} images")
    return avg_acc / max(done, 1), avg_topk / max(done, 1)


def validate_classifier_full(data_cfg: str, cfg: str, weights: str,
                             argv: list[str], *, device="cuda"):
    """validate_classifier_full (classifier.c:408-467): per-image
    fully-convolutional evaluation — resize the short side to net.w
    (bucketed to multiples of 32, as the JAX module does), the network
    re-planned at the image's size (one per size, cached; the same
    parameters), the global-pool head keeping outputs = classes."""
    from ..ops.image import load_image_rgb, resize_image_np

    options = read_data_cfg(data_cfg)
    valid_list = options.get("valid", "data/train.list")
    labels = _labels(options)
    topk = find_value(argv, "-topk", int(options.get("top", 1)), int)
    spec, _, net = _network(cfg, weights, device)
    params = [dict(layer.named_buffers()) for layer in net.layers]
    size = spec.net.w
    nets: dict[tuple[int, int], Network] = {}

    def net_for(w: int, h: int):
        if (w, h) not in nets:
            nets[(w, h)] = Network(spec.resize(w, h), params)
        return nets[(w, h)]

    with open(valid_list) as f:
        paths = [l.strip() for l in f if l.strip()]
    avg_acc = avg_topk = 0.0
    for i, path in enumerate(paths):
        truth = _class_of_path(path, labels)
        img = load_image_rgb(path)
        ih, iw = img.shape[:2]
        # resize_min (image.c): short side -> net.w, keep aspect
        scale = size / min(iw, ih)
        nw = max(32, int(round(iw * scale / 32)) * 32)
        nh = max(32, int(round(ih * scale / 32)) * 32)
        x = resize_image_np(img, nw, nh)[None]
        pred = _forward(net_for(nw, nh), x, device)[0][0, :len(labels)]
        order = np.argsort(-pred)[:topk]
        avg_acc += int(order[0] == truth)
        avg_topk += int(truth in order)
        print(f"{i}: top 1: {avg_acc/(i+1):f}, top {topk}: "
              f"{avg_topk/(i+1):f}")
    n = max(len(paths), 1)
    return avg_acc / n, avg_topk / n


def _demo_frames(argv: list[str]):
    """Frame source for the camera demos: -file <dir|glob|image>."""
    import glob as _glob
    from ..ops.image import load_image_rgb
    src = find_value(argv, "-file", None)
    if src is None:
        raise SystemExit("no camera here: pass -file <dir-or-glob> "
                         "of frames")
    if os.path.isdir(src):
        paths = sorted(_glob.glob(os.path.join(src, "*")))
    else:
        paths = sorted(_glob.glob(src)) or [src]
    for p in paths:
        yield load_image_rgb(p)


def threat_classifier(data_cfg: str, cfg: str, weights: str,
                      argv: list[str], frames=None, out=None, *,
                      device="cuda"):
    """threat_classifier (classifier.c:844-975): rolling threat meter
    over a frame stream — threat = 0.2*curr + 0.8*prev with curr =
    0.6*p[1] + p[2]; the reference's on-frame meter becomes a text
    gauge with the same .57/.97 warning thresholds."""
    import sys as _sys
    from ..infer.classifier import Classifier
    out = out or _sys.stdout
    options = read_data_cfg(data_cfg) if data_cfg else {}
    labels = read_names(options["names"]) if "names" in options else None
    top = int(options.get("top", 1))
    clf = Classifier(cfg, weights, names=labels, device=device)
    threat, roll = 0.0, 0.2
    history = []
    for img in (frames if frames is not None else _demo_frames(argv)):
        pred = clf.predict(img)
        curr = float(pred[1] * .6 + pred[2]) if len(pred) > 2 else \
            float(pred.max())
        threat = roll * curr + (1 - roll) * threat
        gauge = "#" * int(threat * 40)
        warn = " !!!" if threat > .97 else (" !" if threat > .57 else "")
        out.write(f"threat {threat:5.2f} |{gauge:<40}|{warn}\n")
        order = np.argsort(-pred)[:top]
        for ix in order:
            name = labels[ix] if labels and ix < len(labels) else str(ix)
            out.write(f"{100*pred[ix]:.1f}%: {name}\n")
        history.append(threat)
    return history


# gun_classifier's hardcoded ImageNet-22k "threatening" category ids
# (classifier.c:977: bad_cats[])
BAD_CATS = (218, 539, 540, 1213, 1501, 1742, 1911, 2415, 4348, 19223,
            368, 369, 370, 1133, 1200, 1306, 2122, 2301, 2537, 2823,
            3179, 3596, 3639, 4489, 5107, 5140, 5289, 6240, 6631, 6762,
            7048, 7171, 7969, 7984, 7989, 8824, 8927, 9915, 10270,
            10448, 13401, 15205, 18358, 18894, 18895, 19249, 19697)


def gun_classifier(data_cfg: str, cfg: str, weights: str,
                   argv: list[str], frames=None, out=None, *,
                   device="cuda"):
    """gun_classifier (classifier.c:977-1054): flags a frame when any
    bad-category probability exceeds 0.01."""
    import sys as _sys
    from ..infer.classifier import Classifier
    out = out or _sys.stdout
    options = read_data_cfg(data_cfg) if data_cfg else {}
    labels = read_names(options["names"]) if "names" in options else None
    clf = Classifier(cfg, weights, names=labels, device=device)
    flagged = []
    for img in (frames if frames is not None else _demo_frames(argv)):
        pred = clf.predict(img)
        cats = [i for i in BAD_CATS if i < len(pred) and pred[i] > .01]
        if cats:
            out.write("Threat Detected!\n")
            for i in cats:
                name = labels[i] if labels and i < len(labels) else str(i)
                out.write(f"{name}\n")
        else:
            out.write("Scanning...\n")
        flagged.append(bool(cats))
    return flagged


def validate_classifier_10(data_cfg: str, cfg: str, weights: str,
                           argv: list[str], *, device="cuda"):
    """validate_classifier_10 (classifier.c:336-404): 10-crop eval —
    stretch-load at (w+32, h+32), 4 corner + 1 center crops of the
    image and its horizontal flip, predictions summed; the 10 crops go
    through one batched forward."""
    from ..infer.classifier import Classifier
    from ..ops.image import load_image_rgb, resize_image_np, crop_image_np

    options = read_data_cfg(data_cfg)
    valid_list = options.get("valid", "data/train.list")
    labels = _labels(options)
    topk = find_value(argv, "-topk", int(options.get("top", 1)), int)
    clf = Classifier(cfg, weights, names=labels, device=device)
    w, h, shift = clf.spec.net.w, clf.spec.net.h, 32

    with open(valid_list) as f:
        paths = [l.strip() for l in f if l.strip()]
    avg_acc = avg_topk = 0.0
    for i, path in enumerate(paths):
        truth = _class_of_path(path, labels)
        im = resize_image_np(load_image_rgb(path), w + shift, h + shift)
        corners = [(-shift, -shift), (shift, -shift), (0, 0),
                   (-shift, shift), (shift, shift)]
        crops = [crop_image_np(im, dx, dy, w, h) for dx, dy in corners]
        flipped = im[:, ::-1, :]
        crops += [crop_image_np(flipped, dx, dy, w, h)
                  for dx, dy in corners]
        pred = clf.predict_batch(np.stack(crops)).float().cpu().numpy()
        pred = pred.reshape(10, -1)[:, :len(labels)].sum(axis=0)
        order = np.argsort(-pred)[:topk]
        avg_acc += int(order[0] == truth)
        avg_topk += int(truth in order)
        print(f"{i}: top 1: {avg_acc/(i+1):f}, top {topk}: "
              f"{avg_topk/(i+1):f}")
    n = max(len(paths), 1)
    return avg_acc / n, avg_topk / n


# try_classifier's hardcoded ImageNet stats (classifier.c:629-630)
_TRY_MEAN = np.array([0.48263312050943, 0.45230225481413,
                      0.40099074308742], np.float32)
_TRY_STD = np.array([0.22590347483426, 0.22120921437787,
                     0.22103996251583], np.float32)


def try_classifier(data_cfg: str, cfg: str, weights: str, image: str,
                   argv: list[str], out=None, *, device="cuda"):
    """try_classifier (classifier.c:595-675): debug mode — resize_min
    256, center-crop 224 at the reference's off-by-one offset,
    normalize with hardcoded ImageNet mean/std, print layer
    `-layer N`'s BN rolling stats and activations, then top-k."""
    import sys as _sys
    from ..graph import spec as S
    from ..ops.image import load_image_rgb, resize_min_np, crop_image_np

    out = out or _sys.stdout
    layer_num = find_value(argv, "-layer", -1, int)
    options = read_data_cfg(data_cfg) if data_cfg else {}
    names = read_names(options["names"]) if "names" in options else (
        read_names(options["labels"]) if "labels" in options else None)
    top = find_value(argv, "-topk", int(options.get("top", 1)), int)
    spec, params, net = _network(cfg, weights, device)

    r = resize_min_np(load_image_rgb(image), 256)
    ih, iw = r.shape[:2]
    im = crop_image_np(r, (iw - 224 - 1) // 2 + 1,
                       (ih - 224 - 1) // 2 + 1, 224, 224)
    im = (im - _TRY_MEAN) / (_TRY_STD + 1e-6)     # normalize_cpu eps
    pred, aux = _forward(net, im[None], device)
    pred = pred.reshape(-1)

    if 0 <= layer_num < len(spec.layers):
        lp = params[layer_num] if layer_num < len(params) else None
        if isinstance(spec.layers[layer_num], S.ConvSpec) and lp and \
                "rolling_mean" in lp:
            for mu, var, sc in zip(np.asarray(lp["rolling_mean"]),
                                   np.asarray(lp["rolling_variance"]),
                                   np.asarray(lp["scales"])):
                out.write(f"{mu:f} {var:f} {sc:f}\n")
        act = aux["outputs"].get(layer_num)
        if act is not None:
            for v in act.float().cpu().numpy().reshape(-1):
                out.write(f"{v:f}\n")
    for ix in np.argsort(-pred)[:top]:
        name = names[ix] if names and ix < len(names) else str(ix)
        out.write(f"{name}: {pred[ix]:f}\n")
    return pred


def test_classifier(data_cfg: str, cfg: str, weights: str,
                    argv: list[str], out=None, *, device="cuda"):
    """test_classifier (classifier.c:771-842): batched plain-resize
    forward over the `test` list, one TSV row per image
    (path\\tpred...), one batched forward per ``-batch`` images (default
    the net's batch)."""
    import sys as _sys
    from ..ops.image import load_image_rgb, resize_image_np

    out = out or _sys.stdout
    options = read_data_cfg(data_cfg)
    test_list = options.get("test", "data/test.list")
    batch = find_value(argv, "-batch", 0, int) or None
    spec, _, net = _network(cfg, weights, device)
    batch = batch or max(spec.net.batch, 1)

    with open(test_list) as f:
        paths = [l.strip() for l in f if l.strip()]
    for off in range(0, len(paths), batch):
        chunk = paths[off:off + batch]
        x = np.stack([resize_image_np(load_image_rgb(p),
                                      spec.net.w, spec.net.h)
                      for p in chunk])
        pred = _forward(net, x, device)[0]
        for p, row in zip(chunk, pred):
            out.write(p + "".join(f"\t{v:g}" for v in row) + "\n")
    return len(paths)


def label_classifier(data_cfg: str, cfg: str, weights: str,
                     argv: list[str], out=None, *, device="cuda"):
    """label_classifier (classifier.c:732-769): print the argmax label
    name for each image in the `test` list (resize_min + center crop)."""
    import sys as _sys
    from ..infer.classifier import Classifier
    from ..ops.image import load_image_rgb, resize_min_np, crop_image_np

    out = out or _sys.stdout
    options = read_data_cfg(data_cfg)
    label_list = options.get("names", options.get("labels"))
    test_list = options.get("test", "data/train.list")
    labels = read_names(label_list)
    clf = Classifier(cfg, weights, names=labels, device=device)
    w, h = clf.spec.net.w, clf.spec.net.h

    with open(test_list) as f:
        paths = [l.strip() for l in f if l.strip()]
    picked = []
    for path in paths:
        r = resize_min_np(load_image_rgb(path), w)
        ih, iw = r.shape[:2]
        crop = crop_image_np(r, (iw - w) // 2, (ih - h) // 2, w, h)
        pred = clf.predict_batch(crop[None]).float().cpu().numpy()
        ind = int(np.argmax(pred.reshape(-1)[:len(labels)]))
        out.write(labels[ind] + "\n")
        picked.append(labels[ind])
    return picked


def demo_classifier(data_cfg: str, cfg: str, weights: str,
                    argv: list[str], frames=None, out=None, *,
                    device="cuda"):
    """demo_classifier (classifier.c:1056-1122): streaming top-k over
    frames (-file dir/glob instead of a webcam) with an FPS readout."""
    import sys as _sys
    from ..infer.classifier import Classifier
    from ..ops.image import resize_image_np

    out = out or _sys.stdout
    options = read_data_cfg(data_cfg) if data_cfg else {}
    names = read_names(options["names"]) if "names" in options else None
    top = find_value(argv, "-topk", int(options.get("top", 1)), int)
    clf = Classifier(cfg, weights, names=names, device=device)
    w, h = clf.spec.net.w, clf.spec.net.h
    fps = 0.0
    results = []
    for img in (frames if frames is not None else _demo_frames(argv)):
        t0 = time.time()
        x = resize_image_np(img, w, h)
        pred = clf.predict_batch(x[None]).float().cpu().numpy().reshape(-1)
        dt = max(time.time() - t0, 1e-6)
        fps = 0.9 * fps + 0.1 / dt if fps else 1 / dt
        out.write(f"FPS:{fps:.0f}\n")
        order = np.argsort(-pred)[:top]
        for ix in order:
            name = names[ix] if names and ix < len(names) else str(ix)
            out.write(f"{100*pred[ix]:.1f}%: {name}\n")
        results.append(int(order[0]))
    return results


__all__ = ["run_classifier", "train_classifier", "validate_classifier",
           "validate_classifier_multi", "validate_classifier_crop",
           "validate_classifier_full", "validate_classifier_10",
           "predict_classifier", "try_classifier", "test_classifier",
           "label_classifier", "demo_classifier", "threat_classifier",
           "gun_classifier", "BAD_CATS"]
