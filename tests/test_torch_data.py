"""The port's from-disk input path against the JAX package's: the batched
device augmentation (against JAX's gather form and the host pipeline),
the packed dataset's files, the packed loader's and the
device-augmenting ``DetectionLoader``'s batches for one seed (the process
decoder and the shard ranges included), and `cli detector train
-packed` / `-device-aug` on the CPU.

On the CPU the augmentation runs the same torch ops it runs on the card;
tests/test_device_aug.py's gate, 2e-6, holds it to the host pipeline.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr_object_detection_tpu.data import augment as JA
from sr_object_detection_tpu.data import device_aug as JDA
from sr_object_detection_tpu.data.loader import DetectionLoader as JLoader
from sr_object_detection_tpu.data.packed import (
    PackedDetectionLoader as JPacked, pack_detection_dataset as j_pack)
from sr_object_detection_tpu.ops.image import resize_image_np
from sr_object_detection_tpu_torch.apps import cli as TCLI
from sr_object_detection_tpu_torch.config import parse_cfg_text
from sr_object_detection_tpu_torch.data import device_aug as DA
from sr_object_detection_tpu_torch.data.loader import DetectionLoader
from sr_object_detection_tpu_torch.data.packed import (
    PackedDetectionLoader, pack_detection_dataset)
from sr_object_detection_tpu_torch.graph import spec as S
from sr_object_detection_tpu_torch.io.weights import (init_params,
                                                      load_weights)
from torch_parity import train_cfg_text, write_ppm_dataset

AUG = dict(jitter=0.3, hue=0.1, saturation=1.5, exposure=1.5)


def _host_pipeline(img_u8, p, w, h):
    """tests/test_device_aug.py's host pipeline (augment.py, image.py)."""
    im = img_u8.astype(np.float32) / 255.0
    crop = JA.crop_image(im, p["pleft"], p["ptop"], p["swidth"],
                         p["sheight"])
    sized = resize_image_np(crop, w, h)
    if p["flip"]:
        sized = JA.flip_horizontal(sized)
    if p["do_distort"]:
        sized = JA.distort_image(sized, p["dhue"], p["dsat"], p["dexp"])
    return sized


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_augmenter_matches_jax_and_host(seed):
    rng = np.random.default_rng(seed)
    w, h = 64, 48
    imgs, params = [], []
    for _ in range(5):
        oh, ow = int(rng.integers(40, 120)), int(rng.integers(40, 120))
        imgs.append(rng.integers(0, 256, (oh, ow, 3)).astype(np.uint8))
        params.append(DA.draw_params(rng, oh, ow, **AUG)[0])
    params[0]["do_distort"] = False        # the undistorted branch too
    aug = DA.DeviceAugmenter(w, h, device="cpu")
    canvas, cols = DA.stack_batch(aug, imgs, params)
    out = aug(canvas, cols)
    assert out.shape == (5, h, w, 3) and out.dtype == torch.float32
    out = out.numpy()
    jaug = JDA.DeviceAugmenter(w, h, resample="gather")
    jc = np.zeros((5, JDA._bucket(canvas.shape[1]),
                   JDA._bucket(canvas.shape[2]), 3), np.uint8)
    jc[:, :canvas.shape[1], :canvas.shape[2]] = canvas
    jcoefs = [jaug.coeffs(p) for p in params]
    jout = np.asarray(jaug(jc, {k: np.stack([c[k] for c in jcoefs])
                                for k in jcoefs[0]}))
    np.testing.assert_allclose(out, jout, atol=2e-6)
    for b in range(5):
        np.testing.assert_allclose(out[b], _host_pipeline(imgs[b], params[b],
                                                          w, h),
                                   atol=2e-6, err_msg=f"image {b}")
    bf = DA.DeviceAugmenter(w, h, device="cpu", out_dtype=torch.bfloat16)
    assert torch.equal(bf(canvas, cols), torch.from_numpy(out).to(
        torch.bfloat16))


def test_device_augmenter_no_augment_is_plain_resize():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (50, 70, 3)).astype(np.uint8)
    p, xf = DA.draw_params(rng, 50, 70, augment=False, **AUG)
    assert xf == (0.0, 0.0, 1.0, 1.0, False)
    aug = DA.DeviceAugmenter(32, 32, device="cpu")
    out = aug(*DA.stack_batch(aug, [img], [p]))[0].numpy()
    ref = resize_image_np(img.astype(np.float32) / 255.0, 32, 32)
    np.testing.assert_allclose(out, ref, atol=2e-6)


def _dataset(tmp_path):
    """Seven PPM frames in two sizes, each with 1-3 labels and a sliver
    (h < 0.01, which the loaders skip). Returns (list file, paths)."""
    paths = []
    for sub, n, w, h, seed in (("a", 4, 80, 60, 4), ("b", 3, 70, 90, 5)):
        lst = write_ppm_dataset(tmp_path / sub, n, w=w, h=h, seed=seed)
        paths += open(lst).read().split()
    for i, p in enumerate(paths):
        lab = p.replace("images", "labels").rsplit(".", 1)[0] + ".txt"
        with open(lab, "a") as f:
            f.write(f"{i % 3} 0.25 0.25 0.2 0.005\n")
    lst = tmp_path / "all.list"
    lst.write_text("\n".join(paths) + "\n")
    return str(lst), paths


def test_pack_files_byte_equal_jax(tmp_path):
    lst, _ = _dataset(tmp_path)
    hdr = pack_detection_dataset(lst, str(tmp_path / "t"), store_w=72,
                                 store_h=56, quiet=True)
    jhdr = j_pack(lst, str(tmp_path / "j"), store_w=72, store_h=56,
                  quiet=True)
    assert hdr == jhdr == json.load(open(tmp_path / "t.json"))
    for ext in (".imgs", ".labs", ".json"):
        assert (tmp_path / f"t{ext}").read_bytes() == \
            (tmp_path / f"j{ext}").read_bytes(), ext


def _bf16_close(got, want):
    """bf16 batches from float32 values within 2e-6 of each other: equal,
    or one bf16 step apart where the two roundings straddle a boundary."""
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    step = np.abs(want) * 2.0 ** -7 + 1e-30
    assert (np.abs(got - want) <= step).all()
    assert (got == want).mean() > 0.99


def test_packed_loader_matches_jax(tmp_path):
    lst, _ = _dataset(tmp_path)
    prefix = str(tmp_path / "p")
    pack_detection_dataset(lst, prefix, store_w=72, store_h=56, quiet=True)
    kw = dict(w=64, h=48, batch=6, seed=5, **AUG)
    tl = PackedDetectionLoader(prefix, device="cpu",
                               out_dtype=torch.bfloat16, **kw)
    jl = JPacked(prefix, precision="exact", **kw)
    try:
        for _ in range(2):
            xt, tt = tl.next_batch()
            xj, tj = jl.next_batch()
            assert xt.dtype == torch.bfloat16 and xt.shape == xj.shape
            np.testing.assert_array_equal(tt, tj)
            _bf16_close(xt, xj)
            assert (tt[:, 0, 2] > 0).any()
        # a resize: the prefetched batch is redrawn at the new size (JAX's
        # redraw races its prefetch thread for the generator, so only the
        # shape is held to it here)
        tl.set_dims(80, 64)
        xt, tt = tl.next_batch()
        assert xt.shape == (6, 64, 80, 3) and tt.shape == (6, 30, 5)
        # the host side alone: same draws as JAX's from the same state
        jl.pool.shutdown(wait=True)
        tl.pool.shutdown(wait=True)
        jl.set_dims(80, 64)
        tl.rng = np.random.default_rng(9)
        jl.rng = np.random.default_rng(9)
        _, canvas, cols, truth, dims = tl._host_batch_cpu()
        _, jcanvas, jcols, jtruth, jdims = jl._host_batch_cpu()
        assert dims == jdims
        np.testing.assert_array_equal(canvas, jcanvas)
        np.testing.assert_array_equal(truth, jtruth)
        for k in cols:
            np.testing.assert_array_equal(cols[k], jcols[k], err_msg=k)
    finally:
        tl.close()


def test_packed_loader_float32_and_shards(tmp_path):
    lst, _ = _dataset(tmp_path)
    prefix = str(tmp_path / "p")
    pack_detection_dataset(lst, prefix, store_w=64, store_h=64, quiet=True)
    for i in range(3):
        t = PackedDetectionLoader(prefix, w=32, h=32, batch=2, device="cpu",
                                  process_index=i, process_count=3)
        j = JPacked(prefix, w=32, h=32, batch=2, process_index=i,
                    process_count=3)
        assert (t.lo, t.hi) == (j.lo, j.hi)
        t.close()
    tl = PackedDetectionLoader(prefix, w=32, h=32, batch=3, augment=False,
                               device="cpu", seed=0)
    x, _ = tl.next_batch()
    tl.close()
    assert x.dtype == torch.float32
    imgs = np.fromfile(prefix + ".imgs", np.uint8).reshape(7, 64, 64, 3)
    for b, i in enumerate(np.random.default_rng(0).integers(0, 7, size=3)):
        want = resize_image_np(imgs[i].astype(np.float32) / 255.0, 32, 32)
        np.testing.assert_allclose(x[b].numpy(), want, atol=2e-6)


@pytest.mark.parametrize("decoder", ["thread", "process"])
def test_device_augment_loader_matches_jax(tmp_path, decoder):
    """DetectionLoader(device_augment=True) against the JAX loader's for
    one seed (the JAX loader decodes on threads): the same truths, the
    frames within 2e-6; the shard ranges of two processes."""
    lst, paths = _dataset(tmp_path)
    kw = dict(w=48, h=40, batch=4, classes=20, seed=2, workers=2, **AUG)
    tl = DetectionLoader(lst, device_augment=True, decoder=decoder,
                         device="cpu", **kw)
    jl = JLoader(lst, device_augment=True, **kw)
    try:
        for step in range(2):
            if step == 1:
                tl.set_dims(64, 56)
                jl.set_dims(64, 56)
            xt, tt = tl.next_batch()
            xj, tj = jl.next_batch()
            assert isinstance(xt, torch.Tensor) and xt.shape == xj.shape
            np.testing.assert_array_equal(tt, tj)
            np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=2e-6)
    finally:
        tl.close()
        jl.pool.shutdown(wait=True)
    for i in range(2):
        t = DetectionLoader(paths, process_index=i, process_count=2,
                            **dict(kw, workers=1))
        assert t.paths == JLoader._shard_paths(paths, process_index=i,
                                               process_count=2)
        t.close()


@pytest.mark.parametrize("mode", ["packed", "device-aug"])
def test_cli_detector_train_from_disk_on_cpu(tmp_path, capsys, mode):
    """`detector train -packed <prefix> -device-aug` and `-device-aug
    -decoder process` with -cpu: two iterations on a 64x64 tiny-yolo-voc
    write <base>_final.weights, which loads back, moved, with its images
    seen."""
    g = np.load("tests/golden/tiny_yolo_voc.npz")
    cfg = tmp_path / "tiny64.cfg"
    cfg.write_text(train_cfg_text(bytes(g["cfg"]).decode(), size=64,
                                  batch=2, subdivisions=1, max_batches=2,
                                  random=0))
    lst = write_ppm_dataset(tmp_path / "voc", 4, w=80, h=60, seed=2)
    backup = tmp_path / "backup"
    data = tmp_path / "voc.data"
    data.write_text(f"classes=20\ntrain={lst}\nbackup={backup}\n")
    argv = ["detector", "train", str(data), str(cfg), "-cpu"]
    if mode == "packed":
        prefix = str(tmp_path / "voc-packed")
        pack_detection_dataset(lst, prefix, store_w=72, store_h=72,
                               quiet=True)
        argv += ["-packed", prefix, "-device-aug"]
    else:
        argv += ["-device-aug", "-decoder", "process"]
    TCLI.main(argv)
    out = capsys.readouterr().out
    assert "1: " in out and "2: " in out and "Resizing" not in out
    spec = S.build_network_spec(parse_cfg_text(cfg.read_text()))
    params, seen = load_weights(spec, str(backup / "tiny64_final.weights"))
    assert seen == 4
    init = init_params(spec, seed=0)
    assert not np.allclose(params[0]["weights"], init[0]["weights"])
