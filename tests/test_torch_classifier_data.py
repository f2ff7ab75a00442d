"""The port's classification data path (data/loader.py's
``ClassificationLoader``, ``load_classification_sample``,
``load_cifar10_batch`` and ``fill_hierarchy``) against the JAX package's
on the CPU: the same seed gives byte-equal batches with augmentation off
and on; the device-augmented batches within 2e-6 (tests/test_torch_data.py's
gate for ``DeviceAugmenter``); the hierarchy truths and the CIFAR-10
binary reader equal.
"""

import numpy as np
import pytest
import torch

from sr_object_detection_tpu.data import loader as JL
from sr_object_detection_tpu.io.tree import read_tree as j_read_tree
from sr_object_detection_tpu_torch.data import loader as TL
from sr_object_detection_tpu_torch.io.tree import read_tree

LABELS = ["cat", "dog", "owl"]


@pytest.fixture(scope="module")
def ppms(tmp_path_factory):
    """A list of 9 seeded PPMs of several sizes, the label in each name."""
    tmp = tmp_path_factory.mktemp("cls_data")
    rng = np.random.default_rng(21)
    paths = []
    for i in range(9):
        h, w = (int(v) for v in rng.integers(20, 49, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        p = tmp / f"{LABELS[i % 3]}_{i}.ppm"
        p.write_bytes(f"P6\n{w} {h}\n255\n".encode() + img.tobytes())
        paths.append(str(p))
    lst = tmp / "train.list"
    lst.write_text("\n".join(paths) + "\n")
    return str(lst)


AUG = dict(w=24, h=24, batch=5, min_crop=16, max_crop=40, hue=.1,
           saturation=1.5, exposure=1.5, seed=3, workers=2)


@pytest.mark.parametrize("augment", [False, True])
def test_classification_loader_matches_jax(ppms, augment):
    """Two batches of each loader from the same seed: images byte-equal
    (letterboxed without augmentation; square crop, flip and HSV distort
    with it) and the one-hot truths equal."""
    tl = TL.ClassificationLoader(ppms, LABELS, augment=augment, **AUG)
    jl = JL.ClassificationLoader(ppms, LABELS, augment=augment,
                                 process_index=0, process_count=1, **AUG)
    try:
        for _ in range(2):
            (xt, yt), (xj, yj) = tl.next_batch(), jl.next_batch()
            assert xt.dtype == xj.dtype == np.float32
            assert xt.shape == (5, 24, 24, 3)
            assert xt.tobytes() == xj.tobytes()
            np.testing.assert_array_equal(yt, yj)
            assert yt.sum(1).tolist() == [1.0] * 5
    finally:
        tl.close()
        jl.pool.shutdown(wait=True)


def test_device_augment_matches_jax(ppms):
    """ClassificationLoader(device_augment=True): the port's batch (a
    tensor on the CPU, its canvas the batch's largest frame) within 2e-6
    of the JAX device batch (its canvas padded to 128-multiples), the
    truths equal, over two batches."""
    tl = TL.ClassificationLoader(ppms, LABELS, device_augment=True,
                                 device="cpu", **AUG)
    jl = JL.ClassificationLoader(ppms, LABELS, device_augment=True,
                                 process_index=0, process_count=1, **AUG)
    try:
        for _ in range(2):
            (xt, yt), (xj, yj) = tl.next_batch(), jl.next_batch()
            assert isinstance(xt, torch.Tensor) and xt.dtype == torch.float32
            np.testing.assert_allclose(xt.numpy(), np.asarray(xj),
                                       atol=2e-6)
            np.testing.assert_array_equal(yt, yj)
    finally:
        tl.close()
        jl.pool.shutdown(wait=True)
    # bf16 out: the float32 batch rounded once
    bl = TL.ClassificationLoader(ppms, LABELS, device_augment=True,
                                 device="cpu", out_dtype=torch.bfloat16,
                                 **AUG)
    fl = TL.ClassificationLoader(ppms, LABELS, device_augment=True,
                                 device="cpu", **AUG)
    try:
        xb, xf = bl.next_batch()[0], fl.next_batch()[0]
        assert xb.dtype == torch.bfloat16
        assert torch.equal(xb, xf.to(torch.bfloat16))
    finally:
        bl.close()
        fl.close()


TREE = ("animal -1\nplant -1\ncat 0\ndog 0\nowl 0\noak 1\nfir 1\n"
        "tabby 2\nsiamese 2\n")


def test_fill_hierarchy_matches_jax(tmp_path):
    """fill_hierarchy on a seeded 3-level tree: every ancestor of the
    labelled classes set, the sibling groups without a positive masked
    with SECRET_NUM; equal to the JAX function's."""
    p = tmp_path / "t.tree"
    p.write_text(TREE)
    tree, jtree = read_tree(str(p)), j_read_tree(str(p))
    rng = np.random.default_rng(22)
    for _ in range(6):
        t = np.zeros(9, np.float32)
        t[rng.choice(9, int(rng.integers(1, 3)), replace=False)] = 1
        got = TL.fill_hierarchy(t, tree)
        np.testing.assert_array_equal(got, JL.fill_hierarchy(t, jtree))
        assert (got == TL.SECRET_NUM).any() or (got > 0).all()
    t = np.zeros(9, np.float32)
    t[7] = 1                                  # tabby
    got = TL.fill_hierarchy(t, tree)
    assert got[[0, 2, 7]].tolist() == [1, 1, 1]
    assert (got[[5, 6]] == TL.SECRET_NUM).all()   # oak, fir: no positive
    assert TL.SECRET_NUM == JL.SECRET_NUM


def test_load_cifar10_batch_matches_jax(tmp_path):
    """A seeded binary of 7 records (label byte + 3072 CHW bytes): NHWC
    pixels / 255 and one-hot labels, equal to the JAX reader's."""
    rng = np.random.default_rng(23)
    rec = np.concatenate([rng.integers(0, 10, (7, 1)),
                          rng.integers(0, 256, (7, 3072))], 1).astype(
                              np.uint8)
    p = tmp_path / "data_batch_1.bin"
    rec.tofile(p)
    x, y = TL.load_cifar10_batch(str(p))
    jx, jy = JL.load_cifar10_batch(str(p))
    assert x.shape == (7, 32, 32, 3) and y.shape == (7, 10)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    assert x[3, 5, 9, 2] == rec[3, 1 + 2 * 1024 + 5 * 32 + 9] / np.float32(
        255)
    assert y.argmax(1).tolist() == rec[:, 0].tolist()
