"""The port's classifier training apps against the JAX package's on the
CPU: ``classifier train -cpu`` (apps/classifier_app.py) and the
``cifar`` command (apps/cifar_app.py) through ``cli.main`` against the
JAX ``train_classifier`` and ``run_cifar`` on the same cfg and data, the
``.weights`` they write within 1e-4 and the printed results the same;
the XNOR weight pack round trip on the port's io/weights; the train
state checkpoint of every classifier kind through io/checkpoint.py.
"""

import re

import numpy as np
import pytest
import torch

import sr_object_detection_tpu.apps.cifar_app as JC
import sr_object_detection_tpu.apps.classifier_app as JA
import sr_object_detection_tpu.io.weights as JW
import sr_object_detection_tpu_torch.io.weights as TW
from sr_object_detection_tpu_torch.apps import cli as TCLI
from sr_object_detection_tpu_torch.graph.spec import parse_network_cfg
from sr_object_detection_tpu_torch.io import checkpoint as TCK
from sr_object_detection_tpu_torch.io.convert import params_to_numpy

LABELS = ["dark", "lite"]

CLS_CFG = """\
[net]
batch=4
subdivisions={subdivisions}
height=16
width=16
channels=3
momentum=0.9
decay=0.0005
learning_rate=0.1
max_batches={max_batches}
policy=constant
min_crop=12
max_crop=24
hue=.1
saturation=1.5
exposure=1.5

[convolutional]
filters=8
size=3
stride=1
pad=1
batch_normalize=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
filters={classes}
size=1
stride=1
pad=1
activation=linear

[avgpool]

[softmax]
groups=1

[cost]
type=sse
"""


def _weights_close(spec, a, b, tol=1e-4):
    pa, sa = TW.load_weights(spec, a)
    pb, sb = TW.load_weights(spec, b)
    assert sa == sb
    for i, (x, y) in enumerate(zip(pa, pb)):
        for k in x:
            np.testing.assert_allclose(x[k], y[k], rtol=tol, atol=tol,
                                       err_msg=f"layer {i} {k}")
    return sa


@pytest.fixture(scope="module")
def cls_set(tmp_path_factory):
    """(tmp dir, list file, labels file): 8 seeded 20-40 px PPMs, the
    class name in each path, brightness by class."""
    tmp = tmp_path_factory.mktemp("cls_train")
    rng = np.random.default_rng(31)
    paths = []
    for i in range(8):
        h, w = (int(v) for v in rng.integers(20, 41, 2))
        level = (i % 2 + 1) / 3
        img = np.clip(level + rng.normal(0, .1, (h, w, 3)), 0, 1)
        p = tmp / f"{LABELS[i % 2]}_{i}.ppm"
        p.write_bytes(f"P6\n{w} {h}\n255\n".encode()
                      + (img * 255).astype(np.uint8).tobytes())
        paths.append(str(p))
    lst = tmp / "train.list"
    lst.write_text("\n".join(paths) + "\n")
    labels = tmp / "labels.list"
    labels.write_text("\n".join(LABELS) + "\n")
    return tmp, str(lst), str(labels)


@pytest.mark.parametrize("subdivisions", [1, 2])
def test_classifier_train_matches_jax(cls_set, subdivisions, capsys):
    """`classifier train -cpu` and the JAX train_classifier from the same
    seeded .weights over the same list (the loaders' draws are equal):
    3 iterations each, the same loss lines, <cfg>.weights within 1e-4
    with seen 12; then both resume from it without -clear for one more
    iteration (seen 16), and the port with -clear restarts at seen 0."""
    tmp, lst, labels = cls_set
    d = tmp / f"s{subdivisions}"
    d.mkdir()
    cfg = d / "toy.cfg"
    cfg.write_text(CLS_CFG.format(subdivisions=subdivisions, max_batches=3,
                                  classes=2))
    spec = parse_network_cfg(str(cfg))
    w0 = d / "init.weights"
    TW.save_weights(spec, TW.init_params(spec, seed=5), str(w0))
    out = {}
    for who in ("jax", "port"):
        data = d / f"{who}.data"
        data.write_text(f"train={lst}\nlabels={labels}\n"
                        f"backup={d / who}\n")
        if who == "jax":
            JA.train_classifier(str(data), str(cfg), str(w0), [])
        else:
            assert TCLI.main(["classifier", "train", str(data), str(cfg),
                              str(w0), "-cpu"]) == 0
        out[who] = capsys.readouterr().out
    lines = {k: [re.sub(r", [\d.]+ s$", "", l) for l in v.splitlines()]
             for k, v in out.items()}
    assert len(lines["port"]) == 3
    assert [l.split(":")[0] for l in lines["port"]] == ["1", "2", "3"]
    for a, b in zip(lines["port"], lines["jax"]):
        np.testing.assert_allclose(
            [float(v) for v in re.findall(r"[\d.]+", a.split(":", 1)[1])],
            [float(v) for v in re.findall(r"[\d.]+", b.split(":", 1)[1])],
            rtol=1e-4)
    assert _weights_close(spec, str(d / "jax" / "toy.weights"),
                          str(d / "port" / "toy.weights")) == 12
    # resume: seen 12 -> one more iteration up to max_batches 4
    cfg.write_text(CLS_CFG.format(subdivisions=subdivisions, max_batches=4,
                                  classes=2))
    w1 = d / "port" / "toy.weights"
    data = d / "port.data"
    assert TCLI.main(["classifier", "train", str(data), str(cfg), str(w1),
                      "-cpu"]) == 0
    assert capsys.readouterr().out.startswith("4: ")
    assert TW.load_weights(spec, str(w1))[1] == 16
    assert TCLI.main(["classifier", "train", str(data), str(cfg), str(w1),
                      "-cpu", "-clear"]) == 0
    assert len(capsys.readouterr().out.splitlines()) == 4


CIFAR_CFG = """\
[net]
batch=4
subdivisions=1
height=32
width=32
channels=3
momentum=0.9
decay=0.0005
learning_rate=0.1
max_batches=3
policy=constant

[convolutional]
filters=8
size=3
stride=2
pad=1
batch_normalize=1
activation=leaky

[convolutional]
filters=10
size=1
stride=1
pad=1
activation=linear

[avgpool]

[softmax]
groups=1

[cost]
type=sse
"""


@pytest.fixture(scope="module")
def cifar(tmp_path_factory):
    """(dir, cfg, seeded .weights): two training binaries of 6 records
    and a test binary of 5, records of a label byte and 3072 CHW bytes."""
    tmp = tmp_path_factory.mktemp("cifar")
    rng = np.random.default_rng(32)
    data = tmp / "data"
    data.mkdir()
    for name, n in (("data_batch_1.bin", 6), ("data_batch_2.bin", 6),
                    ("test_batch.bin", 5)):
        rec = np.concatenate([rng.integers(0, 10, (n, 1)),
                              rng.integers(0, 256, (n, 3072))], 1)
        rec.astype(np.uint8).tofile(data / name)
    cfg = tmp / "cifar_small.cfg"
    cfg.write_text(CIFAR_CFG)
    spec = parse_network_cfg(str(cfg))
    w = tmp / "init.weights"
    TW.save_weights(spec, TW.init_params(spec, seed=6), str(w))
    return tmp, str(data), str(cfg), str(w)


def test_cifar_train_and_test_match_jax(cifar, capsys):
    """`cifar train`, `cifar distill` and `cifar test` through the port's
    cli.main with -cpu against the JAX run_cifar: the .weights within
    1e-4 (seen 12), the test's top-1 line the same."""
    tmp, data, cfg, w = cifar
    spec = parse_network_cfg(cfg)
    soft = tmp / "soft.csv"
    np.savetxt(soft, np.random.default_rng(33).dirichlet(np.ones(10), 12),
               delimiter=",")
    for sub in ("train", "distill"):
        extra = ["-csv", str(soft)] if sub == "distill" else []
        JC.run_cifar([sub, cfg, w, "-data", data, "-backup",
                      str(tmp / f"j_{sub}")] + extra)
        assert TCLI.main(["cifar", sub, cfg, w, "-data", data, "-backup",
                          str(tmp / f"t_{sub}"), "-cpu"] + extra) == 0
        assert _weights_close(spec, str(tmp / f"j_{sub}" / "cifar_small"
                                        ".weights"),
                              str(tmp / f"t_{sub}" / "cifar_small.weights")
                              ) == 12
    capsys.readouterr()
    trained = str(tmp / "t_train" / "cifar_small.weights")
    JC.run_cifar(["test", cfg, trained, "-data", data])
    ref = capsys.readouterr().out
    assert TCLI.main(["cifar", "test", cfg, trained, "-data", data,
                      "-cpu"]) == 0
    assert capsys.readouterr().out == ref
    assert ref.startswith("top-1 accuracy: ")


@pytest.mark.parametrize("mode", ["multi", "csv", "csvtrain"])
def test_cifar_forward_modes_match_jax(cifar, mode, capsys):
    """`cifar multi|csv|csvtrain` on the seeded weights: the same lines
    (numbers within 1e-5) and the same accuracy on stderr."""
    _, data, cfg, w = cifar
    JC.run_cifar([mode, cfg, w, "-data", data])
    ref = capsys.readouterr()
    assert TCLI.main(["cifar", mode, cfg, w, "-data", data, "-cpu"]) == 0
    got = capsys.readouterr()
    assert got.err == ref.err
    g, r = got.out.splitlines(), ref.out.splitlines()
    assert len(g) == len(r) and g
    for a, b in zip(g, r):
        np.testing.assert_allclose(
            [float(v) for v in re.findall(r"-?[\d.]+(?:e-?\d+)?", a)],
            [float(v) for v in re.findall(r"-?[\d.]+(?:e-?\d+)?", b)],
            rtol=1e-5, atol=1e-7)


def test_cifar_eval_and_extract_match_jax(cifar, capsys):
    """`cifar eval` scores a CSV as the JAX command does; `cifar extract`
    writes the same file names and bytes."""
    tmp, data, _, _ = cifar
    csv = tmp / "pred.csv"
    np.savetxt(csv, np.random.default_rng(34).uniform(0, 1, (5, 10)),
               delimiter=",")
    JC.run_cifar(["eval", "-data", data, "-csv", str(csv)])
    ref = capsys.readouterr().err
    assert TCLI.main(["cifar", "eval", "-data", data, "-csv", str(csv)]) == 0
    assert capsys.readouterr().err == ref
    JC.run_cifar(["extract", "-data", data, "-out", str(tmp / "jx")])
    TCLI.main(["cifar", "extract", "-data", data, "-out", str(tmp / "tx")])
    names = sorted(p.relative_to(tmp / "jx") for p in
                   (tmp / "jx").rglob("*.ppm"))
    assert len(names) == 17
    assert names == sorted(p.relative_to(tmp / "tx") for p in
                           (tmp / "tx").rglob("*.ppm"))
    for n in names:
        assert (tmp / "jx" / n).read_bytes() == (tmp / "tx" / n).read_bytes()


def test_xnor_binary_weights_pack_roundtrip():
    """The bit-packed XNOR conv weights of tests/test_data_eval.py:161 on
    the port's io/weights: the same bytes as the JAX package's pack, and
    unpacking gives sign(w) * mean(|w|) per filter with the size//8
    truncation quirk."""
    import io as _io
    from sr_object_detection_tpu_torch.graph import spec as S
    rng = np.random.default_rng(0)
    spec = S.ConvSpec(index=0, filters=4, size=3, c=3, batch_normalize=True)
    p = {"weights": rng.normal(0, 0.1, (3, 3, 3, 4)).astype(np.float32),
         "biases": rng.normal(0, 1, 4).astype(np.float32),
         "scales": np.ones(4, np.float32),
         "rolling_mean": np.zeros(4, np.float32),
         "rolling_variance": np.ones(4, np.float32)}
    blob = TW.pack_binary_conv(p, batch_normalize=True)
    assert blob == JW.pack_binary_conv(p, batch_normalize=True)
    got = TW.unpack_binary_conv(TW.WeightsReader(_io.BytesIO(blob)), spec,
                                batch_normalize=True)
    np.testing.assert_array_equal(got["biases"], p["biases"])
    flat = np.transpose(p["weights"], (3, 2, 0, 1)).reshape(4, 27)
    gflat = np.transpose(got["weights"], (3, 2, 0, 1)).reshape(4, 27)
    mean = np.mean(np.abs(flat), axis=1, keepdims=True)
    want = np.where(flat > 0, mean, -mean).astype(np.float32)
    np.testing.assert_allclose(gflat[:, :24], want[:, :24], rtol=1e-6)
    np.testing.assert_array_equal(gflat[:, 24:], 0)


def test_train_state_checkpoint_every_kind(tmp_path):
    """A Trainer's state on the all-kinds net (connected + BN, batchnorm,
    local, deconv, XNOR conv) through save_train_state / load_train_state
    with the spec: params and velocities come back equal and in the JAX
    package's layout (the npz holds what params_to_numpy gives)."""
    from sr_object_detection_tpu_torch.config import parse_cfg_text
    from sr_object_detection_tpu_torch.graph import spec as S
    from sr_object_detection_tpu_torch.train.trainer import Trainer
    from torch_parity import all_kinds_text, classifier_params
    spec = S.build_network_spec(parse_cfg_text(all_kinds_text(4, 1)))
    tr = Trainer(spec, params=classifier_params(spec, 3), device="cpu")
    rng = np.random.default_rng(1)
    tr.step(rng.uniform(0, 1, (4, 12, 12, 3)).astype(np.float32),
            rng.uniform(0, 1, (4, 156)).astype(np.float32))
    path = str(tmp_path / "s.npz")
    TCK.save_train_state(path, tr.state, spec)
    z = np.load(path)
    for tag, tree in (("p", tr.state.params), ("v", tr.state.velocity)):
        for i, p in enumerate(params_to_numpy(spec, tree)):
            for k, v in p.items():
                np.testing.assert_array_equal(z[f"{tag}/{i}/{k}"], v)
    back = TCK.load_train_state(path, tr.state, spec)
    assert int(back.seen) == 4
    for a, b in ((back.params, tr.state.params),
                 (back.velocity, tr.state.velocity)):
        for p, q in zip(a, b):
            assert p.keys() == q.keys()
            assert all(torch.equal(p[k], q[k]) for k in p)
