"""The small apps' training loops and compare's ranking modes in the port
(apps/misc_train.py, apps/compare_app.py) against the JAX package's, on
the CPU, through the port's CLI commands with -cpu, on the seeded toy
nets and image sets of tests/test_misc_train.py:

* the label fixups (captcha masking, tags, compare pairs) equal;
* `captcha`, `tag`, `writing`, `compare`, `vid`, `dice`, `super` and
  `voxel` train: per-step losses within 1e-4 relative over 3 steps, the
  .weights files of equal size; dice's step override of the learning
  rate; `dice valid` accuracies equal;
* `compare valid` accuracy, `compare sort` order and `compare battle`
  survivors equal, the elos within 1e-6, the logs' lines equal;
* `captcha test` and `captcha valid` rows within 1e-5.
"""

import io

import numpy as np
import pytest

from sr_object_detection_tpu.apps import compare_app as JC
from sr_object_detection_tpu.apps import misc_train as JT
from sr_object_detection_tpu_torch.apps import cli
from sr_object_detection_tpu_torch.apps import misc_train as TT
from test_misc_train import (CLS_CFG, EXT_CFG, RNN_CFG, SUPER_CFG,
                             WRITING_CFG, _compare_set, _image_set,
                             _toy_cfg, _write_ppm)

ITERS = 3


def _cfg(tmp_path, name, text):
    """The toy cfg, stopping after ITERS iterations (the CLI runs to the
    cfg's max_batches)."""
    import re
    return _toy_cfg(tmp_path, name, re.sub(r"max_batches=\d+",
                                           f"max_batches={ITERS}", text))


def _train_both(tmp_path, command, jax_fn, cfg, args):
    """(port losses, JAX losses): the JAX loop for ITERS iterations and
    the port's `<command> train` through the CLI, each backing up into
    its own directory; their .weights files have equal sizes."""
    import os
    want = jax_fn(cfg, None, args + ["-backup", str(tmp_path / "j")],
                  max_batches=ITERS)
    got = cli.COMMANDS[command](["train", cfg] + args + [
        "-backup", str(tmp_path / "t"), "-cpu"])
    base = os.path.splitext(os.path.basename(cfg))[0] + ".weights"
    assert (tmp_path / "t" / base).stat().st_size == \
        (tmp_path / "j" / base).stat().st_size
    assert len(got) == len(want) == ITERS and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    return got, want


def test_label_fixups_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    y = (rng.random((6, 8)) < 0.5).astype(np.float32)
    for mask in (True, False):
        np.testing.assert_array_equal(TT.fix_data_captcha(y, mask),
                                      JT.fix_data_captcha(y, mask))
    _, paths = _compare_set(tmp_path, n=6)
    for a, b in zip(paths, paths[1:] + paths[:1]):
        for classes in (1, 2):
            np.testing.assert_array_equal(
                TT.load_compare_labels(a, b, classes),
                JT.load_compare_labels(a, b, classes))
    lab = tmp_path / "labels" / "t.txt"
    lab.write_text("3\n1 x\n9\n")
    p = str(tmp_path / "imgs" / "t_iconl.jpeg")
    np.testing.assert_array_equal(TT.load_tags(p, 8), JT.load_tags(p, 8))
    assert TT.load_tags(p, 8).sum() == 2
    assert TT.SECRET_NUM == JT.SECRET_NUM


def test_captcha_train_matches_jax(tmp_path):
    names = ["ax", "ay", "bx", "by"]
    lst, _ = _image_set(tmp_path, names)
    labels = tmp_path / "labels.list"
    labels.write_text("\n".join(names) + "\n")
    cfg = _cfg(tmp_path, "cap.cfg", CLS_CFG.format(ch=3, out=4))
    _train_both(tmp_path, "captcha", JT.train_captcha, cfg,
                ["-list", lst, "-labels", str(labels)])


def test_tag_train_matches_jax(tmp_path):
    import os
    _, paths = _image_set(tmp_path, ["thing"], n_per=8)
    os.makedirs(tmp_path / "labels")
    tagged = []
    for i, p in enumerate(paths):
        q = p.replace(".ppm", "_iconl.jpeg.ppm")
        os.rename(p, q)
        tagged.append(q)
        with open(q.replace("imgs", "labels").replace("_iconl.jpeg",
                                                      ".txt"), "w") as f:
            f.write(f"{i % 4}\n{(i * 3) % 8}\n")
    lst = tmp_path / "tags.list"
    lst.write_text("\n".join(tagged) + "\n")
    cfg = _cfg(tmp_path, "tag.cfg", CLS_CFG.format(ch=3, out=8))
    _train_both(tmp_path, "tag", JT.train_tag, cfg, ["-list", str(lst)])


def test_writing_train_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    (tmp_path / "figs").mkdir()
    paths = []
    for k in range(6):
        img = rng.uniform(0, 1, (16, 16, 3)).astype(np.float32)
        p = tmp_path / "figs" / f"fig{k}.png.ppm"
        _write_ppm(p, img)
        _write_ppm(str(p).replace(".png", "-label.png"),
                   np.repeat((img.mean(-1) > 0.5)[..., None], 3, -1))
        paths.append(str(p))
    lst = tmp_path / "figures.list"
    lst.write_text("\n".join(paths) + "\n")
    cfg = _cfg(tmp_path, "writing.cfg", WRITING_CFG)
    _train_both(tmp_path, "writing", JT.train_writing, cfg,
                ["-list", str(lst)])


def test_compare_train_matches_jax(tmp_path):
    lst, _ = _compare_set(tmp_path, n=10, seed=4)
    cfg = _cfg(tmp_path, "cmp.cfg", CLS_CFG.format(ch=6, out=4))
    _train_both(tmp_path, "compare", JT.train_compare, cfg,
                ["-list", lst, "-classes", "2"])


def test_vid_train_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    vids = []
    for v in range(2):
        d = tmp_path / f"vid{v}"
        d.mkdir()
        base = rng.uniform(0, 1, (16, 16, 3)).astype(np.float32)
        for t in range(8):
            _write_ppm(d / f"f{t:03d}.ppm", np.clip(base + 0.03 * t, 0, 1))
        vids.append(str(d))
    lst = tmp_path / "vids.list"
    lst.write_text("\n".join(vids) + "\n")
    ext = _toy_cfg(tmp_path, "ext.cfg", EXT_CFG)
    cfg = _cfg(tmp_path, "vrnn.cfg", RNN_CFG)
    _train_both(tmp_path, "vid", JT.train_vid_rnn, cfg,
                ["-list", str(lst), "-extractor", ext])


def test_dice_train_and_valid_match_jax(tmp_path, capsys):
    lst, _ = _image_set(tmp_path, TT.DICE_LABELS, n_per=2)
    cfg = _cfg(tmp_path, "dice.cfg", CLS_CFG.format(ch=3, out=6))
    _train_both(tmp_path, "dice", JT.train_dice, cfg, ["-list", lst])
    weights = str(tmp_path / "t" / "dice.weights")
    capsys.readouterr()
    want = JT.validate_dice(cfg, weights, ["-list", lst])
    jax_out = capsys.readouterr().out
    got = cli.COMMANDS["dice"](["valid", cfg, weights, "-list", lst,
                                "-cpu"])
    assert got == want and capsys.readouterr().out == jax_out


def test_dice_lr_step_override(tmp_path, monkeypatch):
    """train_dice's schedule (dice.c:38: learning_rate *= .1 every 100
    iterations) is the step policy (100, 0.1) on the port's Trainer, as
    on JAX's: the rates at batch numbers across two steps are equal."""
    import sr_object_detection_tpu_torch.train.trainer as PT
    from sr_object_detection_tpu.train.sgd import learning_rate_py
    from sr_object_detection_tpu_torch.train.sgd import learning_rate
    made = []
    real = PT.Trainer

    def spy(spec, **kw):
        made.append(spec)
        return real(spec, **kw)
    monkeypatch.setattr(PT, "Trainer", spy)
    lst, _ = _image_set(tmp_path, TT.DICE_LABELS, n_per=1)
    cfg = _cfg(tmp_path, "d2.cfg", CLS_CFG.format(ch=3, out=6))
    TT.train_dice(cfg, None, ["-list", lst, "-backup", str(tmp_path)],
                  device="cpu")
    net = made[0].net
    assert (net.policy, net.step, net.scale) == ("step", 100, 0.1)
    for b in (0, 99, 100, 101, 250):
        assert learning_rate(net, b) == pytest.approx(
            learning_rate_py(net, b), rel=1e-6)
    assert learning_rate(net, 250) == pytest.approx(0.05 * .01, rel=1e-6)


@pytest.mark.parametrize("command", ["super", "voxel"])
def test_super_and_voxel_train_match_jax(tmp_path, command):
    rng = np.random.default_rng(5)
    (tmp_path / "imgs").mkdir()
    paths = []
    for k in range(4):
        p = tmp_path / "imgs" / f"im{k}.ppm"
        _write_ppm(p, rng.uniform(0, 1, (24, 24, 3)).astype(np.float32))
        paths.append(str(p))
    lst = tmp_path / "super.list"
    lst.write_text("\n".join(paths) + "\n")
    cfg = _cfg(tmp_path, "sup.cfg", SUPER_CFG)
    _train_both(tmp_path, command, JT.train_super, cfg,
                ["-list", str(lst), "-scale", "2"])
    assert TT.train_voxel is TT.train_super


@pytest.fixture(scope="module")
def compare_net(tmp_path_factory):
    """A seeded 16-image compare set and a comparator with seeded
    weights (BN statistics and biases non-trivial)."""
    from sr_object_detection_tpu_torch.graph import spec as S
    from sr_object_detection_tpu_torch.io.weights import (init_params,
                                                           save_weights)
    from torch_parity import random_bn
    root = tmp_path_factory.mktemp("compare")
    lst, paths = _compare_set(root, n=16)
    cfg = _toy_cfg(root, "cmp.cfg", CLS_CFG.format(ch=6, out=16))
    spec = S.parse_network_cfg(cfg)
    weights = root / "cmp.weights"
    save_weights(spec, random_bn(init_params(spec, seed=31), 32,
                                 head_gain=4.0), str(weights))
    return root, lst, paths, cfg, str(weights)


def test_compare_valid_and_sort_match_jax(compare_net, capsys):
    _, lst, paths, cfg, weights = compare_net
    capsys.readouterr()
    want = JC.validate_compare(cfg, weights, ["-list", lst, "-classes",
                                              "2"])
    jax_out = capsys.readouterr().out
    got = cli.COMMANDS["compare"](["valid", cfg, weights, "-list", lst,
                                   "-classes", "2", "-cpu"])
    assert got == want and capsys.readouterr().out == jax_out
    want = JC.sort_master(cfg, weights, ["-list", lst, "-class", "7"])
    jax_out = capsys.readouterr().out
    got = cli.COMMANDS["compare"](["sort", cfg, weights, "-list", lst,
                                   "-class", "7", "-cpu"])
    assert got == want and sorted(got) == sorted(paths)
    assert capsys.readouterr().out == jax_out


def test_compare_battle_matches_jax(compare_net, tmp_path):
    from sr_object_detection_tpu_torch.apps import compare_app as TC
    _, lst, paths, cfg, weights = compare_net
    runs = {}
    for tag, fn, kw in (("j", JC.battle_royale, {}),
                        ("t", TC.battle_royale, {"device": "cpu"})):
        runs[tag] = fn(cfg, weights, ["-list", lst, "-classes", "8"],
                       rng=np.random.default_rng(0), all_rounds=3,
                       class_rounds=2, out_dir=str(tmp_path / tag), **kw)
    np.testing.assert_allclose(runs["t"], runs["j"], rtol=0, atol=1e-6)
    assert np.any(runs["t"] != 1500.0)
    np.testing.assert_allclose(runs["t"].sum(axis=0), 1500.0 * 16,
                               atol=1e-6)
    for c in range(8):
        got = (tmp_path / "t" / f"battle_{c}.log").read_text()
        assert got == (tmp_path / "j" / f"battle_{c}.log").read_text()
        assert len(got.splitlines()) == 4


def test_captcha_test_and_valid_match_jax(tmp_path):
    names = ["aa", "bb", "cc", "dd"]
    lst, paths = _image_set(tmp_path, names, n_per=2)
    labels = tmp_path / "labels.list"
    labels.write_text("\n".join(names) + "\n")
    cfg = _toy_cfg(tmp_path, "cap.cfg", CLS_CFG.format(ch=3, out=4))
    args = ["-labels", str(labels)]
    want = JT.test_captcha(cfg, None, paths[0], list(args),
                           out=io.StringIO())
    got = cli.COMMANDS["captcha"](["test", cfg, paths[0], "-cpu"] + args)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    jout, tout = io.StringIO(), io.StringIO()
    want = JT.valid_captcha(cfg, None, ["-list", lst, "-batch", "3"] + args,
                            out=jout)
    got = TT.valid_captcha(cfg, None, ["-list", lst, "-batch", "3"] + args,
                           out=tout, device="cpu")
    assert [t for t, _ in got] == [t for t, _ in want] == \
        [0, 0, 1, 1, 2, 2, 3, 3]
    np.testing.assert_allclose(np.stack([r for _, r in got]),
                               np.stack([r for _, r in want]), atol=1e-5)
    assert len(tout.getvalue().splitlines()) == 8
