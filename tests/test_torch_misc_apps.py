"""The rest of apps/misc_apps.py in the port against the JAX package's, on
the CPU, through the port's CLI commands with -cpu where there is one,
on seeded toy nets, .weights and PPMs:

* the alphanumeric mapping; `art`, `captcha`, `tag`, `compare`,
  `writing` and `dice` outputs within 1e-5;
* `VideoRNN` features (and `vid <cfg> -frames`) within 1e-5;
* `best_3d_shift_r` equal, `voxel extract`'s PPMs byte-equal, `voxel
  test`'s upscaled frames within one 8-bit level;
* the reconstruction step (``make_reconstructor``: the input gradient,
  the border-exact window sum, update and clip) within 1e-4 of JAX's,
  and `vid generate`'s images within 1e-4;
* `3d` and `imtest` / `test` files byte-equal.
"""

import os

import numpy as np
import pytest

from sr_object_detection_tpu.apps import misc_apps as JM
from sr_object_detection_tpu_torch.apps import cli
from sr_object_detection_tpu_torch.apps import misc_apps as TM
from sr_object_detection_tpu_torch.graph import spec as S
from sr_object_detection_tpu_torch.io.weights import (init_params,
                                                       save_weights)
from sr_object_detection_tpu_torch.ops.image import load_image_rgb
from test_misc_train import CLS_CFG, WRITING_CFG
from tools.synth_dataset import write_ppm
from torch_parity import random_bn, random_bn_nested

EXT_CFG = """[net]
batch=1
height=12
width=12
channels=3
learning_rate=0.01
momentum=0.9
decay=0.0001

[convolutional]
filters=4
size=3
stride=2
pad=1
batch_normalize=1
activation=leaky

[connected]
output=16
activation=logistic
"""

VRNN_CFG = """[net]
batch=1
inputs=16
time_steps=1
learning_rate=0.01
momentum=0.9
decay=0.0001

[rnn]
output=16
hidden=8
activation=leaky
batch_normalize=1
"""

SUPER_CFG = """[net]
batch=1
height=8
width=8
channels=3

[convolutional]
filters=8
size=3
stride=1
pad=1
batch_normalize=1
activation=leaky

[deconvolutional]
filters=3
size=2
stride=2
activation=logistic
"""


def _net(root, name, text, seed):
    cfg = root / f"{name}.cfg"
    cfg.write_text(text)
    spec = S.parse_network_cfg(str(cfg))
    weights = root / f"{name}.weights"
    params = init_params(spec, seed=seed)
    params = (random_bn_nested(params, seed + 1)
              if spec.layers[0].kind == "rnn"
              else random_bn(params, seed + 1, head_gain=3.0))
    save_weights(spec, params, str(weights))
    return str(cfg), str(weights)


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    root = tmp_path_factory.mktemp("apps")
    rng = np.random.default_rng(60)
    imgs = []
    for i in range(3):
        p = root / f"im{i}.ppm"
        write_ppm(str(p), rng.integers(0, 256, (20 + 4 * i, 24, 3),
                                       dtype=np.uint8))
        imgs.append(str(p))
    nets = {"art": _net(root, "art", CLS_CFG.format(ch=3, out=10), 61),
            "captcha": _net(root, "captcha",
                            CLS_CFG.format(ch=3, out=2 * TM.NUMCHARS), 63),
            "tag": _net(root, "tag", CLS_CFG.format(ch=3, out=12), 65),
            "compare": _net(root, "compare", CLS_CFG.format(ch=6, out=4),
                            67),
            "writing": _net(root, "writing", WRITING_CFG, 69),
            "dice": _net(root, "dice", CLS_CFG.format(ch=3, out=6), 71)}
    return root, imgs, nets


def test_alphanum_mapping_matches_jax():
    assert TM.NUMCHARS == JM.NUMCHARS == 37
    chars = [TM._int_to_alphanum(i) for i in range(TM.NUMCHARS)]
    assert chars == [JM._int_to_alphanum(i) for i in range(JM.NUMCHARS)]
    assert "".join(chars) == "0123456789abcdefghijklmnopqrstuvwxyz."


@pytest.mark.parametrize("app", ["art", "captcha", "tag", "compare",
                                 "writing", "dice"])
def test_app_output_matches_jax(apps, app, tmp_path):
    root, imgs, nets = apps
    cfg, weights = nets[app]
    if app == "compare":
        want = JM.compare(cfg, weights, imgs[0], imgs[1])
        got = cli.COMMANDS[app]([cfg, weights, imgs[0], imgs[1], "-cpu"])
    elif app == "writing":
        want = JM.writing(cfg, weights, imgs[1],
                          out_path=str(tmp_path / "j.ppm"))
        got = cli.COMMANDS[app]([cfg, weights, imgs[1], "-out",
                                 str(tmp_path / "t.ppm"), "-cpu"])
        assert got.shape == (16, 16, 3)
    else:
        want = getattr(JM, app)(cfg, weights, imgs[2])
        got = cli.COMMANDS[app]([cfg, weights, imgs[2], "-cpu"])
    if app == "captcha":
        assert got == want and len(got) == 2
    elif app == "tag":
        assert [r[0] for r in got] == [r[0] for r in want]
        np.testing.assert_allclose([r[1] for r in got],
                                   [r[1] for r in want], rtol=0, atol=1e-5)
    elif app == "dice":
        assert (got[0], got[2]) == (want[0], want[2])
        assert got[1] == pytest.approx(want[1], abs=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_video_rnn_features_match_jax(tmp_path, capsys):
    from sr_object_detection_tpu_torch.models.zoo import CfgBuilder
    b = CfgBuilder()
    b.net(batch=1, width=32, height=32, channels=3)
    b.conv(8, size=3, stride=2)
    b.conv(16, size=3, stride=2)
    b.section("avgpool")
    cfg = tmp_path / "v.cfg"
    cfg.write_text(b.text())
    frames = np.random.default_rng(0).random((3, 32, 32, 3)).astype(
        np.float32)
    got = TM.VideoRNN(str(cfg), feature_layer=1, device="cpu"
                      ).features(frames)
    want = JM.VideoRNN(str(cfg), feature_layer=1).features(frames)
    assert got.shape == want.shape == (3, 8 * 8 * 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    (tmp_path / "f").mkdir()
    for i, f in enumerate(frames):
        write_ppm(str(tmp_path / "f" / f"{i}.ppm"),
                  (f * 255).astype(np.uint8))
    # the default feature layer (-3: the first conv here)
    feats = cli.COMMANDS["vid"]([str(cfg), "-frames",
                                 str(tmp_path / "f" / "*.ppm"), "-cpu"])
    assert feats.shape == (3, 16 * 16 * 8)
    assert "extracted features: (3, 2048)" in capsys.readouterr().out


def test_stereo_tools_match_jax(tmp_path):
    """best_3d_shift_r equal to JAX's; `voxel extract`'s crops
    byte-equal to the JAX function's."""
    g = np.linspace(0, 1, 60, dtype=np.float32)[:, None, None]
    base = np.broadcast_to(g, (60, 40, 3)).copy()
    base += np.linspace(0, .2, 40, dtype=np.float32)[None, :, None]
    base = np.clip(base, 0, 1)
    for shift in (-4, 0, 3):
        right = np.roll(base, shift, axis=0)
        assert TM.best_3d_shift_r(base, right, -6, 6) == \
            JM.best_3d_shift_r(base, right, -6, 6)
        assert TM._dist_array(base, right) == JM._dist_array(base, right)
    right = np.roll(base, 3, axis=0)
    for side, im in (("l", base), ("r", right)):
        (tmp_path / side).mkdir()
        for i in range(2):
            write_ppm(str(tmp_path / side / f"f{i}.ppm"),
                      (im * 255).astype(np.uint8))
    args = ["-w", "20", "-h", "30", "-xoff", "4"]
    want = JM.extract_voxel(str(tmp_path / "l"), str(tmp_path / "r"),
                            str(tmp_path / "j"), list(args))
    got = cli.COMMANDS["voxel"](["extract", str(tmp_path / "l"),
                                 str(tmp_path / "r"), str(tmp_path / "t")]
                                + args)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert open(a, "rb").read() == open(b, "rb").read()


def test_voxel_upscale_matches_jax(tmp_path):
    cfg, weights = _net(tmp_path, "sup", SUPER_CFG, 73)
    rng = np.random.default_rng(74)
    for i in range(2):
        write_ppm(str(tmp_path / f"fr{i}.ppm"),
                  rng.integers(0, 256, (10, 12, 3), dtype=np.uint8))
    pattern = str(tmp_path / "fr*.ppm")
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want = JM.voxel(cfg, weights, pattern, out_dir=str(tmp_path / "j"))
    got = cli.COMMANDS["voxel"](["test", cfg, weights, pattern, "-out",
                                 str(tmp_path / "t"), "-cpu"])
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    for a, b in zip(got, want):
        x, y = load_image_rgb(a), load_image_rgb(b)
        assert x.shape == (20, 24, 3)
        np.testing.assert_allclose(x, y, rtol=0, atol=1 / 255 + 1e-6)


def test_reconstruction_step_matches_jax(tmp_path):
    """One step of the vid-rnn generator's reconstruction at smooth
    sizes 1 and 2 from a seeded image and update: recon and update
    within 1e-4 of JAX's (the input gradient through a BN conv and a
    connected layer, the window sums exact at the borders)."""
    import jax.numpy as jnp
    import torch
    from sr_object_detection_tpu.graph.spec import parse_network_cfg
    from sr_object_detection_tpu.io.weights import load_weights
    from sr_object_detection_tpu_torch.io.convert import params_to_torch
    cfg, weights = _net(tmp_path, "ext", EXT_CFG, 75)
    jspec = parse_network_cfg(cfg)
    jparams = load_weights(jspec, weights)[0]
    tspec = S.parse_network_cfg(cfg)
    from sr_object_detection_tpu_torch.io.weights import load_weights as TL
    tparams = params_to_torch(tspec, TL(tspec, weights)[0], "cpu")
    rng = np.random.default_rng(76)
    recon = rng.random((1, 12, 12, 3), np.float32)
    update = rng.normal(0, 0.1, (1, 12, 12, 3)).astype(np.float32)
    feat = rng.random(16, np.float32)
    for smooth in (1, 2):
        want = JM.make_reconstructor(jspec, smooth)(
            jparams, jnp.asarray(feat), jnp.asarray(recon),
            jnp.asarray(update), 0.5, 0.9, 0.1)
        got = TM.make_reconstructor(tspec, smooth)(
            tparams, torch.from_numpy(feat), torch.from_numpy(recon),
            torch.from_numpy(update), 0.5, 0.9, 0.1)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-4)
        assert not np.allclose(got[0].numpy(), recon, atol=1e-3)


def test_vid_generate_matches_jax(tmp_path):
    cfg_e, w_e = _net(tmp_path, "ext", EXT_CFG, 77)
    cfg_r, w_r = _net(tmp_path, "vrnn", VRNN_CFG, 79)
    rng = np.random.default_rng(1)
    (tmp_path / "frames").mkdir()
    for i in range(3):
        write_ppm(str(tmp_path / "frames" / f"f{i}.ppm"),
                  rng.integers(0, 255, (12, 12, 3)).astype(np.uint8))
    args = ["-extractor", cfg_e, "-extractor-weights", w_e, "-frames",
            str(tmp_path / "frames" / "*.ppm"), "-n", "2", "-gen", "2",
            "-recon-iters", "3"]
    want = JM.generate_vid_rnn(cfg_r, w_r, args + ["-out",
                                                   str(tmp_path / "j")])
    got = cli.COMMANDS["vid"](["generate", cfg_r, w_r] + args + [
        "-out", str(tmp_path / "t"), "-cpu"])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j")) == [
        "feat0.ppm", "feat1.ppm", "new0.ppm", "new1.ppm", "next0.ppm",
        "next1.ppm"]
    for n in names:
        np.testing.assert_allclose(load_image_rgb(str(tmp_path / "t" / n)),
                                   load_image_rgb(str(tmp_path / "j" / n)),
                                   rtol=0, atol=1 / 255 + 1e-6)


@pytest.mark.parametrize("command", ["imtest", "test"])
def test_3d_and_imtest_files_equal(apps, tmp_path, command):
    _, imgs, _ = apps
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    JM.composite_3d(imgs[0], imgs[0], str(tmp_path / "j" / "a.ppm"),
                    delta=1)
    cli.COMMANDS["3d"]([imgs[0], imgs[0], str(tmp_path / "t" / "a.ppm"),
                        "-delta", "1", "-cpu"])
    want = JM.imtest(imgs[1], str(tmp_path / "j"))
    got = cli.COMMANDS[command]([imgs[1], "-out", str(tmp_path / "t")])
    assert len(got) == len(want) == 7
    for name in sorted(os.listdir(tmp_path / "j")):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()
