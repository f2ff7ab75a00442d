"""The classifier family's layer kinds in the port (graph/compiler.py's
inference forwards, ops/conv.py's connected and XNOR branch,
ops/pooling.py's avgpool and lrn, io/convert.py's local and deconv
layouts) on the CPU: against the committed C-oracle goldens at the JAX
package's 2e-5 (tests/test_parity.py), and against the JAX
``build_forward`` on the same seeded numpy inputs, every layer's output.
"""

import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr_object_detection_tpu.config import parse_cfg_text as j_parse
from sr_object_detection_tpu.graph import spec as JS
from sr_object_detection_tpu.graph.compiler import (
    build_forward, resolve_trees as j_resolve_trees)
from sr_object_detection_tpu.io.weights import init_params as j_init_params
from sr_object_detection_tpu_torch.config import parse_cfg_text
from sr_object_detection_tpu_torch.graph import spec as S
from sr_object_detection_tpu_torch.graph.compiler import Network
from sr_object_detection_tpu_torch.io.convert import (params_to_numpy,
                                                      params_to_torch)
from sr_object_detection_tpu_torch.io.weights import (init_params,
                                                       load_weights,
                                                       save_weights)
from sr_object_detection_tpu_torch.ops.layout import nhwc_to_flat
from torch_parity import random_bn

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"
GOLDENS = ["mini_connected", "mini_lrn", "mini_crop", "mini_local",
           "mini_deconv", "mini_xnor", "mini_tree_cls"]


def _cfg_text(g, tmp_path):
    """A golden's cfg; a tree= cfg gets the golden's tree as a file."""
    text = bytes(g["cfg"]).decode()
    if "tree" in g.files:
        tree = tmp_path / "mini.tree"
        tree.write_text(bytes(g["tree"]).decode())
        text = text.replace("{TREE}", str(tree))
    return text


def _golden_params(g, spec):
    """The golden's weights: init_params(seed), biases from bias_seed
    where the golden has one (tests/test_parity.py's _run)."""
    params = init_params(spec, seed=int(g["seed"]))
    if "bias_seed" in g.files and int(g["bias_seed"]) >= 0:
        brng = np.random.default_rng(int(g["bias_seed"]))
        for p in params:
            if p and "biases" in p:
                p["biases"] = brng.normal(
                    0, 0.5, np.shape(p["biases"])).astype(np.float32)
    return params


def _flat(t):
    t = t.detach().float().numpy()
    return nhwc_to_flat(torch.from_numpy(t)).numpy() if t.ndim == 4 else t


@pytest.mark.parametrize("name", GOLDENS)
def test_mini_golden(name, tmp_path):
    """The port's float32 Network reproduces the C oracle's output and
    every dumped layer at 2e-5."""
    g = np.load(GOLDEN / f"{name}.npz")
    spec = S.build_network_spec(parse_cfg_text(_cfg_text(g, tmp_path)))
    net = Network(spec, params_to_torch(spec, _golden_params(g, spec),
                                        "cpu"))
    x = torch.from_numpy(np.transpose(g["input_chw"], (1, 2, 0))[None]
                         .copy())
    with torch.no_grad():
        out, aux = net(x, keep_all=True)
    np.testing.assert_allclose(_flat(out)[0], g["output"], rtol=2e-5,
                               atol=2e-5)
    for i, l in enumerate(spec.layers):
        if f"layer_{i}" in g.files:
            np.testing.assert_allclose(
                _flat(aux["outputs"][i])[0], g[f"layer_{i}"], rtol=2e-5,
                atol=2e-5, err_msg=f"{name}: layer {i} ({l.kind})")


# every kind the slice adds, on one flat path and one spatial path
FLAT_CFG = """
[net]
batch=1
height=12
width=12
channels=3

[convolutional]
filters=6
size=3
stride=1
pad=1
batch_normalize=1
activation=leaky

[batchnorm]

[lrn]
size=3
alpha=.01
beta=.75
kappa=2

[activation]
activation=ramp

[crop]
crop_width=10
crop_height=10
flip=0
noadjust={noadjust}

[maxpool]
size=2
stride=2

[local]
filters=4
size=3
stride=1
pad=1
activation=leaky

[dropout]
probability=.5

[connected]
output=24
batch_normalize=1
activation=leaky

[connected]
output=12
activation=linear

[route]
layers=-1,-4

[softmax]
groups=4
temperature={temperature}

[cost]
type=sse
"""

SPATIAL_CFG = """
[net]
batch=1
height=10
width=10
channels=3

[convolutional]
filters=8
size=3
stride=1
pad=1
batch_normalize=1
activation=leaky

[convolutional]
xnor=1
filters=8
size=3
stride=1
pad=1
activation=leaky

[deconvolutional]
filters=6
size=4
stride=2
activation=leaky

[connected]
output=60
activation=linear

[convolutional]
filters=7
size=1
stride=1
pad=0
activation=linear

[avgpool]

[softmax]
groups=1
temperature={temperature}
{tree}
"""

TREE = "r0 -1\na 0\nb 0\nc 0\nr1 -1\nd 4\ne 4\n"


def _both(text):
    """(JAX spec, port spec) of one cfg text."""
    return (JS.build_network_spec(j_parse(text)),
            S.build_network_spec(parse_cfg_text(text)))


def _randomized(params, seed):
    """random_bn plus random statistics for the [batchnorm] layer."""
    out = random_bn(params, seed)
    rng = np.random.default_rng(seed + 100)
    for p in out:
        if "scales" in p and "biases" not in p:
            n = p["scales"].shape[0]
            p.update(scales=rng.uniform(0.6, 1.4, n).astype(np.float32),
                     rolling_mean=rng.normal(0, .1, n).astype(np.float32),
                     rolling_variance=rng.uniform(.6, 1.6, n).astype(
                         np.float32))
    return out


def _against_jax(text, seed, batch=2):
    spec_j, spec_t = _both(text)
    params = _randomized(j_init_params(spec_j, seed=seed), seed)
    x = np.random.default_rng(seed).uniform(
        0, 1, (batch, spec_t.net.h, spec_t.net.w, spec_t.net.c)).astype(
            np.float32)
    fwd = build_forward(spec_j, trees=j_resolve_trees(spec_j))
    _, aux_j = fwd(params, jnp.asarray(x), keep_all=True)
    net = Network(spec_t, params_to_torch(spec_t, params, "cpu"))
    with torch.no_grad():
        out, aux_t = net(torch.from_numpy(x), keep_all=True)
    for i, l in enumerate(spec_t.layers):
        got = aux_t["outputs"][i].numpy()
        ref = np.asarray(aux_j["outputs"][i])
        assert got.shape == ref.shape, (i, l.kind)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5,
                                   err_msg=f"layer {i} ({l.kind})")
    return spec_t, out


@pytest.mark.parametrize("noadjust,temperature", [(0, 1), (1, 2.5)])
def test_flat_kinds_match_jax(noadjust, temperature):
    """batchnorm, lrn, activation, crop (with and without noadjust),
    local, dropout, connected with BN, a route of flat outputs, softmax
    with groups and temperature, and the cost pass-through."""
    spec, out = _against_jax(FLAT_CFG.format(noadjust=noadjust,
                                             temperature=temperature), 3)
    # the route of a 1x1 and a 5x5 output is flat: 12 + 100 values
    assert spec.layers[10].out_c == 0 and spec.layers[10].outputs == 112
    assert out.shape == (2, 112)
    np.testing.assert_allclose(out.reshape(2, 4, 28).sum(-1).numpy(), 1.0,
                               rtol=1e-5)


@pytest.mark.parametrize("tree", [False, True])
def test_spatial_kinds_match_jax(tree, tmp_path):
    """An XNOR conv, deconv, a connected layer read back by a conv (the
    flat -> spatial reshape at the conv's 1x1 input), avgpool and
    softmax with a temperature, plain and with a tree."""
    line = ""
    if tree:
        (tmp_path / "t.tree").write_text(TREE)
        line = f"tree={tmp_path / 't.tree'}"
    spec, out = _against_jax(SPATIAL_CFG.format(temperature=1.5, tree=line),
                             5)
    assert [l.kind for l in spec.layers][3:5] == ["connected", "conv"]
    assert out.shape == (2, 7)


def test_unported_kinds_and_training_raise():
    """A [detection] head builds since the last kinds were ported (it
    raised before, naming item 10) and passes its flat input through at
    softmax 0; the JAX optimizer's polyphase rewrite, the one kind the
    port does not build, raises naming it. The training forward over
    every kind of the flat path runs (it raised before the classifier
    family's training was ported): its output and the cost against a
    truth are finite, every BN layer (conv, batchnorm, connected) updates
    its rolling statistics, and dropout and crop made their draws."""
    from sr_object_detection_tpu_torch.graph.compiler import build_layer
    det = S.build_network_spec(parse_cfg_text(
        "[net]\nheight=14\nwidth=14\nchannels=3\n\n[connected]\n"
        "output=24\n\n[detection]\nclasses=1\ncoords=4\nside=2\n"
        "num=1\n"))
    dnet = Network(det, params_to_torch(det, init_params(det), "cpu"))
    with torch.no_grad():
        out, aux = dnet(torch.rand(2, 14, 14, 3), keep_all=True)
    assert out.shape == (2, 24) and torch.equal(out, aux["outputs"][0])
    with pytest.raises(NotImplementedError, match="polyphase"):
        build_layer(S.FusedConvPoolSpec(index=0, filters=4), {})
    text = FLAT_CFG.format(noadjust=0, temperature=1)
    spec = S.build_network_spec(parse_cfg_text(text))
    net = Network(spec, params_to_torch(spec, init_params(spec), "cpu"))
    draws = {}
    out, aux = net(torch.rand(2, 12, 12, 3), train=True,
                   truth=torch.rand(2, 112), draws=draws)
    assert out.shape == (2, 112) and torch.isfinite(out).all()
    assert torch.isfinite(aux["cost"]) and float(aux["cost"]) > 0
    assert sorted(aux["bn"]) == [0, 1, 8]
    assert sorted(draws) == [4, 7]


def test_convert_round_trip_new_kinds(tmp_path):
    """params_to_numpy(params_to_torch(p)) == p bit for bit for connected
    (with BN), batchnorm, local and deconv parameters; the .weights bytes
    survive the round trip; the torch layouts are what the layers read."""
    text = FLAT_CFG.format(noadjust=0, temperature=1)
    spec = S.build_network_spec(parse_cfg_text(text))
    params = _randomized(init_params(spec, seed=2), 2)
    tp = params_to_torch(spec, params, "cpu")
    back = params_to_numpy(spec, tp)
    for l, a, b in zip(spec.layers, params, back):
        assert a.keys() == b.keys(), l.kind
        for k in a:
            np.testing.assert_array_equal(
                np.asarray(a[k], np.float32), b[k], err_msg=f"{l.kind} {k}")
    local = spec.layers[6]
    assert tuple(tp[6]["weights"].shape) == (
        local.out_h * local.out_w, local.filters, local.c * 9)
    w1, w2 = tmp_path / "a.weights", tmp_path / "b.weights"
    save_weights(spec, params, str(w1))
    save_weights(spec, back, str(w2))
    assert w1.read_bytes() == w2.read_bytes()
    sp = S.build_network_spec(parse_cfg_text(
        SPATIAL_CFG.format(temperature=1, tree="")))
    dp = init_params(sp, seed=1)
    dt = params_to_torch(sp, dp, "cpu")
    dl = sp.layers[2]
    assert tuple(dt[2]["weights"].shape) == (dl.c, dl.filters, 4, 4)
    np.testing.assert_array_equal(params_to_numpy(sp, dt)[2]["weights"],
                                  np.asarray(dp[2]["weights"], np.float32))
    assert load_weights(spec, str(w2))[0][6]["weights"].shape == \
        np.asarray(params[6]["weights"]).shape


def test_new_modules_import_without_jax():
    code = ("import sys\n"
            "import sr_object_detection_tpu_torch.infer.classifier\n"
            "import sr_object_detection_tpu_torch.apps.classifier_app\n"
            "import sr_object_detection_tpu_torch.apps.cli\n"
            "import sr_object_detection_tpu_torch.graph.compiler\n"
            "import sr_object_detection_tpu_torch.infer.quant\n"
            "assert 'jax' not in sys.modules\n"
            "assert 'sr_object_detection_tpu' not in sys.modules\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
