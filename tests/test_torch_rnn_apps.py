"""The char-rnn app in the port (apps/rnn_app.py and the CLI's `rnn`
command) against the JAX package's on the CPU, on a seeded .weights and
a seeded text:

* ``CharRNNSampler``'s probs over 20 characters fed to both samplers at
  1e-5 of the largest prob, and its first-layer output;
* ``rnn generate`` and ``rnn generatetactic`` write the JAX functions'
  text (the same ``np.random.default_rng`` draws on the same probs);
* ``rnn valid``'s log-loss and ``rnn validtactic``'s perplexities at 1e-5
  relative, the same number of lines; ``rnn vec`` rows at 1e-5;
* ``rnn train`` from the CLI (-cpu, 3 iterations of 8 streams x 4 steps)
  against the JAX ``train_rnn``: parameters within 1e-5 of each tensor's
  largest value.
"""

import io

import numpy as np
import pytest
import torch

from sr_object_detection_tpu.apps import rnn_app as JA
from sr_object_detection_tpu.graph import spec as JS
from sr_object_detection_tpu_torch.apps import cli
from sr_object_detection_tpu_torch.apps import rnn_app as TA
from sr_object_detection_tpu_torch.graph import spec as S
from sr_object_detection_tpu_torch.io.weights import (init_params,
                                                       load_weights,
                                                       save_weights)
from torch_parity import random_bn_nested

# 8 streams: the training BN over fewer rows a step amplifies the
# packages' sum-order differences (tests/test_torch_recurrent.py)
RNN_CFG = """
[net]
subdivisions=1
inputs=256
batch=8
momentum=0.9
decay=0.001
time_steps=4
learning_rate=0.1
policy=constant
max_batches={iters}

[rnn]
batch_normalize=1
output=16
hidden=16
activation=leaky

[gru]
batch_normalize=0
output=12

[connected]
output=256
activation=leaky

[softmax]

[cost]
type=sse
"""

TEXT = (b"preamble >>e4 e5.\nmore >>d4 d5.\nthe quick brown fox jumps "
        b"over the lazy dog >>nf3 nc6.\n") * 6


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("rnn")
    cfg = d / "rnn.cfg"
    cfg.write_text(RNN_CFG.format(iters=3))
    spec = S.parse_network_cfg(str(cfg))
    weights = d / "rnn.weights"
    save_weights(spec, random_bn_nested(init_params(spec, seed=31), 32),
                 str(weights))
    text = d / "text.txt"
    text.write_bytes(TEXT)
    return d, str(cfg), str(weights), str(text)


def test_sampler_probs_match_jax(files):
    _, cfg, weights, _ = files
    spec, jspec = S.parse_network_cfg(cfg), JS.parse_network_cfg(cfg)
    params = load_weights(spec, weights)[0]
    tsm = TA.CharRNNSampler(spec, params, device="cpu")
    jsm = JA.CharRNNSampler(jspec, params)
    ts, js = tsm.init_state(), jsm.init_state()
    import jax.numpy as jnp
    for ch in TEXT[:20]:
        x = np.zeros((1, 256), np.float32)
        x[0, ch] = 1
        tp, ts, tfirst = tsm._step0(tsm.params, tsm.one_hot(ch), ts)
        jp, js, jfirst = jsm._step0(jsm.params, jnp.asarray(x), js)
        jp = np.asarray(jp)
        np.testing.assert_allclose(tp.numpy(), jp, rtol=0,
                                   atol=1e-5 * jp.max())
        np.testing.assert_allclose(tfirst.numpy(), np.asarray(jfirst),
                                   rtol=0, atol=1e-5 * np.abs(
                                       np.asarray(jfirst)).max())


def test_generate_matches_jax(files, capsys):
    _, cfg, weights, _ = files
    args = ["-len", "60", "-temp", "0.8", "-seed", "th"]
    want = JA.generate_rnn(cfg, weights, list(args))
    capsys.readouterr()
    cli.main(["rnn", "generate", cfg, weights, "-cpu"] + args)
    out = capsys.readouterr().out
    assert out == want.decode("latin-1") + "\n"
    assert len(want) == 62


def _stdin(monkeypatch, data: bytes):
    monkeypatch.setattr("sys.stdin", io.TextIOWrapper(io.BytesIO(data)))


def test_generatetactic_matches_jax(files, monkeypatch, capsys):
    """From the CLI, primed on standard input as rnn.c reads it."""
    _, cfg, weights, _ = files
    args = ["-len", "40", "-temp", "0.9", "-srand", "5"]
    want = JA.generate_tactic_rnn(cfg, weights, list(args), prime=b">>e4 ",
                                  out=io.StringIO())
    _stdin(monkeypatch, b">>e4 ")
    capsys.readouterr()
    got = cli.COMMANDS["rnn"](["generatetactic", cfg, weights, "-cpu"]
                              + args)
    assert got == want
    assert capsys.readouterr().out == want.decode("latin-1") + "\n"


def test_valid_and_validtactic_match_jax(files, capsys):
    _, cfg, weights, text = files
    want = JA.validate_rnn(cfg, weights, text, ["-len", "120"])
    capsys.readouterr()
    got = cli.main(["rnn", "valid", cfg, weights, text, "-len", "120",
                    "-cpu"])
    assert got == 0
    line = capsys.readouterr().out
    assert line.startswith("log-loss: ")
    assert TA.validate_rnn(cfg, weights, text, ["-len", "120"],
                           device="cpu") == pytest.approx(want, rel=1e-5)
    capsys.readouterr()
    jo = io.StringIO()
    jl = JA.valid_tactic_rnn(cfg, weights, text, ["-seed", "x"], out=jo)
    tl = cli.COMMANDS["rnn"](["validtactic", cfg, weights, text, "-seed",
                              "x", "-cpu"])
    assert tl == pytest.approx(jl, rel=1e-5)
    mine = capsys.readouterr().out.splitlines()
    want = jo.getvalue().splitlines()
    assert len(mine) == len(want) > 10
    assert mine[-1].split()[:2] == want[-1].split()[:2]


def test_vec_matches_jax(files, monkeypatch, capsys):
    """From the CLI, one line of standard input a row."""
    _, cfg, weights, _ = files
    lines = ["hello", "world", "hello"]
    jv = JA.vec_char_rnn(cfg, weights, ["-seed", "x"], lines=lines,
                         out=io.StringIO())
    _stdin(monkeypatch, b"hello\nworld\nhello\n")
    capsys.readouterr()
    tv = cli.COMMANDS["rnn"](["vec", cfg, weights, "-seed", "x", "-cpu"])
    for a, b in zip(tv, jv):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())
    np.testing.assert_array_equal(tv[0], tv[2])
    rows = capsys.readouterr().out.splitlines()
    assert len(rows) == 3 and rows[1].startswith("world,")


def test_train_matches_jax(files, capsys):
    d, cfg, weights, text = files
    jt = JA.train_rnn(cfg, text, weights, ["-backup", str(d / "jax")])
    capsys.readouterr()
    # the CLI's command returns train_rnn's trainer
    tt = cli.COMMANDS["rnn"](["train", cfg, text, weights, "-backup",
                              str(d / "port"), "-cpu"])
    spec = S.parse_network_cfg(cfg)
    assert int(tt.state.seen) == int(jt.state.seen) == 3 * 32
    from sr_object_detection_tpu_torch.io.convert import (flat,
                                                          params_to_numpy)
    mine = params_to_numpy(spec, tt.state.params)
    moved = 0.0
    init = load_weights(spec, weights)[0]
    for i, l in enumerate(spec.layers):
        got, ini = flat(mine[i]), flat(init[i])
        for k, v in flat(jt.state.params[i]).items():
            v = np.asarray(v)
            np.testing.assert_allclose(
                got[k], v, rtol=0, atol=1e-5 * np.abs(v).max(),
                err_msg=f"layer {i} ({l.kind}) {k}")
            moved = max(moved, float(np.abs(got[k] - ini[k]).max()))
    assert moved > 0
    assert tt.device == torch.device("cpu")
