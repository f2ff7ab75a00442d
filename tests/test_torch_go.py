"""The Go app in the port (apps/go_app.py) against the JAX package's on
the same seeded moves files and .weights, on the CPU:

* the codec, the augmentation draws, the rules (capture, suicide, ko)
  and Tromp-Taylor scoring equal to JAX's;
* `predict_move` single and the -multi ensemble within 1e-5, and go-19's
  full 13 x 256 stack on 2 boards within 1e-4 of the largest |value|;
* `go train` (through the port's CLI) per-step losses within 1e-4
  relative over 3 steps; `go valid` accuracy equal;
* a scripted `go engine` GTP session's transcript and a `go self`
  game's records equal, byte for byte; `go test`'s board rendering and
  input grammar equal (its loop raises in both packages: ROADMAP
  queue 3, item 19).
"""

import io

import numpy as np
import pytest

from sr_object_detection_tpu.apps import go_app as JG
from sr_object_detection_tpu_torch.apps import cli
from sr_object_detection_tpu_torch.apps import go_app as TG
from sr_object_detection_tpu_torch.graph import spec as S
from sr_object_detection_tpu_torch.io.weights import (init_params,
                                                       save_weights)
from test_go import TOY_CFG, _random_board
from torch_parity import go19_cfg_text, random_bn, write_go_moves

# The game tests' net: the toy net's conv and a connected head. A net of
# convolutions alone gives exactly tied moves on the board's empty
# stretches (every such point sees the same window); which of a tie the
# top-5 threshold keeps then turns on the last bit of each package's
# sums, and a game forks there. A connected head's outputs are each
# point's own, so two packages' games can be held equal move for move.
GAME_CFG = TOY_CFG.replace("""[convolutional]
filters=1
size=1
stride=1
pad=1
activation=linear""", """[connected]
output=361
activation=linear""")

GTP = "\n".join([
    "1 protocol_version", "2 name", "3 known_command genmove",
    "4 list_commands", "5 boardsize 19", "6 clear_board", "7 komi 6.5",
    "8 play black Q16", "9 genmove white", "10 play black D4",
    "11 genmove white", "12 genmove black", "13 play white pass",
    "14 genmove black", "15 genmove white", "16 final_status_list dead",
    "17 frobnicate", "18 quit"]) + "\n"


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The toy policy net of tests/test_go.py with seeded weights (BN
    statistics and biases non-trivial) and two seeded moves files."""
    root = tmp_path_factory.mktemp("go")
    cfg = root / "go_toy.cfg"
    cfg.write_text(TOY_CFG)
    spec = S.parse_network_cfg(str(cfg))
    weights = root / "go_toy.weights"
    save_weights(spec, random_bn(init_params(spec, seed=23), 24,
                                 head_gain=3.0), str(weights))
    train = write_go_moves(root / "go.train", 40, 25)
    test = write_go_moves(root / "go.test", 24, 26)
    return root, str(cfg), str(weights), train, test


@pytest.fixture(scope="module")
def game_net(tmp_path_factory):
    root = tmp_path_factory.mktemp("go_game")
    cfg = root / "go_game.cfg"
    cfg.write_text(GAME_CFG)
    spec = S.parse_network_cfg(str(cfg))
    assert spec.layers[1].kind == "connected"
    weights = root / "go_game.weights"
    save_weights(spec, random_bn(init_params(spec, seed=27), 28,
                                 head_gain=3.0), str(weights))
    return str(cfg), str(weights)


def test_codec_and_augmentation_match_jax(toy):
    rng = np.random.default_rng(0)
    boards = np.stack([_random_board(rng, stones=s) for s in (0, 9, 30)])
    for b in boards:
        packed = TG.board_to_string(b)
        np.testing.assert_array_equal(packed, JG.board_to_string(b))
        np.testing.assert_array_equal(TG.string_to_board(packed), b)
    moves = TG.load_go_moves(toy[3])
    np.testing.assert_array_equal(moves, JG.load_go_moves(toy[3]))
    got = TG.random_go_moves(moves, np.random.default_rng(7), 32)
    want = JG.random_go_moves(moves, np.random.default_rng(7), 32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_rules_and_scoring_match_jax():
    """Capture, suicide and ko legality at every point of seeded boards,
    and Tromp-Taylor scores, equal to the JAX module's."""
    rng = np.random.default_rng(3)
    for stones in (40, 120, 200):
        b = _random_board(rng, stones=stones)
        ko = TG.board_to_string(_random_board(rng, stones=stones))
        for player in (1, -1):
            for r in range(0, 19, 3):
                for c in range(0, 19, 2):
                    assert TG.legal_go(b, ko, player, r, c) == \
                        JG.legal_go(b, ko, player, r, c)
                    if b[r, c] == 0:
                        assert TG.suicide_go(b, player, r, c) == \
                            JG.suicide_go(b, player, r, c)
                        got, want = b.copy(), b.copy()
                        TG.move_go(got, player, r, c)
                        JG.move_go(want, player, r, c)
                        np.testing.assert_array_equal(got, want)
        assert TG.tromp_taylor_score(b) == JG.tromp_taylor_score(b)
        assert TG.score_game(b) == JG.score_game(b)


@pytest.mark.parametrize("multi", [False, True])
def test_predict_move_matches_jax(toy, multi):
    _, cfg, weights, _, _ = toy
    mine = TG.GoEngine(cfg, weights, device="cpu")
    ref = JG.GoEngine(cfg, weights)
    rng = np.random.default_rng(11)
    for stones in (0, 20, 90):
        b = _random_board(rng, stones=stones)
        for t in (1.0, 0.7):
            got = mine.predict_move(b, multi=multi, temperature=t)
            want = ref.predict_move(b, multi=multi, temperature=t)
            assert got.dtype == want.dtype
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert mine.best_move(b) == ref.best_move(b)


def test_go19_full_width_forward_matches_jax(tmp_path):
    """go-19's full stack (13 x 256) on 2 boards, forward only."""
    cfg = tmp_path / "go19.cfg"
    cfg.write_text(go19_cfg_text())
    spec = S.parse_network_cfg(str(cfg))
    assert [l.filters for l in spec.layers[:14]] == [256] * 13 + [1]
    weights = tmp_path / "go19.weights"
    save_weights(spec, random_bn(init_params(spec, seed=19), 20),
                 str(weights))
    mine = TG.GoEngine(str(cfg), str(weights), device="cpu")
    ref = JG.GoEngine(str(cfg), str(weights))
    rng = np.random.default_rng(19)
    x = np.stack([_random_board(rng, stones=s) for s in (30, 150)])
    x = x.reshape(2, 19, 19, 1)
    got = mine.forward(x)
    want = np.asarray(ref._fwd(1.0)(ref.params, x)).reshape(2, -1)
    assert got.shape == (2, 361)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_go_train_matches_jax(toy, tmp_path, capsys):
    root, cfg, weights, train, _ = toy
    _, want = JG.train_go(cfg, weights, ["-moves", train, "-backup",
                                         str(tmp_path / "j")],
                          max_batches=3)
    # the CLI runs until the cfg's max_batches: a copy that stops at 3
    cfg3 = tmp_path / "go_toy.cfg"
    cfg3.write_text(TOY_CFG.replace("max_batches=100", "max_batches=3"))
    capsys.readouterr()
    trainer, got = cli.COMMANDS["go"](["train", str(cfg3), weights,
                                       "-moves", train, "-backup",
                                       str(tmp_path / "t"), "-cpu"])
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert int(trainer.state.seen) == 24
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "40" and out[3].startswith("3, 0.600: ")
    assert (tmp_path / "t" / "go_toy.weights").stat().st_size == \
        (tmp_path / "j" / "go_toy.weights").stat().st_size


def test_go_valid_matches_jax(toy, capsys):
    _, cfg, weights, _, test = toy
    for multi in ([], ["-multi"]):
        want = JG.valid_go(cfg, weights, ["-moves", test] + multi)
        jax_out = capsys.readouterr().out
        got = cli.COMMANDS["go"](["valid", cfg, weights, "-moves", test,
                                  "-cpu"] + multi)
        assert got == want
        assert capsys.readouterr().out == jax_out


def test_go_engine_transcript_matches_jax(game_net):
    """A scripted GTP session, single and -multi: the port's replies are
    the JAX engine's, line for line."""
    cfg, weights = game_net
    for multi in ([], ["-multi"]):
        want, got = io.StringIO(), io.StringIO()
        JG.engine_go(cfg, weights, multi, stdin=io.StringIO(GTP),
                     stdout=want)
        TG.engine_go(cfg, weights, multi, stdin=io.StringIO(GTP),
                     stdout=got, device="cpu")
        assert got.getvalue().splitlines() == want.getvalue().splitlines()
        moves = [l.split()[1] for l in got.getvalue().splitlines()
                 if l.startswith(("=9 ", "=11 ", "=12 "))]
        assert len(moves) == 3 and "pass" not in moves


def test_go_test_loop_matches_jax(toy):
    """`go test`'s board loop: both packages' step passes the top-5 as a
    numpy array to ``format_board``, whose ``indexes or []`` raises on it
    (ROADMAP queue 3, item 19), so both raise the same error; the board
    rendering with the marks as a list and the loop's input grammar
    (``_apply_test_input``) give equal boards and text."""
    _, cfg, weights, _, _ = toy
    errors = []
    for step in (JG.test_go(cfg, weights, [], stdout=io.StringIO()),
                 TG.test_go(cfg, weights, [], stdout=io.StringIO(),
                            device="cpu")):
        with pytest.raises(ValueError) as e:
            step("")
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    rng = np.random.default_rng(5)
    jb = _random_board(rng, stones=40)
    tb = jb.copy()
    order = [int(i) for i in rng.choice(361, TG.NIND, replace=False)]
    for color in (1, -1):
        assert TG.format_board(tb, color, order) == \
            JG.format_board(jb, color, order)
        for line in ("", "2", "C17", "T1", "b D4", "c D4", "p", "w Q3"):
            JG._apply_test_input(jb, color, line, np.asarray(order))
            TG._apply_test_input(tb, color, line, np.asarray(order))
            np.testing.assert_array_equal(tb, jb)


def test_go_self_records_match_jax(game_net):
    """One self-play game: the scores and the winner's emitted records
    equal the JAX game's, byte for byte."""
    cfg, weights = game_net
    want, got = io.BytesIO(), io.BytesIO()
    jres = JG.self_go(cfg, weights, argv=[], max_games=1, out=want)
    tres = TG.self_go(cfg, weights, argv=["-games", "1"], out=got,
                      device="cpu")
    assert tres == jres
    assert len(got.getvalue()) > 0 and got.getvalue() == want.getvalue()
