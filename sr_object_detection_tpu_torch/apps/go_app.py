"""go: policy-network Go — full app parity with src_yolo2/go.c.

Counterpart of ``sr_object_detection_tpu/apps/go_app.py``:

  go train  <cfg> [weights] -moves <go.train> [-backup dir] [-cpu]
  go valid  <cfg> <weights> -moves <go.test> [-multi] [-cpu]
  go test   <cfg> [weights] [-multi] [-cpu]      (interactive board loop)
  go self   <cfg> [weights] [cfg2 [weights2]] [-multi] [-games N] [-cpu]
  go engine <cfg> [weights] [-multi] [-cpu]      (GTP protocol loop)

Reference behavior (cited per function): the moves file is fixed
94-byte records (row, col, 91 packed-board bytes, newline; go.c:21-52),
boards are one-plane 19x19 {+1 own, -1 opponent, 0 empty}
(string_to_board, go.c:55-72), training draws random records with
8-fold dihedral augmentation (random_go_moves, go.c:91-116), and play
legality/ko/suicide/capture follow go.c:293-366.

The policy net runs on ``device`` (CUDA unless the CLI's -cpu) in
float32, through ``graph.compiler.Network``; training is the float32
``Trainer`` with the ``[cost]`` head. The -multi dihedral ensemble runs
as ONE batch of 8 transformed boards (one forward) instead of the
reference's 8 sequential predicts (predict_move, go.c:269-291). The Go
*rules* (flood-fill liberties, captures, ko, suicide, scoring) are
host-side numpy, copied as they are from the JAX module: they are O(361)
bookkeeping between device calls, not compute. Game scoring uses gnugo
when present (score_game, go.c:705-746) and falls back to native
Tromp-Taylor area scoring, so `go self` works without the external
binary. The engine samples its moves from ``np.random.default_rng(0)``
as the JAX engine does, so equal predictions give equal games.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from collections import deque

import numpy as np
import torch

from ..graph.spec import parse_network_cfg
from ..graph import spec as S
from ..graph.compiler import Network
from ..io.convert import params_to_torch
from ..io.weights import load_weights


BOARD = 19
N = BOARD * BOARD
NIND = 5              # candidate moves shown/sampled (go.c nind)
KOMI = 6.5            # score_game (go.c:709)


# ---------------------------------------------------------------------
# moves-file codec (go.c:21-89)
# ---------------------------------------------------------------------

RECORD = 94           # fgetgo reads fixed 94-byte records (go.c:25)


def load_go_moves(path: str) -> np.ndarray:
    """Moves file -> (N, 93) uint8 records [row, col, 91 board bytes]
    (load_go_moves, go.c:34-52; the 94th byte is the newline)."""
    raw = np.fromfile(path, np.uint8)
    n = len(raw) // RECORD
    return raw[:n * RECORD].reshape(n, RECORD)[:, :93].copy()


def string_to_board(packed: np.ndarray) -> np.ndarray:
    """(…, 91) packed bytes -> (…, 19, 19) float32 {1,-1,0}
    (string_to_board, go.c:55-72: per byte, point j uses bit 2j for
    'me' and bit 2j+1 for 'you', LSB-first, 4 points per byte)."""
    packed = np.asarray(packed, np.uint8)
    shifts = 2 * np.arange(4, dtype=np.uint8)
    me = (packed[..., :, None] >> shifts) & 1
    you = (packed[..., :, None] >> (shifts + 1)) & 1
    flat = (me.astype(np.int8) - you.astype(np.int8)).reshape(
        *packed.shape[:-1], 91 * 4)[..., :N]
    return flat.astype(np.float32).reshape(*packed.shape[:-1],
                                           BOARD, BOARD)


def board_to_string(board: np.ndarray) -> np.ndarray:
    """(19, 19) board -> (91,) packed bytes (board_to_string,
    go.c:74-89)."""
    flat = np.zeros(91 * 4, np.uint8)
    b = np.asarray(board).reshape(-1)
    flat[:N][b == 1] = 1
    out = np.zeros(91, np.uint8)
    shifts = 2 * np.arange(4, dtype=np.uint8)
    me = flat.reshape(91, 4)
    you = np.zeros(91 * 4, np.uint8)
    you[:N][b == -1] = 1
    you = you.reshape(91, 4)
    out = ((me << shifts) | (you << (shifts + 1))).astype(
        np.uint8).sum(axis=1).astype(np.uint8)
    return out


def random_go_moves(moves: np.ndarray, rng: np.random.Generator,
                    n: int) -> tuple[np.ndarray, np.ndarray]:
    """Sample n training pairs with dihedral augmentation
    (random_go_moves, go.c:91-116): label = one-hot at the move,
    board = position with the move cell cleared, then a random
    horizontal flip + 0-3 clockwise rotations applied to both."""
    idx = rng.integers(0, len(moves), n)
    recs = moves[idx]
    rows = recs[:, 0].astype(np.int64)
    cols = recs[:, 1].astype(np.int64)
    boards = string_to_board(recs[:, 2:])
    labels = np.zeros((n, BOARD, BOARD), np.float32)
    labels[np.arange(n), rows, cols] = 1.0
    boards[np.arange(n), rows, cols] = 0.0
    flips = rng.integers(0, 2, n)
    rots = rng.integers(0, 4, n)
    for i in range(n):
        if flips[i]:                        # flip_image: horizontal
            boards[i] = boards[i, :, ::-1]
            labels[i] = labels[i, :, ::-1]
        if rots[i]:                         # rotate_image_cw
            boards[i] = np.rot90(boards[i], -int(rots[i]))
            labels[i] = np.rot90(labels[i], -int(rots[i]))
    return boards, labels


# ---------------------------------------------------------------------
# rules: liberties / captures / legality (go.c:174-366)
# ---------------------------------------------------------------------

def _group_and_liberties(board: np.ndarray, r: int, c: int):
    """Flood-fill the group containing (r,c); returns (group cells,
    liberty count) — the semantics behind calculate_liberties
    (go.c:189-208)."""
    side = board[r, c]
    group, libs = set(), set()
    q = deque([(r, c)])
    seen = {(r, c)}
    while q:
        y, x = q.popleft()
        group.add((y, x))
        for ny, nx in ((y + 1, x), (y - 1, x), (y, x + 1), (y, x - 1)):
            if not (0 <= ny < BOARD and 0 <= nx < BOARD):
                continue
            v = board[ny, nx]
            if v == 0:
                libs.add((ny, nx))
            elif v == side and (ny, nx) not in seen:
                seen.add((ny, nx))
                q.append((ny, nx))
    return group, len(libs)


def move_go(board: np.ndarray, player: int, r: int, c: int) -> None:
    """Place a stone and remove captured opponent groups in place
    (move_go, go.c:307-316)."""
    board[r, c] = player
    for ny, nx in ((r + 1, c), (r - 1, c), (r, c + 1), (r, c - 1)):
        if 0 <= ny < BOARD and 0 <= nx < BOARD \
                and board[ny, nx] == -player:
            group, libs = _group_and_liberties(board, ny, nx)
            if libs == 0:
                for gy, gx in group:
                    board[gy, gx] = 0


def suicide_go(board: np.ndarray, player: int, r: int, c: int) -> bool:
    """True when playing at (r,c) is suicide (suicide_go,
    go.c:318-341): safe iff some neighbor is empty, a 1-liberty enemy
    group (capture), or an own group with >1 liberty."""
    for ny, nx in ((r + 1, c), (r - 1, c), (r, c + 1), (r, c - 1)):
        if not (0 <= ny < BOARD and 0 <= nx < BOARD):
            continue
        v = board[ny, nx]
        if v == 0:
            return False
        _, libs = _group_and_liberties(board, ny, nx)
        if v == -player and libs == 1:
            return False
        if v == player and libs > 1:
            return False
    return True


def legal_go(board: np.ndarray, ko: np.ndarray | None, player: int,
             r: int, c: int) -> bool:
    """Occupied cells and the ko-repeat position are illegal
    (legal_go, go.c:343-355: the resulting position must differ from
    the board string two plies back)."""
    if board[r, c] != 0:
        return False
    if ko is not None:
        nxt = board.copy()
        move_go(nxt, player, r, c)
        if np.array_equal(board_to_string(nxt), ko):
            return False
    return True


# ---------------------------------------------------------------------
# scoring (score_game, go.c:705-746)
# ---------------------------------------------------------------------

def _gnugo_available() -> bool:
    import shutil
    return shutil.which("gnugo") is not None


def tromp_taylor_score(board: np.ndarray, komi: float = KOMI) -> float:
    """Native area scoring: stones + empty regions bordering exactly
    one color; positive = black. The in-process stand-in for the
    reference's `gnugo final_score` pipe (go.c:705-746)."""
    b = np.asarray(board)
    score = float((b == 1).sum() - (b == -1).sum())
    seen = np.zeros_like(b, bool)
    for r in range(BOARD):
        for c in range(BOARD):
            if b[r, c] != 0 or seen[r, c]:
                continue
            q = deque([(r, c)])
            seen[r, c] = True
            region, borders = [], set()
            while q:
                y, x = q.popleft()
                region.append((y, x))
                for ny, nx in ((y + 1, x), (y - 1, x),
                               (y, x + 1), (y, x - 1)):
                    if not (0 <= ny < BOARD and 0 <= nx < BOARD):
                        continue
                    if b[ny, nx] == 0 and not seen[ny, nx]:
                        seen[ny, nx] = True
                        q.append((ny, nx))
                    elif b[ny, nx] != 0:
                        borders.add(int(b[ny, nx]))
            if borders == {1}:
                score += len(region)
            elif borders == {-1}:
                score -= len(region)
    return score - komi


def _gnugo_game_lines(board: np.ndarray, final: str) -> list[str]:
    lines = ["komi 6.5", "boardsize 19", "clear_board"]
    for j in range(BOARD):
        for i in range(BOARD):
            if board[j, i] == 0:
                continue
            color = "black" if board[j, i] == 1 else "white"
            col = chr(ord('A') + i + (1 if i >= 8 else 0))
            lines.append(f"play {color} {col}{19 - j}")
    lines.append(final)
    return lines


def score_game(board: np.ndarray) -> float:
    """gnugo final_score when available, Tromp-Taylor otherwise."""
    if _gnugo_available():
        import subprocess
        script = "\n".join(_gnugo_game_lines(board, "final_score")) + "\n"
        out = subprocess.run(["gnugo", "--mode", "gtp"],
                             input=script, capture_output=True,
                             text=True, timeout=120).stdout
        for line in out.splitlines():
            line = line.strip()
            if line.startswith("=") and "+" in line:
                tok = line.split()[-1]          # e.g. B+12.5 / W+3.5
                side, _, val = tok.partition("+")
                try:
                    v = float(val)
                except ValueError:
                    continue
                return v if side.endswith("B") else -v
    return tromp_taylor_score(board)


# ---------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------

def _dihedral(x: np.ndarray, i: int) -> np.ndarray:
    """Transform i in 0..7: rotate cw i%4 times, then horizontal flip
    for i>=4 — the ensemble of predict_move (go.c:269-291)."""
    y = np.rot90(x, -(i % 4))
    return y[:, ::-1] if i >= 4 else y


def _dihedral_inv(x: np.ndarray, i: int) -> np.ndarray:
    y = x[:, ::-1] if i >= 4 else x
    return np.rot90(y, i % 4)


class GoEngine:
    """Policy net wrapper: single or 8-fold dihedral prediction, legal
    move generation with temperature sampling (generate_move,
    go.c:358-421), the net on ``device``."""

    def __init__(self, cfg: str, weights: str | None = None, *,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            from ..infer.detector import disable_tf32
            disable_tf32()
        self.spec = parse_network_cfg(cfg)
        if weights:
            params, _ = load_weights(self.spec, weights)
        else:
            from ..io.weights import init_params
            params = init_params(self.spec)
        self.params = params_to_torch(self.spec, params, self.device)
        self._nets: dict[float, Network] = {}
        self.rng = np.random.default_rng(0)

    def _net(self, temperature: float = 1.0) -> Network:
        t = float(temperature)
        if t not in self._nets:
            spec = self.spec
            if t != 1.0:
                # generate_move sets every layer's temperature
                # (go.c:362); only softmax layers consume it
                layers = tuple(
                    dataclasses.replace(l, temperature=t)
                    if isinstance(l, S.SoftmaxSpec) else l
                    for l in spec.layers)
                spec = S.NetworkSpec(net=spec.net, layers=layers,
                                     cfg_path=spec.cfg_path)
            self._nets[t] = Network(spec, self.params)
        return self._nets[t]

    @torch.no_grad()
    def forward(self, x: np.ndarray, temperature: float = 1.0
                ) -> np.ndarray:
        """(B, 19, 19, 1) boards -> (B, 361) move distributions."""
        out, _ = self._net(temperature)(
            torch.from_numpy(np.ascontiguousarray(x, np.float32))
            .to(self.device))
        return out.reshape(x.shape[0], -1).cpu().numpy()

    def predict_move(self, board: np.ndarray, multi: bool = False,
                     temperature: float = 1.0) -> np.ndarray:
        """(19,19) board -> (19,19) move distribution, occupied cells
        zeroed (predict_move, go.c:269-291). multi averages the 8
        dihedral transforms in ONE batched forward."""
        if multi:
            xs = np.stack([_dihedral(board, i) for i in range(8)])
            x = xs.astype(np.float32).reshape(8, BOARD, BOARD, 1)
            outs = self.forward(x, temperature).reshape(8, BOARD, BOARD)
            move = np.mean([_dihedral_inv(outs[i], i)
                            for i in range(8)], axis=0)
        else:
            x = board.astype(np.float32).reshape(1, BOARD, BOARD, 1)
            move = self.forward(x, temperature).reshape(BOARD, BOARD)
        return np.where(board == 0, move, 0.0)

    def generate_move(self, player: int, board: np.ndarray,
                      multi: bool = False, thresh: float = 0.1,
                      temperature: float = 0.7,
                      ko: np.ndarray | None = None) -> int:
        """Returns a flat move index, or -1 for pass (generate_move,
        go.c:358-421): predict from the mover's perspective, zero
        illegal moves, keep the top-5 above an adaptive threshold,
        sample proportionally, fall back to argmax on suicide."""
        view = board * player                  # flip_board for white
        move = self.predict_move(view, multi, temperature)
        for r in range(BOARD):
            for c in range(BOARD):
                if move[r, c] and not legal_go(board, ko, player, r, c):
                    move[r, c] = 0.0
        flat = move.reshape(-1)
        order = np.argsort(-flat)[:NIND]
        if thresh > flat[order[0]]:
            thresh = flat[order[NIND - 1]]
        flat = np.where(flat < thresh, 0.0, flat)
        if flat.sum() <= 0:
            return -1
        max_i = int(np.argmax(flat))
        index = int(self.rng.choice(N, p=flat / flat.sum()))
        if suicide_go(board, player, max_i // BOARD, max_i % BOARD):
            return -1
        if suicide_go(board, player, index // BOARD, index % BOARD):
            index = max_i
        return index

    def best_move(self, board: np.ndarray) -> tuple[int, int]:
        i = int(np.argmax(self.predict_move(np.asarray(board, np.float32))))
        return i // BOARD, i % BOARD


# ---------------------------------------------------------------------
# board rendering (print_board, go.c:210-253)
# ---------------------------------------------------------------------

def format_board(board: np.ndarray, swap: int = 1,
                 indexes=None) -> str:
    out = ["\n\n   " + " ".join(
        chr(ord('A') + i + (1 if i > 7 else 0)) for i in range(BOARD))]
    marks = {int(ix): n for n, ix in enumerate(indexes or []) if ix >= 0}
    for j in range(BOARD):
        row = [f"{BOARD - j:2d}"]
        for i in range(BOARD):
            idx = j * BOARD + i
            if idx in marks:
                row.append(f" {marks[idx] + 1}")
            elif board[j, i] * -swap > 0:
                row.append(" O")
            elif board[j, i] * -swap < 0:
                row.append(" X")
            else:
                row.append("  ")
        out.append("".join(row))
    return "\n".join(out)


# ---------------------------------------------------------------------
# modes
# ---------------------------------------------------------------------

def train_go(cfg: str, weights, argv, *, device="cuda"):
    """train_go (go.c:118-171): random augmented batches, the float32
    Trainer on ``device``, running 0.95/0.05 avg loss, epoch + cadence
    checkpoints. Returns (trainer, per-step losses)."""
    from .cli import find_value
    from ..train.trainer import Trainer
    from ..io import checkpoint as ckpt
    moves_path = find_value(argv, "-moves", "go.train")
    backup = find_value(argv, "-backup", "backup")
    spec = parse_network_cfg(cfg)
    params = None
    if weights:
        params, _ = load_weights(spec, weights)
    if torch.device(device).type == "cuda":
        from ..infer.detector import disable_tf32
        disable_tf32()
    trainer = Trainer(spec, params=params, device=device)
    moves = load_go_moves(moves_path)
    print(len(moves))
    rng = np.random.default_rng(0)
    outer = trainer.outer_batch
    os.makedirs(backup, exist_ok=True)
    base = os.path.splitext(os.path.basename(cfg))[0]
    limit = spec.net.max_batches or 0
    n_data = len(moves)
    epoch = int(trainer.state.seen) // max(n_data, 1)
    avg = None
    losses = []
    while True:
        i = int(trainer.state.seen) // outer + 1
        if limit and i > limit:
            break
        boards, labels = random_go_moves(moves, rng, outer)
        m = trainer.step(boards.reshape(outer, BOARD, BOARD, 1),
                         labels.reshape(outer, N))
        loss = float(m["loss"]) / outer
        losses.append(loss)
        avg = loss if avg is None else avg * .95 + loss * .05
        seen = int(trainer.state.seen)
        print(f"{i}, {seen / max(n_data, 1):.3f}: {loss:f}, "
              f"{avg:f} avg, {float(m['lr']):f} rate, {seen} images")
        if seen // max(n_data, 1) > epoch:       # per-epoch weights
            epoch = seen // max(n_data, 1)
            ckpt.export_weights(
                os.path.join(backup, f"{base}_{epoch}.weights"),
                spec, trainer.state)
        if i % 100 == 0:                          # .backup cadence
            ckpt.export_weights(os.path.join(backup, f"{base}.backup"),
                                spec, trainer.state)
    ckpt.export_weights(os.path.join(backup, f"{base}.weights"),
                        spec, trainer.state)
    return trainer, losses


def valid_go(cfg: str, weights, argv, *, device="cuda"):
    """valid_go (go.c:402-432): top-1 move-prediction accuracy over a
    moves file."""
    from .cli import find_value, find_arg
    multi = find_arg(argv, "-multi")
    moves_path = find_value(argv, "-moves", "go.test")
    eng = GoEngine(cfg, weights, device=device)
    moves = load_go_moves(moves_path)
    correct = 0
    for i, rec in enumerate(moves):
        truth = int(rec[1]) + BOARD * int(rec[0])
        board = string_to_board(rec[2:])
        move = eng.predict_move(board, multi=multi)
        if int(np.argmax(move)) == truth:
            correct += 1
        print(f"{i} Accuracy {correct / (i + 1):f}")
    return correct / max(len(moves), 1)


def test_go(cfg: str, weights, argv, stdout=None, *, device="cuda"):
    """test_go (go.c:607-703): interactive analysis loop — show top-5
    suggestions, accept a pick / coordinate / edits, flip sides.
    Returns a ``step(line)`` closure so tests can drive it without a
    tty; ``run_test_go`` wires it to stdin. As in the JAX module, the
    step hands the top-5 to ``format_board`` as a numpy array, whose
    ``indexes or []`` raises ValueError on it (ROADMAP queue 3, item
    19): the port keeps the reference's behaviour."""
    from .cli import find_arg
    multi = find_arg(list(argv), "-multi")
    stdout = stdout or sys.stdout
    eng = GoEngine(cfg, weights, device=device)
    board = np.zeros((BOARD, BOARD), np.float32)
    color = 1

    def step(line: str):
        nonlocal board, color
        move = eng.predict_move(board, multi=multi)
        order = np.argsort(-move.reshape(-1))[:NIND]
        stdout.write(format_board(board, color, order) + "\n")
        for n, ix in enumerate(order):
            r, c = int(ix) // BOARD, int(ix) % BOARD
            col = chr(ord('A') + c + (1 if c > 7 else 0))
            stdout.write(f"{n + 1}: {col} {BOARD - r}, "
                         f"{move.reshape(-1)[ix] * 100:.2f}%\n")
        stdout.write(("X" if color == 1 else "O") + " Enter move: ")
        _apply_test_input(board, color, line, order)
        board *= -1           # flip_board + color swap (go.c:699-700)
        color = -color
    return step


def _apply_test_input(board, color, line, order):
    """Input grammar of test_go (go.c:648-697): empty/number = pick a
    suggestion; 'C17' = play there; 'b C17'/'w C17' = place a stone;
    'c C17' = clear; 'p' = pass."""
    line = line.strip()
    if line == "" or line.isdigit():
        picked = int(line) - 1 if line else 0
        if 0 <= picked < NIND:
            ix = int(order[picked])
            board[ix // BOARD, ix % BOARD] = 1
        return
    c0 = line[0]
    if 'A' <= c0 <= 'T':
        parts = line.replace(",", " ").split()
        col = ord(parts[0][0]) - ord('A')
        if col > 7:
            col -= 1
        row = BOARD - int(parts[1] if len(parts) > 1 else parts[0][1:])
        board[row, col] = 1
    elif c0 == 'p':
        pass
    elif c0 in ('b', 'w', 'c'):
        parts = line.split()
        if len(parts) == 3:
            col = ord(parts[1][0]) - ord('A')
            if col > 7:
                col -= 1
            row = BOARD - int(parts[2])
            if c0 == 'c':
                board[row, col] = 0
            else:
                board[row, col] = color if c0 == 'b' else -color


def run_test_go(cfg: str, weights, argv, *, device="cuda"):
    """Interactive loop of test_go on real stdin."""
    step = test_go(cfg, weights, argv, device=device)
    step("")                   # show the opening suggestions
    for line in sys.stdin:
        step(line)


def self_go(cfg: str, weights, cfg2=None, w2=None, argv=(), out=None, *,
            device="cuda"):
    """self_go (go.c:748-824): two nets alternate colors across games;
    each finished game is scored and the WINNER's moves are emitted in
    the training-record format (winner-perspective boards). Records are
    raw 94-byte binary (93 bytes + newline), exactly what
    ``load_go_moves`` reads — written to the binary layer of ``out``
    (the reference printf's raw bytes, go.c:786-791). Returns the
    games' scores."""
    from .cli import find_arg, find_value
    multi = find_arg(list(argv), "-multi")
    max_games = find_value(list(argv), "-games", 0, int)
    out = out or sys.stdout
    if hasattr(out, "buffer"):
        out = out.buffer               # text stream -> raw bytes
    eng1 = GoEngine(cfg, weights, device=device)
    eng2 = GoEngine(cfg2, w2, device=device) if cfg2 else eng1
    board = np.zeros((BOARD, BOARD), np.float32)
    records: list[bytes] = []
    one = board_to_string(board)
    two = board_to_string(board)
    player, total, p1, p2 = 1, 0, 0, 0
    results = []
    while True:
        done = False
        if len(records) >= 300:
            done = True
        else:
            eng = eng1 if ((total % 2 == 0) == (player == 1)) else eng2
            index = eng.generate_move(player, board, multi=multi,
                                      ko=two)
            if index < 0:
                done = True
        if done:
            score = score_game(board)
            i = 0 if score > 0 else 1
            if (score > 0) == (total % 2 == 0):
                p1 += 1
            else:
                p2 += 1
            total += 1
            results.append(score)
            print(f"Total: {total}, Player 1: {p1 / total:f}, "
                  f"Player 2: {p2 / total:f}", file=sys.stderr)
            for j in range(i, len(records), 2):    # winner's moves
                out.write(records[j] + b"\n")
            board[:] = 0
            records = []
            one = board_to_string(board)
            two = board_to_string(board)
            player = 1
            if max_games and total >= max_games:
                return results
            continue
        r, c = index // BOARD, index % BOARD
        two = one
        view = board * player                 # mover's perspective
        rec = bytes([r, c]) + board_to_string(view).tobytes()
        records.append(rec)
        move_go(board, player, r, c)
        one = board_to_string(board)
        player = -player


def engine_go(cfg: str, weights, argv, stdin=None, stdout=None, *,
              device="cuda"):
    """engine_go (go.c:434-605): the GTP command loop. Commands:
    protocol_version, name, version, known_command, list_commands,
    quit, boardsize, clear_board, komi, play, genmove,
    final_status_list (dead-stone query answered via gnugo when
    available, empty otherwise)."""
    from .cli import find_arg
    multi = find_arg(list(argv), "-multi")
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    eng = GoEngine(cfg, weights, device=device)
    board = np.zeros((BOARD, BOARD), np.float32)
    one = board_to_string(board)
    two = board_to_string(board)
    passed = False
    known = {"protocol_version", "name", "version", "known_command",
             "list_commands", "quit", "boardsize", "clear_board",
             "komi", "final_status_list", "play", "genmove"}

    def reply(ids, body=""):
        stdout.write(f"={ids} {body}\n\n" if body else f"={ids} \n\n")
        stdout.flush()

    def fail(ids, body):
        stdout.write(f"?{ids} {body}\n\n")
        stdout.flush()

    for raw in stdin:
        toks = raw.split()
        if not toks:
            continue
        ids = ""
        if toks[0].lstrip("-").isdigit():
            ids = toks[0]
            toks = toks[1:]
        if not toks:
            continue
        cmd = toks[0]
        if cmd == "protocol_version":
            reply(ids, "2")
        elif cmd == "name":
            reply(ids, "SRGo")
        elif cmd == "version":
            reply(ids, "1.0")
        elif cmd == "known_command":
            reply(ids, "true" if len(toks) > 1 and toks[1] in known
                  else "false")
        elif cmd == "list_commands":
            stdout.write(f"={ids} " + "\n".join(sorted(known)) + "\n\n")
            stdout.flush()
        elif cmd == "quit":
            reply(ids)
            break
        elif cmd == "boardsize":
            if len(toks) > 1 and toks[1] == "19":
                reply(ids)
            else:
                fail(ids, "unacceptable size")
        elif cmd == "clear_board":
            passed = False
            board[:] = 0
            one = board_to_string(board)
            two = board_to_string(board)
            reply(ids)
        elif cmd == "komi":
            reply(ids)
        elif cmd == "play":
            if len(toks) < 3:
                fail(ids, "syntax error")
                continue
            color, vertex = toks[1], toks[2]
            player = 1 if color[0] in "bB" else -1
            if vertex[0] in "pP":          # pass
                passed = True
                reply(ids)
                continue
            passed = False
            c = ord(vertex[0].upper()) - ord('A')
            if c >= 8:
                c -= 1                     # GTP skips 'I'
            r = BOARD - int(vertex[1:])
            two = one
            move_go(board, player, r, c)
            one = board_to_string(board)
            reply(ids)
            print(format_board(board, 1), file=sys.stderr)
        elif cmd == "genmove":
            player = 1 if len(toks) > 1 and toks[1][0] in "bB" else -1
            index = eng.generate_move(player, board, multi=multi,
                                      thresh=.1, temperature=.7, ko=two)
            if passed or index < 0:
                reply(ids, "pass")
                passed = False
            else:
                r, c = index // BOARD, index % BOARD
                two = one
                move_go(board, player, r, c)
                one = board_to_string(board)
                col = c + 1 if c >= 8 else c
                reply(ids, f"{chr(ord('A') + col)}{BOARD - r}")
                print(format_board(board, 1), file=sys.stderr)
        elif cmd == "final_status_list":
            if len(toks) > 1 and toks[1][0] in "dD" \
                    and _gnugo_available():
                import subprocess
                script = "\n".join(_gnugo_game_lines(
                    board, "final_status_list dead")) + "\n"
                res = subprocess.run(
                    ["gnugo", "--mode", "gtp"], input=script,
                    capture_output=True, text=True, timeout=120).stdout
                dead = res.strip().splitlines()[-1].lstrip("= ").strip()
                reply(ids, dead)
            else:
                reply(ids)     # no gnugo: report no dead stones
        else:
            fail(ids, "unknown command")
    return 0


_VALUE_FLAGS = {"-moves", "-backup", "-games"}


def _positionals(rest):
    """Positional args with -flag [value] pairs skipped (the mode
    functions splice the flags themselves via find_value)."""
    vals, skip = [], False
    for a in rest:
        if skip:
            skip = False
            continue
        if a in _VALUE_FLAGS:
            skip = True
            continue
        if a.startswith("-"):
            continue
        vals.append(a)
    return vals


def run_go(argv, *, device="cuda"):
    """CLI dispatcher (run_go, go.c:826-845):
    go [train|valid|test|self|engine] <cfg> [weights] ..."""
    argv = list(argv)
    if argv and argv[0] in ("train", "valid", "test", "self",
                            "engine"):
        mode = argv[0]
        rest = argv[1:]
        pos = _positionals(rest)
        cfg = pos[0]
        weights = pos[1] if len(pos) > 1 else None
        if mode == "train":
            return train_go(cfg, weights, rest, device=device)
        if mode == "valid":
            return valid_go(cfg, weights, rest, device=device)
        if mode == "test":
            return run_test_go(cfg, weights, rest, device=device)
        if mode == "self":
            c2 = pos[2] if len(pos) > 2 else None
            w2 = pos[3] if len(pos) > 3 else None
            return self_go(cfg, weights, c2, w2, rest, device=device)
        if mode == "engine":
            return engine_go(cfg, weights, rest, device=device)
    # legacy round-1 surface: `go <cfg> [weights]` suggestion demo; its
    # column letter does not skip 'I' as GTP's do (ROADMAP queue 3, item
    # 20), as in the JAX module
    cfg = argv[0]
    weights = argv[1] if len(argv) > 1 else None
    eng = GoEngine(cfg, weights, device=device)
    board = np.zeros((BOARD, BOARD), np.int8)
    r, c = eng.best_move(board)
    print(f"suggested opening: {chr(ord('A') + c)}{BOARD - r}")
    return eng


__all__ = ["GoEngine", "run_go", "BOARD", "load_go_moves",
           "string_to_board", "board_to_string", "random_go_moves",
           "move_go", "suicide_go", "legal_go", "score_game",
           "tromp_taylor_score", "train_go", "valid_go", "self_go",
           "engine_go"]
