"""char-RNN application: train / generate / validate.

Counterpart of ``sr_object_detection_tpu/apps/rnn_app.py``
(run_char_rnn, src_yolo2/rnn.c:469-492): a byte-level language model over
the reference's RNN/GRU layers; training folds time_steps into the batch
(step-major) and runs the float32 ``Trainer`` on the cost head,
generation runs the recurrence statefully with temperature sampling
(rnn.c test_char_rnn).

  rnn train <cfg> <text> [weights] [-backup dir]
  rnn generate <cfg> [weights] [-len N] [-temp T] [-seed S]
  rnn generatetactic <cfg> [weights] [-len N] [-temp T] [-srand S] < text
  rnn valid <cfg> <weights> <text> [-len N]
  rnn validtactic <cfg> <weights> <text> [-seed S]
  rnn vec <cfg> [weights] [-seed S] < lines

Every mode runs on ``device`` (CUDA unless the CLI's -cpu). The sampler
keeps its states on the device and draws from the same
``np.random.default_rng`` calls as the JAX module, so a CPU run writes
the JAX module's text. ``CharStream`` and ``VOCAB`` are the JAX module's,
copied as they are.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..graph import spec as S
from ..graph.compiler import _softmax
from ..io import checkpoint as ckpt
from ..io.convert import params_to_torch
from ..io.weights import init_params, load_weights
from ..ops import conv as C
from ..ops import rnn as R
from ..ops.activations import get_activation
from .cli import find_value


VOCAB = 256


class CharStream:
    """Step-major one-hot batches (rnn.c train_char_rnn's stream
    layout: x[t*batch + b], y = next char)."""

    def __init__(self, text: bytes, batch: int, steps: int, seed: int = 0):
        self.text = np.frombuffer(text, dtype=np.uint8)
        self.batch = batch
        self.steps = steps
        self.rng = np.random.default_rng(seed)
        self.offsets = self.rng.integers(0, max(len(self.text) - steps - 1,
                                                1), batch)

    def next_batch(self):
        n = len(self.text)
        x = np.zeros((self.steps, self.batch, VOCAB), np.float32)
        y = np.zeros((self.steps, self.batch, VOCAB), np.float32)
        for b in range(self.batch):
            o = int(self.offsets[b])
            if o + self.steps + 1 >= n:
                o = int(self.rng.integers(0, max(n - self.steps - 1, 1)))
            idx = self.text[o:o + self.steps]
            nxt = self.text[o + 1:o + self.steps + 1]
            x[np.arange(self.steps), b, idx] = 1.0
            y[np.arange(self.steps), b, nxt] = 1.0
            self.offsets[b] = o + self.steps
        return (x.reshape(self.steps * self.batch, VOCAB),
                y.reshape(self.steps * self.batch, VOCAB))


class CharRNNSampler:
    """Stateful single-char forward for generation: threads the RNN
    hidden states explicitly (the C keeps l.state across
    network_predict calls, rnn_layer.c:96-118), as tensors on
    ``device``. ``_step(params, x, states)`` -> (probs, states) and
    ``_step0`` (which adds the first layer's output, for vec mode) are
    the JAX sampler's jitted steps."""

    def __init__(self, spec: S.NetworkSpec, params, *, device="cuda"):
        from ..infer.detector import disable_tf32
        self.spec = spec
        self.device = torch.device(device)
        if self.device.type == "cuda":
            disable_tf32()
        self.params = params_to_torch(spec, params, self.device)
        # one-hot rows of the vocabulary, on the device
        self.eye = torch.eye(VOCAB, device=self.device)

    def init_state(self):
        states = []
        for l in self.spec.layers:
            if isinstance(l, S.RNNSpec):
                states.append(torch.zeros((1, l.hidden), device=self.device))
            elif isinstance(l, S.GRUSpec):
                states.append(torch.zeros((1, l.output), device=self.device))
        return states

    def one_hot(self, ch: int):
        return self.eye[ch:ch + 1]

    def _step(self, params, x, states):
        cur, new_states, _ = self._forward(params, x, states)
        return cur, new_states

    def _step0(self, params, x, states):
        return self._forward(params, x, states)

    @torch.no_grad()
    def _forward(self, params, x, states):
        si = 0
        first_out = None
        new_states = list(states)
        cur = x
        for i, l in enumerate(self.spec.layers):
            if isinstance(l, S.RNNSpec):
                cur, new_states[si] = R.rnn_forward_stateful(
                    cur, params[i], l, states[si])
                si += 1
            elif isinstance(l, S.GRUSpec):
                cur, new_states[si] = R.gru_cell(
                    cur, params[i], states[si], l.batch_normalize)
                si += 1
            elif isinstance(l, S.ConnectedSpec):
                cur = C.connected(cur, params[i],
                                  get_activation(l.activation),
                                  batch_normalize=l.batch_normalize)
            elif isinstance(l, S.SoftmaxSpec):
                cur = _softmax(cur / l.temperature)
            elif isinstance(l, (S.DropoutSpec, S.CostSpec)):
                pass
            elif isinstance(l, S.ActivationSpec):
                cur = get_activation(l.activation)(cur)
            else:
                raise NotImplementedError(
                    f"char-rnn sampler: layer {l.kind}")
            if i == 0:
                first_out = cur
        return cur, new_states, first_out

    def generate(self, seed_text: bytes, length: int,
                 temperature: float = 0.7, rng_seed: int = 0) -> bytes:
        states = self.init_state()
        rng = np.random.default_rng(rng_seed)
        out = bytearray(seed_text)
        probs = None
        for ch in seed_text:
            probs, states = self._step(self.params, self.one_hot(ch), states)
        cur = seed_text[-1] if seed_text else 0
        for _ in range(length):
            probs, states = self._step(self.params, self.one_hot(cur),
                                       states)
            p = probs[0].cpu().numpy().astype(np.float64)
            if temperature != 1.0:
                # temperature resampling like rnn.c (logits rescale)
                logp = np.log(np.maximum(p, 1e-12)) / temperature
                p = np.exp(logp - logp.max())
            p = p / p.sum()
            cur = int(rng.choice(VOCAB, p=p))
            out.append(cur)
        return bytes(out)


def train_rnn(cfg: str, text_file: str, weights: str | None,
              argv: list[str], *, device="cuda"):
    """train_char_rnn (rnn.c:83-163): one step-major block of
    ``batch / time_steps`` streams a subdivision, the float32 Trainer on
    the cost head, ``rnn_<N>.weights`` every 1000 batches."""
    import os
    from ..train.trainer import Trainer
    spec = S.parse_network_cfg(cfg)
    params = None
    if weights:
        params, _ = load_weights(spec, weights)
    if torch.device(device).type == "cuda":
        from ..infer.detector import disable_tf32
        disable_tf32()
    trainer = Trainer(spec, params=params, device=device)
    steps = spec.net.time_steps
    micro_batch = spec.net.batch // steps
    with open(text_file, "rb") as f:
        text = f.read()
    stream = CharStream(text, micro_batch, steps)
    max_batches = spec.net.max_batches or 1000
    backup = find_value(argv, "-backup", "backup")
    os.makedirs(backup, exist_ok=True)
    avg = None
    while True:
        i = int(trainer.state.seen) // trainer.outer_batch + 1
        if i > max_batches:
            break
        # one step-major block per subdivision, concatenated so the
        # trainer's (subdivs, micro, ...) reshape slices them cleanly
        blocks = [stream.next_batch() for _ in range(spec.net.subdivisions)]
        x = np.concatenate([b[0] for b in blocks])
        y = np.concatenate([b[1] for b in blocks])
        m = trainer.step(x, y)
        loss = float(m["loss"]) / trainer.outer_batch
        avg = loss if avg is None else avg * .9 + loss * .1
        if i % 10 == 0:
            print(f"{i}: {loss:.6f}, {avg:.6f} avg")
        if i % 1000 == 0:
            ckpt.export_weights(f"{backup}/rnn_{i}.weights", spec,
                                trainer.state)
    return trainer


def _sampler(cfg: str, weights: str | None, device):
    spec = S.parse_network_cfg(cfg)
    params = load_weights(spec, weights)[0] if weights else \
        init_params(spec)
    return CharRNNSampler(spec, params, device=device)


def generate_rnn(cfg: str, weights: str | None, argv: list[str], *,
                 device="cuda"):
    seed = find_value(argv, "-seed", "\n").encode()
    length = find_value(argv, "-len", 200, int)
    temp = find_value(argv, "-temp", 0.7, float)
    sampler = _sampler(cfg, weights, device)
    text = sampler.generate(seed, length, temperature=temp)
    sys.stdout.write(text.decode("latin-1"))
    sys.stdout.write("\n")
    return text


def validate_rnn(cfg: str, weights: str, text_file: str,
                 argv: list[str], *, device="cuda"):
    """valid_char_rnn (rnn.c:390-430): mean log-loss / perplexity of the
    model on a text stream, evaluated with the stateful sampler."""
    import math
    sampler = _sampler(cfg, weights, device)
    with open(text_file, "rb") as f:
        text = f.read()
    limit = find_value(argv, "-len", 2000, int)
    text = text[:limit + 1]
    states = sampler.init_state()
    total = 0.0
    count = 0
    for cur, nxt in zip(text[:-1], text[1:]):
        probs, states = sampler._step(sampler.params, sampler.one_hot(cur),
                                      states)
        p = float(probs[0, nxt])
        total += math.log(max(p, 1e-12))
        count += 1
    mean_ll = total / max(count, 1)
    print(f"log-loss: {-mean_ll:.4f}  perplexity: {math.exp(-mean_ll):.2f}")
    return -mean_ll


def _feed(sampler, states, data: bytes):
    """Feed chars through the stateful sampler; return (probs, states)
    after the last char."""
    probs = None
    for ch in data:
        probs, states = sampler._step(sampler.params, sampler.one_hot(ch),
                                      states)
    return probs, states


def valid_tactic_rnn(cfg: str, weights: str, text_file: str,
                     argv: list[str], out=None, *, device="cuda"):
    """valid_tactic_rnn (rnn.c:327-377): perplexity over only the
    in-tactic spans — scoring turns on after a '>>' marker, off after
    '.\\n'; words = number of '>>' markers."""
    import math
    out = out or sys.stdout
    sampler = _sampler(cfg, weights, device)
    seed = find_value(argv, "-seed", "").encode("latin-1")
    with open(text_file, "rb") as f:
        text = f.read()
    states = sampler.init_state()
    _, states = _feed(sampler, states, seed)
    total = 0.0
    count = 0
    words = 1
    in_tactic = 0
    log2 = math.log(2)
    last = None
    for i in range(len(text) - 1):
        c, nxt = text[i], text[i + 1]
        probs, states = sampler._step(sampler.params, sampler.one_hot(c),
                                      states)
        if c == ord(".") and nxt == ord("\n"):
            in_tactic = 0
        if not in_tactic:
            if c == ord(">") and nxt == ord(">"):
                in_tactic = 1
                words += 1
            continue
        count += 1
        p = float(probs[0, nxt])
        total += math.log(max(p, 1e-12)) / log2
        last = (2 ** (-total / count), 2 ** (-total / words))
        out.write(f"{count} {words} Perplexity: {last[0]:4.4f}    "
                  f"Word Perplexity: {last[1]:4.4f}\n")
    return last


def vec_char_rnn(cfg: str, weights: str, argv: list[str],
                 lines=None, out=None, *, device="cuda"):
    """vec_char_rnn (rnn.c:420-466): per input line, reset the state,
    feed seed + line + ' ', and print 'line,<first layer's output>' —
    the RNN's sentence embedding."""
    out = out or sys.stdout
    sampler = _sampler(cfg, weights, device)
    seed = find_value(argv, "-seed", "").encode("latin-1")
    if lines is None:
        lines = (l.rstrip("\n") for l in sys.stdin)
    vecs = []
    for line in lines:
        states = sampler.init_state()
        _, states = _feed(sampler, states, seed)
        _, states = _feed(sampler, states, line.encode("latin-1"))
        _, states, first = sampler._step0(sampler.params,
                                          sampler.one_hot(ord(" ")), states)
        v = first.cpu().numpy().reshape(-1)
        out.write(line + "".join(f",{f:g}" for f in v) + "\n")
        vecs.append(v)
    return vecs


def generate_tactic_rnn(cfg: str, weights: str, argv: list[str],
                        prime: bytes | None = None, out=None, *,
                        device="cuda"):
    """test_tactic_rnn (rnn.c:282-325): prime the state with the whole
    input stream, then sample until num chars or a '.\\n' boundary;
    probabilities below 1e-4 are zeroed before sampling."""
    out = out or sys.stdout
    num = find_value(argv, "-len", 100, int)
    temp = find_value(argv, "-temp", 0.7, float)
    rseed = find_value(argv, "-srand", 0, int)
    sampler = _sampler(cfg, weights, device)
    rng = np.random.default_rng(rseed)
    if prime is None:
        prime = sys.stdin.buffer.read()
    states = sampler.init_state()
    probs, states = _feed(sampler, states, prime)
    c = prime[-1] if prime else 0
    text = bytearray()
    for _ in range(num):
        p = probs[0].cpu().numpy().astype(np.float64)
        if temp != 1.0:
            logp = np.log(np.maximum(p, 1e-12)) / temp
            p = np.exp(logp - logp.max())
        p[p < 1e-4] = 0.0           # rnn.c:311 out[j]<.0001 -> 0
        p /= p.sum()
        nxt = int(rng.choice(VOCAB, p=p))
        if c == ord(".") and nxt == ord("\n"):
            break
        c = nxt
        text.append(c)
        probs, states = sampler._step(sampler.params, sampler.one_hot(c),
                                      states)
    out.write(text.decode("latin-1") + "\n")
    return bytes(text)


def run_char_rnn(argv: list[str], *, device="cuda"):
    sub = argv.pop(0)
    if sub == "train":
        return train_rnn(argv[0], argv[1],
                         argv[2] if len(argv) > 2 else None, argv[3:],
                         device=device)
    if sub == "generate":
        return generate_rnn(argv[0],
                            argv[1] if len(argv) > 1 else None, argv[2:],
                            device=device)
    if sub == "generatetactic":
        return generate_tactic_rnn(
            argv[0], argv[1] if len(argv) > 1
            and not argv[1].startswith("-") else None,
            argv[2:] if len(argv) > 1
            and not argv[1].startswith("-") else argv[1:], device=device)
    if sub == "valid":
        return validate_rnn(argv[0], argv[1], argv[2], argv[3:],
                            device=device)
    if sub == "validtactic":
        return valid_tactic_rnn(argv[0], argv[1], argv[2], argv[3:],
                                device=device)
    if sub == "vec":
        return vec_char_rnn(
            argv[0], argv[1] if len(argv) > 1
            and not argv[1].startswith("-") else None,
            argv[2:] if len(argv) > 1
            and not argv[1].startswith("-") else argv[1:], device=device)
    raise SystemExit(f"unknown rnn subcommand {sub}")


__all__ = ["VOCAB", "CharStream", "CharRNNSampler", "train_rnn",
           "generate_rnn", "validate_rnn", "valid_tactic_rnn",
           "vec_char_rnn", "generate_tactic_rnn", "run_char_rnn"]
