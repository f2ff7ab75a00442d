"""The classifier family's training in the port (graph/compiler.py's
training forwards of every classifier kind, the cost head of
train/trainer.py, ops/layout.py's dropout, ops/conv.py's connected and
flat batchnorm in train mode) against the JAX package on the CPU.

* the float32 ``Trainer`` against the C oracle's ``train_classifier.npz``
  (weights 1e-4, costs 1e-3 with the cost doubled, as
  tests/test_train_parity.py reads it);
* the port ``Trainer`` against the JAX ``Trainer`` over 3 steps at
  subdivisions 1 and 2 on a net of every trainable classifier kind
  (dropout at probability 0 and a crop as large as its input with
  flip=0, so that neither draws): parameters, rolling statistics and
  velocities within 1e-5 (two velocities whose sums cancel within 1e-4),
  losses within 1e-5 relative;
* zero gradients for the layers past the cost head (against the JAX
  Trainer), and an error for a leaf before it that reaches no loss;
* the three cost types against ``_cost_forward``, and the softmax's
  straight-through (plain) and full (tree) backwards against
  ``jax.grad``;
* dropout and crop with the JAX forward's own draws supplied: forward
  and gradient; the port's generator draws by their statistics;
* one bf16 step of a small darknet19-shaped net against the JAX bf16
  step, within the bf16 training gate 0.03*|loss| + 0.05.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sr_object_detection_tpu.train.trainer as JT
from sr_object_detection_tpu.config import parse_cfg_text as j_parse
from sr_object_detection_tpu.graph import spec as JS
from sr_object_detection_tpu.graph.compiler import (
    _cost_forward, build_forward, resolve_trees as j_resolve_trees)
from sr_object_detection_tpu_torch.config import parse_cfg_text
from sr_object_detection_tpu_torch.graph import spec as S
from sr_object_detection_tpu_torch.data.loader import SECRET_NUM
from sr_object_detection_tpu_torch.graph.compiler import Network, cost
from sr_object_detection_tpu_torch.io.convert import (params_to_numpy,
                                                      params_to_torch)
from sr_object_detection_tpu_torch.train.trainer import Trainer
from torch_parity import (CLASSIFIER_NET, all_kinds_text, check_train_golden,
                          classifier_params, one_hot_groups)

NET = CLASSIFIER_NET

# dropout and crop that draw: the forward of the draws test
DRAWS = NET + """
[convolutional]
filters=6
size=3
stride=1
pad=1
batch_normalize=1
activation=leaky

[dropout]
probability=.4

[crop]
crop_width=9
crop_height=8
flip=1
noadjust={noadjust}

[connected]
output=10
activation=linear
"""

# darknet19's shape at small size: 3x3 + maxpool pairs, a 1x1 head conv,
# avgpool, softmax, cost
D19_SMALL = """
[net]
batch=4
subdivisions=1
height=32
width=32
channels=3
momentum=0.9
decay=0.0005
learning_rate=0.1
max_batches=100
policy=constant

[convolutional]
filters=16
size=3
stride=1
pad=1
batch_normalize=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
filters=32
size=3
stride=1
pad=1
batch_normalize=1
activation=leaky

[maxpool]
size=2
stride=2

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


def _specs(text):
    """(port spec, JAX spec) of one cfg text."""
    return (S.build_network_spec(parse_cfg_text(text)),
            JS.build_network_spec(j_parse(text)))


def test_train_classifier_golden():
    """The port's float32 Trainer reproduces the C oracle's classifier
    training (conv, conv, avgpool, softmax, sse cost, subdivisions 2)."""
    assert check_train_golden("train_classifier", "cpu") < 1e-3


# the all-kinds net's velocities whose batch-and-pixel sums cancel:
# (layer, key) of the XNOR conv's BN scales and the deconv's biases
VELOCITY_CANCELS = {(1, "scales"), (8, "biases")}


@pytest.mark.parametrize("subdivisions", [1, 2])
def test_all_kinds_trainer_matches_jax(subdivisions):
    """3 steps of the port Trainer and the JAX Trainer on the same params
    and batches: parameters, rolling statistics and velocities within
    1e-5 of each tensor's largest magnitude (measured: 2e-6 for the
    parameters, 1.4e-5 for the velocities). Two velocities are held at
    1e-4 (VELOCITY_CANCELS): they are momentum sums of raw gradients
    summed over the whole batch and every pixel, 1,152 terms for the
    deconv bias, which cancel in another order than JAX's (measured at
    subdivisions 1: deconv biases 4.9e-5, the XNOR conv's BN scales
    1.2e-5; JAX's float32 trainer cannot run in float64 to say which side
    rounds less). Each step's loss within 1e-5 relative. Batch 8, so that
    at subdivisions 2 the connected layer's BN sees 4 rows (at 2 rows its
    hand-written backward cancels to a few 1e-4 in either
    implementation)."""
    text = all_kinds_text(8, subdivisions)
    spec, jspec = _specs(text)
    assert [l.kind for l in spec.layers][13:] == ["route", "softmax", "cost"]
    assert spec.layers[13].out_c == 0 and spec.layers[13].outputs == 156
    assert spec.layers[1].xnor and spec.layers[8].kind == "deconv"
    params = classifier_params(spec, 3)
    rng = np.random.default_rng(4)
    jt = JT.Trainer(jspec, params=params)
    tt = Trainer(spec, params=params, device="cpu")
    for _ in range(3):
        x = rng.uniform(0, 1, (8, 12, 12, 3)).astype(np.float32)
        t = one_hot_groups(rng, 8, 156, 4)
        lj = float(jt.step(jnp.asarray(x), jnp.asarray(t))["loss"])
        lt = float(tt.step(x, t)["loss"])
        assert lt == pytest.approx(lj, rel=1e-5)
    for tree in ("params", "velocity"):
        mine = params_to_numpy(spec, getattr(tt.state, tree))
        want = getattr(jt.state, tree)
        for i, l in enumerate(spec.layers):
            assert mine[i].keys() == want[i].keys(), (tree, i)
            for k, v in want[i].items():
                v = np.asarray(v)
                tol = (1e-4 if tree == "velocity"
                       and (i, k) in VELOCITY_CANCELS else 1e-5)
                np.testing.assert_allclose(
                    mine[i][k], v, rtol=tol, atol=tol * np.abs(v).max(),
                    err_msg=f"{tree} layer {i} ({l.kind}) {k}")
    assert int(tt.state.seen) == int(jt.state.seen) == 24


# a connected layer past the cost head, which never runs in training
PAST_HEAD = NET + """
[connected]
output=10
activation=linear

[cost]

[connected]
output=4
activation=linear
"""

# a route that skips layer 1's output: its leaves reach no loss
SKIPPED = NET + """
[convolutional]
filters=4
size=3
stride=1
pad=1
activation=leaky

[convolutional]
filters=4
size=3
stride=1
pad=1
activation=leaky

[route]
layers=-2

[connected]
output=10
activation=linear

[cost]
"""


def test_unused_leaves_past_the_head_get_zero_gradients():
    """A layer past the cost head trains on a zero gradient (its weights
    move by the decay alone), as in the JAX Trainer: 2 steps, parameters
    and velocities within 1e-5; a leaf before the head that reaches no
    loss is an error, not a zero."""
    spec, jspec = _specs(PAST_HEAD.format(batch=4, subdivisions=1))
    assert [l.kind for l in spec.layers] == ["connected", "cost",
                                             "connected"]
    params = classifier_params(spec, 10)
    rng = np.random.default_rng(10)
    jt = JT.Trainer(jspec, params=params)
    tt = Trainer(spec, params=params, device="cpu")
    for _ in range(2):
        x = rng.uniform(0, 1, (4, 12, 12, 3)).astype(np.float32)
        t = one_hot_groups(rng, 4, 10, 1)
        lj = float(jt.step(jnp.asarray(x), jnp.asarray(t))["loss"])
        assert float(tt.step(x, t)["loss"]) == pytest.approx(lj, rel=1e-5)
    for tree in ("params", "velocity"):
        mine = params_to_numpy(spec, getattr(tt.state, tree))
        want = getattr(jt.state, tree)
        for i in (0, 2):
            for k, v in want[i].items():
                v = np.asarray(v)
                np.testing.assert_allclose(
                    mine[i][k], v, rtol=1e-5, atol=1e-5 * np.abs(v).max(),
                    err_msg=f"{tree} layer {i} {k}")
    moved = mine[2]["weights"] - params[2]["weights"]
    assert np.abs(moved).max() > 0
    vel = params_to_numpy(spec, tt.state.velocity)[2]["weights"]
    # the decay alone, twice: v1 = -d B w0, w1 = w0 (1 - lr d),
    # v2 = m v1 - d B w1 = -d B w0 (m + 1 - lr d)
    np.testing.assert_allclose(
        vel, -0.0005 * 4 * params[2]["weights"] * (1.9 - 0.05 * 0.0005),
        rtol=1e-5)
    skip = S.build_network_spec(parse_cfg_text(
        SKIPPED.format(batch=4, subdivisions=1)))
    tr = Trainer(skip, params=classifier_params(skip, 10), device="cpu")
    with pytest.raises(RuntimeError, match="not have been used"):
        tr.step(rng.uniform(0, 1, (4, 12, 12, 3)).astype(np.float32),
                one_hot_groups(rng, 4, 10, 1))


@pytest.mark.parametrize("kind", ["sse", "masked", "smooth"])
def test_cost_types_match_jax(kind):
    """Each cost against the JAX ``_cost_forward``, with its gradient;
    masked truths hold SECRET_NUM, smooth differences lie on both sides
    of 1."""
    rng = np.random.default_rng(5)
    pred = rng.normal(0, 1.5, (3, 20)).astype(np.float32)
    truth = rng.uniform(-1, 1, (3, 20)).astype(np.float32)
    truth[rng.uniform(size=truth.shape) < .3] = SECRET_NUM
    jl = JS.CostSpec(index=0, cost_type=kind, scale=0.7)
    tl = S.CostSpec(index=0, cost_type=kind, scale=0.7)
    want, jg = jax.value_and_grad(
        lambda p: _cost_forward(p, jnp.asarray(truth), jl))(
            jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    got = cost(p, torch.from_numpy(truth), tl)
    got.backward()
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)
    # a bf16 prediction costs in float32
    assert cost(p.detach().bfloat16(), torch.from_numpy(truth),
                tl).dtype == torch.float32


SOFTMAX = NET + """
[connected]
output=12
activation=linear

[softmax]
groups={groups}
temperature=1.7
{tree}
"""


@pytest.mark.parametrize("tree", [False, True])
def test_softmax_backward_matches_jax(tree, tmp_path):
    """The training softmax's gradient through a connected layer against
    ``jax.grad`` of the JAX forward: darknet's straight-through backward
    for the plain softmax (2 groups), the full Jacobian for a tree=
    softmax."""
    line = ""
    if tree:
        (tmp_path / "t.tree").write_text(
            "r0 -1\na 0\nb 0\nc 0\nr1 -1\nd 4\ne 4\nf 4\ng 4\nr2 -1\n"
            "h 9\ni 9\n")
        line = f"tree={tmp_path / 't.tree'}"
    text = SOFTMAX.format(batch=2, subdivisions=1, groups=1 if tree else 2,
                          tree=line)
    spec, jspec = _specs(text)
    params = classifier_params(spec, 6)
    rng = np.random.default_rng(6)
    x = rng.uniform(0, 1, (2, 12, 12, 3)).astype(np.float32)
    g = rng.normal(0, 1, (2, 12)).astype(np.float32)
    fwd = build_forward(jspec, trees=j_resolve_trees(jspec))

    def jloss(p):
        out, _ = fwd(p, jnp.asarray(x), train=True)
        return jnp.sum(out * g), out
    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    net = Network(spec, params_to_torch(spec, params, "cpu"))
    tp = params_to_torch(spec, params, "cpu")
    for p in tp:
        for v in p.values():
            v.requires_grad_(True)
    out, _ = net(torch.from_numpy(x), train=True, params=tp)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-6, atol=1e-6)
    grads = params_to_numpy(spec, [{k: v.grad for k, v in p.items()}
                                   for p in tp])
    for k in ("weights", "biases"):
        np.testing.assert_allclose(grads[0][k], np.asarray(jg[0][k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def _jax_draws(key, x_shape, spec_j):
    """The draws the JAX forward makes from ``key`` on the DRAWS net
    (compiler.py's dropout and ``_crop_forward``): the dropout's keep mask
    (NHWC) and the crop's (dh, dw, flip)."""
    rng, sub = jax.random.split(key)
    drop, crop = spec_j.layers[1], spec_j.layers[2]
    b, h, w = x_shape[0], crop.h, crop.w
    keep = np.asarray(jax.random.bernoulli(
        sub, 1.0 - drop.probability, (b, h, w, crop.c)))
    r1, r2, r3 = jax.random.split(rng, 3)
    dh = int(jax.random.randint(r1, (), 0, h - crop.crop_h + 1))
    dw = int(jax.random.randint(r2, (), 0, w - crop.crop_w + 1))
    flip = bool(jax.random.bernoulli(r3, 0.5))
    return keep, (dh, dw, flip)


@pytest.mark.parametrize("noadjust", [0, 1])
def test_dropout_and_crop_with_jax_draws(noadjust):
    """With the JAX forward's own keep mask and crop offsets and flip
    supplied (a key whose crop flips, at nonzero offsets), the port's
    training forward equals the JAX one, and so do the gradients of a
    fixed cotangent with respect to every parameter and the input."""
    text = DRAWS.format(batch=3, subdivisions=1, noadjust=noadjust)
    spec, jspec = _specs(text)
    params = classifier_params(spec, 7)
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (3, 12, 12, 3)).astype(np.float32)
    g = rng.normal(0, 1, (3, 10)).astype(np.float32)
    for seed in range(100):
        key = jax.random.PRNGKey(seed)
        keep, crop = _jax_draws(key, x.shape, jspec)
        if crop[2] and crop[0] and crop[1]:
            break
    assert crop[2] and 0 < keep.mean() < 1
    fwd = build_forward(jspec)

    def jloss(p, xx):
        out, _ = fwd(p, xx, train=True, rng=key)
        return jnp.sum(out * g), out
    (_, jout), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    net = Network(spec, params_to_torch(spec, params, "cpu"))
    tp = params_to_torch(spec, params, "cpu")
    leaves = [v.requires_grad_(True) for p in tp for k, v in p.items()
              if not k.startswith("rolling")]
    tx = torch.from_numpy(x).requires_grad_(True)
    draws = {1: torch.from_numpy(keep).permute(0, 3, 1, 2), 2: crop}
    out, aux = net(tx, train=True, params=tp, draws=draws)
    (out * torch.from_numpy(g)).sum().backward()
    assert len(draws) == 2 and leaves
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-6)
    grads = params_to_numpy(spec, [{k: v.grad for k, v in p.items()
                                    if v.grad is not None} for p in tp])
    for i, p in enumerate(grads):
        for k, v in p.items():
            np.testing.assert_allclose(v, np.asarray(jgp[i][k]), rtol=1e-5,
                                       atol=1e-5, err_msg=f"{i} {k}")


def test_generator_draws():
    """The port's own draws: the keep fraction near 1 - p and the kept
    values scaled by 1/(1-p); the crop's offsets in range and its flips
    about half; the same generator seed gives the same step, another seed
    another one, and another seed given the first one's draws
    (``Trainer.step(..., draws=)``) the first one's."""
    spec = S.build_network_spec(parse_cfg_text(
        DRAWS.format(batch=4, subdivisions=1, noadjust=1)))
    net = Network(spec, params_to_torch(spec, classifier_params(spec, 8),
                                        "cpu"))
    x = torch.rand(4, 12, 12, 3, generator=torch.Generator().manual_seed(8))
    drop = net.layers[1]
    ones = torch.ones(64, 6, 12, 12)
    gen = torch.Generator().manual_seed(9)
    y = drop.forward_train(ones, drop.draw(ones, gen))
    kept = y[y != 0]
    assert torch.all(kept == 1 / 0.6)
    assert abs(kept.numel() / y.numel() - 0.6) < 0.01
    crop = net.layers[2]
    draws = [crop.draw(ones, gen) for _ in range(400)]
    dh = [d[0] for d in draws]
    dw = [d[1] for d in draws]
    assert set(dh) == set(range(12 - 8 + 1))
    assert set(dw) == set(range(12 - 9 + 1))
    assert abs(np.mean([d[2] for d in draws]) - 0.5) < 0.1
    outs = []
    for seed in (1, 1, 2):
        d = {}
        out, _ = net(x, train=True, generator=torch.Generator().manual_seed(
            seed), draws=d)
        outs.append((out, d))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1][1], outs[1][1][1])
    assert not torch.equal(outs[0][0], outs[2][0])
    # the Trainer's generator: one seed a micro-batch, the same seed the
    # same steps; another seed given the first one's draws the same steps
    tspec = S.build_network_spec(parse_cfg_text(
        DRAWS.format(batch=4, subdivisions=2, noadjust=1) + "\n[cost]\n"))
    t = torch.from_numpy(np.eye(10, dtype=np.float32)[[1, 2, 3, 4]])
    losses, drawn = [], [[], []]
    for seed, draws in ((5, drawn), (5, None), (6, None), (6, drawn)):
        tr = Trainer(tspec, params=classifier_params(tspec, 8), device="cpu",
                     seed=seed)
        losses.append([float(tr.step(x, t, draws=None if draws is None
                                     else draws[s])["loss"])
                       for s in range(2)])
    assert losses[0] == losses[1] == losses[3] != losses[2]
    assert all(len(d) == 2 and sorted(d[0]) == [1, 2] for d in drawn)


def test_bf16_step_matches_jax():
    """One bf16 step of a small darknet19-shaped net (conv 3 -> 16 +
    maxpool at 32x32, B=4) on the port's plain path against the JAX bf16
    step: the loss within 0.03*|loss| + 0.05, the bf16 training gate of
    tests/test_torch_yolov2_train.py."""
    spec, jspec = _specs(D19_SMALL)
    params = classifier_params(spec, 9)
    rng = np.random.default_rng(9)
    x = rng.uniform(0, 1, (4, 32, 32, 3)).astype(np.float32)
    t = one_hot_groups(rng, 4, 10, 1)
    jp = jax.tree.map(jnp.asarray, params)
    st = JT.TrainState(jp, jax.tree.map(jnp.zeros_like, jp), jnp.asarray(0))
    st, mj = jax.jit(JT.make_train_step(jspec, compute_dtype=jnp.bfloat16))(
        st, jnp.asarray(x), jnp.asarray(t), jax.random.PRNGKey(0))
    tr = Trainer(spec, params=params, device="cpu",
                 compute_dtype=torch.bfloat16)
    m = tr.step(x, t)
    loss, want = float(m["loss"]), float(mj["loss"])
    assert abs(loss - want) <= 0.03 * abs(want) + 0.05, (loss, want)
    assert set(m) == {"loss", "lr", "batch_num"}
    moved = params_to_numpy(spec, tr.state.params)[0]["weights"]
    assert not np.array_equal(moved, params[0]["weights"])
