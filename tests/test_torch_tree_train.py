"""The port's WordTree (yolo9000) region loss against the JAX package's:
``TreeInfo``'s tables (a seeded tree and a corrupt one), the class-delta
masks, ``region_delta`` with a tree (classfix 0 and 2, with and without a
class map, with padding, two truths on one cell and classification-only
truths), the C-oracle tree training goldens, and the float32 Trainer on a
tree network with a map against the JAX Trainer.

The trees are written from a seed (``torch_parity.seeded_tree_lines``):
the real 9k.tree is not in the repository.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sr_object_detection_tpu.config as JC
import sr_object_detection_tpu.graph.spec as JS
import sr_object_detection_tpu.train.region_loss as JR
from sr_object_detection_tpu.io.weights import init_params as j_init_params
from sr_object_detection_tpu.train.trainer import Trainer as JTrainer
import sr_object_detection_tpu_torch.config as TC
import sr_object_detection_tpu_torch.graph.spec as TS
import sr_object_detection_tpu_torch.train.region_loss as TR
from sr_object_detection_tpu_torch.io.convert import params_to_numpy
from sr_object_detection_tpu_torch.io.tree import read_tree
from sr_object_detection_tpu_torch.io.weights import init_params
from sr_object_detection_tpu_torch.train.trainer import Trainer
from torch_parity import (TREE_TRAIN_GOLDENS, check_train_golden,
                          seeded_class_map, seeded_tree_lines)

N_NODES, N_GROUPS, N_MAP = 60, 18, 10
A, GRID, B = 3, 5, 4


@pytest.fixture(scope="module")
def tree_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tree")
    tree = d / "seeded.tree"
    tree.write_text("\n".join(seeded_tree_lines(N_NODES, N_GROUPS, 3)) + "\n")
    cmap = d / "seeded.map"
    cmap.write_text("\n".join(map(str, seeded_class_map(N_NODES, N_MAP, 3)))
                    + "\n")
    return tree, cmap


def _corrupt_tree():
    """Forward (2 -> 5, 7 -> 9), self (3 -> 3) and out-of-range (-7, 100)
    parents, as a truncated tree file leaves them."""
    parent = np.array([-1, 0, 5, 3, -7, 1, 2, 100, 6, 4, 8, 10])
    group = np.array([0, 1, 1, 2, 3, 1, 2, 4, 5, 6, 7, 8])
    return types.SimpleNamespace(parent=parent, group=group)


@pytest.mark.parametrize("kind", ["seeded", "corrupt"])
def test_tree_info_matches_jax(tree_files, kind):
    tree = (read_tree(str(tree_files[0])) if kind == "seeded"
            else _corrupt_tree())
    j, t = JR.TreeInfo(tree), TR.TreeInfo(tree)
    for k in ("chain", "chain_valid", "path_groups", "group", "parent"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k), err_msg=k)
    if kind == "corrupt":
        # every walk ends at a root within the depth cap
        assert (t.parent[t.chain[:, -1]] == -1).all()
    c = t.chain.shape[0]
    rng = np.random.default_rng(0)
    tcls = np.concatenate([np.arange(c), rng.integers(0, c, 2 * c)]).reshape(
        3, c)
    jpos, jgrp = j.class_delta_masks(jnp.asarray(tcls))
    tpos, tgrp = t.class_delta_masks(torch.from_numpy(tcls))
    assert tpos.shape == (3, c, c) and tpos.dtype == torch.bool
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tgrp.numpy(), np.asarray(jgrp))


def _cfg(tree, classfix, thresh):
    """A network whose last conv gives the region layer a 5x5 grid of 3
    anchors over the seeded tree's classes."""
    return f"""[net]
batch={B}
subdivisions=1
width=40
height=40
channels=3

[convolutional]
filters={A * (N_NODES + 5)}
size=1
stride=8
pad=0
activation=linear

[region]
anchors=1.2,1.3, 3.1,2.2, 0.8,2.9
bias_match=1
classes={N_NODES}
coords=4
num={A}
softmax=1
rescore=1
object_scale=5
noobject_scale=1
class_scale=1
coord_scale=1
thresh={thresh}
classfix={classfix}
tree={tree}
"""


def _truth(mapped: bool):
    """(B, 30, 5): item 0 three truths, two on one cell; item 1 a truth
    and a classification-only one (raw class 37, a node past the map);
    item 2 none; item 3 a truth, a zero row, then a truth the reference
    never reads."""
    hi = N_MAP if mapped else N_NODES
    t = np.zeros((B, 30, 5), np.float32)
    t[0, 0] = [0.31, 0.52, 0.30, 0.25, 3 % hi]
    t[0, 1] = [0.35, 0.55, 0.10, 0.40, 7 % hi]      # the same cell
    t[0, 2] = [0.81, 0.14, 0.22, 0.18, 9 % hi]
    t[1, 0] = [0.55, 0.45, 0.40, 0.30, 5 % hi]
    t[1, 1] = [999999, 999999, 999999, 999999, 37]
    t[3, 0] = [0.62, 0.71, 0.26, 0.33, 1]
    t[3, 2] = [0.12, 0.18, 0.20, 0.20, 2]
    return t


def _path_score_gap(acts, tree_info, cls_id):
    """The gap between the best and the second objectness x path prob
    over one item's locations (JAX's activations): the port may pick
    the cell only if it is not a near tie."""
    f = N_NODES + 5
    a = np.asarray(acts).reshape(-1, f)
    path = tree_info.chain[cls_id][tree_info.chain_valid[cls_id]]
    score = a[:, 4] * np.prod(a[:, 5:][:, path], axis=1)
    top = np.sort(score)[::-1]
    return top[0] - top[1]


@pytest.mark.parametrize("classfix", [0, 2])
@pytest.mark.parametrize("mapped", [False, True])
def test_tree_region_delta_matches_jax(tree_files, classfix, mapped):
    tree_path, map_path = tree_files
    text = _cfg(tree_path, classfix, 0.6 if classfix == 0 else 0.05)
    jspec = JS.build_network_spec(JC.parse_cfg_text(text)).layers[-1]
    tspec = TS.build_network_spec(TC.parse_cfg_text(text)).layers[-1]
    tree = read_tree(str(tree_path))
    jt, tt = JR.TreeInfo(tree), TR.TreeInfo(tree)
    cmap = TC.read_map(str(map_path)) if mapped else None
    rng = np.random.default_rng(11 + classfix + 2 * mapped)
    raw = rng.normal(0, 1.5, (B, GRID * GRID * A * (N_NODES + 5))).astype(
        np.float32)
    truth = _truth(mapped)
    ja, jd, js = JR.region_delta(jnp.asarray(raw), jnp.asarray(truth), 0,
                                 jspec, tree=jt, class_map=cmap)
    ta, td, ts = TR.region_delta(torch.from_numpy(raw),
                                 torch.from_numpy(truth), 0, tspec,
                                 tree=tt, class_map=cmap)
    gap = _path_score_gap(np.asarray(ja)[1], jt, 37)
    assert gap > 1e-4, gap
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
    jd, td = np.asarray(jd), td.numpy()
    np.testing.assert_allclose(td, jd, atol=1e-5)
    # the classification-only item: only its class delta at one cell
    d1 = td[1].reshape(-1, N_NODES + 5)
    assert not d1[:, :5].any()
    assert (np.abs(d1[:, 5:]).sum(1) > 0).sum() == 1
    assert np.abs(jd).max() > 0.1          # the deltas are not all tiny
    for k in js:
        np.testing.assert_allclose(float(ts[k]), float(js[k]), atol=1e-6,
                                   err_msg=k)


def test_tree_loss_gradient_is_minus_delta(tree_files):
    text = _cfg(tree_files[0], 2, 0.05)
    spec = TS.build_network_spec(TC.parse_cfg_text(text)).layers[-1]
    tree = read_tree(str(tree_files[0]))
    loss, loss_ws = TR.make_region_loss(spec, tree=tree)
    raw = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1, (B, GRID * GRID * A * (N_NODES + 5))).astype(np.float32))
    raw.requires_grad_(True)
    truth = torch.from_numpy(_truth(False))
    cost, stats = loss_ws(raw, truth, 0)
    cost.backward()
    _, delta, _ = TR.region_delta(raw.detach(), truth, 0, spec,
                                  tree=TR.TreeInfo(tree))
    assert torch.equal(raw.grad, -delta)
    assert float(cost.detach()) == pytest.approx(float((delta * delta).sum()))
    assert int(stats["count"]) == 6


@pytest.mark.parametrize("name", sorted(TREE_TRAIN_GOLDENS))
def test_tree_train_golden_on_cpu(name):
    """The float32 Trainer reproduces the C oracle's tree training
    goldens: weights at 2e-4, costs at 1e-3."""
    check_train_golden(name, "cpu")


def test_trainer_tree_with_map_matches_jax(tree_files):
    """The float32 Trainer on a tree network with a class map (the
    goldens have no map) against the JAX Trainer: two steps on truths
    with padding, a shared cell and a classification-only item."""
    text = _cfg(tree_files[0], 2, 0.05).replace(
        f"tree={tree_files[0]}", f"tree={tree_files[0]}\nmap={tree_files[1]}")
    text = text.replace("[convolutional]", "[convolutional]\nfilters=16\n"
                        "size=3\nstride=2\npad=1\nbatch_normalize=1\n"
                        "activation=leaky\n\n[convolutional]", 1).replace(
        "stride=8", "stride=4")
    jspec = JS.build_network_spec(JC.parse_cfg_text(text))
    tspec = TS.build_network_spec(TC.parse_cfg_text(text))
    assert tspec.layers[-1].h == GRID and tspec.layers[-1].map_file
    x = np.random.default_rng(5).uniform(0, 1, (B, 40, 40, 3)).astype(
        np.float32)
    truth = _truth(True)
    jtr = JTrainer(jspec, params=j_init_params(jspec, seed=1))
    ttr = Trainer(tspec, params=init_params(tspec, seed=1), device="cpu")
    for _ in range(2):
        jl = float(jtr.step(x, truth)["loss"])
        tl = float(ttr.step(x, truth)["loss"])
        assert tl == pytest.approx(jl, rel=1e-4)
    mine = params_to_numpy(tspec, ttr.state.params)
    for i, p in enumerate(jtr.state.params):
        for k, v in p.items():
            np.testing.assert_allclose(mine[i][k], np.asarray(v), rtol=2e-4,
                                       atol=2e-4, err_msg=f"layer {i} {k}")


def test_trainer_passes_the_tree(tree_files):
    """make_train_step hands the head's resolved tree to the loss: a
    tree network's first loss is the tree loss's, not a flat softmax's."""
    text = _cfg(tree_files[0], 0, 0.6)
    spec = TS.build_network_spec(TC.parse_cfg_text(text))
    flat = dataclasses.replace(spec, layers=[
        *spec.layers[:-1], dataclasses.replace(spec.layers[-1],
                                               tree_file=None)])
    x = np.random.default_rng(6).uniform(0, 1, (B, 40, 40, 3)).astype(
        np.float32)
    losses = [float(Trainer(s, params=init_params(s, seed=2),
                            device="cpu").step(x, _truth(False))["loss"])
              for s in (spec, flat)]
    assert losses[0] != pytest.approx(losses[1], rel=1e-3)
