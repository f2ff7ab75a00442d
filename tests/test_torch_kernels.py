"""The port's two kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper takes its kernel's plain PyTorch version (the
CUDA kernels cannot run here); these tests hold those plain versions to
the Pallas kernels, run in interpret mode as the JAX package's own tests
run them, on the same seeded numpy inputs. tests/test_torch_cuda.py
compares each CUDA kernel with its plain version on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sr_object_detection_tpu.kernels.b1_stem as JBS
from sr_object_detection_tpu.infer import engine as JE
from sr_object_detection_tpu.io.weights import init_params
from sr_object_detection_tpu.kernels.nms_pallas import (
    nms_per_class_pallas, nms_sort_topk_pallas)
from sr_object_detection_tpu.models import zoo as JZ
from sr_object_detection_tpu.ops import boxes as JB
import sr_object_detection_tpu_torch.kernels.b1_stem as TBS
import sr_object_detection_tpu_torch.kernels.nms as TN
from sr_object_detection_tpu_torch.infer import engine as TE
from sr_object_detection_tpu_torch.io.convert import params_to_torch
from sr_object_detection_tpu_torch.models import zoo as TZ
from sr_object_detection_tpu_torch.ops import boxes as TB
from torch_parity import assert_bf16_close, nms_case, random_bn


@pytest.fixture
def interpret_b1():
    JBS._INTERPRET = True
    yield
    JBS._INTERPRET = False


# --------------------------------------------------------------- NMS ---


@pytest.mark.parametrize("name", ["ties", "k128", "k400"])
def test_nms_plain_matches_pallas_and_xla(name):
    boxes, probs, thresh, k = nms_case(name)
    # per-class core on the same rank-sorted candidates
    top_p, top_i = jax.lax.top_k(jnp.asarray(probs).T, k)
    top_b = jnp.asarray(boxes)[top_i]
    ref_core = np.asarray(nms_per_class_pallas(top_b, top_p, float(thresh),
                                               interpret=True))
    tb, tp, ti = TB.topk_candidates(torch.from_numpy(boxes),
                                    torch.from_numpy(probs), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(top_i))
    before = TN.launches
    got_core = TN.nms_per_class(tb, tp, float(thresh)).numpy()
    assert TN.launches == before          # CPU tensors take the plain path
    np.testing.assert_array_equal(got_core > 0, ref_core > 0)
    np.testing.assert_allclose(got_core, ref_core, rtol=0, atol=1e-6)
    # the whole top-k NMS against both JAX versions
    got = TN.nms_sort_topk(torch.from_numpy(boxes), torch.from_numpy(probs),
                           float(thresh), k=k).numpy()
    for ref in (nms_sort_topk_pallas(jnp.asarray(boxes), jnp.asarray(probs),
                                     float(thresh), k=k, interpret=True),
                JB.nms_sort_topk(jnp.asarray(boxes), jnp.asarray(probs),
                                 float(thresh), k=k)):
        ref = np.asarray(ref)
        np.testing.assert_array_equal(got > 0, ref > 0)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        TB.nms_sort_topk(torch.from_numpy(boxes), torch.from_numpy(probs),
                         float(thresh), k=k).numpy(), got)


def test_nms_ties_suppress_as_expected():
    boxes, probs, thresh, k = nms_case("ties")
    got = TN.nms_sort_topk(torch.from_numpy(boxes), torch.from_numpy(probs),
                           float(thresh), k=k).numpy()
    # class 0: box 0 kills its duplicates 1 and 7; box 2 (IoU 1/3 with
    # box 0, not > 1/3) survives; box 4 kills 5 (IoU .67)
    np.testing.assert_array_equal(got[:, 0] > 0,
                                  [1, 0, 1, 0, 1, 0, 1, 0])


# ------------------------------------------------------------ b1 stem ---


def _folded(width, seed):
    spec_j = JZ.tiny_yolo_voc(width=width, height=width)
    spec_t = TZ.tiny_yolo_voc(width=width, height=width)
    params = random_bn(init_params(spec_j, seed=seed), seed + 1)
    fp_j, fs_j = JE.fold_params_for_inference(spec_j, params, jnp.bfloat16)
    fp_t, fs_t = TE.fold_params_for_inference(
        spec_t, params_to_torch(spec_t, params, "cpu"), torch.bfloat16)
    return (fp_j, fs_j), (fp_t, fs_t), params


def test_fold_params_match():
    (fp_j, _), (fp_t, fs_t), _ = _folded(64, 0)
    for l, pj, pt in zip(fs_t.layers, fp_j, fp_t):
        assert not getattr(l, "batch_normalize", False)
        for k in pj:
            ref = np.asarray(pj[k], np.float32)
            got = pt[k].float()
            if k == "weights":
                got = got.permute(2, 3, 1, 0)
            assert pt[k].dtype == torch.bfloat16
            assert_bf16_close(got.numpy(), ref)


def test_plan_and_truncate_match_jax():
    (_, fs_j), (_, fs_t), _ = _folded(128, 0)
    assert TBS.plan_pairs(fs_t) == JBS.plan_pairs(fs_j) == [
        (0, 1), (2, 3), (4, 5), (6, 7)]
    for n in (2, 8):
        a, b = TBS.truncate_spec(fs_t, n), JBS.truncate_spec(fs_j, n)
        assert dataclasses.asdict(a.net) == dataclasses.asdict(b.net)
        assert ([dataclasses.asdict(l) for l in a.layers]
                == [dataclasses.asdict(l) for l in b.layers])
    y2 = TZ.yolov2(width=128, height=128)       # BN not folded: no pairs
    assert TBS.plan_pairs(y2) == [] and TBS.build_stem(y2, []) == (None, 0)


def test_stem_plain_matches_pallas(interpret_b1):
    (fp_j, fs_j), (fp_t, fs_t), _ = _folded(128, 2)
    stem_j, n_j = JBS.build_stem(fs_j, fp_j)
    stem_t, n_t = TBS.build_stem(fs_t, fp_t)
    assert n_j == n_t == 8
    x = np.random.default_rng(3).uniform(0, 1, (1, 128, 128, 3)).astype(
        np.float32)
    ref = np.asarray(jax.jit(stem_j)(jnp.asarray(x)), np.float32)
    before = TBS.launches
    got = stem_t(torch.from_numpy(x))
    assert TBS.launches == before         # CPU tensors take the plain path
    assert got.dtype == torch.bfloat16 and got.shape == (1, 8, 8, 128)
    got = got.float().numpy()
    assert np.abs(ref).max() > 0.1        # the activations are non-trivial
    assert_bf16_close(got, ref)


def test_stem_pair_plain_matches_pallas_pair(interpret_b1):
    """One pair at tiny-yolo's first-pair channel counts, with a
    non-zero bias, against the Pallas pair kernel."""
    rng = np.random.default_rng(4)
    h = w = 32
    cin, cout = 3, 16
    x = rng.uniform(0, 1, (1, h, w, cin)).astype(np.float32)
    wt = rng.normal(0, 0.3, (3, 3, cin, cout)).astype(np.float32)
    b = rng.normal(0, 0.3, cout).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    wb = jnp.asarray(wt, jnp.bfloat16)
    ref = JBS.from_flat(
        JBS._run_pair(JBS.to_flat(xb, w), JBS.pack_weights(wb),
                      jnp.asarray(b).reshape(-1, 1), H=h, W=w, Cin=cin,
                      Cout=cout), h // 2, w // 2)
    got = TBS.stem_pair(torch.from_numpy(x).to(torch.bfloat16),
                        torch.from_numpy(wt).to(torch.bfloat16),
                        torch.from_numpy(b))
    assert_bf16_close(got.float().numpy(), np.asarray(ref, np.float32))


def test_stem_pair_rejects_bad_shapes_on_cuda_only():
    """The CPU path is the plain version for any shape it can take; the
    checks guard the CUDA launch (exercised by the cuda tests)."""
    x = torch.zeros((1, 4, 4, 3), dtype=torch.bfloat16)
    out = TBS.stem_pair(x, torch.zeros((3, 3, 3, 8), dtype=torch.bfloat16),
                        torch.zeros(8))
    assert out.shape == (1, 2, 2, 8)
