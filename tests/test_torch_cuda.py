"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports no JAX, so it runs on a machine that has none; there,
tests/conftest.py (which imports jax) is left out:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import sr_object_detection_tpu_torch.kernels.b1_stem as TBS
import sr_object_detection_tpu_torch.kernels.nms as TN
from sr_object_detection_tpu_torch.infer.engine import LatencyEngine
from sr_object_detection_tpu_torch.io.weights import init_params
from sr_object_detection_tpu_torch.models.zoo import tiny_yolo_voc
from sr_object_detection_tpu_torch.ops import boxes as TB
from torch_parity import assert_bf16_close, nms_case, random_bn

# tiny-yolo-voc-416's four stem pairs: (H, Cin, Cout)
STEM_PAIRS = [(416, 3, 16), (208, 16, 32), (104, 32, 64), (52, 64, 128)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the plain versions' float32 convs must not run in TF32
    from sr_object_detection_tpu_torch.infer.detector import disable_tf32
    disable_tf32()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ties", "k128", "k400"])
def test_nms_kernel_matches_plain(cuda, name):
    boxes, probs, thresh, k = nms_case(name)
    tb, tp, _ = TB.topk_candidates(torch.from_numpy(boxes).to(cuda),
                                   torch.from_numpy(probs).to(cuda), k)
    before = TN.launches
    got = TN.nms_per_class(tb, tp, float(thresh))
    torch.cuda.synchronize()
    assert TN.launches == before + 1
    ref = TB.nms_per_class_plain(tb, tp, float(thresh))
    assert torch.equal(got > 0, ref > 0)
    assert (got - ref).abs().max().item() <= 1e-6


@pytest.mark.cuda
def test_nms_kernel_large_k(cuda):
    """k past the 48 KB default shared-memory limit (yolov2-608 has
    1,805 candidates)."""
    rng = np.random.default_rng(3)
    n, c = 2048, 4
    boxes = torch.from_numpy(np.stack(
        [rng.uniform(0, 1, n), rng.uniform(0, 1, n), rng.uniform(.02, .3, n),
         rng.uniform(.02, .3, n)], axis=1).astype(np.float32)).to(cuda)
    probs = torch.from_numpy(rng.uniform(0, 1, (n, c)).astype(
        np.float32)).to(cuda)
    got = TN.nms_sort_topk(boxes, probs, 0.45, k=n)
    ref = TB.nms_sort_topk(boxes, probs, 0.45, k=n)
    assert torch.equal(got > 0, ref > 0)
    assert (got - ref).abs().max().item() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("h,cin,cout", STEM_PAIRS)
def test_stem_kernel_matches_plain(cuda, h, cin, cout):
    rng = np.random.default_rng(h)
    x = torch.from_numpy(rng.uniform(0, 1, (1, h, h, cin)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    w = torch.from_numpy(rng.normal(0, 0.3, (3, 3, cin, cout)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    b = torch.from_numpy(rng.normal(0, 0.3, cout).astype(np.float32)).to(
        cuda)
    before = TBS.launches
    got = TBS.stem_pair(x, w, b)
    torch.cuda.synchronize()
    assert TBS.launches == before + 1
    ref = TBS.stem_pair_plain(x, w, b)
    assert_bf16_close(got.float().cpu().numpy(), ref.float().cpu().numpy())


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_inputs(cuda):
    x = torch.zeros((1, 8, 8, 3), device=cuda)            # f32, not bf16
    w = torch.zeros((3, 3, 3, 16), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        TBS.stem_pair(x, w, torch.zeros(16, device=cuda))
    with pytest.raises(ValueError):
        TN.nms_per_class(torch.zeros((2, 5, 4), device=cuda),
                         torch.zeros((2, 5), device=cuda,
                                     dtype=torch.float64), 0.4)


@pytest.mark.cuda
def test_latency_engine_fused_on_cuda(cuda):
    spec = tiny_yolo_voc(width=128, height=128)
    params = random_bn(init_params(spec, seed=0), 1)
    fused = LatencyEngine(spec, params, device=cuda, fused_stem=True)
    plain = LatencyEngine(spec, params, device=cuda)
    assert fused.fused_stem and not plain.fused_stem
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (1, 128, 128, 3)).astype(np.float32)).to(cuda, torch.bfloat16)
    before = TBS.launches
    with torch.no_grad():
        of, _ = fused.forward(x)
        op, _ = plain.forward(x)
    assert TBS.launches == before + 4
    assert (of.float() - op.float()).abs().max().item() <= 2 ** -6
