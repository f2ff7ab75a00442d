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
import sr_object_detection_tpu_torch.kernels.phase_stem as TPS
from sr_object_detection_tpu_torch.infer.engine import LatencyEngine
from sr_object_detection_tpu_torch.infer.quant import (
    QuantizedThroughputEngine)
from sr_object_detection_tpu_torch.io.weights import init_params
from sr_object_detection_tpu_torch.models.zoo import tiny_yolo_voc
from sr_object_detection_tpu_torch.ops import boxes as TB
from sr_object_detection_tpu_torch.ops import conv as TC
from torch_parity import (assert_bf16_close, nms_case, phase_pair_case,
                          random_bn)

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


def _phase_case(cuda, seed, batch, h, cin, cout, x_dtype):
    x, w, dq, b, inv_out, inv_in = phase_pair_case(seed, batch, h, cin,
                                                   cout, x_dtype)
    t = [torch.from_numpy(a).to(cuda) for a in (x, w, dq, b)]
    return (*t, float(inv_out), None if inv_in is None else float(inv_in))


@pytest.mark.cuda
@pytest.mark.parametrize("h,cin,cout", STEM_PAIRS)
def test_phase_stem_kernel_matches_plain(cuda, h, cin, cout):
    """The int8 stem pair at tiny-yolo-416's pair shapes, batch 2: equal
    to the plain int8 chain bit for bit. The first pair also from raw
    uint8 and float32 frames (requantized on load)."""
    dtypes = [np.int8] + ([np.uint8, np.float32] if cin == 3 else [])
    for x_dtype in dtypes:
        x, w, dq, b, inv_out, inv_in = _phase_case(cuda, h, 2, h, cin,
                                                   cout, x_dtype)
        before = TPS.launches
        got = TPS.stem_pair_i8(x, w, dq, b, inv_out, inv_in)
        torch.cuda.synchronize()
        assert TPS.launches == before + 1
        ref = TPS.stem_pair_i8_plain(x, w, dq, b, inv_out, inv_in)
        assert got.dtype == torch.int8 and got.shape == ref.shape
        assert ref.abs().max().item() > 60 and (ref == 127).float().mean() < .05
        assert torch.equal(got, ref), x_dtype


@pytest.mark.cuda
@pytest.mark.parametrize("h,cin,cout", [(24, 5, 7), (10, 6, 20),
                                        (18, 40, 9)])
def test_phase_stem_kernel_uneven_shapes(cuda, h, cin, cout):
    """Channels that are no multiple of 4 or 16, a second input-channel
    stage (Cin > 32), partial pooled tiles."""
    x, w, dq, b, inv_out, inv_in = _phase_case(cuda, cin, 3, h, cin, cout,
                                               np.int8)
    got = TPS.stem_pair_i8(x, w, dq, b, inv_out, inv_in)
    assert torch.equal(got, TPS.stem_pair_i8_plain(x, w, dq, b, inv_out,
                                                   inv_in))


@pytest.mark.cuda
def test_phase_stem_wrapper_rejects_bad_inputs(cuda):
    x, w, dq, b, inv_out, _ = _phase_case(cuda, 0, 1, 8, 3, 16, np.uint8)
    with pytest.raises(ValueError):
        TPS.stem_pair_i8(x, w, dq, b, inv_out)          # frame, no inv_in
    with pytest.raises(ValueError):
        TPS.stem_pair_i8(x.to(torch.int8), w, dq, b, inv_out, 0.5)
    with pytest.raises(ValueError):
        TPS.stem_pair_i8(x, w.float(), dq, b, inv_out, 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,cin,cout,size,stride,pad", [
    (2, 9, 3, 16, 3, 1, 1), (1, 7, 5, 7, 3, 2, 1), (3, 6, 16, 125, 1, 1, 0),
    (1, 3, 8, 8, 3, 1, 1)])
def test_conv2d_i8_on_cuda(cuda, b, h, cin, cout, size, stride, pad):
    """im2col + torch._int_mm on the card against the CPU's float64
    route."""
    rng = np.random.default_rng(h * cin)
    x = torch.from_numpy(rng.integers(-127, 128, (b, h, h + 1, cin),
                                      dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (size, size, cin, cout),
                                      dtype=np.int8))
    got = TC.conv2d_i8(x.to(cuda), w.to(cuda), stride=stride, pad=pad)
    assert torch.equal(got.cpu(), TC.conv2d_i8(x, w, stride=stride,
                                               pad=pad))


@pytest.mark.cuda
def test_quantized_engine_phase_stem_on_cuda(cuda):
    """QuantizedThroughputEngine(batch=128) with and without the stem
    kernel on the card: the same int8 trunk and output bit for bit, four
    launches per batch with it."""
    spec = tiny_yolo_voc(width=64, height=64)
    params = random_bn(init_params(spec, seed=0), 1, head_gain=4.0)
    calib = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    fused = QuantizedThroughputEngine(spec, params, batch=128, device=cuda,
                                      calib_x=calib, phase_stem=True)
    plain = QuantizedThroughputEngine(spec, params, batch=128, device=cuda,
                                      calib_x=calib)
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (128, 64, 64, 3), dtype=np.uint8)).to(cuda)
    before = TPS.launches
    trunk = fused.qnet.forward(x, stop=13)
    out = fused(x)
    torch.cuda.synchronize()
    assert TPS.launches == before + 8
    assert torch.equal(trunk, plain.qnet.forward(x, stop=13))
    assert torch.equal(out, plain(x))
