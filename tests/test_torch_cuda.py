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
import sr_object_detection_tpu_torch.kernels.fused_stem as TFS
import sr_object_detection_tpu_torch.kernels.nms as TN
import sr_object_detection_tpu_torch.kernels.phase_stem as TPS
import sr_object_detection_tpu_torch.kernels.phase_train as TPT
from sr_object_detection_tpu_torch.graph import spec as TS
from sr_object_detection_tpu_torch.graph.compiler import Network
from sr_object_detection_tpu_torch.infer.engine import (
    LatencyEngine, ThroughputEngine, fold_params_for_inference)
from sr_object_detection_tpu_torch.infer.quant import (
    QuantizedThroughputEngine)
from sr_object_detection_tpu_torch.io.convert import params_to_torch
from sr_object_detection_tpu_torch.io.weights import init_params
from sr_object_detection_tpu_torch.models.zoo import tiny_yolo_voc, yolov2
from sr_object_detection_tpu_torch.ops import boxes as TB
from sr_object_detection_tpu_torch.ops import conv as TC
from sr_object_detection_tpu_torch.ops import pooling as TP
from torch_parity import (assert_bf16_close, assert_fwd_close,
                          assert_stem_link_close,
                          chain_case, check_chain_kernels, check_fwdstats,
                          check_y_consistency, dgrad_case,
                          check_fused_stem_kernels, check_pair_gradient,
                          check_train_kernels, images_past_2g, misaligned,
                          nms_case, pair_spec, phase_pair_case, random_bn,
                          stem_case, train_case)

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
    assert torch.equal(got, ref)


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
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 31, 32, 33, 64, 100, 128, 845, 1805,
                               4096, 8192])
def test_nms_kernel_chunks(cuda, k):
    """The chunked recurrence (32 ranks a chunk) equal to the plain walk
    at chunk edges and up to SROD_NMS_MAX_K (8192: 204,800 bytes of
    shared memory, past the 48 KB default), with duplicate boxes, equal
    probs, zero probs, a class of one box in every rank (all but its
    first suppressed), a class whose last positive lies inside a chunk,
    and one with no positive at all."""
    rng = np.random.default_rng(k)
    n, c = max(k, 64), 5 if k <= 2048 else 3
    boxes = np.stack([rng.uniform(0, 1, n), rng.uniform(0, 1, n),
                      rng.uniform(.02, .4, n), rng.uniform(.02, .4, n)],
                     axis=1).astype(np.float32)
    boxes[n // 3:n // 3 + 8] = boxes[n // 3 - 1]
    probs = rng.uniform(0, 1, (n, c)).astype(np.float32) ** 4
    probs[probs < 0.05] = 0
    probs[::7, 0] = probs[0, 0]
    tb, tp, _ = TB.topk_candidates(torch.from_numpy(boxes).to(cuda),
                                   torch.from_numpy(probs).to(cuda), k)
    tb, tp = tb.clone(), tp.clone()
    tb[1] = tb[1, :1]
    tp[1] = torch.where(tp[1] > 0, torch.linspace(1, .5, k, device=cuda), 0)
    tp[2, k * 3 // 5 + 3:] = 0
    if c > 3:
        tp[4] = 0
    before = TN.launches
    got = TN.nms_per_class(tb, tp, 0.4)
    torch.cuda.synchronize()
    assert TN.launches == before + 1
    assert torch.equal(got, TB.nms_per_class_plain(tb, tp, 0.4))
    if k > 1:
        assert ((tp > 0) & (got == 0)).any() and (got[1] > 0).sum() == 1


@pytest.mark.cuda
@pytest.mark.parametrize("k", [128, 845])
def test_nms_kernel_tail_bits(cuda, k):
    """Past the last positive prob, -0.0 and negative probs on boxes that
    rank 0 overlaps: the kernel still zeroes them as the plain version
    does, bit for bit (a view as int32, since -0.0 == 0.0)."""
    rng = np.random.default_rng(k + 1)
    n, c = max(k, 64), 4
    boxes = np.stack([rng.uniform(0, 1, n), rng.uniform(0, 1, n),
                      rng.uniform(.02, .4, n), rng.uniform(.02, .4, n)],
                     axis=1).astype(np.float32)
    probs = rng.uniform(0, 1, (n, c)).astype(np.float32) ** 4
    probs[probs < 0.3] = 0
    tb, tp, _ = TB.topk_candidates(torch.from_numpy(boxes).to(cuda),
                                   torch.from_numpy(probs).to(cuda), k)
    tb, tp = tb.clone(), tp.clone()
    tail = torch.tensor([-0.0, -0.25, 0.0, -1e-30, -0.0], device=cuda)
    for ci in range(c):
        last = int((tp[ci] > 0).nonzero()[-1]) + 1
        m = min(len(tail), k - last)
        tp[ci, last:last + m] = tail[:m]
        tb[ci, last:last + m] = tb[ci, 0]
    got = TN.nms_per_class(tb, tp, 0.4)
    ref = TB.nms_per_class_plain(tb, tp, 0.4)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert (torch.signbit(tp) & (got == 0) & ~torch.signbit(got)).any()


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


def _stem_inputs(cuda, seed, h, w, cin, cout):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(0, 1, (1, h, w, cin)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    wt = torch.from_numpy(rng.normal(0, 0.3, (3, 3, cin, cout)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    b = torch.from_numpy(rng.normal(0, 0.3, cout).astype(np.float32)).to(
        cuda)
    return x, wt, b


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,cin,cout", [
    (416, 416, 3, 16), (208, 208, 32, 32), (416, 416, 1, 16),
    (208, 208, 2, 32), (104, 104, 3, 64),
    (52, 52, 16, 128), (104, 104, 64, 16), (26, 26, 32, 48),
    (52, 52, 128, 32), (22, 38, 3, 16), (22, 38, 16, 32), (26, 26, 2, 128)])
def test_stem_tile_matches_plain(cuda, h, w, cin, cout):
    """The batch-1 stem on the tensor-core tile (its taps fold at Cin <=
    3) within one bf16 ulp of stem_pair_plain, partial 8x8 pooled tiles
    included (13, 11 x 19 pooled pixels), counted under its path; two
    launches bit-equal (test_stem_kernel_matches_plain covers
    tiny-yolo-voc's four pairs themselves)."""
    x, wt, b = _stem_inputs(cuda, h + w + cin + cout, h, w, cin, cout)
    path = "tensor_core_fold" if cin <= 3 else "tensor_core"
    assert TPT.conv_path("stem", cin, cout) == path
    before, paths = TBS.launches, dict(TBS.paths)
    got = TBS.stem_pair(x, wt, b)
    again = TBS.stem_pair(x, wt, b)
    torch.cuda.synchronize()
    assert TBS.launches == before + 2
    assert {k: TBS.paths[k] - paths[k] for k in paths} == {
        **dict.fromkeys(paths, 0), path: 2}
    assert torch.equal(got, again)
    ref = TBS.stem_pair_plain(x, wt, b)
    assert_bf16_close(got.float().cpu().numpy(), ref.float().cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(8, 16), (3, 8), (24, 32), (144, 16)])
def test_stem_other_shapes_take_fp32_kernel(cuda, cin, cout):
    """Shapes off the tile (Cin 4-15, Cin no multiple of 16, Cin past 128,
    Cout no multiple of 16) run stem_pair_kernel, within one bf16 ulp of
    the plain version."""
    x, wt, b = _stem_inputs(cuda, cin + cout, 30, 22, cin, cout)
    assert TPT.conv_path("stem", cin, cout) == "fp32_core"
    paths = dict(TBS.paths)
    got = TBS.stem_pair(x, wt, b)
    torch.cuda.synchronize()
    assert {k: TBS.paths[k] - paths[k] for k in paths} == {
        **dict.fromkeys(paths, 0), "fp32_core": 1}
    assert_bf16_close(got.float().cpu().numpy(),
                      TBS.stem_pair_plain(x, wt, b).float().cpu().numpy())


@pytest.mark.cuda
def test_stem_tile_misaligned_input(cuda):
    """An input view 2 bytes past a 16-byte boundary: the wrapper copies
    it for the tile's 16-byte loads."""
    x, wt, b = _stem_inputs(cuda, 5, 52, 52, 16, 32)
    buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=cuda)
    k = next(k for k in range(8) if (buf.data_ptr() + 2 * k) % 16 == 2)
    xm = buf[k:k + x.numel()].view(x.shape)
    xm.copy_(x)
    assert xm.data_ptr() % 16 == 2
    assert torch.equal(TBS.stem_pair(xm, wt, b), TBS.stem_pair(x, wt, b))


def _fwd_composition(x, w, bias):
    """fwdstats + apply with identity constants: the bf16 serving stem's
    pair as it ran before its own kernel, and the pooled raw conv Z."""
    cout = w.shape[3]
    zero = torch.zeros(cout, device=x.device)
    one = torch.ones(cout, device=x.device)
    z, _, _ = TPT.fwdstats(x, w, zero, one)
    return TPT.apply(z, zero, one, one, bias), z


def _fwd_inputs(cuda, seed, b, h, w, cin, cout):
    """x (b, h, w, Cin) bf16, HWIO weights bf16, a bias of bf16 values."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(0, 1, (b, h, w, cin)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    wt = torch.from_numpy(rng.normal(0, 0.3, (3, 3, cin, cout)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    bias = torch.from_numpy(rng.normal(0, 0.3, cout).astype(np.float32))
    return x, wt, bias.to(cuda, torch.bfloat16).float()


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,cin,cout", [
    (4, 416, 416, 3, 16), (4, 208, 208, 16, 32), (4, 104, 104, 32, 64),
    (4, 52, 52, 64, 128), (3, 52, 52, 16, 32), (2, 22, 38, 3, 16),
    (2, 22, 38, 16, 32), (2, 26, 26, 1, 32), (2, 26, 26, 2, 128),
    (5, 20, 20, 48, 16)])
def test_fwd_pair_matches_composition(cuda, b, h, w, cin, cout):
    """The bf16 serving stem's kernel (mode fwd of the conv tile; its taps
    fold at Cin <= 3) at tiny-yolo-voc's four pairs and at partial 8x8
    pooled tiles (a 52 -> 26 pair; 11 x 19 pooled pixels): torch.equal to
    fwdstats + apply with identity constants, within one bf16 ulp of
    fwd_pair_plain (torch_parity.assert_fwd_close: where the two conv
    sums round apart, ROADMAP queue 3, item 10, the bias add and the
    leaky round once more each), two launches bit-equal, counted under
    its path."""
    x, wt, bias = _fwd_inputs(cuda, h + w + cin + cout, b, h, w, cin, cout)
    path = "tensor_core_fold" if cin <= 3 else "tensor_core"
    assert TPT.conv_path("fwd", cin, cout) == path
    before, paths = TPT.launches["fwd"], dict(TPT.conv_kernels["fwd"])
    got = TPT.fwd_pair(x, wt, bias)
    again = TPT.fwd_pair(x, wt, bias)
    torch.cuda.synchronize()
    assert TPT.launches["fwd"] == before + 2
    assert {k: TPT.conv_kernels["fwd"][k] - paths[k] for k in paths} == {
        **dict.fromkeys(paths, 0), path: 2}
    assert torch.equal(got, again)
    comp, z = _fwd_composition(x, wt, bias)
    assert torch.equal(got, comp)
    ref = TPT.fwd_pair_plain(x, wt, bias)
    assert_fwd_close(got.float().cpu().numpy(), ref.float().cpu().numpy(),
                     z.float().cpu().numpy())
    assert (got.float() < 0).any() and (got.float() > 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(8, 16), (24, 32), (5, 48)])
def test_fwd_pair_other_shapes_take_fp32_path(cuda, cin, cout):
    """Shapes off the tile (Cin 4-15, Cin > 16 no multiple of 16) run
    fwdstats_kernel + apply_kernel by shape: equal to the composition,
    counted as fp32_core under fwd, not under fwdstats or apply."""
    x, wt, bias = _fwd_inputs(cuda, cin + cout, 2, 30, 22, cin, cout)
    assert TPT.conv_path("fwd", cin, cout) == "fp32_core"
    before = dict(TPT.launches)
    paths = dict(TPT.conv_kernels["fwd"])
    got = TPT.fwd_pair(x, wt, bias)
    torch.cuda.synchronize()
    assert TPT.launches == {**before, "fwd": before["fwd"] + 1}
    assert {k: TPT.conv_kernels["fwd"][k] - paths[k] for k in paths} == {
        **dict.fromkeys(paths, 0), "fp32_core": 1}
    assert torch.equal(got, _fwd_composition(x, wt, bias)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(3, 16), (16, 32)])
def test_fwd_pair_rounds_float32_bias(cuda, cin, cout):
    """A float32 bias whose values are no bf16 values: the kernel (fold
    and tile) rounds it to bf16 as apply does, torch.equal to the
    composition and to the kernel given the rounded bias."""
    x, wt, bias = _fwd_inputs(cuda, 11 + cin, 2, 52, 52, cin, cout)
    fine = bias + torch.linspace(1e-4, 3e-3, cout, device=cuda)
    assert not torch.equal(fine.to(torch.bfloat16).float(), fine)
    got = TPT.fwd_pair(x, wt, fine)
    assert torch.equal(got, _fwd_composition(x, wt, fine)[0])
    assert torch.equal(got, TPT.fwd_pair(
        x, wt, fine.to(torch.bfloat16).float()))


@pytest.mark.cuda
def test_fwd_pair_misaligned_input(cuda):
    """An input view 2 bytes past a 16-byte boundary: the wrapper copies
    it for the tile's 16-byte loads (the fold's and the tile's)."""
    for cin, cout in ((3, 16), (16, 32)):
        x, wt, bias = _fwd_inputs(cuda, 7 + cin, 2, 52, 52, cin, cout)
        buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=cuda)
        k = next(k for k in range(8) if (buf.data_ptr() + 2 * k) % 16 == 2)
        xm = buf[k:k + x.numel()].view(x.shape)
        xm.copy_(x)
        assert xm.data_ptr() % 16 == 2
        assert torch.equal(TPT.fwd_pair(xm, wt, bias),
                           TPT.fwd_pair(x, wt, bias))


@pytest.mark.cuda
def test_fwd_pair_rejects_bad_inputs(cuda):
    x, wt, bias = _fwd_inputs(cuda, 9, 2, 16, 16, 16, 32)
    with pytest.raises(ValueError):
        TPT.fwd_pair(x.float(), wt, bias)               # f32 input
    with pytest.raises(ValueError):
        TPT.fwd_pair(x, wt, bias.to(torch.bfloat16))    # bf16 bias
    with pytest.raises(ValueError):
        TPT.fwd_pair(x[:, :15], wt, bias)               # odd H
    with pytest.raises(ValueError):
        TPT.fwd_pair(x, wt[..., :24], bias[:24])        # Cout 24


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
@pytest.mark.parametrize("h,cin,cout", STEM_PAIRS)
def test_phase_stem_tensor_core_b128(cuda, h, cin, cout):
    """The tensor-core kernel at tiny-yolo-416's pair shapes at the
    serving batch (128): bit-equal to the plain int8 chain, pair 1 from
    int8 codes and from uint8 and float32 frames."""
    dtypes = [np.int8] + ([np.uint8, np.float32] if cin == 3 else [])
    for x_dtype in dtypes:
        x, w, dq, b, inv_out, inv_in = _phase_case(cuda, 5 * h, 128, h, cin,
                                                   cout, x_dtype)
        got = TPS.stem_pair_i8(x, w, dq, b, inv_out, inv_in)
        ref = TPS.stem_pair_i8_plain(x, w, dq, b, inv_out, inv_in)
        torch.cuda.synchronize()
        assert ref.abs().max().item() > 60
        assert torch.equal(got, ref), x_dtype
        del x, got, ref
        torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("h,cin,x_dtype", [
    (20, 3, np.uint8), (22, 3, np.uint8), (36, 3, np.float32),
    (20, 3, np.int8), (10, 1, np.uint8), (14, 2, np.int8)])
def test_phase_stem_taps_fold_edges(cuda, h, cin, x_dtype):
    """The taps fold (Cin <= 3) with partial pooled tiles: u8 frames by
    aligned words (W a multiple of 4) and element by element (W 22),
    float32 frames, int8 codes, Cin 1 and 2; Cout 24 masks a group."""
    args = _phase_case(cuda, h + cin, 3, h, cin, 24, x_dtype)
    got = TPS.stem_pair_i8(*args)
    assert torch.equal(got, TPS.stem_pair_i8_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("h,cin,cout", [(416, 3, 16), (52, 64, 128),
                                        (18, 40, 9)])
def test_phase_stem_two_launches_bit_equal(cuda, h, cin, cout):
    """Every output has one owner and one summation order: two launches on
    the same inputs are bit-equal."""
    args = _phase_case(cuda, h + 1, 8, h, cin, cout,
                       np.uint8 if cin == 3 else np.int8)
    first = TPS.stem_pair_i8(*args)
    assert torch.equal(first, TPS.stem_pair_i8(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("h,cin,cout,fold", [
    (416, 3, 16, "taps"), (208, 16, 32, "tap_pairs"), (104, 32, 64, "chunks"),
    (52, 64, 128, "chunks"), (24, 5, 7, "tap_pairs"), (18, 40, 9, "chunks")])
def test_phase_stem_fold_by_shape(cuda, h, cin, cout, fold):
    """``folds`` counts each launch under the K fold the kernel picked:
    the four main-path pairs run the tensor-core kernel's taps, tap-pair
    and chunk folds."""
    args = _phase_case(cuda, h, 2, h, cin, cout, np.int8)
    before = dict(TPS.folds)
    TPS.stem_pair_i8(*args)
    torch.cuda.synchronize()
    want = dict(before)
    want[fold] += 1
    assert TPS.folds == want


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
    folds = dict(TPS.folds)
    trunk = fused.qnet.forward(x, stop=13)
    out = fused(x)
    torch.cuda.synchronize()
    assert TPS.launches == before + 8
    # each batch's four pairs on the tensor cores: taps, tap pairs, chunks
    assert {k: TPS.folds[k] - folds[k] for k in folds} == {
        "taps": 2, "tap_pairs": 2, "chunks": 4}
    assert torch.equal(trunk, plain.qnet.forward(x, stop=13))
    assert torch.equal(out, plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(3, 16), (16, 32), (3, 32), (16, 16)])
def test_train_kernels_match_plain(cuda, cin, cout):
    """fwdstats, apply and bwdg at B=8, 32x32 against their plain
    versions, at chip_smoke's phase-12 tolerances; the cases hold a
    channel with a negative BN scale and an all-equal channel."""
    case = train_case(cin * cout, 8, 32, cin, cout, cuda)
    before = dict(TPT.launches)
    check_train_kernels(TPT, case)
    torch.cuda.synchronize()
    assert {k: TPT.launches[k] - before[k] for k in before} == {
        "fwdstats": 1, "apply": 1, "bwdg": 1, "red": 0, "dy": 0, "dgrad": 0,
        "fwd": 0}


@pytest.mark.cuda
def test_train_kernels_uneven_tiles(cuda):
    """H/2 and W/2 that are no multiple of the 8x8 pooled tile, Cin > 16
    for fwdstats (a second input-channel stage)."""
    case = train_case(7, 3, 22, 3, 16, cuda)
    check_train_kernels(TPT, case)
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.rand((2, 12, 12, 40), device=cuda, generator=g).to(
        torch.bfloat16)
    w = (torch.randn((3, 3, 40, 48), device=cuda, generator=g) * 0.2).to(
        torch.bfloat16)
    s = torch.linspace(-1, 1, 48, device=cuda)
    got = TPT.fwdstats(x, w, torch.zeros(48, device=cuda), s)
    want = TPT.fwdstats_plain(x, w, torch.zeros(48, device=cuda), s)
    assert_bf16_close(got[0].float().cpu().numpy(),
                      want[0].float().cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,cin,cout", [
    (2, 22, 32, 64), (2, 40, 64, 128), (3, 26, 64, 48), (2, 18, 32, 16)])
def test_fwdstats_tensor_core_wide(cuda, b, h, cin, cout):
    """fwdstats on the tensor-core tile at Cin 32 and 64 (two and four
    16-channel chunks a tile), Cout up to 128 in groups of 32 or 16, with
    partial 8x8 pooled tiles, against its plain version (chip_smoke's
    phase-12 tolerances); the tile ran, not the FP32-core loop."""
    case = train_case(b * h + cin + cout, b, h, cin, cout, cuda)
    before = dict(TPT.conv_kernels["fwdstats"])
    check_fwdstats(TPT, case["x"], case["w"], case["shift"], case["scales"])
    torch.cuda.synchronize()
    assert TPT.conv_kernels["fwdstats"] == {
        **before, "tensor_core": before["tensor_core"] + 1}


@pytest.mark.cuda
@pytest.mark.parametrize("h", [22, 36])
@pytest.mark.parametrize("cin,cout", [(3, 16), (3, 32), (1, 16), (2, 48),
                                      (3, 128)])
def test_fwdstats_fold_matches_plain(cuda, cin, cout, h):
    """fwdstats at Cin <= 3 on the tensor-core tile with the taps fold
    (fwdstats_fold_kernel) at B=3 against its plain version (chip_smoke's
    phase-12 tolerances: Z within one bf16 ulp, the argmax equal where the
    extreme taps are more than an ulp apart, the sums at 1e-4), with
    partial 8x8 pooled tiles (22x22: 11x11 pooled; 36x36: 18x18), Cout
    in groups of 32 or 16; the fold ran, by conv_kernels."""
    case = train_case(10 * h + 3 * cin + cout, 3, h, cin, cout, cuda)
    before = dict(TPT.conv_kernels["fwdstats"])
    check_fwdstats(TPT, case["x"], case["w"], case["shift"], case["scales"])
    torch.cuda.synchronize()
    assert TPT.conv_kernels["fwdstats"] == {
        **before, "tensor_core_fold": before["tensor_core_fold"] + 1}


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(3, 16), (3, 32), (1, 16), (2, 48),
                                      (3, 128)])
def test_fwdstats_fold_full_width(cuda, cin, cout):
    """The fold at the leading pair's 416x416 (26x26 whole pooled tiles)
    at B=2, against its plain version, and two launches bit-equal: every
    sum has one owner and one order."""
    case = train_case(416 + cin + cout, 2, 416, cin, cout, cuda)
    args = (case["x"], case["w"], case["shift"], case["scales"])
    before = dict(TPT.conv_kernels["fwdstats"])
    check_fwdstats(TPT, *args)
    first, second = TPT.fwdstats(*args), TPT.fwdstats(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert TPT.conv_kernels["fwdstats"] == {
        **before, "tensor_core_fold": before["tensor_core_fold"] + 3}


@pytest.mark.cuda
def test_fwdstats_fold_misaligned_input(cuda):
    """x whose data pointer lies 2 bytes off a 16-byte boundary (a slice
    of a larger buffer), with H != W (22 x 18): the wrapper copies it to
    an aligned buffer for the fold's 16-byte loads, and the fold holds to
    the plain version."""
    case = train_case(21, 2, 22, 3, 16, cuda)
    x = misaligned(case["x"][:, :, :18].permute(0, 3, 1, 2)).permute(
        0, 2, 3, 1)
    assert x.is_contiguous() and x.data_ptr() % 16
    before = dict(TPT.conv_kernels["fwdstats"])
    check_fwdstats(TPT, x, case["w"], case["shift"], case["scales"])
    torch.cuda.synchronize()
    assert TPT.conv_kernels["fwdstats"] == {
        **before, "tensor_core_fold": before["tensor_core_fold"] + 1}


@pytest.mark.cuda
def test_conv_path_mirror_matches_library(cuda):
    """kernels/phase_train.conv_path, the Python mirror of the library's
    mode-aware predicate, names the path srod_pt_conv_tensor_core picks
    for every mode (the batch-1 stem's too) and shape here."""
    from sr_object_detection_tpu_torch.kernels import _build
    lib = _build.load()
    for mode, m in TPT.MODE_INDEX.items():
        for cin in (1, 2, 3, 4, 8, 15, 16, 24, 32, 40, 48, 64, 128, 144,
                    256):
            for cout in (8, 16, 32, 48, 128):
                got = TPT.CONV_PATHS[lib.srod_pt_conv_tensor_core(m, cin,
                                                                  cout)]
                assert got == TPT.conv_path(mode, cin, cout), (mode, cin,
                                                               cout)
                assert got == TPT.library_conv_path(lib, mode, cin, cout)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,path", [
    (16, 32, "tensor_core"), (32, 16, "tensor_core"), (64, 128, "tensor_core"),
    (3, 16, "tensor_core_fold"), (8, 32, "fp32_core"), (40, 48, "fp32_core")])
def test_conv_path_by_shape(cuda, cin, cout, path):
    """The mode-aware predicate picks the conv path of fwdstats, red and
    dy by shape: the tensor-core tile for Cin a multiple of 16 in every
    mode, the taps fold for fwdstats at Cin <= 3, the FP32-core loop for
    the rest; red and dy take Cin 8 or 16 and refuse Cin 3 (ValueError);
    conv_kernels counts which ran."""
    case = train_case(cin + cout, 2, 16, cin, cout, cuda)
    before = {m: dict(c) for m, c in TPT.conv_kernels.items()}
    TPT.fwdstats(case["x"], case["w"], case["shift"], case["scales"])
    want = {m: dict(c) for m, c in before.items()}
    want["fwdstats"][path] += 1
    if cin <= TPT.MAX_CIN_CHAIN:
        ch = chain_case(cin, 2, 16, cin, cout, cuda)
        args = [ch[k] for k in ("x", "w", "dp", "mean", "inv", "scales",
                                "biases")]
        if cin % 8:
            with pytest.raises(ValueError):
                TPT.red(*args)
            with pytest.raises(ValueError):
                TPT.dy(*args, ch["c1"], ch["c2"], ch["c3"])
        else:
            TPT.red(*args)
            TPT.dy(*args, ch["c1"], ch["c2"], ch["c3"])
            want["red"][path] += 1
            want["dy"][path] += 1
    torch.cuda.synchronize()
    assert TPT.conv_kernels == want
    from sr_object_detection_tpu_torch.kernels import _build
    lib = _build.load()
    assert TPT.CONV_PATHS[lib.srod_pt_conv_tensor_core(0, cin, cout)] == path


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(16, 32), (16, 48), (8, 32)])
def test_conv_modes_two_launches_bit_equal(cuda, cin, cout):
    """fwdstats, red and dy (+ dw) have one owner and one summation order
    per output on either path: two launches on the same inputs are
    bit-equal."""
    case = chain_case(3 * cin + cout, 4, 40, cin, cout, cuda)
    args = [case[k] for k in ("x", "w", "dp", "mean", "inv", "scales",
                              "biases")]
    c123 = [case[k] for k in ("c1", "c2", "c3")]
    for fn in (lambda: TPT.fwdstats(case["x"], case["w"], case["mean"],
                                    case["scales"]),
               lambda: (TPT.red(*args),),
               lambda: TPT.dy(*args, *c123)):
        first, second = fn(), fn()
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,cin,cout", [(4, 40, 16, 32), (3, 22, 16, 48),
                                          (4, 40, 8, 32)])
def test_forward_and_dy_hold_one_y(cuda, b, h, cin, cout):
    """On general (not grid) inputs, fwdstats' Z and argmax equal the
    pooled extreme of dy's recomputed y and the first tap attaining it,
    bit for bit (torch_parity.check_y_consistency), on the tensor-core
    tile (Cin 16) and on the FP32-core loop (Cin 8)."""
    g = torch.Generator(device=cuda).manual_seed(b * h + cin)
    x = torch.randn((b, h, h, cin), generator=g, device=cuda).to(
        torch.bfloat16)
    w = (0.3 * torch.randn((3, 3, cin, cout), generator=g, device=cuda)).to(
        torch.bfloat16)
    scales = torch.linspace(-1, 1, cout, device=cuda)
    assert check_y_consistency(TPT, x, w, scales) == b * (h // 2) ** 2 * cout


@pytest.mark.cuda
@pytest.mark.parametrize("h", [32, 22])
@pytest.mark.parametrize("cin,cout", [(1, 16), (3, 16), (3, 32)])
def test_bwdg_tensor_core_matches_plain(cuda, cin, cout, h):
    """bwdg on the tensor cores (bwdg_tc_kernel: Cin <= 3, Cout 16 or 32)
    at B=8 against its plain version, with whole 8x8 pooled tiles (32x32)
    and partial ones (22x22), through check_train_kernels."""
    case = train_case(100 * cin + cout + h, 8, h, cin, cout, cuda)
    before = dict(TPT.bwdg_kernels)
    check_train_kernels(TPT, case)
    torch.cuda.synchronize()
    assert TPT.bwdg_kernels == {"tensor_core": before["tensor_core"] + 1,
                                "fp32_core": before["fp32_core"]}


def _bwdg_inputs(case):
    x, w, dp = case["x"], case["w"], case["dp"]
    z, am, st = TPT.fwdstats_plain(x, w, case["shift"], case["scales"])
    mean, _, inv = TPT._batch_stats(st, case["shift"], x.shape[0]
                                    * x.shape[1] * x.shape[2])
    return x, dp, z, am, mean, inv, case["scales"], case["biases"]


@pytest.mark.cuda
def test_bwdg_two_launches_bit_equal(cuda):
    """Every bwdg sum has one owner and one order: two launches of the
    tensor-core kernel on the same inputs are bit-equal."""
    args = _bwdg_inputs(train_case(11, 8, 32, 3, 16, cuda))
    first, second = TPT.bwdg(*args), TPT.bwdg(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,kernel", [(3, 16, "tensor_core"),
                                             (16, 32, "fp32_core"),
                                             (3, 48, "fp32_core")])
def test_bwdg_kernel_by_shape(cuda, cin, cout, kernel):
    """The library picks bwdg's kernel by shape: the tensor cores for the
    leading pair's Cin <= 3 and Cout 16 or 32, the FP32 cores for the
    other shapes the wrapper takes; both hold to the plain version."""
    args = _bwdg_inputs(train_case(cin + cout, 2, 16, cin, cout, cuda))
    before = dict(TPT.bwdg_kernels)
    got = TPT.bwdg(*args)
    torch.cuda.synchronize()
    assert TPT.bwdg_kernels[kernel] == before[kernel] + 1
    assert sum(TPT.bwdg_kernels.values()) == sum(before.values()) + 1
    for g, wv in zip(got, TPT.bwdg_plain(*args)):
        assert (g - wv).abs().max().item() <= 1e-3 * wv.abs().max().item()


@pytest.mark.cuda
def test_phase_train_block_gradient_on_cuda(cuda):
    """The fused pair's gradient on the card against a float64
    evaluation of the unfused bf16 chain's formulas at 1e-3, the scale
    and bias gradients against the chain's (torch_parity.
    check_pair_gradient)."""
    case = train_case(5, 8, 32, 3, 16, cuda, flat=False)
    before = dict(TPT.launches)
    check_pair_gradient(TPT, TC, TP, pair_spec(32, 3, 16), case)
    assert TPT.launches["bwdg"] == before["bwdg"] + 1


@pytest.mark.cuda
def test_train_wrappers_reject_bad_inputs(cuda):
    case = train_case(0, 2, 8, 3, 16, cuda)
    with pytest.raises(ValueError):
        TPT.fwdstats(case["x"].float(), case["w"], case["shift"],
                     case["scales"])
    with pytest.raises(ValueError):
        TPT.fwdstats(case["x"][:, :7], case["w"], case["shift"],
                     case["scales"])
    z, am, st = TPT.fwdstats(case["x"], case["w"], case["shift"],
                             case["scales"])
    with pytest.raises(ValueError):
        TPT.apply(z.float(), *([case["scales"]] * 4))
    with pytest.raises(ValueError):
        TPT.bwdg(torch.zeros((2, 8, 8, 17), device=cuda,
                             dtype=torch.bfloat16), case["dp"], z, am,
                 *([case["scales"]] * 4))


@pytest.mark.cuda
def test_throughput_engine_phase_stem_on_cuda(cuda):
    """ThroughputEngine(phase_stem=True) on the card: four pairs, one fwd
    kernel each (the taps fold at pair 1, the tile at pairs 2-4), no
    fwdstats or apply; each link equal to fwdstats + apply with identity
    constants and within one bf16 ulp of the plain engine's layers on the
    same input (see assert_stem_link_close for where the two conv sums
    round apart)."""
    spec = tiny_yolo_voc(width=64, height=64)
    params = random_bn(init_params(spec, seed=0), 1)
    eng = ThroughputEngine(spec, params, device=cuda, batch=8,
                           phase_stem=True)
    plain = ThroughputEngine(spec, params, device=cuda, batch=8)
    assert eng.phase_stem
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 1, (8, 64, 64, 3)).astype(np.float32)).to(cuda, torch.bfloat16)
    before = dict(TPT.launches)
    paths = dict(TPT.conv_kernels["fwd"])
    out = eng(x)
    torch.cuda.synchronize()
    # one fwd kernel a pair (pair 1 on the taps fold), no fwdstats or apply
    assert TPT.launches == {**before, "fwd": before["fwd"] + 4}
    assert {k: TPT.conv_kernels["fwd"][k] - paths[k] for k in paths} == {
        "tensor_core": 3, "tensor_core_fold": 1, "fp32_core": 0}
    assert out.shape == plain(x).shape
    v = x
    for ci in (0, 2, 4, 6):
        p = eng.params[ci]
        w = p["weights"].permute(2, 3, 1, 0).contiguous()
        got = TPT.fwd_pair(v, w, p["biases"].float())
        comp, z = _fwd_composition(v, w, p["biases"].float())
        assert torch.equal(got, comp)
        with torch.no_grad():
            ref = plain._net.layers[ci + 1](plain._net.layers[ci](
                v.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
        assert_stem_link_close(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(),
                               z.float().cpu().numpy())
        v = got


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,cin,cout", [(4, 32, 16, 32), (3, 40, 16, 16),
                                          (2, 24, 8, 48)])
def test_chain_kernels_match_plain(cuda, b, h, cin, cout):
    """red, dy (+ dw) and dgrad at small shapes against their plain
    versions (torch_parity.check_chain_kernels); 40 x 40 and 24 x 24
    leave partial 8 x 8 pooled tiles, Cin = 8 half of dgrad's widest;
    red and dy run the tensor-core tile at Cin 16, the FP32-core loop at
    Cin 8."""
    before = dict(TPT.launches)
    tc = TPT.conv_kernels["dy"]["tensor_core"]
    check_chain_kernels(TPT, chain_case(h + cin, b, h, cin, cout, cuda))
    torch.cuda.synchronize()
    assert {k: TPT.launches[k] - before[k] for k in before} == {
        "fwdstats": 0, "apply": 0, "bwdg": 0, "red": 1, "dy": 1, "dgrad": 1,
        "fwd": 0}
    assert TPT.conv_kernels["dy"]["tensor_core"] == tc + (cin == 16)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,cin,cout", [
    (2, 33, 47, 16, 32), (3, 24, 40, 8, 128), (1, 208, 208, 16, 32),
    (1, 1, 5, 8, 16)])
def test_dgrad_kernel_tiles(cuda, b, h, w, cin, cout):
    """The tensor-core dgrad at shapes that cut its 16 x 32 output tiles
    (odd and partial, one row, Cin 8 and 16, Cout up to 128): within one
    bf16 ulp of dgrad_plain, two launches bit-equal (one owner and one
    summation order per output), one launch counted per call."""
    case = dgrad_case(b + h + w, b, h, w, cin, cout, cuda)
    before = TPT.launches["dgrad"]
    dx = TPT.dgrad(case["d"], case["w"])
    torch.cuda.synchronize()
    assert TPT.launches["dgrad"] == before + 1
    assert dx.shape == (b, h, w, cin) and dx.dtype == torch.bfloat16
    assert_bf16_close(dx.float().cpu().numpy(),
                      TPT.dgrad_plain(case["d"], case["w"])
                      .float().cpu().numpy())
    again = TPT.dgrad(case["d"], case["w"])
    torch.cuda.synchronize()
    assert TPT.launches["dgrad"] == before + 2
    assert torch.equal(dx, again)


@pytest.mark.cuda
def test_dx_pair_gradient_on_cuda(cuda):
    """The chain's second pair on the card against a float64 evaluation of
    the unfused chain's formulas, its input gradient included
    (torch_parity.check_pair_gradient; the cotangent zeroed where the
    kernel's recomputed conv routes a window apart from cuDNN's)."""
    case = train_case(6, 8, 32, 16, 32, cuda, flat=False)
    spec = TS.ConvSpec(index=2, h=32, w=32, c=16, inputs=32 * 32 * 16,
                       out_h=32, out_w=32, out_c=32, outputs=32 * 32 * 32,
                       size=3, stride=1, pad=1, filters=32,
                       activation="leaky", batch_normalize=True)
    before = dict(TPT.launches)
    check_pair_gradient(TPT, TC, TP, spec, case, dx=1e-2)
    assert TPT.launches["dgrad"] == before["dgrad"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("c,h,channels_last", [
    (16, 32, True), (32, 16, True), (256, 6, True), (512, 4, True),
    (24, 16, True), (4, 16, True), (16, 12, False), (64, 8, False)])
def test_fused_stem_kernels_match_plain(cuda, c, h, channels_last):
    """F2, B1 and B2 against their plain versions, y channels-last (the
    port's conv output on the card) or NCHW in memory
    (torch_parity.check_fused_stem_kernels). F2, B1 and B2 take the row
    kernels where y and dp are channels-last and C a multiple of 8 (C 24
    too, which the strided B1 refuses), the strided kernels otherwise (C
    4, NCHW)."""
    before, paths = dict(TFS.launches), dict(TFS.paths)
    check_fused_stem_kernels(TFS, stem_case(c + h, 4, h, c, cuda,
                                            channels_last))
    torch.cuda.synchronize()
    assert {k: TFS.launches[k] - before[k] for k in before} == {
        "f2": 1, "b1": 2, "b2": 1}
    row = channels_last and c % 8 == 0
    assert {k: TFS.paths[k] - paths[k] for k in paths} == {
        "f2_row": row, "b1_row": 2 * row, "b2_row": row, "f2": not row,
        "b1": 2 * (not row), "b2": not row}


# yolov2-608's fused-stem pairs (H, C): layers 0, 2, 6 and 10
Y2_STEM = [(608, 32), (304, 64), (152, 128), (76, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h", [(2, 608), (8, 152)])
def test_train_kernels_yolov2_pair(cuda, b, h):
    """The training pair at yolov2-608's 3 -> 32: fwdstats on the taps
    fold, apply and bwdg on the tensor cores against their plain
    versions (chip_smoke's phase-12 tolerances) at 608 (38x38 whole 8x8
    pooled tiles) and at 152 (W2 = 76: partial tiles), and at 152 the
    pair's gradient against the float64 evaluation
    (check_pair_gradient)."""
    case = train_case(h + b, b, h, 3, 32, cuda)
    before = {k: dict(v) for k, v in (("conv", TPT.conv_kernels["fwdstats"]),
                                      ("bwdg", TPT.bwdg_kernels))}
    check_train_kernels(TPT, case)
    torch.cuda.synchronize()
    assert TPT.conv_kernels["fwdstats"]["tensor_core_fold"] == \
        before["conv"]["tensor_core_fold"] + 1
    assert TPT.bwdg_kernels["tensor_core"] == \
        before["bwdg"]["tensor_core"] + 1
    if h == 152:
        check_pair_gradient(TPT, TC, TP, pair_spec(h, 3, 32),
                            train_case(h, b, h, 3, 32, cuda, flat=False))


@pytest.mark.cuda
@pytest.mark.parametrize("h,c", Y2_STEM)
def test_fused_stem_kernels_yolov2_pairs(cuda, h, c):
    """F2, B1 and B2 at yolov2-608's four fused-stem pairs (B=2,
    channels-last) on the row kernels, against their plain versions."""
    paths = dict(TFS.paths)
    check_fused_stem_kernels(TFS, stem_case(h + c, 2, h, c, cuda))
    torch.cuda.synchronize()
    assert {k: TFS.paths[k] - paths[k] for k in paths} == {
        **dict.fromkeys(paths, 0), "f2_row": 1, "b1_row": 2, "b2_row": 1}


@pytest.mark.cuda
@pytest.mark.slow
def test_fused_stem_past_2g_bytes(cuda):
    """yolov2-608's layer 0 at B=128: y (128, 32, 608, 608) bf16 is 3.03
    GB, so images 91-127 lie past 2^31 bytes; F2, B1 and B2 on the row
    kernels against their plain versions on every image (16 at a time),
    with the batch's own statistics."""
    case = stem_case(608, 128, 608, 32, cuda)
    assert images_past_2g(case["y"]) == 91
    paths = dict(TFS.paths)
    check_fused_stem_kernels(TFS, case, chunk=16)
    torch.cuda.synchronize()
    assert TFS.paths["b2_row"] == paths["b2_row"] + 1


@pytest.mark.cuda
@pytest.mark.slow
def test_train_kernels_yolov2_pair_b128(cuda):
    """The pair at yolov2-608's full training batch (B=128, 3 -> 32 @608),
    the plain versions 16 images at a time."""
    check_train_kernels(TPT, train_case(608, 128, 608, 3, 32, cuda),
                        chunk=16)


@pytest.mark.cuda
@pytest.mark.parametrize("h,c", [(416 >> k, 16 << k) for k in range(5)])
def test_f2_row_at_the_fusable_pairs(cuda, h, c):
    """F2 at the five fusable pairs' conv outputs (B=8, channels-last as
    the conv writes them) on the row kernel, bit-equal to f2_plain; the
    same y in NCHW memory still takes f2_kernel, with the same values."""
    case = stem_case(h + c, 8, h, c, cuda)
    k4 = [case[k] for k in ("mean", "inv", "scales", "biases")]
    paths = dict(TFS.paths)
    got = TFS.f2(case["y"], *k4)
    nchw = TFS.f2(case["y"].contiguous(), *k4)
    torch.cuda.synchronize()
    assert {k: TFS.paths[k] - paths[k] for k in paths} == {
        **dict.fromkeys(paths, 0), "f2_row": 1, "f2": 1}
    assert got.is_contiguous(memory_format=torch.channels_last)
    ref = TFS.f2_plain(case["y"], *k4)
    assert torch.equal(got, ref), (got != ref).sum().item()
    assert torch.equal(nchw, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["y", "dp"])
def test_fused_stem_misaligned_view_takes_strided_kernels(cuda, which):
    """A channels-last view 2 bytes past a 16-byte boundary (y or dp)
    goes to the strided B1 and B2 (and for y, F2), which match their
    plain versions."""
    case = stem_case(7, 4, 16, 32, cuda)
    case[which] = misaligned(case[which])
    assert case[which].data_ptr() % 16 == 2
    paths = dict(TFS.paths)
    check_fused_stem_kernels(TFS, case)
    torch.cuda.synchronize()
    f2_row = which == "dp"             # F2 reads y alone
    assert {k: TFS.paths[k] - paths[k] for k in paths} == {
        "f2_row": f2_row, "b1_row": 0, "b2_row": 0, "f2": not f2_row,
        "b1": 2, "b2": 1}


@pytest.mark.cuda
def test_chain_and_fused_stem_wrappers_reject_bad_inputs(cuda):
    case = chain_case(0, 2, 8, 16, 32, cuda)
    consts = [case[k] for k in ("mean", "inv", "scales", "biases")]
    with pytest.raises(ValueError):
        TPT.red(case["x"].float(), case["w"], case["dp"], *consts)
    with pytest.raises(ValueError):
        TPT.dgrad(case["d"], case["w"][:, :, :12])     # Cin not 8 or 16
    # NCHW (the strided B1) with 48 channels, which do not divide 256
    stem = stem_case(0, 2, 8, 48, cuda, channels_last=False)
    k4 = [stem[k] for k in ("mean", "inv", "scales", "biases")]
    with pytest.raises(ValueError):
        TFS.b1(stem["y"], stem["dp"], *k4)
    with pytest.raises(ValueError):
        TFS.f2(stem["y"][:, :, :7], *k4)


# ------------------------------------------------------------- yolov2 ---


@pytest.fixture
def yolov2_params(cuda):
    """yolov2's numpy params (the same at every input size) with random
    BN statistics and biases."""
    spec = yolov2(width=64, height=64)
    return random_bn(init_params(spec, seed=0), 1, head_gain=4.0)


@pytest.mark.cuda
def test_yolov2_network_on_cuda(cuda, yolov2_params):
    """The float32 Network on yolov2 at 64x64 (route -9, reorg 2, route
    -1,-4) on the card against the CPU, every layer (TF32 off: cuDNN's
    and the CPU's float32 sums differ in order only)."""
    spec = yolov2(width=64, height=64)
    x = torch.from_numpy(np.random.default_rng(6).uniform(
        0, 1, (2, 64, 64, 3)).astype(np.float32))
    outs = {}
    for dev in ("cpu", cuda):
        net = Network(spec, params_to_torch(spec, yolov2_params, dev))
        with torch.no_grad():
            _, aux = net(x.to(dev), keep_all=True)
        outs[str(dev)] = {i: t.float().cpu() for i, t in
                          aux["outputs"].items()}
    for i, l in enumerate(spec.layers):
        torch.testing.assert_close(outs["cuda"][i], outs["cpu"][i],
                                   rtol=1e-4, atol=1e-4,
                                   msg=f"layer {i} ({l.kind})")


@pytest.mark.cuda
def test_yolov2_int8_route_on_cuda(cuda, yolov2_params, monkeypatch):
    """The int8 program on yolov2 at 64x64 on the card and on the CPU,
    calibrated to the same amax: equal scales, the route's requantized
    source included, and the int8 trunk (the route's output and the last
    3x3 conv's) equal bit for bit."""
    import sr_object_detection_tpu_torch.infer.quant as TQ
    spec = yolov2(width=64, height=64)
    calib = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    pf, fspec = fold_params_for_inference(
        spec, params_to_torch(spec, yolov2_params, "cpu"), torch.float32)
    amax = TQ.calibrate_amax(fspec, pf, calib, device="cpu")
    monkeypatch.setattr(TQ, "calibrate_amax", lambda *a, **k: amax)
    qc = TQ.quantize_for_inference(spec, yolov2_params, calib, device="cpu")
    qg = TQ.quantize_for_inference(spec, yolov2_params, calib, device=cuda)
    s = qg.act_scales
    assert s == qc.act_scales and s[27] != s[24]
    assert s[28] == max(s[27], s[24])
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (4, 64, 64, 3), dtype=np.uint8))
    for stop in (29, 30):
        got = qg.forward(x.to(cuda), stop=stop)
        assert got.dtype == torch.int8
        assert torch.equal(got.cpu(), qc.forward(x, stop=stop)), stop
    out = qg.forward(x.to(cuda))
    assert out.shape == (4, 2 * 2 * 5 * 85) and torch.isfinite(out).all()


@pytest.mark.cuda
def test_yolov2_stems_on_cuda(cuda, yolov2_params):
    """yolov2's two stem pairs (3 -> 32 @64, 32 -> 64 @32) in the three
    stems on the card against their plain versions: the bf16 serving stem
    (fwd on the taps fold and on the tile, each link equal to fwdstats +
    apply and within assert_fwd_close of fwd_pair_plain), the int8 stem at
    batch 128 (taps and chunks folds; the stem engine's trunk equal to the
    plain engine's) and the batch-1 stem (the tile's stem mode, within one
    bf16 ulp of stem_pair_plain)."""
    spec = yolov2(width=64, height=64)
    rng = np.random.default_rng(2)
    # bf16 serving stem
    eng = ThroughputEngine(spec, yolov2_params, device=cuda, batch=8,
                           phase_stem=True)
    x = torch.from_numpy(rng.uniform(0, 1, (8, 64, 64, 3)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    before, paths = dict(TPT.launches), dict(TPT.conv_kernels["fwd"])
    out = eng(x)
    torch.cuda.synchronize()
    assert TPT.launches == {**before, "fwd": before["fwd"] + 2}
    assert {k: TPT.conv_kernels["fwd"][k] - paths[k] for k in paths} == {
        "tensor_core": 1, "tensor_core_fold": 1, "fp32_core": 0}
    assert out.shape == (8, 2 * 2 * 5 * 85)
    v = x
    for ci in (0, 2):
        p = eng.params[ci]
        w = p["weights"].permute(2, 3, 1, 0).contiguous()
        got = TPT.fwd_pair(v, w, p["biases"].float())
        comp, z = _fwd_composition(v, w, p["biases"].float())
        assert torch.equal(got, comp)
        assert_fwd_close(got.float().cpu().numpy(),
                         TPT.fwd_pair_plain(v, w, p["biases"].float())
                         .float().cpu().numpy(), z.float().cpu().numpy())
        v = got
    # int8 stem at the serving batch
    calib = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    q_stem = QuantizedThroughputEngine(spec, yolov2_params, batch=128,
                                       device=cuda, calib_x=calib,
                                       phase_stem=True)
    q_plain = QuantizedThroughputEngine(spec, yolov2_params, batch=128,
                                        device=cuda, calib_x=calib)
    u8 = torch.from_numpy(rng.integers(0, 256, (128, 64, 64, 3),
                                       dtype=np.uint8)).to(cuda)
    folds = dict(TPS.folds)
    trunk = q_stem.qnet.forward(u8, stop=30)
    torch.cuda.synchronize()
    assert {k: TPS.folds[k] - folds[k] for k in folds} == {
        "taps": 1, "tap_pairs": 0, "chunks": 1}
    assert torch.equal(trunk, q_plain.qnet.forward(u8, stop=30))
    # batch-1 stem
    fused = LatencyEngine(spec, yolov2_params, device=cuda, fused_stem=True)
    assert fused.fused_stem
    before, paths = TBS.launches, dict(TBS.paths)
    v = x[:1]
    fused.forward(v)
    torch.cuda.synchronize()
    assert TBS.launches == before + 2
    assert {k: TBS.paths[k] - paths[k] for k in paths} == {
        "tensor_core": 1, "tensor_core_fold": 1, "fp32_core": 0}
    for ci in (0, 2):
        p = fused.params[ci]
        w = p["weights"].permute(2, 3, 1, 0).to(torch.bfloat16).contiguous()
        b = p["biases"].float()
        got = TBS.stem_pair(v, w, b)
        assert_bf16_close(got.float().cpu().numpy(),
                          TBS.stem_pair_plain(v, w, b).float().cpu().numpy())
        v = got
