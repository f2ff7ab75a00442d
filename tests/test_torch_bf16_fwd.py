"""The bf16 serving stem's kernel (kernel 4's mode "fwd"), on the CPU.

``conv_tc_body`` (csrc/phase_train.cu) in mode ``CT_FWD`` (``fwd_tc_kernel``;
``fwd_fold_kernel`` at Cin <= 3) computes a pair of the bf16 serving stem
of ``ThroughputEngine(phase_stem=True)`` in one launch: the tile's float32
conv sums, the maximum of each window's four, then the mode's roundings
v = bf16(m), zb = bf16(v + bias) and the bf16 leaky. The kernel runs only
on the card (tests/test_torch_cuda.py holds it there to fwdstats + apply
with torch.equal); here:

* a numpy emulation of that max-first epilogue equals
  ``phase_train.fwd_epilogue_plain`` (the JAX mode's per-tap order, which
  ``fwd_pair_plain`` runs after its conv) bit for bit, but for the sign of
  a zero, on 120,000 seeded windows (ties, all-negative windows, zeros,
  subnormals, biases that cancel the sum);
* ``phase_train.conv_path("fwd", ...)``, the Python mirror of the
  library's shape rule;
* ``fwd_pair_plain`` against ``fwdstats_plain`` + ``apply_plain`` with
  identity constants (the composition it replaces): equal on an exact
  grid; on general inputs within one bf16 ulp of the pooled conv value
  (ROADMAP queue 3, item 10) carried through the bias add's and the
  leaky's roundings (torch_parity.assert_fwd_close);
* ``fwd_pair_plain`` against the JAX package's ``build_bf16_stem`` (its
  ``_run("fwd")`` kernel in interpret mode) on one small case.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sr_object_detection_tpu.kernels.phase_train as JPT
from sr_object_detection_tpu.graph.spec import parse_network_cfg as j_parse
from sr_object_detection_tpu.io.weights import init_params as j_init_params
import sr_object_detection_tpu_torch.kernels.phase_train as TPT
from test_torch_b1_stem_tc import bf16_bits
from torch_parity import assert_fwd_close

SLOPE = np.float32(0.10009765625)        # bf16(0.1)


def bf16(v):
    """float32 -> float32 holding the nearest bf16."""
    return (bf16_bits(v).astype(np.uint32) << 16).view(np.float32)


def max_first(acc, bias):
    """The kernel's epilogue (serve_out<CT_FWD>): the maximum of the
    window's raw float32 sums, v = bf16(m), zb = bf16(v + b) and the bf16
    leaky; returns bf16 bits. acc (..., 4) float32, bias bf16 values."""
    zb = bf16(bf16(acc.max(-1)) + bias)
    return bf16_bits(np.where(zb > 0, zb, zb * SLOPE))


def per_tap_plain(acc, bias):
    """fwd_epilogue_plain on the windows: window i as channel i of a
    (1, 2, 2, n) NHWC conv output (tap 2 r + c at row r, column c);
    returns bf16 bits."""
    y = torch.from_numpy(acc.reshape(1, -1, 2, 2).transpose(0, 2, 3, 1)
                         .copy())
    out = TPT.fwd_epilogue_plain(y, torch.from_numpy(bias))
    return out.reshape(-1).view(torch.int16).numpy().view(np.uint16)


def test_max_first_epilogue_equals_per_tap_order():
    rng = np.random.default_rng(0)
    n = 120_000
    acc = rng.normal(0, 1, (n, 4)).astype(np.float32)
    bias = bf16(rng.normal(0, 0.5, n).astype(np.float32))
    k = n // 8
    acc[:k] = -np.abs(acc[:k])                       # all-negative windows
    acc[k:2 * k, 1:] = acc[k:2 * k, :1]              # four-way ties
    acc[2 * k:3 * k, 3] = acc[2 * k:3 * k, 0]        # two-way ties
    # biases that cancel the sum: bf16(m) = -b, zb = +0
    acc[3 * k:4 * k, 2] = -bias[3 * k:4 * k]
    acc[3 * k:4 * k, [0, 1, 3]] = -np.abs(acc[3 * k:4 * k, [0, 1, 3]]) \
        - np.abs(bias[3 * k:4 * k, None])
    acc[4 * k:5 * k] = np.where(rng.random((k, 4)) < 0.5, -0.0, 0.0)
    bias[4 * k:5 * k] = np.where(np.arange(k) % 2, -0.0, 0.0)  # zeros
    # subnormal sums and biases, whose leaky underflows or stays subnormal
    acc[5 * k:6 * k] = rng.uniform(-1e-38, 1e-39, (k, 4)).astype(np.float32)
    bias[5 * k:6 * k] = bf16(rng.uniform(-1e-38, 1e-38, k).astype(
        np.float32))
    acc[6 * k:7 * k] *= np.float32(1e30)             # large magnitudes
    # sums a hair either side of a bf16 rounding boundary
    acc[7 * k:] = bf16(acc[7 * k:]) * np.float32(1 + 2 ** -9)
    got, want = max_first(acc, bias), per_tap_plain(acc, bias)
    zero = (got & 0x7FFF) == 0
    assert np.array_equal(zero, (want & 0x7FFF) == 0)
    assert np.array_equal(got[~zero], want[~zero])
    # not vacuous: cancelled windows give zeros of both signs, the
    # subnormal block reaches subnormal outputs, the leaky's negative side
    # appears
    assert zero[3 * k:4 * k].all() and (got[zero] == 0x8000).any()
    assert ((got[5 * k:6 * k] & 0x7F80) == 0).sum() > k // 2
    assert (got[~zero] & 0x8000).any()


@pytest.mark.parametrize("cin,cout,path", [
    (3, 16, "tensor_core_fold"), (1, 32, "tensor_core_fold"),
    (2, 128, "tensor_core_fold"), (16, 32, "tensor_core"),
    (32, 64, "tensor_core"), (64, 128, "tensor_core"),
    (48, 16, "tensor_core"), (4, 16, "fp32_core"), (8, 16, "fp32_core"),
    (15, 32, "fp32_core"), (24, 32, "fp32_core"), (40, 48, "fp32_core"),
    (3, 8, "fp32_core"), (16, 24, "fp32_core")])
def test_fwd_path_by_shape(cin, cout, path):
    """The tile where Cout is a multiple of 16 and Cin a multiple of 16,
    its taps fold at Cin <= 3, fwdstats_kernel + apply_kernel for the rest;
    tiny-yolo-voc's four pairs all take the tile."""
    assert TPT.conv_path("fwd", cin, cout) == path
    assert TPT.MODE_INDEX["fwd"] == 4
    for cin_, cout_, p in ((3, 16, "tensor_core_fold"),
                           (16, 32, "tensor_core"), (32, 64, "tensor_core"),
                           (64, 128, "tensor_core")):
        assert TPT.conv_path("fwd", cin_, cout_) == p


def test_cpu_launches_nothing():
    """A CPU tensor takes the plain version: no launch, no path."""
    before = dict(TPT.launches)
    paths = dict(TPT.conv_kernels["fwd"])
    x = torch.zeros((2, 4, 6, 16), dtype=torch.bfloat16)
    out = TPT.fwd_pair(x, torch.zeros((3, 3, 16, 32), dtype=torch.bfloat16),
                       torch.zeros(32))
    assert out.shape == (2, 2, 3, 32) and out.dtype == torch.bfloat16
    assert TPT.launches == before and TPT.conv_kernels["fwd"] == paths


def _case(seed, b, h, wd, cin, cout, grid):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (b, h, wd, cin))
    w = rng.normal(0, 0.3, (3, 3, cin, cout))
    if grid:                  # eighths and sixteenths: every sum exact
        x, w = np.round(x * 8) / 8, np.round(w * 16) / 16
    bias = torch.from_numpy(rng.normal(0, 0.5, cout).astype(np.float32))
    return (torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16),
            torch.from_numpy(w.astype(np.float32)).to(torch.bfloat16),
            bias.to(torch.bfloat16).float())


def _composition(x, w, bias):
    cout = w.shape[3]
    zero, one = torch.zeros(cout), torch.ones(cout)
    z, _, _ = TPT.fwdstats_plain(x, w, zero, one)
    return TPT.apply_plain(z, zero, one, one, bias), z


@pytest.mark.parametrize("b,h,wd,cin,cout", [
    (2, 20, 20, 3, 16), (2, 12, 18, 16, 32), (1, 10, 10, 32, 64)])
def test_fwd_pair_plain_equals_fwdstats_apply(b, h, wd, cin, cout):
    # on an exact grid both round the same float32 sums: equal
    x, w, bias = _case(h + cin, b, h, wd, cin, cout, grid=True)
    got = TPT.fwd_pair_plain(x, w, bias)
    want, _ = _composition(x, w, bias)
    assert torch.equal(got, want)
    assert (want.float() < 0).any() and (want.float() > 0).any()
    # general inputs: the two convs' sums in other orders may round to
    # bf16 an ulp apart (queue 3, item 10), and the bias add and the
    # leaky round once more each
    x, w, bias = _case(h + cin + 1, b, h, wd, cin, cout, grid=False)
    got = TPT.fwd_pair_plain(x, w, bias)
    want, z = _composition(x, w, bias)
    assert_fwd_close(got.float().numpy(), want.float().numpy(),
                     z.float().numpy())


def test_fwd_pair_rounds_float32_bias():
    # a float32 bias of no bf16 values is rounded to bf16 first, as apply
    # rounds it (the kernel rounds it where it stages it)
    x, w, bias = _case(5, 2, 12, 18, 16, 32, grid=True)
    fine = bias + torch.linspace(1e-4, 3e-3, 32)
    assert not torch.equal(fine.to(torch.bfloat16).float(), fine)
    got = TPT.fwd_pair(x, w, fine)
    assert torch.equal(got, TPT.fwd_pair_plain(
        x, w, fine.to(torch.bfloat16).float()))
    assert torch.equal(got, _composition(x, w, fine)[0])


PAIR_CFG = """[net]
batch=128
width=16
height=16
channels=3

[convolutional]
filters=16
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2
"""


def test_fwd_pair_plain_matches_jax_fwd(tmp_path):
    """The JAX package's build_bf16_stem on a one-pair net (3 -> 16 at
    16x16, batch 128, no BN: its _run("fwd") kernel in interpret mode)
    against fwd_pair_plain on the same weights and bf16 bias. On the CPU
    XLA keeps excess float32 precision across the JAX chain's bf16 round
    trips (ROADMAP queue 3, item 5), so the two agree as two conv sum
    orders do (torch_parity.assert_fwd_close)."""
    cfg = tmp_path / "pair.cfg"
    cfg.write_text(PAIR_CFG)
    spec = j_parse(str(cfg))
    params = j_init_params(spec, seed=0)
    rng = np.random.default_rng(1)
    bias = rng.normal(0, 0.5, 16).astype(np.float32)
    params[0]["biases"] = jnp.asarray(bias)
    x = rng.uniform(0, 1, (128, 16, 16, 3)).astype(np.float32)
    JPT._INTERPRET = True
    try:
        stem_fn, n = JPT.build_bf16_stem(spec, params, max_pairs=1)
        assert stem_fn is not None and n == 2
        want = np.asarray(stem_fn(jnp.asarray(x)).astype(jnp.float32))
    finally:
        JPT._INTERPRET = False
    w = torch.from_numpy(np.array(params[0]["weights"], np.float32)).to(
        torch.bfloat16)                                   # HWIO
    b = torch.from_numpy(bias).to(torch.bfloat16).float()
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = TPT.fwd_pair_plain(xb, w, b)
    _, z = _composition(xb, w, b)
    assert got.shape == want.shape
    assert_fwd_close(got.float().numpy(), want, z.float().numpy())
    assert (want < 0).any() and (want > 0).any()


def test_assert_fwd_close_bound():
    """The helper's bound: a flip of bf16(v + b) carried through the
    leaky passes; the same error on the positive side, or three ulps of
    an output whose conv value carries no cancellation, does not."""
    z = np.float32([0.003, 0.5, 0.5])
    ref = bf16(np.float32([-0.0065612793, 0.5, 0.5]))
    got = bf16(np.float32([-0.0065002441, 0.5, 0.5]))
    assert_fwd_close(got, ref, z)
    with pytest.raises(AssertionError):
        assert_fwd_close(-got, -ref, z)        # positive: ulp(z) + ulp(out)
    bad = ref.copy()
    bad[1] = bf16(np.float32(0.5 + 3 * 2 ** -8))
    with pytest.raises(AssertionError):
        assert_fwd_close(bad, ref, z)
