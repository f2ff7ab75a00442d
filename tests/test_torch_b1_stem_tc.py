"""The batch-1 stem on the tensor-core conv tile, on the CPU.

``conv_tc_body`` (csrc/phase_train.cu) in its stem mode (``stem_tc_kernel``;
``stem_fold_kernel`` at Cin <= 3) computes a pair of the batch-1 stem,
``bf16(max over 2x2 of leaky_0.1(conv3x3(x, w) + b))``, on the tile that
fwdstats uses: the conv of an 8x8 pooled tile as one GEMM (M = the 16x16
positions in the m16 order of tests/test_torch_conv_tile.py, K = 9 x Cin
in k16 steps, or the taps fold's two k16 steps of X' [256 x 32] at Cin
<= 3), then an epilogue that takes the maximum of the window's four raw
float32 sums and adds the bias and applies the leaky once. The kernel
runs only on the card (tests/test_torch_cuda.py holds it to
``stem_pair_plain`` there); here:

* the max-then-bias-then-leaky epilogue equals ``stem_pair_kernel``'s
  per-tap order bit for bit on seeded float32 sums (ties, all-negative
  windows, zeros, subnormals), but for the sign of a zero;
* ``phase_train.conv_path("stem", ...)``, the Python mirror of the
  library's shape rule;
* the tile's GEMM (k16 steps or the taps fold's X'), its m16 position
  map and lane-pair window gather, and the epilogue, emulated on inputs of
  an exact grid (every float32 conv sum exact), equal ``stem_pair_plain``
  over partial 8x8 tiles at 26 and 52, and, at one shape, the JAX
  package's ``_pair_kernel`` in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sr_object_detection_tpu.kernels.b1_stem as JBS
import sr_object_detection_tpu_torch.kernels.b1_stem as TBS
import sr_object_detection_tpu_torch.kernels.phase_train as TPT
from test_torch_conv_tile import (conv_tiles, gather_windows, halos,
                                  m_positions, scatter)
from torch_parity import assert_bf16_close

SLOPE = np.float32(0.1)


def bf16_bits(v):
    """float32 -> the bits of the nearest bf16 (ties to even)."""
    u = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def leaky(v):
    return np.where(v > 0, v, SLOPE * v)


def per_tap(acc, bias):
    """stem_pair_kernel's order: per tap fl(acc + b), leaky, then the
    window's maximum, rounded to bf16 once. acc (..., 4) float32."""
    return bf16_bits(leaky(acc + bias[..., None]).max(-1))


def max_first(acc, bias):
    """The tile's epilogue: the maximum of the raw sums, then fl(m + b)
    and the leaky, rounded to bf16 once."""
    return bf16_bits(leaky(acc.max(-1) + bias))


def test_max_first_epilogue_equals_per_tap_order():
    rng = np.random.default_rng(0)
    n = 400_000
    acc = rng.normal(0, 1, (n, 4)).astype(np.float32)
    bias = rng.normal(0, 0.5, n).astype(np.float32)
    k = n // 8
    acc[:k] = -np.abs(acc[:k])                       # all-negative windows
    acc[k:2 * k, 1:] = acc[k:2 * k, :1]              # four-way ties
    acc[2 * k:3 * k, 3] = acc[2 * k:3 * k, 0]        # two-way ties
    acc[3 * k:4 * k, 2] = -bias[3 * k:4 * k]         # fl(m + b) = +0
    acc[3 * k:4 * k, [0, 1, 3]] = -np.abs(acc[3 * k:4 * k, [0, 1, 3]]) \
        - bias[3 * k:4 * k, None]
    acc[4 * k:5 * k] = -0.0                          # signed zeros
    bias[4 * k:5 * k] = np.where(np.arange(k) % 2, -0.0, 0.0)
    # subnormal results, whose leaky underflows to -0 or stays subnormal
    acc[5 * k:6 * k] = -rng.uniform(0, 1e-37, (k, 4)).astype(np.float32)
    bias[5 * k:6 * k] = 0.0
    acc[6 * k:7 * k] *= np.float32(1e30)             # large magnitudes
    got, want = max_first(acc, bias), per_tap(acc, bias)
    zero = (got & 0x7FFF) == 0
    assert np.array_equal(zero, (want & 0x7FFF) == 0)
    assert np.array_equal(got[~zero], want[~zero])
    # the cases are not vacuous: zeros of both signs and subnormal leaky
    # outputs occur, and ties in half the windows
    assert zero.sum() > k // 2 and (got[zero] == 0x8000).any()
    sub = leaky(acc[5 * k:6 * k].max(-1))
    assert ((sub != 0) & (np.abs(sub) < np.finfo(np.float32).tiny)).any()


@pytest.mark.parametrize("cin,cout,path", [
    (3, 16, "tensor_core_fold"), (1, 32, "tensor_core_fold"),
    (2, 128, "tensor_core_fold"), (16, 32, "tensor_core"),
    (32, 64, "tensor_core"), (64, 128, "tensor_core"),
    (128, 16, "tensor_core"), (16, 256, "tensor_core"),
    (4, 16, "fp32_core"), (8, 16, "fp32_core"), (24, 32, "fp32_core"),
    (144, 32, "fp32_core"), (256, 64, "fp32_core"), (3, 8, "fp32_core"),
    (16, 24, "fp32_core"), (64, 120, "fp32_core")])
def test_stem_path_by_shape(cin, cout, path):
    """The tile where Cout is a multiple of 16 and Cin is at most 3 (the
    taps fold) or a multiple of 16 up to 128; stem_pair_kernel for every
    other shape. tiny-yolo-voc's four pairs all take the tile."""
    assert TPT.conv_path("stem", cin, cout) == path
    for cin_, cout_ in ((3, 16), (16, 32), (32, 64), (64, 128)):
        assert TPT.conv_path("stem", cin_, cout_) != "fp32_core"


def test_cpu_launches_nothing():
    """A CPU tensor takes the plain version: no launch, no path."""
    TBS.reset_launches()
    x = torch.zeros((1, 4, 4, 16), dtype=torch.bfloat16)
    out = TBS.stem_pair(x, torch.zeros((3, 3, 16, 32), dtype=torch.bfloat16),
                        torch.zeros(32))
    assert out.shape == (1, 2, 2, 32)
    assert TBS.launches == 0 and not any(TBS.paths.values())


def fold_tiles(x, w):
    """The taps fold's GEMM of every tile: X' [256 positions x 32] (column
    t * Cin + ci the tap's value, zero past 9 Cin) times the weights'
    rows t * Cin + ci (HWIO flattened, zero past 9 Cin), in two k16
    steps: (B, ty, tx, 256 rows in M order, Cout) float64."""
    cin, cout = x.shape[3], w.shape[3]
    assert 9 * cin <= 32
    hal = halos(x)
    fy, fx = m_positions()
    cols = [hal[:, :, :, fy + t // 3, fx + t % 3, ci]
            for t in range(9) for ci in range(cin)]
    xp = torch.zeros((*hal.shape[:3], 256, 32), dtype=torch.float64)
    xp[..., :9 * cin] = torch.stack(cols, -1)
    wp = torch.zeros((32, cout), dtype=torch.float64)
    wp[:9 * cin] = w.double().reshape(9 * cin, cout)
    return xp[..., :16] @ wp[:16] + xp[..., 16:] @ wp[16:]


def model_stem(x, w, bias):
    """The pair through the tile: the GEMM in float32 (exact on the
    grid), the lanes' windows after the shuffle, the max-first epilogue,
    each window stored at its pooled pixel; (1, H/2, W/2, Cout) bf16."""
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    acc = (fold_tiles(x, w) if cin <= 3 else conv_tiles(x, w)).float()
    idx, v = gather_windows(acc, cout)
    o = max_first(v.numpy(), bias.numpy()[idx["c"]])
    vals = torch.from_numpy(o.astype(np.int16)).view(torch.bfloat16).float()
    return scatter(vals, idx, b, h // 2, wd // 2, cout).to(torch.bfloat16)


def grid_case(seed, h, wd, cin, cout):
    """x in eighths, w in sixteenths (every float32 conv sum exact),
    bias normal, from a seed."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(np.round(rng.uniform(0, 1, (1, h, wd, cin)) * 8)
                         / 8).to(torch.bfloat16)
    w = torch.from_numpy(np.round(rng.normal(0, 0.3, (3, 3, cin, cout))
                                  * 16) / 16).to(torch.bfloat16)
    bias = torch.from_numpy(rng.normal(0, 0.5, cout).astype(np.float32))
    return x, w, bias


@pytest.mark.parametrize("h,wd,cin,cout", [
    (26, 26, 16, 32), (52, 52, 32, 16), (26, 52, 16, 16),
    (26, 26, 3, 16), (52, 52, 1, 32), (52, 26, 2, 16)])
def test_tile_stem_matches_plain(h, wd, cin, cout):
    """Partial 8x8 pooled tiles (13 and 26 pooled pixels a side): every
    pooled pixel and channel written once by its lane, equal to
    stem_pair_plain bit for bit."""
    x, w, bias = grid_case(h * wd + cin + cout, h, wd, cin, cout)
    got = model_stem(x, w, bias)
    ref = TBS.stem_pair_plain(x, w, bias)
    assert torch.equal(got, ref), (got != ref).sum().item()
    assert (ref.float() < 0).any() and (ref.float() > 0).any()


@pytest.fixture
def interpret_b1():
    JBS._INTERPRET = True
    yield
    JBS._INTERPRET = False


@pytest.mark.parametrize("cin,cout", [(16, 32), (3, 16)])
def test_tile_stem_matches_jax_pallas(interpret_b1, cin, cout):
    """The tile's emulation against the JAX package's _pair_kernel in
    interpret mode at 32x32 (partial tiles at 16 pooled pixels: none;
    the halo's zero border on every side), within one bf16 ulp."""
    h = 32
    x, w, bias = grid_case(11 + cin, h, h, cin, cout)
    ref = JBS.from_flat(
        JBS._run_pair(JBS.to_flat(jnp.asarray(x.float().numpy(),
                                              jnp.bfloat16), h),
                      JBS.pack_weights(jnp.asarray(w.float().numpy(),
                                                   jnp.bfloat16)),
                      jnp.asarray(bias.numpy()).reshape(-1, 1), H=h, W=h,
                      Cin=cin, Cout=cout), h // 2, h // 2)
    got = model_stem(x, w, bias).float().numpy()
    ref = np.asarray(ref, np.float32)
    assert np.abs(ref).max() > 0.1
    assert_bf16_close(got, ref)
