"""The folded operands of bwdg's tensor-core kernel, on the CPU.

``bwdg_tc_kernel`` (csrc/phase_train.cu) computes bwdg's reductions as one
GEMM per work item, an (image, 8x8 pooled tile) with 16x16 = 256
full-resolution positions: acc [32 x (32 + Cout)] += X'^T [X' | Dz], where

* X' [256 x 32] holds a position's 3x3 taps in HWIO order (column
  t*Cin + ci), 1 in column 9*Cin for a position inside the image, and 0
  elsewhere; a position outside the image is a zero row;
* Dz [256 x Cout] holds dzs of the position's pooled pixel where the
  argmax selects the position's pool variant 2*(fy % 2) + (fx % 2), else 0;

so that G = acc[:9Cin, :9Cin], D = acc[9Cin, :9Cin], A = acc[:9Cin, 32:]
and S[0] = acc[9Cin, 32:]. This test builds X' and Dz per tile as the
kernel lays them out (row = fy*16 + fx), sums the products in float64 and
holds the slices to ``bwdg_plain``. The inputs lie on grids (x in quarters,
dp in eighths) where every float32 sum of ``bwdg_plain`` is exact, so the
two agree to rounding of the float64 sum alone.
"""

import numpy as np
import pytest
import torch

import sr_object_detection_tpu_torch.kernels.phase_train as TPT
from sr_object_detection_tpu_torch.ops.activations import LEAKY_BF16

TILE = 16          # full-resolution positions along a tile's edge


def _case(seed, b, h, cin, cout):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(0, 4, (b, h, h, cin)) / 4.0).to(
        torch.bfloat16)
    w = torch.from_numpy(rng.normal(0, 0.3, (3, 3, cin, cout))).to(
        torch.bfloat16)
    scales = rng.uniform(0.6, 1.4, cout).astype(np.float32)
    scales[1] = -0.8
    shift = torch.from_numpy(rng.normal(0, 0.1, cout).astype(np.float32))
    scales = torch.from_numpy(scales)
    biases = torch.from_numpy(rng.normal(0, 0.2, cout).astype(np.float32))
    dp = torch.from_numpy(rng.integers(-8, 9, (b, h // 2, h // 2, cout))
                          / 8.0).to(torch.bfloat16)
    z, am, st = TPT.fwdstats_plain(x, w, shift, scales)
    mean, _, inv = TPT._batch_stats(st, shift, b * h * h)
    return x, dp, z, am, mean, inv, scales, biases


def fold(x, dp, z, am, mean, inv, scales, biases):
    """acc = sum over the tiles of X'^T [X' | Dz], float64 (32, 32+Cout)."""
    b, h, w, cin = x.shape
    cout = z.shape[-1]
    n9 = 9 * cin
    hp, wp = -(-h // TILE) * TILE, -(-w // TILE) * TILE
    xpad = torch.zeros((b, hp + 2, wp + 2, cin), dtype=torch.float64)
    xpad[:, 1:h + 1, 1:w + 1] = x.double()
    # X' at every position of the padded tiles: taps, ones, zeros
    taps = torch.stack([xpad[:, ky:ky + hp, kx:kx + wp]
                        for ky in range(3) for kx in range(3)], dim=3)
    xf = torch.zeros((b, hp, wp, 32), dtype=torch.float64)
    xf[..., :n9] = taps.reshape(b, hp, wp, n9)
    xf[..., n9] = 1.0
    inside = ((torch.arange(hp) < h)[:, None]
              & (torch.arange(wp) < w)[None, :])
    xf *= inside[None, :, :, None]
    # dzs as the kernel (and bwdg_plain) forms it, routed to its variant
    xhat = (z.float() - mean) * inv
    zb = (xhat * scales).to(torch.bfloat16) + biases.to(torch.bfloat16)
    g = dp.float()
    dzs = torch.where(zb > 0, g, (g * LEAKY_BF16).to(torch.bfloat16).float())
    df = torch.zeros((b, hp, wp, cout), dtype=torch.float64)
    for v in range(4):
        df[:, v // 2:h:2, v % 2:w:2] = torch.where(am.long() == v, dzs,
                                                   0.0).double()
    # rows of one tile: position fy*16 + fx
    def tiles(t):
        c = t.shape[-1]
        return t.reshape(b, hp // TILE, TILE, wp // TILE, TILE, c).permute(
            0, 1, 3, 2, 4, 5).reshape(-1, TILE * TILE, c)
    xt, dt = tiles(xf), tiles(df)
    return torch.einsum("tpm,tpn->mn", xt, torch.cat([xt, dt], dim=2))


@pytest.mark.parametrize("b,h,cin,cout", [
    (1, 32, 3, 16), (1, 22, 3, 16), (1, 32, 1, 16), (1, 22, 3, 32),
    (2, 16, 2, 32)])
def test_bwdg_fold_reproduces_plain(b, h, cin, cout):
    """The fold's slices equal bwdg_plain's S[0], A, D and G at 1e-9 of
    their largest magnitude, with whole tiles and (22x22) partial ones."""
    args = _case(10 * h + cin + cout, b, h, cin, cout)
    acc = fold(*args)
    s, a, d, g = TPT.bwdg_plain(*args)
    n9 = 9 * cin
    got = {"S0": acc[n9, 32:], "A": acc[:n9, 32:], "D": acc[n9, :n9],
           "G": acc[:n9, :n9]}
    want = {"S0": s[0], "A": a, "D": d, "G": g}
    for name in got:
        ref = want[name].double()
        err = (got[name] - ref).abs().max().item()
        assert err <= 1e-9 * ref.abs().max().item(), (name, err)
    # columns past the ones column are zero: they add nothing
    assert not acc[n9 + 1:].any() and not acc[:, n9 + 1:32].any()
