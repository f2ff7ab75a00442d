"""The tensor-core conv tile of fwdstats, red and dy, on the CPU.

``conv_tc_body`` (csrc/phase_train.cu) computes the 3x3 conv of a work
item, an (image, 8x8 pooled tile, group of NC output channels), as one
GEMM on mma.sync m16n8k16 and pools it in registers:

* K = 9 taps x Cin in k16 steps (16-channel chunk, tap): chunks outer,
  taps in row-major order, the same order in every mode;
* M = the tile's 16x16 full-resolution positions: warp w's m16 tile mt
  holds rows 0-7 at full-resolution row 2w and rows 8-15 at row 2w + 1,
  columns 8 mt .. + 7. Lane l = 4g + q of the warp holds accumulator
  entries (row g, columns 2q, 2q + 1) and (row g + 8, same columns): the
  vertical pair of a pool window for two channels. ``__shfl_xor(., 4)``
  swaps with the lane of the horizontal neighbour, after which the lane
  of the even column owns the window of channel 2q and the odd one that
  of channel 2q + 1;
* dy's weight gradient: dw[(tap, ci)][co] += X_tap^T dy over the tile's
  positions (K = the 256 positions, a k16 step per full-resolution row),
  warp w owning the (tap, n8 tile) accumulators w, w + 8, ... < 9 NC / 8.

This test builds those index maps as the kernel does, runs the
arithmetic in float64 on inputs of an exact grid (x in eighths, w in
sixteenths: every float32 conv sum is exact), and holds the outcome to
``fwdstats_plain`` and ``dy_plain`` (Z, argmax, statistics, dy, dw) and,
at one small shape, to the JAX package's ``_train_kernel`` in modes
"fwdstats" and "dy" in interpret mode. tests/test_torch_cuda.py holds the
CUDA kernels to the same plain versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sr_object_detection_tpu.kernels.phase_train as JPT
import sr_object_detection_tpu_torch.kernels.phase_train as TPT
from sr_object_detection_tpu_torch.ops.activations import LEAKY_BF16
from torch_parity import assert_bf16_close

PT, FULL, HALO = 8, 16, 18       # pooled tile, full-resolution tile, halo


def _case(seed, b, h, cin, cout):
    rng = np.random.default_rng(seed)
    bf = torch.bfloat16
    x = torch.from_numpy(np.round(rng.uniform(0, 1, (b, h, h, cin)) * 8)
                         / 8).to(bf)
    w = torch.from_numpy(np.round(rng.normal(0, 0.3, (3, 3, cin, cout))
                                  * 16) / 16).to(bf)
    scales = rng.uniform(0.6, 1.4, cout).astype(np.float32)
    scales[1] = -0.8
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    t = {"x": x, "w": w, "scales": f(scales),
         "shift": f(rng.normal(0, 0.1, cout)),
         "biases": f(rng.normal(0, 0.2, cout)),
         "dp": torch.from_numpy(rng.normal(0, 1, (b, h // 2, h // 2, cout))
                                ).to(bf),
         "c1": f(rng.uniform(0.5, 1.5, cout)),
         "c2": f(rng.normal(0, 1e-3, cout)), "c3": f(rng.normal(0, 1e-3, cout))}
    _, _, st = TPT.fwdstats_plain(x, w, torch.zeros(cout), t["scales"])
    t["mean"], _, t["inv"] = TPT._batch_stats(st, torch.zeros(cout),
                                              b * h * h)
    return t


def k_steps(cin):
    """The kernel's k16 steps: (chunk, tap), chunks outer, taps inner."""
    return [(ch, t) for ch in range(cin // 16) for t in range(9)]


def m_positions():
    """(fy, fx) of GEMM row m = 32 w + 16 mt + r: row 2w + r // 8, column
    8 mt + r % 8."""
    m = np.arange(256)
    w, mt, r = m // 32, (m // 16) % 2, m % 16
    return 2 * w + r // 8, 8 * mt + r % 8


def halos(x):
    """x (B,H,W,Cin) -> float64 halos (B, ty, tx, 18, 18, Cin) of the
    8x8 pooled tiles, zero outside the image."""
    b, h, w, cin = x.shape
    ty, tx = -(-(h // 2) // PT), -(-(w // 2) // PT)
    pad = torch.zeros((b, FULL * ty + 2, FULL * tx + 2, cin),
                      dtype=torch.float64)
    pad[:, 1:h + 1, 1:w + 1] = x.double()
    return torch.stack([torch.stack([
        pad[:, FULL * i:FULL * i + HALO, FULL * j:FULL * j + HALO]
        for j in range(tx)], 1) for i in range(ty)], 1)


def conv_tiles(x, w):
    """The conv of every tile as the kernel's GEMM: (B, ty, tx, 256 rows
    in M order, Cout) float64, summed over the k16 steps in order."""
    cin = x.shape[3]
    hal = halos(x)
    fy, fx = m_positions()
    acc = 0
    seen = set()
    for ch, t in k_steps(cin):
        ky, kx = divmod(t, 3)
        a = hal[:, :, :, fy + ky, fx + kx, 16 * ch:16 * ch + 16]
        acc = acc + a @ w[ky, kx, 16 * ch:16 * ch + 16].double()
        seen.update((t, ci) for ci in range(16 * ch, 16 * ch + 16))
    assert seen == {(t, ci) for t in range(9) for ci in range(cin)}
    return acc


def gather_windows(y, cout):
    """The lanes' windows after the shuffle: for every (warp, mt, nt,
    lane) its channel, pooled pixel (py, px) in the tile and the four
    window values in row-major order, from the accumulator fragments of
    y (B, ty, tx, 256, Cout). Returns a dict of index arrays and the
    values (B, ty, tx, n) x 4."""
    warps, mts, nts, lanes = np.meshgrid(np.arange(8), np.arange(2),
                                         np.arange(cout // 8),
                                         np.arange(32), indexing="ij")
    warps, mts, nts, lanes = (a.ravel() for a in (warps, mts, nts, lanes))

    def frag(lane, e):
        """accumulator entry e of lane `lane`: (row in M order, column)."""
        g, q = lane // 4, lane % 4
        row = 32 * warps + 16 * mts + g + 8 * (e // 2)
        return row, 8 * nts + 2 * q + e % 2

    def val(lane, e):
        row, col = frag(lane, e)
        return y[..., row, col]

    g = lanes // 4
    even = g % 2 == 0
    partner = lanes ^ 4
    ev = torch.from_numpy(even)
    own = [val(lanes, e) for e in range(4)]
    # the partner sends entry 1 (3) if it is even, 0 (2) if odd
    ra = torch.where(torch.from_numpy(~even), val(partner, 1),
                     val(partner, 0))
    rb = torch.where(torch.from_numpy(~even), val(partner, 3),
                     val(partner, 2))
    v = torch.stack([torch.where(ev, own[0], ra), torch.where(ev, ra, own[1]),
                     torch.where(ev, own[2], rb), torch.where(ev, rb, own[3])],
                    -1)
    idx = {"c": 8 * nts + 2 * (lanes % 4) + g % 2, "py": warps,
           "px": 4 * mts + g // 2}
    # the same gather on the positions: window tap k (row-major) comes
    # from the lane whose column parity is k % 2, entry 2 (k // 2) + the
    # channel's parity; it sits at (2 py + k // 2, 2 px + k % 2)
    fy, fx = m_positions()
    for k in range(4):
        src = np.where(even == (k % 2 == 0), lanes, partner)
        row, col = frag(src, 2 * (k // 2) + (~even).astype(int))
        assert (fy[row] == 2 * idx["py"] + k // 2).all()
        assert (fx[row] == 2 * idx["px"] + k % 2).all()
        assert (col == idx["c"]).all()
    return idx, v


def scatter(vals, idx, b, h2, w2, cout):
    """Per-window values (B, ty, tx, n) -> (B, H/2, W/2, Cout): the
    windows inside the image."""
    _, ty, tx, _ = vals.shape
    oy = (torch.arange(ty)[:, None] * PT + torch.from_numpy(idx["py"]))
    ox = (torch.arange(tx)[:, None] * PT + torch.from_numpy(idx["px"]))
    out = torch.zeros((b, ty * PT, tx * PT, cout), dtype=vals.dtype)
    c = torch.from_numpy(idx["c"])
    for i in range(ty):
        for j in range(tx):
            out[:, oy[i], ox[j], c] = vals[:, i, j]
    return out[:, :h2, :w2]


def model_fwdstats(x, w, shift, scales):
    b, h, wd, _ = x.shape
    cout = w.shape[3]
    y = conv_tiles(x, w).float().to(torch.bfloat16).double()
    idx, v = gather_windows(y, cout)
    c = torch.from_numpy(idx["c"])
    up = scales[c] > 0
    z = torch.where(up, v.amax(-1), v.amin(-1))
    am = (v == z[..., None]).double().argmax(-1).double()
    d = v - shift.double()[c][..., None]
    z = scatter(z, idx, b, h // 2, wd // 2, cout)
    am = scatter(am, idx, b, h // 2, wd // 2, cout)
    s0 = scatter(d.sum(-1), idx, b, h // 2, wd // 2, cout)
    s1 = scatter((d * d).sum(-1), idx, b, h // 2, wd // 2, cout)
    return (z.float().to(torch.bfloat16), am.to(torch.int8),
            torch.stack([s0.sum(dim=(0, 1, 2)), s1.sum(dim=(0, 1, 2))]))


def model_dy(x, w, dp, mean, inv, scales, biases, c1, c2, c3):
    """dy and dw through the tile: the routing of the windows gathered
    from the lanes, dy placed in the tile at the window's positions, and
    dw as the positions-as-K GEMM with the warps' tile ownership."""
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    nt_ = cout // 8
    y = conv_tiles(x, w).float().to(torch.bfloat16).float()
    idx, v = gather_windows(y, cout)
    ty, tx = y.shape[1], y.shape[2]
    c = torch.from_numpy(idx["c"])
    # the window's expressions (chain_bwd_kernel's, as _routed)
    xm = v - mean[c][..., None]
    xh = xm * inv[c][..., None]
    zb = ((xh * scales[c][..., None]).to(torch.bfloat16)
          + biases.to(torch.bfloat16)[c][..., None])
    pos = zb > 0
    a = torch.where(pos, zb, zb * LEAKY_BF16).float()
    first = (a == a.amax(-1, keepdim=True)).float().argmax(-1)
    oy = torch.arange(ty)[:, None] * PT + torch.from_numpy(idx["py"])
    ox = torch.arange(tx)[:, None] * PT + torch.from_numpy(idx["px"])
    valid = ((oy < h // 2)[:, None, :] & (ox < wd // 2)[None, :, :])
    dpad = torch.zeros((b, ty * PT, tx * PT, cout))
    dpad[:, :h // 2, :wd // 2] = dp.float()
    gct = torch.stack([torch.stack([dpad[:, oy[i], ox[j], c]
                                    for j in range(tx)], 1)
                       for i in range(ty)], 1)
    neg = (gct * LEAKY_BF16).to(torch.bfloat16).float()
    sel = torch.nn.functional.one_hot(first, 4).bool()
    dz = torch.where(sel, torch.where(pos, gct[..., None], neg[..., None]),
                     0.0)
    dyv = (dz * c1[c][..., None] + xm * c2[c][..., None]
           + c3[c][..., None]).to(torch.bfloat16)
    dyv = torch.where(valid[None, ..., None], dyv.float(), 0.0)
    # the tile's dy at position p = (2 py + k // 2) * 16 + 2 px + k % 2
    tile = torch.zeros((b, ty, tx, 256, cout))
    for k in range(4):
        p = (2 * idx["py"] + k // 2) * FULL + 2 * idx["px"] + k % 2
        tile[..., p, idx["c"]] = dyv[..., k]
    full = tile.reshape(b, ty, tx, FULL, FULL, cout).permute(
        0, 1, 3, 2, 4, 5).reshape(b, FULL * ty, FULL * tx, cout)
    # dw: warp w owns (tap, n8) tiles i = w + 8 j < 9 NT: tap i // NT,
    # n8 tile i % NT (= w % NT)
    owned = {}
    for wi in range(8):
        for j in range(5):
            i = wi + 8 * j
            if i < 9 * nt_:
                assert i % nt_ == wi % nt_
                owned[(i // nt_, i % nt_)] = wi
    assert set(owned) == {(t, n) for t in range(9) for n in range(nt_)}
    hal = halos(x)
    dw = torch.zeros((9, cin, cout), dtype=torch.float64)
    for (t, n), _ in sorted(owned.items()):
        ky, kx = divmod(t, 3)
        for ks in range(FULL):                  # a k16 step per row
            a = hal[:, :, :, ks + ky, kx:kx + FULL]          # (.., 16, ci)
            bm = tile[..., ks * FULL:(ks + 1) * FULL, 8 * n:8 * n + 8]
            dw[t, :, 8 * n:8 * n + 8] += torch.einsum(
                "bijpc,bijpo->co", a, bm.double())
    return full[:, :h, :wd].to(torch.bfloat16), dw.reshape(3, 3, cin, cout)


@pytest.mark.parametrize("b,h,cin,cout", [
    (2, 22, 16, 32), (2, 40, 16, 16), (2, 22, 32, 32), (1, 40, 32, 48)])
def test_tile_fwdstats_matches_plain(b, h, cin, cout):
    """The tile's k16 steps, M order and lane-pair window gather give
    fwdstats_plain's Z and argmax bit for bit and its sums at 1e-6, with
    partial 8x8 pooled tiles (22x22, 40x40)."""
    t = _case(b * h + cin + cout, b, h, cin, cout)
    z, am, st = model_fwdstats(t["x"], t["w"], t["shift"], t["scales"])
    zp, amp, stp = TPT.fwdstats_plain(t["x"], t["w"], t["shift"],
                                      t["scales"])
    assert torch.equal(z, zp)
    assert torch.equal(am, amp)
    err = (st - stp.double()).abs().max() / stp.abs().max()
    assert err <= 1e-6, err


@pytest.mark.parametrize("b,h,cout", [(2, 22, 32), (2, 40, 32), (2, 40, 16)])
def test_tile_dy_matches_plain(b, h, cout):
    """dy through the tile (the window's routing on the gathered lanes,
    dy placed at the window's positions) bit for bit, and dw as the
    positions-as-K fold with the warps' ownership at 1e-6 of dy_plain's,
    Cin 16 (the chain's pair 1: dy runs on the tile at Cin 16)."""
    t = _case(3 * h + cout, b, h, 16, cout)
    args = [t[k] for k in ("x", "w", "dp", "mean", "inv", "scales",
                           "biases", "c1", "c2", "c3")]
    dy, dw = model_dy(*args)
    dyp, dwp = TPT.dy_plain(*args)
    assert torch.equal(dy, dyp)
    err = (dw - dwp.double()).abs().max() / dwp.abs().max()
    assert err <= 1e-6, err


def test_tile_matches_jax_pallas(monkeypatch):
    """At (128, 16, 16, 16 -> 32) the tile's statistics, dy and dw against
    the JAX _train_kernel's modes "fwdstats" and "dy" (with its weight
    gradient) in interpret mode, at the gates of
    tests/test_torch_phase_chain.py (rel 2e-2; dy within one bf16 ulp
    with the same routing pattern)."""
    monkeypatch.setattr(JPT, "_INTERPRET", True)
    b, h, cin, cout = 128, 16, 16, 32
    t = _case(9, b, h, cin, cout)
    x, w = t["x"].float().numpy(), t["w"].float().numpy()
    g = JPT.plan_pair(h, h, cin, cout, P=2)
    xp = JPT.to_phase_np(jnp.asarray(x, jnp.bfloat16), g.P)
    halo = JPT.halo_rows(xp, g.H, g.C, g.RP, g.NB)
    wpk = JPT._pack_w(jnp.asarray(w, jnp.float32), g)
    bias_b = jnp.asarray(t["biases"].numpy()).astype(
        jnp.bfloat16).reshape(-1, 1)
    sh, sc = (jnp.asarray(t[k].numpy()) for k in ("shift", "scales"))
    _, s = JPT._run("fwdstats", g, xp, halo, wpk,
                    JPT._consts(sh, sh, sh, sc), bias_b)
    s = np.asarray(s, np.float64)
    s_j = np.stack([s[:cout].sum(1), s[cout:].sum(1)])
    _, _, st = model_fwdstats(t["x"], t["w"], t["shift"], t["scales"])
    assert np.abs(st.numpy() - s_j).max() / np.abs(s_j).max() < 2e-2
    m, iv = (jnp.asarray(t[k].numpy()) for k in ("mean", "inv"))
    kc7 = JPT._consts(m, m, iv, sc, *(jnp.asarray(t[k].numpy())
                                      for k in ("c1", "c2", "c3")))
    dpp = JPT.to_phase_np(jnp.asarray(t["dp"].float().numpy(),
                                      jnp.bfloat16), 1)
    dy3, raw = JPT._run("dy", g, xp, halo, wpk, kc7, bias_b, dp=dpp,
                        with_wgrad=True)
    dy_j = np.transpose(np.asarray(dy3, np.float32).reshape(
        2, h, cout, h // 2, 128), (4, 1, 3, 0, 2)).reshape(b, h, h, cout)
    dw_j = np.asarray(JPT._unpack_dw_direct(raw, g))
    dy, dw = model_dy(*(t[k] for k in ("x", "w", "dp", "mean", "inv",
                                       "scales", "biases", "c1", "c2",
                                       "c3")))
    dy = dy.float().numpy()
    assert_bf16_close(dy, dy_j)
    np.testing.assert_array_equal(dy != 0, dy_j != 0)
    assert np.abs(dw.numpy() - dw_j).max() / np.abs(dw_j).max() < 2e-2
