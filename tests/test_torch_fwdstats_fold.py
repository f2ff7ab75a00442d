"""The taps fold of fwdstats' tensor-core tile, on the CPU.

``fwdstats_fold_kernel<CIN, NC>`` (csrc/phase_train.cu) runs fwdstats at
Cin <= 3 (the leading pair, whose input is the image) on the conv tile
of ``conv_tc_body`` with another A operand. Per work item, an (image,
8x8 pooled tile, group of NC output channels):

* the ring holds, for each of the 18 halo rows, the aligned 16-byte
  units that cover the row's 18 pixels (cp.async; zero-filled before x,
  past its end and for rows outside the image), the row's first pixel at
  byte ``a & 15`` of its 128-byte slot row, ``a`` the pixel's byte in x;
* X' [256 positions x 32] bf16: row p = position (p // 16, p % 16) of the
  16x16 tile, column t * Cin + ci the value of tap t = 3 ky + kx of
  channel ci (0 outside the image), columns 9 Cin..31 zero. A thread
  builds its row from the three tap rows' 3 Cin contiguous values, read
  as 4-byte words and funnel-shifted where their byte is 2 mod 4, masked
  word by word where a tap's column lies outside the image; 16-byte
  units XOR-swizzled by the row;
* A fragments by ldmatrix.x4 from X' in the tile's m16 order (warp w,
  m16 tile mt: rows 0-7 at full-resolution row 2w, 8-15 at 2w + 1,
  columns 8 mt .. + 7), B fragments by ldmatrix.x4.trans from the
  weights [32 rows t * Cin + ci, zero past 9 Cin][NC], two k16 steps;
* the tile's epilogue: y = bf16(sum), the lane-pair window gather, the
  float64 statistics, and the extreme and first tap of a channel's two
  windows (mt 0, mt 1) at once as bf16x2 (the minimum as the maximum of
  the sign-flipped values), the even lane storing mt 0's pixel and the
  odd one mt 1's.

This test builds those maps as the kernel does, byte by byte where the
kernel moves bytes: with unique tags in place of x it shows every
(position, tap, ci) read once, from the right pixel, at Cin 1, 2 and 3
and at shapes with partial 8x8 pooled tiles, and every ldmatrix phase on
eight distinct bank groups; on inputs of an exact grid (every float32
conv sum exact) its float64 arithmetic gives fwdstats_plain's Z and
argmax bit for bit and its statistics at 1e-6, and at one small shape
the JAX package's ``_train_kernel`` in mode "fwdstats" in interpret mode.
At yolov2-608's training pair (B=128, 3 -> 32 at 608, pooled 304, and the
152 case, pooled 76 with partial tiles) it counts the work items, the
valid windows of every tile and every offset the fold and bwdg's
tensor-core kernel form, in int64 against the same offsets in int32.
tests/test_torch_cuda.py holds the CUDA kernel to fwdstats_plain on the
card, and the library's path predicate to :func:`conv_path`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sr_object_detection_tpu.kernels.phase_train as JPT
import sr_object_detection_tpu_torch.kernels.phase_train as TPT
from test_torch_conv_tile import _case, gather_windows, m_positions
from torch_parity import assert_bf16_close

PT, FULL, HALO = 8, 16, 18       # pooled tile, full-resolution tile, halo
ROW = 128                        # bytes of a staged halo row (FD_ROW)


def tiles_of(b, h, w):
    """(image, first halo row, first halo column) of every work item."""
    ty, tx = -(-(h // 2) // PT), -(-(w // 2) // PT)
    return [(i, FULL * r - 1, FULL * c - 1)
            for i in range(b) for r in range(ty) for c in range(tx)]


def stage_spans(xb, b, gy0, gx0, h, w, cin):
    """The ring slot of one item as the cp.async loader fills it: (18,
    128) bytes, and each row's byte offset. ``xb``: x's bytes."""
    nu = (36 * cin + 29) // 16                 # units covering a row
    slot = np.zeros((HALO, ROW), np.uint8)
    offs = []
    for hr in range(HALO):
        gy = gy0 + hr
        a = 2 * cin * ((b * h + gy) * w + gx0)
        offs.append(a & 15)
        for u in range(nu):
            rel = (a & ~15) + 16 * u
            n = (0 if gy < 0 or gy >= h or rel < 0 or rel >= len(xb)
                 else min(16, len(xb) - rel))
            slot[hr, 16 * u:16 * u + n] = xb[rel:rel + n]
    return slot, offs


def build_xprime(slot, offs, gx0, w, cin):
    """X' (256, 32) uint16 as fold_xprime builds it from a staged slot:
    4-byte words, the funnel shift, the word masks, the packing."""
    n = 3 * cin
    nv = (n + 1) // 2
    words = slot.reshape(-1).view("<u4")
    xp = np.zeros((256, 32), np.uint16)
    for p in range(256):
        fy, fx = divmod(p, 16)

        def inside(j):
            return j < n and 0 <= gx0 + fx + j // cin < w
        mk = [(0xFFFF if inside(2 * k) else 0)
              | (0xFFFF0000 if inside(2 * k + 1) else 0) for k in range(nv)]
        vals = []
        for ky in range(3):
            off = (fy + ky) * ROW + offs[fy + ky] + 2 * cin * fx
            wd = [int(words[(off & ~3) // 4 + k]) for k in range(nv + 1)]
            sh = 8 * (off & 2)
            v = [(((wd[k + 1] << 32) | wd[k]) >> sh) & 0xFFFFFFFF & mk[k]
                 for k in range(nv)]
            vals += [(v[j // 2] >> (16 * (j & 1))) & 0xFFFF
                     for j in range(n)]
        xp[p, :3 * n] = vals
    return xp


def swz4(r, u):
    """Byte of 16-byte unit u of X' row r (swzu<4>)."""
    return r * 64 + ((u ^ ((r >> 1) & 3)) << 4)


def swz_w(r, u, nt):
    """Byte of 16-byte unit u of weight row r (swzu<NT>, NT = NC / 8)."""
    sh = 2 if nt == 2 else 1
    return r * 16 * nt + ((u ^ ((r >> sh) & (nt - 1))) << 4)


def bank_groups_distinct(addrs):
    return len({(a // 16) % 8 for a in addrs}) == len(addrs)


def a_fragments(xbuf):
    """A (16x16) of every (warp, mt, k16 step) from X' bytes through the
    kernel's ldmatrix.x4 addresses: lane l addresses row p = (2w +
    (l // 8) % 2) * 16 + 8 mt + l % 8, unit 2 ks + l // 16; lane t gets
    (row t // 4, elements 2 (t % 4), + 1) of matrix j in register j; the
    mma's A fragment reads registers 0-3 as rows g / g + 8 x k 0-7 /
    8-15. Returns {(w, mt, ks): (16, 16) uint16}."""
    out = {}
    for wv in range(8):
        for mt in range(2):
            for ks in range(2):
                addr = [swz4((2 * wv + (l >> 3) % 2) * 16 + 8 * mt + l % 8,
                             2 * ks + l // 16) for l in range(32)]
                for j in range(4):
                    assert bank_groups_distinct(addr[8 * j:8 * j + 8])
                mats = [np.stack([xbuf[a:a + 16].view("<u2")
                                  for a in addr[8 * j:8 * j + 8]])
                        for j in range(4)]
                a = np.zeros((16, 16), np.uint16)
                for lane in range(32):
                    g, q = lane // 4, lane % 4
                    for j, (r0, k0) in enumerate(((0, 0), (8, 0), (0, 8),
                                                  (8, 8))):
                        a[g + r0, k0 + 2 * q:k0 + 2 * q + 2] = \
                            mats[j][g, 2 * q:2 * q + 2]
                out[(wv, mt, ks)] = a
    return out


def b_fragments(wbuf, nc):
    """B (16 x NC) of each k16 step from the weights' bytes through the
    kernel's ldmatrix.x4.trans addresses: lane l addresses row l % 8 + 8
    ((l // 8) % 2) of the step, unit 2 pr + l // 16; lane t gets (rows 2
    (t % 4), + 1; column t // 4) of matrix j; n8 tile nt reads pair nt //
    2, registers 2 (nt % 2) and + 1 (k 0-7, 8-15)."""
    nt_n = nc // 8
    out = []
    for ks in range(2):
        bmat = np.zeros((16, nc), np.uint16)
        for pr in range(nt_n // 2):
            addr = [ks * 16 * nt_n * 16 + swz_w((l & 7) + 8 * ((l >> 3) & 1),
                                                2 * pr + (l >> 4), nt_n)
                    for l in range(32)]
            for j in range(4):
                assert bank_groups_distinct(addr[8 * j:8 * j + 8])
            mats = [np.stack([wbuf[a:a + 16].view("<u2")
                              for a in addr[8 * j:8 * j + 8]])
                    for j in range(4)]
            for j in range(4):
                # matrix j: k rows 8 (j % 2) .., n columns 8 (2 pr + j // 2)
                kb, nb = 8 * (j % 2), 8 * (2 * pr + j // 2)
                for t in range(32):
                    g, q = t // 4, t % 4
                    bmat[kb + 2 * q:kb + 2 * q + 2, nb + g] = \
                        mats[j][2 * q:2 * q + 2, g]
        out.append(bmat)
    return out


def stage_weights(w_bits, cin, co0, nc):
    """The group's weight rows in shared memory as the kernel copies
    them: row r = t * Cin + ci (w_bits (9 Cin, Cout)), rows 9 Cin..31
    zero, 16-byte units swizzled."""
    nt_n = nc // 8
    buf = np.zeros(32 * nc * 2, np.uint8)
    for r in range(32):
        for u in range(nt_n):
            src = (w_bits[r, co0 + 8 * u:co0 + 8 * u + 8] if r < 9 * cin
                   else np.zeros(8, np.uint16))
            a = swz_w(r, u, nt_n)
            buf[a:a + 16] = src.astype("<u2").view(np.uint8)
    return buf


def fold_items(x_bits, w_bits, cout):
    """Every item's A fragments and every group's B fragments, as the
    kernel assembles them from x's and w's bf16 bits (uint16 arrays).
    Yields (image, gy0, gx0, {(w, mt, ks): A}, [B of the group, ...])."""
    b, h, w, cin = x_bits.shape
    nc = 32 if cout % 32 == 0 else 16
    xb = x_bits.astype("<u2").reshape(-1).view(np.uint8)
    bfr = [b_fragments(stage_weights(w_bits, cin, co0, nc), nc)
           for co0 in range(0, cout, nc)]
    for img, gy0, gx0 in tiles_of(b, h, w):
        slot, offs = stage_spans(xb, img, gy0, gx0, h, w, cin)
        xp = build_xprime(slot, offs, gx0, w, cin)
        xbuf = np.zeros(256 * 64, np.uint8)
        for p in range(256):
            for u in range(4):
                xbuf[swz4(p, u):swz4(p, u) + 16] = \
                    xp[p, 8 * u:8 * u + 8].astype("<u2").view(np.uint8)
        yield img, gy0, gx0, a_fragments(xbuf), bfr


def bits(t):
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def from_bits(a):
    return torch.from_numpy(a.astype(np.uint16).view(np.int16)).view(
        torch.bfloat16).double()


@pytest.mark.parametrize("b,h,w,cin,cout", [
    (1, 16, 16, 3, 16), (3, 22, 22, 3, 16), (1, 36, 22, 1, 32),
    (2, 22, 40, 2, 48), (1, 40, 36, 3, 32)])
def test_fold_reads_every_tap_once(b, h, w, cin, cout):
    """With a unique tag for every element of x (and of w), every X' row
    of every item holds, in column t * Cin + ci, the tag of x at the
    position's tap t and channel ci (0 outside the image) and zeros past
    9 Cin, so the fragments of the two k16 steps pair each (position,
    tap, ci) once with weight row t * Cin + ci; every ldmatrix phase hits
    eight distinct bank groups. Partial 8x8 pooled tiles (H/2, W/2 of 11,
    18 and 20), H != W, B = 3, Cout 48 (three groups of 16)."""
    xt = (np.arange(b * h * w * cin) % 65535 + 1).astype(np.uint16).reshape(
        b, h, w, cin)
    wt = (np.arange(9 * cin * cout) + 1).astype(np.uint16).reshape(
        9 * cin, cout)
    nc = 32 if cout % 32 == 0 else 16
    fy, fx = m_positions()                 # GEMM row -> tile position
    xpad = np.zeros((b, h + 34, w + 34, cin), np.uint16)
    xpad[:, 1:h + 1, 1:w + 1] = xt
    seen = 0
    for img, gy0, gx0, afr, bfr in fold_items(xt, wt, cout):
        for (wv, mt, ks), a in afr.items():
            rows = np.arange(32 * wv + 16 * mt, 32 * wv + 16 * mt + 16)
            for r, m in enumerate(rows):
                want = np.zeros(16, np.uint16)
                for k in range(16):
                    col = 16 * ks + k
                    if col < 9 * cin:
                        t, ci = divmod(col, cin)
                        want[k] = xpad[img, gy0 + 1 + fy[m] + t // 3,
                                       gx0 + 1 + fx[m] + t % 3, ci]
                np.testing.assert_array_equal(a[r], want)
                seen += 1
        for g, group in enumerate(bfr):
            for ks, bmat in enumerate(group):
                rows = np.arange(16 * ks, 16 * ks + 16)
                want = np.where((rows < 9 * cin)[:, None],
                                wt[np.minimum(rows, 9 * cin - 1),
                                   g * nc:(g + 1) * nc], 0)
                np.testing.assert_array_equal(bmat, want)
    assert seen == len(tiles_of(b, h, w)) * 256 * 2


def model_fold(x, w, shift, scales):
    """fwdstats through the fold: the fragments' GEMM in float64, y =
    bf16(sum), the lane-pair window gather, the float64 statistics, and
    Z and the first tap of a channel's two windows at once with the
    bf16x2 sign flip and the kernel's store pairing."""
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    nc = 32 if cout % 32 == 0 else 16
    ty, tx = -(-(h // 2) // PT), -(-(wd // 2) // PT)
    xb, wb = bits(x), bits(w).reshape(9 * cin, cout)
    y = torch.zeros((b, ty, tx, 256, cout), dtype=torch.float64)
    for img, gy0, gx0, afr, bfr in fold_items(xb, wb, cout):
        i, j = (gy0 + 1) // FULL, (gx0 + 1) // FULL
        for (wv, mt, ks), a in afr.items():
            rows = slice(32 * wv + 16 * mt, 32 * wv + 16 * mt + 16)
            for g, group in enumerate(bfr):
                y[img, i, j, rows, g * nc:(g + 1) * nc] += (
                    from_bits(a) @ from_bits(group[ks]))
    y = y.float().to(torch.bfloat16).double()
    idx, v = gather_windows(y, cout)       # (B, ty, tx, n, 4), row-major
    c = torch.from_numpy(idx["c"])
    oy = torch.arange(ty)[:, None] * PT + torch.from_numpy(idx["py"])
    ox = torch.arange(tx)[:, None] * PT + torch.from_numpy(idx["px"])
    valid = (oy < h // 2)[:, None, :] & (ox < wd // 2)[None, :, :]
    d = v - shift.double()[c][..., None]
    s0 = torch.where(valid, d.sum(-1), 0.0).sum(dim=(0, 1, 2))
    s1 = torch.where(valid, (d * d).sum(-1), 0.0).sum(dim=(0, 1, 2))
    stats = torch.zeros((2, cout), dtype=torch.float64)
    stats[0].index_add_(0, c, s0)
    stats[1].index_add_(0, c, s1)
    # the window's four taps as bf16 bits, sign-flipped where the
    # channel's extreme is its minimum; max, then the first tap equal
    vb = bits(v.float().to(torch.bfloat16)).astype(np.int32)
    flip = np.where(scales.numpy()[idx["c"]] > 0, 0, 0x8000)
    fv = torch.from_numpy((vb ^ flip[:, None]).astype(np.uint16).view(
        np.int16)).view(torch.bfloat16).float()
    m = fv.amax(-1)
    first = (fv == m[..., None]).float().argmax(-1)
    zbits = bits(m.to(torch.bfloat16)).astype(np.int32) ^ flip
    zf = torch.from_numpy(zbits.astype(np.uint16).view(np.int16)).view(
        torch.bfloat16)
    # the stores: the window of channel c at pixel (py, px) goes to
    # Z[b, oy, ox, c] (the lane pair's two lanes write the pair's two
    # pixels, channels 8 nt + 2 q and + 1)
    z = torch.zeros((b, ty * PT, tx * PT, cout), dtype=torch.bfloat16)
    am = torch.zeros((b, ty * PT, tx * PT, cout), dtype=torch.int8)
    for i in range(ty):
        for j in range(tx):
            z[:, oy[i], ox[j], c] = zf[:, i, j]
            am[:, oy[i], ox[j], c] = first[:, i, j].to(torch.int8)
    return z[:, :h // 2, :wd // 2], am[:, :h // 2, :wd // 2], stats


def store_owner(cout):
    """The epilogue's stores of a tile: warp w, n8 tile nt and lane l =
    4 g + q write pooled pixel (w, 4 (g % 2) + g // 2) of the tile (the
    even lane of a pair mt 0's window, the odd one mt 1's), channels
    8 nt + 2 q and + 1. Returns the (py, px, c) written."""
    out = []
    for wv in range(8):
        for nt in range(cout // 8):
            for lane in range(32):
                g, q = lane // 4, lane % 4
                px = 4 * (g % 2) + g // 2
                out += [(wv, px, 8 * nt + 2 * q), (wv, px, 8 * nt + 2 * q + 1)]
    return out


@pytest.mark.parametrize("b,h,w,cin,cout", [
    (2, 16, 16, 3, 16), (3, 22, 22, 3, 16), (1, 22, 36, 1, 32),
    (1, 22, 22, 2, 48)])
def test_fold_matches_plain(b, h, w, cin, cout):
    """On the exact grid of train/chain cases (x in eighths, w in
    sixteenths: every float32 conv sum exact) the fold's float64
    arithmetic gives fwdstats_plain's Z and argmax bit for bit and its
    statistics at 1e-6, with partial 8x8 pooled tiles, H != W and Cout
    48; the epilogue's stores write every (pixel, channel) of a tile
    once."""
    t = _case(b * h + w + cin + cout, b, max(h, w), cin, cout)
    x = t["x"][:, :h, :w].contiguous()
    owners = store_owner(cout)
    assert len(owners) == len(set(owners)) == PT * PT * cout
    z, am, st = model_fold(x, t["w"], t["shift"], t["scales"])
    zp, amp, stp = TPT.fwdstats_plain(x, t["w"], t["shift"], t["scales"])
    assert torch.equal(z, zp)
    assert torch.equal(am, amp)
    err = (st - stp.double()).abs().max() / stp.abs().max()
    assert err <= 1e-6, err


def test_fold_matches_jax_pallas(monkeypatch):
    """At (128, 16, 16, 3 -> 16) the fold's Z, argmax and statistics
    against the JAX _train_kernel's mode "fwdstats" (with its argmax) in
    interpret mode: Z within one bf16 ulp, the argmax equal where the
    extreme taps are more than an ulp apart, the statistics at 1e-4."""
    monkeypatch.setattr(JPT, "_INTERPRET", True)
    b, h, cin, cout = 128, 16, 3, 16
    t = _case(12, b, h, cin, cout)
    x, w = t["x"].float().numpy(), t["w"].float().numpy()
    g = JPT.plan_pair(h, h, cin, cout, P=2)
    xp = JPT.to_phase_np(jnp.asarray(x, jnp.bfloat16), g.P)
    halo = JPT.halo_rows(xp, g.H, g.C, g.RP, g.NB)
    wpk = JPT._pack_w(jnp.asarray(w, jnp.float32), g)
    bias_b = jnp.asarray(t["biases"].numpy()).astype(
        jnp.bfloat16).reshape(-1, 1)
    sh, sc = (jnp.asarray(t[k].numpy()) for k in ("shift", "scales"))
    zj, s, amj = JPT._run("fwdstats", g, xp, halo, wpk,
                          JPT._consts(sh, sh, sh, sc), bias_b,
                          with_amax=True)
    h2 = h // 2
    zj = JPT.from_phase_np(np.asarray(zj, np.float32), h2, h2, cout, 1)
    amj = JPT.from_phase_np(np.asarray(amj), h2, h2, cout, 1)
    s = np.asarray(s, np.float64)
    s_j = np.stack([s[:cout].sum(1), s[cout:].sum(1)])
    z, am, st = model_fold(t["x"], t["w"], t["shift"], t["scales"])
    assert_bf16_close(z.float().numpy(), zj)
    y = torch.nn.functional.conv2d(t["x"].permute(0, 3, 1, 2).double(),
                                   t["w"].permute(3, 2, 0, 1).double(),
                                   padding=1)
    taps = y.reshape(b, cout, h2, 2, h2, 2).permute(0, 2, 4, 1, 3, 5)
    taps = taps.reshape(b, h2, h2, cout, 4)
    taps = torch.where(t["scales"].reshape(-1, 1) > 0, taps, -taps)
    top2 = taps.topk(2, dim=-1).values.numpy()
    sep = top2[..., 0] - top2[..., 1] > np.abs(top2[..., 0]) * 2.0 ** -7
    np.testing.assert_array_equal(am.numpy()[sep], amj[sep])
    assert np.abs(st.numpy() - s_j).max() / np.abs(s_j).max() < 1e-4


@pytest.mark.parametrize("mode", TPT.CONV_MODES)
def test_conv_path_by_mode(mode):
    """The mirror of the library's mode-aware predicate: the tile for
    Cin a multiple of 16 in every mode, the taps fold for fwdstats and
    the bf16 serving stem (fwd) at Cin <= 3 only, the FP32-core loop for
    the rest; Cout must be a multiple of 16."""
    want = {1: "tensor_core_fold", 2: "tensor_core_fold",
            3: "tensor_core_fold", 4: "fp32_core", 8: "fp32_core",
            15: "fp32_core", 16: "tensor_core", 24: "fp32_core",
            32: "tensor_core", 40: "fp32_core", 64: "tensor_core"}
    for cin, path in want.items():
        if mode not in ("fwdstats", "fwd") and path == "tensor_core_fold":
            path = "fp32_core"
        assert TPT.conv_path(mode, cin, 16) == path, (cin, path)
        assert TPT.conv_path(mode, cin, 24) == "fp32_core"
    assert TPT.conv_path(mode, 0, 16) == "fp32_core"
    assert set(TPT.conv_kernels[mode]) == set(TPT.CONV_PATHS)


@pytest.mark.parametrize("h", [608, 152])
def test_fold_offsets_at_yolov2_pair(h):
    """yolov2-608's training pair, 3 -> 32 at B=128: 608x608 (304x304
    pooled, 38x38 whole 8x8 pooled tiles) and 152x152 (76x76 pooled: the
    tenth tile of a row and of a column holds 4 pooled rows or columns).
    Every work item's count and index fit 32 bits; over the tiles each
    pooled pixel is valid (oy < H/2 and ox < W/2) exactly once; the
    loader's byte address of each halo row (conv_tc_body's
    2 Cin ((b H + gy) W + gx0)), the X' builder's residue of it mod 16
    (fold_xprime: unsigned 32-bit products, which wrap), bwdg_tc's x, Z,
    dp and argmax offsets and the epilogue's Z/argmax store offsets,
    formed in int64, equal the same formulas in int32 (x is 284 MB, Z 757
    MB at 608: every offset stays below 2^31)."""
    b, cin, cout = 128, 3, 32
    h2 = h // 2
    t = -(-h2 // PT)
    items = b * t * t
    assert items < 2 ** 31
    # valid pooled pixels over the tiles: each once
    oy = (np.arange(t)[:, None] * PT + np.arange(PT)[None]).reshape(-1)
    valid = oy < h2
    assert valid.sum() == h2 and len(np.unique(oy[valid])) == h2
    assert (h2 % PT == 0) == (h == 608)
    i64, i32, u32 = np.int64, np.int32, np.uint32
    img = np.repeat(np.arange(b), t * t)
    ty = np.tile(np.repeat(np.arange(t), t), b)
    tx = np.tile(np.arange(t), b * t)
    assert len(img) == items
    gy0, gx0 = FULL * ty - 1, FULL * tx - 1
    hr = np.arange(HALO)
    for dt in (i64, i32):
        bb, y0, x0 = (v.astype(dt) for v in (img, gy0, gx0))
        gy = y0[:, None] + hr.astype(dt)[None]
        a = dt(2 * cin) * ((bb[:, None] * dt(h) + gy) * dt(h) + x0[:, None])
        if dt is i64:
            a64, inside = a, (gy >= 0) & (gy < h)
        else:
            assert np.array_equal(a, a64)
    # rows outside the image load nothing (the loader's n = 0)
    assert a64[inside].max() < 2 * cin * b * h * h < 2 ** 31
    # fold_xprime: the residue mod 16 from unsigned products that wrap
    gyu = (img[:, None] * h + gy0[:, None] + hr[None]).astype(u32)
    res = (u32(2 * cin) * (gyu * u32(h) + gx0.astype(u32)[:, None])) & u32(15)
    assert np.array_equal(res.astype(i64), a64 & 15)
    # the epilogue's and bwdg_tc's pooled offsets: ((b H2 + oy) W2 + ox)
    # Cout + c at the tile's last pooled pixel and channel; bwdg_tc's x
    # offset b H W Cin + (gy W + gx) Cin + ci at the halo's last pixel
    for dt in (i64, i32):
        bb = img.astype(dt)
        oyl = np.minimum(ty * PT + PT - 1, h2 - 1).astype(dt)
        oxl = np.minimum(tx * PT + PT - 1, h2 - 1).astype(dt)
        zo = ((bb * dt(h2) + oyl) * dt(h2) + oxl) * dt(cout) + dt(cout - 1)
        gyl = np.minimum(gy0 + HALO - 1, h - 1).astype(dt)
        gxl = np.minimum(gx0 + HALO - 1, h - 1).astype(dt)
        xo = bb * dt(h * h * cin) + (gyl * dt(h) + gxl) * dt(cin) + dt(
            cin - 1)
        if dt is i64:
            zo64, xo64 = zo, xo
        else:
            assert np.array_equal(zo, zo64) and np.array_equal(xo, xo64)
    assert zo64.max() == b * h2 * h2 * cout - 1
    assert xo64.max() == b * h * h * cin - 1
