"""The int8 stem pair's tensor-core kernel (csrc/phase_stem.cu), on the CPU.

``phase_pair_tc_kernel`` computes a work item, an (image, 8x8 pooled
tile, group of NC output channels), as one implicit GEMM on
``mma.sync.m16n8k32`` s8 x s8 -> s32 and pools it in registers:

* K = taps x Cin folded into k32 steps by Cin: "taps" (Cin <= 3: 9 x Cin
  codes plus zeros, one step, each position's row assembled in shared
  memory from the halo), "tap_pairs" (Cin <= 16: two taps of 16 channels
  a step, 5 steps), "chunks" (Cin > 16: a tap x 32 channels a step,
  chunks outer, taps inner);
* A and B fragments by ``ldmatrix.x4`` from swizzled shared memory: A
  from the halo at the tap's shifted position (or the assembled rows), B
  from the weights staged [step][co][32 bytes of K];
* M = the 16x16 positions: warp w's m16 tile mt holds rows 0-7 at
  full-resolution row 2w and 8-15 at row 2w + 1, columns 8 mt .. + 7, so
  a lane holds a window's vertical pair and ``__shfl_xor(., 4)`` brings
  the horizontal pair; the max runs on the raw int32 sums and the
  epilogue once per pooled pixel.

This test builds the shared-memory layouts and lane addresses as the
kernel does, emulates ``ldmatrix`` and the s8 ``mma`` by their PTX
fragment maps in numpy, and holds the int32 conv sums and the pooled
int8 codes EXACTLY to ``conv2d_i8`` and ``stem_pair_i8_plain`` (all three
input dtypes of pair 1, uneven Cin / Cout / edges) and, at one small
shape, to the JAX package's ``_pair_kernel`` in interpret mode.
tests/test_torch_cuda.py holds the CUDA kernel to the plain version on
the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sr_object_detection_tpu.kernels.phase_stem as JPS
from sr_object_detection_tpu.graph import spec as JS
import sr_object_detection_tpu_torch.kernels.phase_stem as TPS
from sr_object_detection_tpu_torch.graph import spec as TS
from sr_object_detection_tpu_torch.ops import conv as TC
from test_torch_phase_stem import _synthetic_stem
from torch_parity import phase_pair_case

PT, FULL, TH = 8, 16, 18         # pooled tile, full-resolution tile, halo
TAPS, TAP_PAIRS, CHUNKS = range(3)
LANE = np.arange(32)


def fold_of(cin):
    return TAPS if cin <= 3 else TAP_PAIRS if cin <= 16 else CHUNKS


def k_steps(fold, cin):
    return 1 if fold == TAPS else 5 if fold == TAP_PAIRS else 9 * -(-cin // 32)


def k_source(fold, cin, s, k):
    """(tap, ci, valid) of byte k of k32 step s (arrays broadcast)."""
    if fold == TAPS:
        tap, ci = k // cin, k % cin
    elif fold == TAP_PAIRS:
        tap, ci = 2 * s + (k >> 4), k & 15
    else:
        tap, ci = s % 9 + 0 * k, 32 * (s // 9) + k
    return tap, ci, (tap < 9) & (ci < cin)


def swz2(r, key, u):
    """Byte offset of 16-byte unit u of 32-byte row r, swizzled by bit 2
    of ``key``."""
    return r * 32 + ((u ^ ((key >> 2) & 1)) << 4)


# ---- the PTX fragment maps of mma.m16n8k32 with s8 operands
def a_frag():
    """(32 lanes, 4 regs, 4 bytes) -> (row, k) of A (16x32, row)."""
    l, i, j = np.meshgrid(LANE, np.arange(4), np.arange(4), indexing="ij")
    return l // 4 + 8 * (i & 1), 4 * (l % 4) + 16 * (i >> 1) + j


def b_frag():
    """(32 lanes, 2 regs, 4 bytes) -> (k, n) of B (32x8, col)."""
    l, r, j = np.meshgrid(LANE, np.arange(2), np.arange(4), indexing="ij")
    return 4 * (l % 4) + 16 * r + j, l // 4


def c_frag():
    """(32 lanes, 4 entries) -> (row, n) of C/D (16x8)."""
    l, e = np.meshgrid(LANE, np.arange(4), indexing="ij")
    return l // 4 + 8 * (e >> 1), 2 * (l % 4) + (e & 1)


def ldmatrix_x4(mem, addr):
    """mem (T, bytes) uint8, addr (..., 32) row addresses (lanes 8j ..
    8j + 7 give matrix j's rows) -> (T, ..., 32 lanes, 4 regs, 4 bytes)
    int8: lane l's reg j holds bytes 4 (l % 4) .. + 3 of matrix j's row
    l / 4."""
    j, b = np.arange(4)[:, None], np.arange(4)[None, :]
    l = LANE[:, None, None]
    idx = (np.take(addr, 8 * j[None] + l // 4, axis=-1)
           + 4 * (l % 4) + b[None])
    return mem[:, idx].view(np.int8)


def mma(a, b0, b1):
    """D = A @ B of one m16n8k32 from the lanes' fragments: a (..., 32,
    4, 4), b0 / b1 (..., 32, 4) int8 -> (..., 32 lanes, 4) int64."""
    ar, ak = a_frag()
    A = np.zeros(a.shape[:-3] + (16, 32), np.int64)
    A[..., ar, ak] = a
    bk, bn = b_frag()
    b = np.stack([b0, b1], -2)
    B = np.zeros(b.shape[:-3] + (32, 8), np.int64)
    B[..., bk, bn] = b
    cr, cn = c_frag()
    return (A @ B)[..., cr, cn]


def stage_weights(w, co0, nc, fold):
    """The block's weights in shared memory: byte k of step s, channel n
    at row s * nc + n."""
    cin, cout = w.shape[2:]
    steps = k_steps(fold, cin)
    s, k, n = np.meshgrid(np.arange(steps), np.arange(32), np.arange(nc),
                          indexing="ij")
    tap, ci, ok = k_source(fold, cin, s, k)
    ok = ok & (co0 + n < cout)
    wf = w.reshape(9, cin, cout)
    v = np.where(ok, wf[np.minimum(tap, 8), np.minimum(ci, cin - 1),
                        np.minimum(co0 + n, cout - 1)], 0)
    mem = np.zeros(steps * nc * 32, np.uint8)
    row = s * nc + n
    mem[swz2(row, row, k >> 4) + (k & 15)] = v.astype(np.int8).view(np.uint8)
    return mem[None]


def codes_of(x, inv_in):
    """The codes the kernel stages: int8 as is, frames requantized with
    float32 clamp(rint(x * inv_in))."""
    if x.dtype == np.int8:
        return x
    v = np.rint(x.astype(np.float32) * np.float32(inv_in))
    return np.clip(v, -127, 127).astype(np.int8)


def halos(codes):
    """(B,H,W,Cin) -> (T, 18, 18, Cin) halos of the 8x8 pooled tiles in
    the kernel's item order (image, tile row, tile column), zero outside
    the image."""
    b, h, w, cin = codes.shape
    ty, tx = -(-(h // 2) // PT), -(-(w // 2) // PT)
    pad = np.zeros((b, FULL * ty + 2, FULL * tx + 2, cin), np.int8)
    pad[:, 1:h + 1, 1:w + 1] = codes
    out = np.stack([pad[:, FULL * i:FULL * i + TH, FULL * j:FULL * j + TH]
                    for i in range(ty) for j in range(tx)], 1)
    return out.reshape((-1, TH, TH, cin)), ty, tx


def stages(hal, fold):
    """The shared-memory halo stages of every item: [(step list, mem)] in
    the kernel's order: taps -> the assembled A rows; tap pairs -> one
    stage of 16 bytes a pixel; chunks -> one stage of 32 bytes a pixel
    per 32-channel chunk (units swizzled by the halo column)."""
    t_, _, _, cin = hal.shape
    p = np.arange(TH * TH)
    hx = p % TH
    flat = hal.reshape(t_, TH * TH, cin).view(np.uint8)
    if fold == TAPS:
        halo = np.zeros((t_, TH * TH * 4), np.uint8)
        for c in range(cin):
            halo[:, p * 4 + c] = flat[:, :, c]
        k = np.arange(32)
        tap, ci, ok = k_source(TAPS, cin, 0, k)
        kmap = np.where(ok, ((tap // 3) * TH + tap % 3) * 4 + ci, -1)
        pos = np.arange(FULL * FULL)
        pbase = ((pos >> 4) * TH + (pos & 15)) * 4
        rows = np.where(kmap[None] >= 0,
                        halo[:, pbase[:, None] + np.maximum(kmap, 0)[None]],
                        0)                              # (T, 256, 32)
        a = np.zeros((t_, FULL * FULL * 32), np.uint8)
        for kk in range(32):
            a[:, swz2(pos, pos, kk >> 4) + (kk & 15)] = rows[:, :, kk]
        return [([0], a)]
    if fold == TAP_PAIRS:
        mem = np.zeros((t_, TH * TH * 16), np.uint8)
        for c in range(cin):
            mem[:, p * 16 + c] = flat[:, :, c]
        return [(list(range(5)), mem)]
    out = []
    for ch in range(-(-cin // 32)):
        mem = np.zeros((t_, TH * TH * 32), np.uint8)
        for c in range(32):
            if 32 * ch + c < cin:
                mem[:, swz2(p, hx, c >> 4) + (c & 15)] = flat[:, :,
                                                              32 * ch + c]
        out.append((list(range(9 * ch, 9 * ch + 9)), mem))
    return out


def a_addresses(fold, s):
    """(8 warps, 2 m16 tiles, 32 lanes) A row addresses of step s."""
    wv, mt = np.arange(8)[:, None, None], np.arange(2)[None, :, None]
    l = LANE[None, None, :]
    arow, aunit = 2 * wv + ((l >> 3) & 1), l >> 4
    if fold == TAPS:
        p = arow * FULL + 8 * mt + (l & 7)
        return swz2(p, p, aunit)
    a_pix = arow * TH + 8 * mt + (l & 7)
    if fold == TAP_PAIRS:
        t = np.where(aunit == 1, min(2 * s + 1, 8), 2 * s)
        return (a_pix + (t // 3) * TH + t % 3) * 16
    t = s % 9
    p = a_pix + (t // 3) * TH + t % 3
    return swz2(p, p % TH, aunit)


def b_addresses(s, nc, pr):
    """(32 lanes) B row addresses of step s, n8 tiles 2 pr, 2 pr + 1."""
    brow = (LANE & 7) + 8 * (LANE >> 4)
    return swz2(brow, brow, (LANE >> 3) & 1) + (s * nc + 16 * pr) * 32


def pool_gather(acc):
    """acc (..., 8 warps, 2 mt, NT, 32 lanes, 4) int64 -> (m, pixel, c):
    the pooled max each lane owns after the xor-4 exchange, its pooled
    pixel in the tile and its channel in the group."""
    g, q = LANE // 4, LANE % 4
    even = (g & 1) == 0
    v0 = np.maximum(acc[..., 0], acc[..., 2])
    v1 = np.maximum(acc[..., 1], acc[..., 3])
    send = np.where(even, v1, v0)
    other = send[..., LANE ^ 4]
    m = np.where(even, np.maximum(v0, other), np.maximum(v1, other))
    nt_ = acc.shape[-3]
    wv = np.arange(8)[:, None, None, None]
    mt = np.arange(2)[None, :, None, None]
    nt = np.arange(nt_)[None, None, :, None]
    px = wv * PT + 4 * mt + (g >> 1)
    c = 8 * nt + 2 * q + (g & 1)
    return m, np.broadcast_to(px, m.shape[-4:]), np.broadcast_to(
        c, m.shape[-4:])


def epilogue(m, dq, bias, inv_out):
    """float32 round-to-nearest at each step (the kernel's __fmul_rn /
    __fadd_rn), leaky 0.1, rint half to even, clamp."""
    f = np.float32
    v = (m.astype(f) * f(dq)).astype(f) + f(bias)
    v = np.where(v > 0, v, f(0.1) * v).astype(f)
    return np.clip(np.rint(v * f(inv_out)), -127, 127).astype(np.int8)


def emulate(x, w, dq, bias, inv_out, inv_in):
    """The kernel on numpy inputs -> (pooled codes (B,H/2,W/2,Cout) int8,
    conv sums (B,H,W,Cout) int64 read back from the accumulators)."""
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    fold = fold_of(cin)
    nc = 16 if cout <= 16 else 32
    ntile = nc // 8
    hal, ty, tx = halos(codes_of(x, inv_in))
    st = stages(hal, fold)
    out = np.zeros((b, ty * PT, tx * PT, cout), np.int8)
    conv = np.zeros((b, ty * FULL, tx * FULL, cout), np.int64)
    seen = np.zeros((b, ty * PT, tx * PT, cout), np.int64)
    cr_ = np.arange(4)
    for co0 in range(0, cout, nc):
        wsm = stage_weights(w, co0, nc, fold)
        acc = np.zeros((hal.shape[0], 8, 2, ntile, 32, 4), np.int64)
        for steps, mem in st:
            for s in steps:
                a = ldmatrix_x4(mem, a_addresses(fold, s))
                for pr in range(ntile // 2):
                    bf = ldmatrix_x4(wsm, b_addresses(s, nc, pr))[0]
                    for h2 in range(2):
                        acc[:, :, :, 2 * pr + h2] += mma(
                            a, bf[:, 2 * h2], bf[:, 2 * h2 + 1])
        m, px, c = pool_gather(acc)
        ok = co0 + c < cout
        cc = np.minimum(co0 + c, cout - 1)
        codes = epilogue(m, np.where(ok, dq[cc], 0), np.where(ok, bias[cc], 0),
                         inv_out)
        tiles = acc.shape[0]
        tb, tr = np.arange(tiles) // (ty * tx), np.arange(tiles) % (ty * tx)
        oy = (tr // tx)[:, None, None, None, None] * PT + px // PT
        ox = (tr % tx)[:, None, None, None, None] * PT + px % PT
        bb = np.broadcast_to(tb[:, None, None, None, None], codes.shape)
        sel = np.broadcast_to(ok, codes.shape)
        out[bb[sel], oy[sel], ox[sel], co0 + np.broadcast_to(c, codes.shape)[
            sel]] = codes[sel]
        np.add.at(seen, (bb[sel], oy[sel], ox[sel],
                         co0 + np.broadcast_to(c, codes.shape)[sel]), 1)
        # the accumulators' positions: entry e of lane 4g + q of (warp,
        # mt, nt) = position (2w + e // 2, 8 mt + g), channel 8 nt + 2q +
        # e % 2
        g, q = LANE // 4, LANE % 4
        wv = np.arange(8)[:, None, None, None, None]
        mt = np.arange(2)[None, :, None, None, None]
        nt = np.arange(ntile)[None, None, :, None, None]
        fy = 2 * wv + (cr_ >> 1) + 0 * g[:, None]
        fx = 8 * mt + g[:, None] + 0 * cr_
        ch = 8 * nt + 2 * q[:, None] + (cr_ & 1)
        shp = acc.shape
        fy, fx, ch = (np.broadcast_to(v, shp[1:]) for v in (fy, fx, ch))
        gy = (tr // tx)[:, None, None, None, None, None] * FULL + fy
        gx = (tr % tx)[:, None, None, None, None, None] * FULL + fx
        okc = np.broadcast_to(co0 + ch < cout, shp)
        bb = np.broadcast_to(tb[:, None, None, None, None, None], shp)
        conv[bb[okc], gy[okc], gx[okc],
             np.broadcast_to(co0 + ch, shp)[okc]] = acc[okc]
    # every pooled pixel and channel of the image has exactly one owner
    assert (seen == 1).all()
    return out[:, :h // 2, :wd // 2], conv[:, :h, :wd]


# ------------------------------------------------------------------ tests
def test_mma_fragment_maps():
    """ldmatrix.x4 at the kernel's lane addresses and the s8 m16n8k32
    fragment maps reproduce A @ B exactly; each map covers its matrix
    once."""
    for rows, cols, frag in ((16, 32, a_frag()), (32, 8, b_frag()),
                             (16, 8, c_frag())):
        r, c = frag
        cover = np.zeros((rows, cols), int)
        np.add.at(cover, (r, c), 1)
        assert (cover == 1).all()
    rng = np.random.default_rng(0)
    A = rng.integers(-128, 128, (16, 32), dtype=np.int8)
    Bt = rng.integers(-128, 128, (16, 32), dtype=np.int8)   # [n][k], 2 n8
    amem = np.zeros(16 * 32, np.uint8)
    bmem = np.zeros(16 * 32, np.uint8)
    for r in range(16):
        for u in range(2):
            amem[swz2(r, r, u):swz2(r, r, u) + 16] = A[r, 16 * u:16 * u + 16
                                                       ].view(np.uint8)
            bmem[swz2(r, r, u):swz2(r, r, u) + 16] = Bt[r, 16 * u:16 * u + 16
                                                        ].view(np.uint8)
    arow = (LANE & 7) + 8 * ((LANE >> 3) & 1)
    a = ldmatrix_x4(amem[None], swz2(arow, arow, LANE >> 4))[0]
    bf = ldmatrix_x4(bmem[None], b_addresses(0, 16, 0))[0]
    cr, cn = c_frag()
    for h2 in range(2):
        d = mma(a, bf[:, 2 * h2], bf[:, 2 * h2 + 1])
        want = A.astype(np.int64) @ Bt[8 * h2:8 * h2 + 8].T.astype(np.int64)
        np.testing.assert_array_equal(d, want[cr, cn])


@pytest.mark.parametrize("cin,steps,padding", [
    (1, 1, 23), (3, 1, 5), (5, 5, 5 * 32 - 45), (16, 5, 16),
    (32, 9, 0), (40, 18, 9 * 24), (64, 18, 0)])
def test_k_fold_covers_taps_and_channels(cin, steps, padding):
    """Each fold's (step, byte) -> (tap, channel) map meets every (tap,
    channel) exactly once; the rest is zero padding: 27 + 5 zeros in one
    step at Cin 3, two taps a step at Cin 16 (the last upper half zero),
    tap x 32-channel chunks with none at Cin 32 / 64."""
    fold = fold_of(cin)
    assert k_steps(fold, cin) == steps
    s, k = np.meshgrid(np.arange(steps), np.arange(32), indexing="ij")
    tap, ci, ok = k_source(fold, cin, s, k)
    hits = np.zeros((9, cin), int)
    np.add.at(hits, (tap[ok], ci[ok]), 1)
    assert (hits == 1).all()
    assert (~ok).sum() == padding
    if fold == TAP_PAIRS:       # one tap per 16-byte unit: ldmatrix halves
        assert (tap[:, :16] == 2 * np.arange(steps)[:, None]).all()


def test_position_map_and_pool_gather():
    """The 2-row x 8-column m16 tiles cover the 16x16 positions once, and
    after the xor-4 exchange each lane owns one (pooled pixel, channel)
    whose max is over exactly its 2x2 window."""
    # tag each accumulator entry with its position and channel
    g, q = LANE // 4, LANE % 4
    e = np.arange(4)
    wv = np.arange(8)[:, None, None, None, None]
    mt = np.arange(2)[None, :, None, None, None]
    nt = np.arange(4)[None, None, :, None, None]
    fy = 2 * wv + (e >> 1) + 0 * g[:, None]
    fx = 8 * mt + g[:, None] + 0 * e
    ch = 8 * nt + 2 * q[:, None] + (e & 1)
    fy, fx, ch = np.broadcast_arrays(fy, fx, ch)
    cover = np.zeros((16, 16, 32), int)
    np.add.at(cover, (fy, fx, ch), 1)
    assert (cover == 1).all()
    # a value that encodes the position: the pooled max must be the
    # window's bottom-right position, for every lane and channel
    m, px, c = pool_gather((fy * 16 + fx + 1000 * ch).astype(np.int64))
    py, pxx = px // PT, px % PT
    np.testing.assert_array_equal(
        m, (2 * py + 1) * 16 + 2 * pxx + 1 + 1000 * c)
    owners = np.zeros((64, 32), int)
    np.add.at(owners, (px, c), 1)
    assert (owners == 1).all()


def funnel_r(lo, hi, sh):
    """CUDA's __funnelshift_r: the low 32 bits of (hi:lo) >> sh."""
    v = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return (v >> np.asarray(sh, np.uint64)).astype(np.uint32)


RS = 64                          # bytes of a packed halo row (taps fold)


def words_stage(frame, inv_in, b, oy0, ox0):
    """The taps fold's u8 loader for one item: 252 threads, thread t ->
    halo row t // 14, aligned word t % 14 of the frame row, the bytes of
    pixels outside the image cleared, requantized by the table. Returns
    the item's 18 packed rows (18 * RS bytes) and the rows' lead."""
    _, h, w, _ = frame.shape
    flat = frame.reshape(-1)
    lut = codes_of(np.arange(256, dtype=np.uint8), inv_in).view(np.uint8)
    hb = np.full(18 * RS, 0xAB, np.uint8)            # junk where unwritten
    gy0, gx0 = 2 * oy0 - 1, 2 * ox0 - 1
    leads = []
    for t in range(252):
        row, j = divmod(t, 14)
        gy = gy0 + row
        raw = np.zeros(4, np.uint8)
        rb = ((b * h + gy) * w + gx0) * 3
        lead = rb & 3
        if j == 0:
            leads.append(lead)
        if 0 <= gy < h:
            lo = lead + 3 * max(0, -gx0)
            hi = lead + 3 * min(18, w - gx0)
            b0 = 4 * j
            if b0 + 4 > lo and b0 < hi:
                raw = flat[rb - lead + b0:rb - lead + b0 + 4].copy()
                for i in range(4):
                    if not lo <= b0 + i < hi:
                        raw[i] = 0
        hb[row * RS + 4 * j:row * RS + 4 * j + 4] = lut[raw]
    return hb, np.array(leads)


def taps_rows(hb, leads):
    """Each position's A row from the packed rows at Cin 3, as the kernel
    assembles it: three 9-byte runs by funnel shifts of three words, then
    27 bytes and 5 zeros. -> (256 positions, 32 bytes)."""
    pos = np.arange(256)
    fy, fx = pos // 16, pos % 16
    words = hb.view(np.uint32)
    S = []
    for ky in range(3):
        o = leads[fy + ky] + 3 * fx
        sh = 8 * (o & 3)
        base = ((fy + ky) * RS + (o & ~3)) // 4
        w0, w1, w2 = words[base], words[base + 1], words[base + 2]
        S.append((funnel_r(w0, w1, sh), funnel_r(w1, w2, sh),
                  (w2 >> sh.astype(np.uint32)) & np.uint32(0xff)))
    wd = [S[0][0], S[0][1], S[0][2] | (S[1][0] << np.uint32(8)),
          funnel_r(S[1][0], S[1][1], 24),
          (S[1][1] >> np.uint32(24)) | (S[1][2] << np.uint32(8))
          | (S[2][0] << np.uint32(16)),
          funnel_r(S[2][0], S[2][1], 16),
          (S[2][1] >> np.uint32(16)) | (S[2][2] << np.uint32(16)),
          np.zeros(256, np.uint32)]
    return np.stack(wd, 1).astype(np.uint32).view(np.uint8)


@pytest.mark.parametrize("h,w,b,oy0,ox0", [
    (20, 20, 0, 0, 0), (20, 20, 1, 8, 8), (416, 416, 1, 0, 200),
    (416, 416, 0, 200, 96), (28, 36, 1, 8, 16)])
def test_taps_fold_packed_rows(h, w, b, oy0, ox0):
    """u8 frames at Cin 3 (W a multiple of 4): the aligned-word loader
    stages each halo code at row * 64 + lead + 3 hx + c (zero outside the
    image), and the funnel-shift assembly gives every position the 27
    codes of its 3x3 window in the fold's K order, then 5 zeros."""
    rng = np.random.default_rng(h + oy0)
    frame = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    inv_in = np.float32(127 / 255)
    hb, leads = words_stage(frame, inv_in, b, oy0, ox0)
    assert (leads == 1).all()       # W % 4 == 0: 3 (32 tx - 1) = 1 mod 4
    codes = codes_of(frame, inv_in)
    pad = np.zeros((h + 36, w + 36, 3), np.int8)
    pad[1:h + 1, 1:w + 1] = codes[b]
    halo = pad[2 * oy0:2 * oy0 + 18, 2 * ox0:2 * ox0 + 18]   # (18, 18, 3)
    for hy in range(18):
        row = hb[hy * RS + leads[hy]:hy * RS + leads[hy] + 54]
        np.testing.assert_array_equal(row.view(np.int8), halo[hy].ravel())
    got = taps_rows(hb, leads)
    k = np.arange(32)
    tap, ci, ok = k_source(TAPS, 3, 0, k)
    pos = np.arange(256)
    fy, fx = (pos // 16)[:, None], (pos % 16)[:, None]
    t8 = np.minimum(tap, 8)
    want = np.where(ok, halo[fy + t8 // 3, fx + t8 % 3, ci].view(np.uint8), 0)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("b,h,cin,cout,x_dtype", [
    (2, 20, 3, 16, np.uint8),       # pair 1 from u8 frames, partial tiles
    (2, 20, 3, 16, np.float32),     # pair 1 from float32 frames
    (2, 20, 3, 20, np.int8),        # taps fold on codes, Cout masked (NC 32)
    (2, 18, 16, 32, np.int8),       # pair 2's fold, partial tiles
    (1, 16, 32, 64, np.int8),       # pair 3's fold, two channel groups
    (1, 12, 64, 128, np.int8),      # pair 4's fold, two chunks
    (3, 24, 5, 7, np.int8),         # the card's uneven shapes
    (3, 10, 6, 20, np.int8),
    (3, 18, 40, 9, np.int8),        # a half-empty second chunk
    (2, 8, 16, 16, np.float32),     # frames with Cin > 3
])
def test_kernel_emulation_matches_plain(b, h, cin, cout, x_dtype):
    """The emulated kernel: the int32 conv sums in its accumulators equal
    conv2d_i8's, and its pooled codes equal stem_pair_i8_plain's, bit for
    bit."""
    x, w, dq, bias, inv_out, inv_in = phase_pair_case(
        7 * h + cin, b, h, cin, cout, x_dtype)
    got, sums = emulate(x, w, dq, bias, inv_out, inv_in)
    codes = torch.from_numpy(codes_of(x, inv_in))
    want_sums = TC.conv2d_i8(codes, torch.from_numpy(w), stride=1, pad=1)
    np.testing.assert_array_equal(sums, want_sums.numpy())
    t = [torch.from_numpy(a) for a in (x, w, dq, bias)]
    ref = TPS.stem_pair_i8_plain(
        *t, float(inv_out), None if inv_in is None else float(inv_in))
    assert np.abs(ref.numpy()).max() > 30
    np.testing.assert_array_equal(got, ref.numpy())


@pytest.fixture
def interpret():
    JPS._INTERPRET = True
    yield
    JPS._INTERPRET = False


def test_kernel_emulation_matches_pallas(interpret):
    """One pair (3 -> 16 @16, batch 128, u8 frames): the emulated kernel
    against the JAX package's phase stem in interpret mode."""
    in_scale = 1.0 / 110.0
    spec, qp, s_out = _synthetic_stem(JS, 16, [3, 16], seed=3)
    stem, n = JPS.build_phase_stem(
        spec, [{k: jnp.asarray(v) for k, v in p.items()} for p in qp],
        s_out, in_scale)
    assert n == 2
    x = np.random.RandomState(4).randint(0, 256, (128, 16, 16, 3)).astype(
        np.uint8)
    ref = np.asarray(jax.jit(stem)(jnp.asarray(x)))
    p = qp[0]
    got, _ = emulate(x, p["weights"], p["dequant"], p["biases"],
                     np.float32(1.0 / s_out[0]),
                     np.float32(1.0 / (255.0 * in_scale)))
    assert np.abs(ref).max() > 30
    np.testing.assert_array_equal(got, ref)
    # the port's stem on the CPU (its plain version) agrees too
    spec_t, _, _ = _synthetic_stem(TS, 16, [3, 16], seed=3)
    stem_t, _ = TPS.build_phase_stem(
        spec_t, [{k: torch.from_numpy(v) for k, v in p.items()} for p in qp],
        s_out, in_scale)
    np.testing.assert_array_equal(stem_t(torch.from_numpy(x)).numpy(), got)
