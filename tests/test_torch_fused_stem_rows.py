"""The row kernels of the fused stem (csrc/fused_stem.cu
``f2_row_kernel``, ``b1_row_kernel``, ``b2_row_kernel``), emulated in
numpy on the CPU.

The kernels run only on the card (tests/test_torch_cuda.py holds them to
their plain versions there); here their index maps and their order of
summation are emulated from the same formulas as the source and held to
the plain versions of kernels/fused_stem.py:

* the task -> (row, column tile) map over the blocks' grid-stride loop,
  the thread -> (pooled column, channel group) map and the vector
  offsets of the four taps and of dp cover every window and every tap
  exactly once, at the five fusable pairs' shapes of tiny-yolo-voc-416
  at B=128 and at odd ones;
* the 16-byte vectors' lanes are channels 8g .. 8g+7, low half first,
  and a B2 row pass gathered, computed and scattered through those maps
  equals ``b2_plain`` bit for bit;
* an F2 row pass (the bf16x2 activation and the window's maximum, one
  vector stored at the pooled pixel's offset) writes every pooled vector
  once and equals ``f2_plain`` bit for bit, at the five fusable pairs'
  shapes and at rows split into partial column tiles;
* B1's fixed-order sums (per thread, per block in shared memory, then
  colsum) in float32 are within 1e-4 of ``b1_plain``'s largest
  magnitude;
* ``_row_path`` picks the row kernels for dense channels-last, C a
  multiple of 8 and 16-byte aligned tensors only (F2's output too);
* at yolov2-608's four fused-stem pairs and B=128 (pooled widths 304,
  152, 76 and 38, rows split into partial column tiles) the tasks count
  in 32 bits, every window is covered once, and the vector offsets
  formed in int64 equal the same offsets in int32, while layer 0's byte
  offsets pass 2^31 within image 90.
"""

import numpy as np
import pytest
import torch

import sr_object_detection_tpu_torch.kernels.fused_stem as FS
from torch_parity import misaligned, stem_case

SMS = 132                        # blocks resident on an H100, one an SM
PAIRS = [(416 >> k, 16 << k) for k in range(5)]      # (H = W, C)


def task_map(tasks, nblk):
    """Block k's tasks in the kernel's order: k, k + nblk, ... Returns
    (tasks of block, in order) for every block."""
    return [np.arange(k, tasks, nblk) for k in range(nblk)]


def grid(b, c, h, w, nblk=None):
    g, kper, ntile, threads = FS.row_geometry(c, w)
    tasks = b * (h // 2) * ntile
    if nblk is None:
        nblk = min(tasks, SMS)
    return g, kper, ntile, threads, tasks, nblk


def thread_windows(c, w):
    """Per tile and thread: (pooled column pw, channel group cg, valid)."""
    g, kper, ntile, threads = FS.row_geometry(c, w)
    t = np.arange(threads)
    cg, q = t % g, t // g
    pw = np.arange(ntile)[:, None] * kper + q[None]
    return pw, np.broadcast_to(cg, pw.shape), pw < w // 2


def vector_offsets(r, pw, cg, g, w2):
    """The four taps' y vector offsets and dp's (csrc row_loads)."""
    yrow = 2 * w2 * g
    yo = 2 * r * yrow + 2 * pw * g + cg
    return (np.stack([yo, yo + g, yo + yrow, yo + yrow + g]),
            r * w2 * g + pw * g + cg)


@pytest.mark.parametrize("b,h,w,c", [(128, h, h, c) for h, c in PAIRS]
                         + [(3, 26, 26, 8), (3, 26, 26, 24),
                            (2, 26, 26, 512), (1, 2, 2, 8)])
def test_row_maps_cover_every_window_once(b, h, w, c):
    g, kper, ntile, threads, tasks, nblk = grid(b, c, h, w)
    assert 1 <= threads <= FS.ROW_THREADS and threads == kper * g
    if (h, c) in PAIRS:                 # one row a block, no idle thread
        assert (ntile, threads) == (1, w // 2 * g)
    # every task once over the blocks' grid-stride loops
    seen = np.concatenate(task_map(tasks, nblk))
    assert np.array_equal(np.sort(seen), np.arange(tasks))
    # within a row: every (column, group) once over the tiles' threads
    pw, cg, ok = thread_windows(c, w)
    cover = np.zeros((w // 2, g), np.int64)
    np.add.at(cover, (pw[ok], cg[ok]), 1)
    assert (cover == 1).all()
    # the taps of a row's windows cover y's two rows 2r, 2r+1 once, dp's
    # row r once; rows r follow each other, so all rows tile y and dp
    taps, dpo = vector_offsets(0, pw[ok], cg[ok], g, w // 2)
    assert np.array_equal(np.sort(taps.reshape(-1)),
                          np.arange(2 * w * g))
    assert np.array_equal(np.sort(dpo), np.arange(w // 2 * g))
    rows = np.arange(b * (h // 2))
    assert np.array_equal(vector_offsets(rows, 0, 0, g, w // 2)[0][0],
                          rows * 2 * w * g)


# yolov2-608's fused-stem pairs (H = W, C): layers 0, 2, 6 and 10
Y2_PAIRS = [(608, 32), (304, 64), (152, 128), (76, 256)]


@pytest.mark.parametrize("h,c", Y2_PAIRS)
def test_row_maps_at_yolov2_pairs(h, c):
    """At B=128 the tasks' count fits 32 bits and the column tiles cover
    each row's W/2 pooled columns, the last tile partial where W/2 does
    not divide; every (column, channel group) of a row is covered once.
    The vector offsets of y's four taps and of dp (csrc row_loads) at the
    rows of images 0, 90, 91 and 127, formed in int64 and in int32, are
    equal: at most 189 M vectors. Their byte offsets (16 a vector) pass
    2^31 at layer 0 (y is 3.03 GB) within image 90 and for every image
    from 91 on, and there an int32 byte offset would wrap: the kernels
    index 16-byte vectors with 64-bit offsets."""
    b, h2 = 128, h // 2
    g, kper, ntile, threads, tasks, nblk = grid(b, c, h, h)
    assert tasks < 2 ** 31 and threads == kper * g <= FS.ROW_THREADS
    assert kper * ntile >= h2 and kper * (ntile - 1) < h2
    assert ntile > 1                    # wider rows than one block's 448
    pw, cg, ok = thread_windows(c, h)
    cover = np.zeros((h2, g), np.int64)
    np.add.at(cover, (pw[ok], cg[ok]), 1)
    assert (cover == 1).all() and (~ok).sum() == (kper * ntile - h2) * g
    imgs = (0, 90, 91, b - 1)
    rows = np.concatenate([np.arange(i * h2, (i + 1) * h2) for i in imgs])
    taps, dpo = vector_offsets(rows[:, None], pw[ok][None], cg[ok][None], g,
                               h2)
    i32 = np.int32
    taps32, dpo32 = vector_offsets(rows.astype(i32)[:, None],
                                   pw[ok].astype(i32)[None],
                                   cg[ok].astype(i32)[None], i32(g),
                                   i32(h2))
    assert taps32.dtype == i32
    assert np.array_equal(taps32, taps) and np.array_equal(dpo32, dpo)
    assert taps.max() == b * h * h * g - 1        # y's last vector
    past = 16 * taps >= 2 ** 31
    image = rows[:, None] // h2
    image = np.broadcast_to(image[None], past.shape)
    if c == 32:                                   # layer 0: 3.03 GB
        assert past[image >= 91].all() and not past[image <= 89].any()
        assert past[image == 90].any() and not past[image == 90].all()
        assert not np.array_equal((16 * taps32)[past], (16 * taps)[past])
    else:
        assert not past.any()


def bf16r(v):
    """float32 -> nearest bf16 (ties to even), as float32."""
    u = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def bf16_rn(x):
    """float64 -> nearest bf16 (ties to even) in one rounding, as float32:
    the bf16x2 add and multiply of the row kernels on bf16 operands,
    whose float64 sum or product is exact here."""
    m, e = np.frexp(np.asarray(x, np.float64))
    return (np.rint(m * 256.0) * np.exp2(e - 8.0)).astype(np.float32)


SLOPE = np.float64(0.10009765625)


def test_bf16x2_ops_equal_float_then_round():
    """For bf16 operands, one rounding of the exact sum or product (the
    kernels' add.rn / mul.rn.bf16x2) equals the strided kernels' float32
    operation rounded to bf16, with exponent gaps up to 30 (a float32 sum
    is inexact from a gap of 17)."""
    rng = np.random.default_rng(0)
    n = 200_000
    a = bf16r(rng.normal(0, 1, n).astype(np.float32))
    b = bf16r((rng.normal(0, 1, n) * np.exp2(-rng.integers(0, 31, n)))
              .astype(np.float32))
    b[::7] = -b[::7]
    assert np.array_equal(bf16r(a + b), bf16_rn(a.astype(np.float64) + b))
    assert np.array_equal(bf16r(np.float32(SLOPE) * a), bf16_rn(SLOPE * a))
    # leaky on bf16 z: z > 0 ? z : bf16(slope z) is max(z, bf16(slope z))
    z = np.concatenate([a, [0.0, -0.0]]).astype(np.float32)
    leaky = np.where(z > 0, z, bf16r(np.float32(SLOPE) * z))
    assert np.array_equal(np.maximum(z, bf16_rn(SLOPE * z)).view(np.uint32),
                          leaky.view(np.uint32))


def words(t):
    """A dense channels-last bf16 tensor as its (B, H, W, C/8, 4) uint32
    words, the 16-byte vectors the kernels load."""
    b, c, h, w = t.shape
    u16 = t.permute(0, 2, 3, 1).contiguous().view(torch.int16).numpy()
    return u16.view(np.uint32).reshape(b * h * w * c // 8, 4)


def lanes(vec):
    """(..., 4) uint32 words -> (..., 8) float32: lane j from word j // 2,
    the low half first (csrc lane())."""
    w = vec[..., np.arange(8) // 2]
    bits = np.where(np.arange(8) % 2 == 1, w & 0xFFFF0000, w << 16)
    return bits.astype(np.uint32).view(np.float32)


def pack(vals):
    """(..., 8) float32 -> (..., 4) uint32: bf16 pairs, channel 2m in the
    low half of word m (csrc pack2)."""
    bits = bf16r(vals).view(np.uint32) >> 16
    return (bits[..., 0::2] | (bits[..., 1::2] << 16)).astype(np.uint32)


def consts(case):
    return [case[k].numpy() for k in ("mean", "inv", "scales", "biases",
                                      "c1", "c2", "c3")]


def activation(v, k4, grp):
    """Per tap (4, n, 8 lanes): y - mean, x_hat, the pre-activation z and
    the activation a, for channel group ``grp`` (n,), with the bf16x2
    operations of csrc row_act."""
    mean, inv, sc, bias = (k.reshape(-1, 8)[grp] for k in k4[:4])
    xm = v - mean
    xh = xm * inv
    z = bf16_rn(bf16r(xh * sc).astype(np.float64) + bf16r(bias))
    return xm, xh, z, np.maximum(z, bf16_rn(SLOPE * z))


def window(v, k4, grp):
    """Per tap (4, n, 8 lanes): y - mean, x_hat, the first maximal tap and
    its sign, for channel group ``grp`` (n,), with the bf16x2 operations
    of csrc row_pair."""
    xm, xh, z, a = activation(v, k4, grp)
    first = np.argmax(a == a.max(axis=0), axis=0)
    return xm, xh, first, np.take_along_axis(z, first[None], 0)[0] > 0


def emulate(case, nblk=None, b2=True):
    """The row kernel (B2: dy; else B1: the (C, 2) sums) on the CPU: every
    block's tasks in order, every thread's windows gathered by
    vector_offsets, computed as the kernel computes them, scattered back
    (B2) or summed in the kernel's order (B1)."""
    y, dp = case["y"], case["dp"]
    b, c, h, w = y.shape
    g, kper, ntile, threads, tasks, nblk = grid(b, c, h, w, nblk)
    yw, dw = words(y), words(dp)
    k7 = consts(case)
    out = np.zeros_like(yw)
    t = np.arange(threads)
    cg, q = t % g, t // g
    s = np.zeros((nblk, threads, 2, 8), np.float32)
    for blk, mine in enumerate(task_map(tasks, nblk)):
        for task in mine:
            r, tile = divmod(int(task), ntile)
            pw = tile * kper + q
            ok = pw < w // 2
            taps, dpo = vector_offsets(r, pw[ok], cg[ok], g, w // 2)
            v = lanes(yw[taps])                          # (4, n, 8)
            gv = lanes(dw[dpo])                          # (n, 8)
            xm, xh, first, pf = window(v, k7, cg[ok])
            dz = np.where(pf, gv, bf16_rn(SLOPE * gv))
            if b2:
                c1, c2, c3 = (k.reshape(-1, 8)[cg[ok]] for k in k7[4:])
                d = np.where(np.arange(4)[:, None, None] == first, dz,
                             np.float32(0))
                out[taps] = pack((d * c1 + xm * c2) + c3)
            else:
                yf = np.take_along_axis(v, first[None], 0)[0]
                xf = (yf - k7[0].reshape(-1, 8)[cg[ok]]) \
                    * k7[1].reshape(-1, 8)[cg[ok]]
                s[blk, ok, 0] += dz
                s[blk, ok, 1] += dz * xf
    if b2:
        u16 = out.view(np.uint16).reshape(b, h, w, c)
        return torch.from_numpy(u16.view(np.int16).copy()).view(
            torch.bfloat16).permute(0, 3, 1, 2)
    # block reduction: per output o, the threads of its channel group in
    # thread order; then colsum: 256 strided partial sums, a tree
    part = np.zeros((nblk, 2 * c), np.float32)
    for o in range(2 * c):
        which, ch = divmod(o, c)
        acc = np.zeros(nblk, np.float32)
        for k in range(kper):
            acc += s[:, k * g + ch // 8, which, ch % 8]
        part[:, o] = acc
    red = np.zeros((256, 2 * c), np.float32)
    for tid in range(256):
        for row in range(tid, nblk, 256):
            red[tid] += part[row]
    n = 128
    while n:
        red[:n] += red[n:2 * n]
        n //= 2
    return torch.from_numpy(red[0].reshape(2, c).T.copy())


def emulate_f2(case, nblk=None):
    """F2's row kernel on the CPU: every block's tasks in order, every
    thread's four taps gathered by vector_offsets, the activation and the
    window's maximum as the kernel computes them, one vector stored at
    the pooled pixel's offset (dp's). Every pooled vector is written
    once."""
    y = case["y"]
    b, c, h, w = y.shape
    g, kper, ntile, threads, tasks, nblk = grid(b, c, h, w, nblk)
    yw = words(y)
    k4 = consts(case)[:4]
    out = np.zeros((b * (h // 2) * (w // 2) * g, 4), np.uint32)
    stores = np.zeros(len(out), np.int64)
    t = np.arange(threads)
    cg, q = t % g, t // g
    for mine in task_map(tasks, nblk):
        for task in mine:
            r, tile = divmod(int(task), ntile)
            pw = tile * kper + q
            ok = pw < w // 2
            taps, po = vector_offsets(r, pw[ok], cg[ok], g, w // 2)
            a = activation(lanes(yw[taps]), k4, cg[ok])[3]
            out[po] = pack(a.max(axis=0))
            stores[po] += 1
    assert (stores == 1).all()
    u16 = out.view(np.uint16).reshape(b, h // 2, w // 2, c)
    return torch.from_numpy(u16.view(np.int16).copy()).view(
        torch.bfloat16).permute(0, 3, 1, 2)


ODD = [(3, 26, 8), (3, 26, 24), (2, 26, 512), (2, 52, 128)]     # B, H, C


@pytest.mark.parametrize("b,h,c", [(1, h, c) for h, c in PAIRS]
                         + [(2, 26, 512), (1, 34, 384), (3, 26, 24)])
def test_f2_row_emulation_equals_plain(b, h, c):
    """At the five pairs' (H, C) (batch 1) and at rows split into column
    tiles, the last one partial (C 512 at 26: 2 tiles of 7 columns for
    13; C 384 at 34: 2 tiles of 9 for 17)."""
    case = stem_case(b + h + c, b, h, c, "cpu")
    _, kper, ntile, _ = FS.row_geometry(c, h)
    assert (ntile > 1 and kper * ntile > h // 2) == (c >= 384)
    k4 = [case[n] for n in ("mean", "inv", "scales", "biases")]
    ref = FS.f2_plain(case["y"], *k4)
    for nblk in (None, 5):
        got = emulate_f2(case, nblk)
        assert torch.equal(got, ref), (got != ref).sum().item()


@pytest.mark.parametrize("b,h,c", ODD)
def test_b2_row_emulation_equals_plain(b, h, c):
    case = stem_case(b + h + c, b, h, c, "cpu")
    k = [case[n] for n in ("mean", "inv", "scales", "biases", "c1", "c2",
                           "c3")]
    ref = FS.b2_plain(case["y"], case["dp"], *k)
    for nblk in (None, 5):
        got = emulate(case, nblk)
        assert torch.equal(got, ref), (got != ref).sum().item()


@pytest.mark.parametrize("b,h,c", ODD)
def test_b1_row_emulation_within_plain(b, h, c):
    case = stem_case(b + h + c, b, h, c, "cpu")
    k4 = [case[n] for n in ("mean", "inv", "scales", "biases")]
    ref = FS.b1_plain(case["y"], case["dp"], *k4)
    for nblk in (None, 5):
        got = emulate(case, nblk, b2=False)
        assert torch.equal(got, emulate(case, nblk, b2=False))
        rel = ((got - ref).abs().max(dim=0).values
               / ref.abs().max(dim=0).values).max().item()
        assert rel <= 1e-4, rel


def test_lanes_are_channels_low_half_first():
    case = stem_case(0, 2, 4, 24, "cpu")
    y = case["y"]
    v = lanes(words(y)).reshape(2, 4, 4, 24)
    assert np.array_equal(v, y.permute(0, 2, 3, 1).float().numpy())
    assert np.array_equal(pack(v.reshape(2, 4, 4, 3, 8)),
                          words(y).reshape(2, 4, 4, 3, 4))


def test_row_path_by_layout():
    case = stem_case(1, 2, 8, 16, "cpu")
    y, dp = case["y"], case["dp"]
    assert FS._row_path(y, dp) and FS._row_path(y, dp, torch.empty_like(y))
    nchw = stem_case(1, 2, 8, 16, "cpu", channels_last=False)
    assert not FS._row_path(nchw["y"], nchw["dp"])
    assert not FS._row_path(y, nchw["dp"])            # dp NCHW
    assert not FS._row_path(y, dp, torch.empty(y.shape, dtype=y.dtype))
    c12 = stem_case(1, 2, 8, 12, "cpu")               # C % 8 != 0
    assert not FS._row_path(c12["y"], c12["dp"])
    c24 = stem_case(1, 2, 8, 24, "cpu")               # B1's old kernel: no
    assert FS._row_path(c24["y"], c24["dp"]) and not FS._b1_takes(24)
    bad = misaligned(y)                               # 2 bytes off 16
    assert torch.equal(bad, y) and bad.data_ptr() % 16 == 2
    assert bad.is_contiguous(memory_format=torch.channels_last)
    assert not FS._row_path(bad, dp)
    assert not FS._row_path(y, misaligned(dp))
    assert not FS._row_path(y, dp, misaligned(y))
    assert FS._row_path(y[1:], dp[1:])                # aligned view
    assert not FS._row_path(y[:, :8], dp[:, :8])      # channel slice
    # F2: y and its pooled output, no dp
    pooled = torch.empty(dp.shape, dtype=dp.dtype).contiguous(
        memory_format=torch.channels_last)
    assert FS._row_path(y, None, pooled)
    assert not FS._row_path(nchw["y"], None, pooled)
    assert not FS._row_path(y, None, torch.empty(dp.shape, dtype=dp.dtype))
    assert not FS._row_path(y, None, misaligned(pooled))
    assert not FS._row_path(misaligned(y), None, pooled)
    assert not FS._row_path(c12["y"], None, torch.empty(
        c12["dp"].shape, dtype=dp.dtype).contiguous(
            memory_format=torch.channels_last))
