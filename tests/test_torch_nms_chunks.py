"""The NMS kernel's chunked recurrence (csrc/nms.cu), on the CPU.

``nms_per_class_kernel`` takes a class's rank-sorted candidates in chunks
of 32 ranks: the 32x32 diagonal block's suppression bits (one ballot a
row), the chunk's survivors resolved serially from those bits, then the
ranks past the chunk tested against the survivors, g threads a rank each
taking the survivors i = t mod g. The kernel runs only on the card
(tests/test_torch_cuda.py holds it to ``nms_per_class_plain`` there with
torch.equal); here a numpy emulation of that recurrence, with the
kernel's IoU expression in float32, equals ``ops.boxes.nms_per_class_plain``
bit for bit at k = 1, 31, 32, 33, 128 and 845 (duplicate boxes, equal
probs, zero probs, a fully suppressed class, the last positive inside a
chunk), and one case equals the JAX package's ``nms_per_class_pallas`` in
interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr_object_detection_tpu.kernels.nms_pallas import nms_per_class_pallas
from sr_object_detection_tpu_torch.ops import boxes as TB

CHUNK = 32
THREADS = 512          # SROD_NMS_THREADS
F32 = np.float32


def edges(boxes):
    """(x1, x2, y1, y2, area) float32, each op rounded as the kernel's
    __fsub_rn / __fadd_rn / __fmul_rn."""
    x, y, w, h = (boxes[:, i].astype(F32) for i in range(4))
    hw, hh = w * F32(0.5), h * F32(0.5)
    return x - hw, x + hw, y - hh, y + hh, w * h


def overlaps(e, r, q, thresh):
    """IoU(r, q) > thresh for rank arrays r, q (broadcast), the kernel's
    expression order in float32."""
    x1, x2, y1, y2, area = e
    iw = np.minimum(x2[r], x2[q]) - np.maximum(x1[r], x1[q])
    ih = np.minimum(y2[r], y2[q]) - np.maximum(y1[r], y1[q])
    inter = np.where((iw < 0) | (ih < 0), F32(0), iw * ih)
    uni = (area[r] + area[q]) - inter
    with np.errstate(invalid="ignore", divide="ignore"):
        return inter / uni > thresh


def thread_masks(nq, threads=THREADS):
    """The kernel's split of a chunk's survivors over the g threads of a
    later rank: g the largest power of two <= 32 with g * nq <= threads,
    and thread t's bits 0xffffffff / (2^g - 1) << t."""
    g = 1
    while g < 32 and 2 * g * nq <= threads:
        g *= 2
    every = 0xFFFFFFFF // (((1 << g) if g < 32 else 0) - 1 & 0xFFFFFFFF)
    return [(every << t) & 0xFFFFFFFF for t in range(g)]


def chunked_class(boxes, p, thresh):
    """One class through the kernel's chunked recurrence: (k,) probs with
    the suppressed ranks zeroed."""
    k = len(p)
    e = edges(boxes)
    thresh = F32(thresh)
    pos = np.flatnonzero(p > 0)
    n = int(pos[-1]) + 1 if len(pos) else 0
    # past the last prob that is not +0 every rank reads +0, suppressed or
    # not: the later-rank suppression stops there
    nonzero = np.flatnonzero(p.view(np.uint32) != 0)
    nz = int(nonzero[-1]) + 1 if len(nonzero) else 0
    sup = np.zeros(k, bool)
    pend, pbase = 0, 0
    for base in range(0, n, CHUNK):
        # the diagonal block: row i, bit q for q > i (both < k)
        rows = np.zeros(CHUNK, np.int64)
        for i in range(CHUNK):
            r = base + i
            if r >= n or not p[r] > 0:
                continue
            q = np.arange(base + i + 1, min(base + CHUNK, k))
            hit = overlaps(e, r, q, thresh)
            rows[i] = int(np.sum(1 << (q[hit] - base)))
        # after the barrier: the previous chunk's own suppressed ranks
        for i in range(CHUNK):
            if pend >> i & 1:
                sup[pbase + i] = True
        cand = 0
        for i in range(CHUNK):
            r = base + i
            if r < n and p[r] > 0 and not sup[r]:
                cand |= 1 << i
        killed = surv = 0
        for i in range(CHUNK):
            if cand >> i & 1 and not killed >> i & 1:
                surv |= 1 << i
                killed |= int(rows[i])
        end = base + CHUNK
        if surv and end < nz:
            masks = thread_masks(nz - end)
            assert sum(masks) == 0xFFFFFFFF           # disjoint, all bits
            q = np.arange(end, nz)
            live = ~sup[end:nz]
            for m in masks:
                ranks = [base + i for i in range(CHUNK) if (surv & m) >> i & 1]
                if ranks:
                    hit = overlaps(e, np.array(ranks)[:, None], q[None, :],
                                   thresh).any(0)
                    sup[end:nz] |= live & hit
        pend, pbase = killed, base
    for i in range(CHUNK):
        if pend >> i & 1:
            sup[pbase + i] = True
    return np.where(sup, F32(0), p)


def chunked(top_boxes, top_p, thresh):
    return np.stack([chunked_class(b, p, thresh)
                     for b, p in zip(top_boxes, top_p)])


def case(seed, n, c, k):
    """Rank-sorted top-k candidates (C, k, 4), (C, k) of random boxes
    with duplicates, equal probs, zero probs, a class whose every
    candidate is one box (all suppressed but the first) and a last
    positive inside a chunk."""
    rng = np.random.default_rng(seed)
    boxes = np.stack([rng.uniform(0, 1, n), rng.uniform(0, 1, n),
                      rng.uniform(.02, .4, n), rng.uniform(.02, .4, n)],
                     axis=1).astype(F32)
    boxes[n // 3:n // 3 + 8] = boxes[n // 3 - 1]     # duplicate boxes
    probs = rng.uniform(0, 1, (n, c)).astype(F32) ** 4
    probs[probs < 0.05] = 0
    probs[::7, 0] = probs[0, 0]                       # equal probs
    probs[n // 3 - 1:n // 3 + 8, 1] = 0.5             # equal on equal
    tb, tp, _ = TB.topk_candidates(torch.from_numpy(boxes),
                                   torch.from_numpy(probs), k)
    tb, tp = tb.numpy().copy(), tp.numpy().copy()
    if c > 3:
        tb[2] = tb[2, :1]                             # one box, many ranks
        tp[2] = np.where(tp[2] > 0, np.linspace(1, .5, k, dtype=F32), 0)
        live = max(1, k * 3 // 5 + 3)                 # inside a chunk
        tp[3, live:] = 0
    return tb, tp


@pytest.mark.parametrize("k", [1, 31, 32, 33, 128, 845])
def test_chunked_recurrence_equals_plain(k):
    tb, tp = case(k, 845, 6, k)
    for thresh in (0.4, 0.0):
        got = chunked(tb, tp, thresh)
        ref = TB.nms_per_class_plain(torch.from_numpy(tb),
                                     torch.from_numpy(tp), thresh).numpy()
        assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))
    if k > 1:
        # not vacuous: something was suppressed, something kept
        kept = chunked(tb, tp, 0.4)
        assert ((tp > 0) & (kept == 0)).any() and (kept > 0).any()
        # the one-box class keeps its first rank only
        assert (kept[2] > 0).sum() == 1


def test_tail_of_zero_and_negative_probs():
    """Past the last positive prob, ranks with -0.0 or negative probs are
    still zeroed where a survivor overlaps them (the plain version's
    where(sup, 0, p)); ranks of +0 read +0 either way."""
    tb, tp = case(11, 845, 6, 128)
    for c in range(6):
        last = int(np.flatnonzero(tp[c] > 0)[-1]) + 1
        tail = np.array([-0.0, -0.25, 0.0, -1e-30, -0.0], F32)
        m = min(len(tail), 128 - last)
        tp[c, last:last + m] = tail[:m]
        tb[c, last:last + m] = tb[c, 0]               # overlaps rank 0
    got = chunked(tb, tp, 0.4)
    ref = TB.nms_per_class_plain(torch.from_numpy(tb), torch.from_numpy(tp),
                                 0.4).numpy()
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))
    assert (np.signbit(tp) & (got == 0) & ~np.signbit(got)).any()


def test_all_zero_and_single_rank():
    tb, tp = case(7, 40, 2, 40)
    tp[:] = 0
    assert np.array_equal(chunked(tb, tp, 0.4), tp)
    tp[1, 0] = 0.3
    got = chunked(tb, tp, 0.4)
    assert got[1, 0] == np.float32(0.3) and (got[0] == 0).all()


@pytest.mark.parametrize("threads", [THREADS, 1024])
def test_thread_masks_cover_each_survivor_once(threads):
    for nq in (1, 7, 8, 9, 31, 32, 33, 96, 128, 200, 256, 1000, 1024, 8000):
        masks = thread_masks(nq, threads)
        assert len(masks) * nq <= threads or len(masks) == 1
        acc = 0
        for m in masks:
            assert acc & m == 0
            acc |= m
        assert acc == 0xFFFFFFFF


def test_chunked_recurrence_matches_jax_pallas():
    """One case against the JAX package's nms_per_class_pallas in
    interpret mode (C=6, k=128)."""
    tb, tp = case(128, 400, 6, 128)
    want = np.asarray(nms_per_class_pallas(jnp.asarray(tb), jnp.asarray(tp),
                                           0.4, interpret=True))
    got = chunked(tb, tp, 0.4)
    assert np.array_equal(got, want)
