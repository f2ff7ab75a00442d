"""Helpers shared by the port's tests; they import no JAX, so that the
tests that run on the GPU machine (tests/test_torch_cuda.py) can use
them too."""

import numpy as np


def bf16_ulps(a, b):
    """Distance in bf16 units in the last place between bf16 values
    held as float32 arrays."""
    def ordered(x):
        u = np.asarray(x, np.float32).view(np.uint32) >> 16
        mag = (u & 0x7FFF).astype(np.int64)
        return np.where(u >> 15, -mag, mag)
    return np.abs(ordered(a) - ordered(b))


def random_bn(params, seed, head_gain=1.0):
    """Non-trivial BN statistics and biases (init_params gives the
    identity and zeros, which hide bias and BN bugs). ``head_gain``
    scales the last conv (the region head) so that objectness and class
    probs spread over [0, 1] and random weights give detections."""
    rng = np.random.default_rng(seed)
    out = []
    for p in params:
        p = dict(p)
        if "biases" in p:
            n = p["biases"].shape[0]
            p["biases"] = rng.normal(0, 0.2, n).astype(np.float32)
            if "scales" in p:
                p["scales"] = rng.uniform(0.6, 1.4, n).astype(np.float32)
                p["rolling_mean"] = rng.normal(0, 0.1, n).astype(np.float32)
                p["rolling_variance"] = rng.uniform(
                    0.6, 1.6, n).astype(np.float32)
        out.append(p)
    head = max(i for i, p in enumerate(out) if "weights" in p)
    out[head]["weights"] = np.asarray(out[head]["weights"],
                                      np.float32) * head_gain
    return out


def nms_case(name):
    """(boxes (N,4), probs (N,C), thresh, k)."""
    rng = np.random.default_rng({"ties": 0, "k128": 1, "k400": 2}[name])
    if name == "ties":
        # duplicate boxes with equal probs (rank ties -> lower index
        # first), an IoU exactly at the threshold (1/3: kept, the test is
        # strict), zero-prob boxes between live ones
        boxes = np.array([[1, 1, 2, 2], [1, 1, 2, 2], [2, 1, 2, 2],
                          [5, 5, 1, 1], [5, 5, 1, 1], [5.2, 5, 1, 1],
                          [8, 8, 2, 2], [1, 1, 2, 2]], np.float32)
        probs = np.zeros((8, 3), np.float32)
        probs[:, 0] = [.5, .5, .5, .0, .9, .9, .3, .5]
        probs[:, 1] = [.2, .0, .2, .7, .7, .1, .0, .2]
        probs[:, 2] = .25
        return boxes, probs, np.float32(1 / 3), 8
    n, c = 845, 20
    boxes = np.stack([rng.uniform(0, 1, n), rng.uniform(0, 1, n),
                      rng.uniform(.02, .4, n), rng.uniform(.02, .4, n)],
                     axis=1).astype(np.float32)
    probs = rng.uniform(0, 1, (n, c)).astype(np.float32) ** 4
    probs[probs < 0.05] = 0
    probs[::7, 3] = probs[0, 3]          # many equal probs in one class
    return boxes, probs, np.float32(0.4), 128 if name == "k128" else 400


def assert_bf16_close(got, ref, *, atol=1e-5):
    """Every element within one bf16 ulp, except where both sit within
    ``atol`` of each other: near a cancellation the float32 sums of two
    implementations (other orders) can land on either side of a bf16
    rounding boundary arbitrarily close to 0, where one ulp is tiny."""
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    u = bf16_ulps(got, ref)
    bad = (u > 1) & (np.abs(got - ref) > atol)
    if bad.any():
        i = np.flatnonzero(bad)[:8]
        raise AssertionError(
            f"{bad.sum()} of {bad.size} elements differ by more than one "
            f"bf16 ulp: got {got.ravel()[i]}, want {ref.ravel()[i]}")
    return u
