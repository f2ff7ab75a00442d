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


def phase_pair_case(seed, batch, h, cin, cout, x_dtype=np.int8):
    """Random inputs of one int8 stem pair (kernels/phase_stem.py):
    (x, w, dq, bias, inv_out, inv_in) as numpy. ``x`` is (batch, h, h,
    cin) int8 codes, or raw uint8/float32 frames with their requant
    scale ``inv_in`` (None for codes). The dequant scales put the conv's
    float values at about +-1.5 and ``inv_out`` maps those to codes of
    about +-30, so few saturate and every rounding path is exercised."""
    rng = np.random.default_rng(seed)
    if x_dtype == np.int8:
        x, inv_in = rng.integers(-127, 128, (batch, h, h, cin),
                                 dtype=np.int8), None
    elif x_dtype == np.uint8:
        x, inv_in = rng.integers(0, 256, (batch, h, h, cin),
                                 dtype=np.uint8), np.float32(127 / 255)
    else:
        x = rng.uniform(0, 1, (batch, h, h, cin)).astype(np.float32)
        inv_in = np.float32(127.0)
    w = rng.integers(-127, 128, (3, 3, cin, cout), dtype=np.int8)
    acc_std = 127.0 ** 2 / 3 * np.sqrt(9 * cin)
    dq = (rng.uniform(0.5, 1.5, cout) * 1.5 / acc_std).astype(np.float32)
    bias = rng.uniform(-1, 1, cout).astype(np.float32)
    return x, w, dq, bias, np.float32(20.0), inv_in
