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


def train_cfg_text(text, *, size=None, batch=None, subdivisions=None,
                   max_batches=None, random=None):
    """A darknet cfg's text with [net] width/height, batch, subdivisions
    and max_batches, and the region's random flag, replaced."""
    import re

    def put(t, key, val):
        return re.sub(rf"(?m)^{key}\s*=.*$", f"{key}={val}", t)
    if size is not None:
        text = put(put(text, "width", size), "height", size)
    for key, val in (("batch", batch), ("subdivisions", subdivisions),
                     ("max_batches", max_batches), ("random", random)):
        if val is not None:
            text = put(text, key, val)
    return text


def write_ppm_dataset(root, n, *, w=500, h=375, classes=20, seed=0):
    """``n`` random binary PPM images under root/images with darknet
    label files under root/labels (1-3 boxes each), and root/train.list.
    PPM needs no PIL to decode. Returns the list's path."""
    import pathlib
    root = pathlib.Path(root)
    (root / "images").mkdir(parents=True, exist_ok=True)
    (root / "labels").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        p = root / "images" / f"{i:05d}.ppm"
        p.write_bytes(f"P6\n{w} {h}\n255\n".encode() + img.tobytes())
        rows = [f"{rng.integers(0, classes)} {rng.uniform(.2, .8):.6f} "
                f"{rng.uniform(.2, .8):.6f} {rng.uniform(.1, .4):.6f} "
                f"{rng.uniform(.1, .4):.6f}"
                for _ in range(rng.integers(1, 4))]
        (root / "labels" / f"{i:05d}.txt").write_text("\n".join(rows) + "\n")
        paths.append(str(p))
    lst = root / "train.list"
    lst.write_text("\n".join(paths) + "\n")
    return str(lst)


def _bf16_ulp(v):
    """One bf16 unit in the last place at |v| (float32 array)."""
    a = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


def pair_spec(h, cin, cout):
    """The ConvSpec of a training pair's conv: 3x3 s1 p1, BN, leaky, at
    h x h, cin -> cout (the port's spec class)."""
    from sr_object_detection_tpu_torch.graph import spec as S
    return S.ConvSpec(index=0, h=h, w=h, c=cin, inputs=h * h * cin,
                      out_h=h, out_w=h, out_c=cout, outputs=h * h * cout,
                      size=3, stride=1, pad=1, filters=cout,
                      activation="leaky", batch_normalize=True)


def train_case(seed, batch, h, cin, cout, device, *, flat=True):
    """Random inputs of the training pair's kernels (kernels/
    phase_train.py) as torch tensors on ``device``: x (B,h,h,Cin) bf16,
    w_hwio (3,3,Cin,Cout) bf16, shift/scales/biases (Cout,) f32 with one
    negative scale (channel 1) and, with ``flat``, one all-zero weight
    channel (the last: every tap equal, variance 0), the pooled
    cotangent dp bf16."""
    import torch
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.3, (3, 3, cin, cout)).astype(np.float32)
    if flat:
        w[..., -1] = 0
    scales = rng.uniform(0.6, 1.4, cout).astype(np.float32)
    scales[1] = -0.8
    arrays = dict(
        x=rng.uniform(0, 1, (batch, h, h, cin)).astype(np.float32), w=w,
        shift=rng.normal(0, 0.1, cout).astype(np.float32), scales=scales,
        biases=rng.normal(0, 0.2, cout).astype(np.float32),
        dp=rng.normal(0, 1, (batch, h // 2, h // 2, cout)).astype(
            np.float32))
    t = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    for k in ("x", "w", "dp"):
        t[k] = t[k].to(torch.bfloat16)
    return t


def batch_chunks(b, chunk=None):
    """Slices of a batch of ``b`` images, ``chunk`` images each (one slice
    when None): the plain versions of the kernels at yolov2-608's B=128
    hold several float32 copies of a full-resolution conv output, so the
    card-side checks run them a chunk of images at a time."""
    chunk = chunk or b
    return [slice(i, min(i + chunk, b)) for i in range(0, b, chunk)]


def _bf16_key(t):
    """A bf16 tensor's values as int32 keys whose differences count bf16
    ulps (the torch form of :func:`bf16_ulps`'s ordering)."""
    import torch
    u = t.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
    mag = u & 0x7FFF
    return torch.where(u >> 15 == 1, -mag, mag)


def _bf16_ulp_t(v):
    """:func:`_bf16_ulp` on a float32 tensor, on its device."""
    import torch
    _, e = torch.frexp(v.abs().clamp_min(np.finfo(np.float32).tiny))
    return torch.ldexp(torch.ones_like(v), e - 8)


def check_fwdstats(PT, x, w, shift, scales, chunk=None):
    """fwdstats against its plain version on the same inputs: Z within one
    bf16 ulp (as :func:`assert_bf16_close`), the argmax equal wherever
    the two extreme taps are more than an ulp apart, the sums at 1e-4 of
    their largest magnitude. The plain version runs ``chunk`` images at a
    time (its sums added over the chunks); the comparisons run on the
    tensors' device. Returns (max |Z error|, the plain version's Z,
    argmax and sums)."""
    import torch
    import torch.nn.functional as F
    z, am, st = PT.fwdstats(x, w, shift, scales)
    zps, amps, stp, err = [], [], 0, 0.0
    for s in batch_chunks(x.shape[0], chunk):
        zp, amp, stc = PT.fwdstats_plain(x[s], w, shift, scales)
        diff = (z[s].float() - zp.float()).abs()
        bad = ((_bf16_key(z[s]) - _bf16_key(zp)).abs() > 1) & (diff > 1e-5)
        assert not bad.any(), (f"{int(bad.sum())} of {bad.numel()} Z "
                               f"values differ by more than one bf16 ulp")
        err = max(err, diff.max().item())
        del diff, bad
        y = F.conv2d(x[s].permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                     padding=1).float()
        b, c, h, wd = y.shape
        taps = y.reshape(b, c, h // 2, 2, wd // 2, 2).permute(
            0, 2, 4, 1, 3, 5).reshape(b, h // 2, wd // 2, c, 4)
        del y
        taps = torch.where(scales.reshape(-1, 1) > 0, taps, -taps)
        top2 = taps.topk(2, dim=-1).values
        del taps
        sep = (top2[..., 0] - top2[..., 1]) > _bf16_ulp_t(top2[..., 0])
        same = am[s] == amp
        assert same[sep].all(), f"{int((~same[sep]).sum())} argmax differ"
        del top2, sep, same
        zps.append(zp)
        amps.append(amp)
        stp = stp + stc
    rel = ((st - stp).abs().max(dim=1).values
           / stp.abs().max(dim=1).values.clamp_min(1e-30)).max().item()
    assert rel <= 1e-4, rel
    return err, torch.cat(zps), torch.cat(amps), stp


def check_train_kernels(PT, case, chunk=None):
    """The three training kernels against their plain versions on the
    same inputs: fwdstats as :func:`check_fwdstats`; apply equal bit for
    bit; every bwdg reduction at 1e-3 of its largest magnitude. The
    plain versions run ``chunk`` images at a time (bwdg's reductions
    added over the chunks). Returns the max absolute error of each
    kernel."""
    import torch
    x, w, dp = case["x"], case["w"], case["dp"]
    shift, scales, biases = case["shift"], case["scales"], case["biases"]
    errs = {}
    errs["fwdstats"], zp, amp, stp = check_fwdstats(PT, x, w, shift, scales,
                                                    chunk)
    n = x.shape[0] * x.shape[1] * x.shape[2]
    mean, _, inv = PT._batch_stats(stp, shift, n)
    a = PT.apply(zp, mean, inv, scales, biases)
    for s in batch_chunks(x.shape[0], chunk):
        assert torch.equal(a[s], PT.apply_plain(zp[s], mean, inv, scales,
                                                biases))
    del a
    errs["apply"] = 0.0
    got = PT.bwdg(x, dp, zp, amp, mean, inv, scales, biases)
    want = None
    for s in batch_chunks(x.shape[0], chunk):
        part = PT.bwdg_plain(x[s], dp[s], zp[s], amp[s], mean, inv, scales,
                             biases)
        want = part if want is None else [a + b for a, b in zip(want, part)]
    errs["bwdg"] = 0.0
    for name, g, wv in zip(("S", "A", "D", "G"), got, want):
        err = (g - wv).abs().max().item()
        assert err <= 1e-3 * wv.abs().max().item(), (name, err)
        errs["bwdg"] = max(errs["bwdg"], err)
    return errs


def same_route(PT, C, spec, x, p, dx=False):
    """Where the fused pair and the unfused chain route a pooled pixel's
    gradient to the same tap: (B, H/2, W/2, Cout) bool. The pair takes
    the first tap attaining the raw bf16 conv extreme in the direction
    of the channel's BN slope (the JAX kernel's rule), the chain the
    first maximum of its bf16 output after BN, bias and leaky, whose
    roundings can tie taps that the raw values keep apart (ROADMAP queue
    3, item 4). With ``dx`` the pair is the chain's second pair, whose
    red/dy kernels take the chain's rule on their own recomputed conv;
    its routing is read off the dy kernel (with a unit cotangent and
    c1 = 1, c2 = c3 = 0 the routed tap holds the window's one nonzero
    dy: 1 where the pre-activation is positive, the bf16 leaky slope
    where not), and a window also counts as apart where the two leaky
    signs at the routed tap differ (a conv output one ulp apart next to
    z = 0 moves dz by 0.9 of the cotangent there). x NHWC; p the layer's
    params (OIHW weights)."""
    import torch
    with torch.no_grad():
        xb = x.to(torch.bfloat16)
        w_hwio = p["weights"].permute(2, 3, 1, 0).to(
            torch.bfloat16).contiguous()
        _, am, st = PT.fwdstats(xb, w_hwio, p["rolling_mean"], p["scales"])
        y, _ = C.conv_block_train(x.permute(0, 3, 1, 2), p, spec,
                                  compute_dtype=torch.bfloat16)
        b, c, h, w = y.shape
        taps = y.reshape(b, c, h // 2, 2, w // 2, 2).permute(
            0, 2, 4, 1, 3, 5).reshape(b, h // 2, w // 2, c, 4)
        first = (taps == taps.amax(-1, keepdim=True)).to(
            torch.uint8).argmax(-1)
        if dx:
            mean, _, inv = PT._batch_stats(st, p["rolling_mean"], b * h * w)
            one, zero = torch.ones_like(mean), torch.zeros_like(mean)
            unit = torch.ones_like(am, dtype=torch.bfloat16)
            dyv, _ = PT.dy(xb, w_hwio, unit, mean, inv, p["scales"],
                           p["biases"], one, zero, zero)
            routed = dyv.reshape(b, h // 2, 2, w // 2, 2, c).permute(
                0, 1, 3, 5, 2, 4).reshape(b, h // 2, w // 2, c, 4)
            am = (routed != 0).to(torch.uint8).argmax(-1)
            pos = routed.gather(-1, am[..., None].long())[..., 0] == 1
            cpos = taps.gather(-1, first[..., None].long())[..., 0] > 0
            return (first == am.long()) & (pos == cpos)
    return first == am.long()


def check_pair_gradient(PT, C, P, spec, case, tol=1e-3, dx=None):
    """phase_train_block's gradient against the unfused chain's
    (conv_block_train + maxpool) on the same inputs. The cotangent is
    zeroed where the two tie rules pick different taps
    (:func:`same_route`; a misrouted window moves a whole x(x)dz term,
    which on a random cotangent is a few per cent of the weight gradient
    from well under 1% of the windows).

    The weight gradient is held at ``tol`` of its largest magnitude to a
    float64 evaluation of the chain's own formulas (its bf16 conv output,
    batch statistics and BN-output cotangent, darknet's BN backward, the
    conv's weight gradient): the bf16 chain rounds the conv's input
    cotangent and its weight gradient to bf16, and over a large batch
    those roundings add up to several per cent (its distance is
    returned). The scale and bias gradients, float32 sums on both sides,
    are held to the chain's at ``tol``. Channels of zero variance are
    ill-conditioned here (1/(sqrt(var) + eps) of a var that is a
    cancellation of float32 sums): give a case without one.

    ``dx`` (a tolerance) checks phase_train_dx_block, the chain's second
    pair, instead, and its input gradient too. That pair materializes the
    conv output's cotangent dy in bf16 (the JAX kernel's mode "dy") and
    takes both its weight and its input gradient from it; dy's rounding
    moves the weight gradient by up to a few per cent of its largest
    magnitude (the BN backward leaves it a sum with heavy cancellation),
    so the float64 evaluation rounds dy to bf16 where the pair does. The
    input gradient, bf16 itself, is held at ``dx`` of its largest
    magnitude.

    Returns {"fused": the pair's largest relative difference, "chain":
    the bf16 chain's weight-gradient distance from the float64
    evaluation, "masked": the share of windows zeroed, and with ``dx``
    "dx": the input gradient's relative difference}."""
    import torch
    import torch.nn.functional as F
    from sr_object_detection_tpu_torch.ops.activations import leaky_bf16

    def params():
        p = {"weights": case["w"].float().permute(3, 2, 0, 1).contiguous(),
             "scales": case["scales"].clone(),
             "biases": case["biases"].clone(),
             "rolling_mean": case["shift"].clone(),
             "rolling_variance": torch.ones_like(case["shift"])}
        for k in ("weights", "scales", "biases"):
            p[k].requires_grad_(True)
        return p

    x = case["x"]
    keep = same_route(PT, C, spec, x, params(), dx=dx is not None)
    dp = case["dp"].float() * keep
    block = PT.phase_train_block if dx is None else PT.phase_train_dx_block

    def grads(fn):
        p = params()
        xr = x.detach().clone().requires_grad_(dx is not None)
        (fn(xr, p).float() * dp).sum().backward()
        out = {k: p[k].grad for k in ("weights", "scales", "biases")}
        out["x"] = xr.grad
        return out

    def chain(v, p):
        y, _ = C.conv_block_train(v.permute(0, 3, 1, 2), p, spec,
                                  compute_dtype=torch.bfloat16)
        return P.maxpool(y, size=2, stride=2, pad=0).permute(0, 2, 3, 1)

    gf = grads(lambda v, p: block(v, p, spec)[0])
    gc = grads(chain)
    out = {"masked": 1.0 - keep.float().mean().item(), "fused": 0.0}
    for k in ("scales", "biases"):
        rel = ((gf[k] - gc[k]).abs().max()
               / gc[k].abs().max().clamp_min(1e-3)).item()
        assert rel <= tol, (k, rel)
        out["fused"] = max(out["fused"], rel)
    del gc["scales"], gc["biases"], gc["x"]

    # the chain's formulas in float64 on its own intermediates
    p = params()
    xb = x.permute(0, 3, 1, 2)
    y = F.conv2d(xb, p["weights"].to(torch.bfloat16), padding=1)
    ybn, mean, var = C._BNCoreFast.apply(y, p["scales"], p["rolling_mean"])
    ybn.retain_grad()
    z = P.maxpool(leaky_bf16(C.bias_add(ybn, p["biases"])), size=2,
                  stride=2, pad=0)
    (z.permute(0, 2, 3, 1).float() * dp).sum().backward()
    with torch.no_grad():
        d = ybn.grad.double() * p["scales"].double().reshape(1, -1, 1, 1)
        del ybn, z
        n = d.shape[0] * d.shape[2] * d.shape[3]
        var, ch = var.double(), (lambda t: t.reshape(1, -1, 1, 1))
        xm = y.double() - ch(mean.double())
        del y
        mean_delta = d.sum(dim=(0, 2, 3)) * -(var + 1e-5).rsqrt()
        var_delta = ((d * xm).sum(dim=(0, 2, 3)) * -0.5
                     * (var + 1e-5) ** -1.5)
        d = (d / ch(var.sqrt() + 1e-5) + ch(var_delta) * 2 * xm / n
             + ch(mean_delta) / n)
        del xm
        if dx is not None:
            d = d.to(torch.bfloat16).double()     # dy is bf16 in the pair
        ref = torch.nn.grad.conv2d_weight(xb.double(), p["weights"].shape,
                                          d, padding=1)
        scale = ref.abs().max()
        rel = ((gf["weights"].double() - ref).abs().max() / scale).item()
        assert rel <= tol, ("weights", rel)
        out["fused"] = max(out["fused"], rel)
        out["chain"] = ((gc["weights"].double() - ref).abs().max()
                        / scale).item()
        del ref
        if dx is not None:
            wb = p["weights"].detach().to(torch.bfloat16).double()
            ref = F.conv_transpose2d(d, wb, padding=1).permute(0, 2, 3, 1)
            out["dx"] = ((gf["x"].double() - ref).abs().max()
                         / ref.abs().max()).item()
            assert out["dx"] <= dx, ("x", out["dx"])
    return out


def chain_case(seed, batch, h, cin, cout, device):
    """Random inputs of the chain's second-pair kernels (red, dy, dgrad) as
    torch tensors made on ``device`` from a seed: x (B,h,h,Cin) and w_hwio
    (3,3,Cin,Cout) bf16 on a coarse grid (x in eighths of [0, 1], w in
    sixteenths), where the bf16 conv's float32 sums are exact in any
    order, so a kernel and its plain version recompute the same y and
    route every window alike; the batch statistics of that conv, scales
    with one negative, biases, c1..c3 of the BN backward's size, the
    pooled cotangent dp and a full-resolution cotangent d for dgrad,
    bf16."""
    import torch
    import sr_object_detection_tpu_torch.kernels.phase_train as PT
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    bf = torch.bfloat16
    t = {"x": (rand(batch, h, h, cin) * 8).round().div(8).to(bf),
         "w": (randn(3, 3, cin, cout) * 0.3 * 16).round().div(16).to(bf),
         "dp": randn(batch, h // 2, h // 2, cout).to(bf),
         "d": randn(batch, h, h, cout).to(bf),
         "scales": 0.6 + 0.8 * rand(cout), "biases": 0.2 * randn(cout),
         "c1": 0.5 + rand(cout), "c2": 1e-3 * randn(cout),
         "c3": 1e-3 * randn(cout)}
    t["scales"][1] = -0.8
    zero = torch.zeros(cout, device=device)
    _, _, st = PT.fwdstats_plain(t["x"], t["w"], zero, t["scales"])
    t["mean"], _, t["inv"] = PT._batch_stats(st, zero, batch * h * h)
    return t


def dgrad_case(seed, b, h, w, cin, cout, device):
    """Random inputs of the dgrad kernel made on ``device`` from a seed:
    the cotangent d (b,h,w,Cout) bf16 and w_hwio (3,3,Cin,Cout) bf16 in
    sixteenths, as :func:`chain_case` makes them, at any h and w."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    bf = torch.bfloat16
    return {"d": torch.randn((b, h, w, cout), generator=g,
                             device=device).to(bf),
            "w": (torch.randn((3, 3, cin, cout), generator=g, device=device)
                  * 0.3 * 16).round().div(16).to(bf)}


def check_chain_kernels(PT, case):
    """red, dy (+ dw) and dgrad against their plain versions on the same
    inputs (:func:`chain_case`): red's sums at 1e-4 of their largest
    magnitude and dy's weight gradient at 1e-3 (float32 sums in other
    orders; dw is a sum with heavy cancellation, as bwdg's reductions,
    which are held at 1e-3), dy bit-equal, dgrad within one bf16 ulp
    (float32 sums in other orders, rounded to bf16). Returns the max
    absolute error of each kernel."""
    import torch
    args = [case[k] for k in ("x", "w", "dp", "mean", "inv", "scales",
                              "biases")]
    c123 = [case[k] for k in ("c1", "c2", "c3")]
    errs = {}
    s, sp = PT.red(*args), PT.red_plain(*args)
    rel = ((s - sp).abs().max(dim=1).values
           / sp.abs().max(dim=1).values.clamp_min(1e-30)).max().item()
    assert rel <= 1e-4, ("red", rel)
    errs["red"] = (s - sp).abs().max().item()
    (dyk, dwk), (dyp, dwp) = PT.dy(*args, *c123), PT.dy_plain(*args, *c123)
    assert torch.equal(dyk, dyp), ("dy", (dyk != dyp).sum().item())
    err = (dwk - dwp).abs().max().item()
    assert err <= 1e-3 * dwp.abs().max().item(), ("dw", err)
    errs["dy"] = err
    dx, dxp = PT.dgrad(case["d"], case["w"]), PT.dgrad_plain(case["d"],
                                                              case["w"])
    assert_bf16_close(dx.float().cpu().numpy(), dxp.float().cpu().numpy())
    errs["dgrad"] = (dx.float() - dxp.float()).abs().max().item()
    return errs


def check_y_consistency(PT, x, w, scales):
    """fwdstats' forward and dy's recompute hold one y, bit for bit, on any
    inputs: dy with mean 0, inv 1, c1 0, c2 1 and c3 0 writes dy =
    bf16(dz * 0 + (y - 0) * 1 + 0) = y, the bf16 conv output at full
    resolution; fwdstats' Z and argmax must then equal the pooled extreme
    of that y in the direction of the channel's scale and the first tap
    attaining it. x (B,H,W,Cin<=16), w (3,3,Cin,Cout) bf16, scales
    (Cout,). Returns the number of windows compared."""
    import torch
    cout = w.shape[3]
    b, h, wd, _ = x.shape
    zero = torch.zeros(cout, device=x.device)
    one = torch.ones(cout, device=x.device)
    z, am, _ = PT.fwdstats(x, w, zero, scales)
    dp = torch.zeros((b, h // 2, wd // 2, cout), dtype=torch.bfloat16,
                     device=x.device)
    y, _ = PT.dy(x, w, dp, zero, one, scales, zero, zero, one, zero)
    taps = y.reshape(b, h // 2, 2, wd // 2, 2, cout).permute(
        0, 1, 3, 5, 2, 4).reshape(b, h // 2, wd // 2, cout, 4)
    del y
    want = torch.where(scales > 0, taps.amax(-1), taps.amin(-1))
    first = (taps == want[..., None]).to(torch.uint8).argmax(-1)
    assert torch.equal(z, want), (z != want).sum().item()
    assert torch.equal(am, first.to(torch.int8)), (
        (am != first.to(torch.int8)).sum().item())
    return z.numel()


def stem_case(seed, batch, h, c, device, channels_last=True):
    """Random inputs of the fused stem's kernels (kernels/fused_stem.py)
    made on ``device`` from a seed: y (B,C,h,h) bf16 (channels-last in
    memory, as the port's conv writes it on the card, or NCHW) with exact
    ties in some windows, its batch statistics, scales with one negative,
    biases, c1..c3, and the pooled cotangent dp (B,C,h/2,h/2) bf16."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    fmt = (torch.channels_last if channels_last
           else torch.contiguous_format)
    y = 1.5 * randn(batch, c, h, h)
    y[:, :, 0:2, 0:2] = 0.75
    y[:, :, -2:, -1] = y[:, :, -2:, -2]
    t = {"y": y.to(torch.bfloat16).contiguous(memory_format=fmt),
         "dp": randn(batch, c, h // 2, h // 2).to(torch.bfloat16).contiguous(
             memory_format=fmt),
         "scales": 0.5 + rand(c), "biases": rand(c) - 0.5,
         "c1": 0.5 + rand(c), "c2": 1e-3 * randn(c), "c3": 1e-3 * randn(c)}
    t["scales"][1] = -0.8
    yf = t["y"].float()
    t["mean"] = yf.mean(dim=(0, 2, 3))
    t["inv"] = 1.0 / (yf.var(dim=(0, 2, 3)).sqrt() + 1e-6)
    return t


def misaligned(t):
    """A dense channels-last copy of the 4-D tensor t whose data pointer
    lies one element past a 16-byte boundary (2 bytes for bf16): a view
    with a storage offset, as a caller's slice of a larger buffer."""
    import torch
    b, c, h, w = t.shape
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    size = t.element_size()
    k = next(k for k in range(16)
             if (buf.data_ptr() + k * size) % 16 == size)
    v = buf[k:k + t.numel()].view(b, h, w, c).permute(0, 3, 1, 2)
    v.copy_(t)
    return v


def images_past_2g(t):
    """The first image of a (B, ...) tensor whose bytes begin at or past
    2^31 bytes from its start (B when none does): where a 32-bit byte
    offset would wrap."""
    per = t[0].numel() * t.element_size()
    return min(t.shape[0], -(-(1 << 31) // per))


def check_fused_stem_kernels(FS, case, chunk=None):
    """F2, B1 and B2 against their plain versions on the same inputs
    (:func:`stem_case`): F2 and B2 (at fixed constants) bit-equal, B1's
    sums at 1e-4 of their largest magnitude (float32 sums in other
    orders) and bit-equal across two launches (fixed-order sums). The
    kernels run on the whole batch; the plain versions ``chunk`` images
    at a time (B1's sums added over the chunks), so at yolov2-608's
    layer 0 every image is compared, those past 2^31 bytes of y
    (:func:`images_past_2g`) too, with the batch's own statistics.
    Returns the max absolute error of each kernel."""
    import torch
    y, dp = case["y"], case["dp"]
    k4 = [case[k] for k in ("mean", "inv", "scales", "biases")]
    c123 = [case[k] for k in ("c1", "c2", "c3")]
    chunks = batch_chunks(y.shape[0], chunk)
    p = FS.f2(y, *k4)
    for s in chunks:
        pp = FS.f2_plain(y[s], *k4)
        assert torch.equal(p[s], pp), ("f2", s, (p[s] != pp).sum().item())
    del p, pp
    s1 = FS.b1(y, dp, *k4)
    sp = sum(FS.b1_plain(y[s], dp[s], *k4) for s in chunks)
    rel = ((s1 - sp).abs().max(dim=0).values
           / sp.abs().max(dim=0).values.clamp_min(1e-30)).max().item()
    assert rel <= 1e-4, ("b1", rel)
    assert torch.equal(s1, FS.b1(y, dp, *k4)), "b1 differs across launches"
    d = FS.b2(y, dp, *k4, *c123)
    for s in chunks:
        dpl = FS.b2_plain(y[s], dp[s], *k4, *c123)
        assert torch.equal(d[s], dpl), ("b2", s, (d[s] != dpl).sum().item())
    return {"f2": 0.0, "b1": (s1 - sp).abs().max().item(), "b2": 0.0}


def check_fused_op(FS, C, P, case):
    """fused_bn_leaky_pool against the port's unfused bf16 chain from the
    same conv output y (:func:`stem_case`; the BN core, the bias, the bf16
    leaky and the maxpool), the cotangent dp on the pooled output: the
    pooled output and the batch statistics bit-equal (the same statistics
    code), the scale and bias gradients (float32 sums on both sides) at
    1e-3 of their largest magnitude, the cotangent of y within one bf16
    ulp (darknet's BN backward folded to c1..c3 rounds otherwise than the
    chain's expression). Returns the largest relative difference of the
    scale and bias gradients and the largest |difference| of y's."""
    import torch
    from sr_object_detection_tpu_torch.ops.activations import leaky_bf16

    def run(fn):
        y = case["y"].detach().clone().requires_grad_(True)
        s, b = (case[k].clone().requires_grad_(True)
                for k in ("scales", "biases"))
        out, mean, var = fn(y, s, b)
        (out.float() * case["dp"].float()).sum().backward()
        return out, mean, var, y.grad, s.grad, b.grad

    def chain(y, s, b):
        ybn, mean, var = C._BNCoreFast.apply(y, s, case["mean"])
        z = leaky_bf16(C.bias_add(ybn, b))
        return P.maxpool(z, size=2, stride=2, pad=0), mean, var

    f = run(lambda y, s, b: FS.fused_bn_leaky_pool(y, s, b, case["mean"]))
    c = run(chain)
    for a, b in zip(f[:3], c[:3]):
        assert torch.equal(a, b)
    rel = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-3)).item()
              for a, b in zip(f[4:], c[4:]))
    assert rel <= 1e-3, rel
    assert_bf16_close(f[3].float().cpu().numpy(), c[3].float().cpu().numpy())
    return rel, (f[3].float() - c[3].float()).abs().max().item()


# C-oracle training goldens and the weight tolerance each is held to
# (tests/test_train_parity.py:72-93); costs at 1e-3
TRAIN_GOLDENS = {"train_region_nobn": 1e-4, "train_region_bn": 2e-4,
                 "train_region_classfix2": 1e-4,
                 "train_region_bn_subdiv": 2e-4}


def check_train_golden(name, device):
    """The port's float32 Trainer against a C-oracle training golden on
    ``device``: the weights after N SGD steps at the golden's tolerance,
    the cost trajectory at 1e-3. Returns the max relative cost error."""
    import pathlib
    import tempfile
    from sr_object_detection_tpu_torch.config import parse_cfg_text
    from sr_object_detection_tpu_torch.graph import spec as S
    from sr_object_detection_tpu_torch.io.convert import params_to_numpy
    from sr_object_detection_tpu_torch.io.weights import (init_params,
                                                          load_weights)
    from sr_object_detection_tpu_torch.train.trainer import Trainer
    wtol = TRAIN_GOLDENS[name]
    g = np.load(pathlib.Path(__file__).parent / "golden" / f"{name}.npz")
    net = S.build_network_spec(parse_cfg_text(bytes(g["cfg"]).decode()))
    steps = int(g["steps"])
    x = np.transpose(g["x_chw"], (0, 2, 3, 1)).copy()
    truth = g["truth"].astype(np.float32)
    trainer = Trainer(net, params=init_params(net, seed=int(g["seed"])),
                      device=device)
    costs = [float(trainer.step(x, truth)["loss"]) for _ in range(steps)]
    with tempfile.NamedTemporaryFile(suffix=".weights") as f:
        f.write(bytes(g["weights_after"]))
        f.flush()
        ref, seen = load_weights(net, f.name)
    assert seen == int(trainer.state.seen) == \
        steps * net.net.batch * net.net.subdivisions
    mine = params_to_numpy(net, trainer.state.params)
    for i in range(len(net.layers)):
        for k, want in ref[i].items():
            np.testing.assert_allclose(mine[i][k], want, rtol=wtol,
                                       atol=wtol,
                                       err_msg=f"{name}: layer {i} {k}")
    want = g["costs"].reshape(steps, -1).sum(1)
    np.testing.assert_allclose(costs, want, rtol=1e-3)
    return float(np.max(np.abs(np.asarray(costs) - want) / np.abs(want)))


def assert_stem_link_close(got, ref, z):
    """One link of the bf16 phase stem against the plain engine's conv +
    bias + leaky + pool: within one bf16 ulp, except where the two conv
    sums (the kernel's and cuDNN's, in other orders) round to bf16 values
    one ulp of the conv output apart. Adding the bias and rounding once
    more then leaves the results at most one ulp of the pooled raw conv
    value z plus one ulp of the result apart, which where the bias
    cancels part of z is several ulps of the result: such an element is
    held to that bound. Arrays are float32 NHWC."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    bound = (_bf16_ulp(np.abs(np.asarray(z, np.float32)))
             + _bf16_ulp(np.maximum(np.abs(got), np.abs(ref))))
    bad = (bf16_ulps(got, ref) > 1) & (np.abs(got - ref) > bound)
    assert not bad.any(), (f"{bad.sum()} of {bad.size} elements beyond one "
                           f"bf16 ulp: got {got[bad][:8]}, want {ref[bad][:8]}")
    return float(np.abs(got - ref).max())


def assert_fwd_close(got, ref, z, slope=0.10009765625):
    """Two implementations of the bf16 serving stem's pair (kernel 4's
    mode fwd: v = bf16(y), zb = bf16(v + b), out = zb > 0 ? zb :
    bf16(slope * zb), then the window's maximum) whose float32 conv sums
    round to bf16 values at most one ulp of the pooled conv value z apart
    (ROADMAP queue 3, item 10). The rounding of v + b can then land one
    ulp of zb apart, and the leaky scales that by the slope and rounds
    once more. Where both outputs are positive (out = zb) the bound is
    assert_stem_link_close's, ulp(z) + ulp(out); elsewhere |got - ref| <=
    s * (ulp(z) + ulp(zb)) + ulp(out), with s the slope and zb = out / s
    where both are negative, s = 1 and zb = out across the sign change.
    Arrays are float32 NHWC; returns the max absolute difference."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    z = np.asarray(z, np.float32)
    out = np.maximum(np.abs(got), np.abs(ref))
    s = np.where((got > 0) | (ref > 0), np.float32(1), np.float32(slope))
    bound = np.where(
        (got > 0) & (ref > 0), _bf16_ulp(np.abs(z)) + _bf16_ulp(out),
        s * (_bf16_ulp(np.abs(z)) + _bf16_ulp(out / s)) + _bf16_ulp(out))
    bad = (bf16_ulps(got, ref) > 1) & (np.abs(got - ref) > bound)
    assert not bad.any(), (f"{bad.sum()} of {bad.size} elements beyond the "
                           f"fwd roundings' bound: got {got[bad][:8]}, want "
                           f"{ref[bad][:8]}")
    return float(np.abs(got - ref).max())
