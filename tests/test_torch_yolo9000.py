"""yolo9000's serving paths in the port against the JAX package's, on the
CPU: a narrow net of yolo9000's topology (the darknet19 trunk's kinds at
small widths, 3 anchors, the 28,269-channel head over a seeded 9,418-node
WordTree with 2,429 sibling groups, and an 80-entry class map drawn from
its nodes) at 64x64.

* ``align_region_head``: the rewritten spec and params equal to JAX's,
  and ``io.convert.params_to_torch`` carries JAX's aligned (28,800
  channel HWIO) and flat head params across;
* the pre-split heads (the port's counterparts of tests/test_presplit.py's
  tree tests): ``presplit`` and ``"flat"`` against the flat head in float32
  and in int8 (with and without ``quantize_head``), and against the JAX
  package's at its gates;
* the bf16 ``ThroughputEngine`` with ``presplit="flat"`` and the bf16
  ``LatencyEngine`` on the tree head against JAX's;
* ``Detector`` with and without the map and with ``presplit``, ``cli
  detect -presplit``, and the pipe server on the tree head (no map: the
  gate is objectness > thresh).
"""

import dataclasses
import pathlib
import struct
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sr_object_detection_tpu.infer.engine as JE
import sr_object_detection_tpu.infer.quant as JQ
from sr_object_detection_tpu.apps import cli as JCLI
from sr_object_detection_tpu.graph.spec import parse_network_cfg as j_parse
from sr_object_detection_tpu.infer.detector import Detector as JDetector
from sr_object_detection_tpu.io.weights import init_params as j_init
from sr_object_detection_tpu.io.weights import save_weights as j_save
import sr_object_detection_tpu_torch.infer.engine as TE
import sr_object_detection_tpu_torch.infer.quant as TQ
from sr_object_detection_tpu_torch.apps import cli as TCLI
from sr_object_detection_tpu_torch.graph.compiler import Network
from sr_object_detection_tpu_torch.graph.spec import parse_network_cfg
from sr_object_detection_tpu_torch.infer.detector import Detector
from sr_object_detection_tpu_torch.io.convert import params_to_numpy, \
    params_to_torch
from sr_object_detection_tpu_torch.models import zoo as TZ
from torch_parity import (assert_bf16_close, random_bn, seeded_class_map,
                          seeded_tree_lines)

REPO = pathlib.Path(__file__).resolve().parent.parent
SIZE = 64                  # a 2x2 grid, 12 boxes
CLASSES, GROUPS = 9418, 2429


def _cfg_text(tree, cmap):
    """yolo9000's topology at narrow widths: conv / maxpool pairs down to
    a 2x2 grid, 1x1 bottlenecks, and the real head."""
    b = TZ.CfgBuilder()
    b.net(batch=1, subdivisions=1, width=SIZE, height=SIZE, channels=3,
          momentum=0.9, decay=0.0005, learning_rate=0.00001,
          max_batches=100, policy="constant")
    b.conv(8)
    b.maxpool()
    b.conv(16)
    b.maxpool()
    b.conv(32)
    b.conv(16, size=1, pad=1)
    b.conv(32)
    b.maxpool()
    b.conv(32)
    b.maxpool()
    b.conv(64)
    b.conv(32, size=1, pad=1)
    b.conv(64)
    b.maxpool()
    b.conv(64)
    b.conv(3 * (CLASSES + 5), size=1, bn=False, act="linear")
    b.section("region", anchors=TZ.YOLO9000_ANCHORS, bias_match=1,
              classes=CLASSES, coords=4, num=3, softmax=1, jitter=.2,
              rescore=1, object_scale=5, noobject_scale=1, class_scale=1,
              coord_scale=1, thresh=.6, tree=tree, map=cmap)
    return b.text()


@pytest.fixture(scope="module")
def net9k(tmp_path_factory):
    """(cfg path, weights path, map path, numpy params, JAX spec, port
    spec): the seeded tree and map, random weights with random BN and a
    scaled head, written by the JAX package."""
    d = tmp_path_factory.mktemp("yolo9000")
    tree = d / "9k.tree"
    tree.write_text("\n".join(seeded_tree_lines(CLASSES, GROUPS, 0)) + "\n")
    cmap = d / "coco9k.map"
    cmap.write_text("\n".join(map(str, seeded_class_map(CLASSES, 80, 0)))
                    + "\n")
    cfg = d / "yolo9000-narrow.cfg"
    cfg.write_text(_cfg_text(str(tree), str(cmap)))
    spec_j, spec_t = j_parse(str(cfg)), parse_network_cfg(str(cfg))
    params = random_bn(j_init(spec_j, seed=0), 1, head_gain=6.0)
    weights = d / "w.weights"
    j_save(spec_j, params, str(weights))
    return str(cfg), str(weights), str(cmap), params, spec_j, spec_t


def _x(seed, b=2):
    return np.random.RandomState(seed).uniform(
        0, 1, (b, SIZE, SIZE, 3)).astype(np.float32)


def _asdict(spec):
    return [(type(l).__name__, dataclasses.asdict(l)) for l in spec.layers]


# ------------------------------------------------- the head rewrite ---


def test_align_region_head_matches_jax(net9k):
    """The rewrite of the folded spec and params (tests/test_infer.py's
    align_region_head case): the same spec, head_block 128 + 9,472, and
    params equal to JAX's element for element; the float32 network on the
    aligned head within 1e-6 of the flat head, and within 1e-5 of the
    JAX engine's aligned float32 output."""
    _, _, _, params, spec_j, spec_t = net9k
    pj, fj = JE.fold_params_for_inference(spec_j, params, jnp.float32)
    fj, pj = JE.align_region_head(fj, pj)
    pt, ft = TE.fold_params_for_inference(
        spec_t, params_to_torch(spec_t, params, "cpu"), torch.float32)
    ft0, pt0 = ft, pt
    ft, pt = TE.align_region_head(ft, pt)
    assert ft.layers[-1].head_block == 128 + 9472
    assert ft.layers[-2].filters == 3 * (128 + 9472) == 28800
    assert _asdict(ft) == _asdict(fj)
    for a, b in zip(params_to_numpy(ft, pt), pj):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], np.asarray(b[k]))
    x = torch.from_numpy(_x(0))
    flat = Network(ft0, pt0)(x)[0]
    aligned = Network(ft, pt)(x)[0]
    assert flat.shape == aligned.shape == (2, 2 * 2 * 3 * (CLASSES + 5))
    np.testing.assert_allclose(aligned.numpy(), flat.numpy(), rtol=1e-6,
                               atol=1e-6)
    ej = JE.ThroughputEngine(spec_j, params, batch=2, dtype=jnp.float32,
                             align_head=True)
    ref = np.asarray(ej(jnp.asarray(_x(0))))
    np.testing.assert_allclose(aligned.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("aligned", [False, True])
def test_params_to_torch_carries_head_params(net9k, aligned):
    """JAX's folded params, flat (28,269 channels) or aligned (28,800),
    convert to the port's OIHW tensors of the same rewrite exactly, and
    back."""
    _, _, _, params, spec_j, spec_t = net9k
    pj, fj = JE.fold_params_for_inference(spec_j, params, jnp.float32)
    pt, ft = TE.fold_params_for_inference(
        spec_t, params_to_torch(spec_t, params, "cpu"), torch.float32)
    if aligned:
        fj, pj = JE.align_region_head(fj, pj)
        ft, pt = TE.align_region_head(ft, pt)
    pj = [{k: np.asarray(v) for k, v in p.items()} for p in pj]
    assert pj[-2]["weights"].shape == (1, 1, 64, 28800 if aligned
                                       else 28269)
    conv = params_to_torch(ft, pj, "cpu")
    for a, b in zip(conv, pt):
        for k in b:
            assert torch.equal(a[k], b[k]), k
    back = params_to_numpy(ft, conv)
    for a, b in zip(back, pj):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


# -------------------------------------------------- pre-split heads ---


def _reassemble(fields, cls):
    return np.concatenate([np.asarray(fields, np.float32),
                           np.asarray(cls, np.float32)], axis=-1)


def _slice_flat(cls_flat, region):
    blk = region.head_block
    cf = np.asarray(cls_flat, np.float32)
    return np.stack([cf[..., a * blk + 128:a * blk + 128 + region.classes]
                     for a in range(region.n)], axis=3)


def _float_nets(spec_t, params):
    """The port's float32 networks on the folded spec: flat head,
    presplit and presplit "flat"."""
    pt, ft = TE.fold_params_for_inference(
        spec_t, params_to_torch(spec_t, params, "cpu"), torch.float32)
    fa, pa = TE.align_region_head(ft, pt, min_classes=1)
    return (Network(ft, pt), Network(TE.presplit_spec(fa, True), pa),
            Network(TE.presplit_spec(fa, "flat"), pa))


def test_presplit_float32_matches_flat_and_jax(net9k):
    """tests/test_presplit.py's tree cases on the port: presplit against
    the flat head (2e-5), "flat" against presplit after the consumer
    slice (2e-5), and each against the JAX float32 engine's."""
    _, _, _, params, spec_j, spec_t = net9k
    flat, pre, fla = _float_nets(spec_t, params)
    x = _x(2)
    out = flat(torch.from_numpy(x))[0].numpy()
    f0, c0 = pre(torch.from_numpy(x))[0]
    f1, cf = fla(torch.from_numpy(x))[0]
    region = fla.spec.layers[-1]
    assert c0.shape == (2, 2, 2, 3, CLASSES)
    assert cf.shape == (2, 2, 2, 3 * region.head_block)
    got = _reassemble(f0, c0)
    np.testing.assert_allclose(got, out.reshape(got.shape), rtol=0,
                               atol=2e-5)
    np.testing.assert_array_equal(f1.numpy(), f0.numpy())
    np.testing.assert_allclose(_slice_flat(cf, region), c0.numpy(), rtol=0,
                               atol=2e-5)
    for mode, (fp, cp) in ((True, (f0, c0)), ("flat", (f1, cf))):
        ej = JE.ThroughputEngine(spec_j, params, batch=2,
                                 dtype=jnp.float32, presplit=mode)
        assert ej.presplit
        fj, cj = (np.asarray(t) for t in ej(jnp.asarray(x)))
        np.testing.assert_allclose(fp.numpy(), fj, rtol=0, atol=2e-5)
        if mode == "flat":
            cp, cj = _slice_flat(cp, region), _slice_flat(cj, region)
        np.testing.assert_allclose(np.asarray(cp), cj, rtol=0, atol=2e-5)


@pytest.fixture
def same_amax(net9k, monkeypatch):
    """Both packages calibrate to JAX's amax on the folded (flat) spec:
    the pre-split rewrite leaves every trunk amax as it is."""
    _, _, _, params, spec_j, _ = net9k
    calib = _x(9, b=2)
    pf, fspec = JQ.fold_params_for_inference(spec_j, params,
                                             dtype=jnp.float32)
    amax = JQ.calibrate_amax(fspec, pf, calib)
    monkeypatch.setattr(JQ, "calibrate_amax", lambda *a, **k: amax)
    monkeypatch.setattr(TQ, "calibrate_amax", lambda *a, **k: amax)
    return calib


@pytest.mark.parametrize("qhead", [False, True])
def test_presplit_int8_matches_flat_and_jax(net9k, same_amax, qhead):
    """The int8 program with the pre-split heads: presplit against the
    flat int8 head (2e-5), "flat" against presplit after the slice (2e-5,
    with ``quantize_head`` the full stack's head), each against JAX's
    int8 program (both calibrated to one amax): at 2e-5 with the int8
    head; with the bf16 head at tests/test_torch_engines.py's gates, raw
    box slots 2^-7 and objectness 2^-9, and the tree's class probs at
    2^-8: jitted on the CPU, XLA keeps the bf16 head conv's output in
    float32 (ROADMAP queue 3, item 5), and a bf16 step of a logit moves a
    sibling group's probs by up to a quarter of it."""
    _, _, _, params, spec_j, spec_t = net9k
    calib = same_amax
    x = _x(3)
    q = {mode: TQ.quantize_for_inference(spec_t, params, calib,
                                         device="cpu", presplit=mode,
                                         quantize_head=qhead)
         for mode in (False, True, "flat")}
    out = q[False].forward(x).numpy()
    f0, c0 = q[True].forward(x)
    f1, cf = q["flat"].forward(x)
    region = q["flat"].spec.layers[-1]
    got = _reassemble(f0, c0)
    np.testing.assert_allclose(got, out.reshape(got.shape), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(f1.numpy(), f0.numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(_slice_flat(cf, region), c0.numpy(), rtol=0,
                               atol=2e-5)
    for mode, (fp, cp) in ((True, (f0, c0)), ("flat", (f1, cf))):
        jq = JQ.quantize_for_inference(spec_j, params, calib, presplit=mode,
                                       quantize_head=qhead)
        run = jax.jit(jq.forward)
        fj, cj = (np.asarray(t) for t in run(jq.qparams, jnp.asarray(x)))
        raw_atol, obj_atol, cls_atol = ((2e-5, 2e-5, 2e-5) if qhead
                                        else (2 ** -7, 2 ** -9, 2 ** -8))
        np.testing.assert_allclose(fp.numpy()[..., :4], fj[..., :4], rtol=0,
                                   atol=raw_atol)
        np.testing.assert_allclose(fp.numpy()[..., 4], fj[..., 4], rtol=0,
                                   atol=obj_atol)
        if mode == "flat":
            cp, cj = _slice_flat(cp, region), _slice_flat(cj, region)
        np.testing.assert_allclose(np.asarray(cp), cj, rtol=0,
                                   atol=cls_atol)
    assert TQ.QuantizedThroughputEngine(
        spec_t, params, batch=2, calib_x=calib, device="cpu",
        presplit="flat").presplit


def test_bf16_engines_on_the_tree_head_match_jax(net9k):
    """The bf16 ThroughputEngine with presplit="flat": its class lanes
    within one bf16 ulp of a float64 evaluation of the source's roundings
    (tests/test_torch_tree.py) on its own head logits, and against the
    JAX engine fields within 2^-7 and class lanes within 2^-6 (jitted on
    the CPU, XLA keeps the bf16 x - max in float32, ROADMAP queue 3, item
    5; the op-by-op JAX grouped softmax is held to one ulp in
    tests/test_torch_tree.py). Its checksum benchmark on the (fields,
    cls) pair, and the bf16 LatencyEngine on the tree head: its top-k
    candidates' best probs within 2^-7 of the JAX engine's, in the same
    order where the probs differ by more."""
    from sr_object_detection_tpu_torch.ops import boxes as TB
    from test_torch_tree import _bf16, _bf16_softmax_f64
    _, _, _, params, spec_j, spec_t = net9k
    x = _x(4)
    et = TE.ThroughputEngine(spec_t, params, batch=2, device="cpu",
                             presplit="flat")
    ej = JE.ThroughputEngine(spec_j, params, batch=2, dtype=jnp.bfloat16,
                             presplit="flat")
    assert et.presplit and et.spec.layers[-1].presplit_flat
    out, aux = et._net(torch.from_numpy(x).to(torch.bfloat16), keep_all=True)
    ft, ct = (t.float().numpy() for t in out)
    fj, cj = (np.asarray(t, np.float32) for t in ej(jnp.asarray(x)))
    region = et.spec.layers[-1]
    head = aux["outputs"][len(et.spec.layers) - 2]       # bf16 NHWC logits
    ext, mask = TB.flat_head_gids(3, 4, CLASSES, region.head_block,
                                  et._net.trees[len(et.spec.layers) - 1]
                                  .group)
    masked = torch.from_numpy(_bf16(head.float().numpy() + _bf16(mask)))
    want = _bf16_softmax_f64(masked.to(torch.bfloat16), ext)
    assert_bf16_close(_slice_flat(ct, region), _slice_flat(want, region))
    np.testing.assert_allclose(ft, fj, rtol=0, atol=2 ** -7)
    np.testing.assert_allclose(_slice_flat(ct, region),
                               _slice_flat(cj, region), rtol=0, atol=2 ** -6)
    r = et.benchmark(iters=1, warmup=1)
    assert r["batch"] == 2 and r["images_per_sec"] > 0
    lt = TE.LatencyEngine(spec_t, params, device="cpu")
    lj = JE.LatencyEngine(spec_j, params)
    frame = np.random.RandomState(5).randint(0, 256, (SIZE, SIZE, 3),
                                             np.uint8)
    bt, pt = (t.numpy() for t in lt(frame))
    bj, pj = (np.asarray(t) for t in lj(frame))
    assert pt.shape == pj.shape == (12, CLASSES)
    np.testing.assert_allclose(pt.max(-1), pj.max(-1), rtol=0, atol=2 ** -7)
    best = pj.max(-1)
    for i in range(len(best) - 1):
        if best[i] - best[i + 1] > 2 ** -6:
            np.testing.assert_allclose(bt[i], bj[i], rtol=2 ** -6, atol=1e-3)


# --------------------------------------------------- the Detector ---


def _dets(ds):
    return [(d.class_id, d.prob, d.box) for d in ds]


def _same(got, ref):
    assert len(got) == len(ref) > 0
    for (c, p, b), (c2, p2, b2) in zip(got, ref):
        assert c == c2
        np.testing.assert_allclose(p, p2, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(b, b2, rtol=1e-4, atol=1e-5)


def _gap_thresh(p):
    """A threshold in the widest gap of the reference's best 16 per-box
    probs, so that float32 differences (1e-5 here) cannot move a
    detection across it."""
    best = np.sort(p.max(-1))[::-1][:16]
    gap = int(np.argmax(best[:-1] - best[1:]))
    assert best[gap] - best[gap + 1] > 1e-3
    return float((best[gap] + best[gap + 1]) / 2)


@pytest.mark.parametrize("mode", ["no map", "map", "presplit"])
def test_detector_matches_jax(net9k, mode):
    """Detector on the tree head against the JAX Detector: predict_batch
    at 1e-5 (the no-map branch gates on objectness > thresh, the map
    branch on obj * the mapped path prob), then detect det for det at a
    threshold in a gap of the probs."""
    cfg, weights, cmap, _, _, _ = net9k
    kw = {"map": dict(map_path=cmap), "presplit": dict(presplit=True),
          "no map": {}}[mode]
    td = Detector(cfg, weights, device="cpu", **kw)
    jd = JDetector(cfg, weights, **kw)
    assert td.tree is not None and td.tree.groups == GROUPS
    img = np.random.default_rng(11).uniform(0, 1, (70, 90, 3)).astype(
        np.float32)
    x = td.preprocess(img)[None]
    # the no-map branch gates on objectness; the map branch's probs are
    # obj * a mapped node's path prob, so its gate comes from their gap
    obj_thresh = 0.3 if mode != "map" else 0.0
    jb, jp = (np.asarray(t) for t in jd.predict_batch(jnp.asarray(x),
                                                      thresh=obj_thresh))
    tb, tp = (t.numpy() for t in td.predict_batch(x, thresh=obj_thresh))
    assert tp.shape == (1, 12, 80 if mode == "map" else CLASSES)
    np.testing.assert_allclose(tb, jb, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tp, jp, rtol=1e-4, atol=1e-5)
    assert (jp > 0).any()
    if mode != "map":
        # one live class a box at most, the walk's path prob
        assert ((tp[0] > 0).sum(-1) <= 1).all()
    thresh = obj_thresh if mode != "map" else _gap_thresh(jp[0])
    _same(_dets(td.detect(img, thresh=thresh, hier_thresh=0.5)),
          _dets(jd.detect(img, thresh=thresh, hier_thresh=0.5)))
    # the walk's cut is fixed: another hier_thresh is refused, not ignored
    with pytest.raises(ValueError, match="hier_thresh"):
        td.detect(img, thresh=thresh, hier_thresh=0.3)


def test_cli_detect_presplit_matches_jax(net9k, tmp_path):
    cfg, weights, _, _, _, _ = net9k
    img = np.random.default_rng(12).integers(0, 256, (50, 60, 3),
                                             dtype=np.uint8)
    ppm = tmp_path / "frame.ppm"
    ppm.write_bytes(b"P6\n60 50\n255\n" + img.tobytes())
    common = [cfg, weights, str(ppm), "-thresh", "0.3", "-presplit"]
    jdets = JCLI.cmd_detect(list(common))
    tdets = TCLI.cmd_detect(list(common) + ["-cpu"])
    assert len(jdets) > 0
    _same(_dets(tdets), _dets(jdets))


def test_serve_tree_head(net9k):
    """The pipe server on the tree head, no map: the handshake names the
    9,418 classes, two answers equal the in-process Detector's, and a
    box's probs are nonzero only where its objectness passes the
    request's thresh."""
    cfg, weights, _, _, _, _ = net9k
    rng = np.random.default_rng(13)
    frames = [rng.uniform(0, 1, (40, 56, 3)).astype(np.float32)
              for _ in range(2)]
    thresh = 0.3
    req = b"".join(struct.pack("<3if", f.shape[1], f.shape[0], f.shape[2],
                               thresh) + f.astype("<f4").tobytes()
                   for f in frames) + struct.pack("<3if", 0, 0, 0, 0.0)
    res = subprocess.run(
        [sys.executable, "-m", "sr_object_detection_tpu_torch.infer.serve",
         cfg, weights, "--cpu"], input=req, capture_output=True,
        timeout=240, cwd=REPO)
    assert res.returncode == 0, res.stderr.decode()[-2000:]
    out = res.stdout
    assert struct.unpack("<5i", out[:20]) == (0x53524456, SIZE, SIZE, 12,
                                              CLASSES)
    per = 4 * 12 * (4 + CLASSES)
    assert len(out) == 20 + 2 * per
    det = Detector(cfg, weights, device="cpu")
    live = 0
    for i, f in enumerate(frames):
        blob = np.frombuffer(out[20 + i * per:20 + (i + 1) * per], "<f4")
        x = det.preprocess(f)[None]
        wb, wp = det.predict_batch(x, thresh=thresh)
        np.testing.assert_array_equal(blob[:48].reshape(12, 4),
                                      wb[0].numpy())
        probs = blob[48:].reshape(12, CLASSES)
        np.testing.assert_array_equal(probs, wp[0].numpy())
        acts = det.net(torch.from_numpy(x))[0].reshape(12, CLASSES + 5)
        obj = acts[:, 4].numpy()
        assert not probs[obj <= thresh].any()
        live += int((probs > 0).any(-1).sum())
    assert live > 0
