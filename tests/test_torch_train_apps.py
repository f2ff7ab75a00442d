"""The port's training apps against the JAX package's: train-state
checkpoints both ways, the .weights export, the detection loader, and
`cli detector train` on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr_object_detection_tpu.data.loader import DetectionLoader as JLoader
from sr_object_detection_tpu.io import checkpoint as JCK
from sr_object_detection_tpu.io.weights import init_params as j_init_params
from sr_object_detection_tpu.models import zoo as JZ
from sr_object_detection_tpu.train.trainer import TrainState as JState
from sr_object_detection_tpu_torch.apps import cli as TCLI
from sr_object_detection_tpu_torch.config import parse_cfg_text
from sr_object_detection_tpu_torch.data.loader import DetectionLoader
from sr_object_detection_tpu_torch.graph import spec as S
from sr_object_detection_tpu_torch.io import checkpoint as TCK
from sr_object_detection_tpu_torch.io.convert import params_to_numpy
from sr_object_detection_tpu_torch.io.weights import (init_params,
                                                      load_weights)
from sr_object_detection_tpu_torch.models import zoo as TZ
from sr_object_detection_tpu_torch.train.trainer import Trainer
from torch_parity import train_cfg_text, write_ppm_dataset


def _spec(mod):
    base = mod.tiny_yolo_voc(width=64, height=64)
    return dataclasses.replace(
        base, net=dataclasses.replace(base.net, batch=2, subdivisions=1))


def _trained_port_state():
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    t = np.zeros((2, 30, 5), np.float32)
    t[:, 0] = [0.5, 0.4, 0.3, 0.2, 3]
    tr = Trainer(_spec(TZ), params=init_params(_spec(TZ), seed=4),
                 device="cpu")
    tr.step(x, t)
    return tr


def _assert_states_equal(jstate, tstate, spec):
    assert int(jstate.seen) == int(tstate.seen)
    for jtree, ttree in ((jstate.params, tstate.params),
                         (jstate.velocity, tstate.velocity)):
        mine = params_to_numpy(spec, ttree)
        for i, p in enumerate(jtree):
            assert p.keys() == mine[i].keys()
            for k in p:
                np.testing.assert_array_equal(mine[i][k], np.asarray(p[k]))


def test_train_state_port_to_jax_and_back(tmp_path):
    tr = _trained_port_state()
    TCK.save_train_state(str(tmp_path / "t.npz"), tr.state, _spec(TZ))
    jp = jax.tree.map(jnp.asarray, j_init_params(_spec(JZ), seed=0))
    jtemplate = JState(jp, jax.tree.map(jnp.zeros_like, jp), jnp.asarray(0))
    jstate = JCK.load_train_state(str(tmp_path / "t.npz"), jtemplate)
    _assert_states_equal(jstate, tr.state, _spec(TZ))
    # and back: the JAX package's file loads into the port
    JCK.save_train_state(str(tmp_path / "j.npz"), jstate)
    back = TCK.load_train_state(str(tmp_path / "j.npz"),
                                Trainer(_spec(TZ), device="cpu").state,
                                _spec(TZ))
    _assert_states_equal(jstate, back, _spec(TZ))
    assert back.seen.dtype == torch.int64


def test_export_weights_bytes_equal_jax(tmp_path):
    tr = _trained_port_state()
    TCK.export_weights(str(tmp_path / "t.weights"), _spec(TZ), tr.state)
    jp = params_to_numpy(_spec(TZ), tr.state.params)
    jstate = JState(jax.tree.map(jnp.asarray, jp), None,
                    jnp.asarray(int(tr.state.seen)))
    JCK.export_weights(str(tmp_path / "j.weights"), _spec(JZ), jstate)
    assert ((tmp_path / "t.weights").read_bytes()
            == (tmp_path / "j.weights").read_bytes())
    assert TCK.checkpoint_name("b", "net", 300) == JCK.checkpoint_name(
        "b", "net", 300)
    assert TCK.checkpoint_name("b", "net", 0, final=True).endswith(
        "net_final.weights")
    for i in (1, 100, 250, 1000, 1500, 2000):
        assert TCK.should_checkpoint(i) == JCK.should_checkpoint(i)


@pytest.mark.parametrize("augment", [True, False])
def test_detection_loader_matches_jax(tmp_path, augment):
    lst = write_ppm_dataset(tmp_path / "data", 6, w=50, h=40, seed=1)
    kw = dict(w=32, h=32, batch=4, classes=20, jitter=0.2, hue=0.1,
              saturation=1.5, exposure=1.5, augment=augment, seed=3,
              workers=2)
    tl = DetectionLoader(lst, **kw)
    jl = JLoader(lst, **kw)
    try:
        for step in range(2):
            if step == 1:
                tl.set_dims(40, 40)
                jl.set_dims(40, 40)
            xt, tt = tl.next_batch()
            xj, tj = jl.next_batch()
            assert xt.shape == xj.shape and tt.shape == (4, 30, 5)
            np.testing.assert_array_equal(tt, tj)
            np.testing.assert_array_equal(xt, xj)
            assert (tt[:, 0, 2] > 0).all()
    finally:
        tl.close()
        jl.pool.shutdown(wait=True)
    # the device-augmenting loader draws from the same stream: the same
    # truths as the JAX one's (tests/test_torch_data.py holds its frames)
    tl = DetectionLoader(lst, device_augment=True, device="cpu", **kw)
    jl = JLoader(lst, device_augment=True, **kw)
    try:
        xt, tt = tl.next_batch()
        _, tj = jl.next_batch()
        assert isinstance(xt, torch.Tensor) and xt.shape == (4, 32, 32, 3)
        np.testing.assert_array_equal(tt, tj)
    finally:
        tl.close()
        jl.pool.shutdown(wait=True)


def test_cli_detector_train_on_cpu(tmp_path, capsys):
    """`detector train -cpu` on a 64x64 tiny-yolo-voc with random=0 (no
    multi-scale resize to 320+ on the CPU) and max_batches=2 writes
    <base>_final.weights, which loads back, differs from the initial
    weights and carries the images seen."""
    g = np.load("tests/golden/tiny_yolo_voc.npz")
    cfg = tmp_path / "tiny64.cfg"
    cfg.write_text(train_cfg_text(bytes(g["cfg"]).decode(), size=64,
                                  batch=2, subdivisions=1, max_batches=2,
                                  random=0))
    lst = write_ppm_dataset(tmp_path / "voc", 4, w=80, h=60, seed=2)
    backup = tmp_path / "backup"
    data = tmp_path / "voc.data"
    data.write_text(f"classes=20\ntrain={lst}\nbackup={backup}\n")
    TCLI.main(["detector", "train", str(data), str(cfg), "-cpu"])
    out = capsys.readouterr().out
    assert "1: " in out and "2: " in out and "Resizing" not in out
    spec = S.build_network_spec(parse_cfg_text(cfg.read_text()))
    params, seen = load_weights(spec, str(backup / "tiny64_final.weights"))
    assert seen == 4
    init = init_params(spec, seed=0)
    assert not np.allclose(params[0]["weights"], init[0]["weights"])
    # -packed reads <prefix>.json (tests/test_torch_data.py trains on one)
    with pytest.raises(FileNotFoundError, match="missing.json"):
        TCLI.main(["detector", "train", str(data), str(cfg), "-cpu",
                   "-packed", str(tmp_path / "missing")])
