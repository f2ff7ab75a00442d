"""The port's utils (utils/profiler.py, utils/gemm_bench.py) against the
JAX package's, on the CPU: ``train_flops`` equal for every net of
``models/zoo.ZOO`` and go-19, ``mfu`` read against the H100 table,
``StepTimer`` and ``MetricsLog`` rows as JAX's, ``trace`` writing a
Chrome trace, and ``time_gemm`` / the `gemm` command at tiny shapes."""

import json

import numpy as np
import pytest
import torch

from sr_object_detection_tpu.utils import profiler as JP
from sr_object_detection_tpu_torch.apps import cli
from sr_object_detection_tpu_torch.utils import gemm_bench as TGB
from sr_object_detection_tpu_torch.utils import profiler as TP


@pytest.mark.parametrize("name", ["tiny-yolo-voc", "yolov2", "yolo9000",
                                  "darknet19", "cifar", "rnn", "go19"])
def test_train_flops_matches_jax(name, tmp_path):
    import sr_object_detection_tpu.graph.spec as JS
    import sr_object_detection_tpu.models.zoo as JZ
    import sr_object_detection_tpu_torch.graph.spec as TS
    import sr_object_detection_tpu_torch.models.zoo as TZ
    if name == "go19":
        from torch_parity import go19_cfg_text
        cfg = tmp_path / "go19.cfg"
        cfg.write_text(go19_cfg_text())
        tspec, jspec = TS.parse_network_cfg(str(cfg)), \
            JS.parse_network_cfg(str(cfg))
        # twelve 256 -> 256 3x3 convs at 19x19 dominate: 5.1 GFLOP
        assert TP.train_flops(tspec) / 3 == pytest.approx(5.1e9, rel=0.01)
    else:
        tspec, jspec = TZ.ZOO[name](), JZ.ZOO[name]()
    assert TP.train_flops(tspec) == JP.train_flops(jspec) > 0
    assert TP.train_flops(tspec, 2.0) == JP.train_flops(jspec, 2.0)


def test_mfu_reads_the_h100_table():
    assert TP.H100_PEAK_FLOPS == {"bfloat16": 989e12, "float32": 67e12}
    assert not hasattr(TP, "TPU_PEAK_FLOPS")
    assert TP.mfu(67e12, 1.0) == pytest.approx(1.0)
    assert TP.mfu(989e12, 2.0, "bfloat16") == pytest.approx(0.5)
    with pytest.raises(KeyError):
        TP.mfu(1.0, 1.0, "v5e")


def test_step_timer_and_metrics_log_match_jax(tmp_path, monkeypatch):
    """Both packages' timers and logs on one scripted clock: equal EMAs,
    summaries, rows and JSON lines."""
    import time
    clock = iter(np.arange(0.0, 100.0, 0.25).tolist())
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    monkeypatch.setattr(time, "time", lambda: 1234.5)
    timers = (TP.StepTimer(0.5), JP.StepTimer(0.5))
    for t in timers:
        for name in ("load", "step", "load"):
            with t.phase(name):
                pass
    assert timers[0].ema == timers[1].ema
    assert timers[0].summary() == timers[1].summary()
    logs = (TP.MetricsLog(str(tmp_path / "t.jsonl")),
            JP.MetricsLog(str(tmp_path / "j.jsonl")))
    for log in logs:
        log.log(1, loss=torch.tensor(0.5) if log is logs[0] else
                np.float32(0.5), lr=0.001, note="x")
        log.log(2, loss=2)
    assert logs[0].rows == logs[1].rows
    assert (tmp_path / "t.jsonl").read_text() == \
        (tmp_path / "j.jsonl").read_text()
    assert json.loads((tmp_path / "t.jsonl").read_text().splitlines()[0]) \
        == {"step": 1, "time": 1234.5, "loss": 0.5, "lr": 0.001,
            "note": "x"}


def test_trace_writes_a_chrome_trace(tmp_path):
    with TP.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof.key_averages()
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in events["traceEvents"])


@pytest.mark.parametrize("ta,tb", [(0, 0), (1, 1)])
def test_time_gemm_on_the_cpu(ta, tb):
    r = TGB.time_gemm(8, 12, 16, dtype=torch.float32, ta=ta, tb=tb,
                      reps=5, device="cpu")
    assert r["flops"] == 2.0 * 8 * 12 * 16
    assert r["sec"] > 0 and r["gflops"] == pytest.approx(
        r["flops"] / r["sec"] / 1e9)
    assert (r["m"], r["k"], r["n"], r["ta"], r["tb"]) == (8, 12, 16, ta, tb)


def test_gemm_command_on_the_cpu(capsys):
    from sr_object_detection_tpu.utils.gemm_bench import DARKNET_SHAPES
    assert TGB.DARKNET_SHAPES == DARKNET_SHAPES
    rows = cli.COMMANDS["gemm"](["4", "6", "5", "-reps", "3", "-f32",
                                 "-cpu"])
    assert len(rows) == 1 and rows[0]["gflops"] > 0
    out = capsys.readouterr().out
    assert out.startswith("Matrix Multiplication 4x6 * 6x5: ")
    assert out.rstrip().endswith("us/op)")
