"""The reference training workflow through the port's CLI on the CPU,
as tests/test_workflow_cli.py runs it through the JAX package's:

    pack dataset -> `detector train -packed` (150 steps, checkpoints)
    -> `detector valid` (comp4 files, exact NMS)
    -> the port's reval_voc (eval/reval_voc.py) -> mAP gate

on the same synthetic single-class set, cfg, steps and gate.
"""

import os

from sr_object_detection_tpu_torch.apps import cli
from sr_object_detection_tpu_torch.data.packed import pack_detection_dataset
from sr_object_detection_tpu_torch.eval import reval_voc as RV
from test_workflow_cli import TOY_CFG, _write_dataset


def test_full_reference_workflow_train_valid_reval(tmp_path, capsys):
    train_paths = _write_dataset(tmp_path / "train", 64, seed=0)
    valid_paths = _write_dataset(tmp_path / "valid", 16, seed=99)
    (tmp_path / "train.list").write_text("\n".join(train_paths) + "\n")
    (tmp_path / "valid.list").write_text("\n".join(valid_paths) + "\n")
    (tmp_path / "obj.names").write_text("thing\n")
    backup = tmp_path / "backup"
    (tmp_path / "obj.data").write_text(
        f"classes = 1\n"
        f"train = {tmp_path / 'train.list'}\n"
        f"valid = {tmp_path / 'valid.list'}\n"
        f"names = {tmp_path / 'obj.names'}\n"
        f"backup = {backup}\n")
    cfg = tmp_path / "toy-det.cfg"
    cfg.write_text(TOY_CFG.format(max_batches=150))

    prefix = str(tmp_path / "train_packed")
    hdr = pack_detection_dataset(train_paths, prefix, store_w=48,
                                 store_h=48, quiet=True)
    assert hdr["n"] == 64

    assert cli.main(["detector", "train", str(tmp_path / "obj.data"),
                     str(cfg), "-packed", prefix, "-cpu"]) == 0
    final = backup / "toy-det_final.weights"
    assert final.exists(), os.listdir(backup)
    assert (backup / "toy-det.state.npz").exists()

    results = tmp_path / "results"
    assert cli.main(["detector", "valid", str(tmp_path / "obj.data"),
                     str(cfg), str(final), "-outdir", str(results),
                     "-cpu"]) == 0
    det_file = results / "comp4_det_test_thing.txt"
    assert len(det_file.read_text().splitlines()) > 0, \
        "valid wrote no detections"

    m_ap = RV.main([str(results),
                    "--classes", str(tmp_path / "obj.names"),
                    "--labels", str(tmp_path / "valid" / "labels"),
                    "--image-list", str(tmp_path / "valid.list")])
    assert "Mean AP" in capsys.readouterr().out
    assert m_ap > 0.3, f"workflow mAP too low: {m_ap}"
