"""robot: run the full perception loop from the CLI.

Counterpart of ``sr_object_detection_tpu/apps/robot_app.py``, the analog
of the reference's YOLO2_main variants (YOLO2_main*.cpp:21-87: parse
-cfgfile/-weightfile/-useThrift, build KinectUtil, run()):

  robot run <cfg> <weights> [-source synthetic|<glob>] [-event E]
            [-frames N] [-names file] [-nl path] [-ipc path]
            [-detect-every N] [-maxdist meters] [-faces]
            [-dets-file path] [-cpu]

The in-process Detector runs on CUDA unless -cpu is given; each detect
frame then runs the NMS kernel once (``kernels/nms.py``).

  -faces      count faces per frame (Process_Kinect::detectFaces hook)
  -dets-file  consume detections from the shared-text-file protocol
              instead of running a model in-process (the speech-api
              deployment, KinectUtil_speech_api.cpp) — <cfg> <weights>
              are ignored
"""

from __future__ import annotations

from .cli import find_value, find_arg


def run_robot(argv: list[str], *, device="cuda"):
    sub = argv.pop(0) if argv and not argv[0].endswith(".cfg") else "run"
    if sub != "run":
        raise SystemExit(f"unknown robot subcommand {sub}")
    cfg, weights = argv[0], argv[1]
    source_spec = find_value(argv, "-source", "synthetic")
    event = find_value(argv, "-event", "General")
    max_frames = find_value(argv, "-frames", 30, int)
    names_file = find_value(argv, "-names", None)
    nl_path = find_value(argv, "-nl", "Objects.txt")
    ipc_path = find_value(argv, "-ipc", None)
    detect_every = find_value(argv, "-detect-every", 1, int)
    max_dist = find_value(argv, "-maxdist", 0.0, float)
    count_faces = find_arg(argv, "-faces")
    dets_file = find_value(argv, "-dets-file", None)

    from ..robot.frame_source import (SyntheticRGBDSource,
                                      ImageDirectorySource)
    from ..robot.pipeline import RobotPerception

    names = None
    if names_file:
        from ..config import read_names
        names = read_names(names_file)
    if dets_file:
        # speech-api shape: detections come from another process via
        # the shared txt protocol; no model in this process
        from ..robot.file_protocol import FileProtocolDetector
        det = FileProtocolDetector(dets_file)
    else:
        from ..infer.detector import Detector
        det = Detector(cfg, weights, names=names, device=device)
    if source_spec == "synthetic":
        source = SyntheticRGBDSource(n_frames=max_frames)
    else:
        source = ImageDirectorySource(source_spec)

    faces = None
    if count_faces:
        from ..robot.interaction import FaceCounter
        faces = FaceCounter()

    pipe = RobotPerception(det, names=names, event=event,
                           max_distance=max_dist,
                           detect_every=detect_every, nl_path=nl_path,
                           ipc=ipc_path)
    results = []
    for i, frame in enumerate(source):
        if max_frames and i >= max_frames:
            break
        r = pipe.process(frame)
        if faces is not None:
            img = frame.color.astype("float32")
            r["faces"] = faces(img / 255.0 if img.max() > 1.5 else img)
        results.append(r)
        print(f"frame {i}: {r['sentence']}"
              + (f"  faces={r['faces']}" if faces is not None else "")
              + (f"  [reminder: "
                 f"{', '.join(d.get('name', str(d['class_id'])) for d in r['reminders'])}]"
                 if r["reminders"] else ""))
    return results


__all__ = ["run_robot"]
