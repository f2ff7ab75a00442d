"""ctypes binding for the native robot runtime (native/libsr_robot.so).

The C++ library implements the host-side robot components (object
memory, KCF/fHOG tracking, RANSAC plane removal, 3D localization); this
module exposes them as numpy-friendly Python classes. The library is
built on demand with `make -C native`.
"""

from __future__ import annotations

import ctypes as C
import os
import pathlib
import subprocess

import numpy as np

_REPO = pathlib.Path(__file__).resolve().parents[2]
_LIB_PATH = _REPO / "native" / "build" / "libsr_robot.so"


class srDetection(C.Structure):
    _fields_ = [("x", C.c_float), ("y", C.c_float),
                ("w", C.c_float), ("h", C.c_float),
                ("prob", C.c_float), ("class_id", C.c_int),
                ("cam_x", C.c_float), ("cam_y", C.c_float),
                ("cam_z", C.c_float), ("body_id", C.c_int)]


class srRect(C.Structure):
    _fields_ = [("x", C.c_float), ("y", C.c_float),
                ("w", C.c_float), ("h", C.c_float)]


class srIntrinsics(C.Structure):
    _fields_ = [("fx", C.c_float), ("fy", C.c_float),
                ("cx", C.c_float), ("cy", C.c_float)]


class srObjectMemoryConfig(C.Structure):
    _fields_ = [("appear_thresh", C.c_int), ("disappear_thresh", C.c_int),
                ("iou_match", C.c_float), ("box_ema", C.c_float),
                ("max_objects", C.c_int)]


class srKCFConfig(C.Structure):
    _fields_ = [("padding", C.c_float), ("sigma", C.c_float),
                ("lambda_", C.c_float), ("interp_factor", C.c_float),
                ("output_sigma_factor", C.c_float),
                ("cell_size", C.c_int), ("template_size", C.c_int)]


def _build():
    subprocess.run(["make", "-C", str(_REPO / "native")], check=True,
                   capture_output=True)


def load_library() -> C.CDLL:
    if not _LIB_PATH.exists():
        _build()
    lib = C.CDLL(str(_LIB_PATH))
    lib.sr_om_create.restype = C.c_void_p
    lib.sr_om_create.argtypes = [C.POINTER(srObjectMemoryConfig)]
    lib.sr_om_destroy.argtypes = [C.c_void_p]
    lib.sr_om_update.restype = C.c_int
    lib.sr_om_update.argtypes = [C.c_void_p, C.POINTER(srDetection),
                                 C.c_int]
    lib.sr_om_objects.restype = C.c_int
    lib.sr_om_objects.argtypes = [C.c_void_p, C.POINTER(srDetection),
                                  C.c_int]
    lib.sr_om_reminders.restype = C.c_int
    lib.sr_om_reminders.argtypes = [C.c_void_p, C.POINTER(srDetection),
                                    C.c_int]
    lib.sr_filter_category.restype = C.c_int
    lib.sr_filter_distance.restype = C.c_int
    lib.sr_depth_roi_mean.restype = C.c_float
    lib.sr_depth_roi_mean.argtypes = [C.POINTER(C.c_uint16), C.c_int,
                                      C.c_int, srRect]
    lib.sr_localize.argtypes = [C.POINTER(C.c_uint16), C.c_int, C.c_int,
                                C.POINTER(srIntrinsics),
                                C.POINTER(srDetection)]
    lib.sr_plane_ransac.restype = C.c_int
    lib.sr_plane_ransac.argtypes = [
        C.POINTER(C.c_float), C.c_int, C.c_float, C.c_int, C.c_uint32,
        C.POINTER(C.c_float), C.POINTER(C.c_uint8)]
    lib.sr_remove_plane_depth.restype = C.c_int
    lib.sr_remove_plane_depth.argtypes = [
        C.POINTER(C.c_uint16), C.c_int, C.c_int, C.POINTER(srIntrinsics),
        C.c_float, C.c_int, C.c_uint32]
    lib.sr_kcf_create.restype = C.c_void_p
    lib.sr_kcf_create.argtypes = [C.POINTER(srKCFConfig)]
    lib.sr_kcf_destroy.argtypes = [C.c_void_p]
    lib.sr_kcf_init.argtypes = [C.c_void_p, C.POINTER(C.c_uint8),
                                C.c_int, C.c_int, srRect]
    lib.sr_kcf_track.restype = srRect
    lib.sr_kcf_track.argtypes = [C.c_void_p, C.POINTER(C.c_uint8),
                                 C.c_int, C.c_int]
    lib.sr_kcf_peak.restype = C.c_float
    lib.sr_kcf_peak.argtypes = [C.c_void_p]
    lib.sr_fhog.restype = C.c_int
    lib.sr_fhog.argtypes = [C.POINTER(C.c_float), C.c_int, C.c_int,
                            C.c_int, C.POINTER(C.c_float)]
    lib.sr_tracks_create.restype = C.c_void_p
    lib.sr_tracks_create.argtypes = [C.c_int, C.c_float]
    lib.sr_tracks_destroy.argtypes = [C.c_void_p]
    lib.sr_tracks_update.restype = C.c_int
    lib.sr_tracks_update.argtypes = [C.c_void_p, C.POINTER(srDetection),
                                     C.c_int, C.c_int, C.c_int]
    return lib


_lib = None


def lib() -> C.CDLL:
    global _lib
    if _lib is None:
        _lib = load_library()
    return _lib


# ---------------------------------------------------------------------------
# numpy-friendly wrappers
# ---------------------------------------------------------------------------


def dets_to_struct(dets) -> tuple:
    arr = (srDetection * max(len(dets), 1))()
    for i, d in enumerate(dets):
        arr[i].x, arr[i].y, arr[i].w, arr[i].h = (
            float(d["box"][0]), float(d["box"][1]),
            float(d["box"][2]), float(d["box"][3]))
        arr[i].prob = float(d.get("prob", 0.0))
        arr[i].class_id = int(d.get("class_id", 0))
        arr[i].cam_x = float(d.get("cam", (0, 0, 0))[0])
        arr[i].cam_y = float(d.get("cam", (0, 0, 0))[1])
        arr[i].cam_z = float(d.get("cam", (0, 0, 0))[2])
        arr[i].body_id = int(d.get("body_id", -1))
    return arr, len(dets)


def struct_to_dets(arr, n) -> list[dict]:
    out = []
    for i in range(n):
        d = arr[i]
        out.append({"box": (d.x, d.y, d.w, d.h), "prob": d.prob,
                    "class_id": d.class_id,
                    "cam": (d.cam_x, d.cam_y, d.cam_z),
                    "body_id": d.body_id})
    return out


class ObjectMemory:
    """Cross-frame object persistence + reminders (objectApplication.c)."""

    def __init__(self, appear=5, disappear=8, iou=0.45, ema=0.8,
                 max_objects=128):
        cfg = srObjectMemoryConfig(appear, disappear, iou, ema, max_objects)
        self._h = lib().sr_om_create(C.byref(cfg))

    def update(self, dets: list[dict]) -> int:
        arr, n = dets_to_struct(dets)
        return lib().sr_om_update(self._h, arr, n)

    def objects(self, cap=128) -> list[dict]:
        arr = (srDetection * cap)()
        n = lib().sr_om_objects(self._h, arr, cap)
        return struct_to_dets(arr, n)

    def reminders(self, cap=32) -> list[dict]:
        arr = (srDetection * cap)()
        n = lib().sr_om_reminders(self._h, arr, cap)
        return struct_to_dets(arr, n)

    def __del__(self):
        try:
            lib().sr_om_destroy(self._h)
        except Exception:
            pass


class KCFTracker:
    """KCF/fHOG single-object tracker (kcf.cpp analog)."""

    def __init__(self, **kw):
        if kw:
            cfg = srKCFConfig(
                kw.get("padding", 3.0), kw.get("sigma", 0.5),
                kw.get("lambda_", 1e-4), kw.get("interp_factor", 0.02),
                kw.get("output_sigma_factor", 0.1),
                kw.get("cell_size", 4), kw.get("template_size", 64))
            self._h = lib().sr_kcf_create(C.byref(cfg))
        else:
            self._h = lib().sr_kcf_create(None)

    @staticmethod
    def _frame_ptr(frame: np.ndarray):
        assert frame.dtype == np.uint8 and frame.ndim == 3
        f = np.ascontiguousarray(frame)
        return f, f.ctypes.data_as(C.POINTER(C.c_uint8))

    def init(self, frame: np.ndarray, bbox: tuple):
        f, ptr = self._frame_ptr(frame)
        lib().sr_kcf_init(self._h, ptr, f.shape[1], f.shape[0],
                          srRect(*[float(v) for v in bbox]))

    def track(self, frame: np.ndarray) -> tuple:
        f, ptr = self._frame_ptr(frame)
        r = lib().sr_kcf_track(self._h, ptr, f.shape[1], f.shape[0])
        return (r.x, r.y, r.w, r.h)

    @property
    def peak(self) -> float:
        return lib().sr_kcf_peak(self._h)

    def __del__(self):
        try:
            lib().sr_kcf_destroy(self._h)
        except Exception:
            pass


class MultiTracker:
    """Greedy centroid multi-object track ids (yolo_v2_class tracking)."""

    def __init__(self, history=6, dist_thresh=0.08):
        self._h = lib().sr_tracks_create(history, dist_thresh)

    def update(self, dets: list[dict], frame_w: int, frame_h: int):
        arr, n = dets_to_struct(dets)
        lib().sr_tracks_update(self._h, arr, n, frame_w, frame_h)
        return struct_to_dets(arr, n)

    def __del__(self):
        try:
            lib().sr_tracks_destroy(self._h)
        except Exception:
            pass


def localize(depth_mm: np.ndarray, intrinsics: tuple, dets: list[dict]):
    """Fill camera-space xyz for each detection from the depth frame."""
    d = np.ascontiguousarray(depth_mm, np.uint16)
    K = srIntrinsics(*[float(v) for v in intrinsics])
    arr, n = dets_to_struct(dets)
    for i in range(n):
        lib().sr_localize(d.ctypes.data_as(C.POINTER(C.c_uint16)),
                          d.shape[1], d.shape[0], C.byref(K),
                          C.byref(arr[i]))
    return struct_to_dets(arr, n)


def plane_ransac(points_xyz: np.ndarray, dist_thresh=0.02,
                 max_iters=200, seed=0):
    """Dominant plane fit; returns (plane[4], inlier_mask, n_inliers)."""
    pts = np.ascontiguousarray(points_xyz, np.float32)
    n = len(pts)
    plane = (C.c_float * 4)()
    mask = (C.c_uint8 * n)()
    inl = lib().sr_plane_ransac(
        pts.ctypes.data_as(C.POINTER(C.c_float)), n, dist_thresh,
        max_iters, seed, plane, mask)
    return (np.array(plane[:]), np.frombuffer(mask, np.uint8).astype(bool),
            inl)


def remove_plane(depth_mm: np.ndarray, intrinsics: tuple,
                 dist_thresh=0.02, max_iters=200, seed=0) -> int:
    """Zero the dominant plane out of the depth map in-place."""
    d = np.ascontiguousarray(depth_mm, np.uint16)
    K = srIntrinsics(*[float(v) for v in intrinsics])
    removed = lib().sr_remove_plane_depth(
        d.ctypes.data_as(C.POINTER(C.c_uint16)), d.shape[1], d.shape[0],
        C.byref(K), dist_thresh, max_iters, seed)
    depth_mm[...] = d
    return removed


def fhog(img: np.ndarray, cell: int = 4) -> np.ndarray:
    """31-channel fHOG of an HWC float RGB image."""
    f = np.ascontiguousarray(img, np.float32)
    h, w = f.shape[:2]
    out = np.zeros((h // cell, w // cell, 31), np.float32)
    rc = lib().sr_fhog(f.ctypes.data_as(C.POINTER(C.c_float)), w, h, cell,
                       out.ctypes.data_as(C.POINTER(C.c_float)))
    if rc != 0:
        raise ValueError("fhog failed (image too small?)")
    return out


__all__ = ["ObjectMemory", "KCFTracker", "MultiTracker", "localize",
           "plane_ransac", "remove_plane", "fhog", "load_library"]
