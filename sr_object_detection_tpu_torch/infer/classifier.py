"""Classification inference pipeline.

Counterpart of ``sr_object_detection_tpu/infer/classifier.py``, the
analog of predict_classifier (src_yolo2/classifier.c:676-760): letterbox
preprocess, forward, the hierarchy's path products when the net's
``[softmax]`` has a ``tree=``, top-k. The classifier path letterboxes
(classifier.c:709) where the detector plain-resizes, as there.

It runs on ``device`` (CUDA, where TF32 is switched off as the float32
Detector does, or the CPU) in float32; ``int8_calib`` (or ``quantize``)
runs the int8 program of ``infer/quant.py`` instead (an int8 trunk and a
float tail: darknet19's avgpool + softmax).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..graph import spec as S
from ..graph.compiler import Network
from ..io.convert import params_to_torch
from ..io.weights import init_params, load_weights
from ..ops import boxes as B
from ..ops import image as I


class Classifier:
    """Load a cfg+weights pair and classify images on ``device``."""

    def __init__(self, cfg_path: str, weights_path: Optional[str] = None,
                 *, device, names: Optional[Sequence[str]] = None,
                 int8_calib=None):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            from .detector import disable_tf32
            disable_tf32()
        self.spec = S.parse_network_cfg(cfg_path)
        if weights_path:
            self.params_np, self.seen = load_weights(self.spec, weights_path)
        else:
            self.params_np, self.seen = init_params(self.spec), 0
        self.params = params_to_torch(self.spec, self.params_np, self.device)
        self.net = Network(self.spec, self.params)
        trees = self.net.trees
        if int8_calib is not None:
            self.quantize(int8_calib)
        self.names = list(names) if names else None
        # the hierarchy of a [softmax] tree= (parser.c: net.hierarchy)
        self.tree = None
        for i, l in enumerate(self.spec.layers):
            if isinstance(l, S.SoftmaxSpec) and i in trees:
                self.tree = trees[i]
        self._chain = (None if self.tree is None else
                       B.hierarchy_chain(self.tree.parent, self.device))

    def quantize(self, calib_nhwc: np.ndarray) -> None:
        """Serve the int8 trunk + float tail, calibrated on a preprocessed
        NHWC batch (``preprocess`` of the images); the hierarchy is the
        same."""
        from .quant import QuantizedForwardShim
        self.net = QuantizedForwardShim(self.spec, self.params_np,
                                        calib_nhwc, device=self.device)

    @torch.no_grad()
    def predict_batch(self, x: np.ndarray):
        """NHWC preprocessed numpy batch -> (B, outputs) on the device:
        the network's output, flattened, times the hierarchy's path
        products (only_leaves=0, classifier.c:717) with a tree."""
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        out, _ = self.net(x.to(self.device))
        if out.ndim == 4:
            out = out.reshape(out.shape[0], -1)
        if self._chain is not None:
            out = B.hierarchy_multiply(out, self._chain)
        return out

    def preprocess(self, image_hwc: np.ndarray) -> np.ndarray:
        return I.letterbox_image_np(
            image_hwc, self.spec.net.w, self.spec.net.h)

    def predict(self, image_hwc: np.ndarray) -> np.ndarray:
        x = self.preprocess(image_hwc)[None]
        return self.predict_batch(x)[0].float().cpu().numpy()

    def predict_topk(self, image_hwc: np.ndarray, k: int = 5):
        p = self.predict(image_hwc)
        idx = np.argsort(-p)[:k]
        return [(int(i), float(p[i]),
                 self.names[int(i)] if self.names else None) for i in idx]


__all__ = ["Classifier"]
