"""Shared set-up of the int8 parity tests (tests/test_torch_quant.py,
tests/test_torch_engines.py): tiny-yolo-voc cut to a small width, with
random BN statistics and biases, a calibration batch, and the JAX
package's calibration result on it."""

import jax.numpy as jnp
import numpy as np

import sr_object_detection_tpu.infer.quant as JQ
from sr_object_detection_tpu.io.weights import init_params
from sr_object_detection_tpu.models import zoo as JZ
from sr_object_detection_tpu_torch.models import zoo as TZ
from torch_parity import random_bn

NET = 64           # tiny-yolo-voc at 64x64: 13 layers + the head


def int8_net(size=NET):
    """(JAX spec, port spec, numpy params, calibration batch, JAX amax).
    The head is scaled so that the region outputs spread."""
    spec_j = JZ.tiny_yolo_voc(width=size, height=size)
    spec_t = TZ.tiny_yolo_voc(width=size, height=size)
    params = random_bn(init_params(spec_j, seed=0), 1, head_gain=4.0)
    calib = np.random.RandomState(0).uniform(
        0, 1, (2, size, size, 3)).astype(np.float32)
    pf, fspec = JQ.fold_params_for_inference(spec_j, params,
                                             dtype=jnp.float32)
    return spec_j, spec_t, params, calib, JQ.calibrate_amax(fspec, pf, calib)
