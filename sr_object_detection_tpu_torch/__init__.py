"""sr_object_detection_tpu_torch — the PyTorch/CUDA port of
``sr_object_detection_tpu`` for NVIDIA Hopper (sm_90a).

It mirrors the JAX package's module paths (``graph/spec.py``,
``ops/boxes.py``, ``infer/detector.py`` ...) so each counterpart is easy
to find, and keeps the JAX package's public layouts: NHWC activations,
HWIO conv weights in the numpy params, and the flat region output
ordered ``[row][col][anchor][field]``.

The package imports ``torch`` and never ``jax``. Importing it imports
nothing else: every module is imported where it is used, and the CUDA
kernels under ``csrc/`` are compiled with ``nvcc`` at first use
(``kernels/_build.py``).
"""

__version__ = "0.1.0"
