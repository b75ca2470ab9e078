"""PyTorch/CUDA port of ``boosting_rcnn_tpu`` for NVIDIA Hopper GPUs.

A second package beside the JAX one, which stays the reference.  Module
paths mirror the JAX package's (``ops/nms.py`` <-> ``ops/nms.py``).  The
port imports ``torch`` and numpy only; hand-written CUDA kernels live in
``csrc/`` and are built with ``nvcc`` at first use (``cuda_build.py``).
Entry points: ``builder.build_detector`` and ``TwoStageDetector.predict``.
"""
