"""PyTorch/CUDA port of ``boosting_rcnn_tpu`` for NVIDIA Hopper GPUs.

A second package beside the JAX one, which stays the reference.  Module
paths mirror the JAX package's (``ops/nms.py`` <-> ``ops/nms.py``).  The
port imports ``torch`` and numpy only; hand-written CUDA kernels live in
``csrc/`` and are built with ``nvcc`` at first use (``cuda_build.py``).
Entry points: ``apis.init_detector`` / ``inference_detector`` /
``train_detector``, the CLIs ``python -m boosting_rcnn_tpu_torch.tools.train``
and ``.tools.test``, and below them ``builder.build_detector``,
``TwoStageDetector.predict`` and ``engine.train.make_train_step``.
"""

__version__ = "0.1.0"
