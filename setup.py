#!/usr/bin/env python
from setuptools import find_packages, setup

setup(
    name="boosting_rcnn_tpu",
    version="0.1.0",
    description=(
        "TPU-native object detection framework with the capabilities of "
        "Boosting R-CNN (mmdetection 2.17 fork), rebuilt on JAX/XLA"
    ),
    # "boosting_rcnn_tpu*" also takes in the PyTorch port, boosting_rcnn_tpu_torch
    packages=find_packages(include=["boosting_rcnn_tpu*", "native*"]),
    package_data={"boosting_rcnn_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "orbax-checkpoint", "numpy"],
    extras_require={"data": ["opencv-python"]},
)
