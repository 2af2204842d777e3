"""2D convolutional auto-encoder over spherical-ring images.

Re-implements the reference Keras model (``AE4SphericalRingPC.py:128-146``):
an unsupervised conv AE on the x,y,z channels whose first two conv layers
form the **respond layer** — the 8-channel full-resolution feature map used
for interest-point detection.  Shipped-weights architecture verified from
``TrainedModels/SphericalRingPCRespondLayer.h5``:
Conv2D(32, 3x3, relu, same) -> Conv2D(8, 1x1, relu, same).

All convs are NHWC / channels-last, matching Keras, so the shipped weights
import 1:1 (``caelo_tpu.models.weights_io``).
"""
from __future__ import annotations

import dataclasses

import jax

from .layers import Module, Params, conv, max_pool2x, upsample2x


@dataclasses.dataclass(frozen=True)
class RespondLayer(Module):
    """The keypoint-saliency feature extractor (encoder head only)."""

    features: int = 8
    width: int = 32

    def forward(self, p: Params, x):
        x = jax.nn.relu(conv(p, "conv1_1", x, self.width, (3, 3)))
        return jax.nn.relu(conv(p, "conv1_1_2", x, self.features, (1, 1)))


@dataclasses.dataclass(frozen=True)
class SphericalRingAE(Module):
    """Full auto-encoder for unsupervised training (MSE reconstruction).

    Layer stack mirrors ``AE4SphericalRingPC.py:132-142``: the respond layer,
    two pool+conv encoder stages, and an upsampling decoder back to the
    3-channel input.
    """

    channels: int = 3

    def forward(self, p: Params, x):
        h = RespondLayer().forward(p.child("respond"), x)
        h = max_pool2x(h)
        h = jax.nn.relu(conv(p, "conv1_2", h, 16, (3, 3)))
        h = max_pool2x(h)
        h = jax.nn.relu(conv(p, "conv2_2", h, 16, (3, 3)))
        h = upsample2x(h)
        h = jax.nn.relu(conv(p, "conv2_3", h, 8, (3, 3)))
        h = upsample2x(h)
        return conv(p, "out", h, self.channels, (1, 1))
