"""3D voxel-patch auto-encoder / descriptor encoder.

Re-implements the reference Keras model (``AE4VoxelPatch.py:184-213``): a 3D
conv AE over 16^3 binary occupancy patches whose 20-dim bottleneck is the
per-scale descriptor; three scales concatenate to the 60-dim CAE-LO
descriptor (``Match.py:130-135``).

The *shipped* encoder weights (``TrainedModels/EncoderModel4VoxelPatch.h5``)
use **tanh** activations everywhere including the 20-dim code — that artifact
is authoritative for inference parity, so ``activation='tanh'`` is the
default; the training script in the reference uses relu/linear, which remains
available via the module parameters.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from .layers import (ACTIVATIONS, Module, Params, conv, dense, max_pool2x,
                     upsample2x)


@dataclasses.dataclass(frozen=True)
class PatchEncoder(Module):
    """16^3 occupancy patch -> code_dim descriptor."""

    code_dim: int = 20
    activation: str = "tanh"       # shipped weights; reference training: relu
    code_activation: str = "tanh"  # shipped weights; reference training: linear

    def forward(self, p: Params, x):
        # x: (N, 16, 16, 16) or (N, 16, 16, 16, 1)
        if x.ndim == 4:
            x = x[..., None]
        a = ACTIVATIONS[self.activation]
        h = max_pool2x(a(conv(p, "conv1", x, 8, (3, 3, 3))))
        h = max_pool2x(a(conv(p, "conv2", h, 16, (3, 3, 3))))
        h = a(conv(p, "conv3", h, 32, (3, 3, 3)))
        h = h.reshape(h.shape[0], -1)  # Keras Flatten: channels-last C-order
        h = a(dense(p, "fn1", h, 200))
        return ACTIVATIONS[self.code_activation](
            dense(p, "fn2", h, self.code_dim))


@dataclasses.dataclass(frozen=True)
class VoxelPatchAE(Module):
    """Full AE for unsupervised training (binary cross-entropy loss).

    Decoder mirrors ``AE4VoxelPatch.py:198-207``: Dense 200 -> Dense 2048 ->
    reshape 4^3 x 32 -> conv/upsample stack -> sigmoid occupancy logits.
    """

    code_dim: int = 20
    activation: str = "relu"
    code_activation: str = "linear"

    def forward(self, p: Params, x):
        if x.ndim == 4:
            x = x[..., None]
        code = PatchEncoder(
            code_dim=self.code_dim,
            activation=self.activation,
            code_activation=self.code_activation,
        ).forward(p.child("encoder"), x)
        a = ACTIVATIONS[self.activation]
        h = a(dense(p, "fn3", code, 200))
        h = a(dense(p, "fn4", h, 2048))
        h = h.reshape(h.shape[0], 4, 4, 4, 32)
        h = upsample2x(a(conv(p, "conv2_1", h, 16, (3, 3, 3))))
        h = upsample2x(a(conv(p, "conv2_2", h, 8, (3, 3, 3))))
        return conv(p, "out", h, 1, (3, 3, 3))  # sigmoid is in the loss


def describe(encoder_apply, params, patches3, batch_chunk: int | None = None):
    """Concatenate per-scale codes into the 60-dim descriptor
    (``GetFeaturesFromPatches``, ``Match.py:130-135``).

    Args:
      encoder_apply: the PatchEncoder apply fn.
      params: encoder params.
      patches3: tuple of three ``(K, 16, 16, 16)`` patch tensors.
    """
    codes = [encoder_apply(params, p) for p in patches3]
    return jnp.concatenate(codes, axis=-1)
