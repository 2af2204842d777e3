"""Plain ``jax.lax`` layers shared by the two auto-encoders.

Parameters live in the tree layout Keras and Flax both use:
``{"params": {layer: {"kernel": (spatial..., in, out), "bias": (out,)}}}``,
so the shipped ``.h5`` weights import by renaming alone
(``caelo_tpu.models.weights_io``).  ``Module.init`` initialises the way
``flax.linen`` does — LeCun-normal kernels, zero biases, each layer's key
folded from the root key by the SHA-1 of its path — so a given key gives
the same random weights the earlier Flax modules gave.
"""
from __future__ import annotations

import hashlib
from typing import Tuple

import jax
import jax.numpy as jnp

_kernel_init = jax.nn.initializers.lecun_normal()

ACTIVATIONS = {
    "tanh": jnp.tanh,
    "relu": jax.nn.relu,
    "linear": lambda x: x,
    "sigmoid": jax.nn.sigmoid,
}


def _layer_key(key, path: Tuple[str, ...]):
    """The key ``flax.linen`` derives for a layer's first parameter: the
    path names followed by the per-layer counter 1, SHA-1 hashed, folded in
    once."""
    m = hashlib.sha1()
    for name in path:
        m.update(name.encode("utf-8"))
    m.update(b"\x01")
    return jax.random.fold_in(key, jnp.uint32(int.from_bytes(m.digest()[:4],
                                                             "big")))


class Params:
    """A node of the parameter tree: reads layers, or creates them on first
    use when it was given a key."""

    def __init__(self, tree: dict, key=None, path: Tuple[str, ...] = ()):
        self.tree, self.key, self.path = tree, key, path

    def child(self, name: str) -> "Params":
        if self.key is not None:
            self.tree.setdefault(name, {})
        return Params(self.tree[name], self.key, self.path + (name,))

    def layer(self, name: str, kernel_shape: Tuple[int, ...]):
        if self.key is not None and name not in self.tree:
            k = _kernel_init(_layer_key(self.key, self.path + (name,)),
                             kernel_shape, jnp.float32)
            self.tree[name] = {"kernel": k,
                               "bias": jnp.zeros(kernel_shape[-1:],
                                                 jnp.float32)}
        p = self.tree[name]
        return p["kernel"], p["bias"]


def _promote(*xs):
    dt = jnp.result_type(*xs)
    return [jnp.asarray(x, dt) for x in xs]


def conv(p: Params, name: str, x, features: int, size: Tuple[int, ...]):
    """'SAME' stride-1 convolution, channels last (NHWC/HWIO or
    NDHWC/DHWIO)."""
    k, b = p.layer(name, tuple(size) + (x.shape[-1], features))
    x, k, b = _promote(x, k, b)
    n = len(size)
    spatial = "DHW"[-n:]
    y = jax.lax.conv_general_dilated(
        x, k, (1,) * n, "SAME",
        dimension_numbers=("N" + spatial + "C", spatial + "IO",
                           "N" + spatial + "C"))
    return y + b


def dense(p: Params, name: str, x, features: int):
    k, b = p.layer(name, (x.shape[-1], features))
    x, k, b = _promote(x, k, b)
    return jax.lax.dot_general(x, k, (((x.ndim - 1,), (0,)), ((), ()))) + b


def max_pool2x(x):
    """2x max pool, stride 2, 'SAME', over every spatial axis."""
    window = (1,) + (2,) * (x.ndim - 2) + (1,)
    return jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, window, window,
                                 "SAME")


def upsample2x(x):
    """Nearest-neighbour 2x upsampling over every spatial axis (Keras
    ``UpSampling2D`` / ``UpSampling3D``)."""
    for axis in range(1, x.ndim - 1):
        x = jnp.repeat(x, 2, axis=axis)
    return x


class Module:
    """Base of the models: subclasses are frozen dataclasses whose fields
    are the hyper-parameters, and whose ``forward(p, x)`` is the network,
    written once for both ``init`` and ``apply``."""

    def init(self, key, x) -> dict:
        tree: dict = {}
        self.forward(Params(tree, key), x)
        return {"params": tree}

    def apply(self, params: dict, x):
        return self.forward(Params(params["params"]), x)
