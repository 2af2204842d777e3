"""Model definitions + golden numerics vs the shipped reference weights.

The shipped .h5 artifacts are the authoritative behavior (SURVEY.md section
2.1 'Shipped trained models'); oracles here are direct numpy convolutions,
so agreement proves both the Flax architecture and the weight import.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from caelo_tpu.models import weights_io
from caelo_tpu.models.patch_encoder import PatchEncoder, VoxelPatchAE
from caelo_tpu.models.respond_net import RespondLayer, SphericalRingAE

needs_ref = pytest.mark.skipif(
    not weights_io.reference_models_available(),
    reason="reference .h5 models not present",
)


def np_conv2d_same(x, k, b):
    """NHWC 'same' conv oracle via explicit padding + einsum."""
    kh, kw, cin, cout = k.shape
    ph, pw = kh // 2, kw // 2
    xp = np.pad(x, ((ph, ph), (pw, pw), (0, 0)))
    H, W = x.shape[:2]
    win = np.lib.stride_tricks.sliding_window_view(xp, (kh, kw), axis=(0, 1))
    # win: (H, W, cin, kh, kw)
    return np.einsum("hwcij,ijco->hwo", win, k) + b


def np_conv3d_same(x, k, b):
    kd, kh, kw, cin, cout = k.shape
    p = kd // 2
    xp = np.pad(x, ((p, p), (p, p), (p, p), (0, 0)))
    win = np.lib.stride_tricks.sliding_window_view(
        xp, (kd, kh, kw), axis=(0, 1, 2)
    )
    return np.einsum("dhwcijk,ijkco->dhwo", win, k) + b


def test_respond_layer_shapes():
    m = RespondLayer()
    x = jnp.zeros((1, 64, 128, 3))
    params = m.init(jax.random.key(0), x)
    y = m.apply(params, x)
    assert y.shape == (1, 64, 128, 8)


def test_spherical_ae_shapes():
    m = SphericalRingAE()
    x = jnp.zeros((2, 64, 128, 3))
    params = m.init(jax.random.key(0), x)
    y = m.apply(params, x)
    assert y.shape == (2, 64, 128, 3)


def test_patch_encoder_shapes():
    m = PatchEncoder()
    x = jnp.zeros((4, 16, 16, 16))
    params = m.init(jax.random.key(0), x)
    y = m.apply(params, x)
    assert y.shape == (4, 20)


def test_voxel_ae_shapes():
    m = VoxelPatchAE()
    x = jnp.zeros((2, 16, 16, 16))
    params = m.init(jax.random.key(0), x)
    y = m.apply(params, x)
    assert y.shape == (2, 16, 16, 16, 1)


@needs_ref
def test_respond_layer_golden():
    """Flax forward with imported weights == numpy conv oracle.

    Verifies the shipped architecture Conv2D(32,3x3,relu)->Conv2D(8,1x1,relu)
    (TrainedModels/SphericalRingPCRespondLayer.h5) and the kernel layout of
    the import path.
    """
    params = weights_io.load_respond_layer_params()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 16, 24, 3)).astype(np.float32)
    y = np.asarray(RespondLayer().apply(params, jnp.asarray(x)))[0]

    k1 = np.asarray(params["params"]["conv1_1"]["kernel"])
    b1 = np.asarray(params["params"]["conv1_1"]["bias"])
    k2 = np.asarray(params["params"]["conv1_1_2"]["kernel"])
    b2 = np.asarray(params["params"]["conv1_1_2"]["bias"])
    h = np.maximum(np_conv2d_same(x[0], k1, b1), 0)
    ref = np.maximum(np_conv2d_same(h, k2, b2), 0)
    np.testing.assert_allclose(y, ref, atol=1e-4)


@needs_ref
def test_patch_encoder_golden():
    """Flax encoder with imported weights == numpy oracle incl. the Keras
    channels-last Flatten ordering and tanh activations
    (TrainedModels/EncoderModel4VoxelPatch.h5)."""
    params = weights_io.load_patch_encoder_params()
    rng = np.random.default_rng(1)
    x = (rng.uniform(size=(2, 16, 16, 16)) < 0.2).astype(np.float32)
    y = np.asarray(PatchEncoder().apply(params, jnp.asarray(x)))

    p = params["params"]
    for i in range(2):
        h = x[i][..., None]
        for name in ["conv1", "conv2", "conv3"]:
            k = np.asarray(p[name]["kernel"])
            b = np.asarray(p[name]["bias"])
            h = np.tanh(np_conv3d_same(h, k, b))
            if name != "conv3":
                # 2x2x2 max pool stride 2
                d = h.shape[0] // 2
                h = h.reshape(d, 2, d, 2, d, 2, -1).max(axis=(1, 3, 5))
        flat = h.reshape(-1)  # channels-last C order == Keras Flatten
        h1 = np.tanh(flat @ np.asarray(p["fn1"]["kernel"]) + np.asarray(p["fn1"]["bias"]))
        code = np.tanh(h1 @ np.asarray(p["fn2"]["kernel"]) + np.asarray(p["fn2"]["bias"]))
        np.testing.assert_allclose(y[i], code, atol=1e-4)


@needs_ref
def test_descriptor_sanity():
    """Shipped encoder separates an empty patch from a structured one."""
    params = weights_io.load_patch_encoder_params()
    x = np.zeros((3, 16, 16, 16), np.float32)
    x[1, 8, :, :] = 1.0   # plane
    x[2, :, 8, :] = 1.0   # orthogonal plane
    y = np.asarray(PatchEncoder().apply(params, jnp.asarray(x)))
    assert np.linalg.norm(y[1] - y[0]) > 0.1
    assert np.linalg.norm(y[2] - y[1]) > 0.1


@needs_ref
def test_full_spherical_ae_import_runs():
    """Shipped full 2D AE imports and reconstructs with low error on its own
    respond-layer activations (sanity: the AE was trained to reconstruct
    ring images, so output shape/scale must be consistent)."""
    from caelo_tpu.models.respond_net import SphericalRingAE

    params = weights_io.load_spherical_ae_params()
    rng = np.random.default_rng(0)
    x = rng.normal(0, 5.0, size=(1, 32, 64, 3)).astype(np.float32)
    y = np.asarray(SphericalRingAE().apply(params, jnp.asarray(x)))
    assert y.shape == x.shape and np.isfinite(y).all()
    # respond sub-module weights equal the standalone respond artifact
    r_solo = weights_io.load_respond_layer_params()
    np.testing.assert_allclose(
        params["params"]["respond"]["conv1_1"]["kernel"],
        r_solo["params"]["conv1_1"]["kernel"], atol=1e-6,
    )


@needs_ref
def test_full_voxel_ae_golden_roundtrip():
    """Shipped full 3D AE (relu/linear run) reconstructs binary patches:
    verify the encoder sub-path vs the numpy oracle with relu activations."""
    from caelo_tpu.models.patch_encoder import VoxelPatchAE

    params = weights_io.load_voxel_ae_params()
    model = VoxelPatchAE(activation="relu", code_activation="linear")
    rng = np.random.default_rng(2)
    # in-distribution input: a planar surface patch (training data is
    # surface occupancy, not iid noise)
    x = np.zeros((2, 16, 16, 16), np.float32)
    x[0, :, :, 8] = 1.0
    x[1, 8, :, :] = 1.0
    logits = np.asarray(model.apply(params, jnp.asarray(x)))
    assert logits.shape == (2, 16, 16, 16, 1) and np.isfinite(logits).all()
    # reconstruction should correlate with input occupancy
    prob = 1 / (1 + np.exp(-logits[..., 0]))
    on = prob[x > 0.5].mean()
    off = prob[x < 0.5].mean()
    assert on > off, (on, off)
    x = (rng.uniform(size=(2, 16, 16, 16)) < 0.2).astype(np.float32)

    # golden check of the encoder sub-path (relu variant) vs numpy
    p = params["params"]["encoder"]
    for i in range(2):
        h = x[i][..., None]
        for name in ["conv1", "conv2", "conv3"]:
            k = np.asarray(p[name]["kernel"]); b = np.asarray(p[name]["bias"])
            h = np.maximum(np_conv3d_same(h, k, b), 0)
            if name != "conv3":
                d = h.shape[0] // 2
                h = h.reshape(d, 2, d, 2, d, 2, -1).max(axis=(1, 3, 5))
        flat = h.reshape(-1)
        h1 = np.maximum(flat @ np.asarray(p["fn1"]["kernel"]) + np.asarray(p["fn1"]["bias"]), 0)
        code = h1 @ np.asarray(p["fn2"]["kernel"]) + np.asarray(p["fn2"]["bias"])
        from caelo_tpu.models.patch_encoder import PatchEncoder

        enc = PatchEncoder(activation="relu", code_activation="linear")
        got = np.asarray(enc.apply({"params": p}, jnp.asarray(x[i][None])))[0]
        np.testing.assert_allclose(got, code, atol=1e-4)


# ------------------------------------------------ plain-JAX layer checks
# (run without the shipped weights: random init, numpy oracles)

EXPECTED_TREES = {
    "RespondLayer": {"conv1_1": (3, 3, 3, 32), "conv1_1_2": (1, 1, 32, 8)},
    "SphericalRingAE": {
        "respond/conv1_1": (3, 3, 3, 32), "respond/conv1_1_2": (1, 1, 32, 8),
        "conv1_2": (3, 3, 8, 16), "conv2_2": (3, 3, 16, 16),
        "conv2_3": (3, 3, 16, 8), "out": (1, 1, 8, 3)},
    "PatchEncoder": {
        "conv1": (3, 3, 3, 1, 8), "conv2": (3, 3, 3, 8, 16),
        "conv3": (3, 3, 3, 16, 32), "fn1": (2048, 200), "fn2": (200, 20)},
    "VoxelPatchAE": {
        "encoder/conv1": (3, 3, 3, 1, 8), "encoder/conv2": (3, 3, 3, 8, 16),
        "encoder/conv3": (3, 3, 3, 16, 32), "encoder/fn1": (2048, 200),
        "encoder/fn2": (200, 20), "fn3": (20, 200), "fn4": (200, 2048),
        "conv2_1": (3, 3, 3, 32, 16), "conv2_2": (3, 3, 3, 16, 8),
        "out": (3, 3, 3, 8, 1)},
}
MODELS = {"RespondLayer": (RespondLayer, (1, 16, 24, 3)),
          "SphericalRingAE": (SphericalRingAE, (1, 16, 24, 3)),
          "PatchEncoder": (PatchEncoder, (2, 16, 16, 16)),
          "VoxelPatchAE": (VoxelPatchAE, (2, 16, 16, 16))}


def flat_layers(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if "kernel" in v:
            out[prefix + k] = v
        else:
            out.update(flat_layers(v, prefix + k + "/"))
    return out


@pytest.mark.parametrize("name", sorted(MODELS))
def test_param_tree_layout(name):
    """Flax/Keras layout: {"params": {layer: {"kernel", "bias"}}}, kernels
    (spatial..., in, out) float32, LeCun-normal scale, zero biases."""
    cls, shape = MODELS[name]
    params = cls().init(jax.random.key(0), jnp.zeros(shape))
    layers = flat_layers(params["params"])
    assert {k: tuple(v["kernel"].shape) for k, v in layers.items()} \
        == EXPECTED_TREES[name]
    for v in layers.values():
        k = np.asarray(v["kernel"])
        assert k.dtype == np.float32 and v["bias"].dtype == np.float32
        np.testing.assert_array_equal(np.asarray(v["bias"]), 0.0)
        fan_in = int(np.prod(k.shape[:-1]))
        assert 0.5 < k.std() * np.sqrt(fan_in) < 1.2   # truncated normal


def test_random_init_respond_layer_matches_numpy_oracle():
    params = RespondLayer().init(jax.random.key(1), jnp.zeros((1, 16, 24, 3)))
    x = np.random.default_rng(0).normal(size=(1, 16, 24, 3)).astype(np.float32)
    y = np.asarray(RespondLayer().apply(params, jnp.asarray(x)))[0]
    p = jax.tree.map(np.asarray, params["params"])
    h = np.maximum(np_conv2d_same(x[0], p["conv1_1"]["kernel"],
                                  p["conv1_1"]["bias"]), 0)
    ref = np.maximum(np_conv2d_same(h, p["conv1_1_2"]["kernel"],
                                    p["conv1_1_2"]["bias"]), 0)
    np.testing.assert_allclose(y, ref, atol=1e-5)


def test_random_init_patch_encoder_matches_numpy_oracle():
    """Conv/pool stack, Keras channels-last flatten and the dense head."""
    params = PatchEncoder().init(jax.random.key(2), jnp.zeros((1, 16, 16, 16)))
    x = (np.random.default_rng(1).uniform(size=(2, 16, 16, 16)) < 0.2
         ).astype(np.float32)
    y = np.asarray(PatchEncoder().apply(params, jnp.asarray(x)))
    p = jax.tree.map(np.asarray, params["params"])
    for i in range(2):
        h = x[i][..., None]
        for name in ["conv1", "conv2", "conv3"]:
            h = np.tanh(np_conv3d_same(h, p[name]["kernel"], p[name]["bias"]))
            if name != "conv3":
                d = h.shape[0] // 2
                h = h.reshape(d, 2, d, 2, d, 2, -1).max(axis=(1, 3, 5))
        h1 = np.tanh(h.reshape(-1) @ p["fn1"]["kernel"] + p["fn1"]["bias"])
        code = np.tanh(h1 @ p["fn2"]["kernel"] + p["fn2"]["bias"])
        np.testing.assert_allclose(y[i], code, atol=1e-5)


def test_spherical_ae_pool_and_upsample_match_numpy():
    """The AEs' 2x max pool ('SAME', stride 2) and nearest-neighbour 2x
    upsampling against numpy."""
    from caelo_tpu.models.layers import max_pool2x, upsample2x

    x = np.random.default_rng(2).normal(size=(2, 6, 10, 3)).astype(np.float32)
    pooled = np.asarray(max_pool2x(jnp.asarray(x)))
    np.testing.assert_array_equal(
        pooled, x.reshape(2, 3, 2, 5, 2, 3).max(axis=(2, 4)))
    up = np.asarray(upsample2x(jnp.asarray(x)))
    np.testing.assert_array_equal(up, x.repeat(2, 1).repeat(2, 2))


def test_init_and_forward_match_flax_linen():
    """The same key gives the same weights and outputs as the flax.linen
    modules these replace (where flax is installed)."""
    nn = pytest.importorskip("flax.linen")

    class FlaxRespond(nn.Module):
        @nn.compact
        def __call__(self, x):
            x = nn.relu(nn.Conv(32, (3, 3), padding="SAME", name="conv1_1")(x))
            return nn.relu(nn.Conv(8, (1, 1), padding="SAME",
                                   name="conv1_1_2")(x))

    class FlaxEncoder(nn.Module):
        @nn.compact
        def __call__(self, x):
            x = x[..., None]
            for name, f in (("conv1", 8), ("conv2", 16)):
                x = nn.tanh(nn.Conv(f, (3, 3, 3), padding="SAME", name=name)(x))
                x = nn.max_pool(x, (2, 2, 2), strides=(2, 2, 2),
                                padding="SAME")
            x = nn.tanh(nn.Conv(32, (3, 3, 3), padding="SAME", name="conv3")(x))
            x = nn.tanh(nn.Dense(200, name="fn1")(x.reshape(x.shape[0], -1)))
            return nn.tanh(nn.Dense(20, name="fn2")(x))

    rng = np.random.default_rng(3)
    for ours, theirs, shape in ((RespondLayer(), FlaxRespond(), (1, 16, 24, 3)),
                                (PatchEncoder(), FlaxEncoder(), (2, 16, 16, 16))):
        key = jax.random.key(0)
        p_ours = ours.init(key, jnp.zeros(shape))
        p_theirs = theirs.init(key, jnp.zeros(shape))
        assert jax.tree.structure(p_ours) == jax.tree.structure(p_theirs)
        for a, b in zip(jax.tree.leaves(p_ours), jax.tree.leaves(p_theirs)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        x = jnp.asarray(rng.normal(size=shape).astype(np.float32))
        np.testing.assert_array_equal(np.asarray(ours.apply(p_ours, x)),
                                      np.asarray(theirs.apply(p_theirs, x)))


@pytest.mark.gpu
def test_models_on_gpu_match_cpu_at_highest_precision(gpu):
    cpu = jax.devices("cpu")[0]
    rng = np.random.default_rng(4)
    for cls, shape in ((RespondLayer, (1, 64, 1792, 3)),
                       (PatchEncoder, (256, 16, 16, 16))):
        params = cls().init(jax.random.key(0), jnp.zeros((1,) + shape[1:]))
        x = rng.normal(size=shape).astype(np.float32)
        with jax.default_matmul_precision("highest"):
            outs = [np.asarray(jax.jit(cls().apply)(
                *jax.device_put((params, x), d))) for d in (gpu, cpu)]
        scale = np.abs(outs[1]).max()
        assert np.abs(outs[0] - outs[1]).max() <= 1e-5 * scale
