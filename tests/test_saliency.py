"""The keypoint saliency map (``ops/nms.py``) against a float64 numpy
oracle, alone and through ``select_keypoints``, at the real respond-image
width; the ``gpu``-marked case repeats the check compiled for the card."""
import numpy as np
import pytest
import jax.numpy as jnp

from caelo_tpu.config import KeypointConfig, SensorConfig
from caelo_tpu.ops.nms import saliency_map, select_keypoints


def saliency_oracle(resp, occ, rad=2):
    """float64 min squared diff to occupied neighbours + their count."""
    H, W, _ = resp.shape
    w = 2 * rad + 1
    rp = np.pad(resp.astype(np.float64), ((rad, rad), (rad, rad), (0, 0)))
    op = np.pad(occ, rad)
    md = np.full((H, W), np.inf)
    cnt = np.zeros((H, W), np.int32)
    for dy in range(w):
        for dx in range(w):
            if dy == rad and dx == rad:
                continue
            o = op[dy:dy + H, dx:dx + W]
            d2 = ((rp[dy:dy + H, dx:dx + W]
                   - rp[rad:rad + H, rad:rad + W]) ** 2).sum(-1)
            md = np.minimum(md, np.where(o, d2, np.inf))
            cnt += o
    return md, cnt


def respond_image(rng, H, W, C=8, density=0.6):
    resp = rng.normal(size=(H, W, C)).astype(np.float32)
    occ = rng.uniform(size=(H, W)) < density
    return resp, occ


def check_against_oracle(md, cnt, resp, occ, rad=2):
    md_ref, cnt_ref = saliency_oracle(resp, occ, rad)
    md, cnt = np.asarray(md), np.asarray(cnt)
    np.testing.assert_array_equal(cnt, cnt_ref)
    fin = np.isfinite(md_ref)
    np.testing.assert_array_equal(np.isfinite(md), fin)
    # elementwise f32 sums of 8 squares, no matmul
    np.testing.assert_allclose(md[fin], md_ref[fin], rtol=1e-5, atol=1e-6)


def test_saliency_matches_oracle_at_real_width(rng):
    """The full 64 x 1792 x 8 respond image at ~60 % occupancy."""
    resp, occ = respond_image(rng, 64, 1792)
    check_against_oracle(*saliency_map(jnp.asarray(resp), jnp.asarray(occ)),
                         resp, occ)


@pytest.mark.parametrize("density", [0.0, 0.05, 1.0],
                         ids=["empty", "sparse", "full"])
@pytest.mark.parametrize("rad", [1, 2])
def test_saliency_matches_oracle_by_occupancy_and_window(rng, density, rad):
    """No occupied neighbour -> inf and count 0; the window radius is the
    config's ``window // 2``."""
    resp, occ = respond_image(rng, 13, 200, density=density)
    check_against_oracle(
        *saliency_map(jnp.asarray(resp), jnp.asarray(occ), rad),
        resp, occ, rad)


def test_select_keypoints_saliency_is_the_oracle_on_a_real_width_slice(rng):
    """``select_keypoints``' saliency output is sqrt(min_d2) of the oracle
    (0 where no occupied neighbour), and its keypoints are the highest of
    it among the gated pixels."""
    sensor = SensorConfig()
    kp = KeypointConfig(ground_z_max=-1000.0)
    H, W = sensor.n_lines, sensor.model_w
    resp, occ = respond_image(rng, H, W)
    image = np.zeros((sensor.img_h, sensor.img_w, 5), np.float32)
    image[..., :3] = rng.normal(size=image.shape[:2] + (3,)) * 20
    image[..., 4] = rng.uniform(5, 60, image.shape[:2])
    counter = np.zeros(image.shape[:2], np.int32)
    counter[:H, :W] = occ
    _, pixels, mask, sal = select_keypoints(
        jnp.asarray(image), jnp.asarray(counter), jnp.asarray(resp),
        sensor, kp)
    md_ref, cnt_ref = saliency_oracle(resp, occ)
    want = np.sqrt(np.where(np.isfinite(md_ref), md_ref, 0.0))
    np.testing.assert_allclose(np.asarray(sal), want, rtol=1e-5, atol=1e-6)
    pixels, mask = np.asarray(pixels), np.asarray(mask)
    assert mask.sum() == kp.n_keypoints
    r, c = pixels[:, 0], pixels[:, 1]
    e = sensor.edge_filter
    assert np.all(occ[r, c] & (cnt_ref[r, c] >= kp.min_neighbors))
    assert np.all((r >= e) & (r < H - e) & (c >= e) & (c < W - e))
    assert np.all(want[r, c] > kp.norm_diff_threshold)
    # top-k: no gated pixel outside the set beats the weakest chosen one
    rows, cols = np.arange(H)[:, None], np.arange(W)[None, :]
    gated = (occ & (cnt_ref >= kp.min_neighbors)
             & (want > kp.norm_diff_threshold)
             & (image[:H, :W, 4] >= sensor.visible_bottom)
             & (rows >= e) & (rows < H - e) & (cols >= e) & (cols < W - e))
    gated[r, c] = False
    assert want[gated].max() <= want[r, c].min() * (1 + 1e-6)


@pytest.mark.gpu
def test_saliency_compiled_on_gpu_matches_oracle(gpu, rng):
    import jax

    resp, occ = respond_image(rng, 64, 1792)
    out = jax.jit(saliency_map)(*jax.device_put((resp, occ), gpu))
    check_against_oracle(*out, resp, occ)
