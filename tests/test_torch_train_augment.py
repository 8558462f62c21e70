"""The port's on-device augmentation vs the JAX package's, fed the draws
``jax.random`` makes from the same keys (the test draws them again with
the JAX functions' own calls), on the CPU.

- Flip: bit for bit, landmark identities swapped.
- Rotation: the port's plain warp (what a CPU tensor runs) against
  ``warp_affine_pallas(construction="legacy")`` in interpret mode, the
  kernel the TPU's train step runs, compiled without excess precision as
  ``tests/test_torch_warp_kernels.py`` does. Its tolerance class scaled
  to normalized pixels: one bf16 tap step times the largest |pixel| plus
  half a bf16 ulp of the largest output, on under 1% of the values.
  Landmarks within 1e-5.
- Color jitter: within 1e-6.
- ``make_augment_fn``: off unless enabled; on, the batch keeps its
  shapes and draws come from the generator alone.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from deepfake_vit_tpu.ops import augment as jaug
from deepfake_vit_tpu.ops.pallas.warp_kernel import warp_affine_pallas
from deepfake_vit_tpu_torch.ops import augment as taug

torch.set_num_threads(1)

B, H, W = 6, 64, 64
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    rgb = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    images = (rgb - IMAGENET_MEAN) / IMAGENET_STD  # normalized: negative values included
    landmarks = rng.uniform(5, 58, (B, 5, 2)).astype(np.float32)
    return images, landmarks


def test_flip_matches(batch):
    images, lms = batch
    key = jax.random.PRNGKey(3)
    ref_i, ref_l = jaug.random_flip(jnp.asarray(images), jnp.asarray(lms), key)
    mask = np.asarray(jax.random.bernoulli(key, 0.5, (B,)))
    assert 0 < mask.sum() < B
    got_i, got_l = taug.flip(torch.from_numpy(images), torch.from_numpy(lms),
                             torch.from_numpy(mask.copy()))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))
    i = int(np.argmax(mask))
    np.testing.assert_array_equal(got_l[i, 0].numpy(), [W - 1 - lms[i, 1, 0], lms[i, 1, 1]])


def test_rotation_matches_the_pallas_kernel(batch):
    images, lms = batch
    key, deg = jax.random.PRNGKey(4), 5.0
    _, ref_l = jaug.random_rotation(jnp.asarray(images), jnp.asarray(lms), key, deg)
    theta = jax.random.uniform(key, (B,), minval=-deg, maxval=deg) * (jnp.pi / 180.0)
    cos, sin = jnp.cos(theta), jnp.sin(theta)
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    A = jnp.stack([jnp.stack([cos, -sin, cx - cos * cx + sin * cy], -1),
                   jnp.stack([sin, cos, cy - sin * cx - cos * cy], -1)], axis=1)
    with pltpu.force_tpu_interpret_mode():
        fn = lambda x, a: warp_affine_pallas(x, a, (H, W), construction="legacy")  # noqa: E731
        compiled = jax.jit(fn).lower(jnp.asarray(images), A).compile(
            compiler_options={"xla_allow_excess_precision": False})
        ref_i = np.asarray(compiled(jnp.asarray(images), A).astype(jnp.float32))

    got_i, got_l = taug.rotate(torch.from_numpy(images), torch.from_numpy(lms),
                               torch.from_numpy(np.array(theta)))
    np.testing.assert_allclose(
        taug.rotation_matrices(torch.from_numpy(np.asarray(theta)), (H, W)).numpy(),
        np.asarray(A), rtol=0, atol=1e-5)
    diff = np.abs(got_i.numpy() - ref_i)
    top = float(np.abs(ref_i).max())
    tol = float(np.abs(images).max()) * 2.0 ** -8 + 0.5 * 2.0 ** (math.floor(math.log2(top)) - 7)
    assert diff.max() <= tol, (diff.max(), tol)
    assert np.mean(diff > 0) < 0.01, np.mean(diff > 0)
    assert (ref_i < 0).any() and (ref_i == 0).any()  # normalized values, border zeros
    np.testing.assert_allclose(got_l.numpy(), np.asarray(ref_l), rtol=0, atol=1e-5)


def test_color_jitter_matches(batch):
    images, _ = batch
    key, strength = jax.random.PRNGKey(5), 0.1
    ref = np.asarray(jaug.color_jitter(jnp.asarray(images), key, strength))
    k1, k2 = jax.random.split(key)
    brightness = jax.random.uniform(k1, (B, 1, 1, 1), minval=-strength, maxval=strength)
    contrast = 1.0 + jax.random.uniform(k2, (B, 1, 1, 1), minval=-strength, maxval=strength)
    got = taug.jitter(torch.from_numpy(images), torch.from_numpy(np.asarray(brightness)),
                      torch.from_numpy(np.asarray(contrast))).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_make_augment_fn(batch):
    images, lms = batch
    assert taug.make_augment_fn(None) is None
    assert taug.make_augment_fn({"enabled": False, "random_rotation": 5}) is None
    aug = taug.make_augment_fn({"enabled": True, "random_flip": True, "random_rotation": 5,
                                "color_jitter": 0.1})
    tb = {"image": torch.from_numpy(images), "landmarks": torch.from_numpy(lms),
          "label": torch.zeros(B, dtype=torch.long)}
    a = aug(tb, torch.Generator().manual_seed(1))
    b = aug(tb, torch.Generator().manual_seed(1))
    c = aug(tb, torch.Generator().manual_seed(2))
    assert a["image"].shape == tb["image"].shape and a["landmarks"].shape == tb["landmarks"].shape
    assert torch.equal(a["image"], b["image"]) and torch.equal(a["landmarks"], b["landmarks"])
    assert not torch.equal(a["image"], c["image"])
    assert not a["image"].requires_grad and a["label"] is tb["label"]
    # The draws in order: flip, rotation, jitter.
    g = torch.Generator().manual_seed(1)
    x, lm = taug.random_flip(tb["image"], tb["landmarks"], g)
    x, lm = taug.random_rotation(x, lm, g, 5.0)
    x = taug.color_jitter(x, g, 0.1)
    assert torch.equal(x, a["image"]) and torch.equal(lm, a["landmarks"])
