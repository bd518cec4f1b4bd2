"""PyTorch port: SE(2) algebra against slam2d_tpu.core.se2 (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam2d_tpu.core import se2 as jse2
from slam2d_tpu_torch.core import se2 as tse2

torch.set_num_threads(1)

_RNG = np.random.default_rng(0)
A = np.concatenate(
    [_RNG.uniform(-20, 20, (64, 2)), _RNG.uniform(-7, 7, (64, 1))], axis=1
).astype(np.float32)
B = np.concatenate(
    [_RNG.uniform(-2, 2, (64, 2)), _RNG.uniform(-4, 4, (64, 1))], axis=1
).astype(np.float32)
PTS = _RNG.uniform(-12, 12, (64, 9, 2)).astype(np.float32)

CASES = {
    "wrap_angle": (lambda m, a, b, p: m.wrap_angle(a[..., 2] * 3.0)),
    "compose": (lambda m, a, b, p: m.compose(a, b)),
    "inverse": (lambda m, a, b, p: m.inverse(a)),
    "between": (lambda m, a, b, p: m.between(a, b)),
    "transform_points": (lambda m, a, b, p: m.transform_points(a, p)),
    "rotate_points": (lambda m, a, b, p: m.rotate_points(a[..., 2], p)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_se2_matches_jax(name):
    fn = CASES[name]
    ref = np.asarray(fn(jse2, jnp.asarray(A), jnp.asarray(B), jnp.asarray(PTS)))
    out = fn(
        tse2, torch.from_numpy(A), torch.from_numpy(B), torch.from_numpy(PTS)
    ).numpy()
    assert out.shape == ref.shape and out.dtype == np.float32
    # float32 cos/sin of XLA and of PyTorch may differ in the last bit
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5)


BROADCASTS = {
    # the particle filter's forms: [P, 3] poses with one [1, 3] delta
    "compose_particles_delta": (lambda m, a, b: m.compose(a, b[None, 0])),
    "compose_delta_particles": (lambda m, a, b: m.compose(a[0], b)),
    "between_one_to_many": (lambda m, a, b: m.between(a[0], b)),
    "wrap_angle_particles": (lambda m, a, b: m.wrap_angle(a[:, 2:3] - b[:, 2])),
}


@pytest.mark.parametrize("name", sorted(BROADCASTS))
def test_se2_broadcasts_over_particles(name):
    fn = BROADCASTS[name]
    ref = np.asarray(fn(jse2, jnp.asarray(A), jnp.asarray(B)))
    out = fn(tse2, torch.from_numpy(A), torch.from_numpy(B)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5)


def test_wrap_angle_range():
    th = torch.linspace(-50.0, 50.0, 10001)
    w = tse2.wrap_angle(th)
    assert float(w.min()) >= -np.pi - 1e-6 and float(w.max()) <= np.pi + 1e-6
