"""Unit tests: geometry kernels vs the independent numpy oracle."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from deepmimo_tpu.ops import geometry as geo
from oracle import (oracle_rotate, oracle_fov_mask, oracle_ant_positions,
                    oracle_array_response)


def test_rotate_angles_matches_oracle():
    rng = np.random.RandomState(0)
    el = rng.uniform(0, 180, (16, 7))
    az = rng.uniform(-180, 180, (16, 7))
    rot = np.array([10.0, -20.0, 135.0])

    t_ref, p_ref = oracle_rotate(rot, el, az)
    t, p = geo.rotate_angles(jnp.asarray(rot, dtype=jnp.float64),
                             jnp.asarray(el, dtype=jnp.float64),
                             jnp.asarray(az, dtype=jnp.float64))
    np.testing.assert_allclose(np.asarray(t), t_ref, atol=1e-12)
    np.testing.assert_allclose(np.asarray(p), p_ref, atol=1e-12)


def test_rotate_angles_per_user_rotation():
    rng = np.random.RandomState(1)
    n_ue, n_p = 8, 5
    el = rng.uniform(0, 180, (n_ue, n_p))
    az = rng.uniform(-180, 180, (n_ue, n_p))
    rot = rng.uniform(-180, 180, (n_ue, 3))

    t_ref, p_ref = oracle_rotate(rot, el, az)
    t, p = geo.rotate_angles(jnp.asarray(rot, dtype=jnp.float64),
                             jnp.asarray(el, dtype=jnp.float64),
                             jnp.asarray(az, dtype=jnp.float64))
    np.testing.assert_allclose(np.asarray(t), t_ref, atol=1e-12)
    np.testing.assert_allclose(np.asarray(p), p_ref, atol=1e-12)


def test_rotate_zero_rotation_is_identity():
    rng = np.random.RandomState(2)
    el = rng.uniform(1, 179, (4, 6))
    az = rng.uniform(-179, 179, (4, 6))
    t, p = geo.rotate_angles(jnp.zeros(3, dtype=jnp.float64),
                             jnp.asarray(el, dtype=jnp.float64),
                             jnp.asarray(az, dtype=jnp.float64))
    np.testing.assert_allclose(np.asarray(t), np.deg2rad(el), atol=1e-12)
    # azimuth wraps to (-pi, pi]
    np.testing.assert_allclose(
        np.mod(np.asarray(p) - np.deg2rad(az) + np.pi, 2 * np.pi) - np.pi,
        0, atol=1e-12)


def test_fov_mask_matches_oracle():
    rng = np.random.RandomState(3)
    theta = rng.uniform(-2 * np.pi, 2 * np.pi, (10, 9))
    phi = rng.uniform(-2 * np.pi, 2 * np.pi, (10, 9))
    for fov in ([120.0, 60.0], [360.0, 30.0], [90.0, 180.0]):
        ref = oracle_fov_mask(fov, theta, phi)
        got = np.asarray(geo.apply_fov(fov, jnp.asarray(theta),
                                       jnp.asarray(phi)))
        np.testing.assert_array_equal(got, ref)


def test_ant_indices_layout():
    # (M1, M2) panel lives in the y-z plane: x = 0 everywhere
    idx = geo.ant_indices((3, 2))
    assert idx.shape == (6, 3)
    np.testing.assert_array_equal(idx, oracle_ant_positions((3, 2)))
    np.testing.assert_array_equal(idx[:, 0], 0)


@pytest.mark.parametrize("shape", [(1, 1), (8, 1), (4, 2)])
def test_array_response_matches_oracle(shape):
    rng = np.random.RandomState(4)
    theta = rng.uniform(0, np.pi, (5, 6))
    phi = rng.uniform(-np.pi, np.pi, (5, 6))
    spacing = 0.5

    got = np.asarray(geo.array_response(
        shape, jnp.asarray(spacing, dtype=jnp.float64),
        jnp.asarray(theta), jnp.asarray(phi), dtype=jnp.complex128))
    for u in range(5):
        for p in range(6):
            ref = oracle_array_response(shape, spacing, theta[u, p],
                                        phi[u, p])
            np.testing.assert_allclose(got[u, :, p], ref, atol=1e-12)


def test_array_response_invalid_paths_zeroed():
    theta = jnp.ones((2, 3), dtype=jnp.float64)
    phi = jnp.ones((2, 3), dtype=jnp.float64)
    valid = jnp.asarray([[True, False, True], [False, False, True]])
    resp = np.asarray(geo.array_response((2, 2), jnp.asarray(0.5), theta,
                                         phi, valid))
    assert np.all(resp[0, :, 1] == 0)
    assert np.all(resp[1, :, :2] == 0)
    assert np.all(resp[0, :, 0] != 0)


def test_safe_arccos_gradient_finite_at_boundary():
    g = jax.grad(lambda x: geo.safe_arccos(x))(jnp.asarray(1.0))
    assert np.isfinite(np.asarray(g))
    g = jax.grad(lambda x: geo.safe_arccos(x))(jnp.asarray(-1.0))
    assert np.isfinite(np.asarray(g))
    # Inside the clamp the gradient is exact, in float32 and float64:
    # d arccos(x)/dx = -1/sin(t) at x = cos(t), 0.001 deg from the pole.
    t = np.deg2rad(1e-3)
    g = jax.grad(geo.safe_arccos)(jnp.asarray(np.cos(t), jnp.float64))
    np.testing.assert_allclose(float(g), -1 / np.sin(t), rtol=1e-6)
    g = jax.grad(geo.safe_arccos)(jnp.asarray(0.5, jnp.float32))
    np.testing.assert_allclose(float(g), -1 / np.sqrt(0.75), rtol=1e-6)


def test_steering_vec_normalized():
    v = geo.steering_vec((8, 1), phi=30.0, theta=10.0, spacing=0.5)
    assert v.shape == (8,)
    np.testing.assert_allclose(np.linalg.norm(v), 1.0, atol=1e-12)
