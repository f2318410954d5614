"""Geometry kernels: Euler-angle rotation, FoV masks, array responses.

Vectorized, differentiable re-implementations of the reference geometry
subsystem (reference deepmimo/generator/geometry.py:19-339). Semantics match
the reference formulas exactly; the implementation differs:

- validity masks replace NaN propagation (NaNs poison gradients under jit),
- ``safe_arccos``/``safe_polar``/``safe_angle`` guard gradient
  singularities at |x| -> 1, on the polar axis and at the complex origin,
- everything is batched and shape-static so XLA can fuse into the channel
  renderer.

Angle conventions (scenario format): theta = elevation measured from the
z-axis (0..180 deg), phi = azimuth in the x-y plane. Inputs to the public
functions are in DEGREES, outputs of ``rotate_angles`` are RADIANS (matching
the reference pipeline, which stores rotated angles in radians).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


# ============================================================================
# Gradient-safe primitives
# ============================================================================

@jax.custom_jvp
def safe_arccos(x: jax.Array) -> jax.Array:
    """arccos with a clamped input and a bounded gradient at |x| -> 1.

    The gradient's clamp sits one machine epsilon of x's dtype inside
    +-1, so float64 gradients stay exact to within ~1e-8 rad of the
    poles (a fixed float32-sized margin would clip them within 0.03 deg).
    """
    return jnp.arccos(jnp.clip(x, -1.0, 1.0))


@safe_arccos.defjvp
def _safe_arccos_jvp(primals, tangents):
    (x,), (dx,) = primals, tangents
    eps = jnp.finfo(jnp.result_type(x, float)).eps
    xc = jnp.clip(x, -1.0 + eps, 1.0 - eps)
    primal = jnp.arccos(jnp.clip(x, -1.0, 1.0))
    tangent = -dx / jnp.sqrt(1.0 - xc * xc)
    return primal, tangent


def safe_polar(x: jax.Array, y: jax.Array, z: jax.Array) -> jax.Array:
    """Polar angle of the unit vector (x, y, z): atan2(hypot(x, y), z).

    Unlike arccos(z), whose float32 input has lost the angle near the
    poles (cos t rounds to 1 for t below ~3e-4 rad), this keeps the
    angle to float rounding everywhere; zero gradient on the axis.
    """
    r2 = x * x + y * y
    on_axis = r2 == 0
    r = jnp.where(on_axis, 0.0, jnp.sqrt(jnp.where(on_axis, 1.0, r2)))
    return jnp.arctan2(r, z)


def safe_angle(re: jax.Array, im: jax.Array) -> jax.Array:
    """atan2(im, re) that yields zero gradient (not NaN) at the origin."""
    mag2 = re * re + im * im
    safe = mag2 > 0
    re_s = jnp.where(safe, re, 1.0)
    return jnp.where(safe, jnp.arctan2(im, re_s), 0.0)


# ============================================================================
# Euler rotation of spherical angles
# ============================================================================

def rotate_angles(rotation_deg: jax.Array, el_deg: jax.Array,
                  az_deg: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Rotate spherical angles by array Euler rotation [x, y, z] (degrees).

    Rotation is applied z-axis first, then y, then x — the formulation used
    by the scenario toolchain (reference geometry.py:198-319; same closed
    form as 3GPP TR 38.901 §7.1-15/16 for the local-coordinate transform).

    Args:
        rotation_deg: [3] or [U, 3] Euler angles in degrees.
        el_deg: [U, P] elevation (theta) in degrees.
        az_deg: [U, P] azimuth (phi) in degrees.

    Returns:
        (theta_rot, phi_rot) in RADIANS, shape [U, P].
    """
    theta = jnp.deg2rad(el_deg)
    phi = jnp.deg2rad(az_deg)
    rot = jnp.deg2rad(jnp.asarray(rotation_deg))
    if rot.ndim == 1:
        rot = rot[None, :]
    rot_x = rot[:, 0:1]   # rotation about x
    rot_y = rot[:, 1:2]   # rotation about y
    rot_z = rot[:, 2:3]   # rotation about z

    x, y, z = _rotated_unit_components(rot_x, rot_y, rot_z, theta, phi)
    return safe_polar(x, y, z), safe_angle(x, y)


def _rotated_unit_components(rot_x, rot_y, rot_z, theta, phi):
    """(x', y', z') = unit vector of (theta, phi) in the rotated frame.

    x' = sin(theta')cos(phi'), y' = sin(theta')sin(phi'), z' = cos(theta')
    — the quantities rotate_angles converts to angles. All radians.
    """
    sin_az = jnp.sin(phi - rot_z)
    cos_az = jnp.cos(phi - rot_z)
    sin_y, cos_y = jnp.sin(rot_y), jnp.cos(rot_y)
    sin_x, cos_x = jnp.sin(rot_x), jnp.cos(rot_x)
    sin_t, cos_t = jnp.sin(theta), jnp.cos(theta)

    z = cos_y * cos_x * cos_t + \
        sin_t * (sin_y * cos_x * cos_az - sin_x * sin_az)
    x = cos_y * sin_t * cos_az - sin_y * cos_t
    y = cos_y * sin_x * cos_t + \
        sin_t * (sin_y * sin_x * cos_az + cos_x * sin_az)
    return x, y, z


def rotate_unit_vec(rotation_deg: jax.Array, el_deg: jax.Array,
                    az_deg: jax.Array
                    ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Rotated-frame unit-vector components (x', y', z') — the trig-domain
    composition of :func:`rotate_angles` + :func:`array_response_phase`.

    The fused render kernel needs only kd*y' and kd*z' (panel elements lie
    in the y-z plane), so going through angle space (two atan2 here, then
    sincos again in array_response_phase) is pure overhead. Identical
    values up to roundoff — sin(theta')sin(phi') == y' for a unit vector.
    """
    theta = jnp.deg2rad(el_deg)
    phi = jnp.deg2rad(az_deg)
    rot = jnp.deg2rad(jnp.asarray(rotation_deg))
    if rot.ndim == 1:
        rot = rot[None, :]
    return _rotated_unit_components(rot[:, 0:1], rot[:, 1:2], rot[:, 2:3],
                                    theta, phi)


# ============================================================================
# Field of view
# ============================================================================

def apply_fov(fov_deg, theta_rad: jax.Array, phi_rad: jax.Array) -> jax.Array:
    """Boolean inclusion mask for a [horizontal, vertical] FoV in degrees.

    Horizontal FoV is centered on azimuth 0; vertical FoV on elevation 90 deg
    (boresight). Matches reference geometry.py:123-195.
    """
    fov = jnp.deg2rad(jnp.asarray(fov_deg))
    theta = jnp.mod(theta_rad, 2 * jnp.pi)
    phi = jnp.mod(phi_rad, 2 * jnp.pi)
    incl_phi = (phi <= fov[0] / 2) | (phi >= 2 * jnp.pi - fov[0] / 2)
    incl_theta = ((theta <= jnp.pi / 2 + fov[1] / 2) &
                  (theta >= jnp.pi / 2 - fov[1] / 2))
    return incl_phi & incl_theta


def is_full_fov(fov_deg) -> bool:
    """Host-side check: does this FoV cover the whole sphere?"""
    fov = np.asarray(fov_deg)
    return bool(fov[0] >= 360 and fov[1] >= 180)


# ============================================================================
# Antenna array geometry
# ============================================================================

def ant_indices(panel_shape: Tuple[int, int]) -> np.ndarray:
    """Element positions (integer grid) of an (M1, M2) panel in the y-z plane.

    x = 0 for every element; y ranges over M1, z over M2 (the scenario-format
    panel convention, reference geometry.py:105-120). Returned as a numpy
    [N, 3] int array (static data baked into the jit trace).
    """
    m1, m2 = int(panel_shape[0]), int(panel_shape[1])
    y = np.tile(np.arange(m1), m2)
    z = np.repeat(np.arange(m2), m1)
    x = np.zeros_like(y)
    return np.stack([x, y, z], axis=1)


def array_response_phase(theta_rad: jax.Array, phi_rad: jax.Array,
                         kd: jax.Array) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Per-path wave-vector components (kx, ky, kz) scaled by kd.

    response[n] = exp(j * (pos_n . k_vec)) with
    k_vec = kd * [sin(theta)cos(phi), sin(theta)sin(phi), cos(theta)].
    """
    st = jnp.sin(theta_rad)
    return (kd * st * jnp.cos(phi_rad),
            kd * st * jnp.sin(phi_rad),
            kd * jnp.cos(theta_rad))


def array_response(panel_shape: Tuple[int, int], spacing: jax.Array,
                   theta_rad: jax.Array, phi_rad: jax.Array,
                   valid: Optional[jax.Array] = None,
                   dtype=jnp.complex64) -> jax.Array:
    """Complex array response for a panel, batched over users and paths.

    Args:
        panel_shape: static (M1, M2).
        spacing: element spacing in wavelengths (scalar, differentiable).
        theta_rad / phi_rad: [U, P] angles in radians.
        valid: optional [U, P] bool; invalid entries produce 0 responses.

    Returns:
        [U, N, P] complex response where N = M1*M2. Since panel x-positions
        are all zero, only the (y, z) phase components contribute.
    """
    kd = 2 * jnp.pi * spacing
    _, ky, kz = array_response_phase(theta_rad, phi_rad, kd)   # each [U, P]
    pos = ant_indices(panel_shape)                             # [N, 3] static
    y = jnp.asarray(pos[:, 1], dtype=theta_rad.dtype)
    z = jnp.asarray(pos[:, 2], dtype=theta_rad.dtype)
    # phase[u, n, p] = y_n * ky[u, p] + z_n * kz[u, p]
    phase = y[None, :, None] * ky[:, None, :] + z[None, :, None] * kz[:, None, :]
    resp = jnp.exp(1j * phase.astype(_real_dtype(dtype))).astype(dtype)
    if valid is not None:
        resp = jnp.where(valid[:, None, :], resp, 0)
    return resp


def _real_dtype(cdtype):
    return jnp.float64 if cdtype == jnp.complex128 else jnp.float32


def array_response_planes(panel_shape: Tuple[int, int], spacing: jax.Array,
                          theta_rad: jax.Array, phi_rad: jax.Array,
                          valid: Optional[jax.Array] = None
                          ) -> Tuple[jax.Array, jax.Array]:
    """Array response as (real, imag) planes.

    The planes path sums with real matmuls and returns real/imag planes,
    skipping a complex pass over H. Same math as :func:`array_response`.

    Returns:
        (re, im), each [U, N, P] in the angles' dtype.
    """
    kd = 2 * jnp.pi * spacing
    _, ky, kz = array_response_phase(theta_rad, phi_rad, kd)
    pos = ant_indices(panel_shape)
    y = jnp.asarray(pos[:, 1], dtype=theta_rad.dtype)
    z = jnp.asarray(pos[:, 2], dtype=theta_rad.dtype)
    phase = y[None, :, None] * ky[:, None, :] + \
        z[None, :, None] * kz[:, None, :]
    re, im = jnp.cos(phase), jnp.sin(phase)
    if valid is not None:
        v = valid[:, None, :]
        re = jnp.where(v, re, 0.0)
        im = jnp.where(v, im, 0.0)
    return re, im


# ============================================================================
# Public steering vector
# ============================================================================

def steering_vec(array, phi: float = 0, theta: float = 0,
                 spacing: float = 0.5) -> np.ndarray:
    """Normalized steering vector of an (M1, M2) panel toward (phi, theta).

    Matches the reference public helper (geometry.py:322-339) including its
    angle convention: the panel's polar angle is phi (degrees) and its
    azimuthal offset is theta + 90 degrees.
    """
    pos = ant_indices(array)
    kd = 2 * np.pi * spacing
    t = np.deg2rad(phi)
    p = np.deg2rad(theta) + np.pi / 2
    kvec = kd * np.array([np.sin(t) * np.cos(p),
                          np.sin(t) * np.sin(p),
                          np.cos(t)])
    resp = np.exp(1j * pos @ kvec)
    return resp / np.linalg.norm(resp)
