"""Independent NumPy oracle for channel synthesis.

A deliberately simple, loop-based implementation of the DeepMIMO channel
math (NaN-padded convention), written directly from the formulas. Used as
the golden reference for the JAX renderer — the same role the v3 generator
plays for the reference v4 (reference test/test_v3_correspondence.py).
"""

from __future__ import annotations

import numpy as np

LIGHTSPEED = 299_792_458.0


# ----------------------------------------------------------------------------
# Geometry
# ----------------------------------------------------------------------------

def oracle_rotate(rotation_deg, el_deg, az_deg):
    """Euler rotation of spherical angles; degrees in, radians out."""
    theta = np.deg2rad(np.asarray(el_deg, dtype=np.float64))
    phi = np.deg2rad(np.asarray(az_deg, dtype=np.float64))
    rot = np.deg2rad(np.asarray(rotation_deg, dtype=np.float64))
    if rot.ndim == 1:
        rot = rot[None, :]
    rx, ry, rz = rot[:, 0:1], rot[:, 1:2], rot[:, 2:3]

    sin_az, cos_az = np.sin(phi - rz), np.cos(phi - rz)
    sin_y, cos_y = np.sin(ry), np.cos(ry)
    sin_x, cos_x = np.sin(rx), np.cos(rx)
    sin_t, cos_t = np.sin(theta), np.cos(theta)

    theta_rot = np.arccos(np.clip(
        cos_y * cos_x * cos_t + sin_t * (sin_y * cos_x * cos_az -
                                         sin_x * sin_az), -1, 1))
    phi_rot = np.angle(
        (cos_y * sin_t * cos_az - sin_y * cos_t) +
        1j * (cos_y * sin_x * cos_t +
              sin_t * (sin_y * sin_x * cos_az + cos_x * sin_az)))
    return theta_rot, phi_rot


def oracle_fov_mask(fov_deg, theta_rad, phi_rad):
    fov = np.deg2rad(np.asarray(fov_deg, dtype=np.float64))
    theta = np.mod(theta_rad, 2 * np.pi)
    phi = np.mod(phi_rad, 2 * np.pi)
    inc_phi = (phi <= fov[0] / 2) | (phi >= 2 * np.pi - fov[0] / 2)
    inc_theta = (theta <= np.pi / 2 + fov[1] / 2) & \
                (theta >= np.pi / 2 - fov[1] / 2)
    return inc_phi & inc_theta


def oracle_ant_positions(shape):
    m1, m2 = shape
    y = np.tile(np.arange(m1), m2)
    z = np.repeat(np.arange(m2), m1)
    return np.stack([np.zeros_like(y), y, z], 1).astype(np.float64)


def oracle_array_response(shape, spacing, theta_rad, phi_rad):
    """[N] complex response for scalar angles."""
    kd = 2 * np.pi * spacing
    kvec = kd * np.array([np.sin(theta_rad) * np.cos(phi_rad),
                          np.sin(theta_rad) * np.sin(phi_rad),
                          np.cos(theta_rad)])
    return np.exp(1j * oracle_ant_positions(shape) @ kvec)


def oracle_pattern(name, theta_rad):
    if name == "isotropic":
        return np.ones_like(theta_rad)
    if name == "halfwave-dipole":
        sin_t = np.sin(theta_rad)
        out = np.zeros_like(theta_rad)
        ok = np.abs(sin_t) > 1e-10
        out[ok] = 1.643 * np.cos(np.pi / 2 * np.cos(theta_rad[ok])) ** 2 \
            / sin_t[ok]
        return out
    raise ValueError(name)


# ----------------------------------------------------------------------------
# Channel synthesis (per-user loop, NaN-padded)
# ----------------------------------------------------------------------------

def oracle_channels(power, phase, delay, aoa_az, aoa_el,
                    aod_az, aod_el,
                    bs_shape=(8, 1), ue_shape=(1, 1),
                    bs_spacing=0.5, ue_spacing=0.5,
                    bs_rotation=(0, 0, 0), ue_rotation=(0, 0, 0),
                    bs_pattern="isotropic", ue_pattern="isotropic",
                    bs_fov=None, ue_fov=None,
                    freq_domain=True, n_fft=512, selected_subcarriers=(0,),
                    bandwidth=10e6, rx_filter=False, num_paths=25,
                    doppler_vel=None, doppler_acc=None, carrier_freq=3.5e9,
                    doppler_time=None):
    """NaN-padded inputs [U, P]; returns [U, R, T, K or num_paths] complex."""
    power_dbw = np.asarray(power, dtype=np.float64)[:, :num_paths]
    phase_deg = np.asarray(phase, dtype=np.float64)[:, :num_paths]
    delay_s = np.asarray(delay, dtype=np.float64)[:, :num_paths]
    aoa_az = np.asarray(aoa_az, dtype=np.float64)[:, :num_paths]
    aoa_el = np.asarray(aoa_el, dtype=np.float64)[:, :num_paths]
    aod_az = np.asarray(aod_az, dtype=np.float64)[:, :num_paths]
    aod_el = np.asarray(aod_el, dtype=np.float64)[:, :num_paths]
    if doppler_vel is not None:
        doppler_vel = np.asarray(doppler_vel, dtype=np.float64)[:, :num_paths]
        doppler_acc = np.asarray(doppler_acc, dtype=np.float64)[:, :num_paths]

    n_ue, n_p = power_dbw.shape
    n_rx = int(np.prod(ue_shape))
    n_tx = int(np.prod(bs_shape))
    sel = np.asarray(selected_subcarriers)
    ts = 1.0 / bandwidth

    # Rotated angles (radians)
    aod_t, aod_p = oracle_rotate(bs_rotation, aod_el, aod_az)
    aoa_t, aoa_p = oracle_rotate(ue_rotation, aoa_el, aoa_az)

    # FoV mask on rotated angles
    fov_mask = ~np.isnan(power_dbw)
    if bs_fov is not None and not (bs_fov[0] >= 360 and bs_fov[1] >= 180):
        fov_mask &= oracle_fov_mask(bs_fov, aod_t, aod_p)
    if ue_fov is not None and not (ue_fov[0] >= 360 and ue_fov[1] >= 180):
        fov_mask &= oracle_fov_mask(ue_fov, aoa_t, aoa_p)

    # Pattern gains on rotated angles; power in Watts
    power_lin = 10 ** (power_dbw / 10) * \
        oracle_pattern(bs_pattern, np.nan_to_num(aod_t)) * \
        oracle_pattern(ue_pattern, np.nan_to_num(aoa_t))

    last = len(sel) if freq_domain else n_p
    channel = np.zeros((n_ue, n_rx, n_tx, last), dtype=np.complex128)

    for u in range(n_ue):
        mask = fov_mask[u]
        idxs = np.where(mask)[0]
        if len(idxs) == 0:
            continue
        a_tx = np.stack([oracle_array_response(bs_shape, bs_spacing,
                                               aod_t[u, p], aod_p[u, p])
                         for p in idxs], axis=1)        # [T, np]
        a_rx = np.stack([oracle_array_response(ue_shape, ue_spacing,
                                               aoa_t[u, p], aoa_p[u, p])
                         for p in idxs], axis=1)        # [R, np]
        prod = a_rx[:, None, :] * a_tx[None, :, :]      # [R, T, np]

        pw = power_lin[u, idxs]
        ph = np.deg2rad(phase_deg[u, idxs])
        dl = delay_s[u, idxs]

        if freq_domain:
            delay_n = dl / ts
            over = delay_n >= n_fft
            amp = np.sqrt(np.where(over, 0.0, pw) / n_fft)
            if rx_filter:
                d = np.arange(n_fft)
                dn = np.where(over, n_fft, delay_n)
                taps = amp[:, None] * np.exp(1j * ph)[:, None] * \
                    np.sinc(d[None, :] - dn[:, None])
                if doppler_vel is not None:
                    tau = d * ts
                    t0 = tau if doppler_time is None else tau + doppler_time
                    dop = np.exp(-1j * 2 * np.pi * carrier_freq *
                                 (doppler_vel[u, idxs][:, None] * t0 /
                                  LIGHTSPEED +
                                  doppler_acc[u, idxs][:, None] * t0 ** 2 /
                                  (2 * LIGHTSPEED)))
                    taps = taps * dop
                dft = np.exp(-1j * 2 * np.pi / n_fft *
                             np.outer(d, sel))
                gains = taps @ dft                      # [np, K]
            else:
                dn = np.where(over, n_fft, delay_n)
                gains = amp[:, None] * np.exp(1j * (
                    ph[:, None] - 2 * np.pi / n_fft * np.outer(dn, sel)))
                if doppler_vel is not None:
                    t0 = dl if doppler_time is None else dl + doppler_time
                    dop = np.exp(-1j * 2 * np.pi * carrier_freq *
                                 (doppler_vel[u, idxs] * t0 / LIGHTSPEED +
                                  doppler_acc[u, idxs] * t0 ** 2 /
                                  (2 * LIGHTSPEED)))
                    gains = gains * dop[:, None]
            channel[u] = (prod[:, :, :, None] *
                          gains[None, None, :, :]).sum(axis=2)
        else:
            gains = np.sqrt(pw) * np.exp(1j * ph)
            if doppler_vel is not None:
                t0 = dl if doppler_time is None else dl + doppler_time
                gains = gains * np.exp(
                    -1j * 2 * np.pi * carrier_freq *
                    (doppler_vel[u, idxs] * t0 / LIGHTSPEED +
                     doppler_acc[u, idxs] * t0 ** 2 / (2 * LIGHTSPEED)))
            channel[u, :, :, :len(idxs)] = prod * gains[None, None, :]

    return channel


# ----------------------------------------------------------------------------
# Synthetic ray data
# ----------------------------------------------------------------------------

def make_synthetic_paths(n_ue=32, max_paths=10, seed=0, with_doppler=False,
                         all_valid=False):
    """Random NaN-padded path matrices shaped like a converted scenario."""
    rng = np.random.RandomState(seed)
    n_valid = rng.randint(0 if not all_valid else max_paths,
                          max_paths + 1, size=n_ue)
    if all_valid:
        n_valid[:] = max_paths

    def padded(draw):
        arr = np.full((n_ue, max_paths), np.nan)
        for u in range(n_ue):
            arr[u, :n_valid[u]] = draw(n_valid[u])
        return arr

    data = {
        "power": padded(lambda n: rng.uniform(-130, -60, n)),
        "phase": padded(lambda n: rng.uniform(-180, 180, n)),
        "delay": padded(lambda n: rng.uniform(1e-7, 4e-5, n)),
        "aoa_az": padded(lambda n: rng.uniform(-180, 180, n)),
        "aoa_el": padded(lambda n: rng.uniform(0, 180, n)),
        "aod_az": padded(lambda n: rng.uniform(-180, 180, n)),
        "aod_el": padded(lambda n: rng.uniform(0, 180, n)),
    }
    if with_doppler:
        data["doppler_vel"] = padded(lambda n: rng.uniform(-30, 30, n))
        data["doppler_acc"] = padded(lambda n: rng.uniform(-5, 5, n))
    data["n_valid"] = n_valid
    return data
