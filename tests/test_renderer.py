"""Renderer correctness: the JAX renderer vs the numpy oracle.

Covers the BASELINE configuration matrix: SISO narrowband TD, OFDM wideband,
MIMO arrays, rotations + FoV + dipole patterns, and Doppler time snapshots.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from deepmimo_tpu.ops.types import PathData, AntennaPanel, ChannelConfig
from deepmimo_tpu.ops.channel import render_channels
from oracle import oracle_channels, make_synthetic_paths


def _render(data, cfg, bs_rot=(0, 0, 0), ue_rot=(0, 0, 0), bs_spacing=0.5,
            ue_spacing=0.5):
    paths = PathData.from_numpy(
        power=data["power"], phase=data["phase"], delay=data["delay"],
        aoa_az=data["aoa_az"], aoa_el=data["aoa_el"],
        aod_az=data["aod_az"], aod_el=data["aod_el"],
        doppler_vel=data.get("doppler_vel"),
        doppler_acc=data.get("doppler_acc"),
        dtype=jnp.float64)
    bs = AntennaPanel.make(bs_rot, bs_spacing, dtype=jnp.float64)
    ue = AntennaPanel.make(ue_rot, ue_spacing, dtype=jnp.float64)
    return np.asarray(render_channels(paths, bs, ue, cfg))


F64 = dict(dtype="complex128")


def test_siso_narrowband_time_domain():
    """BASELINE config #1: single antennas, time domain."""
    data = make_synthetic_paths(n_ue=24, max_paths=8, seed=10)
    cfg = ChannelConfig(bs_shape=(1, 1), ue_shape=(1, 1), freq_domain=False,
                        num_paths=8, **F64)
    got = _render(data, cfg)
    ref = oracle_channels(**{k: data[k] for k in
                             ("power", "phase", "delay", "aoa_az", "aoa_el",
                              "aod_az", "aod_el")},
                          bs_shape=(1, 1), ue_shape=(1, 1),
                          freq_domain=False, num_paths=8)
    np.testing.assert_allclose(got, ref, atol=1e-12)


def test_ofdm_wideband_siso():
    """BASELINE config #2: 512-subcarrier OFDM phase ramp."""
    data = make_synthetic_paths(n_ue=16, max_paths=10, seed=11)
    sel = tuple(range(0, 512, 64))
    cfg = ChannelConfig(bs_shape=(1, 1), ue_shape=(1, 1), freq_domain=True,
                        subcarriers=512, selected_subcarriers=sel,
                        bandwidth=10e6, num_paths=10, **F64)
    got = _render(data, cfg)
    ref = oracle_channels(**{k: data[k] for k in
                             ("power", "phase", "delay", "aoa_az", "aoa_el",
                              "aod_az", "aod_el")},
                          bs_shape=(1, 1), ue_shape=(1, 1), freq_domain=True,
                          n_fft=512, selected_subcarriers=sel,
                          bandwidth=10e6, num_paths=10)
    np.testing.assert_allclose(got, ref, atol=1e-12)


def test_mimo_upa_ofdm():
    """BASELINE config #3: 8x64 MIMO UPA with isotropic patterns."""
    data = make_synthetic_paths(n_ue=8, max_paths=6, seed=12)
    cfg = ChannelConfig(bs_shape=(8, 8), ue_shape=(2, 4), freq_domain=True,
                        subcarriers=64, selected_subcarriers=(0, 7, 31),
                        num_paths=6, **F64)
    got = _render(data, cfg)
    ref = oracle_channels(**{k: data[k] for k in
                             ("power", "phase", "delay", "aoa_az", "aoa_el",
                              "aod_az", "aod_el")},
                          bs_shape=(8, 8), ue_shape=(2, 4), freq_domain=True,
                          n_fft=64, selected_subcarriers=(0, 7, 31),
                          num_paths=6)
    assert got.shape == (8, 8, 64, 3)
    np.testing.assert_allclose(got, ref, atol=1e-12)


def test_rotations_fov_dipole():
    """BASELINE config #4: rotated arrays + FoV + halfwave dipole."""
    data = make_synthetic_paths(n_ue=12, max_paths=9, seed=13)
    bs_rot, ue_rot = (10.0, 20.0, 30.0), (-15.0, 5.0, 120.0)
    cfg = ChannelConfig(bs_shape=(4, 2), ue_shape=(2, 1), freq_domain=True,
                        subcarriers=128, selected_subcarriers=(0, 5),
                        bs_pattern="halfwave-dipole",
                        ue_pattern="halfwave-dipole",
                        bs_fov=(120.0, 90.0), ue_fov=(180.0, 120.0),
                        num_paths=9, **F64)
    got = _render(data, cfg, bs_rot=bs_rot, ue_rot=ue_rot)
    ref = oracle_channels(**{k: data[k] for k in
                             ("power", "phase", "delay", "aoa_az", "aoa_el",
                              "aod_az", "aod_el")},
                          bs_shape=(4, 2), ue_shape=(2, 1), freq_domain=True,
                          n_fft=128, selected_subcarriers=(0, 5),
                          bs_rotation=bs_rot, ue_rotation=ue_rot,
                          bs_pattern="halfwave-dipole",
                          ue_pattern="halfwave-dipole",
                          bs_fov=(120.0, 90.0), ue_fov=(180.0, 120.0),
                          num_paths=9)
    np.testing.assert_allclose(got, ref, atol=1e-12)


def test_per_user_rotations():
    data = make_synthetic_paths(n_ue=6, max_paths=5, seed=14)
    rng = np.random.RandomState(99)
    ue_rot = rng.uniform(-180, 180, (6, 3))
    cfg = ChannelConfig(bs_shape=(2, 2), ue_shape=(1, 1), freq_domain=True,
                        subcarriers=32, selected_subcarriers=(0,),
                        num_paths=5, **F64)
    got = _render(data, cfg, ue_rot=ue_rot)
    ref = oracle_channels(**{k: data[k] for k in
                             ("power", "phase", "delay", "aoa_az", "aoa_el",
                              "aod_az", "aod_el")},
                          bs_shape=(2, 2), ue_shape=(1, 1), freq_domain=True,
                          n_fft=32, selected_subcarriers=(0,),
                          ue_rotation=ue_rot, num_paths=5)
    np.testing.assert_allclose(got, ref, atol=1e-12)


def test_rx_filter_lpf():
    data = make_synthetic_paths(n_ue=5, max_paths=4, seed=15)
    sel = (0, 3, 9)
    cfg = ChannelConfig(bs_shape=(2, 1), ue_shape=(1, 1), freq_domain=True,
                        subcarriers=32, selected_subcarriers=sel,
                        rx_filter=True, num_paths=4, **F64)
    got = _render(data, cfg)
    ref = oracle_channels(**{k: data[k] for k in
                             ("power", "phase", "delay", "aoa_az", "aoa_el",
                              "aod_az", "aod_el")},
                          bs_shape=(2, 1), ue_shape=(1, 1), freq_domain=True,
                          n_fft=32, selected_subcarriers=sel, rx_filter=True,
                          num_paths=4)
    np.testing.assert_allclose(got, ref, atol=1e-10)


def test_paths_over_fft_are_trimmed():
    data = make_synthetic_paths(n_ue=4, max_paths=4, seed=16, all_valid=True)
    # Make half the delays exceed the OFDM symbol (N * Ts = 32/10e6 = 3.2us)
    data["delay"][:, ::2] = 1e-3
    cfg = ChannelConfig(bs_shape=(1, 1), ue_shape=(1, 1), freq_domain=True,
                        subcarriers=32, selected_subcarriers=(0, 1),
                        num_paths=4, **F64)
    got = _render(data, cfg)
    ref = oracle_channels(**{k: data[k] for k in
                             ("power", "phase", "delay", "aoa_az", "aoa_el",
                              "aod_az", "aod_el")},
                          bs_shape=(1, 1), ue_shape=(1, 1), freq_domain=True,
                          n_fft=32, selected_subcarriers=(0, 1), num_paths=4)
    np.testing.assert_allclose(got, ref, atol=1e-12)
    assert np.all(np.isfinite(got))


def test_doppler_time_snapshots():
    """BASELINE config #5: Doppler phase over time snapshots."""
    data = make_synthetic_paths(n_ue=6, max_paths=5, seed=17,
                                with_doppler=True)
    times = (0.0, 1e-3, 2e-3)
    cfg = ChannelConfig(bs_shape=(4, 1), ue_shape=(1, 1), freq_domain=True,
                        subcarriers=64, selected_subcarriers=(0, 8),
                        num_paths=5, enable_doppler=True,
                        carrier_freq=3.5e9, doppler_times=times, **F64)
    got = _render(data, cfg)
    assert got.shape == (6, 1, 4, 2, 3)
    for i, t in enumerate(times):
        ref = oracle_channels(
            **{k: data[k] for k in ("power", "phase", "delay", "aoa_az",
                                    "aoa_el", "aod_az", "aod_el")},
            bs_shape=(4, 1), ue_shape=(1, 1), freq_domain=True, n_fft=64,
            selected_subcarriers=(0, 8), num_paths=5,
            doppler_vel=data["doppler_vel"], doppler_acc=data["doppler_acc"],
            carrier_freq=3.5e9, doppler_time=None if t == 0.0 else t)
        np.testing.assert_allclose(got[..., i], ref, atol=1e-10)


def test_doppler_t0_matches_v3_semantics():
    """At t=0 the Doppler phase uses the path's own delay (v3 formula)."""
    data = make_synthetic_paths(n_ue=4, max_paths=3, seed=18,
                                with_doppler=True)
    cfg = ChannelConfig(bs_shape=(2, 1), ue_shape=(1, 1), freq_domain=True,
                        subcarriers=32, selected_subcarriers=(0,),
                        num_paths=3, enable_doppler=True,
                        carrier_freq=28e9, doppler_times=(0.0,), **F64)
    got = _render(data, cfg)
    ref = oracle_channels(
        **{k: data[k] for k in ("power", "phase", "delay", "aoa_az",
                                "aoa_el", "aod_az", "aod_el")},
        bs_shape=(2, 1), ue_shape=(1, 1), freq_domain=True, n_fft=32,
        selected_subcarriers=(0,), num_paths=3,
        doppler_vel=data["doppler_vel"], doppler_acc=data["doppler_acc"],
        carrier_freq=28e9)
    np.testing.assert_allclose(got, ref, atol=1e-10)


def test_time_domain_compacts_valid_paths_to_front():
    """With FoV filtering, TD output packs surviving paths at the front."""
    data = make_synthetic_paths(n_ue=10, max_paths=7, seed=19)
    cfg = ChannelConfig(bs_shape=(2, 1), ue_shape=(1, 1), freq_domain=False,
                        ue_fov=(180.0, 90.0), num_paths=7, **F64)
    got = _render(data, cfg)
    ref = oracle_channels(**{k: data[k] for k in
                             ("power", "phase", "delay", "aoa_az", "aoa_el",
                              "aod_az", "aod_el")},
                          bs_shape=(2, 1), ue_shape=(1, 1),
                          freq_domain=False, ue_fov=(180.0, 90.0),
                          num_paths=7)
    np.testing.assert_allclose(got, ref, atol=1e-12)


def test_time_domain_compact_always_interior_holes():
    """compact_td_paths=True packs hand-built interior-invalid slots."""
    data = make_synthetic_paths(n_ue=6, max_paths=5, seed=21)
    # Punch a hole in the middle of every user's path list.
    for key in ("power", "phase", "delay", "aoa_az", "aoa_el", "aod_az",
                "aod_el"):
        data[key][:, 2] = np.nan
    got = _render(data, ChannelConfig(
        bs_shape=(2, 1), ue_shape=(1, 1), freq_domain=False, num_paths=5,
        compact_td_paths=True, **F64))
    ref = oracle_channels(**{k: data[k] for k in
                             ("power", "phase", "delay", "aoa_az", "aoa_el",
                              "aod_az", "aod_el")},
                          bs_shape=(2, 1), ue_shape=(1, 1),
                          freq_domain=False, num_paths=5)
    np.testing.assert_allclose(got, ref, atol=1e-12)
    # And "auto" (no FoV) must NOT compact: the hole slot stays zero.
    got_auto = _render(data, ChannelConfig(
        bs_shape=(2, 1), ue_shape=(1, 1), freq_domain=False, num_paths=5,
        **F64))
    assert np.all(got_auto[..., 2] == 0)


def test_float32_accuracy_vs_float64():
    """The f32 path stays within mixed-precision tolerance of f64."""
    data = make_synthetic_paths(n_ue=16, max_paths=8, seed=20)
    kw = dict(bs_shape=(4, 2), ue_shape=(2, 1), freq_domain=True,
              subcarriers=64, selected_subcarriers=(0, 5, 20), num_paths=8)
    got64 = _render(data, ChannelConfig(**kw, dtype="complex128"))

    paths32 = PathData.from_numpy(
        power=data["power"], phase=data["phase"], delay=data["delay"],
        aoa_az=data["aoa_az"], aoa_el=data["aoa_el"],
        aod_az=data["aod_az"], aod_el=data["aod_el"], dtype=jnp.float32)
    got32 = np.asarray(render_channels(
        paths32, AntennaPanel.make(), AntennaPanel.make(),
        ChannelConfig(**kw, dtype="complex64")))

    scale = np.abs(got64).max()
    assert scale > 0
    np.testing.assert_allclose(got32, got64, atol=5e-5 * scale)


def test_rx_filter_full_band_fft_path():
    """LPF with all subcarriers selected uses the FFT path; same values."""
    data = make_synthetic_paths(n_ue=4, max_paths=3, seed=23)
    n_fft = 16
    base = dict(bs_shape=(2, 1), ue_shape=(1, 1), freq_domain=True,
                subcarriers=n_fft, rx_filter=True, num_paths=3, **F64)
    full = _render(data, ChannelConfig(
        **base, selected_subcarriers=tuple(range(n_fft))))
    # Reference: DFT-matrix path via per-subcarrier selection
    ref = oracle_channels(**{k: data[k] for k in
                             ("power", "phase", "delay", "aoa_az", "aoa_el",
                              "aod_az", "aod_el")},
                          bs_shape=(2, 1), ue_shape=(1, 1), freq_domain=True,
                          n_fft=n_fft,
                          selected_subcarriers=tuple(range(n_fft)),
                          rx_filter=True, num_paths=3)
    np.testing.assert_allclose(full, ref, atol=1e-10)


@pytest.mark.parametrize("n_sel", [16, 64])
def test_rx_filter_complex64_product_path(n_sel):
    """compute_channels with the sinc receive filter at complex64 matches
    the float64 oracle, including 64 subcarriers under the product's
    packed plane layout (that config renders complex H and stacks it)."""
    import deepmimo_tpu as dm

    keys = ("power", "phase", "delay", "aoa_az", "aoa_el", "aod_az",
            "aod_el")
    data = make_synthetic_paths(n_ue=12, max_paths=6, seed=24)
    ds = dm.Dataset({**{k: np.float32(data[k]) for k in keys},
                     "rx_pos": np.zeros((12, 3), np.float32),
                     "tx_pos": np.zeros((1, 3), np.float32)})
    params = dm.ChannelGenParameters()
    params["bs_antenna"]["shape"] = np.array([4, 2])
    params["num_paths"] = 6
    params["ofdm"]["selected_subcarriers"] = np.arange(n_sel)
    params["ofdm"]["rx_filter"] = 1
    got = ds.compute_channels(params)
    ref = oracle_channels(*(np.float32(data[k]).astype(np.float64)
                            for k in keys), bs_shape=(4, 2),
                          selected_subcarriers=np.arange(n_sel),
                          rx_filter=True, num_paths=6)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=5e-5 * np.abs(ref).max())
