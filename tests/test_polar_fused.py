"""Dual-polar single-dispatch device path: self-consistency tests.

The fused polar render (pol axis riding the kernel snapshot axis with
per-snapshot amplitudes, ops/channel.py render_channels_planes_polar)
must agree with the 4x-independent-render fallback for every supported
config, and the to_device / streamed variants must agree with the host
dict path. Reference behavior anchor: deepmimo_v3/generator/python/
generator.py:71-78 (four independent generator passes).
"""

import numpy as np
import pytest

import deepmimo_tpu as dm
from deepmimo_tpu.config import config
from deepmimo_tpu import consts as c
from scenario_utils import write_synthetic_scenario

POLS = ("VV", "VH", "HH", "HV")
N_UE = 20
MAX_PATHS = 6


def _dataset_with_pols(tmp_path, seed=3):
    folder = str(tmp_path / f"dp_{seed}")
    data = write_synthetic_scenario(folder, n_ue=N_UE, max_paths=MAX_PATHS,
                                    seed=seed, grid=(5, 4))
    ds = dm.load(folder)
    rng = np.random.RandomState(seed + 1)
    nanmask = np.isnan(data["power"])
    for pol in POLS:
        ds[f"power_{pol.lower()}"] = np.float32(np.where(
            nanmask, np.nan, rng.uniform(-120, -70, data["power"].shape)))
        ds[f"phase_{pol.lower()}"] = np.float32(np.where(
            nanmask, np.nan, rng.uniform(-180, 180, data["power"].shape)))
    return ds


def _params(**kw):
    p = dm.ChannelGenParameters()
    p[c.PARAMSET_POLAR_EN] = 1
    p[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_SHAPE] = \
        np.array(kw.pop("bs_shape", [4, 2]))
    p[c.PARAMSET_ANT_UE][c.PARAMSET_ANT_SHAPE] = \
        np.array(kw.pop("ue_shape", [1, 1]))
    p[c.PARAMSET_OFDM][c.PARAMSET_OFDM_SC_NUM] = kw.pop("n_fft", 64)
    p[c.PARAMSET_OFDM][c.PARAMSET_OFDM_SC_SAMP] = \
        kw.pop("selected", np.arange(8))
    p[c.PARAMSET_NUM_PATHS] = MAX_PATHS
    for k, v in kw.items():
        p[k] = v
    return p


def _force_fallback(ds, params, monkeypatch):
    """Channels via the 4x-independent-render fallback path."""
    from deepmimo_tpu.ops import channel as C
    monkeypatch.setattr(C, "fused_render_eligible", lambda cfg: False)
    try:
        return ds.compute_channels(params)
    finally:
        monkeypatch.undo()


def test_fused_polar_matches_fallback(tmp_path, monkeypatch):
    ds = _dataset_with_pols(tmp_path)
    ours = ds.compute_channels(_params())
    ref = _force_fallback(_dataset_with_pols(tmp_path, seed=3),
                          _params(), monkeypatch)
    assert set(ours) == set(POLS)
    for pol in POLS:
        scale = np.abs(ref[pol]).max() + 1e-30
        np.testing.assert_allclose(ours[pol], ref[pol],
                                   atol=2e-5 * scale, err_msg=pol)


def test_fused_polar_mimo_rx_and_rotation(tmp_path, monkeypatch):
    kw = dict(bs_shape=[2, 2], ue_shape=[2, 1])

    def params():
        p = _params(**dict(kw))
        p[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_ROTATION] = \
            np.array([10.0, 20.0, 30.0])
        return p

    ours = _dataset_with_pols(tmp_path, seed=9).compute_channels(params())
    ref = _force_fallback(_dataset_with_pols(tmp_path, seed=9), params(),
                          monkeypatch)
    for pol in POLS:
        scale = np.abs(ref[pol]).max() + 1e-30
        np.testing.assert_allclose(ours[pol], ref[pol],
                                   atol=2e-5 * scale, err_msg=pol)
        assert ours[pol].shape == (N_UE, 2, 4, 8)


def test_fused_polar_to_device_roundtrip(tmp_path):
    import jax
    from deepmimo_tpu.ops.channel import unpack_polar_planes_np

    host = _dataset_with_pols(tmp_path, seed=5).compute_channels(_params())

    ds2 = _dataset_with_pols(tmp_path, seed=5)
    params = ds2.set_channel_params(_params())
    raw = ds2.compute_channels(params, to_device=True)
    np.random.seed(1001)
    cfg, _, _ = params.to_config(
        ds2.n_ue, ue_rotation=params.resolve_ue_rotation(ds2.n_ue),
        dtype=config.get("compute_dtype"))
    unpacked = unpack_polar_planes_np(jax.device_get(raw), cfg, len(POLS))
    for i, pol in enumerate(POLS):
        np.testing.assert_allclose(unpacked[i], host[pol], atol=1e-6,
                                   err_msg=pol)


def test_fused_polar_streamed_blocks_match_single(tmp_path):
    single = _dataset_with_pols(tmp_path, seed=7).compute_channels(_params())

    old_budget = config.get("max_device_output_bytes")
    old_block = config.get("user_block")
    try:
        config.set("max_device_output_bytes", 1)   # force streaming
        config.set("user_block", 8)                # 20 users -> 3 blocks
        streamed = _dataset_with_pols(tmp_path, seed=7).compute_channels(
            _params())
    finally:
        config.set("max_device_output_bytes", old_budget)
        config.set("user_block", old_block)
    for pol in POLS:
        np.testing.assert_allclose(streamed[pol], single[pol], atol=1e-6,
                                   err_msg=pol)


def test_fused_polar_with_doppler_snapshots(tmp_path, monkeypatch):
    def with_doppler(ds):
        rng = np.random.RandomState(2)
        shape = np.asarray(ds[c.POWER_PARAM_NAME]).shape
        nanmask = np.isnan(np.asarray(ds[c.POWER_PARAM_NAME]))
        ds[c.DOPPLER_VEL_PARAM_NAME] = np.float32(np.where(
            nanmask, np.nan, rng.uniform(-30, 30, shape)))
        ds[c.DOPPLER_ACC_PARAM_NAME] = np.float32(np.where(
            nanmask, np.nan, rng.uniform(-2, 2, shape)))
        return ds

    def params():
        p = _params()
        p[c.PARAMSET_DOPPLER_EN] = 1
        p[c.PARAMSET_DOPPLER_TIMES] = np.array([0.0, 1e-3, 2e-3])
        return p

    ours = with_doppler(
        _dataset_with_pols(tmp_path, seed=11)).compute_channels(params())
    ref = _force_fallback(
        with_doppler(_dataset_with_pols(tmp_path, seed=11)), params(),
        monkeypatch)
    for pol in POLS:
        assert ours[pol].shape == ref[pol].shape  # [U, R, T, K, S]
        scale = np.abs(ref[pol]).max() + 1e-30
        np.testing.assert_allclose(ours[pol], ref[pol],
                                   atol=2e-5 * scale, err_msg=pol)


def test_fused_polar_stacked_layout_matches_packed(tmp_path):
    # Default config layout is packed; force stacked and compare.
    packed = _dataset_with_pols(tmp_path, seed=13).compute_channels(
        _params(selected=np.arange(16)))
    old = config.get("planes_layout")
    try:
        config.set("planes_layout", "stacked")
        stacked = _dataset_with_pols(tmp_path, seed=13).compute_channels(
            _params(selected=np.arange(16)))
    finally:
        config.set("planes_layout", old)
    for pol in POLS:
        np.testing.assert_allclose(stacked[pol], packed[pol], atol=1e-6,
                                   err_msg=pol)


def test_fused_polar_bf16_output(tmp_path):
    """Dual-polar + bf16 planes serving mode compose."""
    f32 = _dataset_with_pols(tmp_path, seed=17).compute_channels(_params())
    old = config.get("planes_out_dtype")
    try:
        config.set("planes_out_dtype", "bfloat16")
        b16 = _dataset_with_pols(tmp_path, seed=17).compute_channels(
            _params())
    finally:
        config.set("planes_out_dtype", old)
    for pol in POLS:
        assert b16[pol].dtype == np.complex64      # widened at unpack
        scale = np.abs(f32[pol]).max() + 1e-30
        np.testing.assert_allclose(b16[pol], f32[pol],
                                   atol=2 ** -7 * scale, err_msg=pol)


def test_fused_polar_to_device_donated_loop(tmp_path):
    """Serving loop: dual-polar to_device with out= donation reuses the
    device buffer and keeps producing correct channels."""
    import jax

    ds = _dataset_with_pols(tmp_path, seed=19)
    params = _params()
    first = ds.compute_channels(params, to_device=True)
    ref = np.asarray(jax.device_get(first))
    h = first
    for _ in range(3):
        h = ds.compute_channels(params, to_device=True, out=h)
    np.testing.assert_allclose(np.asarray(jax.device_get(h)), ref,
                               atol=1e-6)


def test_fused_polar_streaming_checkpoint_resume(tmp_path):
    """Dual-polar streaming writes checkpoint blocks and resumes from
    them (blocks already on disk are not re-rendered)."""
    single = _dataset_with_pols(tmp_path, seed=23).compute_channels(
        _params())

    ck = str(tmp_path / "ckpt")
    old = {k: config.get(k) for k in ("max_device_output_bytes",
                                      "user_block", "checkpoint_dir")}
    try:
        config.set("max_device_output_bytes", 1)
        config.set("user_block", 8)
        config.set("checkpoint_dir", ck)
        a = _dataset_with_pols(tmp_path, seed=23).compute_channels(
            _params())
        import os
        blocks = [f for root, _, fs in os.walk(ck) for f in fs
                  if f.startswith("block_")]
        assert len(blocks) == 3                    # 20 users / 8
        # resume: fresh dataset, same config -> loads from disk
        b = _dataset_with_pols(tmp_path, seed=23).compute_channels(
            _params())
    finally:
        for k, v in old.items():
            config.set(k, v)
    for pol in POLS:
        np.testing.assert_allclose(a[pol], single[pol], atol=1e-6)
        np.testing.assert_allclose(b[pol], single[pol], atol=1e-6)
