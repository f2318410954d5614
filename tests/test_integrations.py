"""Tests: Sionna adapter, MATLAB export, dual-polar, pipelines, profiling."""

import os

import numpy as np
import pytest

import deepmimo_tpu as dm
from deepmimo_tpu import consts as c
from deepmimo_tpu.integrations import DeepMIMOSionnaAdapter, export_matlab
from scenario_utils import write_synthetic_scenario


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("scen") / "integ_city")
    data = write_synthetic_scenario(folder, n_ue=16, max_paths=6, seed=11,
                                    grid=(4, 4))
    return dm.load(folder), data


def test_sionna_adapter_shapes(dataset):
    ds, data = dataset
    adapter = DeepMIMOSionnaAdapter(ds)
    assert len(adapter) == 16
    a, tau = next(iter(adapter()))
    assert a.shape == (1, 1, 1, 8, 6, 1)     # [rx, rx_ant, tx, tx_ant, p, t]
    assert tau.shape == (1, 1, 6)
    assert a.dtype == np.csingle


def test_sionna_adapter_values(dataset):
    ds, data = dataset
    adapter = DeepMIMOSionnaAdapter(ds, ue_idx=np.array([3]))
    a, tau = next(iter(adapter()))
    # Channel is the time-domain channel of user 3
    ch = np.asarray(ds.channel) if not ds.ch_params[c.PARAMSET_FD_CH] else \
        None
    nv = data["n_valid"][3]
    # Delays packed (valid first), NaN -> 0
    expected_tau = np.nan_to_num(np.float32(data["delay"][3, :6]))[:nv]
    np.testing.assert_allclose(tau[0, 0, :nv], expected_tau, rtol=1e-6)
    assert np.all(np.abs(a[0, 0, 0, :, nv:, 0]) == 0)


def test_sionna_adapter_multi_user_rows(dataset):
    ds, _ = dataset
    adapter = DeepMIMOSionnaAdapter(ds, ue_idx=np.array([[0, 1], [2, 3]]))
    outs = list(adapter())
    assert len(outs) == 2
    assert outs[0][0].shape[0] == 2   # 2 rx per sample


def test_matlab_export(dataset, tmp_path):
    ds, data = dataset
    out = export_matlab(ds, str(tmp_path / "matlab_scen"))
    import scipy.io
    params = scipy.io.loadmat(os.path.join(out, "params.mat"))
    assert params["num_BS"].item() == 1
    assert params["carrier_freq"].item() == 3.5e9

    chunk = scipy.io.loadmat(os.path.join(out, "BS1_UE_0-16.mat"),
                             squeeze_me=False)
    chs = chunk["channels"]
    # canonical published-v3 nesting: 1xN cell of structs with field 'p'
    # (the chain upstream indexes, reference raytracing_v3.py:139)
    assert chs.shape == (1, 16)
    u = int(np.argmax(data["n_valid"]))
    mat = chs[0][u][0][0][0]
    nv = data["n_valid"][u]
    assert mat.shape == (8, nv)
    np.testing.assert_allclose(mat[1], np.float64(
        np.float32(data["delay"][u, :nv])), rtol=1e-6)
    # power in the v3 dBm convention: dBW + tx_power (0 here)
    np.testing.assert_allclose(
        mat[2], np.float64(np.float32(data["power"][u, :nv])), rtol=1e-5)
    assert chunk["rx_locs"].shape == (16, 5)
    assert chunk["tx_loc"].size >= 3
    assert os.path.exists(os.path.join(out, "UE_locations.mat"))
    assert os.path.exists(os.path.join(out, "BS1_BS.mat"))


def test_dual_polar_channels(tmp_path):
    folder = str(tmp_path / "dp_city")
    data = write_synthetic_scenario(folder, n_ue=8, max_paths=4, seed=3,
                                    grid=(4, 2))
    ds = dm.load(folder)
    # Attach per-polarization power/phase matrices
    rng = np.random.RandomState(0)
    for pol in ("vv", "vh", "hh", "hv"):
        ds[f"power_{pol}"] = np.float32(data["power"]) - \
            rng.uniform(0, 10)
        ds[f"phase_{pol}"] = np.float32(data["phase"])

    params = dm.ChannelGenParameters()
    params[c.PARAMSET_POLAR_EN] = 1
    chans = ds.compute_channels(params)
    assert set(chans.keys()) == {"VV", "VH", "HH", "HV"}
    for pol, ch in chans.items():
        assert ch.shape == (8, 1, 8, 1)
        assert np.isfinite(ch).all()
    # different polarization powers -> different channels
    assert not np.allclose(chans["VV"], chans["HH"])


def test_dual_polar_missing_matrices_raises(dataset):
    ds, _ = dataset
    params = dm.ChannelGenParameters()
    params[c.PARAMSET_POLAR_EN] = 1
    with pytest.raises(ValueError, match="polarization"):
        ds.compute_channels(params)


# ----------------------------------------------------------------------------
# Pipelines
# ----------------------------------------------------------------------------

def test_geo_roundtrip():
    from deepmimo_tpu.pipelines import (gps_to_cartesian, cartesian_to_gps,
                                        haversine, bbox_size_meters,
                                        pad_bbox)
    lat0, lon0 = 33.42, -111.93
    x, y = gps_to_cartesian([33.43, 33.42], [-111.92, -111.94], lat0, lon0)
    lat, lon = cartesian_to_gps(x, y, lat0, lon0)
    np.testing.assert_allclose(lat, [33.43, 33.42], atol=1e-9)
    np.testing.assert_allclose(lon, [-111.92, -111.94], atol=1e-9)

    d = haversine(33.42, -111.93, 33.43, -111.93)
    assert abs(d - 1113.2) < 5  # ~1.11 km per 0.01 deg latitude

    w, h = bbox_size_meters((33.42, -111.93, 33.43, -111.92))
    assert abs(h - 1113.2) < 5
    padded = pad_bbox((33.42, -111.93, 33.43, -111.92), 100)
    assert padded[0] < 33.42 and padded[2] > 33.43


def test_placement():
    from deepmimo_tpu.pipelines import gen_rx_grid, gen_tx_pos
    rt = {
        "gps_bbox": (33.42, -111.93, 33.423, -111.927),
        "grid_spacing": 20.0, "ue_height": 1.5,
        "bs_lats": [33.4215], "bs_lons": [-111.9285], "bs_heights": [10.0],
    }
    grid = gen_rx_grid(rt)
    assert grid.shape[1] == 3
    assert np.all(grid[:, 2] == 1.5)
    assert len(grid) > 100  # ~330m x 330m at 20 m spacing

    tx = gen_tx_pos(rt)
    assert tx.shape == (1, 3)
    assert tx[0, 2] == 10.0
    assert np.abs(tx[0, :2]).max() < 500


def test_pipeline_csv_and_state(tmp_path):
    from deepmimo_tpu.pipelines import read_pipeline_csv
    from deepmimo_tpu.pipelines.runner import PipelineState
    csv_path = tmp_path / "rows.csv"
    csv_path.write_text(
        "name,min_lat,min_lon,max_lat,max_lon,bs_lat,bs_lon,bs_height\n"
        "city_a,33.42,-111.93,33.43,-111.92,33.425|33.426,"
        "-111.925|-111.924,6|8\n")
    rows = read_pipeline_csv(str(csv_path))
    assert rows[0].name == "city_a"
    assert rows[0].bs_lats == [33.425, 33.426]
    assert rows[0].bs_heights == [6.0, 8.0]

    state = PipelineState(str(tmp_path))
    assert not state.done("city_a", "scene")
    state.mark("city_a", "scene")
    # persisted across instances
    assert PipelineState(str(tmp_path)).done("city_a", "scene")


def test_pipeline_gated_tools_raise(tmp_path):
    from deepmimo_tpu.pipelines.blender_osm import (fetch_osm_scene,
                                                    BlenderNotAvailable)
    from deepmimo_tpu.pipelines.raytracers import (raytrace_sionna,
                                                   RaytracerNotAvailable)
    with pytest.raises(BlenderNotAvailable):
        fetch_osm_scene((0, 0, 1, 1), str(tmp_path))
    with pytest.raises(RaytracerNotAvailable):
        raytrace_sionna(str(tmp_path), np.zeros((1, 3)), np.zeros((2, 3)),
                        {})


# ----------------------------------------------------------------------------
# Profiling subsystem
# ----------------------------------------------------------------------------

def test_stage_timer():
    import jax.numpy as jnp
    from deepmimo_tpu.utils.profiling import StageTimer
    t = StageTimer(sync=False)
    with t.stage("outer"):
        with t.stage("inner"):
            pass
    totals = t.totals()
    assert "outer" in totals and "outer/inner" in totals
    t.report(printer=lambda *a: None)

    # A syncing stage blocks on the outputs appended to it; errors from
    # inside the stage propagate instead of being swallowed.
    t = StageTimer()
    with t.stage("render") as out:
        out.append(jnp.ones((4, 4)) * 2)
    assert t.totals()["render"] >= 0
    with pytest.raises(ZeroDivisionError):
        with t.stage("fails"):
            1 / 0
    assert "fails" in t.totals()


def test_roofline_accounting():
    from deepmimo_tpu.utils.profiling import renderer_roofline
    r = renderer_roofline(n_ue=131072, n_rx_ant=1, n_tx_ant=64, n_sc=64,
                          n_paths=25, hbm_bytes_per_s=3.35e12,
                          flops_per_s=165e12)
    assert r["flops"] == 8 * 131072 * 64 * 25 * 64
    assert r["t_speed_of_light_s"] > 0
    assert r["users_per_s_sol"] > 1e6
    assert r["t_memory_bound_s"] == r["bytes"] / 3.35e12
    # No default device: the caller must pass the peaks.
    with pytest.raises(TypeError):
        renderer_roofline(131072, 1, 64, 64, 25)


def test_v3_roundtrip(dataset, tmp_path):
    """matlab_export -> legacy v3 loader round-trips the path matrices."""
    from deepmimo_tpu.converter.legacy_v3 import (load_v3_scenario,
                                                  is_v3_scenario)
    ds, data = dataset
    out = export_matlab(ds, str(tmp_path / "v3_scen"), tx_power_dbm=30.0)
    assert is_v3_scenario(out)

    v3 = load_v3_scenario(out)
    assert v3.n_ue == 16
    for key in ("power", "phase", "delay", "aoa_az", "aoa_el", "aod_az",
                "aod_el"):
        ours = np.float32(np.asarray(ds[key]))
        theirs = np.asarray(v3[key])[:, :ours.shape[1]]
        # v3 packs valid paths; padded tails stay NaN in both
        np.testing.assert_allclose(np.nan_to_num(theirs),
                                   np.nan_to_num(ours), atol=1e-4,
                                   err_msg=key)
    np.testing.assert_allclose(np.asarray(v3.rx_pos),
                               np.asarray(ds.rx_pos), atol=1e-5)
    np.testing.assert_allclose(np.asarray(v3.tx_pos),
                               np.asarray(ds.tx_pos), atol=1e-5)
    # channels computable from the legacy load
    ch = v3.compute_channels(dm.ChannelGenParameters())
    assert np.isfinite(ch).all()


# ----------------------------------------------------------------------------
# 5G NR CDL export (reference DeepMIMO-5GNR MATLAB bridge,
# construct_DeepMIMO_CDL_channel.m:8-56)
# ----------------------------------------------------------------------------

def test_nr_cdl_export_fields(dataset):
    from deepmimo_tpu.integrations import CDLConfig, export_cdl
    dataset, _ = dataset

    cfg = CDLConfig(velocity_kmh=18.0, travel_dir_deg=(45.0, 90.0))
    users = export_cdl(dataset, cfg)
    assert len(users) == dataset.n_ue

    act = [u for u in users if u is not None]
    assert act, "no active users exported"
    u0 = act[0]

    n_p = len(u0["PathDelays"])
    for key in ("AveragePathGains", "AnglesAoD", "AnglesZoD", "AnglesAoA",
                "AnglesZoA"):
        assert len(u0[key]) == n_p
    assert not np.isnan(u0["PathDelays"]).any()

    # Doppler: fd = v/3.6 / c * fc (construct_DeepMIMO_CDL_channel.m:23)
    fc = u0["CarrierFrequency"]
    expected_fd = (18.0 / 3.6) / 299792458.0 * fc
    np.testing.assert_allclose(u0["MaximumDopplerShift"], expected_fd,
                               rtol=1e-9)
    assert u0["UTDirectionOfTravel"] == [45.0, 90.0]

    # Zenith angles come from ray elevations; azimuths from ray azimuths
    pw = np.asarray(dataset["power"])
    act_idx = [i for i, u in enumerate(users) if u is not None][0]
    m = ~np.isnan(pw[act_idx])
    np.testing.assert_allclose(
        users[act_idx]["AnglesZoA"],
        np.asarray(dataset["aoa_el"])[act_idx][m], rtol=1e-6)

    # Orientation downtilt sign flip: [bearing; -el; 0]
    cfg2 = CDLConfig(bs_orientation_deg=(30.0, 10.0))
    u2 = [u for u in export_cdl(dataset, cfg2) if u is not None][0]
    assert u2["TransmitArrayOrientation"] == [30.0, -10.0, 0.0]


def test_nr_cdl_numerology():
    from deepmimo_tpu.integrations import CDLConfig

    # NRB=24 @ 30 kHz: 288 sc / 0.85 -> FFT 512 -> 15.36 MHz (nrOFDMInfo)
    cfg = CDLConfig(nrb=24, scs_khz=30, num_slots=4)
    assert cfg.sample_rate == 512 * 30e3
    assert cfg.slots_per_subframe == 2
    assert cfg.num_time_samples == int(
        np.ceil(4.1 * cfg.sample_rate / 2 * 1e-3))

    # NRB=52 @ 15 kHz: 624 sc -> FFT 1024 -> 15.36 MHz
    cfg2 = CDLConfig(nrb=52, scs_khz=15)
    assert cfg2.sample_rate == 1024 * 15e3


def test_nr_cdl_mat_roundtrip_and_cir(dataset, tmp_path):
    import scipy.io
    dataset = dataset[0]
    from deepmimo_tpu.integrations import (CDLConfig, export_cdl,
                                           save_cdl_mat, synthesize_cdl_cir)

    users = export_cdl(dataset, CDLConfig(velocity_kmh=(5.0, 30.0)))
    path = save_cdl_mat(users, str(tmp_path / "cdl.mat"))
    loaded = scipy.io.loadmat(path, squeeze_me=True)["cdl_users"]
    assert loaded.shape[0] == len(users)

    # numpy consumer: evaluate the exported params into a CIR
    u0 = [u for u in users if u is not None][0]
    t = np.linspace(0, 1e-3, 8)
    cir = synthesize_cdl_cir(u0, t)
    assert cir.shape == (8, len(u0["PathDelays"]))
    assert np.isfinite(cir).all()
    # |a_p| is time-invariant; phase rotates at the per-path Doppler
    np.testing.assert_allclose(np.abs(cir[0]), np.abs(cir[-1]), rtol=1e-6)
    np.testing.assert_allclose(
        np.abs(cir[0]), 10 ** (np.asarray(u0["AveragePathGains"]) / 20),
        rtol=1e-6)
