"""Golden-oracle parity: our channels vs the actual reference generator.

Imports the upstream package from /root/reference (read-only) and runs its
CPU generator on the same synthetic ray data, sweeping the BASELINE config
matrix. This is the toolchain-equivalence guarantee: a reference user gets
the same channels (to f32 accumulation tolerance — the reference accumulates
in csingle) from this build.
"""

import os
import sys

import numpy as np
import pytest

import deepmimo_tpu as dm
from deepmimo_tpu import consts as c
from deepmimo_tpu.config import config
from oracle import make_synthetic_paths

REFERENCE_PATH = "/root/reference"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(os.path.join(REFERENCE_PATH, "deepmimo")),
    reason="reference package not available")


@pytest.fixture(scope="module")
def ref():
    sys.path.insert(0, REFERENCE_PATH)
    import importlib
    for mod in list(sys.modules):
        if mod == "deepmimo" or mod.startswith("deepmimo."):
            del sys.modules[mod]
    mod = importlib.import_module("deepmimo")
    yield mod
    sys.path.remove(REFERENCE_PATH)
    for name in list(sys.modules):
        if name == "deepmimo" or name.startswith("deepmimo."):
            del sys.modules[name]


def _ref_channels(ref, data, params_fn):
    from deepmimo.generator.dataset import Dataset as RefDataset
    from deepmimo.generator.channel import ChannelGenParameters as RefParams

    n_ue = data["power"].shape[0]
    ds = RefDataset({k: np.asarray(data[k], dtype=np.float32)
                     for k in ("power", "phase", "delay", "aoa_az", "aoa_el",
                               "aod_az", "aod_el")} |
                    {"rx_pos": np.zeros((n_ue, 3), dtype=np.float32),
                     "tx_pos": np.zeros((1, 3), dtype=np.float32)})
    params = RefParams()
    params_fn(params)
    return np.asarray(ds.compute_channels(params))


def _our_channels(data, params_fn, fov=None, mode="f64"):
    """Run our generator. mode='f64' is the high-precision parity path
    (complex128, XLA); mode='production' is the path real users hit:
    complex64 planes with the fused Pallas kernel where eligible."""
    ds = dm.Dataset({k: np.asarray(data[k], dtype=np.float32)
                     for k in ("power", "phase", "delay", "aoa_az", "aoa_el",
                               "aod_az", "aod_el")} |
                    {"rx_pos": np.zeros((data["power"].shape[0], 3),
                                        dtype=np.float32),
                     "tx_pos": np.zeros((1, 3), dtype=np.float32)})
    if fov is not None:
        ds.apply_fov(*fov)
    params = dm.ChannelGenParameters()
    params_fn(params)
    old_dt = config.get("compute_dtype")
    config.set("compute_dtype",
               "complex128" if mode == "f64" else "complex64")
    try:
        return ds.compute_channels(params)
    finally:
        config.set("compute_dtype", old_dt)


# f32 trig + f32 accumulation vs the reference's complex128
# responses/csingle accumulation: tolerance tiers per mode.
_TOL = {"f64": 3e-5, "production": 4e-4}


def _compare(ref_ch, our_ch, rtol=None, mode="f64"):
    assert ref_ch.shape == our_ch.shape
    scale = max(np.abs(ref_ch).max(), 1e-30)
    np.testing.assert_allclose(our_ch, ref_ch,
                               atol=(rtol or _TOL[mode]) * scale)


# Both modes run every config: 'production' exercises the real user path
# (complex64 planes + fused Pallas kernel where eligible) directly against
# the upstream generator, so kernel drift fails parity; 'f64' is the
# tight-accuracy tier.
@pytest.fixture(params=["f64", "production"])
def mode(request):
    return request.param

DATA = make_synthetic_paths(n_ue=48, max_paths=10, seed=77)


def test_parity_default_params(ref, mode):
    def setp(p):
        pass
    _compare(_ref_channels(ref, DATA, setp),
             _our_channels(DATA, setp, mode=mode), mode=mode)


def test_parity_mimo_subcarriers(ref, mode):
    def setp(p):
        p["bs_antenna"]["shape"] = np.array([4, 2])
        p["ue_antenna"]["shape"] = np.array([2, 1])
        p["ofdm"]["subcarriers"] = 64
        p["ofdm"]["selected_subcarriers"] = np.arange(0, 64, 8)
        p["num_paths"] = 10
    _compare(_ref_channels(ref, DATA, setp),
             _our_channels(DATA, setp, mode=mode), mode=mode)


def test_parity_num_paths_trim(ref, mode):
    def setp(p):
        p["num_paths"] = 5
    _compare(_ref_channels(ref, DATA, setp),
             _our_channels(DATA, setp, mode=mode), mode=mode)


def test_parity_fixed_rotation_and_spacing(ref, mode):
    def setp(p):
        p["bs_antenna"]["shape"] = np.array([8, 1])
        p["bs_antenna"]["rotation"] = np.array([10, 20, 30])
        p["bs_antenna"]["spacing"] = 0.7
        p["ue_antenna"]["rotation"] = np.array([-5, 15, 60])
    _compare(_ref_channels(ref, DATA, setp),
             _our_channels(DATA, setp, mode=mode), mode=mode)


def test_parity_random_per_user_rotation(ref, mode):
    """[3, 2] spec draws per-user rotations under seed 1001 in both stacks."""
    def setp(p):
        p["ue_antenna"]["rotation"] = np.array([[0, 30], [30, 60], [60, 90]])
    _compare(_ref_channels(ref, DATA, setp),
             _our_channels(DATA, setp, mode=mode), mode=mode)


def test_parity_halfwave_dipole(ref, mode):
    def setp(p):
        p["bs_antenna"]["radiation_pattern"] = "halfwave-dipole"
        p["ue_antenna"]["radiation_pattern"] = "halfwave-dipole"
        p["bs_antenna"]["shape"] = np.array([2, 2])
    _compare(_ref_channels(ref, DATA, setp),
             _our_channels(DATA, setp, mode=mode), mode=mode)


def test_parity_time_domain(ref, mode):
    def setp(p):
        p["freq_domain"] = 0
        p["bs_antenna"]["shape"] = np.array([4, 1])
    _compare(_ref_channels(ref, DATA, setp),
             _our_channels(DATA, setp, mode=mode), mode=mode)


def test_parity_lpf_rx_filter(ref, mode):
    def setp(p):
        p["ofdm"]["subcarriers"] = 64
        p["ofdm"]["selected_subcarriers"] = np.arange(4)
        p["ofdm"]["rx_filter"] = 1
    _compare(_ref_channels(ref, DATA, setp),
             _our_channels(DATA, setp, mode=mode),
             rtol=max(1e-4, _TOL[mode]), mode=mode)


def test_parity_with_fov(ref, mode):
    """FoV path: reference filters via dataset.apply_fov, ours likewise."""
    from deepmimo.generator.dataset import Dataset as RefDataset
    from deepmimo.generator.channel import ChannelGenParameters as RefParams

    n_ue = DATA["power"].shape[0]
    rng = np.random.RandomState(5)
    inter = np.where(np.isnan(DATA["power"]), np.nan,
                     rng.randint(0, 3, DATA["power"].shape).astype(float))
    base = {k: np.asarray(DATA[k], dtype=np.float32)
            for k in ("power", "phase", "delay", "aoa_az", "aoa_el",
                      "aod_az", "aod_el")} | \
        {"rx_pos": np.zeros((n_ue, 3), dtype=np.float32),
         "tx_pos": np.zeros((1, 3), dtype=np.float32),
         "inter": inter}

    rds = RefDataset(dict(base))
    rds.apply_fov(bs_fov=np.array([120, 90]), ue_fov=np.array([360, 180]))
    rp = RefParams()
    rp["bs_antenna"]["shape"] = np.array([4, 1])
    ref_ch = np.asarray(rds.compute_channels(rp))

    def setp(p):
        p["bs_antenna"]["shape"] = np.array([4, 1])
    our_ch = _our_channels(DATA, setp,
                           fov=(np.array([120, 90]), np.array([360, 180])),
                           mode=mode)
    _compare(ref_ch, our_ch, mode=mode)

    # Derived quantities agree too
    ods = dm.Dataset(dict(base))
    ods.apply_fov(np.array([120, 90]), np.array([360, 180]))
    np.testing.assert_array_equal(np.asarray(ods.num_paths),
                                  np.asarray(rds.num_paths))
    np.testing.assert_array_equal(np.asarray(ods.los), np.asarray(rds.los))


def test_parity_pathloss_and_los(ref):
    from deepmimo.generator.dataset import Dataset as RefDataset

    n_ue = DATA["power"].shape[0]
    rng = np.random.RandomState(3)
    inter = np.where(np.isnan(DATA["power"]), np.nan,
                     rng.randint(0, 3, DATA["power"].shape).astype(float))
    base = {k: np.asarray(DATA[k], dtype=np.float32)
            for k in ("power", "phase", "delay", "aoa_az", "aoa_el",
                      "aod_az", "aod_el")} | \
        {"rx_pos": rng.uniform(-50, 50, (n_ue, 3)).astype(np.float32),
         "tx_pos": np.array([[0, 0, 10]], dtype=np.float32),
         "inter": inter}

    rds = RefDataset(dict(base))
    ods = dm.Dataset(dict(base))

    np.testing.assert_allclose(np.asarray(ods.pathloss),
                               np.asarray(rds.pathloss), rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(ods.los), np.asarray(rds.los))
    np.testing.assert_allclose(np.asarray(ods.distance),
                               np.asarray(rds.distance), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(ods.num_paths),
                                  np.asarray(rds.num_paths))


# ----------------------------------------------------------------------------
# Gradient parity vs the reference (BASELINE target: "allclose forward
# channels AND gradients vs. the reference CPU generator"). The upstream
# generator has no autodiff, so its gradients are taken by central finite
# differences THROUGH deepmimo.generator.dataset.Dataset.compute_channels
# (reference channel.py:200-288) and compared against our complex128 VJP.
# ----------------------------------------------------------------------------

def _ref_loss_fn(ref, data, setp, cot):
    """loss(data) = Re<cot, H_ref(data)> through the upstream generator."""
    def loss(d):
        h = _ref_channels(ref, d, setp)
        return float(np.real(np.vdot(cot, h)))
    return loss


def test_gradients_vs_reference_fd(ref):
    import jax
    import jax.numpy as jnp
    from deepmimo_tpu.ops.types import PathData, AntennaPanel, ChannelConfig
    from deepmimo_tpu.ops.channel import render_channels

    data = make_synthetic_paths(n_ue=4, max_paths=4, seed=55)
    n_fft, sel, bw = 32, np.arange(4), 10e6

    def setp(p):
        p["bs_antenna"]["shape"] = np.array([2, 2])
        p["ue_antenna"]["shape"] = np.array([1, 1])
        p["ofdm"]["subcarriers"] = n_fft
        p["ofdm"]["selected_subcarriers"] = sel
        p["ofdm"]["bandwidth"] = bw
        p["num_paths"] = 4

    h0 = _ref_channels(ref, data, setp)
    rng = np.random.RandomState(3)
    cot_np = (rng.normal(size=h0.shape) +
              1j * rng.normal(size=h0.shape))
    ref_loss = _ref_loss_fn(ref, data, setp, cot_np)

    # --- our VJP (complex128 functional renderer, same conventions) ---
    paths = PathData.from_numpy(
        power=data["power"], phase=data["phase"], delay=data["delay"],
        aoa_az=data["aoa_az"], aoa_el=data["aoa_el"],
        aod_az=data["aod_az"], aod_el=data["aod_el"], dtype=jnp.float64)
    cfg = ChannelConfig(bs_shape=(2, 2), ue_shape=(1, 1), freq_domain=True,
                        subcarriers=n_fft,
                        selected_subcarriers=tuple(sel.tolist()),
                        bandwidth=bw, num_paths=4, dtype="complex128")
    bs = AntennaPanel.make(dtype=jnp.float64)
    ue = AntennaPanel.make(dtype=jnp.float64)
    cot = jnp.asarray(cot_np)

    def our_loss(p):
        h = render_channels(p, bs, ue, cfg)
        # reference layout: [n_ue, rx, tx, k]
        return jnp.real(jnp.vdot(cot, h))

    grads = jax.grad(our_loss, allow_int=True)(paths)

    # --- central FD through the upstream generator, per field ---
    # eps balances f32-accumulation noise (the reference accumulates in
    # csingle) against truncation; tolerances are relative to each
    # field's gradient scale.
    fields = {
        "power": ("power_dbw", 1e-2, 2e-3),
        "phase": ("phase_deg", 1e-2, 2e-3),
        "delay": ("delay_s", 1e-11, 2e-3),
        "aoa_az": ("aoa_az_deg", 1e-2, 2e-3),
        "aoa_el": ("aoa_el_deg", 1e-2, 2e-3),
        "aod_az": ("aod_az_deg", 1e-2, 2e-3),
        "aod_el": ("aod_el_deg", 1e-2, 2e-3),
    }
    probe_rng = np.random.RandomState(11)
    valid = ~np.isnan(np.asarray(data["power"], dtype=np.float64))
    for key, (our_field, eps, rtol) in fields.items():
        g_ours = np.asarray(getattr(grads, our_field), dtype=np.float64)
        gscale = max(np.abs(g_ours).max(), 1e-300)
        coords = np.argwhere(valid)
        pick = coords[probe_rng.choice(len(coords), size=4, replace=False)]
        for (u, p_i) in pick:
            def perturbed(delta):
                d = {k: np.array(v, dtype=np.float64, copy=True)
                     for k, v in data.items()}
                d[key][u, p_i] += delta
                return ref_loss(d)
            fd = (perturbed(eps) - perturbed(-eps)) / (2 * eps)
            ad = g_ours[u, p_i]
            assert abs(fd - ad) <= rtol * gscale, (
                f"{key}[{u},{p_i}]: reference FD={fd:.6e} vs our "
                f"VJP={ad:.6e} (field grad scale {gscale:.3e})")
