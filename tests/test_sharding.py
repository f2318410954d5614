"""Multi-device sharding tests on the 8-device virtual CPU mesh.

Validates that the sharded renderer and distributed training step produce
identical results to single-device execution, and that shardings actually
span the mesh.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from deepmimo_tpu.ops.types import PathData, AntennaPanel, ChannelConfig
from deepmimo_tpu.ops.channel import render_channels
from deepmimo_tpu.parallel import (make_mesh, render_channels_sharded,
                                   shard_paths)
from deepmimo_tpu.parallel.sharded import (
    init_calib_params, make_sharded_training_step, calib_loss)
from oracle import make_synthetic_paths


def _paths(n_ue=16, max_paths=6, seed=50):
    data = make_synthetic_paths(n_ue=n_ue, max_paths=max_paths, seed=seed)
    return PathData.from_numpy(
        power=data["power"], phase=data["phase"], delay=data["delay"],
        aoa_az=data["aoa_az"], aoa_el=data["aoa_el"],
        aod_az=data["aod_az"], aod_el=data["aod_el"], dtype=jnp.float32)


CFG = ChannelConfig(bs_shape=(4, 2), ue_shape=(2, 1), freq_domain=True,
                    subcarriers=64, selected_subcarriers=tuple(range(8)),
                    num_paths=6, dtype="complex64")


def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.devices.size == 8


def test_sharded_render_matches_single_device():
    paths = _paths()
    bs, ue = AntennaPanel.make((10, 0, 30)), AntennaPanel.make()
    ref = np.asarray(render_channels(paths, bs, ue, CFG))

    mesh = make_mesh()
    out = render_channels_sharded(paths, bs, ue, CFG, mesh)
    np.testing.assert_allclose(np.asarray(out), ref, atol=1e-6)


def test_sharded_render_users_actually_sharded():
    paths = _paths()
    mesh = make_mesh()
    sharded = shard_paths(paths, mesh)
    # The user axis must be split across all 8 devices
    assert len(sharded.power_dbw.sharding.device_set) == 8


def test_sharded_render_with_tile_axis():
    paths = _paths()
    bs, ue = AntennaPanel.make(), AntennaPanel.make()
    ref = np.asarray(render_channels(paths, bs, ue, CFG))
    mesh = make_mesh(tile=2)  # 4 x 2 mesh
    out = render_channels_sharded(paths, bs, ue, CFG, mesh)
    np.testing.assert_allclose(np.asarray(out), ref, atol=1e-6)


def test_training_step_matches_unsharded():
    paths = _paths(n_ue=16)
    bs, ue = AntennaPanel.make((5, 5, 5)), AntennaPanel.make()
    params = init_calib_params(paths, bs, ue)

    # Target: channels from slightly different geometry
    target = render_channels(paths, AntennaPanel.make((7, 5, 5)), ue, CFG)

    # Unsharded reference step
    loss0, grads0 = jax.value_and_grad(calib_loss, allow_int=True)(
        params, paths, target, CFG)

    # Sharded step
    mesh = make_mesh()
    step, place = make_sharded_training_step(mesh, CFG, lr=1e-2)
    s_params, s_paths, s_target = place(params, paths, target)
    new_params, loss1 = step(s_params, s_paths, s_target)

    np.testing.assert_allclose(float(loss1), float(loss0), rtol=1e-5)
    # Updated shared parameter = p - lr * grad (psum'd across shards)
    expected_rot = np.asarray(params.bs.rotation_deg) - \
        1e-2 * np.asarray(grads0.bs.rotation_deg)
    np.testing.assert_allclose(np.asarray(new_params.bs.rotation_deg),
                               expected_rot, rtol=1e-4, atol=1e-6)


def test_training_step_loss_decreases():
    paths = _paths(n_ue=16, seed=51)
    bs, ue = AntennaPanel.make((0, 0, 0)), AntennaPanel.make()
    params = init_calib_params(paths, bs, ue)
    target = render_channels(paths, AntennaPanel.make((0, 0, 10)), ue, CFG)

    mesh = make_mesh()
    step, place = make_sharded_training_step(mesh, CFG, lr=3e-3)
    params, s_paths, s_target = place(params, paths, target)
    losses = []
    for _ in range(10):
        params, loss = step(params, s_paths, s_target)
        losses.append(float(loss))
    assert losses[-1] < losses[0]


def test_training_step_planes_matches_complex_loss():
    """The planes-path calibration (fused Pallas fwd+bwd) reproduces the
    complex-path loss value and decreases it over steps."""
    from deepmimo_tpu.ops.channel import render_channels_planes
    from deepmimo_tpu.parallel.sharded import (calib_loss_planes,
                                               training_step_planes)

    cfg = CFG
    paths = _paths(n_ue=16, seed=52)
    bs, ue = AntennaPanel.make((0, 0, 0)), AntennaPanel.make()
    params = init_calib_params(paths, bs, ue)
    target_c = render_channels(paths, AntennaPanel.make((0, 0, 10)), ue, CFG)
    target_p = render_channels_planes(
        paths, AntennaPanel.make((0, 0, 10)), ue, cfg)

    loss_c = float(calib_loss(params, paths, target_c, CFG))
    loss_p = float(calib_loss_planes(params, paths, target_p, cfg))
    # Identical normalized objective: the 1/2 from the planes axis cancels.
    np.testing.assert_allclose(loss_p, loss_c, rtol=1e-4)

    losses = []
    for _ in range(10):
        params, loss = training_step_planes(params, paths, target_p, cfg,
                                            lr=3e-3)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    assert all(np.isfinite(losses))


def test_multihost_loader_single_process(tmp_path):
    """load_paths_sharded shards users over the mesh (1-process path)."""
    import sys
    sys.path.insert(0, "tests")
    from scenario_utils import write_synthetic_scenario
    import deepmimo_tpu as dm
    from deepmimo_tpu.parallel import load_paths_sharded, host_user_range

    folder = str(tmp_path / "mh_scen")
    write_synthetic_scenario(folder, n_ue=16, max_paths=4, seed=21,
                             grid=(4, 4))
    ds = dm.load(folder)
    mesh = make_mesh()
    pd = load_paths_sharded(ds, mesh, num_paths=4)
    assert pd.power_dbw.shape == (16, 4)
    assert len(pd.power_dbw.sharding.device_set) == 8

    # range partitioning covers all users exactly once
    spans = [host_user_range(16, pi, 4) for pi in range(4)]
    assert spans[0] == (0, 4) and spans[-1] == (12, 16)

    # sharded render matches host render
    bs, ue = AntennaPanel.make(), AntennaPanel.make()
    h = render_channels_sharded(pd, bs, ue, CFG.replace(num_paths=4), mesh)
    ref = render_channels(jax.device_put(pd), bs, ue,
                          CFG.replace(num_paths=4))
    np.testing.assert_allclose(np.asarray(h), np.asarray(ref), atol=1e-6)


def test_export_xyz_csv(tmp_path):
    import sys
    sys.path.insert(0, "tests")
    from scenario_utils import write_synthetic_scenario
    import deepmimo_tpu as dm
    from deepmimo_tpu.generator.visualization import export_xyz_csv

    folder = str(tmp_path / "csv_scen")
    write_synthetic_scenario(folder, n_ue=8, max_paths=4, seed=22,
                             grid=(4, 2))
    ds = dm.load(folder)
    path = export_xyz_csv(ds, np.asarray(ds.pathloss),
                          str(tmp_path / "cov.csv"))
    lines = open(path).read().splitlines()
    assert lines[0] == "x,y,z,value"
    assert len(lines) == 9


def test_polar_sharded_matches_single_device():
    """Single-dispatch dual-polar render sharded over users == unsharded."""
    from deepmimo_tpu.parallel import render_polar_sharded
    from deepmimo_tpu.ops.channel import (render_channels_planes_polar,
                                          unpack_polar_planes_np)

    paths = _paths(n_ue=16)
    bs, ue = AntennaPanel.make((10, 0, 30)), AntennaPanel.make()
    rng = np.random.RandomState(4)
    u, p = 16, 6
    pol_p = rng.uniform(-120, -70, (4, u, p)).astype(np.float32)
    pol_ph = rng.uniform(-180, 180, (4, u, p)).astype(np.float32)

    ref = np.asarray(render_channels_planes_polar(
        paths, bs, ue, CFG, jnp.asarray(pol_p), jnp.asarray(pol_ph)))

    mesh = make_mesh()
    out = render_polar_sharded(paths, bs, ue, CFG, pol_p, pol_ph, mesh)
    np.testing.assert_allclose(np.asarray(out), ref, atol=1e-6)
    # Users axis genuinely sharded across the mesh
    users_dim = 0 if out.ndim == 4 else 1
    n_users_axis = dict(zip(mesh.axis_names, mesh.devices.shape))["users"]
    shard_rows = {s.data.shape[users_dim] for s in out.addressable_shards}
    assert shard_rows == {16 // n_users_axis}

    # And the unpack produces the per-pol complex quadruple
    hq = unpack_polar_planes_np(np.asarray(out), CFG, 4)
    assert hq.shape[0] == 4 and np.isfinite(hq).all()


def test_beamgain_sharded_matches_single_device():
    """Fused beam-gain consumer sharded over users == unsharded."""
    from deepmimo_tpu.parallel import render_beam_gains_sharded
    from deepmimo_tpu.ops.channel import render_beam_gains

    paths = _paths(n_ue=16)
    bs, ue = AntennaPanel.make((10, 0, 30)), AntennaPanel.make()
    rng = np.random.RandomState(6)
    t = CFG.n_tx_ant
    w = np.exp(1j * rng.uniform(-np.pi, np.pi, (4, t))) / np.sqrt(t)
    wr = jnp.asarray(np.real(w), jnp.float32)
    wi = jnp.asarray(np.imag(w), jnp.float32)

    ref = np.asarray(render_beam_gains(paths, bs, ue, CFG, wr, wi))
    mesh = make_mesh()
    out = render_beam_gains_sharded(paths, bs, ue, CFG, wr, wi, mesh)
    np.testing.assert_allclose(np.asarray(out), ref, atol=1e-6 * ref.max())
    # Users axis genuinely sharded across the mesh
    n_users_axis = dict(zip(mesh.axis_names, mesh.devices.shape))["users"]
    shard_rows = {s.data.shape[0] for s in out.addressable_shards}
    assert shard_rows == {16 // n_users_axis}


def test_polar_beamgain_sharded_matches_single_device():
    """Dual-polar beam gains sharded over users == unsharded."""
    from deepmimo_tpu.parallel import render_beam_gains_polar_sharded
    from deepmimo_tpu.ops.channel import render_beam_gains_polar

    paths = _paths(n_ue=16)
    bs, ue = AntennaPanel.make((10, 0, 30)), AntennaPanel.make()
    rng = np.random.RandomState(8)
    u, p = 16, 6
    pol_p = rng.uniform(-120, -70, (4, u, p)).astype(np.float32)
    pol_ph = rng.uniform(-180, 180, (4, u, p)).astype(np.float32)
    t = CFG.n_tx_ant
    w = np.exp(1j * rng.uniform(-np.pi, np.pi, (4, t))) / np.sqrt(t)
    wr = jnp.asarray(np.real(w), jnp.float32)
    wi = jnp.asarray(np.imag(w), jnp.float32)

    ref = np.asarray(render_beam_gains_polar(
        paths, bs, ue, CFG, jnp.asarray(pol_p), jnp.asarray(pol_ph),
        wr, wi))
    mesh = make_mesh()
    out = render_beam_gains_polar_sharded(paths, bs, ue, CFG, pol_p,
                                          pol_ph, wr, wi, mesh)
    np.testing.assert_allclose(np.asarray(out), ref,
                               atol=1e-6 * max(ref.max(), 1e-30))
    n_users_axis = dict(zip(mesh.axis_names, mesh.devices.shape))["users"]
    shard_rows = {s.data.shape[0] for s in out.addressable_shards}
    assert shard_rows == {16 // n_users_axis}
