"""Randomized-configuration parity sweep: production renderer vs oracle.

The named parity suites pin hand-chosen configs; this sweep samples the
configuration space (panel shapes, path counts across both lane layouts,
subcarrier selections, rotations incl. per-user, FoV, patterns, Doppler,
both domains) under fixed seeds and checks the PRODUCTION precision path
(complex64, the product route) against the float64 numpy oracle. Catches
cross-term bugs the axis-at-a-time suites cannot.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from deepmimo_tpu.ops.types import PathData, AntennaPanel, ChannelConfig
from deepmimo_tpu.ops.channel import render_channels
from oracle import oracle_channels, make_synthetic_paths

BS_SHAPES = [(1, 1), (4, 2), (8, 8), (2, 3)]
UE_SHAPES = [(1, 1), (2, 1), (2, 2)]
P_CHOICES = [5, 25, 40, 72]          # packed groups 4/4/2 + legacy g=1
K_CHOICES = [tuple(range(8)), tuple(range(0, 512, 8)),
             tuple(range(3, 67)), (0, 5, 17, 100)]   # last: non-arith
PATTERNS = ["isotropic", "halfwave-dipole"]


def _sample(rng):
    """One random configuration draw."""
    freq = bool(rng.randint(0, 2))
    doppler = bool(rng.randint(0, 3) == 0) and freq
    per_user_rot = rng.randint(0, 4) == 0
    spec = dict(
        bs_shape=BS_SHAPES[rng.randint(len(BS_SHAPES))],
        ue_shape=UE_SHAPES[rng.randint(len(UE_SHAPES))],
        num_paths=P_CHOICES[rng.randint(len(P_CHOICES))],
        freq_domain=freq,
        sel=K_CHOICES[rng.randint(len(K_CHOICES))],
        bandwidth=float(rng.choice([10e6, 50e6])),
        bs_rot=tuple(rng.uniform(-60, 60, 3)),
        per_user_rot=per_user_rot,
        bs_pattern=PATTERNS[rng.randint(2)],
        ue_pattern=PATTERNS[rng.randint(2)],
        bs_fov=(120.0, 90.0) if rng.randint(0, 3) == 0 else None,
        doppler=doppler,
        doppler_times=tuple(np.linspace(0, 1e-3,
                                        rng.randint(2, 4)))
        if doppler else (0.0,),
    )
    return spec


@pytest.mark.parametrize("seed", range(12))
def test_random_config_matches_oracle(seed):
    rng = np.random.RandomState(1000 + seed)
    spec = _sample(rng)
    n_ue = int(rng.randint(9, 30))
    data = make_synthetic_paths(n_ue=n_ue, max_paths=spec["num_paths"],
                                seed=seed, with_doppler=spec["doppler"])
    ue_rot = (rng.uniform(-40, 40, (n_ue, 3)) if spec["per_user_rot"]
              else tuple(rng.uniform(-40, 40, 3)))

    cfg = ChannelConfig(
        bs_shape=spec["bs_shape"], ue_shape=spec["ue_shape"],
        freq_domain=spec["freq_domain"], subcarriers=512,
        selected_subcarriers=spec["sel"], bandwidth=spec["bandwidth"],
        num_paths=spec["num_paths"], bs_pattern=spec["bs_pattern"],
        ue_pattern=spec["ue_pattern"], bs_fov=spec["bs_fov"],
        enable_doppler=spec["doppler"],
        doppler_times=spec["doppler_times"],
        dtype="complex64", planes_layout="packed")

    paths = PathData.from_numpy(
        power=data["power"], phase=data["phase"], delay=data["delay"],
        aoa_az=data["aoa_az"], aoa_el=data["aoa_el"],
        aod_az=data["aod_az"], aod_el=data["aod_el"],
        doppler_vel=data.get("doppler_vel"),
        doppler_acc=data.get("doppler_acc"), dtype=jnp.float32)
    bs = AntennaPanel.make(spec["bs_rot"], 0.5)
    ue = AntennaPanel.make(ue_rot, 0.5)
    got = np.asarray(render_channels(paths, bs, ue, cfg))

    kw = dict(bs_shape=spec["bs_shape"], ue_shape=spec["ue_shape"],
              bs_rotation=spec["bs_rot"], ue_rotation=ue_rot,
              bs_pattern=spec["bs_pattern"], ue_pattern=spec["ue_pattern"],
              bs_fov=spec["bs_fov"], freq_domain=spec["freq_domain"],
              n_fft=512, selected_subcarriers=spec["sel"],
              bandwidth=spec["bandwidth"], num_paths=spec["num_paths"])
    if spec["doppler"]:
        refs = [oracle_channels(
            **{k: data[k] for k in ("power", "phase", "delay", "aoa_az",
                                    "aoa_el", "aod_az", "aod_el")},
            doppler_vel=data["doppler_vel"],
            doppler_acc=data["doppler_acc"], doppler_time=t, **kw)
            for t in spec["doppler_times"]]
        ref = np.stack(refs, axis=-1)
    else:
        ref = oracle_channels(
            **{k: data[k] for k in ("power", "phase", "delay", "aoa_az",
                                    "aoa_el", "aod_az", "aod_el")}, **kw)

    assert got.shape == ref.shape, (spec, got.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-30)
    err = np.abs(got - ref).max() / scale
    # 4e-4: the production complex64 tolerance (same bound as the E2E
    # upstream parity) — f32 phase arguments reach ~1e3 rad at 512-FFT
    # wideband delays, so ~1e-4 relative H error is inherent rounding.
    assert err < 4e-4, (spec, err)


@pytest.mark.parametrize("seed", range(6))
def test_random_config_polar_matches_four_renders(seed):
    """Dual-polar single-dispatch == four independent per-pol renders,
    on random configs (both lane layouts, random rotations, Doppler)."""
    from deepmimo_tpu.ops.channel import (render_channels_planes_polar,
                                          unpack_polar_planes_np,
                                          fused_render_eligible)

    rng = np.random.RandomState(2000 + seed)
    p = int(rng.choice([6, 25, 40]))
    n_ue = int(rng.randint(8, 20))
    k = int(rng.choice([16, 64]))
    doppler = seed % 3 == 0
    data = make_synthetic_paths(n_ue=n_ue, max_paths=p, seed=seed,
                                with_doppler=doppler)
    cfg = ChannelConfig(
        bs_shape=tuple(rng.choice([1, 2, 4], 2)), ue_shape=(1, 1),
        freq_domain=True, subcarriers=512,
        selected_subcarriers=tuple(range(k)), num_paths=p,
        enable_doppler=doppler,
        doppler_times=(0.0, 1e-3) if doppler else (0.0,),
        dtype="complex64", planes_layout="packed")
    assert fused_render_eligible(cfg)

    paths = PathData.from_numpy(
        power=data["power"], phase=data["phase"], delay=data["delay"],
        aoa_az=data["aoa_az"], aoa_el=data["aoa_el"],
        aod_az=data["aod_az"], aod_el=data["aod_el"],
        doppler_vel=data.get("doppler_vel"),
        doppler_acc=data.get("doppler_acc"), dtype=jnp.float32)
    bs = AntennaPanel.make(tuple(rng.uniform(-30, 30, 3)), 0.5)
    ue = AntennaPanel.make()

    nanmask = np.isnan(data["power"])
    pol_p = np.where(nanmask, np.nan,
                     rng.uniform(-120, -70, (4,) + data["power"].shape)
                     ).astype(np.float32)
    pol_ph = np.where(nanmask, np.nan,
                      rng.uniform(-180, 180, (4,) + data["power"].shape)
                      ).astype(np.float32)

    out = render_channels_planes_polar(paths, bs, ue, cfg,
                                       jnp.asarray(pol_p),
                                       jnp.asarray(pol_ph))
    quad = unpack_polar_planes_np(np.asarray(out), cfg, 4)

    from deepmimo_tpu.ops.channel import render_channels
    for ip in range(4):
        d2 = dict(data)
        d2["power"] = pol_p[ip]
        d2["phase"] = pol_ph[ip]
        paths_ip = PathData.from_numpy(
            power=d2["power"], phase=d2["phase"], delay=d2["delay"],
            aoa_az=d2["aoa_az"], aoa_el=d2["aoa_el"],
            aod_az=d2["aod_az"], aod_el=d2["aod_el"],
            doppler_vel=d2.get("doppler_vel"),
            doppler_acc=d2.get("doppler_acc"), dtype=jnp.float32)
        ref = np.asarray(render_channels(paths_ip, bs, ue, cfg))
        scale = max(np.abs(ref).max(), 1e-30)
        assert np.abs(quad[ip] - ref).max() / scale < 4e-4


@pytest.mark.parametrize("seed", range(6))
def test_random_config_beamgain_matches_fold(seed):
    """Fused beam gains == |conj(W).H|^2 on random configs."""
    from deepmimo_tpu.ops.channel import (render_beam_gains,
                                          render_channels)

    rng = np.random.RandomState(3000 + seed)
    p = int(rng.choice([6, 25, 40, 72]))
    n_ue = int(rng.randint(8, 20))
    k = int(rng.choice([8, 64]))
    b = int(rng.choice([4, 16]))
    doppler = seed % 3 == 1
    data = make_synthetic_paths(n_ue=n_ue, max_paths=p, seed=seed,
                                with_doppler=doppler)
    bs_shape = tuple(rng.choice([2, 4], 2))
    ue_shape = (2, 1) if seed % 2 else (1, 1)
    cfg = ChannelConfig(
        bs_shape=bs_shape, ue_shape=ue_shape, freq_domain=True,
        subcarriers=512, selected_subcarriers=tuple(range(k)),
        num_paths=p, enable_doppler=doppler,
        doppler_times=(0.0, 2e-3) if doppler else (0.0,),
        dtype="complex64", planes_layout="packed")

    paths = PathData.from_numpy(
        power=data["power"], phase=data["phase"], delay=data["delay"],
        aoa_az=data["aoa_az"], aoa_el=data["aoa_el"],
        aod_az=data["aod_az"], aod_el=data["aod_el"],
        doppler_vel=data.get("doppler_vel"),
        doppler_acc=data.get("doppler_acc"), dtype=jnp.float32)
    bs = AntennaPanel.make(tuple(rng.uniform(-30, 30, 3)), 0.5)
    ue = AntennaPanel.make()
    t = int(np.prod(bs_shape))
    w = np.exp(1j * rng.uniform(-np.pi, np.pi, (b, t))) / np.sqrt(t)

    g = np.asarray(render_beam_gains(
        paths, bs, ue, cfg, jnp.asarray(np.real(w), jnp.float32),
        jnp.asarray(np.imag(w), jnp.float32)))

    h = np.asarray(render_channels(paths, bs, ue, cfg))
    if doppler:                    # [U, R, T, K, S] -> fold, s-major sk
        y = np.einsum("bt,urtks->urbks", w.conj(), h)
        expect = (np.abs(y) ** 2).transpose(0, 1, 2, 4, 3).reshape(
            n_ue, -1, 2 * k)
    else:
        expect = np.abs(np.einsum("bt,urtk->urbk", w.conj(), h)) ** 2
        expect = expect.reshape(n_ue, -1, k)
    scale = max(expect.max(), 1e-30)
    assert g.shape == expect.shape
    assert np.abs(g - expect).max() / scale < 1e-3
