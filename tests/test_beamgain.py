"""Codebook beam gains from per-path scalars: parity + product API.

The beam-gain path (ops/beamgain.py) folds the codebook into the TX
response before the path sum so H is never materialized; these tests pin
it against the explicit route |conj(W) . H|^2 computed from the rendered
channels.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from deepmimo_tpu.ops.beamgain import beam_gain, beam_gain_reference


def _scalars(u=26, p=25, n_s=1, seed=0, slot_amp=False):
    rng = np.random.RandomState(seed)
    mk = lambda lo, hi, *s: jnp.asarray(rng.uniform(lo, hi, s), jnp.float32)
    return (mk(-3, 3, u, p), mk(-3, 3, u, p), mk(-3, 3, u, p),
            mk(-3, 3, u, p), mk(0, 1e-2, u, (n_s if slot_amp else 1) * p),
            mk(-3, 3, u, n_s * p), mk(0, 6, u, p))


def _codebook(b, t, seed=1):
    rng = np.random.RandomState(seed)
    w = np.exp(1j * rng.uniform(-np.pi, np.pi, (b, t))) / np.sqrt(t)
    return (jnp.asarray(np.real(w), jnp.float32),
            jnp.asarray(np.imag(w), jnp.float32))


@pytest.mark.parametrize("rx_shape,tx_shape,n_beams,n_k,n_s,slot_amp", [
    ((1, 1), (8, 8), 16, 64, 1, False),   # headline shape, single RX
    ((2, 1), (4, 2), 8, 16, 1, False),    # multi-antenna RX outer product
    ((1, 1), (4, 4), 4, 16, 4, True),     # dual-polar layout: per-slot amps
])
def test_fused_matches_reference(rx_shape, tx_shape, n_beams, n_k, n_s,
                                 slot_amp):
    """The codebook fold equals |conj(W) . H|^2 through the explicit H."""
    args = _scalars(n_s=n_s, slot_amp=slot_amp)
    t = tx_shape[0] * tx_shape[1]
    wr, wi = _codebook(n_beams, t)
    ref = beam_gain_reference(*args, wr, wi, rx_shape, tx_shape, n_k)
    out = beam_gain(*args, wr, wi, rx_shape, tx_shape, n_k)
    assert out.shape == ref.shape
    scale = float(jnp.max(ref))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=3e-5 * scale)


def test_fused_doppler_snapshots():
    args = _scalars(n_s=3)
    wr, wi = _codebook(4, 16)
    ref = beam_gain_reference(*args, wr, wi, (1, 1), (4, 4), 8)
    out = beam_gain(*args, wr, wi, (1, 1), (4, 4), 8)
    assert out.shape == (26, 4, 24)          # [U, B, S*K]
    scale = float(jnp.max(ref))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=3e-5 * scale)


def test_reference_is_differentiable():
    args = _scalars(u=8, p=5)
    wr, wi = _codebook(4, 16)

    def loss(wr, wi):
        return jnp.sum(beam_gain_reference(*args, wr, wi, (1, 1), (4, 4),
                                           8))
    gr, gi = jax.grad(loss, argnums=(0, 1))(wr, wi)
    assert bool(jnp.isfinite(gr).all()) and float(jnp.abs(gr).max()) > 0
    assert bool(jnp.isfinite(gi).all())


def test_product_compute_beam_gains_matches_channels():
    """Dataset.compute_beam_gains == |H @ W^H|^2 from compute_channels."""
    import deepmimo_tpu as dm

    rng = np.random.RandomState(3)
    U, P = 40, 12
    n_valid = rng.randint(1, P + 1, size=U)
    mask = np.arange(P)[None, :] < n_valid[:, None]

    def mat(lo, hi):
        a = rng.uniform(lo, hi, (U, P)).astype(np.float32)
        return np.where(mask, a, np.nan).astype(np.float32)

    ds = dm.Dataset({
        "power": mat(-120, -60), "phase": mat(-180, 180),
        "delay": mat(1e-7, 2e-6),
        "aoa_az": mat(-180, 180), "aoa_el": mat(0, 180),
        "aod_az": mat(-180, 180), "aod_el": mat(0, 180),
        "rx_pos": np.zeros((U, 3), np.float32),
        "tx_pos": np.zeros((1, 3), np.float32),
    })
    params = dm.ChannelGenParameters()
    params["bs_antenna"]["shape"] = np.array([8, 8])
    params["num_paths"] = P
    params["ofdm"]["selected_subcarriers"] = np.arange(64)

    B = 16
    rngw = np.random.RandomState(5)
    codebook = np.exp(1j * rngw.uniform(-np.pi, np.pi, (B, 64))) / 8.0

    g = ds.compute_beam_gains(params, codebook=codebook)
    assert g.shape == (U, 1, B, 64)

    h = ds.compute_channels(params)                     # [U, 1, 64, 64]
    expect = np.abs(np.einsum("bt,urtk->urbk", codebook.conj(), h)) ** 2
    scale = expect.max()
    np.testing.assert_allclose(g, expect, atol=3e-5 * scale)

    # Rejects a mis-shaped codebook loudly
    with pytest.raises(ValueError):
        ds.compute_beam_gains(params, codebook=codebook[:, :32])
    with pytest.raises(ValueError):
        ds.compute_beam_gains(params)


def test_fused_beam_gain_differentiable():
    """jax.grad through the codebook fold equals the gradient through the
    explicit H, so codebook learning can drive the SAME function that
    serves."""
    args = _scalars(u=10, p=6)
    wr, wi = _codebook(4, 16)

    def loss_fused(wr, wi):
        return jnp.sum(beam_gain(*args, wr, wi, (1, 1), (4, 4), 8))

    def loss_ref(wr, wi):
        return jnp.sum(beam_gain_reference(*args, wr, wi, (1, 1), (4, 4),
                                           8))

    gf = jax.grad(loss_fused, argnums=(0, 1))(wr, wi)
    gr_ = jax.grad(loss_ref, argnums=(0, 1))(wr, wi)
    for a, b in zip(gf, gr_):
        scale = float(jnp.abs(b).max()) + 1e-12
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=3e-4 * scale)

    # gradients also flow to the per-path scalars (geometry calibration)
    g_amp = jax.grad(lambda amp: jnp.sum(beam_gain(
        *args[:4], amp, *args[5:], wr, wi, (1, 1), (4, 4), 8)))(args[4])
    assert bool(jnp.isfinite(g_amp).all())
    assert float(jnp.abs(g_amp).max()) > 0


def test_compute_beam_gains_donated_serving_loop():
    """out= donates the previous beam-gain buffer (constant device
    memory serving, mirroring compute_channels)."""
    import deepmimo_tpu as dm

    rng = np.random.RandomState(11)
    U, P = 24, 6
    mat = lambda lo, hi: rng.uniform(lo, hi, (U, P)).astype(np.float32)
    ds = dm.Dataset({
        "power": mat(-120, -60), "phase": mat(-180, 180),
        "delay": mat(1e-7, 2e-6),
        "aoa_az": mat(-180, 180), "aoa_el": mat(0, 180),
        "aod_az": mat(-180, 180), "aod_el": mat(0, 180),
        "rx_pos": np.zeros((U, 3), np.float32),
        "tx_pos": np.zeros((1, 3), np.float32),
    })
    params = dm.ChannelGenParameters()
    params["bs_antenna"]["shape"] = np.array([4, 2])
    params["num_paths"] = P
    params["ofdm"]["selected_subcarriers"] = np.arange(16)
    w = np.exp(1j * rng.uniform(-np.pi, np.pi, (4, 8))) / np.sqrt(8)

    ref = ds.compute_beam_gains(params, codebook=w)
    g = None
    for _ in range(3):
        g = ds.compute_beam_gains(params, codebook=w, to_device=True,
                                  out=g)
    got = np.asarray(jax.device_get(g)).reshape(U, 1, 4, 1, 16)[:, :, :,
                                                                0, :]
    np.testing.assert_allclose(got, ref, atol=1e-6 * ref.max())

    # a mismatched out is ignored, not crashed on
    bad = jnp.zeros((U, 2, 16), jnp.float32)
    g2 = ds.compute_beam_gains(params, codebook=w, to_device=True,
                               out=bad)
    got2 = np.asarray(jax.device_get(g2)).reshape(U, 1, 4, 1, 16)[:, :,
                                                                  :, 0, :]
    np.testing.assert_allclose(got2, ref, atol=1e-6 * ref.max())


def test_polar_beam_gains_match_per_pol_fold():
    """render_beam_gains_polar == |conj(W).H_pol|^2 per polarization,
    through the product dual-polar dict (one fused dispatch, no H)."""
    import deepmimo_tpu as dm
    from deepmimo_tpu.ops.channel import render_beam_gains_polar

    rng = np.random.RandomState(7)
    U, P = 24, 8
    n_valid = rng.randint(1, P + 1, size=U)
    mask = np.arange(P)[None, :] < n_valid[:, None]

    def mat(lo, hi):
        a = rng.uniform(lo, hi, (U, P)).astype(np.float32)
        return np.where(mask, a, np.nan).astype(np.float32)

    base = {
        "power": mat(-120, -60), "phase": mat(-180, 180),
        "delay": mat(1e-7, 2e-6),
        "aoa_az": mat(-180, 180), "aoa_el": mat(0, 180),
        "aod_az": mat(-180, 180), "aod_el": mat(0, 180),
        "rx_pos": np.zeros((U, 3), np.float32),
        "tx_pos": np.zeros((1, 3), np.float32),
    }
    ds = dm.Dataset(dict(base))
    for pol in ("vv", "vh", "hh", "hv"):
        ds[f"power_{pol}"] = mat(-115, -65)
        ds[f"phase_{pol}"] = mat(-180, 180)

    params = dm.ChannelGenParameters()
    params["bs_antenna"]["shape"] = np.array([4, 2])
    params["num_paths"] = P
    params["ofdm"]["selected_subcarriers"] = np.arange(16)
    params["enable_dual_polar"] = 1

    B, T = 4, 8
    rngw = np.random.RandomState(8)
    w = np.exp(1j * rngw.uniform(-np.pi, np.pi, (B, T))) / np.sqrt(T)

    gq = ds.compute_beam_gains(params, codebook=w)
    assert set(gq) == {"VV", "VH", "HH", "HV"}

    quad = ds.compute_channels(params)          # {pol: [U, R, T, K]}
    for pol in gq:
        expect = np.abs(np.einsum("bt,urtk->urbk", w.conj(),
                                  quad[pol])) ** 2
        scale = max(expect.max(), 1e-30)
        assert gq[pol].shape == expect.shape
        np.testing.assert_allclose(gq[pol], expect, atol=1e-3 * scale)

    # Raw device layout: one array, slot axis pol-major
    g_raw = ds.compute_beam_gains(params, codebook=w, to_device=True)
    assert g_raw.shape == (U, B, 4 * 16)

    # Missing pol matrices raise loudly
    ds2 = dm.Dataset(dict(base))
    with pytest.raises(ValueError, match="per-polarization"):
        ds2.compute_beam_gains(params, codebook=w)


@pytest.mark.parametrize("polar", [False, True])
def test_beam_gains_reject_rx_filter(polar):
    """The scalar formulation has no sinc receive filter: beam gains with
    rx_filter refuse instead of returning maps without it."""
    from deepmimo_tpu.ops.channel import (render_beam_gains,
                                          render_beam_gains_polar)
    from deepmimo_tpu.ops.types import PathData, AntennaPanel, ChannelConfig

    u, p = 4, 3
    z = np.zeros((u, p), np.float32)
    paths = PathData.from_numpy(z - 80, z, z + 1e-7, z, z + 90, z, z + 90)
    cfg = ChannelConfig(bs_shape=(4, 2), subcarriers=64,
                        selected_subcarriers=tuple(range(16)), num_paths=p,
                        rx_filter=True)
    wr, wi = _codebook(4, 8)
    bs, ue = AntennaPanel.make(), AntennaPanel.make()
    with pytest.raises(ValueError, match="receive filter"):
        if polar:
            pol = jnp.zeros((4, u, p), jnp.float32)
            render_beam_gains_polar(paths, bs, ue, cfg, pol, pol, wr, wi)
        else:
            render_beam_gains(paths, bs, ue, cfg, wr, wi)
