"""Fused GPU render kernel: interpret-mode parity, VJP, and kernel choice.

The kernel (ops/pallas/render.py) runs here in the Pallas interpreter
against its plain XLA reference. Tests marked ``gpu`` compile it for the
card; they skip without one and run from chip_smoke.py on the GPU.
"""

import dataclasses
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from deepmimo_tpu.ops import channel as C
from deepmimo_tpu.ops.pallas import render as R
from deepmimo_tpu.ops.types import PathData, AntennaPanel, ChannelConfig

sys.path.insert(0, "tests")
from oracle import make_synthetic_paths  # noqa: E402


def _scalars(u, p, n_s=1, slot_amp=False, seed=0):
    rng = np.random.RandomState(seed)
    mk = lambda lo, hi, *s: jnp.asarray(rng.uniform(lo, hi, s), jnp.float32)
    return (mk(-3, 3, u, p), mk(-3, 3, u, p), mk(-3, 3, u, p),
            mk(-3, 3, u, p), mk(0, 1e-3, u, (n_s if slot_amp else 1) * p),
            mk(-3, 3, u, n_s * p), mk(0, 6, u, p))


def _max_rel(out, ref):
    out = tuple(np.asarray(x, np.float32) for x in out)
    scale = max(float(np.abs(r).max()) for r in ref)
    return max(float(np.abs(o - np.asarray(r)).max())
               for o, r in zip(out, ref)) / scale


def _split(h, packed):
    """Kernel output -> (hr, hi) [U, Q, S*K]."""
    if packed:
        sk = h.shape[-1] // 2
        return h[..., :sk], h[..., sk:]
    return h[0], h[1]


# (name, U, P, rx, tx, K, S, slot_amp, packed, tiles)
KERNEL_CASES = [
    ("p_not_pow2", 24, 25, (1, 1), (8, 8), 16, 1, False, False, None),
    ("mimo_rx", 12, 25, (2, 2), (4, 2), 16, 1, False, True, None),
    ("single_antenna", 10, 7, (1, 1), (1, 1), 8, 1, False, False, None),
    ("ragged_row_block", 9, 13, (2, 1), (2, 2), 16, 1, False, True,
     R.Tiles(rows=16, cols=16, num_warps=4)),
    ("doppler_slots", 8, 6, (1, 2), (2, 4), 8, 3, False, False, None),
    ("per_slot_amp", 8, 7, (2, 1), (2, 2), 16, 4, True, True, None),
    ("paths_over_32", 6, 40, (1, 1), (4, 4), 16, 1, False, False, None),
    ("row_blocks", 5, 9, (2, 1), (8, 8), 16, 1, False, True,
     R.Tiles(rows=64, cols=16, num_warps=4)),
    ("ragged_column_blocks", 5, 9, (1, 1), (4, 2), 40, 2, False, False,
     R.Tiles(rows=16, cols=32, num_warps=8)),
]


@pytest.mark.parametrize("case", KERNEL_CASES, ids=[c[0] for c in
                                                    KERNEL_CASES])
def test_fused_render_kernel_matches_reference(case):
    """Interpret-mode kernel vs the plain XLA reference: path padding to a
    power of two, ragged row and column blocks, slots, per-slot
    amplitudes, both output layouts."""
    _, u, p, rx, tx, k, s, slot_amp, packed, tiles = case
    args = _scalars(u, p, s, slot_amp)
    ref = R._reference_impl(*args, rx, tx, k)
    h = R.fused_render(*args, rx, tx, k, interpret=True, packed=packed,
                       tiles=tiles)
    q = rx[0] * rx[1] * tx[0] * tx[1]
    assert h.shape == ((u, q, 2 * s * k) if packed else (2, u, q, s * k))
    assert _max_rel(_split(h, packed), ref) < 3e-5


def test_fused_render_packed_layout_matches_stacked():
    """packed=True returns [U, Q, 2SK] with hr||hi on the minor dim and
    the same numbers as the stacked [2, U, Q, SK] layout."""
    args = _scalars(12, 25)
    for rx_shape, tx_shape in [((1, 1), (8, 8)), ((2, 2), (4, 2))]:
        stacked = R.fused_render(*args, rx_shape, tx_shape, 64,
                                 interpret=True)
        packed = R.fused_render(*args, rx_shape, tx_shape, 64,
                                interpret=True, packed=True)
        q = stacked.shape[2]
        assert packed.shape == (12, q, 128)
        np.testing.assert_array_equal(np.asarray(packed[..., :64]),
                                      np.asarray(stacked[0]))
        np.testing.assert_array_equal(np.asarray(packed[..., 64:]),
                                      np.asarray(stacked[1]))

    def loss(a):
        h = R.fused_render(*a, (1, 1), (4, 4), 64, interpret=True,
                           packed=True)
        return jnp.sum(h ** 2)

    g = jax.grad(loss)(args)
    assert all(np.isfinite(np.asarray(x)).all() for x in g)


@pytest.mark.parametrize("rx_shape,tx_shape,n_s,slot_amp,packed", [
    ((1, 1), (8, 8), 1, False, False),   # single RX antenna (zero dgry)
    ((2, 2), (4, 2), 1, False, False),   # full RX chain
    ((1, 2), (2, 4), 2, False, True),    # slots, packed cotangent
    ((2, 1), (2, 2), 4, True, False),    # per-slot amplitudes
    ((1, 1), (4, 4), 1, False, True),    # packed (hr||hi) cotangent
])
def test_fused_render_vjp_matches_reference_vjp(rx_shape, tx_shape, n_s,
                                                slot_amp, packed):
    """The custom VJP equals jax.vjp of the reference for all 7 inputs."""
    u, p, k = 10, 13, 16
    args = _scalars(u, p, n_s, slot_amp, seed=11)
    rng = np.random.RandomState(12)
    q = rx_shape[0] * rx_shape[1] * tx_shape[0] * tx_shape[1]
    shape = (u, q, 2 * n_s * k) if packed else (2, u, q, n_s * k)
    ct = jnp.asarray(rng.uniform(-1, 1, shape), jnp.float32)
    _, vjp_k = jax.vjp(lambda *a: R.fused_render(
        *a, rx_shape, tx_shape, k, interpret=True, packed=packed), *args)

    def ref(*a):
        hr, hi = R._reference_impl(*a, rx_shape, tx_shape, k)
        return (jnp.concatenate((hr, hi), -1) if packed
                else jnp.stack((hr, hi)))
    _, vjp_r = jax.vjp(ref, *args)
    for a, b in zip(vjp_k(ct), vjp_r(ct)):
        assert a.shape == b.shape
        scale = float(jnp.abs(b).max()) + 1e-12
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-5 * scale)


def test_fused_render_per_snapshot_amp():
    """amp [U, S*P] (dual-polar layout): every slot carries its own
    amplitudes; forward and gradients match the reference."""
    u, p, k, s = 16, 7, 16, 4
    args = _scalars(u, p, s, slot_amp=True, seed=5)
    ref = R._reference_impl(*args, (1, 1), (4, 4), k)
    out = R.fused_render(*args, (1, 1), (4, 4), k, interpret=True)
    assert out.shape == (2, u, 16, s * k)
    assert _max_rel(_split(out, False), ref) < 3e-5

    def loss(fn):
        return lambda amp: jnp.sum(fn(*args[:4], amp, *args[5:]) ** 2)
    g = jax.grad(loss(lambda *a: R.fused_render(
        *a, (1, 1), (4, 4), k, interpret=True)))(args[4])
    g_ref = jax.grad(loss(lambda *a: jnp.stack(R._reference_impl(
        *a, (1, 1), (4, 4), k))))(args[4])
    assert g.shape == (u, s * p)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref),
                               atol=1e-5 * float(jnp.abs(g_ref).max()))


@pytest.fixture
def route(monkeypatch):
    """``route(kernel)`` sends the product renderers through the fused
    kernel, run in the Pallas interpreter (the CPU stand-in for the GPU
    path), or through plain XLA, and drops traces of the other route."""
    real = R.fused_render
    monkeypatch.setattr(R, "fused_render",
                        lambda *a, **k: real(*a, interpret=True, **k))

    def set_route(kernel):
        monkeypatch.setattr(C, "_use_render_kernel",
                            lambda cfg: kernel and
                            C.fused_render_eligible(cfg))
        jax.clear_caches()
    yield set_route
    jax.clear_caches()


def _paths(n_ue, max_paths, seed, doppler=False):
    data = make_synthetic_paths(n_ue=n_ue, max_paths=max_paths, seed=seed,
                                with_doppler=doppler)
    return PathData.from_numpy(
        power=data["power"], phase=data["phase"], delay=data["delay"],
        aoa_az=data["aoa_az"], aoa_el=data["aoa_el"],
        aod_az=data["aod_az"], aod_el=data["aod_el"],
        doppler_vel=data.get("doppler_vel"),
        doppler_acc=data.get("doppler_acc"), dtype=jnp.float32)


FUSED_BACKEND_CASES = {
    "single_rx": dict(bs_shape=(4, 4), ue_shape=(1, 1),
                      selected_subcarriers=tuple(range(16))),
    "stride4": dict(bs_shape=(2, 2), ue_shape=(2, 1),
                    selected_subcarriers=tuple(range(0, 64, 4))),
    "one_subcarrier": dict(bs_shape=(4, 2), ue_shape=(1, 1),
                           selected_subcarriers=(5,)),
    "pattern_and_fov": dict(bs_shape=(2, 2), ue_shape=(1, 1),
                            selected_subcarriers=tuple(range(8)),
                            bs_pattern="halfwave-dipole",
                            bs_fov=(120.0, 90.0)),
    "doppler": dict(bs_shape=(2, 2), ue_shape=(1, 1),
                    selected_subcarriers=tuple(range(8)),
                    enable_doppler=True, doppler_times=(0.0, 1e-3)),
}


@pytest.mark.parametrize("name", list(FUSED_BACKEND_CASES))
def test_render_channels_planes_fused_backend(name, route):
    """The product's kernel branch of render_channels_planes matches its
    plain XLA branch (layouts, Doppler time axis, FoV, patterns)."""
    paths = _paths(12, 8, 3, doppler=True)
    bs = AntennaPanel.make((10.0, 20.0, 30.0))
    ue = AntennaPanel.make()
    cfg = ChannelConfig(freq_domain=True, subcarriers=64, bandwidth=10e6,
                        num_paths=8, dtype="complex64",
                        **FUSED_BACKEND_CASES[name])
    route(False)
    hx = np.asarray(C.render_channels_planes(paths, bs, ue, cfg))
    route(True)
    assert C._use_render_kernel(cfg)
    hf = np.asarray(C.render_channels_planes(paths, bs, ue, cfg))
    assert hx.shape == hf.shape
    np.testing.assert_allclose(hf, hx, atol=5e-5 * np.abs(hx).max())


def test_render_channels_planes_packed_cfg(route):
    """cfg.planes_layout='packed' end-to-end (kernel and XLA branches
    agree), with fallback to stacked when S*K is not 64-aligned."""
    paths = _paths(12, 6, 9)
    bs = AntennaPanel.make((5.0, 0.0, 20.0))
    ue = AntennaPanel.make()
    kw = dict(bs_shape=(4, 2), ue_shape=(1, 1), freq_domain=True,
              subcarriers=128, selected_subcarriers=tuple(range(64)),
              num_paths=6)

    route(False)
    stacked = np.asarray(C.render_channels_planes(
        paths, bs, ue, ChannelConfig(**kw)))
    for kernel in (True, False):
        route(kernel)
        cfg = ChannelConfig(**kw, planes_layout="packed")
        assert C._packed_layout(cfg)
        pk = np.asarray(C.render_channels_planes(paths, bs, ue, cfg))
        assert pk.shape == stacked.shape[1:-1] + (2 * stacked.shape[-1],)
        np.testing.assert_allclose(pk[..., :64], stacked[0], atol=2e-6)
        np.testing.assert_allclose(pk[..., 64:], stacked[1], atol=2e-6)

    # K=6 is not 64-aligned: packed request falls back to stacked
    cfg_small = ChannelConfig(bs_shape=(4, 2), ue_shape=(1, 1),
                              freq_domain=True, subcarriers=128,
                              selected_subcarriers=tuple(range(6)),
                              num_paths=6, planes_layout="packed")
    assert not C._packed_layout(cfg_small)
    out = C.render_channels_planes(paths, bs, ue, cfg_small)
    assert out.shape[0] == 2


def test_fused_render_bf16_output_mode(route):
    """out_dtype='bfloat16' serving mode: half the H bytes, ~2^-8 rel
    rounding vs the f32 output; grads still flow (f32 chain)."""
    from deepmimo_tpu.ops.channel import unpack_planes_np

    paths = _paths(16, 6, 21)
    bs, ue = AntennaPanel.make((5, 0, 20)), AntennaPanel.make()
    for kernel in (True, False):
        route(kernel)
        for layout in ("packed", "stacked"):
            cfg32 = ChannelConfig(bs_shape=(4, 2), ue_shape=(1, 1),
                                  freq_domain=True, subcarriers=64,
                                  selected_subcarriers=tuple(range(64)),
                                  num_paths=6, planes_layout=layout)
            cfg16 = dataclasses.replace(cfg32, out_dtype="bfloat16")
            h32 = C.render_channels_planes(paths, bs, ue, cfg32)
            h16 = C.render_channels_planes(paths, bs, ue, cfg16)
            assert h16.dtype == jnp.bfloat16 and h32.dtype == jnp.float32
            scale = float(jnp.abs(h32).max())
            np.testing.assert_allclose(np.asarray(h16, np.float32),
                                       np.asarray(h32), atol=2 ** -7 * scale)
            assert unpack_planes_np(np.asarray(h16), cfg16).dtype == \
                np.complex64

    args = _scalars(8, 5)

    def loss(a):
        h = R.fused_render(*a, (1, 1), (2, 2), 16, packed=True,
                           out_dtype="bfloat16")
        return jnp.sum(h.astype(jnp.float32) ** 2)

    g = jax.grad(loss)(args)
    assert all(bool(jnp.isfinite(x).all()) for x in g)
    assert any(float(jnp.abs(x).max()) > 0 for x in g)


@pytest.mark.parametrize("path", ["fused", "xla"])
def test_calibration_gradients_match_float64(path, route):
    """Calibration gradients through each product branch (the kernel's
    unit-vector prologue + custom VJP, or the XLA angle path) equal the
    float64 gradient leaf by leaf, with paths 0.002 deg from both poles
    (where an arccos of the float32 cosine loses the angle). Leaves whose
    float64 gradient is exactly zero (the single-antenna UE's rotation and
    spacing, the arrival angles) must be zero too."""
    from deepmimo_tpu.parallel.sharded import (calib_loss_planes,
                                               init_calib_params)

    data = make_synthetic_paths(n_ue=16, max_paths=8, seed=7)
    data["aod_el"][:4, 0] = [0.002, 179.998, 0.002, 179.998]
    data["power"][:4, 0] = np.nanmax(data["power"])
    paths = PathData.from_numpy(*(data[k] for k in (
        "power", "phase", "delay", "aoa_az", "aoa_el", "aod_az", "aod_el")))
    cfg = ChannelConfig(bs_shape=(4, 4), ue_shape=(1, 1), subcarriers=512,
                        selected_subcarriers=tuple(range(16)), num_paths=8)
    route(path == "fused")
    ue = AntennaPanel.make()
    target = C.render_channels_planes(
        paths, AntennaPanel.make((0, 0, 10), spacing=0.55), ue, cfg)
    params = init_calib_params(paths, AntennaPanel.make(), ue)
    grad = jax.grad(calib_loss_planes)
    got = grad(params, paths, target, cfg)

    to64 = lambda t: jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32 else x, t)
    cfg64 = dataclasses.replace(cfg, dtype="complex128")      # plain XLA
    ref = grad(to64(params), to64(paths), target.astype(jnp.float64), cfg64)
    for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        g, r = np.asarray(g, np.float64), np.asarray(r)
        if g.ndim == 3:                      # d_angles: one leaf per angle
            g, r = np.moveaxis(g, -1, 0), np.moveaxis(r, -1, 0)
        else:
            g, r = g[None], r[None]
        for gi, ri in zip(g, r):
            scale = np.abs(ri).max()
            if scale == 0:
                assert np.abs(gi).max() == 0
            else:
                assert np.abs(gi - ri).max() < 5e-5 * scale


# (name, platform, cfg overrides, kernel expected)
CHOICE_CASES = [
    ("gpu_eligible", "gpu", {}, True),
    ("gpu_time_domain", "gpu", dict(freq_domain=False), False),
    ("gpu_rx_filter", "gpu", dict(rx_filter=True), False),
    ("gpu_complex128", "gpu", dict(dtype="complex128"), False),
    ("gpu_irregular_subcarriers", "gpu",
     dict(selected_subcarriers=(0, 1, 5)), False),
    ("gpu_doppler_slots", "gpu",
     dict(enable_doppler=True, doppler_times=(0.0, 1e-3)), True),
    ("cpu_eligible", "cpu", {}, False),
]


@pytest.mark.parametrize("case", CHOICE_CASES,
                         ids=[c[0] for c in CHOICE_CASES])
def test_backend_choice(case, monkeypatch):
    """gpu -> kernel when eligible, otherwise XLA; the product never asks
    the kernel for interpret mode (it is traced here, not run)."""
    _, platform, overrides, expect_kernel = case
    kw = dict(bs_shape=(4, 2), ue_shape=(1, 1), subcarriers=64,
              selected_subcarriers=tuple(range(16)), num_paths=6)
    cfg = ChannelConfig(**{**kw, **overrides})
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert C._use_render_kernel(cfg) is expect_kernel
    calls = []
    real = R.fused_render
    monkeypatch.setattr(R, "fused_render",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    paths = _paths(8, 6, 4)
    bs, ue = AntennaPanel.make(), AntennaPanel.make()
    # Trace only: the Triton lowering never runs on this host.
    jax.eval_shape(lambda p: C.render_channels_planes.__wrapped__(
        p, bs, ue, cfg), paths)
    assert len(calls) == int(expect_kernel)
    assert all(not k.get("interpret", False) for k in calls)


@pytest.mark.parametrize("n_q,n_paths,n_sk,rows,cols", [
    (64, 25, 64, 64, 32),     # headline widths
    (4, 3, 1, 16, 16),        # tiny: floors of 16 for the dots
    (1024, 80, 512, 64, 32),  # wide: capped blocks
])
def test_pick_tiles_shapes(n_q, n_paths, n_sk, rows, cols):
    t = R.pick_tiles(n_q, n_sk)
    assert (t.rows, t.cols) == (rows, cols)
    for side in (t.rows, t.cols, R._pow2(n_paths)):
        assert side >= 16 and side & (side - 1) == 0


def test_dot_algorithm_mapping():
    alg = jax.lax.DotAlgorithmPreset
    assert R._dot_algorithm("float32", False) == alg.TF32_TF32_F32_X3
    assert R._dot_algorithm("float32", True) == alg.F32_F32_F32
    assert R._dot_algorithm("highest", False) == alg.F32_F32_F32
    with pytest.raises(ValueError, match="matmul_dtype"):
        R._dot_algorithm("float16", False)


GPU_CASES = [c for c in KERNEL_CASES
             if c[0] in ("p_not_pow2", "ragged_row_block", "per_slot_amp",
                         "ragged_column_blocks")]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_CASES, ids=[c[0] for c in GPU_CASES])
def test_fused_render_compiled_matches_reference(case):
    """The kernel as compiled for the card (TF32x3 dots) vs the reference."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (compiled Triton kernel)")
    _, u, p, rx, tx, k, s, slot_amp, packed, tiles = case
    args = _scalars(u, p, s, slot_amp)
    ref = R._reference_impl(*args, rx, tx, k)
    h = jax.jit(lambda *a: R.fused_render(*a, rx, tx, k, packed=packed,
                                          tiles=tiles))(*args)
    assert _max_rel(_split(h, packed), ref) < 3e-5
