"""Smoke run of the channel generator on an NVIDIA GPU.

Drives the product path through the entry points a user calls, at the
asu-campus population (131,931 users x 25 paths, an 8x8 BS panel, a
single-antenna UE, 64 of 512 subcarriers at 10 MHz), compares every phase
with its plain reference, and prints one JSON object as its last line.
It exits non-zero, printing no result, where JAX finds no GPU.

    python chip_smoke.py               # phases a-d on one card
    python chip_smoke.py --four-cards  # phase e only: the sharded paths
                                       # on a 4-card mesh vs one card

Phases (one card):
  a. main path: write the synthetic scenario to disk, ``dm.load`` it,
     ``compute_channels`` to the device and to the host, compare 1,024
     random users with the float64 oracle (tests/oracle.py);
  b. render kernel at real widths (headline, MIMO, Doppler, dual-polar)
     vs its plain reference, the kernel-vs-XLA timing through
     ``compute_channels``, and the tests marked ``gpu``;
  c. dual-polar channels, beam gains, time domain and the receive
     filter at 32,768 users, each vs the oracle on a subsample;
  d. calibration gradients through the kernel path and the plain XLA
     path, leaf by leaf, vs the float64 gradient; three steps of
     ``training_step_planes`` with a finite, falling loss.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

N_UE = 131_931              # asu-campus grid, 411 x 321
GRID = (411, 321)
N_PATHS = 25
BS_SHAPE = (8, 8)
N_FFT = 512
SEL_SC = np.arange(64)
TIMED_USERS = 131_072
SIDE_USERS = 32_768
ORACLE_USERS = 1_024
TIMING_REPS = 20

# Max |H - H_oracle| / max |H_oracle| against the float64 oracle, for the
# kernel path, the plain XLA path, the time domain and the receive filter.
# The float32 phase arguments reach ~300 rad at these delays; both render
# paths read ~1.5e-5 on this data, a single TF32 path-sum pass ~3.5e-4.
TOL_ORACLE = 5e-5
# Beam-gain powers square the channel error.
TOL_BEAM = 1e-4
# Kernel vs its HIGHEST-precision XLA reference (the tests' bound): TF32x3
# path sums keep float32-level error; panel phases of up to ~40 rad may
# round differently where the two compilers contract multiply-adds.
TOL_KERNEL = 3e-5
# Calibration gradients per leaf vs the float64 gradient, relative to the
# leaf's largest float64 entry (float32 sums over 32,768 users).
TOL_GRAD = 1e-4


class Smoke:
    """Collects each phase's comparisons; a phase fails on any error."""

    def __init__(self):
        self.failed = []

    def check(self, what, err, tol):
        ok = bool(np.isfinite(err) and err <= tol)
        print(f"  check {what}: max err {err:.3e} (tolerance {tol:.1e}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            self.failed.append(what)

    def phase(self, name, fn, *args):
        print(f"== phase {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn(self, *args)
        except Exception:                  # report, then fail the run
            traceback.print_exc()
            self.failed.append(f"phase {name}")
        print(f"== phase {name} done in {time.perf_counter() - t0:.1f} s",
              flush=True)


def rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def memory(compiled):
    m = compiled.memory_analysis()
    gb = lambda x: f"{x / 1e9:.3f} GB"
    return (f"args {gb(m.argument_size_in_bytes)}, out "
            f"{gb(m.output_size_in_bytes)}, temp {gb(m.temp_size_in_bytes)}")


def headline_params(**ofdm):
    import deepmimo_tpu as dm
    from deepmimo_tpu import consts as c

    p = dm.ChannelGenParameters()
    p[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_SHAPE] = np.array(BS_SHAPE)
    p[c.PARAMSET_OFDM][c.PARAMSET_OFDM_SC_NUM] = N_FFT
    p[c.PARAMSET_OFDM][c.PARAMSET_OFDM_SC_SAMP] = SEL_SC
    p[c.PARAMSET_NUM_PATHS] = N_PATHS
    for k, v in ofdm.items():
        p[c.PARAMSET_OFDM][k] = v
    return p


KEYS = ("power", "phase", "delay", "aoa_az", "aoa_el", "aod_az", "aod_el")


def oracle(data, idx, **kw):
    from oracle import oracle_channels

    kw.setdefault("bs_shape", BS_SHAPE)
    kw.setdefault("n_fft", N_FFT)
    kw.setdefault("selected_subcarriers", SEL_SC)
    return oracle_channels(*(np.asarray(data[k])[idx] for k in KEYS),
                           num_paths=N_PATHS, **kw)


def render_memory(ds, params):
    """memory_analysis of the one-dispatch render compute_channels runs."""
    from deepmimo_tpu.generator import dataset as D

    cfg, bsp, uep = params.to_config(ds.n_ue)
    return cfg, memory(D._render_full_jit.lower(
        ds._path_data(cfg), bsp, uep, cfg, None).compile())


def path_taken(cfg):
    from deepmimo_tpu.ops.channel import _use_render_kernel
    return "fused kernel" if _use_render_kernel(cfg) else "XLA"


@contextlib.contextmanager
def plain_xla():
    """Render kernel-eligible configs through the plain XLA path, the
    kernel's comparison; traces of the other route are dropped on entry
    and exit."""
    import jax
    from deepmimo_tpu.ops import channel as C

    kernel_rule = C._use_render_kernel
    C._use_render_kernel = lambda cfg: False
    jax.clear_caches()
    try:
        yield
    finally:
        C._use_render_kernel = kernel_rule
        jax.clear_caches()


# ----------------------------------------------------------------------------
# a. main path
# ----------------------------------------------------------------------------

def phase_main(s, state):
    import jax
    import deepmimo_tpu as dm
    from deepmimo_tpu.ops.channel import unpack_planes_np
    from scenario_utils import write_synthetic_scenario

    folder = os.path.join(state["tmp"], "asu_campus_synthetic")
    t0 = time.perf_counter()
    data = write_synthetic_scenario(folder, n_ue=N_UE, max_paths=N_PATHS,
                                    seed=0, grid=GRID)
    t1 = time.perf_counter()
    ds = dm.load(folder)
    print(f"  scenario written in {t1 - t0:.1f} s, loaded in "
          f"{time.perf_counter() - t1:.1f} s: {ds.n_ue} users x "
          f"{np.asarray(ds.power).shape[1]} paths", flush=True)
    params = headline_params()
    cfg, mem = render_memory(ds, params)
    print(f"  path: {path_taken(cfg)}; render {mem}", flush=True)

    h_dev = ds.compute_channels(params, to_device=True)
    jax.block_until_ready(h_dev)
    print(f"  to_device planes {h_dev.shape} {h_dev.dtype}", flush=True)
    h = ds.compute_channels(params)
    print(f"  host channels {h.shape} {h.dtype}", flush=True)
    assert h.shape == (N_UE, 1, 64, 64) and np.isfinite(h).all()
    idx = np.sort(np.random.RandomState(1).choice(N_UE, ORACLE_USERS,
                                                   replace=False))
    s.check("to_device planes == host channels",
            rel_err(unpack_planes_np(np.asarray(h_dev[idx]), cfg), h[idx]),
            0.0)
    s.check(f"compute_channels vs float64 oracle ({ORACLE_USERS} users)",
            rel_err(h[idx], oracle(data, idx)), TOL_ORACLE)
    state["data"], state["ds"] = data, ds


# ----------------------------------------------------------------------------
# b. kernel at real widths + kernel vs XLA through compute_channels
# ----------------------------------------------------------------------------

def phase_kernel(s, state):
    import jax
    import jax.numpy as jnp
    import deepmimo_tpu as dm
    from deepmimo_tpu.ops.pallas import render as R

    @jax.jit
    def err(h, hr, hi):                      # packed kernel output
        sk = hr.shape[-1]
        gr, gi = h[..., :sk], h[..., sk:]
        return (jnp.maximum(jnp.abs(gr - hr).max(), jnp.abs(gi - hi).max())
                / jnp.maximum(jnp.abs(hr).max(), jnp.abs(hi).max()))

    # (name, users, rx, tx, K, slots, per-slot amp)
    widths = [("headline", TIMED_USERS, (1, 1), BS_SHAPE, 64, 1, False),
              ("MIMO (2,1)x(8,8)", TIMED_USERS, (2, 1), BS_SHAPE, 64, 1,
               False),
              ("Doppler 16 snapshots x 8 subcarriers", SIDE_USERS, (1, 1),
               BS_SHAPE, 8, 16, False),
              ("dual-polar 4 slots", SIDE_USERS, (1, 1), BS_SHAPE, 64, 4,
               True)]
    for name, u, rx, tx, k, n_s, slot_amp in widths:
        keys = jax.random.split(jax.random.PRNGKey(u + n_s), 7)
        uni = lambda i, lo, hi, n: jax.random.uniform(
            keys[i], (u, n), jnp.float32, lo, hi)
        args = (uni(0, -3, 3, N_PATHS), uni(1, -3, 3, N_PATHS),
                uni(2, -3, 3, N_PATHS), uni(3, -3, 3, N_PATHS),
                uni(4, 0, 1e-3, (n_s if slot_amp else 1) * N_PATHS),
                uni(5, -3, 3, n_s * N_PATHS), uni(6, 0, 6, N_PATHS))
        fn = jax.jit(lambda *a: R.fused_render(*a, rx, tx, k, packed=True))
        compiled = fn.lower(*args).compile()
        h = compiled(*args)
        n = 4096
        ref = R._reference_impl(*(a[:n] for a in args), rx, tx, k)
        q = rx[0] * rx[1] * tx[0] * tx[1]
        print(f"  kernel {name}: {u} users, H {h.shape} "
              f"(Q={q}, S*K={n_s * k}); {memory(compiled)}", flush=True)
        s.check(f"kernel {name} vs HIGHEST reference ({n} users)",
                float(err(h[:n], *ref)), TOL_KERNEL)
        del h, ref

    # Kernel vs plain XLA end to end: the same donated compute_channels
    # call on each route, in blocks kernel, XLA, XLA, kernel; medians of
    # the per-dispatch times.
    import re
    from deepmimo_tpu.generator import dataset as D
    from deepmimo_tpu.ops.channel import unpack_planes_np

    data = state["data"]
    idx = np.sort(np.random.RandomState(5).choice(
        TIMED_USERS, min(TIMED_USERS, 512), replace=False))
    results = {}
    for name, ue_shape in (("headline", (1, 1)), ("MIMO (2,1)x(8,8)",
                                                   (2, 1))):
        ds = dm.Dataset({**{k: np.asarray(data[k])[:TIMED_USERS]
                            for k in KEYS},
                         "rx_pos": np.zeros((TIMED_USERS, 3), np.float32),
                         "tx_pos": np.zeros((1, 3), np.float32)})
        params = headline_params()
        params["ue_antenna"]["shape"] = np.array(ue_shape)
        cfg, bsp, uep = params.to_config(TIMED_USERS)
        outs, times, algs = {}, {"fused": [], "xla": []}, None
        for path in ("fused", "xla", "xla", "fused"):
            with plain_xla() if path == "xla" else contextlib.nullcontext():
                for rep in range(2 + TIMING_REPS // 2):
                    t0 = time.perf_counter()
                    outs[path] = ds.compute_channels(
                        params, to_device=True, out=outs.get(path))
                    jax.block_until_ready(outs[path])
                    if rep >= 2:              # 0-1 compile: without, then
                        times[path].append(   # with a donated buffer
                            time.perf_counter() - t0)
                if path == "xla" and algs is None:
                    hlo = D._render_full_jit.lower(
                        ds._path_data(cfg), bsp, uep, cfg,
                        None).compile().as_text()
                    algs = sorted(set(re.findall(
                        r'algorithm[=":]+\s*"?(\w+)', hlo)))
        med = {b: float(np.median(t)) * 1e3 for b, t in times.items()}
        results[name] = med
        print(f"  compute_channels {name}, {TIMED_USERS} users, "
              f"{len(times['fused'])} donated dispatches each: fused "
              f"kernel median "
              f"{med['fused']:.3f} ms (min {min(times['fused']) * 1e3:.3f}),"
              f" XLA median {med['xla']:.3f} ms (min "
              f"{min(times['xla']) * 1e3:.3f}); XLA/kernel "
              f"{med['xla'] / med['fused']:.2f}x; kernel path taken: "
              f"{path_taken(cfg)}; XLA path dot algorithms: {algs}",
              flush=True)
        ref = oracle(data, idx, ue_shape=ue_shape)
        for path, label in (("fused", "kernel"), ("xla", "XLA")):
            got = unpack_planes_np(np.asarray(outs[path][idx]), cfg)
            s.check(f"{name}: {label} path vs float64 oracle (512 users)",
                    rel_err(got, ref), TOL_ORACLE)
        del outs
    state["timing"] = results

    import test_pallas
    for case in test_pallas.GPU_CASES:
        test_pallas.test_fused_render_compiled_matches_reference(case)
        print(f"  test_fused_render_compiled_matches_reference[{case[0]}] "
              "passed", flush=True)


# ----------------------------------------------------------------------------
# c. other product paths at 32,768 users
# ----------------------------------------------------------------------------

def phase_products(s, state):
    import jax
    import jax.numpy as jnp
    import deepmimo_tpu as dm
    from deepmimo_tpu.generator import dataset as D
    from deepmimo_tpu.ops.channel import render_beam_gains

    data = state["data"]
    u = SIDE_USERS
    base = {**{k: np.asarray(data[k])[:u] for k in KEYS},
            "rx_pos": np.zeros((u, 3), np.float32),
            "tx_pos": np.zeros((1, 3), np.float32)}
    idx = np.sort(np.random.RandomState(2).choice(u, min(u, 256),
                                                   replace=False))

    # Dual-polar: per-polarization power/phase, shared geometry.
    rng = np.random.RandomState(3)
    nan = np.isnan(base["power"])
    pols = {}
    ds = dm.Dataset(dict(base))
    for pol in ("vv", "vh", "hh", "hv"):
        pols[pol] = (np.where(nan, np.nan, rng.uniform(-120, -70, nan.shape)
                              ).astype(np.float32),
                     np.where(nan, np.nan, rng.uniform(-180, 180, nan.shape)
                              ).astype(np.float32))
        ds[f"power_{pol}"], ds[f"phase_{pol}"] = pols[pol]
    params = headline_params()
    params["enable_dual_polar"] = 1
    cfg = params.to_config(u)[0]
    pol_p, pol_ph = ds._polar_stacks()
    _, bsp, uep = params.to_config(u)
    compiled = D._render_polar_jit.lower(ds._path_data(cfg), bsp, uep, cfg,
                                         pol_p, pol_ph).compile()
    quad = ds.compute_channels(params)
    print(f"  dual-polar: path {path_taken(cfg)}; {len(quad)} x "
          f"{quad['VV'].shape}; {memory(compiled)}", flush=True)
    for pol, (pw, ph) in pols.items():
        ref = oracle({**base, "power": pw, "phase": ph}, idx)
        s.check(f"dual-polar {pol.upper()} vs oracle",
                rel_err(quad[pol.upper()][idx], ref), TOL_ORACLE)
    del quad

    # Beam gains: a 2x-oversampled 2-D DFT codebook (16 x 16 = 256 beams).
    ds = dm.Dataset(dict(base))
    params = headline_params()
    m = np.arange(8)
    dft = lambda n: np.exp(2j * np.pi * np.outer(np.arange(n) / n - 0.5,
                                                 m)) / np.sqrt(8)   # [n, 8]
    # Antenna t = n * 8 + m: kron(z-beam, y-beam).
    cb = np.einsum("in,jm->ijnm", dft(16), dft(16)).reshape(256, 64)
    g = ds.compute_beam_gains(params, codebook=cb)
    cfg, bsp, uep = params.to_config(u)
    wr = jnp.asarray(cb.real, jnp.float32)
    wi = jnp.asarray(cb.imag, jnp.float32)
    compiled = render_beam_gains.lower(ds._path_data(cfg), bsp, uep, cfg,
                                       wr, wi).compile()
    print(f"  beam gains: path XLA (codebook fold); G {g.shape}; "
          f"{memory(compiled)}", flush=True)
    h_ref = oracle(base, idx)
    g_ref = np.abs(np.einsum("bt,urtk->urbk", cb.conj(), h_ref)) ** 2
    s.check("beam gains vs |conj(W) H_oracle|^2", rel_err(g[idx], g_ref),
            TOL_BEAM)
    del g

    # Time domain and the sinc receive filter (plain XLA paths).
    for name, extra, okw in (("time domain", {}, dict(freq_domain=False)),
                             ("rx_filter", {"rx_filter": 1},
                              dict(rx_filter=True))):
        ds = dm.Dataset(dict(base))
        params = headline_params(**extra)
        if name == "time domain":
            params["freq_domain"] = 0
        cfg, mem = render_memory(ds, params)
        h = ds.compute_channels(params)
        print(f"  {name}: path {path_taken(cfg)}; H {h.shape}; {mem}",
              flush=True)
        s.check(f"{name} vs oracle", rel_err(h[idx], oracle(base, idx,
                                                            **okw)),
                TOL_ORACLE)
        del h
    jax.clear_caches()


# ----------------------------------------------------------------------------
# d. training steps
# ----------------------------------------------------------------------------

def phase_training(s, state):
    import dataclasses

    import jax
    import jax.numpy as jnp
    from deepmimo_tpu.ops.channel import render_channels_planes
    from deepmimo_tpu.ops.types import AntennaPanel, PathData
    from deepmimo_tpu.parallel.sharded import (calib_loss_planes,
                                               init_calib_params,
                                               training_step_planes)

    data = state["data"]
    u = SIDE_USERS
    paths = PathData.from_numpy(*(np.asarray(data[k])[:u] for k in KEYS))
    cfg = headline_params().to_config(u)[0]
    bs, ue = AntennaPanel.make(), AntennaPanel.make()
    target = render_channels_planes(paths, AntennaPanel.make((0, 0, 10)),
                                    ue, cfg)
    params = init_calib_params(paths, bs, ue)
    compiled = training_step_planes.lower(params, paths, target, cfg,
                                          3e-3).compile()
    print(f"  training_step_planes: {u} users, target {target.shape}; "
          f"forward path {path_taken(cfg)}, backward: VJP of the plain "
          f"reference; step {memory(compiled)}", flush=True)

    # Gradients of the training loss through the product path (the kernel
    # and its custom VJP) and through the plain XLA path, each against
    # the float64 gradient of the XLA path, leaf by leaf.
    grad = jax.jit(jax.grad(calib_loss_planes), static_argnums=3)
    g_k = grad(params, paths, target, cfg)
    with plain_xla():
        g_x = grad(params, paths, target, cfg)
    with jax.enable_x64(True):
        to64 = lambda t: jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32
            else x, t)
        sk = target.shape[-1] // 2
        g_64 = grad(to64(params), to64(paths),
                    jnp.stack((target[..., :sk], target[..., sk:])).astype(
                        jnp.float64),
                    dataclasses.replace(cfg, dtype="complex128"))
    leaves = lambda g: [np.asarray(x, np.float64) for x in jax.tree.leaves(g)]
    names = ("bs.rotation", "bs.spacing", "ue.rotation", "ue.spacing",
             "d_power", "d_phase", "d_delay", "d_angles")
    for name, k, x, r in zip(names, leaves(g_k), leaves(g_x), leaves(g_64)):
        if name == "d_angles":               # one leaf per angle
            parts = [(f"d_angles[{a}]", k[..., i], x[..., i], r[..., i])
                     for i, a in enumerate(("aoa_az", "aoa_el", "aod_az",
                                            "aod_el"))]
        else:
            parts = [(name, k, x, r)]
        for leaf, k_, x_, r_ in parts:
            scale = np.abs(r_).max()
            for label, g in (("kernel path", k_), ("XLA path", x_)):
                if scale == 0:               # no dependence: exactly zero
                    s.check(f"gradient {leaf} ({label}): float64 gradient "
                            "is exactly 0, max |grad|", np.abs(g).max(), 0.0)
                else:
                    s.check(f"gradient {leaf} ({label}) vs float64",
                            np.abs(g - r_).max() / scale, TOL_GRAD)

    losses = []
    for _ in range(3):
        params, loss_v = training_step_planes(params, paths, target, cfg,
                                              lr=3e-3)
        losses.append(float(loss_v))
    print(f"  losses {losses}", flush=True)
    ok = all(np.isfinite(losses)) and losses[2] < losses[1] < losses[0]
    s.check("loss finite and falling (0 = yes)", 0.0 if ok else 1.0, 0.0)


# ----------------------------------------------------------------------------
# e. four cards
# ----------------------------------------------------------------------------

def phase_four_cards(s, state):
    import jax
    import jax.numpy as jnp
    from deepmimo_tpu.ops.channel import (render_beam_gains,
                                          render_channels,
                                          render_channels_planes_polar)
    from deepmimo_tpu.ops.types import AntennaPanel, PathData
    from deepmimo_tpu.parallel import (make_mesh, render_channels_sharded,
                                       render_polar_sharded)
    from deepmimo_tpu.parallel.sharded import (init_calib_params,
                                               make_sharded_training_step,
                                               render_beam_gains_sharded,
                                               training_step)
    from oracle import make_synthetic_paths

    devices = jax.devices()
    assert len(devices) >= 4, f"need 4 cards, have {len(devices)}"
    mesh = make_mesh(devices[:4])
    u = TIMED_USERS
    data = make_synthetic_paths(n_ue=u, max_paths=N_PATHS, seed=0)
    paths = PathData.from_numpy(*(data[k] for k in KEYS))
    cfg = headline_params().to_config(u)[0]
    bs, ue = AntennaPanel.make((10.0, 0.0, 30.0)), AntennaPanel.make()
    print(f"  mesh {dict(zip(mesh.axis_names, mesh.devices.shape))} over "
          f"{[d.id for d in devices[:4]]}; {u} users", flush=True)

    one = jax.device_get(render_channels(paths, bs, ue, cfg))
    four = jax.device_get(render_channels_sharded(paths, bs, ue, cfg, mesh))
    s.check("render_channels_sharded vs one card", rel_err(four, one),
            1e-6)
    del one, four

    rng = np.random.RandomState(4)
    w = np.exp(1j * rng.uniform(-np.pi, np.pi, (16, 64))) / 8.0
    wr, wi = (jnp.asarray(x, jnp.float32) for x in (w.real, w.imag))
    one = jax.device_get(render_beam_gains(paths, bs, ue, cfg, wr, wi))
    four = jax.device_get(render_beam_gains_sharded(paths, bs, ue, cfg, wr,
                                                    wi, mesh))
    s.check("render_beam_gains_sharded vs one card", rel_err(four, one),
            1e-6)

    pol = rng.uniform(-120, -70, (4, u, N_PATHS)).astype(np.float32)
    pol_ph = rng.uniform(-180, 180, (4, u, N_PATHS)).astype(np.float32)
    cfg_pol = cfg.replace(planes_layout="packed")
    one = jax.device_get(render_channels_planes_polar(
        paths, bs, ue, cfg_pol, jnp.asarray(pol), jnp.asarray(pol_ph)))
    four = jax.device_get(render_polar_sharded(paths, bs, ue, cfg_pol, pol,
                                               pol_ph, mesh))
    s.check("render_polar_sharded (kernel per card) vs one card",
            rel_err(four, one), 1e-6)
    del one, four

    n = SIDE_USERS
    sub = jax.tree_util.tree_map(lambda x: x[:n], paths)
    target = render_channels(sub, AntennaPanel.make((10.0, 0.0, 40.0)), ue,
                             cfg)
    params = init_calib_params(sub, bs, ue)
    p1, loss1 = training_step(params, sub, target, cfg, lr=1e-3)
    step, place = make_sharded_training_step(mesh, cfg, lr=1e-3)
    p4, loss4 = step(*place(params, sub, target))
    s.check("make_sharded_training_step loss vs one card",
            rel_err(float(loss4), float(loss1)), 1e-5)
    s.check("make_sharded_training_step update vs one card",
            max(rel_err(a, b) for a, b in zip(jax.tree.leaves(p4),
                                               jax.tree.leaves(p1))), 1e-4)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths on a 4-card mesh")
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU, JAX found "
              f"{dev.platform!r}", file=sys.stderr)
        return 2
    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
    import deepmimo_tpu as dm
    if not os.path.abspath(dm.__file__).startswith(HERE + os.sep):
        print(f"chip_smoke: imported the package from {dm.__file__}, not "
              f"from {HERE}", file=sys.stderr)
        return 2
    from deepmimo_tpu.utils.compile_cache import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"device_kind: {dev.device_kind}; devices: {len(jax.devices())}",
          flush=True)
    print(f"nvidia-smi: {smi}", flush=True)

    s = Smoke()
    if args.four_cards:
        s.phase("e: four cards", phase_four_cards, {})
        count = 4
    else:
        with tempfile.TemporaryDirectory() as tmp:
            state = {"tmp": tmp}
            s.phase("a: main path", phase_main, state)
            if "data" in state:
                for name, fn in (("b: render kernel", phase_kernel),
                                 ("c: product paths", phase_products),
                                 ("d: training", phase_training)):
                    s.phase(name, fn, state)
        count = 1
    if s.failed:
        print(f"chip_smoke FAILED: {s.failed}", flush=True)
    print(smi, flush=True)                  # name, power limit per card
    print(json.dumps({"ok": not s.failed,
                      "device": {"platform": dev.platform,
                                 "kind": dev.device_kind, "count": count}}))
    return 1 if s.failed else 0


if __name__ == "__main__":
    sys.exit(main())
