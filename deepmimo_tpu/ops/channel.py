"""Fused path→channel renderer: the computational heart of the framework.

Synthesizes MIMO channel matrices from per-path ray data:

    H[u, r, t, k] = sum_p  a_rx[u, r, p] * a_tx[u, t, p] * g[u, p, k]

with g the per-path complex gain (power, phase, OFDM delay phase ramp,
optional sinc receive filter, optional Doppler). This re-implements the
full reference pipeline — rotate -> FoV -> pattern gain -> array response ->
OFDM path constants -> path sum (reference deepmimo/generator/channel.py:
141-288 and dataset.py:224-417) — as one pure, jitted, differentiable
function with static shapes.

Design notes:
- The computation is bound by device-memory bandwidth on writing H
  (arithmetic intensity ~= n_paths flops/byte, far below the tensor cores'
  ridge point), so the renderer writes H exactly once and keeps every
  intermediate O(P/K) or O(P/(R*T)) relative to H. The path sum is a
  batched complex matmul (R*T, P) x (P, K). On a GPU, configs that
  :func:`fused_render_eligible` accepts render through one fused kernel
  (ops/pallas/render.py); everything else is plain XLA.
- Validity masks (not NaNs) gate padded path slots; gradients flow only
  through real paths.
- No data-dependent shapes: paths are padded to cfg.num_paths, subcarrier
  selection is static.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import consts as c
from .types import PathData, AntennaPanel, ChannelConfig
from .geometry import rotate_angles, apply_fov, array_response, is_full_fov
from .patterns import pattern_gain


# ============================================================================
# Stage helpers (each pure; fused by XLA under jit)
# ============================================================================

def _rotated_angles(paths: PathData, bs: AntennaPanel, ue: AntennaPanel):
    """Rotate departure angles by the BS array rotation and arrival angles by
    the UE rotation. Returns radians ([U, P] each)."""
    aod_theta, aod_phi = rotate_angles(bs.rotation_deg,
                                       paths.aod_el_deg, paths.aod_az_deg)
    aoa_theta, aoa_phi = rotate_angles(ue.rotation_deg,
                                       paths.aoa_el_deg, paths.aoa_az_deg)
    return aod_theta, aod_phi, aoa_theta, aoa_phi


def _fov_valid(cfg: ChannelConfig, valid, aod_theta, aod_phi, aoa_theta,
               aoa_phi):
    """AND the path-validity mask with the FoV inclusion masks (static
    branches: None or full-sphere FoVs compile to no-ops)."""
    if cfg.bs_fov is not None and not is_full_fov(cfg.bs_fov):
        valid = valid & apply_fov(cfg.bs_fov, aod_theta, aod_phi)
    if cfg.ue_fov is not None and not is_full_fov(cfg.ue_fov):
        valid = valid & apply_fov(cfg.ue_fov, aoa_theta, aoa_phi)
    return valid


def _powers_linear(cfg: ChannelConfig, paths: PathData, valid,
                   aod_theta, aod_phi, aoa_theta, aoa_phi):
    """Linear path power [W] with TX/RX pattern gains applied ([U, P])."""
    p_lin = jnp.power(10.0, paths.power_dbw / 10.0)
    gain = (pattern_gain(cfg.bs_pattern, aod_theta, aod_phi) *
            pattern_gain(cfg.ue_pattern, aoa_theta, aoa_phi))
    return jnp.where(valid, p_lin * gain, 0.0)


def _doppler_phase(cfg: ChannelConfig, paths: PathData, tau, t_snap):
    """Doppler phase factor exp(-j 2 pi f_c (v (tau+t)/c + a (tau+t)^2/2c)).

    Reduces to the v3 formulation (reference deepmimo_v3/generator/python/
    construct_deepmimo.py:266-280) at t_snap = 0. ``tau`` broadcasts against
    the path axes; ``t_snap`` is a scalar snapshot time.
    """
    if paths.doppler_vel is None:
        return None
    v = paths.doppler_vel[..., None] if tau.ndim > paths.doppler_vel.ndim else paths.doppler_vel
    a = paths.doppler_acc[..., None] if tau.ndim > paths.doppler_acc.ndim else paths.doppler_acc
    t = tau + t_snap
    arg = (-2 * jnp.pi * cfg.carrier_freq *
           (v * t / c.LIGHTSPEED + a * (t * t) / (2 * c.LIGHTSPEED)))
    return jnp.exp(1j * arg.astype(_rd(cfg)))


def _rd(cfg: ChannelConfig):
    return cfg.rdtype


def _xla_precision(cfg: ChannelConfig, complex_dot: bool = False):
    """Dot precision for the XLA (non-kernel) path sums.

    A float32 product left at DEFAULT precision runs in TF32 on a GPU's
    tensor cores (about 3 decimal digits), so "float32" and "highest" name
    the full float32 algorithm explicitly for real operands. Dots of
    complex operands and complex128 renders (the parity path) take the
    HIGHEST precision enum instead: dot-algorithm presets do not describe
    complex products. "bfloat16" and "default" leave the choice to the
    operand dtype and XLA.
    """
    if cfg.matmul_dtype not in ("float32", "highest"):
        return None
    if complex_dot or cfg.dtype == "complex128":
        return jax.lax.Precision.HIGHEST
    return jax.lax.DotAlgorithmPreset.F32_F32_F32


def _ofdm_path_gains(cfg: ChannelConfig, powers_lin, delays, phase_deg, valid,
                     t_snap, paths: PathData):
    """Per-path complex gain on the selected subcarriers: g[u, p, k].

    Implements the OFDM path constant sqrt(P/N) e^{j phi} e^{-j 2 pi d_n k/N}
    with over-FFT trimming, optional sinc receive filter, and optional
    Doppler (reference generator/channel.py:166-198).
    """
    n_fft = cfg.subcarriers
    ts = 1.0 / cfg.bandwidth
    k_sel = jnp.asarray(np.asarray(cfg.selected_subcarriers, dtype=np.float64),
                        dtype=_rd(cfg))                      # [K]

    delay_n = delays / ts                                    # [U, P]
    in_fft = delay_n < n_fft
    pvalid = valid & in_fft
    amp = jnp.where(pvalid, jnp.sqrt(powers_lin / n_fft), 0.0)
    psi = jnp.deg2rad(phase_deg)

    if not cfg.rx_filter:
        # g[u,p,k] = amp * exp(j(psi - 2 pi delay_n k / N)) [* doppler]
        base = psi[..., None] - (2 * jnp.pi / n_fft) * delay_n[..., None] * k_sel
        g = amp[..., None] * jnp.exp(1j * base.astype(_rd(cfg)))
        if cfg.enable_doppler:
            dop = _doppler_phase(cfg, paths, delays, t_snap)   # [U, P]
            if dop is not None:
                g = g * dop[..., None]
    else:
        # Sinc receive filter: path energy smears across delay taps d, then
        # a delay->subcarrier DFT projects taps onto the selected bins.
        d = jnp.arange(n_fft, dtype=_rd(cfg))                 # [D]
        taps = jnp.sinc(d[None, None, :] - delay_n[..., None])  # [U, P, D]
        path_const = (amp * jnp.exp(1j * psi.astype(_rd(cfg))))[..., None] * taps
        if cfg.enable_doppler:
            # Per-tap Doppler with tap delay d * Ts (v3 LPF semantics).
            dop = _doppler_phase(cfg, paths, (d * ts)[None, None, :], t_snap)
            if dop is not None:
                path_const = path_const * dop
        if cfg.selected_subcarriers == tuple(range(n_fft)):
            # Full-band output: the delay->subcarrier projection IS the
            # DFT, so use an FFT (O(N log N) per path instead of O(N*K)).
            g = jnp.fft.fft(path_const.astype(cfg.cdtype), axis=-1)
        else:
            dft = jnp.exp(-1j * (2 * jnp.pi / n_fft) *
                          (d[:, None] * k_sel[None, :]).astype(_rd(cfg)))
            g = jnp.einsum("upd,dk->upk", path_const.astype(cfg.cdtype),
                           dft.astype(cfg.cdtype),
                           precision=_xla_precision(cfg, complex_dot=True))
    return g.astype(cfg.cdtype)


def _td_compact_active(cfg: ChannelConfig) -> bool:
    """Static decision: does the TD render need path compaction?

    Loader/converter path data is tail-padded (validity front-packed), so
    only FoV filtering can punch interior holes. See
    ChannelConfig.compact_td_paths.
    """
    if not cfg.compact_td_paths:
        return False
    if cfg.compact_td_paths == "auto":
        return ((cfg.bs_fov is not None and not is_full_fov(cfg.bs_fov)) or
                (cfg.ue_fov is not None and not is_full_fov(cfg.ue_fov)))
    return True


def _compact_paths(cfg, paths: PathData, valid, powers_lin, aod_theta,
                   aod_phi, aoa_theta, aoa_phi):
    """Pack valid path slots to the front (reference TD output ordering,
    reference generator/channel.py:287).

    Uses a cumsum-rank one-hot permutation applied as one batched matmul
    instead of argsort + per-array gathers (the permutation matmul is
    exact — each output row selects one input).
    """
    rd = _rd(cfg)
    u, p = valid.shape
    v = valid.astype(rd)
    rank_valid = jnp.cumsum(v, axis=1) - 1
    n_valid = jnp.sum(v, axis=1, keepdims=True)
    rank_invalid = jnp.cumsum(1.0 - v, axis=1) - 1
    dest = jnp.where(valid, rank_valid, n_valid + rank_invalid)   # [U, P]
    slots = jnp.arange(p, dtype=rd)
    onehot = (dest[:, None, :] == slots[None, :, None]).astype(rd)

    arrs = [powers_lin, aod_theta, aod_phi, aoa_theta, aoa_phi,
            paths.power_dbw, paths.phase_deg, paths.delay_s,
            paths.aoa_az_deg, paths.aoa_el_deg, paths.aod_az_deg,
            paths.aod_el_deg]
    if paths.doppler_vel is not None:
        arrs += [paths.doppler_vel, paths.doppler_acc]
    stacked = jnp.stack([a.astype(rd) for a in arrs], axis=-1)
    # HIGHEST: the permutation must be EXACT — each output row selects one
    # input value; a TF32 or bf16 dot would round every routed value.
    out = jnp.einsum("uds,usa->uda", onehot, stacked,
                     preferred_element_type=rd,
                     precision=jax.lax.Precision.HIGHEST)
    cols = [out[..., i] for i in range(len(arrs))]
    new_valid = slots[None, :] < n_valid
    new_paths = PathData(
        power_dbw=cols[5], phase_deg=cols[6], delay_s=cols[7],
        aoa_az_deg=cols[8], aoa_el_deg=cols[9], aod_az_deg=cols[10],
        aod_el_deg=cols[11], valid=new_valid,
        doppler_vel=cols[12] if paths.doppler_vel is not None else None,
        doppler_acc=cols[13] if paths.doppler_vel is not None else None)
    return (new_paths, new_valid, cols[0], cols[1], cols[2], cols[3],
            cols[4])


# ============================================================================
# Plane-based (real/imag) path: real matmuls, H written as planes
# ============================================================================

def _ofdm_gain_planes(cfg: ChannelConfig, powers_lin, delays, phase_deg,
                      valid, t_snap, paths: PathData):
    """Per-path OFDM gains as (gr, gi) planes, [U, P, K] each (non-LPF)."""
    n_fft = cfg.subcarriers
    ts = 1.0 / cfg.bandwidth
    k_sel = jnp.asarray(np.asarray(cfg.selected_subcarriers,
                                   dtype=np.float64), dtype=_rd(cfg))

    delay_n = delays / ts
    pvalid = valid & (delay_n < n_fft)
    amp = jnp.where(pvalid, jnp.sqrt(powers_lin / n_fft), 0.0)
    base = (jnp.deg2rad(phase_deg)[..., None] -
            (2 * jnp.pi / n_fft) * delay_n[..., None] * k_sel)
    if cfg.enable_doppler and paths.doppler_vel is not None:
        t = delays + t_snap
        base = base - (2 * jnp.pi * cfg.carrier_freq * (
            paths.doppler_vel * t / c.LIGHTSPEED +
            paths.doppler_acc * (t * t) / (2 * c.LIGHTSPEED)))[..., None]
    gr = amp[..., None] * jnp.cos(base)
    gi = amp[..., None] * jnp.sin(base)
    return gr, gi


def _path_sum_planes_ri(cfg: ChannelConfig, arx, atx, gr, gi):
    """H = sum_p (a_rx a_tx) g via four real batched matmuls -> (hr, hi).

    Accumulation is always float32. Returning planes (not complex) skips
    a full extra read+write of H.
    """
    (arx_r, arx_i), (atx_r, atx_i) = arx, atx
    u, r, p = arx_r.shape
    t = atx_r.shape[1]
    er = (arx_r[:, :, None, :] * atx_r[:, None, :, :] -
          arx_i[:, :, None, :] * atx_i[:, None, :, :]).reshape(u, r * t, p)
    ei = (arx_r[:, :, None, :] * atx_i[:, None, :, :] +
          arx_i[:, :, None, :] * atx_r[:, None, :, :]).reshape(u, r * t, p)

    if cfg.matmul_dtype == "bfloat16":
        cast = lambda x: x.astype(jnp.bfloat16)
        er, ei, gr, gi = cast(er), cast(ei), cast(gr), cast(gi)

    prec = _xla_precision(cfg)
    mm = lambda a, b: jnp.einsum("uqp,upk->uqk", a, b,
                                 preferred_element_type=jnp.float32,
                                 precision=prec)
    hr = mm(er, gr) - mm(ei, gi)
    hi = mm(er, gi) + mm(ei, gr)
    k = gr.shape[-1]
    return hr.reshape(u, r, t, k), hi.reshape(u, r, t, k)


def _path_sum_planes(cfg: ChannelConfig, arx, atx, gr, gi):
    hr, hi = _path_sum_planes_ri(cfg, arx, atx, gr, gi)
    return (hr + 1j * hi).astype(cfg.cdtype)


def _td_gain_planes(cfg: ChannelConfig, powers_lin, phase_deg, valid,
                    t_snap, paths: PathData):
    """Time-domain per-path gains as (gr, gi) planes [U, P]."""
    amp = jnp.where(valid, jnp.sqrt(powers_lin), 0.0)
    psi = jnp.deg2rad(phase_deg)
    if cfg.enable_doppler and paths.doppler_vel is not None:
        t = paths.delay_s + t_snap
        psi = psi - 2 * jnp.pi * cfg.carrier_freq * (
            paths.doppler_vel * t / c.LIGHTSPEED +
            paths.doppler_acc * (t * t) / (2 * c.LIGHTSPEED))
    return amp * jnp.cos(psi), amp * jnp.sin(psi)


def _td_channel_planes_ri(arx, atx, gr, gi):
    """H[u,r,t,p] planes = (a_rx a_tx) * g, all elementwise (no path sum)."""
    (arx_r, arx_i), (atx_r, atx_i) = arx, atx
    er = (arx_r[:, :, None, :] * atx_r[:, None, :, :] -
          arx_i[:, :, None, :] * atx_i[:, None, :, :])
    ei = (arx_r[:, :, None, :] * atx_i[:, None, :, :] +
          arx_i[:, :, None, :] * atx_r[:, None, :, :])
    g_r = gr[:, None, None, :]
    g_i = gi[:, None, None, :]
    return er * g_r - ei * g_i, er * g_i + ei * g_r


def _k_progression(cfg: ChannelConfig):
    """(k0, stride) if selected subcarriers form an arithmetic progression.

    Static (cfg is hashable/static under jit), so this gates compile-time
    dispatch to the fused kernel. Single subcarrier counts with stride 1.
    """
    ks = tuple(int(k) for k in cfg.selected_subcarriers)
    if len(ks) == 1:
        return ks[0], 1
    d = ks[1] - ks[0]
    if d != 0 and all(b - a == d for a, b in zip(ks, ks[1:])):
        return ks[0], d
    return None


def _fused_n_snap(cfg: ChannelConfig) -> int:
    return len(cfg.doppler_times) if cfg.enable_doppler else 1


def _packed_layout(cfg: ChannelConfig) -> bool:
    """Static: emit the packed [..., 2*S*K] plane layout? Requires opt-in,
    the frequency domain, S*K % 64 == 0 (so hr and hi each fill whole
    64-float rows) and the planes fast path (complex64, no sinc filter);
    the other configs render complex H and stack its planes."""
    sk = len(cfg.selected_subcarriers) * _fused_n_snap(cfg)
    return (cfg.planes_layout == "packed" and cfg.freq_domain
            and cfg.dtype == "complex64" and not cfg.rx_filter
            and sk % 64 == 0)


def _angles_needed(cfg: ChannelConfig) -> bool:
    """Static: does any stage need rotated ANGLES (vs unit vectors)?

    FoV masks and non-isotropic patterns are functions of (theta', phi');
    the fused render itself needs only the rotated wave-vector components,
    which rotate_unit_vec provides without arccos/atan2/second-sincos.
    """
    fov_on = ((cfg.bs_fov is not None and not is_full_fov(cfg.bs_fov)) or
              (cfg.ue_fov is not None and not is_full_fov(cfg.ue_fov)))
    return (fov_on or cfg.bs_pattern != "isotropic"
            or cfg.ue_pattern != "isotropic")


def fused_render_eligible(cfg: ChannelConfig) -> bool:
    """Static: can this config render from per-path scalars?

    The one eligibility rule for the fused render (OFDM, no sinc filter,
    complex64, an arithmetic subcarrier selection). Every entry point
    consults it, through :func:`_use_render_kernel` or directly for the
    dual-polar single-dispatch path.
    """
    return bool(cfg.freq_domain and not cfg.rx_filter
                and cfg.dtype == "complex64"
                and _k_progression(cfg) is not None)


def _use_render_kernel(cfg: ChannelConfig) -> bool:
    """Static: render through the fused GPU kernel?

    On a GPU, for every eligible config (the kernel beats the plain XLA
    path end to end there); plain XLA everywhere else. The kernel runs
    compiled; the Pallas interpreter is for tests that call it directly.
    """
    return jax.default_backend() == "gpu" and fused_render_eligible(cfg)


def _fused_path_scalars(cfg: ChannelConfig, paths: PathData, valid,
                        powers_lin):
    """(amp [U,P], psi [U,S*P], omega [U,P]) for the fused render.

    All per-path math runs on flat [U*P] views until the final reshape.
    Shared by the render and beam-gain entry points.
    """
    rd = _rd(cfg)
    u, p = paths.delay_s.shape
    fl = lambda x: x.reshape(-1)
    valid_f = fl(valid)

    n_fft = cfg.subcarriers
    delay_f = fl(paths.delay_s)
    delay_n = delay_f * cfg.bandwidth
    pvalid = valid_f & (delay_n < n_fft)
    amp = jnp.where(pvalid, jnp.sqrt(fl(powers_lin) / n_fft),
                    0.0).astype(rd)

    k0, stride = _k_progression(cfg)
    omega_base = (2 * jnp.pi / n_fft) * delay_n
    psi0 = jnp.deg2rad(fl(paths.phase_deg)) - omega_base * k0
    snapshots = cfg.doppler_times if cfg.enable_doppler else (0.0,)
    n_s = len(snapshots)
    if cfg.enable_doppler and paths.doppler_vel is not None:
        dop_v, dop_a = fl(paths.doppler_vel), fl(paths.doppler_acc)
        psis = []
        for t_snap in snapshots:
            t = delay_f + t_snap
            psis.append(psi0 - 2 * jnp.pi * cfg.carrier_freq * (
                dop_v * t / c.LIGHTSPEED +
                dop_a * (t * t) / (2 * c.LIGHTSPEED)))
        # [S, U*P] -> [U, S*P] (one small transpose; Doppler configs only)
        psi = jnp.stack(psis).reshape(n_s, u, p).transpose(1, 0, 2)
        psi = psi.reshape(u, n_s * p).astype(rd)
    else:
        psi = jnp.broadcast_to(psi0.reshape(u, 1, p),
                               (u, n_s, p)).reshape(u, n_s * p).astype(rd)
    omega = (omega_base * stride).astype(rd).reshape(u, p)
    return amp.reshape(u, p), psi, omega


def _scalar_render(cfg: ChannelConfig, gry, grz, gty, gtz, amp, psi,
                   omega, packed: bool):
    """H planes from per-path scalars: [U, Q, 2*S*K] packed or
    [2, U, Q, S*K] stacked.

    The fused kernel on a GPU (one store of H; ops/pallas/render.py),
    the plain XLA form of the same math elsewhere.
    """
    from .pallas.render import _reference_impl, fused_render

    n_k = len(cfg.selected_subcarriers)
    if _use_render_kernel(cfg):
        return fused_render(gry, grz, gty, gtz, amp, psi, omega,
                            cfg.ue_shape, cfg.bs_shape, n_k,
                            mm_dtype=cfg.matmul_dtype, packed=packed,
                            out_dtype=cfg.out_dtype)
    hr, hi = _reference_impl(gry, grz, gty, gtz, amp, psi, omega,
                             cfg.ue_shape, cfg.bs_shape, n_k,
                             precision=_xla_precision(cfg))
    h = jnp.concatenate((hr, hi), -1) if packed else jnp.stack((hr, hi))
    return h.astype(cfg.out_dtype)


def _wavevec_inputs(cfg: ChannelConfig, paths: PathData, bs, ue):
    """(valid, powers_lin, gry, grz, gty, gtz) for the fused render.

    Angle space (rotated theta/phi + FoV + pattern gains) is only entered
    when a stage needs it; otherwise rotate_unit_vec provides the rotated
    wave-vector components directly on flat [U*P] views (per-user [U, 3]
    rotations keep the [U, P] shape to broadcast per row).
    """
    from .geometry import array_response_phase, rotate_unit_vec

    need_angles = _angles_needed(cfg)
    if need_angles:
        aod_theta, aod_phi, aoa_theta, aoa_phi = _rotated_angles(paths, bs,
                                                                 ue)
        valid = _fov_valid(cfg, paths.valid, aod_theta, aod_phi,
                           aoa_theta, aoa_phi)
        powers_lin = _powers_linear(cfg, paths, valid, aod_theta, aod_phi,
                                    aoa_theta, aoa_phi)
    else:
        valid = paths.valid
        powers_lin = jnp.where(
            valid.reshape(-1),
            jnp.power(10.0, paths.power_dbw.reshape(-1) / 10.0), 0.0)

    kd_ue = 2 * jnp.pi * ue.spacing
    kd_bs = 2 * jnp.pi * bs.spacing
    if need_angles:
        _, gry, grz = array_response_phase(aoa_theta, aoa_phi, kd_ue)
        _, gty, gtz = array_response_phase(aod_theta, aod_phi, kd_bs)
    else:
        flat_ok = (jnp.asarray(ue.rotation_deg).ndim == 1 and
                   jnp.asarray(bs.rotation_deg).ndim == 1)
        v = (lambda x: x.reshape(-1)) if flat_ok else (lambda x: x)
        _, ry, rz = rotate_unit_vec(ue.rotation_deg, v(paths.aoa_el_deg),
                                    v(paths.aoa_az_deg))
        _, ty, tz = rotate_unit_vec(bs.rotation_deg, v(paths.aod_el_deg),
                                    v(paths.aod_az_deg))
        gry, grz = kd_ue * ry, kd_ue * rz
        gty, gtz = kd_bs * ty, kd_bs * tz
    return valid, powers_lin, gry, grz, gty, gtz


def _scalar_inputs(cfg: ChannelConfig, paths: PathData, bs, ue):
    """The fused render's 7 inputs: (gry, grz, gty, gtz [U, P], amp [U, P],
    psi [U, S*P], omega [U, P]), zero on invalid paths."""
    valid, powers_lin, gry, grz, gty, gtz = _wavevec_inputs(cfg, paths,
                                                            bs, ue)
    u, p = paths.delay_s.shape
    valid_f = valid.reshape(-1)
    z = lambda x: jnp.where(valid_f, x.reshape(-1), 0.0).astype(_rd(cfg)) \
        .reshape(u, p)
    amp, psi, omega = _fused_path_scalars(cfg, paths, valid, powers_lin)
    return z(gry), z(grz), z(gty), z(gtz), amp, psi, omega


def _check_beam_gain_cfg(cfg: ChannelConfig, name: str) -> None:
    """Beam gains fold the codebook into the scalar (fused) formulation:
    refuse configs it does not express instead of returning wrong maps."""
    if not (cfg.freq_domain and not cfg.rx_filter and _k_progression(cfg)):
        raise ValueError(
            f"{name} requires the frequency domain, no receive filter "
            "(rx_filter=0) and an arithmetic subcarrier selection; render "
            "channels and fold the codebook downstream for other configs.")


@functools.partial(jax.jit, static_argnames=("cfg",))
def render_beam_gains(paths: PathData, bs: AntennaPanel, ue: AntennaPanel,
                      cfg: ChannelConfig, wr: jax.Array,
                      wi: jax.Array) -> jax.Array:
    """Codebook beam-gain maps G[U, R*B, S*K] WITHOUT materializing H.

    G[u, r, b, k] = |sum_t conj(w[b, t]) H[u, r, t, k]|^2 with the
    codebook folded into the TX response before the path sum
    (ops/beamgain.py): H at T antennas is never formed, and the output
    is T/B x2 smaller than the planes. The reference computes beam maps
    host-side from full H (reference docs/manual beam-selection
    examples); this is the serving path for beam training / initial
    access / coverage maps.

    Args:
        wr/wi: codebook real/imag planes [B, T] (conj applied inside,
            matching ``abs(h @ codebook.conj().T)**2`` consumer code).

    Frequency-domain, no receive filter, arithmetic subcarrier
    selections only.
    """
    from .beamgain import beam_gain

    _check_beam_gain_cfg(cfg, "render_beam_gains")
    paths = paths.trim_paths(cfg.num_paths)
    rd = _rd(cfg)
    return beam_gain(*_scalar_inputs(cfg, paths, bs, ue),
                     jnp.asarray(wr, rd), jnp.asarray(wi, rd),
                     cfg.ue_shape, cfg.bs_shape,
                     len(cfg.selected_subcarriers),
                     precision=_xla_precision(cfg))


def _polar_packed_layout(cfg: ChannelConfig, n_pol: int = 4) -> bool:
    """Static: packed plane layout for the polar render (pol*S*K lanes)."""
    sk = len(cfg.selected_subcarriers) * _fused_n_snap(cfg) * n_pol
    return (cfg.planes_layout == "packed" and cfg.freq_domain
            and sk % 64 == 0)


def _polar_fused_inputs(cfg: ChannelConfig, paths: PathData, bs, ue,
                        pol_power_dbw, pol_phase_deg):
    """Shared dual-polar prologue for the fused render/beam-gain paths.

    Returns (u, p, gry, grz, gty, gtz, amp [U, st*P], psi [U, st*P],
    omega [U, P], st = n_pol * n_snapshots) with the wave-vector steps
    already zero-masked and [U, P]-shaped, and the per-polarization
    amplitudes/phases stacked pol-major on the kernel slot axis
    (angles/delays are shared across polarizations — v3 semantics).
    """
    from .geometry import array_response_phase, rotate_unit_vec

    paths = paths.trim_paths(cfg.num_paths)
    n_pol = pol_power_dbw.shape[0]
    pol_power_dbw = pol_power_dbw[..., :cfg.num_paths]
    pol_phase_deg = pol_phase_deg[..., :cfg.num_paths]
    rd = _rd(cfg)
    u, p = paths.delay_s.shape

    need_angles = _angles_needed(cfg)
    if need_angles:
        aod_theta, aod_phi, aoa_theta, aoa_phi = _rotated_angles(paths, bs,
                                                                 ue)
        valid = _fov_valid(cfg, paths.valid, aod_theta, aod_phi,
                           aoa_theta, aoa_phi)
        gain_f = (pattern_gain(cfg.bs_pattern, aod_theta, aod_phi) *
                  pattern_gain(cfg.ue_pattern, aoa_theta,
                               aoa_phi)).reshape(-1)
    else:
        valid = paths.valid
        gain_f = None

    kd_ue = 2 * jnp.pi * ue.spacing
    kd_bs = 2 * jnp.pi * bs.spacing
    if need_angles:
        _, gry, grz = array_response_phase(aoa_theta, aoa_phi, kd_ue)
        _, gty, gtz = array_response_phase(aod_theta, aod_phi, kd_bs)
    else:
        flat_ok = (jnp.asarray(ue.rotation_deg).ndim == 1 and
                   jnp.asarray(bs.rotation_deg).ndim == 1)
        v = (lambda x: x.reshape(-1)) if flat_ok else (lambda x: x)
        _, ry, rz = rotate_unit_vec(ue.rotation_deg, v(paths.aoa_el_deg),
                                    v(paths.aoa_az_deg))
        _, ty, tz = rotate_unit_vec(bs.rotation_deg, v(paths.aod_el_deg),
                                    v(paths.aod_az_deg))
        gry, grz = kd_ue * ry, kd_ue * rz
        gty, gtz = kd_bs * ty, kd_bs * tz

    # Shared per-path scalars (flat [U*P] views — see _fused_path_scalars)
    fl = lambda x: x.reshape(-1)
    valid_f = fl(valid)
    z = lambda x: jnp.where(valid_f, fl(x), 0.0).astype(rd).reshape(u, p)
    n_fft = cfg.subcarriers
    delay_f = fl(paths.delay_s)
    delay_n = delay_f * cfg.bandwidth
    pvalid = valid_f & (delay_n < n_fft)
    k0, stride = _k_progression(cfg)
    omega_base = (2 * jnp.pi / n_fft) * delay_n
    omega = (omega_base * stride).astype(rd).reshape(u, p)

    snapshots = cfg.doppler_times if cfg.enable_doppler else (0.0,)
    n_s = len(snapshots)
    dop_terms = [0.0] * n_s
    if cfg.enable_doppler and paths.doppler_vel is not None:
        dop_v, dop_a = fl(paths.doppler_vel), fl(paths.doppler_acc)
        for i, t_snap in enumerate(snapshots):
            t = delay_f + t_snap
            dop_terms[i] = -2 * jnp.pi * cfg.carrier_freq * (
                dop_v * t / c.LIGHTSPEED +
                dop_a * (t * t) / (2 * c.LIGHTSPEED))

    # Per-pol amp/psi stacked pol-major on the kernel snapshot axis.
    # Pol matrices arrive NaN-padded straight from the loader (they skip
    # PathData.from_numpy's zero-fill), so BOTH amp and psi are masked:
    # a NaN psi would poison the kernel tables even at amp = 0.
    amps, psis = [], []
    for ip in range(n_pol):
        p_lin = jnp.power(10.0, fl(pol_power_dbw[ip]) / 10.0)
        if gain_f is not None:
            p_lin = p_lin * gain_f
        p_lin = jnp.where(valid_f, p_lin, 0.0)
        amp_p = jnp.where(pvalid, jnp.sqrt(p_lin / n_fft), 0.0).astype(rd)
        psi0 = jnp.where(valid_f,
                         jnp.deg2rad(fl(pol_phase_deg[ip])), 0.0) - \
            omega_base * k0
        for s in range(n_s):
            amps.append(amp_p)
            psis.append((psi0 + dop_terms[s]).astype(rd))
    st = n_pol * n_s
    to_uspp = lambda xs: (jnp.stack(xs).reshape(st, u, p)
                          .transpose(1, 0, 2).reshape(u, st * p))
    amp, psi = to_uspp(amps), to_uspp(psis)
    return (u, p, z(gry), z(grz), z(gty), z(gtz), amp, psi, omega, st)


@functools.partial(jax.jit, static_argnames=("cfg",))
def render_beam_gains_polar(paths: PathData, bs: AntennaPanel,
                            ue: AntennaPanel, cfg: ChannelConfig,
                            pol_power_dbw: jax.Array,
                            pol_phase_deg: jax.Array,
                            wr: jax.Array, wi: jax.Array) -> jax.Array:
    """Per-polarization beam-gain maps G[U, R*B, N_pol*S*K], ONE dispatch.

    Composes the two single-dispatch tricks: the polarization axis rides
    the slot axis with per-slot amplitudes AND phases (the dual-polar
    layout), while the codebook folds into the path sum so no
    polarization's H is ever materialized. The reference would run four
    full generator passes and fold host-side. Slot axis is pol-major
    (slot = pol * S + s); slice G[..., ip*S*K:(ip+1)*S*K] per
    polarization.
    """
    from .beamgain import beam_gain

    _check_beam_gain_cfg(cfg, "render_beam_gains_polar")
    (u, p, gry, grz, gty, gtz, amp, psi, omega,
     st) = _polar_fused_inputs(cfg, paths, bs, ue, pol_power_dbw,
                               pol_phase_deg)
    rd = _rd(cfg)
    return beam_gain(gry, grz, gty, gtz, amp, psi, omega,
                     jnp.asarray(wr, rd), jnp.asarray(wi, rd),
                     cfg.ue_shape, cfg.bs_shape,
                     len(cfg.selected_subcarriers),
                     precision=_xla_precision(cfg))


@functools.partial(jax.jit, static_argnames=("cfg",))
def render_channels_planes_polar(paths: PathData, bs: AntennaPanel,
                                 ue: AntennaPanel, cfg: ChannelConfig,
                                 pol_power_dbw: jax.Array,
                                 pol_phase_deg: jax.Array) -> jax.Array:
    """All polarizations in ONE dispatch (dual-polar device path).

    The reference renders {VV, VH, HH, HV} as four independent generator
    passes (deepmimo_v3/generator/python/generator.py:71-78) — 4x the
    rotation/FoV/pattern/panel work. Here the polarization axis rides
    the fused render's slot axis: rotations, FoV masks, pattern gains
    and panel responses are computed ONCE (angles and delays are shared
    across polarizations — v3 semantics); only the per-path
    amplitude/phase differs per polarization, through per-slot
    amplitudes. On a GPU this is one fused kernel; elsewhere the same
    math in plain XLA.

    Args:
        paths: shared geometry (angles/delays/Doppler); its own
            power/phase fields are ignored.
        pol_power_dbw / pol_phase_deg: [N_pol, U, P] per-polarization
            power (dBW) and phase (deg) matrices.

    Returns (pol-major on the folded axis, s_total = pol * S + s):
        packed layout: [U, R, T, 2 * N_pol * S * K] — hr planes for all
        (pol, s, k) in the first minor half, hi in the second.
        stacked: [2, U, R, T, N_pol, S, K].
    Unpack host-side with :func:`unpack_polar_planes_np`.
    """
    if not fused_render_eligible(cfg):
        raise ValueError(
            "render_channels_planes_polar requires a fused-render config "
            "(OFDM, no rx_filter, complex64, arithmetic subcarrier "
            "selection); render each polarization with render_channels.")
    (u, p, gry, grz, gty, gtz, amp, psi, omega,
     st) = _polar_fused_inputs(cfg, paths, bs, ue, pol_power_dbw,
                               pol_phase_deg)
    n_pol = pol_power_dbw.shape[0]
    n_k = len(cfg.selected_subcarriers)
    packed = _polar_packed_layout(cfg, n_pol)
    h = _scalar_render(cfg, gry, grz, gty, gtz, amp, psi, omega, packed)
    r = cfg.ue_shape[0] * cfg.ue_shape[1]
    t = cfg.bs_shape[0] * cfg.bs_shape[1]
    if packed:
        return h.reshape(u, r, t, 2 * st * n_k)
    n_s = st // n_pol
    return h.reshape(2, u, r, t, n_pol, n_s, n_k)


def unpack_polar_planes_np(arr, cfg: ChannelConfig, n_pol: int = 4):
    """Host-side inverse of :func:`render_channels_planes_polar`.

    Returns [N_pol, U, R, T, K] complex (or [..., K, S] with a trailing
    time axis for multi-snapshot Doppler), matching the per-polarization
    output of :func:`render_channels`.
    """
    arr = np.asarray(arr)
    cdt = np.complex128 if arr.dtype == np.float64 else np.complex64
    if arr.dtype not in (np.float32, np.float64):
        arr = arr.astype(np.float32)
    n_s = _fused_n_snap(cfg)
    n_k = len(cfg.selected_subcarriers)
    if _polar_packed_layout(cfg, n_pol):
        sk = n_pol * n_s * n_k
        u, r, t = arr.shape[:3]
        h = np.empty((u, r, t, sk), dtype=cdt)
        h.real = arr[..., :sk]
        h.imag = arr[..., sk:]
        h = np.moveaxis(h.reshape(u, r, t, n_pol, n_s, n_k), 3, 0)
    else:
        h = np.empty(arr.shape[1:], dtype=cdt)       # [U,R,T,NP,S,K]
        h.real = arr[0]
        h.imag = arr[1]
        h = np.moveaxis(h, 3, 0)                     # [NP,U,R,T,S,K]
    if n_s > 1:
        return np.moveaxis(h, 4, 5)                  # time axis last
    return h[:, :, :, :, 0, :] if h.ndim == 6 else h


def _path_sum(a_rx, a_tx, g, cdtype, cfg=None):
    """H[u, r, t, k] = sum_p a_rx[u,r,p] a_tx[u,t,p] g[u,p,k].

    Associated as (outer-product -> batched matmul) so the only large
    intermediate is E[u, r*t, p] (a factor P/K or P/(R*T) of H).
    """
    u, r, p = a_rx.shape
    t = a_tx.shape[1]
    e = (a_rx[:, :, None, :] * a_tx[:, None, :, :]).reshape(u, r * t, p)
    h = jnp.einsum("uqp,upk->uqk", e.astype(cdtype), g,
                   preferred_element_type=cdtype,
                   precision=(_xla_precision(cfg, complex_dot=True)
                              if cfg else None))
    return h.reshape(u, r, t, g.shape[-1])


# ============================================================================
# Public renderer
# ============================================================================

@functools.partial(jax.jit, static_argnames=("cfg",))
def render_channels_planes(paths: PathData, bs: AntennaPanel,
                           ue: AntennaPanel, cfg: ChannelConfig
                           ) -> jax.Array:
    """Render channels as real/imag planes.

    Layout (decide with :func:`_packed_layout`, a static function of cfg):
    - stacked (default): [2, U, R, T, K(, T_t)]
    - packed (cfg.planes_layout == "packed", freq domain, S*K % 64 == 0):
      [U, R, T, 2*S*K] with hr in the first minor half.

    The serving-oriented output: float32 planes skip the complexification
    pass (a full extra read+write of H). Same configs as the fast path of
    :func:`render_channels` (complex64, no sinc filter; both domains). On
    a GPU, :func:`fused_render_eligible` configs render through the fused
    kernel; the rest, and every config elsewhere, through plain XLA.
    """
    co = (lambda x: x) if cfg.out_dtype == "float32" else \
        (lambda x: x.astype(cfg.out_dtype))
    if not (cfg.dtype == "complex64" and not cfg.rx_filter):
        h = render_channels(paths, bs, ue, cfg)
        return co(jnp.stack((jnp.real(h), jnp.imag(h))))

    from .geometry import array_response_planes

    paths = paths.trim_paths(cfg.num_paths)
    snapshots = cfg.doppler_times if cfg.enable_doppler else (0.0,)
    if _use_render_kernel(cfg):
        # One kernel, all Doppler snapshots: per-snapshot phases ride the
        # subcarrier axis (s-major), and H is stored exactly once.
        packed = _packed_layout(cfg)
        h = _scalar_render(cfg, *_scalar_inputs(cfg, paths, bs, ue), packed)
        u, r, t = paths.delay_s.shape[0], cfg.n_rx_ant, cfg.n_tx_ant
        if packed:                          # hr in the first minor half
            return h.reshape(u, r, t, -1)
        n_s = _fused_n_snap(cfg)
        h = h.reshape(2, u, r, t, n_s, -1)               # [2, U, R, T, S, K]
        return h[:, :, :, :, 0] if n_s == 1 else jnp.moveaxis(h, 4, 5)

    aod_theta, aod_phi, aoa_theta, aoa_phi = _rotated_angles(paths, bs, ue)
    valid = _fov_valid(cfg, paths.valid, aod_theta, aod_phi, aoa_theta,
                       aoa_phi)
    powers_lin = _powers_linear(cfg, paths, valid, aod_theta, aod_phi,
                                aoa_theta, aoa_phi)
    if not cfg.freq_domain and _td_compact_active(cfg):
        (paths, valid, powers_lin, aod_theta, aod_phi, aoa_theta,
         aoa_phi) = _compact_paths(cfg, paths, valid, powers_lin,
                                   aod_theta, aod_phi, aoa_theta, aoa_phi)
    arx = array_response_planes(cfg.ue_shape, ue.spacing, aoa_theta,
                                aoa_phi, valid)
    atx = array_response_planes(cfg.bs_shape, bs.spacing, aod_theta,
                                aod_phi, valid)

    outs = []
    for t_snap in snapshots:
        if cfg.freq_domain:
            gr, gi = _ofdm_gain_planes(cfg, powers_lin, paths.delay_s,
                                       paths.phase_deg, valid, t_snap,
                                       paths)
            hr, hi = _path_sum_planes_ri(cfg, arx, atx, gr, gi)
        else:
            gr, gi = _td_gain_planes(cfg, powers_lin, paths.phase_deg,
                                     valid, t_snap, paths)
            hr, hi = _td_channel_planes_ri(arx, atx, gr, gi)
        outs.append((hr, hi))
    if _packed_layout(cfg):
        # Same packed convention as the fused kernel: hr for all (s, k)
        # s-major in the first minor half, hi in the second.
        hr_all = jnp.concatenate([o[0] for o in outs], axis=-1)
        hi_all = jnp.concatenate([o[1] for o in outs], axis=-1)
        return co(jnp.concatenate((hr_all, hi_all), axis=-1))
    if cfg.enable_doppler and len(snapshots) > 1:
        return co(jnp.stack([jnp.stack(o) for o in outs], axis=-1))
    return co(jnp.stack(outs[0]))


def unpack_planes_np(arr, cfg: ChannelConfig) -> np.ndarray:
    """Host-side inverse of :func:`render_channels_planes`' plane layouts.

    Takes the (host-gathered) planes array and returns the canonical
    complex channel tensor: [U, R, T, K] (OFDM), [U, R, T, P] (time
    domain), with a trailing time axis for multi-snapshot Doppler —
    matching :func:`render_channels`. Works on numpy to avoid a device
    round-trip in the host-gather path.
    """
    arr = np.asarray(arr)
    # bf16 planes (cfg.out_dtype='bfloat16') widen to complex64; only
    # float64 planes produce complex128.
    cdt = np.complex128 if arr.dtype == np.float64 else np.complex64
    if arr.dtype not in (np.float32, np.float64):
        arr = arr.astype(np.float32)
    if _packed_layout(cfg):
        n_s = _fused_n_snap(cfg)
        n_k = len(cfg.selected_subcarriers)
        sk = n_s * n_k
        h = np.empty(arr.shape[:-1] + (sk,), dtype=cdt)
        h.real = arr[..., :sk]
        h.imag = arr[..., sk:]
        if n_s > 1:                      # snapshot-major -> time axis last
            u, r, t = h.shape[:3]
            h = np.moveaxis(h.reshape(u, r, t, n_s, n_k), 3, 4)
        return h
    h = np.empty(arr.shape[1:], dtype=cdt)
    h.real = arr[0]
    h.imag = arr[1]
    return h


@functools.partial(jax.jit, static_argnames=("cfg",))
def render_channels(paths: PathData, bs: AntennaPanel, ue: AntennaPanel,
                    cfg: ChannelConfig) -> jax.Array:
    """Render MIMO channels for a batch of users.

    Args:
        paths: PathData for U users (padded to >= cfg.num_paths path slots).
        bs: BS (TX) antenna panel parameters (rotation [3] or [U,3], spacing).
        ue: UE (RX) antenna panel parameters.
        cfg: static configuration.

    Returns:
        Frequency domain: complex [U, n_rx_ant, n_tx_ant, K]
        Time domain:      complex [U, n_rx_ant, n_tx_ant, num_paths]
        With Doppler over multiple snapshots, a trailing time axis is added:
        [..., len(cfg.doppler_times)].
    """
    paths = paths.trim_paths(cfg.num_paths)

    aod_theta, aod_phi, aoa_theta, aoa_phi = _rotated_angles(paths, bs, ue)
    valid = _fov_valid(cfg, paths.valid, aod_theta, aod_phi, aoa_theta,
                       aoa_phi)
    powers_lin = _powers_linear(cfg, paths, valid, aod_theta, aod_phi,
                                aoa_theta, aoa_phi)

    if not cfg.freq_domain and _td_compact_active(cfg):
        # Reference packs valid paths to the front of the path axis in the
        # time-domain output (channel.py:287); permute inputs equivalently.
        (paths, valid, powers_lin, aod_theta, aod_phi, aoa_theta,
         aoa_phi) = _compact_paths(cfg, paths, valid, powers_lin,
                                   aod_theta, aod_phi, aoa_theta, aoa_phi)

    # Fast plane-based path: f32 outputs, no sinc filter (freq and time
    # domain). The complex128 (parity) and LPF paths go through the
    # complex implementation.
    use_planes = cfg.dtype == "complex64" and not cfg.rx_filter

    if use_planes:
        from .geometry import array_response_planes
        arx = array_response_planes(cfg.ue_shape, ue.spacing, aoa_theta,
                                    aoa_phi, valid)
        atx = array_response_planes(cfg.bs_shape, bs.spacing, aod_theta,
                                    aod_phi, valid)
    else:
        a_tx = array_response(cfg.bs_shape, bs.spacing, aod_theta, aod_phi,
                              valid, cfg.cdtype)             # [U, T, P]
        a_rx = array_response(cfg.ue_shape, ue.spacing, aoa_theta, aoa_phi,
                              valid, cfg.cdtype)             # [U, R, P]

    n_times = len(cfg.doppler_times) if cfg.enable_doppler else 1
    snapshots = cfg.doppler_times if cfg.enable_doppler else (0.0,)

    outs = []
    for t_snap in snapshots[:n_times]:
        if use_planes and cfg.freq_domain:
            gr, gi = _ofdm_gain_planes(cfg, powers_lin, paths.delay_s,
                                       paths.phase_deg, valid, t_snap,
                                       paths)
            h = _path_sum_planes(cfg, arx, atx, gr, gi)
        elif use_planes:
            gr, gi = _td_gain_planes(cfg, powers_lin, paths.phase_deg,
                                     valid, t_snap, paths)
            hr, hi = _td_channel_planes_ri(arx, atx, gr, gi)
            h = (hr + 1j * hi).astype(cfg.cdtype)
        elif cfg.freq_domain:
            g = _ofdm_path_gains(cfg, powers_lin, paths.delay_s,
                                 paths.phase_deg, valid, t_snap, paths)
            h = _path_sum(a_rx, a_tx, g, cfg.cdtype, cfg)
        else:
            psi = jnp.deg2rad(paths.phase_deg)
            gains = jnp.where(valid, jnp.sqrt(powers_lin), 0.0) * \
                jnp.exp(1j * psi.astype(_rd(cfg)))
            if cfg.enable_doppler:
                dop = _doppler_phase(cfg, paths, paths.delay_s, t_snap)
                if dop is not None:
                    gains = gains * dop
            # H[u,r,t,p] = a_rx[u,r,p] a_tx[u,t,p] gains[u,p]
            h = (a_rx[:, :, None, :] * a_tx[:, None, :, :] *
                 gains[:, None, None, :].astype(cfg.cdtype))
        outs.append(h)

    if cfg.enable_doppler and n_times > 1:
        return jnp.stack(outs, axis=-1)
    return outs[0]


def render_channels_and_grads(paths: PathData, bs: AntennaPanel,
                              ue: AntennaPanel, cfg: ChannelConfig,
                              cotangent: Optional[jax.Array] = None
                              ) -> Tuple[jax.Array, Tuple]:
    """Forward channels plus VJP w.r.t. (paths, bs, ue) for a cotangent.

    If ``cotangent`` is None, uses ones (sum-of-elements probe). This is the
    "pixel-analog gradient" used by parity tests: dRe(sum(H*cot))/d params.
    """
    def fwd(p, b, u):
        return render_channels(p, b, u, cfg)

    h, vjp_fn = jax.vjp(fwd, paths, bs, ue)
    if cotangent is None:
        cotangent = jnp.ones_like(h)
    grads = vjp_fn(cotangent.astype(h.dtype))
    return h, grads
