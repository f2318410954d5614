"""Dataset: lazy, device-accelerated view of one TX-RX pair's ray data.

Presents the scenario matrices and every derived quantity of the reference
toolchain (reference deepmimo/generator/dataset.py:69-999) — channels,
rotated/FoV-filtered angles, pattern-gain powers, pathloss, LoS, path counts,
interaction strings, grid info, subsetting — with identical keys/aliases and
NaN-padded presentation, while the heavy computation runs through the jitted
device renderer on masked PathData, streamed over user blocks.
"""

from __future__ import annotations

import functools
import inspect
import os
from typing import Any, Dict, List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from .. import consts as c
from ..config import config
from ..utils import DotDict
from ..info import info as _info
from ..ops import geometry as _geo
from ..ops import patterns as _pat
from ..ops.types import PathData
from .params import ChannelGenParameters
from .sampling import dbw2watt, get_uniform_idxs

# Parameters shared across datasets inside a MacroDataset
SHARED_PARAMS = [
    c.SCENE_PARAM_NAME,
    c.MATERIALS_PARAM_NAME,
    c.LOAD_PARAMS_PARAM_NAME,
    c.RT_PARAMS_PARAM_NAME,
]


def _np(x):
    return np.asarray(x)


class Dataset(DotDict):
    """Dict-like dataset with lazily computed attributes.

    Primary (loaded) keys: power, phase, delay, aoa_az/el, aod_az/el,
    rx_pos, tx_pos, inter, inter_pos.
    Derived keys are computed on first access and cached (same registry
    contract as the reference `_computed_attributes`).
    """

    # ------------------------------------------------------------------
    # 1. Core interface
    # ------------------------------------------------------------------

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        super().__init__(data or {})

    def __getattr__(self, key: str) -> Any:
        try:
            return super().__getitem__(key)
        except KeyError:
            pass
        try:
            return self._resolve_key(key)
        except KeyError:
            # Attribute protocol: unknown names must raise AttributeError
            # (keeps hasattr/copy/pickle working); dict access still raises
            # KeyError via __getitem__.
            raise AttributeError(key) from None

    def __getitem__(self, key: str) -> Any:
        try:
            return super().__getitem__(key)
        except KeyError:
            return self._resolve_key(key)

    def _resolve_key(self, key: str) -> Any:
        resolved = c.DATASET_ALIASES.get(key, key)
        if resolved != key:
            key = resolved
            try:
                return super().__getitem__(key)
            except KeyError:
                pass
        if key in self._computed_attributes:
            method = getattr(self, self._computed_attributes[key])
            value = method()
            if isinstance(value, dict):
                self.update(value)
                return super().__getitem__(key)
            self[key] = value
            return value
        raise KeyError(key)

    def __dir__(self):
        return list(set(list(super().__dir__()) +
                        list(self._computed_attributes.keys()) +
                        list(c.DATASET_ALIASES.keys())))

    # ------------------------------------------------------------------
    # 2. Channel computation
    # ------------------------------------------------------------------

    def set_channel_params(self, params: Optional[ChannelGenParameters] = None):
        """Validate and store channel parameters; invalidate stale caches."""
        if params is None:
            params = ChannelGenParameters()
        params.validate(self.n_ue)

        old = (super().__getitem__(c.CH_PARAMS_PARAM_NAME)
               if c.CH_PARAMS_PARAM_NAME in super().keys() else None)
        self[c.CH_PARAMS_PARAM_NAME] = params.deepcopy()

        if old is not None:
            same = True
            for side in (c.PARAMSET_ANT_BS, c.PARAMSET_ANT_UE):
                if not np.array_equal(_np(old[side][c.PARAMSET_ANT_ROTATION]),
                                      _np(params[side][c.PARAMSET_ANT_ROTATION])):
                    same = False
            if not same:
                self._clear_cache_rotated_angles()
        return params

    def compute_channels(self, params: Optional[ChannelGenParameters] = None,
                         to_device: bool = False, out=None) -> np.ndarray:
        """Compute MIMO channels for every user (the hot path).

        Default: renders through the jitted device renderer — in ONE
        dispatch when the output tensor fits :func:`output_budget`,
        otherwise streamed over user blocks with the host
        readback overlapped against compute — and returns a numpy complex
        array, cached under ``dataset.channel``. Shape: [n_ue, n_rx_ant,
        n_tx_ant, K] (OFDM) or [n_ue, n_rx_ant, n_tx_ant, n_paths] (time
        domain); an extra trailing time axis appears for multi-snapshot
        Doppler.

        Args:
            params: channel-generation parameters (defaults applied).
            to_device: return the raw device planes array instead of a
                host numpy array — no host gather, full device throughput.
                The layout is the renderer's plane layout (see
                ``ops.channel.render_channels_planes``); convert with
                ``ops.channel.unpack_planes_np``. Not cached.
            out: optional device planes array from a previous identical
                compute_channels call; its buffer is donated so serving
                loops run in constant device memory. Ignored unless its
                shape/dtype match the new output.
        """
        if params is None:
            stored = self.get(c.CH_PARAMS_PARAM_NAME)
            params = ChannelGenParameters() if stored is None else stored

        params = self.set_channel_params(params)

        # Deterministic per-user random rotations (toolchain convention).
        np.random.seed(1001)
        ue_rotation = params.resolve_ue_rotation(self.n_ue)

        cfg, bs_panel, ue_panel = params.to_config(
            self.n_ue,
            bs_fov=self.get("bs_fov"), ue_fov=self.get("ue_fov"),
            ue_rotation=ue_rotation,
            dtype=config.get("compute_dtype"))

        if cfg.freq_domain:
            # Memoized per (n_fft, bandwidth): serving loops re-call
            # compute_channels back-to-back and the report is a full pass
            # over the delay/power matrices.
            cache = self.get("_clip_report_cache") or {}
            ck = (cfg.subcarriers, cfg.bandwidth)
            if ck in cache:
                report = cache[ck]
            else:
                report = delay_clipping_report(
                    _np(self[c.DELAY_PARAM_NAME]),
                    _np(self[c.POWER_PARAM_NAME]),
                    cfg.subcarriers, cfg.bandwidth)
                cache[ck] = report
                self["_clip_report_cache"] = cache
                if report is not None:
                    _print_delay_clipping_warning(report)
            if report is not None:
                self["clipping_report"] = report

        if params.get(c.PARAMSET_POLAR_EN, 0):
            channel = self._compute_dual_polar(cfg, bs_panel, ue_panel,
                                               to_device=to_device,
                                               out=out)
        else:
            channel = _render_streamed(self._path_data(cfg), bs_panel,
                                       ue_panel, cfg, to_device=to_device,
                                       out=out)
        if to_device:
            return channel
        self[c.CHANNEL_PARAM_NAME] = channel
        return channel

    def _compute_dual_polar(self, cfg, bs_panel, ue_panel,
                            to_device: bool = False, out=None):
        """Dual-polarization channels: {'VV','VH','HH','HV'} -> H.

        Requires per-polarization power/phase matrices (``power_vv``,
        ``phase_vv``, ...) in the scenario; angles and delays are shared
        across polarizations (v3 semantics, reference
        deepmimo_v3/generator/python/generator.py:71-78).

        Fast path (fused-eligible configs): ONE device dispatch renders
        all four polarizations — the pol axis rides the fused render's
        slot axis with per-polarization amplitudes, sharing rotations,
        FoV, pattern gains and panel responses (the reference runs four
        full generator passes).
        ``to_device=True`` returns the raw device planes array in the
        kernel layout (see ops.channel.render_channels_planes_polar);
        unpack with ``ops.channel.unpack_polar_planes_np``.
        """
        from ..ops.channel import fused_render_eligible

        pols = ("VV", "VH", "HH", "HV")
        missing = [p for p in pols
                   if f"power_{p.lower()}" not in super().keys()]
        if missing:
            raise ValueError(
                "Dual-polarization requested but the scenario has no "
                f"per-polarization matrices for {missing}. Expected keys "
                "like 'power_vv'/'phase_vv'.")

        if fused_render_eligible(cfg):
            pd = self._path_data(cfg)
            pol_p, pol_ph = self._polar_stacks(pols)
            res = _render_polar_streamed(pd, bs_panel, ue_panel, cfg,
                                         pol_p, pol_ph,
                                         to_device=to_device, out=out)
            if to_device:
                return res
            return {pol: res[i] for i, pol in enumerate(pols)}

        if to_device:
            raise ValueError(
                "to_device=True with dual-polarization requires a fused-"
                "eligible config (OFDM, no rx_filter, complex64, "
                "arithmetic subcarrier selection); call per polarization "
                "instead.")
        channels = {}
        for pol in pols:
            pd = self._path_data(cfg)
            pol_power = _np(self[f"power_{pol.lower()}"])
            pol_phase = _np(self.get(f"phase_{pol.lower()}",
                                     self[c.PHASE_PARAM_NAME]))
            pd = PathData.from_numpy(
                power=pol_power, phase=pol_phase,
                delay=_np(self[c.DELAY_PARAM_NAME]),
                aoa_az=_np(self[c.AOA_AZ_PARAM_NAME]),
                aoa_el=_np(self[c.AOA_EL_PARAM_NAME]),
                aod_az=_np(self[c.AOD_AZ_PARAM_NAME]),
                aod_el=_np(self[c.AOD_EL_PARAM_NAME]),
                doppler_vel=self.get(c.DOPPLER_VEL_PARAM_NAME),
                doppler_acc=self.get(c.DOPPLER_ACC_PARAM_NAME),
                dtype=pd.power_dbw.dtype)
            channels[pol] = _render_streamed(pd, bs_panel, ue_panel, cfg)
        return channels

    def _polar_stacks(self, pols=("VV", "VH", "HH", "HV")):
        """Device-cached [N_pol, U, P] power/phase stacks: serving loops
        re-call back-to-back, and re-staging the four stacks from the host
        on every call would add a host-to-device copy per render."""
        cached = self.get("_polar_data_cache")
        if cached is None:
            pol_p = jnp.asarray(np.stack(
                [_np(self[f"power_{p.lower()}"]) for p in pols]))
            pol_ph = jnp.asarray(np.stack(
                [_np(self.get(f"phase_{p.lower()}",
                              self[c.PHASE_PARAM_NAME]))
                 for p in pols]))
            cached = (pol_p, pol_ph)
            self["_polar_data_cache"] = cached
        return cached

    def compute_beam_gains(self, params: Optional[ChannelGenParameters]
                           = None, codebook=None,
                           to_device: bool = False,
                           out=None) -> np.ndarray:
        """Codebook beam-gain maps G = |conj(W) . H|^2 without H.

        The codebook folds into the TX response before the path sum
        (ops/beamgain.py), so the full channel tensor at T antennas is
        never materialized — not on the device, not on the host. The serving
        primitive for beam training / initial access / coverage maps
        (the reference computes these host-side from full H).

        Args:
            codebook: complex [n_beams, n_tx_ant] array, or an
                (wr, wi) tuple of real/imag planes. Gains match
                ``np.abs(H @ codebook.conj().T)**2``.
            to_device: return the raw device array [U, R*B, S*K].
            out: optional device array from a previous identical call;
                its buffer is donated so serving loops run in constant
                device memory (mirrors ``compute_channels(out=)``).

        Returns [n_ue, n_rx_ant, n_beams, K] float32 (an extra trailing
        time axis for multi-snapshot Doppler). Dual-polar scenarios with
        ``params['enable_dual_polar']=1`` return a per-polarization dict
        {'VV','VH','HH','HV'} of such maps, ALL computed in one
        dispatch (pol axis on the slot axis; H never exists for any
        polarization).
        """
        if codebook is None:
            raise ValueError("compute_beam_gains requires a codebook "
                             "([n_beams, n_tx_ant] complex, or an "
                             "(wr, wi) tuple)")
        if params is None:
            stored = self.get(c.CH_PARAMS_PARAM_NAME)
            params = ChannelGenParameters() if stored is None else stored
        params = self.set_channel_params(params)
        np.random.seed(1001)
        ue_rotation = params.resolve_ue_rotation(self.n_ue)
        cfg, bs_panel, ue_panel = params.to_config(
            self.n_ue,
            bs_fov=self.get("bs_fov"), ue_fov=self.get("ue_fov"),
            ue_rotation=ue_rotation,
            dtype=config.get("compute_dtype"))

        if isinstance(codebook, tuple):
            wr, wi = (np.asarray(x, np.float32) for x in codebook)
        else:
            cb = np.asarray(codebook)
            wr = np.real(cb).astype(np.float32)
            wi = np.imag(cb).astype(np.float32)
        if wr.ndim != 2 or wr.shape[1] != cfg.n_tx_ant:
            raise ValueError(
                f"codebook must be [n_beams, {cfg.n_tx_ant}] for this "
                f"antenna config; got {wr.shape}")

        pd = self._path_data(cfg)
        wr_d, wi_d = jnp.asarray(wr), jnp.asarray(wi)

        if params.get(c.PARAMSET_POLAR_EN, 0):
            # Dual-polar beam gains: pol axis on the slot axis +
            # codebook folded into the path-sum — one dispatch, no H for
            # any polarization. Returns {pol: [U, R, B, K(, S)]}.
            pols = ("VV", "VH", "HH", "HV")
            missing = [pq for pq in pols
                       if f"power_{pq.lower()}" not in super().keys()]
            if missing:
                raise ValueError(
                    "Dual-polarization beam gains need per-polarization "
                    f"matrices for {missing} (keys like 'power_vv').")
            from ..ops.channel import render_beam_gains_polar
            pol_p, pol_ph = self._polar_stacks(pols)
            g = render_beam_gains_polar(pd, bs_panel, ue_panel, cfg,
                                        pol_p, pol_ph, wr_d, wi_d)
            if to_device:
                return g
            arr = np.asarray(jax.device_get(g))
            r, b = cfg.n_rx_ant, wr.shape[0]
            n_s = (len(cfg.doppler_times) if cfg.enable_doppler else 1)
            n_k = cfg.n_sel_subcarriers
            arr = arr.reshape(self.n_ue, r, b, len(pols), n_s, n_k)
            out_pols = {}
            for ip, pq in enumerate(pols):
                gi = arr[:, :, :, ip]
                out_pols[pq] = (gi.transpose(0, 1, 2, 4, 3)
                                if n_s > 1 else gi[:, :, :, 0])
            return out_pols

        from ..ops.channel import render_beam_gains
        g_shape = (self.n_ue,
                   cfg.n_rx_ant * wr.shape[0],
                   (len(cfg.doppler_times) if cfg.enable_doppler else 1)
                   * cfg.n_sel_subcarriers)
        if out is not None and (tuple(out.shape) != g_shape
                                or str(out.dtype) != "float32"):
            out = None                   # config changed: nothing to donate
        if out is not None:
            g = _beamgain_jit_donate(pd, bs_panel, ue_panel, cfg, wr_d,
                                     wi_d, out)
        else:
            g = render_beam_gains(pd, bs_panel, ue_panel, cfg, wr_d,
                                  wi_d)
        if to_device:
            return g
        arr = np.asarray(jax.device_get(g))
        r, b = cfg.n_rx_ant, wr.shape[0]
        n_s = (len(cfg.doppler_times) if cfg.enable_doppler else 1)
        n_k = cfg.n_sel_subcarriers
        arr = arr.reshape(self.n_ue, r, b, n_s, n_k)
        if n_s > 1:
            return arr.transpose(0, 1, 2, 4, 3)     # time axis last
        return arr[:, :, :, 0, :]

    def _path_data(self, cfg=None) -> PathData:
        """Masked device pytree of this dataset's path matrices (cached)."""
        cached = self.get("_path_data_cache")
        if cached is not None:
            return cached
        import jax.numpy as jnp
        dtype = (jnp.float64 if config.get("compute_dtype") == "complex128"
                 else jnp.float32)
        pd = PathData.from_numpy(
            power=self[c.POWER_PARAM_NAME],
            phase=self[c.PHASE_PARAM_NAME],
            delay=self[c.DELAY_PARAM_NAME],
            aoa_az=self[c.AOA_AZ_PARAM_NAME],
            aoa_el=self[c.AOA_EL_PARAM_NAME],
            aod_az=self[c.AOD_AZ_PARAM_NAME],
            aod_el=self[c.AOD_EL_PARAM_NAME],
            doppler_vel=self.get(c.DOPPLER_VEL_PARAM_NAME),
            doppler_acc=self.get(c.DOPPLER_ACC_PARAM_NAME),
            dtype=dtype)
        self["_path_data_cache"] = pd
        return pd

    # ------------------------------------------------------------------
    # 3. Geometric computations
    # ------------------------------------------------------------------

    @property
    def tx_ori(self) -> np.ndarray:
        return _np(self.ch_params[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_ROTATION]) \
            * np.pi / 180

    @property
    def bs_ori(self) -> np.ndarray:
        return self.tx_ori

    @property
    def rx_ori(self) -> np.ndarray:
        return _np(self.ch_params[c.PARAMSET_ANT_UE][c.PARAMSET_ANT_ROTATION]) \
            * np.pi / 180

    @property
    def ue_ori(self) -> np.ndarray:
        return self.rx_ori

    def _ensure_ch_params(self) -> ChannelGenParameters:
        stored = self.get(c.CH_PARAMS_PARAM_NAME)
        if stored is None:
            stored = self.set_channel_params(None)
            self[c.CH_PARAMS_PARAM_NAME] = stored
        return stored

    def _compute_rotated_angles(self) -> Dict[str, np.ndarray]:
        """Rotated AoD/AoA (radians, NaN-padded presentation)."""
        params = self._ensure_ch_params()
        np.random.seed(1001)
        ue_rotation = params.resolve_ue_rotation(self.n_ue)
        bs_rotation = _np(params[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_ROTATION])

        aod_el = _np(self[c.AOD_EL_PARAM_NAME], )
        aod_az = _np(self[c.AOD_AZ_PARAM_NAME])
        aoa_el = _np(self[c.AOA_EL_PARAM_NAME])
        aoa_az = _np(self[c.AOA_AZ_PARAM_NAME])

        aod_t, aod_p = _rotate_np(bs_rotation, aod_el, aod_az)
        aoa_t, aoa_p = _rotate_np(ue_rotation, aoa_el, aoa_az)
        return {
            c.AOD_EL_ROT_PARAM_NAME: aod_t,
            c.AOD_AZ_ROT_PARAM_NAME: aod_p,
            c.AOA_EL_ROT_PARAM_NAME: aoa_t,
            c.AOA_AZ_ROT_PARAM_NAME: aoa_p,
        }

    def _compute_array_response_product(self) -> np.ndarray:
        """[n_ue, M_rx, M_tx, n_paths] complex RX x TX array-response
        product at the FoV-filtered rotated angles (invalid paths -> 0).

        A presentation attribute that is inherently O(users x R x T x P)
        on the host (the channel path never materializes it — reference
        dataset.py:398-417 does, the exact anti-pattern SURVEY §7 flags):
        sized against config 'max_array_product_bytes' with guidance, and
        built in user blocks with pure numpy so peak intermediate memory
        stays bounded."""
        from ..ops.geometry import ant_indices

        params = self._ensure_ch_params()
        bs_p = params[c.PARAMSET_ANT_BS]
        ue_p = params[c.PARAMSET_ANT_UE]
        bs_shape = tuple(int(x) for x in _np(bs_p[c.PARAMSET_ANT_SHAPE]))
        ue_shape = tuple(int(x) for x in _np(ue_p[c.PARAMSET_ANT_SHAPE]))

        aod_t = np.nan_to_num(_np(self[c.AOD_EL_FOV_PARAM_NAME]))
        aod_p = np.nan_to_num(_np(self[c.AOD_AZ_FOV_PARAM_NAME]))
        aoa_t = np.nan_to_num(_np(self[c.AOA_EL_FOV_PARAM_NAME]))
        aoa_p = np.nan_to_num(_np(self[c.AOA_AZ_FOV_PARAM_NAME]))
        valid = ~np.isnan(_np(self[c.AOD_EL_FOV_PARAM_NAME]))

        n_ue, n_p = aod_t.shape
        r = ue_shape[0] * ue_shape[1]
        t = bs_shape[0] * bs_shape[1]
        out_bytes = n_ue * r * t * n_p * 8
        limit = int(config.get("max_array_product_bytes") or (4 << 30))
        if out_bytes > limit:
            raise MemoryError(
                f"array_response_product would be [{n_ue}, {r}, {t}, "
                f"{n_p}] complex64 = {out_bytes / 2**30:.1f} GiB on the "
                f"host (limit {limit / 2**30:.1f} GiB, config "
                "'max_array_product_bytes'). Use dataset.subset(idxs) to "
                "restrict users, or compute channels directly — "
                "compute_channels never materializes this product.")

        def response(shape, spacing, theta, phi, v):
            kd = 2 * np.pi * spacing
            st = np.sin(theta)
            ky = kd * st * np.sin(phi)
            kz = kd * np.cos(theta)
            pos = ant_indices(shape)
            phase = (pos[None, :, 1:2] * ky[:, None, :] +
                     pos[None, :, 2:3] * kz[:, None, :])
            resp = np.exp(1j * phase).astype(np.complex64)
            resp[~np.broadcast_to(v[:, None, :], resp.shape)] = 0
            return resp

        out = np.empty((n_ue, r, t, n_p), dtype=np.complex64)
        block = max(1, int(config.get("user_block") or 16384))
        for s in range(0, n_ue, block):
            e = min(s + block, n_ue)
            a_tx = response(bs_shape, float(bs_p[c.PARAMSET_ANT_SPACING]),
                            aod_t[s:e], aod_p[s:e], valid[s:e])
            a_rx = response(ue_shape, float(ue_p[c.PARAMSET_ANT_SPACING]),
                            aoa_t[s:e], aoa_p[s:e], valid[s:e])
            out[s:e] = a_rx[:, :, None, :] * a_tx[:, None, :, :]
        return out

    def _clear_cache_rotated_angles(self) -> None:
        for k in {c.AOD_EL_ROT_PARAM_NAME, c.AOD_AZ_ROT_PARAM_NAME,
                  c.AOA_EL_ROT_PARAM_NAME, c.AOA_AZ_ROT_PARAM_NAME} & \
                set(super().keys()):
            super().__delitem__(k)
        self._clear_cache_fov()

    # ------------------------------------------------------------------
    # 4. Field of view
    # ------------------------------------------------------------------

    def apply_fov(self, bs_fov: np.ndarray = np.array([360, 180]),
                  ue_fov: np.ndarray = np.array([360, 180])) -> None:
        """Set FoV limits; derived quantities recompute lazily."""
        self._clear_cache_fov()
        self["bs_fov"] = np.asarray(bs_fov)
        self["ue_fov"] = np.asarray(ue_fov)

    def _compute_fov(self) -> Dict[str, np.ndarray]:
        aod_t = self[c.AOD_EL_ROT_PARAM_NAME]
        aod_p = self[c.AOD_AZ_ROT_PARAM_NAME]
        aoa_t = self[c.AOA_EL_ROT_PARAM_NAME]
        aoa_p = self[c.AOA_AZ_ROT_PARAM_NAME]

        bs_fov, ue_fov = self.get("bs_fov"), self.get("ue_fov")
        bs_full = bs_fov is not None and _geo.is_full_fov(bs_fov)
        ue_full = ue_fov is not None and _geo.is_full_fov(ue_fov)

        if (bs_fov is None and ue_fov is None) or (bs_full and ue_full):
            return {
                c.FOV_MASK_PARAM_NAME: None,
                c.AOD_EL_FOV_PARAM_NAME: aod_t,
                c.AOD_AZ_FOV_PARAM_NAME: aod_p,
                c.AOA_EL_FOV_PARAM_NAME: aoa_t,
                c.AOA_AZ_FOV_PARAM_NAME: aoa_p,
            }

        mask = np.ones(aod_t.shape, dtype=bool)
        if bs_fov is not None and not bs_full:
            mask &= _fov_np(bs_fov, aod_t, aod_p)
        if ue_fov is not None and not ue_full:
            mask &= _fov_np(ue_fov, aoa_t, aoa_p)

        nanw = lambda a: np.where(mask, a, np.nan)
        return {
            c.FOV_MASK_PARAM_NAME: mask,
            c.AOD_EL_FOV_PARAM_NAME: nanw(aod_t),
            c.AOD_AZ_FOV_PARAM_NAME: nanw(aod_p),
            c.AOA_EL_FOV_PARAM_NAME: nanw(aoa_t),
            c.AOA_AZ_FOV_PARAM_NAME: nanw(aoa_p),
        }

    def _clear_cache_fov(self) -> None:
        keys = {c.FOV_MASK_PARAM_NAME, c.NUM_PATHS_PARAM_NAME,
                c.LOS_PARAM_NAME, c.CHANNEL_PARAM_NAME,
                c.PWR_LINEAR_ANT_GAIN_PARAM_NAME,
                c.AOD_EL_FOV_PARAM_NAME, c.AOD_AZ_FOV_PARAM_NAME,
                c.AOA_EL_FOV_PARAM_NAME, c.AOA_AZ_FOV_PARAM_NAME}
        for k in keys & set(super().keys()):
            super().__delitem__(k)

    # ------------------------------------------------------------------
    # 5. Path and power computations
    # ------------------------------------------------------------------

    def compute_pathloss(self, coherent: bool = True) -> np.ndarray:
        """Pathloss in dB from a coherent (or incoherent) path-gain sum."""
        powers_linear = 10 ** (_np(self[c.POWER_PARAM_NAME]) / 10)
        phases_rad = np.deg2rad(_np(self[c.PHASE_PARAM_NAME]))
        gains = np.sqrt(powers_linear).astype(np.complex64)
        if coherent:
            gains = gains * np.exp(1j * phases_rad)
        total_power = np.abs(np.nansum(gains, axis=1)) ** 2
        mask = total_power > 0
        pathloss = np.full_like(total_power, np.nan, dtype=np.float64)
        pathloss[mask] = -10 * np.log10(total_power[mask])
        self[c.PATHLOSS_PARAM_NAME] = pathloss
        return pathloss

    def _compute_los(self) -> np.ndarray:
        """LoS status per user: 1 LoS, 0 NLoS, -1 no paths."""
        inter = _np(self[c.INTERACTIONS_PARAM_NAME])
        los_status = np.full(inter.shape[0], -1)

        _ = self[c.AOD_AZ_ROT_PARAM_NAME]  # ensure rotated angles exist
        fov_mask = self[c.FOV_MASK_PARAM_NAME]
        if fov_mask is not None:
            has_paths = np.any(fov_mask, axis=1)
            # First in-FoV path per user (vectorized argmax over the mask).
            first_idx = np.argmax(fov_mask, axis=1)
            first_valid = np.where(
                has_paths, inter[np.arange(inter.shape[0]), first_idx], -1)
        else:
            has_paths = _np(self[c.NUM_PATHS_PARAM_NAME]) > 0
            first_valid = inter[:, 0] if inter.shape[1] else \
                np.full(inter.shape[0], np.nan)

        los_status[has_paths] = 0
        los_mask = first_valid == c.INTERACTION_LOS
        los_status[los_mask & has_paths] = 1
        return los_status

    def _compute_num_paths(self) -> np.ndarray:
        aoa_az_fov = self[c.AOA_AZ_FOV_PARAM_NAME]
        return (~np.isnan(_np(aoa_az_fov))).sum(axis=1)

    def _compute_num_interactions(self) -> np.ndarray:
        inter = _np(self[c.INTERACTIONS_PARAM_NAME]).astype(np.float64)
        result = np.zeros_like(inter)
        result[np.isnan(inter)] = np.nan
        nz = inter > 0
        result[nz] = np.floor(np.log10(inter[nz])) + 1
        return result

    def _compute_inter_int(self) -> np.ndarray:
        inter = _np(self[c.INTERACTIONS_PARAM_NAME]).astype(np.float64).copy()
        inter[np.isnan(inter)] = -1
        return inter.astype(int)

    def _compute_inter_str(self) -> np.ndarray:
        inter = _np(self[c.INTERACTIONS_PARAM_NAME]).astype(np.float64)
        table = str.maketrans({"0": "", "1": "R", "2": "D", "3": "S",
                               "4": "T"})

        def translate(x):
            if np.isnan(x):
                return "n"
            if x == 0:
                return ""  # LoS: single '0' digit -> empty interaction string
            return str(int(x)).translate(table)

        return np.vectorize(translate, otypes=[object])(inter)

    def _compute_n_ue(self) -> int:
        return _np(self[c.RX_POS_PARAM_NAME]).shape[0]

    def _compute_distances(self) -> np.ndarray:
        return np.linalg.norm(
            _np(self[c.RX_POS_PARAM_NAME]) - _np(self[c.TX_POS_PARAM_NAME]),
            axis=1)

    def _compute_power_linear_ant_gain(self) -> np.ndarray:
        """Linear powers with TX/RX pattern gains at FoV-filtered angles."""
        params = self._ensure_ch_params()
        tx_pat = params[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_RAD_PAT]
        rx_pat = params[c.PARAMSET_ANT_UE][c.PARAMSET_ANT_RAD_PAT]

        power = _np(self[c.PWR_LINEAR_PARAM_NAME])
        aod_t = _np(self[c.AOD_EL_FOV_PARAM_NAME])
        aod_p = _np(self[c.AOD_AZ_FOV_PARAM_NAME])
        aoa_t = _np(self[c.AOA_EL_FOV_PARAM_NAME])
        aoa_p = _np(self[c.AOA_AZ_FOV_PARAM_NAME])

        gain = (_pattern_np(tx_pat, aod_t, aod_p) *
                _pattern_np(rx_pat, aoa_t, aoa_p))
        out = power * gain
        out[np.isnan(aoa_t)] = np.nan
        return out

    def _compute_power_linear(self) -> np.ndarray:
        return dbw2watt(_np(self[c.POWER_PARAM_NAME]))

    # ------------------------------------------------------------------
    # 6. Grid and sampling
    # ------------------------------------------------------------------

    def _compute_grid_info(self) -> Dict[str, np.ndarray]:
        rx_pos = _np(self[c.RX_POS_PARAM_NAME])
        xs, ys = np.unique(rx_pos[:, 0]), np.unique(rx_pos[:, 1])
        return {
            "grid_size": np.array([len(xs), len(ys)]),
            "grid_spacing": np.array([np.mean(np.diff(xs)),
                                      np.mean(np.diff(ys))]),
        }

    def _is_valid_grid(self) -> bool:
        return np.prod(self["grid_size"]) == self.n_ue

    def subset(self, idxs: np.ndarray) -> "Dataset":
        """New Dataset restricted to the selected user indices."""
        idxs = np.asarray(idxs)
        initial = {}
        for param in SHARED_PARAMS:
            if param in super().keys():
                initial[param] = super().__getitem__(param)
        initial["n_ue"] = len(idxs)
        new = Dataset(initial)
        n_ue = self.n_ue
        for attr, value in self.to_dict().items():
            if attr.startswith("_") or attr in SHARED_PARAMS + ["n_ue"]:
                continue
            if isinstance(value, np.ndarray) and value.ndim >= 1 and \
                    value.shape[0] == n_ue:
                new[attr] = value[idxs]
            else:
                new[attr] = value
        return new

    def get_active_idxs(self) -> np.ndarray:
        return np.where(_np(self[c.NUM_PATHS_PARAM_NAME]) > 0)[0]

    def get_uniform_idxs(self, steps: List[int]) -> np.ndarray:
        return get_uniform_idxs(self.n_ue, self["grid_size"], steps)

    # ------------------------------------------------------------------
    # 7. Visualization passthroughs
    # ------------------------------------------------------------------

    def plot_coverage(self, cov_map, **kwargs):
        from .visualization import plot_coverage
        return plot_coverage(_np(self[c.RX_POS_PARAM_NAME]), cov_map,
                             bs_pos=_np(self[c.TX_POS_PARAM_NAME]).T,
                             bs_ori=self.tx_ori, **kwargs)

    def plot_rays(self, idx: int, **kwargs):
        from .visualization import plot_rays
        defaults = {"proj_3D": True, "color_by_type": True}
        defaults.update(kwargs)
        return plot_rays(_np(self[c.RX_POS_PARAM_NAME])[idx],
                         _np(self[c.TX_POS_PARAM_NAME])[0],
                         _np(self[c.INTERACTIONS_POS_PARAM_NAME])[idx],
                         _np(self[c.INTERACTIONS_PARAM_NAME])[idx],
                         **defaults)

    # ------------------------------------------------------------------
    # 8. Registry & info
    # ------------------------------------------------------------------

    _computed_attributes = {
        c.N_UE_PARAM_NAME: "_compute_n_ue",
        c.NUM_PATHS_PARAM_NAME: "_compute_num_paths",
        c.NUM_INTERACTIONS_PARAM_NAME: "_compute_num_interactions",
        c.DIST_PARAM_NAME: "_compute_distances",
        c.PATHLOSS_PARAM_NAME: "compute_pathloss",
        c.CHANNEL_PARAM_NAME: "compute_channels",
        c.LOS_PARAM_NAME: "_compute_los",
        c.CH_PARAMS_PARAM_NAME: "set_channel_params",
        c.PWR_LINEAR_PARAM_NAME: "_compute_power_linear",
        c.AOA_AZ_ROT_PARAM_NAME: "_compute_rotated_angles",
        c.AOA_EL_ROT_PARAM_NAME: "_compute_rotated_angles",
        c.AOD_AZ_ROT_PARAM_NAME: "_compute_rotated_angles",
        c.AOD_EL_ROT_PARAM_NAME: "_compute_rotated_angles",
        "array_response_product": "_compute_array_response_product",
        "fov": "_compute_fov",
        c.FOV_MASK_PARAM_NAME: "_compute_fov",
        c.AOA_AZ_FOV_PARAM_NAME: "_compute_fov",
        c.AOA_EL_FOV_PARAM_NAME: "_compute_fov",
        c.AOD_AZ_FOV_PARAM_NAME: "_compute_fov",
        c.AOD_EL_FOV_PARAM_NAME: "_compute_fov",
        c.PWR_LINEAR_ANT_GAIN_PARAM_NAME: "_compute_power_linear_ant_gain",
        "grid_size": "_compute_grid_info",
        "grid_spacing": "_compute_grid_info",
        c.INTER_STR_PARAM_NAME: "_compute_inter_str",
        c.INTER_INT_PARAM_NAME: "_compute_inter_int",
    }

    def info(self, param_name: Optional[str] = None) -> None:
        if param_name in c.DATASET_ALIASES:
            resolved = c.DATASET_ALIASES[param_name]
            print(f"'{param_name}' is an alias for '{resolved}'")
            param_name = resolved
        _info(param_name)


# ============================================================================
# Numpy wrappers over ops (NaN-padded presentation at the Dataset level)
# ============================================================================

def _rotate_np(rotation_deg, el_deg, az_deg):
    """rotate_angles with NaN pass-through for padded slots."""
    import jax.numpy as jnp  # noqa: F401  (ops are jax-backed)
    el = np.asarray(el_deg, dtype=np.float64)
    az = np.asarray(az_deg, dtype=np.float64)
    nan_mask = np.isnan(el)
    t, p = _geo.rotate_angles(np.asarray(rotation_deg, dtype=np.float64),
                              np.nan_to_num(el), np.nan_to_num(az))
    t, p = np.array(t), np.array(p)
    t[nan_mask] = np.nan
    p[nan_mask] = np.nan
    return t, p


def _fov_np(fov_deg, theta_rad, phi_rad):
    theta = np.asarray(theta_rad, dtype=np.float64)
    phi = np.asarray(phi_rad, dtype=np.float64)
    nan_mask = np.isnan(theta)
    mask = np.array(_geo.apply_fov(np.asarray(fov_deg, dtype=np.float64),
                                   np.nan_to_num(theta),
                                   np.nan_to_num(phi)))
    mask[nan_mask] = False
    return mask


def _pattern_np(name, theta_rad, phi_rad):
    theta = np.asarray(theta_rad, dtype=np.float64)
    out = np.asarray(_pat.pattern_gain(name, np.nan_to_num(theta),
                                       np.nan_to_num(np.asarray(phi_rad,
                                                                dtype=np.float64))),
                     dtype=np.float64).copy()
    out[np.isnan(theta)] = np.nan
    return out


# ============================================================================
# Streaming renderer (host-side batching over user blocks)
# ============================================================================

def _render_ri(paths, bs_panel, ue_panel, cfg):
    """Renderer returning (real, imag) planes: the fast path never forms
    the complex tensor on the device."""
    from ..ops.channel import render_channels_planes
    return render_channels_planes(paths, bs_panel, ue_panel, cfg)


def delay_clipping_report(delays_s, powers_dbw, n_fft: int,
                          bandwidth: float):
    """Aggregate over-OFDM-symbol stats, or None when nothing clips.

    OFDM path construction zeroes paths whose delay exceeds the symbol
    duration N/B; the reference warns at generation time with config
    guidance (reference deepmimo/generator/channel.py:228-250) and its v3
    PathVerifier aggregates the clipped-power statistics
    (deepmimo_v3/generator/python/utils.py:15-40). This computes both.
    """
    delays = np.asarray(delays_s, dtype=np.float64)
    powers = np.asarray(powers_dbw, dtype=np.float64)
    symbol_t = n_fft / bandwidth
    valid = ~np.isnan(delays)
    clipped = valid & (delays >= symbol_t)
    if not clipped.any():
        return None

    p_lin = np.where(valid, 10.0 ** (powers / 10.0), 0.0)
    total_pwr = p_lin.sum(axis=1)
    clip_pwr = np.where(clipped, p_lin, 0.0).sum(axis=1)
    users_hit = clipped.any(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        frac = np.where(total_pwr > 0, clip_pwr / total_pwr, 0.0)
    return {
        "symbol_duration_s": symbol_t,
        "subcarriers": n_fft,
        "bandwidth_hz": bandwidth,
        "max_delay_s": float(np.nanmax(delays)),
        "n_clipped_paths": int(clipped.sum()),
        "n_total_paths": int(valid.sum()),
        "n_users_affected": int(users_hit.sum()),
        "n_users": int(delays.shape[0]),
        "mean_clipped_power_pct": float(100 * frac[users_hit].mean()),
        "max_clipped_power_pct": float(100 * frac.max()),
    }


def _print_delay_clipping_warning(r: dict) -> None:
    sc_spacing = r["bandwidth_hz"] / r["subcarriers"]
    print("\nWarning: Some path delays exceed the OFDM symbol duration")
    print("-" * 50)
    print(f"- Subcarriers (N): {r['subcarriers']}, bandwidth (B): "
          f"{r['bandwidth_hz']/1e6:.1f} MHz, subcarrier spacing: "
          f"{sc_spacing/1e3:.1f} kHz")
    print(f"- Symbol duration (N/B): {r['symbol_duration_s']*1e6:.1f} us, "
          f"max path delay: {r['max_delay_s']*1e6:.1f} us")
    print(f"- Clipped paths: {r['n_clipped_paths']}/{r['n_total_paths']} "
          f"across {r['n_users_affected']}/{r['n_users']} users")
    print(f"- Clipped power (affected users): "
          f"mean {r['mean_clipped_power_pct']:.2f}%, "
          f"max {r['max_clipped_power_pct']:.2f}%")
    print("Paths arriving after the symbol duration are zeroed. To avoid "
          "clipping: increase subcarriers (N), decrease bandwidth (B), or "
          "switch to time-domain generation (ch_params['freq_domain'] = 0). "
          "See dataset.plot_power_discarding() / dataset.clipping_report.")
    print("-" * 50)


def _get_complex(out_ri, cfg) -> np.ndarray:
    import jax
    from ..ops.channel import unpack_planes_np
    return unpack_planes_np(jax.device_get(out_ri), cfg)


def output_budget() -> int:
    """Largest output (bytes) that compute_channels renders in ONE dispatch.

    ``config['max_device_output_bytes']`` when set; otherwise a quarter
    of the device's memory limit (``memory_stats()['bytes_limit']``),
    leaving room for the plain renderer's intermediates and a donated
    previous output. Devices without memory stats (the CPU backend) use
    a quarter of the host's physical memory.
    """
    budget = config.get("max_device_output_bytes")
    if budget is not None:
        return int(budget)
    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    if limit is None:
        limit = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return int(limit) // 4


_OUT_SHAPE_MEMO: Dict = {}


def _render_out_shape(path_data, bs_panel, ue_panel, cfg):
    """Memoized jax.eval_shape of the renderer (re-tracing per call would
    serialize against the device in serving loops)."""
    leaves = jax.tree_util.tree_leaves((path_data, bs_panel, ue_panel))
    key = (cfg, tuple((tuple(x.shape), str(getattr(x, "dtype", "")))
                      for x in leaves))
    if key not in _OUT_SHAPE_MEMO:
        _OUT_SHAPE_MEMO[key] = jax.eval_shape(
            lambda p, b, u: _render_ri(p, b, u, cfg),
            path_data, bs_panel, ue_panel)
    return _OUT_SHAPE_MEMO[key]


@functools.partial(jax.jit, static_argnums=(3,), donate_argnums=(6,))
def _beamgain_jit_donate(pd, bs_panel, ue_panel, cfg, wr, wi, scratch):
    """Donating beam-gain render: ``scratch`` (a previous output) is
    reused so back-to-back serving sweeps run in constant device memory."""
    del scratch
    from ..ops.channel import render_beam_gains
    return render_beam_gains(pd, bs_panel, ue_panel, cfg, wr, wi)


@functools.partial(jax.jit, static_argnums=(3,), donate_argnums=(4,))
def _render_full_jit(pd, bs_panel, ue_panel, cfg, scratch):
    """One-dispatch full render; ``scratch`` (a previous output buffer) is
    donated so back-to-back serving calls reuse one device allocation."""
    del scratch
    return _render_ri(pd, bs_panel, ue_panel, cfg)


@functools.partial(jax.jit, static_argnums=(3,))
def _render_polar_jit(pd, bs_panel, ue_panel, cfg, pol_p, pol_ph):
    from ..ops.channel import render_channels_planes_polar
    return render_channels_planes_polar(pd, bs_panel, ue_panel, cfg,
                                        pol_p, pol_ph)


@functools.partial(jax.jit, static_argnums=(3,), donate_argnums=(6,))
def _render_polar_jit_donate(pd, bs_panel, ue_panel, cfg, pol_p, pol_ph,
                             scratch):
    """Donating variant: ``scratch`` (a previous output) is reused so
    back-to-back dual-polar serving calls run in constant device memory
    (the 4x-sized H would otherwise double-allocate per call)."""
    del scratch
    from ..ops.channel import render_channels_planes_polar
    return render_channels_planes_polar(pd, bs_panel, ue_panel, cfg,
                                        pol_p, pol_ph)


def _render_polar_streamed(path_data: PathData, bs_panel, ue_panel, cfg,
                           pol_power_dbw, pol_phase_deg,
                           to_device: bool = False, out=None):
    """Dual-polar render: one fused dispatch (or user-blocked streaming).

    Returns host complex [N_pol, U, R, T, K(, S)] — or, with
    ``to_device``, the raw device planes array in the kernel layout.
    ``out`` donates a previous output's buffer (serving loops).
    """
    from ..ops.channel import unpack_polar_planes_np

    n_ue = path_data.n_ue
    n_pol = pol_power_dbw.shape[0]
    pol_p = jnp.asarray(pol_power_dbw)
    pol_ph = jnp.asarray(pol_phase_deg)

    key = (cfg, n_pol, tuple(pol_p.shape))
    if key not in _OUT_SHAPE_MEMO:
        _OUT_SHAPE_MEMO[key] = jax.eval_shape(
            lambda p, b, u, pp, ph: _render_polar_jit(p, b, u, cfg, pp,
                                                      ph),
            path_data, bs_panel, ue_panel, pol_p, pol_ph)
    out_shape = _OUT_SHAPE_MEMO[key]
    out_bytes = int(np.prod(out_shape.shape)) * out_shape.dtype.itemsize
    if to_device or out_bytes <= output_budget():
        if out is not None and (tuple(out.shape) != tuple(out_shape.shape)
                                or out.dtype != out_shape.dtype):
            out = None                   # config changed: nothing to donate
        if out is not None:
            h = _render_polar_jit_donate(path_data, bs_panel, ue_panel,
                                         cfg, pol_p, pol_ph, out)
        else:
            h = _render_polar_jit(path_data, bs_panel, ue_panel, cfg,
                                  pol_p, pol_ph)
        if to_device:
            return h
        return unpack_polar_planes_np(jax.device_get(h), cfg, n_pol)

    # Streamed blocks (device->host copy of block i overlaps block i+1),
    # with optional checkpoint/resume (config 'checkpoint_dir') like the
    # single-pol streamer: long dual-polar jobs restart where they died.
    block = int(config.get("user_block"))
    store = None
    ckpt_root = config.get("checkpoint_dir")
    if ckpt_root:
        from .checkpoint import ChunkStore
        store = ChunkStore(ckpt_root,
                           ChunkStore.fingerprint(cfg, n_ue,
                                                  {"polar": n_pol}))
        store.write_manifest({"n_ue": n_ue, "block": block,
                              "n_pol": n_pol})
    per_user_rot = np.asarray(bs_panel.rotation_deg).ndim == 2 or \
        np.asarray(ue_panel.rotation_deg).ndim == 2
    chunks: list = []
    inflight: list = []

    def collect(entry):
        idx, start, size, h = entry
        arr = unpack_polar_planes_np(jax.device_get(h), cfg, n_pol)
        chunks[idx] = arr[:, :size]
        if store is not None:
            store.save_block(start, chunks[idx])
    for start in range(0, n_ue, block):
        size = min(block, n_ue - start)
        idx = len(chunks)
        chunks.append(None)
        if store is not None and store.has_block(start):
            chunks[idx] = store.load_block(start)[:, :size]
            continue
        pd, bsp, uep = _slice_block(path_data, bs_panel, ue_panel,
                                    per_user_rot, start, size, block)
        pad = block - size
        pp = pol_p[:, start:start + size]
        ph = pol_ph[:, start:start + size]
        if pad:
            pp = jnp.pad(pp, ((0, 0), (0, pad), (0, 0)))
            ph = jnp.pad(ph, ((0, 0), (0, pad), (0, 0)))
        h = _render_polar_jit(pd, bsp, uep, cfg, pp, ph)
        try:
            h.copy_to_host_async()
        except Exception:
            pass
        inflight.append((idx, start, size, h))
        if len(inflight) >= 2:
            collect(inflight.pop(0))
    for entry in inflight:
        collect(entry)
    return np.concatenate(chunks, axis=1)


def _render_streamed(path_data: PathData, bs_panel, ue_panel, cfg,
                     to_device: bool = False, out=None) -> np.ndarray:
    """Render all users' channels at device throughput.

    Single-dispatch path (default): when the output tensor fits
    :func:`output_budget` (or ``to_device`` is set), the WHOLE user batch
    renders in one jitted call — the renderer covers every user
    internally, so no host-side batching and no per-block
    dispatch+readback serialization. ``out`` donates a previous result's
    buffer.

    Streaming path: outputs too large for device memory render over
    ``config['user_block']`` blocks with the device→host copy of block i
    issued asynchronously while block i+1 computes (``copy_to_host_async``)
    — plus optional checkpoint/resume and per-block device-failure retry.
    """
    import jax

    n_ue = path_data.n_ue
    block = int(config.get("user_block"))

    # Optional checkpoint/resume for long jobs (config 'checkpoint_dir')
    store = None
    ckpt_root = config.get("checkpoint_dir")
    if ckpt_root:
        from .checkpoint import ChunkStore
        store = ChunkStore(ckpt_root, ChunkStore.fingerprint(cfg, n_ue))
        store.write_manifest({"n_ue": n_ue, "block": block})

    out_shape = _render_out_shape(path_data, bs_panel, ue_panel, cfg)
    out_bytes = int(np.prod(out_shape.shape)) * out_shape.dtype.itemsize
    single = to_device or (store is None and out_bytes <= output_budget())

    if single:
        if out is not None and (out.shape != out_shape.shape or
                                out.dtype != out_shape.dtype):
            out = None                   # config changed: nothing to donate
        try:
            h = _render_full_jit(path_data, bs_panel, ue_panel, cfg, out)
            if to_device:
                return h
            return _get_complex(h, cfg)
        except jax.errors.JaxRuntimeError as e:
            if to_device:
                raise
            print(f"[deepmimo_tpu] single-dispatch render failed ({e}); "
                  "falling back to streamed blocks")

    render = jax.jit(_render_ri, static_argnames=("cfg",))
    per_user_rot = np.asarray(bs_panel.rotation_deg).ndim == 2 or \
        np.asarray(ue_panel.rotation_deg).ndim == 2

    chunks: list = []
    inflight: list = []                  # (chunk_idx, start, size, device_h)

    def collect(entry):
        idx, start, size, h = entry
        try:
            arr = _get_complex(h, cfg)[:size]
        except jax.errors.JaxRuntimeError:
            # Re-render this block synchronously with retry + CPU fallback.
            arr = _render_block_with_retry(
                render, *_slice_block(path_data, bs_panel, ue_panel,
                                      per_user_rot, start, size, block),
                cfg)[:size]
        if store is not None:
            store.save_block(start, arr)
        chunks[idx] = arr

    for start in range(0, n_ue, block):
        size = min(block, n_ue - start)
        idx = len(chunks)
        chunks.append(None)
        if store is not None and store.has_block(start):
            chunks[idx] = store.load_block(start)[:size]
            continue
        pd, bsp, uep = _slice_block(path_data, bs_panel, ue_panel,
                                    per_user_rot, start, size, block)
        h = render(pd, bsp, uep, cfg)    # async dispatch
        try:
            h.copy_to_host_async()
        except Exception:
            pass
        inflight.append((idx, start, size, h))
        if len(inflight) >= 2:           # bound in-flight device buffers
            collect(inflight.pop(0))
    for entry in inflight:
        collect(entry)
    return np.concatenate(chunks, axis=0)


def _slice_block(path_data, bs_panel, ue_panel, per_user_rot, start, size,
                 block):
    """Fixed-shape user block (tail zero-padded) + panel slices."""
    if size < block:
        pad = block - size
        pd = jax.tree_util.tree_map(
            lambda x: None if x is None else
            np.concatenate([np.asarray(x)[start:start + size],
                            np.zeros((pad,) + np.asarray(x).shape[1:],
                                     dtype=np.asarray(x).dtype)], axis=0),
            path_data)
    else:
        pd = path_data.slice_users(start, block)
    bsp, uep = bs_panel, ue_panel
    if per_user_rot:
        bsp = _slice_panel(bs_panel, start, size, block)
        uep = _slice_panel(ue_panel, start, size, block)
    return pd, bsp, uep


def _render_block_with_retry(render, pd, bsp, uep, cfg, retries: int = 1):
    """Device-failure resilience for long sweeps.

    Transient accelerator/runtime errors (a lost device, OOM from a
    fragmented heap) retry once on the device, then fall back to a CPU
    execution of the same jitted function so a multi-hour job never loses
    its progress.
    """
    import jax

    for attempt in range(retries + 1):
        try:
            return _get_complex(render(pd, bsp, uep, cfg), cfg)
        except jax.errors.JaxRuntimeError as e:
            print(f"[deepmimo_tpu] device error on block "
                  f"(attempt {attempt + 1}): {e}")
    print("[deepmimo_tpu] falling back to CPU for this block")
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        pd_cpu = jax.tree_util.tree_map(
            lambda x: None if x is None else np.asarray(x), pd)
        return _get_complex(_render_ri(pd_cpu, bsp, uep, cfg), cfg)


def _slice_panel(panel, start, size, block):
    rot = np.asarray(panel.rotation_deg)
    if rot.ndim != 2:
        return panel
    sl = rot[start:start + size]
    if size < block:
        sl = np.concatenate(
            [sl, np.zeros((block - size, 3), dtype=sl.dtype)], axis=0)
    from ..ops.types import AntennaPanel
    return AntennaPanel(rotation_deg=type(panel.rotation_deg)(sl)
                        if not isinstance(sl, np.ndarray) else sl,
                        spacing=panel.spacing)


# ============================================================================
# MacroDataset
# ============================================================================

class MacroDataset:
    """Container propagating attribute/method access to child Datasets."""

    SINGLE_ACCESS_METHODS = {"info"}

    PROPAGATE_METHODS = {
        name for name, _ in inspect.getmembers(Dataset,
                                               predicate=inspect.isfunction)
        if not name.startswith("__")
    }

    def __init__(self, datasets=None):
        self.datasets = datasets if datasets is not None else []

    def _get_single(self, key):
        if not self.datasets:
            raise IndexError("MacroDataset is empty")
        return self.datasets[0][key]

    def __getattr__(self, name):
        if name in self.PROPAGATE_METHODS:
            if name in self.SINGLE_ACCESS_METHODS:
                def single_method(*args, **kwargs):
                    return getattr(self.datasets[0], name)(*args, **kwargs)
                return single_method

            def propagated(*args, **kwargs):
                results = [getattr(d, name)(*args, **kwargs)
                           for d in self.datasets]
                return results[0] if len(results) == 1 else results
            return propagated

        if name in SHARED_PARAMS:
            return self._get_single(name)

        results = [getattr(d, name) for d in self.datasets]
        return results[0] if len(results) == 1 else results

    def __getitem__(self, idx):
        if isinstance(idx, (int, slice)):
            return self.datasets[idx]
        if idx in SHARED_PARAMS:
            return self._get_single(idx)
        results = [d[idx] for d in self.datasets]
        return results[0] if len(results) == 1 else results

    def __setitem__(self, key, value):
        for d in self.datasets:
            d[key] = value

    def __len__(self):
        return len(self.datasets)

    def append(self, dataset):
        self.datasets.append(dataset)

    def compute_channels_batched(self, params=None, to_device: bool = False,
                                 out=None):
        """ONE device dispatch for every child dataset (multi-TX render).

        The reference generates multi-TX scenarios with one full
        generator pass per (tx, rx) pair (its MacroDataset propagates
        compute_channels child by child — so does ours by default). Here
        the children's path matrices CONCATENATE on the user axis (path
        slots NaN-padded to the widest child) and the renderer covers
        the combined batch — one dispatch, one compile, no
        per-child dispatch overhead. Children share one
        ChannelGenParameters (reference semantics) and FoV settings.

        Returns a list of per-child channel tensors — or, with
        ``to_device``, the COMBINED device planes array (children
        stacked on the user axis in order; slice at the child offsets).
        Dual-polarization is not supported here (use the per-child
        path).
        """
        if not self.datasets:
            raise IndexError("MacroDataset is empty")
        if params is not None and params.get(c.PARAMSET_POLAR_EN, 0):
            raise ValueError("compute_channels_batched does not support "
                             "dual-polarization; call per dataset.")
        if len(self.datasets) == 1:
            res = self.datasets[0].compute_channels(
                params, to_device=to_device, out=out)
            return res if to_device else [res]

        combined = self._combined_dataset()
        sizes = [d.n_ue for d in self.datasets]
        ch = combined.compute_channels(params, to_device=to_device,
                                       out=out)
        if to_device:
            return ch
        offs = np.cumsum([0] + sizes)
        return [ch[offs[i]:offs[i + 1]] for i in range(len(sizes))]

    def _combined_dataset(self) -> "Dataset":
        """Children's path matrices concatenated on the user axis (path
        slots NaN-padded to the widest child); cached."""
        combined = getattr(self, "_batched_cache", None)
        if combined is not None:
            return combined
        keys = [c.POWER_PARAM_NAME, c.PHASE_PARAM_NAME,
                c.DELAY_PARAM_NAME, c.AOA_AZ_PARAM_NAME,
                c.AOA_EL_PARAM_NAME, c.AOD_AZ_PARAM_NAME,
                c.AOD_EL_PARAM_NAME]
        have_doppler = all(
            d.get(c.DOPPLER_VEL_PARAM_NAME) is not None
            for d in self.datasets)
        if have_doppler:
            keys += [c.DOPPLER_VEL_PARAM_NAME, c.DOPPLER_ACC_PARAM_NAME]
        pmax = max(np.asarray(d[c.POWER_PARAM_NAME]).shape[1]
                   for d in self.datasets)

        def cat(key):
            arrs = []
            for d in self.datasets:
                a = np.asarray(d[key], dtype=np.float32)
                if a.shape[1] < pmax:
                    a = np.pad(a, ((0, 0), (0, pmax - a.shape[1])),
                               constant_values=np.nan)
                arrs.append(a)
            return np.concatenate(arrs, axis=0)

        data = {k: cat(k) for k in keys}
        data[c.RX_POS_PARAM_NAME] = np.concatenate(
            [np.asarray(d[c.RX_POS_PARAM_NAME], np.float32)
             for d in self.datasets], axis=0)
        data[c.TX_POS_PARAM_NAME] = np.asarray(
            self.datasets[0][c.TX_POS_PARAM_NAME], np.float32)
        combined = Dataset(data)
        for k in ("bs_fov", "ue_fov"):
            v = self.datasets[0].get(k)
            if v is not None:
                combined[k] = v
        self._batched_cache = combined
        return combined

    def compute_beam_gains_batched(self, params=None, codebook=None,
                                   to_device: bool = False):
        """Beam-gain maps for EVERY child dataset in one fused dispatch.

        Multi-TX beam sweep (one codebook evaluated against every TX's
        users) through the codebook-folded render: children concatenate
        on the user axis like :meth:`compute_channels_batched` and the
        full H of any child is never materialized. Returns a list of
        per-child ``[n_ue, R, B, K]`` maps — or, with ``to_device``, the
        combined raw device array (children stacked on the user axis).
        """
        if not self.datasets:
            raise IndexError("MacroDataset is empty")
        if len(self.datasets) == 1:
            res = self.datasets[0].compute_beam_gains(
                params, codebook=codebook, to_device=to_device)
            return res if to_device else [res]
        combined = self._combined_dataset()
        sizes = [d.n_ue for d in self.datasets]
        g = combined.compute_beam_gains(params, codebook=codebook,
                                        to_device=to_device)
        if to_device:
            return g
        offs = np.cumsum([0] + sizes)
        return [g[offs[i]:offs[i + 1]] for i in range(len(sizes))]
