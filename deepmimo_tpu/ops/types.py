"""Pytree data types for the channel renderer.

``PathData`` is the device-resident struct-of-arrays view of one TX-RX pair's
ray data (the 7 per-path matrices of the scenario format, reference
deepmimo/consts.py:188-198), converted to masks + fill values so every array
is NaN-free and differentiable.

``ChannelConfig`` carries the *static* (hashable) part of channel generation
parameters — shapes, pattern names, subcarrier selection — and is passed as a
static argument to jitted renderers. The *differentiable* part (rotations,
spacing, doppler times) lives in ``AntennaPanel`` / ``PathData`` pytrees.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np


def _register_dataclass(cls):
    """Register a dataclass as a JAX pytree (all fields are leaves)."""
    fields = [f.name for f in dataclasses.fields(cls)]

    def flatten(obj):
        return [getattr(obj, name) for name in fields], None

    def unflatten(_, children):
        return cls(**dict(zip(fields, children)))

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    return cls


@_register_dataclass
@dataclasses.dataclass(frozen=True)
class PathData:
    """Struct-of-arrays per-path ray data for U users × P paths (padded).

    All angle fields are in DEGREES (scenario-format convention); power in dBW.
    ``valid`` marks real paths; padded slots hold zeros and must be masked.
    Doppler fields are optional (None when the scenario has no mobility data).
    """

    power_dbw: jax.Array          # [U, P] path power, dBW
    phase_deg: jax.Array          # [U, P] path phase, degrees
    delay_s: jax.Array            # [U, P] time of arrival, seconds
    aoa_az_deg: jax.Array         # [U, P]
    aoa_el_deg: jax.Array         # [U, P]
    aod_az_deg: jax.Array         # [U, P]
    aod_el_deg: jax.Array         # [U, P]
    valid: jax.Array              # [U, P] bool
    doppler_vel: Optional[jax.Array] = None   # [U, P] radial velocity m/s
    doppler_acc: Optional[jax.Array] = None   # [U, P] radial accel m/s^2

    @property
    def n_ue(self) -> int:
        return self.power_dbw.shape[0]

    @property
    def max_paths(self) -> int:
        return self.power_dbw.shape[1]

    @classmethod
    def from_numpy(cls, power, phase, delay, aoa_az, aoa_el, aod_az, aod_el,
                   doppler_vel=None, doppler_acc=None,
                   dtype=jnp.float32) -> "PathData":
        """Build from NaN-padded numpy matrices (the on-disk convention)."""
        power = np.asarray(power)
        valid = ~np.isnan(power)

        def clean(x):
            x = np.asarray(x, dtype=np.float64)
            return jnp.asarray(np.where(valid, np.nan_to_num(x), 0.0),
                               dtype=dtype)

        return cls(
            power_dbw=clean(power),
            phase_deg=clean(phase),
            delay_s=clean(delay),
            aoa_az_deg=clean(aoa_az),
            aoa_el_deg=clean(aoa_el),
            aod_az_deg=clean(aod_az),
            aod_el_deg=clean(aod_el),
            valid=jnp.asarray(valid),
            doppler_vel=None if doppler_vel is None else clean(doppler_vel),
            doppler_acc=None if doppler_acc is None else clean(doppler_acc),
        )

    def slice_users(self, start: int, size: int) -> "PathData":
        """Static slice along the user axis (for host-side batching)."""
        return jax.tree_util.tree_map(
            lambda x: None if x is None else
            jax.lax.dynamic_slice_in_dim(x, start, size, axis=0), self)

    def trim_paths(self, num_paths: int) -> "PathData":
        """Keep only the first ``num_paths`` path slots."""
        return jax.tree_util.tree_map(
            lambda x: None if x is None else x[:, :num_paths], self)


@_register_dataclass
@dataclasses.dataclass(frozen=True)
class AntennaPanel:
    """Differentiable antenna-array parameters for one side (TX or RX).

    ``rotation_deg`` is either shape [3] (one rotation for all users) or
    [U, 3] (per-user rotations). ``spacing`` is in wavelengths.
    The panel shape itself is static and lives in ChannelConfig.
    """

    rotation_deg: jax.Array       # [3] or [U, 3]
    spacing: jax.Array            # scalar, wavelengths

    @classmethod
    def make(cls, rotation_deg=(0.0, 0.0, 0.0), spacing=0.5,
             dtype=jnp.float32) -> "AntennaPanel":
        return cls(rotation_deg=jnp.asarray(rotation_deg, dtype=dtype),
                   spacing=jnp.asarray(spacing, dtype=dtype))


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """Static channel-generation configuration (hashable; jit static arg).

    Mirrors the reference parameter set (reference generator/channel.py:33-63)
    minus the differentiable leaves (rotation/spacing → AntennaPanel).
    """

    bs_shape: Tuple[int, int] = (8, 1)
    ue_shape: Tuple[int, int] = (1, 1)
    bs_pattern: str = "isotropic"
    ue_pattern: str = "isotropic"
    freq_domain: bool = True
    # OFDM
    subcarriers: int = 512
    selected_subcarriers: Tuple[int, ...] = (0,)
    bandwidth: float = 10e6
    rx_filter: bool = False            # sinc low-pass filter
    # Paths
    num_paths: int = 25
    # FoV (degrees); None disables filtering for that side
    bs_fov: Optional[Tuple[float, float]] = None
    ue_fov: Optional[Tuple[float, float]] = None
    # Doppler
    enable_doppler: bool = False
    carrier_freq: float = 3.5e9
    doppler_times: Tuple[float, ...] = (0.0,)
    # Time-domain path compaction (reference packs valid paths to the
    # front of the path axis). "auto" compacts only when an FoV filter is
    # active — loader/converter path data is tail-padded, so validity is
    # already front-packed unless FoV punches holes. True always compacts
    # (needed only for hand-built interior-invalid path data); False never.
    compact_td_paths: Union[bool, str] = "auto"
    # Precision of the complex output
    dtype: str = "complex64"
    # Path-sum precision: "float32" (full float32 products in XLA, three
    # TF32 passes in the fused GPU kernel), "highest" (full float32
    # everywhere), "bfloat16" (bf16 operands, float32 accumulation) or
    # "default" (the backend's choice).
    matmul_dtype: str = "float32"
    # Plane layout of render_channels_planes: "stacked" -> [2, U, R, T, K];
    # "packed" -> [U, R, T, 2K] with hr in the first minor half (needs
    # K % 64 == 0; silently falls back to stacked otherwise).
    planes_layout: str = "stacked"
    # Output precision of the PLANES renderers ("float32" default;
    # "bfloat16" halves the H output bytes at ~2^-8 relative rounding on
    # H. Serving feature for NN consumers (beam selection / CSI nets eat
    # bf16); the canonical complex path and parity tests stay float32).
    out_dtype: str = "float32"

    @property
    def n_rx_ant(self) -> int:
        return int(np.prod(self.ue_shape))

    @property
    def n_tx_ant(self) -> int:
        return int(np.prod(self.bs_shape))

    @property
    def n_sel_subcarriers(self) -> int:
        return len(self.selected_subcarriers)

    @property
    def cdtype(self):
        return jnp.complex64 if self.dtype == "complex64" else jnp.complex128

    @property
    def rdtype(self):
        return jnp.float32 if self.dtype == "complex64" else jnp.float64

    def replace(self, **kw) -> "ChannelConfig":
        return dataclasses.replace(self, **kw)
