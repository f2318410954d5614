"""Compute core: pure-JAX (and one Pallas GPU kernel) channel synthesis ops.

All functions here are pure, jit-friendly (static shapes, no data-dependent
Python control flow), differentiable w.r.t. their continuous inputs, and use
validity masks instead of NaN padding (NaNs poison gradients).

Unit conventions INSIDE ops: radians and linear power.
The API layer (deepmimo_tpu.generator) converts from the scenario format's
degrees / dBW convention at the boundary.
"""

from .types import PathData, ChannelConfig, AntennaPanel
from .geometry import (
    rotate_angles,
    ant_indices,
    array_response,
    apply_fov,
    steering_vec,
    safe_arccos,
)
from .patterns import pattern_gain, PATTERN_REGISTRY
from .channel import (render_channels, render_channels_planes,
                      render_channels_and_grads, render_beam_gains,
                      render_beam_gains_polar, fused_render_eligible)

__all__ = [
    "PathData", "ChannelConfig", "AntennaPanel",
    "rotate_angles", "ant_indices", "array_response", "apply_fov",
    "steering_vec", "safe_arccos",
    "pattern_gain", "PATTERN_REGISTRY",
    "render_channels", "render_channels_planes",
    "render_channels_and_grads", "render_beam_gains",
    "render_beam_gains_polar", "fused_render_eligible",
]
