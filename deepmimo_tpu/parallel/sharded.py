"""Sharded channel rendering and distributed differentiable calibration.

Two entry points:

- ``render_channels_sharded``: the forward renderer laid out over a
  (users, tile) mesh — users data-parallel, output subcarriers sharded over
  the tile axis. XLA partitions the einsum; no manual collectives needed.

- ``training_step``: one step of gradient-based calibration of the channel
  model (array geometry + per-path parameter corrections) against target
  channels. Per-user path gradients stay local to each shard; shared
  parameter gradients (panel rotation/spacing) are all-reduced by XLA's
  partitioner (NCCL between GPUs), overlapped with the backward pass.

Renders that run the fused GPU kernel (the dual-polar path) are wrapped in
``shard_map``: a kernel is opaque to XLA's partitioner, so each device runs
it on its own user shard.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.types import PathData, AntennaPanel, ChannelConfig
from ..ops.channel import render_channels, render_channels_planes
from .mesh import USERS_AXIS, TILE_AXIS, user_sharding, replicated


def shard_paths(paths: PathData, mesh: Mesh) -> PathData:
    """Device-put PathData with the user axis sharded across the mesh."""
    sh = user_sharding(mesh)
    return jax.tree_util.tree_map(
        lambda x: None if x is None else jax.device_put(x, sh), paths)


@functools.partial(jax.jit, static_argnames=("cfg", "mesh"))
def _render_sharded(paths, bs, ue, cfg, mesh):
    h = render_channels(paths, bs, ue, cfg)
    # Constrain the output layout: users over the dp axis, last (subcarrier)
    # axis over the tile axis, so downstream consumers keep tiles in HBM.
    spec = [USERS_AXIS] + [None] * (h.ndim - 2) + [TILE_AXIS]
    return jax.lax.with_sharding_constraint(h, NamedSharding(mesh, P(*spec)))


def render_channels_sharded(paths: PathData, bs: AntennaPanel,
                            ue: AntennaPanel, cfg: ChannelConfig,
                            mesh: Mesh) -> jax.Array:
    """Render channels with users sharded across the mesh.

    The per-user computation is embarrassingly parallel, so XLA partitions
    it with zero communication; only the output layout constraint introduces
    (sub-channel) collectives when tile > 1.
    """
    paths = shard_paths(paths, mesh)
    return _render_sharded(paths, bs, ue, cfg, mesh)


def _panel_spec(panel: AntennaPanel):
    """Per-user [U, 3] rotations shard with the users; the rest replicate."""
    return jax.tree_util.tree_map(
        lambda x: P(USERS_AXIS) if jnp.ndim(x) == 2 else P(), panel)


@functools.partial(jax.jit, static_argnames=("cfg", "mesh"))
def _render_polar_sharded(paths, bs, ue, cfg, pol_p, pol_ph, mesh):
    from ..ops.channel import (render_channels_planes_polar,
                               _polar_packed_layout)
    # Render layouts: packed [U, R, T, 2*Np*S*K] (users leading) or
    # stacked [2, U, R, T, Np, S, K] (users second).
    lead = ([USERS_AXIS] if _polar_packed_layout(cfg, pol_p.shape[0])
            else [None, USERS_AXIS])
    pol_spec = P(None, USERS_AXIS)
    h = jax.shard_map(
        lambda *a: render_channels_planes_polar(*a[:3], cfg, *a[3:]),
        mesh=mesh,
        in_specs=(P(USERS_AXIS), _panel_spec(bs), _panel_spec(ue),
                  pol_spec, pol_spec),
        out_specs=P(*lead), check_vma=False,
    )(paths, bs, ue, pol_p, pol_ph)
    # Users over the dp axis; the folded (pol, s, k) minor axis over the
    # tile axis.
    spec = lead + [None] * (h.ndim - len(lead) - 1) + [TILE_AXIS]
    return jax.lax.with_sharding_constraint(h, NamedSharding(mesh, P(*spec)))


def render_polar_sharded(paths: PathData, bs: AntennaPanel,
                         ue: AntennaPanel, cfg: ChannelConfig,
                         pol_power_dbw, pol_phase_deg,
                         mesh: Mesh) -> jax.Array:
    """All four polarizations, one dispatch, users sharded.

    The single-dispatch dual-polar render (pol axis riding the slot
    axis) is per-user independent like the single-pol path, so users
    shard with zero forward collectives; the [N_pol, U, P] pol matrices
    shard on their user axis alongside PathData. The user count must
    divide the mesh's users axis. Returns the raw render-layout planes
    (unpack host-side with ops.channel.unpack_polar_planes_np).
    """
    paths = shard_paths(paths, mesh)
    sh = NamedSharding(mesh, P(None, USERS_AXIS, None))
    pol_p = jax.device_put(jnp.asarray(pol_power_dbw), sh)
    pol_ph = jax.device_put(jnp.asarray(pol_phase_deg), sh)
    return _render_polar_sharded(paths, bs, ue, cfg, pol_p, pol_ph, mesh)


@functools.partial(jax.jit, static_argnames=("cfg", "mesh"))
def _render_beamgain_polar_sharded(paths, bs, ue, cfg, pol_p, pol_ph,
                                   wr, wi, mesh):
    from ..ops.channel import render_beam_gains_polar
    g = render_beam_gains_polar(paths, bs, ue, cfg, pol_p, pol_ph, wr, wi)
    spec = (USERS_AXIS, None, TILE_AXIS)
    return jax.lax.with_sharding_constraint(g, NamedSharding(mesh, P(*spec)))


def render_beam_gains_polar_sharded(paths: PathData, bs: AntennaPanel,
                                    ue: AntennaPanel, cfg: ChannelConfig,
                                    pol_power_dbw, pol_phase_deg,
                                    wr, wi, mesh: Mesh) -> jax.Array:
    """Dual-polar beam-gain maps (one dispatch, no H) with users sharded.

    The [N_pol, U, P] polarization stacks shard on their user axis
    alongside PathData; the codebook planes replicate. Zero forward
    collectives like every per-user-independent render here.
    """
    paths = shard_paths(paths, mesh)
    sh = NamedSharding(mesh, P(None, USERS_AXIS, None))
    pol_p = jax.device_put(jnp.asarray(pol_power_dbw), sh)
    pol_ph = jax.device_put(jnp.asarray(pol_phase_deg), sh)
    rep = replicated(mesh)
    wr = jax.device_put(jnp.asarray(wr), rep)
    wi = jax.device_put(jnp.asarray(wi), rep)
    return _render_beamgain_polar_sharded(paths, bs, ue, cfg, pol_p,
                                          pol_ph, wr, wi, mesh)


@functools.partial(jax.jit, static_argnames=("cfg", "mesh"))
def _render_beamgain_sharded(paths, bs, ue, cfg, wr, wi, mesh):
    from ..ops.channel import render_beam_gains
    g = render_beam_gains(paths, bs, ue, cfg, wr, wi)   # [U, R*B, S*K]
    spec = (USERS_AXIS, None, TILE_AXIS)
    return jax.lax.with_sharding_constraint(g, NamedSharding(mesh, P(*spec)))


def render_beam_gains_sharded(paths: PathData, bs: AntennaPanel,
                              ue: AntennaPanel, cfg: ChannelConfig,
                              wr, wi, mesh: Mesh) -> jax.Array:
    """Beam-gain maps with users sharded across the mesh.

    The codebook-folded render (H never materialized — ops/beamgain.py)
    is per-user independent, so
    users shard with zero forward collectives; the small [B, T] codebook
    planes replicate. Output G [U, R*B, S*K] shards users over the dp
    axis, the subcarrier axis over the tile axis.
    """
    paths = shard_paths(paths, mesh)
    rep = replicated(mesh)
    wr = jax.device_put(jnp.asarray(wr), rep)
    wi = jax.device_put(jnp.asarray(wi), rep)
    return _render_beamgain_sharded(paths, bs, ue, cfg, wr, wi, mesh)


# ============================================================================
# Distributed differentiable calibration (the "training step")
# ============================================================================

class CalibParams(NamedTuple):
    """Learnable parameters of the channel model.

    Panel geometry (shared across users; grads all-reduced) plus per-path
    corrections to the ray parameters (sharded with the users).
    """

    bs: AntennaPanel
    ue: AntennaPanel
    d_power_dbw: jax.Array    # [U, P]
    d_phase_deg: jax.Array    # [U, P]
    d_delay_ns: jax.Array     # [U, P] (nanoseconds, for conditioning)
    d_angles_deg: jax.Array   # [U, P, 4]: aoa_az, aoa_el, aod_az, aod_el


def init_calib_params(paths: PathData, bs: AntennaPanel,
                      ue: AntennaPanel) -> CalibParams:
    u, p = paths.power_dbw.shape
    z = jnp.zeros((u, p), dtype=paths.power_dbw.dtype)
    return CalibParams(bs=bs, ue=ue, d_power_dbw=z, d_phase_deg=z,
                       d_delay_ns=z,
                       d_angles_deg=jnp.zeros((u, p, 4), dtype=z.dtype))


def _apply_calib(paths: PathData, params: CalibParams) -> PathData:
    da = params.d_angles_deg
    return PathData(
        power_dbw=paths.power_dbw + params.d_power_dbw,
        phase_deg=paths.phase_deg + params.d_phase_deg,
        delay_s=paths.delay_s + params.d_delay_ns * 1e-9,
        aoa_az_deg=paths.aoa_az_deg + da[..., 0],
        aoa_el_deg=paths.aoa_el_deg + da[..., 1],
        aod_az_deg=paths.aod_az_deg + da[..., 2],
        aod_el_deg=paths.aod_el_deg + da[..., 3],
        valid=paths.valid,
        doppler_vel=paths.doppler_vel,
        doppler_acc=paths.doppler_acc,
    )


def calib_loss(params: CalibParams, paths: PathData, target: jax.Array,
               cfg: ChannelConfig) -> jax.Array:
    """Normalized mean squared complex error vs the target channels.

    Normalizing by the target power makes the loss (and useful learning
    rates) independent of the absolute pathloss scale (~1e-10 W powers).
    """
    h = render_channels(_apply_calib(paths, params), params.bs, params.ue,
                        cfg)
    err = h - target
    num = jnp.mean(jnp.real(err * jnp.conj(err)))
    den = jnp.mean(jnp.real(target * jnp.conj(target))) + 1e-30
    return num / den


def calib_loss_planes(params: CalibParams, paths: PathData,
                      target: jax.Array, cfg: ChannelConfig) -> jax.Array:
    """Planes-layout calibration loss (normalized MSE on real planes).

    Same objective as :func:`calib_loss` but through
    :func:`render_channels_planes`, so on a GPU the forward runs as the
    fused kernel and the backward differentiates its plain XLA reference
    (ops/pallas/render.py). ``target`` must be in the same planes layout
    the cfg selects (stacked or packed).
    """
    h = render_channels_planes(_apply_calib(paths, params), params.bs,
                               params.ue, cfg)
    err = h - target
    return jnp.mean(err * err) / (jnp.mean(target * target) + 1e-30)


@functools.partial(jax.jit, static_argnames=("cfg", "lr"))
def training_step_planes(params: CalibParams, paths: PathData,
                         target: jax.Array, cfg: ChannelConfig,
                         lr: float = 1e-3
                         ) -> Tuple[CalibParams, jax.Array]:
    """One SGD calibration step on the planes path (fused forward)."""
    loss, grads = jax.value_and_grad(calib_loss_planes)(params, paths,
                                                        target, cfg)
    new_params = jax.tree_util.tree_map(
        lambda p, g: p - lr * g if g is not None else p, params, grads)
    return new_params, loss


@functools.partial(jax.jit, static_argnames=("cfg", "lr"))
def training_step(params: CalibParams, paths: PathData, target: jax.Array,
                  cfg: ChannelConfig, lr: float = 1e-3
                  ) -> Tuple[CalibParams, jax.Array]:
    """One SGD step of channel-model calibration.

    Under a mesh, per-user leaves keep their user sharding and the shared
    panel gradients are all-reduced automatically (psum over the users axis,
    overlapped with backward by XLA's scheduler).
    """
    loss, grads = jax.value_and_grad(calib_loss)(params, paths, target, cfg)
    new_params = jax.tree_util.tree_map(
        lambda p, g: p - lr * g if g is not None else p, params, grads)
    return new_params, loss


def make_sharded_training_step(mesh: Mesh, cfg: ChannelConfig,
                               lr: float = 1e-3):
    """Build a jitted training step with explicit mesh shardings.

    Returns (step_fn, place_fn): ``place_fn(params, paths, target)`` puts
    the training state on the mesh with users sharded; ``step_fn`` runs one
    update.
    """
    u_sh = user_sharding(mesh)
    r_sh = replicated(mesh)

    def place(params: CalibParams, paths: PathData, target: jax.Array):
        def put_user(x):
            return None if x is None else jax.device_put(x, u_sh)

        paths = jax.tree_util.tree_map(put_user, paths)
        target_spec = [USERS_AXIS] + [None] * (target.ndim - 2) + [TILE_AXIS]
        target = jax.device_put(
            target, NamedSharding(mesh, P(*target_spec)))
        params = CalibParams(
            bs=jax.tree_util.tree_map(
                lambda x: jax.device_put(x, r_sh), params.bs),
            ue=jax.tree_util.tree_map(
                lambda x: jax.device_put(
                    x, u_sh if getattr(x, "ndim", 0) == 2 else r_sh),
                params.ue),
            d_power_dbw=put_user(params.d_power_dbw),
            d_phase_deg=put_user(params.d_phase_deg),
            d_delay_ns=put_user(params.d_delay_ns),
            d_angles_deg=put_user(params.d_angles_deg),
        )
        return params, paths, target

    @functools.partial(jax.jit, static_argnames=())
    def step(params, paths, target):
        loss, grads = jax.value_and_grad(calib_loss)(params, paths, target,
                                                     cfg)
        return jax.tree_util.tree_map(
            lambda p, g: p - lr * g if g is not None else p,
            params, grads), loss

    return step, place
