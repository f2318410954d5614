"""Serving-loop example: constant-memory device-resident channel renders.

Demonstrates the three product render modes on a synthetic scenario:

1. one-shot host render (numpy complex out),
2. the serving loop — device planes with a donated output buffer
   (one dispatch per batch, no host readback, constant device memory),
3. a legacy-v3 dual-polarization scenario rendered to the VV/VH/HH/HV
   quadruple.

Runs on the default JAX device (the GPU where there is one); pass
``--cpu`` to force the CPU:

    python examples/serve_channels.py [--cpu]
"""

import os
import sys
import tempfile

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "tests"))

if "--cpu" in sys.argv[1:]:
    import jax
    jax.config.update("jax_platforms", "cpu")

import deepmimo_tpu as dm
from deepmimo_tpu.ops.channel import unpack_planes_np
from scenario_utils import write_synthetic_scenario


def main():
    import jax
    from deepmimo_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    tmp = tempfile.mkdtemp(prefix="dm_serve_")
    folder = os.path.join(tmp, "demo_city")
    write_synthetic_scenario(folder, n_ue=256, max_paths=8, grid=(16, 16))
    ds = dm.load(folder)

    params = dm.ChannelGenParameters()
    params["bs_antenna"]["shape"] = np.array([8, 8])
    params["ofdm"]["selected_subcarriers"] = np.arange(64)

    # 1. one-shot host render
    H = ds.compute_channels(params)
    print(f"host render: {H.shape} {H.dtype}, "
          f"|H| max {np.abs(H).max():.3e}")

    # 2. serving loop: device planes, donated buffer
    h = None
    for step in range(4):                      # pretend new batches arrive
        h = ds.compute_channels(params, to_device=True, out=h)
    planes = jax.device_get(h)
    cfg, _, _ = params.to_config(ds.n_ue)
    H2 = unpack_planes_np(planes, cfg)
    print(f"serving loop: device planes {h.shape} -> complex {H2.shape}; "
          f"allclose={np.allclose(H2, H, atol=1e-5 * np.abs(H).max())}")

    # 3. dual-polarization from a v3-format scenario on disk
    per_pol = {}
    rng = np.random.RandomState(0)
    base_power = np.asarray(ds.power)
    for pol in ("vv", "vh", "hh", "hv"):
        ds[f"power_{pol}"] = (base_power - rng.uniform(0, 10)).astype(
            np.float32)
        ds[f"phase_{pol}"] = np.asarray(ds.phase)
    from deepmimo_tpu.integrations import export_matlab
    v3_folder = os.path.join(tmp, "demo_v3_dualpolar")
    export_matlab(ds, v3_folder)

    ds3 = dm.load(v3_folder)                  # v3 dispatch, dual-polar keys
    params["enable_dual_polar"] = 1
    quad = ds3.compute_channels(params)
    print("dual-polar:", {k: v.shape for k, v in quad.items()})

    # 4. beam-gain serving: codebook folded into the fused kernel, the
    #    full H tensor never materialized (the beam-training primitive).
    params["enable_dual_polar"] = 0
    n_tx = 64
    rng = np.random.RandomState(3)
    codebook = np.exp(1j * rng.uniform(-np.pi, np.pi, (16, n_tx))) \
        / np.sqrt(n_tx)
    G = ds.compute_beam_gains(params, codebook=codebook)
    best = G.sum(axis=-1).argmax(axis=-1)[:, 0]     # per-user best beam
    expect = np.abs(np.einsum("bt,urtk->urbk", codebook.conj(), H)) ** 2
    print(f"beam gains: {G.shape}, best-beam histogram "
          f"{np.bincount(best, minlength=16).tolist()}, "
          f"allclose={np.allclose(G, expect, atol=1e-5 * expect.max())}")


if __name__ == "__main__":
    main()
