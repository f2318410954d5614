"""Dual-polar device-path throughput vs single-pol.

Target: dual-polar users/s within 4.5x of single-pol (it renders 4x the
output) instead of four independent renders + host assembly. Measures
both through the product API (Dataset.compute_channels, to_device planes)
on the same synthetic 32k-user chunk, on the GPU:

    python benchmarks/run_polar_bench.py
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_UE = 32_768
MAX_PATHS = 25
OUT = os.path.join(REPO, "benchmarks", "polar_bench.json")


def main():
    import jax
    import deepmimo_tpu as dm
    from deepmimo_tpu import consts as c
    from bench import make_data
    from deepmimo_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    data = make_data(N_UE, MAX_PATHS)
    nanmask = np.isnan(data["power"])
    rng = np.random.RandomState(1)

    def dataset():
        d = dict(data)
        d["rx_pos"] = np.zeros((N_UE, 3), np.float32)
        d["tx_pos"] = np.zeros((1, 3), np.float32)
        ds = dm.Dataset(d)
        for pol in ("vv", "vh", "hh", "hv"):
            ds[f"power_{pol}"] = np.where(
                nanmask, np.nan,
                rng.uniform(-120, -70, data["power"].shape)
            ).astype(np.float32)
            ds[f"phase_{pol}"] = np.where(
                nanmask, np.nan,
                rng.uniform(-180, 180, data["power"].shape)
            ).astype(np.float32)
        return ds

    def params(polar):
        p = dm.ChannelGenParameters()
        p[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_SHAPE] = np.array([8, 8])
        p[c.PARAMSET_OFDM][c.PARAMSET_OFDM_SC_NUM] = 512
        p[c.PARAMSET_OFDM][c.PARAMSET_OFDM_SC_SAMP] = np.arange(64)
        p[c.PARAMSET_NUM_PATHS] = MAX_PATHS
        if polar:
            p[c.PARAMSET_POLAR_EN] = 1
        return p

    # Median of N donated dispatches, each waited for with
    # block_until_ready; the `out=` chain keeps device memory constant.
    N = 10
    results = {"timing": f"median of {N} donated dispatches",
               "device": jax.devices()[0].device_kind}
    for name, polar in (("single_pol", False), ("dual_polar", True)):
        ds = dataset()
        p = params(polar)
        h = jax.block_until_ready(ds.compute_channels(p, to_device=True))
        times = []
        for _ in range(N):
            t0 = time.perf_counter()
            h = jax.block_until_ready(
                ds.compute_channels(p, to_device=True, out=h))
            times.append(time.perf_counter() - t0)
        dt = float(np.median(times))
        results[name] = {"ms": round(dt * 1e3, 3),
                         "users_per_s": round(N_UE / dt, 1)}
        print(f"{name}: {dt * 1e3:.3f} ms -> {N_UE / dt / 1e6:.2f} M "
              f"users/s", flush=True)

    ratio = (results["single_pol"]["users_per_s"] /
             results["dual_polar"]["users_per_s"])
    results["slowdown_ratio"] = round(ratio, 2)
    results["target"] = "<= 4.5x (renders 4x the output in one dispatch)"
    results["config"] = f"{N_UE} users, 25 paths, 8x8 BS, 64 of 512 sc"
    print(f"dual-polar slowdown: {ratio:.2f}x (target <= 4.5)", flush=True)
    with open(OUT, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
