"""Benchmark: users/s channel generation on the GPU vs the reference CPU stack.

Workload (BASELINE.json): asu_campus-scale synthetic scenario — 131,072 users
x 25 paths per chunk, 64-antenna BS UPA, OFDM (512-FFT, 64 selected
subcarriers), isotropic patterns — the "64-ant OFDM" headline config.

The sweep runs THROUGH THE PRODUCT API. Each of the 12 chunks is a
``deepmimo_tpu.Dataset`` and each render is ``dataset.compute_channels(
params, to_device=True, out=prev)`` — one device dispatch per dataset, the
previous output buffer donated so the sweep runs in constant device memory.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": "users/s", "vs_baseline": N,
     "device": {...}}

Timing: the 12 dispatches pipeline (async dispatch; no host sync between
calls); each sweep ends in ``block_until_ready`` on the final output, and
the best of 3 sweeps is reported. A run without a GPU fails.

The reference baseline (users/s of jmoraispk/DeepMIMO's generator on the same
data, same machine, CPU) is measured once on a subsample and cached in
benchmarks/baseline_reference.json.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
BASELINE_CACHE = os.path.join(REPO, "benchmarks", "baseline_reference.json")

CHUNK = 131_072         # ~asu_campus grid (411 x 321 = 131,931)
N_CHUNKS = 12
N_UE = CHUNK * N_CHUNKS  # total distinct users rendered per sweep
MAX_PATHS = 25
BS_SHAPE = (8, 8)       # 64-antenna UPA
UE_SHAPE = (1, 1)
N_FFT = 512
SEL_SC = tuple(range(64))
BANDWIDTH = 10e6
BASELINE_SAMPLE = 384   # users timed through the reference CPU generator


def make_data(n_ue, max_paths, seed=7):
    """Synthetic NaN-padded path matrices (vectorized; fast at 131k users)."""
    rng = np.random.RandomState(seed)
    n_valid = rng.randint(1, max_paths + 1, size=n_ue)
    mask = np.arange(max_paths)[None, :] < n_valid[:, None]

    def mat(lo, hi):
        a = rng.uniform(lo, hi, (n_ue, max_paths)).astype(np.float32)
        return np.where(mask, a, np.nan).astype(np.float32)

    return {
        "power": mat(-130, -60), "phase": mat(-180, 180),
        "delay": mat(1e-7, 4e-6),
        "aoa_az": mat(-180, 180), "aoa_el": mat(0, 180),
        "aod_az": mat(-180, 180), "aod_el": mat(0, 180),
    }


def make_params():
    import deepmimo_tpu as dm
    from deepmimo_tpu import consts as c
    params = dm.ChannelGenParameters()
    params[c.PARAMSET_ANT_BS][c.PARAMSET_ANT_SHAPE] = np.array(BS_SHAPE)
    params[c.PARAMSET_ANT_UE][c.PARAMSET_ANT_SHAPE] = np.array(UE_SHAPE)
    params[c.PARAMSET_OFDM][c.PARAMSET_OFDM_SC_NUM] = N_FFT
    params[c.PARAMSET_OFDM][c.PARAMSET_OFDM_SC_SAMP] = np.array(SEL_SC)
    params[c.PARAMSET_OFDM][c.PARAMSET_OFDM_BANDWIDTH] = BANDWIDTH
    params[c.PARAMSET_NUM_PATHS] = MAX_PATHS
    return params


def bench_device(data):
    import jax
    import jax.numpy as jnp
    import deepmimo_tpu as dm
    from deepmimo_tpu.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX found "
                         f"{dev.platform!r}")
    enable_compile_cache()
    params = make_params()
    datasets = []
    for i in range(N_CHUNKS):
        sl = slice(i * CHUNK, (i + 1) * CHUNK)
        d = {k: v[sl] for k, v in data.items()}
        d["rx_pos"] = np.zeros((CHUNK, 3), np.float32)
        d["tx_pos"] = np.zeros((1, 3), np.float32)
        datasets.append(dm.Dataset(d))

    # Pre-allocate the output buffer so ONLY the donated-output executable
    # compiles, then warm up: transfers every dataset's path data to the
    # device and sanity-checks one chunk.
    from deepmimo_tpu.generator import dataset as D
    ds0 = datasets[0]
    p0 = ds0.set_channel_params(params)
    np.random.seed(1001)
    cfg0, bsp0, uep0 = p0.to_config(
        ds0.n_ue, ue_rotation=p0.resolve_ue_rotation(ds0.n_ue))
    oshape = D._render_out_shape(ds0._path_data(cfg0), bsp0, uep0, cfg0)
    h = jnp.zeros(oshape.shape, oshape.dtype)
    for ds in datasets:
        h = ds.compute_channels(params, to_device=True, out=h)
    assert np.isfinite(float(jax.device_get(h[0, 0, 0, 0])))
    assert h.shape[0] == CHUNK

    best = None
    for _ in range(3):
        t0 = time.perf_counter()
        for ds in datasets:
            h = ds.compute_channels(params, to_device=True, out=h)
        h.block_until_ready()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return N_UE / best, best, N_UE, dev


def bench_reference(data, n_sample):
    """Time the reference CPU generator on a subsample; returns users/s."""
    sys.path.insert(0, "/root/reference")
    import importlib
    for mod in list(sys.modules):
        if mod == "deepmimo" or mod.startswith("deepmimo."):
            del sys.modules[mod]
    deepmimo = importlib.import_module("deepmimo")
    from deepmimo.generator.dataset import Dataset as RefDataset
    from deepmimo.generator.channel import ChannelGenParameters as RefParams

    sub = {k: np.asarray(v[:n_sample], dtype=np.float32)
           for k, v in data.items()}
    ds = RefDataset({
        "power": sub["power"], "phase": sub["phase"], "delay": sub["delay"],
        "aoa_az": sub["aoa_az"], "aoa_el": sub["aoa_el"],
        "aod_az": sub["aod_az"], "aod_el": sub["aod_el"],
        "rx_pos": np.zeros((n_sample, 3), dtype=np.float32),
        "tx_pos": np.zeros((1, 3), dtype=np.float32),
    })
    params = RefParams()
    params["bs_antenna"]["shape"] = np.array(BS_SHAPE)
    params["ue_antenna"]["shape"] = np.array(UE_SHAPE)
    params["ofdm"]["subcarriers"] = N_FFT
    params["ofdm"]["selected_subcarriers"] = np.array(SEL_SC)
    params["ofdm"]["bandwidth"] = BANDWIDTH
    params["num_paths"] = MAX_PATHS

    t0 = time.perf_counter()
    ds.compute_channels(params)
    dt = time.perf_counter() - t0
    return n_sample / dt


def get_baseline(data):
    if os.path.exists(BASELINE_CACHE):
        with open(BASELINE_CACHE) as f:
            return json.load(f)["users_per_s"]
    try:
        ups = bench_reference(data, BASELINE_SAMPLE)
    except Exception as e:
        print(f"# baseline measurement failed: {e}", file=sys.stderr)
        return None
    os.makedirs(os.path.dirname(BASELINE_CACHE), exist_ok=True)
    with open(BASELINE_CACHE, "w") as f:
        json.dump({"users_per_s": ups, "sample": BASELINE_SAMPLE,
                   "config": "64-ant OFDM, 64 subcarriers, 25 paths",
                   "source": "jmoraispk/DeepMIMO v4.0.0a3 CPU"}, f, indent=2)
    return ups


def main():
    import jax

    data = make_data(N_UE, MAX_PATHS)
    baseline = get_baseline(data)
    users_per_s, dt, n_timed, dev = bench_device(data)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"# device={dev.device_kind} ({smi}) timed_users={n_timed} "
          f"wall={dt:.4f}s baseline={baseline if baseline else 'n/a'} "
          "users/s", file=sys.stderr)
    result = {
        "metric": "users/s channel generation via dataset.compute_channels "
                  "(131k users/chunk, 64-ant OFDM, 64 subcarriers, 25 paths)",
        "value": round(users_per_s, 1),
        "unit": "users/s",
        "vs_baseline": round(users_per_s / baseline, 2) if baseline else None,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
