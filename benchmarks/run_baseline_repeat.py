"""Re-measure the reference CPU generator baseline: >=3 repeats, 2k users.

The headline vs_baseline multiplier in bench.py divides by this number, so
it gets a multi-repeat measurement at a sample size large enough to
amortize the reference's per-call setup (VERDICT r3 ask #7; round-2 cache
was a single 384-user run). Refreshes benchmarks/baseline_reference.json
(mean users/s + spread). CPU-only: it never opens the GPU.

    python benchmarks/run_baseline_repeat.py
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "benchmarks", "baseline_reference.json")

N_SAMPLE = 2048
N_REPEAT = 3

# Same synthetic workload as bench.py (64-ant OFDM headline config).
from bench import make_data, BS_SHAPE, UE_SHAPE, N_FFT, SEL_SC, \
    BANDWIDTH, MAX_PATHS  # noqa: E402


def main():
    sys.path.insert(0, "/root/reference")
    import importlib
    for mod in list(sys.modules):
        if mod == "deepmimo" or mod.startswith("deepmimo."):
            del sys.modules[mod]
    deepmimo = importlib.import_module("deepmimo")
    from deepmimo.generator.dataset import Dataset as RefDataset
    from deepmimo.generator.channel import ChannelGenParameters as RefParams

    data = make_data(N_SAMPLE, MAX_PATHS)
    ds_dict = {
        "power": data["power"], "phase": data["phase"],
        "delay": data["delay"],
        "aoa_az": data["aoa_az"], "aoa_el": data["aoa_el"],
        "aod_az": data["aod_az"], "aod_el": data["aod_el"],
        "rx_pos": np.zeros((N_SAMPLE, 3), dtype=np.float32),
        "tx_pos": np.zeros((1, 3), dtype=np.float32),
    }

    def params():
        p = RefParams()
        p["bs_antenna"]["shape"] = np.array(BS_SHAPE)
        p["ue_antenna"]["shape"] = np.array(UE_SHAPE)
        p["ofdm"]["subcarriers"] = N_FFT
        p["ofdm"]["selected_subcarriers"] = np.array(SEL_SC)
        p["ofdm"]["bandwidth"] = BANDWIDTH
        p["num_paths"] = MAX_PATHS
        return p

    rates = []
    for i in range(N_REPEAT):
        ds = RefDataset(dict(ds_dict))     # fresh dataset: no memoization
        t0 = time.perf_counter()
        ds.compute_channels(params())
        dt = time.perf_counter() - t0
        rates.append(N_SAMPLE / dt)
        print(f"repeat {i + 1}/{N_REPEAT}: {dt:.2f}s -> "
              f"{rates[-1]:.1f} users/s", flush=True)

    mean = float(np.mean(rates))
    out = {
        "users_per_s": mean,
        "users_per_s_runs": [round(r, 1) for r in rates],
        "spread_pct": round(100 * (max(rates) - min(rates)) / mean, 1),
        "sample": N_SAMPLE,
        "repeats": N_REPEAT,
        "config": "64-ant OFDM, 64 subcarriers, 25 paths",
        "source": "jmoraispk/DeepMIMO v4.0.0a3 CPU (this machine)",
        "version": str(getattr(deepmimo, "__version__", "unknown")),
    }
    with open(OUT, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
