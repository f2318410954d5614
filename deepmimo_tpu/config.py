"""Global configuration singleton.

Environment-level settings (scenario folder locations, ray-tracer versions,
device preferences). Mirrors the capability of the reference config singleton
(reference deepmimo/config.py:36-165) with compute additions: dtype, path-sum
precision, default mesh axis names, streaming budgets.

Usage::

    from deepmimo_tpu import config
    config.set('scenarios_folder', '/data/scenarios')
    folder = config.get('scenarios_folder')
    config('scenarios_folder')            # also supported (callable get)
    config('scenarios_folder', '/data')   # callable set
    config.print_config()
"""

from __future__ import annotations

from typing import Any, Optional

from . import consts as c


class DeepMIMOConfig:
    """Singleton holding global configuration parameters."""

    _instance: Optional["DeepMIMOConfig"] = None

    _DEFAULTS = {
        # Ray tracer defaults used when writing scenarios
        "wireless_insite_version": c.RAYTRACER_VERSION_WIRELESS_INSITE,
        "sionna_version": c.RAYTRACER_VERSION_SIONNA,
        "aodt_version": c.RAYTRACER_VERSION_AODT,
        # Scenario storage
        "scenarios_folder": c.SCENARIOS_FOLDER,
        # Compute settings
        "use_gpu": False,                 # kept for API parity; unused
        "compute_dtype": "complex64",     # channel output dtype
        "planes_layout": "packed",        # H plane layout: packed|stacked
        # Path-sum precision: "float32" = full float32 products in XLA and
        # three TF32 passes in the fused kernel, "bfloat16" = bf16
        # operands, "highest" = full float32 everywhere. With "float32",
        # max |dH| / max |H| against the float64 oracle at asu-campus scale
        # on an H100 is 1.4e-5 to 2.0e-5 through the kernel and through the
        # plain XLA path alike (float32 phases of ~300 rad bound both);
        # chip_smoke.py holds both to 5e-5.
        "matmul_dtype": "float32",
        # Planes-renderer output precision: "bfloat16" halves H's output
        # bytes (~2^-8 relative rounding) — a serving mode for NN
        # consumers. The canonical complex outputs and parity tests stay
        # float32.
        "planes_out_dtype": "float32",
        "user_block": 16384,              # users per block when streaming to host
        # compute_channels renders in ONE dispatch when the output tensor
        # fits this budget (bytes); larger outputs stream over user_block
        # blocks with readback overlapped against compute. None derives
        # it from the device's memory (generator.dataset.output_budget).
        "max_device_output_bytes": None,
        # Host-memory cap for the [n_ue, M_rx, M_tx, n_paths] array
        # response product presentation attribute (it is inherently
        # O(users x antennas^2 x paths); above this it raises with
        # guidance instead of OOMing the host).
        "max_array_product_bytes": 4 << 30,
        "mesh_axis_users": "users",       # mesh axis name for user sharding
        "mesh_axis_tile": "tile",         # mesh axis name for subcarrier/antenna tiles
        "validate_parity": False,         # run f64 CPU parity checks when possible
        "checkpoint_dir": None,           # persist rendered blocks for resume
        # API endpoint (scenario database)
        "api_endpoint": "https://dev.deepmimo.net",
    }

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance._data = dict(cls._DEFAULTS)
        return cls._instance

    # -- dict-style interface -------------------------------------------------
    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def set(self, key: str, value: Any) -> None:
        if key not in self._data:
            raise KeyError(
                f"Unknown config key '{key}'. Valid keys: {sorted(self._data)}")
        self._data[key] = value

    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self.set(key, value)

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    # -- callable interface ---------------------------------------------------
    def __call__(self, key: Optional[str] = None, value: Any = None) -> Any:
        """config() prints; config(key) gets; config(key, value) sets."""
        if key is None:
            self.print_config()
            return None
        if value is None:
            return self.get(key)
        self.set(key, value)
        return None

    def reset(self) -> None:
        """Restore all settings to their defaults."""
        self._data = dict(self._DEFAULTS)

    def print_config(self) -> None:
        print("DeepMIMO configuration:")
        for k in sorted(self._data):
            print(f"  {k}: {self._data[k]}")

    def __repr__(self) -> str:
        return f"DeepMIMOConfig({self._data})"


config = DeepMIMOConfig()
