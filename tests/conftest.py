"""Test configuration: force an 8-device virtual CPU platform.

Tests exercise multi-chip sharding on a host-emulated mesh; tests marked
``gpu`` skip here and run on the card from chip_smoke.py.

The CPU platform is forced through jax.config before any device query
(the virtual device count can only be set before backends initialize).
"""

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
# float64 available for high-precision parity tests (f32 remains default)
jax.config.update("jax_enable_x64", True)
