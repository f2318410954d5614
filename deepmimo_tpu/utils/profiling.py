"""Profiling and tracing subsystem: stage timers + jax.profiler integration.

The reference toolchain has no profiling beyond tqdm bars (SURVEY §5); here
tracing is first-class: hierarchical stage timers with device
synchronization, TensorBoard-compatible XLA traces, and a roofline helper
for the channel renderer.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class StageTimer:
    """Hierarchical wall-clock stage timer that waits for device work.

    JAX dispatches asynchronously, so a stage's clock stops only after
    the device arrays it produced are ready: append them to the list the
    stage yields. Usage::

        timer = StageTimer()
        with timer.stage("load"):
            ...
        with timer.stage("render") as out:
            out.append(render_channels(...))
        timer.report()
    """

    sync: bool = True
    records: List = field(default_factory=list)
    _stack: List[str] = field(default_factory=list)

    @contextlib.contextmanager
    def stage(self, name: str):
        full = "/".join(self._stack + [name])
        self._stack.append(name)
        outputs: List = []
        t0 = time.perf_counter()
        try:
            yield outputs
            if self.sync and outputs:
                import jax
                jax.block_until_ready(outputs)
        finally:
            self.records.append((full, time.perf_counter() - t0))
            self._stack.pop()

    def totals(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, dt in self.records:
            out[name] = out.get(name, 0.0) + dt
        return out

    def report(self, printer=print) -> None:
        printer("Stage timings:")
        for name, total in sorted(self.totals().items()):
            depth = name.count("/")
            printer(f"  {'  ' * depth}{name.split('/')[-1]:30s} "
                    f"{total * 1e3:10.2f} ms")


@contextlib.contextmanager
def xla_trace(logdir: str):
    """Capture a TensorBoard-compatible device trace for the block."""
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str):
    """Named region visible in XLA traces (TraceAnnotation)."""
    import jax
    with jax.profiler.TraceAnnotation(name):
        yield


def renderer_roofline(n_ue: int, n_rx_ant: int, n_tx_ant: int, n_sc: int,
                      n_paths: int, *, hbm_bytes_per_s: float,
                      flops_per_s: float,
                      n_time: int = 1) -> Dict[str, float]:
    """Speed-of-light accounting for the channel renderer on one device.

    The caller passes the device's peaks (memory bytes/s, FLOP/s).
    Returns flops, bytes, arithmetic intensity, and the compute/memory
    bound times (seconds). Complex multiply-add = 8 real flops; H output
    = complex64.
    """
    q = n_rx_ant * n_tx_ant
    flops = 8.0 * n_ue * q * n_paths * n_sc * n_time
    h_bytes = 8.0 * n_ue * q * n_sc * n_time
    in_bytes = 4.0 * n_ue * n_paths * 7
    bytes_total = h_bytes + in_bytes
    t_mem = bytes_total / hbm_bytes_per_s
    t_flop = flops / flops_per_s
    return {
        "flops": flops,
        "bytes": bytes_total,
        "intensity_flops_per_byte": flops / bytes_total,
        "t_memory_bound_s": t_mem,
        "t_compute_bound_s": t_flop,
        "t_speed_of_light_s": max(t_mem, t_flop),
        "users_per_s_sol": n_ue / max(t_mem, t_flop),
    }
