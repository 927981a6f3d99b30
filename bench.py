"""Headline benchmark: closed-loop MPPI solves/s on one GPU at the
north-star shape.

Runs the scan-compiled closed-loop simulator (one solve of K=1024 samples
over an H=50 horizon plus one plant step per iteration) for 4000 steps on
the 8000-point synthesised circle, for both rollout backends ('xla' and the
Pallas kernel 'pallas'), and reports steady-state solves/s: the median of
three timed chains after a compile-and-warm-up chain, each ending in
``block_until_ready``.  Refuses to run without a GPU.

Baseline: the reference implementation measured ~199 ms/solve at K=100,T=30
on one CPU core and scales ~linearly in K·T ⇒ ~7.0 s/solve at K=1024,H=50
(BASELINE.md) ⇒ 0.143 solves/s.

Quality is gated on the same runs: the on-path (lag-free) end-effector
error over the first 1500 live steps must stay under 42 mm, and the
``high_accuracy_preset`` run (controller dt matched to the plant) under
18 mm — both gates calibrated from earlier 8-seed sweeps at this shape
(docs/PARITY_RUN.md).

Prints ONE JSON line: the metric, its value (the kernel backend), the xla
backend's value, both tracking errors, and the device.
"""

import json
import statistics
import sys
import time

import numpy as np


REFERENCE_SOLVES_PER_S = 1.0 / 6.96  # extrapolated reference @ K=1024, H=50
STEPS = 4000
ONPATH_GATE_MM = 42.0
HA_GATE_MM = 18.0


def onpath_mean_mm(rec, path_xy):
    """Mean min-distance (mm) to the path over the first 1500 live steps."""
    ee = np.asarray(rec.ee)[~np.asarray(rec.done)][:1500]
    assert len(ee) >= 1000, len(ee)
    d = np.empty(len(ee))
    for i in range(0, len(ee), 256):
        d[i:i + 256] = np.linalg.norm(
            ee[i:i + 256, None, :] - path_xy[None], axis=-1).min(axis=1)
    return float(d.mean() * 1e3)


def main() -> None:
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {dev.platform!r}")

    from mppi_robotarm.utils.cache import enable_persistent_cache
    enable_persistent_cache()
    from mppi_robotarm import (benchmark_preset, high_accuracy_preset,
                                   init_sim, simulate, synth_circle_path)

    ref_path = jnp.asarray(synth_circle_path(8000))
    path_xy = np.asarray(ref_path)[:, 0:2]

    def chain(preset, backend):
        arm, cfg, sim = preset()
        state0 = init_sim(cfg, sim, jax.random.PRNGKey(0))
        run = lambda: simulate(arm, cfg, sim, ref_path, state0, STEPS,
                               backend=backend)
        out = jax.block_until_ready(run())          # compile + warm-up
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(run())
            times.append(time.perf_counter() - t0)
        return STEPS / statistics.median(times), out[1]

    rates, errs = {}, {}
    for backend in ("pallas", "xla"):
        rates[backend], rec = chain(benchmark_preset, backend)
        errs[backend] = onpath_mean_mm(rec, path_xy)
        print(f"# {backend}: {rates[backend]:.1f} solves/s, on-path "
              f"{errs[backend]:.2f} mm", file=sys.stderr)
        assert errs[backend] < ONPATH_GATE_MM, (backend, errs[backend])
    _, rec_h = chain(high_accuracy_preset, "pallas")
    ha_mm = onpath_mean_mm(rec_h, path_xy)
    assert ha_mm < HA_GATE_MM, ha_mm

    print(json.dumps({
        "metric": "mppi_solves_per_s_K1024_H50",
        "value": round(rates["pallas"], 2),
        "unit": "solves/s",
        "backend": "pallas",
        "xla_value": round(rates["xla"], 2),
        "vs_baseline": round(rates["pallas"] / REFERENCE_SOLVES_PER_S, 1),
        "on_path_mean_mm": round(errs["pallas"], 2),
        "high_accuracy_on_path_mean_mm": round(ha_mm, 2),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
