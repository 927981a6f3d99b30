"""Run the MPPI closed loop on the GPU through its entry points, check it,
and time it — the quickest proof that the system starts on the card.

    python chip_smoke.py          # one GPU: every phase below
    python chip_smoke.py --four   # four GPUs: the sharded paths only

One process drives the card.  Phases, each raising on failure:

1. device: a GPU or nothing; its kind, count, JAX version, and the card's
   name and power limit from ``nvidia-smi``;
2. the persistent compile cache (utils/cache.py);
3. the Pallas rollout kernel vs the XLA ``rollout_costs`` on identical
   noise at K=1024/H=50, K=65536/H=50 and B=4096 × K=128/H=50, and one full
   ``solve`` per backend;
4. the closed loop through ``cli.main`` at K=1024/H=50 for 1500 steps on
   the 8000-point circle, per backend, gated on finite states and the
   on-path error; ``simulate_batch`` at B=4096 × K=128 for 20 steps;
5. timings, each beside the card's name and power limit;
6. the ``gpu``-marked tests, in this process.

``--four`` runs BASELINE config 5 instead: ``make_sharded_solve`` on a
1×4 ('data', 'samples') mesh at K=65536/H=50 and ``make_sharded_sim_step``
on a 4×1 mesh at B=4096 × K=128/H=50, both backends, each compared with one
device on the same noise.

Tolerances.  The kernel and ``rollout_costs`` do the same float32
arithmetic in another order: libdevice's sin/cos against XLA's own, FMA
contraction chosen per compiler, and S summed in another order; a 50-step
rollout carries those ulps into S.  S may differ by 1e-4 relative.  A solve's
``u_seq`` may differ by 1e-4 absolute (rad/s² of control), a tenth of the
1e-3 control-deviation gate against the reference.  The sharded paths are
held to the same bounds: their softmax and Σwε are summed per shard first.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import argparse
import contextlib
import dataclasses
import io
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "chiprun_out", "chip_smoke")
S_RTOL = 1e-4
U_ATOL = 1e-4
ONPATH_GATE_MM = 42.0          # bench.py's on-path gate at this shape


def device_phase(want: int):
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX found "
                         f"{devs[0].platform!r}")
    if len(devs) < want:
        raise SystemExit(f"needs {want} GPUs, JAX found {len(devs)}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    card = card.strip().splitlines()[0]
    print(f"device: {devs[0].device_kind} x{len(devs)}, jax {jax.__version__}")
    print(f"card: {card}")
    return devs, card


def max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))


def check(name, ok, detail):
    print(f"{'PASS' if ok else 'FAIL'} {name}: {detail}")
    if not ok:
        raise AssertionError(f"{name}: {detail}")


def timed(fn, n):
    """Median and p90 seconds of ``n`` calls of ``fn`` after one warm call."""
    import jax
    jax.block_until_ready(fn(0))
    ts = []
    for i in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(i + 1))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), float(np.percentile(ts, 90))


def kernel_phase(m, ref):
    """Kernel S vs rollout_costs at real widths; one solve per backend."""
    import jax
    import jax.numpy as jnp
    from mppi_robotarm.ops.noise import (sample_epsilon, sigma_cholesky,
                                             sigma_inverse)
    from mppi_robotarm.ops.pallas_rollout import rollout_costs_pallas
    from mppi_robotarm.ops.rollout import rollout_costs
    from mppi_robotarm.ops.waypoint import slice_window

    arm, cfg0, _ = m.benchmark_preset()
    x0 = jnp.asarray([1.15, -1.27, 0.3, -0.2], jnp.float32)
    window, valid = slice_window(ref, 100, cfg0.search_idx_len)
    for k, b in ((1024, None), (65536, None), (128, 4096)):
        cfg = dataclasses.replace(cfg0, num_samples=k)
        u = jnp.tile(jnp.asarray(cfg.warm_start, jnp.float32),
                     (cfg.horizon, 1))
        sinv = jnp.asarray(sigma_inverse(cfg.sigma), jnp.float32)
        chol = sigma_cholesky(cfg.sigma)

        def pair(e):
            s_x, _ = rollout_costs(arm, cfg, x0, u, e, window, valid, sinv)
            s_p = rollout_costs_pallas(arm, cfg, x0, u, e, window, valid,
                                       sinv)
            return s_x, s_p

        if b is None:
            eps = sample_epsilon(jax.random.PRNGKey(k), k, cfg.horizon, chol)
            s_x, s_p = jax.jit(pair)(eps)
        else:
            keys = jax.random.split(jax.random.PRNGKey(k), b)
            eps = jax.vmap(lambda kk: sample_epsilon(
                kk, k, cfg.horizon, chol))(keys)
            s_x, s_p = jax.jit(jax.vmap(pair))(eps)
        finite = bool(np.isfinite(np.asarray(s_p)).all())
        rel = max_rel(s_p, s_x)
        absd = float(np.max(np.abs(np.asarray(s_p) - np.asarray(s_x))))
        shape = f"K={k}/H={cfg.horizon}" + (f" B={b}" if b else "")
        check(f"kernel S vs rollout_costs {shape}",
              finite and rel <= S_RTOL,
              f"max abs {absd:.6g}, max rel {rel:.3g} (bound {S_RTOL}), "
              f"finite {finite}")

    for k in (1024, 65536):
        cfg = dataclasses.replace(cfg0, num_samples=k)
        st = m.init_state(cfg)
        res = {be: m.solve(arm, cfg, ref, x0, st, key=jax.random.PRNGKey(9),
                           backend=be) for be in ("xla", "pallas")}
        du = float(np.max(np.abs(np.asarray(res["pallas"].u_seq)
                                 - np.asarray(res["xla"].u_seq))))
        check(f"solve u_seq pallas vs xla K={k}/H={cfg.horizon}",
              du <= U_ATOL and np.isfinite(du),
              f"max abs {du:.6g} (bound {U_ATOL})")


def closed_loop_phase(m, ref):
    """cli.main at K=1024/H=50 for 1500 steps per backend; fleet steps."""
    import jax
    import jax.numpy as jnp
    from mppi_robotarm import cli

    os.makedirs(OUT, exist_ok=True)
    path_file = os.path.join(OUT, "circle8000.txt")
    np.savetxt(path_file, np.asarray(ref))
    for be in ("xla", "pallas"):
        out_dir = os.path.join(OUT, f"cli_{be}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--ref-path", path_file, "--steps", "1500",
                           "--samples", "1024", "--horizon", "50",
                           "--backend", be, "--out-dir", out_dir,
                           "--metrics-every", "500"])
        summary = json.loads(buf.getvalue().strip().splitlines()[-1])
        with np.load(os.path.join(out_dir, "record.npz")) as rec:
            finite = all(bool(np.isfinite(rec[f]).all())
                         for f in ("q", "dq", "u", "ee"))
            steps = int(rec["q"].shape[0])
        onpath_mm = summary["onpath_mean_m"] * 1e3
        check(f"cli.main closed loop {be} K=1024/H=50",
              rc == 0 and finite and steps == 1500
              and onpath_mm < ONPATH_GATE_MM,
              f"{steps} steps, finite {finite}, on-path mean "
              f"{onpath_mm:.3f} mm (gate {ONPATH_GATE_MM} mm), "
              f"{summary['solves_per_s']} solves/s incl. compile")

    arm, cfg, sim = m.benchmark_preset()
    cfg = dataclasses.replace(cfg, num_samples=128)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(4096))
    states = m.init_sim_batch(cfg, sim, keys)
    for be in ("xla", "pallas"):
        final, rec = m.simulate_batch(arm, cfg, sim, ref, states, 20,
                                      backend=be)
        finite = bool(np.isfinite(np.asarray(rec.q)).all()
                      and np.isfinite(np.asarray(final.mppi.u_prev)).all())
        check(f"simulate_batch {be} B=4096 x K=128/H=50, 20 steps", finite,
              f"finite {finite}")


def timing_phase(m, ref, card):
    import jax
    import jax.numpy as jnp

    arm, cfg0, sim = m.benchmark_preset()
    x0 = jnp.asarray(sim.q0 + sim.dq0, jnp.float32)
    keys = list(jax.random.split(jax.random.PRNGKey(0), 61))
    for k in (1024, 65536):
        cfg = dataclasses.replace(cfg0, num_samples=k)
        st = m.init_state(cfg)
        for be in ("xla", "pallas"):
            def one(i, cfg=cfg, be=be):
                return m.solve(arm, cfg, ref, x0, st, key=keys[i],
                               backend=be).u0
            med, p90 = timed(one, 60)
            print(f"time solve K={k}/H=50 {be}: median {med * 1e6:.1f} us, "
                  f"p90 {p90 * 1e6:.1f} us over 60 solves [{card}]")

    s0 = m.init_sim(cfg0, sim, jax.random.PRNGKey(0))
    for be in ("xla", "pallas"):
        def loop(i, be=be):
            return m.simulate(arm, cfg0, sim, ref, s0, 4000, backend=be)[1].q
        med, _ = timed(loop, 3)
        print(f"time closed loop K=1024/H=50 {be}: {4000 / med:.1f} "
              f"solves/s (median of 3 chains of 4000 steps) [{card}]")

    cfg = dataclasses.replace(cfg0, num_samples=128)
    states = m.init_sim_batch(
        cfg, sim, jax.vmap(jax.random.PRNGKey)(jnp.arange(4096)))
    for be in ("xla", "pallas"):
        def fleet(i, be=be):
            return m.simulate_batch(arm, cfg, sim, ref, states, 20,
                                    backend=be)[1].q
        med, _ = timed(fleet, 3)
        print(f"time fleet B=4096 x K=128/H=50 {be}: "
              f"{4096 * 20 / med:.0f} scenario-solves/s (median of 3 "
              f"chains of 20 steps) [{card}]")
    peak = jax.devices()[0].memory_stats()["peak_bytes_in_use"]
    print(f"peak device memory: {peak} bytes in use [{card}]")


def gpu_tests_phase():
    import pytest
    os.environ["MPPI_TEST_GPU"] = "1"
    rc = pytest.main(["-m", "gpu", "-q", "-p", "no:cacheprovider",
                      "-p", "no:randomly", os.path.join(HERE, "tests")])
    check("gpu-marked tests", rc == 0, f"pytest exit code {int(rc)}")


def four_phase(m, ref, card):
    """BASELINE config 5 on four GPUs, each path vs one device."""
    import jax
    import jax.numpy as jnp
    from mppi_robotarm.ops.noise import sample_epsilon, sigma_cholesky
    from mppi_robotarm.parallel.mesh import make_mesh
    from mppi_robotarm.parallel.sharded import (make_sharded_sim_step,
                                                    make_sharded_solve)

    devs = jax.devices()[:4]
    arm, cfg0, sim = m.benchmark_preset()

    def spans(name, outs):
        sets = [len(o.sharding.device_set) for o in outs]
        check(f"{name} outputs span 4 devices", all(n == 4 for n in sets),
              f"device_set sizes {sets}")

    # K sharded over 'samples' on a 1x4 mesh, K=65536/H=50
    cfg = dataclasses.replace(cfg0, num_samples=65536)
    b = 2
    chol = sigma_cholesky(cfg.sigma)
    eps = jax.vmap(lambda kk: sample_epsilon(kk, cfg.num_samples,
                                             cfg.horizon, chol))(
        jax.random.split(jax.random.PRNGKey(4), b))
    obs = jnp.asarray([[1.15, -1.27, 0.0, 0.0], [1.10, -1.20, 0.3, -0.2]],
                      jnp.float32)
    u_prev = jnp.tile(jnp.asarray(cfg.warm_start, jnp.float32),
                      (b, cfg.horizon, 1))
    wp = jnp.zeros((b,), jnp.int32)
    mesh = make_mesh(data=1, samples=4, devices=devs)
    for be in ("xla", "pallas"):
        f = make_sharded_solve(arm, cfg, mesh, backend=be)
        outs = jax.block_until_ready(f(ref, obs, u_prev, wp, eps))
        spans(f"sharded solve 1x4 {be}", outs)
        for i in range(b):
            one = m.solve(arm, cfg, ref, obs[i],
                          m.MPPIState(u_prev=u_prev[i], wp_idx=wp[i]),
                          eps=eps[i], backend=be)
            du = float(np.max(np.abs(np.asarray(outs[1][i])
                                     - np.asarray(one.u_seq))))
            rel = max_rel(outs[5][i], one.costs)
            check(f"sharded solve 1x4 {be} K=65536 scenario {i} vs one "
                  f"device", du <= U_ATOL and rel <= S_RTOL,
                  f"u_seq max abs {du:.3g}, S max rel {rel:.3g}")
        med, p90 = timed(lambda i: f(ref, obs, u_prev, wp, eps)[0], 20)
        print(f"time sharded solve 1x4 {be} B={b} K=65536/H=50: median "
              f"{med * 1e6:.1f} us, p90 {p90 * 1e6:.1f} us [{card}]")

    # scenarios sharded over 'data' on a 4x1 mesh, B=4096 x K=128/H=50
    cfg = dataclasses.replace(cfg0, num_samples=128)
    b = 4096
    q = jnp.tile(jnp.asarray([sim.q0], jnp.float32), (b, 1))
    q = q + 0.01 * jax.random.normal(jax.random.PRNGKey(1), (b, 2))
    dq = jnp.zeros((b, 2), jnp.float32)
    u_prev = jnp.tile(jnp.asarray(cfg.warm_start, jnp.float32),
                      (b, cfg.horizon, 1))
    wp = jnp.zeros((b,), jnp.int32)
    keys = jax.random.key_data(jax.vmap(jax.random.PRNGKey)(
        jnp.arange(b))).astype(jnp.uint32)
    mesh4 = make_mesh(data=4, samples=1, devices=devs)
    mesh1 = make_mesh(data=1, samples=1, devices=devs[:1])
    for be in ("xla", "pallas"):
        f4 = make_sharded_sim_step(arm, cfg, sim, mesh4, backend=be)
        f1 = make_sharded_sim_step(arm, cfg, sim, mesh1, backend=be)
        outs4 = jax.block_until_ready(f4(ref, q, dq, u_prev, wp, keys))
        outs1 = jax.block_until_ready(f1(ref, q, dq, u_prev, wp, keys))
        spans(f"sharded sim step 4x1 {be}", outs4)
        dq_ = float(np.max(np.abs(np.asarray(outs4[0])
                                  - np.asarray(outs1[0]))))
        du = float(np.max(np.abs(np.asarray(outs4[2])
                                 - np.asarray(outs1[2]))))
        same_wp = bool(np.array_equal(np.asarray(outs4[3]),
                                      np.asarray(outs1[3])))
        check(f"sharded sim step 4x1 {be} B=4096 x K=128 vs one device",
              du <= U_ATOL and dq_ <= U_ATOL and same_wp,
              f"q max abs {dq_:.3g}, u_prev max abs {du:.3g}, "
              f"wp_idx equal {same_wp}")
        for name, fn in (("4 devices", f4), ("1 device", f1)):
            med, _ = timed(lambda i, fn=fn: fn(ref, q, dq, u_prev, wp,
                                               keys)[0], 20)
            print(f"time sharded sim step {be} B=4096 x K=128/H=50 on "
                  f"{name}: {b / med:.0f} scenario-solves/s [{card}]")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run the four-GPU sharded paths (BASELINE config 5) "
                        "and nothing else")
    args = p.parse_args(argv)
    n_dev = 4 if args.four else 1

    devs, card = device_phase(n_dev)

    import jax.numpy as jnp
    import mppi_robotarm as m
    from mppi_robotarm.utils.cache import enable_persistent_cache

    print(f"compile cache: {enable_persistent_cache()}")
    ref = jnp.asarray(m.synth_circle_path(8000), jnp.float32)
    t0 = time.perf_counter()
    if args.four:
        four_phase(m, ref, card)
    else:
        kernel_phase(m, ref)
        closed_loop_phase(m, ref)
        timing_phase(m, ref, card)
        gpu_tests_phase()
    check("matplotlib never imported", "matplotlib" not in sys.modules,
          "the main path and the card tests need no plotting")
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s [{card}]")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
