"""Command-line driver — the replacement for reference run.py.

Runs the scan-compiled closed-loop tracking simulation, prints structured
metrics, optionally saves the reference-parity figures and checkpoints.

    python -m mppi_robotarm.cli --ref-path xydq_circle.txt --steps 1500 \
        --out-dir results/ --figures

Configs load from JSON (--config) on top of the circle-tracking preset;
individual flags override.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mppi_robotarm",
        description="MPPI path tracking for the 2-link arm",
    )
    p.add_argument("--ref-path", default=None,
                   help="4/6-col path file; default: synthesised circle")
    p.add_argument("--config", default=None, help="JSON config file")
    p.add_argument("--steps", type=int, default=None,
                   help="closed-loop steps (default from SimConfig: 1500)")
    p.add_argument("--samples", type=int, default=None, help="K")
    p.add_argument("--horizon", type=int, default=None, help="T")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backend", choices=("xla", "pallas"), default="xla",
                   help="rollout as an XLA scan, or as one Pallas kernel "
                        "per solve (GPU)")
    p.add_argument("--out-dir", default=None,
                   help="save records (.npz), metrics (.json), figures")
    p.add_argument("--figures", action="store_true",
                   help="write reference-parity result figures")
    p.add_argument("--checkpoint", default=None,
                   help="resume from this checkpoint; also saved at the end")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="periodic checkpoint cadence in steps (0 = off)")
    p.add_argument("--profile-dir", default=None,
                   help="capture a jax.profiler trace into this dir")
    p.add_argument("--metrics-every", type=int, default=100)
    p.add_argument("--batch", type=int, default=0,
                   help="run B parallel scenarios (initial states jittered "
                        "per scenario); saves all scenarios' records; "
                        "--figures draws scenario 0; --checkpoint saves the "
                        "final batched state; --checkpoint-every and "
                        "--render-step are not supported in batch mode")
    p.add_argument("--render-step", type=int, default=None,
                   help="after the run, render the sampled/optimal "
                        "trajectories at this recorded step (the reference's "
                        "run.py:73-118 per-step figure); requires --out-dir")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import jax
    import jax.numpy as jnp
    from .utils.cache import enable_persistent_cache
    enable_persistent_cache()
    from . import config as cfg_mod
    from .sim.loop import init_sim, simulate
    from .sim.paths import load_ref_path, synth_circle_path
    from .utils.checkpoint import load_checkpoint, save_checkpoint
    from .utils.metrics import MetricsLogger, tracking_errors
    from .utils.timing import trace

    if args.config:
        with open(args.config) as f:
            arm, mppi, sim = cfg_mod.config_from_json(f.read())
    else:
        arm, mppi, sim = cfg_mod.circle_tracking_preset()
    if args.samples:
        mppi = dataclasses.replace(mppi, num_samples=args.samples)
    if args.horizon:
        mppi = dataclasses.replace(mppi, horizon=args.horizon)
    steps = args.steps if args.steps is not None else sim.num_steps

    ref = (load_ref_path(args.ref_path) if args.ref_path
           else synth_circle_path(max(2000, steps + mppi.search_idx_len + 2)))
    ref_j = jnp.asarray(ref)

    if args.batch > 0:
        from .sim.loop import init_sim_batch, simulate_batch

        # fail loudly on flags the batch branch cannot honour rather than
        # silently ignoring them after an expensive run
        if args.checkpoint_every > 0:
            raise SystemExit("--checkpoint-every is not supported with "
                             "--batch (use --checkpoint for a final save)")
        if args.render_step is not None:
            raise SystemExit("--render-step is not supported with --batch")
        keys = jax.vmap(jax.random.PRNGKey)(
            jnp.arange(args.seed, args.seed + args.batch))
        q0 = (jnp.asarray([sim.q0], jnp.float32)
              + 0.01 * jax.random.normal(jax.random.PRNGKey(args.seed + 1),
                                         (args.batch, 2)))
        states = init_sim_batch(mppi, sim, keys, q0=q0)
        t0 = time.perf_counter()
        final, recb = simulate_batch(arm, mppi, sim, ref_j, states, steps,
                                     backend=args.backend)
        jax.block_until_ready(recb.q)
        wall = time.perf_counter() - t0
        ee_last = np.asarray(recb.ee[-1])
        err = np.linalg.norm(
            ee_last - ref[min(steps, ref.shape[0] - 1), 0:2], axis=-1)
        print(json.dumps({
            "batch": args.batch, "steps": steps, "K": mppi.num_samples,
            "T": mppi.horizon, "backend": args.backend,
            "wall_s": round(wall, 3),
            "scenario_solves_per_s": round(args.batch * steps / wall, 1),
            "ee_median_m": round(float(np.median(err)), 6),
            "ee_p95_m": round(float(np.percentile(err, 95)), 6),
        }))
        if args.out_dir:
            os.makedirs(args.out_dir, exist_ok=True)
            np.savez(os.path.join(args.out_dir, "batch_record.npz"),
                     **{f: np.asarray(getattr(recb, f))
                        for f in recb._fields})
            if args.figures:
                from .utils.plotting import plot_results
                # scenario 0's view of the (steps, B, ...) record arrays
                rec0 = type(recb)(*(np.asarray(v)[:, 0] for v in recb))
                fig1, fig2 = plot_results(rec0, ref)
                fig1.savefig(os.path.join(args.out_dir,
                                          "figure1_tracking.png"), dpi=150)
                fig2.savefig(os.path.join(args.out_dir,
                                          "figure2_controls.png"), dpi=150)
        if args.checkpoint:
            from .utils.checkpoint import save_checkpoint as _save
            _save(args.checkpoint, final)
        return 0

    if args.checkpoint and os.path.exists(args.checkpoint):
        state = load_checkpoint(args.checkpoint)
        print(f"resumed from {args.checkpoint} at step {int(state.step)}",
              file=sys.stderr)
    else:
        state = init_sim(mppi, sim, jax.random.PRNGKey(args.seed))
    state0 = state                     # kept for --render-step replay

    logger = MetricsLogger(every=args.metrics_every)
    t0 = time.perf_counter()
    with trace(args.profile_dir):
        if args.checkpoint_every > 0:
            rec_parts = []
            done_steps = 0
            while done_steps < steps:
                chunk = min(args.checkpoint_every, steps - done_steps)
                state, rec = simulate(arm, mppi, sim, ref_j, state, chunk,
                                      backend=args.backend)
                jax.block_until_ready(rec.q)
                rec_parts.append(rec)
                done_steps += chunk
                if args.checkpoint:
                    save_checkpoint(args.checkpoint, state)
            rec = jax.tree.map(
                lambda *xs: jnp.concatenate(xs, axis=0), *rec_parts)
        else:
            state, rec = simulate(arm, mppi, sim, ref_j, state, steps,
                                  backend=args.backend)
            jax.block_until_ready(rec.q)
    wall = time.perf_counter() - t0

    # clamp the comparison window to the path length: a user-supplied
    # --ref-path shorter than steps+1 rows must not crash the error calc
    # after the whole simulation completed
    usable = min(steps, ref.shape[0] - 1)
    errs = tracking_errors(np.asarray(rec.ee)[:usable],
                           ref[1:usable + 1, 0:2], full_path=ref)
    summary = {
        "steps": steps, "K": mppi.num_samples, "T": mppi.horizon,
        "backend": args.backend,
        "wall_s": round(wall, 3),
        "solves_per_s": round(steps / wall, 1),
        **{k: round(v, 6) for k, v in errs.items()},
        "final_wp_idx": int(state.mppi.wp_idx),
        "path_end": bool(state.done),
    }
    logger.log_record(rec, stride=args.metrics_every)
    print(json.dumps(summary))

    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        np.savez(os.path.join(args.out_dir, "record.npz"),
                 **{f: np.asarray(getattr(rec, f)) for f in rec._fields})
        with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
        if args.figures:
            from .utils.plotting import plot_results
            fig1, fig2 = plot_results(rec, ref)
            fig1.savefig(os.path.join(args.out_dir, "figure1_tracking.png"),
                         dpi=150)
            fig2.savefig(os.path.join(args.out_dir, "figure2_controls.png"),
                         dpi=150)
        if args.render_step is not None:
            from .mppi.solver import solve, viz_rollouts
            from .utils.plotting import plot_sampled_trajectories
            i = min(args.render_step, steps - 1)
            # Recover the EXACT solver state entering step i by replaying
            # the scan from the run's initial state, then re-issue step i's
            # solve with the key the driver split there — the rendered
            # rollouts are the ones the recorded run actually used.
            state_i = state0
            if i > 0:
                state_i, _ = simulate(arm, mppi, sim, ref_j, state0, i,
                                      backend=args.backend)
            _, sub = jax.random.split(state_i.key)
            obs = jnp.concatenate([state_i.q, state_i.dq])
            res = solve(arm, mppi, ref_j, obs, state_i.mppi, key=sub,
                        backend=args.backend)
            viz = viz_rollouts(arm, mppi, obs, res.u_seq,
                               state_i.mppi.u_prev, res.eps, res.costs)
            fig = plot_sampled_trajectories(
                obs[:2], viz.sampled_trajs, viz.optimal_traj, ref,
                viz.sorted_idx)
            fig.savefig(os.path.join(args.out_dir,
                                     f"sampled_step{i}.png"), dpi=150)
    if args.checkpoint:
        save_checkpoint(args.checkpoint, state)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
