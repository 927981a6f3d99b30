"""Closed-loop regression gate vs the EXECUTED reference (VERDICT r1 item 1).

``tests/data/reference_golden_run.npz`` holds the full 1500-step circle run
of the actual /root/reference code (control.py + utils.py driven with
run.py:48-71 semantics, np.random.seed(0) — tools/make_reference_golden.py).
The reference consumes one ``np.random.multivariate_normal(0, 20I, (100,30))``
draw per solve (control.py:163), so the identical noise stream is regenerated
here from ``np.random.RandomState(0)`` and injected into the framework solver
(the golden-parity seam, SURVEY.md §7(c)).

Measured behaviour being pinned (see docs/PARITY_RUN.md for the full report):
the replay is bit-for-bit identical for the first ~25 plant steps, stays
inside the BASELINE <1e-3 rad gate for 100+ steps while float summation-order
noise chaos-amplifies (~×1.4/step), and remains distributionally identical
(EE tracking error, wp schedule) over the full run.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from mppi_robotarm.config import ArmParams, MPPIConfig, SimConfig
from mppi_robotarm.models.arm import fk_ee
from mppi_robotarm.mppi.solver import init_state, solve
from mppi_robotarm.sim.loop import plant_step
from mppi_robotarm.utils.metrics import tracking_errors

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "reference_golden_run.npz")


def _ee(q):
    x, y = fk_ee(q[:, 0], q[:, 1], 1.0, 1.0)
    return np.stack([np.asarray(x), np.asarray(y)], axis=1)


@pytest.fixture(scope="module")
def golden():
    if not os.path.exists(GOLDEN):
        pytest.skip("golden reference run not captured "
                    "(tools/make_reference_golden.py)")
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def replay(golden, ref_path):
    """Full-length framework replay of the reference noise stream (f64)."""
    steps = golden["q"].shape[0]
    arm, cfg, sim = ArmParams(), MPPIConfig(), SimConfig()
    rs = np.random.RandomState(int(golden["seed"]))
    sigma = np.array([[20.0, 0.0], [0.0, 20.0]])
    q = jnp.asarray(golden["x0"][:2], jnp.float64)
    dq = jnp.asarray(golden["x0"][2:], jnp.float64)
    state = init_state(cfg, dtype=jnp.float64)
    rp = jnp.asarray(ref_path)
    qs, us, wps = [], [], []
    for _ in range(steps):
        eps = rs.multivariate_normal(np.zeros(2), sigma, (100, 30))
        observed = jnp.concatenate([q, dq])
        res = solve(arm, cfg, rp, observed, state, eps=jnp.asarray(eps))
        q, dq = plant_step(arm, sim, q, dq, res.u0)
        state = res.state
        qs.append(np.asarray(q))
        us.append(np.asarray(res.u0))
        wps.append(int(state.wp_idx))
    return np.array(qs), np.array(us), np.array(wps)


def test_bitwise_prefix(golden, replay):
    """The first plant steps are bit-for-bit identical to the reference."""
    q_b, u_b, _ = replay
    qdiff = np.max(np.abs(q_b - golden["q"]), axis=1)
    exact = int(np.argmax(qdiff > 0)) if (qdiff > 0).any() else len(qdiff)
    assert exact >= 15, f"bitwise prefix only {exact} steps"


def test_baseline_gate_prefix(golden, replay):
    """<1e-3 rad step-aligned deviation (BASELINE gate) holds for >=80 steps,
    <1e-9 for >=40 — far beyond reference self-reproducibility (Q8)."""
    q_b, _, _ = replay
    qdiff = np.max(np.abs(q_b - golden["q"]), axis=1)
    tight = int(np.argmax(qdiff > 1e-9)) if (qdiff > 1e-9).any() else len(qdiff)
    gate = int(np.argmax(qdiff > 1e-3)) if (qdiff > 1e-3).any() else len(qdiff)
    assert tight >= 40, f"<1e-9 prefix only {tight} steps"
    assert gate >= 80, f"<1e-3 gate prefix only {gate} steps"


def test_wp_schedule_prefix(golden, replay):
    """The discrete waypoint schedule matches exactly for >=80 solves."""
    _, _, wp_b = replay
    eq = wp_b == golden["wp_idx"]
    first = int(np.argmin(eq)) if not eq.all() else len(eq)
    assert first >= 80, f"wp schedule diverges at step {first}"


def test_full_run_error_distribution(golden, replay, ref_path):
    """Full-run EE tracking error matches the executed reference's within
    noise-realisation spread (the BASELINE 'EE RMS tracking error parity'
    row, measured not extrapolated)."""
    steps = golden["q"].shape[0]
    q_b, _, wp_b = replay
    step_ref = np.asarray(ref_path)[1:steps + 1, 0:2]
    s_ref = tracking_errors(_ee(golden["q"]), step_ref, full_path=ref_path)
    s_rep = tracking_errors(_ee(q_b), step_ref, full_path=ref_path)
    # lag-free on-path error: like-for-like within 1.5x both ways
    ratio = s_rep["onpath_mean_m"] / s_ref["onpath_mean_m"]
    assert 1 / 1.5 < ratio < 1.5, f"on-path mean ratio {ratio:.2f}"
    # step-aligned RMS (includes schedule lag): within 1.5x
    ratio2 = s_rep["ee_rms_m"] / s_ref["ee_rms_m"]
    assert 1 / 1.5 < ratio2 < 1.5, f"step-aligned RMS ratio {ratio2:.2f}"
    # both complete the revolution: final wp indices within 5% of the path
    assert abs(int(wp_b[-1]) - int(golden["wp_idx"][-1])) < 0.05 * len(ref_path)


def test_f32_production_tracking_distribution(golden, ref_path):
    """Distributional regression gate for the f32 PRODUCTION path (r2 W2).

    The bitwise/f64 replay above covers the injected-noise seam only; this
    runs the actual production configuration — threefry noise, float32,
    scan-compiled `simulate` (PARITY_RUN.md run C) — for 2 seeds x 500
    steps and gates the lag-free on-path EE error.  Calibration: an
    earlier 8-seed sweep of this exact configuration (PARITY.md, "EE
    tracking error parity") spans 10.97-30.69 mm on-path mean over the
    full 1500-step run; a healthy 500-step prefix sits well under
    45 mm, while a semantics regression (wrong waypoint freeze, broken
    warm start, mis-scaled noise) blows through it.
    """
    import jax
    from mppi_robotarm.sim.loop import init_sim, simulate

    arm, cfg, sim = ArmParams(), MPPIConfig(), SimConfig()
    rp = jnp.asarray(ref_path, jnp.float32)
    steps = 500
    refn = np.asarray(ref_path)
    for seed in (0, 1):
        s0 = init_sim(cfg, sim, jax.random.PRNGKey(seed))
        final, rec = simulate(arm, cfg, sim, rp, s0, steps)
        assert not bool(np.asarray(rec.done)[-1])
        st = tracking_errors(np.asarray(rec.ee), refn[1:steps + 1, 0:2],
                             full_path=refn)
        onpath_mm = st["onpath_mean_m"] * 1e3
        assert np.isfinite(onpath_mm) and onpath_mm < 45.0, (seed, onpath_mm)
        # the wp schedule must advance roughly one waypoint per step
        wp_end = int(np.asarray(rec.wp_idx)[-1])
        assert 0.5 * steps < wp_end < 1.6 * steps, wp_end
