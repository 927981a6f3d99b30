"""Configuration system for the MPPI engine.

The reference (junofficial/mppi_RobotArm) hardcodes all constants:
physical parameters in ``sys_params.py:1-13``, MPPI hyperparameters in the
``MPPIControllerForPathTracking`` ctor defaults (control.py:21-35) and the
``run.py:25-37`` call site, and sim constants at run.py:9-11.  Here every
knob is a field of a frozen (hashable, jit-static) dataclass, with the
reference's run.py values captured as the ``circle_tracking`` preset.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

Matrix2 = Tuple[Tuple[float, float], Tuple[float, float]]
Vec4 = Tuple[float, float, float, float]


@dataclasses.dataclass(frozen=True)
class ArmParams:
    """Physical constants of the 2-link planar arm (reference sys_params.py:1-13).

    Note the reference's inertia matrix adds the raw link *lengths* l1/l2 to
    the diagonal terms (control.py:241-245, utils.py:15-19) — physically these
    read like link rotational inertias written as lengths.  We replicate this
    exactly (SURVEY.md quirk Q1); both plant and controller model share it, so
    the system is self-consistent.
    """

    Ts: float = 0.0025
    m1: float = 1.0
    m2: float = 1.0
    l1: float = 1.0
    l2: float = 1.0
    lc1: float = 0.5
    lc2: float = 0.5
    g: float = 9.81


@dataclasses.dataclass(frozen=True)
class MPPIConfig:
    """MPPI solver hyperparameters (reference control.py:21-65, run.py:25-37).

    All fields are hashable so the config can be a jit static argument.
    ``sigma`` and cost weights are stored as nested tuples; convert with
    :func:`sigma_array` etc. at trace time.
    """

    horizon: int = 30                      # T, run.py:28
    num_samples: int = 100                 # K, run.py:29
    exploration: float = 0.0               # run.py:30, control.py:98 split (Q9)
    lam: float = 100.0                     # temperature λ, run.py:31
    alpha: float = 0.98                    # run.py:32; γ = λ(1−α) (control.py:45)
    sigma: Matrix2 = ((20.0, 0.0), (0.0, 20.0))          # run.py:33
    stage_cost_weight: Vec4 = (0.50, 0.50, 5.0, 5.0)     # run.py:34
    terminal_cost_weight: Vec4 = (5.0, 5.0, 50.0, 50.0)  # run.py:35
    delta_t: float = 0.006                 # controller-model dt = 2×plant dt (Q2)
    # Cost scaling quirks (Q7): stage/terminal ×10000 (control.py:185,198),
    # waypoint distance metric ×100 (control.py:212).
    cost_scale: float = 10000.0
    dist_scale: float = 100.0
    # Windowed nearest-waypoint search length (control.py:203, Q5).
    search_idx_len: int = 30
    # Median filter window over the horizon axis (control.py:122, Q10).
    filter_window: int = 10
    # Input clamp (Q11): reference `_g` is a disabled clip at ±0.8
    # (control.py:170-171).  None keeps the reference no-op behaviour.
    u_clamp: Optional[float] = None
    # Warm start u_prev fill (control.py:59).
    warm_start: Tuple[float, float] = (10.0, -2.0)
    # Arm link lengths used by the *cost* FK; the reference controller
    # hardcodes 1.0 (control.py:55-56) independent of sys_params.
    l1: float = 1.0
    l2: float = 1.0

    @property
    def gamma(self) -> float:
        """γ = λ(1−α), control.py:45."""
        return self.lam * (1.0 - self.alpha)

    def validate(self) -> None:
        """Precondition checks mirroring control.py:157-159."""
        s = self.sigma
        if len(s) != 2 or any(len(row) != 2 for row in s):
            raise ValueError(
                "sigma must be a square matrix with the size of dim_u (=2)"
            )
        if self.horizon < 1 or self.num_samples < 1:
            raise ValueError("horizon and num_samples must be >= 1")
        if self.filter_window < 1:
            raise ValueError("filter_window must be >= 1")


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Closed-loop simulator constants (reference run.py:9-16)."""

    dt: float = 0.003                     # plant integration step, run.py:10
    num_steps: int = 1500                 # run.py:11
    q0: Tuple[float, float] = (1.152198236517471885, -1.266101672070702344)
    dq0: Tuple[float, float] = (0.0, 0.0)
    # Optional constant disturbance torque on the plant.  The reference
    # declares `isDesturbance = 0` (run.py:16) but never uses it; we implement
    # it as an injectable plant disturbance (SURVEY.md §5.3).
    disturbance: Tuple[float, float] = (0.0, 0.0)


def circle_tracking_preset() -> Tuple[ArmParams, MPPIConfig, SimConfig]:
    """The exact run.py:25-37 configuration (K=100, T=30, circle path)."""
    return ArmParams(), MPPIConfig(), SimConfig()


def benchmark_preset() -> Tuple[ArmParams, MPPIConfig, SimConfig]:
    """BASELINE.json north-star shape: K=1024, H=50."""
    return (
        ArmParams(),
        dataclasses.replace(MPPIConfig(), horizon=50, num_samples=1024),
        SimConfig(),
    )


def high_accuracy_preset() -> Tuple[ArmParams, MPPIConfig, SimConfig]:
    """K=1024, H=50 with the controller model's timestep matched to the
    plant (delta_t = 0.003 instead of the reference's 0.006, quirk Q2).

    The reference's 2x-coarser internal integrator is the dominant tracking
    error source at long horizons: the Q2 mismatch compounds over the
    lookahead, measured at 12.6 mm mean on-path EE error (seeds 7.0-17.9)
    for the parity semantics vs **6.1 mm (2.8-7.8)** with this preset —
    better than every measured H=30 configuration — at identical compute
    cost (docs/PARITY_RUN.md, round-4 mechanism isolation).  Use this when
    tracking quality matters more than reference parity; the benchmark and
    parity suites keep Q2.
    """
    return (
        ArmParams(),
        dataclasses.replace(MPPIConfig(), horizon=50, num_samples=1024,
                            delta_t=0.003),
        SimConfig(),
    )


# ---------------------------------------------------------------------------
# JSON round-trip (SURVEY.md §5.6: config loadable from CLI/JSON)
# ---------------------------------------------------------------------------

def _tuplify(x):
    if isinstance(x, list):
        return tuple(_tuplify(v) for v in x)
    return x


def config_to_json(arm: ArmParams, mppi: MPPIConfig, sim: SimConfig) -> str:
    return json.dumps(
        {
            "arm": dataclasses.asdict(arm),
            "mppi": dataclasses.asdict(mppi),
            "sim": dataclasses.asdict(sim),
        },
        indent=2,
    )


def config_from_json(text: str) -> Tuple[ArmParams, MPPIConfig, SimConfig]:
    raw = json.loads(text)
    arm = ArmParams(**{k: _tuplify(v) for k, v in raw.get("arm", {}).items()})
    mppi = MPPIConfig(**{k: _tuplify(v) for k, v in raw.get("mppi", {}).items()})
    sim = SimConfig(**{k: _tuplify(v) for k, v in raw.get("sim", {}).items()})
    mppi.validate()
    return arm, mppi, sim
