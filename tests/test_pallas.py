"""Pallas rollout kernel (ops/pallas_rollout.py) vs the XLA rollout.

On the CPU the kernel runs in interpret mode (conftest.py); the ``gpu``
tests run it compiled, on the card, through ``chip_smoke.py``.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mppi_robotarm.config import ArmParams, MPPIConfig
from mppi_robotarm.mppi.solver import init_state, solve
from mppi_robotarm.ops.noise import sigma_inverse
from mppi_robotarm.ops.pallas_rollout import block_k, rollout_costs_pallas
from mppi_robotarm.ops.rollout import rollout_costs
from mppi_robotarm.ops.waypoint import slice_window
from mppi_robotarm.sim.paths import synth_circle_path

ARM = ArmParams()
X0 = np.array([1.152198236517471885, -1.266101672070702344, 0.0, 0.0],
              np.float32)
F32 = jnp.float32


def _inputs(cfg, rng, start=0, path=None):
    path = synth_circle_path(400) if path is None else path
    t = cfg.horizon
    u = (np.tile(np.asarray(cfg.warm_start, np.float32), (t, 1))
         + rng.normal(size=(t, 2)).astype(np.float32))
    eps = (rng.normal(size=(cfg.num_samples, t, 2))
           * np.sqrt(20.0)).astype(np.float32)
    window, valid = slice_window(jnp.asarray(path, F32), start,
                                 cfg.search_idx_len)
    sinv = jnp.asarray(sigma_inverse(cfg.sigma), F32)
    return jnp.asarray(u), jnp.asarray(eps), window, valid, sinv


def _both(cfg, x0, u, eps, window, valid, sinv, k_offset=0):
    s_ref, _ = rollout_costs(ARM, cfg, x0, u, eps, window, valid, sinv,
                             k_offset=k_offset)
    s = rollout_costs_pallas(ARM, cfg, x0, u, eps, window, valid, sinv,
                             k_offset=k_offset)
    return np.asarray(s), np.asarray(s_ref)


# (K, H, W, exploration, u_clamp, window start): every K in {1, 100, 128,
# 1000, 1024}, every H in {1, 6, 30, 50}, every W in {1, 30, 80}, the
# exploration split and the clamp on and off, K both a multiple of the
# block and not, and windows truncated at the path end (start 396 of 400).
KERNEL_CASES = [
    (1, 1, 1, 0.0, None, 0),
    (1, 6, 30, 0.0, 0.8, 396),
    (100, 1, 30, 0.0, None, 0),
    (100, 6, 30, 0.3, None, 0),
    (100, 30, 80, 0.0, 0.8, 396),
    (100, 50, 1, 0.5, None, 10),
    (128, 1, 80, 0.0, None, 0),
    (128, 6, 1, 0.0, 0.8, 0),
    (128, 30, 30, 0.2, None, 396),
    (128, 50, 30, 0.0, None, 0),
    (1000, 1, 30, 0.1, 0.8, 0),
    (1000, 6, 80, 0.0, None, 396),
    (1000, 30, 30, 0.0, None, 50),
    (1000, 50, 1, 0.0, 0.8, 0),
    (1024, 1, 1, 0.0, None, 396),
    (1024, 6, 30, 0.5, 0.8, 0),
    (1024, 30, 80, 0.0, None, 0),
    (1024, 50, 30, 0.0, None, 0),
]


@pytest.mark.parametrize("k,h,w,expl,clamp,start", KERNEL_CASES)
def test_kernel_matches_rollout_costs(rng, k, h, w, expl, clamp, start):
    cfg = dataclasses.replace(MPPIConfig(), num_samples=k, horizon=h,
                              search_idx_len=w, exploration=expl,
                              u_clamp=clamp)
    u, eps, window, valid, sinv = _inputs(cfg, rng, start)
    s, s_ref = _both(cfg, jnp.asarray(X0), u, eps, window, valid, sinv)
    assert s.shape == (k,) and s.dtype == np.float32
    # same float32 arithmetic in another order (FMA contraction, the
    # scan-free loop): a few ulp of S, never a different waypoint
    np.testing.assert_allclose(s, s_ref, rtol=2e-5)


@pytest.mark.parametrize("k_offset", [0, 64, 192])
def test_kernel_exploration_split_uses_global_index(rng, k_offset):
    """Q9 under sample sharding: the exploit cutoff counts from k_offset."""
    cfg = dataclasses.replace(MPPIConfig(), num_samples=256, horizon=5,
                              exploration=0.5)
    u, eps, window, valid, sinv = _inputs(cfg, rng)
    eps = eps[:64]
    s, s_ref = _both(cfg, jnp.asarray(X0), u, eps, window, valid, sinv,
                     k_offset=k_offset)
    np.testing.assert_allclose(s, s_ref, rtol=2e-5)


def test_vmapped_kernel_matches_per_scenario(rng):
    """vmap adds a grid axis; each scenario equals its own launch."""
    cfg = dataclasses.replace(MPPIConfig(), num_samples=100, horizon=5)
    b = 3
    x0s = jnp.asarray(np.tile(X0, (b, 1))
                      + rng.normal(scale=0.01, size=(b, 4)), F32)
    u, _, window, valid, sinv = _inputs(cfg, rng)
    eps = jnp.asarray(rng.normal(size=(b, 100, 5, 2)) * 4.0, F32)
    starts = [0, 40, 396]
    wins = [slice_window(jnp.asarray(synth_circle_path(400), F32), s, 30)
            for s in starts]
    windows = jnp.stack([w for w, _ in wins])
    valids = jnp.stack([v for _, v in wins])
    sb = jax.vmap(lambda x, e, w, v: rollout_costs_pallas(
        ARM, cfg, x, u, e, w, v, sinv))(x0s, eps, windows, valids)
    for i in range(b):
        si = rollout_costs_pallas(ARM, cfg, x0s[i], u, eps[i], windows[i],
                                  valids[i], sinv)
        np.testing.assert_array_equal(np.asarray(sb[i]), np.asarray(si))


@pytest.mark.parametrize("k", [1, 31, 32, 100, 1024, 4224, 8448, 65536])
def test_block_k_picker(k):
    """A power of two in [32, 128]; small K spreads over many programs."""
    b = block_k(k)
    assert b & (b - 1) == 0 and 32 <= b <= 128
    n_programs = -(-k // b)
    if b > 32:
        # only grown once every one of the 132 SMs gets a program anyway
        assert n_programs >= 132 // 2
    assert block_k(2 * k) >= b


@pytest.mark.parametrize("k", [1, 33, 100, 129])
def test_padding_lanes_are_inert(rng, k):
    """K that is not a multiple of the block pads with zero noise; the pad
    lanes are dropped and cannot change the real ones."""
    cfg = dataclasses.replace(MPPIConfig(), num_samples=k, horizon=4)
    u, eps, window, valid, sinv = _inputs(cfg, rng)
    assert k % block_k(k)
    s = rollout_costs_pallas(ARM, cfg, jnp.asarray(X0), u, eps, window,
                             valid, sinv)
    # the same samples inside a larger, block-aligned K give the same S
    cfg_big = dataclasses.replace(cfg, num_samples=256)
    big = jnp.concatenate(
        [eps, jnp.asarray(rng.normal(size=(256 - k, 4, 2)), F32)])
    s_big = rollout_costs_pallas(ARM, cfg_big, jnp.asarray(X0), u, big,
                                 window, valid, sinv)
    assert s.shape == (k,)
    np.testing.assert_array_equal(np.asarray(s), np.asarray(s_big)[:k])


@pytest.mark.parametrize("mode", ["key", "eps"])
def test_solve_backends_agree(ref_path, rng, mode):
    """solve(backend='pallas') == solve(backend='xla') on the same noise:
    one key draws identical noise on both."""
    cfg = dataclasses.replace(MPPIConfig(), num_samples=128, horizon=12)
    ref = jnp.asarray(ref_path, F32)
    state = init_state(cfg, dtype=F32)
    if mode == "key":
        kw = dict(key=jax.random.PRNGKey(5))
    else:
        kw = dict(eps=jnp.asarray(rng.normal(size=(128, 12, 2)) * 4.0, F32))
    a = solve(ARM, cfg, ref, jnp.asarray(X0), state, backend="xla", **kw)
    b = solve(ARM, cfg, ref, jnp.asarray(X0), state, backend="pallas", **kw)
    np.testing.assert_array_equal(np.asarray(a.eps), np.asarray(b.eps))
    np.testing.assert_allclose(np.asarray(b.costs), np.asarray(a.costs),
                               rtol=2e-5)
    np.testing.assert_allclose(np.asarray(b.u_seq), np.asarray(a.u_seq),
                               atol=1e-4)
    assert int(a.state.wp_idx) == int(b.state.wp_idx)


def test_unknown_backend_raises(ref_path):
    cfg = dataclasses.replace(MPPIConfig(), num_samples=8, horizon=3)
    with pytest.raises(ValueError, match="unknown backend"):
        solve(ARM, cfg, jnp.asarray(ref_path, F32), jnp.asarray(X0),
              init_state(cfg, dtype=F32), key=jax.random.PRNGKey(0),
              backend="pallas-fused")


def _export_cuda(f, *args):
    """Lower ``f`` for CUDA on this host: the kernel compiled, not
    interpreted, down to Triton IR (its PTX compile happens on the card).
    (x64 off: jax.export recurses on weak int64 scalars under x64.)"""
    dis = [jax.export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")]
    jax.config.update("jax_enable_x64", False)
    try:
        exp = jax.export.export(jax.jit(f), platforms=["cuda"],
                                disabled_checks=dis)(*args)
    finally:
        jax.config.update("jax_enable_x64", True)
    return exp.mlir_module()


# the production shapes: K=1024/H=50, K=65536/H=50, B=4096 × K=128/H=50
@pytest.mark.parametrize("k,b", [(1024, None), (65536, None), (128, 4096)])
def test_cuda_cross_lowering(k, b):
    cfg = dataclasses.replace(MPPIConfig(), num_samples=k, horizon=50)
    sinv = jnp.asarray(sigma_inverse(cfg.sigma), F32)

    def f(x0, u, eps, window, valid):
        return rollout_costs_pallas(ARM, cfg, x0, u, eps, window, valid,
                                    sinv)

    shapes = [(4,), (50, 2), (k, 50, 2), (30, 4)]
    if b is not None:
        f = jax.vmap(f)
        shapes = [(b,) + s for s in shapes]
    args = [jax.ShapeDtypeStruct(s, F32) for s in shapes]
    args.append(jax.ShapeDtypeStruct(((b,) if b else ()) + (30,), bool))
    text = _export_cuda(f, *args)
    # one compiled launch, and nothing of the interpreted form
    assert text.count("__gpu$xla.gpu.triton") == 1
    assert "stablehlo.sine" not in text


def test_cuda_cross_lowering_closed_loop(ref_path):
    """The whole scan-compiled closed loop with the kernel inside lowers."""
    import mppi_robotarm as m
    cfg = dataclasses.replace(MPPIConfig(), num_samples=1024, horizon=50)
    sim = m.SimConfig()
    ref = jnp.asarray(ref_path, F32)

    def f(q):
        s0 = m.init_sim(cfg, sim, jax.random.PRNGKey(0))._replace(q=q)
        return m.simulate(ARM, cfg, sim, ref, s0, 4, backend="pallas")[1].q

    text = _export_cuda(f, jax.ShapeDtypeStruct((2,), F32))
    assert "__gpu$xla.gpu.triton" in text


@pytest.mark.gpu
@pytest.mark.parametrize("k,h", [(1000, 50), (65536, 50)])
def test_compiled_kernel_matches_rollout_costs(gpu, rng, k, h):
    """On the card: the compiled kernel vs the XLA rollout, K not a
    multiple of the block and at full width."""
    cfg = dataclasses.replace(MPPIConfig(), num_samples=k, horizon=h,
                              exploration=0.1)
    u, eps, window, valid, sinv = _inputs(cfg, rng, start=100,
                                          path=synth_circle_path(8000))
    s, s_ref = _both(cfg, jnp.asarray(X0), u, eps, window, valid, sinv)
    np.testing.assert_allclose(s, s_ref, rtol=1e-4)


@pytest.mark.gpu
def test_compiled_closed_loop_backends_agree(gpu):
    """On the card: 50 closed-loop steps, pallas vs xla, same keys.

    The compiled backends differ by ulps per solve (libdevice vs XLA
    transcendentals, contraction order), and the closed loop amplifies
    that (×4.6 per step, PARITY_RUN.md): the runs agree tightly at first
    and then only in shape."""
    import mppi_robotarm as m
    arm, cfg, sim = m.benchmark_preset()
    ref = jnp.asarray(m.synth_circle_path(8000), F32)
    s0 = m.init_sim(cfg, sim, jax.random.PRNGKey(0))
    _, ra = m.simulate(arm, cfg, sim, ref, s0, 50, backend="xla")
    _, rb = m.simulate(arm, cfg, sim, ref, s0, 50, backend="pallas")
    wa, wb = np.asarray(ra.wp_idx), np.asarray(rb.wp_idx)
    np.testing.assert_array_equal(wa[:10], wb[:10])
    np.testing.assert_allclose(np.asarray(rb.q[:10]), np.asarray(ra.q[:10]),
                               atol=1e-3)
    assert np.abs(wa - wb).max() <= 3, (wa, wb)
    assert np.isfinite(np.asarray(rb.q)).all()
