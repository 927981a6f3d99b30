"""CLI sample-trajectory renderer (reference C20) + animation smoke test."""

import os

import numpy as np


def test_cli_render_step(tmp_path):
    from mppi_robotarm.cli import main
    out = os.path.join(tmp_path, "out")
    rc = main(["--steps", "5", "--samples", "16", "--horizon", "6",
               "--out-dir", out, "--render-step", "3"])
    assert rc == 0
    assert os.path.exists(os.path.join(out, "sampled_step3.png"))


def test_animation_smoke():
    from mppi_robotarm.utils.plotting import animate_arm
    q_seq = np.stack([np.linspace(0, 1, 10), np.linspace(-1, 0, 10)], axis=1)
    anim = animate_arm(q_seq)
    # draw the first frame
    anim._init_draw()
    anim._draw_frame(0)
    import matplotlib.pyplot as plt
    plt.close("all")


def test_animation_frame_content():
    """C22 with teeth (round-3 VERDICT item 7): every frame's link artists
    must carry the FK of that frame's joint angles (reference
    visualize.py:17-31 draws [0,x1] / [x1,x2] per frame with l1=l2=1) —
    a broken artist-update function fails here, not just a crash."""
    from mppi_robotarm.config import ArmParams
    from mppi_robotarm.models.arm import fk_full
    from mppi_robotarm.utils.plotting import animate_arm

    rng = np.random.default_rng(3)
    q_seq = rng.uniform(-np.pi, np.pi, size=(7, 2))
    anim = animate_arm(q_seq)
    frames = list(anim.new_frame_seq())
    assert len(frames) == len(q_seq)

    arm = ArmParams()   # l1 = l2 = 1, as visualize.py hardcodes
    anim._init_draw()
    for i in frames:
        link1, link2 = anim._func(i)
        x1, y1, x2, y2 = (np.asarray(v) for v in
                          fk_full(q_seq[i, 0], q_seq[i, 1], arm))
        np.testing.assert_allclose(link1.get_xydata(),
                                   [[0.0, 0.0], [x1, y1]], atol=1e-12)
        np.testing.assert_allclose(link2.get_xydata(),
                                   [[x1, y1], [x2, y2]], atol=1e-12)
    import matplotlib.pyplot as plt
    plt.close("all")


def test_multihost_init_noop():
    """initialize_multihost is safely a no-op on a single-process CPU run."""
    from mppi_robotarm.parallel.mesh import initialize_multihost
    initialize_multihost()  # must not raise


def test_cli_batch_mode(tmp_path):
    import json
    import os
    import contextlib
    import io
    from mppi_robotarm.cli import main
    out = os.path.join(tmp_path, "b")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["--steps", "4", "--samples", "16", "--horizon", "6",
                   "--batch", "3", "--out-dir", out])
    assert rc == 0
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert summary["batch"] == 3 and summary["steps"] == 4
    assert os.path.exists(os.path.join(out, "batch_record.npz"))


def test_cli_backend_guards():
    import pytest
    from mppi_robotarm.cli import main
    with pytest.raises(SystemExit, match="checkpoint-every"):
        main(["--steps", "4", "--samples", "16", "--horizon", "6",
              "--batch", "2", "--checkpoint-every", "2"])
    # the whole-loop kernel backend is gone: argparse refuses it
    with pytest.raises(SystemExit):
        main(["--steps", "4", "--backend", "pallas-fused"])


def test_cli_pallas_backend(tmp_path):
    """The CLI's closed loop through the rollout kernel, with checkpoints."""
    import contextlib
    import io
    import json
    from mppi_robotarm.cli import main
    buf = io.StringIO()
    ckpt = os.path.join(tmp_path, "ck.npz")
    with contextlib.redirect_stdout(buf):
        rc = main(["--steps", "6", "--samples", "40", "--horizon", "5",
                   "--backend", "pallas", "--checkpoint", ckpt,
                   "--checkpoint-every", "3"])
    assert rc == 0 and os.path.exists(ckpt)
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert summary["backend"] == "pallas" and summary["steps"] == 6
    assert np.isfinite(summary["onpath_mean_m"])
