"""The port's graft entry points (isogs_slam_tpu_torch/graft_entry.py)
against the root __graft_entry__.py: entry()'s mapping loss against the
JAX function's on the same scene and the same iso sample, and the
multi-device dry run on two gloo ranks on the CPU."""
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from isogs_slam_tpu_torch import graft_entry

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT = 180   # seconds; the ranks are killed and the test fails


def test_entry_loss_matches_reference():
    """entry()'s loss on the CPU within 1e-5 relative of the jitted JAX
    entry's. The JAX fn draws its iso query rows from PRNGKey(0) (a
    uniform score per row, the smallest first: iso_loss.py's random alive
    subset); the same rows go to the port through iso_sel. Unaided, the
    port draws from its own torch.Generator: finite, not the same rows."""
    jfn, jargs = jax_entry.entry()
    ref = float(jax.jit(jfn)(*jargs))
    key, alive_rows = jargs[-1], jargs[0].shape[0]
    scores = jax.random.uniform(key, (alive_rows,))
    sel = np.array(jax.lax.top_k(-scores, 256)[1])

    fn, args = graft_entry.entry(device="cpu")
    for a, b in zip(args[:-1], jargs[:-1]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = float(fn(*args, iso_sel=torch.tensor(sel).long()))
    assert abs(got - ref) <= 1e-5 * abs(ref), (got, ref)
    assert np.isfinite(float(fn(*args)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_dryrun_multichip_two_ranks():
    """dryrun_multichip(2) as two gloo ranks on the CPU (the environment
    torch.distributed.run sets, as tests/test_torch_parallel.py launches
    its ranks): both exit 0 and report every part finite, with the same
    losses on both ranks (replicated results)."""
    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE="2",
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "isogs_slam_tpu_torch.graft_entry",
             "--dryrun", "2", "--device", "cpu"], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"the ranks did not finish within {SPAWN_TIMEOUT} s")
    assert [p.returncode for p in procs] == [0, 0], "\n".join(outs)
    ok = [[ln for ln in o.splitlines() if ln.startswith("dryrun_multichip(2)")
           and ln.endswith(" OK")] for o in outs]
    assert [len(x) for x in ok] == [1, 1], outs
    assert "rank 0" in ok[0][0] and "rank 1" in ok[1][0]
    assert ok[0][0].split(":", 1)[1] == ok[1][0].split(":", 1)[1]
