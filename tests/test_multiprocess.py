"""Genuine multi-process (multi-"host") sharding test.

Spawns TWO separate Python processes, each owning 4 virtual CPU devices,
joined through jax.distributed over gloo — the same runtime layer a
multi-host GPU run uses (SURVEY §2.3(1)). Each process constructs only its addressable
shards (asserted inside the worker), trains 3 sharded HPF CAVI steps,
and all-gathers the result; the parent compares both gathered states
against the single-device run bit-for-tolerance.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from conftest import make_synthetic
from hgaprec_jax.config import ModelConfig
from hgaprec_jax.data.device import build_device_data
from hgaprec_jax.models.state import init_state
from hgaprec_jax.models.step import make_step

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_sharding(tmp_path):
    # dataset for the per-host ingest phase of the workers
    from hgaprec_jax.data.synthetic import write_pf_dataset
    write_pf_dataset(str(tmp_path), np.random.default_rng(9), 60, 25, k=3,
                     scale=1.2)
    port = _free_port()
    env = dict(os.environ)
    # keep any PYTHONPATH entries already set; add repo + tests dirs
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT, HERE, env.get("PYTHONPATH", "")])
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_mp_worker.py"),
         str(pid), str(port), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in (0, 1)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"

    # single-device reference (this process: 8 local CPU devices, unused)
    rng = np.random.default_rng(42)
    store, validation, test = make_synthetic(rng, n=53, m=31, density=0.3)
    cfg = ModelConfig(n=store.n, m=store.m, k=4, variant="hpf",
                      sweep="segment")
    data = build_device_data(store, pad_multiple=128)
    state = init_state(cfg, seed=11)
    step = make_step(cfg)
    for _ in range(3):
        state = step(state, data)

    # the item-sharded top-k ran as a cross-process collective; check it
    # against a host-side masked argsort of the same model
    from hgaprec_jax.eval.score import scorer_from_state
    z0 = np.load(tmp_path / "proc0.npz")
    sc = scorer_from_state(state, cfg)
    scores = np.asarray(sc.su) @ np.asarray(sc.sv).T
    scores[0, 2] = 0.0   # the masked (user 0, item 2) cell
    for r, n in enumerate((0, 3, 7)):
        want = np.sort(scores[n])[::-1][:5]
        np.testing.assert_allclose(z0["topk_vals"][r], want, rtol=2e-4,
                                   atol=1e-6, err_msg=f"topk user {n}")
    z1 = np.load(tmp_path / "proc1.npz")
    np.testing.assert_array_equal(z0["topk_ids"], z1["topk_ids"])

    saw_primary = []
    for pid in (0, 1):
        z = np.load(tmp_path / f"proc{pid}.npz")
        np.testing.assert_allclose(z["theta_e"], np.asarray(state.theta.e),
                                   rtol=2e-4, atol=1e-6,
                                   err_msg=f"theta proc{pid}")
        np.testing.assert_allclose(z["beta_e"], np.asarray(state.beta.e),
                                   rtol=2e-4, atol=1e-6,
                                   err_msg=f"beta proc{pid}")
        np.testing.assert_allclose(z["xi_e"],
                                   np.asarray(state.theta_rate.e),
                                   rtol=2e-4, atol=1e-6,
                                   err_msg=f"xi proc{pid}")
        saw_primary.append(int(z["primary"][0]))
    assert saw_primary == [1, 0]  # exactly process 0 is the writer

    # per-host ingest: the two slices are proper subsets that tile the
    # training stream (each process held less than the global nnz)
    g = int(z0["global_nnz"][0])
    l0, l1 = int(z0["local_nnz"][0]), int(z1["local_nnz"][0])
    assert l0 < g and l1 < g and l0 + l1 == g
