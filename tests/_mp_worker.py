"""Worker for the genuine 2-process multi-host test.

Launched as `python tests/_mp_worker.py <process_id> <port> <outdir>`
by tests/test_multiprocess.py. Each process sees 4 local CPU devices
(8 global), initializes jax.distributed over gloo, builds ONLY its
process-local shards (the per-device construction path in
parallel/sharded.py), runs 3 sharded CAVI steps, and dumps the gathered
state for the parent to compare against the single-device run.
"""

import os
import sys


def main():
    pid, port, outdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=4")
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                               num_processes=2, process_id=pid)
    assert jax.device_count() == 8, jax.device_count()
    assert jax.process_count() == 2

    import numpy as np
    from conftest import make_synthetic
    from hgaprec_jax.config import ModelConfig
    from hgaprec_jax.parallel.distributed import is_primary
    from hgaprec_jax.parallel.sharded import build_sharded_run, make_mesh

    rng = np.random.default_rng(42)
    store, validation, test = make_synthetic(rng, n=53, m=31, density=0.3)
    cfg = ModelConfig(n=store.n, m=store.m, k=4, variant="hpf",
                      sweep="segment")

    run = build_sharded_run(store, cfg, make_mesh(), seed=11,
                            pad_multiple=128, dense=False)
    # every user-side data/state leaf must be only partially addressable
    # here — i.e. this process genuinely built only its own shards
    assert not run.data.u_ids.is_fully_addressable
    assert not run.state.theta.e.is_fully_addressable
    for _ in range(3):
        run.step()
    st = run.unsharded_state()

    # multi-host item-sharded ranking eval: every process participates
    # in the collectives; results must be identical everywhere
    from hgaprec_jax.eval.score import scorer_from_state
    from hgaprec_jax.parallel.sharded import sharded_masked_topk
    sc = scorer_from_state(st, cfg)
    users = np.asarray([0, 3, 7], np.int64)
    mask_cols = np.full((3, 2), -(10 ** 9), np.int32)
    mask_cols[0, 0] = 2   # mask one item for user 0
    tv, ti = sharded_masked_topk(sc, run.mesh, users, mask_cols, k=5)

    # --- per-host ingest: load_dataset(user_rows=host_user_rows) must ---
    # materialize only this process's training rows, keep GLOBAL id maps,
    # and train identically to the full-store run (the parent wrote the
    # TSV dataset into outdir before spawning us)
    from hgaprec_jax.data.ratings import load_dataset
    from hgaprec_jax.parallel.distributed import host_user_rows
    store_l, val_l, test_l = load_dataset(outdir, 500, 500, False, 1,
                                          user_rows=host_user_rows)
    store_g, val_g, _ = load_dataset(outdir, 500, 500, False, 1)
    assert store_l.n == store_g.n and store_l.m == store_g.m  # global maps
    assert store_l.local_user_rows is not None
    assert store_l.nratings < store_g.nratings   # a real slice, per process
    assert val_l == val_g                        # eval maps stay global

    cfg2 = ModelConfig(n=store_g.n, m=store_g.m, k=3, variant="bpf",
                       sweep="segment")
    run_l = build_sharded_run(store_l, cfg2, make_mesh(), seed=7,
                              pad_multiple=64, dense=False)
    run_g = build_sharded_run(store_g, cfg2, make_mesh(), seed=7,
                              pad_multiple=64, dense=False)
    for _ in range(2):
        run_l.step()
        run_g.step()
    st_l = run_l.unsharded_state()
    st_g = run_g.unsharded_state()
    np.testing.assert_allclose(np.asarray(st_l.theta.e),
                               np.asarray(st_g.theta.e), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(st_l.beta.e),
                               np.asarray(st_g.beta.e), rtol=1e-6)

    # --- sharded HYBRID layout across two processes: the head set is ---
    # chosen from allgather-summed degrees and the per-shard TailCompact
    # pads come from allgather-maxed stats; per-host-ingested and
    # full-store builds must train identically
    cfg3 = ModelConfig(n=store_g.n, m=store_g.m, k=3, variant="hpf",
                       sweep="hybrid", hybrid_head_items=8,
                       dense_limit_bytes=64)
    run_hl = build_sharded_run(store_l, cfg3, make_mesh(), seed=7,
                               pad_multiple=64)
    run_hg = build_sharded_run(store_g, cfg3, make_mesh(), seed=7,
                               pad_multiple=64)
    assert run_hl.data.head_dense_y is not None
    assert run_hl.data.tail_compact is not None
    from hgaprec_jax.models.step import _resolve_mode
    assert _resolve_mode(run_hl.cfg, run_hl.data) == "hybrid"
    for _ in range(2):
        run_hl.step()
        run_hg.step()
    st_hl = run_hl.unsharded_state("eval")
    st_hg = run_hg.unsharded_state("eval")
    np.testing.assert_allclose(np.asarray(st_hl.theta.e),
                               np.asarray(st_hg.theta.e), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(st_hl.beta.e),
                               np.asarray(st_hg.beta.e), rtol=1e-6)

    np.savez(os.path.join(outdir, f"proc{pid}.npz"),
             theta_e=np.asarray(st.theta.e),
             beta_e=np.asarray(st.beta.e),
             xi_e=np.asarray(st.theta_rate.e),
             topk_vals=tv, topk_ids=ti,
             local_nnz=np.asarray([store_l.nratings]),
             global_nnz=np.asarray([store_g.nratings]),
             primary=np.asarray([1 if is_primary() else 0]))
    print(f"proc {pid}: OK", flush=True)


if __name__ == "__main__":
    main()
