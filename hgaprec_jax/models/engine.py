"""Training driver: CAVI loop + reporting cadence + stopping + contract.

Reproduces the reference's operational envelope:

  * per-run output directory named from the config (env.hh:283-369),
    containing param.txt, infer.log, validation.txt, test.txt,
    precision.txt, logl.txt, rmse.txt, heldout.txt, ndcg.txt, max.txt,
    byusers.tsv/byitems.tsv and model TSVs (see io/checkpoint.py).
  * reporting every rfreq iterations at pre-increment counter 0, 10, ...
    (hgaprec.cc:962-971): validation + test likelihood, save_model,
    precision over freshly sampled users, itemrank (only at iter%100==0),
    optional ELBO.
  * stopping rule (hgaprec.cc:1476-1491): after iter 30, stop when the
    validation likelihood's relative improvement < 1e-6 (why=0) or after
    3 consecutive decreases (why=1); then do_on_stop(): save model +
    write the full ranking for test_users.tsv if present (hgaprec.cc:
    1572-1577, 2087-2112).
  * SIGTERM sets a flag polled at every report boundary (every rfreq
    iterations — the iterations in between are fused into one device
    dispatch, so signal latency is bounded by rfreq, not 1, unlike the
    reference's per-iteration poll, main.cc:19-30, hgaprec.cc:973-976)
    -> checkpoint + ranking; training can also *resume* from the native
    checkpoint (an improvement; the reference cannot).
"""

from __future__ import annotations

import os
import signal
import time
from typing import Dict, Optional

import numpy as np

from hgaprec_jax.config import ModelConfig, RunConfig
from hgaprec_jax.data.device import DeviceData, build_device_data
from hgaprec_jax.data.ratings import (CountMap, RatingsStore,
                                      leave_one_out_map,
                                      validation_users_of_movie)
from hgaprec_jax.eval import ranking as rank_mod
from hgaprec_jax.eval.ranking import EvalIndex
from hgaprec_jax.eval.score import pair_loglik, scorer_from_state
from hgaprec_jax.io import checkpoint as ckpt
from hgaprec_jax.models.elbo import training_elbo
from hgaprec_jax.models.state import ModelState, init_state
from hgaprec_jax.models.step import make_multi_step, make_step


def _pairs_arrays(cmap: CountMap):
    import jax.numpy as jnp
    pairs = sorted(cmap.keys())
    u = jnp.asarray(np.asarray([p[0] for p in pairs], np.int32))
    i = jnp.asarray(np.asarray([p[1] for p in pairs], np.int32))
    y = jnp.asarray(np.asarray([cmap[p] for p in pairs], np.float32))
    return u, i, y


class Trainer:
    def __init__(self, store: RatingsStore, validation: CountMap,
                 test: CountMap, mcfg: ModelConfig, rcfg: RunConfig,
                 device_data: Optional[DeviceData] = None,
                 primary: Optional[bool] = None,
                 build_data: bool = True):
        self.store = store
        self.validation = validation
        self.test = test
        self.mcfg = mcfg
        self.rcfg = rcfg
        # Multi-host: every process runs the same eval/stopping code (the
        # decisions are deterministic on the gathered state, so processes
        # stay in lockstep), but only the primary writes the output-file
        # contract. Non-primary output lands in a scratch subdir.
        if primary is None:
            from hgaprec_jax.parallel.distributed import is_primary
            try:
                primary = is_primary()
            except Exception:
                primary = True
        self.primary = primary
        self.shared_outdir = rcfg.resolve_outdir(mcfg)
        self.outdir = self.shared_outdir
        if not primary:
            import jax
            self.outdir = os.path.join(self.shared_outdir,
                                       f".proc{jax.process_index()}")
        os.makedirs(self.outdir, exist_ok=True)
        if device_data is not None:
            self.data = device_data
        elif not build_data:
            # the sharded multi-host driver builds per-device shards
            # itself (parallel/sharded.py); a per-host-ingested store
            # holds only local rows, so single-device data would be both
            # wasteful and partial
            self.data = None
        else:
            # catalogs too wide to densify get the hybrid head/tail
            # layout (dense top-degree items + sparse-tail sweep) by
            # default; skip the head block when the catalog densifies
            # anyway (dense_y is the faster path and the head would be
            # dead weight in device memory). Explicit sweep='hybrid' always builds
            # the head regardless of m.
            will_densify = store.n * store.m <= mcfg.dense_limit_bytes
            if mcfg.sweep == "hybrid":
                head = mcfg.hybrid_head_items
            elif mcfg.sweep == "auto" and not will_densify:
                # any catalog too wide to densify: head/tail hybrid
                # (scatter-free compact tail); build_device_data falls back
                # to no head when the byte budget can't fit 512 columns,
                # and _resolve_mode then picks the segment sweep
                head = mcfg.hybrid_head_items
            else:
                head = 0
            self.data = build_device_data(
                store, hybrid_head_items=head,
                dense_limit_bytes=mcfg.dense_limit_bytes,
                head_limit_bytes=mcfg.head_limit_bytes)
        self.step = make_step(mcfg)
        self.multi_step = make_multi_step(mcfg)
        self.state: ModelState = init_state(mcfg, seed=rcfg.seed)
        self.iteration = 0
        self.start_time = time.time()
        self.index = EvalIndex(validation, test, store)
        self.leave_one_out = leave_one_out_map(test)
        self.val_users_of_movie = validation_users_of_movie(validation)
        self._val_pairs = _pairs_arrays(validation)
        self._test_pairs = _pairs_arrays(test)
        self._prev_h = 0.0
        self._nh = 0
        self._stop_requested = False
        self._on_stop_done = False
        self._rng = np.random.default_rng(
            (rcfg.seed or 0) + 1000003)  # eval sampling stream
        self._sampled_users: Optional[np.ndarray] = None
        # set by the sharded driver: items sharded over this mesh for the
        # ranking eval (per-shard top-k + all_gather merge)
        self.eval_mesh = None
        self._files: Dict[str, object] = {}
        self._open_outputs()
        if self.primary:
            self._write_param_txt()
            # marginals need the full COO; a per-host-ingested store
            # holds only this host's rows (data/ratings.py user_rows)
            if rcfg.write_marginals and \
                    getattr(store, "local_user_rows", None) is None:
                store.write_marginal_distributions(self.outdir)

    # -- plumbing ----------------------------------------------------------
    def _open_outputs(self):
        # reference opens all of these up front (hgaprec.cc:40-75)
        for name in ("heldout.txt", "validation.txt", "test.txt", "logl.txt",
                     "precision.txt", "ndcg.txt", "rmse.txt", "infer.log"):
            self._files[name] = open(os.path.join(self.outdir, name), "w")

    def close(self):
        self._join_save()
        for f in self._files.values():
            f.close()
        self._files = {}

    def log(self, msg: str):
        f = self._files.get("infer.log")
        if f:
            f.write(msg + "\n")
            f.flush()

    def _write_param_txt(self):
        m, r = self.mcfg, self.rcfg
        with open(os.path.join(self.outdir, "param.txt"), "w") as f:
            # key: value lines like Env::plog (env.hh:375-402)
            f.write(f"n: {m.n}\nk: {m.k}\nt: 2\n")
            f.write("test_ratio: 0.2\nvalidation_ratio: 0.01\n")
            f.write(f"seed: {r.seed}\n")
            f.write(f"a: {m.a}\nb: {m.b}\nc: {m.c}\nd: {m.d}\n")
            f.write(f"reportfreq: {r.rfreq}\n")
            f.write(f"vb: {int(m.vb)}\nbias: {int(m.bias)}\n")
            f.write(f"hier: {int(m.hier)}\n")
            f.write(f"binary_data: {int(m.binary)}\n")
            f.write(f"variant: {m.variant}\n")
            f.write(f"rating_threshold: {r.rating_threshold}\n")
            f.write(f"max_iterations: {r.max_iterations}\n")

    def scorer(self):
        return scorer_from_state(self.state, self.mcfg)

    def duration(self) -> int:
        return int(time.time() - self.start_time)

    def install_sigterm(self):
        signal.signal(signal.SIGTERM, self._on_sigterm)

    def _on_sigterm(self, signum, frame):
        self._stop_requested = True

    # -- likelihood + stopping (hgaprec.cc:1439-1501) ----------------------
    def compute_likelihood(self, validation: bool) -> float:
        u, i, y = self._val_pairs if validation else self._test_pairs
        k = int(u.shape[0])
        if k == 0:
            return 0.0
        total, _ = pair_loglik(self.scorer(), u, i, y, self.mcfg.binary)
        a = float(total) / k
        fname = "validation.txt" if validation else "test.txt"
        f = self._files[fname]
        f.write(f"{self.iteration}\t{self.duration()}\t{a:.9f}\t{k}\n")
        f.flush()
        if not validation:
            return a
        stop, why = False, -1
        if self.iteration > 30:
            if (a > self._prev_h and self._prev_h != 0 and
                    abs((a - self._prev_h) / self._prev_h) < 1e-6):
                stop, why = True, 0
            elif a < self._prev_h:
                self._nh += 1
            elif a > self._prev_h:
                self._nh = 0
            if self._nh > 2:
                stop, why = True, 1
        self._prev_h = a
        with open(os.path.join(self.outdir, "max.txt"), "w") as f:
            f.write(f"{self.iteration}\t{self.duration()}\t{a:.5f}\t{why}\n")
        if stop:
            self.do_on_stop()
            self._stop_requested = True
        return a

    def do_on_stop(self):
        """save_model + gen_ranking_for_users(false) (hgaprec.cc:1572-1577)."""
        self._on_stop_done = True
        self.save_model()
        self.gen_ranking_for_users(load=False)

    # -- model io ----------------------------------------------------------
    def _join_save(self):
        t = getattr(self, "_save_thread", None)
        if t is not None:
            t.join()
            self._save_thread = None

    def save_model(self):
        """Snapshot to host, write files on a background thread.

        The D2H copies happen synchronously — the next fused chunk
        donates the state buffers, so the writer must not read device
        arrays later. The file writes (the slow part; the reference
        blocks its loop on them every rfreq, hgaprec.cc:966) overlap the
        next training chunk."""
        import threading

        import jax
        if not self.primary:
            return  # checkpoint files are written once, by process 0
        # explicit owning copies: the next fused dispatch donates the state
        # buffers (donate_argnums), and np.asarray's copy-vs-view behavior
        # on device arrays is an implementation detail
        host_state = jax.tree.map(lambda x: np.array(x, copy=True),
                                  self.state)
        iteration = self.iteration
        self._join_save()

        def write():
            ckpt.save_model_tsv(self.outdir, host_state, self.mcfg,
                                self.store.seq2user, self.store.seq2movie)
            ckpt.save_npz(os.path.join(self.outdir, "model.npz"),
                          host_state, iteration)

        t = threading.Thread(target=write, daemon=True)
        self._save_thread = t
        t.start()

    def load_model(self, indir: Optional[str] = None):
        self._join_save()   # don't read files an in-flight save is writing
        # non-primary processes load the primary's checkpoint (shared FS)
        indir = indir or self.shared_outdir
        npz = os.path.join(indir, "model.npz")
        if os.path.exists(npz):
            self.state, self.iteration = ckpt.load_npz(npz, self.mcfg)
        else:
            self.state = ckpt.load_model_tsv(indir, self.mcfg, self.state)

    # -- eval wrappers -----------------------------------------------------
    def compute_precision(self, save_ranking: bool):
        """One precision report (hgaprec.cc:1703-1848).

        User selection parity: on saving reports (every 100 iters) the
        reference REUSES `_sampled_users` from the previous non-saving
        report (hgaprec.cc:1715-1721 only resamples when
        !save_ranking_file); test_users.tsv enters only through
        gen_ranking_for_users. Reproduced exactly here."""
        if self.iteration % 100 == 0 and self.iteration > 0:
            save_ranking = True
        if not save_ranking:
            # resample each non-saving report (hgaprec.cc:1713-1721)
            self._sampled_users = rank_mod.sample_users(
                self._rng, self.store.n, self.rcfg.num_precision_users)
        if self._sampled_users is None:
            self._sampled_users = rank_mod.sample_users(
                self._rng, self.store.n, self.rcfg.num_precision_users)
        users = self._sampled_users
        path = os.path.join(self.outdir, "ranking.tsv") if save_ranking \
            else None
        # Non-primary processes must still JOIN this call when the
        # item-sharded top-k collective is active (eval_mesh), but they
        # write no report files — the primary's output is the contract.
        pfile = self._files["precision.txt"] if self.primary else None
        if not self.primary:
            path = None
        return rank_mod.compute_precision(
            self.scorer(), self.store, self.index, self.test, users,
            pfile, path, self.rcfg.topn_by_user,
            self.eval_mesh)

    def compute_itemrank(self, final: bool):
        if not self.primary:
            return None   # host-local (no collective): primary-only work
        if self.iteration % 100 == 0 and self.iteration > 0:
            final = True
        if not final or self._sampled_users is None:
            return None
        return rank_mod.compute_itemrank(self.scorer(), self.store,
                                         self.index, self._sampled_users,
                                         self.outdir)

    def gen_ranking_for_users(self, load: bool):
        """hgaprec.cc:2087-2112: rank for users in test_users.tsv."""
        if load:
            self.load_model()
        tu_path = os.path.join(self.rcfg.datdir, "test_users.tsv")
        if not os.path.exists(tu_path):
            self.log(f"cannot open {tu_path}")
            return
        users = self.store.read_test_users(tu_path)
        if users.size == 0:
            return
        self._sampled_users = users
        if self.primary or self.eval_mesh is not None:
            rank_mod.compute_precision(
                self.scorer(), self.store, self.index, self.test, users,
                self._files["precision.txt"] if self.primary else None,
                (os.path.join(self.outdir, "ranking.tsv")
                 if self.primary else None),
                self.rcfg.topn_by_user, self.eval_mesh)
        if self.primary:
            rank_mod.compute_itemrank(self.scorer(), self.store,
                                      self.index, users, self.outdir)

    def compute_rmse(self) -> float:
        return rank_mod.compute_rmse(self.scorer(), self.test,
                                     self.outdir, self._files["rmse.txt"])

    def gen_msr_csv(self):
        rank_mod.gen_msr_csv(self.scorer(), self.store, self.index,
                             self.leave_one_out, self.val_users_of_movie,
                             self.outdir)

    def logl(self) -> float:
        if self.data is None:
            # per-host ingest: this process holds only its row slice, so
            # a full training ELBO is not computable host-locally
            self.log("logl skipped: no single-device data (sharded run)")
            return 0.0
        s = float(training_elbo(self.state, self.data, self.mcfg))
        f = self._files["logl.txt"]
        f.write(f"{s:.5f}\n")
        f.flush()
        return s

    # -- main loop ---------------------------------------------------------
    def next_chunk(self, cap: Optional[int]):
        """(n_steps, bound) to reach the next report boundary in one fused
        dispatch — the next multiple of rfreq (reference reporting cadence,
        hgaprec.cc:962), clipped at the iteration cap. Shared by the
        single-device loop and the sharded driver so the fusion arithmetic
        cannot drift between them."""
        rfreq = max(self.rcfg.rfreq, 1)
        bound = -(-self.iteration // rfreq) * rfreq
        if cap is not None:
            bound = min(bound, cap)
        return bound - self.iteration + 1, bound

    def resolve_cap(self) -> Optional[int]:
        """Iteration cap: vb_hier honors max_iterations (hgaprec.cc:
        1336-1339); the other variants run until the stopping rule unless
        enforce_max_iterations is set."""
        if self.mcfg.hier or self.rcfg.enforce_max_iterations:
            return self.rcfg.max_iterations
        return None

    def report(self):
        # every process: the validation likelihood drives the stopping
        # rule, which must stay lockstep across processes (deterministic on
        # the gathered state, so no broadcast is needed)
        self.compute_likelihood(True)
        if self._stop_requested:
            return
        if self.primary:
            self.compute_likelihood(False)
            if not self.mcfg.mle:
                self.save_model()
        # precision joins the item-sharded top-k COLLECTIVE when
        # eval_mesh is set — then every process must call it (it skips
        # the file writes on non-primary); without a mesh the whole
        # report is host-local and non-primary skips it outright
        if self.primary or self.eval_mesh is not None:
            self.compute_precision(False)
        if self.primary:
            if (self.mcfg.variant in ("bpf", "hpf", "canny")
                    and not self.mcfg.bias):
                # reference: vb/vb_hier/vb_canny also run itemrank
                self.compute_itemrank(False)
            if self.rcfg.logl:
                self.logl()

    def run(self, max_iters: Optional[int] = None) -> ModelState:
        """Train until the stopping rule fires (or an iteration cap).

        With rcfg.trace_dir set, the whole loop runs under
        jax.profiler.trace for TensorBoard/xprof (the reference has no
        profiler at all — SURVEY.md §5)."""
        if self.rcfg.trace_dir:
            import jax
            with jax.profiler.trace(self.rcfg.trace_dir):
                return self._run_loop(max_iters)
        return self._run_loop(max_iters)

    def _run_loop(self, max_iters: Optional[int] = None) -> ModelState:
        cap = max_iters if max_iters is not None else self.resolve_cap()
        last_report = (time.time(), 0)
        while True:
            if cap is not None and self.iteration > cap:
                break
            # Run every iteration up to the next report boundary in ONE
            # device dispatch — the host round trip per iteration is the
            # reference's loop structure, not part of the algorithm.
            n_steps, bound = self.next_chunk(cap)
            if n_steps > 1:
                self.state = self.multi_step(self.state, self.data, n_steps)
                self.iteration = bound
            else:
                self.state = self.step(self.state, self.data)
            if self.iteration % self.rcfg.rfreq == 0:
                now = time.time()
                t0, it0 = last_report
                if self.iteration > it0:
                    rate = (self.iteration - it0) / max(now - t0, 1e-9)
                    self.log(f"iteration {self.iteration}: "
                             f"{rate:.1f} iters/s")
                last_report = (now, self.iteration)
                self.report()
            if self._stop_requested:
                self.log(f"stopping at iteration {self.iteration} "
                         f"duration {self.duration()}s")
                break
            self.iteration += 1
        # reference exits via do_on_stop on max_iterations (hgaprec.cc:
        # 1336-1339) and SIGTERM (973-976), not just on convergence
        if not self._on_stop_done:
            self.do_on_stop()
        self._join_save()   # checkpoint files complete when run() returns
        return self.state
