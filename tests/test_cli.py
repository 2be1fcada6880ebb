"""CLI smoke tests: reference flag surface end to end."""

import json
import os

import numpy as np
import pytest

from conftest import make_synthetic
from hgaprec_jax import cli
from hgaprec_jax.data.synthetic import write_pf_dataset


@pytest.fixture
def dataset(tmp_path, rng):
    write_pf_dataset(str(tmp_path), rng, 50, 30, k=3, scale=6.0,
                     test_frac=0.15, valid_frac=0.1)
    return tmp_path


def test_cli_train_bpf(dataset, tmp_path):
    out = str(tmp_path / "out")
    rc = cli.main(["-dir", str(dataset), "-n", "50", "-m", "30", "-k", "3",
                   "-rfreq", "4", "-max-iterations", "8", "-seed", "2",
                   "-outdir", out, "-hier"])
    assert rc == 0
    assert os.path.exists(os.path.join(out, "validation.txt"))
    assert os.path.exists(os.path.join(out, "htheta.tsv"))


def test_cli_gen_ranking_after_train(dataset, tmp_path):
    out = str(tmp_path / "out2")
    cli.main(["-dir", str(dataset), "-n", "50", "-m", "30", "-k", "3",
              "-rfreq", "4", "-max-iterations", "4", "-outdir", out,
              "-hier"])
    rc = cli.main(["-dir", str(dataset), "-n", "50", "-m", "30", "-k", "3",
                   "-outdir", out, "-hier", "-gen-ranking"])
    assert rc == 0
    assert os.path.exists(os.path.join(out, "ranking.tsv"))


def test_cli_write_training_formats(dataset, tmp_path):
    out = str(tmp_path / "out3")
    rc = cli.main(["-dir", str(dataset), "-n", "50", "-m", "30", "-k", "3",
                   "-outdir", out, "-write-training", "-lda"])
    assert rc == 0
    lines = open(os.path.join(out, "ldatrain.tsv")).read().splitlines()
    assert lines and ":" in lines[0]
    rc = cli.main(["-dir", str(dataset), "-n", "50", "-m", "30", "-k", "3",
                   "-outdir", out, "-write-training", "-vwlda"])
    assert rc == 0
    assert open(os.path.join(out, "ldatrain.tsv")).read().startswith("|")


def test_cli_chi_export(dataset, tmp_path):
    out = str(tmp_path / "out4")
    rc = cli.main(["-dir", str(dataset), "-n", "50", "-m", "30", "-k", "3",
                   "-outdir", out, "-chi", "-wals"])
    assert rc == 0
    head = open(os.path.join(out, "chitrain.tsv")).read().splitlines()
    assert head[0].startswith("%%MatrixMarket")
    # wals rows: "u m conf p"
    assert len(head[2].split()) == 4


def test_cli_nmf_native(dataset, tmp_path):
    out = str(tmp_path / "out5")
    rc = cli.main(["-dir", str(dataset), "-n", "50", "-m", "30", "-k", "3",
                   "-outdir", out, "-nmf"])
    assert rc == 0
    assert os.path.exists(os.path.join(out, "nmf_theta.tsv"))
    # ranking written for test_users.tsv
    assert os.path.exists(os.path.join(out, "ranking.tsv"))


def test_cli_msr(dataset, tmp_path):
    out = str(tmp_path / "out6")
    cli.main(["-dir", str(dataset), "-n", "50", "-m", "30", "-k", "3",
              "-rfreq", "2", "-max-iterations", "4", "-outdir", out,
              "-hier"])
    rc = cli.main(["-dir", str(dataset), "-n", "50", "-m", "30", "-k", "3",
                   "-outdir", out, "-hier", "-msr"])
    assert rc == 0
    assert os.path.exists(os.path.join(out, "pred.csv"))


def test_cli_online_quits(dataset, tmp_path, capsys):
    rc = cli.main(["-dir", str(dataset), "-n", "50", "-m", "30", "-k", "3",
                   "-outdir", str(tmp_path / "o7"), "-online"])
    assert rc == 0
    assert "not implemented" in capsys.readouterr().out


def test_cli_sharded_devices(dataset, tmp_path):
    out = str(tmp_path / "out8")
    rc = cli.main(["-dir", str(dataset), "-n", "50", "-m", "30", "-k", "3",
                   "-rfreq", "3", "-max-iterations", "6", "-outdir", out,
                   "-hier", "-devices", "8"])
    assert rc == 0
    rows = open(os.path.join(out, "validation.txt")).read().splitlines()
    assert len(rows) >= 2


def test_cli_sharded_hybrid_devices(dataset, tmp_path):
    """The full sharded driver through the big-sparse hybrid layout
    (VERDICT r4 #1): -devices 8 -sweep hybrid trains, reports (eval
    gathers the e-only state), checkpoints (full gather), and matches
    the single-device hybrid run's validation trajectory."""
    out = str(tmp_path / "outh")
    rc = cli.main(["-dir", str(dataset), "-n", "50", "-m", "30", "-k", "3",
                   "-rfreq", "3", "-max-iterations", "6", "-outdir", out,
                   "-hier", "-sweep", "hybrid", "-devices", "8"])
    assert rc == 0
    rows = open(os.path.join(out, "validation.txt")).read().splitlines()
    assert len(rows) >= 2
    assert os.path.exists(os.path.join(out, "model.npz"))   # checkpointed
    out1 = str(tmp_path / "outh1")
    rc = cli.main(["-dir", str(dataset), "-n", "50", "-m", "30", "-k", "3",
                   "-rfreq", "3", "-max-iterations", "6", "-outdir", out1,
                   "-hier", "-sweep", "hybrid"])
    assert rc == 0
    rows1 = open(os.path.join(out1, "validation.txt")).read().splitlines()
    for a, b in zip(rows, rows1):
        la, lb = float(a.split("\t")[2]), float(b.split("\t")[2])
        assert abs(la - lb) < 5e-3 * max(1.0, abs(lb))


def test_nmf_reconstructs(rng):
    from hgaprec_jax.ops.nmf import nmf
    w = rng.gamma(2.0, 1.0, (30, 3)).astype(np.float32)
    h = rng.gamma(2.0, 1.0, (20, 3)).astype(np.float32)
    v = w @ h.T
    theta, beta = nmf(v, 3, iters=300, seed=1)
    err = np.linalg.norm(theta @ beta.T - v) / np.linalg.norm(v)
    assert err < 0.05


def test_coldstart_prefers_seed_neighbors(rng):
    from hgaprec_jax.config import ModelConfig
    from hgaprec_jax.data.device import build_device_data
    from hgaprec_jax.models.coldstart import fold_in_users
    from hgaprec_jax.models.state import init_state
    from hgaprec_jax.models.step import make_step
    store, validation, test = make_synthetic(rng, n=40, m=30, density=0.3)
    cfg = ModelConfig(n=store.n, m=store.m, k=3)
    data = build_device_data(store)
    state = init_state(cfg, 1)
    step = make_step(cfg)
    for _ in range(10):
        state = step(state, data)
    theta_e, scores = fold_in_users(state, cfg, [[0, 1], [2]])
    assert theta_e.shape == (2, 3)
    assert np.isfinite(scores).all() and (scores >= 0).all()


def test_cli_nmfload(dataset, tmp_path):
    """-nmfload imports libNMF theta/beta from the output dir, re-saves,
    and ranks (main.cc:298-302 -> hgaprec.cc:833-862)."""
    out = tmp_path / "out_nmfload"
    out.mkdir()
    rng2 = np.random.default_rng(9)
    th = rng2.random((50, 3))
    be = rng2.random((3, 30))   # [k, m] orientation
    (out / "theta.tsv").write_text(
        "h\nh\n" + "\n".join(" ".join(f"{v:.6f}" for v in r) for r in th))
    (out / "beta.tsv").write_text(
        "h\nh\n" + "\n".join(" ".join(f"{v:.6f}" for v in r) for r in be))
    rc = cli.main(["-dir", str(dataset), "-n", "50", "-m", "30", "-k", "3",
                   "-outdir", str(out), "-nmfload"])
    assert rc == 0
    assert (out / "nmf_theta.tsv").exists()
    assert (out / "ranking.tsv").exists()


def test_cli_ctr_maps(dataset, tmp_path, monkeypatch):
    """-ctr applies the id maps and writes the map CSVs
    (hgaprec.cc:418-476)."""
    out = tmp_path / "out_ctr"
    out.mkdir()
    monkeypatch.chdir(tmp_path)
    rng2 = np.random.default_rng(3)
    np.savetxt("final-U.dat", rng2.random((50, 3)))
    np.savetxt("final-V.dat", rng2.random((30, 3)))
    # identity ext->row maps over the dataset's external ids (1-based)
    with open("user_map.dat", "w") as f:
        for e in range(1, 51):
            f.write(f"{e},{e - 1}\n")
    with open("item_map.dat", "w") as f:
        for e in range(1, 31):
            f.write(f"{e},{e - 1}\n")
    rc = cli.main(["-dir", str(dataset), "-n", "50", "-m", "30", "-k", "3",
                   "-outdir", str(out), "-ctr"])
    assert rc == 0
    assert (out / "user-map.csv").exists()
    assert (out / "ctr_theta.tsv").exists()
    assert (out / "ranking.tsv").exists()


def test_cli_chi_tool_commands(dataset, tmp_path, capsys):
    """-chisgd / -chipmf print the graphchi command lines."""
    for flag, frag in (("-chisgd", "biassgd"), ("-chipmf", "pmf")):
        out = str(tmp_path / f"out{flag}")
        rc = cli.main(["-dir", str(dataset), "-n", "50", "-m", "30",
                       "-k", "3", "-outdir", out, "-chi", flag])
        assert rc == 0
        assert frag in capsys.readouterr().out


def test_cli_coldstart_titles(dataset, tmp_path, capsys):
    """-test folds in a fresh user from seed items and prints titles."""
    out = str(tmp_path / "outcs")
    rc = cli.main(["-dir", str(dataset), "-n", "50", "-m", "30", "-k", "3",
                   "-rfreq", "4", "-max-iterations", "8", "-outdir", out])
    assert rc == 0
    capsys.readouterr()
    # metadata file with movielens layout, external ids are 1-based
    meta = tmp_path / "movies.dat"
    meta.write_text("".join(f"{e}::Title {e}::Genre\n"
                            for e in range(1, 31)))
    rc = cli.main(["-dir", str(tmp_path), "-n", "50", "-m", "30", "-k", "3",
                   "-outdir", out, "-test", "-test-items", "1,2",
                   "-load", out])
    assert rc == 0
    outtext = capsys.readouterr().out
    assert "Title 1, Genre" in outtext
    assert "predictions" in outtext
    # top-21 lines follow the predictions header
    tail = outtext.split("predictions\n", 1)[1].strip().splitlines()
    assert len(tail) == min(21, 30)


def test_outdir_bridge_suffixes(dataset, tmp_path):
    """Output-dir naming includes bridge-mode suffixes (env.hh:326-369)."""
    from hgaprec_jax.config import ModelConfig, RunConfig
    mc = ModelConfig(n=5, m=4, k=2)
    rc = RunConfig(datdir=".", label="x", chi=True, chi_tool="wals",
                   wals_l=0.1, wals_C=10)
    assert rc.derive_outdir(mc) == \
        "n5-m4-k2-x-batch-vb-chi-wals-wl-0.1-wC-10"
    rc2 = RunConfig(datdir=".", label="x", nmf=True, write_training=True)
    assert rc2.derive_outdir(mc) == "n5-m4-k2-x-batch-vb-nmf-write-training"


def test_cli_chi_als_roundtrip_stub(dataset, tmp_path, monkeypatch):
    """-chi -als against a test-double graphchi binary: the stub writes
    deterministic MatrixMarket factors, and the CLI's import/rank tail
    (mm_load_rowmajor + rank_foreign, hgaprec.cc:478-530 semantics) must
    produce ranking.tsv/precision.txt from them — the round trip the
    reference drives through system() (hgaprec.cc:533-549)."""
    import stat

    root = tmp_path / "graphchi-cpp"
    tooldir = root / "toolkits" / "collaborative_filtering"
    tooldir.mkdir(parents=True)
    stub = tooldir / "als"
    stub.write_text('''#!/usr/bin/env python3
import sys
train = [a.split("=", 1)[1] for a in sys.argv
         if a.startswith("--training=")][0]
d = [int(a.split("=", 1)[1]) for a in sys.argv if a.startswith("--D=")][0]
for side, rows in (("_U.mm", 50), ("_V.mm", 30)):
    with open(train + side, "w") as f:
        f.write("%%MatrixMarket matrix array real general\\n%comment\\n")
        f.write(f"{rows} {d}\\n")
        for r in range(rows):
            f.write(" ".join(str(0.01 * (r + 1) * (c + 1))
                             for c in range(d)) + "\\n")
''')
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("GRAPHCHI_ROOT", str(root))

    out = str(tmp_path / "outchi")
    rc = cli.main(["-dir", str(dataset), "-n", "50", "-m", "30", "-k", "3",
                   "-outdir", out, "-chi", "-als"])
    assert rc == 0
    # stub ran and produced factors; CLI re-imported and ranked them
    assert os.path.exists(os.path.join(out, "chitrain.tsv_U.mm"))
    ranking = open(os.path.join(out, "ranking.tsv")).read().splitlines()
    assert ranking, "rank_foreign wrote no rows"
    # deterministic stub factors: score(u,i) ~ (u+1)(i+1); per user the
    # top-ranked unmasked item must carry the highest score column
    first = ranking[0].split("\t")
    assert len(first) == 4
    prec = open(os.path.join(out, "precision.txt")).read()
    assert prec.strip(), "precision.txt empty"


def test_metadata_readers_all_datasets(tmp_path):
    """Title metadata for all four dataset families (the -test/explore
    title chain): movielens movies.dat, netflix movie_titles.txt,
    mendeley titles.dat (line number = id, ratings.cc:771-790), and NYT
    nyt-titles.tsv."""
    from hgaprec_jax.data import readers

    (tmp_path / "movies.dat").write_text(
        "1::Toy Story (1995)::Animation\n7::Sabrina (1995)::Romance\n")
    ml = readers.read_movielens_metadata(str(tmp_path / "movies.dat"))
    assert ml[7] == ("Sabrina (1995)", "Romance")

    (tmp_path / "movie_titles.txt").write_text(
        "118,1996,The Bird Cage\n12263,2001,Shrek\n")
    nf = readers.read_netflix_metadata(str(tmp_path / "movie_titles.txt"))
    assert nf[118][0] == "The Bird Cage"

    (tmp_path / "titles.dat").write_text(
        "collaborative filtering for implicit feedback\n"
        "variational inference review\n")
    md = readers.read_mendeley_metadata(str(tmp_path / "titles.dat"))
    assert md[0][0].startswith("collaborative")
    assert md[1][0] == "variational inference review"

    (tmp_path / "nyt-titles.tsv").write_text(
        "3|Op-Ed: On Things\n9|World Briefing\n")
    ny = readers.read_nyt_metadata(str(tmp_path / "nyt-titles.tsv"))
    assert ny[9] == ("World Briefing", "")
