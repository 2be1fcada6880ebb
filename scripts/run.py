#!/usr/bin/env python
"""Canonical launcher with per-dataset presets (scripts/run.pl equivalent).

The reference's run.pl (run.pl:61-179) hard-codes N/M/rating-threshold
presets per dataset and assembles an hgaprec command line; smallrun.pl
carries subsampled variants. This launcher does the same for the
JAX CLI:

  python scripts/run.py -dataset movielens -dataloc DATA [-K 100]
        [-hier] [-bias] [-binary] [-novb] [-logl] [-hyp] [-label L]
        [-seed S] [-gen] [-msr] [-lda|-als|-wals|-climf|-nmf]
        [-mle-user|-mle-item] [-small] [-devices D] [-dry-run]

Presets (run.pl:62-65, 84-87, 109-112, 135-138, 158-161; smallrun.pl:33-47):
  netflix   N=480189  M=17770   threshold 4   (small: 40000 x 1800)
  nyt       N=1615675 M=107523  threshold 1   (small: 160000 x 10000)
  movielens N=6040    M=3681    threshold 4
  mendeley  N=80278   M=261248  threshold 1
  echonest  N=1019318 M=384546  threshold 1
-hyp appends "-a 0.01 -b 1 -c 0.01 -d 1" (run.pl:322-325); unlike the
reference (which ignores -a/-b/-c/-d, hgaprec.cc:13-20) these reach the
model here.
"""

import argparse
import os
import subprocess
import sys

PRESETS = {
    "netflix": dict(n=480189, m=17770, threshold=4),
    "nyt": dict(n=1615675, m=107523, threshold=1),
    "movielens": dict(n=6040, m=3681, threshold=4),
    "mendeley": dict(n=80278, m=261248, threshold=1),
    "echonest": dict(n=1019318, m=384546, threshold=1),
}
SMALL = {  # smallrun.pl subsampled configs
    "netflix": dict(n=40000, m=1800, threshold=4),
    "nyt": dict(n=160000, m=10000, threshold=1),
}
BATCH_RFREQ = 10  # run.pl:27
DEFAULT_K = 100   # run.pl:32


def build_cmd(a) -> list:
    preset = (SMALL if a.small else PRESETS).get(a.dataset)
    if preset is None:
        sys.exit(f"no {'small ' if a.small else ''}preset for {a.dataset!r}"
                 f" (choose from {sorted(PRESETS)})")
    loc = os.path.join(a.dataloc, a.dataset)
    cmd = [sys.executable, "-m", "hgaprec_jax.cli",
           "-dir", loc, "-n", str(preset["n"]), "-m", str(preset["m"]),
           "-k", str(a.K), "-rfreq", str(a.rfreq),
           "-rating-threshold", str(preset["threshold"])]
    if a.gen:
        cmd += ["-gen-ranking"]
    if a.msr:
        cmd += ["-msr"]
    for tool, flags in (("als", ["-chi", "-als"]), ("wals", ["-chi", "-wals"]),
                        ("climf", ["-chi", "-climf"]),
                        ("nmf", ["-chi", "-chinmf"]), ("lda", ["-lda"])):
        if getattr(a, tool):
            cmd += flags
    if a.mle_user:
        cmd += ["-mle-user"]
    if a.mle_item:
        cmd += ["-mle-item"]
    # run.pl process() tail (run.pl:320-348)
    if a.hyp:
        cmd += ["-a", "0.01", "-b", "1", "-c", "0.01", "-d", "1"]
    if a.label:
        cmd += ["-label", a.label]
    if a.seed:
        cmd += ["-seed", str(a.seed)]
    if a.binary:
        cmd += ["-binary-data"]
    if a.bias:
        cmd += ["-bias"]
    if a.hier:
        cmd += ["-hier"]
    if a.novb:
        cmd += ["-novb"]
    if a.logl:
        cmd += ["-logl"]
    if a.devices > 1:
        cmd += ["-devices", str(a.devices)]
    return cmd


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-dataset", required=True, choices=sorted(PRESETS))
    p.add_argument("-dataloc", default="data",
                   help="prefix path; dataset dir is <dataloc>/<dataset>")
    p.add_argument("-K", type=int, default=DEFAULT_K)
    p.add_argument("-rfreq", type=int, default=BATCH_RFREQ)
    for f in ("hier", "bias", "binary", "novb", "logl", "hyp", "gen", "msr",
              "lda", "als", "wals", "climf", "nmf", "mle-user", "mle-item",
              "small", "dry-run"):
        p.add_argument(f"-{f}", dest=f.replace("-", "_"),
                       action="store_true")
    p.add_argument("-label", default="")
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("-devices", type=int, default=0)
    a = p.parse_args()

    cmd = build_cmd(a)
    print("+ " + " ".join(cmd))
    if a.dry_run:
        return 0
    return subprocess.call(cmd)


if __name__ == "__main__":
    sys.exit(main())
