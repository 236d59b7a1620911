"""Hyperparameter search over the port's command line (the reference's
hs.py, hs.py:8-212).

    python -m mccnn_tpu_torch.tools.hs <method> <dataset> <arch> <action> <net_fname> [log ...]

Methods random / hillclimb_slow / hillclimb_fast / hillclimb_dim over
per-(dataset, arch, action) value grids (hs.py:14-153), with the ``da``
search alias (the augmentation grid, run as ``train_tr``, hs.py:14-35).
Each run proposes a configuration, launches ``python -m
mccnn_tpu_torch`` on it (on the card), takes the score from the last
token of its standard output (hs.py:209-211) and logs one line,
``score dataset arch action -k v ...``, printed and appended to
``$MCCNN_HS_LOG`` (default ``hs_log.0``). Hill-climb state is recovered
from the log files named on the command line, else ``hs_log.*``
(hs.py:159-177), so concurrent searches can share logs.

Two departures from the JAX package's copy (tools/hs.py): a child that
exits non-zero, or whose last token is not a number, scores 1.0 (that
copy scores the last flag its failed child echoed); and the slow arch's
``test_te`` passes ``-net_fname <net_fname>`` beside ``-use_cache``,
the net whose volumes ``cache/`` holds (that copy passes no net, which
the command line refuses).
"""

from __future__ import annotations

import glob
import os
import random
import subprocess
import sys

from mccnn_tpu_torch.tools import FAILED, cli_command, cli_env, score_of

METHODS = {"random", "hillclimb_slow", "hillclimb_fast", "hillclimb_dim"}

# value tables transcribed from the reference search spec (hs.py:14-153)
_DA = [  # hs.py:16-32 — augmentation search, runs train_tr
    ("hflip", [0]),
    ("vflip", [0]),
    ("rotate", [0, 3, 7, 14, 21, 28]),
    ("hscale", [1, 0.9, 0.8, 0.7]),
    ("scale", [1, 0.9, 0.8, 0.7]),
    ("trans", [0]),
    ("hshear", [0, 0.1, 0.2, 0.3]),
    ("brightness", [0, 0.5, 0.7, 1, 1.3]),
    ("contrast", [1, 1.1, 1.2, 1.3, 1.4, 1.5]),
    ("d_vtrans", [0, 0.5, 1, 1.5, 2]),
    ("d_rotate", [0, 3, 5]),
    ("d_hscale", [1, 0.9, 0.8]),
    ("d_hshear", [0, 0.1, 0.2, 0.3]),
    ("d_brightness", [0, 0.2, 0.3, 0.5, 0.7, 0.9]),
    ("d_contrast", [1, 1.1, 1.2]),
]

# shared stereo-method value columns (hs.py:54-102; KITTI slow, ad,
# census, and fast use the same columns — fast drops the CBCA rows)
_SGM_COMMON = [
    ("pi1", [0.25, 0.33, 0.44, 0.57, 0.76, 1.0, 1.32, 1.74, 2.3, 3.03, 4.0]),
    ("pi2", [8.0, 10.56, 13.93, 18.38, 24.25, 32.0, 42.22, 55.72, 73.52,
             97.01, 128.0]),
    ("sgm_q1", [3, 3.5, 4, 4.5, 5]),
    ("sgm_q2", [2, 2.5, 3, 3.5, 4, 4.5]),
    ("alpha1", [1.0, 1.25, 1.5, 1.75, 2.0, 2.25, 2.5, 2.75]),
    ("tau_so", [0.01, 0.02, 0.03, 0.05, 0.08, 0.13, 0.22, 0.36, 0.6, 1.0]),
    ("blur_sigma", [1.0, 1.29, 1.67, 2.15, 2.78, 3.59, 4.64, 5.99, 7.74,
                    10.0]),
    ("blur_t", [1, 2, 3, 4, 5, 6, 7]),
]
_CBCA = [
    ("L1", [0, 1, 2, 3, 4, 5, 6]),
    ("cbca_i1", [0, 2, 4, 6, 8]),
    ("cbca_i2", [0, 2, 4, 6, 8]),
    ("tau1", [0.01, 0.02, 0.03, 0.05, 0.08, 0.13, 0.22, 0.36, 0.6, 1.0]),
]
_MB_METHOD = [  # hs.py:135-149 — MB-scaled penalties, shorter blur_t
    ("pi1", [0.2, 0.3, 0.4, 0.6, 0.8, 1.0, 1.3, 1.7, 2.3, 3.0, 4.0]),
    ("pi2", [2.0, 2.6, 3.5, 4.6, 6.1, 8.0, 10.6, 13.9, 18.4, 24.3, 32.0]),
    ("sgm_q1", [3, 3.5, 4, 4.5, 5]),
    ("sgm_q2", [2, 2.5, 3, 3.5, 4, 4.5]),
    ("alpha1", [1.0, 1.25, 1.5, 1.75, 2.0, 2.25, 2.5, 2.75]),
    ("tau_so", [0.01, 0.02, 0.03, 0.05, 0.08, 0.13, 0.22, 0.36, 0.6, 1.0]),
    ("blur_sigma", [1.0, 1.29, 1.67, 2.15, 2.78, 3.59, 4.64, 5.99, 7.74,
                    10.0]),
    ("blur_t", [1, 2, 3, 4, 5]),
]


def grid_for(dataset: str, arch: str, action: str):
    """The (dataset, arch, action) → param grid dispatch of hs.py:14-153.
    `action` here is the *search* action — 'da' selects the augmentation
    grid (the run action is train_tr)."""
    kitti = dataset in ("kitti", "kitti2015")
    if action == "da":
        return _DA
    if kitti and action == "train_tr" and arch == "slow":
        return [  # hs.py:38-47
            ("l1", [3, 4, 5]),
            ("fm", [4, 5, 6, 7, 8]),
            ("l2", [3, 4, 5, 6]),
            ("nh2", [200, 300, 400, 500]),
            ("lr", [0.001, 0.003, 0.01]),
        ]
    if kitti and action == "test_te" and arch in ("slow", "ad", "census"):
        return _CBCA + _SGM_COMMON  # hs.py:54-91
    if kitti and action == "test_te" and arch == "fast":
        return list(_SGM_COMMON)  # hs.py:94-103
    if dataset == "mb" and action == "train_tr" and arch == "slow":
        return [  # hs.py:110-119
            ("l1", [3, 4, 5]),
            ("fm", [4, 5, 6, 7, 8]),
            ("l2", [2, 3, 4, 5]),
            ("nh2", [100, 200, 300, 400]),
            ("lr", [0.0003, 0.001, 0.003, 0.01]),
        ]
    if action == "train_tr" and arch == "fast":
        return [  # hs.py:126-130
            ("l1", [2, 3, 4, 5, 6]),
            ("fm", [64, 80, 96]),
            ("lr", [0.001, 0.002, 0.005, 0.01, 0.02]),
        ]
    if dataset == "mb" and action == "test_te":
        return _MB_METHOD
    raise SystemExit(f"no search grid for ({dataset}, {arch}, {action})")


def valid(ps: dict) -> bool:
    if "pi1" in ps and "pi2" in ps and ps["pi1"] > ps["pi2"]:
        return False  # constraint hs.py:69-70
    return True


def parse_log(log_files, dataset, arch, action):
    """(score, params-dict) per matching line:
    `score dataset arch action -k v -k v ...` (hs.py:162-168)."""
    results = []
    for fname in log_files:
        with open(fname) as f:
            lines = f.readlines()
        for line in lines:
            toks = line.split()
            if len(toks) < 4:
                continue
            try:
                score = float(toks[0])
            except ValueError:
                continue
            if toks[1:4] != [dataset, arch, action]:
                continue
            ps = {}
            it = iter(toks[4:])
            for k in it:
                if k.startswith("-"):
                    try:
                        ps[k[1:]] = float(next(it))
                    except (StopIteration, ValueError):
                        break
            results.append((score, ps))
    return results


def _indices_of(grid, ps: dict) -> list[int]:
    """Recover grid indices from logged values by nearest match
    (hs.py:171-178)."""
    x = []
    for name, vals in grid:
        cur = float(ps.get(name, vals[0]))
        x.append(min(range(len(vals)), key=lambda j: abs(float(vals[j]) - cur)))
    return x


def propose(method: str, grid, rng, results) -> dict:
    """One proposal as index vector semantics of hs.py:155-198."""
    while True:
        if method == "random" or not results:
            x = [rng.randrange(len(vals)) for _, vals in grid]
        else:
            _, best = min(results, key=lambda r: r[0])
            x = _indices_of(grid, best)
            if method == "hillclimb_dim":
                # one dimension, fully re-randomized (hs.py:181-183)
                i = rng.randrange(len(grid))
                x[i] = rng.randrange(len(grid[i][1]))
            else:
                # neighbor moves: every dim (fast) or one dim (slow)
                # (hs.py:184-195)
                dims = (range(len(grid)) if method == "hillclimb_fast"
                        else [rng.randrange(len(grid))])
                for i in dims:
                    ns = [x[i]]
                    if x[i] - 1 >= 0:
                        ns.append(x[i] - 1)
                    if x[i] + 1 < len(grid[i][1]):
                        ns.append(x[i] + 1)
                    x[i] = rng.choice(ns)
        ps = {grid[i][0]: grid[i][1][x[i]] for i in range(len(grid))}
        if valid(ps):
            return ps


def run_command(dataset: str, arch: str, action: str, net_fname: str,
                flags: list[str]) -> list[str]:
    """The command line of one run (hs.py:204-208): ``test_te`` reads
    the slow arch's volumes from ``cache/`` (``-use_cache``) and passes
    the net in any case, the one that made the cache for the slow arch;
    ``-`` names no net."""
    cmd = cli_command(dataset, arch, "-a", action)
    if action == "test_te":
        if arch == "slow":
            cmd += ["-use_cache"]
        if net_fname and net_fname != "-":
            cmd += ["-net_fname", net_fname]
    return cmd + flags


def search_run(method: str, dataset: str, arch: str, action: str,
               net_fname: str, grid, rng, log_files, log_out: str) -> str:
    """One run of the search: propose from the logs, run the command
    line, score it, print and append the log line, which it returns."""
    results = (parse_log(log_files, dataset, arch, action)
               if method != "random" else [])
    ps = propose(method, grid, rng, results)
    flags = []
    for k, _ in grid:  # grid order, so recovery stays aligned
        flags += [f"-{k}", str(ps[k])]
    cmd = run_command(dataset, arch, action, net_fname, flags)
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=24 * 3600, env=cli_env())
    except (OSError, subprocess.SubprocessError) as e:
        print(f"FAILED: {e}", file=sys.stderr)
        score = FAILED
    else:
        score = score_of(out.returncode, out.stdout)
        if out.returncode != 0:
            print(f"FAILED: exit code {out.returncode}: "
                  f"{out.stderr.strip()[-2000:]}", file=sys.stderr)
    line = " ".join([str(score), dataset, arch, action] + flags)
    print(line, flush=True)
    with open(log_out, "a") as f:
        f.write(line + "\n")
    return line


def main() -> None:
    method, dataset, arch, action, net_fname = sys.argv[1:6]
    if method not in METHODS:
        raise SystemExit(f"method {method!r} is not one of {sorted(METHODS)}")
    if dataset not in ("kitti", "kitti2015", "mb"):
        raise SystemExit(f"unknown dataset {dataset!r}")
    if arch not in ("fast", "slow", "ad", "census"):
        raise SystemExit(f"unknown arch {arch!r}")
    if action not in ("test_te", "train_tr", "da"):
        raise SystemExit(f"unknown action {action!r}")

    grid = grid_for(dataset, arch, action)
    if action == "da":
        action = "train_tr"  # the run action (hs.py:14-15)
    log_files = sys.argv[6:] or glob.glob("hs_log.*")
    rng = random.Random()
    log_out = os.environ.get("MCCNN_HS_LOG", "hs_log.0")
    while True:
        search_run(method, dataset, arch, action, net_fname, grid, rng,
                   log_files, log_out)


if __name__ == "__main__":
    main()
