"""Coordinated multi-worker hyperparameter search over the port's command
line (the reference's rgs.py: leveled random-restart hill climbing over
ssh workers, rgs.py:9-135).

    python -m mccnn_tpu_torch.tools.rgs <dataset> <arch> <action> <net_fname>

Workers are (host, extra-flags) pairs; jobs are dispatched over a
process pool. A local worker runs ``python -m mccnn_tpu_torch`` on its
card, a remote one through ``ssh host "cd mc-cnn_tpu && <python> -m
mccnn_tpu_torch ..."``. A failed worker scores 1 (rgs.py:89-91), and so
does a child that exits non-zero or whose last token is not a number
(the JAX package's copy, tools/rgs.py, scores the last flag such a
child echoed). One process drives one card, so the reference's ``-gpu
N`` entries become one entry a card (``-gpu N`` in its flags) or a
host.
"""

from __future__ import annotations

import multiprocessing as mp
import random
import subprocess
import sys

from mccnn_tpu_torch.tools import FAILED, cli_command, cli_env, hs, score_of

# (host, extra flag string); 'localhost' runs without ssh
WORKERS = [
    ("localhost", ""),
]

# the kitti test_te grid of the slow, ad and census archs (hs.grid_for)
PARAMS = hs._CBCA + hs._SGM_COMMON


def job_command(dataset, arch, action, net_fname, ps, worker_id) -> list[str]:
    """The command of one job on worker ``worker_id``."""
    host, extra = WORKERS[worker_id % len(WORKERS)]
    flags = []
    for k, v in ps.items():
        flags += [f"-{k}", str(v)]
    cmd = cli_command(dataset, arch, "-a", action)
    if net_fname and net_fname != "-":
        cmd += ["-net_fname", net_fname]
    cmd += extra.split() + flags
    if host != "localhost":
        cmd = ["ssh", host, " ".join(["cd", "mc-cnn_tpu", "&&"] + cmd)]
    return cmd


def run_job(args):
    (dataset, arch, action, net_fname, ps, worker_id) = args
    cmd = job_command(dataset, arch, action, net_fname, ps, worker_id)
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=24 * 3600, env=cli_env())
    except (OSError, subprocess.SubprocessError):
        return FAILED, ps  # rgs.py:89-91
    return score_of(out.returncode, out.stdout), ps


def neighbors(ps):
    for k, vs in PARAMS:
        i = vs.index(ps[k]) if ps[k] in vs else 0
        for j in (i - 1, i + 1):
            if 0 <= j < len(vs):
                q = dict(ps)
                q[k] = vs[j]
                if q.get("pi1", 0) <= q.get("pi2", 1e9):
                    yield q


def main() -> None:
    dataset, arch, action, net_fname = sys.argv[1:5]
    rng = random.Random(42)
    visited = set()
    # spawn: workers start from a fresh import of this module
    pool = mp.get_context("spawn").Pool(len(WORKERS))

    def key(ps):
        return tuple(sorted(ps.items()))

    best_score, best = float("inf"), None
    while True:
        if best is None:
            cand = [{k: rng.choice(vs) for k, vs in PARAMS}
                    for _ in range(len(WORKERS))]
            cand = [c for c in cand if c["pi1"] <= c["pi2"]] or cand
        else:
            cand = [c for c in neighbors(best) if key(c) not in visited]
            if not cand:  # level exhausted: random restart (rgs.py:108-135)
                best = None
                continue
        jobs = [(dataset, arch, action, net_fname, c, i)
                for i, c in enumerate(cand)]
        for score, ps in pool.map(run_job, jobs):
            visited.add(key(ps))
            line = " ".join([str(score)] + [f"-{k} {v}" for k, v in ps.items()])
            print(line, flush=True)
            if score < best_score:
                best_score, best = score, ps


if __name__ == "__main__":
    main()
