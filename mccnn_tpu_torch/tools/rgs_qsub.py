"""Cluster-scheduler variant of the hyperparameter search over the port's
command line (the reference's rgs_qsub.py: PBS qsub/qstat job driving,
rgs_qsub.py:11-158).

    python -m mccnn_tpu_torch.tools.rgs_qsub <dataset> <arch> <action> <net_fname>

Jobs are submitted through a scheduler command template (PBS ``qsub``
by default; any batch system with a submit/poll pair works); each job
runs ``python -m mccnn_tpu_torch`` with the package's directory on
``PYTHONPATH``. Results are collected from the job stdout files (score
= last token, 1.0 when it is not a number), and SIGINT/SIGTERM delete
outstanding jobs (rgs_qsub.py:95-101).
"""

from __future__ import annotations

import os
import random
import shlex
import signal
import subprocess
import sys
import time

from mccnn_tpu_torch.tools import FAILED, PACKAGE_ROOT, hs, last_score

SUBMIT = ["qsub"]          # submit command; reads the job script on stdin
POLL = ["qstat"]           # returns nonzero/empty when the job is done
DELETE = ["qdel"]          # cancel a job
JOB_DIR = "qsub_jobs"

# the kitti test_te grid of the slow, ad and census archs (hs.grid_for)
PARAMS = hs._CBCA + hs._SGM_COMMON

outstanding: set[str] = set()


def cleanup(signum, frame):
    for job in outstanding:
        subprocess.run(DELETE + [job], capture_output=True)
    sys.exit(1)


def launcher() -> str:
    """The start of a job's command: the port's command line, with the
    package's directory first on ``PYTHONPATH``."""
    return (f"PYTHONPATH={shlex.quote(PACKAGE_ROOT)}"
            f"${{PYTHONPATH:+:$PYTHONPATH}} {sys.executable} -m mccnn_tpu_torch")


def submit(dataset, arch, action, net_fname, ps, idx):
    os.makedirs(JOB_DIR, exist_ok=True)
    flags = " ".join(f"-{k} {v}" for k, v in ps.items())
    net = f"-net_fname {net_fname}" if net_fname and net_fname != "-" else ""
    out = os.path.abspath(os.path.join(JOB_DIR, f"job_{idx}.out"))
    script = (f"#!/bin/sh\ncd {os.getcwd()}\n"
              f"{launcher()} {dataset} {arch} -a {action} "
              f"{net} {flags} > {out} 2>&1\n")
    r = subprocess.run(SUBMIT, input=script, capture_output=True, text=True)
    job_id = r.stdout.strip().split()[0] if r.stdout.strip() else ""
    return job_id, out, ps


def read_score(out: str) -> float:
    """The score in a job's output file: its last token, or
    :data:`FAILED` when the file is missing or that token is not a
    number."""
    try:
        with open(out) as f:
            text = f.read()
    except OSError:
        return FAILED
    return last_score(text)


def wait_all(jobs):
    results = []
    for job_id, out, ps in jobs:
        while True:
            r = subprocess.run(POLL + [job_id], capture_output=True, text=True)
            if r.returncode != 0 or not r.stdout.strip():
                break
            time.sleep(10)
        outstanding.discard(job_id)
        results.append((read_score(out), ps))
    return results


def main() -> None:
    dataset, arch, action, net_fname = sys.argv[1:5]
    signal.signal(signal.SIGINT, cleanup)
    signal.signal(signal.SIGTERM, cleanup)
    rng = random.Random(42)
    idx = 0
    while True:
        batch = []
        for _ in range(4):
            ps = {k: rng.choice(vs) for k, vs in PARAMS}
            if ps["pi1"] > ps["pi2"]:
                continue
            job = submit(dataset, arch, action, net_fname, ps, idx)
            outstanding.add(job[0])
            batch.append(job)
            idx += 1
        for score, ps in wait_all(batch):
            print(" ".join([str(score)] +
                           [f"-{k} {v}" for k, v in ps.items()]), flush=True)


if __name__ == "__main__":
    main()
