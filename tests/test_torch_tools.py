"""The port's experiment drivers (``mccnn_tpu_torch/tools/``) against the
JAX package's copies in ``tools/``, which are loaded by path under names
of their own (``jax_tools_hs``, ...).

The grids, proposals, log lines, job scripts and the regression loop's
output equal the JAX copies'; the commands equal theirs after the
launcher (``python main.py`` there, ``python -m mccnn_tpu_torch`` here)
but for the two repairs: a child that exits non-zero scores 1.0 (the
JAX copies score the last flag it echoed), and the slow arch's
``test_te`` passes ``-net_fname`` beside ``-use_cache``. One test runs
the port's command line for real, on the CPU, through ``rgs.run_job``.
"""

import importlib.util
import os
import random
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from mccnn_tpu_torch import tools
from mccnn_tpu_torch.config import parse_args
from mccnn_tpu_torch.data.datasets import make_synthetic_kitti
from mccnn_tpu_torch.data.png16 import write_png16
from mccnn_tpu_torch.tools import hs, predict_kitti, rgs, rgs_qsub
from mccnn_tpu_torch.train.evaluate import action_eval

ROOT = Path(__file__).resolve().parents[1]
PORT_LAUNCHER = [sys.executable, "-m", "mccnn_tpu_torch"]
JAX_LAUNCHER = [sys.executable, "main.py"]


def _load_jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    saved = list(sys.path)  # predict_kitti.py puts the repo root first
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


JHS, JRGS, JQSUB, JPREDICT = (_load_jax_tool(n) for n in
                              ("hs", "rgs", "rgs_qsub", "predict_kitti"))

# the (dataset, arch, action) searches of tests/test_contracts.py
COMBOS = [
    ("kitti", "slow", "train_tr"), ("kitti2015", "slow", "train_tr"),
    ("kitti", "slow", "test_te"), ("kitti", "ad", "test_te"),
    ("kitti2015", "census", "test_te"), ("kitti", "fast", "test_te"),
    ("mb", "slow", "train_tr"), ("kitti", "fast", "train_tr"),
    ("mb", "fast", "train_tr"), ("mb", "fast", "test_te"),
    ("mb", "slow", "test_te"), ("kitti", "fast", "da"),
]
METHODS = ("random", "hillclimb_slow", "hillclimb_fast", "hillclimb_dim")


class Stop(BaseException):
    """Ends a search loop from a stub: the JAX copy catches Exception
    around its child (tools/hs.py:223)."""


def _log_line(score, dataset, arch, action, ps, grid):
    toks = [str(score), dataset, arch, action]
    for k, _ in grid:
        toks += [f"-{k}", str(ps[k])]
    return " ".join(toks)


# --- equal tables and draws ------------------------------------------------

@pytest.mark.parametrize("combo", COMBOS, ids="-".join)
def test_grid_for_is_the_jax_copys(combo):
    assert hs.grid_for(*combo) == JHS.grid_for(*combo)


def test_grid_for_refuses_what_the_jax_copy_refuses():
    for mod in (hs, JHS):
        with pytest.raises(SystemExit, match=r"no search grid for "
                           r"\(kitti, census, train_tr\)"):
            mod.grid_for("kitti", "census", "train_tr")
    assert hs.METHODS == JHS.METHODS


def test_valid_is_the_jax_copys():
    cases = [{}, {"pi1": 1.0}, {"pi1": 4.0, "pi2": 8.0},
             {"pi1": 8.0, "pi2": 8.0}, {"pi1": 10.0, "pi2": 8.0},
             {"lr": 0.01, "pi2": 2.0}]
    assert [hs.valid(c) for c in cases] == [JHS.valid(c) for c in cases]
    assert [hs.valid(c) for c in cases] == [True] * 4 + [False, True]


def test_parse_log_is_the_jax_copys(tmp_path):
    grid = hs.grid_for("kitti", "fast", "test_te")
    mid = {k: vs[len(vs) // 2] for k, vs in grid}
    low = {k: vs[0] for k, vs in grid}
    log = tmp_path / "hs_log.3"
    log.write_text("\n".join([
        _log_line(0.031, "kitti", "fast", "test_te", mid, grid),
        _log_line(0.02, "kitti", "slow", "test_te", low, grid),
        "garbage line",
        "",
        "nan kitti fast",
        "abc kitti fast test_te -pi1 1.0",
        _log_line(0.045, "kitti", "fast", "test_te", low, grid) + " -pi1",
        "0.5 kitti fast test_te -pi1 x -pi2 8.0",
        _log_line(1.0, "kitti", "fast", "train_tr", mid, grid),
    ]) + "\n")
    got = hs.parse_log([str(log)], "kitti", "fast", "test_te")
    assert got == JHS.parse_log([str(log)], "kitti", "fast", "test_te")
    assert [s for s, _ in got] == [0.031, 0.045, 0.5]


@pytest.mark.parametrize("method", METHODS)
def test_propose_draws_as_the_jax_copy(method):
    """50 proposals from two generators of one seed, equal one by one,
    over every grid, hill-climbing from two logged points."""
    for combo in COMBOS:
        grid = hs.grid_for(*combo)
        results = [(0.5, {k: float(vs[-1]) for k, vs in grid}),
                   (0.25, {k: float(vs[len(vs) // 3]) for k, vs in grid})]
        for seed in (0, 7):
            mine, theirs = random.Random(seed), random.Random(seed)
            for _ in range(50):
                a = hs.propose(method, grid, mine, results)
                b = JHS.propose(method, grid, theirs, results)
                assert a == b
                assert hs.valid(a)
            assert mine.getstate() == theirs.getstate()


def test_rgs_tables_are_the_jax_copys():
    assert rgs.PARAMS == JRGS.PARAMS
    assert rgs_qsub.PARAMS == JQSUB.PARAMS
    assert rgs.WORKERS == JRGS.WORKERS
    for seed in range(5):
        r = random.Random(seed)
        p = {k: r.choice(vs) for k, vs in rgs.PARAMS}
        assert list(rgs.neighbors(p)) == list(JRGS.neighbors(p))
    off = dict(p, L1=9)  # a value off the grid starts at its first entry
    assert list(rgs.neighbors(off)) == list(JRGS.neighbors(off))


def test_launcher_and_environment():
    assert tools.cli_command("kitti", "fast") == PORT_LAUNCHER + ["kitti",
                                                                  "fast"]
    env = tools.cli_env()
    assert env["PYTHONPATH"].split(os.pathsep)[0] == str(ROOT)
    assert tools.score_of(0, "kitti fast\n1.5 0.25\n0.0312\n") == 0.0312
    assert tools.score_of(1, "kitti slow -a test_te -blur_t 5\n") == 1.0
    assert tools.score_of(0, "") == 1.0
    assert tools.score_of(0, "err (main.lua:892-902)") == 1.0


# --- one search run of each copy against a stub ----------------------------

def _drive_hs(mod, monkeypatch, capsys, tmp_path, argv, log_name, rc,
              stdout_of, seed=5):
    """Run ``mod.main()`` until its second child: returns (the first
    child's command and keywords, the printed text, the log's bytes)."""
    calls = []

    def run(cmd, **kw):
        calls.append((cmd, kw))
        if len(calls) == 2:
            raise Stop
        return subprocess.CompletedProcess(cmd, rc, stdout_of(cmd), "boom")

    monkeypatch.setattr(mod.subprocess, "run", run)
    monkeypatch.setattr(mod, "random", types.SimpleNamespace(
        Random=lambda: random.Random(seed)))
    monkeypatch.setattr(sys, "argv", ["hs.py"] + argv)
    monkeypatch.setenv("MCCNN_HS_LOG", str(tmp_path / log_name))
    capsys.readouterr()
    with pytest.raises(Stop):
        mod.main()
    printed = capsys.readouterr().out
    return calls[0], printed, (tmp_path / log_name).read_bytes()


def _ok(cmd):
    return "kitti fast -a test_te\n1.2 0.0312\n0.0312\n"


RUNS = [
    ("random", "kitti", "fast", "test_te"),
    ("random", "kitti", "slow", "test_te"),
    ("hillclimb_fast", "kitti", "ad", "test_te"),
    ("hillclimb_slow", "kitti2015", "census", "test_te"),
    ("hillclimb_dim", "mb", "fast", "test_te"),
    ("random", "kitti", "slow", "train_tr"),
    ("hillclimb_fast", "kitti", "fast", "da"),
]


@pytest.mark.parametrize("run", RUNS, ids="-".join)
def test_one_search_run_as_the_jax_copy(run, tmp_path, monkeypatch, capsys):
    method, dataset, arch, action = run
    monkeypatch.chdir(tmp_path)
    grid = hs.grid_for(dataset, arch, action)
    run_action = "train_tr" if action == "da" else action
    seed_ps = {k: vs[len(vs) // 2] for k, vs in grid}
    (tmp_path / "hs_log.1").write_text(
        _log_line(0.05, dataset, arch, run_action, seed_ps, grid) + "\n")
    argv = [method, dataset, arch, action, "net.npz"]
    (jcmd, _), jout, jlog = _drive_hs(JHS, monkeypatch, capsys, tmp_path,
                                      argv, "jax.log", 0, _ok)
    (pcmd, kw), pout, plog = _drive_hs(hs, monkeypatch, capsys, tmp_path,
                                       argv, "port.log", 0, _ok)
    assert jcmd[:2] == JAX_LAUNCHER and pcmd[:3] == PORT_LAUNCHER
    want = list(jcmd[2:])
    if run_action == "test_te" and arch == "slow":
        # repair (b): the net whose volumes cache/ holds
        assert "-net_fname" not in want
        want[want.index("-use_cache") + 1:
             want.index("-use_cache") + 1] = ["-net_fname", "net.npz"]
    assert pcmd[3:] == want
    assert kw["env"]["PYTHONPATH"].split(os.pathsep)[0] == str(ROOT)
    assert pout == jout and plog == jlog
    assert jout.startswith(f"0.0312 {dataset} {arch} {run_action} -")
    assert jlog.decode() == jout


def test_slow_test_te_with_no_net_passes_none():
    cmd = hs.run_command("kitti", "slow", "test_te", "-", ["-blur_t", "5"])
    assert cmd == PORT_LAUNCHER + ["kitti", "slow", "-a", "test_te",
                                   "-use_cache", "-blur_t", "5"]


# --- the fault the JAX copies carry ----------------------------------------

def _echo(cmd):
    """What a command line that fails after echoing its argv prints."""
    args = cmd[3:] if cmd[1] == "-m" else cmd[2:]
    return " ".join(args) + "\n"


@pytest.mark.parametrize("run", [
    ("random", "kitti", "slow", "test_te"),
    ("random", "kitti", "fast", "train_tr"),
    ("hillclimb_fast", "mb", "slow", "train_tr"),
], ids="-".join)
def test_a_failed_child_scores_one(run, tmp_path, monkeypatch, capsys):
    """tools/hs.py:222 reads the last token whatever the exit code: its
    failed slow test_te (`-blur_t 5` last) logs 5.0, a failed train_tr
    its `-lr`; the port's copy logs 1.0."""
    method, dataset, arch, action = run
    monkeypatch.chdir(tmp_path)
    if action == "test_te":
        def stdout_of(cmd):  # the command line's refusal, reproduced
            return "kitti slow -a test_te -use_cache -data_dir d -blur_t 5\n"
    else:
        stdout_of = _echo
    argv = [method, dataset, arch, action, "-"]
    (jcmd, _), jout, _ = _drive_hs(JHS, monkeypatch, capsys, tmp_path, argv,
                                   "jax.log", 1, stdout_of)
    (pcmd, _), pout, plog = _drive_hs(hs, monkeypatch, capsys, tmp_path,
                                      argv, "port.log", 1, stdout_of)
    jscore = float(jout.split()[0])
    if action == "test_te":
        assert jscore == 5.0
    else:
        assert jcmd[-2] == "-lr" and jscore == float(jcmd[-1]) < 0.05
    assert pout.split()[0] == "1.0" and plog.decode() == pout
    assert pout.split()[1:] == jout.split()[1:]


def test_rgs_run_job_as_the_jax_copy(monkeypatch):
    r = random.Random(3)
    ps = {k: r.choice(vs) for k, vs in rgs.PARAMS}
    job = ("kitti", "slow", "test_te", "net.npz", ps, 0)
    for rc, stdout_of, port_score, jax_score in (
            (0, _ok, 0.0312, 0.0312),
            (1, _echo, 1.0, float(ps["blur_t"]))):
        cmds = []

        def run(cmd, **kw):
            cmds.append(cmd)
            return subprocess.CompletedProcess(cmd, rc, stdout_of(cmd), "")

        monkeypatch.setattr(subprocess, "run", run)
        assert JRGS.run_job(job) == (jax_score, ps)
        assert rgs.run_job(job) == (port_score, ps)
        assert cmds[1][:3] == PORT_LAUNCHER and cmds[0][2:] == cmds[1][3:]
    remote = {}
    for mod in (JRGS, rgs):
        monkeypatch.setattr(mod, "WORKERS", [("gpu7", "-gpu 2")])
        cmds.clear()
        mod.run_job(job)  # through the stub: nothing reaches ssh
        remote[mod] = cmds[0]
    jremote, premote = remote.values()
    assert jremote[:2] == premote[:2] == ["ssh", "gpu7"]
    assert premote == rgs.job_command(*job)
    assert premote[2] == jremote[2].replace(
        " ".join(JAX_LAUNCHER), " ".join(PORT_LAUNCHER))
    assert premote[2].startswith("cd mc-cnn_tpu && " + " ".join(PORT_LAUNCHER))


# --- rgs_qsub --------------------------------------------------------------

def test_qsub_job_script_as_the_jax_copys(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ps = {k: vs[1] for k, vs in rgs_qsub.PARAMS}
    scripts = []

    def run(cmd, input=None, **kw):
        scripts.append(input)
        return subprocess.CompletedProcess(cmd, 0, "4711.pbs\n", "")

    monkeypatch.setattr(subprocess, "run", run)
    jjob = JQSUB.submit("kitti", "ad", "test_te", "-", ps, 3)
    pjob = rgs_qsub.submit("kitti", "ad", "test_te", "-", ps, 3)
    assert jjob == pjob == ("4711.pbs", str(tmp_path / "qsub_jobs" /
                                            "job_3.out"), ps)
    jlines, plines = (s.splitlines() for s in scripts)
    assert len(jlines) == len(plines) == 3 and jlines[:2] == plines[:2]
    jrest = jlines[2].removeprefix(" ".join(JAX_LAUNCHER) + " ")
    prest = plines[2].removeprefix(rgs_qsub.launcher() + " ")
    assert jrest != jlines[2] and prest != plines[2] and jrest == prest

    # the launcher's PYTHONPATH reaches the package from another directory
    monkeypatch.undo()
    probe = rgs_qsub.launcher().replace(
        "-m mccnn_tpu_torch",
        "-c 'import mccnn_tpu_torch as m; print(m.__file__)'")
    out = subprocess.run(["sh", "-c", probe], cwd=tmp_path, check=True,
                         capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH="/nonexistent"))
    assert out.stdout.strip() == str(ROOT / "mccnn_tpu_torch" /
                                     "__init__.py")


def test_qsub_wait_all_as_the_jax_copys(tmp_path, monkeypatch):
    (tmp_path / "a.out").write_text("kitti ad -a test_te\n0.9 0.0312\n"
                                    "0.0312\n")
    (tmp_path / "c.out").write_text("Traceback ...\nSystemExit: boom\n")
    jobs = [(f"{i}.pbs", str(tmp_path / f"{n}.out"), {"L1": i})
            for i, n in enumerate("abc")]
    want = [(0.0312, {"L1": 0}), (1.0, {"L1": 1}), (1.0, {"L1": 2})]
    for mod in (JQSUB, rgs_qsub):
        polls, sleeps = [], []

        def run(cmd, **kw):  # each job runs for one poll, then is gone
            polls.append(cmd)
            running = polls.count(cmd) == 1
            return subprocess.CompletedProcess(
                cmd, 0, "R\n" if running else "", "")

        monkeypatch.setattr(subprocess, "run", run)
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            sleep=sleeps.append))
        mod.outstanding.update(j[0] for j in jobs)
        assert mod.wait_all(jobs) == want
        assert polls == [mod.POLL + [j[0]] for j in jobs for _ in (0, 1)]
        assert sleeps == [10] * 3 and not mod.outstanding


# --- predict_kitti ---------------------------------------------------------

def test_predict_kitti_prints_as_the_jax_copy(tmp_path, monkeypatch,
                                              capsys):
    pytest.importorskip("PIL")
    root = tmp_path / "training"
    rng = np.random.RandomState(4)
    gts = {}
    for i in (0, 1):
        for sub in ("image_0", "image_1", "disp_noc"):
            (root / sub).mkdir(parents=True, exist_ok=True)
        for sub in ("image_0", "image_1"):
            write_png16(rng.rand(40, 80) * 200, str(root / sub /
                                                    f"{i:06d}_10.png"))
        gt = np.where(rng.rand(40, 80) < 0.3, 0,
                      rng.randint(1, 200, (40, 80)) / 4.0)
        write_png16(gt, str(root / "disp_noc" / f"{i:06d}_10.png"))
        gts[i] = gt.astype(np.float32)
    monkeypatch.chdir(tmp_path)
    outs = {}
    for mod in (JPREDICT, predict_kitti):
        cmds = []

        def run(cmd, **kw):  # a prediction off by 0-7 px
            cmds.append((cmd, kw))
            i = int(Path(cmd[cmd.index("-left") + 1]).stem[:6])
            off = np.random.RandomState(i).randint(0, 8, (40, 80))
            (gts[i] + off).astype(np.float32).reshape(1, 1, 40, 80) \
                .tofile("disp.bin")
            return subprocess.CompletedProcess(cmd, 0, b"", b"")

        monkeypatch.setattr(subprocess, "run", run)
        monkeypatch.setattr(sys, "argv", ["predict_kitti.py", "n.npz",
                                          str(root), "3"])
        capsys.readouterr()
        mod.main()
        outs[mod] = capsys.readouterr().out, cmds
    (jout, jcmds), (pout, pcmds) = outs.values()
    assert pout == jout
    lines = pout.splitlines()
    assert [ln.split()[0] for ln in lines[:2]] == ["0", "1"] and len(lines) == 3
    assert 0.3 < float(lines[2]) < 0.8
    assert len(jcmds) == len(pcmds) == 2
    for (jc, jkw), (pc, pkw) in zip(jcmds, pcmds):
        assert pc[:3] == PORT_LAUNCHER and pc[3:] == jc[2:]
        assert pc[-2:] == ["-net_fname", "n.npz"]
        assert pkw["check"] and jkw["check"]


# --- one real run of the port's command line on the CPU --------------------

def test_rgs_run_job_runs_the_ports_cli(tmp_path, monkeypatch, capsys):
    """kitti ad test_te on a synthetic set at 40x80 (D=8 in the images;
    the evaluation's D is KITTI's 228) through a child with -backend cpu:
    its score is the last token action_eval prints in this process."""
    make_synthetic_kitti(str(tmp_path / "data.kitti"), n_images=2,
                         height=40, width=80, disp_max=8)
    monkeypatch.chdir(tmp_path)
    extra = f"-backend cpu -data_dir {tmp_path}"
    monkeypatch.setattr(rgs, "WORKERS", [("localhost", extra)])
    r = random.Random(11)
    ps = {k: r.choice(vs) for k, vs in rgs.PARAMS}
    score, got_ps = rgs.run_job(("kitti", "ad", "test_te", "-", ps, 0))
    assert got_ps is ps

    flags = []
    for k, v in ps.items():
        flags += [f"-{k}", str(v)]
    cfg, tail = parse_args(["kitti", "ad", "-a", "test_te"]
                           + extra.split() + flags)
    capsys.readouterr()
    action_eval(cfg, tail)
    want = float(capsys.readouterr().out.split()[-1])
    assert 0.0 <= want < 1.0
    assert score == want
