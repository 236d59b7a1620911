"""The port's command line: the ``-a time`` protocol."""

import pytest

from mccnn_tpu_torch import cli


@pytest.mark.parametrize("arch,runs", [("fast", 30), ("slow", 3),
                                       ("census", 3)])
def test_time_takes_the_reference_run_count(arch, runs, monkeypatch, capsys):
    """``-a time`` runs one warm-up, then the fastest of 30 runs for the
    fast arch and of 3 for the others (mccnn_tpu/cli.py:113), also on
    the CPU; ``stereo_predict`` is stubbed with a counter."""
    calls = []

    def fake_predict(cfg, params, x0, x1, disp_max, device=None):
        calls.append((tuple(x0.shape), disp_max, device.type))

    monkeypatch.setattr(cli, "stereo_predict", fake_predict)
    monkeypatch.setattr(cli, "load_params", lambda cfg: None)
    cli.main(["kitti", arch, "-a", "time", "-backend", "cpu"])
    assert calls == [((350, 1242), 228, "cpu")] * (1 + runs)
    best = float(capsys.readouterr().out.strip().splitlines()[-1])
    assert 0.0 <= best < 1.0
