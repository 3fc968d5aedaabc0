"""The port's diagnostic CLI (concrete_tpu_torch.diagnose): twins of
tests/test_diagnose.py's cases of the wait-mode state machine, with the
probe subprocess scripted (no GPU needed), and the one-shot report on a
machine without CUDA."""

import subprocess

from concrete_tpu_torch import diagnose


def _patch_run(monkeypatch, results):
    """Feed wait() a scripted sequence of probe outcomes."""
    seq = iter(results)

    def fake_run(cmd, **kw):
        r = next(seq)
        if r == "timeout":
            raise subprocess.TimeoutExpired(cmd, kw.get("timeout"))
        rc, out = r
        return subprocess.CompletedProcess(cmd, rc, stdout=out, stderr="")

    monkeypatch.setattr(subprocess, "run", fake_run)
    monkeypatch.setattr("time.sleep", lambda s: None)


LIVE = (0, "LIVE 256.0 NVIDIA H100 80GB HBM3\n")


def test_wait_returns_0_when_probe_goes_live(monkeypatch):
    _patch_run(monkeypatch, ["timeout", LIVE])
    assert diagnose.wait(max_wait_s=600, probe_timeout_s=1, interval_s=1) == 0


def test_wait_returns_1_on_budget_exhaustion(monkeypatch):
    _patch_run(monkeypatch, ["timeout"] * 50)
    # interval > budget: exactly one probe, then give up
    assert diagnose.wait(max_wait_s=0.5, probe_timeout_s=1, interval_s=1) == 1


def test_wait_treats_probe_error_as_not_live(monkeypatch):
    _patch_run(monkeypatch,
               [(1, "RuntimeError: CUDA error: no kernel image\n"), LIVE])
    assert diagnose.wait(max_wait_s=600, probe_timeout_s=1, interval_s=1) == 0


def test_wait_rejects_silent_cpu_fallback(monkeypatch):
    """A probe that finds no CUDA device must not count as live: a serving
    job would land on the CPU's plain versions."""
    _patch_run(monkeypatch, [(0, "NO_CUDA 0.0 cpu\n"), LIVE])
    assert diagnose.wait(max_wait_s=600, probe_timeout_s=1, interval_s=1) == 0
    _patch_run(monkeypatch, [(0, "NO_CUDA 0.0 cpu\n")] * 5)
    assert diagnose.wait(max_wait_s=0.5, probe_timeout_s=1, interval_s=1) == 1


def test_wait_allow_cpu_accepts_fallback(monkeypatch):
    _patch_run(monkeypatch, [(0, "NO_CUDA 0.0 cpu\n")])
    assert diagnose.wait(max_wait_s=600, probe_timeout_s=1, interval_s=1,
                         allow_cpu=True) == 0


def test_wait_probe_source_forces_host_pull():
    """The probe must pull a value computed on the card back to the host
    (.cpu()), so a live verdict means the device ran."""
    assert ".cpu()" in diagnose.PROBE_SRC and "cuda" in diagnose.PROBE_SRC


def test_probe_source_runs_here():
    """The real probe in a fresh interpreter: NO_CUDA on this CPU machine
    (LIVE on a GPU one)."""
    import sys

    r = subprocess.run([sys.executable, "-c", diagnose.PROBE_SRC],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    import torch

    tag = r.stdout.split()[0]
    assert tag == ("LIVE" if torch.cuda.is_available() else "NO_CUDA")


def test_main_reports_no_cuda(monkeypatch, capsys):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert diagnose.main(timeout_s=5) == 1
    out = capsys.readouterr().out
    assert "torch " in out and "no CUDA device" in out and "card:" in out


def test_main_reports_blocked_init(monkeypatch, capsys):
    import time

    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    monkeypatch.setattr(diagnose, "_device_init", lambda: time.sleep(30))
    assert diagnose.main(timeout_s=0.05) == 1
    assert "BLOCKED" in capsys.readouterr().out
