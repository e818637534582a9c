"""The port's launchers on the CPU, as subprocesses:
``python -m repro_torch.launch.train --arch granite-3-8b --reduced
--steps 4 --device cpu`` with ``--ckpt-dir``, then again with more steps
to resume from its checkpoint, and ``python -m repro_torch.launch.serve
--reduced --device cpu``: each exits 0 and prints what the reference's
prints.  Without ``--device`` (the card) and without CUDA, each raises."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 240


def _run(*argv, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", *argv], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=TIMEOUT)


def test_train_launcher_trains_and_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    args = ["repro_torch.launch.train", "--arch", "granite-3-8b",
            "--reduced", "--batch", "4", "--seq", "32", "--device", "cpu",
            "--ckpt-dir", ck, "--ckpt-every", "2", "--log-every", "2"]
    first = _run(*args, "--steps", "4", cwd=tmp_path)
    assert first.returncode == 0, first.stderr[-3000:]
    assert "[power] stagger ramp-in: 8 racks" in first.stdout
    assert "[ckpt] saved step 4" in first.stdout
    assert "done: 4 steps" in first.stdout
    assert sorted(os.listdir(ck)) == ["step_0000000002", "step_0000000004"]
    again = _run(*args, "--steps", "6", cwd=tmp_path)
    assert again.returncode == 0, again.stderr[-3000:]
    assert "[ckpt] resumed from step 4" in again.stdout
    assert "step     6 loss" in again.stdout and "done: 2 steps" in again.stdout


def test_serve_launcher_generates(tmp_path):
    out = _run("repro_torch.launch.serve", "--reduced", "--device", "cpu",
               "--batch", "2", "--gen", "8", cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "generated 2x8 tokens" in out.stdout


@pytest.mark.parametrize("module", ["train", "serve"])
def test_launchers_without_a_card_raise(monkeypatch, module):
    import torch
    from repro_torch.launch import serve, train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = {"train": train.main, "serve": serve.main}[module]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--reduced", "--steps", "1"] if module == "train"
             else ["--reduced"])
