"""``python -m repro_torch.launch.train`` across ranks, on the CPU
(``torch.distributed.run``, gloo, ``--device cpu``, reduced h2o-danube-1.8b):

* two ranks (a (1, 2) mesh: the reference's ``available_mesh`` of two
  devices) print the reference's ``mesh=`` line and log every step's loss
  within 1e-5 relative of the one-process launcher's;
* an elastic rerun: four ranks on a (2, 2) mesh (``--model-parallel 2``)
  sent SIGTERM after their step-5 line save a checkpoint together, and two
  ranks resume from it on a (1, 2) mesh and end, rc 0, on the one-process
  run's last loss within 1e-5 relative.
"""
import os
import pathlib
import signal
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEPS = 24
SIGTERM_AFTER = 5          # the rest leave the signal time to reach every rank
LOSS_RTOL = 1e-5


def _cmd(ranks, *extra):
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(ranks)] if ranks else [sys.executable]
    return run + ["-m", "repro_torch.launch.train", "--arch", "h2o-danube-1.8b", "--reduced",
                  "--device", "cpu", "--steps", str(STEPS), "--batch", "4", "--seq", "32",
                  "--log-every", "1", *extra]


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")


def _losses(stdout):
    return {int(ln.split()[1]): float(ln.split()[3]) for ln in stdout.splitlines()
            if ln.startswith("step ")}


@pytest.fixture(scope="module")
def one_process():
    out = subprocess.run(_cmd(0), capture_output=True, text=True, cwd=ROOT, env=_env(),
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "mesh={'data': 1, 'model': 1}" in out.stdout.splitlines()[0]
    return _losses(out.stdout)


def _close(a, b):
    return abs(a - b) <= LOSS_RTOL * abs(b)


def test_two_ranks_log_the_one_process_losses(one_process):
    out = subprocess.run(_cmd(2), capture_output=True, text=True, cwd=ROOT, env=_env(),
                         timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("arch=h2o-danube-1.8b device=cpu params~119,104 "
                               "mesh={'data': 1, 'model': 2} transport=gloo"), lines[0]
    assert lines[-1] == "done"
    got = _losses(out.stdout)
    assert sorted(got) == sorted(one_process) and len(got) == STEPS
    assert all(_close(got[s], one_process[s]) for s in got), (got, one_process)


def test_sigterm_on_four_ranks_resumes_on_two(one_process, tmp_path):
    ckpt = ("--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", str(SIGTERM_AFTER))
    a = subprocess.Popen(_cmd(4, "--model-parallel", "2", *ckpt), stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True, cwd=ROOT, env=_env())
    seen = []
    try:
        for line in a.stdout:
            seen.append(line)
            if line.startswith(f"step {SIGTERM_AFTER:5d}"):
                a.send_signal(signal.SIGTERM)
        a.wait(timeout=120)
    finally:
        a.kill()
    assert seen[0].startswith("arch=h2o-danube-1.8b") and "mesh={'data': 2, 'model': 2}" in seen[0]
    assert any(ln.startswith("SIGTERM: checkpointing") for ln in seen), seen
    saved = sorted(p.name for p in (tmp_path / "ck").glob("step_*"))
    assert saved and SIGTERM_AFTER < int(saved[-1].split("_")[1]) < STEPS, saved
    b = subprocess.run(_cmd(2, *ckpt), capture_output=True, text=True, cwd=ROOT, env=_env(),
                       timeout=240)
    assert b.returncode == 0, b.stderr[-3000:]
    lines = b.stdout.splitlines()
    assert "mesh={'data': 1, 'model': 2}" in lines[0]
    assert f"resumed from step {int(saved[-1].split('_')[1])}" in lines, lines
    got = _losses(b.stdout)
    assert _close(got[STEPS - 1], one_process[STEPS - 1]), (got, one_process)
