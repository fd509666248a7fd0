"""The LM example twins (`examples/torch_{serve,train}_lm.py`, ROADMAP
item 10.5) run as scripts on the CPU, each a subprocess as a user runs
it, through the port's launchers with the reduced configs."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(script, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                           *args], capture_output=True, text=True,
                          timeout=240, cwd=str(ROOT), env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-5000:]
    return proc.stdout


def test_serve_example_serves_every_request_on_the_cpu():
    out = _run("torch_serve_lm.py", "--device", "cpu", "--requests", "2",
               "--max-new", "4")
    assert "served 2 requests, 8 tokens" in out and "on cpu" in out
    assert out.count("req") == 3        # the summary's and one a request


def test_train_example_trains_its_default_arch_on_the_cpu(tmp_path):
    out = _run("torch_train_lm.py", "--device", "cpu", "--arch",
               "mamba2_780m", "--steps", "2", "--batch", "2", "--seq", "32",
               "--log-every", "1", "--ckpt-dir", str(tmp_path))
    assert "step 0: loss=" in out and "step 1: loss=" in out
    assert (tmp_path / "step_00000002").is_dir()
