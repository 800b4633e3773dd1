"""examples/encrypted_matvec_torch.py as a user runs it, in a subprocess.

With `--device cpu` it runs the serving chain on the plain path and exits
0 with the slot error below 0.15, with its keys from the OS and from a
seeded generator (`--seed`); with no CUDA device visible and no
`--device cpu` it exits nonzero (no silent CPU run).
"""

import os
import pathlib
import re
import subprocess
import sys

EXAMPLE = pathlib.Path(__file__).resolve().parent.parent / "examples" / "encrypted_matvec_torch.py"
TIMEOUT_S = 300


def _run(*args, **env):
    return subprocess.run([sys.executable, str(EXAMPLE), *args], capture_output=True, text=True,
                          timeout=TIMEOUT_S, env={**os.environ, **env})


def _check_within_the_envelope(proc):
    assert proc.returncode == 0, proc.stderr
    err = float(re.search(r"max \|error\| = ([0-9.]+)", proc.stdout).group(1))
    assert err < 0.15
    assert "encrypted matvec OK" in proc.stdout


def test_example_runs_on_the_cpu_within_the_envelope():
    _check_within_the_envelope(_run("--device", "cpu", "--seed", "7"))


def test_example_draws_its_keys_from_the_os_by_default():
    _check_within_the_envelope(_run("--device", "cpu"))


def test_example_without_cuda_refuses_to_run_on_the_cpu():
    proc = _run(CUDA_VISIBLE_DEVICES="")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "slots checked" not in proc.stdout
