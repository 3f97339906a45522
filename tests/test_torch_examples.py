"""The torch train-loop examples (examples_torch/) run to completion as
subprocesses with --cpu: their own assertions are the checks (the loss
falls, the learned signs match the generator, the resumed stream is
byte-equal). Without --cpu on a host without CUDA each exits 1 with the
typed message and never carries on on the CPU.

They live apart from examples/: tests/test_examples.py runs every
examples/*.py with JAX on the CPU and no CUDA."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = sorted(p.name for p in (ROOT / "examples_torch").glob("*.py"))
TIMEOUT_S = 180


def _run(name, cwd, *args, env=None):
    return subprocess.run(
        [sys.executable, str(ROOT / "examples_torch" / name), *args],
        capture_output=True, text=True, timeout=TIMEOUT_S, cwd=cwd,
        env={**os.environ, "HOME": str(cwd), **(env or {})},
    )


def test_both_examples_are_here():
    assert EXAMPLES == ["streaming_train_loop.py", "train_loop.py"]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu(name, tmp_path):
    r = _run(name, tmp_path, "--cpu")
    assert r.returncode == 0, f"{name}:\n{r.stdout[-2000:]}\n{r.stderr[-2000:]}"
    if name == "train_loop.py":
        assert "training works" in r.stdout and "on cpu" in r.stdout
    else:
        assert "byte-identically" in r.stdout and "on cpu" in r.stdout


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_without_cuda_exits_1(name, tmp_path):
    r = _run(name, tmp_path, env={"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 1
    assert r.stdout == ""
    assert r.stderr.strip().endswith("CUDA is not available; pass --cpu")
