"""Every port example runs as a subprocess on the CPU and exits 0, as
tests/test_examples.py runs the reference's: the examples double as
end-to-end lifecycle drives of the port's user API (each also holds its
main query to the same query with Hyperspace off)."""

import os
import subprocess
import sys

import pytest

from hyperspace_tpu_torch.examples import EXAMPLES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES_DIR = os.path.join(REPO, "hyperspace_tpu_torch", "examples")


def test_the_port_has_every_reference_example():
    reference = sorted(f[:-3] for f in os.listdir(os.path.join(REPO, "examples"))
                       if f.endswith(".py"))
    assert sorted(EXAMPLES) == reference
    assert all(os.path.exists(os.path.join(EXAMPLES_DIR, f"{e}.py")) for e in EXAMPLES)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs(name, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", f"hyperspace_tpu_torch.examples.{name}", "--device", "cpu",
         "--workdir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env,
    )
    assert out.returncode == 0, f"{name} failed:\n{out.stderr[-2000:]}"
    assert out.stdout.strip()
