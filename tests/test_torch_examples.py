"""The port's examples (`python -m repro_torch.examples.<name> --device
cpu`) print the reference examples' numbers.

The reference's four examples run in child processes (``JAX_PLATFORMS=
cpu``), the port's in this process on the CPU, where each takes the
reference's shape on the plain backend.  Timings are masked, and so are
the words that name a package's own backend ("jnp" / "torch") or kernel.
Where the reference cannot run (ROADMAP §3a: its a4 Pallas kernel, which
`quickstart.py`'s step 3 launches, does not run on the installed JAX),
the port's kernel step is held against the reference's plain version
(`repro.kernels.ref.metropolis_sweep_ref` on `ops.make_kernel_inputs`)
instead, and only the lines the reference printed are compared.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.examples import annealing_service, parallel_tempering, quantum_annealing
from repro_torch.examples import quickstart

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
EXAMPLES = {"quickstart": quickstart, "parallel_tempering": parallel_tempering,
            "annealing_service": annealing_service, "quantum_annealing": quantum_annealing}


def _mask(text: str) -> list[str]:
    text = re.sub(r"\d+(\.\d+)?k spin-flips/s", "<rate>", text)
    text = re.sub(r"\s*\d+(\.\d+)?\s*(ms|s)\b", " <t>", text)
    text = re.sub(r"backend: (jnp|torch)", "backend: <plain>", text)
    return [line for line in text.splitlines() if line.strip()]


@pytest.fixture(scope="module")
def reference_output():
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": os.path.join(ROOT, "src")}
    procs = {
        name: subprocess.Popen([sys.executable, os.path.join(ROOT, "examples", f"{name}.py")],
                               env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in EXAMPLES
    }
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        out[name] = (p.returncode, stdout, stderr)
    return out


@pytest.mark.parametrize("name", ["parallel_tempering", "annealing_service",
                                  "quantum_annealing"])
def test_example_prints_the_references_lines(reference_output, name, capsys):
    rc, want, err = reference_output[name]
    assert rc == 0, err[-3000:]
    EXAMPLES[name].main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert _mask(got) == _mask(want)


def test_quickstart_prints_the_references_ladder_and_holds_kernel_5(reference_output, capsys):
    from repro.core import ising as jis
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    rc, want, err = reference_output["quickstart"]
    # Trap §3a: the reference dies in its Pallas step after the ladder.
    assert rc != 0 and "pl" in err and "load" in err
    _, out_kernel = quickstart.main(["--device", "cpu"])
    got = _mask(capsys.readouterr().out)
    want = _mask(want)
    assert len(want) == 5 and got[:5] == want  # the model line and a1-a4
    assert "bit-exact over 2 replicas (256 layers" in got[5]
    jm = jis.random_layered_model(n=6, L=256, seed=5, beta=1.1)
    jout = jref.metropolis_sweep_ref(*jops.make_kernel_inputs(jm, batch=2, seed=9), n=jm.n)
    for a, b in zip(out_kernel, jout):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_examples_run_as_modules_on_the_cpu():
    """``python -m repro_torch.examples.<name> --device cpu`` as the README
    gives it (the quantum annealer: the shortest)."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    p = subprocess.run([sys.executable, "-m", "repro_torch.examples.quantum_annealing",
                        "--device", "cpu"], env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "OK: annealed state beats random baseline" in p.stdout
