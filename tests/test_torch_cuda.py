"""Tests that need a CUDA card: the kernel against its plain version, and
the server on the card.  Marked ``cuda``; each test checks for a card in
its own body and skips without one (run them on the card with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_*.py``).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import engine, ising, metropolis
from repro_torch.kernels import ops, ref
from repro_torch.serve_mc import AnnealJob, SampleServer

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize(
    "n,L,B,S", [(96, 256, 8, 8), (4, 256, 3, 5), (320, 256, 2, 2), (6, 384, 2, 0)],
    ids=["main", "tiny", "two-blocks", "zero-sweeps"],
)
def test_kernel_bit_equals_plain(n, L, B, S):
    _need_card()
    dev = torch.device("cuda")
    m = ising.random_layered_model(n=n, L=L, seed=n, beta=1.0)
    eng = engine.SweepEngine.create(m, backend="torch", batch=B, V=128, device=dev)
    carry = eng.init_carry(seed=1)
    betas = torch.linspace(0.2, 2.0, B, device=dev)
    fn = ops.make_colored_multisweep(eng.classes, m.h, m.space_nbr, m.space_J, m.tau_J, n=n)
    before = ops.launches["colored_multisweep"]
    got = fn(carry.spins, carry.rng, betas, S)
    torch.cuda.synchronize()
    assert ops.launches["colored_multisweep"] == before + 1
    want = ref.colored_multisweep_ref(
        carry.spins, carry.rng, betas, metropolis.classes_to(eng.classes, dev),
        h=torch.as_tensor(m.h, device=dev),
        base_nbr=torch.as_tensor(m.space_nbr, dtype=torch.int64, device=dev),
        base_J=torch.as_tensor(m.space_J, device=dev),
        tau_J=torch.as_tensor(m.tau_J, device=dev), n=n, num_sweeps=S,
    )
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_server_on_card_matches_plain():
    _need_card()
    m = ising.random_layered_model(n=8, L=256, seed=0, beta=1.2)
    out = []
    for backend in ("cuda", "torch"):
        server = SampleServer(m, slots=4, chunk_sweeps=4, backend=backend, device="cuda")
        for i in range(6):
            server.submit(AnnealJob.constant(seed=i, sweeps=5 + 3 * i, beta=0.5 + 0.2 * i))
        out.append({r.jid: r for r in server.drain()})
    for jid, r in out[0].items():
        np.testing.assert_array_equal(r.spins, out[1][jid].spins)
        assert r.energy == out[1][jid].energy
