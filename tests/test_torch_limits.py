"""Construction-time limits and knobs of the port, on the CPU.

* `SweepEngine.create(..., backend="cuda")` refuses a lattice past a
  rung's kernel limits (`ops.check_kernel_rows`) before it builds
  anything, with a ValueError naming the largest rows;
* ``replica_tile``: a cuda-backend knob that must divide the batch (the
  reference's wording), refused where the a4 CTA does not fit it, passed
  through `SampleServer`;
* ``placement="affine"|"flat"`` is accepted (both place alike on one
  device) and any other mode refused as the reference refuses it;
* the CLI resolves its default backend before it checks the rung, so
  ``--device cpu --rung a2`` serves.
"""

import numpy as np
import pytest

from repro_torch.core import engine, ising
from repro_torch.kernels import ops
from repro_torch.launch import anneal_serve
from repro_torch.serve_mc import AnnealJob, SampleServer


@pytest.mark.parametrize(
    "rung,n,limit,kernels",
    [("cb", 768, 1162, "colored"), ("a4", 960, 1356, "a4")],
    ids=["cb", "a4"],
)
def test_create_refuses_rows_past_the_kernel_limit(rung, n, limit, kernels):
    m = ising.random_layered_model(n=n, L=256, seed=1)
    match = f"rows={2 * n} .* the {kernels} kernels hold at most {limit} rows"
    with pytest.raises(ValueError, match=match):
        engine.SweepEngine.create(m, rung=rung, backend="cuda", device="cuda")
    with pytest.raises(ValueError, match=match):
        engine.SweepEngine.create([m, m], rung=rung, backend="cuda", device="cuda")
    # The largest rows of whole layer blocks are taken, and the limit returned.
    assert ops.check_kernel_rows(rung, limit // n * n, n, m.space_degree, 5) == limit


@pytest.mark.parametrize(
    "kwargs,match",
    [(dict(backend="torch", device="cpu", V=4, replica_tile=1), "cuda-backend knob"),
     (dict(rung="a4", batch=3, replica_tile=2), "replica_tile 2 must divide batch 3"),
     (dict(rung="cb", batch=3, replica_tile=2), "replica_tile 2 must divide batch 3"),
     (dict(rung="a4", batch=4, replica_tile=2),
      "replica_tile 2 at rows=192 .* at most 94 rows a replica"),
     (dict(rung="a4", batch=8, replica_tile=8), "no generator warp")],
    ids=["torch-backend", "a4-divide", "cb-divide", "a4-smem", "a4-threads"],
)
def test_create_checks_replica_tile(kwargs, match):
    m = ising.random_layered_model(n=96, L=256, seed=0)
    kw = dict(backend="cuda", device="cuda")
    kw.update(kwargs)
    with pytest.raises(ValueError, match=match):
        engine.SweepEngine.create(m, **kw)


def test_server_passes_replica_tile_and_accepts_placement():
    m = ising.random_layered_model(n=4, L=16, seed=0)
    kw = dict(slots=2, chunk_sweeps=2, backend="torch", V=4, device="cpu")
    with pytest.raises(ValueError, match="cuda-backend knob"):
        SampleServer(m, replica_tile=1, **kw)
    with pytest.raises(ValueError, match="placement mode must be 'affine' or 'flat', got 'x'"):
        SampleServer(m, placement="x", **kw)
    out = []
    for placement in ("affine", "flat"):
        server = SampleServer(m, placement=placement, **kw)
        assert server.config.placement == placement
        for i in range(3):
            server.submit(AnnealJob.constant(seed=i, sweeps=3 + i, beta=0.8))
        out.append({r.jid: r for r in server.drain()})
    for jid, r in out[0].items():
        np.testing.assert_array_equal(r.spins, out[1][jid].spins)


def test_cli_default_backend_serves_the_slower_rungs_off_the_card():
    report = anneal_serve.main([
        "--device", "cpu", "--rung", "a2", "--jobs", "2", "--slots", "2", "--chunk", "2",
        "--n", "4", "--L", "8", "--V", "4", "--budget-min", "2", "--budget-max", "4", "--quiet",
    ])
    assert report.server.engine.backend == "torch" and report.server.engine.rung == "a2"
    assert len(report.results) == 2
