"""Sampling-as-a-service over the batched SweepEngine.

    server = SampleServer(model, slots=8, chunk_sweeps=8)   # on the card
    server.submit(AnnealJob.constant(seed=1, sweeps=64, beta=1.2))
    results = server.drain()      # JobResult: spins, energy, magnetization

Jobs pack into replica slots of ONE resident engine; every chunk of
sweeps is a single launch of the rung's multisweep kernel for all of
them.  ``SampleServer(model, multi_tenant=True)`` serves jobs that carry
their own model (``AnnealJob.constant(..., model=tenant)``) side by side
in that one launch.  A parallel-tempering ladder is one job of R slots
(``PTJob(seed, betas, num_rounds, sweeps_per_round)``) whose rounds ride
the same launches.  A server snapshots itself (``snapshot_manager=``,
`SampleServer.snapshot`) and `SampleServer.restore` continues it bit for
bit, also one written by the JAX reference's server.
"""

from repro_torch.serve_mc.jobs import AnnealJob, JobResult, PTJob
from repro_torch.serve_mc.scheduler import (
    AdaptiveChunker,
    AdmissionPolicy,
    PlacementPlanner,
    PriorityBackfillPolicy,
    SampleServer,
    ServeConfig,
    SlotPool,
    make_policy,
)
from repro_torch.serve_mc.snapshot import restore_server, save_snapshot, snapshot_state

__all__ = [
    "AdaptiveChunker",
    "AdmissionPolicy",
    "AnnealJob",
    "JobResult",
    "PTJob",
    "PlacementPlanner",
    "PriorityBackfillPolicy",
    "SampleServer",
    "ServeConfig",
    "SlotPool",
    "make_policy",
    "restore_server",
    "save_snapshot",
    "snapshot_state",
]
