#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py            # needs one CUDA device; ~13 minutes
    python3 chip_smoke.py --quick    # build + kernel-vs-plain checks only
    python3 chip_smoke.py --profile  # also trace the serving runs, LM decode steps and a train step
    python3 chip_smoke.py --dryrun-table DIR  # every dry-run cell, rows in DIR (not the smoke)

(``--kill-worker DIR`` is the SIGKILL child of phase 6c: the script runs
itself with it; it serves, snapshots into DIR and kills itself.
``--train-worker cut|resume DIR`` are the children of phase 11d,
``--mesh-worker dryrun ARGS...``, ``--mesh-worker rank0 ARCH SHAPE``
and ``--mesh-worker nccl`` those of phase 12.  ``--dryrun-table DIR``, not part of the
smoke, runs the dry run of every (arch x shape x mesh) cell on the card,
one child an arch, and writes each arch's rows to DIR.)

The port's kernels (src/repro_torch/kernels/csrc/):

  colored_multisweep           fused cb multisweep, MT19937 inside     (serving, --rung cb)
  colored_multisweep_multi     the same, each slot its own couplings  (multi-tenant serving, cb)
  metropolis_multisweep        fused a4 multisweep, MT19937 inside     (serving, --rung a4)
  metropolis_multisweep_multi  the same, each slot its own couplings  (multi-tenant serving, a4)
  metropolis_sweep             one a4 sweep on the caller's uniforms   (per-sweep path)
  mt_next_block                one MT19937 block, tempered or uniform  (per-sweep path)
  fastexp_2d                   the paper's bit-trick exp, "fast"/"accurate" (ops.fastexp)
  pt_swap                      a PT ladder's swap phase: energies read in place, swaps decided
                               on the card (ops.pt_swap; every PT round on one device)

#1-#5 each take the exp flavour ("fast", "accurate", "exact") as a
template parameter; sweep_exp_check.cu maps their exp over a buffer for
the exhaustive check (no path launches it).

Phases (any failure raises, so the script exits non-zero and never prints
its final ok line; no phase catches an exception):

  1. environment: Python / torch / CUDA versions and the card's name and
     power limit (nvidia-smi);
  2. build every kernel from csrc/ (one nvcc per source, all started
     together, sm_90a) and print ptxas's register / shared-memory lines;
  3. each kernel against its plain PyTorch version on the card, on the
     same inputs, bit-equal (torch.equal on every output, the generator
     state included): the cb multisweeps, single-model and on B distinct
     tenants, at every shape of `CB_CHECKS` (n=96 L=256 at B = 1, 8 and
     115; n=6 L=384, whose classes have fewer rows than the CTA has warps;
     n=320 L=256, two generator blocks a sweep with the uniforms in device
     memory; 0 sweeps) and at 4 and 8 warp groups a CTA; the a4 kernels
     (the multisweep, its multi-tenant twin on B distinct tenants, the
     one-sweep kernel on the plain generator's uniforms) bit pattern for
     bit pattern at every shape of `A4_CHECKS` (B = 1, 8 and 115 at the
     main shape, three layer blocks, rows=640 with two generator blocks a
     sweep and the fields in device memory, 0 sweeps), and at every
     replica tile a CTA takes at the shapes of `A4_TILE_CHECKS`; the
     MT19937 block in both flavours, bit patterns, at every V of
     `MT_CHECK_V` (a partial tile, odd counts, B=8 and B=115 lanes), one
     block and 5 chained blocks; both
     multi-tenant kernels on 8 copies of one model against the
     single-model kernel.  Each plain multisweep
     on the card is also held against the plain version on the CPU at
     the main shape.
     The exp kernel, both flavours, against its plain version on the card
     and the plain version on the card against the CPU's, bit for bit:
     2^20 uniforms in [-200, 200], the grid [-180, -80] (where the flush
     of subnormal results decides), +-0, +-inf, NaN, subnormals, +-1e10,
     shapes (7,), (1000,), (3, 5, 11), float16 and bfloat16 input; then
     the kernel against the plain version on the card over all 2^32
     float32 bit patterns, NaNs unified;
     the flavours: #1-#5 on "accurate" and "exact" bit pattern for bit
     pattern against their plain versions at every shape of
     `FLAVOUR_CHECKS` (B = 1, 8, 115 at the main shape, three layer
     blocks, rows=640; 8 sweeps), "accurate"'s plain versions on the card
     against the CPU's; the sweep kernels' exp (`sweep_exp<F>`) for
     "exact" and "accurate" against the plain exps over all 2^32 float32
     inputs, and "exact" on the card within 2 ulp of the correctly rounded
     exp (its distance from the CPU's printed);
     the PT swap kernel #8 against its plain version (`ref.pt_swap_ref`)
     on the same card tensors at every shape of `PT_SWAP_CHECKS` (the
     paper's ladder of 115 replicas at n=96 L=256, its rows a permutation
     of a 115-slot carry; an odd ladder of 7 on 8 slots), from each parity
     and on every exp flavour, over `PT_SWAP_ROUNDS` chained rounds:
     energies, betas, the swap generator and both counters bit-equal each
     round, one launch a round; the plain version's energies on the card
     against the CPU's;
  4. the serving paths: `anneal_serve.main` serves 12 anneal jobs
     (constants and ramps, 64-256 sweeps) at the paper's per-model width
     (96 spins x 256 layers) on 8 slots in chunks of 8 sweeps, once on
     rung cb and once on rung a4; every job must be served, each energy
     must equal `observables.energies` of its spins, every result must be
     bit-identical to the same jobs served with the plain version on the
     card, and the rung's kernel must have been launched once per served
     chunk (launch counts are zeroed just before each run and read just
     after); the drain's wall split into admission, the launches'
     enqueue, the wait for the card before retiring and the rest of each
     step, from the server's telemetry spans;
  5. multi-tenant serving, once per rung: `SampleServer(multi_tenant=True)`
     at the same width, 8 slots, chunks of 8, 16 anneal jobs (constants and
     ramps, 64-256 sweeps), job i on tenant i % 8 of 8 reseeded tenants,
     every fourth job on the server's own model; every result must equal
     the same job run alone on a single-model engine of its own model
     (kernels #1/#3), and the rung's multi-tenant kernel must have been
     launched once per served chunk (counts zeroed just before, read just
     after).  For comparison, the same jobs on a resident slots=1 server;
  6. the per-sweep path (per sweep: `ops.mt_uniforms_count`, then one a4
     sweep launch) at the main shape, counts zeroed just before and read
     just after; it must end in the fused kernel's carry, bit for bit;
     parallel tempering at the paper's production shape (R=115 replicas,
     betas geometric from 0.1 to 3.0, n=96 L=256): `run_parallel_tempering`
     (32 rounds of 8 sweeps) on each rung with "fast" and "accurate",
     backend "cuda" (one sweep kernel launch and one #8 launch a round,
     counts zeroed just before and read just after) equal to backend
     "torch" on the card bit for bit (both swap through #8 on the card;
     phase 3 holds #8 against its plain version); the same ladder as a `PTJob` beside 8 anneal jobs on a 128-slot
     server, policy fair, chunks of 3 (rounds split across chunks), equal
     to the standalone run, each anneal job to its solo run; a `PTJob` on a
     tenant of a multi-tenant server (#4, #2) equal to its solo run; the
     CLI serving `--pt-replicas 115 --pt-rounds 8 --rung a4`;
     6c. recovery and the stream, at n=96 L=256: on rungs cb and a4, single-
     model (#1, #3) and multi-tenant (#2, #4), 10 anneal jobs and a PT
     ladder of R=4 on 8 slots, chunks of 8, snapshots every 16 sweeps; the
     server is abandoned after the first snapshot has landed and a job has
     retired, `SampleServer.restore` rebuilds it on the card and drains
     (counts zeroed just before the restore, read just after: the rung's
     kernel once a chunk, nothing else); every result, the retirement
     order and the final pool (rng included) equal the uninterrupted run
     bit for bit.  The same from a child process (this script with
     ``--kill-worker``) that dies by SIGKILL; a graceful drain (a
     `PreemptionHandler` triggered with the ladder parked by checkpoint-
     preemption, policy backfill); a CPU snapshot (backend "torch", 4
     slots) restored with backend "cuda"; the CLI's ``--smoke`` on the
     card (its ``smoke: resumed`` line required); the CLI's cb mix drained
     with an `ObservableStream` equal to the untapped drain, every sample's
     energies equal to `observables.energies` of `spins_flat` at its
     boundary; an `arm_profiler` window of 4 chunks whose trace names the
     served kernel, with no ``profiler.error`` event; timings (host clock):
     the snapshot's synchronous part, its background write and the restore
     at 8 and 128 slots, the pool's bytes, slot-sweeps/s with the stream
     off and on;
     6d. the slot mesh on four LOGICAL devices of the one card
     (``SlotMesh(("cuda:0",) * 4)``: a block of storage and a stream each),
     at n=96 L=256: #1-#4 through `SweepEngine` at B=8 on the equal split
     and on capacities [4, 2, 1, 1], each equal to one device bit for bit
     (pool, generator state, tables) through a park on one device, a
     resume on another and betas rewritten on two; a drain of 12 anneal
     jobs and a PT ladder of 4 on 8 slots (policy fifo, chunks of 8) on
     each rung, single-model and on 4 tenants, on one device and over
     [4, 2, 1, 1] affine (the rebalancer migrates, the ladder swaps on one
     device) and flat (the ladder spans devices and swaps from gathered
     energies), telemetry on (the skew monitor fed for every launch):
     results and retirement order equal one device's; a D=4 snapshot
     restored on one device and on [4, 2, 1, 1], each equal to the
     uninterrupted run; the CLI's ``--devices 1`` equal to phase 4's cb
     serve, ``--devices 2`` refused on one card; per-device and per-kernel
     launches, and slot-sweeps/s on one and four logical devices (a layout
     check on one card, not a scaling figure);
     6e. the four examples (`python -m repro_torch.examples.<name>`) on the
     card: the quickstart's kernel step holds #5 bit-equal to its plain
     version, the others check their own results;
  7. timings from CUDA events: each kernel and its plain version at B=8
     and B=115 (the multi-tenant kernels on B distinct tenants; the cb
     kernels also at 4 warp groups; #5 and #6 on the card alone), the
     least time the card could take
     (bytes or operations), the cb launch's split into fixed cost, class
     walk and generator at each warp-group count, the a4 launch's split
     into fixed cost, row walk and generator, the launch-structure
     comparison (fused vs per-sweep, B = 1, 8, 115) and the sweep-order
     comparison (a4 vs cb, B=8); #1 and #3 on each exp flavour at B=8
     and B=115; PT rounds/s and replica-sweeps/s on each rung and flavour,
     the card's time of a round's sweep launch and swap phase and the
     round's host syncs; the serving phases' sweeps/s and spin-flips/s;
  8. the exp path: `ops.fastexp` on one sweep's exps at the paper's shape
     (115 models x 24,576 spins = 2,826,240 elements), once per flavour
     (counts zeroed just before, read just after), its results bit-equal
     to the plain version's on the same inputs and within the paper's
     error envelopes; then each flavour of the kernel, its plain
     version and `torch.exp` (the paper's exact-exp baseline, not a library
     form of the kernel) timed with a cold L2 at 2^20, 2,826,240 and 2^26
     elements (L2 clean, and as the flush leaves it dirty), with GB/s and
     the bytes bound, and the Figure-17 relative
     error (min, max, mean) of the card's outputs on the 400,001-point grid;
  9. the ladder: one engine sweep on the card with the plain version of
     rungs a3 (n=96, L=256, B=1; bit-equal to the a4 engine through kernel
     #3 from the same seed), a1 and a2 (a1 == a2 under "fast"; a2 on the
     card == a2 on the CPU); their times are those of eager plain loops.
  10. the LM server (no kernel of its own: the LM has no TPU kernel, its
     products and elementwise ops are plain PyTorch on the card): a.
     gemma-2b at full width (18 layers, d_model 2048, 8 heads / 1 KV head
     of 256, d_ff 16384, vocab 256000; 2,506,172,416 parameters, the
     config's 2,506,096,640 and the norms' 75,776, initialised from a
     seeded generator on the card): one float32 prefill of 8 tokens
     on the card against the same weights on the CPU within ROADMAP §3w's
     bound (`LM_F32_LOGITS`), and in float32 a prefill of 8 tokens and 8
     decode steps against teacher forcing (one forward pass) within the
     reference's 0.06; the served bfloat16 model's forward and decode
     against the float32 forward, printed (bfloat16 drifts past 0.06 at 18
     layers, the reference's too: ROADMAP §3w); `ServeEngine` with the CLI's defaults (8
     requests, 4 slots, prompts of 8, 16 new tokens, max_len 128), every
     request served its 16 tokens; b. qwen2.5-14b, deepseek-coder-33b,
     command-r-35b and internvl2-26b at full width and 2 layers, one at a
     time: a prefill and 8 decode steps against teacher forcing; c. CUDA-
     event times of a prefill (B=4, 8 tokens) and of a decode step (B=4)
     with the decode step's bytes bound (the held weights once a step at
     3.35 TB/s), the served drain's tokens/s (host clock), the peak memory
     while serving.
     10b. the other LM families (plain PyTorch on the card too; they launch
     none of #1-#8, counts zeroed just before and read just after), one
     model at a time, random weights from a seeded generator on the card:
     a. zamba2-1.2b (Mamba2 with a shared attention block every 6 layers)
     and rwkv6-1.6b at full width and depth (38 and 24 layers), the main
     path of this phase: in float32, 16 decode steps from empty caches
     against the card's teacher forcing within 0.06 and the card's forward
     against the same weights' forward on the CPU within `LM_F32_LOGITS`
     (TF32 off: `float32_products`); in bfloat16, served through
     `ServeEngine` with phase 10's settings, every request its 16 tokens;
     a decode step's CUDA-event time at B=4 against its bytes bound, the
     drain's tokens/s, the peak memory; b. deepseek-v3-671b (its 3 dense
     layers and its first MoE layer of 256 experts) and
     llama4-scout-17b-a16e (2 layers) at full width, depth cut for memory:
     in float32 a prefill of 8 tokens and up to 8 decode steps against
     teacher forcing (B=1): capacity depends on the batch, so the steps
     compared end before the first position whose (token, expert)
     assignment teacher forcing dropped (`DropCount`; at least the
     reference's 4; the prefill and decode steps drop none), then served
     in bfloat16 as in a.; c.
     whisper-tiny at full size (4 + 4 layers, 1500 frames from the seed),
     float32: encode, `init_decode_caches` and 16 decode steps against
     `encdec.apply`'s teacher forcing, and each of the three on the card
     against the CPU; then served in bfloat16 as the server builds it (a
     dense decoder, as the reference's decoder builds an encoder-decoder
     config).  ``--profile`` adds `profile_lm` to each served model.
  11. LM training (plain PyTorch on the card: it launches none of #1-#8,
     counts zeroed just before and read just after): a. gemma-2b at full
     width and depth, one float32 `make_train_step` step (B=1, 16 tokens,
     TF32 off) on the card and on the CPU from the same weights and batch:
     loss, gradient norm and the worst leaf's clipped gradient (Adam's m)
     within `TRAIN_F32_GRAD_DEEP`; b. the main path:
     `launch.train.main(TRAIN_ARGS)` trains gemma-2b (bf16 compute over
     float32 parameters, remat "full", the config's own): every loss
     finite and printed as returned; a step's CUDA-event time, tokens/s,
     its share of the dense-bf16 peak (8 N a token: the recompute's 2 N
     too), the AdamW update's time against its bytes bound (28 B a
     parameter), the peak memory (``--profile``: the device's busy share
     of a step); then the same with bfloat16 m and v (lower peak);
     c. grad_accum=2 against 1 on a batch of 8 at full width: Adam's m
     within the reference's scaled 2e-2 in float32, bf16 printed; d.
     resume bit for bit on the card: two children (``--train-worker``,
     deterministic algorithms) train the CLI's default smoke config
     uninterrupted and with SIGTERM after step 2 (the emergency
     checkpoint), a fresh one resumes to step 4; every leaf equal; e.
     zamba2-1.2b and rwkv6-1.6b at full width and depth, 4 bf16 steps each
     through `launch.train.main`; f. every other LM arch's smoke config,
     one float32 train step card against CPU within a.'s bound.
  12. the LM over a device mesh (plain PyTorch on the card: none of
     #1-#8; every piece runs in a child, which zeroes its counts before
     its work and prints them after, and the sum must be 0): a.
     `launch.dryrun` at full width and depth on the card's device type,
     one child a cell, all at once (`MESH_CELLS`: gemma-2b train_4k on
     16x16 and 2x16x16 with int8_ef, qwen2.5-14b prefill_32k and
     decode_32k, deepseek-v3 train_4k (experts over 16) and decode_32k,
     whisper-tiny decode_32k, rwkv6-1.6b long_500k, qwen2.5-14b
     long_500k): each row `ok` or the reference's `skipped`, qwen's decode
     with collectives and temp bytes, each row and its seconds printed; c.
     beside them, a child on a one-rank NCCL world (every axis of size
     1): expert parallelism (both combines) == the local path and the
     int8_ef step on a (1, 1, 1) pod mesh == one device, bit for bit; b.
     then rank 0's share of gemma-2b train_4k and deepseek-v3 decode_32k,
     its blocks real tensors drawn from a seed, one step each in a fake
     world (no value printed: its collectives do nothing): the card's
     peak beside the dry run's arguments + temp bytes, the step's ms.

The last three lines of standard output are the nvidia-smi line, one JSON
line ``{"kernels": [...]}`` (#1-#4 also carry ``recovery_launches``, their
launches in phase 6c's restored drains and nothing else, and
``mesh_launches``, those of phase 6d's served mesh drains; #1 also carries
``stream_launches``, those of the streamed drain, and ``smoke_launches``,
those of the whole ``anneal_serve --smoke`` run, before and after its
restore; a kernel the examples launch carries ``examples_launches``; #8's
entry counts the swap phases of the same drains where ladders swapped, and
its ``launches`` are those of the standalone cb ladder) and the final
``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.ising_qmc import CONFIG as PAPER  # noqa: E402  (after the path)

#: Published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s and
#: 67 TFLOP/s float32 outside the tensor cores.  That rate counts a fused
#: multiply-add as two operations (132 SMs x 128 float32 lanes x 2 at the
#: 1.98 GHz boost clock); the operations here are single adds, multiplies,
#: compares and bit operations, so a float32 one issues at half of it and
#: an int32 one at a quarter (64 int32 lanes per SM, which the float32
#: pipe shares).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12 / 2
INT32_OPS_PER_S = 67e12 / 4
SMS = 132

#: The paper's shape (configs/ising_qmc.py): 96 spins x 256 layers a model,
#: 115 models, 128 lanes.
MAIN_N, MAIN_L, MAIN_SLOTS, MAIN_CHUNK = PAPER.spins_per_layer, PAPER.num_layers, 8, 8
LANES, MT_N = PAPER.lanes, 624

#: Exp kernel sizes: 2^20, one sweep's exps at the paper's shape (115
#: models x 24,576 spins), 2^26.
FASTEXP_MAIN = PAPER.total_spins
FASTEXP_SIZES = (2**20, FASTEXP_MAIN, 2**26)
#: The paper's §2.4 valid range of "accurate", and its error envelopes.
ACCURATE_LO, ACCURATE_HI = -31.5 * np.log(2.0), 32.0 * np.log(2.0)
ENVELOPE = {"fast": (-0.0392, 0.0201), "accurate": (-0.0105, 0.0051)}
#: One sweep of an eager plain rung above this many seconds is cut (L).
LADDER_SWEEP_S = 20.0

SERVE_ARGS = [
    "--jobs", "12", "--slots", str(MAIN_SLOTS), "--chunk", str(MAIN_CHUNK),
    "--n", str(MAIN_N), "--L", str(MAIN_L), "--V", str(LANES),
    "--budget-min", "64", "--budget-max", "256", "--seed", "0", "--quiet",
]

CSRC = "src/repro_torch/kernels/csrc"
#: Kernel -> the TPU kernel it replaces (None: the reference's code is jnp).
KERNELS = {
    "colored_multisweep": "src/repro/kernels/metropolis_kernel.py:523",
    "colored_multisweep_multi": "src/repro/kernels/metropolis_kernel.py:642",
    "metropolis_multisweep": "src/repro/kernels/metropolis_kernel.py:389",
    "metropolis_multisweep_multi": "src/repro/kernels/metropolis_kernel.py:425",
    "metropolis_sweep": "src/repro/kernels/metropolis_kernel.py:280",
    "mt_next_block": "src/repro/kernels/mt19937_kernel.py:55",
    "fastexp_2d": "src/repro/kernels/fastexp_kernel.py:54",
    "pt_swap": None,  # src/repro/core/tempering.py:187 swap_phase
}
#: Check-only entries built beside the kernels: the sweep kernels' exp over
#: a buffer (`check_sweep_exp_exhaustive`); no path launches them.
CHECK_ENTRIES = ("sweep_exp_check",)
#: The sweep and generator kernels, timed per batch of replicas.
SWEEP_KERNELS = tuple(k for k in KERNELS if k not in ("fastexp_2d", "pt_swap"))
#: Rung -> the kernel of its serving path, single-model and multi-tenant.
SERVE_KERNEL = {"cb": "colored_multisweep", "a4": "metropolis_multisweep"}
MULTI_KERNEL = {"cb": "colored_multisweep_multi", "a4": "metropolis_multisweep_multi"}
#: Shapes #1 and #2 are held bit-equal at: (what, n, L, B, sweeps).
CB_CHECKS = (
    ("the serving shape", MAIN_N, MAIN_L, MAIN_SLOTS, 8),
    ("one replica", MAIN_N, MAIN_L, 1, 8),
    ("the paper's 115 models", MAIN_N, MAIN_L, 115, 2),
    ("3 layer blocks, classes of 4-5 rows, fewer than the warps", 6, 384, 3, 5),
    ("2 generator blocks a sweep, uniforms in device memory", 320, 256, 4, 3),
    ("0 sweeps", MAIN_N, MAIN_L, MAIN_SLOTS, 0),
)
#: Warp groups of 128 threads a colored CTA is checked and timed at; the
#: last is `ops.COLORED_WARP_GROUPS`, the wrappers' default.
CB_WARP_GROUPS = (4, 8)
#: Shapes #3, #4 and #5 are held bit-equal (bit patterns) at: (what, n, L,
#: B, sweeps); #5 runs one sweep at each shape with sweeps > 0.
A4_CHECKS = (
    ("the serving shape", MAIN_N, MAIN_L, MAIN_SLOTS, 8),
    ("one replica", MAIN_N, MAIN_L, 1, 8),
    ("the paper's 115 models", MAIN_N, MAIN_L, 115, 2),
    ("3 layer blocks", 6, 384, 3, 5),
    ("rows=640: 2 generator blocks a sweep, fields in device memory", 320, 256, 4, 3),
    ("0 sweeps", MAIN_N, MAIN_L, MAIN_SLOTS, 0),
)
#: Generator columns #6 is held bit-equal at (a partial tile, odd and
#: even counts, B=8 and B=115 lanes), one block and `MT_CHAINED` chained
#: blocks, both flavours.
MT_CHECK_V = (1, 31, 33, 200, 1024, PAPER.num_models * LANES)
MT_CHAINED = 5
#: Shapes where replica tiles > 1 fit: (n, L, B, sweeps); rows 32 and 64.
A4_TILE_CHECKS = ((16, MAIN_L, MAIN_SLOTS, 5), (32, MAIN_L, MAIN_SLOTS, 3))
#: The exp flavours #1-#5 are held at beside "fast" (`check_colored` and
#: `check_a4` hold "fast"), and the shapes: (what, n, L, B, sweeps).
OTHER_FLAVOURS = ("accurate", "exact")
FLAVOUR_CHECKS = (
    ("one replica", MAIN_N, MAIN_L, 1, 8),
    ("the serving shape", MAIN_N, MAIN_L, MAIN_SLOTS, 8),
    ("the paper's 115 models", MAIN_N, MAIN_L, 115, 8),
    ("3 layer blocks", 6, 384, 3, 8),
    ("rows=640", 320, 256, 4, 8),
)
#: Parallel tempering at the paper's production shape (configs/ising_qmc.py:
#: 115 replicas, betas geometric from 0.1 to 3.0) on one model of the main
#: width; rounds and sweeps a round of `run_parallel_tempering`; the served
#: ladder's server: slots, anneal jobs beside it, a chunk that does not
#: divide the sweeps of a round (rounds split across chunks).
PT_R, PT_BETA_MIN, PT_BETA_MAX = PAPER.num_models, PAPER.beta_min, PAPER.beta_max
PT_ROUNDS, PT_SWEEPS = 32, 8
PT_SLOTS, PT_ANNEAL_JOBS, PT_CHUNK = 128, 8, 3
#: Rounds of the multi-tenant ladder and of the CLI's.
PT_MULTI_ROUNDS, PT_CLI_ROUNDS = 8, 8
#: The swap kernel (#8) is held bit-equal at: (what, n, L, B slots, R
#: replicas), the ladder's rows a random permutation of R of the B slots;
#: `PT_SWAP_ROUNDS` chained rounds from each parity.
PT_SWAP_CHECKS = (
    ("the paper's ladder, rows scattered in a 115-slot carry", MAIN_N, MAIN_L, PT_R, PT_R),
    ("an odd ladder of 7 on the serving shape's 8 slots", MAIN_N, MAIN_L, MAIN_SLOTS, 7),
)
PT_SWAP_ROUNDS = 12
#: Rounds the examples' ladders swap on the card: parallel_tempering's
#: standalone ladder, annealing_service's two `PTJob`s (6 + 2).
EXAMPLE_PT_ROUNDS = {"parallel_tempering": 10, "annealing_service": 6 + 2}
#: Multi-tenant serving: tenants, jobs; the per-slot table floats of a site
#: each kernel reads (cb: h, J row, tau; a4: doubled J row and tau).
TENANTS, MULTI_JOBS = 8, 16
#: Recovery (phase 6c): slots, chunk, the periodic snapshot cadence in
#: sweeps; the anneal jobs and their budgets; the PT ladder's replicas,
#: rounds and sweeps a round; the CPU -> card restore's slots.
REC_SLOTS, REC_CHUNK, REC_EVERY = 8, 8, 16
REC_JOBS, REC_BUDGETS = 10, (16, 65)
REC_PT_R, REC_PT_ROUNDS, REC_PT_SWEEPS = 4, 6, 4
REC_CPU_SLOTS = 4
#: The slot mesh (phase 6d): logical devices on the one card and the ragged
#: capacities; the served drain's short and long anneal budgets (sweeps)
#: and its PT ladder's replicas and rounds.
MESH_D, MESH_CAPS = 4, (4, 2, 1, 1)
MESH_SHORT, MESH_LONG = 16, 64
MESH_PT_R, MESH_PT_ROUNDS = 4, 4


# -- what each kernel must move and compute (bytes, int32 ops, float32 ops) --


def colored_counts(B: int, rows: int, sd: int, sweeps: int) -> tuple[int, int, int]:
    """One colored multisweep launch.  Bytes: spins in, the generator state
    in and out, spins/h_space/h_tau out.  Per sweep: ceil(rows/624) twists
    of 624 generator words (8 int ops each); tempering of the ``rows``
    words drawn (10 int ops, the >> 8 and the int->float conversion, then
    one float multiply); the class update of every spin (a multiply and an
    add per space neighbour, then the tau sum and product, the field sum,
    the two products of x, the exp's scale, conversion (int), bias add
    (int) and centre product, the accept compare and the flip).  After the
    last sweep, the dense field pass."""
    blocks = -(-rows // MT_N)
    spins = rows * LANES
    nbytes = 4 * B * (spins + 2 * MT_N * LANES + 3 * spins)
    int_ops = sweeps * (blocks * MT_N * LANES * 8 + spins * (12 + 2))
    fp_ops = sweeps * spins * (1 + 2 * sd + 9) + spins * (2 * sd + 2)
    return nbytes, B * int_ops, B * fp_ops


def a4_counts(B: int, rows: int, sd: int, sweeps: int) -> tuple[int, int, int]:
    """One fused a4 multisweep launch.  Bytes: spins, h_space, h_tau in and
    out, the generator state in and out.  Per sweep: the twists and the
    tempering of the ``rows`` words drawn as in `colored_counts` (8 and 12
    int ops, one float multiply); per spin the row step: the field sum,
    the two products of x, the exp (scale, conversion and bias add (int),
    centre), the accept compare, S_mul, the new spin (three ops), -S_mul,
    a multiply and an add per space neighbour, the tau product and the two
    tau adds: 14 int and 2*sd + 16 float ops with the uniform's multiply."""
    blocks = -(-rows // MT_N)
    spins = rows * LANES
    nbytes = 4 * B * (6 * spins + 2 * MT_N * LANES)
    int_ops = sweeps * (blocks * MT_N * LANES * 8 + spins * 14)
    fp_ops = sweeps * spins * (2 * sd + 16)
    return nbytes, B * int_ops, B * fp_ops


def sweep_counts(B: int, rows: int, sd: int) -> tuple[int, int, int]:
    """One a4 sweep launch on the caller's uniforms.  Bytes: spins,
    h_space, h_tau and the uniforms in; spins, h_space, h_tau out.  Per
    spin the row step of `a4_counts` without the generator: 2 int and
    2*sd + 15 float ops."""
    spins = rows * LANES
    return 4 * B * 7 * spins, B * spins * 2, B * spins * (2 * sd + 15)


def mt_counts(V: int, uniforms: bool) -> tuple[int, int, int]:
    """One MT19937 block launch over (624, V).  Bytes: the state in, the new
    state and the output out.  Per word: 8 int ops of twist and 10 of
    tempering; the uniform flavour adds the >> 8 and the conversion (int)
    and one float multiply."""
    words = MT_N * V
    return 3 * 4 * words, words * (8 + (12 if uniforms else 10)), words * int(uniforms)


def fastexp_counts(n: int, flavor: str) -> tuple[int, int, int]:
    """One exp launch over ``n`` float32 elements.  Bytes: each input read
    once, each result written once.  Operations per element ("fast"):
    the scale multiply, the flush compare and the centre multiply (float),
    the conversion and the bias add (int); "accurate" adds the input flush,
    the two clip compares, the two mask compares and the max (float).  Its
    two float64 square roots and divisions are left out: the card's table
    of peaks gives no float64 rate, and the bound stays a floor."""
    if flavor == "fast":
        return 8 * n, 2 * n, 3 * n
    return 8 * n, 2 * n, 9 * n


def with_tables(counts: tuple[int, int, int], B: int, n: int, floats_per_site: int):
    """A multi-tenant launch: the single-model counts plus every slot's own
    coupling tables, read once (``floats_per_site`` float32 per site)."""
    nbytes, int_ops, fp_ops = counts
    return nbytes + 4 * B * n * floats_per_site, int_ops, fp_ops


#: The a4 row step's dependent path (csrc/a4_sweep.cuh: a4_sweep), in
#: cycles: a row reads its own field cell, which the previous rows' flips
#: updated (a shared-memory load, ~23 cycles), then 12 dependent
#: single-cycle-issue operations of ~4 cycles each (the field sum, the two
#: products of x, the exp's scale, conversion, bias add and centre product,
#: the flush compare, the accept compare, the mask, -S_mul times J2 and the
#: add into the neighbour's cell), then the store that the next row's load
#: waits for (~23).  Approximate Hopper latencies, not a measurement.
A4_ROW_CHAIN_CYCLES = 23 + 12 * 4 + 23
#: The SM clock the peak rates above assume (H100 SXM boost).
SM_CLOCK_HZ = 1.98e9


def a4_chain_ms(rows: int, sweeps: int) -> float:
    """Least time of an a4 launch from its dependence chain alone: a
    replica's rows x sweeps row steps run one after another (each reads
    what the previous flips wrote), whatever B, since replicas run side by
    side.  A floor beside the operations bound, which assumes every
    operation independent."""
    return rows * sweeps * A4_ROW_CHAIN_CYCLES / SM_CLOCK_HZ * 1e3


def ops_seconds(int_ops: int, fp_ops: int) -> float:
    """Least time for the operations: int32 ops on their own lanes, and all
    of them on the float32 pipe that those lanes are part of."""
    return max(int_ops / INT32_OPS_PER_S, (int_ops + fp_ops) / FP32_OPS_PER_S)


def bound(counts: tuple[int, int, int], ctas: int | None = None):
    """(least ms the card could take, which of bytes/operations bounds it,
    least ms when only ``ctas`` SMs work — one CTA per replica — or None)."""
    nbytes, int_ops, fp_ops = counts
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_seconds(int_ops, fp_ops) * 1e3
    t_occ = t_ops * SMS / min(ctas, SMS) if ctas else None
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", t_occ


def ptxas_summary(report: str) -> str:
    """One line of a build's ptxas report: its kernel instantiations, their
    registers, spill bytes and stack frames, and the template arguments of
    any instantiation that spills."""
    def ints(pattern, text=report):
        return [int(x) for x in re.findall(pattern, text)]

    regs, spills = ints(r"Used (\d+) registers"), ints(r"(\d+) bytes spill stores")
    stack = ints(r"(\d+) bytes stack frame")
    spilling = []
    for chunk in report.split("Compiling entry function")[1:]:
        args = re.search(r"kernelI((?:L[ib]\d+E)+)E", chunk)
        if args and max(ints(r"(\d+) bytes spill stores", chunk), default=0):
            spilling.append("<" + ",".join(re.findall(r"L[ib](\d+)E", args.group(1))) + ">")
    return (f"{len(regs)} kernel instantiation(s), registers {min(regs)}-{max(regs)}, spill stores "
            f"<= {max(spills, default=0)} B, stack <= {max(stack, default=0)} B"
            + (f"; spilling: {' '.join(spilling)}" if spilling else ""))


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call of ``fn`` from CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_queued(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call of ``fn`` on the card alone: the card spins ~5 ms
    before the first event, so the host has queued every call by then, and
    a call shorter than its wrapper's host time is not timed at the host's
    rate (`cuda_ms`, back to back, would be)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_cold(fn, reps: int, flush: torch.Tensor, clean: torch.Tensor | None = None) -> float:
    """Mean ms of ``fn`` with a cold L2: ``flush`` (larger than the 50 MB
    L2) is rewritten before each call, and only the call is timed, by a
    pair of CUDA events around it.  The card then spins for ~1 ms, so the
    host has queued the events and the call before the card reaches them:
    the time is the card's, not the host's launch overhead.

    The rewrite leaves L2 full of dirty lines, whose write-back the timed
    call pays for as it evicts them.  ``clean`` (also larger than L2) is
    then read after the rewrite, so L2 holds only clean lines and the call
    pays for its own traffic alone."""
    fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        if clean is not None:
            torch.sum(clean)
        torch.cuda._sleep(2_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def colored_case(n: int, L: int, B: int, device, seed: int = 0, exp_flavor: str = "fast"):
    """A model, its kernel entry, its plain entry and one batch of inputs,
    on the exp flavour ``exp_flavor``."""
    from repro_torch.core import engine, ising, metropolis
    from repro_torch.kernels import ops, ref

    m = ising.random_layered_model(n=n, L=L, seed=seed, beta=1.1)
    eng = engine.SweepEngine.create(m, rung="cb", backend="torch", batch=B, V=LANES, device=device)
    carry = eng.init_carry(seed=seed + 1)
    # Spread the betas so replicas differ in acceptance rate.
    betas = torch.linspace(0.3, 1.5, B, device=device, dtype=torch.float32)
    kernel = ops.make_colored_multisweep(eng.classes, m.h, m.space_nbr, m.space_J, m.tau_J, n=n,
                                         exp_flavor=exp_flavor)
    classes = metropolis.classes_to(eng.classes, device)
    tabs = dict(
        h=torch.as_tensor(m.h, device=device),
        base_nbr=torch.as_tensor(m.space_nbr, dtype=torch.int64, device=device),
        base_J=torch.as_tensor(m.space_J, device=device),
        tau_J=torch.as_tensor(m.tau_J, device=device),
    )

    def plain(spins, rng, beta, sweeps):
        return ref.colored_multisweep_ref(
            spins, rng, beta, classes, **tabs, n=n, num_sweeps=sweeps, exp_flavor=exp_flavor
        )

    return m, eng.rows, kernel, plain, (carry.spins, carry.rng, betas)


def a4_case(n: int, L: int, B: int, device, seed: int = 0,
            exp_flavor: str = "fast") -> types.SimpleNamespace:
    """An a4 model and batch of inputs ``(spins, h_space, h_tau, rng)``
    with spread betas, and its entries on the exp flavour ``exp_flavor``: ``fused``/``plain`` (multisweep
    kernel / plain version), ``sweep``/``sweep_plain`` (one sweep on given
    uniforms), ``per_sweep`` (per sweep, the MT19937 block kernel, then
    one sweep launch) and ``uniforms`` (one sweep's uniforms from the
    plain generator, laid out (B, rows, 128))."""
    from repro_torch.core import engine, ising
    from repro_torch.core import mt19937 as mt
    from repro_torch.kernels import ops, ref

    m = ising.random_layered_model(n=n, L=L, seed=seed, beta=1.1)
    eng = engine.SweepEngine.create(m, rung="a4", backend="torch", batch=B, V=LANES, device=device)
    c = eng.init_carry(seed=seed + 1)
    rows = eng.rows
    kw = dict(
        base_nbr=torch.as_tensor(m.space_nbr, dtype=torch.int32, device=device),
        base_J2=torch.as_tensor(2.0 * m.space_J, dtype=torch.float32, device=device),
        tau_J2=torch.as_tensor(2.0 * m.tau_J, dtype=torch.float32, device=device),
        beta=torch.linspace(0.3, 1.5, B, device=device, dtype=torch.float32),
        n=n,
        exp_flavor=exp_flavor,
    )

    def lanes(u):  # (rows, B*128) -> (B, rows, 128)
        return u.reshape(rows, B, LANES).permute(1, 0, 2).contiguous()

    def per_sweep(inputs, sweeps):
        spins, hs, ht, rng = inputs
        for _ in range(sweeps):
            rng, u = ops.mt_uniforms_count(rng, rows)
            spins, hs, ht = ops.metropolis_sweep(spins, hs, ht, lanes(u), **kw)
        return spins, hs, ht, rng

    return types.SimpleNamespace(
        m=m, rows=rows, inputs=(c.spins, c.h_space, c.h_tau, c.rng),
        fused=lambda inputs, sweeps, tile=None: ops.metropolis_multisweep(
            *inputs, **kw, num_sweeps=sweeps, replica_tile=tile),
        plain=lambda inputs, sweeps: ref.metropolis_multisweep_ref(
            *inputs, **kw, num_sweeps=sweeps),
        sweep=lambda inputs, u: ops.metropolis_sweep(*inputs[:3], u, **kw),
        sweep_plain=lambda inputs, u: ref.metropolis_sweep_ref(*inputs[:3], u, **kw),
        per_sweep=per_sweep,
        uniforms=lanes(mt.mt_uniforms_count(c.rng, rows)[1]),
    )


def tenants(base, count: int) -> list:
    """``count`` disorder realizations on ``base``'s lattice."""
    from repro_torch.core import ising

    return [ising.reseed_couplings(base, seed=100 + k) for k in range(count)]


def multi_case(rung: str, n: int, L: int, B: int, device, seed: int = 0,
               copies: bool = False, exp_flavor: str = "fast") -> types.SimpleNamespace:
    """A multi-tenant batch on ``rung``: B distinct tenants of one lattice
    (or B copies of its model), the inputs of a multi-tenant engine's carry
    with spread betas, and the entries ``kernel`` (#2 / #4), ``plain``
    (their plain versions) and ``single`` (#1 / #3 on the first slot's
    model's tables), each ``(inputs, sweeps) -> outputs``, on the exp
    flavour ``exp_flavor``."""
    from repro_torch.core import engine, ising, metropolis
    from repro_torch.kernels import ops, ref

    m = ising.random_layered_model(n=n, L=L, seed=seed, beta=1.1)
    eng = engine.SweepEngine.create([m] * B if copies else tenants(m, B), rung=rung,
                                    backend="torch", V=LANES, device=device)
    c = eng.init_carry(seed=seed + 1)
    betas = torch.linspace(0.3, 1.5, B, device=device, dtype=torch.float32)
    t = eng.slot_tables
    if rung == "cb":
        nbr = torch.as_tensor(m.space_nbr, dtype=torch.int64, device=device)
        classes = metropolis.classes_to(eng.classes, device)
        multi_fn = ops.make_colored_multisweep_multi(eng.classes, m.space_nbr, n=n,
                                                     exp_flavor=exp_flavor)
        single_fn = ops.make_colored_multisweep(eng.classes, m.h, m.space_nbr, m.space_J,
                                                m.tau_J, n=n, exp_flavor=exp_flavor)
        return types.SimpleNamespace(
            m=m, rows=eng.rows, inputs=(c.spins, c.rng, betas),
            kernel=lambda inp, S: multi_fn(*inp, t["h"], t["base_J"], t["tau_J"], S),
            plain=lambda inp, S: ref.colored_multisweep_multi_ref(
                *inp, classes, t["h"], nbr, t["base_J"], t["tau_J"], n, S, exp_flavor),
            single=lambda inp, S: single_fn(*inp, S),
        )
    nbr = torch.as_tensor(m.space_nbr, dtype=torch.int32, device=device)
    return types.SimpleNamespace(
        m=m, rows=eng.rows, inputs=(c.spins, c.h_space, c.h_tau, c.rng),
        kernel=lambda inp, S, tile=None: ops.metropolis_multisweep_multi(
            *inp, nbr, t["base_J2"], t["tau_J2"], betas, n, S, exp_flavor, replica_tile=tile),
        plain=lambda inp, S: ref.metropolis_multisweep_multi_ref(
            *inp, nbr, t["base_J2"], t["tau_J2"], betas, n, S, exp_flavor),
        single=lambda inp, S: ops.metropolis_multisweep(
            *inp, nbr, t["base_J2"][0], t["tau_J2"][0], betas, n, S, exp_flavor),
    )


def mt_state(V: int, device, seed: int = 0) -> torch.Tensor:
    from repro_torch.core import mt19937 as mt

    return mt.mt_init(np.arange(V, dtype=np.uint32) * np.uint32(2654435761) + np.uint32(seed), device)


def assert_same(got, want, what: str, names=("spins", "h_space", "h_tau", "rng"),
                bits: bool = False) -> float:
    """Raise unless every output is equal (``bits``: float32 outputs also
    bit pattern for bit pattern, so -0.0 != +0.0); return the max
    |difference| over the float outputs (0.0 when equal)."""
    err = 0.0
    for name, a, b in zip(names, got, want, strict=True):
        if a.dtype.is_floating_point:
            err = max(err, float((a.double() - b.double()).abs().max()))
        if bits and a.dtype == torch.float32 and not torch.equal(a.view(torch.int32),
                                                                b.view(torch.int32)):
            bad = (a.view(torch.int32) != b.view(torch.int32)).nonzero()
            raise AssertionError(f"{what}: {name} differs in bit pattern at {bad.shape[0]} of "
                                 f"{a.numel()} places, first {bad[0].tolist()}")
        if not torch.equal(a, b):
            bad = (a != b).nonzero()
            raise AssertionError(
                f"{what}: {name} differs at {bad.shape[0]} of {a.numel()} places, "
                f"first {bad[0].tolist()}: {a[tuple(bad[0])].item()} vs {b[tuple(bad[0])].item()}"
            )
    return err


@contextlib.contextmanager
def warp_groups(W: int):
    """Launch the colored kernels (#1, #2) with ``W`` warp groups a CTA."""
    from repro_torch.kernels import ops

    before, ops.COLORED_WARP_GROUPS = ops.COLORED_WARP_GROUPS, W
    try:
        yield
    finally:
        ops.COLORED_WARP_GROUPS = before


def check_mt(dev) -> float:
    """#6 in both flavours against its plain version on the card, bit for
    bit: the new state and the output of one block, and of `MT_CHAINED`
    blocks chained through the kernel's own state, at every V of
    `MT_CHECK_V`.  Returns the max |kernel - plain| of the uniforms."""
    from repro_torch.kernels import ops, ref

    err = 0.0
    for V in MT_CHECK_V:
        start = mt_state(V, dev, seed=V)
        for kern, plain, out in ((ops.mt_next_block, ref.mt_next_block_ref, "words"),
                                 (ops.mt_uniforms, ref.mt_uniforms_ref, "uniforms")):
            got, want = start, start
            for b in range(MT_CHAINED):
                got, got_out = kern(got)
                want, want_out = plain(want)
                err = max(err, assert_same((got, got_out), (want, want_out),
                                           f"MT block (624, {V}) {out}, block {b + 1}",
                                           names=("state", out), bits=True))
    print(f"[check mt] (624, V) at V = {', '.join(map(str, MT_CHECK_V))}, one block and "
          f"{MT_CHAINED} chained: tempered words and uniforms, kernel == plain (bit patterns)")
    return err


def accepted_tiles(rows: int, n: int, sd: int, B: int, multi: bool) -> list[int]:
    """The replica tiles > 1 that divide B and that an a4 CTA takes at this
    shape (`ops.a4_smem_plan`)."""
    from repro_torch.kernels import ops

    tiles = []
    for tile in range(2, B + 1):
        if B % tile:
            continue
        try:
            ops.a4_smem_plan(rows, n, sd, tile, multi)
        except ValueError:
            continue
        tiles.append(tile)
    return tiles


def check_a4(dev) -> tuple[float, float, float]:
    """#3, #4 (on B distinct tenants) and #5 against their plain versions on
    the card, bit pattern for bit pattern, at every shape of `A4_CHECKS`;
    each accepted replica tile at the shapes of `A4_TILE_CHECKS`; #4 on
    copies of one model against #3; the plain versions on the card against
    the CPU's at the main shape.
    Returns the max |kernel - plain| of #3, #4 and #5."""
    err3 = err4 = err5 = 0.0
    for what, n, L, B, S in A4_CHECKS:
        case = a4_case(n, L, B, dev, seed=n + B)
        mc = multi_case("a4", n, L, B, dev, seed=n + B)
        want, want_multi = case.plain(case.inputs, S), mc.plain(mc.inputs, S)
        want_sweep = case.sweep_plain(case.inputs, case.uniforms) if S else None
        err3 = max(err3, assert_same(case.fused(case.inputs, S), want, f"a4 {what}", bits=True))
        err4 = max(err4, assert_same(mc.kernel(mc.inputs, S), want_multi, f"a4 multi {what}",
                                     bits=True))
        if S:
            err5 = max(err5, assert_same(
                case.sweep(case.inputs, case.uniforms), want_sweep, f"a4 one sweep {what}",
                names=("spins", "h_space", "h_tau"), bits=True))
        print(f"[check a4] n={n} L={L} B={B} rows={case.rows} {S} sweeps ({what}): "
              f"metropolis_multisweep, metropolis_multisweep_multi on {B} tenants"
              f"{' and metropolis_sweep' if S else ''} == plain (bit patterns)")
    checked_tiles = 0
    for n, L, B, S in A4_TILE_CHECKS:
        case = a4_case(n, L, B, dev, seed=n)
        mc = multi_case("a4", n, L, B, dev, seed=n)
        want, want_multi = case.plain(case.inputs, S), mc.plain(mc.inputs, S)
        sd = case.m.space_degree
        tiles = accepted_tiles(case.rows, n, sd, B, multi=False)
        tiles_m = accepted_tiles(case.rows, n, sd, B, multi=True)
        for tile in tiles:
            err3 = max(err3, assert_same(case.fused(case.inputs, S, tile), want,
                                         f"a4 tile {tile}", bits=True))
        for tile in tiles_m:
            err4 = max(err4, assert_same(mc.kernel(mc.inputs, S, tile), want_multi,
                                         f"a4 multi tile {tile}", bits=True))
        checked_tiles += len(tiles) + len(tiles_m)
        print(f"[check a4 tile] n={n} L={L} B={B} rows={case.rows} {S} sweeps: replica tiles "
              f"{tiles} (multi-tenant {tiles_m}) == plain (bit patterns)")
    if not checked_tiles:
        raise AssertionError(f"no replica tile > 1 fits at any shape of {A4_TILE_CHECKS}")
    main = a4_case(MAIN_N, MAIN_L, MAIN_SLOTS, dev)
    cpu = a4_case(MAIN_N, MAIN_L, MAIN_SLOTS, "cpu")
    assert_same([t.cpu() for t in main.plain(main.inputs, 8)], cpu.plain(cpu.inputs, 8),
                "a4 plain cuda vs cpu", bits=True)
    mc = multi_case("a4", MAIN_N, MAIN_L, MAIN_SLOTS, dev)
    mc_cpu = multi_case("a4", MAIN_N, MAIN_L, MAIN_SLOTS, "cpu")
    assert_same([t.cpu() for t in mc.plain(mc.inputs, 8)], mc_cpu.plain(mc_cpu.inputs, 8),
                "a4 multi plain cuda vs cpu", bits=True)
    copies = multi_case("a4", MAIN_N, MAIN_L, MAIN_SLOTS, dev, seed=7, copies=True)
    assert_same(copies.kernel(copies.inputs, 8), copies.single(copies.inputs, 8),
                "a4 multi on copies vs single-model kernel", bits=True)
    print(f"[check a4] main shape: both plain versions on card == on CPU; {MAIN_SLOTS} copies of "
          f"one model: metropolis_multisweep_multi == metropolis_multisweep (bit patterns)")
    return err3, err4, err5


def check_colored(dev) -> tuple[float, float]:
    """#1 and #2 against their plain versions on the card, bit for bit, at
    every shape of `CB_CHECKS` and every warp-group count of
    `CB_WARP_GROUPS` (#2 on B distinct tenants); #2 on copies of one model
    against #1; the plain versions on the card against the CPU's at the
    main shape.  Returns the max |kernel - plain| of #1 and of #2."""
    err1 = err2 = 0.0
    for W in CB_WARP_GROUPS:
        with warp_groups(W):
            for what, n, L, B, S in CB_CHECKS:
                _, rows, kernel, plain, inputs = colored_case(n, L, B, dev, seed=n + B)
                err1 = max(err1, assert_same(kernel(*inputs, S), plain(*inputs, S),
                                             f"cb {what} W={W}"))
                mc = multi_case("cb", n, L, B, dev, seed=n + B)
                err2 = max(err2, assert_same(mc.kernel(mc.inputs, S), mc.plain(mc.inputs, S),
                                             f"cb multi {what} W={W}"))
                print(f"[check cb] W={W} n={n} L={L} B={B} rows={rows} {S} sweeps ({what}): "
                      f"colored_multisweep == plain, colored_multisweep_multi on {B} tenants == "
                      f"plain (bit-equal)")
            copies = multi_case("cb", MAIN_N, MAIN_L, MAIN_SLOTS, dev, seed=7, copies=True)
            assert_same(copies.kernel(copies.inputs, 8), copies.single(copies.inputs, 8),
                        f"cb multi on copies vs single-model kernel, W={W}")
            print(f"[check cb multi] W={W}: {MAIN_SLOTS} copies of one model: "
                  f"colored_multisweep_multi == colored_multisweep (bit-equal)")
    _, _, _, plain, inputs = colored_case(MAIN_N, MAIN_L, MAIN_SLOTS, dev)
    _, _, _, plain_cpu, _ = colored_case(MAIN_N, MAIN_L, MAIN_SLOTS, "cpu")
    assert_same([t.cpu() for t in plain(*inputs, 8)], plain_cpu(*(t.cpu() for t in inputs), 8),
                "cb plain cuda vs cpu")
    mc = multi_case("cb", MAIN_N, MAIN_L, MAIN_SLOTS, dev)
    mc_cpu = multi_case("cb", MAIN_N, MAIN_L, MAIN_SLOTS, "cpu")
    assert_same([t.cpu() for t in mc.plain(mc.inputs, 8)], mc_cpu.plain(mc_cpu.inputs, 8),
                "cb multi plain cuda vs cpu")
    print("[check cb] main shape: both plain versions on card == on CPU (bit-equal)")
    return err1, err2


def check_flavours(dev) -> dict:
    """#1-#5 on the exps "accurate" and "exact" against their plain versions
    on the card, bit pattern for bit pattern, at every shape of
    `FLAVOUR_CHECKS` (#2 and #4 on B distinct tenants; #5 one sweep on the
    plain generator's uniforms); "accurate"'s plain versions on the card
    against the CPU's at the serving shape ("exact" is `torch.exp`, whose
    last bits differ between the card and the CPU).  Returns the max
    |kernel - plain| of each kernel."""
    names = ("colored_multisweep", "colored_multisweep_multi", "metropolis_multisweep",
             "metropolis_multisweep_multi", "metropolis_sweep")
    err = dict.fromkeys(names, 0.0)
    for flavor in OTHER_FLAVOURS:
        for what, n, L, B, S in FLAVOUR_CHECKS:
            seed = n + B
            _, rows, kernel, plain, inputs = colored_case(n, L, B, dev, seed, flavor)
            err[names[0]] = max(err[names[0]], assert_same(
                kernel(*inputs, S), plain(*inputs, S), f"cb {flavor} {what}", bits=True))
            mc = multi_case("cb", n, L, B, dev, seed, exp_flavor=flavor)
            err[names[1]] = max(err[names[1]], assert_same(
                mc.kernel(mc.inputs, S), mc.plain(mc.inputs, S), f"cb multi {flavor} {what}",
                bits=True))
            case = a4_case(n, L, B, dev, seed, flavor)
            err[names[2]] = max(err[names[2]], assert_same(
                case.fused(case.inputs, S), case.plain(case.inputs, S), f"a4 {flavor} {what}",
                bits=True))
            mc = multi_case("a4", n, L, B, dev, seed, exp_flavor=flavor)
            err[names[3]] = max(err[names[3]], assert_same(
                mc.kernel(mc.inputs, S), mc.plain(mc.inputs, S), f"a4 multi {flavor} {what}",
                bits=True))
            err[names[4]] = max(err[names[4]], assert_same(
                case.sweep(case.inputs, case.uniforms), case.sweep_plain(case.inputs, case.uniforms),
                f"a4 one sweep {flavor} {what}", names=("spins", "h_space", "h_tau"), bits=True))
            print(f"[check flavours] {flavor}: n={n} L={L} B={B} rows={rows} {S} sweeps ({what}): "
                  f"colored_multisweep, colored_multisweep_multi on {B} tenants, "
                  f"metropolis_multisweep, metropolis_multisweep_multi on {B} tenants, "
                  f"metropolis_sweep == plain (bit patterns)")
    for rung in ("cb", "a4"):
        if rung == "cb":
            _, _, _, plain, inputs = colored_case(MAIN_N, MAIN_L, MAIN_SLOTS, dev, 0, "accurate")
            _, _, _, plain_cpu, _ = colored_case(MAIN_N, MAIN_L, MAIN_SLOTS, "cpu", 0, "accurate")
            got, want = plain(*inputs, 8), plain_cpu(*(t.cpu() for t in inputs), 8)
        else:
            case = a4_case(MAIN_N, MAIN_L, MAIN_SLOTS, dev, 0, "accurate")
            cpu = a4_case(MAIN_N, MAIN_L, MAIN_SLOTS, "cpu", 0, "accurate")
            got, want = case.plain(case.inputs, 8), cpu.plain(cpu.inputs, 8)
        assert_same([t.cpu() for t in got], want, f"{rung} accurate plain cuda vs cpu", bits=True)
    print("[check flavours] accurate, the serving shape: the plain cb and a4 multisweeps on the "
          "card == on the CPU (bit patterns)")
    return err


def ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in float32 ulps (the distance of their bit patterns on the
    ordered integer line), 0 where both are NaN or equal infinities."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(2**31) - i, i)

    d = (ordered(a) - ordered(b)).abs()
    return torch.where(a.isnan() & b.isnan(), torch.zeros_like(d), d)


def check_sweep_exp_exhaustive(dev, chunk: int = 2**28) -> None:
    """The sweep kernels' exp, ``sweep_exp<F>`` for F "exact" and
    "accurate" (csrc/sweep_exp_check.cu, built as the sweep kernels are),
    against the plain exps on the card (`exp_reference`: `torch.exp` with
    the flush; `fastexp_accurate`) over all 2^32 float32 bit patterns,
    bit for bit with NaNs unified; then "exact" on the card, on the exp
    cases of `fastexp_cases`, within 2 ulp of the correctly rounded exp
    (float64 exp rounded to float32, flushed), and its distance from the
    CPU's `exp_reference` printed."""
    from repro_torch.core import fastexp as fx
    from repro_torch.kernels import ops

    nan_bits = torch.tensor(0x7FC00000, dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    bad = dict.fromkeys(("exact", "accurate"), 0)
    first = {}
    for lo in range(-(2**31), 2**31, chunk):
        x = torch.arange(lo, lo + chunk, dtype=torch.int32, device=dev).view(torch.float32)
        for flavor in bad:
            got, want = ops._sweep_exp_check(x, flavor), fx.EXP_FNS[flavor](x)
            g, w = (torch.where(t.isnan(), nan_bits, t.view(torch.int32)) for t in (got, want))
            diff = (g != w).nonzero()
            if diff.numel():
                bad[flavor] += diff.shape[0]
                i = int(diff[0])
                first.setdefault(flavor, f"x bits {lo + i:#010x}: {got[i].item()!r} vs "
                                         f"{want[i].item()!r}")
        del x, got, want, g, w
    torch.cuda.synchronize()
    if any(bad.values()):
        raise AssertionError(f"sweep_exp vs the plain exps over all 2^32 float32 inputs: "
                             f"differing inputs {bad}, first {first}")
    print(f"[check sweep_exp] all 2^32 float32 bit patterns: sweep_exp<exact> == exp_reference "
          f"(torch.exp, flushed) and sweep_exp<accurate> == fastexp_accurate on the card "
          f"(bit-equal, NaNs unified) in {time.perf_counter() - t0:.1f} s")
    # "exact" on the card is CUDA's expf, within 2 ulp of the correctly
    # rounded exp (CUDA's documented bound); the CPU's torch.exp is another
    # libm, so the two are compared for the record, not to each other.
    worst = {"card vs correctly rounded": (0, None), "card vs CPU": (0, None)}
    for what, x in fastexp_cases():
        x = x.float().reshape(-1)
        card = ops._sweep_exp_check(x.to(dev), "exact").cpu()
        correct = fx.flush_subnormal(torch.exp(x.double()).float())
        for key, d in (("card vs correctly rounded", ulps(card, correct)),
                       ("card vs CPU", ulps(card, fx.exp_reference(x)))):
            i = int(d.argmax())
            if int(d[i]) > worst[key][0]:
                worst[key] = (int(d[i]), float(x[i]))
    print(f"[check sweep_exp] exact on the card, the exp cases: at most "
          f"{worst['card vs correctly rounded'][0]} ulp from the correctly rounded exp (at x = "
          f"{worst['card vs correctly rounded'][1]}), at most {worst['card vs CPU'][0]} ulp from "
          f"exp_reference on the CPU (at x = {worst['card vs CPU'][1]})")
    if worst["card vs correctly rounded"][0] > 2:
        raise AssertionError(f"sweep_exp<exact> on the card: {worst}")


def pt_swap_case(n: int, L: int, B: int, R: int, device, seed: int):
    """A (B, rows, 128) block of +-1 spins, the block's betas (the ladder's
    geometric betas at its rows, others elsewhere), the ladder's R rows (a
    random permutation of R of the B slots, so none is in replica order),
    and the energy tables of a model of that shape, on ``device``."""
    from repro_torch.core import ising, tempering

    g = torch.Generator().manual_seed(seed)
    rows = torch.randperm(B, generator=g)[:R].to(torch.int32)
    spins = torch.where(torch.rand(B, n * L // LANES, LANES, generator=g) < 0.5, -1.0, 1.0)
    betas = 0.5 + torch.rand(B, generator=g)
    betas[rows.long()] = torch.from_numpy(
        np.geomspace(PT_BETA_MIN, PT_BETA_MAX, R).astype(np.float32))
    m = ising.random_layered_model(n=n, L=L, seed=seed, beta=1.0)
    return (spins.to(device), betas.to(device), rows.to(device),
            tempering.model_energy_tables(m, device))


def check_pt_swap(dev) -> float:
    """#8 against `ref.pt_swap_ref` on the same card tensors at every shape
    of `PT_SWAP_CHECKS`, from each parity, on every exp flavour:
    `PT_SWAP_ROUNDS` chained rounds (a tenth of the spins flipped between
    rounds; betas, generator and counters carried), each round's energies
    and betas (bit patterns), generator words and counters equal, swaps
    both accepted and refused, one launch a round (counts zeroed just
    before, read just after).  The plain version's energies of the first
    round on the card are also held against the CPU's.  Returns the
    largest |difference| (0)."""
    from repro_torch.core import mt19937 as mt
    from repro_torch.kernels import ops, ref

    n_flav = 1 + len(OTHER_FLAVOURS)
    for what, n, L, B, R in PT_SWAP_CHECKS:
        accepted = proposed = 0
        for parity in (0, 1):
            for flavor in ("fast", *OTHER_FLAVOURS):
                spins, betas, rows, tables = pt_swap_case(n, L, B, R, dev, seed=B + R + parity)
                zero = torch.zeros((), dtype=torch.int32, device=dev)
                got = want = (betas, mt.mt_init(1000 + R + parity, dev), zero, zero)
                flips = torch.Generator().manual_seed(R + parity)
                ops.reset_launches()
                for r in range(PT_SWAP_ROUNDS):
                    p = (parity + r) % 2
                    where = f"pt_swap {what}, parity {parity}, {flavor}, round {r}"
                    if r == 0 and flavor == "fast":
                        e_cpu = ref.pt_swap_ref(
                            *(t.cpu() for t in (spins, want[0], rows, *want[1:], *tables)), n, p,
                            flavor)[0]
                    e_got, *got = ops.pt_swap(spins, got[0], rows, *got[1:], *tables, n, p, flavor)
                    e_want, *want = ref.pt_swap_ref(spins, want[0], rows, *want[1:], *tables, n,
                                                    p, flavor)
                    same_bits(e_got, e_want, f"{where}: energies")
                    if r == 0 and flavor == "fast":
                        same_bits(e_want.cpu(), e_cpu, f"{where}: plain energies, card vs CPU")
                    same_bits(got[0], want[0], f"{where}: betas")
                    for name, a, b in zip(("generator", "accepted", "proposed"), got[1:], want[1:]):
                        if not torch.equal(a, b):
                            raise AssertionError(f"{where}: {name} differs")
                    flip = torch.rand(spins.shape, generator=flips) < 0.1
                    spins = torch.where(flip.to(dev), -spins, spins)
                if ops.launches["pt_swap"] != PT_SWAP_ROUNDS or sum(ops.launches.values()) != \
                        PT_SWAP_ROUNDS:
                    raise AssertionError(f"pt_swap {what}: launches {dict(ops.launches)}")
                accepted, proposed = accepted + int(got[2]), proposed + int(got[3])
        if not 0 < accepted < proposed:
            raise AssertionError(f"pt_swap {what}: {accepted} of {proposed} swaps accepted")
        print(f"[check pt_swap] {what} (R={R} of B={B}, n={n} L={L}): {PT_SWAP_ROUNDS} chained "
              f"rounds from each parity x {n_flav} flavours, energies, betas, generator and "
              f"counters bit-equal to the plain version on the card each round, "
              f"{PT_SWAP_ROUNDS} launches a chain; {accepted} of {proposed} swaps accepted")
    return 0.0


def time_pt_swap(dev) -> tuple:
    """#8 at the paper's ladder (R=115 rows scattered in a 115-slot carry,
    n=96 L=256), on the card alone, beside its plain version (CUDA events
    around back-to-back calls) and its bound: the ladder's spins read once
    (float64 arithmetic is under the read; the card's peak table gives no
    float64 rate).  Returns (ms, plain ms, bound)."""
    from repro_torch.core import mt19937 as mt
    from repro_torch.kernels import ops, ref

    spins, betas, rows, tables = pt_swap_case(MAIN_N, MAIN_L, PT_R, PT_R, dev, seed=7)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    args = (spins, betas, rows, mt.mt_init(7, dev), zero, zero, *tables, MAIN_N, 0, "fast")
    t_k = cuda_ms_queued(lambda: ops.pt_swap(*args), reps=50)
    t_p = cuda_ms(lambda: ref.pt_swap_ref(*args), reps=10)
    return t_k, t_p, bound((4 * spins[:PT_R].numel(), 0, 0))


def pt_model():
    from repro_torch.core import ising

    return ising.random_layered_model(n=MAIN_N, L=MAIN_L, seed=0, beta=1.2)


def pt_betas() -> np.ndarray:
    return np.geomspace(PT_BETA_MIN, PT_BETA_MAX, PT_R).astype(np.float32)


def check_pt_state(what: str, state, energies, m, betas, rounds: int) -> None:
    """What a finished ladder must show: +-1 spins of the lane shape, the
    beta multiset kept, a proposal count of one per pair a round, an
    accept count within it, finite energies equal to the spins' float64
    energies rounded to float32."""
    from repro_torch.core import engine, observables, reorder

    R = len(betas)
    if tuple(state.spins.shape) != (R, MAIN_N * MAIN_L // LANES, LANES):
        raise AssertionError(f"{what}: spins of shape {tuple(state.spins.shape)}")
    if not bool((state.spins.abs() == 1.0).all()):
        raise AssertionError(f"{what}: spins not +-1")
    if not np.array_equal(np.sort(state.betas.cpu().numpy()), np.sort(betas)):
        raise AssertionError(f"{what}: the beta multiset changed")
    want_prop = sum(len(range(r % 2, R - 1, 2)) for r in range(rounds))
    acc, prop = int(state.swap_accept), int(state.swap_propose)
    if prop != want_prop or not 0 <= acc <= prop:
        raise AssertionError(f"{what}: {acc} accepted of {prop} proposed, want {want_prop}")
    flat = np.stack([reorder.from_lane(s, m.n, m.L, LANES) for s in state.spins.cpu().numpy()])
    if energies.shape != (R,) or not np.all(np.isfinite(energies)) or not np.array_equal(
            energies, observables.energies(m, flat).astype(np.float32)):
        raise AssertionError(f"{what}: energies are not the spins' energies")


def same_pt_state(got, want, what: str) -> None:
    """Raise unless two PT states are equal, float fields bit pattern for
    bit pattern."""
    from repro_torch.core import tempering

    for f in tempering.PTState._fields:
        a, b = getattr(got, f), getattr(want, f)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: {f} differs")


def sweep_launches(launches: dict) -> int:
    """Launches of every kernel but #8, which a ladder's swap phase
    launches beside the sweep kernels, once a round."""
    return sum(v for k, v in launches.items() if k != "pt_swap")


def check_swaps(what: str, launches: dict, want: int, fused: int | None = None) -> None:
    """Raise unless #8 was launched ``want`` times, one a round swapped on
    one device, and the server counted as many (``fused``:
    `stats()["placement"]["pt_swap_fused"]`; None for no server)."""
    if launches["pt_swap"] != want or fused not in (None, want):
        raise AssertionError(f"{what}: {launches['pt_swap']} pt_swap launches, server "
                             f"pt_swap_fused {fused}, want {want}")


def pt_standalone(dev) -> dict:
    """`run_parallel_tempering` at R=115, n=96 L=256, `PT_ROUNDS` rounds of
    `PT_SWEEPS` sweeps, on each rung and with the "fast" and "accurate"
    exps: backend "cuda" (one launch of the rung's kernel and one of #8 a
    round, counts zeroed just before and read just after) equal to backend
    "torch" on the card, bit for bit.  Both backends swap through #8 on
    the card; `check_pt_swap` holds #8 against its plain version.  Returns
    {(rung, flavor): (state, energies, launches)}."""
    from repro_torch.core import tempering
    from repro_torch.kernels import ops

    m, betas = pt_model(), pt_betas()
    out = {}
    for rung in ("a4", "cb"):
        for flavor in ("fast", "accurate"):
            kw = dict(seed=11, sweeps_per_round=PT_SWEEPS, rung=rung, exp_flavor=flavor)
            ops.reset_launches()
            t0 = time.perf_counter()
            state, energies = tempering.run_parallel_tempering(m, betas, PT_ROUNDS,
                                                               backend="cuda", **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = dict(ops.launches)
            kernel = SERVE_KERNEL[rung]
            if launches[kernel] != PT_ROUNDS or sweep_launches(launches) != PT_ROUNDS:
                raise AssertionError(f"PT {rung} {flavor}: launches {launches}, want "
                                     f"{PT_ROUNDS} {kernel}")
            check_swaps(f"PT {rung} {flavor}", launches, PT_ROUNDS)
            t0 = time.perf_counter()
            plain, plain_e = tempering.run_parallel_tempering(m, betas, PT_ROUNDS,
                                                              backend="torch", V=LANES, **kw)
            torch.cuda.synchronize()
            dt_plain = time.perf_counter() - t0
            same_pt_state(state, plain, f"PT {rung} {flavor}: cuda vs torch backend")
            if not np.array_equal(energies, plain_e):
                raise AssertionError(f"PT {rung} {flavor}: energies differ between backends")
            check_pt_state(f"PT {rung} {flavor}", state, energies, m, betas, PT_ROUNDS)
            out[rung, flavor] = (state, energies, launches)
            print(f"[pt {rung}] {flavor}: R={PT_R} n={MAIN_N} L={MAIN_L}, {PT_ROUNDS} rounds of "
                  f"{PT_SWEEPS} sweeps: {launches[kernel]} {kernel} + {launches['pt_swap']} "
                  f"pt_swap launches, {dt:.3f} s; "
                  f"backend torch on the card {dt_plain:.3f} s; spins, fields, betas, generator "
                  f"state, swap generator and counts bit-equal ({int(state.swap_accept)} of "
                  f"{int(state.swap_propose)} swaps accepted); energies finite, == the spins'")
    return out


def pt_served(standalone: dict) -> None:
    """One PTJob (R=115, the standalone run's seed, betas and rounds) and
    `PT_ANNEAL_JOBS` anneal jobs on a `PT_SLOTS`-slot server, policy
    "fair", chunks of `PT_CHUNK` sweeps (rounds split across chunks), on
    each rung: the ladder equals the standalone run bit for bit, every
    anneal job its solo run, the rung's kernel ran every sweep launch and
    #8 every round's swap phase."""
    from repro_torch.core import engine, reorder
    from repro_torch.kernels import ops
    from repro_torch.serve_mc import AnnealJob, PTJob, SampleServer

    m, betas = pt_model(), pt_betas()
    rng = np.random.default_rng(5)
    specs = [(2000 + i, int(rng.integers(32, 129)), float(rng.uniform(0.5, 1.5)))
             for i in range(PT_ANNEAL_JOBS)]
    for rung in ("a4", "cb"):
        state, _, _ = standalone[rung, "fast"]
        server = SampleServer(m, slots=PT_SLOTS, chunk_sweeps=PT_CHUNK, rung=rung,
                              policy="fair")
        for seed, sweeps, beta in specs:
            server.submit(AnnealJob.constant(seed=seed, sweeps=sweeps, beta=beta))
        pt = PTJob(seed=11, betas=betas, num_rounds=PT_ROUNDS, sweeps_per_round=PT_SWEEPS)
        server.submit(pt)
        ops.reset_launches()
        t0 = time.perf_counter()
        results = {r.jid: r for r in server.drain()}
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(ops.launches)
        kernel = SERVE_KERNEL[rung]
        if launches[kernel] != server.launches or sweep_launches(launches) != launches[kernel]:
            raise AssertionError(f"PT served {rung}: launches {launches} vs {server.launches}")
        check_swaps(f"PT served {rung}", launches, PT_ROUNDS,
                    server.stats()["placement"]["pt_swap_fused"])
        r = results[pt.jid]
        solo = np.stack([reorder.from_lane(s, m.n, m.L, LANES) for s in state.spins.cpu().numpy()])
        if not (np.array_equal(r.spins, solo)
                and np.array_equal(r.extras["betas"], state.betas.cpu().numpy())
                and r.extras["swap_accept"] == int(state.swap_accept)
                and r.extras["swap_propose"] == int(state.swap_propose)
                and torch.equal(pt.swap_rng, state.swap_rng)):
            raise AssertionError(f"PT served {rung}: the ladder != the standalone run")
        if r.chunks <= PT_ROUNDS:
            raise AssertionError(f"PT served {rung}: rounds were not split ({r.chunks} chunks)")
        eng = engine.SweepEngine.create(m, rung=rung)
        for jid, (seed, sweeps, beta) in enumerate(specs):
            carry = eng.run(eng.init_slot_carry(seed=seed, beta=beta), sweeps)
            if not np.array_equal(results[jid].spins, eng.spins_flat(carry)[0]):
                raise AssertionError(f"PT served {rung}: anneal job {jid} != its solo run")
        st = server.stats()
        print(f"[pt served {rung}] PTJob R={PT_R} ({PT_ROUNDS} rounds of {PT_SWEEPS}) + "
              f"{PT_ANNEAL_JOBS} anneal jobs on {PT_SLOTS} slots, policy fair, chunk {PT_CHUNK}: "
              f"{st['launches']} launches == {launches[kernel]} {kernel} launches, "
              f"{launches['pt_swap']} pt_swap launches == rounds, the ladder in "
              f"{r.chunks} chunks, {dt:.3f} s, {st['busy_slot_sweeps'] / dt:.0f} slot-sweeps/s; "
              f"the ladder == the standalone run, every anneal job == its solo run (bit-equal)")


def pt_multi_tenant() -> None:
    """A PTJob on its own model (a tenant) beside anneal jobs on other
    tenants, on a multi-tenant server of `PT_SLOTS` slots, on each rung
    (#4, #2, and #8 on the tenant's tables once a round; counts zeroed
    just before, read just after): the ladder equals
    `run_parallel_tempering` of its model, bit for bit."""
    from repro_torch.core import reorder, tempering
    from repro_torch.kernels import ops
    from repro_torch.serve_mc import AnnealJob, PTJob, SampleServer

    m, betas = pt_model(), pt_betas()
    tenant_models = tenants(m, 3)
    for rung in ("a4", "cb"):
        state, energies = tempering.run_parallel_tempering(
            tenant_models[0], betas, PT_MULTI_ROUNDS, seed=12, sweeps_per_round=PT_SWEEPS,
            rung=rung)
        server = SampleServer(m, slots=PT_SLOTS, chunk_sweeps=PT_CHUNK, rung=rung,
                              multi_tenant=True)
        for i, model in enumerate((tenant_models[1], tenant_models[2], None)):
            server.submit(AnnealJob.constant(seed=3000 + i, sweeps=40 + 16 * i, beta=1.0,
                                             model=model))
        pt = PTJob(seed=12, betas=betas, num_rounds=PT_MULTI_ROUNDS, sweeps_per_round=PT_SWEEPS,
                   model=tenant_models[0])
        server.submit(pt)
        ops.reset_launches()
        r = {r.jid: r for r in server.drain()}[pt.jid]
        launches = dict(ops.launches)
        kernel = MULTI_KERNEL[rung]
        if launches[kernel] != server.launches or sweep_launches(launches) != launches[kernel]:
            raise AssertionError(f"PT multi {rung}: launches {launches} vs {server.launches}")
        check_swaps(f"PT multi {rung}", launches, PT_MULTI_ROUNDS,
                    server.stats()["placement"]["pt_swap_fused"])
        solo = np.stack([reorder.from_lane(s, m.n, m.L, LANES) for s in state.spins.cpu().numpy()])
        if not (np.array_equal(r.spins, solo)
                and np.array_equal(r.extras["betas"], state.betas.cpu().numpy())
                and r.extras["swap_accept"] == int(state.swap_accept)
                and r.extras["swap_propose"] == int(state.swap_propose)
                and np.array_equal(r.energy.astype(np.float32), energies)):
            raise AssertionError(f"PT multi {rung}: the tenant's ladder != its solo run")
        print(f"[pt multi {rung}] PTJob R={PT_R} on a tenant + 3 anneal jobs on {PT_SLOTS} "
              f"slots: {server.launches} launches == {launches[kernel]} {kernel} launches, "
              f"{launches['pt_swap']} pt_swap launches; the "
              f"ladder == run_parallel_tempering of its model (bit-equal)")


def pt_cli() -> None:
    """``anneal_serve --pt-replicas 115 --pt-rounds 8 --rung a4`` at n=96
    L=256 on `PT_SLOTS` slots: every job served, the ladder's result
    whole, every sweep launch the a4 kernel's and every round's swap #8's."""
    from repro_torch.core import observables
    from repro_torch.kernels import ops
    from repro_torch.launch import anneal_serve

    ops.reset_launches()
    report = anneal_serve.main([
        "--pt-replicas", str(PT_R), "--pt-rounds", str(PT_CLI_ROUNDS), "--rung", "a4",
        "--n", str(MAIN_N), "--L", str(MAIN_L), "--slots", str(PT_SLOTS), "--jobs", "8",
        "--chunk", str(MAIN_CHUNK), "--quiet"])
    launches = dict(ops.launches)
    if launches["metropolis_multisweep"] != report.server.launches or sweep_launches(
            launches) != launches["metropolis_multisweep"]:
        raise AssertionError(f"PT CLI: launches {launches} vs {report.server.launches}")
    check_swaps("PT CLI", launches, PT_CLI_ROUNDS,
                report.server.stats()["placement"]["pt_swap_fused"])
    pt = [r for r in report.results if r.spins.ndim == 2]
    if len(report.results) != 9 or len(pt) != 1 or pt[0].spins.shape != (PT_R, MAIN_N * MAIN_L):
        raise AssertionError(f"PT CLI: served {len(report.results)} jobs, {len(pt)} ladders")
    r = pt[0]
    if not np.array_equal(r.energy, observables.energies(report.model, r.spins)) or \
            r.sweeps_done != PT_CLI_ROUNDS * (MAIN_CHUNK // 2):
        raise AssertionError("PT CLI: the ladder's result is not whole")
    print(f"[pt cli] anneal_serve --pt-replicas {PT_R} --pt-rounds {PT_CLI_ROUNDS} --rung a4 "
          f"--slots {PT_SLOTS} --jobs 8 (n={MAIN_N} L={MAIN_L}): 9 jobs served in "
          f"{report.seconds:.3f} s, {report.server.launches} metropolis_multisweep and "
          f"{launches['pt_swap']} pt_swap launches, "
          f"the ladder {r.extras['swap_accept']} of {r.extras['swap_propose']} swaps accepted")


def pt_host_syncs(eng, state) -> tuple[int, str]:
    """Host syncs of one PT round: the warnings `torch.cuda`'s sync debug
    mode raises for every synchronizing call while the round is enqueued,
    and where in the port they were raised."""
    import traceback
    import warnings

    from repro_torch.core import tempering

    sites = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            port = [f for f in traceback.extract_stack() if "repro_torch" in f.filename]
            sites.append(f"{Path(port[-1].filename).name}:{port[-1].lineno}" if port else
                         f"{Path(filename).name}:{lineno}")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            tempering.pt_round(eng, state, 0, PT_SWEEPS)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return len(sites), ", ".join(sites) or "none"


def time_pt(smi: str) -> dict:
    """PT rounds at R=115, n=96 L=256, `PT_SWEEPS` sweeps a round, on each
    rung and flavour: rounds/s and replica-sweeps/s over a steady window
    (host clock, synchronized), the card's time of the sweep launch and
    of the swap phase (#8) from CUDA events around
    each, their shares of a round, and the round's host syncs, beside the
    card's name and power limit (``smi``).  Returns
    {(rung, flavor): (rounds/s, sweep ms, swap ms, round ms, syncs)}."""
    from repro_torch.core import engine, tempering

    m, betas = pt_model(), pt_betas()
    rounds = 20
    out = {}
    for rung in ("a4", "cb"):
        for flavor in ("fast", "accurate"):
            eng = tempering.make_pt_engine(m, PT_R, rung=rung, exp_flavor=flavor)
            state = tempering.init_pt(m, betas, seed=11, engine=eng)
            for r in range(2):
                state = tempering.pt_round(eng, state, r % 2, PT_SWEEPS)
            syncs, sync_sites = pt_host_syncs(eng, state)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for r in range(rounds):
                state = tempering.pt_round(eng, state, r % 2, PT_SWEEPS)
            torch.cuda.synchronize()
            round_ms = (time.perf_counter() - t0) / rounds * 1e3
            tables = tempering.energy_tables(eng)
            marks = []
            for r in range(rounds):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                ev[0].record()
                carry = eng.run(engine.SweepCarry(*state[:5]), PT_SWEEPS)
                ev[1].record()
                state = tempering.swap_phase(state._replace(
                    spins=carry.spins, h_space=carry.h_space, h_tau=carry.h_tau,
                    rng=carry.rng), *tables, r % 2, m.n, flavor)
                ev[2].record()
                marks.append(ev)
            torch.cuda.synchronize()
            sweep_ms = sum(e[0].elapsed_time(e[1]) for e in marks) / rounds
            swap_ms = sum(e[1].elapsed_time(e[2]) for e in marks) / rounds
            out[rung, flavor] = (1e3 / round_ms, sweep_ms, swap_ms, round_ms, syncs)
            print(f"[time pt {rung}] {flavor}: R={PT_R}, {PT_SWEEPS} sweeps a round: "
                  f"{1e3 / round_ms:.1f} rounds/s, {PT_R * PT_SWEEPS * 1e3 / round_ms:,.0f} "
                  f"replica-sweeps/s ({round_ms:.4f} ms a round, host clock); on the card: "
                  f"sweep launch {sweep_ms:.4f} ms ({sweep_ms / round_ms:.3f} of the round), "
                  f"swap phase {swap_ms:.4f} ms ({swap_ms / round_ms:.3f}); {syncs} host "
                  f"syncs a round ({sync_sites}); {smi}")
    return out


def serve_checked(rung: str) -> tuple:
    """Serve the 12-job mix on ``rung`` through its kernel (counts zeroed
    just before, read just after), check every result, serve it again
    with the plain version on the card and require bit-identical results.
    Returns (report, the launch counts of the kernel-served run)."""
    from repro_torch.core import observables
    from repro_torch.kernels import ops
    from repro_torch.launch import anneal_serve

    kernel = SERVE_KERNEL[rung]
    argv = SERVE_ARGS + ["--rung", rung, "--device", "cuda"]
    ops.reset_launches()
    report = anneal_serve.main(argv + ["--backend", "cuda"])
    launches = dict(ops.launches)
    served = report.server.stats()
    if launches[kernel] == 0:
        raise AssertionError(f"the {rung} serving path never launched {kernel}")
    if launches[kernel] != served["launches"] or sum(launches.values()) != launches[kernel]:
        raise AssertionError(f"kernel launches {launches} != server launches {served['launches']}")
    if len(report.results) != 12:
        raise AssertionError(f"{rung}: served {len(report.results)} of 12 jobs")
    N = MAIN_N * MAIN_L
    for r in report.results:
        if r.spins.shape != (N,) or not np.all(np.abs(r.spins) == 1.0):
            raise AssertionError(f"{rung} job {r.jid}: spins not +-1 of shape ({N},)")
        if not np.isfinite(r.energy) or r.energy != observables.energies(report.model, r.spins):
            raise AssertionError(f"{rung} job {r.jid}: energy {r.energy} disagrees with its spins")
    plain_report = anneal_serve.main(argv + ["--backend", "torch"])
    got = {r.jid: r for r in report.results}
    for r in plain_report.results:
        g = got[r.jid]
        if not (np.array_equal(g.spins, r.spins) and g.energy == r.energy
                and g.sweeps_done == r.sweeps_done and g.chunks == r.chunks
                and g.extras["final_beta"] == r.extras["final_beta"]):
            raise AssertionError(f"{rung} job {r.jid}: kernel-served result != plain-served result")
    host_split(rung, report.server, report.seconds)
    if list(report.server._retired) != list(plain_report.server._retired):
        raise AssertionError(f"{rung}: retirement order differs between kernel and plain serving")
    sweeps_s = served["busy_slot_sweeps"] / report.seconds
    flips_s = served["spin_flips"] / report.seconds
    print(f"[serve {rung}] 12 jobs, n={MAIN_N} L={MAIN_L}, {MAIN_SLOTS} slots, chunk {MAIN_CHUNK}: "
          f"{served['launches']} launches == {launches[kernel]} {kernel} launches, "
          f"{report.seconds:.3f} s, {sweeps_s:.0f} slot-sweeps/s, {flips_s / 1e6:.2f}M spin-flips/s, "
          f"{len(report.results) / report.seconds:.1f} jobs/s; plain-served on the card: "
          f"{plain_report.seconds:.3f} s; results bit-identical")
    return report, launches


def host_split(what: str, server, seconds: float) -> None:
    """Print where a served drain's wall time went, as shares of it, from
    the server's own telemetry spans: admission (`sched.admit`), the
    launches' enqueue (`sched.launch`), the host waiting for the card
    before retiring (`sched.wait`), the rest of each step (segment hooks,
    retire, finalize, gauges: `sched.step` less those three) and the time
    outside the steps (the drain loop)."""
    tel = server.telemetry
    if tel.dropped_events:
        raise AssertionError(f"{what}: the telemetry ring dropped {tel.dropped_events} events")
    total = {"sched.step": 0.0, "sched.admit": 0.0, "sched.launch": 0.0, "sched.wait": 0.0}
    opened, steps = {}, 0
    for ev in tel.events():
        name = ev["name"]
        if name not in total or ev["tid"] != 0:
            continue
        if ev["ph"] == "B":
            opened[name] = ev["ts"]
        elif ev["ph"] == "E":
            total[name] += ev["ts"] - opened.pop(name)
            steps += name == "sched.step"
    wall = seconds * 1e6
    step, admit, launch, wait = (total[k] for k in ("sched.step", "sched.admit", "sched.launch",
                                                    "sched.wait"))
    print(f"[host split {what}] {steps} steps in {seconds:.3f} s, shares of the wall: admit "
          f"{admit / wall:.3f}, launch {launch / wall:.3f} (the enqueue), wait {wait / wall:.3f} "
          f"(the host waiting for the card before retiring), the rest of the step (hooks, "
          f"retire, finalize) {(step - admit - launch - wait) / wall:.3f}, outside the steps "
          f"{(wall - step) / wall:.3f} (telemetry on)")


def multi_job_specs(base, tenant_models) -> list:
    """The multi-tenant mix: ``MULTI_JOBS`` (seed, schedule, model) specs,
    constants and 4-step ramps of 64-256 sweeps; job i samples
    ``tenant_models[i % TENANTS]``, every fourth job the server's model
    (model None)."""
    rng = np.random.default_rng(0)
    specs = []
    for i in range(MULTI_JOBS):
        budget = int(rng.integers(64, 257))
        model = None if i % 4 == 3 else tenant_models[i % TENANTS]
        if i % 3 == 2:
            schedule = [(budget // 4, float(b)) for b in np.linspace(0.3, 1.4, 4)]
        else:
            schedule = [(budget, float(rng.uniform(0.5, 1.5)))]
        specs.append((1000 + i, schedule, model))
    return specs


def serve_multi(rung: str, base, specs, slots: int):
    """Serve ``specs`` on a multi-tenant server through the rung's kernel;
    returns (results by jid, drain seconds, stats)."""
    from repro_torch.serve_mc import AnnealJob, SampleServer

    server = SampleServer(base, slots=slots, chunk_sweeps=MAIN_CHUNK, rung=rung, backend="cuda",
                          device="cuda", multi_tenant=True)
    for seed, schedule, model in specs:
        server.submit(AnnealJob(seed, schedule, model=model))
    t0 = time.perf_counter()
    results = server.drain()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return {r.jid: r for r in results}, dt, server.stats()


def serve_multi_checked(rung: str) -> tuple:
    """Serve the multi-tenant mix on ``rung`` (counts zeroed just before,
    read just after), hold every result against the same job run alone on
    a single-model engine of its own model, then serve the mix again on a
    resident slots=1 server for comparison.  Returns (stats, seconds,
    launch counts)."""
    from repro_torch.core import engine, ising, observables
    from repro_torch.kernels import ops

    base = ising.random_layered_model(n=MAIN_N, L=MAIN_L, seed=0, beta=1.2)
    specs = multi_job_specs(base, tenants(base, TENANTS))
    kernel = MULTI_KERNEL[rung]
    ops.reset_launches()
    results, dt, served = serve_multi(rung, base, specs, MAIN_SLOTS)
    launches = dict(ops.launches)
    if launches[kernel] == 0 or launches[kernel] != served["launches"]:
        raise AssertionError(f"{rung} multi-tenant: kernel launches {launches} != server "
                             f"launches {served['launches']}")
    if sum(launches.values()) != launches[kernel]:
        raise AssertionError(f"{rung} multi-tenant: other kernels launched: {launches}")
    if sorted(results) != list(range(MULTI_JOBS)):
        raise AssertionError(f"{rung} multi-tenant: served {sorted(results)}")
    solo_engines = {}
    N = MAIN_N * MAIN_L
    for jid, (seed, schedule, model) in enumerate(specs):
        m = base if model is None else model
        eng = solo_engines.get(id(m))
        if eng is None:
            eng = solo_engines[id(m)] = engine.SweepEngine.create(
                m, rung=rung, backend="cuda", V=LANES, device="cuda")
        carry = eng.init_slot_carry(seed=seed, beta=schedule[0][1])
        for sweeps, beta in schedule:
            carry = eng.run(eng.set_slot_betas(carry, [0], [beta]), sweeps)
        spins, r = eng.spins_flat(carry)[0], results[jid]
        if r.spins.shape != (N,) or not np.array_equal(r.spins, spins):
            raise AssertionError(f"{rung} multi-tenant job {jid}: served spins != solo run")
        if not np.isfinite(r.energy) or r.energy != observables.energies(m, spins):
            raise AssertionError(f"{rung} multi-tenant job {jid}: energy is not its model's")
        if r.extras["final_beta"] != float(carry.betas[0]):
            raise AssertionError(f"{rung} multi-tenant job {jid}: final beta differs")
    seq, seq_dt, seq_stats = serve_multi(rung, base, specs, 1)
    for jid, r in seq.items():
        if not np.array_equal(r.spins, results[jid].spins):
            raise AssertionError(f"{rung} job {jid}: slots=1 result != packed result")
    sweeps_s = served["busy_slot_sweeps"] / dt
    print(f"[serve-multi {rung}] {MULTI_JOBS} jobs on {TENANTS} tenants + the base model, "
          f"n={MAIN_N} L={MAIN_L}, {MAIN_SLOTS} slots, chunk {MAIN_CHUNK}: {served['launches']} "
          f"launches == {launches[kernel]} {kernel} launches, {dt:.3f} s, {sweeps_s:.0f} "
          f"slot-sweeps/s, {served['spin_flips'] / dt / 1e6:.2f}M spin-flips/s, "
          f"{MULTI_JOBS / dt:.1f} jobs/s, utilization {served['utilization']:.3f}; every job == "
          f"its solo single-model run (bit-equal)")
    print(f"[serve-multi {rung}] the same jobs on a resident slots=1 server: "
          f"{seq_stats['launches']} launches, {seq_dt:.3f} s, "
          f"{seq_stats['busy_slot_sweeps'] / seq_dt:.0f} slot-sweeps/s, "
          f"{MULTI_JOBS / seq_dt:.1f} jobs/s; packed/slots=1 speed {seq_dt / dt:.2f}x; "
          f"results bit-identical")
    return served, dt, launches


def profile_serve(rung: str, multi: bool = False) -> None:
    """Trace one kernel-served run with torch.profiler: device time of
    every kernel against the drain's wall time (the device busy share).
    ``multi``: the multi-tenant mix instead of the CLI's."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import ising
    from repro_torch.launch import anneal_serve

    kernel = (MULTI_KERNEL if multi else SERVE_KERNEL)[rung]
    what = f"{rung} multi-tenant" if multi else rung
    if multi:
        base = ising.random_layered_model(n=MAIN_N, L=MAIN_L, seed=0, beta=1.2)
        specs = multi_job_specs(base, tenants(base, TENANTS))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if multi:
            seconds = serve_multi(rung, base, specs, MAIN_SLOTS)[1]
        else:
            seconds = anneal_serve.main(
                SERVE_ARGS + ["--rung", rung, "--device", "cuda", "--backend", "cuda"]).seconds
    # The device's own rows (kernels, copies): an aten op's row carries its
    # kernels' time too, so summing every row would count it twice.
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not rows:
        raise AssertionError("the profiler recorded no device activity")
    total_us = sum(e.self_device_time_total for e in rows)
    ours = sum(e.self_device_time_total for e in rows if f"{kernel}_kernel" in e.key)
    wall_us = seconds * 1e6
    print(f"[profile {what}] serving drain under the profiler: {seconds:.3f} s wall, device "
          f"busy {total_us / 1e3:.3f} ms ({total_us / wall_us:.3f} of wall), of which "
          f"{kernel} {ours / 1e3:.3f} ms; top device ops:")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"[profile {what}]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:5d}  {e.key[:70]}")


# -- recovery and the stream (phase 6c) ----------------------------------------


def recovery_jobs(base, multi: bool) -> list:
    """The recovery mix: `REC_JOBS` anneal jobs (constants and 4-step ramps
    of `REC_BUDGETS` sweeps, three users) and one PT ladder of `REC_PT_R`
    replicas; multi-tenant: every other anneal job and the ladder on one of
    4 tenants of ``base``."""
    from repro_torch.serve_mc import AnnealJob, PTJob

    rng = np.random.default_rng(7)
    models = tenants(base, 4) if multi else [None]
    jobs = []
    for i in range(REC_JOBS):
        budget = int(rng.integers(*REC_BUDGETS))
        kw = dict(model=models[i % len(models)] if i % 2 else None, user=f"u{i % 3}")
        if i % 4 == 3:
            jobs.append(AnnealJob.ramp(seed=500 + i, beta_start=0.4, beta_end=1.4, steps=4,
                                       sweeps_per_step=budget // 4, **kw))
        else:
            jobs.append(AnnealJob.constant(seed=500 + i, sweeps=budget,
                                           beta=float(rng.uniform(0.5, 1.5)), **kw))
    jobs.insert(2, PTJob(seed=77, betas=np.linspace(0.4, 1.4, REC_PT_R).astype(np.float32),
                         num_rounds=REC_PT_ROUNDS, sweeps_per_round=REC_PT_SWEEPS,
                         model=models[-1], user="ladder"))
    return jobs


def rec_server(rung: str, multi: bool, slots: int = REC_SLOTS, **kw):
    """(model, a `SampleServer` at the paper's width on the card unless
    ``kw`` says otherwise), chunks of `REC_CHUNK`."""
    from repro_torch.core import ising
    from repro_torch.serve_mc import SampleServer

    base = ising.random_layered_model(n=MAIN_N, L=MAIN_L, seed=3, beta=1.1)
    return base, SampleServer(base, slots=slots, chunk_sweeps=REC_CHUNK, rung=rung,
                              multi_tenant=multi, **kw)


def uninterrupted(server, jobs, pre=()) -> tuple:
    """Submit ``jobs`` and drain: (results by jid, retirement order, the
    final pool on the host)."""
    for j in jobs:
        server.submit(j)
    results = {r.jid: r for r in list(pre) + server.drain()}
    return results, list(server._retired), server.engine.extract_pool(server.carry)


def serve_until_snapshot(server) -> list:
    """Step until a periodic snapshot has landed and a job has retired, with
    work left; returns the results retired so far."""
    pre = []
    while len(server.policy) or server._active:
        pre.extend(server.step())
        server.wait_snapshots()
        if server.snapshot_manager.latest_step() is not None and pre and (
                len(server.policy) or server._active):
            return pre
    raise AssertionError("the drain ended before a snapshot landed and a job retired")


def host_bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def same_run(got: dict, server, want: tuple, what: str, done: frozenset = frozenset()) -> None:
    """Raise unless the results ``got`` (plus the jids ``done`` before a
    snapshot) cover the uninterrupted run ``want`` with every result, the
    retirement order and the final pool (rng included) equal bit for bit."""
    want_results, want_order, want_pool = want
    if set(got) | done != set(want_results):
        raise AssertionError(f"{what}: served {sorted(got)} + {sorted(done)}, want "
                             f"{sorted(want_results)}")
    for jid, r in got.items():
        w = want_results[jid]
        same = (np.array_equal(host_bits(r.spins), host_bits(w.spins))
                and np.array_equal(host_bits(r.energy), host_bits(w.energy))
                and r.sweeps_done == w.sweeps_done
                and all(np.array_equal(host_bits(r.extras[k]), host_bits(w.extras[k]))
                        for k in ("betas", "swap_accept", "swap_propose", "final_beta")
                        if k in w.extras))
        if not same:
            raise AssertionError(f"{what}: job {jid} differs from the uninterrupted run")
    if list(server._retired) != want_order:
        raise AssertionError(f"{what}: retirement order {list(server._retired)} != {want_order}")
    pool = server.engine.extract_pool(server.carry)
    for name, a, b in zip(want_pool.carry._fields, pool.carry, want_pool.carry):
        if not np.array_equal(host_bits(a), host_bits(b)):
            raise AssertionError(f"{what}: the final pool's {name} differs")


def restore_and_drain(source, kernel: str, what: str, **overrides) -> tuple:
    """`SampleServer.restore` on the card and drain, counts zeroed just
    before and read just after; the restored path must launch ``kernel``
    once a chunk, #8 once a round its ladders swap (`pt_swap_fused`, which
    a restore starts from 0), and nothing else.  Returns (server, results
    by jid, launches)."""
    from repro_torch.kernels import ops
    from repro_torch.serve_mc import SampleServer

    ops.reset_launches()
    server = SampleServer.restore(source, **overrides)
    before = server.launches
    results = {r.jid: r for r in server.drain()}
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    if server.engine.device.type != "cuda" or server.engine.backend != "cuda":
        raise AssertionError(f"{what}: restored on {server.engine.device} / {server.engine.backend}")
    if launches[kernel] == 0 or launches[kernel] != server.launches - before or sweep_launches(
            launches) != launches[kernel]:
        raise AssertionError(f"{what}: launches {launches}, server {server.launches - before}")
    fused = server.stats()["placement"]["pt_swap_fused"]
    check_swaps(what, launches, fused, fused)
    return server, results, launches


def recovery_in_process(rung: str, multi: bool, tmp: str) -> tuple:
    """Kill and restore inside one process: serve the recovery mix with
    periodic snapshots, abandon the server after the first snapshot has
    landed and a job has retired, restore on the card and drain; equal to
    the uninterrupted run.  Returns (launches of the restored drain, the
    uninterrupted run)."""
    kernel = (MULTI_KERNEL if multi else SERVE_KERNEL)[rung]
    what = f"recovery {rung}{' multi-tenant' if multi else ''}"
    base, ref = rec_server(rung, multi)
    want = uninterrupted(ref, recovery_jobs(base, multi))
    base, srv = rec_server(rung, multi, snapshot_manager=tmp, snapshot_every_sweeps=REC_EVERY)
    for j in recovery_jobs(base, multi):
        srv.submit(j)
    pre = serve_until_snapshot(srv)
    crash, step = srv.sweeps_elapsed, srv.snapshot_manager.latest_step()
    del srv  # the "kill": in-flight state is gone
    server, post, launches = restore_and_drain(tmp, kernel, what)
    got = {r.jid: r for r in pre}
    got.update(post)  # jobs retired after the snapshot ran again, bit-equal
    same_run(got, server, want, what)
    print(f"[{what}] {len(want[0])} jobs (a PT ladder of {REC_PT_R}) on {REC_SLOTS} slots, "
          f"n={MAIN_N} L={MAIN_L}, snapshots every {REC_EVERY} sweeps: abandoned at sweep "
          f"{crash} (snapshot at {step}, {len(pre)} retired), restored on the card: "
          f"{launches[kernel]} {kernel} launches, {len(post)} jobs finished; every result, "
          f"the retirement order and the final pool rng == the uninterrupted run")
    return launches, want


def kill_worker(snap_dir: str) -> int:
    """The SIGKILL child: serve the cb recovery mix on the card with periodic
    snapshots and kill this process with SIGKILL at the first boundary
    where a snapshot has landed and a job has retired (no goodbye
    snapshot).  It never prints the ok line."""
    if not torch.cuda.is_available():
        return 2
    base, server = rec_server("cb", False, snapshot_manager=snap_dir,
                              snapshot_every_sweeps=REC_EVERY)
    for j in recovery_jobs(base, False):
        server.submit(j)
    serve_until_snapshot(server)
    os.kill(os.getpid(), signal.SIGKILL)
    return 3


def recovery_sigkill(want: tuple, tmp: str) -> dict:
    """Re-execute this script as a worker (`kill_worker`), require it to die
    by SIGKILL, restore its last periodic snapshot on the card and finish:
    equal to the uninterrupted cb run ``want``."""
    snap = os.path.join(tmp, "killed")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--kill-worker", snap],
                          capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    if proc.returncode != -signal.SIGKILL or '"ok"' in proc.stdout:
        raise AssertionError(f"kill worker exited {proc.returncode}, wanted -SIGKILL:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    from repro_torch.ckpt.manager import CheckpointManager

    step = CheckpointManager(snap).latest_step()
    server, post, launches = restore_and_drain(snap, "colored_multisweep", "sigkill")
    done = frozenset(server._retired) - frozenset(post)
    same_run(post, server, want, "sigkill", done=done)
    print(f"[recovery sigkill] a worker process serving cb on the card died by SIGKILL "
          f"(returncode {proc.returncode}, {child_s:.1f} s); restored from its snapshot at sweep "
          f"{step}: {launches['colored_multisweep']} colored_multisweep launches, "
          f"{len(post)} jobs finished, {len(done)} retired before the snapshot; == the "
          f"uninterrupted run")
    return launches


def preempt_sequence(server) -> list:
    """A wide low-priority PT ladder and a filler, one chunk, then three
    priority-3 jobs that checkpoint-preempt the ladder (it parks)."""
    from repro_torch.serve_mc import AnnealJob, PTJob

    server.submit(PTJob(seed=3, betas=np.array([0.5, 0.8, 1.2], np.float32), num_rounds=6,
                        sweeps_per_round=2, user="ladder"))
    server.submit(AnnealJob.constant(seed=4, sweeps=30, beta=1.0, user="u0"))
    out = list(server.step())
    for i in range(3):
        server.submit(AnnealJob.constant(seed=20 + i, sweeps=6, beta=1.1, priority=3, user="vip"))
    out.extend(server.step())
    return out


def recovery_graceful(tmp: str) -> dict:
    """Graceful drain: SIGTERM's handler (`trigger()`) mid-drain under
    policy backfill with the ladder parked; `drain` returns with
    ``preempted`` set after a blocking snapshot, and the restore finishes
    equal to the uninterrupted run."""
    from repro_torch.runtime.ft import PreemptionHandler

    kw = dict(slots=4, policy="backfill")
    _, ref = rec_server("cb", False, **kw)
    pre_ref = preempt_sequence(ref)
    want = uninterrupted(ref, [], pre_ref)
    handler = PreemptionHandler(install=False)
    _, srv = rec_server("cb", False, snapshot_manager=tmp, preemption=handler, **kw)
    pre = preempt_sequence(srv)
    if not srv.preemptions or not any(j.parked for j in srv.policy.jobs()):
        raise AssertionError("graceful drain: the ladder was not parked")
    handler.trigger()
    pre.extend(srv.drain())
    if not srv.preempted or srv.snapshot_manager.latest_step() is None:
        raise AssertionError("graceful drain: drain() did not stop with a snapshot")
    step = srv.snapshot_manager.latest_step()
    server, post, launches = restore_and_drain(tmp, "colored_multisweep", "graceful drain")
    if server.preempted:
        raise AssertionError("graceful drain: the restored server is preempted")
    got = {r.jid: r for r in pre}
    got.update(post)
    same_run(got, server, want, "graceful drain")
    print(f"[recovery graceful] policy backfill, the ladder parked: drain() stopped at sweep "
          f"{step} with a blocking snapshot ({len(pre)} retired); restored: "
          f"{launches['colored_multisweep']} colored_multisweep launches, {len(post)} jobs "
          f"finished; == the uninterrupted run")
    return launches


def recovery_cpu_to_card(tmp: str) -> dict:
    """A plain-backend snapshot on the CPU (cb, "fast", `REC_CPU_SLOTS`
    slots, n=96 L=256, at least `REC_EVERY` sweeps in), restored with
    backend "cuda" on the card: equal to the CPU's uninterrupted run."""
    from repro_torch.serve_mc import AnnealJob

    def jobs():
        return [AnnealJob.constant(seed=900 + i, sweeps=24 + 8 * i, beta=0.6 + 0.15 * i)
                for i in range(6)]

    kw = dict(slots=REC_CPU_SLOTS, backend="torch", device="cpu")
    _, ref = rec_server("cb", False, **kw)
    t0 = time.perf_counter()
    want = uninterrupted(ref, jobs())
    cpu_s = time.perf_counter() - t0
    _, srv = rec_server("cb", False, snapshot_manager=tmp, snapshot_every_sweeps=REC_EVERY, **kw)
    for j in jobs():
        srv.submit(j)
    pre = serve_until_snapshot(srv)
    step = srv.snapshot_manager.latest_step()
    if step < REC_EVERY:
        raise AssertionError(f"CPU -> card: snapshot at sweep {step}")
    server, post, launches = restore_and_drain(tmp, "colored_multisweep", "CPU -> card",
                                                  backend="cuda")
    got = {r.jid: r for r in pre}
    got.update(post)
    same_run(got, server, want, "CPU -> card")
    print(f"[recovery cpu->card] plain backend on the CPU (cb, fast, {REC_CPU_SLOTS} slots, "
          f"n={MAIN_N} L={MAIN_L}; uninterrupted {cpu_s:.1f} s), snapshot at sweep {step}, "
          f"restored with backend cuda: {launches['colored_multisweep']} colored_multisweep "
          f"launches; every result and the final pool == the CPU's uninterrupted run")
    return launches


def recovery_cli(tmp: str) -> dict:
    """``anneal_serve --smoke`` on the card: serve -> snapshot -> abandon ->
    restore -> finish on backend cuda; its ``smoke: resumed`` line is
    required and every result whole.  #8 runs every round of its ladder
    (3) at least once, more where the restored server runs a round again,
    and every swap of the restored server (`pt_swap_fused`)."""
    from repro_torch.core import observables
    from repro_torch.kernels import ops
    from repro_torch.launch import anneal_serve

    out = io.StringIO()
    ops.reset_launches()
    with contextlib.redirect_stdout(out):
        report = anneal_serve.main(["--smoke", "--trace", os.path.join(tmp, "smoke_trace.json")])
    launches = dict(ops.launches)
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith(("serving", "smoke:", "served"))]
    if not any(ln.startswith("smoke: resumed") for ln in lines):
        raise AssertionError(f"--smoke printed no 'smoke: resumed' line:\n{out.getvalue()[-2000:]}")
    if report.server.engine.backend != "cuda" or launches["colored_multisweep"] == 0 or (
            sweep_launches(launches) != launches["colored_multisweep"]):
        raise AssertionError(f"--smoke: backend {report.server.engine.backend}, launches {launches}")
    fused = report.server.stats()["placement"]["pt_swap_fused"]
    if launches["pt_swap"] < max(3, fused):
        raise AssertionError(f"--smoke: {launches['pt_swap']} pt_swap launches for a ladder of 3 "
                             f"rounds, {fused} swapped after the restore")
    if len(report.results) != 8 or any(
            not np.array_equal(r.energy, observables.energies(report.model, r.spins))
            for r in report.results):
        raise AssertionError("--smoke: results not whole")
    for ln in lines:
        print(f"[recovery cli] {ln}")
    return launches


def stream_and_profiler(tmp: str, smi: str) -> dict:
    """The stream: the CLI's cb mix (`SERVE_ARGS`) drained with
    ``stream=ObservableStream()`` equals the drain without it bit for bit,
    and every sample's energies equal `observables.energies` of
    `spins_flat` at that boundary.  Then slot-sweeps/s with the stream off
    and on, in turns.  The profiler: a window of 4 chunks writes a trace
    that names the served kernel, with no ``profiler.error`` event."""
    from repro_torch.core import ising, observables
    from repro_torch.kernels import ops
    from repro_torch.launch import anneal_serve
    from repro_torch.obs import ObservableStream
    from repro_torch.serve_mc import SampleServer

    args = anneal_serve.parse_args(SERVE_ARGS + ["--rung", "cb"])
    model = ising.random_layered_model(n=args.n, L=args.L, seed=args.seed, beta=args.beta)
    live = []  # the server being drained, for the stream's subscriber

    def drain(stream=None, profile_dir=None):
        server = SampleServer(model, slots=args.slots, chunk_sweeps=args.chunk, rung="cb",
                              stream=stream)
        live[:] = [server]
        for j in anneal_serve.build_job_mix(args):
            server.submit(j)
        if profile_dir is not None:
            server.arm_profiler(profile_dir, num_chunks=4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = {r.jid: r for r in server.drain()}
        torch.cuda.synchronize()
        return results, time.perf_counter() - t0, server

    checked = []

    def check(sample):
        (server,) = live
        job, slots = server._active[sample.jid]
        spins = server.engine.spins_flat(server.carry)[list(slots)]
        want = np.atleast_1d(observables.energies(job.model_on(server), spins))
        if not np.array_equal(host_bits(sample.energy), host_bits(want)):
            raise AssertionError(f"stream: job {sample.jid} energies != observables at sweep "
                                 f"{sample.sweeps_elapsed}")
        checked.append(sample.jid)

    off, _, _ = drain()
    stream = ObservableStream()
    stream.subscribe(check)
    ops.reset_launches()
    on, _, server = drain(stream)
    launches = dict(ops.launches)
    if launches["colored_multisweep"] != server.launches or sum(launches.values()) != server.launches:
        raise AssertionError(f"stream: launches {launches} vs {server.launches}")
    for jid, r in off.items():
        if not (np.array_equal(host_bits(r.spins), host_bits(on[jid].spins))
                and np.array_equal(host_bits(r.energy), host_bits(on[jid].energy))):
            raise AssertionError(f"stream: job {jid} differs from the untapped drain")
    if not checked or stream.samples_taken != len(checked):
        raise AssertionError("stream: no samples checked")
    rates = {"off": [], "on": []}
    for which in ("off", "on", "on", "off"):
        _, seconds, srv = drain(ObservableStream() if which == "on" else None)
        rates[which].append(srv.busy_slot_sweeps / seconds)
    print(f"[stream] cb drain, {len(off)} jobs, n={MAIN_N} L={MAIN_L}, {MAIN_SLOTS} slots: "
          f"{stream.samples_taken} samples, each == observables.energies of spins_flat at its "
          f"boundary; results == the untapped drain bit for bit; slot-sweeps/s off "
          f"{' / '.join(f'{x:.0f}' for x in rates['off'])}, on "
          f"{' / '.join(f'{x:.0f}' for x in rates['on'])} (turns off, on, on, off); {smi}")

    logdir = os.path.join(tmp, "profile")
    _, _, srv = drain(profile_dir=logdir)
    names = [e["name"] for e in srv.telemetry.events()]
    if "profiler.error" in names or "profiler.stop" not in names:
        raise AssertionError(f"profiler: events {[n for n in names if n.startswith('profiler')]}")
    i0, i1 = names.index("profiler.start"), names.index("profiler.stop")
    window = sum(1 for n in names[i0:i1] if n == "engine.launch")
    trace = open(os.path.join(logdir, "trace.json")).read()
    kernels = {e.get("name", "") for e in json.loads(trace)["traceEvents"]
               if e.get("cat") == "kernel"}
    if window != 4 or not any("colored_multisweep_kernel" in k for k in kernels):
        raise AssertionError(f"profiler: {window} launches in the window, kernels {sorted(kernels)[:8]}")
    print(f"[profiler] arm_profiler(num_chunks=4) on the cb drain: {window} launches in the "
          f"window, trace {len(trace):,} B names {sorted(k for k in kernels if 'colored' in k)[0][:60]}; "
          f"no profiler.error")
    return launches


def time_snapshots(tmp: str, smi: str) -> None:
    """The snapshot's costs at `REC_SLOTS` and 128 slots (cb, n=96 L=256):
    the synchronous part of a periodic snapshot (the pool's copy to the
    host and the manifest build), the background write (npy shards,
    sha256, fsync, rename), `SampleServer.restore` (read, verify, build
    the server, the pool to the card), in ms (host clock, 3 each), and the
    pool's bytes."""
    from repro_torch.serve_mc import SampleServer, snapshot_state

    for slots in (REC_SLOTS, 128):
        d = os.path.join(tmp, f"timed-{slots}")
        base, srv = rec_server("cb", False, slots=slots, snapshot_manager=d)
        for j in recovery_jobs(base, False):
            srv.submit(j)
        for _ in range(3):
            srv.step()
        torch.cuda.synchronize()
        arrays, _ = snapshot_state(srv)
        pool_bytes = sum(arrays[f"carry/{f}"].nbytes for f in srv.carry._fields)
        total = sum(a.nbytes for a in arrays.values())
        sync, write, restore = [], [], []
        for _ in range(3):
            t0 = time.perf_counter()
            srv.snapshot(blocking=False)
            t1 = time.perf_counter()
            srv.wait_snapshots()
            t2 = time.perf_counter()
            SampleServer.restore(d, snapshot_every_sweeps=0)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            sync.append((t1 - t0) * 1e3)
            write.append((t2 - t1) * 1e3)
            restore.append((t3 - t2) * 1e3)
            srv.step()
        print(f"[time snapshot] cb, {slots} slots, n={MAIN_N} L={MAIN_L}: pool {pool_bytes:,} B "
              f"({pool_bytes / slots:,.0f} B a slot), snapshot {total:,} B; save sync part "
              f"{' / '.join(f'{x:.2f}' for x in sync)} ms, background write "
              f"{' / '.join(f'{x:.2f}' for x in write)} ms, restore "
              f"{' / '.join(f'{x:.2f}' for x in restore)} ms; {smi}")


def recovery_and_stream(smi: str) -> dict:
    """Phase 6c.  Returns {"recovery": {kernel: launches of the restored
    drains (`restore_and_drain`) alone}, "smoke": {kernel: launches of the
    whole CLI ``--smoke`` run}, "stream": {kernel: launches of the streamed
    drain}}."""
    restored = dict.fromkeys(KERNELS, 0)

    def add(launches):
        for k, v in launches.items():
            restored[k] += v

    with tempfile.TemporaryDirectory(prefix="chip_smoke_recovery_") as tmp:
        want_cb = None
        for rung in ("cb", "a4"):
            for multi in (False, True):
                d = os.path.join(tmp, f"{rung}-{int(multi)}")
                launches, want = recovery_in_process(rung, multi, d)
                add(launches)
                if (rung, multi) == ("cb", False):
                    want_cb = want
        add(recovery_sigkill(want_cb, tmp))
        add(recovery_graceful(os.path.join(tmp, "graceful")))
        add(recovery_cpu_to_card(os.path.join(tmp, "cpu")))
        smoke = recovery_cli(tmp)
        stream = stream_and_profiler(tmp, smi)
        time_snapshots(tmp, smi)
    return {"recovery": restored, "smoke": smoke, "stream": stream}


def same_bits(got: torch.Tensor, want: torch.Tensor, what: str, any_nan: bool = False) -> float:
    """Raise unless two float32 tensors are equal bit for bit (signed
    zeros included; NaN payloads too, unless ``any_nan``: a NaN made by
    the card's float multiply carries no payload, one made on the CPU keeps
    its input's, and IEEE 754 leaves that choice open).  Returns the max
    |difference| over the elements where both are finite (0.0 when equal)."""
    if any_nan:
        got, want = (torch.where(t.isnan(), torch.full_like(t, float("nan")), t) for t in (got, want))
    a, b = got.contiguous().view(torch.int32), want.contiguous().view(torch.int32)
    if a.shape != b.shape or not torch.equal(a, b.to(a.device)):
        bad = (a != b.to(a.device)).nonzero()
        first = tuple(bad[0].tolist()) if bad.numel() else ()
        raise AssertionError(f"{what}: {bad.shape[0]} of {a.numel()} results differ, first "
                             f"{list(first)}: {got[first].item()} vs {want[first].item()}")
    both = torch.isfinite(got) & torch.isfinite(want.to(got.device))
    d = (got.double() - want.to(got.device).double()).abs()[both]
    return float(d.max()) if d.numel() else 0.0


def fastexp_cases() -> list:
    """(name, float32/16/bf16 CPU tensor) inputs of the exp kernel's check."""
    rng = np.random.default_rng(0)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40, 1e-45, -1e-45,
                        1.1e-38, -1.1e-38, 1e10, -1e10], np.float32)
    cases = [
        ("2^20 uniforms in [-200, 200]", torch.from_numpy(rng.uniform(-200, 200, 2**20).astype(np.float32))),
        ("grid [-180, -80], 200,001 points", torch.from_numpy(np.linspace(-180, -80, 200_001).astype(np.float32))),
        ("+-0, +-inf, NaN, subnormals, +-1e10", torch.from_numpy(special)),
    ]
    for shape in ((7,), (1000,), (3, 5, 11)):
        cases.append((f"shape {shape}", torch.from_numpy(rng.uniform(-30, 30, shape).astype(np.float32))))
    for dtype in (torch.float16, torch.bfloat16):
        x = torch.from_numpy(np.linspace(-20, 20, 4099).astype(np.float32)).to(dtype)
        cases.append((f"{str(dtype).split('.')[-1]} input, 4099 elements", x))
    return cases


def check_fastexp(dev) -> float:
    """#7 against its plain version on the card, and the plain version on
    the card against the CPU's, both flavours, bit for bit."""
    from repro_torch.kernels import ops, ref

    err = 0.0
    for what, x in fastexp_cases():
        for flavor in ("fast", "accurate"):
            got = ops.fastexp(x.to(dev), flavor)
            want = ref.fastexp_ref(x.to(dev), flavor)
            if got.dtype != torch.float32 or got.shape != x.shape:
                raise AssertionError(f"fastexp {what}: {got.dtype} {tuple(got.shape)}")
            err = max(err, same_bits(got, want, f"fastexp {flavor} {what}: kernel vs plain"))
            same_bits(want.cpu(), ref.fastexp_ref(x, flavor), f"fastexp {flavor} {what}: plain "
                      "card vs CPU", any_nan=True)
        print(f"[check fastexp] {what}: fast and accurate: kernel == plain (bit-equal), plain on "
              f"card == plain on CPU (bit-equal, NaN payloads aside)")
    return err


def check_fastexp_exhaustive(dev, chunk: int = 2**28) -> None:
    """#7 in both flavours against its plain version on the card over all
    2^32 float32 bit patterns, ``chunk`` at a time, bit for bit with NaNs
    unified (a NaN in both is equal whatever its payload)."""
    from repro_torch.kernels import ops, ref

    nan_bits = torch.tensor(0x7FC00000, dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    nans = dict.fromkeys(("fast", "accurate"), 0)
    for lo in range(-(2**31), 2**31, chunk):
        x = torch.arange(lo, lo + chunk, dtype=torch.int32, device=dev).view(torch.float32)
        for flavor in nans:
            got, want = ops.fastexp(x, flavor), ref.fastexp_ref(x, flavor)
            g, w = (torch.where(t.isnan(), nan_bits, t.view(torch.int32)) for t in (got, want))
            if not torch.equal(g, w):
                bad = (g != w).nonzero()
                i = int(bad[0])
                raise AssertionError(
                    f"fastexp {flavor}: {bad.shape[0]} of the {chunk} bit patterns from {lo:#x} "
                    f"differ, first x bits {lo + i:#010x}: {got[i].item()} vs {want[i].item()}")
            nans[flavor] += int(got.isnan().sum())
        del x, got, want, g, w
    torch.cuda.synchronize()
    print(f"[check fastexp] all 2^32 float32 bit patterns, chunks of {chunk:,}: fast and accurate: "
          f"kernel == plain (bit-equal, NaNs unified; NaN results: fast {nans['fast']:,}, "
          f"accurate {nans['accurate']:,}) in {time.perf_counter() - t0:.1f} s")


def rel_err_stats(got: torch.Tensor, x: torch.Tensor) -> tuple[float, float, float]:
    """min, max and mean of got / exp(x) - 1 (float64 exp of the float32 x)."""
    r = got.double() / torch.exp(x.double()) - 1.0
    return float(r.min()), float(r.max()), float(r.mean())


def fastexp_path(dev) -> tuple[dict, float]:
    """The exp's main path: `ops.fastexp` on one sweep's exps at the
    paper's shape, each flavour once, launch counts zeroed just before and
    read just after.  Each result must equal the plain version's on the
    same inputs bit for bit and lie in the paper's envelope.  Returns the
    launch counts and the max |kernel - plain|."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cpu").manual_seed(0)
    x = (torch.rand(FASTEXP_MAIN, generator=gen) * (ACCURATE_HI - ACCURATE_LO - 0.02)
         + ACCURATE_LO + 0.01).to(dev)
    ops.reset_launches()
    out = {flavor: ops.fastexp(x, flavor) for flavor in ("fast", "accurate")}
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    if launches["fastexp_2d"] != 2 or sum(launches.values()) != 2:
        raise AssertionError(f"the exp path launched {launches}, want 2 fastexp_2d launches")
    err = 0.0
    for flavor, y in out.items():
        err = max(err, same_bits(y, ref.fastexp_ref(x, flavor),
                                 f"fastexp {flavor} main path: kernel vs plain"))
        lo, hi, mean = rel_err_stats(y, x)
        if y.shape != x.shape or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"fastexp {flavor}: not finite or shape {tuple(y.shape)}")
        if not ENVELOPE[flavor][0] <= lo <= hi <= ENVELOPE[flavor][1]:
            raise AssertionError(f"fastexp {flavor}: relative error [{lo}, {hi}] outside "
                                 f"{ENVELOPE[flavor]}")
        print(f"[fastexp path] {FASTEXP_MAIN:,} elements, {flavor}: 1 fastexp_2d launch, == the "
              f"plain version (bit-equal), finite, relative error [{lo:.5f}, {hi:.5f}] inside "
              f"the paper's {ENVELOPE[flavor]}")
    return launches, err


def time_fastexp(dev) -> dict:
    """Each flavour of #7, its plain version and `torch.exp` with a cold
    L2, at `FASTEXP_SIZES`, by both flushes of `cuda_ms_cold` (L2 left
    dirty, and clean); then the Figure-17 error of the card's outputs.
    Returns {(flavor, n): (kernel ms, plain ms, torch.exp ms, bound, kernel
    ms with L2 left dirty, torch.exp ms with L2 left dirty)}."""
    from repro_torch.kernels import ops, ref

    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)  # 128 MB > L2
    clean = torch.ones(32 * 2**20, dtype=torch.float32, device=dev)
    gen = torch.Generator(device="cpu").manual_seed(1)
    out = {}
    for n in FASTEXP_SIZES:
        x = (torch.rand(n, generator=gen) * 40.0 - 20.0).to(dev)
        t_exp = cuda_ms_cold(lambda: torch.exp(x), 20, flush, clean)
        t_exp_dirty = cuda_ms_cold(lambda: torch.exp(x), 20, flush)
        for flavor in ("fast", "accurate"):
            t_k = cuda_ms_cold(lambda: ops.fastexp(x, flavor), 20, flush, clean)
            t_k_dirty = cuda_ms_cold(lambda: ops.fastexp(x, flavor), 20, flush)
            t_p = cuda_ms_cold(lambda: ref.fastexp_ref(x, flavor), 5, flush, clean)
            t_p_dirty = cuda_ms_cold(lambda: ref.fastexp_ref(x, flavor), 5, flush)
            b = bound(fastexp_counts(n, flavor))
            out[flavor, n] = (t_k, t_p, t_exp, b, t_k_dirty, t_exp_dirty)
            gbs = 8 * n / (t_k * 1e-3) / 1e9
            verdict = ("at half its bound or above" if b[0] / t_k >= 0.5 else "under half its bound")
            print(f"[time fastexp] n={n:,} {flavor}, clean cold L2: kernel {t_k:.4f} ms ({gbs:.0f} "
                  f"GB/s, {b[0] / t_k:.3f} of the bound: {verdict}; "
                  f"{'no slower' if t_k <= t_exp else 'slower'} than torch.exp), plain "
                  f"{t_p:.4f} ms, torch.exp (the paper's exact-exp baseline) {t_exp:.4f} ms "
                  f"({8 * n / (t_exp * 1e-3) / 1e9:.0f} GB/s); bound {b[0]:.5f} ms ({b[1]}, "
                  f"8 B an element at {HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
            print(f"[time fastexp] n={n:,} {flavor}, L2 left dirty by the flush: kernel "
                  f"{t_k_dirty:.4f} ms, plain {t_p_dirty:.4f} ms, torch.exp {t_exp_dirty:.4f} ms")
    grid = torch.linspace(ACCURATE_LO + 0.01, ACCURATE_HI - 0.01, 400_001, dtype=torch.float64)
    grid = grid.float().to(dev)
    for flavor in ("fast", "accurate"):
        lo, hi, mean = rel_err_stats(ops.fastexp(grid, flavor), grid)
        print(f"[fig17 fastexp] {flavor}: relative error on the 400,001-point grid, from the "
              f"card's outputs: min {lo:.6f}, max {hi:.6f}, mean {mean:.3e}")
    return out


def ladder(dev) -> None:
    """One engine sweep of each of the paper's slower rungs on the card,
    plain version ("torch" backend): a3 == the a4 engine through kernel
    #3, a1 == a2 under "fast", a2 on the card == a2 on the CPU."""
    from repro_torch.core import engine, ising

    fields = engine.SweepCarry._fields

    def one_sweep(m, rung, device, backend="torch", **kw):
        eng = engine.SweepEngine.create(m, rung=rung, backend=backend, batch=1, V=LANES,
                                        device=device, **kw)
        carry = eng.init_carry(seed=2)
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry = eng.run(carry, 1)
        if device != "cpu":
            torch.cuda.synchronize()
        return carry, time.perf_counter() - t0

    m = ising.random_layered_model(n=MAIN_N, L=MAIN_L, seed=0, beta=1.1)
    c3, t3 = one_sweep(m, "a3", dev)
    c4, _ = one_sweep(m, "a4", dev, backend="cuda")
    assert_same(c3, c4, "a3 (plain) vs a4 (kernel #3)", names=fields)
    print(f"[ladder] a3 n={MAIN_N} L={MAIN_L} V={LANES} B=1, one sweep: == the a4 engine through "
          f"kernel #3 (bit-equal); eager plain version {t3:.2f} s")
    # a1 is the slowest eager loop: size L so that one sweep stays under
    # LADDER_SWEEP_S, from a probe at 8 layers.
    _, t_probe = one_sweep(ising.random_layered_model(n=MAIN_N, L=8, seed=0, beta=1.1), "a1",
                           dev, exp_flavor="fast")
    L = MAIN_L
    while L > 8 and t_probe * L / 8 > LADDER_SWEEP_S:
        L //= 2
    if L < MAIN_L:
        print(f"[ladder] cut: a1/a2 at L={L}, not {MAIN_L} (an 8-layer a1 sweep took "
              f"{t_probe:.2f} s, so {MAIN_L} layers would take ~{t_probe * MAIN_L / 8:.0f} s)")
    mf = ising.random_layered_model(n=MAIN_N, L=L, seed=0, beta=1.1)
    c1, t1 = one_sweep(mf, "a1", dev, exp_flavor="fast")
    c2, t2 = one_sweep(mf, "a2", dev)
    assert_same(c1, c2, "a1 vs a2 under fast", names=fields)
    c2c, t2c = one_sweep(mf, "a2", "cpu")
    assert_same([t.cpu() for t in c2], c2c, "a2 card vs CPU", names=fields)
    flips = int((c2.spins.cpu() != engine.SweepEngine.create(
        mf, rung="a2", backend="torch", device="cpu").init_carry(seed=2).spins).sum())
    print(f"[ladder] a1, a2 n={MAIN_N} L={L} B=1, one sweep, fast exp: a1 == a2 (bit-equal), "
          f"a2 on card == a2 on CPU ({flips} flips); eager plain version a1 {t1:.2f} s, "
          f"a2 {t2:.2f} s on the card, a2 {t2c:.2f} s on the CPU")


# -- the slot mesh (phase 6d) and the examples (phase 6e) -----------------------


def logical_mesh(dev, count: int = MESH_D):
    """``count`` logical devices on the one card (one block and one stream
    each), or on the host for a CPU trial of this phase."""
    from repro_torch.launch.mesh import SlotMesh

    return SlotMesh((str(dev),) * count)


def mesh_engines(dev, n: int = MAIN_N, L: int = MAIN_L, **kw) -> None:
    """#1-#4 through `SweepEngine` at B=8: on four logical devices (equal
    split) and on `MESH_CAPS`, each equal to one device bit for bit (the
    whole pool in logical layout, generator state and tables included),
    through two 8-sweep launches with a park on one device and a resume on
    another and betas rewritten on two devices between them.  Launches of
    the mesh engines: one a device with slots, a run."""
    from repro_torch.core import engine as E
    from repro_torch.core import ising
    from repro_torch.kernels import ops

    base = ising.random_layered_model(n=n, L=L, seed=21, beta=1.1)
    models = tenants(base, MAIN_SLOTS)
    kw = {"device": dev, **kw}
    for rung in ("cb", "a4"):
        for multi in (False, True):
            kernel = (MULTI_KERNEL if multi else SERVE_KERNEL)[rung]

            def make(**mesh_kw):
                if multi:
                    return E.SweepEngine.create(models, rung=rung, **kw, **mesh_kw)
                return E.SweepEngine.create(base, rung=rung, batch=MAIN_SLOTS, **kw, **mesh_kw)

            def drive(eng):
                c = eng.run(eng.init_carry(seed=4), MAIN_CHUNK)
                c = eng.slot(1).resume(c, eng.slot(6).park(c))
                c = eng.set_slot_betas(c, [2, 7], [0.75, 1.25])
                return eng.extract_pool(eng.run(c, MAIN_CHUNK))

            want = drive(make())
            for caps in (None, MESH_CAPS):
                four = make(mesh=logical_mesh(dev), capacities=caps)
                ops.reset_launches()
                got = drive(four)
                launches = ops.launches[kernel]
                for name, a, b in zip(got.carry._fields, got.carry, want.carry):
                    if not np.array_equal(host_bits(a), host_bits(b)):
                        raise AssertionError(f"mesh {rung} multi={multi} caps={caps}: {name}")
                for k in (want.tables or {}):
                    if not np.array_equal(host_bits(got.tables[k]), host_bits(want.tables[k])):
                        raise AssertionError(f"mesh {rung} multi={multi} caps={caps}: table {k}")
                used = sum(1 for c in four.capacities if c)
                if dev.type == "cuda" and launches != 2 * used:
                    raise AssertionError(f"mesh {kernel} caps={caps}: {launches} launches, "
                                         f"want {2 * used}")
                print(f"[mesh engine] {kernel} B={MAIN_SLOTS} n={n} L={L} on "
                      f"{len(four.mesh)} logical devices, capacities {four.capacities}: "
                      f"{launches} launches (per device {four.device_launches}); pool, generator "
                      f"state{' and tables' if multi else ''} == one device, bit for bit")


def mesh_jobs(base, multi: bool):
    """(the first 8 anneal jobs, the ladder and 4 more anneal jobs).  Under
    affine placement on `MESH_CAPS` the first 8 land on slots 6, 7, 4, 5,
    0, 1, 2, 3 (best fit: the small devices first); the short ones (jobs
    2-6) retire after two chunks and free slots 4, 5, 0, 1, 2, so the
    ladder of 4 fits the pool but no device: the rebalancer migrates slot
    3 off device 0.  Under flat placement jobs land on slots 0-7 in order,
    and the ladder takes the lowest free slots 2, 3, 4, 5: it spans devices
    0 and 1."""
    from repro_torch.serve_mc import AnnealJob, PTJob

    models = tenants(base, 4) if multi else [None] * 4
    first = [AnnealJob.constant(seed=600 + i, sweeps=MESH_SHORT if 2 <= i <= 6 else MESH_LONG,
                                beta=0.6 + 0.1 * i, model=models[i % 4] if i % 2 else None)
             for i in range(8)]
    ladder = PTJob(seed=88, betas=np.linspace(0.4, 1.4, MESH_PT_R).astype(np.float32),
                   num_rounds=MESH_PT_ROUNDS, sweeps_per_round=MAIN_CHUNK, model=models[3])
    more = [AnnealJob.constant(seed=700 + i, sweeps=2 * MESH_SHORT, beta=1.0,
                               model=models[i] if i % 2 else None) for i in range(4)]
    return first, [ladder] + more


def mesh_server(dev, rung: str, multi: bool, mesh=None, caps=None, placement="affine",
                n: int = MAIN_N, L: int = MAIN_L, **kw):
    from repro_torch.core import ising
    from repro_torch.serve_mc import SampleServer

    base = ising.random_layered_model(n=n, L=L, seed=22, beta=1.1)
    return base, SampleServer(base, slots=MAIN_SLOTS, chunk_sweeps=MAIN_CHUNK, rung=rung,
                              multi_tenant=multi, policy="fifo", mesh=mesh, capacities=caps,
                              placement=placement, device=dev, **kw)


def mesh_drain(base, server, steps_before: int = 2, stop_after: int | None = None) -> tuple:
    """Serve `mesh_jobs`: the first 8, ``steps_before`` chunks, then the
    rest; drain (or stop after ``stop_after`` more steps).  Returns
    (results by jid, seconds)."""
    first, rest = mesh_jobs(base, server.multi_tenant)
    t0 = time.perf_counter()
    for j in first:
        server.submit(j)
    results = []
    for _ in range(steps_before):
        results += server.step()
    for j in rest:
        server.submit(j)
    if stop_after is None:
        results += server.drain()
    else:
        for _ in range(stop_after):
            results += server.step()
    if server.engine.device.type == "cuda":
        torch.cuda.synchronize()
    return {r.jid: r for r in results}, time.perf_counter() - t0


def same_results(got: dict, want: dict, what: str) -> None:
    if set(got) != set(want):
        raise AssertionError(f"{what}: jobs {sorted(got)} != {sorted(want)}")
    for jid, r in got.items():
        w = want[jid]
        if not (np.array_equal(host_bits(r.spins), host_bits(w.spins))
                and np.array_equal(host_bits(r.energy), host_bits(w.energy))
                and r.sweeps_done == w.sweeps_done
                and all(np.array_equal(host_bits(r.extras[k]), host_bits(w.extras[k]))
                        for k in ("betas", "swap_accept", "swap_propose", "final_beta")
                        if k in w.extras)):
            raise AssertionError(f"{what}: job {jid} differs from one device's")


def mesh_served(dev, smi: str, **kw) -> dict:
    """The served mesh path on each rung, single-model and multi-tenant: the
    same drain on one device, on four logical devices under `MESH_CAPS`
    affine (the rebalancer migrates; the ladder swaps on one device) and
    flat (the ladder spans devices and swaps from gathered energies), with
    telemetry on (the skew monitor fed for every launch).  Every result and
    the retirement order equal one device's; a round the ladder swaps on
    one device is one launch of #8 (`pt_swap_local` == `pt_swap_fused`),
    a round it spans devices none.  Returns the mesh drains' launches
    (counts zeroed just before each, read just after)."""
    from repro_torch.kernels import ops

    launches = dict.fromkeys(KERNELS, 0)
    for rung in ("cb", "a4"):
        for multi in (False, True):
            what = f"mesh {rung}{' multi-tenant' if multi else ''}"
            base, one = mesh_server(dev, rung, multi, **kw)
            want, t_one = mesh_drain(base, one)
            rate = {}
            for placement in ("affine", "flat"):
                base, srv = mesh_server(dev, rung, multi, logical_mesh(dev), MESH_CAPS,
                                        placement, **kw)
                ops.reset_launches()
                got, secs = mesh_drain(base, srv)
                for k, v in ops.launches.items():
                    launches[k] += v
                same_results(got, want, f"{what} {placement}")
                if list(srv._retired) != list(one._retired):
                    raise AssertionError(f"{what} {placement}: retirement order differs")
                st = srv.stats()["placement"]
                if placement == "affine" and not (st["rebalance_migrations"] >= 1
                                                  and st["pt_swap_local"] > 0):
                    raise AssertionError(f"{what} affine: no migration / local swap: {st}")
                if placement == "flat" and not (st["spanning"] >= 1 and st["pt_swap_cross"] > 0):
                    raise AssertionError(f"{what} flat: the ladder never spanned: {st}")
                check_swaps(f"{what} {placement}", ops.launches, st["pt_swap_local"],
                            st["pt_swap_fused"])
                if srv._skew.launches != srv.launches:
                    raise AssertionError(f"{what}: skew monitor fed {srv._skew.launches} of "
                                         f"{srv.launches} launches")
                rate[placement] = srv.stats()["busy_slot_sweeps"] / secs
                print(f"[{what} {placement}] {len(got)} jobs on {MAIN_SLOTS} slots over "
                      f"{MESH_D} logical devices {MESH_CAPS}: {srv.launches} steps, launches per "
                      f"device {srv.engine.device_launches}, per kernel "
                      f"{ {k: v for k, v in ops.launches.items() if v} }; migrations "
                      f"{st['rebalance_migrations']}, affine/spanning {st['affine']}/"
                      f"{st['spanning']}, PT swaps local/cross {st['pt_swap_local']}/"
                      f"{st['pt_swap_cross']} (pt_swap launches {st['pt_swap_fused']}), "
                      f"straggler events "
                      f"{srv.stats()['telemetry']['straggler_events']}; results and retirement "
                      f"order == one device")
            rate_one = one.stats()["busy_slot_sweeps"] / t_one
            print(f"[{what} rate] one device {rate_one:.0f} slot-sweeps/s, four logical devices "
                  f"affine {rate['affine']:.0f} / flat {rate['flat']:.0f} slot-sweeps/s (a layout "
                  f"check on one card, not a scaling figure); {smi}")
    return launches


def mesh_snapshots(dev, tmp: str, **kw) -> None:
    """A snapshot of the cb drain on four logical devices (equal split),
    taken after the ladder is admitted, restored on one device and on
    `MESH_CAPS`; each finishes equal to the uninterrupted run."""
    from repro_torch.serve_mc import SampleServer

    base, ref = mesh_server(dev, "cb", False, logical_mesh(dev), **kw)
    want, _ = mesh_drain(base, ref)
    base, srv = mesh_server(dev, "cb", False, logical_mesh(dev), **kw)
    pre, _ = mesh_drain(base, srv, stop_after=1)
    srv.snapshot(tmp)
    for mesh, caps in ((None, None), (logical_mesh(dev), MESH_CAPS)):
        back = SampleServer.restore(tmp, mesh=mesh, capacities=caps, device=dev,
                                    backend=kw.get("backend", "cuda"))
        got = dict(pre)
        got.update({r.jid: r for r in back.drain()})
        same_results(got, want, f"mesh snapshot onto {caps or 'one device'}")
        print(f"[mesh snapshot] D={MESH_D} snapshot at sweep {srv.sweeps_elapsed} restored on "
              f"{back.devices} device(s) {caps or ''}: {len(got)} jobs == the uninterrupted run")


def mesh_cli(cb_report) -> None:
    """``--devices 1`` through the CLI (the mesh path on one card) equals the
    CLI's serve without a mesh; ``--devices 2`` on one card is refused with
    the reference's count message."""
    from repro_torch.launch import anneal_serve

    report = anneal_serve.main(SERVE_ARGS + ["--rung", "cb", "--device", "cuda",
                                             "--devices", "1"])
    if report.server.engine.mesh is None:
        raise AssertionError("--devices 1 served without a mesh")
    same_results({r.jid: r for r in report.results}, {r.jid: r for r in cb_report.results},
                 "--devices 1")
    n = torch.cuda.device_count()
    try:
        anneal_serve.main(SERVE_ARGS + ["--rung", "cb", "--devices", str(n + 1)])
    except ValueError as e:
        if f"{n + 1} devices requested, {n} visible" not in str(e):
            raise
    else:
        raise AssertionError(f"--devices {n + 1} was not refused on {n} card(s)")
    print(f"[mesh cli] --devices 1: 12 jobs == the CLI without a mesh; --devices {n + 1} "
          f"refused on {n} card(s)")


def mesh_phase(dev, smi: str, cb_report) -> dict:
    """Phase 6d.  Returns the served mesh drains' launches per kernel."""
    mesh_engines(dev)
    launches = mesh_served(dev, smi)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        mesh_snapshots(dev, tmp)
    mesh_cli(cb_report)
    return launches


def examples_phase() -> dict:
    """Phase 6e: the four examples on the card (``--device cuda``), their
    output kept short.  The quickstart holds kernel #5 bit-equal to its
    plain version on the card; the others assert their own results.  #8
    swaps each round of their ladders once (`EXAMPLE_PT_ROUNDS`).  Returns
    the launches per kernel (counts zeroed just before, read just after)."""
    from repro_torch.examples import annealing_service, parallel_tempering, quantum_annealing
    from repro_torch.examples import quickstart
    from repro_torch.kernels import ops

    ops.reset_launches()
    for name, mod in (("quickstart", quickstart), ("parallel_tempering", parallel_tempering),
                      ("annealing_service", annealing_service),
                      ("quantum_annealing", quantum_annealing)):
        t0 = time.perf_counter()
        swaps = ops.launches["pt_swap"]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            mod.main(["--device", "cuda"])
        torch.cuda.synchronize()
        check_swaps(f"example {name}", {"pt_swap": ops.launches["pt_swap"] - swaps},
                    EXAMPLE_PT_ROUNDS.get(name, 0))
        lines = out.getvalue().strip().splitlines()
        print(f"[example {name}] {time.perf_counter() - t0:.1f} s; {lines[-1].strip()}")
    launches = dict(ops.launches)
    if launches["metropolis_sweep"] != 1:
        raise AssertionError(f"quickstart launched #5 {launches['metropolis_sweep']} times")
    print(f"[examples] launches {({k: v for k, v in launches.items() if v})}")
    return launches


# -- the LM server (phase 10) ----------------------------------------------------

#: The served arch at full width, and the CLI's defaults (launch/serve.py):
#: requests, slots, prompt tokens, new tokens, max_len.
LM_ARCH = "gemma-2b"
LM_REQUESTS, LM_SLOTS, LM_PROMPT, LM_MAX_NEW, LM_MAX_LEN = 8, 4, 8, 16, 128
#: The other dense configs, at full width and this many layers (depth cut
#: to fit the phase's time), and their decode steps after an 8-token prefill.
LM_OTHER = ("qwen2.5-14b", "deepseek-coder-33b", "command-r-35b", "internvl2-26b")
LM_OTHER_LAYERS, LM_DECODE_STEPS = 2, 8
#: Bounds on the scaled error max|a - b| / max|a|: the card's float32
#: prefill against the CPU's (ROADMAP §3w, tests/test_torch_lm_trap.py
#: F32_LOGITS), and decode against teacher forcing (the reference's bound,
#: tests/test_archs.py:90).
LM_F32_LOGITS = 2.0**-13
LM_TEACHER_FORCING = 0.06


def scaled_error(want: torch.Tensor, got: torch.Tensor) -> float:
    want, got = want.double().cpu(), got.double().cpu()
    return float((want - got).abs().max() / want.abs().max().clamp(min=1e-30))


@contextlib.contextmanager
def float32_products():
    """Float32 products in float32, not TF32, while the gates run: the WKV
    chunk scales k by exp(-cs), up to e^64, and amplifies any reduced-
    precision product (ROADMAP §3y)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def lm_tokens(cfg, batch: int, length: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, length)).astype(np.int32))


def lm_model(cfg, dev, seed: int = 0):
    """The port's init of ``cfg`` from a seeded generator on the card."""
    from repro_torch.models import decoder

    return decoder.init_params(torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)


def lm_teacher_forcing(cfg, model, batch: int, what: str) -> float:
    """A prefill of 8 tokens and `LM_DECODE_STEPS` decode steps against one
    forward pass of all 16; returns the largest scaled error."""
    from repro_torch.models import decoder

    dev = next(model.parameters()).device
    toks = lm_tokens(cfg, batch, 8 + LM_DECODE_STEPS, seed=1).to(dev)
    with torch.inference_mode():
        lg_tf, _ = decoder.apply(model, toks, cfg)
        lg, caches, n = decoder.prefill(model, toks[:, :8], cfg, max_len=8 + LM_DECODE_STEPS)
        errs = [scaled_error(lg_tf[:, :8], lg)]
        for t in range(n, 8 + LM_DECODE_STEPS):
            lg, caches = decoder.decode_step(model, toks[:, t:t + 1], caches, t, cfg)
            errs.append(scaled_error(lg_tf[:, t], lg[:, 0]))
    if not all(np.isfinite(errs)) or max(errs) >= LM_TEACHER_FORCING:
        raise AssertionError(f"{what}: prefill/decode vs teacher forcing {errs}")
    return max(errs)


def lm_float32_checks(dev) -> tuple[float, float]:
    """gemma-2b at full width in float32: prefill and decode against
    teacher forcing on the card (bound 0.06), then one prefill on the card
    against the same weights' prefill on the CPU (bound `LM_F32_LOGITS`).
    Returns the two scaled errors."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import decoder

    cfg = dataclasses.replace(get_config(LM_ARCH), dtype="float32")
    model = lm_model(cfg, dev)
    toks = lm_tokens(cfg, 1, LM_PROMPT, seed=2)
    with float32_products():
        tf_err = lm_teacher_forcing(cfg, model, LM_SLOTS, f"{LM_ARCH} float32")
        with torch.inference_mode():
            card = decoder.prefill(model, toks.to(dev), cfg, max_len=LM_PROMPT)[0].cpu()
        model.to("cpu")
        with torch.inference_mode():
            cpu = decoder.prefill(model, toks, cfg, max_len=LM_PROMPT)[0]
    del model
    torch.cuda.empty_cache()
    err = scaled_error(cpu, card)
    if not torch.isfinite(card).all() or err > LM_F32_LOGITS:
        raise AssertionError(f"float32 prefill, card vs CPU: scaled error {err} > {LM_F32_LOGITS}")
    return tf_err, err


def lm_bf16_drift(cfg, model, dev) -> tuple[float, float]:
    """The served bfloat16 model's teacher forcing and decode against
    the float32 teacher forcing of the same weights (ROADMAP §3w: at 18
    layers bfloat16 itself drifts past 0.06, the reference's too); printed,
    not a check.  Returns (bf16 forward vs float32, bf16 decode vs float32)."""
    import dataclasses

    from repro_torch.models import decoder

    steps = 8 + LM_DECODE_STEPS
    toks = lm_tokens(cfg, LM_SLOTS, steps, seed=1).to(dev)
    with torch.inference_mode():
        tf_bf16, _ = decoder.apply(model, toks, cfg)
        lg, caches, n = decoder.prefill(model, toks[:, :8], cfg, max_len=steps)
        dec = [decoder.decode_step(model, toks[:, t:t + 1], caches, t, cfg)[0][:, 0]
               for t in range(n, steps)]
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    m32 = lm_model(cfg32, dev)
    with torch.inference_mode():
        tf32 = decoder.apply(m32, toks, cfg32)[0][:, n:]
    del m32
    torch.cuda.empty_cache()
    return scaled_error(tf32, tf_bf16[:, n:]), scaled_error(tf32, torch.stack(dec, 1))


def profile_lm(cfg, model, caches, cur_len: int, batch: int, steps: int = 8) -> None:
    """Trace ``steps`` decode steps (B = ``batch``, the caches') with
    torch.profiler: wall and device busy time a step, the device's kernels
    a step, the top device ops (where a host-bound step's time goes)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import decoder

    dev = next(model.parameters()).device
    token = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
    with torch.inference_mode():
        decoder.decode_step(model, token, caches, cur_len, cfg)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                decoder.decode_step(model, token, caches, cur_len, cfg)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # The device's own rows (kernels, copies): an aten op's row carries its
    # kernels' time too, so summing every row would count it twice.
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not rows:
        raise AssertionError("the profiler recorded no device activity")
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3 / steps
    kernels = sum(e.count for e in rows) / steps
    print(f"[lm profile] {cfg.name} decode step B={token.shape[0]} under the profiler: "
          f"{wall_ms:.3f} ms wall, device busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.3f} of "
          f"wall), {kernels:.0f} device activities a step; top:")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"[lm profile]   {e.self_device_time_total / 1e3 / steps:9.4f} ms a step  "
              f"x{e.count // steps:4d}  {e.key[:70]}")


def lm_phase(dev, smi: str, profile: bool = False) -> None:
    """Phase 10: the LM server on the card.  a. gemma-2b at full width: in
    float32, prefill and decode vs teacher forcing and the prefill card vs
    CPU; the served (bfloat16) model's drift from the float32 forward,
    printed; `ServeEngine` with the CLI's defaults, every request its
    `LM_MAX_NEW` tokens.  b. the other dense configs at
    full width and `LM_OTHER_LAYERS` layers, one at a time.  c. timings."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models import decoder
    from repro_torch.nn.basic import FLOAT32_MODULES

    t0 = time.perf_counter()
    tf32_err, err32 = lm_float32_checks(dev)
    print(f"[lm {LM_ARCH}] float32: prefill + {LM_DECODE_STEPS} decode steps vs teacher forcing "
          f"on the card: scaled error {tf32_err:.3e} (bound {LM_TEACHER_FORCING}); prefill "
          f"({LM_PROMPT} tokens), card vs CPU: {err32:.3e} (bound {LM_F32_LOGITS:.3e}) in "
          f"{time.perf_counter() - t0:.1f} s")

    cfg = get_config(LM_ARCH)
    model = lm_model(cfg, dev).hold_compute_dtype()
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    n_params = sum(p.numel() for p in model.parameters())
    n_norm = sum(p.numel() for m in model.modules() if isinstance(m, FLOAT32_MODULES)
                 for p in m.parameters())
    if n_params - n_norm != cfg.num_params():  # the config's count leaves the norms out
        raise AssertionError(f"{LM_ARCH}: {n_params} parameters, {n_norm} of them norms; "
                             f"the config counts {cfg.num_params()}")
    drift_tf, drift_dec = lm_bf16_drift(cfg, model, dev)
    print(f"[lm {LM_ARCH}] {n_params:,} parameters ({cfg.dtype}, {weight_bytes:,} B held); "
          f"against the float32 forward of the same weights: the bf16 forward {drift_tf:.4f}, "
          f"bf16 prefill + decode {drift_dec:.4f} (ROADMAP §3w: bf16 drift at 18 layers)")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()  # the peak of serving, not of the float32 models
    engine = serve.ServeEngine(cfg, model, LM_SLOTS, max_len=LM_MAX_LEN, seed=0, device=dev)
    pending = serve.make_requests(cfg, LM_REQUESTS, LM_PROMPT, LM_MAX_NEW, seed=0)
    torch.cuda.synchronize()
    t_serve = time.perf_counter()
    finished, steps = serve.drain(engine, pending)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t_serve
    tokens = sum(len(r.out) for r in finished)
    if len(finished) != LM_REQUESTS or any(len(r.out) != LM_MAX_NEW for r in finished):
        raise AssertionError(f"served {[len(r.out) for r in finished]}, want {LM_MAX_NEW} each")
    if not all(0 <= t < cfg.vocab_size for r in finished for t in r.out):
        raise AssertionError("a served token is outside the vocabulary")
    print(f"[lm serve] {LM_REQUESTS} requests on {LM_SLOTS} slots, {tokens} tokens in "
          f"{serve_s:.3f} s ({steps} decode steps, {tokens / serve_s:.1f} tok/s); "
          f"req 0: {finished[0].out[:8]}")

    # c. timings: prefill (B=slots, prompt tokens) and a decode step (B=slots).
    toks = lm_tokens(cfg, LM_SLOTS, LM_PROMPT, seed=3).to(dev)
    with torch.inference_mode():
        prefill_ms = cuda_ms(lambda: decoder.prefill(model, toks, cfg, max_len=LM_MAX_LEN), 10)
        _, caches, n = decoder.prefill(model, toks, cfg, max_len=LM_MAX_LEN)
        step = toks[:, :1]
        decode_ms = cuda_ms(lambda: decoder.decode_step(model, step, caches, n, cfg), 20)
    peak = torch.cuda.max_memory_allocated()
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    print(f"[lm time] {LM_ARCH} B={LM_SLOTS}: prefill of {LM_PROMPT} tokens {prefill_ms:.3f} ms; "
          f"decode step {decode_ms:.3f} ms (bytes bound {bound_ms:.3f} ms: {weight_bytes:,} B "
          f"of weights once a step at {HBM_BYTES_PER_S / 1e12:.2f} TB/s; {bound_ms / decode_ms:.3f} "
          f"of it); served {tokens / serve_s:.1f} tok/s; peak memory {peak:,} B; {smi}")
    if profile:
        profile_lm(cfg, model, caches, n, LM_SLOTS)
    del model, engine, caches
    torch.cuda.empty_cache()

    for arch in LM_OTHER:
        t1 = time.perf_counter()
        ocfg = dataclasses.replace(get_config(arch), num_layers=LM_OTHER_LAYERS)
        omodel = lm_model(ocfg, dev).hold_compute_dtype()
        err = lm_teacher_forcing(ocfg, omodel, 2, arch)
        del omodel
        torch.cuda.empty_cache()
        print(f"[lm {arch}] full width, {LM_OTHER_LAYERS} layers: prefill + {LM_DECODE_STEPS} "
              f"decode steps vs teacher forcing: scaled error {err:.4f} in "
              f"{time.perf_counter() - t1:.1f} s")


# -- the other LM families (phase 10b) --------------------------------------------

#: Served at full width and full depth (this slice's main path).
LM_FAMILIES_FULL = ("zamba2-1.2b", "rwkv6-1.6b")
#: At full width, depth cut for memory: arch -> layers (deepseek-v3: its 3
#: dense layers and its first MoE layer of 256 experts).
LM_FAMILIES_CUT = {"deepseek-v3-671b": 4, "llama4-scout-17b-a16e": 2}
#: The encoder-decoder at full size, and the frames it encodes.
LM_ENCDEC = "whisper-tiny"
LM_FAMILY_STEPS = 16


class DropCount:
    """Counts the (token, expert) assignments that capacity drops in a
    model's MoE layers (`moe.dropped_pairs` on each layer's input), and
    the first sequence position of a token that lost one, until `close`.
    Capacity depends on the whole batch, so teacher forcing may drop what a
    decode step keeps (ROADMAP §3z); a drop at position p changes no
    position before it (causal attention, per-token experts)."""

    def __init__(self, model):
        from repro_torch.nn import moe

        self.reset()
        self.handles = [m.register_forward_pre_hook(self._hook) for m in model.modules()
                        if isinstance(m, moe.MoE)]

    def reset(self) -> None:
        self.dropped, self.calls, self.first = 0, 0, None

    def _hook(self, m, args):
        from repro_torch.nn import moe

        x = args[0]
        pairs = moe.dropped_pairs(m.tree(), x.reshape(-1, x.shape[-1]), m.cfg)
        self.calls += 1
        if len(pairs):
            self.dropped += len(pairs)
            first = int((pairs[:, 0] % x.shape[1]).min())
            self.first = first if self.first is None else min(self.first, first)

    def close(self) -> None:
        for h in self.handles:
            h.remove()


def family_float32_full(arch: str, dev) -> tuple[float, float]:
    """zamba2 / rwkv6 at full width and depth in float32: `LM_FAMILY_STEPS`
    decode steps on the card against the card's teacher forcing (bound
    0.06), and the card's forward against the same weights' forward on the
    CPU (bound `LM_F32_LOGITS`).  Returns the two scaled errors."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import decoder

    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    model = lm_model(cfg, dev)
    toks = lm_tokens(cfg, 2, LM_FAMILY_STEPS, seed=1)
    with float32_products(), torch.inference_mode():
        card = decoder.apply(model, toks.to(dev), cfg)[0]
        caches = decoder.init_decode_caches(cfg, 2, LM_FAMILY_STEPS, device=dev)
        errs = []
        for t in range(LM_FAMILY_STEPS):
            lg, caches = decoder.decode_step(model, toks[:, t:t + 1].to(dev), caches, t, cfg)
            errs.append(scaled_error(card[:, t], lg[:, 0]))
        card = card.cpu()
        model.to("cpu")
        cpu = decoder.apply(model, toks, cfg)[0]
    del model
    torch.cuda.empty_cache()
    if not all(np.isfinite(errs)) or max(errs) >= LM_TEACHER_FORCING:
        raise AssertionError(f"{arch} float32: decode vs teacher forcing {errs}")
    err = scaled_error(cpu, card)
    if not torch.isfinite(card).all() or err > LM_F32_LOGITS:
        raise AssertionError(f"{arch} float32 forward, card vs CPU: {err} > {LM_F32_LOGITS}")
    return max(errs), err


def family_float32_cut(arch: str, layers: int, dev) -> dict:
    """deepseek-v3 / llama4-scout at full width and ``layers`` layers in
    float32 on the card, B=1: a prefill of 8 tokens and up to
    `LM_DECODE_STEPS` decode steps against teacher forcing (one forward of
    16 tokens).  The steps compared end before the first position whose
    assignment teacher forcing dropped (the prefill and the decode steps
    must drop none), and must include the reference's 4.  Returns the
    largest scaled error, teacher forcing's dropped assignments, their
    first position and the decode steps compared."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import decoder

    cfg = dataclasses.replace(get_config(arch), dtype="float32", num_layers=layers)
    model = lm_model(cfg, dev)
    watch = DropCount(model)
    steps = 8 + LM_DECODE_STEPS
    toks = lm_tokens(cfg, 1, steps, seed=1).to(dev)
    with float32_products(), torch.inference_mode():
        lg_tf, _ = decoder.apply(model, toks, cfg)
        tf = dict(dropped=watch.dropped, first=watch.first, calls=watch.calls)
        end = steps if watch.first is None else watch.first
        watch.reset()
        lg, caches, n = decoder.prefill(model, toks[:, :8], cfg, max_len=steps)
        errs = [scaled_error(lg_tf[:, :8], lg)]
        for t in range(n, end):
            lg, caches = decoder.decode_step(model, toks[:, t:t + 1], caches, t, cfg)
            errs.append(scaled_error(lg_tf[:, t], lg[:, 0]))
    watch.close()
    peak = torch.cuda.max_memory_allocated()
    del model, caches
    torch.cuda.empty_cache()
    if watch.dropped:
        raise AssertionError(f"{arch}: the prefill or a decode step dropped {watch.dropped}")
    if end - n < 4:
        raise AssertionError(f"{arch}: teacher forcing dropped {tf['dropped']} assignments from "
                             f"position {tf['first']}: fewer than 4 decode steps to compare")
    if not all(np.isfinite(errs)) or max(errs) >= LM_TEACHER_FORCING:
        raise AssertionError(f"{arch} float32: prefill/decode vs teacher forcing {errs}")
    return dict(err=max(errs), steps=end - n, peak=peak, **tf)


def family_served(cfg, dev, smi: str, profile: bool) -> None:
    """``cfg`` (bfloat16) served through `ServeEngine` with phase 10's
    settings; the CUDA-event time of a decode step at B = `LM_SLOTS`
    against its bytes bound (every held weight read once: the reference's
    MoE dispatch runs every expert), tokens/s, peak memory."""
    from repro_torch.launch import serve
    from repro_torch.models import decoder

    torch.cuda.reset_peak_memory_stats()
    model = lm_model(cfg, dev).hold_compute_dtype()  # float32 drawn, cast a parameter at a time
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    n_params = sum(p.numel() for p in model.parameters())
    engine = serve.ServeEngine(cfg, model, LM_SLOTS, max_len=LM_MAX_LEN, seed=0, device=dev)
    pending = serve.make_requests(cfg, LM_REQUESTS, LM_PROMPT, LM_MAX_NEW, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    finished, steps = serve.drain(engine, pending)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    tokens = sum(len(r.out) for r in finished)
    if len(finished) != LM_REQUESTS or any(len(r.out) != LM_MAX_NEW for r in finished):
        raise AssertionError(f"{cfg.name}: served {[len(r.out) for r in finished]}")
    if not all(0 <= t < cfg.vocab_size for r in finished for t in r.out):
        raise AssertionError(f"{cfg.name}: a served token is outside the vocabulary")
    caches = decoder.init_decode_caches(cfg, LM_SLOTS, LM_MAX_LEN, device=dev)
    step = lm_tokens(cfg, LM_SLOTS, 1, seed=3).to(dev)
    with torch.inference_mode():
        logits = decoder.decode_step(model, step, caches, LM_PROMPT, cfg)[0]
        if not torch.isfinite(logits).all():
            raise AssertionError(f"{cfg.name}: non-finite decode logits")
        decode_ms = cuda_ms(lambda: decoder.decode_step(model, step, caches, LM_PROMPT, cfg), 20)
    peak = torch.cuda.max_memory_allocated()
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    print(f"[lm serve {cfg.name}] {cfg.num_layers} layers, {n_params:,} parameters "
          f"({weight_bytes:,} B held, bf16); {LM_REQUESTS} requests on {LM_SLOTS} slots, {tokens} "
          f"tokens in {serve_s:.3f} s ({steps} decode steps, {tokens / serve_s:.1f} tok/s); decode "
          f"step B={LM_SLOTS} {decode_ms:.3f} ms (bytes bound {bound_ms:.3f} ms, "
          f"{bound_ms / decode_ms:.3f} of it); peak memory {peak:,} B; req 0: "
          f"{finished[0].out[:8]}; {smi}")
    if profile:
        profile_lm(cfg, model, caches, LM_PROMPT, LM_SLOTS)
    del model, engine, caches
    torch.cuda.empty_cache()


def encdec_float32(dev) -> tuple[float, float]:
    """whisper-tiny at full size in float32 (B=1, `enc_seq` frames from the
    seed): encode, `init_decode_caches` and `LM_FAMILY_STEPS` decode steps
    on the card against `encdec.apply`'s teacher forcing (bound 0.06); the
    card's encoding, forward and decode logits against the CPU's (bound
    `LM_F32_LOGITS`).  Returns (teacher-forcing error, card vs CPU)."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import encdec

    cfg = dataclasses.replace(get_config(LM_ENCDEC), dtype="float32")
    model = encdec.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    toks = lm_tokens(cfg, 1, LM_FAMILY_STEPS, seed=1)
    frames = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, cfg.enc_seq, cfg.d_model)).astype(np.float32))

    def run(device):
        t, f = toks.to(device), frames.to(device)
        enc = encdec.encode(model, f, cfg)
        lg_tf = encdec.apply(model, t, f, cfg)[0]
        caches = encdec.init_decode_caches(model, f, cfg, LM_FAMILY_STEPS)
        dec = []
        for s in range(LM_FAMILY_STEPS):
            lg, caches = encdec.decode_step(model, t[:, s:s + 1], caches, s, cfg)
            dec.append(lg[:, 0])
        return enc.cpu(), lg_tf.cpu(), torch.stack(dec, 1).cpu()

    with float32_products(), torch.inference_mode():
        card = run(dev)
        model.to("cpu")
        cpu = run("cpu")
    tf_err = scaled_error(card[1], card[2])
    if not all(torch.isfinite(c).all() for c in card) or tf_err >= LM_TEACHER_FORCING:
        raise AssertionError(f"{LM_ENCDEC}: decode vs teacher forcing {tf_err}")
    errs = [scaled_error(c, g) for c, g in zip(cpu, card)]
    if max(errs) > LM_F32_LOGITS:
        raise AssertionError(f"{LM_ENCDEC} card vs CPU (encode, forward, decode): {errs}")
    return tf_err, max(errs)


def lm_families_phase(dev, smi: str, profile: bool = False) -> None:
    """Phase 10b: the other LM families on the card, one model at a time,
    random weights from a seeded generator on the card.  a. zamba2-1.2b
    and rwkv6-1.6b at full width and depth: float32 gates, then served in
    bfloat16; b. deepseek-v3 (4 layers) and llama4-scout (2 layers) at
    full width: float32 teacher forcing with no assignment dropped, then
    served in bfloat16; c. whisper-tiny at full size, float32, card vs
    CPU, then served (as a dense decoder) in bfloat16."""
    import dataclasses

    from repro_torch.configs.registry import get_config

    for arch in LM_FAMILIES_FULL:
        t0 = time.perf_counter()
        tf_err, cpu_err = family_float32_full(arch, dev)
        print(f"[lm {arch}] float32, full width and depth: {LM_FAMILY_STEPS} decode steps vs "
              f"teacher forcing on the card {tf_err:.3e} (bound {LM_TEACHER_FORCING}); forward "
              f"(B=2, {LM_FAMILY_STEPS} tokens) card vs CPU {cpu_err:.3e} (bound "
              f"{LM_F32_LOGITS:.3e}) in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        family_served(get_config(arch), dev, smi, profile)
        print(f"[lm {arch}] bf16 serving in {time.perf_counter() - t0:.1f} s")
    for arch, layers in LM_FAMILIES_CUT.items():
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        r = family_float32_cut(arch, layers, dev)
        print(f"[lm {arch}] float32, full width, {layers} layers, B=1: prefill of 8 + "
              f"{r['steps']} decode steps vs teacher forcing {r['err']:.3e} (bound "
              f"{LM_TEACHER_FORCING}); teacher forcing dropped {r['dropped']} assignments in "
              f"{r['calls']} MoE calls (first at position {r['first']}: the steps compared end "
              f"before it), the prefill and decode steps none; peak memory {r['peak']:,} B in "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        family_served(dataclasses.replace(get_config(arch), num_layers=layers), dev, smi, profile)
        print(f"[lm {arch}] bf16 serving in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tf_err, cpu_err = encdec_float32(dev)
    print(f"[lm {LM_ENCDEC}] float32, full size: encode, caches and {LM_FAMILY_STEPS} decode "
          f"steps vs teacher forcing {tf_err:.3e} (bound {LM_TEACHER_FORCING}); card vs CPU "
          f"{cpu_err:.3e} (bound {LM_F32_LOGITS:.3e}) in {time.perf_counter() - t0:.1f} s")
    # What the server serves for whisper: its config built as a dense decoder,
    # as the reference's decoder builds it.
    family_served(get_config(LM_ENCDEC), dev, smi, profile)


# -- LM training (phase 11) --------------------------------------------------------

#: The trained arch at full width and depth, and the main path's CLI flags
#: (the CLI's default lr of 3e-3 was set for the smoke configs).
TRAIN_ARCH = "gemma-2b"
TRAIN_ARGS = ["--arch", TRAIN_ARCH, "--steps", "12", "--batch", "4", "--seq-len", "128",
              "--lr", "3e-4", "--warmup", "4"]
#: Steps of the main path left out of its times (allocation, cuBLAS set-up).
TRAIN_WARMUP_STEPS = 2
#: The other families trained at full width and depth (bf16, the configs' own).
TRAIN_FAMILIES = ("zamba2-1.2b", "rwkv6-1.6b")
#: The bound (tests/test_torch_lm_trap.py F32_GRAD_DEEP) on a float32 train
#: step's loss, clipped gradient (Adam's first moment after one step) and
#: gradient norm, the card's against the CPU's, as scaled errors: the bound at
#: 18 layers (the CPU tests' F32_GRAD, 2^-15, holds the port against the
#: reference at the smoke configs; zamba2's smoke step, card vs CPU, is 3.0e-5:
#: its scans' exps).
TRAIN_F32_GRAD_DEEP = 2.0**-13
#: Grad accumulation against one batch: the reference's own bound on Adam's m
#: (tests/test_train_infra.py:54-73), scaled by each leaf's largest value.
TRAIN_ACCUM_M = 2e-2
#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet, 700 W).
BF16_OPS_PER_S = 989e12


class StepEvents:
    """Wraps `train.step.make_train_step` and `optim.adamw.adamw_update` in
    `launch.train` so that each call is timed by a pair of CUDA events (the
    call's span on the card: host gaps included) and the states it returns
    are kept; ``profile_step`` traces that step with torch.profiler."""

    def __init__(self, profile_step: int | None = None):
        from repro_torch.launch import train as train_cli
        from repro_torch.train import step as step_mod

        self.step_ms, self.adamw_ms, self.states, self.busy = [], [], [], None
        self._mods, self._profile_step = (train_cli, step_mod), profile_step
        self._make, self._adamw = train_cli.make_train_step, step_mod.adamw_update

    def _events(self, fn, out: list):
        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            result = fn(*args, **kw)
            end.record()
            out.append((start, end))
            return result
        return timed

    def __enter__(self):
        train_cli, step_mod = self._mods
        step_mod.adamw_update = self._events(self._adamw, self.adamw_ms)

        def make(cfg, tc):
            step = self._events(self._make(cfg, tc), self.step_ms)

            def call(state, batch):
                if len(self.step_ms) == self._profile_step:
                    return self._profiled(step, state, batch)
                state, metrics = step(state, batch)
                self.states.append(state)
                return state, metrics
            return call

        train_cli.make_train_step = make
        return self

    def _profiled(self, step, state, batch):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if not rows:
            raise AssertionError("the profiler recorded no device activity")
        busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
        self.busy = (busy_ms, wall_ms, sum(e.count for e in rows))
        self.states.append(state)
        return state, metrics

    def __exit__(self, *exc):
        train_cli, step_mod = self._mods
        train_cli.make_train_step, step_mod.adamw_update = self._make, self._adamw
        torch.cuda.synchronize()
        self.step_ms = [s.elapsed_time(e) for s, e in self.step_ms]
        self.adamw_ms = [s.elapsed_time(e) for s, e in self.adamw_ms]
        return False


def train_cli(argv: list[str], profile_step: int | None = None):
    """`launch.train.main(argv)` on the card: returns (losses, `StepEvents`,
    peak memory).  The losses printed must be the losses returned."""
    from repro_torch.launch import train as train_mod

    out = io.StringIO()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with StepEvents(profile_step) as ev, contextlib.redirect_stdout(out):
        losses = train_mod.main(argv)
    peak = torch.cuda.max_memory_allocated()
    printed = re.findall(r"^step +\d+ loss +(\S+)", out.getvalue(), re.M)
    if printed != [f"{loss:.4f}" for loss in losses] or not all(np.isfinite(losses)):
        raise AssertionError(f"{argv}: printed {printed}, returned {losses}")
    return losses, ev, peak


def card_scaled_error(want: torch.Tensor, got: torch.Tensor, floor: float = 1e-30) -> float:
    """`scaled_error` in float64 on ``want``'s device (a leaf of 2 GB stays
    on the card); the largest value floored at ``floor``."""
    want, got = want.double(), got.to(want.device).double()
    return float((want - got).abs().max() / want.abs().max().clamp(min=floor))


def leaf_errors(want: dict, got: dict, floor: float = 1e-30) -> tuple[float, str]:
    """The worst scaled error over the leaves of two ``{name: tensor}``."""
    worst, where = 0.0, ""
    for name, w in want.items():
        e = card_scaled_error(w, got[name], floor)
        if not e <= worst:  # NaN counts as worst
            worst, where = e, name
    return worst, where


def train_step_card_vs_cpu(cfg, dev, batch_np: dict, seed: int = 0):
    """One float32 `make_train_step` step (TF32 off) on the card and on the
    CPU from the same weights (drawn on the card) and batch.  Returns the
    scaled errors of the loss, the gradient norm and the worst leaf of m
    (the clipped gradient times 1 - b1), with that leaf's name."""
    from repro_torch.models import decoder, encdec
    from repro_torch.train import step as step_mod

    init = (encdec if cfg.encdec else decoder).init_params
    tc = step_mod.TrainConfig()
    with float32_products():
        model = init(torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)
        state, met = step_mod.make_train_step(cfg, tc)(
            step_mod.init_train_state(model, tc),
            {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()})
        m_card = state.opt.m
        state = None
        model.to("cpu")
        cpu_state, cpu_met = step_mod.make_train_step(cfg, tc)(
            step_mod.init_train_state(model, tc),
            {k: torch.from_numpy(v) for k, v in batch_np.items()})
    errs = {k: scaled_error(cpu_met[k].reshape(1), met[k].reshape(1))
            for k in ("loss", "grad_norm")}
    m_err, worst = leaf_errors(m_card, cpu_state.opt.m)
    return errs["loss"], errs["grad_norm"], m_err, worst, float(met["loss"])


def host_free_bytes() -> int:
    with open("/proc/meminfo") as f:
        info = dict(line.split(":", 1) for line in f)
    return int(info["MemAvailable"].split()[0]) * 1024


def train_float32_gate(dev) -> None:
    """11a: gemma-2b at full width and depth, one float32 train step (B=1,
    16 tokens) on the card and on the CPU."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLMDataset

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), dtype="float32")
    batch = SyntheticLMDataset(cfg.vocab_size, 16, 1, seed=0).batch_at(0)
    free = host_free_bytes()
    t0 = time.perf_counter()
    loss_e, gn_e, m_e, worst, loss = train_step_card_vs_cpu(cfg, dev, batch)
    torch.cuda.empty_cache()
    for what, e in (("loss", loss_e), ("grad norm", gn_e), ("clipped gradient", m_e)):
        if not e <= TRAIN_F32_GRAD_DEEP:
            raise AssertionError(f"{TRAIN_ARCH} float32 train step, card vs CPU: {what} "
                                 f"scaled error {e} > {TRAIN_F32_GRAD_DEEP}")
    print(f"[train {TRAIN_ARCH}] float32 train step, full width and depth (B=1, 16 tokens), "
          f"card vs CPU from the same weights: loss {loss:.6f} (scaled error {loss_e:.3e}), "
          f"grad norm {gn_e:.3e}, worst leaf's clipped gradient {m_e:.3e} ({worst}); bound "
          f"{TRAIN_F32_GRAD_DEEP:.3e}; host memory free before: {free:,} B; "
          f"{time.perf_counter() - t0:.1f} s")


def train_main_path(smi: str, profile: bool) -> None:
    """11b: gemma-2b trained through `launch.train.main` (bf16 compute over
    float32 parameters, remat "full"), then the same run with bfloat16 m, v."""
    import functools

    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train as train_mod
    from repro_torch.optim.adamw import AdamWConfig

    cfg = get_config(TRAIN_ARCH)
    batch, seq = int(TRAIN_ARGS[5]), int(TRAIN_ARGS[7])
    tokens = batch * seq
    t0 = time.perf_counter()
    losses, ev, peak = train_cli(TRAIN_ARGS, profile_step=8 if profile else None)
    wall = time.perf_counter() - t0
    state = ev.states[-1]
    n_params = sum(p.numel() for p in state.params.parameters())
    if n_params != 2_506_172_416 or cfg.num_layers != 18 or cfg.d_model != 2048:
        raise AssertionError(f"{TRAIN_ARCH}: {n_params} parameters, {cfg.num_layers} layers")
    if any(t.dtype != torch.float32 for t in (*state.opt.m.values(), *state.params.parameters())):
        raise AssertionError("the main path's parameters and m must be float32")
    del state
    ev.states.clear()
    steady = ev.step_ms[TRAIN_WARMUP_STEPS:]
    step_ms = float(np.median(steady))
    adamw_ms = float(np.median(ev.adamw_ms[TRAIN_WARMUP_STEPS:]))
    flops = 8 * n_params * tokens  # 6 N a token, and the recompute's 2 N
    bound_flops_ms = flops / BF16_OPS_PER_S * 1e3
    adamw_bytes = 28 * n_params  # read p, g, m, v; write p, m, v (float32)
    adamw_bound = adamw_bytes / HBM_BYTES_PER_S * 1e3
    print(f"[train {TRAIN_ARCH}] launch.train.main({' '.join(TRAIN_ARGS)}): losses "
          f"{', '.join(f'{x:.4f}' for x in losses)} (printed == returned, all finite) in "
          f"{wall:.1f} s; {n_params:,} parameters, 18 layers, d_model 2048, remat full")
    print(f"[train time] {TRAIN_ARCH} B={batch} S={seq}: step {step_ms:.2f} ms (CUDA events, "
          f"median of steps {TRAIN_WARMUP_STEPS}-{len(ev.step_ms) - 1}: "
          f"{min(steady):.2f}-{max(steady):.2f}), {tokens / step_ms * 1e3:.0f} tokens/s; "
          f"{flops:.3e} operations a step (8 N a token) = {bound_flops_ms:.2f} ms at the dense "
          f"bf16 peak ({bound_flops_ms / step_ms:.3f} of it); AdamW update {adamw_ms:.2f} ms "
          f"against its bytes bound {adamw_bound:.2f} ms ({adamw_bytes:,} B at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s: {adamw_bound / adamw_ms:.3f} of it); peak memory "
          f"{peak:,} B; {smi}")
    if ev.busy is not None:
        busy_ms, wall_ms, acts = ev.busy
        print(f"[train profile] {TRAIN_ARCH} step 8 under the profiler: {wall_ms:.2f} ms wall, "
              f"device busy {busy_ms:.2f} ms ({busy_ms / wall_ms:.3f} of wall), {acts} device "
              f"activities")
    orig = train_mod.AdamWConfig
    train_mod.AdamWConfig = functools.partial(AdamWConfig, state_dtype="bfloat16")
    try:
        losses16, ev16, peak16 = train_cli(TRAIN_ARGS)
    finally:
        train_mod.AdamWConfig = orig
    if any(t.dtype != torch.bfloat16 for t in ev16.states[-1].opt.v.values()):
        raise AssertionError("state_dtype='bfloat16': m and v must be bfloat16")
    ev16.states.clear()
    if not peak16 < peak:
        raise AssertionError(f"bfloat16 m, v: peak memory {peak16:,} B, not below {peak:,}")
    step16 = float(np.median(ev16.step_ms[TRAIN_WARMUP_STEPS:]))
    print(f"[train {TRAIN_ARCH}] bfloat16 m, v (AdamWConfig(state_dtype='bfloat16')): losses "
          f"{', '.join(f'{x:.4f}' for x in losses16)}; step {step16:.2f} ms, AdamW "
          f"{float(np.median(ev16.adamw_ms[TRAIN_WARMUP_STEPS:])):.2f} ms; peak memory "
          f"{peak16:,} B (float32 m, v: {peak:,}); {smi}")


def accum_m_error(cfg, dev, batch) -> tuple[float, str]:
    """One step of ``cfg`` at full width on ``batch``, grad_accum=2 against
    1 (lr 0 at the first step, so both start from the same weights): the
    worst leaf of Adam's m as the reference scales it (by the largest value
    of grad_accum=1's leaf, floored at 1e-6), and its name."""
    from repro_torch.models import decoder
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import step as step_mod

    model = decoder.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    m = {}
    for accum in (2, 1):  # grad_accum=1's m (the scale) stays on the card
        tc = step_mod.TrainConfig(optimizer=AdamWConfig(lr=1e-2, warmup_steps=1,
                                                        total_steps=10), grad_accum=accum)
        state, met = step_mod.make_train_step(cfg, tc)(step_mod.init_train_state(model, tc),
                                                       batch)
        if accum == 2 and set(met) & {"ce_loss", "aux_loss"}:
            raise AssertionError(f"grad_accum=2 metrics carry {sorted(met)}")
        m[accum] = {n: t.cpu() if accum == 2 else t for n, t in state.opt.m.items()}
        del state, met
    worst = leaf_errors(m[1], m[2], floor=1e-6)
    del model, m
    torch.cuda.empty_cache()
    return worst


def train_grad_accum(dev) -> None:
    """11c: gemma-2b at full width, one step on a batch of 8 (S=128),
    grad_accum=2 against 1: in float32 (TF32 off) Adam's m within the
    reference's scaled 2e-2; the config's bf16, printed: a norm scale's
    gradient is a sum over every token with cancellation, and at 18 layers
    bf16's rounding moves it by more than that."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLMDataset

    cfg = get_config(TRAIN_ARCH)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in SyntheticLMDataset(cfg.vocab_size, 128, 8, seed=1).batch_at(0).items()}
    t0 = time.perf_counter()
    with float32_products():
        err32, where32 = accum_m_error(dataclasses.replace(cfg, dtype="float32"), dev, batch)
    err16, where16 = accum_m_error(cfg, dev, batch)
    if not err32 <= TRAIN_ACCUM_M:
        raise AssertionError(f"grad_accum=2 vs 1, float32: m scaled error {err32} at {where32}")
    print(f"[train accum] {TRAIN_ARCH} B=8 S=128, grad_accum=2 vs 1, Adam's m, worst leaf: "
          f"float32 {err32:.3e} ({where32}; bound {TRAIN_ACCUM_M}); bf16 {err16:.3e} "
          f"({where16}; printed) in {time.perf_counter() - t0:.1f} s")


def train_worker(mode: str, root: str) -> int:
    """The resume children (``--train-worker cut|resume DIR``): the CLI's
    default arch at its smoke config on the card, 4 steps, deterministic
    algorithms.  ``cut``: an uninterrupted run checkpointing into DIR/whole,
    then a run into DIR/cut that sends itself SIGTERM when step 2 has ended,
    so `PreemptionHandler` stops the loop and the emergency checkpoint is
    written.  ``resume``: a fresh process resuming DIR/cut to step 4."""
    if not torch.cuda.is_available():
        return 2
    torch.use_deterministic_algorithms(True)
    from repro_torch.launch import train as train_mod
    from repro_torch.runtime import ft

    class SigtermAfterStep2(ft.StepTimer):
        def __exit__(self, *exc):
            super().__exit__(*exc)
            if self.step + 1 == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return False

    argv = ["--smoke", "--steps", "4", "--ckpt-dir"]
    if mode == "cut":
        train_mod.main(argv + [os.path.join(root, "whole")])
        train_mod.StepTimer = SigtermAfterStep2
        try:
            train_mod.main(argv + [os.path.join(root, "cut")])
        finally:
            train_mod.StepTimer = ft.StepTimer
    else:
        train_mod.main(argv + [os.path.join(root, "cut")])
    return 0


def train_resume(dev, tmp: str) -> None:
    """11d: resume on the card, bit for bit.  Two children (this script with
    ``--train-worker``), each with ``torch.use_deterministic_algorithms``
    and ``CUBLAS_WORKSPACE_CONFIG=:4096:8``: the embedding's and the
    loss's gathers have scatter-add backwards, which are atomic on the card
    otherwise.  The first trains 4 steps uninterrupted, then 4 steps that
    receive SIGTERM after step 2 and write the emergency checkpoint; a
    fresh one resumes from it to step 4.  Every leaf of the two final
    states must be equal (torch.equal, on the card)."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.configs.registry import get_config
    from repro_torch.core import convert
    from repro_torch.launch.train import parse_args
    from repro_torch.models import decoder
    from repro_torch.train import step as step_mod

    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()

    def child(mode: str) -> str:
        proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--train-worker",
                               mode, tmp], capture_output=True, text=True, timeout=600, env=env)
        if proc.returncode != 0:
            raise AssertionError(f"train worker exited {proc.returncode}:\n{proc.stdout[-2000:]}"
                                 f"\n{proc.stderr[-4000:]}")
        return proc.stdout

    out = child("cut")
    if "preemption: writing emergency checkpoint" not in out:
        raise AssertionError(f"the preempted run wrote no emergency checkpoint:\n{out}")
    whole, cut = os.path.join(tmp, "whole"), os.path.join(tmp, "cut")
    cut_steps = CheckpointManager(cut).valid_steps()
    if cut_steps != [2]:
        raise AssertionError(f"after SIGTERM at step 2 the checkpoints are {cut_steps}, want [2]")
    out = child("resume")
    if "resumed from checkpoint step 2" not in out:
        raise AssertionError(f"the fresh worker did not resume from step 2:\n{out}")
    cfg = get_config(parse_args([]).arch, smoke=True)
    tc = step_mod.TrainConfig()
    states = []
    for d in (whole, cut):
        model = decoder.init_params(torch.Generator(device=dev).manual_seed(1), cfg, device=dev)
        step, state, _ = CheckpointManager(d).restore_latest(step_mod.init_train_state(model, tc))
        if step != 4:
            raise AssertionError(f"{d}: latest step {step}, want 4")
        states.append(state)
    a, b = (convert.train_state_to_arrays(s) for s in states)
    differ = [n for n in a if not torch.equal(a[n].to(dev), b[n].to(dev))]
    if differ:
        raise AssertionError(f"resumed run != uninterrupted run at {differ[:5]}")
    print(f"[train resume] {cfg.name} on the card, deterministic algorithms: 4 steps "
          f"uninterrupted == 2 steps, SIGTERM, emergency checkpoint at step 2, a fresh process "
          f"resumed to step 4: all {len(a)} leaves equal (torch.equal) in "
          f"{time.perf_counter() - t0:.1f} s")


def train_families(smi: str) -> None:
    """11e: zamba2-1.2b and rwkv6-1.6b at full width and depth, 4 bf16
    steps each through `launch.train.main`."""
    from repro_torch.configs.registry import get_config

    for arch in TRAIN_FAMILIES:
        cfg = get_config(arch)
        argv = ["--arch", arch, "--steps", "4", "--batch", "4", "--seq-len", "128",
                "--lr", "3e-4", "--warmup", "2"]
        t0 = time.perf_counter()
        losses, ev, peak = train_cli(argv)
        n_params = sum(p.numel() for p in ev.states[-1].params.parameters())
        ev.states.clear()
        step_ms = float(np.median(ev.step_ms[1:]))
        print(f"[train {arch}] full width and depth ({cfg.num_layers} layers, {n_params:,} "
              f"parameters), B=4 S=128, 4 bf16 steps: losses "
              f"{', '.join(f'{x:.4f}' for x in losses)}; step {step_ms:.2f} ms (median of steps "
              f"1-3), {512 / step_ms * 1e3:.0f} tokens/s; AdamW "
              f"{float(np.median(ev.adamw_ms[1:])):.2f} ms; peak memory {peak:,} B in "
              f"{time.perf_counter() - t0:.1f} s; {smi}")


def train_smoke_archs(dev) -> None:
    """11f: every other LM arch's smoke config: one float32 train step on
    the card against the CPU (B=2, 32 positions)."""
    import dataclasses

    from repro_torch.configs.registry import ARCHS, get_config

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    worst = []
    for arch in ARCHS:
        if arch in ("ising-qmc", TRAIN_ARCH):
            continue
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
        text = 32 - cfg.vlm_patches
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, text)).astype(np.int32),
                 "labels": rng.integers(0, cfg.vocab_size, (2, text)).astype(np.int32)}
        if cfg.vlm_patches:
            batch["visual_embeds"] = rng.standard_normal((2, cfg.vlm_patches, cfg.d_model),
                                                         np.float32)
        if cfg.encdec:
            batch["frames"] = rng.standard_normal((2, cfg.enc_seq, cfg.d_model), np.float32)
        loss_e, gn_e, m_e, where, _ = train_step_card_vs_cpu(cfg, dev, batch)
        if not max(loss_e, gn_e, m_e) <= TRAIN_F32_GRAD_DEEP:
            raise AssertionError(f"{arch} smoke float32 train step, card vs CPU: loss {loss_e}, "
                                 f"grad norm {gn_e}, m {m_e} ({where}) > {TRAIN_F32_GRAD_DEEP}")
        worst.append(f"{arch} {max(loss_e, gn_e, m_e):.2e}")
    print(f"[train smoke archs] float32 train step card vs CPU (worst of loss, grad norm, "
          f"clipped gradient; bound {TRAIN_F32_GRAD_DEEP:.3e}, 11a's): {'; '.join(worst)} in "
          f"{time.perf_counter() - t0:.1f} s")


def train_phase(dev, smi: str, profile: bool = False) -> None:
    """Phase 11: LM training on the card (plain PyTorch: none of #1-#8)."""
    train_float32_gate(dev)
    train_main_path(smi, profile)
    train_grad_accum(dev)
    with tempfile.TemporaryDirectory() as tmp:
        train_resume(dev, tmp)
    train_families(smi)
    train_smoke_archs(dev)


# -- the LM over a device mesh (phase 12) ---------------------------------------------

#: Phase 12a's dry-run cells (arch, shape, multi-pod) and the status each
#: must have: the reference skips quadratic attention at long_500k.
MESH_CELLS = [
    ("gemma-2b", "train_4k", False, "ok"),
    ("gemma-2b", "train_4k", True, "ok"),
    ("qwen2.5-14b", "prefill_32k", False, "ok"),
    ("qwen2.5-14b", "decode_32k", False, "ok"),
    ("deepseek-v3-671b", "train_4k", False, "ok"),
    ("deepseek-v3-671b", "decode_32k", False, "ok"),
    ("whisper-tiny", "decode_32k", False, "ok"),
    ("rwkv6-1.6b", "long_500k", False, "ok"),
    ("qwen2.5-14b", "long_500k", False, "skipped"),
]
#: Phase 12b: rank 0's share of these cells, run for real on the card.
RANK0_CELLS = [("gemma-2b", "train_4k"), ("deepseek-v3-671b", "decode_32k")]


def _last_json(text: str, back: int = 1) -> dict:
    """The ``back``-th JSON row from the end of ``text``."""
    rows = [line for line in text.splitlines() if line.startswith("{")]
    if len(rows) < back:
        raise AssertionError(f"no JSON row in:\n{text[-2000:]}")
    return json.loads(rows[-back])


def _child_launches(stdout: str) -> dict:
    """The kernel launches a phase-12 child counted itself (its last JSON row)."""
    return _last_json(stdout)["launches"]


def _children(cmds: dict, timeout: float) -> dict:
    """Run the commands (``{key: argv}``) at once; ``{key: (rc, stdout, stderr, s)}``.
    Every child is waited for, or killed when the time is up."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs, out = {}, {}
    t0 = time.perf_counter()
    try:
        for key, argv in cmds.items():
            procs[key] = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                          text=True, env=env, cwd=str(ROOT))
        for key, proc in procs.items():
            left = max(1.0, timeout - (time.perf_counter() - t0))
            stdout, stderr = proc.communicate(timeout=left)
            out[key] = (proc.returncode, stdout, stderr, time.perf_counter() - t0)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def mesh_dryrun(smi: str, extra: dict, launches: dict) -> tuple[dict, dict]:
    """12a: `launch.dryrun`'s CLI at full width and depth, one child a cell,
    all at once (a fake world of 256 or 512 ranks each; fake tensors on the
    card's device type), with the ``extra`` children beside them.  Each
    child's kernel launches are added to ``launches``.  Returns the rows
    and the extra children's results."""
    cmds = dict(extra)
    for arch, shape, mp, _ in MESH_CELLS:
        cmds[arch, shape, mp] = [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-worker",
                                 "dryrun", "--device", "cuda", "--arch", arch, "--shape", shape,
                                 "--no-analyze"] + (["--multi-pod"] if mp else [])
    results = _children(cmds, timeout=420)
    rows = {}
    for arch, shape, mp, want in MESH_CELLS:
        rc, stdout, stderr, done_s = results[arch, shape, mp]
        if rc != 0:
            raise AssertionError(f"dry run {arch} {shape} exited {rc}:\n{stderr[-3000:]}")
        for name, n in _child_launches(stdout).items():
            launches[name] += n
        row = _last_json(stdout, back=2)
        if row["status"] != want:
            raise AssertionError(f"dry run {arch} {shape} {'2x16x16' if mp else '16x16'}: "
                                 f"{row['status']}, not {want}: {row}\n{stderr[-4000:]}")
        rows[arch, shape, mp] = row
        mesh = "x".join(str(n) for n in row.get("mesh", {}).values()) or (
            "2x16x16" if mp else "16x16")
        if want == "skipped":
            print(f"[dryrun] {arch} {shape} {mesh}: skipped ({row['reason'][:60]}...) "
                  f"{row['seconds']:.1f} s")
            continue
        mem, coll = row["memory"], row["collectives"]
        print(f"[dryrun] {arch} {shape} {mesh}: ok in {row['seconds']:.1f} s (build "
              f"{row['lower_s']} s, step {row['compile_s']} s); rank 0 arguments "
              f"{mem['argument_bytes'] / 1e9:.3f} GB, temp {mem['temp_bytes'] / 1e9:.3f} GB, "
              f"output {mem['output_bytes'] / 1e9:.3f} GB; {row['xla_cost']['flops_body_once']:.4g}"
              f" flops; collectives {coll['counts']} ({sum(coll['bytes_once'].values()) / 1e9:.3f}"
              f" GB)")
    qwen = rows["qwen2.5-14b", "decode_32k", False]
    if not (sum(qwen["collectives"]["counts"].values()) > 0 and qwen["memory"]["temp_bytes"] > 0
            and qwen["mesh"] == {"data": 16, "model": 16}):
        raise AssertionError(f"qwen2.5-14b decode_32k: {qwen}")
    print(f"[dryrun] {len(MESH_CELLS)} cells in "
          f"{max(r[3] for r in results.values()):.1f} s of wall time (children in parallel); {smi}")
    return rows, {k: results[k] for k in extra}


def mesh_rank0(rows: dict, smi: str, launches: dict) -> None:
    """12b: rank 0's share of each of `RANK0_CELLS`, its local blocks real
    tensors on the card drawn from a seeded generator, one step in the fake
    world (whose collectives do nothing: no value is printed).  The card's
    peak beside the dry run's argument + temp bytes.  Each child's kernel
    launches are added to ``launches``."""
    for arch, shape in RANK0_CELLS:
        res = _children({0: [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-worker",
                             "rank0", arch, shape]}, timeout=420)[0]
        rc, stdout, stderr, _ = res
        if rc != 0:
            raise AssertionError(f"rank 0's {arch} {shape} exited {rc}:\n{stderr[-3000:]}")
        got = _last_json(stdout)
        for name, n in got["launches"].items():
            launches[name] += n
        mem = rows[arch, shape, False]["memory"]
        dry = mem["argument_bytes"] + mem["temp_bytes"]
        print(f"[rank0] {arch} {shape}: one step {got['step_ms']:.1f} ms on the card "
              f"(build {got['build_s']:.1f} s); peak {got['peak_bytes'] / 1e9:.3f} GB "
              f"(arguments {got['argument_bytes'] / 1e9:.3f} GB) against the dry run's "
              f"arguments + temp {dry / 1e9:.3f} GB: ratio {got['peak_bytes'] / dry:.3f}; "
              f"{got['microbatches']} microbatches; {smi}")
        if got["argument_bytes"] != mem["argument_bytes"]:
            raise AssertionError(f"{arch} {shape}: rank 0's arguments {got['argument_bytes']} B "
                                 f"on the card, {mem['argument_bytes']} B in the dry run")


def mesh_worker_dryrun(args: list[str]) -> int:
    """A child of 12a: `launch.dryrun`'s CLI on ``args``, its kernel
    launches counted from 0 and printed as the last JSON row."""
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun

    ops.reset_launches()
    dryrun.main(args)
    print(json.dumps({"launches": dict(ops.launches)}))
    return 0


def mesh_worker_rank0(arch: str, shape: str) -> int:
    """The child of 12b: rank 0's share of (arch, shape), run for real."""
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun

    dev = torch.device("cuda:0")
    dryrun.init_fake_world(False)
    ops.reset_launches()
    t0 = time.perf_counter()
    cell = dryrun.build_cell(arch, shape, False, "cuda",
                             generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    arg_bytes = dryrun.local_bytes(cell.args)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dryrun.run_step(cell, fake=False)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    print(json.dumps({"arch": arch, "shape": shape, "build_s": build_s, "step_ms": step_ms,
                      "peak_bytes": torch.cuda.max_memory_allocated(),
                      "argument_bytes": arg_bytes,
                      "microbatches": cell.meta.get("microbatches_run", 1),
                      "launches": dict(ops.launches)}))
    return 0


def mesh_worker_nccl() -> int:
    """The child of 12c: a one-rank NCCL world on the card, every mesh axis
    of size 1.  Expert parallelism (both combines) through the mesh path
    equals the local path bit for bit (one MoE layer, and deepseek-v3's and
    llama4-scout's smoke models, float32 and bfloat16); the int8_ef train
    step on a ``(1, 1, 1)`` ``("pod", "data", "model")`` mesh equals the
    one-device step (a mesh shape, no device mesh) bit for bit: every
    parameter, m, v and residual after two steps."""
    import dataclasses as dc
    import socket

    import torch.distributed as dist

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.models import decoder
    from repro_torch.nn import moe
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding import ShardingCtx, use_ctx
    from repro_torch.train import step as tstep

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    ops.reset_launches()
    try:
        mesh = make_host_mesh(1, 1, device="cuda")
        ctx = ShardingCtx.over(mesh)
        g = torch.Generator(device=dev).manual_seed(0)
        for dtype in (torch.float32, torch.bfloat16):
            for combine in ("psum", "gather"):
                cfg = moe.MoEConfig(num_experts=16, top_k=4, d_ff_expert=256, capacity_factor=1.0,
                                    routing="sigmoid", norm_topk=True, num_shared_experts=1,
                                    combine=combine)
                layer = moe.MoE(g, 512, cfg, dtype=dtype, device=dev)
                x = torch.randn((4, 64, 512), generator=g, device=dev).to(dtype)
                with torch.no_grad():
                    y0, a0 = layer(x)
                    with use_ctx(ctx):
                        assert moe._ep_mesh(cfg) is mesh
                        y1, a1 = layer(x)
                if not (torch.equal(y0, y1) and torch.equal(a0, a1)):
                    raise AssertionError(f"EP {combine} {dtype}: not the local path")
                print(f"[nccl] one MoE layer (16 experts, top-4, d 512), {combine}, {dtype}: "
                      f"the mesh path == the local path bit for bit")
            for arch in ("deepseek-v3-671b", "llama4-scout-17b-a16e"):
                cfg = dc.replace(get_config(arch, smoke=True), dtype="bfloat16"
                                 if dtype == torch.bfloat16 else "float32")
                model = decoder.init_params(torch.Generator(device=dev).manual_seed(1), cfg, dev)
                toks = torch.randint(0, cfg.vocab_size, (2, 32), generator=g, device=dev)
                with torch.no_grad():
                    l0, _ = decoder.apply(model, toks, cfg)
                    with use_ctx(ctx):
                        l1, _ = decoder.apply(model, toks, cfg)
                if not torch.equal(l0, l1):
                    raise AssertionError(f"{arch} {dtype}: the mesh logits differ")
                print(f"[nccl] {arch} smoke {dtype}: logits on the mesh == one device")
        cfg = dc.replace(get_config("gemma-2b", smoke=True), dtype="float32")
        tc = tstep.TrainConfig(optimizer=AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=10),
                               grad_compression="int8_ef")
        pods = make_mesh((1, 1, 1), ("pod", "data", "model"), "cuda")
        states = []
        for c in (ShardingCtx({"pod": 1, "data": 1, "model": 1}), ShardingCtx.over(pods)):
            model = decoder.init_params(torch.Generator(device=dev).manual_seed(2), cfg, dev)
            state = tstep.init_train_state(model, tc)
            step = tstep.make_train_step(cfg, tc)
            gb = torch.Generator(device=dev).manual_seed(3)
            with use_ctx(c):
                for _ in range(2):
                    toks = torch.randint(0, cfg.vocab_size, (4, 33), generator=gb, device=dev)
                    state, _ = step(state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
            states.append(state)
        a, b = states
        for name, p in a.params.named_parameters():
            q = dict(b.params.named_parameters())[name]
            for what, x, y in (("param", p, q), ("m", a.opt.m[name], b.opt.m[name]),
                               ("v", a.opt.v[name], b.opt.v[name]),
                               ("residual", a.ef_residual[name], b.ef_residual[name])):
                if not torch.equal(x, y):
                    raise AssertionError(f"int8_ef on the (1, 1, 1) mesh: {what} {name} differs")
        print(f"[nccl] int8_ef train step on a (1, 1, 1) pod mesh == one device bit for bit "
              f"(2 steps, {len(a.opt.m)} leaves: parameters, m, v, residuals)")
    finally:
        dist.destroy_process_group()
    print(json.dumps({"ok": True, "launches": dict(ops.launches)}))
    return 0


def dryrun_table(out_dir: str) -> int:
    """``--dryrun-table DIR`` (not part of the smoke): the dry run of every
    (arch x shape x mesh) cell, ``launch.dryrun --arch A --both-meshes`` a
    child an arch, all at once; each child's rows in DIR/A.json, and one
    line a row here."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing to test", file=sys.stderr)
        return 2
    from repro_torch.launch.dryrun import LM_ARCHS

    os.makedirs(out_dir, exist_ok=True)
    smi = nvidia_smi_line()
    cmds = {a: [sys.executable, "-m", "repro_torch.launch.dryrun", "--device", "cuda",
                "--arch", a, "--both-meshes", "--no-analyze",
                "--out", os.path.join(out_dir, f"{a}.json")] for a in LM_ARCHS}
    results = _children(cmds, timeout=1800)
    print(smi)
    print("arch | shape | mesh | status | seconds | argument GB | temp GB | collectives | "
          "collective GB | flops")
    failed = 0
    for a in LM_ARCHS:
        rc, stdout, stderr, _ = results[a]
        if rc != 0:
            print(f"{a}: exited {rc}: {stderr[-1500:]}")
            failed += 1
            continue
        with open(os.path.join(out_dir, f"{a}.json")) as f:
            for row in json.load(f):
                mesh = "2x16x16" if row["multi_pod"] else "16x16"
                if row["status"] != "ok":
                    why = row.get("reason") or row.get("error", "")
                    print(f"{a} | {row['shape']} | {mesh} | {row['status']} | "
                          f"{row['seconds']} | {why[:100]}")
                    failed += row["status"] == "error"
                    continue
                mem, coll = row["memory"], row["collectives"]
                print(f"{a} | {row['shape']} | {mesh} | ok | {row['seconds']} | "
                      f"{mem['argument_bytes'] / 1e9:.3f} | {mem['temp_bytes'] / 1e9:.3f} | "
                      f"{sum(coll['counts'].values())} | "
                      f"{sum(coll['bytes_once'].values()) / 1e9:.3f} | "
                      f"{row['xla_cost']['flops_body_once']:.4g}")
    print(f"[dryrun table] {failed} cells failed; "
          f"{max(r[3] for r in results.values()):.1f} s of wall time")
    return 1 if failed else 0


def lm_mesh_phase(smi: str) -> dict:
    """Phase 12: the LM over a device mesh (plain PyTorch: none of #1-#8).
    12a's children and 12c's run at once; 12b's after them, one at a time,
    so that their step times have the host to themselves.  Every piece of
    the phase runs in a child, which counts its own kernel launches from 0;
    returns their sum."""
    from repro_torch.kernels import ops

    torch.cuda.empty_cache()  # the earlier phases' cached blocks, for the children
    launches = dict.fromkeys(ops.launches, 0)
    nccl = [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-worker", "nccl"]
    rows, extra = mesh_dryrun(smi, {"nccl": nccl}, launches)
    rc, stdout, stderr, done_s = extra["nccl"]
    if rc != 0:
        raise AssertionError(f"the NCCL child exited {rc}:\n{stderr[-3000:]}")
    for name, n in _child_launches(stdout).items():
        launches[name] += n
    print("\n".join(line for line in stdout.splitlines() if line.startswith("[nccl]")))
    print(f"[nccl] {done_s:.1f} s")
    mesh_rank0(rows, smi, launches)
    return launches


def main(argv: list[str]) -> int:
    if "--kill-worker" in argv:
        return kill_worker(argv[argv.index("--kill-worker") + 1])
    if "--train-worker" in argv:
        at = argv.index("--train-worker")
        return train_worker(argv[at + 1], argv[at + 2])
    if "--dryrun-table" in argv:
        return dryrun_table(argv[argv.index("--dryrun-table") + 1])
    if "--mesh-worker" in argv:
        at = argv.index("--mesh-worker")
        if argv[at + 1] == "dryrun":
            return mesh_worker_dryrun(argv[at + 2:])
        if argv[at + 1] == "rank0":
            return mesh_worker_rank0(*argv[at + 2:at + 4])
        return mesh_worker_nccl()
    quick = "--quick" in argv
    profile = "--profile" in argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing to test", file=sys.stderr)
        return 2
    from repro_torch.core import ising, reorder
    from repro_torch.kernels import _build, ops, ref

    t_start = time.perf_counter()
    dev = torch.device("cuda:0")
    if ops.COLORED_WARP_GROUPS != CB_WARP_GROUPS[-1]:
        raise AssertionError(f"CB_WARP_GROUPS {CB_WARP_GROUPS} must end in the wrappers' "
                             f"default, {ops.COLORED_WARP_GROUPS}")
    # -- 1. environment ----------------------------------------------------
    smi = nvidia_smi_line()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}")
    print(smi)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.build(list(KERNELS) + list(CHECK_ENTRIES))
    print(f"[build] {', '.join(f'{k}.cu' for k in (*KERNELS, *CHECK_ENTRIES))} in "
          f"{time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)")
    for name in (*KERNELS, *CHECK_ENTRIES):
        print(f"[ptxas {name}] {ptxas_summary(_build.ptxas_report(name))}")
    for what, n in (("the serving shape", MAIN_N), ("two generator blocks a sweep", 320)):
        m = ising.random_layered_model(n=n, L=MAIN_L, seed=0, beta=1.1)
        rows, C = n * MAIN_L // LANES, len(reorder.colored_classes(m, LANES))
        nbytes, u_smem = ops.colored_smem_plan(rows, m.space_degree, C)
        print(f"[smem colored] {what}: rows={rows} sd={m.space_degree} C={C}: {nbytes:,} B of "
              f"dynamic shared memory a CTA, uniforms in "
              f"{'shared memory' if u_smem else 'device-memory scratch'}")

    # -- 3. kernel vs plain, on the card -----------------------------------
    phase_s = {"environment, build": time.perf_counter() - t_start}  # phase -> seconds
    t_phase = time.perf_counter()

    def end_phase(what: str) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        phase_s[what], t_phase = now - t_phase, now

    err = dict.fromkeys(KERNELS, 0.0)
    err["colored_multisweep"], err["colored_multisweep_multi"] = check_colored(dev)

    (err["metropolis_multisweep"], err["metropolis_multisweep_multi"],
     err["metropolis_sweep"]) = check_a4(dev)
    main_case = a4_case(MAIN_N, MAIN_L, MAIN_SLOTS, dev)
    err["mt_next_block"] = check_mt(dev)
    err["fastexp_2d"] = check_fastexp(dev)
    check_fastexp_exhaustive(dev)
    err["pt_swap"] = check_pt_swap(dev)
    end_phase("checks")
    for name, e in check_flavours(dev).items():
        err[name] = max(err[name], e)
    check_sweep_exp_exhaustive(dev)
    end_phase("flavour checks")
    if quick:
        print(f"quick checks passed in {time.perf_counter() - t_start:.1f} s")
        return 0

    # -- 4. the serving paths, through the CLI entry point -----------------
    cb_report, cb_launches = serve_checked("cb")
    a4_report, a4_launches = serve_checked("a4")

    # -- 5. multi-tenant serving ---------------------------------------------
    multi_served = {rung: serve_multi_checked(rung) for rung in ("cb", "a4")}

    # -- 6. the per-sweep path ---------------------------------------------
    ops.reset_launches()
    per_sweep_out = main_case.per_sweep(main_case.inputs, MAIN_CHUNK)
    ps_launches = dict(ops.launches)
    assert_same(per_sweep_out, main_case.fused(main_case.inputs, MAIN_CHUNK), "per-sweep vs fused")
    for name in ("metropolis_sweep", "mt_next_block"):
        if ps_launches[name] != MAIN_CHUNK:
            raise AssertionError(f"per-sweep path: {ps_launches}, want {MAIN_CHUNK} {name} launches")
    print(f"[per-sweep] B={MAIN_SLOTS} {MAIN_CHUNK} sweeps: {ps_launches['mt_next_block']} "
          f"mt_next_block + {ps_launches['metropolis_sweep']} metropolis_sweep launches; "
          f"carry == the fused kernel's (bit-equal)")

    end_phase("serving, per-sweep path")
    # -- 6b. parallel tempering: standalone, served, multi-tenant, the CLI ----
    pt_runs = pt_standalone(dev)
    pt_served(pt_runs)
    pt_multi_tenant()
    pt_cli()
    end_phase("parallel tempering")
    # -- 6c. recovery and the stream -----------------------------------------
    rec_launches = recovery_and_stream(smi)
    end_phase("recovery and stream")
    # -- 6d. the slot mesh: four logical devices on the card -------------------
    rec_launches["mesh"] = mesh_phase(dev, smi, cb_report)
    for name in SWEEP_KERNELS[:4]:
        if rec_launches["mesh"][name] == 0:
            raise AssertionError(f"the mesh drains never launched {name}")
    end_phase("mesh")
    # -- 6e. the examples on the card ------------------------------------------
    rec_launches["examples"] = examples_phase()
    end_phase("examples")
    # -- 7. timings (CUDA events) ------------------------------------------
    sd = main_case.m.space_degree
    times = {name: {} for name in SWEEP_KERNELS}  # name -> B -> (ms, plain ms, bound)
    cb_w_times = {}  # (W, B) -> (#1 ms, #2 ms) at the other warp-group counts
    for B in (MAIN_SLOTS, 115):
        mB, rowsB, kB, pB, inB = colored_case(MAIN_N, MAIN_L, B, dev, seed=B)
        times["colored_multisweep"][B] = (
            cuda_ms(lambda: kB(*inB, 8), reps=20), cuda_ms(lambda: pB(*inB, 8), reps=3, warmup=1),
            bound(colored_counts(B, rowsB, sd, 8), B))
        c = main_case if B == MAIN_SLOTS else a4_case(MAIN_N, MAIN_L, B, dev, seed=B)
        times["metropolis_multisweep"][B] = (
            cuda_ms(lambda: c.fused(c.inputs, 8), reps=20),
            cuda_ms(lambda: c.plain(c.inputs, 8), reps=1, warmup=1),
            bound(a4_counts(B, c.rows, sd, 8), B))
        # #5 and #6 on the card alone: their launches are about as short
        # as their wrappers' host time.
        times["metropolis_sweep"][B] = (
            cuda_ms_queued(lambda: c.sweep(c.inputs, c.uniforms), reps=50),
            cuda_ms(lambda: c.sweep_plain(c.inputs, c.uniforms), reps=2, warmup=1),
            bound(sweep_counts(B, c.rows, sd), B))
        state = c.inputs[3]
        times["mt_next_block"][B] = (
            cuda_ms_queued(lambda: ops.mt_uniforms(state), reps=50),
            cuda_ms(lambda: ref.mt_uniforms_ref(state), reps=10),
            bound(mt_counts(B * LANES, uniforms=True)))
        t_words = cuda_ms_queued(lambda: ops.mt_next_block(state), reps=50)
        for rung, extra in (("cb", 2), ("a4", 1)):
            mc = multi_case(rung, MAIN_N, MAIN_L, B, dev, seed=B)
            sd_m = mc.m.space_degree
            counts = (colored_counts if rung == "cb" else a4_counts)(B, mc.rows, sd_m, 8)
            times[MULTI_KERNEL[rung]][B] = (
                cuda_ms(lambda: mc.kernel(mc.inputs, 8), reps=20),
                cuda_ms(lambda: mc.plain(mc.inputs, 8), reps=3 if rung == "cb" else 1, warmup=1),
                bound(with_tables(counts, B, MAIN_N, sd_m + extra), B))
            if rung == "cb":
                mc_cb = mc
        # #1 and #2 at the other warp-group counts (same inputs).
        for W in CB_WARP_GROUPS[:-1]:
            with warp_groups(W):
                cb_w_times[W, B] = (cuda_ms(lambda: kB(*inB, 8), reps=20),
                                    cuda_ms(lambda: mc_cb.kernel(mc_cb.inputs, 8), reps=20))
        for name in SWEEP_KERNELS:
            t_k, t_p, (b_ms, b_by, occ_ms) = times[name][B]
            occ = "" if occ_ms is None else f", one-CTA-per-replica bound {occ_ms:.5f} ms"
            if name in ("metropolis_multisweep", "metropolis_multisweep_multi"):
                occ += f", row-chain bound {a4_chain_ms(2 * MAIN_N, 8):.5f} ms"
            print(f"[time {name}] B={B} n={MAIN_N} L={MAIN_L}: kernel {t_k:.4f} ms/launch, "
                  f"plain {t_p:.4f} ms, bound {b_ms:.5f} ms ({b_by}){occ}")
        for W in CB_WARP_GROUPS[:-1]:
            print(f"[time colored W={W}] B={B}: colored_multisweep "
                  f"{cb_w_times[W, B][0]:.4f} ms, colored_multisweep_multi "
                  f"{cb_w_times[W, B][1]:.4f} ms (W={CB_WARP_GROUPS[-1]}: "
                  f"{times['colored_multisweep'][B][0]:.4f} / "
                  f"{times['colored_multisweep_multi'][B][0]:.4f} ms)")
        print(f"[time mt_next_block] B={B}: (624, {B * LANES}) uniforms {times['mt_next_block'][B][0]:.4f}"
              f" ms, tempered words {t_words:.4f} ms (bound {bound(mt_counts(B * LANES, False))[0]:.5f} ms)"
              f", card alone")
    # Where a colored launch's time goes, B=8, at each warp-group count,
    # timed on the card alone (a 0-sweep launch is shorter than its
    # wrapper's host time): fixed cost (0 sweeps), per-sweep cost (1 vs 8
    # sweeps), and its split between the generator (the twist does not
    # depend on rows) and the class walk with the tempering of the rows'
    # uniforms (linear in rows; rows 96/192/288 all keep their uniforms in
    # shared memory).
    split_cases = {n_s: colored_case(n_s, MAIN_L, MAIN_SLOTS, dev, seed=n_s)
                   for n_s in (48, MAIN_N, 144)}
    for W in CB_WARP_GROUPS:
        split = {}
        with warp_groups(W):
            for n_s, (_, rowsS, kS, _, inS) in split_cases.items():
                for S in ((0, 1, 8) if n_s == MAIN_N else (8,)):
                    split[rowsS, S] = cuda_ms_queued(lambda: kS(*inS, S), reps=20)
        rows_m = 2 * MAIN_N
        per_sweep = (split[rows_m, 8] - split[rows_m, 1]) / 7
        per_row = (split[288, 8] - split[96, 8]) / (288 - 96) / 8
        print(f"[split cb] W={W} B={MAIN_SLOTS} rows={rows_m} (card alone): launch "
              f"{split[rows_m, 0]:.4f} ms at 0 sweeps (fixed cost), {split[rows_m, 1]:.4f} ms at 1, "
              f"{per_sweep:.4f} ms per sweep = {per_row * rows_m:.4f} ms class walk and "
              f"tempering ({per_row * 1e6:.1f} ns/row) + {per_sweep - per_row * rows_m:.4f} ms "
              f"twist; 8-sweep launch at rows 96/192/288: {split[96, 8]:.4f}/"
              f"{split[rows_m, 8]:.4f}/{split[288, 8]:.4f} ms")
    # Where an a4 launch's time goes, B=8, on the card alone (a 0-sweep
    # launch is shorter than its wrapper's host time): #3's fixed cost (0
    # sweeps) and per-sweep cost (1 vs 8 sweeps).  The row walk from the
    # walker alone: #5 (one sweep on given uniforms, no generator) at rows
    # 96 vs 192 (lpv=2, fields in shared memory), less the growth of the
    # fixed cost (#3 at 0 sweeps, same rows).  The generator from #3 at
    # rows 32, where the walk is shorter than a block's twist, so each
    # sweep waits on the generator.  rows=384 keeps the fields in device
    # memory.
    split_cases = {n_s: main_case if n_s == MAIN_N else a4_case(n_s, MAIN_L, MAIN_SLOTS, dev,
                                                                 seed=n_s)
                   for n_s in (16, 48, MAIN_N, 192)}
    split = {}
    for n_s, c in split_cases.items():
        for S in ((0, 8) if n_s == 48 else (0, 1, 8) if n_s in (16, MAIN_N) else (8,)):
            split[c.rows, S] = cuda_ms_queued(lambda: c.fused(c.inputs, S), reps=10)
        if n_s in (48, MAIN_N):
            split[c.rows, "walk"] = cuda_ms_queued(lambda: c.sweep(c.inputs, c.uniforms), reps=20)
    rows_m = 2 * MAIN_N
    per_sweep = (split[rows_m, 8] - split[rows_m, 1]) / 7
    per_row = ((split[rows_m, "walk"] - split[96, "walk"])
               - (split[rows_m, 0] - split[96, 0])) / (rows_m - 96)
    gen = (split[32, 8] - split[32, 1]) / 7
    print(f"[split a4] B={MAIN_SLOTS} rows={rows_m} (card alone): launch {split[rows_m, 0]:.4f} ms "
          f"at 0 sweeps (fixed cost), {split[rows_m, 1]:.4f} ms at 1, {per_sweep:.4f} ms per sweep "
          f"= {per_row * rows_m:.4f} ms row walk ({per_row * 1e3:.4f} us/row, the walker alone) + "
          f"{per_sweep - per_row * rows_m:.4f} ms the generator and sweep barrier add; generator "
          f"{gen:.4f} ms per sweep (rows 32, walk {per_row * 32:.4f} ms); 8-sweep launch at rows "
          f"96/192: {split[96, 8]:.4f}/{split[rows_m, 8]:.4f} ms, at rows 384 (fields in device "
          f"memory): {split[384, 8]:.4f} ms")
    # Launch structure (the reference's launch_structure_compare): one
    # fused launch of 8 sweeps against, per sweep, the block kernel and one
    # sweep launch; both must end in the same carry.  Timed back to back
    # (the host's rate where it is the slower) and on the card alone.
    for B in (1, MAIN_SLOTS, 115):
        c = a4_case(MAIN_N, MAIN_L, B, dev, seed=100 + B)
        assert_same(c.per_sweep(c.inputs, 8), c.fused(c.inputs, 8), f"launch structure B={B}")
        t_f = cuda_ms(lambda: c.fused(c.inputs, 8), reps=10)
        t_s = cuda_ms(lambda: c.per_sweep(c.inputs, 8), reps=10)
        q_f = cuda_ms_queued(lambda: c.fused(c.inputs, 8), reps=10)
        q_s = cuda_ms_queued(lambda: c.per_sweep(c.inputs, 8), reps=3)
        print(f"[launch structure] B={B} n={MAIN_N} L={MAIN_L} 8 sweeps: fused {t_f * 1e3 / 8:.2f} "
              f"us/sweep, per-sweep {t_s * 1e3 / 8:.2f} us/sweep ({t_s / t_f:.3f}x); card alone: "
              f"fused {q_f * 1e3 / 8:.2f}, per-sweep {q_s * 1e3 / 8:.2f} us/sweep "
              f"({q_s / q_f:.3f}x); same carry")
    # Sweep order (the reference's colored_vs_sequential), B=8.
    us_a4 = times["metropolis_multisweep"][MAIN_SLOTS][0] * 1e3 / 8
    us_cb = times["colored_multisweep"][MAIN_SLOTS][0] * 1e3 / 8
    print(f"[sweep order] B={MAIN_SLOTS} n={MAIN_N} L={MAIN_L}: a4 {us_a4:.2f} us/sweep, "
          f"cb {us_cb:.2f} us/sweep (cb/a4 speed {us_a4 / us_cb:.3f}x)")
    # #1 and #3 on the other exps, 8-sweep launches (the same inputs' shapes
    # as the "fast" times above).
    flavour_ms = {}  # (flavor, B) -> (#1 ms, #3 ms)
    for B in (MAIN_SLOTS, 115):
        for flavor in OTHER_FLAVOURS:
            _, _, kF, _, inF = colored_case(MAIN_N, MAIN_L, B, dev, B, flavor)
            cF = a4_case(MAIN_N, MAIN_L, B, dev, B, flavor)
            flavour_ms[flavor, B] = (cuda_ms(lambda: kF(*inF, 8), reps=20),
                                     cuda_ms(lambda: cF.fused(cF.inputs, 8), reps=20))
        t1, t3 = times["colored_multisweep"][B][0], times["metropolis_multisweep"][B][0]
        print(f"[time flavours] B={B} n={MAIN_N} L={MAIN_L}, 8-sweep launches: "
              f"colored_multisweep fast {t1:.4f} / "
              + " / ".join(f"{f} {flavour_ms[f, B][0]:.4f}" for f in OTHER_FLAVOURS)
              + f" ms; metropolis_multisweep fast {t3:.4f} / "
              + " / ".join(f"{f} {flavour_ms[f, B][1]:.4f}" for f in OTHER_FLAVOURS)
              + f" ms; {smi}")
    time_pt(smi)
    swap_time = time_pt_swap(dev)
    print(f"[time pt_swap] R={PT_R} rows scattered in {PT_R} slots, n={MAIN_N} L={MAIN_L}: "
          f"kernel {swap_time[0]:.5f} ms/call (card alone), plain {swap_time[1]:.4f} ms, bound "
          f"{swap_time[2][0]:.5f} ms ({swap_time[2][1]}); {smi}")

    end_phase("timings")
    # -- 8. the exp path and its timings -------------------------------------
    exp_launches, exp_err = fastexp_path(dev)
    err["fastexp_2d"] = max(err["fastexp_2d"], exp_err)
    exp_times = time_fastexp(dev)
    end_phase("exp")

    # -- 9. the ladder's slower rungs (plain version) --------------------------
    ladder(dev)
    end_phase("ladder")

    # -- 10. the LM server ----------------------------------------------------
    lm_phase(dev, smi, profile)
    end_phase("LM server")
    # -- 10b. the other LM families -------------------------------------------
    ops.reset_launches()
    lm_families_phase(dev, smi, profile)
    if any(ops.launches.values()):
        raise AssertionError(f"the LM families launched {dict(ops.launches)}; they have no kernel")
    end_phase("LM families")
    # -- 11. LM training ------------------------------------------------------
    ops.reset_launches()
    train_phase(dev, smi, profile)
    if any(ops.launches.values()):
        raise AssertionError(f"LM training launched {dict(ops.launches)}; it has no kernel")
    print(f"[train] phase 11 launched none of #1-#8: {dict(ops.launches)}")
    end_phase("LM training")
    # -- 12. the LM over a device mesh ------------------------------------------
    ops.reset_launches()
    mesh_launches = lm_mesh_phase(smi)
    if any(ops.launches.values()) or any(mesh_launches.values()):
        raise AssertionError(f"phase 12 launched {mesh_launches} in its children, "
                             f"{dict(ops.launches)} here; it has no kernel")
    print(f"[mesh] phase 12 launched none of #1-#8 (its children's own counts, summed): "
          f"{mesh_launches}")
    end_phase("LM over a mesh")

    if profile:
        profile_serve("cb")
        profile_serve("a4")
        profile_serve("cb", multi=True)
        profile_serve("a4", multi=True)
    drains = [(rung, SERVE_KERNEL[rung], report.seconds, launches)
              for rung, report, launches in (("cb", cb_report, cb_launches),
                                             ("a4", a4_report, a4_launches))]
    drains += [(f"{rung} multi-tenant", MULTI_KERNEL[rung], seconds, launches)
               for rung, (_, seconds, launches) in multi_served.items()]
    for what, name, seconds, launches in drains:
        t_k = times[name][MAIN_SLOTS][0]
        # Launches of the serving run times the B=8 kernel time above
        # (chunks of 8 sweeps; shorter remainder chunks make this an upper
        # estimate).
        share = launches[name] * t_k * 1e-3 / seconds
        print(f"[serve {what}] kernel share of the drain's wall time <= {share:.3f} "
              f"({launches[name]} launches x {t_k:.4f} ms / {seconds:.3f} s)")
    if profile:
        end_phase("profile")
    print(f"[total] {time.perf_counter() - t_start:.1f} s: "
          + ", ".join(f"{what} {sec:.1f} s" for what, sec in phase_s.items()))
    main_launches = {
        "colored_multisweep": cb_launches["colored_multisweep"],
        "metropolis_multisweep": a4_launches["metropolis_multisweep"],
        "metropolis_sweep": ps_launches["metropolis_sweep"],
        "mt_next_block": ps_launches["mt_next_block"],
    }
    for rung, (_, _, launches) in multi_served.items():
        main_launches[MULTI_KERNEL[rung]] = launches[MULTI_KERNEL[rung]]
    print(smi)
    entries = []
    for name, replaces in KERNELS.items():
        extra = {}
        if name == "fastexp_2d":
            # The "fast" flavour at the paper's one-sweep size; "accurate" beside it.
            t_k, t_p, _, (b_ms, b_by, _), t_kd, t_expd = exp_times["fast", FASTEXP_MAIN]
            t_ka, t_pa, t_exp, (b_a, _, _), t_kad, _ = exp_times["accurate", FASTEXP_MAIN]
            main_launches[name] = exp_launches[name]
            extra = {"elements": FASTEXP_MAIN, "accurate_ms": t_ka, "accurate_plain_ms": t_pa,
                     "accurate_bound_ms": b_a, "torch_exp_ms": t_exp, "ms_l2_dirty": t_kd,
                     "accurate_ms_l2_dirty": t_kad, "torch_exp_ms_l2_dirty": t_expd}
        elif name == "pt_swap":
            # The paper's ladder; `launches` are the standalone cb ladder's.
            t_k, t_p, (b_ms, b_by, _) = swap_time
            main_launches[name] = pt_runs["cb", "fast"][2][name]
            extra = {"replicas": PT_R}
        else:
            t_k, t_p, (b_ms, b_by, _) = times[name][MAIN_SLOTS]
        if name in ("colored_multisweep", "metropolis_multisweep"):
            col = 0 if name == "colored_multisweep" else 1
            extra = {f"{f}_ms": flavour_ms[f, MAIN_SLOTS][col] for f in OTHER_FLAVOURS}
        entries.append({
            "name": name,
            "route": "cuda",
            "source": f"{CSRC}/{name}.cu",
            "replaces": replaces,
            "launches": main_launches[name],
            "max_abs_err": err[name],
            "bit_equal": err[name] == 0.0,
            "ms": t_k,
            "plain_ms": t_p,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
            **extra,
        })
        for key, counts in rec_launches.items():
            if counts[name]:
                entries[-1][f"{key}_launches"] = counts[name]
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
