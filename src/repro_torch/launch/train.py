"""End-to-end training entry point (the card by default, the CPU at smoke scale).

Wires every substrate layer together: config registry -> parameters ->
data pipeline (prefetch) -> train step -> checkpointing (periodic async +
emergency on preemption) -> straggler monitor -> auto-resume.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b --lr 3e-4   # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu --steps 20 \\
      --ckpt-dir /tmp/ckpt

The flags are the reference's, plus ``--device``.  One device trains:
``--data`` / ``--model`` other than 1 are refused (meshes over several
devices are not ported yet), and every parameter's partition spec on the
1x1 mesh is replicated, so nothing is placed.  Without ``--smoke`` the
arch's full config trains.  The checkpoints are the reference's format
(each package resumes the other's).

One repair against the reference: after a preemption the reference also
writes the preempted state as the final step (``--steps``), so a restart
resumes from a step that was never reached; here the emergency
checkpoint is the last one written.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import PrefetchIterator, SyntheticLMDataset
from repro_torch.models import decoder, encdec
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.ft import PreemptionHandler, StepTimer, StragglerMonitor
from repro_torch.sharding import ShardingCtx, use_ctx
from repro_torch.train.step import TrainConfig, init_train_state, make_train_step


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--data", type=int, default=1, help="data-parallel size")
    ap.add_argument("--model", type=int, default=1, help="model-parallel size")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.data != 1 or args.model != 1:
        raise ValueError(f"--data {args.data} --model {args.model}: the port trains on one "
                         f"device; a mesh over several devices is not ported yet")
    return args


def main(argv=None):
    """Train; returns the losses of the steps run (resumed steps excluded)."""
    args = parse_args(argv)
    cfg = get_config(args.arch, smoke=args.smoke)
    device = torch.device(args.device)
    ctx = ShardingCtx({"data": args.data, "model": args.model})
    tc = TrainConfig(
        optimizer=AdamWConfig(
            lr=args.lr, warmup_steps=args.warmup, total_steps=max(args.steps, 10)
        ),
        grad_accum=args.grad_accum,
    )

    init_fn = encdec.init_params if cfg.encdec else decoder.init_params
    with use_ctx(ctx):
        params = init_fn(torch.Generator(device=device).manual_seed(args.seed), cfg, device)
        state = init_train_state(params, tc)

        extra = {}
        if cfg.encdec:
            extra["frames"] = (cfg.enc_seq, cfg.d_model)
        if cfg.vlm_patches:
            extra["visual_embeds"] = (cfg.vlm_patches, cfg.d_model)
        ds = SyntheticLMDataset(
            vocab_size=cfg.vocab_size,
            seq_len=args.seq_len,
            global_batch=args.batch,
            seed=args.seed,
            extra_specs=extra,
        )

        mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
        start_step = 0
        if mgr is not None:
            latest, restored, _ = mgr.restore_latest(state)
            if latest is not None:
                state, start_step = restored, latest
                print(f"resumed from checkpoint step {latest}")

        it = PrefetchIterator(ds, start_step=start_step)
        step_fn = make_train_step(cfg, tc)
        preempt = PreemptionHandler()
        monitor = StragglerMonitor()

        losses = []
        preempted = False
        try:
            for step in range(start_step, args.steps):
                batch = {k: torch.from_numpy(v).to(device) for k, v in next(it).items()}
                with StepTimer(monitor, step) as t:
                    state, metrics = step_fn(state, batch)
                    loss = float(metrics["loss"])
                losses.append(loss)
                flag = " STRAGGLER" if t.is_straggler else ""
                print(
                    f"step {step:5d} loss {loss:8.4f} gnorm "
                    f"{float(metrics['grad_norm']):8.3f} {t.seconds*1e3:7.1f}ms{flag}",
                    flush=True,
                )
                if mgr is not None and (step + 1) % args.ckpt_every == 0:
                    mgr.save(step + 1, state, blocking=False, extra=it.state())
                if preempt.should_exit:
                    preempted = True
                    if mgr is not None:
                        print("preemption: writing emergency checkpoint")
                        mgr.save(step + 1, state, blocking=True, extra=it.state())
                    break
            if mgr is not None:
                mgr.wait()
                if not preempted:
                    mgr.save(args.steps, state, blocking=True, extra=it.state())
        finally:
            it.close()
            preempt.uninstall()
        if monitor.flagged:
            print(f"straggler events: {monitor.flagged}")
        if losses:
            print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
        else:
            print(f"nothing to train: the checkpoint is at step {start_step}")
        return losses


if __name__ == "__main__":
    main()
