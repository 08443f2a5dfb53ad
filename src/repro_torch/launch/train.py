"""Training launcher of the port (the port of repro/launch/train.py):
--arch <id> at smoke size, with checkpoint/restart, preemption handling
(SIGTERM -> final checkpoint -> clean exit), straggler detection (a
slow-step line) and optional DDP with int8 gradient compression.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \
        --steps 100 --ckpt DIR [--ckpt-every 50] [--ddp [--compress]] \
        [--device cpu]

It always takes the smoke config, as the reference's launcher does, and
seeds the weights from 0. It runs on the card unless ``--device cpu`` is
given. ``--ddp`` splits each batch over the ("data",) grid of the
visible devices (``train_step.ddp_grid``): every card, one replica each,
or REPRO_TEST_DEVICES=N logical devices of one. Checkpoints go through checkpoint/manager.py (the state's
parameters by name, the optimizer state and the residuals); a run
started again with the same ``--ckpt`` resumes from its latest step and
skips the batches that step consumed, so its losses are those of a run
that was never stopped (the reference's launcher restarts its data
stream instead). It prints every step's loss (the reference's, every
tenth).
"""
from __future__ import annotations

import argparse
import signal
import sys
import time


def main(argv=None) -> int:
    import numpy as np
    import torch

    from ..checkpoint.manager import CheckpointManager
    from ..configs import ARCH_IDS, get_config
    from ..core.detector import resolve_device
    from ..data.lm_data import LMDataConfig, batches
    from ..launch.mesh import visible_devices
    from ..train.optimizer import OptConfig
    from ..train.train_step import (init_ddp_state, init_train_state,
                                    load_state_tree, make_ddp_train_step,
                                    make_train_step, state_tree)

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    # the smoke config is always taken; ``--smoke`` is accepted and
    # ignored only so the reference's documented command line runs as is
    ap.add_argument("--smoke", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ddp", action="store_true",
                    help="data-parallel over the device grid")
    ap.add_argument("--compress", action="store_true",
                    help="int8 gradient compression (with --ddp)")
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=True)
    print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.2f}M "
          f"devices={len(visible_devices(dev))} device={dev}", flush=True)
    opt = OptConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps)
    gen = torch.Generator(device=dev).manual_seed(0)
    if args.ddp:
        state = init_ddp_state(cfg, gen, dev)
        step_fn = make_ddp_train_step(cfg, opt, compress=args.compress)
    else:
        state = init_train_state(cfg, gen, dev)
        step_fn = make_train_step(cfg, opt)

    mgr = CheckpointManager(args.ckpt) if args.ckpt else None
    start = 0
    if mgr is not None and mgr.latest_step() is not None:
        start = mgr.latest_step()
        state = load_state_tree(state, mgr.restore(start, state_tree(state),
                                                   dev))
        print(f"resumed from step {start}", flush=True)

    stop = {"now": False}

    def _sigterm(signum, frame):   # preemption: checkpoint + exit
        print("SIGTERM: writing final checkpoint", flush=True)
        stop["now"] = True
    signal.signal(signal.SIGTERM, _sigterm)

    data = batches(LMDataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                batch=args.batch))
    for _ in range(start):             # the batches the resumed steps took
        next(data)
    step_times = []
    for step in range(start, args.steps):
        batch = dict(next(data))
        B, S = batch["tokens"].shape
        if cfg.mrope:
            batch["positions"] = np.broadcast_to(
                np.arange(S, dtype=np.int32)[None, :, None], (B, S, 3))
        if cfg.encoder_layers:
            batch["enc_input"] = np.zeros((B, cfg.encoder_ctx, cfg.d_model),
                                          np.float32)
        t0 = time.time()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])          # waits for the step
        dt = time.time() - t0
        step_times.append(dt)
        med = float(np.median(step_times[-20:]))
        if len(step_times) > 5 and dt > args.straggler_factor * med:
            print(f"[straggler] step {step}: {dt:.2f}s vs median "
                  f"{med:.2f}s -- at pod scale this triggers re-slicing",
                  flush=True)
        print(f"step {step + 1:4d} loss {loss:.6f} "
              f"({B * S / dt:,.0f} tok/s)", flush=True)
        if mgr is not None and ((step + 1) % args.ckpt_every == 0
                                or stop["now"]):
            mgr.save_async(step + 1, state_tree(state))
        if stop["now"]:
            if mgr is not None:
                mgr.wait()
            return 0
    if mgr is not None:
        mgr.wait()
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
