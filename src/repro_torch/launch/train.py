"""Training launcher — the port of `repro/launch/train.py`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_5_3b \
        --steps 100 --batch 8 --seq 256 --reduced --ckpt-dir /tmp/run \
        [--device cpu]

Wires together: config -> parameters (drawn from seed 0; fp32 with
--reduced, bf16 otherwise) and AdamW state -> `make_train_step`
(gradient-accumulation microbatches) -> the resumable `TokenPipeline`
-> `CheckpointManager` (async, atomic, retention) -> `StepWatchdog`
(straggler detection). On restart it resumes from the latest checkpoint,
exact to the pipeline cursor. It runs on the card unless --device names
another device. JAX's --compress and --mesh come with the distribution
slice.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch, get_reduced
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.device import resolve
from repro_torch.distributed.elastic import StepWatchdog
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig, adamw_init


def main(argv=None):
    """Run the training loop; returns the last step's loss."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_arch(args.arch)
    dev = resolve(args.device)
    oc = AdamWConfig(lr=args.lr, moment_dtype=cfg.opt_dtype,
                     total_steps=args.steps)
    dtype = torch.float32 if args.reduced else torch.bfloat16
    params = lm.init_params(cfg, 0, dtype, dev)
    opt = adamw_init(params, oc)
    step_fn = make_train_step(cfg, oc, microbatches=args.microbatches,
                              device=dev)
    pipe = TokenPipeline(cfg.vocab_size, args.seq, args.batch, seed=0)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if mgr and mgr.latest_step() is not None:
        restored, aux = mgr.restore({"params": params.state_dict(),
                                     "opt": opt})
        params.load_state_dict(restored["params"])
        opt = restored["opt"]
        pipe.load_state_dict({k: aux[k] for k in ("seed", "step")})
        start = int(aux["step_counter"])
        print(f"[resume] from step {start}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    wd = StepWatchdog()
    metrics = None
    for step in range(start, args.steps):
        wd.start()
        params, opt, metrics = step_fn(params, opt, pipe.next_batch())
        sync()                           # the step's time is the device's
        info = wd.stop()
        if info["evict"]:
            print(f"[watchdog] persistent straggler at step {step} — "
                  "elastic remesh would trigger here")
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step}: loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"({info['step_s']:.2f}s)", flush=True)
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, {"params": params.state_dict(), "opt": opt},
                     aux={**pipe.state_dict(), "step_counter": step + 1},
                     async_=True)
    if mgr:
        mgr.save(args.steps, {"params": params.state_dict(), "opt": opt},
                 aux={**pipe.state_dict(), "step_counter": args.steps})
        mgr.wait()
    return None if metrics is None else float(metrics["loss"])


if __name__ == "__main__":
    main()
