"""Training launcher — the port of `repro/launch/train.py`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_5_3b \
        --steps 100 --batch 8 --seq 256 --reduced --ckpt-dir /tmp/run \
        [--compress int8] [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch deepseek_moe_16b --reduced --device cpu --mesh local \
        --compress int8 [--microbatches 2]

Wires together: config -> mesh (`--mesh local`: (1, world size) over
the live world, every rank on the model axis; `single` and `multi` the
production (16, 16) and (2, 16, 16) meshes, which need 256 and 512
ranks) and the attention layout JAX's `train.py` picks
(`sharding.attn_layout`: "heads" when the heads divide over 'model',
else "seq") -> parameters (drawn from seed 0 on every rank, each rank
keeping its held blocks, `lm.init_params(mesh=)`: JAX's `param_spec`
for every family, heads, d_ff, experts, vocab, the SSM's d_in and the
RG-LRU's width over 'model'; fp32 with --reduced, bf16 otherwise) and AdamW
state (the rank's ZeRO-1 blocks) -> `make_train_step` (gradient-
accumulation microbatches, `--microbatches`, on any mesh: each a block
of the global batch's rows, the fp32 sum reduced once a step; optional
gradient compression with error feedback; data, tensor and expert
parallelism under a mesh of more than one rank) -> the resumable
`TokenPipeline` (the global batch on every rank; the step takes the
rank's rows) -> `CheckpointManager` (async, atomic,
retention; JAX's layout, each rank its blocks) -> `StepWatchdog`
(straggler detection). On restart it resumes from the latest checkpoint
through `reshard_tree` onto whatever mesh is live, exact to the
pipeline cursor; a checkpoint that `repro.launch.train` wrote resumes
too. Under `torchrun` (RANK in the environment) the ranks join the world
the environment describes (`distributed.mesh.init_from_env`) and rank 0
logs. It runs on the card unless --device names another device.
"""
from __future__ import annotations

import argparse

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch, get_reduced
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.distributed import mesh as pg
from repro_torch.distributed.compression import ErrorFeedback
from repro_torch.distributed.context import mesh_context
from repro_torch.distributed.elastic import StepWatchdog, reshard_tree
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.launch.sharding import attn_layout
from repro_torch.launch.steps import (held_specs, init_opt_state,
                                      make_train_step)
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig


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
    ap.add_argument("--compress", choices=["none", "int8", "topk"],
                    default="none")
    ap.add_argument("--mesh", choices=["local", "single", "multi"],
                    default="local")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    started = pg.init_from_env(args.device)
    try:
        return _train(args)
    finally:
        if started:
            pg._GROUPS.clear()
            dist.destroy_process_group()


def _train(args):
    cfg = get_reduced(args.arch) if args.reduced else get_arch(args.arch)
    dev = pg.rank_device(args.device)
    mesh = {"local": make_local_mesh,
            "single": make_production_mesh,
            "multi": lambda: make_production_mesh(multi_pod=True)
            }[args.mesh]()
    lead = mesh.rank == 0
    oc = AdamWConfig(lr=args.lr, moment_dtype=cfg.opt_dtype,
                     total_steps=args.steps)
    dtype = torch.float32 if args.reduced else torch.bfloat16

    compressor = None
    if args.compress != "none":
        ef = ErrorFeedback(mode=args.compress)
        ef_state = {}

        def compressor(grads):
            if not ef_state:
                ef_state.update(ef.init(grads))
            out, new = ef.apply(grads, ef_state)
            ef_state.update(new)
            return out

    with mesh_context(mesh):
        layout = attn_layout(cfg, mesh.shape["model"])
        params = lm.init_params(cfg, 0, dtype, dev, mesh=mesh, layout=layout)
        opt = init_opt_state(params, oc, cfg, mesh, layout)
        specs = held_specs(params, cfg, mesh, layout)
        step_fn = make_train_step(cfg, oc, layout=layout,
                                  microbatches=args.microbatches,
                                  compressor=compressor, device=dev)
        pipe = TokenPipeline(cfg.vocab_size, args.seq, args.batch, seed=0)
        mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
        start = 0
        if mgr and mgr.latest_step() is not None:
            like = {"params": dict.fromkeys(specs["params"]),
                    "opt": {"mu": dict.fromkeys(specs["params"]),
                            "nu": dict.fromkeys(specs["params"]),
                            "step": None}}
            restored, aux = mgr.restore(like)
            params.load_state_dict(reshard_tree(
                restored["params"], cfg, mesh, "params", layout, dev))
            opt = reshard_tree(restored["opt"], cfg, mesh, "opt", layout,
                               dev)
            pipe.load_state_dict({k: aux[k] for k in ("seed", "step")})
            start = int(aux["step_counter"])
            if lead:
                print(f"[resume] from step {start}")

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        wd = StepWatchdog()
        metrics = None
        for step in range(start, args.steps):
            wd.start()
            params, opt, metrics = step_fn(params, opt, pipe.next_batch())
            sync()                       # the step's time is the device's
            info = wd.stop()
            if info["evict"] and lead:
                print(f"[watchdog] persistent straggler at step {step} — "
                      "elastic remesh would trigger here")
            if lead and (step % args.log_every == 0
                         or step == args.steps - 1):
                print(f"step {step}: loss={float(metrics['loss']):.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"lr={float(metrics['lr']):.2e} "
                      f"({info['step_s']:.2f}s)", flush=True)
            if mgr and (step + 1) % args.ckpt_every == 0:
                mgr.save(step + 1, {"params": params.state_dict(),
                                    "opt": opt},
                         aux={**pipe.state_dict(), "step_counter": step + 1},
                         async_=True, specs=specs, mesh=mesh)
        if mgr:
            mgr.save(args.steps, {"params": params.state_dict(), "opt": opt},
                     aux={**pipe.state_dict(), "step_counter": args.steps},
                     specs=specs, mesh=mesh)
            mgr.wait()
    return None if metrics is None else float(metrics["loss"])


if __name__ == "__main__":
    main()
