"""Multi-pod dry-run on torch's meta device — the twin of
`repro/launch/dryrun.py`: for every (architecture x input shape x mesh)
cell, one rank's step of the production mesh, run on meta tensors (no
allocation, nothing computed) under the op counter, recording what that
rank holds, does and puts on the wire.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_7b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

JAX lowers and compiles the whole SPMD program on 512 forced host
devices. The port runs eagerly, one process a rank, so the dry-run runs
ONE rank's program: the mesh is shape-only (`Mesh(shape, names,
rank=r)`, no process group), its collectives give their outputs' shapes
on meta (`distributed.mesh.ShapeGroup`), the kernels their launches'
outputs (`kernels.*`), and `launch.op_analysis.OpCounter` counts the
rank's flops, HBM bytes, collective bytes and memory. The rank is the
mesh's last (`RANK`): in the "seq" attention layout it holds the most
keys (PERF.md §7's imbalance), and the record names it. Its arguments
are its blocks of the parameters and moments, its rows of the batch and
its blocks of the caches (`launch.specs`).

The record keeps JAX's keys (`arch`, `shape`, `mesh`, `variant`,
`n_devices`, `layout`, `kind`, `seq_len`, `global_batch`, `analysis`,
`collectives`, `memory`, `status`) and adds `rank`, `kernel_calls` and
`trace_s` (the host seconds of the traced step, in the place of JAX's
`lower_s` and `compile_s`), `collective_calls`, `wire` (the step's
`distributed.mesh.tally`: calls and bytes a rank put in) and
`snn_rows_assumed`; `xla_cost_analysis` has no counterpart. A variant
the port cannot run stays an error record, as JAX's `run` writes one.
Artifacts go to `artifacts/dryrun_torch/`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, cells, get_arch
from repro_torch.core import distributed_engine as de
from repro_torch.distributed import mesh as pg
from repro_torch.distributed.context import Mesh, mesh_context
from repro_torch.launch import op_analysis, specs
from repro_torch.launch.sharding import attn_layout, local_slice
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.optim import AdamWConfig

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" \
    / "dryrun_torch"
RANK = -1          # the mesh's last rank


def production_mesh(multi_pod: bool, rank: int = RANK) -> Mesh:
    """The production mesh's shape-only twin, as seen by `rank` (the last
    by default): (data 16, model 16), or (pod 2, data 16, model 16)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape_mesh(shape, axes, rank)


def shape_mesh(shape, axes, rank: int = RANK) -> Mesh:
    n = 1
    for s in shape:
        n *= s
    return Mesh(shape, axes, rank=rank % n)


def count(step, args, arguments) -> dict:
    """Run `step(*args)` once under the op counter and a collective tally;
    `arguments` are the tensors the rank holds going in. Returns the
    counter's record, the tally (`wire`: {op: [calls, bytes put in]})
    and `trace_s`."""
    t0 = time.perf_counter()
    with pg.tally() as wire, op_analysis.OpCounter() as c:
        c.arguments(arguments)
        c.outputs(step(*args))
    rec = c.record()
    rec["wire"] = {k: v[:2] for k, v in sorted(wire.items())}
    rec["trace_s"] = round(time.perf_counter() - t0, 3)
    return rec


def lm_step(cfg, shape, oc: AdamWConfig, layout: str, mesh: Mesh,
            microbatches: int = 1, device="meta", seed: int = 0,
            dtype=torch.bfloat16):
    """(step, its arguments, the tensors the rank holds) of one cell's
    step for `mesh`'s rank, made under the context mesh: on meta the
    specs' stand-ins; on another device the rank's blocks of the
    parameters drawn from `seed` and seeded values of the other inputs
    (`specs.concretize`)."""
    from repro_torch.launch.steps import init_opt_state
    from repro_torch.models import lm
    meta = torch.device(device).type == "meta"
    params = specs.params_shapes(cfg, dtype, mesh, layout) if meta else \
        lm.init_params(cfg, seed, dtype, device, mesh=mesh, layout=layout)
    batch = specs.batch_shapes(cfg, shape)
    if not meta:
        batch = specs.concretize(batch, seed, device)
    held = specs.rank_batch(batch, cfg, mesh)
    if shape.kind == "train":
        opt = init_opt_state(params, oc, cfg, mesh, layout)
        step = make_train_step(cfg, oc, layout=layout,
                               microbatches=microbatches, device=device)
        return step, (params, opt, batch), (params, opt, held)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, layout=layout), (params, batch), \
            (params, held)
    cache = specs.cache_shapes(cfg, shape, dtype, mesh)
    if not meta:
        cache = specs.concretize(cache, seed, device)
    step = make_decode_step(cfg, layout=layout, max_len=shape.seq_len)
    return step, (params, batch["tokens"], cache, shape.seq_len - 1), \
        (params, held, cache)


def snn_step(cfg: de.SNNShardConfig, mesh: Mesh):
    """(step, arguments, held) of `make_snn_step` for the mesh's rank, on
    meta: its blocks of the state (`snn_shardings`) and the key."""
    shapes = de.snn_state_shapes(cfg, mesh)
    sh = de.snn_shardings(cfg, mesh)
    state = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
             [local_slice(sh[k], v.shape, mesh)].clone()
             for k, v in shapes.items()}
    key = torch.empty((2,), dtype=torch.int64, device="meta")
    return de.make_snn_step(cfg, mesh), (state, key), (state, key)


def lower_snn(multi_pod: bool, rank: int = RANK, cfg=None, mesh=None):
    """The paper's own full-scale config, 160 M neurons / 40 B synapses,
    hierarchically routed (`core/distributed_engine.py`): one rank's step
    on the production mesh (or `mesh`)."""
    cfg = de.SNNShardConfig() if cfg is None else cfg
    mesh = production_mesh(multi_pod, rank) if mesh is None else mesh
    step, args, held = snn_step(cfg, mesh)
    rec = count(step, args, held)
    n_loc = cfg.n_neurons // mesh.size
    return {
        "arch": "hiaer_snn_40b", "shape": "step_160M_40B",
        "mesh": "pod2x16x16" if multi_pod else "pod16x16",
        "variant": "baseline", "kind": "snn_step",
        "n_devices": mesh.size, "rank": mesh.rank,
        "n_neurons": cfg.n_neurons,
        "n_synapse_slots": cfg.fan_window_blocks * cfg.block * cfg.n_neurons,
        "n_loc": n_loc, "packed": n_loc % 32 == 0,
        "layout": "hiaer", "seq_len": 1, "global_batch": 1, **rec}


def lower_cell(arch_id: str, shape_name: str, multi_pod: bool,
               variant: str = "baseline", rank: int = RANK):
    """Dry-run one cell: returns the result record dict."""
    if arch_id == "hiaer_snn_40b":
        return lower_snn(multi_pod, rank)
    cfg = get_arch(arch_id)
    microbatches = 1
    if variant != "baseline":
        for v in variant.split("+"):
            if v.startswith("mb"):
                microbatches = int(v[2:])
        variant_cfg = "+".join(v for v in variant.split("+")
                               if not v.startswith("mb"))
        if variant_cfg:
            cfg = apply_variant(cfg, variant_cfg)
    shape = SHAPES[shape_name]
    mesh = production_mesh(multi_pod, rank)
    oc = AdamWConfig(moment_dtype=cfg.opt_dtype)
    with mesh_context(mesh):
        layout = attn_layout(cfg, mesh.shape["model"])
        step, args, held = lm_step(cfg, shape, oc, layout, mesh,
                                   microbatches)
        rec = count(step, args, held)
    return {
        "arch": arch_id, "shape": shape_name,
        "mesh": "pod2x16x16" if multi_pod else "pod16x16",
        "variant": variant, "n_devices": mesh.size, "rank": mesh.rank,
        "layout": layout, "kind": shape.kind,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch, **rec}


def apply_variant(cfg, variant: str):
    """JAX's named beyond-baseline variants (the same names)."""
    for v in variant.split("+"):
        if v == "hier_a2a" and cfg.moe is not None:
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, hierarchical_a2a=True))
        elif v == "sm_attn":
            cfg = dataclasses.replace(cfg, attn_impl="shardmap")
        elif v == "seqpar":
            cfg = dataclasses.replace(cfg, seq_parallel=True)
        elif v == "loss_chunk_2k":
            cfg = dataclasses.replace(cfg, loss_chunk=2048)
        elif v.startswith("capacity_"):
            f = float(v.split("_")[1])
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=f))
        elif v == "remat_dots":
            cfg = dataclasses.replace(cfg, remat_policy="dots")
        elif v.startswith("remat_"):
            cfg = dataclasses.replace(cfg, remat=v == "remat_on")
        else:
            raise ValueError(f"unknown variant {v}")
    return cfg


def run(arch_id, shape_name, multi_pod, out_dir: Path, variant="baseline",
        force=False):
    tag = "multi" if multi_pod else "single"
    name = f"{arch_id}__{shape_name}__{tag}"
    if variant != "baseline":
        name += f"__{variant}"
    path = out_dir / f"{name}.json"
    if path.exists() and not force:
        print(f"[skip] {name} (artifact exists)")
        return json.loads(path.read_text())
    print(f"[dryrun] {name} ...", flush=True)
    try:
        rec = lower_cell(arch_id, shape_name, multi_pod, variant)
        rec["status"] = "ok"
    except Exception as e:
        rec = {"arch": arch_id, "shape": shape_name, "mesh": tag,
               "variant": variant, "status": "error",
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
        print(f"[FAIL] {name}: {e}", flush=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=1))
    if rec["status"] == "ok":
        a, m = rec["analysis"], rec["memory"]
        print(f"[ok] {name}: rank {rec['rank']} trace={rec['trace_s']}s "
              f"flops={a['flops']:.3e} hbm={a['hbm_bytes_tight']:.3e} "
              f"coll={a['collective_bytes']:.3e} "
              f"args={m['argument_size_in_bytes'] / 2**30:.2f}GiB "
              f"temp={m['temp_size_in_bytes'] / 2**30:.2f}GiB", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(ARTIFACTS))
    args = ap.parse_args(argv)
    out_dir = Path(args.out)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        pairs = [(a, s.name) for a in ARCH_IDS for s in cells(a)]
        pairs.append(("hiaer_snn_40b", "step_160M_40B"))
    else:
        assert args.arch, "--arch required unless --all"
        if args.shape:
            pairs = [(args.arch, args.shape)]
        elif args.arch == "hiaer_snn_40b":
            pairs = [(args.arch, "step_160M_40B")]
        else:
            pairs = [(args.arch, s.name) for s in cells(args.arch)]
    n_ok = n_fail = 0
    for arch, shp in pairs:
        for mp in meshes:
            rec = run(arch, shp, mp, out_dir, variant=args.variant,
                      force=args.force)
            if rec.get("status") == "ok":
                n_ok += 1
            else:
                n_fail += 1
    print(f"dry-run complete: {n_ok} ok, {n_fail} failed")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
