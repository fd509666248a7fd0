"""Step-atomic checkpoints in the JAX package's on-disk layout — the port
of `repro/checkpoint/store.py`:

  * writes go to ``step_N.tmp/`` and are renamed to ``step_N/`` only
    after an fsync, so a failure mid-save never corrupts the latest
    restorable step;
  * one ``{key}.npy`` per whole leaf, or ``{key}.shard{i}.npy`` per
    block of a sharded one, each with its global index as a string
    (``"(slice(0, 4, None), slice(None, None, None))"``); keys are the
    "/"-joined paths of the tree, with "/" as "__" in file names; bf16
    leaves are stored as their raw bits (uint16), as JAX's `_BITCAST`
    does, since numpy has no bf16;
  * an ``index.json`` with each leaf's global shape, dtype name and
    file(s), and the caller's ``aux`` (the data pipeline's cursor, the
    step counter);
  * `CheckpointManager.save` copies the tree to the host, then writes it
    synchronously or in one background thread (at most one in flight),
    and keeps the newest `keep` steps.

`save_tree` and `restore_tree` take nested dicts as they are;
`restore_blocks` restores a rank's blocks of each leaf (of a save
sharded over any mesh, or whole) from the files that overlap them, never
assembling the whole leaf.
`CheckpointManager` stores the port's training state ({"params": state
dict, "opt": {"mu", "nu", "step"}}) in JAX's layout: state-dict names
become nested keys (`embed.table` -> `embed/table`) and a segment's
per-layer leaves (`blocks.3.attn.wq`; `dense_blocks`, `groups`, `tail`)
are stacked over the layers (`blocks/attn/wq`, (L, ...)), so either
package restores what the other saved. `restore_tree` reads both
layouts: a leaf of `like` named by a state-dict name is found under its
own key or as its layer of the stacked leaf.

Under a mesh of more than one rank each rank writes the blocks it is
the first to hold (`specs` give every leaf's spec over its global shape)
and rank 0 writes the whole leaves; each rank then leaves a marker file
named by the save's attempt, and rank 0, once every rank's marker of
this attempt is there, deletes whatever else the directory holds (what
an interrupted save of the same step left: its blocks, its markers),
writes the index and renames. The attempt is an id that rank 0 draws
and broadcasts over the mesh's process group before anything is
written, on the caller's thread (so an async save's writes need no
collective); a shape-only mesh, whose one process writes every rank's
blocks, takes it from the caller. The ranks share the file system.
"""
from __future__ import annotations

import json
import os
import re
import secrets
import shutil
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

SEGMENTS = ("blocks", "dense_blocks", "groups", "tail")
MARKER_TIMEOUT_S = 600.0


def _to_savable(t):
    """(numpy array, dtype name) on the host: a copy even on the CPU,
    where .cpu() would alias the live storage that the next step's
    in-place update overwrites under an async save."""
    if isinstance(t, tuple):
        return t
    if isinstance(t, np.ndarray):
        return t.copy(), t.dtype.name
    t = torch.as_tensor(t).detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:       # numpy has no bf16: the raw bits
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, arr.dtype.name


def _from_saved(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


_SLICE_RE = re.compile(r"slice\((\w+),\s*(\w+)(?:,\s*\w+)?\)")


def _parse_index(index_str: str, shape):
    """'(slice(0, 32, None), slice(None, None, None))' -> slice tuple."""
    slices = []
    for i, m in enumerate(_SLICE_RE.finditer(index_str)):
        a, b = m.group(1), m.group(2)
        slices.append(slice(None if a == "None" else int(a),
                            None if b == "None" else int(b)))
    if not slices:
        return tuple(slice(None) for _ in shape)
    while len(slices) < len(shape):
        slices.append(slice(None))
    return tuple(slices)


def _flatten(tree, prefix=()) -> Dict[str, object]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out["/".join(prefix + (str(k),))] = v
    return out


def _unflatten_like(like, flat, prefix=()):
    out = {}
    for k, v in like.items():
        path = prefix + (str(k),)
        out[k] = _unflatten_like(v, flat, path) if isinstance(v, dict) \
            else flat["/".join(path)]
    return out


def _nest(flat: Dict[str, object]) -> dict:
    out: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def layer_of(name: str):
    """A state-dict name's (JAX path parts, layer index or None):
    `blocks.3.attn.wq` -> (("blocks", "attn", "wq"), 3), `embed.table`
    -> (("embed", "table"), None)."""
    parts = name.split(".")
    if len(parts) > 2 and parts[0] in SEGMENTS and parts[1].isdigit():
        return (parts[0],) + tuple(parts[2:]), int(parts[1])
    return tuple(parts), None


def stack_layers(state: Dict[str, object], stack) -> dict:
    """A state dict as JAX's nested tree: names split at "." and each
    segment's per-layer leaves stacked over the layers with `stack` (a
    function of the list of layers' leaves, in layer order)."""
    flat: Dict[str, object] = {}
    layers: Dict[str, dict] = {}
    for name, v in state.items():
        path, i = layer_of(name)
        key = "/".join(path)
        if i is None:
            flat[key] = v
        else:
            layers.setdefault(key, {})[i] = v
    for key, by in layers.items():
        if sorted(by) != list(range(len(by))):
            raise ValueError(f"{key}: layers {sorted(by)} are not 0..L-1")
        flat[key] = stack([by[i] for i in range(len(by))])
    return _nest(flat)


def _is_state(d: dict) -> bool:
    return any("." in str(k) for k in d)


def to_jax_layout(tree, stack):
    """A tree whose state dicts (dicts keyed by dotted names) are turned
    into JAX's nested, layer-stacked form (`stack_layers`)."""
    if not isinstance(tree, dict):
        return tree
    if _is_state(tree):
        return stack_layers(tree, stack)
    return {k: to_jax_layout(v, stack) for k, v in tree.items()}


def _stack_host(leaves):
    arrs = [a for a, _ in leaves]
    return np.stack(arrs), leaves[0][1]


def _stack_spec(specs):
    if any(s != specs[0] for s in specs):
        raise ValueError(f"a segment's layers have specs {set(specs)}")
    return (None,) + tuple(specs[0])


def _jax_key(key: str):
    """A flat key of the port's tree -> (the key in JAX's layout, layer
    index or None)."""
    *head, leaf = key.split("/")
    path, i = layer_of(leaf)
    return "/".join(tuple(head) + path), i


def _block_index(spec, gshape, mesh, rank: int) -> tuple:
    from repro_torch.launch.sharding import local_slice, rank_coords
    return local_slice(spec, gshape, mesh, rank_coords(mesh, rank))


def save_attempt(mesh, attempt=None) -> str:
    """The id one multi-rank save shares: `attempt` where the caller
    gives it, else drawn by rank 0 and broadcast over the mesh's process
    group (a collective: every rank of the mesh calls this, in program
    order). A shape-only mesh has no group to agree over, so its caller
    must name the attempt."""
    if attempt is not None:
        return str(attempt)
    if not mesh.live:
        raise ValueError(
            f"a save under the shape-only mesh {mesh.shape}: one process "
            f"writes every rank's blocks, and its calls must name the "
            f"attempt they share (attempt=...)")
    from repro_torch.distributed import mesh as pg
    draw = torch.tensor([secrets.randbits(62) if mesh.rank == 0 else 0],
                        dtype=torch.int64)
    got, = pg.broadcast([draw], src=mesh.ranks[0],
                        group=mesh.group(mesh.axis_names))
    return f"{int(got[0]):x}"


def save_tree(path: os.PathLike, tree, *, aux: Optional[Dict] = None,
              specs: Optional[Dict] = None, mesh=None, attempt=None):
    """Atomic save of a nested dict of tensors or arrays (or of (array,
    dtype name) pairs already on the host). With a `mesh` of more than
    one rank, `specs` (a tree like `tree`, each leaf's spec over its
    global shape, or None where the leaf is whole on every rank) says
    which leaves are this rank's blocks, and `attempt` (`save_attempt`)
    names this save among any earlier one of the same step: the module
    docstring."""
    path = Path(path)
    tmp = path.with_suffix(".tmp")
    multi = mesh is not None and mesh.size > 1
    rank = mesh.rank if multi else 0
    if multi:
        attempt = save_attempt(mesh, attempt)
    elif tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True, exist_ok=multi)
    flat_specs = _flatten(specs) if specs is not None else {}
    index = {"leaves": {}, "aux": aux or {}}
    for key, leaf in _flatten(tree).items():
        data, dtn = _to_savable(leaf)
        fname = key.replace("/", "__")
        spec = flat_specs.get(key) if multi else None
        if spec is None or all(mesh.axis_size(a) == 1
                               for a in spec if a is not None):
            if rank == 0:
                np.save(tmp / f"{fname}.npy", data)
            index["leaves"][key] = {"shape": list(data.shape), "dtype": dtn,
                                    "sharded": False,
                                    "file": f"{fname}.npy"}
            continue
        gshape = tuple(d * (1 if a is None else mesh.axis_size(a))
                       for d, a in zip(data.shape, spec))
        shards, first = [], {}
        for r in range(mesh.size):
            idx = str(_block_index(spec, gshape, mesh, r))
            if idx in first:
                continue
            first[idx] = r
            sf = f"{fname}.shard{r}.npy"
            if r == rank:
                np.save(tmp / sf, data)
            shards.append({"file": sf, "index": idx})
        index["leaves"][key] = {"shape": list(gshape), "dtype": dtn,
                                "sharded": True, "shards": shards}
    if multi:
        (tmp / f".done{rank}.{attempt}").write_text("")
        if rank != 0:
            return
        deadline = time.monotonic() + MARKER_TIMEOUT_S
        while not all((tmp / f".done{r}.{attempt}").exists()
                      for r in range(mesh.size)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{tmp}: not every rank wrote its "
                                   f"blocks of attempt {attempt} in "
                                   f"{MARKER_TIMEOUT_S:.0f} s")
            time.sleep(0.01)
        named = {m["file"] for m in index["leaves"].values()
                 if not m["sharded"]} | {
            sh["file"] for m in index["leaves"].values() if m["sharded"]
            for sh in m["shards"]}
        for f in tmp.iterdir():
            if f.name not in named:
                shutil.rmtree(f) if f.is_dir() else f.unlink()
    (tmp / "index.json").write_text(json.dumps(index))
    fd = os.open(tmp, os.O_RDONLY)
    os.fsync(fd)
    os.close(fd)
    if path.exists():
        shutil.rmtree(path)
    os.rename(tmp, path)


def _load(path: Path, meta) -> torch.Tensor:
    """A leaf's global array from its file or its shards (replicas of a
    block overwrite with identical values)."""
    if not meta["sharded"]:
        return _from_saved(np.load(path / meta["file"]), meta["dtype"])
    arr = None
    for s in meta["shards"]:
        part = np.load(path / s["file"])
        if arr is None:
            arr = np.empty(tuple(meta["shape"]), dtype=part.dtype)
        arr[_parse_index(s["index"], meta["shape"])] = part
    return _from_saved(arr, meta["dtype"])


def restore_tree(path: os.PathLike, like):
    """Restore into the structure of `like` (a nested dict whose leaves
    are tensors, or anything else for a host tensor): each leaf in its
    saved dtype, on the device of `like`'s leaf, reassembled from its
    shards where it was saved in blocks. A leaf named by a state-dict
    name is read under its own key or, in JAX's layout, as its layer of
    the stacked leaf. Returns (tree, aux)."""
    path = Path(path)
    index = json.loads((path / "index.json").read_text())
    saved = index["leaves"]
    flat_like = _flatten(like)
    where = {k: (k, None) if k in saved else _jax_key(k) for k in flat_like}
    missing = sorted(k for k, (j, _) in where.items() if j not in saved)
    if missing:
        raise KeyError(f"checkpoint missing leaves: {missing[:5]}")
    cache: Dict[str, torch.Tensor] = {}
    flat = {}
    for key, ref in flat_like.items():
        jkey, i = where[key]
        if jkey not in cache:
            cache[jkey] = _load(path, saved[jkey])
        t = cache[jkey] if i is None else cache[jkey][i].clone()
        flat[key] = t.to(ref.device) if torch.is_tensor(ref) else t
    return _unflatten_like(like, flat), index.get("aux", {})


def _region(index, shape) -> list:
    """An index's (start, stop) per dim of `shape`."""
    return [(0 if sl.start is None else sl.start,
             n if sl.stop is None else sl.stop)
            for sl, n in zip(index, shape)]


def _load_block(path: Path, meta, want) -> np.ndarray:
    """The region `want` ((start, stop) per dim) of a saved leaf, read
    from the files that overlap it only, one of each set of replicas
    (memory-mapped: a whole leaf or a shard is never read whole for a
    block of it)."""
    out = np.empty(tuple(b - a for a, b in want),
                   dtype=np.dtype("uint16" if meta["dtype"] == "bfloat16"
                                  else meta["dtype"]))
    parts = ([(meta["file"], [(0, n) for n in meta["shape"]])]
             if not meta["sharded"] else
             [(sh["file"], _region(_parse_index(sh["index"], meta["shape"]),
                                   meta["shape"]))
              for sh in meta["shards"]])
    seen = set()
    for fname, have in parts:
        cut = [(max(a, c), min(b, d)) for (a, b), (c, d) in zip(want, have)]
        if any(a >= b for a, b in cut) or tuple(have) in seen:
            continue                     # no overlap, or a replica's
        seen.add(tuple(have))
        arr = np.load(path / fname, mmap_mode="r")
        src = tuple(slice(a - c, b - c) for (a, b), (c, _) in zip(cut, have))
        dst = tuple(slice(a - c, b - c) for (a, b), (c, _) in zip(cut, want))
        out[dst] = arr[src]
    return out


def restore_blocks(path: os.PathLike, like, specs, mesh, coords=None):
    """`restore_tree` of a rank's blocks only: each leaf of `like` the
    block a rank at `coords` (default: the mesh's own) holds under its
    spec in `specs` (a tree like `like`, each spec over the leaf's
    global shape; None for a whole leaf), read from the files of the
    saved leaf that overlap the block (its shards, in JAX's layout or
    the port's; a state-dict name's layer of a stacked leaf). Returns
    (tree, aux)."""
    from repro_torch.launch.sharding import local_slice
    path = Path(path)
    index = json.loads((path / "index.json").read_text())
    saved = index["leaves"]
    flat_like, flat_specs = _flatten(like), _flatten(specs)
    flat = {}
    for key, ref in flat_like.items():
        jkey, i = (key, None) if key in saved else _jax_key(key)
        if jkey not in saved:
            raise KeyError(f"checkpoint missing leaf {key}")
        meta = saved[jkey]
        shape = meta["shape"][1:] if i is not None else meta["shape"]
        spec = flat_specs.get(key) or (None,) * len(shape)
        want = _region(local_slice(spec, shape, mesh, coords), shape)
        if i is not None:
            want = [(i, i + 1)] + want
        t = _from_saved(np.ascontiguousarray(_load_block(path, meta, want)),
                        meta["dtype"])
        if i is not None:
            t = t[0]
        flat[key] = t.to(ref.device) if torch.is_tensor(ref) else t
    return _unflatten_like(like, flat), index.get("aux", {})


class CheckpointManager:
    """Step-numbered checkpoints with retention, async save and resume,
    in JAX's layout (the module docstring)."""

    def __init__(self, root: os.PathLike, keep: int = 3):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def _dir(self, step: int) -> Path:
        return self.root / f"step_{step:08d}"

    def steps(self):
        return sorted(int(p.name.split("_")[1]) for p in
                      self.root.glob("step_*") if p.is_dir()
                      and not p.name.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree, aux: Optional[Dict] = None,
             async_: bool = False, specs: Optional[Dict] = None, mesh=None,
             attempt=None):
        """Save `tree` (state dicts inside it in JAX's layout) as step
        `step`; under a `mesh` of more than one rank with `specs`
        (`save_tree`), each rank its blocks, the ranks agreeing on the
        attempt here, on the caller's thread."""
        self.wait()                      # at most one save in flight
        if mesh is not None and mesh.size > 1:
            attempt = save_attempt(mesh, attempt)
        host_tree = to_jax_layout(_host(tree), _stack_host)
        host_specs = None if specs is None else to_jax_layout(specs,
                                                              _stack_spec)
        lead = mesh is None or mesh.rank == 0

        def work():
            save_tree(self._dir(step), host_tree,
                      aux={**(aux or {}), "step": step}, specs=host_specs,
                      mesh=mesh, attempt=attempt)
            if lead:
                self._gc()
        if async_:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()

    def restore(self, like, step: Optional[int] = None):
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        return restore_tree(self._dir(step), like)

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._dir(s), ignore_errors=True)


def _host(tree):
    return {k: (_host(v) if isinstance(v, dict) else _to_savable(v))
            for k, v in tree.items()}
