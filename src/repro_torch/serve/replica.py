"""Multi-rank serving of a mesh deployment: one leader, followers that
replay (ROADMAP item 7b).

A mesh `Deployment` whose world holds several ranks runs every call as
SPMD: each rank makes the same calls in the same order, and the calls
meet in the tier's collectives. A server cannot run on every rank —
micro-batches form on each rank's own clock — so rank 0 LEADS: its
`SpikeServer` holds a `LeaderDeployment`, a proxy that, before each
state-changing call is made locally, broadcasts that call as one record
over the world group (`Leader`, one a server). Every other rank runs
`serve_follower`, which replays the records in order until the leader's
`SpikeServer.shutdown` sends the stop record:

    # every rank, in the same order
    c = CompiledNetwork.load(path)                      # target "mesh"
    if rank == 0:
        srv = SpikeServer(); srv.add_model("m", c, window=16)
        with srv: ...                                   # serve, portal
    else:
        serve_follower(deploy(c))

The replayed calls are the ones that change lane state or weights:
`run_lanes`, `write_synapses`, `load_weights`, `reset`, `lane_restore`,
`load_lane_state` and `alloc_lanes`. Reads (`lane_membrane`,
`lane_snapshot`, `lane_state`) stay local on the leader: lane state is
whole host numpy on every rank, so replay keeps each rank's lanes equal
to the leader's. One lock per process covers "broadcast the record, then
make the call", across every server: the dispatcher thread, the caller
thread of a session close or a restore, and the supervisor's rollback
would otherwise interleave their collectives and hang. The fault sites
of the dispatch path fire before a record leaves, so a batch is never
half replayed, and the supervisor's rollback goes through the proxy, so
the followers roll back too.

A server leads one multi-rank model. Its `add_model` first broadcasts
an add record holding the model's name and what the deployments must
share (`describe`: a digest of the artifact's tables and current
weights, the seed, the mesh layout). Every rank compares its own and
the verdicts are gathered, so a follower deployed from another artifact
or seed makes `add_model` and `serve_follower` raise on every rank
instead of serving other noise. Each record also carries how the
leader's PREVIOUS call ended (the exception's type name, or None); a
follower whose own replay of that call ended otherwise raises at once
instead of serving on from another state. An idle leader sends a no-op
record every `KEEPALIVE_S`, so a follower's wait never reaches the
process group's timeout.
"""
from __future__ import annotations

import functools
import hashlib
import json
import threading
import time
from typing import Optional

import numpy as np
import torch.distributed as dist

__all__ = ["Leader", "LeaderDeployment", "serve_follower", "describe",
           "REPLAYED", "KEEPALIVE_S"]

# the Deployment calls a follower replays: every one that changes lane
# state or weights
REPLAYED = ("run_lanes", "write_synapses", "load_weights", "reset",
            "lane_restore", "load_lane_state", "alloc_lanes")
KEEPALIVE_S = 10.0
_ADD, _STOP, _NOOP = "add", "stop", "noop"

# one lock per process: a record and the call it describes go out as one
# unit, whatever the thread or the server
_LOCK = threading.RLock()
# how the leader's last replicated call ended, and when a record last
# left (records of every server of the process share the world's order)
_state = {"last": None, "sent": 0.0}


def _broadcast(record=None):
    """Rank 0's `record` on every rank (one broadcast of its pickle)."""
    box = [record]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def describe(dep) -> dict:
    """What the leader's deployment and every follower's must share: a
    digest of the artifact (its neuron tables, synapse columns and
    current weights), the seed, and the mesh layout."""
    c, impl, hr = dep.compiled, dep.impl, dep.compiled.hierarchy
    h = hashlib.sha256(json.dumps(
        [c.target, c.n_axons, c.n_neurons, hr.n_servers,
         hr.fpgas_per_server, hr.cores_per_fpga,
         hr.neurons_per_core]).encode())
    for a in (c.theta, c.nu, c.lam, c.is_lif, c.syn_item, c.syn_post,
              c.syn_weight):
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype.str} {a.shape}".encode())
        h.update(a.data)
    return {"artifact": h.hexdigest(), "seed": dep.seed,
            "world_size": impl.world_size, "n_devices": impl.n_devices,
            "packed": impl.packed}


def _agree(name: str, diff) -> None:
    """Gather every rank's list of the `describe` keys in which its
    deployment differs from the leader's; raise on every rank when any
    list is not empty."""
    box = [None] * dist.get_world_size()
    dist.all_gather_object(box, sorted(diff))
    bad = {r: d for r, d in enumerate(box) if d}
    if bad:
        raise ValueError(
            f"deployments of {name!r} differ from the leader's "
            f"(rank: keys) {bad}: every rank must deploy the same "
            f"artifact with the same seed, n_devices and packing")


class Leader:
    """The leading side of one server's followers: wraps its multi-rank
    deployment, keeps the followers' wait short, and releases them."""

    def __init__(self):
        self.released = False
        self.records = 0
        self.model: Optional[str] = None

    def send(self, kind: str, body=None) -> None:
        """Broadcast one record, with the outcome of the leader's
        previous call; the caller holds `_LOCK`."""
        if self.released:
            raise RuntimeError("the followers were released by the "
                               "server's shutdown; a multi-rank server "
                               "does not restart")
        _broadcast((kind, body, _state["last"]))
        _state["sent"] = time.monotonic()
        self.records += 1

    def wrap(self, dep, name: str) -> "LeaderDeployment":
        """Send `dep`'s add record under `name`; raises on every rank
        unless every follower's deployment matches it."""
        if self.model is not None:
            raise ValueError(f"this server already leads the multi-rank "
                             f"model {self.model!r}; a server leads one")
        mine = describe(dep)
        with _LOCK:
            self.send(_ADD, (name, mine))
            _agree(name, ())
        self.model = name
        return LeaderDeployment(dep, name, self)

    def keepalive(self) -> None:
        """A no-op record when the last one is `KEEPALIVE_S` old (the
        dispatcher calls this on its idle ticks)."""
        if time.monotonic() - _state["sent"] < KEEPALIVE_S:
            return
        with _LOCK:
            if not self.released:
                self.send(_NOOP)

    def release(self) -> None:
        """The stop record, once; every later replicated call raises."""
        with _LOCK:
            if not self.released:
                self.send(_STOP)
                self.released = True


class LeaderDeployment:
    """Rank 0's proxy over a mesh `Deployment` that spans ranks: the
    calls in `REPLAYED` are broadcast, then made; everything else (the
    reads, `compiled`, `impl`, `counter`, ...) is the deployment's own."""

    def __init__(self, dep, name: str, leader: Leader):
        self._dep = dep
        self._name = name
        self._leader = leader

    def __getattr__(self, attr):
        if attr in REPLAYED:
            return functools.partial(self._replicate, attr)
        return getattr(self._dep, attr)

    def _replicate(self, op: str, *args, **kw):
        with _LOCK:
            self._leader.send("call", (self._name, op, args, kw))
            try:
                out = getattr(self._dep, op)(*args, **kw)
            except BaseException as e:
                _state["last"] = type(e).__name__
                raise
            _state["last"] = None
            return out


def serve_follower(dep) -> int:
    """A follower rank's loop: check the leader's add record against
    `dep`, replay the leader's calls on it until the stop record, and
    return the number of calls replayed. Raises when `dep` differs from
    the leader's deployment, and when a replayed call ended otherwise
    than the leader's."""
    mine = describe(dep)
    model: Optional[str] = None
    last: Optional[str] = None
    n = 0
    while True:
        kind, body, leader_last = _broadcast()
        if n and leader_last != last:
            raise RuntimeError(
                f"follower diverged from the leader on call {n}: the "
                f"leader's ended in {leader_last or 'success'}, this "
                f"rank's in {last or 'success'}")
        if kind == _STOP:
            return n
        if kind == _NOOP:
            continue
        if kind == _ADD:
            if model is not None:
                raise RuntimeError(f"an add record for {body[0]!r} while "
                                   f"following {model!r}")
            name, theirs = body
            _agree(name, [k for k in mine if mine[k] != theirs.get(k)])
            model = name
            continue
        name, op, args, kw = body
        if name != model:
            raise RuntimeError(f"a call on model {name!r} while "
                               f"following {model!r}")
        n += 1
        try:
            getattr(dep, op)(*args, **kw)
        except Exception as e:    # noqa: BLE001 — compared with the leader
            last = type(e).__name__
        else:
            last = None
