"""Deterministic fault injection for the serving stack — stdlib only;
the port's copy of `repro/faults/`, so one spec and seed fire the same
hits in both packages.

Large neuromorphic deployments treat component failure as the normal
case; to test that our serve -> portal -> bridge stack actually
recovers, failures must be INJECTABLE and REPLAYABLE: the same armed
plan must produce the same crash at the same batch on every run, so a
chaos test that passed yesterday pins the same recovery path today.

A `FaultPlan` arms named injection SITES. The production code calls
`faults.fire("<site>")` at each site — a module-level no-op (one global
load + `is None` check) unless a plan is installed, which is what keeps
the disarmed hooks inside the serve/portal bench's <= 5% overhead
envelope. Armed sites trigger either at exact hit indices (`@i,j` —
the i-th time that site is reached, 1-based) or with a seeded Bernoulli
rate (`%p` — `random.Random(seed ^ site)` drives it, so the sequence
of triggers is a pure function of (plan spec, seed)).

Sites (the first three wired through serve/server.py, the last two
through portal/bridge.py and portal/http.py):

  dispatch_crash   dispatcher loop dies mid-batch  -> supervisor restart
  batch_exception  one micro-batch raises          -> batch rejected,
                                                      loop survives
  slow_batch       one micro-batch sleeps delay_s  -> watchdog/deadline
  bridge_drop      worker's UDS transport severed  -> auto-reconnect
  worker_exit      front-end worker hard-exits     -> parent respawns

Plans come from code (`FaultPlan().arm(...)`), from a spec string
(`FaultPlan.from_spec("dispatch_crash@2;slow_batch%0.25:delay=0.05")`),
or from the environment (`install_from_env()` reads REPRO_FAULTS /
REPRO_FAULTS_SEED / REPRO_FAULTS_LOG) — the env route is how bridge
worker subprocesses inherit the chaos plan of their parent. Every
trigger appends one NDJSON line to the log path (O_APPEND single
writes, so N processes sharing one file stay line-atomic).

This module must stay importable by the portal's bridge workers:
stdlib only, no numpy.
"""
from __future__ import annotations

import json
import os
import random
import threading
import time
import zlib
from typing import Dict, Iterable, Optional

__all__ = ["FaultPlan", "InjectedFault", "SITES", "fire", "install",
           "uninstall", "current", "install_from_env"]

# site name -> default action when triggered
SITES = {
    "dispatch_crash": "raise",
    "batch_exception": "raise",
    "slow_batch": "sleep",
    "bridge_drop": "flag",
    "worker_exit": "exit",
}

_EXIT_CODE = 17          # distinguishable from crashes and signals


class InjectedFault(RuntimeError):
    """Raised by a triggered `raise`-action site. Carries the site and
    the 1-based hit index so recovery paths (and their tests) can tell
    injected failures from organic ones."""

    def __init__(self, site: str, hit: int):
        super().__init__(
            f"injected fault at site {site!r} (hit #{hit})")
        self.site = site
        self.hit = hit


class _Site:
    """Armed state of one injection site."""

    __slots__ = ("name", "at", "rate", "delay_s", "action", "hits",
                 "fired", "_rng")

    def __init__(self, name: str, at: Iterable[int] = (),
                 rate: float = 0.0, delay_s: float = 0.05,
                 action: Optional[str] = None, seed: int = 0):
        if name not in SITES:
            raise ValueError(f"unknown fault site {name!r} "
                             f"(have {sorted(SITES)})")
        self.name = name
        self.at = frozenset(int(i) for i in at)
        self.rate = float(rate)
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        self.delay_s = float(delay_s)
        self.action = action or SITES[name]
        self.hits = 0
        self.fired = 0
        # per-site deterministic stream: the trigger sequence depends
        # only on (seed, site name), never on dict order or other sites
        self._rng = random.Random(seed ^ zlib.crc32(name.encode()))

    def spec(self) -> str:
        s = self.name
        if self.at:
            s += "@" + ",".join(str(i) for i in sorted(self.at))
        if self.rate:
            s += f"%{self.rate:g}"
        if self.action == "sleep":
            s += f":delay={self.delay_s:g}"
        return s


class FaultPlan:
    """A seeded, replayable set of armed injection sites.

        plan = FaultPlan(seed=7).arm("dispatch_crash", at=[2])
        faults.install(plan)
        ... exercise the server; batch #2's dispatch dies ...
        faults.uninstall()

    Thread-safe: `fire` is called from the dispatcher thread, client
    threads, and asyncio loops concurrently; hit counting is locked so
    `@i` means the i-th arrival globally."""

    def __init__(self, seed: int = 0, log_path: Optional[str] = None):
        self.seed = int(seed)
        self.log_path = log_path
        self._sites: Dict[str, _Site] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------ build
    def arm(self, site: str, *, at: Iterable[int] = (),
            rate: float = 0.0, delay_s: float = 0.05,
            action: Optional[str] = None) -> "FaultPlan":
        self._sites[site] = _Site(site, at=at, rate=rate,
                                  delay_s=delay_s, action=action,
                                  seed=self.seed)
        return self

    @classmethod
    def from_spec(cls, spec: str, *, seed: int = 0,
                  log_path: Optional[str] = None) -> "FaultPlan":
        """Parse `site[@i,j][%rate][:delay=s]` entries joined by `;`.

            dispatch_crash@2;slow_batch%0.25:delay=0.05;worker_exit@3
        """
        plan = cls(seed=seed, log_path=log_path)
        for entry in spec.split(";"):
            entry = entry.strip()
            if not entry:
                continue
            body, _, opts = entry.partition(":")
            delay_s = 0.05
            for kv in filter(None, opts.split(":")):
                k, _, v = kv.partition("=")
                if k.strip() != "delay":
                    raise ValueError(
                        f"unknown fault option {k!r} in {entry!r}")
                delay_s = float(v)
            rate = 0.0
            if "%" in body:
                body, _, r = body.partition("%")
                rate = float(r)
            at: tuple = ()
            if "@" in body:
                body, _, idx = body.partition("@")
                at = tuple(int(i) for i in idx.split(",") if i)
            plan.arm(body.strip(), at=at, rate=rate, delay_s=delay_s)
        return plan

    def spec(self) -> str:
        """Round-trippable spec string (the form workers inherit via
        REPRO_FAULTS)."""
        return ";".join(s.spec() for s in self._sites.values())

    # ------------------------------------------------------------ fire
    def fire(self, site: str, **ctx) -> bool:
        """Count one arrival at `site`; trigger per the armed policy.
        Returns True for `flag`-action triggers (the call site performs
        the fault itself, e.g. severing a transport), False when
        disarmed/untriggered; raises `InjectedFault` for raise-action
        sites; sleeps for `sleep`; hard-exits for `exit`."""
        st = self._sites.get(site)
        if st is None:
            return False
        with self._lock:
            st.hits += 1
            hit = st.hits
            trig = hit in st.at or (
                st.rate > 0.0 and st._rng.random() < st.rate)
            if trig:
                st.fired += 1
        if not trig:
            return False
        self._log(site, hit, st.action, ctx)
        if st.action == "sleep":
            time.sleep(st.delay_s)
            return False
        if st.action == "exit":
            # simulate a worker process dying uncleanly: no atexit, no
            # finally blocks — the parent's reaper must cope
            os._exit(_EXIT_CODE)
        if st.action == "flag":
            return True
        raise InjectedFault(site, hit)

    def _log(self, site: str, hit: int, action: str, ctx: dict) -> None:
        if not self.log_path:
            return
        rec = {"ts": round(time.time(), 6), "pid": os.getpid(),
               "site": site, "hit": hit, "action": action}
        if ctx:
            rec.update(ctx)
        line = (json.dumps(rec) + "\n").encode("utf-8")
        try:
            fd = os.open(self.log_path,
                         os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
            try:
                os.write(fd, line)
            finally:
                os.close(fd)
        except OSError:
            pass                       # chaos logging never adds faults

    # ------------------------------------------------------------ stats
    def stats(self) -> dict:
        with self._lock:
            return {name: {"hits": st.hits, "fired": st.fired,
                           "action": st.action}
                    for name, st in self._sites.items()}


# --------------------------------------------------------------- global
# the one installed plan; `fire` below is the hook production code
# calls — when no plan is installed it is one global read + None check
_PLAN: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> FaultPlan:
    global _PLAN
    _PLAN = plan
    return plan


def uninstall() -> None:
    global _PLAN
    _PLAN = None


def current() -> Optional[FaultPlan]:
    return _PLAN


def fire(site: str, **ctx) -> bool:
    """The injection hook. Disarmed (no plan installed) it returns
    False immediately — cheap enough to leave compiled into every hot
    path (bench-gated <= 5% with hooks in and disarmed)."""
    p = _PLAN
    if p is None:
        return False
    return p.fire(site, **ctx)


def install_from_env() -> Optional[FaultPlan]:
    """Install a plan from REPRO_FAULTS (spec), REPRO_FAULTS_SEED, and
    REPRO_FAULTS_LOG (NDJSON trigger log). No-op without REPRO_FAULTS.
    Bridge workers call this on startup, so `--faults` on the parent
    portal arms the whole process tree with one deterministic plan."""
    spec = os.environ.get("REPRO_FAULTS")
    if not spec:
        return None
    plan = FaultPlan.from_spec(
        spec, seed=int(os.environ.get("REPRO_FAULTS_SEED", "0")),
        log_path=os.environ.get("REPRO_FAULTS_LOG") or None)
    return install(plan)
