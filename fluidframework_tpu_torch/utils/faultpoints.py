"""Named fault-injection points for the server stack.

A chaos drill needs to kill the pipeline at *arbitrary, named* places —
mid-sequencing, between a durable append and its spill write, between a
summary upload and its ack — and the production code needs to pay
nothing for that capability when no drill is running. This module is
the contract between the two: server code drops a
``fault_point("site.name")`` call at each interesting boundary (one
global ``is None`` check when disarmed), and a drill installs a plan
(any object with ``hit(site, **ctx)``) that decides — per site, per hit
— whether to crash (:class:`CrashInjected`), stall, or pass through.

Sites are registered at import time of the module that hosts them, so
``registered_sites()`` documents the full injection surface and drills
can assert they cover it.
"""

from __future__ import annotations

import random
import threading
from typing import Dict, Optional, Set

#: every site name ever declared via :func:`declare_site` — the
#: discoverable injection surface (drills sweep it; reviews audit it).
_SITES: Set[str] = set()

_lock = threading.Lock()
_plan = None  # the installed plan, or None (disarmed)


class CrashInjected(RuntimeError):
    """Raised by an armed fault plan to simulate a process kill at a
    fault point. Carries the site name; drills catch it and run the
    recovery path exactly as a restarted process would."""

    def __init__(self, site: str):
        super().__init__(f"injected crash at {site}")
        self.site = site


def declare_site(name: str) -> str:
    """Register a site name (idempotent); returns it so hosts can write
    ``SITE_X = declare_site("x")`` and pass the constant around."""
    with _lock:
        _SITES.add(name)
    return name


def registered_sites() -> Set[str]:
    with _lock:
        return set(_SITES)


def install(plan) -> None:
    """Arm ``plan`` globally. Only one plan at a time — nested drills
    would make hit counts meaningless."""
    global _plan
    with _lock:
        if _plan is not None:
            raise RuntimeError("a fault plan is already installed")
        _plan = plan


def uninstall() -> None:
    global _plan
    with _lock:
        _plan = None


def active_plan():
    return _plan


def fault_point(site: str, **ctx) -> None:
    """The hook server code calls. Disarmed: one global read, no other
    work. Armed: the plan decides (crash / stall / nothing). The plan
    registry is this package's own: arming a site here arms nothing in
    any other package that declares the same site names."""
    plan = _plan
    if plan is not None:
        plan.hit(site, **ctx)


class armed:
    """``with armed(plan): ...`` — install for the block, always
    uninstall (even when the block exits via CrashInjected)."""

    def __init__(self, plan):
        self.plan = plan

    def __enter__(self):
        install(self.plan)
        return self.plan

    def __exit__(self, *_exc):
        uninstall()
        return False


class ProbabilisticPlan:
    """Repeat-fire fault plan: each armed site crashes with probability
    ``p`` on every hit, drawn from one seeded rng so a soak run replays
    exactly. Unlike a one-shot plan ("crash on the Nth hit"), this plan
    never exhausts — it models a flaky fleet rather than a scripted
    kill.

    ``arm(site, p)`` may be called before or after install; ``disarm``
    removes one site. ``fires`` counts injected crashes per site so
    drills can assert coverage.
    """

    def __init__(self, rng: Optional[random.Random] = None):
        self.rng = rng or random.Random()
        self._p: Dict[str, float] = {}
        self._stall: Dict[str, tuple] = {}   # site → (p, seconds)
        self.fires: Dict[str, int] = {}
        self.stalls: Dict[str, int] = {}
        self._lock = threading.Lock()

    def arm(self, site: str, p: float = 0.01) -> "ProbabilisticPlan":
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"p must be a probability, got {p}")
        with self._lock:
            self._p[site] = p
        return self

    def arm_stall(self, site: str, p: float, seconds: float
                  ) -> "ProbabilisticPlan":
        """With probability ``p`` per hit, sleep ``seconds`` at ``site``
        — degradation (delayed sequencing → delayed acks), not death."""
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"p must be a probability, got {p}")
        with self._lock:
            self._stall[site] = (p, seconds)
        return self

    def disarm(self, site: str) -> None:
        with self._lock:
            self._p.pop(site, None)
            self._stall.pop(site, None)

    def hit(self, site: str, **ctx) -> None:
        with self._lock:
            stall = self._stall.get(site)
            sleep_s = 0.0
            if stall is not None and self.rng.random() < stall[0]:
                self.stalls[site] = self.stalls.get(site, 0) + 1
                sleep_s = stall[1]
            p = self._p.get(site)
            fire = p is not None and self.rng.random() < p
            if fire:
                self.fires[site] = self.fires.get(site, 0) + 1
        if sleep_s:
            import time
            time.sleep(sleep_s)
        if fire:
            raise CrashInjected(site)


def arm(site: str, p: float = 0.01,
        rng: Optional[random.Random] = None) -> ProbabilisticPlan:
    """Probabilistically arm ``site``: installs a shared
    :class:`ProbabilisticPlan` (creating one if nothing is installed,
    reusing the installed one if it is probabilistic) and arms the site
    at rate ``p``. A later ``rng`` replaces the plan's rng so callers
    can re-seed between soak phases. Raises if a *different* kind of
    plan is installed — mixing one-shot budgets with probabilistic fire
    would make both unaccountable."""
    global _plan
    with _lock:
        plan = _plan
        if plan is None:
            plan = ProbabilisticPlan(rng=rng)
            _plan = plan
        elif not isinstance(plan, ProbabilisticPlan):
            raise RuntimeError("a non-probabilistic fault plan is installed")
        elif rng is not None:
            plan.rng = rng
    return plan.arm(site, p)


def disarm(site: str) -> None:
    """Remove one probabilistically armed site (no-op when the installed
    plan is not probabilistic or nothing is armed)."""
    plan = _plan
    if isinstance(plan, ProbabilisticPlan):
        plan.disarm(site)


# ------------------------------------------------- corruption injectors
# Seeded disk-rot simulators for the durability-integrity drills: they
# mutate a durable file IN PLACE the way real corruption does — a flipped
# bit, a truncation that may later regrow, a spliced-out record — and
# return an evidence dict so the drill can assert the detection
# layer reports the SAME location. They are deliberately plain file
# operations (no log/format knowledge): the integrity plane must detect
# arbitrary byte damage, not only damage shaped like its own framing.

CORRUPTION_KINDS = ("bitflip", "truncate", "splice")


def corrupt_bitflip(path: str, rng: random.Random) -> dict:
    """Flip ONE random bit somewhere in the file."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    if not data:
        return {"kind": "bitflip", "path": path, "skipped": "empty file"}
    off = rng.randrange(len(data))
    bit = rng.randrange(8)
    data[off] ^= 1 << bit
    with open(path, "wb") as f:
        f.write(data)
    return {"kind": "bitflip", "path": path, "offset": off, "bit": bit}


def corrupt_truncate(path: str, rng: random.Random) -> dict:
    """Cut the file at a random interior byte (NOT a record boundary on
    purpose — boundary truncation is the harder case the summary chain
    anchor exists for; callers wanting it can truncate exactly)."""
    import os
    size = os.path.getsize(path)
    if size < 2:
        return {"kind": "truncate", "path": path, "skipped": "too small"}
    cut = rng.randrange(1, size)
    with open(path, "r+b") as f:
        f.truncate(cut)
    return {"kind": "truncate", "path": path, "offset": cut,
            "dropped_bytes": size - cut}


def corrupt_splice(path: str, rng: random.Random) -> dict:
    """Remove one interior line (newline-framed files: a clean record
    splice) or, for binary files with too few lines, one interior 16-byte
    chunk — the 'a record vanished but the stream still looks healthy'
    case only a checksum CHAIN can see."""
    with open(path, "rb") as f:
        data = f.read()
    lines = data.split(b"\n")
    # newline-framed with at least 3 complete interior candidates
    if len(lines) >= 4 and data.endswith(b"\n"):
        i = rng.randrange(1, len(lines) - 2)  # never the first or torn slot
        cut = lines[:i] + lines[i + 1:]
        with open(path, "wb") as f:
            f.write(b"\n".join(cut))
        return {"kind": "splice", "path": path, "line": i,
                "dropped_bytes": len(lines[i]) + 1}
    if len(data) < 48:
        return {"kind": "splice", "path": path, "skipped": "too small"}
    off = rng.randrange(16, len(data) - 32)
    with open(path, "wb") as f:
        f.write(data[:off] + data[off + 16:])
    return {"kind": "splice", "path": path, "offset": off,
            "dropped_bytes": 16}


def corrupt_file(path: str, kind: str, rng: random.Random) -> dict:
    """Dispatch one corruption of ``kind`` ∈ :data:`CORRUPTION_KINDS`."""
    fn = {"bitflip": corrupt_bitflip, "truncate": corrupt_truncate,
          "splice": corrupt_splice}.get(kind)
    if fn is None:
        raise ValueError(f"unknown corruption kind {kind!r} "
                         f"(want one of {CORRUPTION_KINDS})")
    return fn(path, rng)


# Core sites declared centrally (hosts may declare more):
SITE_DELI_MID_WINDOW = declare_site("deli.sequence.mid_window")
SITE_OPLOG_MID_APPEND = declare_site("oplog.append.mid")
SITE_OPLOG_MID_SPILL = declare_site("oplog.spill.mid_line")
SITE_SUBMIT_POST_SEQUENCE = declare_site("serving.submit.post_sequence")
SITE_FLUSH_MID_BATCH = declare_site("serving.flush.mid_batch")
SITE_INGEST_MID_BATCH = declare_site("serving.ingest.mid_batch")
SITE_SUMMARIZER_POST_UPLOAD = declare_site("summarizer.post_upload")
SITE_CHECKPOINT_MID_WRITE = declare_site("checkpoint.mid_write")
SITE_APPLY_STALL = declare_site("serving.apply.stall")
