"""Observer fanout: one encoded window, N read-only subscribers.

Counterpart of ``fluidframework_tpu/server/observer.py``, the transport
half of the read plane (``server/read_plane.py`` is the encode half).
Routerlicious encodes a sequenced op once and lets its pub/sub tier fan
the bytes; a slow consumer is disconnected, never allowed to hold back
the sequencer. Two tiers:

- :class:`ObserverHub` — the transport-agnostic multiplexer. It keeps a
  ring of the last ``ring`` encoded windows (replay on resubscribe), a
  byte budget a subscriber (``server/admission.py``'s
  :class:`TokenBucket`, granted a whole window or nothing), shed
  accounting and the delivery gauges. ``publish`` hands the SAME bytes
  object to every subscriber's sink: a subscriber costs a budget check
  and a sink call, never an encode.
- :class:`ObserverDoor` — the asyncio socket tier (the columnar door's
  idiom: a loop on a thread of its own, sinks that hop onto it with
  ``call_soon_threadsafe``). Its protocol rides the columnar framing:

  - client → server ``J`` ``{"t": "subscribe", "from_wid"?, "name"?}``
    → server ``J`` ``{"t": "subscribed", "sid", "next_wid", "ring_from",
    "catchup_needed"}``. A ``from_wid``
    inside the ring replays the gap at once; ``catchup_needed`` says the
    ring no longer reaches back that far (the generation-diff rung);
  - server → client: the read plane's window runs verbatim (a ``J``
    window header, then ``B`` / ``R`` / ``T`` / ``J`` record frames);
  - a shed subscriber gets ``J`` ``{"t": "gap", "wid"}`` in place of the
    window and is parked until it asks ``{"t": "resume", "from_wid"}``
    (answered ``resumed`` or ``catchup_needed``);
  - ``{"t": "catchup", "from_gen"}`` is answered with the generation
    store's ladder (``catchup_info``); ``{"t": "close"}`` ends the
    session.

``publish`` does no socket I/O (a door sink only schedules a write on the
loop) and never waits on a reader. It fans out under the hub's lock, as
a subscribe's or a resume's ring replay does: a sink sees the replayed
windows, then the live ones, each once and in order.

Staleness (:class:`StalenessTracker`) is sampled by the hub (window
delivery delay) and by the read replicas (drain lag), each into a
tracker of its own; every tracker sets ``read_staleness_p99_s``.
"""

from __future__ import annotations

import asyncio
import json
import struct
import threading
import time
import zlib
from collections import deque
from typing import Callable, Dict, List, Optional

from ..utils.telemetry import REGISTRY
from .admission import TokenBucket
from .columnar_ingress import encode_json

#: window of the delivery-rate gauge (seconds)
_RATE_WINDOW_S = 5.0
#: samples a staleness tracker keeps
_STALENESS_KEEP = 1024
#: the address the observer door listens on
_HOST = "127.0.0.1"


class StalenessTracker:
    """Bounded sample window behind the ``read_staleness_p99_s`` gauge:
    the hub's window delivery delay, or a replica's drain lag."""

    def __init__(self):
        self._samples: List[float] = []
        self._lock = threading.Lock()

    def observe(self, seconds: float) -> None:
        with self._lock:
            self._samples.append(float(seconds))
            del self._samples[:-_STALENESS_KEEP]
            ss = sorted(self._samples)
            p99 = ss[min(len(ss) - 1, int(0.99 * len(ss)))]
        REGISTRY.set_gauge("read_staleness_p99_s", p99)

    def p99(self) -> float:
        with self._lock:
            if not self._samples:
                return 0.0
            ss = sorted(self._samples)
            return ss[min(len(ss) - 1, int(0.99 * len(ss)))]


#: the process-wide tracker (the gauge is process-scoped)
STALENESS = StalenessTracker()


class _Sub:
    __slots__ = ("sid", "name", "sink", "bucket", "last_wid",
                 "delivered_windows", "delivered_ops",
                 "delivered_bytes", "sheds", "parked", "t_subscribed")

    def __init__(self, sid: int, name: str, sink: Callable[[bytes], None],
                 bucket: Optional[TokenBucket], last_wid: int):
        self.sid = sid
        self.name = name
        self.sink = sink
        self.bucket = bucket
        self.last_wid = last_wid
        self.delivered_windows = 0
        self.delivered_ops = 0
        self.delivered_bytes = 0
        self.sheds = 0
        self.parked = False
        self.t_subscribed = time.time()

    def delivered(self, wid: int, n_ops: int, nbytes: int) -> None:
        self.last_wid = wid
        self.delivered_windows += 1
        self.delivered_ops += n_ops
        self.delivered_bytes += nbytes

    def shed(self, wid: int) -> None:
        """Park the subscriber and send the gap notice in place of
        window ``wid`` (outside the budget: the notice must arrive
        exactly when the data could not)."""
        self.sheds += 1
        self.parked = True
        REGISTRY.inc("observer_sheds_total")
        try:
            self.sink(encode_json({"t": "gap", "wid": wid}))
        except Exception:   # noqa: BLE001 — a dead sink leaves on publish
            pass


class ObserverHub:
    """Encode-once fanout hub (module docstring). ``ring`` windows are
    kept for replay; ``byte_rate`` / ``byte_burst`` are every
    subscriber's byte budget (bytes/s; None: no budget)."""

    def __init__(self, ring: int = 256,
                 byte_rate: Optional[float] = None,
                 byte_burst: Optional[float] = None,
                 tracker: Optional[StalenessTracker] = None):
        self._lock = threading.Lock()
        self._subs: Dict[int, _Sub] = {}
        self._next_sid = 1
        self._wid = 0       # the last window id handed out
        self._head = 0      # the last window id published
        #: (wid, payload bytes, n_ops, t_encoded)
        self._ring: deque = deque(maxlen=ring)
        self.byte_rate = byte_rate
        self.byte_burst = byte_burst
        self.tracker = tracker if tracker is not None else STALENESS
        self._delivered: deque = deque()   # (t, ops) for the rate gauge
        self.windows_published = 0
        self.ops_published = 0

    # ------------------------------------------------------------ windows

    def next_wid(self) -> int:
        with self._lock:
            self._wid += 1
            return self._wid

    def oldest_retained(self) -> Optional[int]:
        with self._lock:
            return self._ring[0][0] if self._ring else None

    @staticmethod
    def _granted(sub: _Sub, nbytes: int, now: float) -> bool:
        """Whole-window budget: the window's bytes, or nothing (a
        partial grant is handed back)."""
        if sub.bucket is None:
            return True
        got = sub.bucket.grant(nbytes, now)
        if got < nbytes:
            sub.bucket.tokens += got
            return False
        return True

    def publish(self, wid: int, payload: bytes, n_ops: int) -> int:
        """Fan one encoded window to every live subscriber; returns how
        many it reached. The payload is shared: no copy, no encode, a
        subscriber."""
        now = time.monotonic()
        t_wall = time.time()
        nbytes = len(payload)
        delivered = 0
        with self._lock:
            self._ring.append((wid, payload, n_ops, t_wall))
            self._head = wid
            self.windows_published += 1
            self.ops_published += n_ops
            for sub in list(self._subs.values()):
                if sub.parked:
                    continue
                if not self._granted(sub, nbytes, now):
                    sub.shed(wid)
                    continue
                try:
                    sub.sink(payload)
                except Exception:   # noqa: BLE001 — a dead sink leaves
                    del self._subs[sub.sid]
                    continue
                sub.delivered(wid, n_ops, nbytes)
                delivered += 1
        self.tracker.observe(time.time() - t_wall)
        self._note_rate(n_ops * delivered)
        return delivered

    def _note_rate(self, ops: int) -> None:
        now = time.monotonic()
        with self._lock:
            self._delivered.append((now, ops))
            while self._delivered and \
                    self._delivered[0][0] < now - _RATE_WINDOW_S:
                self._delivered.popleft()
            total = sum(n for _, n in self._delivered)
            span = _RATE_WINDOW_S if len(self._delivered) > 1 else 1.0
            n_subs = len(self._subs)
        REGISTRY.set_gauge("observer_delivery_ops_per_sec", total / span)
        REGISTRY.set_gauge("observer_subscribers", float(n_subs))

    # -------------------------------------------------------- subscribers

    def subscribe(self, sink: Callable[[bytes], None],
                  name: str = "", from_wid: Optional[int] = None) -> dict:
        """Register a sink; replay the ring from ``from_wid`` when it
        still reaches back that far. Returns ``{"sid", "next_wid",
        "ring_from", "catchup_needed"}``: ``catchup_needed`` means the
        caller must take the generation-diff rung before the live stream
        is gapless. The replay and the registration are one step under
        the lock, so no live window overtakes a replayed one."""
        bucket = (TokenBucket(self.byte_rate, self.byte_burst)
                  if self.byte_rate else None)
        with self._lock:
            sid = self._next_sid
            self._next_sid += 1
            ring_from = self._ring[0][0] if self._ring else None
            catchup_needed = bool(
                from_wid is not None and self._ring and from_wid < ring_from)
            last = from_wid - 1 if from_wid is not None else self._head
            sub = _Sub(sid, name or f"observer-{sid}", sink, bucket, last)
            if from_wid is not None and not catchup_needed:
                self._replay(sub, from_wid, budget=True)
            self._subs[sid] = sub
        REGISTRY.inc("observer_subscribes_total")
        return {"sid": sid, "next_wid": sub.last_wid + 1,
                "ring_from": ring_from, "catchup_needed": catchup_needed}

    def _replay(self, sub: _Sub, from_wid: int, budget: bool) -> None:
        """The ring's windows from ``from_wid`` to ``sub`` (under the
        lock); a subscribe's replay rides the same budget as live
        delivery, a resume's is granted whole."""
        for wid, payload, n_ops, _t in self._ring:
            if wid < from_wid:
                continue
            if budget and not self._granted(sub, len(payload),
                                            time.monotonic()):
                sub.shed(wid)
                return
            sub.sink(payload)
            sub.delivered(wid, n_ops, len(payload))

    def unsubscribe(self, sid: int) -> None:
        with self._lock:
            self._subs.pop(sid, None)

    def resume(self, sid: int, from_wid: int) -> bool:
        """Unpark a shed subscriber, replaying [from_wid ..] from the
        ring; False when the ring no longer reaches (catch-up needed)."""
        with self._lock:
            sub = self._subs.get(sid)
            if sub is None:
                return False
            if self._ring and from_wid < self._ring[0][0]:
                return False
            sub.parked = False
            self._replay(sub, from_wid, budget=False)
        return True

    # ------------------------------------------------------------- health

    def readers(self) -> List[dict]:
        """A row a subscriber: its lag (windows behind the newest), the
        volume delivered, its sheds."""
        with self._lock:
            wid = self._head
            subs = list(self._subs.values())
        return [{
            "sid": s.sid, "name": s.name,
            "last_wid": s.last_wid, "lag_windows": max(0, wid - s.last_wid),
            "delivered_windows": s.delivered_windows,
            "delivered_ops": s.delivered_ops,
            "delivered_bytes": s.delivered_bytes,
            "sheds": s.sheds, "parked": s.parked,
            "age_s": round(time.time() - s.t_subscribed, 3),
        } for s in subs]

    def stats(self) -> dict:
        rows = self.readers()
        return {
            "subscribers": len(rows),
            "windows_published": self.windows_published,
            "ops_published": self.ops_published,
            "worst_lag_windows": max((r["lag_windows"] for r in rows),
                                     default=0),
            "sheds": sum(r["sheds"] for r in rows),
            "parked": sum(1 for r in rows if r["parked"]),
            "staleness_p99_s": self.tracker.p99(),
        }


# ----------------------------------------------------------------- door

class ObserverDoor:
    """Asyncio socket tier over one :class:`ObserverHub`: a connection
    subscribes with one control frame, then receives the hub's window
    runs verbatim. ``gen_store`` (a ``runtime.summarizer.
    SummaryGenerationStore``) answers the catch-up rung: a ``{"t":
    "catchup", "from_gen"}`` request gets the ladder's generations and
    whether a diff from ``from_gen`` is possible (the diff itself travels
    through the store)."""

    def __init__(self, hub: Optional[ObserverHub] = None, port: int = 0,
                 gen_store=None):
        self.hub = hub if hub is not None else ObserverHub()
        self.port = port
        self.gen_store = gen_store
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._thread: Optional[threading.Thread] = None
        self._ready = threading.Event()
        self.connections = 0

    # ---------------------------------------------------------- lifecycle

    def start_in_thread(self) -> "ObserverDoor":
        self._thread = threading.Thread(target=self._run,
                                        name="observer-door", daemon=True)
        self._thread.start()
        if not self._ready.wait(10):
            raise RuntimeError("observer door failed to start")
        return self

    def _run(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop

        async def boot():
            self._server = await asyncio.start_server(
                self._handle, _HOST, self.port)
            self.port = self._server.sockets[0].getsockname()[1]
            self._ready.set()

        loop.run_until_complete(boot())
        try:
            loop.run_forever()
        finally:
            # let the cancelled sessions unwind, then release the sockets
            rest = asyncio.all_tasks(loop)
            for t in rest:
                t.cancel()
            if rest:
                loop.run_until_complete(
                    asyncio.gather(*rest, return_exceptions=True))
            loop.close()

    def stop(self) -> None:
        loop = self._loop
        if loop is None or loop.is_closed():
            return

        def shutdown():
            if self._server is not None:
                self._server.close()
            loop.stop()

        loop.call_soon_threadsafe(shutdown)
        if self._thread is not None:
            self._thread.join(timeout=5)

    # --------------------------------------------------------- connection

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self.connections += 1
        loop = asyncio.get_running_loop()
        sid = None
        try:
            req = await self._read_json(reader)
            if req.get("t") != "subscribe":
                writer.write(encode_json(
                    {"t": "error", "reason": "expected subscribe"}))
                await writer.drain()
                return

            def sink(payload: bytes) -> None:
                # publish runs on the engine's flush or log thread; the
                # write hops onto the loop (transports are loop-affine)
                loop.call_soon_threadsafe(self._write, writer, payload)

            ack = self.hub.subscribe(sink, name=str(req.get("name", "")),
                                     from_wid=req.get("from_wid"))
            sid = ack["sid"]
            writer.write(encode_json({"t": "subscribed", **ack}))
            await writer.drain()
            # the read side carries control only: resume / catchup / close
            while True:
                req = await self._read_json(reader)
                if req.get("t") == "resume":
                    ok = self.hub.resume(sid, int(req["from_wid"]))
                    writer.write(encode_json(
                        {"t": "resumed" if ok else "catchup_needed"}))
                    await writer.drain()
                elif req.get("t") == "catchup":
                    writer.write(encode_json(self._catchup_info(req)))
                    await writer.drain()
                elif req.get("t") == "close":
                    return
        except (asyncio.IncompleteReadError, ConnectionError, OSError,
                ValueError):
            pass
        finally:
            if sid is not None:
                self.hub.unsubscribe(sid)
            try:
                writer.close()
            except (ConnectionError, OSError, RuntimeError):
                pass

    def _catchup_info(self, req: dict) -> dict:
        """The catch-up rung: the generations the ladder holds and
        whether a diff from the client's generation is possible."""
        if self.gen_store is None:
            return {"t": "catchup_info", "available": False,
                    "reason": "no generation store attached"}
        gens = self.gen_store.generations()
        have = req.get("from_gen")
        return {"t": "catchup_info", "available": bool(gens),
                "generations": gens,
                "directory": self.gen_store.directory,
                "diff_ok": bool(gens) and have is not None
                and have in gens and have != gens[-1]}

    @staticmethod
    def _write(writer: asyncio.StreamWriter, payload: bytes) -> None:
        try:
            writer.write(payload)
        except (ConnectionError, OSError, RuntimeError):
            pass

    @staticmethod
    async def _read_json(reader: asyncio.StreamReader) -> dict:
        hdr = await reader.readexactly(5)
        ftype, length = struct.unpack("<BI", hdr)
        payload = await reader.readexactly(length)
        (crc,) = struct.unpack("<I", await reader.readexactly(4))
        if crc != zlib.crc32(payload) or ftype != ord("J"):
            raise ValueError("bad control frame")
        return json.loads(payload)
