"""Distributed UUID → small-int ID compression.

Reference counterpart: ``@fluidframework/id-compressor`` (``IdCompressor``,
session/cluster allocation acked through the op stream) — SURVEY.md §2.11
(mount empty). Semantics preserved from the reference design:

- Every client (session) has a **session UUID**. Calling ``generate_id()``
  returns immediately with a **local id** (negative ints, -1, -2, ...) —
  usable at once, no round trip.
- Allocation is batched into **ranges**: the runtime calls
  ``take_next_creation_range()`` when flushing a batch and ships the range in
  the op stream. When the range comes back sequenced (``finalize_range``),
  the local ids gain **final ids** (non-negative ints) allocated from a
  document-global counter in sequence order — every client computes the same
  final ids because they all see the same total order.
- Final ids are allocated in **clusters** with slack capacity so a chatty
  session's consecutive ranges stay contiguous (cheap delta coding), matching
  the reference's cluster-chain design.
- ``normalize_to_op_space`` maps a local id to the id to embed in outgoing
  ops (final if known, else the local id + session id lets peers resolve);
  ``normalize_to_session_space`` maps an op-space id back to the local alias
  where one exists.

Final ids are dense small ints, so they can index device-resident
struct-of-array tensors (doc/segment tables) directly, without a host-side
hash lookup.
"""

from __future__ import annotations

import dataclasses
import uuid
from typing import Dict, List, Optional, Tuple

DEFAULT_CLUSTER_CAPACITY = 512


@dataclasses.dataclass
class IdCreationRange:
    """A batch of locally-generated ids announced to the service
    (reference: IdCreationRange in the id-compressor protocol)."""

    session_id: str
    first_gen_count: int   # 1-based generation count of the first id in range
    count: int


@dataclasses.dataclass
class _Cluster:
    """A contiguous block of final ids owned by one session."""

    session_id: str
    base_final: int        # first final id in the cluster
    base_gen: int          # generation count (1-based) of first id
    capacity: int          # reserved width
    count: int             # finalized so far (<= capacity)


class IdCompressor:
    """One session's view of the document-global id space.

    All replicas converge on identical final-id assignment because
    finalization happens in sequenced-op order (total order broadcast).
    """

    def __init__(self, session_id: Optional[str] = None,
                 cluster_capacity: int = DEFAULT_CLUSTER_CAPACITY):
        self.session_id = session_id or str(uuid.uuid4())
        self.cluster_capacity = cluster_capacity
        self._generated = 0          # ids generated locally (gen counts 1..N)
        self._announced = 0          # ids shipped in creation ranges so far
        self._next_final = 0         # document-global final-id watermark
        self._clusters: List[_Cluster] = []
        # session_id -> list of its clusters, in finalization order
        self._by_session: Dict[str, List[_Cluster]] = {}

    # ------------------------------------------------------------ generation

    def generate_id(self) -> int:
        """Allocate one id usable immediately. Returns the **session-space**
        id: negative local alias -(gen_count)."""
        self._generated += 1
        return -self._generated

    def take_next_creation_range(self) -> Optional[IdCreationRange]:
        """The unannounced tail of locally-generated ids, to be shipped in
        the next outgoing batch. None if nothing new."""
        if self._generated == self._announced:
            return None
        rng = IdCreationRange(
            session_id=self.session_id,
            first_gen_count=self._announced + 1,
            count=self._generated - self._announced,
        )
        self._announced = self._generated
        return rng

    # ---------------------------------------------------------- finalization

    def finalize_range(self, rng: IdCreationRange) -> None:
        """Apply one sequenced creation range (from ANY session, own ranges
        included). Must be called in sequence order on every replica."""
        chain = self._by_session.setdefault(rng.session_id, [])
        expected_gen = (chain[-1].base_gen + chain[-1].count) if chain else 1
        if rng.first_gen_count != expected_gen:
            raise ValueError(
                f"out-of-order creation range for session {rng.session_id}: "
                f"got gen {rng.first_gen_count}, expected {expected_gen}")
        remaining = rng.count
        gen = rng.first_gen_count
        # fill slack in the session's newest cluster first
        if chain and chain[-1] is self._clusters[-1] \
                and chain[-1].count < chain[-1].capacity:
            tail = chain[-1]
            take = min(remaining, tail.capacity - tail.count)
            tail.count += take
            remaining -= take
            gen += take
        while remaining > 0:
            cap = max(self.cluster_capacity, remaining)
            cluster = _Cluster(session_id=rng.session_id,
                               base_final=self._next_final,
                               base_gen=gen, capacity=cap,
                               count=min(remaining, cap))
            self._next_final += cap
            self._clusters.append(cluster)
            chain.append(cluster)
            gen += cluster.count
            remaining -= cluster.count

    # -------------------------------------------------------- normalization

    def _final_for(self, session_id: str, gen_count: int) -> Optional[int]:
        for c in self._by_session.get(session_id, []):
            if c.base_gen <= gen_count < c.base_gen + c.count:
                return c.base_final + (gen_count - c.base_gen)
        return None

    def normalize_to_op_space(self, session_space_id: int) -> int:
        """Session-space → op-space: final id if this local id has been
        finalized, else the (negative) local id itself — peers resolve it
        with ``normalize_to_session_space(id, originating_session)``."""
        if session_space_id >= 0:
            return session_space_id
        final = self._final_for(self.session_id, -session_space_id)
        return final if final is not None else session_space_id

    def normalize_to_session_space(self, op_space_id: int,
                                   originator: Optional[str] = None) -> int:
        """Op-space → this session's space. Negative ids are the
        *originator's* local aliases and require the originator's session id
        to resolve (they must already be finalized here)."""
        if op_space_id >= 0:
            return op_space_id
        sid = originator or self.session_id
        if sid == self.session_id:
            return op_space_id
        final = self._final_for(sid, -op_space_id)
        if final is None:
            raise KeyError(
                f"unfinalized foreign local id {op_space_id} from {sid}")
        return final

    def decompress(self, session_space_id: int) -> str:
        """Session-space id → stable UUID string (reference: decompress)."""
        if session_space_id < 0:
            return stable_id(self.session_id, -session_space_id)
        for c in self._clusters:
            if c.base_final <= session_space_id < c.base_final + c.count:
                gen = c.base_gen + (session_space_id - c.base_final)
                return stable_id(c.session_id, gen)
        raise KeyError(f"unknown id {session_space_id}")

    def recompress(self, stable: str) -> int:
        """UUID string → session-space id (reference: recompress)."""
        for sid, chain in self._by_session.items():
            for c in chain:
                for i in range(c.count):
                    if stable_id(sid, c.base_gen + i) == stable:
                        final = c.base_final + i
                        if sid == self.session_id:
                            return -(c.base_gen + i)
                        return final
        # unfinalized own ids
        for gen in range(1, self._generated + 1):
            if stable_id(self.session_id, gen) == stable:
                return -gen
        raise KeyError(f"unknown stable id {stable}")

    # --------------------------------------------------------- serialization

    def summarize(self) -> dict:
        """Document-global finalized state (identical on every replica at the
        same sequence number) + nothing session-local: a summary must load on
        any client."""
        return {
            "nextFinal": self._next_final,
            "clusters": [dataclasses.asdict(c) for c in self._clusters],
        }

    @classmethod
    def load(cls, summary: dict, session_id: Optional[str] = None,
             cluster_capacity: int = DEFAULT_CLUSTER_CAPACITY
             ) -> "IdCompressor":
        comp = cls(session_id=session_id, cluster_capacity=cluster_capacity)
        comp._next_final = summary["nextFinal"]
        for cd in summary["clusters"]:
            c = _Cluster(**cd)
            comp._clusters.append(c)
            comp._by_session.setdefault(c.session_id, []).append(c)
        return comp


def stable_id(session_id: str, gen_count: int) -> str:
    """Deterministic UUID for the ``gen_count``-th id of a session
    (reference derives these by offsetting the session UUID; a v5 hash keeps
    the same determinism without 128-bit arithmetic)."""
    return str(uuid.uuid5(uuid.UUID(session_id), str(gen_count)))
