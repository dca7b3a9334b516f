"""A seeded container session against the in-process service.

Two container clients a document (``examples/shared_text.py``'s schema:
a SharedString ``text`` and a SharedMap ``meta``): the editor A runs
``flush_mode="turn"`` (its edits leave as one grouped batch a turn), the
viewer B the default ``"immediate"``. Each round, for each doc in order:

1. A makes a turn of 1-3 edits: typing inserts 70 %, removes of 1-4
   chars 15 %, annotates of one of :data:`N_KEYS` property keys 15 %
   (inserts instead of annotates while ``annotate`` is off);
2. in the first round A sets ``meta["title"]`` (a map op: it passes
   through the service and is never served by the string replica);
3. in the paste round, one doc in ``paste_every`` pastes
   :data:`PASTE_CHARS` chars in A's turn (its batch leaves compressed)
   and one doc in ``chunk_every`` pastes :data:`CHUNK_CHARS` (chunked);
4. B makes one edit, sequenced before A's batch, so A's ops cross it
   (with ``cross`` off, after A's flush: the JAX package's outbox stamps
   a batch with the seq current at its flush, so a crossing B edit makes
   its replicas diverge, ROADMAP C13);
5. A flushes.

Every draw comes from one ``random.Random(seed)`` in doc order, and every
position from the replica's current length, so two services fed the same
session (either package's, on either device) see the same ops. The
clients are duck-typed: ``client_cls`` / ``options_cls`` /
``summary_cls`` default to this package's ``LocalClient``,
``ContainerRuntimeOptions`` and ``SummaryConfig``; the tests pass the JAX
package's to drive its service with the same session.

Summaries are deterministic: the summarizer (on by default in
``LocalClient``) proposes after :data:`SUMMARY_MAX_OPS` ops and never on
the wall clock.

``fingerprinted(service)`` records the replica store's state after every
apply and every compaction under ROADMAP's parity contract, so a service
on the card can be held against its ``device="cpu"`` twin step by step.
"""

from __future__ import annotations

import random
import string
import time
from typing import Iterable, List, Optional

SCHEMA = {"initialObjects": {"text": "sharedString", "meta": "map"}}
N_KEYS = 8                   # property keys p0 .. p7 (the store's K = 8)
PASTE_CHARS = 6_000          # its batch passes 4,096 B: compressed
CHUNK_CHARS = 20_000         # compressed it passes 16,384 B: chunked
SUMMARY_MAX_OPS = 8          # ops since the last ack that force a summary
#: 62 symbols (~6 bits a char): a paste compresses to about 3/4 of its
#: size, so a 20,000-char paste stays past one 16,384 B op when packed
ALPHABET = string.ascii_letters + string.digits


def doc_ids(n: int, prefix: str = "svc") -> List[str]:
    """Explicit doc ids (``svc00000`` ...): rows and partitions follow
    them, where ``create_container`` would draw ``uuid4`` ids."""
    return [f"{prefix}{i:05d}" for i in range(n)]


def _edit(text, rng: random.Random, annotate: bool) -> str:
    """One seeded edit on the SharedString ``text``; returns its kind."""
    n = text.get_length()
    roll = rng.random()
    if n == 0 or roll < 0.70 or (roll >= 0.85 and not annotate):
        word = "".join(rng.choices(string.ascii_lowercase,
                                   k=rng.randint(1, 6)))
        text.insert_text(rng.randint(0, n), word)
        return "insert"
    start = rng.randrange(n)
    if roll < 0.85:
        text.remove_text(start, min(n, start + rng.randint(1, 4)))
        return "remove"
    text.annotate_range(start, min(n, start + rng.randint(1, 8)),
                        {f"p{rng.randrange(N_KEYS)}": rng.randint(0, 9)})
    return "annotate"


class ServiceSession:
    """Editor (turn) and viewer (immediate) containers on ``docs``."""

    def __init__(self, service, docs: Iterable[str], client_cls=None,
                 options_cls=None, summary_cls=None):
        if client_cls is None:
            from ..framework.fluid_static import LocalClient as client_cls
        if options_cls is None:
            from ..runtime.container_runtime import (
                ContainerRuntimeOptions as options_cls,
            )
        if summary_cls is None:
            from ..runtime.summarizer import SummaryConfig as summary_cls
        cfg = summary_cls(max_ops=SUMMARY_MAX_OPS, max_time_s=float("inf"))
        self.service = service
        self.docs = list(docs)
        self.editor = client_cls(service=service, summary_config=cfg,
                                 runtime_options=options_cls(
                                     flush_mode="turn"))
        self.viewer = client_cls(service=service, summary_config=cfg)
        self.containers = []       # (A, B) FluidContainers a doc
        self.texts = []            # (A's text, B's text, A's meta) a doc
        for d in self.docs:
            a, _ = self.editor.create_container(SCHEMA, doc_id=d)
            b = self.viewer.get_container(d, SCHEMA)
            self.containers.append((a, b))
            oa, ob = a.initial_objects, b.initial_objects
            self.texts.append((oa["text"], ob["text"], oa["meta"]))
        self.edits = {"insert": 0, "remove": 0, "annotate": 0, "paste": 0,
                      "title": 0}
        #: host seconds spent inside the client calls of ``round`` (the
        #: service's sequencing, lambdas and replica pumping included)
        self.round_s: List[float] = []

    def round(self, r: int, rng: random.Random, annotate: bool = True,
              paste: bool = False, paste_every: int = 64,
              chunk_every: int = 1024, cross: bool = True) -> None:
        """One round over every doc (see the module docstring)."""
        edits = self.edits
        t0 = time.perf_counter()
        for i, ((a, _b), (ta, tb, meta)) in enumerate(
                zip(self.containers, self.texts)):
            for _ in range(rng.randint(1, 3)):
                edits[_edit(ta, rng, annotate)] += 1
            if r == 0:
                meta.set("title", f"doc {i}")
                edits["title"] += 1
            if paste and i % paste_every == 0:
                n = CHUNK_CHARS if i % chunk_every == 0 else PASTE_CHARS
                ta.insert_text(rng.randint(0, ta.get_length()),
                               "".join(rng.choices(ALPHABET, k=n)))
                edits["paste"] += 1
            if cross:
                edits[_edit(tb, rng, annotate)] += 1
                a.flush()
            else:
                a.flush()
                edits[_edit(tb, rng, annotate)] += 1
        self.round_s.append(time.perf_counter() - t0)

    def run(self, rounds: int, seed: int, paste_round: Optional[int] = 2,
            **kw) -> None:
        """``rounds`` rounds from ``random.Random(seed)``; the first has no
        annotates (the store's props mode switches on in the second)."""
        rng = random.Random(seed)
        for r in range(rounds):
            self.round(r, rng, annotate=r > 0, paste=r == paste_round, **kw)

    def summaries_acked(self) -> int:
        return sum(c.container._summary_manager.summaries_acked
                   for pair in self.containers for c in pair)


def store_fingerprint(store, compacted: bool) -> str:
    """SHA-1 of a string store's state under the parity contract: every
    field, slots past ``count`` included, after an apply; after a
    compaction the planes and property planes on ``[0, count)``, count,
    overflow and the digest."""
    import hashlib

    import torch

    from ..ops import merge_tree as mt
    st = store.state
    h = hashlib.sha1()

    def put(t):
        h.update(t.contiguous().cpu().numpy().tobytes())

    if not compacted:
        for k in mt.FIELDS:
            put(getattr(st, k))
        return h.hexdigest()
    live = torch.arange(st.seq.shape[1], device=st.seq.device)[None, :] \
        < st.count[:, None]
    for k in mt.PLANES:
        put(torch.where(live, getattr(st, k), 0))
    put(torch.where(live[:, :, None], st.prop_val, 0))
    for t in (st.count, st.overflow, mt.string_state_digest(st)):
        put(t)
    return h.hexdigest()


def fingerprinted(service) -> List[tuple]:
    """Wrap ``service``'s replica store so that each apply and each
    compaction appends ``(kind, props mode, fingerprint)`` to the
    returned list."""
    store, prints = service.store, []
    apply, compact = store.apply_messages, store.compact

    def applied(msgs):
        apply(msgs)
        prints.append(("apply", store._has_props,
                       store_fingerprint(store, False)))

    def compacted(ms):
        compact(ms)
        prints.append(("compact", store._has_props,
                       store_fingerprint(store, True)))

    store.apply_messages, store.compact = applied, compacted
    return prints
