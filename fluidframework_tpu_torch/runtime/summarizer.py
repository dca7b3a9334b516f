"""Summary generations on disk: the recovery ladder.

Counterpart of the generation-store half of
``fluidframework_tpu/runtime/summarizer.py``. A generation is a pickled
summary blob beside a JSON manifest holding the blob's SHA-256 and size;
a load verifies the blob against its manifest before it unpickles it, and
walks from the newest generation to older ones until one verifies. The
read plane's catch-up diffs two generations of one ladder
(``server/read_plane.py``); the observer door's catch-up rung answers
from it (``server/observer.py``).

Both packages write the same file names and manifest fields, and a
summary of either package holds only builtins and numpy arrays, so each
package loads the other's generations.

``SummaryConfig`` / ``SummaryManager`` are the client-side summarization
agent (the counterpart of the JAX module's): wired to a loaded container,
the elected client uploads a summary and proposes it with a SUMMARIZE op
once enough ops (or time) have passed since the last ack.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
import time
from typing import Callable, List, Optional, Tuple

from ..core.protocol import MessageType, SequencedDocumentMessage
from ..utils import tracing
from ..utils.atomicfile import atomic_write_json, read_json
from ..utils.faultpoints import SITE_SUMMARIZER_POST_UPLOAD, fault_point
from ..utils.telemetry import REGISTRY


class SummaryIntegrityError(RuntimeError):
    """No summary generation survived manifest verification: the ladder
    ran out of rungs (recovery falls back to a full-log replay)."""


class SummaryGenerationStore:
    """Multi-generation summary store with hashed manifests.

    ``save`` writes one generation: the summary blob (pickle: summaries
    carry numpy planes that JSON cannot round-trip losslessly), then a
    JSON manifest with the blob's SHA-256, size, seq and generation
    number. The newest ``keep`` generations are kept; older ones are
    pruned.

    ``load_latest`` is the ladder: newest → oldest, each blob verified
    against its manifest before it is unpickled (a corrupt blob is never
    deserialized); it returns the first generation that verifies with
    its depth (0 = newest), sets the ``recovery_ladder_depth`` gauge,
    counts ``summary_manifest_verify_failures_total`` a rejected rung,
    and raises :class:`SummaryIntegrityError` when every rung fails."""

    _BLOB = "gen-{:08d}.summary.pkl"
    _MANIFEST = "gen-{:08d}.manifest.json"

    def __init__(self, directory: str, keep: int = 3):
        if keep < 1:
            raise ValueError("keep must be >= 1")
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def generations(self) -> List[int]:
        """Generation numbers with a manifest on disk, ascending."""
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("gen-") and name.endswith(".manifest.json"):
                try:
                    out.append(int(name[4:12]))
                except ValueError:
                    continue
        return sorted(out)

    # ------------------------------------------------------------- save

    def save(self, summary: dict, seq: int) -> int:
        """Persist one generation: the blob first, the manifest last (a
        crash between the two leaves a manifest-less blob that the ladder
        ignores). Returns the generation number."""
        gens = self.generations()
        gen = (gens[-1] + 1) if gens else 0
        blob = pickle.dumps(summary, protocol=pickle.HIGHEST_PROTOCOL)
        blob_path = os.path.join(self.directory, self._BLOB.format(gen))
        tmp = blob_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, blob_path)
        manifest = {"generation": gen, "seq": int(seq),
                    "sha256": hashlib.sha256(blob).hexdigest(),
                    "size": len(blob)}
        atomic_write_json(
            os.path.join(self.directory, self._MANIFEST.format(gen)),
            manifest)
        for old in self.generations()[:-self.keep]:
            self._remove(old)
        REGISTRY.inc("summary_generations_written_total")
        return gen

    def _remove(self, gen: int) -> None:
        for fmt in (self._BLOB, self._MANIFEST):
            try:
                os.remove(os.path.join(self.directory, fmt.format(gen)))
            except OSError:
                pass

    # ------------------------------------------------------------- load

    def _verify_generation(self, gen: int) -> Tuple[Optional[bytes],
                                                    Optional[dict], str]:
        """(blob, manifest, "") when it verifies; (None, the manifest or
        None, reason) when not. Never unpickles anything."""
        try:
            manifest = read_json(
                os.path.join(self.directory, self._MANIFEST.format(gen)))
        except (OSError, ValueError) as e:
            return None, None, f"manifest unreadable: {e}"
        try:
            with open(os.path.join(self.directory,
                                   self._BLOB.format(gen)), "rb") as f:
                blob = f.read()
        except OSError as e:
            return None, manifest, f"blob unreadable: {e}"
        if len(blob) != int(manifest.get("size", -1)):
            return None, manifest, (
                f"blob size {len(blob)} != manifest {manifest.get('size')}")
        if hashlib.sha256(blob).hexdigest() != manifest.get("sha256"):
            return None, manifest, "sha256 mismatch"
        return blob, manifest, ""

    def load_generation(self, gen: int) -> Tuple[dict, int]:
        """Load and verify one generation: (summary, seq); raises
        :class:`SummaryIntegrityError` when it does not verify."""
        blob, manifest, reason = self._verify_generation(gen)
        if blob is None:
            REGISTRY.inc("summary_manifest_verify_failures_total")
            raise SummaryIntegrityError(
                f"generation {gen} in {self.directory}: {reason}")
        return pickle.loads(blob), int(manifest["seq"])

    def load_latest(self) -> Tuple[dict, int, int]:
        """The ladder: the newest generation that verifies, as
        ``(summary, seq, depth)`` (depth 0 is the newest; each corrupt
        rung adds 1, and the caller's tail replay is that much longer).
        Raises :class:`SummaryIntegrityError` when no rung verifies."""
        gens = self.generations()
        reasons = []
        for depth, gen in enumerate(reversed(gens)):
            blob, manifest, reason = self._verify_generation(gen)
            if blob is None:
                REGISTRY.inc("summary_manifest_verify_failures_total")
                reasons.append(f"gen {gen}: {reason}")
                continue
            REGISTRY.set_gauge("recovery_ladder_depth", float(depth))
            return pickle.loads(blob), int(manifest["seq"]), depth
        raise SummaryIntegrityError(
            f"no verifiable summary generation in {self.directory} "
            f"({len(gens)} tried): {'; '.join(reasons) or 'empty store'}")

    def verify_all(self) -> List[dict]:
        """Verify every generation without loading any: one problem dict
        a failing rung (empty when clean)."""
        problems = []
        for gen in self.generations():
            blob, _manifest, reason = self._verify_generation(gen)
            if blob is None:
                problems.append({"generation": gen, "reason": reason,
                                 "path": os.path.join(
                                     self.directory,
                                     self._BLOB.format(gen))})
        return problems


#: consecutive nacked proposals before a manager gives up until an ack
MAX_ATTEMPTS = 3


@dataclasses.dataclass
class SummaryConfig:
    """Reference: ISummaryConfiguration (§5.6)."""

    max_ops: int = 100            # ops since last ack that force a summary
    min_ops: int = 1              # never summarize with fewer new ops
    max_time_s: float = 60.0      # time since last ack that forces a summary
    #: channel-handle reuse: unchanged channels upload a handle node
    #: referencing the last ACKED summary (storage materializes it)
    incremental: bool = True


class SummaryManager:
    """Per-container summarization agent. Wire one to a loaded container:
    ``SummaryManager(container)``; it listens to the op stream, and on the
    elected client runs the summarize protocol automatically. Works with
    both the synchronous local driver (echo + ack are processed reentrantly
    inside ``submit``) and an async stream (they arrive later)."""

    def __init__(self, container,
                 config: Optional[SummaryConfig] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.container = container
        self.config = config or SummaryConfig()
        self.clock = clock or time.monotonic
        self.last_ack_seq = container.base_seq
        self.last_ack_time = self.clock()
        self._in_flight = False
        self._inflight_capture = None   # channel seqs of the upload
        self.pending_proposal: Optional[int] = None  # seq of our SUMMARIZE op
        self.failed_attempts = 0
        self.summaries_acked = 0
        self.summaries_nacked = 0
        container.on("op", self._on_op)
        # a proposal in flight when the connection drops is lost (the op
        # never sequences for a dead client) — reset so the next elected
        # window can try again
        container.on("disconnected", self._on_disconnected)

    def _on_disconnected(self, _reason: str) -> None:
        self._in_flight = False
        self.pending_proposal = None

    # --------------------------------------------------------------- election

    @property
    def elected_client(self) -> Optional[int]:
        """Oldest quorum member (join order) — reference:
        OrderedClientElection."""
        members = self.container.quorum.members
        return next(iter(members), None)

    @property
    def is_elected(self) -> bool:
        cid = self.container.client_id
        return cid is not None and cid == self.elected_client

    # -------------------------------------------------------------- op stream

    def _on_op(self, msg: SequencedDocumentMessage) -> None:
        if msg.type == MessageType.SUMMARIZE:
            if self._in_flight and msg.is_from(self.container.client_id) \
                    and self.pending_proposal is None:
                self.pending_proposal = msg.seq
            return
        if msg.type == MessageType.SUMMARY_ACK:
            self.last_ack_seq = msg.contents["summaryProposal"]
            self.last_ack_time = self.clock()
            if self._in_flight \
                    and msg.contents["summaryProposal"] == \
                    self.pending_proposal:
                self._in_flight = False
                self.pending_proposal = None
                self.failed_attempts = 0
                self.summaries_acked += 1
                # unchanged channels may now reference this summary by
                # handle (channel-handle reuse, SURVEY.md §2.16); the
                # baseline is the capture taken at UPLOAD time, immune
                # to out-of-band summarize() calls in between
                self.container.runtime.on_summary_ack(
                    self._inflight_capture)
                self._inflight_capture = None
            return
        if msg.type == MessageType.SUMMARY_NACK:
            if self._in_flight \
                    and msg.contents.get("summaryProposal") == \
                    self.pending_proposal:
                self._in_flight = False
                self.pending_proposal = None
                self.failed_attempts += 1
                self.summaries_nacked += 1
            return
        self.maybe_summarize()

    # ------------------------------------------------------------- heuristics

    def should_summarize(self) -> bool:
        """RunningSummarizer heuristics (§3.4)."""
        if not self.is_elected or not self.container.connected:
            return False
        if self._in_flight:
            return False              # one in-flight proposal at a time
        if self.failed_attempts >= MAX_ATTEMPTS:
            return False              # give up until the next ack resets us
        new_ops = self.container.protocol.seq - self.last_ack_seq
        if new_ops < self.config.min_ops:
            return False
        if new_ops >= self.config.max_ops:
            return True
        return (self.clock() - self.last_ack_time) >= self.config.max_time_s

    def maybe_summarize(self) -> bool:
        if not self.should_summarize():
            return False
        self.summarize_now()
        return True

    # ---------------------------------------------------------------- the act

    def summarize_now(self) -> int:
        """Run one summarize attempt; returns the summary's base seq.
        (Callable directly for on-demand summaries — reference:
        summarizeOnDemand.)"""
        container = self.container
        seq = container.protocol.seq
        with tracing.span("summarize", seq=seq) as sp:
            with tracing.span("summarize.build"):
                summary = {
                    "protocol": container.protocol.snapshot(),
                    # incremental is a no-op until the first ack
                    # establishes the handle-reuse baseline (summarize
                    # falls back to full)
                    "runtime": container.runtime.summarize(
                        incremental=self.config.incremental),
                }
            self._inflight_capture = \
                container.runtime.take_summary_capture()
            t0 = time.perf_counter()
            handle = container.service.summary_storage.upload_summary(
                summary, seq)
            REGISTRY.inc("summary_uploads")
            REGISTRY.observe("summary_upload_ms",
                             (time.perf_counter() - t0) * 1000)
            sp.annotate(handle=handle)
            # crash here = summary uploaded but the SUMMARIZE proposal
            # never sequenced: the upload is an orphan blob, no ack ever
            # references it, and a restarted summarizer must re-propose
            # from the last ACKED summary (never resume this one)
            fault_point(SITE_SUMMARIZER_POST_UPLOAD, seq=seq,
                        handle=handle)
            # mark in-flight BEFORE submit: the synchronous local
            # pipeline processes the echo (which records
            # pending_proposal) and the ack reentrantly inside this call
            self._in_flight = True
            self.pending_proposal = None
            REGISTRY.inc("summary_proposals")
            container.submit({"handle": handle, "summarySeq": seq},
                             MessageType.SUMMARIZE)
        return seq
