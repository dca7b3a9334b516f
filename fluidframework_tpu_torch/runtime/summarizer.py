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
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import List, Optional, Tuple

from ..utils.atomicfile import atomic_write_json, read_json
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
