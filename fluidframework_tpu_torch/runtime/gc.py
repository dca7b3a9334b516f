"""Garbage collection of unreferenced datastores.

Reference counterpart: ``GarbageCollector`` in
``@fluidframework/container-runtime`` (SURVEY.md §2.8; mount empty).
Semantics preserved from the reference's mark/sweep design:

- **Handles** are the reference edges: a DDS value of the serialized-handle
  form ``{"type": "__fluid_handle__", "url": "/dsId[/channelId]"}`` (built
  with ``fluid_handle``) marks its target datastore as referenced.
- **Mark phase** (run at summarize time): walk every datastore's summary
  tree, collect handle edges, compute reachability from the root datastores
  (``create_data_store(..., root=True)`` — reference: aliased/root
  datastores).
- **Unreferenced tracking**: a datastore that becomes unreachable is stamped
  with the summary seq where that happened (reference: unreferenced
  timestamp in the GC summary blob). If it becomes reachable again the stamp
  clears (revival).
- **Sweep phase**: a datastore unreferenced for ``SWEEP_GRACE_SUMMARIES``
  consecutive summaries is dropped from the summary — new clients never see
  it (reference: sweep / tombstone; the tombstone intermediate state is
  collapsed into the grace window here).

The GC state lives IN the summary, so every replica that loads it agrees on
unreferenced stamps — GC is deterministic despite running only on the
summarizing client.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Set

HANDLE_TYPE = "__fluid_handle__"
#: summaries a datastore stays unreferenced before it is swept (a loaded
#: summary's ``sweepGrace`` takes its place)
SWEEP_GRACE_SUMMARIES = 2


def fluid_handle(ds_id: str, channel_id: Optional[str] = None) -> dict:
    """Serialized handle to a datastore (or one of its channels) — the
    reference's IFluidHandle wire form."""
    url = f"/{ds_id}" + (f"/{channel_id}" if channel_id else "")
    return {"type": HANDLE_TYPE, "url": url}


def is_handle(value: Any) -> bool:
    return isinstance(value, dict) and value.get("type") == HANDLE_TYPE \
        and isinstance(value.get("url"), str)


def handle_target(value: dict) -> str:
    """Datastore id a serialized handle points at."""
    return value["url"].lstrip("/").split("/", 1)[0]


def collect_handles(node: Any, out: Optional[Set[str]] = None) -> Set[str]:
    """Walk any JSON-ish tree and collect referenced datastore ids."""
    if out is None:
        out = set()
    if is_handle(node):
        out.add(handle_target(node))
    elif isinstance(node, dict):
        for v in node.values():
            collect_handles(v, out)
    elif isinstance(node, (list, tuple)):
        for v in node:
            collect_handles(v, out)
    return out


class GarbageCollector:
    """Mark/sweep over the datastore reference graph at summarize time."""

    def __init__(self):
        self.sweep_grace_summaries = SWEEP_GRACE_SUMMARIES
        # ds_id -> number of consecutive summaries it has been unreferenced
        self.unreferenced_for: Dict[str, int] = {}
        self.swept: List[str] = []     # ids removed by sweep (telemetry)

    # ----------------------------------------------------------------- phases

    def run(self, datastore_summaries: Dict[str, dict],
            roots: Set[str]) -> Dict[str, dict]:
        """Mark + sweep one summary's datastore map. Returns the (possibly
        pruned) map; mutates the GC bookkeeping."""
        reachable = self._mark(datastore_summaries, roots)
        pruned: Dict[str, dict] = {}
        for ds_id, summary in datastore_summaries.items():
            if ds_id in reachable:
                self.unreferenced_for.pop(ds_id, None)   # revival
                pruned[ds_id] = summary
                continue
            n = self.unreferenced_for.get(ds_id, 0) + 1
            if n > self.sweep_grace_summaries:
                self.swept.append(ds_id)                 # sweep: drop it
                self.unreferenced_for.pop(ds_id, None)
            else:
                self.unreferenced_for[ds_id] = n
                pruned[ds_id] = summary
        return pruned

    def _mark(self, summaries: Dict[str, dict], roots: Set[str]) -> Set[str]:
        """Reachability over handle edges from the root datastores."""
        edges = {ds_id: collect_handles(summary) & set(summaries)
                 for ds_id, summary in summaries.items()}
        reachable: Set[str] = set()
        frontier = [r for r in roots if r in summaries]
        while frontier:
            ds_id = frontier.pop()
            if ds_id in reachable:
                continue
            reachable.add(ds_id)
            frontier.extend(edges.get(ds_id, ()))
        return reachable

    # ------------------------------------------------------------- summary io

    def summarize(self) -> dict:
        return {"unreferencedFor": dict(self.unreferenced_for),
                "sweepGrace": self.sweep_grace_summaries}

    def load(self, state: dict) -> None:
        self.unreferenced_for = dict(state.get("unreferencedFor", {}))
        self.sweep_grace_summaries = state.get(
            "sweepGrace", self.sweep_grace_summaries)
