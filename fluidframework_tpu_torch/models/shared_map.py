"""SharedMap / SharedDirectory: last-writer-wins keyed stores.

Reference counterpart: ``@fluidframework/map`` (``SharedMap``, ``MapKernel``
``tryProcessMessage``/pendingKeys, ``SharedDirectory`` with subdirectory
paths) — SURVEY.md §2.3 (mount empty).

Convergence model (the simplest of all DDSes, which is why it is the first
tensor kernel): ops apply in total order, last ``set`` per key wins. The one
subtlety is optimistic local state: while a local ``set``/``delete`` for a key
is in flight, remote ops for that same key are *skipped* — our op is sequenced
later, so it wins anyway, and skipping keeps the local view stable instead of
flickering through remote values. A pending ``clear`` shadows the whole map.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator

from ..core.protocol import SequencedDocumentMessage
from .shared_object import SharedObject


class _NoValue:
    """Sentinel for "the key was absent" in valueChanged events — distinct
    from a stored ``None`` (a legal value here, unlike JS ``undefined``)."""

    def __repr__(self):
        return "NO_VALUE"


NO_VALUE = _NoValue()


class MapKernel:
    """Op-application core shared by SharedMap and each directory node.

    Pending-op bookkeeping is a FIFO mirroring the sequenced echo order (a
    counter-reset scheme is wrong: the echo of an op submitted *before* a
    local clear must not consume the pending count of an op submitted after
    it — found by map fuzz seed 22)."""

    _CLEAR = object()

    def __init__(self):
        self.data: Dict[str, Any] = {}           # optimistic (read) view
        self.acked: Dict[str, Any] = {}          # pure sequenced state
        self.pending_keys: Dict[str, int] = {}   # key -> outstanding local ops
        self.pending_clears = 0
        import collections
        self._pending_fifo = collections.deque()  # key or _CLEAR, in op order

    # local edits (apply optimistically, return op contents)
    def set_local(self, key: str, value: Any) -> dict:
        self.data[key] = value
        self.pending_keys[key] = self.pending_keys.get(key, 0) + 1
        self._pending_fifo.append(key)
        return {"op": "set", "key": key, "value": value}

    def delete_local(self, key: str) -> dict:
        self.data.pop(key, None)
        self.pending_keys[key] = self.pending_keys.get(key, 0) + 1
        self._pending_fifo.append(key)
        return {"op": "delete", "key": key}

    def clear_local(self) -> dict:
        self.data.clear()
        self.pending_clears += 1
        self._pending_fifo.append(self._CLEAR)
        return {"op": "clear"}

    def _apply_acked(self, op: dict) -> None:
        """Pure sequenced replay — every op, no shadowing. This is the state
        summaries serialize (pending local values must never leak into a
        summary, and the acked value must survive being shadowed locally)."""
        kind = op["op"]
        if kind == "clear":
            self.acked.clear()
        elif kind == "set":
            self.acked[op["key"]] = op["value"]
        elif kind == "delete":
            self.acked.pop(op["key"], None)

    # sequenced inbox
    def process(self, op: dict, local: bool) -> list:
        """Apply a sequenced op. Returns the VISIBLE changes it caused, for
        the owner to emit as events: ``("valueChanged", key, previous)`` /
        ``("clear", previous_contents)``. Local echoes and remote ops
        shadowed by in-flight local state cause none."""
        self._apply_acked(op)
        kind = op["op"]
        if local:
            entry = self._pending_fifo.popleft()
            if kind == "clear":
                assert entry is self._CLEAR, "pending FIFO out of sync"
                self.pending_clears -= 1
            else:
                assert entry == op["key"], "pending FIFO out of sync"
                n = self.pending_keys.get(entry, 0) - 1
                if n <= 0:
                    self.pending_keys.pop(entry, None)
                else:
                    self.pending_keys[entry] = n
            return []
        if kind == "clear":
            if self.pending_clears > 0:
                return []  # our pending clear supersedes everything before it
            # remote clear wipes acked state but keys with in-flight local
            # ops survive (those ops are sequenced after the clear)
            survivors = {k: self.data[k] for k in self.pending_keys
                         if k in self.data}
            wiped = {k: v for k, v in self.data.items()
                     if k not in survivors}
            self.data = survivors
            return [("clear", wiped)] if wiped else []
        key = op["key"]
        if self.pending_clears > 0 or key in self.pending_keys:
            return []  # shadowed by in-flight local ops for this key / clear
        previous = self.data.get(key, NO_VALUE)
        if kind == "set":
            self.data[key] = op["value"]
        elif kind == "delete":
            if previous is NO_VALUE:
                return []  # deleting an absent key changes nothing
            self.data.pop(key, None)
        return [("valueChanged", key, previous)]


class SharedMap(SharedObject):
    TYPE = "map"

    def __init__(self, object_id: str, client_id: int):
        super().__init__(object_id, client_id)
        self.kernel = MapKernel()

    # public API (reference: SharedMap.set/get/delete/has/clear).
    # Local edits emit their event at submit (the optimistic apply is the
    # visible change), remote ops at process — matching the reference's
    # "valueChanged"/"clear" emitter contract.
    def set(self, key: str, value: Any) -> None:
        previous = self.kernel.data.get(key, NO_VALUE)
        self.submit_local_message(self.kernel.set_local(key, value))
        self._emit("valueChanged", self, key, previous, True)

    def get(self, key: str, default: Any = None) -> Any:
        return self.kernel.data.get(key, default)

    def has(self, key: str) -> bool:
        return key in self.kernel.data

    def delete(self, key: str) -> None:
        previous = self.kernel.data.get(key, NO_VALUE)
        self.submit_local_message(self.kernel.delete_local(key))
        if previous is not NO_VALUE:
            self._emit("valueChanged", self, key, previous, True)

    def clear(self) -> None:
        previous = dict(self.kernel.data)
        self.submit_local_message(self.kernel.clear_local())
        if previous:
            self._emit("clear", self, previous, True)

    def keys(self) -> Iterator[str]:
        return iter(sorted(self.kernel.data))

    def __len__(self) -> int:
        return len(self.kernel.data)

    def items(self):
        return sorted(self.kernel.data.items())

    def process_core(self, msg: SequencedDocumentMessage, local: bool) -> None:
        for change in self.kernel.process(msg.contents, local):
            if change[0] == "valueChanged":
                self._emit("valueChanged", self, change[1], change[2], False)
            else:
                self._emit("clear", self, change[1], False)

    def summarize(self) -> dict:
        # the acked shadow: never contains optimistic local values, and keeps
        # the sequenced value even while a local op for the key is in flight
        return {"type": self.TYPE, "data": dict(self.kernel.acked)}

    def load_core(self, summary: dict) -> None:
        self.kernel.data = dict(summary["data"])
        self.kernel.acked = dict(summary["data"])


class SharedDirectory(SharedObject):
    """Hierarchical map: keys live in path-addressed subdirectories
    (reference: SharedDirectory / IDirectory)."""

    TYPE = "directory"

    def __init__(self, object_id: str, client_id: int):
        super().__init__(object_id, client_id)
        self._nodes: Dict[str, MapKernel] = {"/": MapKernel()}

    @staticmethod
    def _norm(path: str) -> str:
        parts = [p for p in path.split("/") if p]
        return "/" + "/".join(parts) + ("/" if parts else "")

    def _node(self, path: str, create: bool = False) -> MapKernel:
        p = self._norm(path)
        if p not in self._nodes:
            if not create:
                raise KeyError(f"no subdirectory {path!r}")
            self._nodes[p] = MapKernel()
        return self._nodes[p]

    def create_sub_directory(self, path: str) -> str:
        p = self._norm(path)
        if p not in self._nodes:
            self._nodes[p] = MapKernel()
            self.submit_local_message({"op": "createSubdir", "path": p})
        return p

    def set(self, key: str, value: Any, path: str = "/") -> None:
        node = self._node(path, create=True)
        op = node.set_local(key, value)
        op["path"] = self._norm(path)
        self.submit_local_message(op)

    def get(self, key: str, default: Any = None, path: str = "/") -> Any:
        p = self._norm(path)
        if p not in self._nodes:
            return default
        return self._nodes[p].data.get(key, default)

    def delete(self, key: str, path: str = "/") -> None:
        node = self._node(path)
        op = node.delete_local(key)
        op["path"] = self._norm(path)
        self.submit_local_message(op)

    def subdirectories(self):
        return sorted(self._nodes)

    def process_core(self, msg: SequencedDocumentMessage, local: bool) -> None:
        op = msg.contents
        if op["op"] == "createSubdir":
            if not local:
                self._nodes.setdefault(op["path"], MapKernel())
            return
        node = self._node(op.get("path", "/"), create=True)
        node.process(op, local)

    def summarize(self) -> dict:
        return {
            "type": self.TYPE,
            "nodes": {p: dict(n.acked) for p, n in self._nodes.items()},
        }

    def load_core(self, summary: dict) -> None:
        self._nodes = {}
        for p, data in summary["nodes"].items():
            k = MapKernel()
            k.data = dict(data)
            k.acked = dict(data)
            self._nodes[p] = k
