"""Sequence-number sentinels shared by the host layers and the device state.

Reference counterpart: ``@fluidframework/merge-tree`` ``constants.ts``.
Every sentinel is an int32 that keeps ordinary ``<=`` comparisons
meaningful in vectorised visibility masks:

- ``SEQ_UNASSIGNED``: a pending local op (client-side state only; the
  device state is acked-only).
- ``SEQ_UNIVERSAL``: state loaded from a summary, visible to everyone.
- ``NOT_REMOVED``: ``removed_seq`` of a live segment, +inf-like so
  ``removed_seq <= ref_seq`` is false for live segments.
"""

SEQ_UNASSIGNED = -1
SEQ_UNIVERSAL = 0
NO_CLIENT = -1

NOT_REMOVED = 2**31 - 1
