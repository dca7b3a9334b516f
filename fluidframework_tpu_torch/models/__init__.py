"""The DDS layer: collaborative data structures with Fluid merge
semantics, as host (oracle) implementations.

Counterpart of ``fluidframework_tpu/models/``: the merge tree and its
client, interval collections, the SharedObject base and channel registry,
SharedString, SharedMap and SharedDirectory. The client containers run
these; the serving replica merges the same string ops on the card.
"""

from .interval_collection import IntervalCollection, SequenceInterval
from .merge_tree import (
    LOCAL_VIEW, LocalReference, MergeTree, Segment, SegmentKind,
    SlidePolicy, TrackingGroup,
)
from .merge_tree_client import SequenceClient
from .shared_map import MapKernel, SharedDirectory, SharedMap
from .shared_object import (
    ChannelFactory, ChannelRegistry, SharedObject, default_registry,
)
from .shared_string import SharedString

__all__ = [
    "MergeTree", "Segment", "SegmentKind", "SlidePolicy", "LocalReference",
    "LOCAL_VIEW", "SequenceClient", "SharedObject", "ChannelFactory",
    "ChannelRegistry", "default_registry", "SharedMap", "SharedDirectory",
    "MapKernel", "SharedString", "IntervalCollection", "SequenceInterval",
    "TrackingGroup",
]
