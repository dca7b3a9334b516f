"""Loader: container lifecycle, delta manager, protocol/quorum.

Counterpart of ``fluidframework_tpu/loader/`` (reference:
``@fluidframework/container-loader``, SURVEY.md §2.10).
"""

from .container import Container, ContainerState, Loader
from .delta_manager import ConnectionState, DeltaManager
from .delta_queue import DeltaQueue
from .protocol import ProtocolHandler, Quorum, QuorumProposal

__all__ = [
    "Container",
    "ContainerState",
    "Loader",
    "ConnectionState",
    "DeltaManager",
    "DeltaQueue",
    "ProtocolHandler",
    "Quorum",
    "QuorumProposal",
]
