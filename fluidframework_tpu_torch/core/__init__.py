"""Common definitions: sequence-number sentinels and protocol messages."""

from .constants import NO_CLIENT, NOT_REMOVED, SEQ_UNASSIGNED, SEQ_UNIVERSAL
from .protocol import MessageType, SequencedDocumentMessage, SignalMessage

__all__ = [
    "SEQ_UNASSIGNED",
    "SEQ_UNIVERSAL",
    "NO_CLIENT",
    "NOT_REMOVED",
    "MessageType",
    "SequencedDocumentMessage",
    "SignalMessage",
]
