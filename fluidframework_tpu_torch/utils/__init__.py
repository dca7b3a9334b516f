"""Host utilities the durable log calls: fault points, atomic file
writes, the counter registry and the host-byte estimate of a log
record."""
