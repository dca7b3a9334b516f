"""Host utilities the durable log and the columnar front door call: fault
points, atomic file writes, the metrics registry, span tracing, the
capacity ledger and host-byte estimates, retry backoff."""
