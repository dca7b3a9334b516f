"""Serving side: sequencers, the partitioned log, the engine, pipelined
ingest."""
