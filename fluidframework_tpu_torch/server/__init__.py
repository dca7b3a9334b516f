"""Serving side: sequencers, the partitioned log, the engines, pipelined
ingest, and the columnar front door with its admission control."""
