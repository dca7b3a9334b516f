"""Client drivers: the reconnecting read-only observer client."""
