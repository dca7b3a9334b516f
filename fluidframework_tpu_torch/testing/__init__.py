"""Seeded test corpora."""
