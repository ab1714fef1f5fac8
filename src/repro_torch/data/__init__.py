"""Seeded data streams (numpy only; byte-identical to ``repro.data``)."""
