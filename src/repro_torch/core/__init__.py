"""Protocols, learners, substrates and the engine (port of ``repro.core``)."""
