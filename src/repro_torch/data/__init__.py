"""Seeded data streams (numpy only; byte-identical to ``repro.data``)."""
from . import streams
from .streams import (drifting_stream, separable_stream, stock_stream,
                      susy_stream, token_stream)

__all__ = ["streams", "susy_stream", "separable_stream", "drifting_stream",
           "stock_stream", "token_stream"]
