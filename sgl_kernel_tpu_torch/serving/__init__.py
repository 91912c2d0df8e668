"""Serving: the continuous-batching engine and its model adapters."""
