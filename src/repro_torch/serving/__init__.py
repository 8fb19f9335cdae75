"""Serving: step functions, the host-side Engine and continuous batching."""
