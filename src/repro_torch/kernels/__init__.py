"""Attention kernels of the port: plain versions (ref), Hopper kernels
(csrc/ + one wrapper module each) and the dispatching wrappers (ops)."""
