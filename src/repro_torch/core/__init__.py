"""repro_torch.core — the CodeCRDT coordination state as PyTorch tensor code.

The counterpart of ``repro.core``: the same join-semilattices, with the
same names, tree layouts and dtypes (int32 / bool / uint8 leaves), held
bitwise against the JAX package by ``tests/test_torch_crdt.py``.  Every
operation is out of place (it returns new tensors and never writes the
ones it was given), as the JAX functions are pure: a state may be shared
by several replicas, as the orchestrator's merged documents are.

  clock     Lamport clocks, packed (clock, client) keys, version vectors
  lww       LWW register banks — the TODO board substrate
  gset      G-counter / G-set / per-client append-only logs
  counter   PN-counters with per-replica lanes
  rga       sequence CRDT with deterministic materialization
  doc       SlotDoc — fixed-shape production code document
  todo      TodoBoard + status/dependency semantics
  protocol  optimistic write-verify claim protocol
  observe   version-vector subscriptions, invalidation signals
  delta     delta-state sync: frontiers, O(Δ) extraction, join-apply
  merge     local replica joins and the pmax join over a replica axis
  tree      pytree helpers over NamedTuples, dicts and lists of tensors
"""
