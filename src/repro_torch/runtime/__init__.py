"""The training runtime of the port: checkpoints and the CRDT elastic work
queue."""
