"""Model zoo of the port (the dense MHA family so far)."""
