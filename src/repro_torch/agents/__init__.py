"""The agents of the port: the multi-agent trial, its tasks and the
evaluator."""
