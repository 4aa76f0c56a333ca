"""Host-side utilities of the port: the evaluators and the jsonl logger."""
