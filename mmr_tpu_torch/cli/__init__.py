"""Command-line entry points of the port (Path A's trainer and evaluator)."""
