"""Run-level machinery of the port: checkpoints."""
