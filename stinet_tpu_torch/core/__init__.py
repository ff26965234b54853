"""Run-level machinery of the port: config and run directories, logging,
registries, the TensorBoard writer and checkpoints."""
