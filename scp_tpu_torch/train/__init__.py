"""Training of the port (single device): data pipeline, trainer, checkpoints."""
