"""Training of the port: the data streams (a copy of the JAX package's),
AdamW with its schedules, the train step and loop, and checkpoints in the
JAX package's on-disk format."""
