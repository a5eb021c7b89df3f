"""Training substrate: optimizer, train step, checkpointing, fault tolerance."""
