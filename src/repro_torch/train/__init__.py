"""Training and serving substrate: the optimizer, the train-step factory,
the synthetic data stream, checkpoints, and the serving steps."""
