"""The port's twins of the repo's ``examples/`` drivers for the model and
train stack, run as ``python -m repro_torch.examples.<name>``."""
