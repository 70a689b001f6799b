"""Command-line entry points of the port (the JAX package's ``launch``)."""
