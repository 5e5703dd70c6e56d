"""The port's applications (the JAX package's `apps/`)."""
