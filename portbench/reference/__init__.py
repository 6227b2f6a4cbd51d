"""The yardstick: the plain reference, its comparisons and the arithmetic of the metrics. Nothing here imports the program or JAX."""
