"""Data parallelism over processes (the JAX package's ``parallel/``, its
``data`` mesh axis): :mod:`egorear_tpu_torch.parallel.dist`."""
