"""Parallelism over processes (the JAX package's ``parallel/``): the
``data`` mesh axis and the process groups in
:mod:`egorear_tpu_torch.parallel.dist`, the ``model`` axis's placement
rule in :mod:`egorear_tpu_torch.parallel.mesh` and its sharded modules in
:mod:`egorear_tpu_torch.parallel.tensor`."""
