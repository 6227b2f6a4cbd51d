"""Tools that drive the port's main path (the JAX package's ``tools/``), each
run as ``python -m egorear_tpu_torch.tools.<name>``: ``profile_fwd``,
``profile_train``, ``overfit_probe``, ``eval_occlusion_split``,
``run_curriculum`` (on the card unless ``--device cpu`` is given; without
CUDA they raise) and ``flops_count`` (on the CPU)."""
