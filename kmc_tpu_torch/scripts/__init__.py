"""Command-line tools of the port that mirror the JAX package's
``scripts/``: the oracle validation driver (``validate_vs_reference``),
the state-invariant check (``check_flagship_state``) and the physics
checks (``early_cluster_size_check``, ``validate_lattice_physics``,
``measure_residual_overlap``).  Run them with
``python -m kmc_tpu_torch.scripts.<name>``."""
