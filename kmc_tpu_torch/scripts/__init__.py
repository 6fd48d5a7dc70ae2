"""Command-line tools of the port that mirror the JAX package's
``scripts/``: the oracle validation driver (``validate_vs_reference``) and
the state-invariant check (``check_flagship_state``).  Run them with
``python -m kmc_tpu_torch.scripts.<name>``."""
