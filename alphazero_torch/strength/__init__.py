"""Strength gates of the port's evaluators, ports of the JAX package's
``scripts/eval_*.py``: ``quant_match`` (int8 against bf16 at equal
simulations), ``asym_match`` (equal compute, at the measured speed
ratio) and ``vs_baseline`` (the absolute anchor against the classical
engine). Each runs with ``python -m alphazero_torch.strength.<name>``."""
