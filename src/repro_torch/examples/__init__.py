"""The user-facing examples on the port (twins of the JAX package's
``examples/*.py``). Each runs as ``python -m repro_torch.examples.<name>``
on ``cuda`` unless ``--device cpu`` is passed, and exposes ``main(argv)``,
which returns what it printed as data and raises where the reference's
output sets a bar (``sweep_census``: no signature computed twice;
``tune_census``: 0 B of ledger drift; ``quickstart``: the PPR edit reruns
only the edited reducer)."""
