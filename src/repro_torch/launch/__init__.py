# Launch layer: the serve and train entry points
# (``python -m repro_torch.launch.serve`` / ``.train``, both on the local
# mesh of ``.mesh``), and the LM workflow's memory-tier check
# (``.bench_tier``). The shape and dry-run launchers are ROADMAP queue 1
# item 9b.
