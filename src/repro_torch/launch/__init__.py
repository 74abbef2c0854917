# Launch layer: the serve and train entry points
# (``python -m repro_torch.launch.serve`` / ``.train``) and the LM
# workflow's memory-tier check (``.bench_tier``). The mesh and dry-run
# launchers come with the distributed substrate.
