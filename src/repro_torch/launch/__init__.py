# Launch layer: the serve entry point (``python -m repro_torch.launch.serve``).
# The mesh, dry-run and train launchers come with the distributed substrate.
