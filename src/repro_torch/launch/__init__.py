"""Launchers: ``python -m repro_torch.launch.serve`` serves an LM through
the port's :class:`~repro_torch.serving.ServingEngine`."""
