"""Launchers: ``python -m repro_torch.launch.serve`` serves an LM through
the port's :class:`~repro_torch.serving.ServingEngine`;
``python -m repro_torch.launch.train`` trains one through
:class:`~repro_torch.train.TrainLoop`."""
