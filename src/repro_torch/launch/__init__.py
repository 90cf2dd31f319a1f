"""Entry points: the training loop (``python -m repro_torch.launch.train``)
and its bounded-retry supervisor (``launch.elastic``)."""
