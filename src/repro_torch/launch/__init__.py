"""Entry points: the training loop (``python -m repro_torch.launch.train``)
and its bounded-retry supervisor (``launch.elastic``), the serving command
line (``launch.serve``), and the one-card dry run (``launch.dryrun``, with
its cell policy in ``launch.specs``)."""
