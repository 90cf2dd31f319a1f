"""Entry points: the training loop (``python -m repro_torch.launch.train``)
and its bounded-retry supervisor (``launch.elastic``), the serving command
line (``launch.serve``, over one rank or a grid of rank processes), the rank
grids and their launcher (``launch.mesh``), and the dry run
(``launch.dryrun``: one card or rank 0 of a grid, with its cell policy and
abstract inputs in ``launch.specs``)."""
