"""Launchers of the port: the query-ranking load loop (``serve_rank``),
the offline job (``rank``), the trainer (``train``), the decode launcher
(``serve``), and the dry-run with its mesh builders, steps and roofline
model (``dryrun``, ``mesh``, ``steps``, ``hlo_cost``, ``hlo_analysis``)."""
