"""Launchers of the port: ``serve_rank``, the query-ranking load loop."""
