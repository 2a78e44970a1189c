"""Configurations of the port: the serving defaults of the paper's own
workload (``hits_webgraph``)."""
