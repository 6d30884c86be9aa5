"""Cluster metadata: the cluster state and its update queue
(``state.py``)."""
