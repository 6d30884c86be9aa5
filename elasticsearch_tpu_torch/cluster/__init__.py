"""The cluster: the cluster state and its update queue (``state.py``),
shard allocation (``allocation.py``), adaptive replica selection
(``response_collector.py``) and the in-process multi-node cluster with
replication and peer recovery (``multinode.py``)."""
