"""Node-to-node transport: the in-process hub (``local.py``)."""
