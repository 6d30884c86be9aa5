"""The task registry (``task_manager.py``): running searches and
by-query runs, listed and cancelled through ``_tasks``."""
