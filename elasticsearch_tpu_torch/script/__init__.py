"""Scripting: the numeric expression engine (``expression.py``) and the
painless interpreter (``painless.py``)."""
