"""Observability of the port: the process metrics registry
(``metrics.py``), the null run observer the serving tier calls
(``events.py``) and the serving SLO engine (``serve.py``)."""
