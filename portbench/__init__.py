"""The port's benchmark: see ``portbench/run.py`` and ``PERF.md``."""
