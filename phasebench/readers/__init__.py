"""Shared readers of per-layer metrics.  A metric's file
``metrics/<name>.json`` names one of these under ``reader`` with its
parameters, or a module ``metrics/<name>.py`` beside it holds its own
``read(ctx, params)``.  A reader returns None where it finds nothing to
read, and the metric is then left out of the result line.

``ctx`` holds ``jobs`` (each window job's ``-metrics.json``, as a dict),
``trace`` (a ``phasebench.trace.Trace`` of the window, or None) and
``config`` (the cell's configuration file)."""
