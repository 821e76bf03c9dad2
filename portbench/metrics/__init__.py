"""The per-layer metric readers, one file a metric, and their frozen
arithmetic (_trace.py, _roofline.py)."""
