"""Build helpers."""
