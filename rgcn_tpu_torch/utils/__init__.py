"""Utilities: ``logging.ScalarLogger`` (metrics to stdout and JSONL)."""
