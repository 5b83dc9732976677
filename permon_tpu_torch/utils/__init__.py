"""Utilities: checkpoint / resume (utils/checkpoint.py)."""
