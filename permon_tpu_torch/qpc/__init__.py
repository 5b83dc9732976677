"""Constraint objects (the QPC analog)."""

from .box import BoxConstraint
