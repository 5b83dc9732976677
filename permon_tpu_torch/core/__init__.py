"""Operators, fixed-tree reductions, the band K+ and the gather kernel."""
