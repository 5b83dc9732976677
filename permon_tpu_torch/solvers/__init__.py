"""The dual solvers (CG / PCPG)."""
