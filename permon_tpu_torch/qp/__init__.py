"""The QP object, its coarse projector and the transform chain."""
