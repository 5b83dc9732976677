"""The QP object, its coarse projector and the transform chain."""

from .qp import QP
