"""Preconditioners of the port (the counterpart of ``permon_tpu.pc``)."""

from .dual import PCDual
