"""Quantization formats the port's weight layouts are built from."""

from .formats import AWQ_ORDER, awq_unpack_int32, pack_int4, unpack_int4
