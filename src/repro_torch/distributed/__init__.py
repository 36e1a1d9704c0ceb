"""Fault tolerance (own copy of ``repro.distributed``'s one-device parts)."""
