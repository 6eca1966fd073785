"""Drivers of the traffic mixes, one module per ``kind``."""
