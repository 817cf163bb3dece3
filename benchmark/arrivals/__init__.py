"""Arrival processes a traffic file may name, one file each (see ``benchmark.load``)."""
