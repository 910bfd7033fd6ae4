"""Synthesis entry points of the port."""
