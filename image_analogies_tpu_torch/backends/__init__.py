"""Matching backends of the port."""
