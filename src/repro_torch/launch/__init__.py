"""Serving driver of the port."""
