"""Serving and training drivers of the port, and their step builders."""
