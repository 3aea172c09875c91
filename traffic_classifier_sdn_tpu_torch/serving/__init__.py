"""Serving layers of the port above the flow table. See incremental.py."""
