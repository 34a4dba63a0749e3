"""Logical-axis sharding rules (``sharding.rules``)."""
