"""Logical-axis sharding rules (``sharding.rules``) and the blocks and collectives of
training over several processes (``sharding.process``)."""
