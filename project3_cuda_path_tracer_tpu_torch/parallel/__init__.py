"""Sharded rendering over a list of devices (parallel/shard.py)."""
