"""Parallelism helpers of the port (single device for now)."""
