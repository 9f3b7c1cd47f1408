"""Operational tools of the port: ``redis_import`` migrates a reference
fleet's Redis counters into a live server through its HTTP API."""
