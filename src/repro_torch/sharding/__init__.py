"""Sharding rules of the launcher: params, batches and caches as specs
over a named mesh, and their DTensor placements."""
