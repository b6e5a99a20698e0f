"""Deterministic, host-sharded, resumable synthetic-token data (`pipeline`)."""
