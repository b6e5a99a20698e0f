"""Fault-tolerance runtime: `ft.PreemptionHandler` (SIGTERM -> graceful
drain)."""
