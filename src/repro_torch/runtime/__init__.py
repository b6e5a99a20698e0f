"""Fault-tolerance runtime: `ft.PreemptionHandler` (SIGTERM -> graceful
drain) and `ft.StragglerMonitor` (EMA step-time anomalies)."""
