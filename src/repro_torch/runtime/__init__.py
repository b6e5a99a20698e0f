"""Fault-tolerance runtime: `ft.PreemptionHandler` (SIGTERM -> graceful
drain or emergency checkpoint), `ft.StragglerMonitor` and `ft.StepTimer`
(EMA step-time anomalies) and `ft.elastic_plan` (a mesh after node loss)."""
