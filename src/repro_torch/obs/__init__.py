"""Telemetry (DESIGN.md §13): host-side lifecycle spans and dispatch
counters (`obs.telemetry`) and the result-document block
(`obs.export`)."""
