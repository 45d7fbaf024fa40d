"""Telemetry: the metrics-record envelope."""
