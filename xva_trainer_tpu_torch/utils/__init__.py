"""Host-side utilities of the port: typed-config overlays and telemetry."""
