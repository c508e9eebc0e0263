"""The flight recorder (``events``) and Prometheus rendering (``exporter``) that serving
writes through; the rest of the JAX package's telemetry comes with later slices."""
