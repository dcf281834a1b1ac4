"""Process, host and device-mesh scale-out helpers."""
