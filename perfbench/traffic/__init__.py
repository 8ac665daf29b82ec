"""The benchmark's traffic generator and its data."""
