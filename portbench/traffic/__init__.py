"""Traffic entries and their parameter files, found by name."""
