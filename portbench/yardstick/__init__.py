"""Operation and byte counts and the peak table (the yardstick)."""
