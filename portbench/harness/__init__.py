"""The run harness: cells by name, the window, the trace, the check."""
